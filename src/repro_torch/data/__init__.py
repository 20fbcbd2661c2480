"""Corpus substrate: synthetic streams, shard builds, the compressed store."""
from .compressed_store import CompressedCorpus, build_compressed_corpus
from .synthetic import make_corpus, zipf_probs

__all__ = ["CompressedCorpus", "build_compressed_corpus", "make_corpus",
           "zipf_probs"]
