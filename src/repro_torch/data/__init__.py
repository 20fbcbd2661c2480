"""Corpus substrate: synthetic streams, shard builds, the compressed store."""
from .compressed_store import (CompressedCorpus, build_compressed_corpus,
                               token_histogram)
from .synthetic import corpus_region, make_corpus, zipf_probs

__all__ = ["CompressedCorpus", "build_compressed_corpus", "corpus_region",
           "make_corpus", "token_histogram", "zipf_probs"]
