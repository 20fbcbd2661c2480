"""Corpus substrate: synthetic streams, shard builds, the compressed store,
the deterministic batch pipeline."""
from .compressed_store import (CompressedCorpus, build_compressed_corpus,
                               token_histogram)
from .pipeline import TokenBatcher, batch_offsets
from .shard_build import build_shards_stacked
from .synthetic import corpus_region, make_corpus, zipf_probs

__all__ = ["CompressedCorpus", "TokenBatcher", "batch_offsets",
           "build_compressed_corpus", "build_shards_stacked",
           "corpus_region", "make_corpus", "token_histogram", "zipf_probs"]
