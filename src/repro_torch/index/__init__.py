"""Succinct full-text index (port of ``repro.index``): suffix array → BWT →
FM-index → sharded index.

1. ``suffix_array``  — prefix doubling; each round one stable pair sort
   (``core.sort.radix_sort_stable``, the ``radix_rank`` kernels on the
   card) and one prefix-sum re-rank.
2. ``bwt_encode``    — BWT gather + C[] boundary table (histogram + scan).
3. ``build_fm_index``— wavelet matrix over the BWT (Theorem 4.5) +
   sampled-SA locate directories.
4. ``build_sharded_index`` — every shard built as one batch, its leaves
   stacked, so a pattern batch against the whole corpus is one backward
   search over (shards, patterns).
"""
from .bwt import (SENTINEL_SHIFT, append_sentinel, bwt_decode, bwt_encode,
                  bwt_from_sa, symbol_boundaries)
from .fm_index import FMIndex, build_fm_index, fm_count, fm_locate
from .patterns import sample_patterns
from .sharded import (ShardedTextIndex, build_sharded_index,
                      seam_windows_from_tokens)
from .suffix_array import doubling_round, suffix_array, suffix_array_naive

__all__ = [
    "SENTINEL_SHIFT", "append_sentinel", "bwt_decode", "bwt_encode",
    "bwt_from_sa", "symbol_boundaries",
    "FMIndex", "build_fm_index", "fm_count", "fm_locate",
    "ShardedTextIndex", "build_sharded_index", "seam_windows_from_tokens",
    "sample_patterns", "doubling_round", "suffix_array",
    "suffix_array_naive",
]
