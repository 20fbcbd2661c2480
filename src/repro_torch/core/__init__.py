"""Bit ops, scans, sorts, rank/select, the wavelet matrix and the wavelet
tree on torch tensors."""
from .rank_select import (BinaryRank, BinarySelect, BitVector,
                          build_binary_rank, build_binary_select,
                          build_bitvector, build_bitvector_levels, rank0,
                          rank1, select0, select1)
from .sort import counting_rank, radix_sort_stable, sort_pass
from .wavelet_matrix import (WaveletMatrix, build_wavelet_matrix, num_levels,
                             wm_access, wm_rank, wm_select)
from .wavelet_tree import (WaveletTree, build_wavelet_tree, wt_access,
                           wt_rank, wt_select)

__all__ = [
    "BinaryRank", "BinarySelect", "BitVector", "build_binary_rank",
    "build_binary_select", "build_bitvector", "build_bitvector_levels",
    "rank0", "rank1", "select0", "select1", "WaveletMatrix",
    "build_wavelet_matrix", "num_levels", "wm_access", "wm_rank", "wm_select",
    "counting_rank", "radix_sort_stable", "sort_pass", "WaveletTree",
    "build_wavelet_tree", "wt_access", "wt_rank", "wt_select",
]
