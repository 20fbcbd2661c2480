"""Bit ops, scans, rank/select and the wavelet matrix on torch tensors."""
from .rank_select import (BinaryRank, BinarySelect, BitVector,
                          build_binary_rank, build_binary_select,
                          build_bitvector, build_bitvector_levels, rank0,
                          rank1, select0, select1)
from .wavelet_matrix import (WaveletMatrix, build_wavelet_matrix, num_levels,
                             wm_access, wm_rank, wm_select)

__all__ = [
    "BinaryRank", "BinarySelect", "BitVector", "build_binary_rank",
    "build_binary_select", "build_bitvector", "build_bitvector_levels",
    "rank0", "rank1", "select0", "select1", "WaveletMatrix",
    "build_wavelet_matrix", "num_levels", "wm_access", "wm_rank", "wm_select",
]
