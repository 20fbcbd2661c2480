"""Bit ops, scans, sorts, rank/select, the wavelet matrix, the wavelet tree
and its Huffman-shaped and multiary forms on torch tensors."""
from . import bitops, scan, sort
from .huffman import (HuffmanWaveletTree, build_huffman_wavelet_tree,
                      canonical_codes, huffman_code_lengths, huffman_codebook,
                      reference_huffman_levels)
from .multiary import (MultiaryWaveletTree, build_multiary_wavelet_tree,
                       mwt_access, mwt_rank, mwt_select)
from .rank_select import (BinaryRank, BinarySelect, BitVector,
                          GeneralizedRankSelect, access_bit, build_binary_rank,
                          build_binary_select, build_bitvector,
                          build_bitvector_levels, build_generalized,
                          generalized_access, generalized_rank,
                          generalized_select, rank0, rank1, select0, select1)
from .sort import (bucket_ranks, counting_rank, radix_sort_stable,
                   sort_pass, sort_permutation)
from .wavelet_matrix import (WaveletMatrix, build_wavelet_matrix,
                             build_wavelet_matrix_levelwise, num_levels,
                             reverse_bits, wm_access, wm_child_interval,
                             wm_interval_zeros, wm_position_step, wm_rank,
                             wm_select)
from .wavelet_tree import (WaveletTree, build_wavelet_tree,
                           build_wavelet_tree_dd,
                           build_wavelet_tree_levelwise, wt_access, wt_rank,
                           wt_select)

__all__ = [
    "bitops", "scan", "sort", "access_bit", "bucket_ranks",
    "sort_permutation", "reverse_bits", "wm_child_interval",
    "wm_interval_zeros", "wm_position_step",
    "BinaryRank", "BinarySelect", "BitVector", "GeneralizedRankSelect",
    "build_binary_rank", "build_binary_select", "build_bitvector",
    "build_bitvector_levels", "build_generalized", "generalized_access",
    "generalized_rank", "generalized_select", "rank0", "rank1", "select0",
    "select1", "WaveletMatrix", "build_wavelet_matrix",
    "build_wavelet_matrix_levelwise", "num_levels", "wm_access", "wm_rank",
    "wm_select", "counting_rank", "radix_sort_stable", "sort_pass",
    "WaveletTree", "build_wavelet_tree", "build_wavelet_tree_dd",
    "build_wavelet_tree_levelwise", "wt_access", "wt_rank", "wt_select",
    "HuffmanWaveletTree", "build_huffman_wavelet_tree", "canonical_codes",
    "huffman_code_lengths", "huffman_codebook", "reference_huffman_levels",
    "MultiaryWaveletTree", "build_multiary_wavelet_tree", "mwt_access",
    "mwt_rank", "mwt_select",
]
