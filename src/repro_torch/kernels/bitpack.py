"""Pack rows of 0/1 values into LSB-first words: CUDA kernel + plain version.

Replaces ``repro/kernels/bitpack.py:bitpack_pallas``. The Pallas form takes
the bits transposed to (32, W), for the TPU's sublane reduction; the CUDA
kernel (``csrc/bitpack.cu``) needs no transpose: one warp packs 32 words,
and ``__ballot_sync`` over 32 consecutive bits is the word itself. Bound on
the H100 by bytes: 4 B read and 1/8 B written per bit.

Any nonzero value reads as 1; words are zero past n.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitops

from . import build


def bitpack_plain(bits: torch.Tensor, n: int) -> torch.Tensor:
    """(R, ceil(n/32)) int32 words of the first n values of each row."""
    return bitops.pack_bits(bitops.pad_bits((bits[:, :n] != 0).long()))


def bitpack(bits: torch.Tensor, n: int) -> torch.Tensor:
    """The CUDA kernel for a CUDA tensor, else the plain version."""
    if bits.dim() != 2 or bits.dtype != torch.int32:
        raise ValueError(f"bits must be (R, N) int32, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    if bits.shape[1] < n:
        raise ValueError(f"rows hold {bits.shape[1]} bits, need {n}")
    if bits.device.type == "cpu":
        return bitpack_plain(bits, n)
    if bits.device.type != "cuda":
        raise ValueError(f"unsupported device {bits.device}")
    if bits.stride(1) != 1:
        raise ValueError("bit rows must be contiguous")
    rows, W = bits.shape[0], bitops.num_words(n)
    words = torch.empty((rows, W), dtype=torch.int32, device=bits.device)
    lib = build.library("bitpack")
    err = lib.bitpack(bits.data_ptr(), rows, n, bits.stride(0),
                      words.data_ptr(), W, words.stride(0),
                      build.stream(bits.device))
    build.count_launch("bitpack")
    build.check(lib, err, "bitpack")
    return words
