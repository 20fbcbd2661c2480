"""Packed-word bit operations on torch tensors (port of ``repro.core.bitops``).

Words are stored as ``int32`` tensors holding the uint32 bit pattern, the
reference's bytes. Arithmetic widens to ``int64`` and masks with
``0xFFFFFFFF`` first (:func:`u32`): ``>>`` on ``int32`` sign-extends, and
the CPU build of torch has no shifts on ``uint32``. Popcount is SWAR, as
torch has no popcount op. Every function works along the last axis and
broadcasts over leading (batch) axes.
"""
from __future__ import annotations

import torch

WORD_BITS = 32
_M32 = 0xFFFFFFFF


def num_words(n_bits: int) -> int:
    """Number of 32-bit words needed to hold ``n_bits`` bits."""
    return (n_bits + WORD_BITS - 1) // WORD_BITS


def u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 value of each element, as ``int64`` in [0, 2^32)."""
    return x.long() & _M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """``int32`` holding the low 32 bits of each element (two's complement
    reinterpretation, the inverse of :func:`u32`)."""
    x = x.long() & _M32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack 0/1 values into ``int32`` words, LSB-first along the last axis.

    Bit ``i`` lands in word ``i // 32`` at position ``i % 32``. The length
    must be a multiple of 32 (:func:`pad_bits` first, padding with 0).
    """
    n = bits.shape[-1]
    if n % WORD_BITS:
        raise ValueError("pack_bits needs a multiple of 32 bits: pad first")
    b = bits.long().reshape(bits.shape[:-1] + (n // WORD_BITS, WORD_BITS))
    shifts = torch.arange(WORD_BITS, device=bits.device)
    return to_i32((b << shifts).sum(-1))


def pad_bits(bits: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last axis to a multiple of the word size."""
    pad = (-bits.shape[-1]) % WORD_BITS
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    return bits


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: the first ``n`` bits as ``uint8``."""
    shifts = torch.arange(WORD_BITS, device=words.device)
    bits = (u32(words)[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n].to(torch.uint8)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the low 32 bits of each element (SWAR), as ``int64``."""
    x = u32(x)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def word_prefix_popcount(words: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of per-word popcounts (ranks at word
    boundaries) along the last axis, ``int64``."""
    counts = popcount(words)
    return torch.cumsum(counts, -1) - counts


def mask_below(bit_index: torch.Tensor) -> torch.Tensor:
    """Mask with bits [0, bit_index) set, bit_index in [0, 32], ``int64``."""
    return (torch.ones_like(bit_index, dtype=torch.long)
            << bit_index.long()) - 1


def rank1_word(word: torch.Tensor, bit_index: torch.Tensor) -> torch.Tensor:
    """Number of 1 bits strictly below ``bit_index`` within a word."""
    return popcount(u32(word) & mask_below(bit_index))


def select_in_word(word: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Position of the k-th (0-based) set bit of ``word``; 32 if the word
    has fewer than k+1 set bits. Branchless binary search over popcounts of
    masked halves, as in the reference."""
    word = u32(word)
    k = k.long()
    pos = torch.zeros_like(k)
    remaining = k
    for width in (16, 8, 4, 2, 1):
        cnt = popcount((word >> pos) & ((1 << width) - 1))
        go_right = cnt <= remaining
        remaining = torch.where(go_right, remaining - cnt, remaining)
        pos = torch.where(go_right, pos + width, pos)
    return pos


def pack_fields(values: torch.Tensor, width: int,
                out_dtype_name: str = "uint32") -> torch.Tensor:
    """Pack ``width``-bit fields into words, 32 // width a word, LSB-first
    along the last axis (the paper's packed lists); ``width`` divides 32 and
    the tail is padded with zero fields. The words come as ``int32``
    holding the uint32 pattern for ``"uint32"``, and converted to the named
    dtype otherwise, as the reference's ``astype`` converts them."""
    if 32 % width:
        raise ValueError(f"width {width} does not divide 32")
    per = WORD_BITS // width
    v = u32(values)
    pad = (-v.shape[-1]) % per
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    v = v.reshape(v.shape[:-1] + (-1, per))
    out = torch.zeros(v.shape[:-1], dtype=torch.long, device=v.device)
    for j in range(per):                 # OR, as the reference reduces
        out |= v[..., j] << (j * width)
    if out_dtype_name == "uint32":
        return to_i32(out)
    return out.to(getattr(torch, out_dtype_name))


def unpack_fields(words: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_fields`: the first ``n`` fields of ``width``
    bits along the last axis, ``int64``."""
    if 32 % width:
        raise ValueError(f"width {width} does not divide 32")
    shifts = torch.arange(0, WORD_BITS, width, device=words.device)
    fields = (u32(words)[..., None] >> shifts) & ((1 << width) - 1)
    return fields.reshape(words.shape[:-1] + (-1,))[..., :n]


def extract_bit(values: torch.Tensor, bit) -> torch.Tensor:
    """Bit ``bit`` (0 = LSB) of each value, ``int64`` in {0, 1}."""
    return (u32(values) >> bit) & 1


def extract_field(values: torch.Tensor, lo_bit: int,
                  width: int) -> torch.Tensor:
    """``width`` bits starting at ``lo_bit`` of each value, ``int64``."""
    return (u32(values) >> lo_bit) & ((1 << width) - 1)
