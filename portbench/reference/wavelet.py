"""The plain reference of a wavelet matrix, its directories and its range
quantile, in plain torch.

A level holds bit ``nbits - 1 - l`` of every symbol in the level's order;
the next level's order is the stable partition of this one by that bit,
zeros first. The bitmap packs the level's bits 32 to an int32 word, bit i
of a row at bit ``i % 32`` of word ``i // 32``. The rank directory holds,
for every 32 words, the ones before it (int32) and, for every 4 words, the
ones before it inside its group of 32 (int16). A select directory holds,
for every ``sample_rate``-th one (or zero), the 4-word block it lies in.
Nothing here comes from the program: it is the definition, computed
directly.
"""
from __future__ import annotations

import torch

WORD = 32
BLOCK_WORDS = 4
SUPER_WORDS = 32


def num_levels(sigma: int) -> int:
    """Bit levels of a wavelet matrix over [0, sigma)."""
    return max(1, (max(2, sigma) - 1).bit_length())


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """Values in [0, 2^32) as the int32 with the same bits."""
    x = x.long()
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """(R, n) 0/1 -> (R, ceil(n/32)) int32 words, least bit first."""
    rows, n = bits.shape
    w = -(-n // WORD)
    padded = torch.zeros((rows, w * WORD), dtype=torch.int64,
                         device=bits.device)
    padded[:, :n] = bits
    shifts = torch.arange(WORD, device=bits.device)
    return to_int32((padded.view(rows, w, WORD) << shifts).sum(-1))


def word_ones(bits: torch.Tensor) -> torch.Tensor:
    """(R, n) 0/1 -> (R, ceil(n/32)) int64 ones of each word."""
    rows, n = bits.shape
    w = -(-n // WORD)
    padded = torch.zeros((rows, w * WORD), dtype=torch.int64,
                         device=bits.device)
    padded[:, :n] = bits
    return padded.view(rows, w, WORD).sum(-1)


def rank_directory(bits: torch.Tensor):
    """(superblock int32, block int16) of (R, n) bits."""
    ones = word_ones(bits)
    before = torch.cumsum(ones, 1) - ones            # ones before each word
    superblock = before[:, ::SUPER_WORDS]
    blocks = before[:, ::BLOCK_WORDS]
    group = torch.arange(blocks.shape[1], device=bits.device) // (
        SUPER_WORDS // BLOCK_WORDS)
    block = blocks - superblock[:, group]
    return superblock.to(torch.int32), block.to(torch.int16)


def select_directory(bits: torch.Tensor, sample_rate: int, zeros: bool):
    """(R, n // sample_rate + 2) int32: for j = 0, 1, ..., the block of 4
    words that holds the (j * sample_rate)-th one (zero) of each row; past
    the last one (zero), the last block."""
    rows, n = bits.shape
    nblk = -(-(-(-n // WORD)) // BLOCK_WORDS)
    per_block = torch.zeros((rows, nblk * BLOCK_WORDS * WORD),
                            dtype=torch.int64, device=bits.device)
    per_block[:, :n] = (1 - bits.long()) if zeros else bits
    counts = per_block.view(rows, nblk, -1).sum(-1)
    ends = torch.cumsum(counts, 1)                    # targets through block
    targets = (torch.arange(n // sample_rate + 2, device=bits.device)
               * sample_rate).expand(rows, -1).contiguous()
    holder = torch.searchsorted(ends.contiguous(), targets, right=True)
    return holder.clamp(max=nblk - 1).to(torch.int32)


def partition(order: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Stable partition of each row of ``order`` by ``bits``, zeros
    first."""
    b = bits.long()
    z = (1 - b).sum(1, keepdim=True)
    dest = torch.where(b == 0, torch.cumsum(1 - b, 1) - 1,
                       z + torch.cumsum(b, 1) - 1)
    return torch.empty_like(order).scatter_(1, dest, order)


def matrix_levels(symbols: torch.Tensor, nbits: int, stable: bool = True):
    """Yield (l, bits (R, n) int64, zeros (R,)) of each level of the
    wavelet matrices of the rows of ``symbols``. ``stable=False`` is the
    control's unordered partition (each level's ones in reverse order, as a
    partition by atomic counters may leave them)."""
    order = symbols.long()
    for l in range(nbits):
        bits = (order >> (nbits - 1 - l)) & 1
        yield l, bits, (1 - bits).sum(1)
        if l + 1 < nbits:
            order = partition(order, bits)
            if not stable:
                z = (1 - bits).sum(1, keepdim=True)
                i = torch.arange(order.shape[1], device=order.device)
                order = order.gather(1, torch.where(
                    i >= z, z + order.shape[1] - 1 - i, i))


def matrix(symbols: torch.Tensor, sigma: int, sample_rate: int,
           stable: bool = True) -> dict:
    """Every leaf of the wavelet matrices of the rows of ``symbols`` (R, n),
    stacked as (R, nbits, ...)."""
    nbits = num_levels(sigma)
    leaves = {k: [] for k in ("words", "superblock", "block", "sel1",
                              "sel0", "zeros")}
    for _, bits, zeros in matrix_levels(symbols, nbits, stable):
        leaves["words"].append(pack(bits))
        sb, blk = rank_directory(bits)
        leaves["superblock"].append(sb)
        leaves["block"].append(blk)
        leaves["sel1"].append(select_directory(bits, sample_rate, False))
        leaves["sel0"].append(select_directory(bits, sample_rate, True))
        leaves["zeros"].append(zeros.to(torch.int32))
    return {k: torch.stack(v, 1) for k, v in leaves.items()}


def quantiles(tokens: torch.Tensor, sigma: int, batches: list) -> list:
    """The k-th smallest token of each query of ``batches`` ((lo, hi, k)
    int tensors on the tokens' device) in ``tokens[lo:hi]``, by the
    descent of one wavelet matrix over the whole stream, level by level
    for every batch at once. k is clamped into the range; -1 for an empty
    range."""
    nbits = num_levels(sigma)
    n = tokens.shape[0]
    state = []
    for lo, hi, k in batches:
        lo = lo.long().clamp(0, n)
        hi = torch.maximum(hi.long().clamp(0, n), lo)
        total = hi - lo
        k = torch.minimum(k.long().clamp(min=0), (total - 1).clamp(min=0))
        state.append([lo, hi, k, torch.zeros_like(k), total])
    for _, bits, zeros in matrix_levels(tokens[None], nbits):
        ones = torch.zeros(n + 1, dtype=torch.int64, device=tokens.device)
        ones[1:] = torch.cumsum(bits[0], 0)
        z = int(zeros[0])
        for s in state:
            lo, hi, k, sym, _ = s
            olo, ohi = ones[lo], ones[hi]
            zin = (hi - lo) - (ohi - olo)
            bit = k >= zin
            s[0] = torch.where(bit, z + olo, lo - olo)
            s[1] = torch.where(bit, z + ohi, hi - ohi)
            s[2] = torch.where(bit, k - zin, k)
            s[3] = (sym << 1) | bit.long()
        del ones
    out = []
    for _, _, _, sym, total in state:
        out.append(torch.where(total <= 0, -1, sym).to(torch.int32))
    return out
