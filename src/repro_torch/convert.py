"""Carry a wavelet matrix, a wavelet tree, a Huffman-shaped or multiary tree
or a generalized rank/select structure between the reference's layout and
the port's, bit-exactly.

The reference side is a dict of numpy leaves keyed by dotted field path —
``bitvectors.rank.words`` (uint32), ``bitvectors.rank.superblock``
(uint32), ``bitvectors.rank.block`` (uint16), ``bitvectors.sel1.sample``,
``bitvectors.sel0.sample`` and ``zeros`` (int32) — plus ``n`` and
``nbits``; stacked matrices carry a leading (S,) axis on every leaf. A tree
has ``node_starts`` (int32) in place of ``zeros``. A Huffman-shaped tree
has ``ranks.words``, ``ranks.superblock``, ``ranks.block`` and ``active``
(int32), plus ``n`` and ``max_len``; a generalized structure ``packed``
(uint32) and ``chunk_cum`` (int32), plus ``n``, ``width`` and
``chunk_syms``; a multiary tree the same under ``levels.``, with
``node_starts``, plus ``n``, ``width``, ``nlevels`` and ``chunk_syms``.
The port keeps the same bytes in ``int32``/``int16``. No JAX is imported
here: callers flatten the reference pytree to numpy themselves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.huffman import HuffmanWaveletTree
from repro_torch.core.multiary import MultiaryWaveletTree
from repro_torch.core.rank_select import (BinaryRank, BinarySelect, BitVector,
                                          GeneralizedRankSelect)
from repro_torch.core.wavelet_matrix import WaveletMatrix
from repro_torch.core.wavelet_tree import WaveletTree
from repro_torch.device import resolve_device
from repro_torch.tree import tree_named_leaves

# reference dtype, port dtype of every leaf
_BITVECTOR_DTYPES = {
    "bitvectors.rank.words": (np.uint32, np.int32),
    "bitvectors.rank.superblock": (np.uint32, np.int32),
    "bitvectors.rank.block": (np.uint16, np.int16),
    "bitvectors.sel1.sample": (np.int32, np.int32),
    "bitvectors.sel0.sample": (np.int32, np.int32),
}
LEAF_DTYPES = {**_BITVECTOR_DTYPES, "zeros": (np.int32, np.int32)}
TREE_LEAF_DTYPES = {**_BITVECTOR_DTYPES, "node_starts": (np.int32, np.int32)}
HUFFMAN_LEAF_DTYPES = {"ranks.words": (np.uint32, np.int32),
                       "ranks.superblock": (np.uint32, np.int32),
                       "ranks.block": (np.uint16, np.int16),
                       "active": (np.int32, np.int32)}
GENERALIZED_LEAF_DTYPES = {"packed": (np.uint32, np.int32),
                           "chunk_cum": (np.int32, np.int32)}
MULTIARY_LEAF_DTYPES = {"levels.packed": (np.uint32, np.int32),
                        "levels.chunk_cum": (np.int32, np.int32),
                        "node_starts": (np.int32, np.int32)}


def _tensors(leaves: dict, dtypes: dict, device) -> dict:
    """Port tensors on ``device`` holding the bytes of reference leaves."""
    dev = resolve_device(device)
    t = {}
    for name, (ref_dt, port_dt) in dtypes.items():
        arr = np.ascontiguousarray(np.asarray(leaves[name], ref_dt))
        t[name] = torch.from_numpy(arr.view(port_dt).copy()).to(dev)
    return t


def _port_leaves(leaves: dict, dtypes: dict, n: int, sample_rate: int,
                 device):
    """(BitVector, dict of port tensors) holding the bytes of ``leaves``."""
    t = _tensors(leaves, dtypes, device)
    rank = BinaryRank(words=t["bitvectors.rank.words"],
                      superblock=t["bitvectors.rank.superblock"],
                      block=t["bitvectors.rank.block"], n=n)
    sel1 = BinarySelect(sample=t["bitvectors.sel1.sample"], n=n,
                        sample_rate=sample_rate, zeros=False)
    sel0 = BinarySelect(sample=t["bitvectors.sel0.sample"], n=n,
                        sample_rate=sample_rate, zeros=True)
    return BitVector(rank=rank, sel1=sel1, sel0=sel0), t


def _reference_leaves(struct, dtypes: dict,
                      static=("n", "nbits")) -> dict:
    named = tree_named_leaves(struct)
    out = {}
    for name, (ref_dt, port_dt) in dtypes.items():
        arr = named[name].cpu().numpy()
        if arr.dtype != port_dt:
            raise ValueError(f"{name} is {arr.dtype}, expected {port_dt}")
        out[name] = arr.view(ref_dt)
    for name in static:
        out[name] = getattr(struct, name)
    return out


def from_reference(leaves: dict, n: int, nbits: int, sample_rate: int = 512,
                   device: str | torch.device = "cuda") -> WaveletMatrix:
    """The port's ``WaveletMatrix`` holding the bytes of reference leaves."""
    bvs, t = _port_leaves(leaves, LEAF_DTYPES, n, sample_rate, device)
    return WaveletMatrix(bitvectors=bvs, zeros=t["zeros"], n=n, nbits=nbits)


def to_reference(wm: WaveletMatrix) -> dict:
    """Reference-layout numpy leaves of a port matrix, plus ``n`` and
    ``nbits``."""
    return _reference_leaves(wm, LEAF_DTYPES)


def tree_from_reference(leaves: dict, n: int, nbits: int,
                        sample_rate: int = 512,
                        device: str | torch.device = "cuda") -> WaveletTree:
    """The port's ``WaveletTree`` holding the bytes of reference leaves."""
    bvs, t = _port_leaves(leaves, TREE_LEAF_DTYPES, n, sample_rate, device)
    return WaveletTree(bitvectors=bvs, node_starts=t["node_starts"], n=n,
                       nbits=nbits)


def tree_to_reference(wt: WaveletTree) -> dict:
    """Reference-layout numpy leaves of a port tree, plus ``n`` and
    ``nbits``."""
    return _reference_leaves(wt, TREE_LEAF_DTYPES)


def huffman_from_reference(leaves: dict, n: int, max_len: int,
                           device: str | torch.device = "cuda"
                           ) -> HuffmanWaveletTree:
    """The port's ``HuffmanWaveletTree`` holding the bytes of reference
    leaves."""
    t = _tensors(leaves, HUFFMAN_LEAF_DTYPES, device)
    ranks = BinaryRank(words=t["ranks.words"],
                       superblock=t["ranks.superblock"],
                       block=t["ranks.block"], n=n)
    return HuffmanWaveletTree(ranks=ranks, active=t["active"], n=n,
                              max_len=max_len)


def huffman_to_reference(t: HuffmanWaveletTree) -> dict:
    """Reference-layout numpy leaves of a port Huffman-shaped tree, plus
    ``n`` and ``max_len``."""
    return _reference_leaves(t, HUFFMAN_LEAF_DTYPES, ("n", "max_len"))


def generalized_from_reference(leaves: dict, n: int, width: int,
                               chunk_syms: int = 128,
                               device: str | torch.device = "cuda"
                               ) -> GeneralizedRankSelect:
    """The port's ``GeneralizedRankSelect`` holding the bytes of reference
    leaves."""
    t = _tensors(leaves, GENERALIZED_LEAF_DTYPES, device)
    return GeneralizedRankSelect(packed=t["packed"],
                                 chunk_cum=t["chunk_cum"], n=n, width=width,
                                 chunk_syms=chunk_syms)


def generalized_to_reference(g: GeneralizedRankSelect) -> dict:
    """Reference-layout numpy leaves of a port generalized structure, plus
    ``n``, ``width`` and ``chunk_syms``."""
    return _reference_leaves(g, GENERALIZED_LEAF_DTYPES,
                             ("n", "width", "chunk_syms"))


def multiary_from_reference(leaves: dict, n: int, width: int, nlevels: int,
                            chunk_syms: int = 128,
                            device: str | torch.device = "cuda"
                            ) -> MultiaryWaveletTree:
    """The port's ``MultiaryWaveletTree`` holding the bytes of reference
    leaves."""
    t = _tensors(leaves, MULTIARY_LEAF_DTYPES, device)
    levels = GeneralizedRankSelect(packed=t["levels.packed"],
                                   chunk_cum=t["levels.chunk_cum"], n=n,
                                   width=width, chunk_syms=chunk_syms)
    return MultiaryWaveletTree(levels=levels, node_starts=t["node_starts"],
                               n=n, width=width, nlevels=nlevels)


def multiary_to_reference(t: MultiaryWaveletTree) -> dict:
    """Reference-layout numpy leaves of a port multiary tree, plus ``n``,
    ``width``, ``nlevels`` and ``chunk_syms``."""
    out = _reference_leaves(t, MULTIARY_LEAF_DTYPES, ("n", "width",
                                                      "nlevels"))
    out["chunk_syms"] = t.levels.chunk_syms
    return out
