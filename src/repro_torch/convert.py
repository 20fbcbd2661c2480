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
An FM index has its matrix under ``wm.``, ``C`` and ``sa_sample``
(int32) and its mark directory under ``mark.`` (``words``, ``superblock``,
``block``), plus ``n``, ``sigma`` and ``sample_rate``; a sharded text index
the same under ``shards.`` with ``seam_windows`` (int32) and, when degraded,
``available`` (bool), plus ``n``, ``sigma``, ``shard_bits`` and
``seam_overlap``.
The port keeps the same bytes in ``int32``/``int16``.

A model's params (``repro.models`` ↔ ``repro_torch.models``) are nested
dicts of arrays with the same paths and shapes on both sides
(:func:`params_from_reference`, :func:`params_to_reference`); their bf16
leaves arrive as ml_dtypes ``bfloat16`` or a 2-byte ``V2`` view and are
read by their bits, so no ``ml_dtypes`` is needed here. A training state
(``repro.train.TrainState`` ↔ ``repro_torch.train.TrainState``) is its
params, AdamW moments (f32) and step (int32) and error-feedback residuals
(f32), the same trees (:func:`train_state_from_reference`,
:func:`train_state_to_reference`). No JAX is imported here: callers
flatten the reference pytree to numpy themselves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import host_array
from repro_torch.core.huffman import HuffmanWaveletTree
from repro_torch.core.multiary import MultiaryWaveletTree
from repro_torch.core.rank_select import (BinaryRank, BinarySelect, BitVector,
                                          GeneralizedRankSelect)
from repro_torch.core.wavelet_matrix import WaveletMatrix, num_levels
from repro_torch.core.wavelet_tree import WaveletTree
from repro_torch.device import resolve_device
from repro_torch.index.fm_index import FMIndex
from repro_torch.index.sharded import ShardedTextIndex
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
_RANK_DTYPES = {"words": (np.uint32, np.int32),
                 "superblock": (np.uint32, np.int32),
                 "block": (np.uint16, np.int16)}
FM_LEAF_DTYPES = {**{f"wm.{k}": v for k, v in LEAF_DTYPES.items()},
                  "C": (np.int32, np.int32),
                  **{f"mark.{k}": v for k, v in _RANK_DTYPES.items()},
                  "sa_sample": (np.int32, np.int32)}
SHARDED_LEAF_DTYPES = {**{f"shards.{k}": v
                          for k, v in FM_LEAF_DTYPES.items()},
                       "seam_windows": (np.int32, np.int32)}
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


def _bitvector(t: dict, prefix: str, n: int, sample_rate: int) -> BitVector:
    """The ``BitVector`` of the port tensors ``t`` named under
    ``prefix + "bitvectors."``."""
    def leaf(name):
        return t[f"{prefix}bitvectors.{name}"]

    rank = BinaryRank(words=leaf("rank.words"),
                      superblock=leaf("rank.superblock"),
                      block=leaf("rank.block"), n=n)
    sel1 = BinarySelect(sample=leaf("sel1.sample"), n=n,
                        sample_rate=sample_rate, zeros=False)
    sel0 = BinarySelect(sample=leaf("sel0.sample"), n=n,
                        sample_rate=sample_rate, zeros=True)
    return BitVector(rank=rank, sel1=sel1, sel0=sel0)


def _port_leaves(leaves: dict, dtypes: dict, n: int, sample_rate: int,
                 device):
    """(BitVector, dict of port tensors) holding the bytes of ``leaves``."""
    t = _tensors(leaves, dtypes, device)
    return _bitvector(t, "", n, sample_rate), t


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


def _fm_index(t: dict, prefix: str, n: int, sigma: int, sample_rate: int,
              bv_sample_rate: int) -> FMIndex:
    """An ``FMIndex`` of the port tensors ``t`` named under ``prefix``."""
    def leaf(name):
        return t[prefix + name]

    m = n + 1
    wm = WaveletMatrix(bitvectors=_bitvector(t, prefix + "wm.", m,
                                             bv_sample_rate),
                       zeros=leaf("wm.zeros"), n=m,
                       nbits=num_levels(sigma + 1))
    mark = BinaryRank(words=leaf("mark.words"),
                      superblock=leaf("mark.superblock"),
                      block=leaf("mark.block"), n=m)
    return FMIndex(wm=wm, C=leaf("C"), mark=mark,
                   sa_sample=leaf("sa_sample"), n=n, sigma=sigma,
                   sample_rate=sample_rate)


def fm_index_from_reference(leaves: dict, n: int, sigma: int,
                            sample_rate: int = 32, bv_sample_rate: int = 512,
                            device: str | torch.device = "cuda") -> FMIndex:
    """The port's ``FMIndex`` holding the bytes of reference leaves (an
    index of ``n`` symbols in [0, σ), its matrix over σ+1)."""
    t = _tensors(leaves, FM_LEAF_DTYPES, device)
    return _fm_index(t, "", n, sigma, sample_rate, bv_sample_rate)


def fm_index_to_reference(fm: FMIndex) -> dict:
    """Reference-layout numpy leaves of a port FM index, plus ``n``,
    ``sigma`` and ``sample_rate``."""
    return _reference_leaves(fm, FM_LEAF_DTYPES, ("n", "sigma",
                                                  "sample_rate"))


def sharded_index_from_reference(leaves: dict, n: int, sigma: int,
                                 shard_bits: int, seam_overlap: int,
                                 sample_rate: int = 32,
                                 bv_sample_rate: int = 512,
                                 device: str | torch.device = "cuda"
                                 ) -> ShardedTextIndex:
    """The port's ``ShardedTextIndex`` holding the bytes of reference
    leaves (``available`` among them when the index is degraded)."""
    t = _tensors(leaves, SHARDED_LEAF_DTYPES, device)
    shards = _fm_index(t, "shards.", 1 << shard_bits, sigma + 1, sample_rate,
                       bv_sample_rate)
    available = leaves.get("available")
    if available is not None:
        available = torch.from_numpy(np.asarray(available, bool)).to(
            t["seam_windows"].device)
    return ShardedTextIndex(shards=shards, seam_windows=t["seam_windows"],
                            n=n, sigma=sigma, shard_bits=shard_bits,
                            seam_overlap=seam_overlap, available=available)


def sharded_index_to_reference(idx: ShardedTextIndex) -> dict:
    """Reference-layout numpy leaves of a port sharded index (with
    ``available`` when degraded), plus ``n``, ``sigma``, ``shard_bits`` and
    ``seam_overlap``."""
    out = _reference_leaves(idx, SHARDED_LEAF_DTYPES,
                            ("n", "sigma", "shard_bits", "seam_overlap"))
    if idx.available is not None:
        out["available"] = idx.available.cpu().numpy()
    return out


def _param_tensor(arr, device) -> torch.Tensor:
    """A reference param leaf as a tensor on ``device``: a 2-byte float
    that numpy cannot name (ml_dtypes ``bfloat16``, or its ``V2`` view) is
    read as bf16 by its bits; anything else keeps its dtype."""
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype.itemsize == 2 and arr.dtype.kind not in "iuf":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def params_from_reference(tree: dict,
                          device: str | torch.device = "cuda") -> dict:
    """The port's params on ``device`` from the reference's nested dict of
    numpy arrays (``jax.tree.map(np.asarray, params)``): the same paths,
    shapes and dtypes."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_reference(v, dev) for k, v in tree.items()}
    return _param_tensor(tree, dev)


def params_to_reference(params: dict) -> dict:
    """Nested dict of host numpy arrays of the port's params, the paths,
    shapes and dtypes the reference holds; bf16 leaves come as their bits
    in a ``V2`` view (``.view(ml_dtypes.bfloat16)`` on the reference's
    side)."""
    if isinstance(params, dict):
        return {k: params_to_reference(v) for k, v in params.items()}
    return host_array(params)


def train_state_from_reference(state, device: str | torch.device = "cuda"):
    """The port's ``TrainState`` on ``device`` from the reference's: any
    object with ``params``, ``opt.m``, ``opt.v``, ``opt.step`` and ``ef``
    whose leaves numpy can read (``np.asarray``)."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.trainer import TrainState
    dev = resolve_device(device)

    def tree(t):
        return params_from_reference(t, dev)
    step = torch.from_numpy(np.asarray(state.opt.step, np.int32).copy())
    return TrainState(params=tree(state.params),
                      opt=AdamWState(m=tree(state.opt.m),
                                     v=tree(state.opt.v), step=step.to(dev)),
                      ef=tree(state.ef))


def train_state_to_reference(state) -> dict:
    """``{"params", "opt": {"m", "v", "step"}, "ef"}`` of host numpy arrays
    of a port ``TrainState``, the reference's paths, shapes and dtypes
    (bf16 leaves as their bits in a ``V2`` view)."""
    return {"params": params_to_reference(state.params),
            "opt": {"m": params_to_reference(state.opt.m),
                    "v": params_to_reference(state.opt.v),
                    "step": host_array(state.opt.step)},
            "ef": params_to_reference(state.ef)}
