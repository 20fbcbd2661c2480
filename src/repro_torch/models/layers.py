"""Shared transformer layers on torch tensors (port of
``repro.models.layers``): norms, RoPE, GQA attention, MLPs.

Every function is plain: params are dicts of tensors with the reference's
names and shapes. The numerics are the reference's: bf16 products cast to
f32 *after* the product, an f32 softmax with a ``-1e30`` additive bias,
norms computed in f32, cast back and then scaled in bf16. Attention is
written in plain torch ops, as the reference writes it in ``jnp``, and
modes are the reference's three: full (prefill), query-chunked (long
prefill, bounded memory) and single-token decode against a KV cache.

The activations are the reference's op sequences with every op rounded to
bf16, as XLA computes them on the CPU: a fused torch activation rounds once
and differs in the last bit, which is enough to flip a near-tied MoE
routing.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .shard_ctx import constrain, distribute, fit_dim, reduce_partial

NEG_BIAS = -1e30


def remat(fn: Callable, *args):
    """``fn(*args)``; with grad enabled its activations are recomputed in
    the backward pass instead of kept (the reference's
    ``jax.checkpoint``). The model draws no random numbers, so no RNG
    state is kept."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x · sigmoid(x), the sigmoid as 1 / (1 + exp(-x))."""
    return x * (1 / (1 + torch.exp(-x)))


def _const(value: float, dtype: torch.dtype) -> float:
    """A constant rounded to ``dtype``, as JAX casts a weakly typed one."""
    return torch.tensor(value, dtype=dtype).item()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh approximation)."""
    c = _const(math.sqrt(2 / math.pi), x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + _const(0.044715, x.dtype)
                                       * (x * x * x))))
    return x * cdf


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_frequencies(head_dim: int, theta: float, positions: torch.Tensor):
    """(..., head_dim/2) cos/sin tables for the given positions."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim/2).
    The rotation runs in f32 (bf16 times the f32 tables), then casts back."""
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, hd) → (B, S, KV*groups, hd) for GQA."""
    if groups == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, hd).reshape(
        b, s, kv * groups, hd)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")``: one matmul over the flattened heads."""
    d, h, k = w.shape
    w = fit_dim(w.reshape(d, h * k), -1, h)
    return fit_dim(x @ w, -1, h).unflatten(-1, (h, k))


def _out_project(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")``."""
    h, k, d = w.shape
    return reduce_partial(fit_dim(o.flatten(-2), -1, h)
                          @ fit_dim(w.reshape(h * k, d), 0, h))


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """bf16 ``bqhd,bkhd->bhqk`` product, cast to f32 after, scaled (a
    batched matmul: the bits of ``torch.einsum``, at half its host cost).

    Training and prefill call it on each device's local heads
    (:func:`_per_shard`, :func:`_head_parallel`). Decode calls it on
    DTensors, and there the heads are replicated first: the product folds
    (b, h) into one batch dim, which DTensor cannot do with h sharded
    (torch 2.11 refuses; 2.13 plans it through strided shards at a far
    higher cost)."""
    q, k = fit_dim(q, 2, 1), fit_dim(k, 2, 1)
    return ((q.transpose(1, 2) @ k.permute(0, 2, 3, 1)).float()
            / math.sqrt(q.shape[-1]))


def _weighted(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``bhqk,bkhd->bqhd`` (on local heads, or heads replicated on the
    DTensors of decode, as in :func:`_scores`)."""
    return (fit_dim(probs, 1, 1) @ fit_dim(v, 2, 1).transpose(1, 2)
            ).transpose(1, 2)


def _causal_bias(qpos: torch.Tensor, kpos: torch.Tensor) -> torch.Tensor:
    """(Sq, Sk) f32 additive bias: 0 where key ≤ query, else -1e30."""
    return torch.where(kpos[None, :] <= qpos[:, None], 0.0,
                       NEG_BIAS).to(torch.float32)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, H, hd) — plain softmax attention."""
    scores = _scores(q, k)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        dev = q.device
        scores += _causal_bias(torch.arange(sq, device=dev) + (sk - sq),
                               torch.arange(sk, device=dev))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _weighted(probs, v)


def bidirectional_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    return full_attention(q, k, v, causal=False)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_chunk: int = 1024, causal: bool = True
                      ) -> torch.Tensor:
    """Attention one query chunk at a time: memory O(q_chunk · Sk) per head
    instead of O(Sq · Sk), in the backward pass too (each chunk is
    rematerialized). Each chunk is a full softmax over all keys, so it
    equals :func:`full_attention` up to accumulation order."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if sq % q_chunk:
        raise ValueError(f"query length {sq} is not a multiple of the "
                         f"chunk {q_chunk}")
    kpos = torch.arange(sk, device=q.device)

    def chunk_out(qc, k, v, ci):
        scores = _scores(qc, k)
        if causal:
            qpos = (ci * q_chunk + (sk - sq)
                    + torch.arange(q_chunk, device=q.device))
            scores += _causal_bias(qpos, kpos)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return _weighted(probs, v)
    # each chunk rematerialized, as the reference's ``jax.checkpoint`` of
    # its chunk: the backward keeps one chunk's (q_chunk × Sk) scores at a
    # time instead of every chunk's
    return torch.cat([remat(chunk_out, q[:, ci * q_chunk:(ci + 1) * q_chunk],
                            k, v, ci) for ci in range(sq // q_chunk)],
                     dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length_mask: torch.Tensor) -> torch.Tensor:
    """Single-position attention: q (B, 1, H, hd) vs cache (B, S, H, hd).

    ``length_mask``: (B, S) bool — True for valid cache slots."""
    scores = _scores(q, k_cache)
    scores = torch.where(length_mask[:, None, None, :], scores, NEG_BIAS)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _weighted(probs, v_cache)


def _per_shard(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """``fn(q, k, v)`` for (B, S, H, hd) operands. On DTensors each device
    attends over its own batch rows and heads (``local_map``; the
    sequence dims gathered, k and v laid out as q): attention needs no
    collective then, where DTensor's own strategies gather the scores."""
    if not hasattr(q, "device_mesh"):
        return fn(q, k, v)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in q.placements]
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    # contiguous shards both ways: the output and the operands' gradients
    # are transposed views, which DTensor's later views of a shard (the
    # projections' folds) cannot take

    def local(*t):
        return fn(*(_ContiguousGrad.apply(x) for x in t)).contiguous()
    return local_map(local, out_placements=pl, in_placements=(pl, pl, pl),
                     device_mesh=mesh)(q, k, v)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, its gradient made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _qkv(x: torch.Tensor, p: dict, cfg):
    q, k, v = (_project(x, p[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _attend(q, k, v, q_chunk: Optional[int]) -> torch.Tensor:
    """Causal attention of (B, S, H, hd) operands, query-chunked past
    ``q_chunk``."""
    if q_chunk is not None and q.shape[1] > q_chunk:
        return chunked_attention(q, k, v, q_chunk=q_chunk)
    return full_attention(q, k, v)


def head_slices(h: int, kv: int, parts: int, j: int):
    """The heads device ``j`` of ``parts`` serves when ``parts`` does not
    divide the ``h`` query heads: the heads padded to a multiple of
    ``parts`` (GSPMD's padding of the reference's ``P(.., "model", ..)``),
    ``ceil(h / parts)`` of them a device. Returns (query heads, which of
    them are real, the KV heads they read, each query head's index into
    those): a padding head reads the last real head's KV head; its query
    and output weights are zero (:func:`_head_sharded`)."""
    hl = -(-h // parts)
    glob = [j * hl + i for i in range(hl)]
    heads = [min(g, h - 1) for g in glob]
    groups = h // kv
    kv_heads = sorted({g // groups for g in heads})
    return (heads, [g < h for g in glob], kv_heads,
            [kv_heads.index(g // groups) for g in heads])


#: the weights :func:`_head_parallel` shards on their head dim (a weight's
#: head dim: 1 for ``wq``, 0 for ``bq`` and ``wo``); the KV heads' stay
#: whole
HEAD_DIMS = {"wq": 1, "bq": 0, "wo": 0}


def unsharded_heads(t, cfg) -> Optional[int]:
    """The mesh dim of ``model`` where ``t`` is a DTensor on a mesh whose
    ``model`` axis has more than one device and does not divide the query
    heads (:func:`_head_parallel`'s case), else None."""
    names = list(getattr(getattr(t, "device_mesh", None), "mesh_dim_names",
                         None) or ())
    if "model" not in names:
        return None
    m = names.index("model")
    parts = t.device_mesh.size(m)
    return None if parts == 1 or cfg.num_heads % parts == 0 else m


def _head_sharded(w: torch.Tensor, dim: int, m: int) -> torch.Tensor:
    """A weight with its head dim ``dim`` zero-padded to a multiple of the
    ``model`` axis (mesh dim ``m``) and sharded over it, its other dims
    gathered: each device gathers its own heads' slice alone (the FSDP
    gather of ``model._fsdp`` leaves these weights to this), and its
    gradient is reduce-scattered over the data axes from that slice."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    h, parts = w.shape[dim], mesh.size(m)
    pad = [0, 0] * (w.dim() - 1 - dim) + [0, -(-h // parts) * parts - h]
    pl = list(w.placements)
    w = local_map(lambda t: torch.nn.functional.pad(t, pad),
                  out_placements=pl, in_placements=(pl,),
                  in_grad_placements=(pl,), device_mesh=mesh)(w)
    pl[m] = Shard(dim)
    w = w.redistribute(mesh, pl)            # each device's slice, no copy
    return w.redistribute(mesh, [Shard(dim) if i == m else Replicate()
                                 for i in range(mesh.ndim)])


def _local_heads(x, pos, w: dict, cfg, heads, real, kv_heads, kv_of,
                 q_chunk):
    """Attention of plain tensors over this device's padded query heads
    (:func:`head_slices`) and out-projected: (B, S, D), this device's share
    of the sum over the heads. ``wq``, ``bq`` and ``wo`` are this device's
    slices (:func:`_head_sharded`: zero for a padding head, whose output
    therefore adds exactly zero), the KV weights whole. Each head's
    projections, scores and output are the plain route's ops on that
    head's slice of the weights."""
    d, hd, hl = x.shape[-1], cfg.head_dim, len(heads)
    bias = cfg.qkv_bias
    q = (x @ w["wq"].reshape(d, hl * hd)).unflatten(-1, (hl, hd))
    if bias:
        q = q + w["bq"]

    def proj(wt, bias):
        y = (x @ wt[:, kv_heads].reshape(d, len(kv_heads) * hd)).unflatten(
            -1, (len(kv_heads), hd))
        return y if bias is None else y + bias[kv_heads]
    k = proj(w["wk"], w["bk"] if bias else None)
    v = proj(w["wv"], w["bv"] if bias else None)
    cos, sin = rope_frequencies(hd, cfg.rope_theta, pos)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k, v = k[:, :, kv_of], v[:, :, kv_of]
    o = _attend(q, k, v, q_chunk)
    return o.flatten(-2) @ w["wo"].reshape(hl * hd, -1)


def _head_parallel(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor,
                   q_chunk: Optional[int]):
    """GQA attention of a DTensor ``x`` with the query heads sharded over
    ``model`` where ``model`` does not divide them (a ``local_map``), or
    None where that route does not apply: a plain tensor, no ``model`` axis
    of more than one device, or heads it divides (those shard through
    :func:`_per_shard`).

    Each device projects, attends and out-projects its ``ceil(h / model)``
    heads (:func:`head_slices`), its batch rows kept: ``wq``, ``bq`` and
    ``wo`` padded with zero heads and sharded on their head dim over
    ``model`` as the reference's are (:func:`_head_sharded`), the few KV
    heads' weights whole (FSDP-gathered, replicated over ``model``). The
    output's sums over the heads are pending over ``model``. Gradients:
    ``x``'s and the KV weights' are partial sums over ``model`` (each
    device's heads), the sharded weights' are each device's own slice; the
    weights' are partial over the batch shards too."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(x, DTensor):
        return None
    m = unsharded_heads(x, cfg)
    if m is None:
        return None
    mesh = x.device_mesh
    sl = head_slices(cfg.num_heads, cfg.num_kv_heads, mesh.size(m),
                     mesh.get_local_rank(m))
    pl = [q if isinstance(q, Shard) and q.dim == 0 and i != m
          else Replicate() for i, q in enumerate(x.placements)]
    batch = [i for i, q in enumerate(pl) if isinstance(q, Shard)]
    rep = [Replicate()] * mesh.ndim
    grad_x = list(pl)
    grad_x[m] = Partial()
    out_pl = list(pl)
    out_pl[m] = Partial()
    keys = ["wq", "wk", "wv", "wo"] + (["bq", "bk", "bv"]
                                       if cfg.qkv_bias else [])
    x = x.redistribute(mesh, pl)
    if not isinstance(positions, DTensor):
        positions = distribute(positions, mesh, rep)
    positions = positions.redistribute(mesh, pl)
    ws, w_pl, w_grad = [], [], []
    for k in keys:
        dim = HEAD_DIMS.get(k)
        if dim is None:
            ws.append(p[k].redistribute(mesh, rep))
            w_pl.append(rep)
            w_grad.append([Partial() if i in batch or i == m
                           else Replicate() for i in range(mesh.ndim)])
        else:
            ws.append(_head_sharded(p[k], dim, m))
            w_pl.append([Shard(dim) if i == m else Replicate()
                         for i in range(mesh.ndim)])
            w_grad.append([Shard(dim) if i == m else
                           Partial() if i in batch else Replicate()
                           for i in range(mesh.ndim)])

    def local(xl, pos, *wl):
        return _local_heads(xl, pos, dict(zip(keys, wl)), cfg, *sl,
                            q_chunk)
    from torch.distributed.tensor.experimental import local_map
    return local_map(
        local, out_placements=out_pl,
        in_placements=(pl, pl) + tuple(w_pl),
        in_grad_placements=(grad_x, pl) + tuple(w_grad),
        device_mesh=mesh)(x, positions, *ws)


def gqa_attention_train(x: torch.Tensor, p: dict, cfg,
                        positions: torch.Tensor,
                        q_chunk: Optional[int] = None) -> torch.Tensor:
    """Full-sequence GQA attention. x: (B, S, D). On DTensors whose
    ``model`` axis does not divide the heads the heads are sharded
    anyway, padded (:func:`_head_parallel`); elsewhere each device attends
    over the heads and batch rows it holds (:func:`_per_shard`)."""
    y = _head_parallel(x, p, cfg, positions, q_chunk)
    if y is not None:
        return reduce_partial(y)
    q, k, v = _qkv(x, p, cfg)
    cos, sin = rope_frequencies(cfg.head_dim, cfg.rope_theta, positions)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    groups = cfg.num_heads // cfg.num_kv_heads
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    o = _per_shard(lambda q, k, v: _attend(q, k, v, q_chunk), q, k, v)
    return _out_project(o, p["wo"])


class DecodeStep(NamedTuple):
    """What every attention layer of one decode step shares (the reference
    recomputes it in each layer): positions (B,), the slot written,
    pos[0] as a host int (aligned batches), the RoPE tables and the
    (B, S_max) valid-slot mask."""
    pos: torch.Tensor
    start: int
    cos: torch.Tensor
    sin: torch.Tensor
    length_mask: torch.Tensor


def decode_step_tables(cfg, pos: torch.Tensor, start: int,
                       smax: int) -> DecodeStep:
    b = pos.shape[0]
    cos, sin = rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                pos.reshape(-1, 1).expand(b, 1))
    length_mask = (torch.arange(smax, device=pos.device)[None, :]
                   <= pos.reshape(-1, 1))
    return DecodeStep(pos, start, cos, sin, length_mask)


def gqa_attention_decode(x: torch.Tensor, p: dict, cfg,
                         cache_k: torch.Tensor, cache_v: torch.Tensor,
                         step: DecodeStep):
    """One-token decode. x: (B, 1, D); cache: (B, S_max, KV, hd).

    The new key and value are written into the caches in place, at slot
    ``step.start`` for the whole batch (the reference's
    ``dynamic_update_slice_in_dim`` at ``pos[0]``). Returns (out (B, 1, D),
    cache_k, cache_v)."""
    q, k, v = _qkv(x, p, cfg)
    q = apply_rope(q, step.cos, step.sin)
    k = apply_rope(k, step.cos, step.sin)
    cache_k[:, step.start:step.start + 1] = k.to(cache_k.dtype)
    cache_v[:, step.start:step.start + 1] = v.to(cache_v.dtype)
    groups = cfg.num_heads // cfg.num_kv_heads
    kk = _repeat_kv(cache_k, groups)
    vv = _repeat_kv(cache_v, groups)
    o = decode_attention(q, kk, vv, step.length_mask)
    return _out_project(o, p["wo"]), cache_k, cache_v


def cross_attention(x: torch.Tensor, memory: torch.Tensor, p: dict,
                    cfg) -> torch.Tensor:
    """Cross-attention over a fixed memory (encoder states / image tokens)."""
    q = _project(x, p["wq"])
    k = _project(memory, p["wk"])
    v = _project(memory, p["wv"])
    groups = cfg.num_heads // cfg.num_kv_heads
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    o = _per_shard(bidirectional_attention, q, k, v)
    return _out_project(o, p["wo"])


def swiglu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    h = silu(x @ p["w1"])
    h = h * (x @ p["w3"])
    # pin the hidden f-sharding so the w2 product partial-sums (one small
    # activation all-reduce) instead of gathering the w2 shard
    h = constrain(h, "dp", None, "model")
    return h @ p["w2"]


def gelu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    h = gelu(x @ p["w1"])
    h = constrain(h, "dp", None, "model")
    return h @ p["w2"]
