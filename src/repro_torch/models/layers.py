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
from typing import NamedTuple, Optional

import torch

from .shard_ctx import constrain, fit_dim, reduce_partial

NEG_BIAS = -1e30


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

    On DTensors (decode: training and prefill attend per shard,
    :func:`_per_shard`) the heads are replicated first: the product folds
    (b, h) into one batch dim, which DTensor cannot do with h sharded
    (torch 2.11 refuses; 2.13 plans it through strided shards at a far
    higher cost)."""
    q, k = fit_dim(q, 2, 1), fit_dim(k, 2, 1)
    return ((q.transpose(1, 2) @ k.permute(0, 2, 3, 1)).float()
            / math.sqrt(q.shape[-1]))


def _weighted(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``bhqk,bkhd->bqhd`` (heads replicated on DTensors, as in
    :func:`_scores`)."""
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
    instead of O(Sq · Sk). Each chunk is a full softmax over all keys, so
    it equals :func:`full_attention` up to accumulation order."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if sq % q_chunk:
        raise ValueError(f"query length {sq} is not a multiple of the "
                         f"chunk {q_chunk}")
    kpos = torch.arange(sk, device=q.device)
    outs = []
    for ci in range(sq // q_chunk):
        qc = q[:, ci * q_chunk:(ci + 1) * q_chunk]
        scores = _scores(qc, k)
        if causal:
            qpos = (ci * q_chunk + (sk - sq)
                    + torch.arange(q_chunk, device=q.device))
            scores += _causal_bias(qpos, kpos)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        outs.append(_weighted(probs, v))
    return torch.cat(outs, dim=1)


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


def gqa_attention_train(x: torch.Tensor, p: dict, cfg,
                        positions: torch.Tensor,
                        q_chunk: Optional[int] = None) -> torch.Tensor:
    """Full-sequence GQA attention. x: (B, S, D)."""
    s = x.shape[1]
    q, k, v = _qkv(x, p, cfg)
    cos, sin = rope_frequencies(cfg.head_dim, cfg.rope_theta, positions)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    groups = cfg.num_heads // cfg.num_kv_heads
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    if q_chunk is not None and s > q_chunk:
        o = _per_shard(lambda q, k, v: chunked_attention(q, k, v,
                                                         q_chunk=q_chunk),
                       q, k, v)
    else:
        o = _per_shard(full_attention, q, k, v)
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
