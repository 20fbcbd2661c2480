"""Model assembly on torch tensors (port of ``repro.models.model``): param
and cache shapes, init, the prefill and decode forward passes, and the
training loss.

All families share one structure: token embedding → a loop over a stack of
identical *blocks* (the smallest repeating layer pattern) → final norm →
LM head. Per-block params are stacked on a leading (num_blocks,) axis, with
the reference's leaf paths, shapes and bf16 dtype, so checkpoints
interchange (``repro_torch.convert.params_from_reference``); the
reference's ``lax.scan`` over that axis is a Python loop here.

Families:
  dense   — [GQA attn, MLP]  (granite/deepseek/internlm2/qwen2)
  moe     — [GQA attn, MoE(+dense residual)]  (arctic/dbrx)
  ssm     — [Mamba-2 SSD]  (mamba2)
  hybrid  — period-8 block: attn at slot 3, Mamba elsewhere; MoE FF on odd
            slots, dense FF on even  (jamba)
  encdec  — encoder [attn, MLP] + decoder [self, cross, MLP]  (whisper)
  vlm     — period-5 block: 4 self layers + 1 image-cross layer
            (llama-vision)

The serve path runs the forward passes under ``torch.inference_mode``;
the decode cache is updated in place. Training differentiates
:meth:`Model.loss_fn` with autograd: each block (and each encoder block)
is rematerialized in the backward pass by ``torch.utils.checkpoint``, as
the reference's ``jax.checkpoint`` scans are, and the stacked block params
are unbound once, so the gradient of a stacked leaf is one ``stack`` of its
blocks' gradients (bf16, as the reference's ``value_and_grad`` of bf16
params gives them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device

from . import layers as L
from .moe import moe_layer, moe_param_shapes
from .shard_ctx import all_reduce, constrain, gather_dp, grad_as_forward
from .ssm import CONV_K, mamba2_block, mamba2_decode, mamba2_param_shapes

Params = Dict[str, Any]

ACT_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.bfloat16


def map_tree(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a nested dict whose leaves are tensors or
    shape tuples; ``path`` holds the dict keys down to the leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def tree_paths(tree, path: tuple = ()):
    """(path, leaf) of every leaf, dict keys sorted (the reference's
    flattening order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], path + (k,))
    else:
        yield path, tree


def _index(tree, i: int):
    """Slice ``i`` of the leading axis of every leaf."""
    return map_tree(lambda _, a: a[i], tree)


def _unstack(tree, n: int) -> list:
    """The n slices of the leading axis of every leaf, one ``unbind`` a
    leaf: autograd then stacks the slices' gradients in one pass, where n
    selects would each add a zero-filled full-size gradient."""
    parts = map_tree(lambda _, a: a.unbind(0), tree)
    return [map_tree(lambda _, a: a[i], parts) for i in range(n)]


#: each block's remat unit (``layers.remat``, the reference's
#: ``jax.checkpoint`` of its scanned block)
_remat = L.remat


def _fsdp(tree, cfg=None):
    """The block's weights with their data-parallel shards gathered
    (``shard_ctx.gather_dp``), inside the remat so the backward gathers
    again; the MoE expert banks keep theirs (their data axis shards f, not
    a contraction dim), and their gradients are held to those placements
    (``shard_ctx.grad_as_forward``): each layer's bank gradient is
    reduce-scattered in that layer's backward, where DTensor would
    otherwise stack every layer's unreduced, data-replicated gradient
    before one reduce-scatter (arctic: 19.5 GB a device on 16×16). Given
    ``cfg``, the self-attention's query and output weights whose heads the
    ``model`` axis does not divide are left as they are: the head-parallel
    route gathers each device's own heads alone
    (``layers._head_sharded``)."""
    def one(path, w):
        if path[-2:-1] == ("moe",) and path[-1] in ("w1", "w2", "w3"):
            return grad_as_forward(w)
        if (cfg is not None and path[:-1] == ("attn",)
                and path[-1] in L.HEAD_DIMS
                and L.unsharded_heads(w, cfg) is not None):
            return w
        return gather_dp(w)
    return map_tree(one, tree)


def _norm(x, scale, cfg):
    if cfg.norm_type == "layer":
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        return ((xf - mu) * torch.rsqrt(var + cfg.norm_eps)).to(
            x.dtype) * scale
    return L.rms_norm(x, scale, cfg.norm_eps)


def _mlp(x, p, cfg):
    if cfg.activation == "gelu":
        return L.gelu_mlp(x, p)
    return L.swiglu_mlp(x, p)


# ==========================================================================
# Parameter shapes
# ==========================================================================

def _attn_shapes(cfg) -> Dict[str, tuple]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
         "wo": (h, hd, d)}
    if cfg.qkv_bias:
        s.update({"bq": (h, hd), "bk": (kv, hd), "bv": (kv, hd)})
    return s


def _mlp_shapes(cfg, d_ff=None) -> Dict[str, tuple]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.activation == "gelu":
        return {"w1": (d, f), "w2": (f, d)}
    return {"w1": (d, f), "w3": (d, f), "w2": (f, d)}


def _stack_shapes(tree, n: int):
    return map_tree(lambda _, s: (n,) + tuple(s), tree)


def _block_shapes(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    if cfg.family == "dense":
        return {"ln1": (d,), "attn": _attn_shapes(cfg),
                "ln2": (d,), "mlp": _mlp_shapes(cfg)}
    if cfg.family == "moe":
        return {"ln1": (d,), "attn": _attn_shapes(cfg),
                "ln2": (d,), "moe": moe_param_shapes(cfg, cfg.d_ff_moe)}
    if cfg.family == "ssm":
        return {"ln1": (d,), "mamba": mamba2_param_shapes(cfg)}
    if cfg.family == "hybrid":
        per = cfg.period
        n_moe = per // cfg.moe_every
        return {
            "ln_mix": (per, d),
            "ln_ff": (per, d),
            "attn": _attn_shapes(cfg),
            "mamba": _stack_shapes(mamba2_param_shapes(cfg), per - 1),
            "moe": _stack_shapes(moe_param_shapes(cfg, cfg.d_ff_moe), n_moe),
            "mlp": _stack_shapes(_mlp_shapes(cfg), per - n_moe),
        }
    if cfg.family == "encdec":
        return {"ln1": (d,), "self_attn": _attn_shapes(cfg),
                "ln2": (d,), "cross_attn": _attn_shapes(cfg),
                "ln3": (d,), "mlp": _mlp_shapes(cfg)}
    if cfg.family == "vlm":
        return {
            "self": _stack_shapes({"ln1": (d,), "attn": _attn_shapes(cfg),
                                   "ln2": (d,), "mlp": _mlp_shapes(cfg)},
                                  cfg.period - 1),
            "cross": {"ln1": (d,), "attn": _attn_shapes(cfg),
                      "ln2": (d,), "mlp": _mlp_shapes(cfg),
                      "gate_attn": (), "gate_mlp": ()},
        }
    raise ValueError(cfg.family)


def param_shapes(cfg) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.padded_vocab
    shapes: Dict[str, Any] = {
        "embed": (v, d),
        "final_norm": (d,),
        "lm_head": (d, v),
        "blocks": _stack_shapes(_block_shapes(cfg), cfg.num_blocks),
    }
    if cfg.family == "encdec":
        shapes["enc_blocks"] = _stack_shapes(
            {"ln1": (d,), "attn": _attn_shapes(cfg),
             "ln2": (d,), "mlp": _mlp_shapes(cfg)}, cfg.encoder_layers)
        shapes["enc_pos"] = (cfg.encoder_frames, d)
        shapes["enc_final_norm"] = (d,)
    return shapes


def count_params(cfg, active_only: bool = False) -> int:
    total = 0
    for path, shp in tree_paths(param_shapes(cfg)):
        size = math.prod(shp)
        if active_only and cfg.num_experts:
            if "moe" in path and any(k in ("w1", "w2", "w3") for k in path):
                size = size * cfg.experts_per_token // cfg.num_experts
        total += size
    return total


def init_params(cfg, seed: int = 0,
                device: str | torch.device = "cuda") -> Params:
    """Materialized init on ``device``, leaf by leaf in the reference's
    order from one ``torch.Generator`` of that device seeded with ``seed``
    (so the values depend on the device's generator, and differ from the
    reference's), by the reference's per-leaf rules."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def init_one(path, shp):
        name = path[-1]
        shp = tuple(shp)
        if name.startswith(("ln", "out_norm")) or "norm" in name or \
                name in ("D_skip",):
            return torch.ones(shp, dtype=PARAM_DTYPE, device=dev)
        if name == "dt_bias":
            return torch.full(shp, -4.6, dtype=PARAM_DTYPE, device=dev)
        if name == "A_log":
            a = torch.log(torch.linspace(1.0, 8.0, shp[-1],
                                         dtype=torch.float32, device=dev))
            return a.to(PARAM_DTYPE) * torch.ones(shp, dtype=PARAM_DTYPE,
                                                  device=dev)
        if name.startswith(("b", "gate")):
            return torch.zeros(shp, dtype=PARAM_DTYPE, device=dev)
        # fan-in per leaf: (d, h, hd) projects from d, wo (h, hd, d) from h·hd
        if name in ("wq", "wk", "wv"):
            fan_in = shp[-3]
        elif name == "wo":
            fan_in = shp[-3] * shp[-2]
        elif len(shp) >= 2:
            fan_in = shp[-2]
        else:
            fan_in = max(1, shp[-1] if shp else 1)
        # unit-scale embeddings; depth-scaled residual-out projections
        scale = 1.0 if name == "embed" else 1.0 / math.sqrt(fan_in)
        if name in ("wo", "w2", "out_proj"):
            scale /= math.sqrt(2.0 * max(1, cfg.num_layers))
        return (torch.randn(shp, generator=gen, dtype=torch.float32,
                            device=dev) * scale).to(PARAM_DTYPE)

    shapes = param_shapes(cfg)
    leaves = {path: init_one(path, shp) for path, shp in tree_paths(shapes)}
    return map_tree(lambda path, _: leaves[path], shapes)


def abstract_params(cfg) -> Params:
    """The params as ``meta`` tensors: the reference's shapes and bf16
    dtype, no storage (the dry run's stand-ins)."""
    return map_tree(lambda _, s: torch.empty(s, dtype=PARAM_DTYPE,
                                             device="meta"),
                    param_shapes(cfg))


def count_expert_params(cfg) -> int:
    """Parameters in MoE expert banks (2D-shardable at decode)."""
    return sum(math.prod(shp) for path, shp in tree_paths(param_shapes(cfg))
               if "moe" in path and path[-1] in ("w1", "w2", "w3"))


# ==========================================================================
# Sharding rules
# ==========================================================================
#
# A spec is a tuple with one entry per tensor dim (trailing ``None``s may be
# left off), each entry ``None`` (replicated), a mesh axis name, or a tuple
# of names that shards one dim over several mesh axes, major first: the
# reference's ``PartitionSpec`` as a plain tuple. ``shard_ctx.placements``
# turns one into DTensor placements on a mesh.

Spec = Tuple[Any, ...]


def _canon(spec) -> Spec:
    """A one-name tuple entry stands as the name, as ``PartitionSpec``
    writes it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


# spec for the TRAILING dims of each named leaf; leading stack axes get None
_PARAM_RULES = {
    "embed": ("model", "data"),
    "lm_head": ("data", "model"),
    "enc_pos": (None, None),
    "wq": ("data", "model", None),
    "wk": ("data", "model", None),
    "wv": ("data", "model", None),
    "wo": ("model", None, "data"),
    "bq": ("model", None),
    "bk": ("model", None),
    "bv": ("model", None),
    "w1": ("data", "model"),
    "w3": ("data", "model"),
    "w2": ("model", "data"),
    "router": ("data", None),
    "in_proj": ("data", "model"),
    "out_proj": ("model", "data"),
    "conv_w": (None, "model"),
    "dt_bias": ("model",),
    "A_log": ("model",),
    "D_skip": ("model",),
    "out_norm": ("model",),
}

# Expert banks are 2D-sharded on (experts × ff), never on the contraction
# dim: contraction-dim (FSDP) sharding would gather a whole expert bank a
# layer a microbatch under gradient accumulation, where ff-dim sharding
# costs only small activation reshards around the grouped products.
_MOE_RULES = {
    "w1": ("model", None, "data"),
    "w3": ("model", None, "data"),
    "w2": ("model", None, "data"),
}

# Decode-mode rules: weights sharded on NON-contracting dims only (Megatron
# TP), so a token step never gathers weight shards (FSDP's contraction-dim
# sharding amortizes over a training batch but costs a full weight gather a
# decode step). Expert banks keep their 2D (model × data) sharding.
_PARAM_RULES_DECODE = {
    "embed": ("model", None),
    "lm_head": (None, "model"),
    "enc_pos": (None, None),
    "wq": (None, "model", None),
    "wk": (None, "model", None),
    "wv": (None, "model", None),
    "wo": ("model", None, None),
    "bq": ("model", None),
    "bk": ("model", None),
    "bv": ("model", None),
    "w1": (None, "model"),
    "w3": (None, "model"),
    "w2": ("model", None),
    "router": (None, None),
    "in_proj": (None, "model"),
    "out_proj": ("model", None),
    "conv_w": (None, "model"),
    "dt_bias": ("model",),
    "A_log": ("model",),
    "D_skip": ("model",),
    "out_norm": ("model",),
}

_MOE_RULES_DECODE = {
    "w1": ("model", None, "data"),
    "w3": ("model", None, "data"),
    # w2 sharded on its OUTPUT dim (d over data), contraction f unsharded:
    # the reshard is then a small gather of h, not a gather of w2
    "w2": ("model", None, "data"),
}

# TP-only dense shards above this many bytes a device keep the train-mode
# FSDP rules at decode (capacity over collective cost): llama-3.2-vision's
# 90B dense params would be 11.25 GB a device on a 16-way model axis, and
# arctic's 56 attention heads (not divisible by 16) would replicate 8.2 GB
# of attention weights.
_DECODE_TP_BUDGET_BYTES = 4e9


def fit_spec(spec: Spec, shape, axis_sizes: Optional[Dict[str, int]]
             ) -> Spec:
    """Drop sharded axes that do not divide the dimension evenly (qwen2's
    kv=2 cannot shard over model=16; granite's odd vocabulary cannot shard
    at all): the undivisible dims fall back to replication. The result has
    one entry per dim of ``shape``; without ``axis_sizes`` ``spec`` comes
    back as it is."""
    if axis_sizes is None:
        return _canon(spec)
    new = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        if ax is None:
            new.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = math.prod(axis_sizes.get(a, 1) for a in axes)
        new.append(ax if (size > 0 and dim % size == 0) else None)
    return _canon(new)


def param_specs(cfg, axis_sizes: Optional[Dict[str, int]] = None,
                mode: str = "train") -> Params:
    """Spec tree matching ``param_shapes(cfg)``.

    ``axis_sizes`` (e.g. {"data": 16, "model": 16}) enables shape-aware
    fitting; without it the raw logical rules are returned. ``mode``:
    "train" = FSDP×TP (contraction dims sharded over data, weight gathers
    amortized over the batch); "decode" = TP-only (no per-step weight
    gathers; falls back to the train rules when the TP shard would not
    fit the decode budget)."""
    decode = mode == "decode"
    if decode and axis_sizes:
        tp = axis_sizes.get("model", 1)
        dp = axis_sizes.get("data", 1)
        # expert banks stay 2D-sharded at decode; only the dense remainder
        # is TP-only. Gate on the per-device bytes the decode rules give.
        n_moe = count_expert_params(cfg)
        n_dense = count_params(cfg) - n_moe
        per_dev = 2.0 * (n_dense / tp + n_moe / (tp * dp))
        if per_dev > _DECODE_TP_BUDGET_BYTES:
            decode = False      # capacity-forced FSDP (e.g. vlm-90b)
    rules_main = _PARAM_RULES_DECODE if decode else _PARAM_RULES
    rules_moe = _MOE_RULES_DECODE if decode else _MOE_RULES

    def spec_for(path, shp):
        name = path[-1]
        rules = rules_moe if ("moe" in path and name in rules_moe) \
            else rules_main
        base = rules.get(name)
        if base is None:
            return ()           # norms, gates, scalars: replicated
        pad = len(shp) - len(base)
        if pad < 0:             # leaf smaller than its rule
            return ()
        return fit_spec((None,) * pad + base, shp, axis_sizes)

    return map_tree(spec_for, param_shapes(cfg))


def batch_spec(dp_axes) -> Spec:
    return _canon((dp_axes, None))


def cache_specs(cfg, dp_axes, batch: int, seq: int,
                axis_sizes: Optional[Dict[str, int]] = None,
                shard_seq: bool = True) -> Any:
    """Spec tree matching ``cache_shapes(cfg, batch, seq)``."""
    def spec_for(path, shp):
        name = path[-1]
        if name in ("k", "v"):
            base = (dp_axes, "model" if shard_seq else None, None, None)
        elif name in ("xk", "xv"):
            base = (dp_axes, None, None, None)
        elif name == "ssm":
            base = (dp_axes, "model", None, None)
        elif name == "conv":
            base = (dp_axes, None, "model")
        else:
            return ()
        return fit_spec((None,) * (len(shp) - len(base)) + base, shp,
                        axis_sizes)

    return map_tree(spec_for, cache_shapes(cfg, batch, seq))


# ==========================================================================
# Cache shapes
# ==========================================================================

def cache_shapes(cfg, batch: int, seq: int) -> Dict[str, Any]:
    """Decode-cache shapes (tuples) for one model."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    nb = cfg.num_blocks
    h, n, pdim = (cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim) \
        if cfg.ssm_state else (0, 0, 0)
    conv_c = cfg.ssm_inner + 2 * cfg.ssm_state if cfg.ssm_state else 0
    if cfg.family in ("dense", "moe"):
        return {"k": (nb, batch, seq, kv, hd), "v": (nb, batch, seq, kv, hd)}
    if cfg.family == "ssm":
        return {"ssm": (nb, batch, h, n, pdim),
                "conv": (nb, batch, CONV_K - 1, conv_c)}
    if cfg.family == "hybrid":
        nm = cfg.period - 1
        return {"k": (nb, batch, seq, kv, hd),
                "v": (nb, batch, seq, kv, hd),
                "ssm": (nb, nm, batch, h, n, pdim),
                "conv": (nb, nm, batch, CONV_K - 1, conv_c)}
    if cfg.family == "encdec":
        return {"k": (nb, batch, seq, kv, hd),
                "v": (nb, batch, seq, kv, hd),
                "xk": (nb, batch, cfg.encoder_frames, kv, hd),
                "xv": (nb, batch, cfg.encoder_frames, kv, hd)}
    if cfg.family == "vlm":
        ns = cfg.period - 1
        return {"k": (nb, ns, batch, seq, kv, hd),
                "v": (nb, ns, batch, seq, kv, hd),
                "xk": (nb, batch, cfg.num_image_tokens, kv, hd),
                "xv": (nb, batch, cfg.num_image_tokens, kv, hd)}
    raise ValueError(cfg.family)


def abstract_cache(cfg, batch: int, seq: int):
    """The decode cache as bf16 ``meta`` tensors."""
    return map_tree(lambda _, s: torch.empty(s, dtype=ACT_DTYPE,
                                             device="meta"),
                    cache_shapes(cfg, batch, seq))


def zero_cache(cfg, batch: int, seq: int,
               device: str | torch.device = "cuda"):
    dev = resolve_device(device)
    return map_tree(lambda _, s: torch.zeros(s, dtype=ACT_DTYPE, device=dev),
                    cache_shapes(cfg, batch, seq))


# ==========================================================================
# Block forward functions (prefill)
# ==========================================================================

def _attn_sub(x, ln, attn_p, cfg, positions, q_chunk):
    return x + L.gqa_attention_train(_norm(x, ln, cfg), attn_p, cfg,
                                     positions, q_chunk=q_chunk)


def _block_train(x, bp, cfg, positions, memory, q_chunk):
    if cfg.family == "dense":
        x = _attn_sub(x, bp["ln1"], bp["attn"], cfg, positions, q_chunk)
        return x + _mlp(_norm(x, bp["ln2"], cfg), bp["mlp"], cfg)
    if cfg.family == "moe":
        x = _attn_sub(x, bp["ln1"], bp["attn"], cfg, positions, q_chunk)
        return x + moe_layer(_norm(x, bp["ln2"], cfg), bp["moe"], cfg)
    if cfg.family == "ssm":
        return x + mamba2_block(_norm(x, bp["ln1"], cfg), bp["mamba"], cfg)
    if cfg.family == "hybrid":
        mi = di = 0
        for i in range(cfg.period):
            h = _norm(x, bp["ln_mix"][i], cfg)
            if i == cfg.period // 2 - 1:      # attn slot (1:7 interleave)
                x = x + L.gqa_attention_train(h, bp["attn"], cfg, positions,
                                              q_chunk=q_chunk)
            else:
                x = x + mamba2_block(h, _index(bp["mamba"], mi), cfg)
                mi += 1
            hf = _norm(x, bp["ln_ff"][i], cfg)
            if i % cfg.moe_every == 1:
                x = x + moe_layer(hf, _index(bp["moe"], i // cfg.moe_every),
                                  cfg)
            else:
                x = x + _mlp(hf, _index(bp["mlp"], di), cfg)
                di += 1
        return x
    if cfg.family == "encdec":
        x = _attn_sub(x, bp["ln1"], bp["self_attn"], cfg, positions, q_chunk)
        x = x + L.cross_attention(_norm(x, bp["ln2"], cfg), memory,
                                  bp["cross_attn"], cfg)
        return x + _mlp(_norm(x, bp["ln3"], cfg), bp["mlp"], cfg)
    if cfg.family == "vlm":
        for i in range(cfg.period - 1):
            sp = _index(bp["self"], i)
            x = _attn_sub(x, sp["ln1"], sp["attn"], cfg, positions, q_chunk)
            x = x + _mlp(_norm(x, sp["ln2"], cfg), sp["mlp"], cfg)
        cp = bp["cross"]
        x = x + torch.tanh(cp["gate_attn"]) * L.cross_attention(
            _norm(x, cp["ln1"], cfg), memory, cp["attn"], cfg)
        return x + torch.tanh(cp["gate_mlp"]) * _mlp(
            _norm(x, cp["ln2"], cfg), cp["mlp"], cfg)
    raise ValueError(cfg.family)


def _encoder(params, cfg, frames):
    """Whisper encoder over stubbed frame embeddings (B, F, D): learned
    positions, bidirectional self-attention without RoPE."""
    x = frames + params["enc_pos"][None].to(frames.dtype)
    groups = cfg.num_heads // cfg.num_kv_heads

    def body(x, bp):
        bp = _fsdp(bp)
        hn = _norm(x, bp["ln1"], cfg)
        q = L._project(hn, bp["attn"]["wq"])
        k = L._repeat_kv(L._project(hn, bp["attn"]["wk"]), groups)
        v = L._repeat_kv(L._project(hn, bp["attn"]["wv"]), groups)
        o = L._per_shard(L.bidirectional_attention, q, k, v)
        x = x + L._out_project(o, bp["attn"]["wo"])
        return x + _mlp(_norm(x, bp["ln2"], cfg), bp["mlp"], cfg)

    for bp in _unstack(params["enc_blocks"], cfg.encoder_layers):
        x = _remat(body, x, bp)
    return _norm(x, params["enc_final_norm"], cfg)


def _mask_padded_vocab(logits: torch.Tensor, cfg) -> torch.Tensor:
    """Vocabulary-padding slots get -1e30, so they never win."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    valid = torch.arange(cfg.padded_vocab,
                         device=logits.device) < cfg.vocab_size
    return torch.where(valid, logits, L.NEG_BIAS)


def _vocab_shard(t: torch.Tensor, vdim: int):
    """(offset, width) of this device's slice of dim ``vdim`` of a DTensor:
    its vocabulary shard (mesh axes major first)."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    offset, width = 0, t.shape[vdim]
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == vdim:
            width //= mesh.size(i)
            offset = offset * mesh.size(i) + mesh.get_local_rank(i)
    return offset * width, width


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. On a DTensor table sharded over the vocabulary each
    device looks up the tokens in its own rows (0 elsewhere) and the
    partial sums reduce over the vocabulary's mesh axes (a vocabulary-
    parallel embedding); the model dim is gathered first. DTensor's own
    strategies for this gather and its backward scatter do not cover a
    sharded table on every torch (2.11 has none)."""
    if not hasattr(table, "device_mesh"):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tab_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in table.placements]
    table = table.redistribute(mesh, tab_pl)
    vocab = [isinstance(p, Shard) for p in tab_pl]
    tok_pl = [Replicate() if v else p
              for v, p in zip(vocab, tokens.placements)]
    tokens = tokens.redistribute(mesh, tok_pl)
    out_pl = [Partial() if v else p for v, p in zip(vocab, tok_pl)]
    offset, width = _vocab_shard(table, 0)

    def lookup(tab, tok):
        ids = tok.long() - offset
        mine = (ids >= 0) & (ids < width)
        return torch.where(mine[..., None], tab[ids.clamp(0, width - 1)], 0)
    return local_map(lookup, out_placements=out_pl,
                     in_placements=(tab_pl, tok_pl),
                     device_mesh=mesh)(table, tokens)


def _gold_local(logits: torch.Tensor, labels: torch.Tensor,
                offset: int = 0) -> torch.Tensor:
    """``logits[..., labels]`` as a masked sum over the vocabulary slots
    ``offset`` + [0, V): exact (one term, the rest +0.0), and 0 where the
    label lies outside the slots."""
    vocab = torch.arange(offset, offset + logits.shape[-1],
                         device=logits.device)
    return torch.where(vocab == labels[..., None], logits, 0.0).sum(-1)


def _gold_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The logit of each label, (B, S). On a vocabulary-sharded DTensor each
    device sums its own slots (``local_map``) and the partial sums reduce
    over the vocabulary's mesh axes: DTensor has no sharded strategy for a
    gather, and a masked sum on the global layout would build the mask and
    the gradient at the full vocabulary on every device."""
    if not hasattr(logits, "device_mesh"):
        return _gold_local(logits, labels)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    vdim = logits.dim() - 1
    lab_pl, out_pl = [], []
    for p in logits.placements:
        if isinstance(p, Shard) and p.dim == vdim:
            lab_pl.append(Replicate())
            out_pl.append(Partial())
        else:
            lab_pl.append(p)
            out_pl.append(p)
    labels = labels.redistribute(mesh, lab_pl)
    offset, _ = _vocab_shard(logits, vdim)
    return local_map(lambda lg, lb: _gold_local(lg, lb, offset),
                     out_placements=out_pl,
                     in_placements=(logits.placements, lab_pl),
                     device_mesh=mesh)(logits, labels)


def _vocab_dims(logits: torch.Tensor) -> list:
    """The mesh dims sharding a DTensor's last (vocabulary) dim; [] for a
    plain tensor."""
    if not hasattr(logits, "device_mesh"):
        return []
    from torch.distributed.tensor import Shard
    vdim = logits.dim() - 1
    return [i for i, p in enumerate(logits.placements)
            if isinstance(p, Shard) and p.dim == vdim]


class _ShardLogZ(torch.autograd.Function):
    """The log-sum-exp over the whole vocabulary of a device's vocabulary
    shard ``lg`` (``valid``: its non-padding slots, or None), reduced over
    the mesh dims ``vdims``: the max (detached, as ``jax.nn.logsumexp``
    holds it) and the sum of exponentials each in one all-reduce, the same
    (B, S) result on every device of a vocabulary group. The gradient of a
    shard needs no collective: the sum's gradient is its replicated
    ``g / s`` times the shard's own exponentials (autograd's chain for
    ``log(exp(lg − amax).sum(-1))``)."""

    @staticmethod
    def forward(ctx, lg, valid, mesh, vdims):
        if valid is not None:
            lg = torch.where(valid, lg, L.NEG_BIAS)
        amax = lg.amax(-1, keepdim=True)
        for i in vdims:
            amax = all_reduce(amax, mesh, i, "max")
        amax = torch.where(torch.isfinite(amax), amax, 0.0)
        e = torch.exp(lg - amax)
        tot = e.sum(-1)
        for i in vdims:
            tot = all_reduce(tot, mesh, i)
        ctx.save_for_backward(e, tot)
        return torch.log(tot) + amax[..., 0]

    @staticmethod
    def backward(ctx, g):
        e, tot = ctx.saved_tensors
        return (g / tot)[..., None] * e, None, None, None


def _vocab_parallel_logz(logits: torch.Tensor, cfg) -> torch.Tensor:
    """``logsumexp`` of the masked logits over the vocabulary, (B, S), for a
    DTensor sharded on it: each device masks its own padding slots and
    reduces its shard (:class:`_ShardLogZ` in a ``local_map``), so no
    device holds the whole vocabulary. DTensor's own plan of the plain ops
    gathers the logits' gradient at the full vocabulary."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    vdims = _vocab_dims(logits)
    offset, width = _vocab_shard(logits, logits.dim() - 1)
    out_pl = [Replicate() if i in vdims else p
              for i, p in enumerate(logits.placements)]

    def local(lg):
        valid = None
        if cfg.padded_vocab != cfg.vocab_size:
            valid = torch.arange(offset, offset + width,
                                 device=lg.device) < cfg.vocab_size
        return _ShardLogZ.apply(lg, valid, mesh, vdims)
    return local_map(local, out_placements=out_pl,
                     in_placements=(logits.placements,),
                     device_mesh=mesh)(logits)


def forward_train(params: Params, cfg, tokens: torch.Tensor,
                  extras: Optional[Dict[str, torch.Tensor]] = None,
                  q_chunk: Optional[int] = 512,
                  logits_mode: str = "all") -> torch.Tensor:
    """tokens: (B, S) → logits (B, S, V) (or (B, V) for logits_mode="last"),
    f32. With grad enabled every block is rematerialized (:func:`_remat`)."""
    b, s = tokens.shape
    x = constrain(_embed(params["embed"].to(ACT_DTYPE), tokens), "dp", None,
                  None)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    memory = None
    if cfg.family == "encdec":
        memory = _encoder(params, cfg, extras["frames"].to(ACT_DTYPE))
    elif cfg.family == "vlm":
        memory = extras["image_embeds"].to(ACT_DTYPE)

    def body(x, bp, memory):
        return constrain(_block_train(x, _fsdp(bp, cfg), cfg, positions,
                                      memory, q_chunk), "dp", None, None)

    for bp in _unstack(params["blocks"], cfg.num_blocks):
        x = _remat(body, x, bp, memory)
    x = _norm(x, params["final_norm"], cfg)
    if logits_mode == "last":
        x = x[:, -1:]
    # bf16 product, cast to f32 after it
    logits = constrain(x @ gather_dp(params["lm_head"]).to(ACT_DTYPE), "dp",
                       None, "model").float()
    return logits[:, 0] if logits_mode == "last" else logits


# ==========================================================================
# Decode (serve_step)
# ==========================================================================

def _attn_decode_sub(x, ln, attn_p, cfg, k, v, step):
    h = _norm(x, ln, cfg)
    o, k, v = L.gqa_attention_decode(h, attn_p, cfg, k, v, step)
    return x + o, k, v


def _block_decode(x, bp, cfg, cache_b, step):
    """One block, one token. cache_b: this block's cache slices (views);
    attention writes its slot in place, the other leaves come back new."""
    if cfg.family in ("dense", "moe"):
        x, k, v = _attn_decode_sub(x, bp["ln1"], bp["attn"], cfg,
                                   cache_b["k"], cache_b["v"], step)
        if cfg.family == "dense":
            x = x + _mlp(_norm(x, bp["ln2"], cfg), bp["mlp"], cfg)
        else:
            x = x + moe_layer(_norm(x, bp["ln2"], cfg), bp["moe"], cfg)
        return x, {"k": k, "v": v}
    if cfg.family == "ssm":
        h = _norm(x, bp["ln1"], cfg)
        o, st, cv = mamba2_decode(h, bp["mamba"], cfg,
                                  cache_b["ssm"], cache_b["conv"])
        return x + o, {"ssm": st, "conv": cv}
    if cfg.family == "hybrid":
        new_ssm, new_conv = [], []
        k = v = None
        mi = di = 0
        for i in range(cfg.period):
            h = _norm(x, bp["ln_mix"][i], cfg)
            if i == cfg.period // 2 - 1:
                o, k, v = L.gqa_attention_decode(h, bp["attn"], cfg,
                                                 cache_b["k"], cache_b["v"],
                                                 step)
            else:
                o, st, cv = mamba2_decode(h, _index(bp["mamba"], mi), cfg,
                                          cache_b["ssm"][mi],
                                          cache_b["conv"][mi])
                new_ssm.append(st)
                new_conv.append(cv)
                mi += 1
            x = x + o
            hf = _norm(x, bp["ln_ff"][i], cfg)
            if i % cfg.moe_every == 1:
                x = x + moe_layer(hf, _index(bp["moe"], i // cfg.moe_every),
                                  cfg)
            else:
                x = x + _mlp(hf, _index(bp["mlp"], di), cfg)
                di += 1
        return x, {"k": k, "v": v, "ssm": torch.stack(new_ssm),
                   "conv": torch.stack(new_conv)}
    if cfg.family == "encdec":
        x, k, v = _attn_decode_sub(x, bp["ln1"], bp["self_attn"], cfg,
                                   cache_b["k"], cache_b["v"], step)
        h = _norm(x, bp["ln2"], cfg)
        x = x + _cross_decode(h, bp["cross_attn"], cfg,
                              cache_b["xk"], cache_b["xv"])
        x = x + _mlp(_norm(x, bp["ln3"], cfg), bp["mlp"], cfg)
        return x, {"k": k, "v": v, "xk": cache_b["xk"], "xv": cache_b["xv"]}
    if cfg.family == "vlm":
        for i in range(cfg.period - 1):
            sp = _index(bp["self"], i)
            x, _, _ = _attn_decode_sub(x, sp["ln1"], sp["attn"], cfg,
                                       cache_b["k"][i], cache_b["v"][i], step)
            x = x + _mlp(_norm(x, sp["ln2"], cfg), sp["mlp"], cfg)
        cp = bp["cross"]
        h = _norm(x, cp["ln1"], cfg)
        x = x + torch.tanh(cp["gate_attn"]) * _cross_decode(
            h, cp["attn"], cfg, cache_b["xk"], cache_b["xv"])
        x = x + torch.tanh(cp["gate_mlp"]) * _mlp(
            _norm(x, cp["ln2"], cfg), cp["mlp"], cfg)
        return x, cache_b
    raise ValueError(cfg.family)


def _cross_decode(x, p, cfg, xk, xv):
    """Cross-attention against precomputed memory K/V. x: (B, 1, D)."""
    q = L._project(x, p["wq"])
    mask = torch.ones((x.shape[0], xk.shape[1]), dtype=torch.bool,
                      device=x.device)
    o = L.cache_attention(q, xk, xv, mask, cfg.num_heads // cfg.num_kv_heads)
    return L._out_project(o, p["wo"])


def forward_decode(params: Params, cfg, tokens: torch.Tensor, cache,
                   pos: torch.Tensor):
    """tokens: (B, 1); pos: (B,) current positions (aligned batches: every
    row writes its cache slot at pos[0]).

    ``pos`` may live on the host, which spares the card a synchronize: the
    slot is read from it as a host int (a ``meta`` pos, the dry run's, has
    no value: its slot is taken as 0, which the step's cost does not
    depend on). ``cache`` is updated in place and returned. Returns
    (logits (B, V) f32, cache)."""
    step = None
    if "k" in cache:
        step = L.decode_step_tables(
            cfg, pos.to(tokens.device, non_blocking=True),
            0 if pos.is_meta else int(pos[0]), cache["k"].shape[-3])
    x = constrain(_embed(params["embed"].to(ACT_DTYPE), tokens), "dp", None,
                  None)
    for i in range(cfg.num_blocks):
        cb = _index(cache, i)
        # the weights stay where they are (no FSDP gather, unlike the train
        # step): a token's activations are far smaller than a block's
        # weights, and DTensor then moves them instead, as the reference's
        # plan does (arctic decode: 15.8 → 0.23 GB of collectives a step)
        x, new_cb = _block_decode(x, _index(params["blocks"], i),
                                  cfg, cb, step)
        x = constrain(x, "dp", None, None)
        for name, leaf in new_cb.items():
            if leaf is not cb[name]:
                cb[name].copy_(leaf)
    x = _norm(x, params["final_norm"], cfg)
    logits = (x @ gather_dp(params["lm_head"]).to(ACT_DTYPE)).float()
    return _mask_padded_vocab(logits, cfg)[:, 0], cache


# ==========================================================================
# Model facade
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any

    def abstract_params(self):
        return abstract_params(self.cfg)

    def param_specs(self):
        return param_specs(self.cfg)

    def init(self, seed: int = 0, device: str | torch.device = "cuda"):
        return init_params(self.cfg, seed, device)

    def extras_shapes(self, batch: int) -> Dict[str, tuple]:
        cfg = self.cfg
        if cfg.family == "encdec":
            return {"frames": (batch, cfg.encoder_frames, cfg.d_model)}
        if cfg.family == "vlm":
            return {"image_embeds": (batch, cfg.num_image_tokens,
                                     cfg.d_model)}
        return {}

    def loss_fn(self, params, tokens, extras=None, q_chunk=512):
        """tokens: (B, S+1). Mean next-token cross-entropy in f32: the
        reference's ``logsumexp − gold`` over the padded vocabulary, pad
        slots masked to ``NEG_BIAS``, the logsumexp as ``jax.nn`` writes it
        (its max held constant). Logits sharded on the vocabulary (a
        DTensor) take the vocabulary-parallel route
        (:func:`_vocab_parallel_logz`, :func:`_gold_logits`)."""
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        logits = forward_train(params, self.cfg, inp, extras,
                               q_chunk=q_chunk)
        if _vocab_dims(logits):
            # the labels lie in the vocabulary, so the gold logits need no
            # mask
            return (_vocab_parallel_logz(logits, self.cfg)
                    - _gold_logits(logits, labels)).mean()
        logits = _mask_padded_vocab(logits, self.cfg)
        amax = logits.detach().amax(-1, keepdim=True)
        amax = torch.where(torch.isfinite(amax), amax, 0.0)
        logz = torch.log(torch.exp(logits - amax).sum(-1)) + amax[..., 0]
        return (logz - _gold_logits(logits, labels)).mean()

    def prefill(self, params, tokens, extras=None, q_chunk=512):
        """Forward pass returning last-position logits only."""
        logits = forward_train(params, self.cfg, tokens, extras,
                               q_chunk=q_chunk, logits_mode="last")
        return _mask_padded_vocab(logits, self.cfg)

    def decode_step(self, params, tokens, cache, pos):
        return forward_decode(params, self.cfg, tokens, cache, pos)


def build_model(cfg) -> Model:
    return Model(cfg=cfg)
