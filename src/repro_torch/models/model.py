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
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from . import layers as L
from .moe import moe_layer, moe_param_shapes
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


def _remat(fn: Callable, *args):
    """``fn(*args)``; with grad enabled its activations are recomputed in
    the backward pass instead of kept (the reference's
    ``jax.checkpoint``). The model draws no random numbers, so no RNG
    state is kept."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


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
        hn = _norm(x, bp["ln1"], cfg)
        q = L._project(hn, bp["attn"]["wq"])
        k = L._repeat_kv(L._project(hn, bp["attn"]["wk"]), groups)
        v = L._repeat_kv(L._project(hn, bp["attn"]["wv"]), groups)
        o = L.full_attention(q, k, v, causal=False)
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


def forward_train(params: Params, cfg, tokens: torch.Tensor,
                  extras: Optional[Dict[str, torch.Tensor]] = None,
                  q_chunk: Optional[int] = 512,
                  logits_mode: str = "all") -> torch.Tensor:
    """tokens: (B, S) → logits (B, S, V) (or (B, V) for logits_mode="last"),
    f32. With grad enabled every block is rematerialized (:func:`_remat`)."""
    b, s = tokens.shape
    x = params["embed"].to(ACT_DTYPE)[tokens]
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    memory = None
    if cfg.family == "encdec":
        memory = _encoder(params, cfg, extras["frames"].to(ACT_DTYPE))
    elif cfg.family == "vlm":
        memory = extras["image_embeds"].to(ACT_DTYPE)

    def body(x, bp, memory):
        return _block_train(x, bp, cfg, positions, memory, q_chunk)

    for bp in _unstack(params["blocks"], cfg.num_blocks):
        x = _remat(body, x, bp, memory)
    x = _norm(x, params["final_norm"], cfg)
    if logits_mode == "last":
        x = x[:, -1:]
    # bf16 product, cast to f32 after it
    logits = (x @ params["lm_head"].to(ACT_DTYPE)).float()
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
    groups = cfg.num_heads // cfg.num_kv_heads
    kk = L._repeat_kv(xk, groups)
    vv = L._repeat_kv(xv, groups)
    mask = torch.ones((x.shape[0], xk.shape[1]), dtype=torch.bool,
                      device=x.device)
    o = L.decode_attention(q, kk, vv, mask)
    return L._out_project(o, p["wo"])


def forward_decode(params: Params, cfg, tokens: torch.Tensor, cache,
                   pos: torch.Tensor):
    """tokens: (B, 1); pos: (B,) current positions (aligned batches: every
    row writes its cache slot at pos[0]).

    ``pos`` may live on the host, which spares the card a synchronize: the
    slot is read from it as a host int. ``cache`` is updated in place and
    returned. Returns (logits (B, V) f32, cache)."""
    step = None
    if "k" in cache:
        step = L.decode_step_tables(
            cfg, pos.to(tokens.device, non_blocking=True), int(pos[0]),
            cache["k"].shape[-3])
    x = params["embed"].to(ACT_DTYPE)[tokens]
    for i in range(cfg.num_blocks):
        cb = _index(cache, i)
        x, new_cb = _block_decode(x, _index(params["blocks"], i), cfg, cb,
                                  step)
        for name, leaf in new_cb.items():
            if leaf is not cb[name]:
                cb[name].copy_(leaf)
    x = _norm(x, params["final_norm"], cfg)
    logits = (x @ params["lm_head"].to(ACT_DTYPE)).float()
    return _mask_padded_vocab(logits, cfg)[:, 0], cache


# ==========================================================================
# Model facade
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any

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
        (its max held constant)."""
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        logits = _mask_padded_vocab(
            forward_train(params, self.cfg, inp, extras, q_chunk=q_chunk),
            self.cfg)
        amax = logits.detach().amax(-1, keepdim=True)
        amax = torch.where(torch.isfinite(amax), amax, 0.0)
        logz = torch.log(torch.exp(logits - amax).sum(-1)) + amax[..., 0]
        gold = torch.take_along_dim(logits, labels[..., None].long(),
                                    dim=-1)[..., 0]
        return (logz - gold).mean()

    def prefill(self, params, tokens, extras=None, q_chunk=512):
        """Forward pass returning last-position logits only."""
        logits = forward_train(params, self.cfg, tokens, extras,
                               q_chunk=q_chunk, logits_mode="last")
        return _mask_padded_vocab(logits, self.cfg)

    def decode_step(self, params, tokens, cache, pos):
        return forward_decode(params, self.cfg, tokens, cache, pos)


def build_model(cfg) -> Model:
    return Model(cfg=cfg)
