"""Mamba-2 SSD (state-space duality) blocks on torch tensors (port of
``repro.models.ssm``): the chunked scan for a whole sequence and the O(1)
recurrent decode.

Within chunks of length Q the output is an attention-like quadratic form
masked by cumulative decays; across chunks an (H, N, P) state is carried
by a linear recurrence (a loop over the chunks, where the reference scans).

Shapes (per layer): x (B, S, H, P) heads×headdim, B/C (B, S, N) shared
across heads (G=1), dt (B, S, H), A (H,) negative decay rates.
"""
from __future__ import annotations

import torch

from .layers import rms_norm, silu
from .shard_ctx import fit_dim

CONV_K = 4   # causal depthwise conv width (Mamba standard)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` by its op sequence."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


#: XLA rewrites a cumulative sum longer than this into blocks of it
#: (``ReduceWindowRewriter``): a sequential sum within each block, plus the
#: exclusive prefix of the block totals, scanned the same way
_SCAN_BLOCK = 16


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis in x's dtype, one element
    after another (rounded at every step)."""
    out = list(x.unbind(-1))
    for i in range(1, len(out)):
        out[i] = out[i - 1] + out[i]
    return torch.stack(out, -1)


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum accumulated in x's dtype as the reference's
    ``jnp.cumsum`` computes it on the CPU: sequential within blocks of 16,
    each block then offset by the exclusive prefix of the block totals
    (itself summed so), every add rounded to x's dtype; ``torch.cumsum``
    accumulates in f32 and rounds once."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = _sequential_cumsum(x)
    else:
        nb = -(-n // _SCAN_BLOCK)
        blocks = _zero_pad(x, 0, nb * _SCAN_BLOCK - n).unflatten(
            -1, (nb, _SCAN_BLOCK))
        inner = _sequential_cumsum(blocks)
        totals = cumsum(inner[..., -1], -1)
        out = (inner + _zero_pad(totals[..., :-1], 1, 0)[..., None]).flatten(
            -2)[..., :n]
    return out.movedim(-1, dim)


def _zero_pad(x: torch.Tensor, before: int, after: int,
              dim: int = -1) -> torch.Tensor:
    """x with zeros before and after along ``dim``, as a concatenation
    (``F.pad``'s values; torch 2.11's DTensor cannot plan a
    ``constant_pad_nd``)."""
    def zeros(k):
        shape = list(x.shape)
        shape[dim] = k
        return x.new_zeros(shape)
    return torch.cat([zeros(before), x, zeros(after)], dim=dim)


def _ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """Exact chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H); A: (H,); Bm/Cm: (B, S, N).
    Returns y: (B, S, H, P).
    """
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk "
                         f"{chunk}")
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = Bm.reshape(b, nc, chunk, n)
    Cc = Cm.reshape(b, nc, chunk, n)

    loga = dtc * A                                  # (b, nc, Q, h) ≤ 0
    L = cumsum(loga, dim=2)                         # within-chunk cumulative

    # --- intra-chunk quadratic term ------------------------------------
    # M[t, s] = (C_t · B_s) · exp(L_t − L_s) · dt_s   for s ≤ t
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc).float()      # (b,nc,Q,Q)
    decay = L[:, :, :, None, :] - L[:, :, None, :, :]         # (b,nc,Q,Q,h)
    idx = torch.arange(chunk, device=x.device)
    tmask = idx[:, None] >= idx[None, :]
    gate = torch.where(tmask[None, None, :, :, None], torch.exp(decay), 0.0)
    m = cb[..., None] * gate * dtc[:, :, None, :, :]          # (b,nc,Q,Q,h)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", m.to(x.dtype), xc)

    # --- chunk summaries and inter-chunk recurrence ---------------------
    # S_c = Σ_s exp(L_end − L_s) dt_s · B_s ⊗ x_s      (b, nc, h, n, p)
    end_decay = torch.exp(L[:, :, -1:, :] - L)                # (b,nc,Q,h)
    wgt = (end_decay * dtc).to(x.dtype)
    s_chunk = torch.einsum("bcsn,bcshp->bchnp", Bc.to(x.dtype),
                           wgt[..., None] * xc)
    chunk_decay = torch.exp(L[:, :, -1, :]).to(x.dtype)       # (b,nc,h)

    hstate = torch.zeros((b, h, n, p), dtype=x.dtype, device=x.device)
    h_prev = []                           # the state BEFORE each chunk
    for c in range(nc):
        h_prev.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    h_prev = torch.stack(h_prev, dim=1)                       # (b,nc,h,n,p)

    # --- inter-chunk contribution ---------------------------------------
    instate_decay = torch.exp(L).to(x.dtype)                  # (b,nc,Q,h)
    y_inter = (torch.einsum("bctn,bchnp->bcthp", Cc.to(x.dtype), h_prev)
               * instate_decay[..., None])
    return (y_intra + y_inter).reshape(b, s, h, p)


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. u: (B, S, C); w: (K, C). A DTensor's S is
    gathered first where it is sharded (the shifted windows cross shard
    borders), and padded by :func:`_zero_pad`."""
    u = fit_dim(u, 1, 1)
    pads = _zero_pad(u, CONV_K - 1, 0, dim=1)
    out = torch.zeros_like(u)
    for i in range(CONV_K):
        out = out + pads[:, i:i + u.shape[1]] * w[i]
    return out


def _split_in_proj(zxbc: torch.Tensor, cfg):
    """z, x, B, C, dt of the input projection."""
    din, n = cfg.ssm_heads * cfg.ssm_headdim, cfg.ssm_state
    return zxbc.split([din, din, n, n, cfg.ssm_heads], dim=-1)


def _gated_out(y: torch.Tensor, z: torch.Tensor, p: dict, cfg):
    y = y * silu(z)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def mamba2_block(x: torch.Tensor, p: dict, cfg,
                 chunk: int = 256) -> torch.Tensor:
    """Full Mamba-2 mixer. x: (B, S, D) → (B, S, D)."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    h, pdim, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    din = h * pdim
    z, xin, Bm, Cm, dt = _split_in_proj(x @ p["in_proj"], cfg)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out = silu(_causal_conv(conv_in, p["conv_w"]))
    xin, Bm, Cm = conv_out.split([din, n, n], dim=-1)
    dt = softplus(dt + p["dt_bias"])                          # (B,S,H)
    A = -torch.exp(p["A_log"])                                # (H,)
    xh = xin.reshape(b, s, h, pdim)
    y = _ssd_chunked(xh, dt, A, Bm, Cm, chunk)
    y = y + xh * p["D_skip"][None, None, :, None]
    return _gated_out(y.reshape(b, s, din), z, p, cfg)


def mamba2_decode(x: torch.Tensor, p: dict, cfg, ssm_state: torch.Tensor,
                  conv_state: torch.Tensor):
    """One-token decode. x: (B, 1, D); ssm_state: (B, H, N, P);
    conv_state: (B, CONV_K-1, C). Returns (y, ssm_state, conv_state), the
    states new tensors."""
    b = x.shape[0]
    h, pdim, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    din = h * pdim
    z, xin, Bm, Cm, dt = _split_in_proj(x @ p["in_proj"], cfg)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)                # (B,1,C)
    window = torch.cat([conv_state, conv_in], dim=1)          # (B,K,C)
    conv_out = silu(torch.einsum("bkc,kc->bc", window,
                                 p["conv_w"]))[:, None, :]
    new_conv_state = window[:, 1:]
    xin, Bm, Cm = conv_out.split([din, n, n], dim=-1)
    dt = softplus(dt + p["dt_bias"])[:, 0]                    # (B,H)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)                                     # (B,H)
    xh = xin.reshape(b, h, pdim)
    dBx = (dt[:, :, None, None] * Bm[:, 0, None, :, None].to(x.dtype)
           * xh[:, :, None, :])                               # (B,H,N,P)
    new_state = ssm_state * a[..., None, None].to(x.dtype) + dBx
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].to(x.dtype), new_state)
    y = y + xh * p["D_skip"][None, :, None]
    return (_gated_out(y.reshape(b, 1, din), z, p, cfg),
            new_state, new_conv_state)


def mamba2_param_shapes(cfg) -> dict:
    d = cfg.d_model
    h, pdim, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    din = h * pdim
    conv_c = din + 2 * n
    return {
        "in_proj": (d, 2 * din + 2 * n + h),
        "conv_w": (CONV_K, conv_c),
        "dt_bias": (h,),
        "A_log": (h,),
        "D_skip": (h,),
        "out_norm": (din,),
        "out_proj": (din, d),
    }
