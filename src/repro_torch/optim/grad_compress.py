"""Error-feedback bitplane gradient compression (port of
``repro.optim.grad_compress``).

Each gradient tensor is quantized to ``bits`` levels (sign + magnitude)
and the bit-planes are packed into 32-bit words with the same machinery
the rank/select structures use, so the wire volume is ``bits/32`` of f32.
The quantization error is carried in an error-feedback residual, so the
accumulated update is unbiased. Planes are MSB-first: dropping trailing
planes degrades precision gracefully (``keep_planes``).

The planes of a leaf are one (bits, n) int32 tensor packed by one call of
``kernels.ops.bitpack``: one launch of the CUDA kernel on the card, the
plain ``bitops.pack_bits`` on the CPU. The words are the reference's bit
for bit (uint32 patterns held in int32). Rounding is half-to-even in both
``jnp.round`` and ``torch.round``.

``compressed_allreduce_mean`` is the collective: every member's packed
planes and scale are gathered with ``torch.distributed``, dequantized, and
averaged (the reference's ``shard_map`` all-gather), one all-gather of the
words and one of the scales a leaf.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core import bitops
from repro_torch.kernels import ops
from repro_torch.models.model import map_tree, tree_paths


def quantize_bitplanes(x: torch.Tensor, bits: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) → (planes (bits, ceil(n/32)) int32 words, scale () f32).

    Plane 0 = sign; planes 1.. = magnitude bits, MSB first."""
    if bits < 2:
        raise ValueError(f"bits must be at least 2, got {bits}")
    flat = x.reshape(-1).to(torch.float32)
    m = (1 << (bits - 1)) - 1
    amax = flat.abs().max()
    # a divisor on the device: CUDA multiplies by the reciprocal of a host
    # scalar, which rounds differently from the reference's division
    scale = torch.where(amax > 0, amax / torch.full_like(amax, m), 1.0)
    q = torch.clamp(torch.round(flat / scale), -m, m).to(torch.int32)
    planes = torch.empty((bits, flat.numel()), dtype=torch.int32,
                         device=x.device)
    planes[0] = q < 0
    mag = q.abs()
    for i in range(bits - 1):
        torch.bitwise_and(mag >> (bits - 2 - i), 1, out=planes[1 + i])
    return ops.bitpack(planes), scale


def dequantize_bitplanes(words: torch.Tensor, scale: torch.Tensor, bits: int,
                         shape: tuple, keep_planes: int | None = None
                         ) -> torch.Tensor:
    """Inverse of :func:`quantize_bitplanes`; ``keep_planes`` < bits drops
    the trailing magnitude planes (coarser values at a lower wire cost)."""
    n = 1
    for d in shape:
        n *= d
    kp = bits if keep_planes is None else keep_planes
    sign = bitops.unpack_bits(words[0], n).to(torch.bool)
    mag = torch.zeros((n,), dtype=torch.int64, device=words.device)
    for i in range(kp - 1):
        mag |= (bitops.unpack_bits(words[1 + i], n).to(torch.int64)
                << (bits - 2 - i))
    magf = mag.to(torch.float32)
    val = torch.where(sign, -magf, magf)
    return (val * scale).reshape(shape)


def ef_compress_tree(grads: Any, residuals: Any, bits: int
                     ) -> Tuple[Any, Any]:
    """Error-feedback round trip on a nested dict of gradients (a tuple or
    list of tensors will do, as in the reference's tests).

    Returns (decompressed grads as seen after the wire, new residuals);
    the caller feeds the grads to the optimizer and keeps the residuals."""
    def one(g, r):
        if hasattr(g, "device_mesh"):
            # a DTensor leaf: the round trip runs on the whole gradient
            # (on a 1×1 mesh its local tensor), so the planes, the scale
            # and the words are the unsharded leaf's
            from repro_torch.models.shard_ctx import distribute
            dq, res = one(g.full_tensor(), r.full_tensor())
            return (distribute(dq, g.device_mesh, g.placements),
                    distribute(res, r.device_mesh, r.placements))
        corrected = g.to(torch.float32) + r
        words, scale = quantize_bitplanes(corrected, bits)
        dq = dequantize_bitplanes(words, scale, bits, tuple(g.shape))
        return dq.to(g.dtype), corrected - dq

    if isinstance(grads, (tuple, list)):
        out = [one(g, r) for g, r in zip(grads, residuals)]
        return (type(grads)(o[0] for o in out),
                type(grads)(o[1] for o in out))
    res = dict(tree_paths(residuals))
    out = {path: one(g, res[path]) for path, g in tree_paths(grads)}
    return (map_tree(lambda path, _: out[path][0], grads),
            map_tree(lambda path, _: out[path][1], grads))


def zero_residuals(params: Any) -> Any:
    return map_tree(lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


def compressed_allreduce_mean(tree: Any, bits: int, group=None) -> Any:
    """Mean of a nested dict of tensors over the members of ``group`` (the
    default process group if None), with the compressed wire format: each
    member ships its packed planes and scale, every member dequantizes all
    of them and averages, in the members' rank order."""
    import torch.distributed as dist

    # torch 2.13 renamed the one-buffer all-gather; the older name warns
    gather = (getattr(dist, "all_gather_single", None)
              or dist.all_gather_into_tensor)
    size = dist.get_world_size(group)

    def one(_, g):
        words, scale = quantize_bitplanes(g, bits)
        all_words = torch.empty((size * bits, words.shape[1]),
                                dtype=words.dtype, device=words.device)
        gather(all_words, words.contiguous(), group=group)
        all_scale = torch.empty((size,), dtype=scale.dtype,
                                device=scale.device)
        gather(all_scale, scale.reshape(1), group=group)
        dq = torch.stack([dequantize_bitplanes(w, s, bits, tuple(g.shape))
                          for w, s in zip(all_words.split(bits), all_scale)])
        return (dq.sum(0) / torch.full_like(dq[0], size)).to(g.dtype)

    return map_tree(one, tree)


def compression_ratio(bits: int) -> float:
    """Wire bytes vs f32 (ignoring the per-tensor scale scalar)."""
    return bits / 32.0
