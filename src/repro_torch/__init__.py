"""PyTorch/CUDA port of the wavelet-matrix construction and range analytics.

A second package beside ``repro`` (JAX + Pallas), which stays the
reference. Layout and module names follow ``repro``: ``core`` (bit ops,
scans, rank/select, the wavelet matrix), ``kernels`` (hand-written CUDA
kernels for Hopper, each with a plain PyTorch version beside it),
``analytics`` (range queries and the sharded engine), ``data`` (synthetic
corpus, shard builds, the compressed store) and ``launch`` (CLIs).

Every structure is a frozen dataclass of tensors with the reference's field
names and byte layout: packed words are ``int32`` holding the uint32 bit
pattern, rank superblocks ``int32``, block-relative ranks ``int16``,
select samples and zero counts ``int32``. Plain torch code widens to
``int64`` before any shift or popcount.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise
when the card is missing; pass ``device="cpu"`` to run the plain versions.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
