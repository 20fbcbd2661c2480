"""Production and host meshes (port of ``repro.launch.mesh``), as
``torch.distributed`` device meshes.

The production meshes stand for the fleet the dry run plans for: 16×16
cards a pod, and a 2-pod axis on top. They are built over torch's fake
process group (backend ``"fake"``): one process plays rank 0 of 512 and
every collective returns at once, as XLA's 512 placeholder host devices
do for the reference. Their ``device_type`` is ``"cuda"``, the cards they
stand for: on a ``"cpu"`` mesh DTensor replaces an all-to-all by an
all-gather and a chunk (gloo has no all-to-all), so the dry run would
count the wrong collective. The tensors on them are ``meta`` tensors,
which DTensor never moves to the mesh's device, so no card is needed.

The host mesh is a real 1×1 mesh over a one-rank group on an in-process
``HashStore``: nccl on the card, gloo on the CPU. Neither mesh reaches for
the network.

One process holds one default process group, so a process builds either
the fake world or the host group, not both (the reference likewise sets
its 512 placeholder devices before jax starts). Everything is built
lazily, by functions, so importing this module starts nothing.
"""
from __future__ import annotations

import contextlib

import torch

FAKE_WORLD = 512          # ranks of the fake world; one pod is the first 256


def _default_group(backend: str, world_size: int):
    """Start the default process group (rank 0 of ``world_size``) unless
    one of this backend and size is already up; raise if another is."""
    import torch.distributed as dist
    if dist.is_initialized():
        have = (dist.get_backend(), dist.get_world_size())
        if have != (backend, world_size):
            raise RuntimeError(
                f"this process already holds a {have[0]} process group of "
                f"{have[1]} ranks; a {backend} group of {world_size} needs "
                f"its own process")
        return
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    else:
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 = 256 cards a pod; the multi-pod mesh adds a 2-pod axis. Over
    the fake world of 512 ranks (the single-pod mesh uses the first 256)."""
    from torch.distributed.device_mesh import DeviceMesh
    _default_group("fake", FAKE_WORLD)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cuda", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(device: str | torch.device = "cuda"):
    """The 1×1 ("data", "model") mesh of ``device``'s one card (nccl), or of
    the CPU (gloo), over a one-rank group."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    _default_group("nccl" if dev.type == "cuda" else "gloo", 1)
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> tuple:
    """The batch/data-parallel axes of a mesh (pod axis included if present)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


@contextlib.contextmanager
def set_mesh(mesh):
    """Install ``mesh`` for the step: ``shard_ctx`` gets its data-parallel
    axes and sizes, and plain tensors made inside (``arange`` positions,
    masks) count as replicated on it, as GSPMD treats constants."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import shard_ctx
    shard_ctx.set_mesh_context(dp_axes(mesh), shard_ctx.axis_sizes(mesh))
    try:
        with implicit_replication():
            yield mesh
    finally:
        shard_ctx.clear_mesh_context()
