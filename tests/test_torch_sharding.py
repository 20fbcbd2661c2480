"""The port's sharding specs (``repro_torch.models.model``) and shard
context against the reference's, and ``--mesh host`` training on the CPU.

* ``param_specs`` of all ten architectures on both production meshes
  ({"data": 16, "model": 16} and {"pod": 2, "data": 16, "model": 16}), in
  train and decode modes, and without axis sizes: leaf for leaf equal to
  the reference's ``PartitionSpec``s as tuples. The same for
  ``cache_specs`` (``shard_seq`` on and off), ``batch_spec``,
  ``fit_spec``, ``count_expert_params``, and the shapes and dtypes of
  ``abstract_params`` and ``abstract_cache``. Nothing is compiled: the
  reference's spec functions are plain Python.
* The reference's own spec tests (``tests/test_sharding_policies.py``,
  ``tests/test_models_smoke.py:86``) on the port.
* ``shard_ctx``: ``constrain`` is the identity for a plain tensor and
  without a context; ``placements`` of tuple entries.
* ``python -m repro_torch.launch.train --mesh host`` on the CPU at the
  smoke config, 3 steps: losses and grad norms equal to ``--mesh none``'s
  bit for bit (one CPU thread: several threads split the CPU's float
  reductions by load, so two runs of either may differ in the last bit).
"""
import math

import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as rbase
from repro.models import model as rmodel
from repro_torch.configs.base import ARCHITECTURES, get_config
from repro_torch.models import model as tmodel
from repro_torch.models import shard_ctx
from repro_torch.models.model import tree_paths

MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


def _ref_leaves(tree):
    """(path, leaf) of a reference tree of dicts, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for path, leaf in _ref_leaves(tree[k]):
                yield (k,) + path, leaf
    else:
        yield (), tree


def _specs_equal(ref, port):
    r = {p: tuple(s) for p, s in _ref_leaves(ref)}
    t = dict(tree_paths(port))
    assert r.keys() == t.keys()
    bad = {p: (r[p], t[p]) for p in r if r[p] != t[p]}
    assert not bad, bad


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_param_specs_equal_the_reference(arch):
    rcfg, tcfg = rbase.get_config(arch), get_config(arch)
    for sizes in (None, *MESHES):
        for mode in ("train", "decode"):
            _specs_equal(rmodel.param_specs(rcfg, sizes, mode),
                         tmodel.param_specs(tcfg, sizes, mode))
    assert tmodel.count_expert_params(tcfg) == \
        rmodel.count_expert_params(rcfg)
    _specs_equal(rmodel.build_model(rcfg).param_specs(),
                 tmodel.build_model(tcfg).param_specs())


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_cache_specs_equal_the_reference(arch):
    rcfg, tcfg = rbase.get_config(arch), get_config(arch)
    for sizes in (None, *MESHES):
        dp = tuple(a for a in ("pod", "data") if sizes and a in sizes) \
            or ("data",)
        for shard_seq in (True, False):
            _specs_equal(
                rmodel.cache_specs(rcfg, dp, 128, 32768, sizes, shard_seq),
                tmodel.cache_specs(tcfg, dp, 128, 32768, sizes, shard_seq))
        assert tmodel.batch_spec(dp) == tuple(rmodel.batch_spec(dp))


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_abstract_params_and_cache_equal_the_reference(arch):
    rcfg, tcfg = rbase.get_config(arch), get_config(arch)
    for ref, port in (
            (rmodel.abstract_params(rcfg), tmodel.abstract_params(tcfg)),
            (rmodel.build_model(rcfg).abstract_params(),
             tmodel.build_model(tcfg).abstract_params()),
            (rmodel.abstract_cache(rcfg, 4, 64),
             tmodel.abstract_cache(tcfg, 4, 64))):
        r = dict(_ref_leaves(ref))
        t = dict(tree_paths(port))
        assert r.keys() == t.keys()
        for p in r:
            assert t[p].is_meta
            assert tuple(t[p].shape) == tuple(r[p].shape), p
            assert str(t[p].dtype).removeprefix("torch.") == \
                str(jnp.dtype(r[p].dtype)), p


def test_fit_spec_equals_the_reference():
    sizes = {"pod": 2, "data": 16, "model": 16}
    for spec, shape in ((("data", "model"), (32, 14)),
                        ((("pod", "data"), None), (64, 3)),
                        ((("pod", "data"), "model"), (16, 32)),
                        (("model",), (48, 5, 7)), ((None, "data"), (3, 1))):
        want = tuple(rmodel.fit_spec(rmodel.P(*spec), shape, sizes))
        assert tmodel.fit_spec(spec, shape, sizes) == want
    assert tmodel.fit_spec(("data",), (3,), None) == ("data",)


# ---- the reference's own spec tests, on the port ------------------------

@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_decode_mode_specs_fit_and_cover(arch):
    """tests/test_sharding_policies.py: decode specs divide their dims."""
    cfg = get_config(arch)
    sizes = {"data": 16, "model": 16}
    shapes = dict(tree_paths(tmodel.abstract_params(cfg)))
    for path, spec in tree_paths(tmodel.param_specs(cfg, sizes, "decode")):
        for dim, ax in zip(shapes[path].shape, spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            assert dim % math.prod(sizes[a] for a in axes) == 0, path


def test_decode_mode_capacity_fallback():
    """Large dense shards keep the FSDP rules at decode (llama-vision,
    arctic); dbrx takes TP-only mode."""
    sizes = {"data": 16, "model": 16}
    for arch in ("llama_3_2_vision_90b", "arctic_480b"):
        cfg = get_config(arch)
        assert tmodel.param_specs(cfg, sizes, "decode") == \
            tmodel.param_specs(cfg, sizes, "train"), arch
    cfg = get_config("dbrx_132b")
    sd = tmodel.param_specs(cfg, sizes, "decode")
    st = tmodel.param_specs(cfg, sizes, "train")
    assert sd["lm_head"] != st["lm_head"]
    # dbrx's head is TP-only: its vocabulary over model, no data axis
    assert sd["lm_head"] == (None, "model")


def test_decode_mode_small_arch_is_tp_only():
    cfg = get_config("qwen2_0_5b")
    for _, spec in tree_paths(tmodel.param_specs(
            cfg, {"data": 16, "model": 16}, "decode")):
        for ax in spec:
            assert "data" not in (ax if isinstance(ax, tuple) else (ax,))


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_param_specs_cover_all_leaves(arch):
    """tests/test_models_smoke.py:86: every leaf has a spec of at most its
    rank, dividing its dims."""
    cfg = get_config(arch)
    sizes = {"data": 16, "model": 16}
    shapes = dict(tree_paths(tmodel.abstract_params(cfg)))
    specs = dict(tree_paths(tmodel.param_specs(cfg, sizes)))
    assert shapes.keys() == specs.keys()
    for path, spec in specs.items():
        shape = shapes[path].shape
        assert len(spec) <= len(shape), path
        for dim, ax in zip(shape, spec):
            if ax is not None:
                axes = ax if isinstance(ax, tuple) else (ax,)
                assert dim % math.prod(sizes[a] for a in axes) == 0, path


# ---- the shard context ---------------------------------------------------

def test_constrain_is_the_identity_without_a_mesh():
    x = torch.ones(4, 8)
    assert shard_ctx.constrain(x, "dp", None) is x
    shard_ctx.set_mesh_context(("data",), {"data": 16, "model": 16})
    try:
        assert shard_ctx.constrain(x, "dp", "model") is x
        assert shard_ctx.fit_dim(x, -1, 3) is x
        assert shard_ctx.replicated(lambda a: a + 1, x).equal(x + 1)
    finally:
        shard_ctx.clear_mesh_context()


class _Mesh:
    """The two attributes ``placements`` reads."""
    mesh_dim_names = ("pod", "data", "model")

    def size(self, i):
        return (2, 16, 16)[i]


def test_placements_of_spec_entries():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Mesh()
    assert shard_ctx.placements((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert shard_ctx.placements((), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):
        shard_ctx.placements((("data", "pod"),), mesh)


# ---- --mesh host on the CPU -----------------------------------------------

def test_train_cli_mesh_host_is_bit_identical_on_the_cpu(capsys):
    import torch.distributed as dist

    from repro_torch.launch import train
    argv = ["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu",
            "--steps", "3", "--log-every", "1"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = {m: train.main(argv + ["--mesh", m]) for m in ("none", "host")}
    finally:
        torch.set_num_threads(threads)
        if dist.is_initialized():
            dist.destroy_process_group()
    hist = {m: [(h["loss"], h["grad_norm"]) for h in t.history]
            for m, t in runs.items()}
    assert hist["host"] == hist["none"]
    assert len(hist["none"]) == 3
    for path, p in tree_paths(runs["host"].state.params):
        assert type(p).__name__ == "DTensor"
        assert torch.equal(p.full_tensor(),
                           dict(tree_paths(runs["none"].state.params))[path])
    out = capsys.readouterr().out.splitlines()
    loss_lines = [ln for ln in out if ln.startswith("loss ")]
    assert len(loss_lines) == 2 and loss_lines[0] == loss_lines[1]
