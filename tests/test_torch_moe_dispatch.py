"""The MoE's expert-parallel dispatch and combine on DTensors
(``repro_torch.models.moe._ExpertParallel``) against the plain route and
against the reference's plan.

* Plan against plan: one MoE layer with dbrx's 16 experts and top 4 at
  d_model 64, prefilling 16 × 256 tokens. The port records it on the fake
  16×16 mesh (``obs.prof.lower``, a subprocess: one process holds one
  default process group); the reference compiles its ``moe_layer`` on 512
  host devices in a second subprocess, with ``jax.make_mesh`` given
  ``Auto`` axes (under jax 0.9.0 its default ``Explicit`` axes turn the
  layer's sharding constraint into an assertion that fails) and the same
  placements: x ("data", None, None), router ("data", None), w1, w3, w2
  ("model", None, "data"). The port's per-device peak (argument + output +
  temp − alias) must lie within 1.5× of the reference's argument + temp.
  The gathered route of the parent commit records 7.80 MB against the
  reference's 2.99 MB (2.6×); the expert-parallel route 0.42 MB.
* The same subprocess records a train and a prefill cell of that
  16-expert layer's smoke model through ``launch.dryrun.lower_cell``: the
  backward of the new route (remat included) plans on DTensor, with only
  the reference's five collective kinds.
* Values on a real mesh: 4 gloo ranks as a 2×2 ("data", "model") mesh, in
  a subprocess with its own timeout. dbrx's smoke config (4 experts, top
  2), its router biased so that expert 0 overflows its capacity: slots,
  ``keep`` and the dispatch buffer equal the plain route's bit for bit;
  the layer's output and its input gradient lie within ``rtol=atol=0.05``
  of the plain route's, and so do the parent's gathered route's (forced
  in the same run), under the same bound.
* Plain tensors keep their op sequence: the MoE cases of
  ``tests/test_torch_models.py`` and ``tests/test_torch_train.py`` and the
  card's 1×1-mesh training test are unchanged.
"""
import json
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
ENV = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
       "OMP_NUM_THREADS": "1"}
BATCH, SEQ = 16, 256

LAYER = """
import dataclasses
E, K = 16, 4          # dbrx's experts and top-k, at the smoke widths
SPECS = {"router": ("data", None), "w1": ("model", None, "data"),
         "w3": ("model", None, "data"), "w2": ("model", None, "data")}
"""

PORT = LAYER + textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh, set_mesh
    from repro_torch.models.model import fit_spec
    from repro_torch.models.moe import moe_layer, moe_param_shapes
    from repro_torch.models.shard_ctx import axis_sizes
    from repro_torch.obs import prof

    b, s = int(sys.argv[1]), int(sys.argv[2])
    cfg = dataclasses.replace(get_config("dbrx_132b", smoke=True),
                              num_experts=E, experts_per_token=K)
    mesh = make_production_mesh()
    sizes = axis_sizes(mesh)
    shapes = moe_param_shapes(cfg)

    def meta(shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")
    with set_mesh(mesh):
        p = {n: dryrun._placed(fit_spec(SPECS[n], shapes[n], sizes),
                               meta(shapes[n]), mesh) for n in SPECS}
        x = dryrun._placed(fit_spec(("data", None, None),
                                    (b, s, cfg.d_model), sizes),
                           meta((b, s, cfg.d_model)), mesh)

        def layer(x, p):
            with torch.no_grad():
                return moe_layer(x, p, cfg)
        program = prof.lower(layer, x, p, name="moe_layer", mesh=mesh)
    cells = []
    for kind, seq in (("train", 16), ("prefill", 16)):
        prog = dryrun.lower_cell(cfg, ShapeConfig(kind, seq, 32, kind), mesh,
                                 grad_accum=2)
        cells.append(dryrun.cell_result("dbrx16", kind, mesh, prog, 0.0))
    print(json.dumps({"memory": prof.compiled_memory(program),
                      "analysis": prof.analyze_program(program),
                      "cells": cells}))
""")

REFERENCE = LAYER + textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs.base import get_config
    from repro.models import shard_ctx
    from repro.models.model import fit_spec
    from repro.models.moe import moe_layer, moe_param_shapes

    b, s = int(sys.argv[1]), int(sys.argv[2])
    cfg = dataclasses.replace(get_config("dbrx_132b", smoke=True),
                              num_experts=E, experts_per_token=K)
    mesh = jax.make_mesh((16, 16), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    sizes = {"data": 16, "model": 16}
    shard_ctx.set_mesh_context(("data",), sizes)
    shapes = moe_param_shapes(cfg)

    def named(spec, shape):
        return NamedSharding(mesh, fit_spec(P(*spec), shape, sizes))
    ps = {n: named(SPECS[n], shapes[n]) for n in SPECS}
    xs = named(("data", None, None), (b, s, cfg.d_model))
    args = ({n: jax.ShapeDtypeStruct(shapes[n], jnp.bfloat16)
             for n in shapes},
            jax.ShapeDtypeStruct((b, s, cfg.d_model), jnp.bfloat16))
    with jax.set_mesh(mesh):
        compiled = jax.jit(lambda p, x: moe_layer(x, p, cfg),
                           in_shardings=(ps, xs),
                           out_shardings=xs).lower(*args).compile()
    mem = compiled.memory_analysis()
    print(json.dumps({"argument_bytes": mem.argument_size_in_bytes,
                      "temp_bytes": mem.temp_size_in_bytes}))
""")


def _run(code: str, *args, timeout=300) -> dict:
    out = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                         capture_output=True, text=True, env=ENV,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def plans():
    return (_run(PORT, BATCH, SEQ),
            _run(REFERENCE, BATCH, SEQ, timeout=180))


def test_moe_layer_plan_within_1_5x_of_the_reference(plans):
    port, ref = plans
    peak = port["memory"]["peak_bytes"]
    want = ref["argument_bytes"] + ref["temp_bytes"]
    assert peak <= 1.5 * want, (peak, want, peak / want)
    # the same arguments: the layer's local shards of x and the weights
    assert port["memory"]["argument_bytes"] == ref["argument_bytes"]


def test_moe_layer_plan_moves_no_gathered_tokens(plans):
    """The gathered route moved every routing of the batch to every
    device; the expert-parallel route moves the count table, the buffer's
    sum over data, the expert outputs' gather over data and the (T_i·k, D)
    block's sum over model."""
    port, _ = plans
    coll = port["analysis"]["collective_bytes_per_device"]
    t, k, d = BATCH * SEQ, 4, 64
    per_shard_block = t // 16 * k * d * 2          # bf16 rows of one shard
    assert coll.get("all-gather", 0) < t * k * d * 2
    assert coll.get("all-reduce", 0) <= 3 * per_shard_block


def test_moe_cells_of_the_16_expert_model_plan(plans):
    port, _ = plans
    for cell in port["cells"]:
        assert cell["ok"], cell
        assert set(cell["collective_bytes_per_device"]) <= {
            "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute"}
        mem = cell["memory"]
        assert mem["peak_bytes"] == (mem["argument_bytes"]
                                     + mem["output_bytes"]
                                     + mem["temp_bytes"]
                                     - mem["alias_bytes"])
        assert cell["flops_per_device"] > 0


GLOO = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    def run(rank, world, port, res_path):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs.base import get_config
        from repro_torch.core.sort import bucket_ranks
        from repro_torch.launch.mesh import set_mesh
        from repro_torch.models import moe
        from repro_torch.models.shard_ctx import distribute, placements

        cfg = get_config("dbrx_132b", smoke=True)
        d, e, k = cfg.d_model, cfg.num_experts, cfg.experts_per_token
        f = cfg.d_ff_moe
        b, s = 4, 64
        t = b * s
        cap = max(8, int(t * k * 1.25 / e))
        rng = np.random.default_rng(0)
        router = rng.normal(size=(d, e)) * 0.1
        router[:, 0] += 0.06           # x's mean of 0.5 favours expert 0
        p = {"router": bf16(router),
             "w1": bf16(rng.normal(size=(e, d, f)) * 0.1),
             "w3": bf16(rng.normal(size=(e, d, f)) * 0.1),
             "w2": bf16(rng.normal(size=(e, f, d)) * 0.1)}
        x = bf16(rng.normal(size=(b, s, d)) + 0.5)
        g = bf16(rng.normal(size=(b, s, d)))

        xp = x.clone().requires_grad_()
        want = moe.moe_layer(xp, p, cfg)
        (want.float() * g.float()).sum().backward()
        fe_plain = moe.top_k((x @ p["router"]).float(), k)[1].reshape(-1)
        rank_plain = bucket_ranks(fe_plain, e).long()
        keep_plain = rank_plain < cap
        slot_plain = rank_plain.clamp(max=cap - 1)
        src = torch.arange(t).repeat_interleave(k)
        buf_plain = torch.zeros((e, cap, d), dtype=x.dtype).index_put_(
            (fe_plain, slot_plain),
            torch.where(keep_plain[:, None], x.reshape(t, d)[src], 0),
            accumulate=True)

        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        specs = {"router": ("data", None), "w1": ("model", None, "data"),
                 "w3": ("model", None, "data"), "w2": ("model", None, "data")}
        res = {"dropped": int((~keep_plain).sum())}
        of_ep = moe._ExpertParallel.of
        for route in ("expert_parallel", "gathered"):
            if route == "gathered":
                moe._ExpertParallel.of = classmethod(lambda cls, x, e: None)
            with set_mesh(mesh):
                pd = {n: distribute(v, mesh, placements(specs[n], mesh))
                      for n, v in p.items()}
                xpl = placements(("data", None, None), mesh)
                xd = distribute(x, mesh, xpl).requires_grad_()
                out = moe.moe_layer(xd, pd, cfg)
                (out.float() * distribute(g, mesh, xpl).float()).sum() \\
                    .backward()
                r = {"out": (out.full_tensor().float()
                             - want.float()).abs().max().item(),
                     "grad": (xd.grad.full_tensor().float()
                              - xp.grad.float()).abs().max().item(),
                     "out_ok": torch.allclose(out.full_tensor().float(),
                                              want.float(), rtol=0.05,
                                              atol=0.05),
                     "grad_ok": torch.allclose(
                         xd.grad.full_tensor().float(), xp.grad.float(),
                         rtol=0.05, atol=0.05)}
                if route == "expert_parallel":
                    ep = moe._ExpertParallel.of(xd, e)
                    r["route"] = ep is not None
                    fe = ep.tokens(moe.top_k((xd @ pd["router"]).float(),
                                             k)[1]).reshape(t * k)
                    slot, keep = ep.slots(fe, e, cap)
                    buf = ep.dispatch(ep.tokens(xd).reshape(t, d), fe, slot,
                                      keep, cap)
                    r["flat_e"] = torch.equal(fe.full_tensor(), fe_plain)
                    r["slot"] = torch.equal(slot.full_tensor(), slot_plain)
                    r["keep"] = torch.equal(keep.full_tensor(), keep_plain)
                    r["buf"] = torch.equal(buf.full_tensor(), buf_plain)
                    r["buf_placements"] = [[type(q).__name__,
                                            getattr(q, "dim", None)]
                                           for q in buf.placements]
                res[route] = r
        moe._ExpertParallel.of = of_ep
        dist.destroy_process_group()
        if rank == 0:
            with open(res_path, "w") as fh:
                json.dump(res, fh)

    if __name__ == "__main__":
        mp.spawn(run, args=(4, int(sys.argv[1]), sys.argv[2]), nprocs=4)
""")


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_gloo")
    script = tmp / "moe_gloo.py"          # spawned ranks import it
    script.write_text(GLOO)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = subprocess.run([sys.executable, str(script), str(port),
                          str(tmp / "res.json")], capture_output=True,
                         text=True, timeout=180, env=ENV)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads((tmp / "res.json").read_text())


def test_expert_parallel_slots_keep_and_buffer_bit_for_bit(gloo_run):
    r = gloo_run["expert_parallel"]
    assert gloo_run["dropped"] > 0          # the capacity is exercised
    assert r["route"]
    assert r["flat_e"] and r["slot"] and r["keep"] and r["buf"], r
    assert r["buf_placements"] == [["Replicate", None], ["Shard", 0]]


@pytest.mark.parametrize("route", ["expert_parallel", "gathered"])
def test_moe_layer_on_a_gloo_mesh_matches_the_plain_route(gloo_run, route):
    r = gloo_run[route]
    assert r["out_ok"], r
    assert r["grad_ok"], r
