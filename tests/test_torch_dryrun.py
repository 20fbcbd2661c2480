"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.mesh``) and
program analysis (``repro_torch.obs.prof``: ``lower``, ``compiled_cost``,
``compiled_memory``, ``analyze_program``), checked by hand and against the
reference's ``analyze_hlo``.

* ``analyze_program`` of a hand-written program with a loop of known trip
  count: dot FLOPs and collective bytes exact; the ``hlo_analysis`` shim
  prints the same for a saved program.
* ``compiled_cost`` of a 64×64 f32 matmul is 2·64³ FLOPs, and
  ``compiled_memory``'s peak is argument + output + temp − alias.
* On a fake 16×16 mesh (a subprocess: one process holds one default
  process group), ``x @ w`` with x (64, 512) as [Shard(0), Replicate()]
  and w (512, 1024) as [Shard(0), Shard(1)] costs exactly the local
  product's 2·64·64·32 FLOPs a device, where a dispatch mode around the
  DTensor code would see one global (64, 512) @ (512, 1024); DTensor's
  all-to-all of x counts as an all-to-all, not as an all-gather.
* Two dry-run cells of ``qwen2_0_5b``'s smoke config in that subprocess,
  a train cell (batch 32 × 16 tokens, grad_accum 2) on 16×16 and a decode
  cell (batch 32 against 64 cache slots) on 2×16×16 (``lower_cell`` and
  ``cell_result``, which
  ``run_cell`` composes at the full config): ``ok``, with the reference's
  keys, and
  ``argument_bytes`` equal to the local shard bytes counted here in numpy
  from the spec tuples and the shapes.
* At a 1×1 mesh and ``qwen2_0_5b``'s smoke config, the train step's
  ``dot_flops_per_device`` against the reference's ``analyze_hlo`` of its
  compiled step: within 5% (measured: equal; both count the forward, the
  rematerialized forward and the backward products), and neither counts a
  collective byte.
* Shape gating and ``input_specs`` (``tests/test_launch.py``).
"""
import json
import runpy
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import model as rmodel
from repro.optim import adamw as radamw
from repro.optim.schedule import cosine_schedule as rcosine
from repro_torch.configs.base import (ARCHITECTURES, SHAPES, ShapeConfig,
                                      get_config, smoke_shape,
                                      supports_shape)
from repro_torch.launch import dryrun
from repro_torch.models.model import (abstract_params, cache_specs,
                                      fit_spec, param_specs, tree_paths)
from repro_torch.obs import prof

SRC = Path(__file__).resolve().parents[1] / "src"

PROGRAM = """\
program hand devices=4 mesh=data:2,model:2
memory argument_bytes=100 output_bytes=40 temp_bytes=30 alias_bytes=20
computation main {
  %1 = bf16[8,16] dot aten.mm(bf16[8,32], bf16[32,16]) contract=32
  %2 = f32[64] all-reduce _c10d_functional.all_reduce(f32[64])
  call microbatch trip=10
}
computation microbatch {
  %3 = f32[4,8] dot aten.bmm(f32[2,4,3], f32[2,3,8]) contract=3
  %4 = bf16[128,256] all-gather _c10d_functional.all_gather_into_tensor(bf16[8,256])
  %5 = f32[4,8] pointwise aten.add(f32[4,8], f32[4,8])
  %6 = f32[4,8] view aten.view(f32[4,8])
}
"""


def test_analyze_program_by_hand(tmp_path, monkeypatch, capsys):
    res = prof.analyze_program(PROGRAM)
    # 2·8·16·32 once; 2·4·8·3 ten times
    assert res["dot_flops_per_device"] == 2 * 8 * 16 * 32 + 10 * 2 * 4 * 8 * 3
    assert res["collective_bytes_per_device"] == {
        "all-reduce": 64 * 4, "all-gather": 10 * 128 * 256 * 2}
    assert res["num_computations"] == 2
    assert dryrun.collective_bytes_per_device(PROGRAM) == \
        res["collective_bytes_per_device"]
    cost = prof.compiled_cost(PROGRAM)
    assert cost["flops"] == res["dot_flops_per_device"] + 10 * 32
    # every op but the view reads its operands and writes its result once
    assert cost["bytes_accessed"] == (
        (8 * 32 + 32 * 16 + 8 * 16) * 2 + 2 * 64 * 4
        + 10 * ((2 * 4 * 3 + 2 * 3 * 8 + 4 * 8) * 4
                + (8 * 256 + 128 * 256) * 2 + 3 * 4 * 8 * 4))
    mem = prof.compiled_memory(PROGRAM)
    assert mem == {"argument_bytes": 100, "output_bytes": 40,
                   "temp_bytes": 30, "alias_bytes": 20, "peak_bytes": 150}
    f = tmp_path / "cell.program.txt"
    f.write_text(PROGRAM)
    monkeypatch.setattr(sys, "argv", ["hlo_analysis", str(f)])
    runpy.run_module("repro_torch.launch.hlo_analysis", run_name="__main__")
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(res))


def test_compiled_cost_and_memory_of_a_matmul():
    a = torch.empty(64, 64, device="meta")
    program = prof.lower(lambda x, y: x @ y, a, a.clone())
    assert prof.compiled_cost(program)["flops"] == 2 * 64 ** 3
    mem = prof.compiled_memory(program)
    assert mem["argument_bytes"] == 2 * 64 * 64 * 4
    assert mem["output_bytes"] == 64 * 64 * 4
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                 + mem["temp_bytes"] - mem["alias_bytes"])
    # a donated argument the output may reuse; a temporary in between
    program = prof.lower(lambda x: (x * 2).exp(), a, donate=(0,))
    mem = prof.compiled_memory(program)
    assert mem["alias_bytes"] == 64 * 64 * 4
    assert mem["temp_bytes"] == 64 * 64 * 4
    assert mem["peak_bytes"] == 2 * 64 * 64 * 4
    assert prof.compiled_cost(program)["transcendentals"] == 64 * 64
    # a loop traced once, weighted by its trip count
    def body(x):
        for _ in prof.loop("microbatch", 3):
            x = x @ x
        return x
    program = prof.lower(body, a)
    assert "call microbatch trip=3" in program.text
    assert prof.analyze_program(program)["dot_flops_per_device"] == \
        3 * 2 * 64 ** 3
    assert list(prof.loop("microbatch", 3)) == [0, 1, 2]


FAKE_MESH = textwrap.dedent("""
    import json, sys
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.obs import prof

    mesh = make_production_mesh()
    x = DTensor.from_local(torch.empty(4, 512, device="meta"), mesh,
                           [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(32, 64, device="meta"), mesh,
                           [Shard(0), Shard(1)], run_check=False)
    matmul = prof.lower(lambda a, b: a @ b, x, w, mesh=mesh)
    cfg = get_config("qwen2_0_5b", smoke=True)
    cells = []
    for name, kind, multi_pod, seq in (("train_4k", "train", False, 16),
                                       ("decode_32k", "decode", True, 64)):
        mesh = make_production_mesh(multi_pod=multi_pod)
        program = dryrun.lower_cell(cfg, ShapeConfig(name, seq, 32, kind),
                                    mesh, grad_accum=2)
        cells.append(dryrun.cell_result("qwen2_0_5b", name, mesh, program,
                                        0.0))
    print(json.dumps({"matmul": prof.analyze_program(matmul),
                      "matmul_text": matmul.text, "cells": cells}))
""")


@pytest.fixture(scope="module")
def fake_mesh_run():
    out = subprocess.run([sys.executable, "-c", FAKE_MESH],
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(SRC),
                              "PATH": "/usr/bin:/bin"}, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_local_flops_on_a_fake_mesh(fake_mesh_run):
    res = fake_mesh_run["matmul"]
    assert res["dot_flops_per_device"] == 2 * 64 * 512 * 1024 / 256
    assert res["dot_flops_per_device"] == 2 * 64 * 64 * 32
    assert set(res["collective_bytes_per_device"]) == {"all-to-all"}
    assert "devices=256 mesh=data:16,model:16" in fake_mesh_run["matmul_text"]


def _local_bytes(shape, spec, itemsize, sizes):
    n = 1
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        n *= dim // int(np.prod([sizes[a] for a in axes], dtype=np.int64))
    return n * itemsize


def _argument_bytes(cfg, shape, sizes):
    """The step's arguments' local shard bytes, from the spec tuples."""
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    b, s = shape.global_batch, shape.seq_len
    mode = "decode" if shape.kind == "decode" else "train"
    specs = dict(tree_paths(param_specs(cfg, sizes, mode)))
    shapes = dict(tree_paths(abstract_params(cfg)))
    pbytes = sum(_local_bytes(shapes[p].shape, specs[p], 2, sizes)
                 for p in specs)
    if shape.kind == "train":
        return (pbytes + 2 * pbytes * 2 + 4
                + _local_bytes((b, s + 1), fit_spec((dp, None), (b, s + 1),
                                                    sizes), 4, sizes))
    cshapes = dict(tree_paths(dryrun.input_specs(cfg, shape)["cache"]))
    cbytes = sum(_local_bytes(cshapes[p].shape, sp, 2, sizes)
                 for p, sp in tree_paths(cache_specs(cfg, dp, b, s, sizes)))
    return (pbytes + cbytes
            + _local_bytes((b, 1), fit_spec((dp, None), (b, 1), sizes), 4,
                           sizes)
            + _local_bytes((b,), fit_spec((dp,), (b,), sizes), 4, sizes))


def test_dryrun_cells_on_a_fake_mesh(fake_mesh_run):
    cfg = get_config("qwen2_0_5b", smoke=True)
    keys = {"arch", "shape", "mesh", "devices", "ok", "lower_s", "compile_s",
            "flops_per_device", "bytes_accessed_per_device",
            "collective_bytes_per_device", "memory"}
    for cell, kind, seq, sizes in zip(
            fake_mesh_run["cells"], ("train", "decode"), (16, 64),
            ({"data": 16, "model": 16},
             {"pod": 2, "data": 16, "model": 16})):
        assert cell["ok"] and keys <= set(cell), cell
        assert cell["devices"] == int(np.prod(list(sizes.values())))
        assert cell["memory"]["argument_bytes"] == _argument_bytes(
            cfg, ShapeConfig(cell["shape"], seq, 32, kind), sizes)
        assert cell["memory"]["peak_bytes"] == (
            cell["memory"]["argument_bytes"] + cell["memory"]["output_bytes"]
            + cell["memory"]["temp_bytes"] - cell["memory"]["alias_bytes"])
        assert set(cell["collective_bytes_per_device"]) <= set(
            prof.COLLECTIVES)
        assert cell["flops_per_device"] > 0


def _reference_dot_flops(shape) -> float:
    """``analyze_hlo`` of the reference's train step (the dry run's, one
    microbatch) compiled on the CPU for the smoke config."""
    cfg = rbase.get_config("qwen2_0_5b", smoke=True)
    model = rmodel.build_model(cfg)

    def step(params, opt, tokens):
        loss, grads = jax.value_and_grad(model.loss_fn)(params, tokens, None)
        lr = rcosine(opt.step, 3e-4, 2000, 100_000)
        return radamw.adamw_update(params, grads, opt, lr)

    params = rmodel.abstract_params(cfg)
    tokens = jax.ShapeDtypeStruct((shape.global_batch, shape.seq_len + 1),
                                  jnp.int32)
    compiled = jax.jit(step).lower(
        params, radamw.abstract_opt_state(params), tokens).compile(
        {"xla_backend_optimization_level": 0})
    res = analyze_hlo(compiled.as_text())
    assert not res["collective_bytes_per_device"]
    return res["dot_flops_per_device"]


def test_dot_flops_against_the_reference_on_a_1x1_mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_config("qwen2_0_5b", smoke=True)
    shape = smoke_shape("train")
    try:
        program = dryrun.lower_cell(cfg, shape, make_host_mesh("cpu"))
    finally:
        dist.destroy_process_group()
    port = prof.analyze_program(program)
    assert not port["collective_bytes_per_device"]
    ref = _reference_dot_flops(shape)
    assert abs(port["dot_flops_per_device"] - ref) <= 0.05 * ref, (
        port["dot_flops_per_device"], ref)


def test_shape_gating():
    assert supports_shape("mamba2_370m", "long_500k")
    assert supports_shape("jamba_v0_1_52b", "long_500k")
    for arch in ARCHITECTURES:
        if arch not in ("mamba2_370m", "jamba_v0_1_52b"):
            assert not supports_shape(arch, "long_500k"), arch
        for shp in ("train_4k", "prefill_32k", "decode_32k"):
            assert supports_shape(arch, shp)


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_input_specs_abstract(arch):
    """input_specs gives meta tensors only (no storage), of the
    reference's shapes and dtypes."""
    cfg, rcfg = get_config(arch), rbase.get_config(arch)
    for shape_name, shape in SHAPES.items():
        if not supports_shape(arch, shape_name):
            continue
        specs = dryrun.input_specs(cfg, shape)
        assert all(t.is_meta for _, t in tree_paths(specs)), shape_name
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            assert specs["tokens"].shape == (b, 1)
            assert specs["pos"].shape == (b,)
            want = rmodel.cache_shapes(rcfg, b, s)
            for p, t in tree_paths(specs["cache"]):
                assert tuple(t.shape) == tuple(want[p[0]]), p
            continue
        assert specs["batch"]["tokens"].shape == \
            (b, s + 1 if shape.kind == "train" else s)
        assert specs["batch"]["tokens"].dtype == torch.int32
        for k, shp in rmodel.build_model(rcfg).extras_shapes(b).items():
            assert tuple(specs["batch"][k].shape) == shp
            assert specs["batch"][k].dtype == torch.bfloat16


def test_dryrun_compare_rows_and_counts(tmp_path, capsys):
    """``launch.dryrun_compare``: a row for each cell ``ok`` in both
    directories, the peak ratio of the two packages' own peaks, and the
    port's cells counted ok, failed and skipped."""
    from repro_torch.launch import dryrun_compare
    port, ref = tmp_path / "port", tmp_path / "ref"
    port.mkdir()
    ref.mkdir()

    def cell(d, cid, ok=True, peak=0.0, coll=None, **extra):
        (d / f"{cid}.json").write_text(json.dumps(
            {"ok": ok, "memory": {"peak_bytes": peak},
             "collective_bytes_per_device": coll or {}, **extra}))
    cell(port, "a__train_4k__16x16", peak=3e9, coll={"all-gather": 2e9,
                                                     "all-reduce": 1e9})
    cell(ref, "a__train_4k__16x16", peak=2e9, coll={"all-reduce": 5e8})
    cell(port, "a__long_500k__16x16", ok=False, skipped="full attention")
    cell(port, "b__decode_32k__16x16", ok=False, error="boom")
    cell(ref, "b__decode_32k__16x16", peak=1e9)
    cell(port, "b__prefill_32k__16x16", peak=1e9)       # no reference cell
    rows = dryrun_compare.rows(dryrun_compare._cells(port),
                               dryrun_compare._cells(ref))
    assert rows == [("a__train_4k__16x16", 3.0, 2.0, 1.5, 3.0, 0.5, None)]
    assert dryrun_compare.counts(dryrun_compare._cells(port)) == {
        "ok": 2, "fail": 1, "skip": 1}
    dryrun_compare.main([str(port), str(ref), "--arch", "b"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "port cells ok=2 fail=1 skip=1"
    assert len(out) == 3                         # no row of arch b


#: a hand-written post-SPMD module: a microbatch loop of 4 trips around a
#: ``call`` of a layer loop of 3 trips (jax 0.9.0 lowers a scan inside a
#: scan so), whose trip counts sit only in the loops' ``backend_config``;
#: the conditions compare through fusions, as the reference's count cannot
#: read them
_HLO = """HloModule jit_train_step, entry_computation_layout={(f32[8])->f32[8]}

%wrapped_compare_computation (p0: s32[], p1: s32[]) -> pred[] {
  %p0 = s32[] parameter(0)
  %p1 = s32[] parameter(1)
  ROOT %lt = pred[] compare(%p0, %p1), direction=LT
}

%layer_body (t: (s32[], bf16[16,8])) -> (s32[], bf16[16,8]) {
  %t = (s32[], bf16[16,8]{1,0}) parameter(0)
  %x = bf16[16,8]{1,0} get-tuple-element(%t), index=1
  %ag = bf16[64,8]{1,0} all-gather(%x), dimensions={0}
  %ar = f32[16,8]{1,0} all-reduce(%x), to_apply=%add.promoted
  ROOT %o = (s32[], bf16[16,8]{1,0}) tuple(%i, %x)
}

%layer_cond (t: (s32[], bf16[16,8])) -> pred[] {
  %t = (s32[], bf16[16,8]{1,0}) parameter(0)
  %c = s32[] constant(3)
  ROOT %w = pred[] fusion(%i, %c), kind=kLoop, calls=%wrapped_compare_computation
}

%layers (t: (s32[], bf16[16,8])) -> (s32[], bf16[16,8]) {
  %t = (s32[], bf16[16,8]{1,0}) parameter(0)
  ROOT %loop = (s32[], bf16[16,8]{1,0}) while(%t), condition=%layer_cond, body=%layer_body, backend_config={"known_trip_count":{"n":"3"},"known_init_step":{"init":"0","step":"1"}}
}

%micro_body (t: (s32[], bf16[16,8])) -> (s32[], bf16[16,8]) {
  %t = (s32[], bf16[16,8]{1,0}) parameter(0)
  %rs = bf16[2,8]{1,0} reduce-scatter(%x), dimensions={0}
  ROOT %call = (s32[], bf16[16,8]{1,0}) call(%t), to_apply=%layers
}

%micro_cond (t: (s32[], bf16[16,8])) -> pred[] {
  %t = (s32[], bf16[16,8]{1,0}) parameter(0)
  %c = s32[] constant(4)
  ROOT %w = pred[] fusion(%i, %c), kind=kLoop, calls=%wrapped_compare_computation
}

ENTRY %main (a: f32[8]) -> f32[8] {
  %a = f32[8]{0} parameter(0)
  %loop = (s32[], bf16[16,8]{1,0}) while(%t), condition=%micro_cond, body=%micro_body, backend_config={"known_trip_count":{"n":"4"}}
  %final = f32[8]{0} all-reduce(%a), to_apply=%add
  ROOT %r = f32[8]{0} add(%a, %a)
}
"""


def test_dryrun_compare_scales_collectives_by_their_trip_counts():
    """Each collective's result bytes times the known trip counts of the
    loops around it: the layer loop's 3 inside the microbatch loop's 4
    (through a ``call``), the microbatch body's own 4, the entry's once;
    a promoted bf16 all-reduce at 2 bytes."""
    from repro_torch.launch import dryrun_compare as dc
    w = dc.trip_weights(_HLO)
    assert w["main"] == 1 and w["micro_body"] == 4
    assert w["layers"] == 4 and w["layer_body"] == 12
    got = dc.collective_bytes_with_trips(_HLO)
    assert got == {"all-gather": 64 * 8 * 2 * 12,
                   "all-reduce": 16 * 8 * 2 * 12 + 8 * 4,
                   "reduce-scatter": 2 * 8 * 2 * 4}


def test_grad_accum_is_the_reference_table_on_both_meshes():
    """The dry run's microbatch counts (``GRAD_ACCUM``, taken as they are
    on 16×16 and 2×16×16 alike) are the reference's table: 16 for dbrx,
    arctic and llama-vision, whose microbatch on 2×16×16 is then sharded
    over ``data`` and replicated over ``pod``, where the reference
    replicates it over every device."""
    import ast
    import inspect

    from repro_torch.configs.base import ARCHITECTURES
    from repro_torch.launch import dryrun
    # the reference's table, read from its source: importing
    # ``repro.launch.dryrun`` would set 512 host devices for the worker
    src = (Path(__file__).resolve().parents[1] / "src" / "repro" / "launch"
           / "dryrun.py").read_text()
    table = next(ast.literal_eval(node.value)
                 for node in ast.parse(src).body
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", "") == "GRAD_ACCUM")
    for arch in ARCHITECTURES:
        assert dryrun.GRAD_ACCUM.get(arch, 1) == table.get(arch, 1), arch
    assert dryrun.GRAD_ACCUM["dbrx_132b"] == 16
    # no cap by mesh: a cell takes the table's count as it is
    assert "GRAD_ACCUM.get(arch, 1)" in inspect.getsource(dryrun.run_cell)


def test_peak_live_names_the_temporaries_at_the_peak():
    """``Program.peak_live``: the temporaries live where the temp bytes
    peak, largest first, each with the program line of the op that made
    it; their sum is the temp bytes."""
    a = torch.empty(64, 64, device="meta")

    def fn(x):
        big = torch.cat([x, x, x, x])           # 4 × 16 KiB, the peak
        small = (big * 2).sum(0)                 # big is live until here
        return small.exp()
    program = prof.lower(fn, a)
    mem = prof.compiled_memory(program)
    sizes = [nb for nb, _ in program.peak_live]
    assert sizes == sorted(sizes, reverse=True)
    assert sum(sizes) == mem["temp_bytes"]
    assert sizes[:2] == [4 * 64 * 64 * 4] * 2
    assert "aten.cat" in program.peak_live[0][1] or \
        "aten.cat" in program.peak_live[1][1]
