"""Multi-pod dry run (port of ``repro.launch.dryrun``): lower and analyze
every (arch × shape × mesh) cell on the production meshes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_0_5b \\
        --shape train_4k                 # one cell, both meshes: --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell

No card is needed for the model cells. Each step runs once on DTensors
whose shards are ``meta`` tensors over a fake mesh of 256 or 512 ranks
(``launch.mesh.make_production_mesh``), with params, optimizer state,
batch and cache placed by the reference's sharding rules
(``models.model.param_specs``, ``cache_specs``, ``batch_shardings``) and
the activations pinned by ``models.shard_ctx.constrain``. ``obs.prof.lower``
records the program one device runs, the redistributions' collectives
included; ``compiled_cost``, ``compiled_memory`` and ``analyze_program``
read it. One JSON a cell under ``results/dryrun_torch/`` (the reference's
``results/dryrun/`` is never touched) with the reference's keys:
``lower_s`` is the recording's time and ``compile_s`` the analysis time
(nothing is compiled), both on the host clock; ``flops_per_device``,
``bytes_accessed_per_device``, ``collective_bytes_per_device`` (the five
kinds of the reference, by result bytes) and ``memory`` per device, its
``peak_bytes`` = argument + output + temp − alias, set against
``device_memory_bytes``: the card's memory where one is present, else the
80 GB that ``nvidia-smi`` names the H100 the meshes stand for by; and
``peak_buffers``, the largest temporaries live at the peak, each as
[bytes, the program line of the op that made it].

``--analytics`` runs the range-analytics cell on the card (``--device``,
``cuda`` by default): the reference's engine (2^14 tokens, vocabulary
1,024, shards of 2^12, batches of 1,024) answers the four-op batch and the
fused quantile kernel, each reported through the kernels' work model
(``obs.prof.collect_work``), its launches and the card's peak-memory rise.
"""
from __future__ import annotations

import argparse
import json
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import (ARCHITECTURES, SHAPES, get_config,
                                      supports_shape)
from repro_torch.launch.mesh import dp_axes, make_production_mesh, set_mesh
from repro_torch.models.model import (abstract_cache, abstract_params,
                                      build_model, cache_specs, fit_spec,
                                      map_tree, param_specs, tree_paths)
from repro_torch.models.shard_ctx import axis_sizes as mesh_axis_sizes
from repro_torch.models.shard_ctx import fit_batch, placements
from repro_torch.obs import Stopwatch, prof
from repro_torch.optim.adamw import (AdamWState, abstract_opt_state,
                                     adamw_update)
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.train.trainer import _map2, value_and_grad

RESULTS_DEFAULT = Path("results/dryrun_torch")
PEAK_BUFFERS = 8          # temporaries a cell's record lists at its peak
#: the memory of one card of the production meshes, as ``nvidia-smi``
#: names it ("NVIDIA H100 80GB HBM3"), where no card is present to ask
H100_MEMORY_BYTES = 80e9

# Microbatch counts for the train_4k cells: the reference's table
# (``repro.launch.dryrun.GRAD_ACCUM``) on both meshes, so the cells
# correspond one to one. They bound per-device activation memory; the
# reference caps them at global_batch/data(=16). On 2×16×16 a microbatch
# of 16 (arctic, dbrx, llama-vision) is smaller than the 32 data shards:
# the reference replicates it over every device; the port keeps it
# sharded over ``data``, one example a device, and replicates it over
# ``pod`` only (``shard_ctx.fit_batch``, and ``constrain``'s ``"dp"``
# falls back to the minor data axes that divide the batch).
GRAD_ACCUM = {
    "arctic_480b": 16, "dbrx_132b": 16, "llama_3_2_vision_90b": 16,
    "internlm2_20b": 8, "granite_3_8b": 8, "deepseek_7b": 8,
    "jamba_v0_1_52b": 8, "whisper_medium": 4, "qwen2_0_5b": 4,
    "mamba2_370m": 4,
}


# --------------------------------------------------------------------------
# Step functions
# --------------------------------------------------------------------------


def make_train_step(model, grad_accum: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: f32 gradient accumulation over ``grad_accum`` microbatches,
    then AdamW. Microbatch i takes every ``grad_accum``-th example (a
    reshape to (mb, grad_accum, ...)), so each keeps the batch's data
    sharding; under :func:`obs.prof.lower` the microbatch body is recorded
    once, as a loop of ``grad_accum`` trips (the reference's ``lax.scan``),
    and run ``grad_accum`` times otherwise."""
    extras_keys = tuple(model.extras_shapes(1).keys())

    def grads_of(params, batch):
        tokens = batch["tokens"]
        if grad_accum == 1:
            extras = {k: batch[k] for k in extras_keys} or None
            return value_and_grad(model.loss_fn, params, tokens, extras)
        mb = tokens.shape[0] // grad_accum

        def split(x):
            # a batch sharded wider than a microbatch (2×16×16 at
            # grad_accum 16: 16 examples, 32 data shards) keeps its shards
            # over ``data`` and is replicated over ``pod``
            return fit_batch(x, mb).reshape(mb, grad_accum, *x.shape[1:])
        mb_tok = split(tokens)
        mb_ext = {k: split(batch[k]) for k in extras_keys}
        loss = None
        grads = map_tree(lambda _, p: torch.zeros_like(
            p, dtype=torch.float32), params)
        for i in prof.loop("microbatch", grad_accum):
            ext = {k: v[:, i] for k, v in mb_ext.items()} or None
            part, g = value_and_grad(model.loss_fn, params, mb_tok[:, i],
                                     ext)
            loss = part if loss is None else loss + part
            grads = _map2(torch.add, grads, g)
        inv = 1.0 / grad_accum
        return loss * inv, map_tree(lambda _, g: g * inv, grads)

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        lr = cosine_schedule(opt_state.step, 3e-4, 2000, 100_000)
        new_params, new_opt, metrics = adamw_update(params, grads, opt_state,
                                                    lr)
        return new_params, new_opt, {"loss": loss, **metrics}

    return train_step


def make_prefill_step(model):
    extras_keys = tuple(model.extras_shapes(1).keys())

    def prefill_step(params, batch):
        extras = {k: batch[k] for k in extras_keys} or None
        with torch.no_grad():
            return model.prefill(params, batch["tokens"], extras)

    return prefill_step


def make_serve_step(model):
    def serve_step(params, tokens, cache, pos):
        with torch.no_grad():
            return model.decode_step(params, tokens, cache, pos)

    return serve_step


# --------------------------------------------------------------------------
# Abstract inputs + shardings
# --------------------------------------------------------------------------

def input_specs(cfg, shape):
    """``meta`` stand-ins (global shapes) for every model input of this
    cell: int32 tokens, bf16 extras and cache, as the reference's
    ``ShapeDtypeStruct``s."""
    model = build_model(cfg)
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    extras = {k: meta(shp, torch.bfloat16)
              for k, shp in model.extras_shapes(b).items()}
    if shape.kind == "train":
        return {"batch": {"tokens": meta((b, s + 1), torch.int32),
                          **extras}}
    if shape.kind == "prefill":
        return {"batch": {"tokens": meta((b, s), torch.int32), **extras}}
    # decode: one token against a seq-length cache
    return {"tokens": meta((b, 1), torch.int32),
            "cache": abstract_cache(cfg, b, s),
            "pos": meta((b,), torch.int32)}


def batch_shardings(cfg, mesh, specs):
    """Spec tree of a batch: its leading dim over the data-parallel axes,
    fitted to the shapes."""
    dp = dp_axes(mesh)
    sizes = mesh_axis_sizes(mesh)
    return map_tree(lambda _, s: fit_spec((dp,) + (None,) * (s.dim() - 1),
                                          tuple(s.shape), sizes), specs)


def abstract_opt_state_specs(pspecs):
    return AdamWState(m=pspecs, v=pspecs, step=())


def _placed(spec, t, mesh):
    """A meta DTensor of ``t``'s global shape and dtype, laid out by
    ``spec`` on ``mesh``: its shard is a fresh meta tensor of the local
    shape (every spec here is fitted, so shards are even)."""
    from torch.distributed.tensor import DTensor, Shard
    pl = placements(spec, mesh)
    local = list(t.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    shard = torch.empty(local, dtype=t.dtype, device="meta")
    return DTensor.from_local(shard, mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def place(tree, specs, mesh):
    """:func:`_placed` over a tree of meta tensors and its spec tree."""
    if isinstance(tree, AdamWState):
        return AdamWState(m=place(tree.m, specs.m, mesh),
                          v=place(tree.v, specs.v, mesh),
                          step=_placed(specs.step, tree.step, mesh))
    flat = dict(tree_paths(specs))
    return map_tree(lambda path, t: _placed(flat[path], t, mesh), tree)


def _pin(tree, specs, mesh):
    """Redistribute the DTensors of ``tree`` to ``specs`` (the step's output
    shardings, as ``out_shardings`` pins them)."""
    if isinstance(tree, AdamWState):
        return AdamWState(m=_pin(tree.m, specs.m, mesh),
                          v=_pin(tree.v, specs.v, mesh),
                          step=_pin(tree.step, specs.step, mesh))
    if isinstance(tree, torch.Tensor):
        want = placements(specs, mesh)
        return (tree if list(tree.placements) == want
                else tree.redistribute(mesh, want))
    flat = dict(tree_paths(specs))
    return map_tree(lambda path, t: _pin(t, flat[path], mesh), tree)


def collective_bytes_per_device(program_text: str) -> dict:
    """Per-device collective traffic of a recorded program: {kind: bytes}
    by each op's result shape, weighted by trip count."""
    return prof.analyze_program(program_text)["collective_bytes_per_device"]


def device_memory_bytes() -> float:
    """The card's memory, or the 80 GB of the H100 the meshes stand for."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return H100_MEMORY_BYTES


# --------------------------------------------------------------------------
# Lower + analyze one cell
# --------------------------------------------------------------------------

def lower_cell(cfg, shape, mesh, grad_accum: int = 1):
    """Record one cell's step on ``mesh``; returns the ``obs.prof.Program``.
    The step's inputs are placed by the reference's rules and its outputs
    pinned to the reference's output shardings."""
    model = build_model(cfg)
    dp = dp_axes(mesh)
    sizes = mesh_axis_sizes(mesh)
    # decode steps use TP-only weight sharding (no per-token weight
    # gathers); train/prefill amortize FSDP gathers over the whole batch
    pspecs = param_specs(cfg, sizes,
                         mode="decode" if shape.kind == "decode" else "train")
    specs = input_specs(cfg, shape)
    b, s = shape.global_batch, shape.seq_len
    with set_mesh(mesh):
        params = place(abstract_params(cfg), pspecs, mesh)
        if shape.kind == "train":
            ospecs = abstract_opt_state_specs(pspecs)
            opt = place(abstract_opt_state(abstract_params(cfg)), ospecs,
                        mesh)
            batch = place(specs["batch"],
                          batch_shardings(cfg, mesh, specs["batch"]), mesh)
            step = make_train_step(model, grad_accum=grad_accum)

            def fn(p, o, bt):
                new_p, new_o, metrics = step(p, o, bt)
                return _pin(new_p, pspecs, mesh), _pin(new_o, ospecs,
                                                       mesh), metrics
            return prof.lower(fn, params, opt, batch, donate=(0, 1),
                              name=f"{cfg.name}.train_step", mesh=mesh)
        logits_spec = fit_spec((dp, "model"), (b, cfg.padded_vocab), sizes)
        if shape.kind == "prefill":
            batch = place(specs["batch"],
                          batch_shardings(cfg, mesh, specs["batch"]), mesh)
            step = make_prefill_step(model)
            return prof.lower(
                lambda p, bt: _pin(step(p, bt), logits_spec, mesh),
                params, batch, name=f"{cfg.name}.prefill_step", mesh=mesh)
        cspecs = cache_specs(cfg, dp, b, s, sizes, shard_seq=True)
        cache = place(specs["cache"], cspecs, mesh)
        tokens = _placed(fit_spec((dp, None), (b, 1), sizes),
                         specs["tokens"], mesh)
        pos = _placed(fit_spec((dp,), (b,), sizes), specs["pos"], mesh)
        step = make_serve_step(model)

        def serve(p, t, c, ps):
            logits, new_cache = step(p, t, c, ps)
            return _pin(logits, logits_spec, mesh), _pin(new_cache, cspecs,
                                                         mesh)
        return prof.lower(serve, params, tokens, cache, pos, donate=(2,),
                          name=f"{cfg.name}.serve_step", mesh=mesh)


def analyze(program, save_hlo: Path | None = None) -> dict:
    """The cost, memory and collective analysis of a recorded program."""
    sw = Stopwatch()
    if save_hlo:
        save_hlo.write_text(program.text)
    cost = prof.compiled_cost(program)
    mem = prof.compiled_memory(program)
    hlo = prof.analyze_program(program)
    return {"compile_s": round(sw.lap(), 1),
            "flops": cost["flops"],
            "bytes_accessed": cost["bytes_accessed"],
            "transcendentals": cost["transcendentals"],
            "dot_flops": hlo["dot_flops_per_device"],
            "collective_bytes": hlo["collective_bytes_per_device"],
            "memory": mem}


def cell_result(arch: str, shape_name: str, mesh, program, lower_s: float,
                save_hlo: Path | None = None) -> dict:
    """One cell's record, with the reference's keys, from its program."""
    analyzed = analyze(program, save_hlo)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "devices": mesh.size(),
        "ok": True,
        "lower_s": round(lower_s, 1), "compile_s": analyzed["compile_s"],
        "flops_per_device": analyzed["flops"],
        "dot_flops_per_device": analyzed["dot_flops"],
        "bytes_accessed_per_device": analyzed["bytes_accessed"],
        "transcendentals_per_device": analyzed["transcendentals"],
        "collective_bytes_per_device": analyzed["collective_bytes"],
        "memory": analyzed["memory"],
        "device_memory_bytes": device_memory_bytes(),
        "peak_buffers": [list(b)
                         for b in program.peak_live[:PEAK_BUFFERS]],
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save_hlo: Path | None = None) -> dict:
    """Lower and analyze one cell on its production mesh."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    shape = SHAPES[shape_name]
    grad_accum = GRAD_ACCUM.get(arch, 1)
    sw = Stopwatch()
    program = lower_cell(get_config(arch), shape, mesh,
                         grad_accum=grad_accum)
    res = cell_result(arch, shape_name, mesh, program, sw.lap(), save_hlo)
    if shape.kind == "train":
        res["grad_accum"] = grad_accum
    return res


# --------------------------------------------------------------------------
# Range-analytics cell, on the card
# --------------------------------------------------------------------------

def _on_card(fn, dev) -> dict:
    """Run ``fn`` once with the kernels' work model open, on the host clock
    ending in a synchronize; its work, launches and peak-memory rise."""
    from repro_torch.kernels import build
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    before = dict(build.launches)
    sw = Stopwatch()
    with prof.collect_work() as work:
        out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    cell = {"ok": True, "s": sw.lap(),
            "bytes_accessed": work.bytes, "int_ops": work.int_ops,
            "flops": work.flops,
            "launches": {k: v - before[k] for k, v in build.launches.items()
                         if v > before[k]}}
    if dev.type == "cuda":
        cell["peak_rise_bytes"] = float(torch.cuda.max_memory_allocated(dev)
                                        - base)
    return cell, out


def run_analytics_cell(out_dir: Path, save_hlo: bool = False,
                       device: str = "cuda") -> dict:
    """Build the reference's small analytics store on ``device`` and run
    its serving programs once each: the four-op batched query path and the
    fused quantile kernel (one ``wm_quantile_sharded`` launch a batch on a
    card). ``save_hlo`` writes each part's work and launches."""
    import numpy as np

    from repro_torch.analytics import build_sharded_analytics
    from repro_torch.data import make_corpus
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    n, vocab, sb, B = 1 << 14, 1024, 12, 1024
    toks = np.asarray(make_corpus(n, vocab, seed=0), np.int64)
    eng = build_sharded_analytics(toks, vocab, shard_bits=sb, device=dev)
    rng = np.random.default_rng(1)

    def i32(a):
        return torch.as_tensor(a.astype(np.int32), device=dev)
    lo = i32(rng.integers(0, n, B))
    hi = torch.clamp(lo + i32(rng.integers(1, n // 2, B)), max=n)
    k = i32(rng.integers(0, n // 2, B))
    s0 = i32(rng.integers(0, vocab, B))
    s1 = torch.clamp(s0 + 32, max=vocab)

    serve, _ = _on_card(lambda: (
        eng.range_quantile(lo, hi, k), eng.range_count(lo, hi, s0, s1),
        eng.range_topk(lo, hi, 8), eng.range_distinct(lo, hi)), dev)
    kernel, _ = _on_card(lambda: ops.wm_quantile_batch(eng.shard(0), lo, hi,
                                                       k), dev)
    if save_hlo:
        for part, cell in (("serve", serve), ("quantile_kernel", kernel)):
            (out_dir / f"analytics__{part}.work.json").write_text(
                json.dumps(cell, indent=1))
    return {"cell": "analytics", "ok": True, "device": str(dev),
            "n": n, "vocab": vocab, "batch": B,
            "num_shards": eng.num_shards,
            "serve_4op_batch": serve,
            "fused_quantile_kernel": kernel}


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def cell_id(arch, shape_name, multi_pod):
    return f"{arch}__{shape_name}__{'2x16x16' if multi_pod else '16x16'}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--analytics", action="store_true",
                    help="also run the range-analytics cell (on --device)")
    ap.add_argument("--device", default="cuda",
                    help="device of the analytics cell")
    ap.add_argument("--out", type=Path, default=RESULTS_DEFAULT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write each cell's program as <cell>.program.txt")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)

    if args.analytics or args.all:
        out_file = args.out / "analytics__serving.json"
        if out_file.exists() and not args.force:
            print("=== analytics (cached) ===", flush=True)
        else:
            print("=== analytics ===", flush=True)
            try:
                res = run_analytics_cell(args.out, save_hlo=args.save_hlo,
                                         device=args.device)
                out_file.write_text(json.dumps(res, indent=1))
                print(json.dumps({k: res[k] for k in
                                  ("serve_4op_batch",
                                   "fused_quantile_kernel")}), flush=True)
            except Exception as e:  # noqa: BLE001
                out_file.write_text(json.dumps(
                    {"cell": "analytics", "ok": False,
                     "error": repr(e)[:2000]}))
                print(f"FAILED: {e!r}"[:500], flush=True)
        if args.analytics and not args.all and not args.arch:
            return

    if args.all:
        archs = list(ARCHITECTURES)
        shapes = list(SHAPES)
        meshes = [False, True]
    else:
        if not args.arch:
            ap.error("--arch (or --all, or --analytics alone) is required")
        archs = [args.arch]
        shapes = [args.shape] if args.shape else list(SHAPES)
        meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                cid = cell_id(arch, shape_name, mp)
                out_file = args.out / f"{cid}.json"
                if out_file.exists() and not args.force:
                    n_skip += 1
                    continue
                if not supports_shape(arch, shape_name):
                    out_file.write_text(json.dumps(
                        {"arch": arch, "shape": shape_name,
                         "mesh": "2x16x16" if mp else "16x16",
                         "ok": False, "skipped": "full-attention arch: "
                         "long_500k requires sub-quadratic mixing"}))
                    n_skip += 1
                    continue
                print(f"=== {cid} ===", flush=True)
                try:
                    hlo_path = (args.out / f"{cid}.program.txt"
                                if args.save_hlo else None)
                    res = run_cell(arch, shape_name, mp, save_hlo=hlo_path)
                    out_file.write_text(json.dumps(res, indent=1))
                    print(json.dumps({k: res[k] for k in
                                      ("lower_s", "compile_s",
                                       "flops_per_device", "memory",
                                       "collective_bytes_per_device")}),
                          flush=True)
                    n_ok += 1
                except Exception as e:  # noqa: BLE001
                    tb = traceback.format_exc()
                    out_file.write_text(json.dumps(
                        {"arch": arch, "shape": shape_name,
                         "mesh": "2x16x16" if mp else "16x16",
                         "ok": False, "error": repr(e)[:2000],
                         "traceback": tb[-6000:]}))
                    print(f"FAILED: {e!r}"[:500], flush=True)
                    print(tb[-3000:], flush=True)
                    n_fail += 1
    print(f"done ok={n_ok} fail={n_fail} skip={n_skip}")


if __name__ == "__main__":
    main()
