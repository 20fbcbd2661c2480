"""Runs one cell of ``BENCHMARK.json`` once: set-up, the measured window,
the traced stretch (``--trace 1``), the check against the plain reference,
and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by its name:

* ``BENCHMARK.json``'s ``configs[].file``: the configuration's sizes and the
  name of its system;
* ``portbench/systems/<system>.py``: the system's entries into the program
  (a build, a server), the leaves a build leaves resident, its
  hand-written kernels' work, its check against ``portbench/reference``
  and its control;
* ``portbench/ops/<op>.py``: a query traffic's operation: its batches, the
  call, the check, the kernel's work and the control;
* ``portbench/traffic/<traffic>.json``: the traffic's parameters, read by
  the one generator of its ``kind``;
* ``portbench/kinds/<kind>.py``: that generator, ``run(ctx)``, and the
  check of what it kept, ``check(ctx, out)`` (``build``: whole builds back
  to back; ``query``: a closed loop of query batches with one caller);
* ``portbench/metrics/<metric>.py``: a reader with ``read(reading)`` that
  returns the per-layer metric, or None where it finds nothing to read;
  a metric split by cell (``idle_pct.query``) falls back to the reader of
  its name up to the first dot (``idle_pct.py``).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from contextlib import nullcontext
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path

import torch

from portbench import corpus, trace

HERE = Path(__file__).resolve().parent
#: top-level modules that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ---- the registry -----------------------------------------------------------

def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> tuple[dict, dict]:
    """(workload entry, configuration entry) of cell ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def load_config(root: Path, entry: dict) -> dict:
    return json.loads((Path(root) / entry["file"]).read_text())


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def load_system(name: str):
    return importlib.import_module(f"portbench.systems.{name}")


def load_op(name: str):
    return importlib.import_module(f"portbench.ops.{name}")


def load_kind(name: str):
    return importlib.import_module(f"portbench.kinds.{name}")


def load_reader(name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``, or, where
    there is none, of the file named by ``name`` up to its first dot: one
    reader serves a quantity split by cell (``launches.build``,
    ``launches.query``)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, kind: str, cell: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---- what a run reads -------------------------------------------------------

@dataclass
class Reading:
    """What the per-layer readers read: the traced stretch's trace, the
    units (builds or batches) in it, the bound of its hand-written kernels'
    work (kernel -> ms over the stretch) and the built structure's bits a
    token."""
    trace: trace.Trace
    units: int
    bound_ms: dict = field(default_factory=dict)
    bits_per_token: float | None = None


def storage_bytes(objs) -> int:
    """Bytes of every tensor storage reachable from ``objs`` (dataclasses,
    tuples, lists), each storage once."""
    seen: dict[int, int] = {}

    def visit(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        elif is_dataclass(x) and not isinstance(x, type):
            for f in fields(x):
                visit(getattr(x, f.name))
        elif isinstance(x, (list, tuple)):
            for y in x:
                visit(y)
    visit(objs)
    return sum(seen.values())


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Profiled:
    """``torch.profiler`` over a stretch of the window (device activity
    only where there is a device), exported to a chrome trace under the
    run's temporary directory and read back."""

    def __init__(self, dev: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.dev = dev
        self.trace: trace.Trace | None = None

    def __enter__(self):
        sync(self.dev)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        sync(self.dev)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                self.trace = trace.load(Path(path))
            finally:
                os.unlink(path)
        return False


def span(name: str, on: bool):
    """The benchmark's span around a call into the program (only in the
    traced stretch)."""
    return torch.profiler.record_function(name) if on else nullcontext()


# ---- the two generators -----------------------------------------------------

def corpora(cfg: dict, traffic: dict, seed: int, dev: torch.device) -> list:
    """The traffic's corpora of this seed: device int32 tensors, or host
    numpy arrays for a host feed (made on the device, copied once)."""
    out = []
    for i in range(int(traffic.get("corpora", 1))):
        toks = corpus.make_tokens(cfg, corpus.substream(seed, 1, i), dev)
        if traffic.get("feed", "device") == "host":
            toks = toks.cpu().numpy()
        out.append(toks)
    return out


def peak(dev: torch.device) -> int:
    """The allocator's peak since the process's start or the last reset."""
    return (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)


# ---- one run ----------------------------------------------------------------

def run_cell(root: Path, name: str, seed: int, seconds: float, traced: bool,
             dev: torch.device, t_start: float,
             config_override: dict | None = None,
             traffic_override: dict | None = None) -> dict:
    """One run of cell ``name``: its result (the last line's object) and
    the compared numbers. ``t_start``: the process's start on the
    ``time.perf_counter`` clock. ``config_override`` and
    ``traffic_override`` replace keys of the configuration and the traffic
    (the CPU tests' small sizes)."""
    bench = load_benchmark(root)
    cell, cfg_entry = find_cell(bench, name)
    cfg = {**load_config(root, cfg_entry), **(config_override or {})}
    traffic = {**load_traffic(cell["traffic"]), **(traffic_override or {})}
    kind = load_kind(traffic["kind"])
    marks = {}
    ctx = {"cfg": cfg, "traffic": traffic, "dev": dev, "seed": int(seed),
           "seconds": float(seconds), "trace": bool(traced),
           "system": load_system(cfg["system"]),
           "setup_done": lambda: marks.setdefault(
               "setup", time.perf_counter() - t_start)}
    out = kind.run(ctx)
    values = {"setup_s": marks["setup"],
              "peak_mem_gib": out["window_peak"] / 2**30, **out["metrics"]}
    # the window's peak: what the cell's traffic holds, its resident
    # structures included, and not the set-up's own temporaries
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": int(cell["chips"]),
              "memory_peak_bytes": out["window_peak"]}
    result = {"correct": None, "attempted": out["attempted"], "failed": 0,
              "metrics": {}, "device": device}
    if traced:
        reading = out.pop("reading")
        lo, hi = trace.window(reading.trace)
        device["busy_s"] = trace.busy_us(reading.trace.device, lo, hi) / 1e6
        device["window_s"] = (hi - lo) / 1e6
        for m in metrics_of(bench, "per_layer", name):
            v = load_reader(m["name"])(reading)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        result["breakdown"] = trace.breakdown(reading.trace)
    else:
        for m in metrics_of(bench, "end_to_end", name):
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    # the program's state goes before the reference runs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = kind.check(ctx, out)
    result["correct"] = all(v <= limit for v, limit in checks.values())
    result["checks"] = {k: {"value": v, "limit": limit}
                        for k, (v, limit) in checks.items()}
    return {"result": result, "values": values, "cfg": cfg,
            "traffic": traffic, "out": out}
