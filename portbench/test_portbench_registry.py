"""The benchmark's registry: ``BENCHMARK.json`` keeps the contract's
shape, and every configuration, traffic mix, system and per-layer metric
is found by its name; no run loads JAX or the JAX package."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_benchmark_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = next(e for e in BENCH["end_to_end"]
                         if e["name"] == m["moves"])
            assert cell in moved.get("workloads", CELLS)
    for entry in (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                  + BENCH["per_layer"]):
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files(cell):
    workload, entry = harness.find_cell(BENCH, cell)
    cfg = harness.load_config(ROOT, entry)
    system = harness.load_system(cfg["system"])
    traffic = harness.load_traffic(workload["traffic"])
    kind = harness.load_kind(traffic["kind"])
    assert callable(kind.run) and callable(kind.check)
    if traffic["kind"] == "build":
        owner, fns = system, ("build", "check_build", "structure",
                              "build_work", "control_build")
    else:
        assert callable(system.serve)
        owner = harness.load_op(traffic["op"])
        fns = ("batches", "call", "check", "bounds_ms", "control")
    for fn in fns:
        assert callable(getattr(owner, fn)), fn
    reported = harness.metrics_of(BENCH, "end_to_end", cell)
    assert {"setup_s", "peak_mem_gib"} <= {m["name"] for m in reported}
    assert len(reported) >= 3
    assert harness.metrics_of(BENCH, "per_layer", cell)


@pytest.mark.parametrize("metric", METRICS)
def test_every_metric_has_a_reader(metric):
    assert callable(harness.load_reader(metric))


def test_a_metric_split_by_cell_falls_back_to_its_quantity():
    for name in ("launches.build", "launches.query", "idle_pct.index",
                 "kernels_roofline.build"):
        path = Path(harness.load_reader(name).__code__.co_filename)
        assert path.name == name.split(".")[0] + ".py"
    with pytest.raises(FileNotFoundError):
        harness.load_reader("no_such_metric.build")


def test_an_unknown_cell_is_named():
    with pytest.raises(KeyError, match="no workload"):
        harness.find_cell(BENCH, "lmcorpus.nothing")


def test_no_run_loads_jax_or_the_jax_package():
    """A CPU run of each kind of cell in a fresh process, then the loaded
    modules by top-level name (``repro_torch`` begins with ``repro``)."""
    code = f"""
import sys, time, json
sys.path[0:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import torch
from portbench import harness
from portbench.conftest import run_small
for cell in ("lmcorpus.build", "ngram_index.build", "lmcorpus.quantile"):
    assert run_small(cell)["result"]["correct"]
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_program():
    code = f"""
import sys, json
sys.path[0:0] = [{str(ROOT)!r}]
import portbench.reference.wavelet, portbench.reference.suffix
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}}
                        & {{'repro', 'repro_torch', 'jax'}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
