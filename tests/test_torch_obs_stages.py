"""``obs.stage`` and ``obs.timeline``: the hot paths' stages and their
reading from a ``torch.profiler`` trace.

* With no profiler recording and no exporter configured a stage is the
  shared null context: no ``record_function``, no histogram, no event; a
  span enters no ``record_function`` and takes no id, yet keeps its
  histogram and its path.
* Under the CPU profiler stages and spans are nested ``user_annotation``
  ranges; with an exporter a stage writes a ``span`` event under its
  parent, except a per-call stage (``export=False``, the quantile's
  dispatch), which stays a profiler's range only.
* The store build, the index build and a quantile batch emit their
  documented stages in the documented nesting (the CPU routes: no
  ``wm.zeros``, which only the kernel route has).
* ``timeline.split`` of a synthetic trace: device operations go to the
  innermost range that launched them, syncs to the range that holds them,
  stray operations apart, each thread to its own ranges; ``launch.obs
  --stages`` renders it.
* On the card: the builds' device time lies under named stages, the
  quantile kernel under ``engine.range_quantile``.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.analytics import build_sharded_analytics
from repro_torch.index import build_sharded_index
from repro_torch.launch import obs as obs_cli
from repro_torch.obs import spans, timeline

SIGMA = 300            # 9 levels: two τ-chunks, so the big step runs


@pytest.fixture(autouse=True)
def _clean():
    obs.REGISTRY.reset()
    yield
    obs.configure(None)
    obs.REGISTRY.reset()


def _count_record_function(monkeypatch) -> list:
    calls = []
    real = torch.profiler.record_function

    def counted(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return calls


def test_stage_without_profiler_or_exporter_records_nothing(monkeypatch,
                                                            tmp_path):
    calls = _count_record_function(monkeypatch)
    assert not spans.profiling()
    cm = obs.stage("wm.levels", chunk=0)
    assert cm is obs.stage("other")
    with cm as target:
        assert target is None and obs.current_span() is None
    with obs.span("outer") as sp:
        assert sp.span_id is None and sp.path == "outer"
        with obs.span("inner") as inner:
            assert inner.path == "outer/inner" and inner.parent_id is None
    assert calls == []
    hist = obs.REGISTRY.snapshot()["histograms"]
    assert set(hist) == {"span.outer", "span.inner"}


def test_stage_is_off_with_metrics_disabled(tmp_path):
    obs.configure(tmp_path)
    with obs.disabled(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert obs.stage("x") is obs.stage("y")
    assert obs.read_events(tmp_path) == []


def _profiled(fn, tmp_path) -> list:
    """The chrome trace events of ``fn()`` under the CPU profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    return timeline.load(path)


def test_stage_and_span_nest_under_the_profiler(monkeypatch, tmp_path):
    calls = _count_record_function(monkeypatch)

    def body():
        assert spans.profiling()
        with obs.span("outer"):
            with obs.stage("a", chunk=1):
                torch.ones(4).sum()
                with obs.stage("b"):
                    torch.ones(4).sum()
            with obs.stage("c"):
                pass
    events = _profiled(body, tmp_path)
    assert calls == ["outer", "a", "b", "c"]
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    assert {e["name"] for e in notes} >= {"outer", "a", "b", "c"}
    assert [r.path for r in timeline.ranges(events)] == [
        "outer", "outer/a", "outer/a/b", "outer/c"]
    assert set(obs.REGISTRY.snapshot()["histograms"]) == {"span.outer"}


def test_stage_with_an_exporter_writes_a_span_event(tmp_path):
    obs.configure(tmp_path)
    with obs.span("outer") as outer:
        assert outer.span_id is not None
        with obs.stage("wm.levels", chunk=2):
            assert obs.current_span().name == "wm.levels"
            obs.event("mid")
    ev = obs.read_events(tmp_path)
    by_name = {e["name"]: e for e in ev if e["kind"] == "span"}
    st = by_name["wm.levels"]
    assert st["parent_id"] == outer.span_id
    assert st["path"] == "outer/wm.levels" and st["attrs"] == {"chunk": 2}
    assert st["dur_s"] >= 0
    mid = next(e for e in ev if e["name"] == "mid")
    assert mid["span_id"] == st["span_id"]
    assert set(obs.REGISTRY.snapshot()["histograms"]) == {"span.outer"}


def test_a_per_call_stage_exports_nothing(monkeypatch, tmp_path):
    calls = _count_record_function(monkeypatch)
    obs.configure(tmp_path / "m")
    assert obs.stage("q", export=False) is obs.stage("r", export=False)
    toks = _tokens()
    eng = build_sharded_analytics(toks, SIGMA, shard_bits=10, device="cpu")
    n_events = len(obs.read_events(tmp_path / "m"))
    assert n_events > 0                  # the build's stages are exported
    lo = torch.tensor([0, 10, 500])

    def batch():
        with obs.span("batch") as sp:
            eng.range_quantile(lo, lo + 700, torch.tensor([0, 3, 9]))
            assert obs.current_span() is sp
    batch()
    ev = obs.read_events(tmp_path / "m")[n_events:]
    assert [e["name"] for e in ev] == ["batch"]
    assert "engine.range_quantile" not in calls
    events = _profiled(batch, tmp_path)
    assert _paths(events) == ["batch", "batch/engine.range_quantile"]
    ev = obs.read_events(tmp_path / "m")[n_events:]
    assert [e["name"] for e in ev] == ["batch", "batch"]


def _paths(events) -> list:
    """The ranges' paths in the order they first start."""
    seen = []
    for r in timeline.ranges(events):
        if r.path not in seen:
            seen.append(r.path)
    return seen


STORE = ["engine.build"] + ["engine.build/" + s for s in (
    "store.upload", "wm.levels", "wm.compose", "wm.directories",
    "store.histograms", "engine.operands")]
INDEX = ["sharded_index.build/" + s for s in (
    "sharded_index.prep", "sa.initial", "sa.round",
    "sa.converged", "bwt.gather", "bwt.c_table", "wm.levels", "wm.compose",
    "wm.directories", "fm.samples", "sharded_index.seams")]


def _tokens(n=3000, seed=0):
    return np.random.default_rng(seed).integers(0, SIGMA, n).astype(np.int32)


@pytest.mark.parametrize("path", ["store", "index", "quantile"])
def test_the_hot_paths_emit_their_stages(path, tmp_path):
    toks = _tokens()
    if path == "store":
        events = _profiled(lambda: build_sharded_analytics(
            toks, SIGMA, shard_bits=10, device="cpu"), tmp_path)
        want = STORE
    elif path == "index":
        events = _profiled(lambda: build_sharded_index(
            toks, SIGMA, shard_bits=10, device="cpu"), tmp_path)
        want = ["sharded_index.build"] + INDEX
    else:
        eng = build_sharded_analytics(toks, SIGMA, shard_bits=10,
                                      device="cpu")
        lo = torch.tensor([0, 10, 500])
        events = _profiled(lambda: eng.range_quantile(
            lo, lo + 700, torch.tensor([0, 3, 9])), tmp_path)
        want = ["engine.range_quantile"]
    assert _paths(events) == want
    rows = {r.path: r for r in timeline.split(events)[0]}
    if path == "store":
        assert rows["engine.build/wm.levels"].calls == 2    # two τ-chunks
    if path == "index":
        assert rows[INDEX[2]].calls == rows[INDEX[3]].calls >= 1


def _synthetic() -> list:
    """A trace: entry E (0-100) holding stage A (10-40, inside it B 20-30)
    and stage C (50-90); a launch in each, a sync in B and one outside E,
    and a device operation that no runtime call launched."""
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": args}
    return [
        x("user_annotation", "ProfilerStep#1", 0, 300),
        x("user_annotation", "E", 0, 100),
        x("user_annotation", "A", 10, 30),
        x("user_annotation", "B", 20, 10),
        x("user_annotation", "C", 50, 40),
        x("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=2),
        x("cuda_runtime", "cudaMemcpyAsync", 22, 1, correlation=3),
        x("cuda_runtime", "cudaStreamSynchronize", 24, 2, correlation=4),
        x("cuda_driver", "cuLaunchKernel", 60, 1, correlation=5),
        x("cuda_runtime", "cudaDeviceSynchronize", 150, 2, correlation=6),
        x("kernel", "k_entry", 200, 3, correlation=1),
        x("kernel", "k_a", 203, 5, correlation=2),
        x("gpu_memcpy", "Memcpy DtoH", 208, 7, correlation=3),
        x("kernel", "k_c", 215, 11, correlation=5),
        x("gpu_memset", "Memset", 230, 13, correlation=99),
    ]


def test_timeline_splits_device_time_and_syncs_by_stage():
    rows, stray = timeline.split(_synthetic())
    got = {r.path: (r.calls, r.host_us, r.device_us, r.self_device_us,
                    r.launches, r.syncs) for r in rows}
    assert got == {"E": (1, 100, 26, 3, 4, 1),
                   "E/A": (1, 30, 12, 5, 2, 1),
                   "E/A/B": (1, 10, 7, 7, 1, 1),
                   "E/C": (1, 40, 11, 11, 1, 0)}
    assert stray == 13
    assert [r.name for r in rows] == ["E", "A", "B", "C"]
    assert [r.depth for r in rows] == [0, 1, 2, 1]
    out = timeline.render(rows, stray)
    assert out.splitlines()[2].startswith("  A ")
    assert "outside every range: 0.013" in out


def test_timeline_keeps_each_thread_to_its_own_ranges():
    """A second thread's range, launch and sync, all inside the main
    thread's stage A, stay the second thread's; its call outside any of
    its own ranges is counted nowhere."""
    def x(cat, name, ts, dur, tid, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 7, "tid": tid, "args": args}
    events = [
        x("user_annotation", "E", 0, 100, 1),
        x("user_annotation", "A", 10, 60, 1),
        x("user_annotation", "R", 20, 30, 2),
        x("cuda_runtime", "cudaLaunchKernel", 15, 1, 1, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 30, 1, 2, correlation=2),
        x("cuda_runtime", "cudaStreamSynchronize", 32, 2, 2, correlation=3),
        x("cuda_runtime", "cudaStreamSynchronize", 60, 2, 2, correlation=4),
        x("cuda_runtime", "cudaLaunchKernel", 62, 1, 2, correlation=5),
        x("kernel", "k_a", 200, 3, 9, correlation=1),
        x("kernel", "k_r", 203, 5, 9, correlation=2),
        x("kernel", "k_stray", 210, 7, 9, correlation=5),
    ]
    assert [r.path for r in timeline.ranges(events)] == ["E", "E/A", "R"]
    rows, stray = timeline.split(events)
    got = {r.path: (r.calls, r.device_us, r.launches, r.syncs)
           for r in rows}
    assert got == {"E": (1, 3, 1, 0), "E/A": (1, 3, 1, 0),
                   "R": (1, 5, 1, 1)}
    assert stray == 7


def test_innermost_range_of_points_in_any_order():
    rs = timeline.ranges(_synthetic())
    got = timeline.innermost(rs, [95.0, 25.0, 5.0, 150.0, 40.0])
    assert [r.name if r else None for r in got] == ["E", "B", "E", None,
                                                   "A"]


def test_launch_obs_renders_the_stages_of_a_profile_dir(tmp_path, capsys):
    assert obs_cli.main([str(tmp_path), "--stages"]) == 2
    (tmp_path / "trace.json").write_text(
        json.dumps({"traceEvents": _synthetic()}))
    with obs.trace(tmp_path, obs.prof.BUILD_TRACE_FILE):
        with obs.stage("wm.levels"):
            torch.ones(8).cumsum(0)
    assert (tmp_path / "build_trace.json").exists()
    capsys.readouterr()
    assert obs_cli.main([str(tmp_path), "--stages"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("build_trace.json:\n") and "\ntrace.json:\n" in out
    assert "\nwm.levels " in out and "\n    B " in out


def _card_trace(fn, tmp_path) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()                                     # kernels built and loaded
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    path = tmp_path / "card.json"
    prof.export_chrome_trace(str(path))
    return timeline.load(path)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["store", "index"])
def test_card_builds_spend_their_device_time_in_named_stages(path,
                                                             tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    toks = np.random.default_rng(1).integers(0, 151936, 1 << 20).astype(
        np.int32)
    if path == "store":
        t = torch.from_numpy(toks).cuda()
        entry, syncs = "engine.build", 1          # the range check
        events = _card_trace(lambda: build_sharded_analytics(
            t, 151936, shard_bits=16, device="cuda"), tmp_path)
    else:
        entry, syncs = "sharded_index.build", 4   # 2 checks, 2+ rounds
        events = _card_trace(lambda: build_sharded_index(
            toks, 151936, shard_bits=16, device="cuda"), tmp_path)
    rows = {r.path: r for r in timeline.split(events)[0]}
    e = rows[entry]
    assert e.launches > 0 and e.syncs >= syncs
    assert e.self_device_us <= 0.05 * e.device_us
    if path == "store":
        assert rows[entry + "/wm.zeros"].launches >= 1
        assert rows[entry + "/wm.levels"].launches >= 18


@pytest.mark.cuda
def test_card_quantile_kernel_launches_inside_its_stage(tmp_path):
    """Eight batches under the profiler, their operands made before it:
    every quantile kernel the trace holds was launched inside
    ``engine.range_quantile``, no device operation outside it, no sync in
    it. At least one kernel, not eight: in a process that has run many
    profiler sessions the first records of a session can be missing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 151936, 1 << 18).astype(np.int32)).cuda()
    eng = build_sharded_analytics(toks, 151936, shard_bits=16,
                                  device="cuda")
    lo = torch.arange(0, 4096, dtype=torch.int32, device="cuda") * 17
    args = [(lo + i, lo + 999, lo % 7) for i in range(8)]

    def batches():
        for a in args:
            eng.range_quantile(*a)
    events = _card_trace(batches, tmp_path)
    rows, stray = timeline.split(events)
    assert [r.path for r in rows] == ["engine.range_quantile"]
    st = rows[0]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "wm_quantile" in e.get("name", "")]
    assert 1 <= len(kernels) <= 8 and st.calls == 8 and st.syncs == 0
    assert st.launches >= len(kernels) and stray == 0
    assert st.self_device_us >= sum(e["dur"] for e in kernels)
