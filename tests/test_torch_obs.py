"""The port's ``repro_torch.obs`` against the reference's ``repro.obs``.

* The same scripted instrument calls give equal registry snapshots (the
  histograms past their raw head compared bucket by bucket) and byte-equal
  Prometheus text.
* A capture written by either package renders the same through either
  package's ``launch.obs`` (table and span tree).
* Disabled mode is a no-op; spans nest, carry events and wait on CPU
  tensors; ``time_compiled``, ``timed_op`` and ``track_shapes``.
* ``launch.regress`` gives the reference's report and exit codes on the
  histories of ``tests/test_history.py``.
* The kernel wrappers' ``kernels.work.*`` gauges equal the reference's,
  and ``profile_op`` of a wrapper op gives a roofline in (0, 1] from the
  work model, whose quantile bytes equal an independent count.
* No module of ``repro_torch.obs``, of the port's CLIs or LM serving path,
  no port example and not ``chip_smoke.py`` imports ``jax``, ``ml_dtypes``
  or ``repro`` (a subprocess with all three blocked).
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.launch import obs as robs_cli
from repro.launch import regress as rregress
from repro.obs import metrics as rmetrics
from repro.obs.history import HISTORY_FILE, append_history
from repro_torch import obs as tobs
from repro_torch.kernels import ops as tops
from repro_torch.launch import obs as tobs_cli
from repro_torch.launch import regress as tregress
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import prof as tprof

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True)
def _clean_registries():
    for o in (robs, tobs):
        o.REGISTRY.reset()
        o.reset_shape_tracking()
    yield
    for o in (robs, tobs):
        o.configure(None)
        o.REGISTRY.reset()


def _script(m) -> "object":
    """One scripted sequence of instrument calls on a fresh registry of
    module ``m`` (either package's ``obs.metrics``)."""
    reg = m.MetricsRegistry()
    rng = np.random.default_rng(0)
    reg.counter("core.build", builder="wm", path="fused").inc()
    reg.counter("core.build", builder="wm", path="fused").inc(3)
    reg.counter("robust.fault", kind="leaf_bitflip").inc()
    reg.counter("plain").inc(7)
    reg.gauge("serve.x.qps").set(123.5)
    reg.gauge("weird name{a=1}", op="a/b").set(-2)
    reg.gauge("never.set")
    for v in rng.lognormal(-6, 2, 500):
        reg.histogram("serve.analytics.quantile.latency_s").observe(v)
    small = reg.histogram("small", raw_cap=16)
    for v in list(rng.exponential(0.01, 300)) + [0.0, -1.0, 1e-9, 5e4]:
        small.observe(v)
    return reg


def test_scripted_registries_are_equal():
    r, t = _script(rmetrics), _script(tmetrics)
    assert r.snapshot() == t.snapshot()
    for key, h in r.histograms.items():
        assert h._buckets == t.histograms[key]._buckets
        assert h._raw == t.histograms[key]._raw
    assert tmetrics.parse_key("a{b=1,c=x}") == rmetrics.parse_key(
        "a{b=1,c=x}")


def test_prometheus_text_is_byte_equal():
    r, t = _script(rmetrics), _script(tmetrics)
    assert (tobs.prometheus_text(t.snapshot())
            == robs.prometheus_text(r.snapshot()))


def _capture(o, directory, array):
    """A small capture through package ``o``: spans with events, a timed
    serving op, counters; written as snapshot.json + events.jsonl."""
    o.configure(directory)
    with o.span("chaos.scenario", scenario="demo") as sp:
        o.event("fault.demo", kind="fault", leaf="x")
        with o.span("analytics.load", step=0):
            o.counter("robust.restore", outcome="clean").inc()
        sp.set("outcome", "ok")
    for _ in range(3):
        o.timed_op("analytics", "quantile", lambda x: x + 1, array, batch=8)
    o.histogram("serve.frontend.count.latency_s").observe(0.25)
    o.write_snapshot()
    o.configure(None)


def _render(cli, directory, capsys, *args) -> str:
    assert cli.main([str(directory), *args]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_either_launch_obs_renders_either_capture(writer, tmp_path, capsys):
    if writer == "port":
        _capture(tobs, tmp_path, torch.arange(4))
    else:
        _capture(robs, tmp_path, jnp.arange(4))
    for args in ((), ("--tree",), ("--counters",), ("--prometheus",)):
        want = _render(robs_cli, tmp_path, capsys, *args)
        assert _render(tobs_cli, tmp_path, capsys, *args) == want
    table = _render(tobs_cli, tmp_path, capsys)
    assert table.splitlines()[2].startswith("analytics.quantile  6 ")
    tree = _render(tobs_cli, tmp_path, capsys, "--tree")
    assert "chaos.scenario [" in tree and "  analytics.load [" in tree
    assert "* fault:fault.demo leaf=x" in tree
    for cli, name in ((robs_cli, "r.html"), (tobs_cli, "t.html")):
        assert cli.main([str(tmp_path), "--html",
                         str(tmp_path / name)]) == 0
    assert "Span waterfall" in (tmp_path / "t.html").read_text()


def test_snapshot_meta_names_the_torch_runtime(tmp_path):
    tobs.configure(tmp_path)
    tobs.counter("x").inc()
    tobs.write_snapshot()
    meta = tobs.read_snapshot(tmp_path)["meta"]
    assert meta["torch_version"] == torch.__version__
    assert meta["backend"] == ("cuda" if torch.cuda.is_available()
                               else "cpu")
    assert "jax_version" not in meta and meta["device_count"] >= 1


def test_disabled_mode_is_a_no_op(tmp_path):
    tobs.configure(tmp_path)
    c, g, h = (tobs.counter("c"), tobs.gauge("g"), tobs.histogram("h"))
    with tobs.disabled():
        assert not tobs.enabled()
        c.inc(5)
        g.set(1.0)
        h.observe(1.0)
        with tobs.span("s") as sp:
            sp.set("k", 1)
            assert sp.sync(torch.ones(2)) is not None
            tobs.event("e")
        assert tobs.track_shapes("op", torch.ones(2)) is False
    assert tobs.enabled()
    snap = tobs.REGISTRY.snapshot()
    assert snap["counters"] == {"c": 0}
    assert snap["gauges"] == {} and snap["histograms"] == {}
    assert tobs.read_events(tmp_path) == []


def test_spans_nest_carry_events_and_wait_on_cpu_tensors(tmp_path):
    from repro_torch.core.wavelet_matrix import build_wavelet_matrix
    tobs.configure(tmp_path)
    wm = build_wavelet_matrix(torch.arange(64) % 7, 7, device="cpu")
    with tobs.span("outer", a=1) as outer:
        with tobs.span("inner") as inner:
            assert tobs.current_span() is inner
            tobs.event("mid", x=2)
            assert inner.sync((wm, [torch.ones(3)], {"k": torch.zeros(1)}))
            assert inner.path == "outer/inner"
        outer.set("done", True)
    assert tobs.current_span() is None
    ev = tobs.read_events(tmp_path)
    spans = {e["name"]: e for e in ev if e["kind"] == "span"}
    assert spans["inner"]["parent_id"] == spans["outer"]["span_id"]
    assert spans["outer"]["attrs"] == {"a": 1, "done": True}
    mid = next(e for e in ev if e["name"] == "mid")
    assert mid["span_id"] == spans["inner"]["span_id"]
    assert mid["attrs"] == {"x": 2}
    hist = tobs.REGISTRY.snapshot()["histograms"]
    assert hist["span.outer"]["count"] == hist["span.inner"]["count"] == 1
    leaves = tobs.spans.tensor_leaves((wm, 3, [torch.ones(1)]))
    from repro_torch.tree import tree_leaves
    assert len(leaves) == len(tree_leaves(wm)) + 1


@pytest.mark.parametrize("body_raises", [False, True])
def test_span_raises_its_sync_error_unless_the_body_raised(body_raises,
                                                           tmp_path,
                                                           monkeypatch):
    """The synchronize is where a card raises its asynchronous errors: after
    a clean body the span ends and raises it; the body's own error wins."""
    from repro_torch.kernels.build import KernelError

    def failing_wait(value):
        raise KernelError("launch failed")

    monkeypatch.setattr(tobs.spans, "wait_for", failing_wait)
    tobs.configure(tmp_path)
    want = ValueError if body_raises else KernelError
    with pytest.raises(want):
        with tobs.span("s") as sp:
            sp.sync(torch.ones(2))
            if body_raises:
                raise ValueError("body")
    assert tobs.current_span() is None
    ends = [e for e in tobs.read_events(tmp_path) if e["kind"] == "span"]
    assert [e["name"] for e in ends] == ["s"]


@pytest.mark.parametrize("profile", [
    lambda fn: tobs.profile_op("t.dev", fn),
    lambda fn: tobs.profiled_op("t", "dev", fn)])
def test_profiling_raises_device_errors(profile):
    """Profiling degrades on other failures, never on the device's."""
    from repro_torch.kernels.build import KernelError

    def broken():
        raise KernelError("CUDA kernel build failed")

    with pytest.raises(KernelError):
        profile(broken)
    with pytest.raises(torch.OutOfMemoryError):
        profile(lambda: (_ for _ in ()).throw(torch.OutOfMemoryError("oom")))
    assert "prof.error{op=t.dev}" not in tobs.REGISTRY.snapshot()["counters"]


def test_time_compiled_and_timed_op_family():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    x = torch.arange(5)
    out, steady, first = tobs.time_compiled(fn, x, iters=3)
    assert torch.equal(out, x * 2) and len(calls) == 4
    assert steady > 0 and first > 0
    out, steady, first = tobs.timed_op("analytics", "dbl", fn, x, batch=5,
                                       iters=2)
    snap = tobs.REGISTRY.snapshot()
    assert snap["counters"]["serve.analytics.dbl.calls"] == 3
    assert snap["histograms"]["serve.analytics.dbl.latency_s"]["count"] == 1
    assert snap["gauges"]["serve.analytics.dbl.batch"] == 5
    assert snap["gauges"]["serve.analytics.dbl.compile_s"] == first
    assert snap["gauges"]["serve.analytics.dbl.qps"] == pytest.approx(
        5 / steady)


def test_track_shapes_counts_as_the_reference():
    shapes = [(8,), (8,), (32,), (8,), (128,), (32,)]
    for s in shapes:
        robs.track_shapes("frontend.count", jnp.zeros(s, jnp.int32), 3)
        tobs.track_shapes("frontend.count", torch.zeros(s, dtype=torch.int32),
                          3)
    want = robs.REGISTRY.snapshot()["counters"]
    got = tobs.REGISTRY.snapshot()["counters"]
    assert got == want
    assert got["jit.shapes{op=frontend.count}"] == 3
    assert got["jit.calls{op=frontend.count}"] == 6


def _meta(commit, host="h1", fast=True):
    return {"git_commit": commit, "git_dirty": False, "backend": "cpu",
            "host": host, "fast": fast, "timestamp": "2026-08-09T00:00:00",
            "seed": 0}


def _series(path, values, host="h1", fast=True):
    for i, v in enumerate(values):
        append_history(path, "wt", [{"name": "build", "us_per_call": v}],
                       _meta(f"c{i}", host=host, fast=fast))


@pytest.mark.parametrize("values,args,rc", [
    ([100, 101, 99, 100, 100, 200], [], 1),            # a 2x step fails
    ([100, 128, 84, 117, 92, 109, 122], [], 0),        # noisy, flat
    ([100, 100, 100, 100, 400], ["--fail-on", "none"], 0),
    ([100.0 * 1.07 ** i for i in range(12)], ["--fail-on", "drift", "-v"],
     1),
    (None, [], 2),                                     # no history: soft
])
def test_regress_gives_the_reference_report(values, args, rc, tmp_path,
                                            capsys):
    path = tmp_path / HISTORY_FILE
    if values is not None:
        _series(path, values)
        _series(path, [50, 51], host="h2", fast=False)
    argv = ["--history", str(path), *args]
    assert rregress.main(argv) == rc
    want = capsys.readouterr()
    assert tregress.main(argv) == rc
    got = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)


def test_kernel_work_gauges_equal_the_reference():
    """The reference's gauges fire when its jitted wrappers trace: the
    shapes here are used by no other test, so they trace here (the jit
    caches are left alone: other tests of a worker rely on them)."""
    from repro.kernels import ops as rops
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 104).astype(np.int32)
    digits = rng.integers(0, 16, 203).astype(np.int32)
    words = rng.integers(-(1 << 31), 1 << 31, 7, dtype=np.int64).astype(
        np.int32)
    levels = rng.integers(-(1 << 31), 1 << 31, (3, 7), dtype=np.int64
                          ).astype(np.int32)
    rops.bitpack(jnp.asarray(bits))
    rops.radix_rank(jnp.asarray(digits), 16)
    rops.rank_build(jnp.asarray(words), 213)
    rops.rank_build_levels(jnp.asarray(levels), 213)
    tops.bitpack(torch.from_numpy(bits))
    tops.radix_rank(torch.from_numpy(digits), 16)
    tops.rank_build(torch.from_numpy(words), 213)
    tops.rank_build_levels(torch.from_numpy(levels), 213)
    want = {k: v for k, v in robs.REGISTRY.snapshot()["gauges"].items()
            if k.startswith("kernels.work.")}
    got = {k: v for k, v in tobs.REGISTRY.snapshot()["gauges"].items()
           if k.startswith("kernels.work.")}
    assert len(want) == 7 and got == want
    traces = {k for k in tobs.REGISTRY.snapshot()["counters"]
              if k.startswith("kernels.trace")}
    assert traces == {f"kernels.trace{{op={op},route=plain}}" for op in
                      ("bitpack", "radix_rank", "rank_build",
                       "rank_build_levels")}


def test_profile_op_roofline_of_a_wrapper_op_on_the_cpu():
    n = 1 << 16
    bits = torch.from_numpy(np.random.default_rng(1).integers(0, 2, n)
                            ).to(torch.int32)
    out, stats = tobs.profile_op("t.bitpack", tops.bitpack, bits, iters=3,
                                 work_elements=float(n))
    assert torch.equal(out, tops.bitpack(bits))
    assert stats["bytes_accessed"] == n * 4 + (n // 32) * 4
    assert stats["int_ops"] == n * 2
    assert 0 < stats["roofline_util"] <= 1.0
    assert stats["bound"] in ("compute", "memory")
    assert "peak_bytes" not in stats            # the CPU records none
    g = tobs.REGISTRY.snapshot()["gauges"]
    assert g["prof.roofline_util{op=t.bitpack}"] == stats["roofline_util"]
    assert g["prof.melem_per_s{op=t.bitpack}"] > 0
    # an op that reaches no kernel wrapper has no roofline
    _, plain = tobs.profile_op("t.plain", lambda x: x + 1, bits)
    assert "roofline_util" not in plain and "error" not in plain
    # profiling never raises unless strict
    _, bad = tobs.profile_op("t.bad", lambda: 1 / 0)
    assert "error" in bad
    assert tobs.REGISTRY.snapshot()["counters"]["prof.error{op=t.bad}"] == 1
    with pytest.raises(ZeroDivisionError):
        tobs.profile_op("t.bad", lambda: 1 / 0, strict=True)


def test_profiled_op_emits_both_families():
    x = torch.ones(64, dtype=torch.int32)
    out, steady, first = tobs.profiled_op("analytics", "pack", tops.bitpack,
                                          x, batch=64, iters=2)
    snap = tobs.REGISTRY.snapshot()
    assert snap["counters"]["serve.analytics.pack.calls"] == 3
    assert snap["histograms"]["serve.analytics.pack.latency_s"]["count"] == 1
    assert 0 < snap["gauges"]["prof.roofline_util{op=analytics.pack}"] <= 1


def test_hardware_model():
    assert tprof.hw_model("cpu") == tprof.HW_MODELS["cpu"]
    h100 = tprof.hw_model("cuda", device_name="NVIDIA H100 80GB HBM3")
    assert h100 == (989e12, 3.35e12, 16.7e12)
    with pytest.raises(ValueError):
        tprof.hw_model("cuda", device_name="NVIDIA A100-SXM4-80GB")


def test_hardware_model_env_overrides(monkeypatch):
    monkeypatch.setenv("REPRO_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("REPRO_HBM_BW", "2e11")
    assert tprof.hw_model("cuda", device_name="Other") == (1e12, 2e11, 1e12)
    assert tprof.hw_model("cpu") == (1e12, 2e11, 1e12)   # override wins


def test_quantile_work_counts_the_bound_s_sectors():
    """The work model's bytes for a quantile batch against an independent
    count of the descent's live probes and their distinct sectors (the
    level-descent primitives on the shards, as ``chip_smoke.py`` counts
    the bound's bytes)."""
    from repro_torch.analytics import build_sharded_analytics
    from repro_torch.analytics.engine import local_ranges
    from repro_torch.core.wavelet_matrix import (wm_child_interval,
                                                 wm_interval_zeros)
    from repro_torch.kernels import wm_quantile
    rng = np.random.default_rng(4)
    n, sigma, sb = 5000, 300, 10
    eng = build_sharded_analytics(rng.integers(0, sigma, n), sigma,
                                  shard_bits=sb, device="cpu")
    lo = torch.from_numpy(rng.integers(-5, n, 200).astype(np.int32))
    hi = lo + torch.from_numpy(rng.integers(-3, 3000, 200).astype(np.int32))
    k = torch.from_numpy(rng.integers(-2, 500, 200).astype(np.int32))
    nbytes, nops = wm_quantile.quantile_work(eng.quantile, lo, hi, k)

    S, nbits = eng.num_shards, eng.shards.nbits
    los, his = local_ranges(sb, S, n, lo, hi)
    kk = torch.minimum(k.long().clamp(min=0),
                       ((his - los).sum(0) - 1).clamp(min=0))
    per_row = (1 << sb) // wm_quantile.SECTOR_BITS + 1
    probes, keys = 0, []
    for l in range(nbits):
        live = his > los
        probes += 2 * int(live.sum())
        row = ((torch.arange(S)[:, None] * nbits + l).expand_as(los)[live]
               * per_row)
        keys += [row + los[live] // wm_quantile.SECTOR_BITS,
                 row + his[live] // wm_quantile.SECTOR_BITS]
        lo0, hi0 = wm_interval_zeros(eng.shards, l, los, his)
        z = (hi0 - lo0).sum(0)
        bit = (kk >= z).long()
        kk = torch.where(bit == 1, kk - z, kk)
        los, his = wm_child_interval(eng.shards, l, los, his, bit, lo0, hi0)
    sectors = int(torch.unique(torch.cat(keys)).numel())
    assert nbytes == 200 * 16 + sectors * wm_quantile.SECTOR_BYTES
    assert nops == probes * wm_quantile.PROBE_OPS
    with tprof.collect_work() as work:
        eng.range_quantile(lo, hi, k)
    assert work.bytes == nbytes and work.int_ops == nops


def test_no_jax_or_reference_import():
    """Every module of repro_torch.obs, the port's CLIs, its LM serving path
    (configs, models, ``convert``), its training half (``optim``,
    ``train``, ``data.pipeline``, ``launch.train``, ``launch.profile_train``),
    the port's examples and ``chip_smoke.py`` import in a process where
    importing ``jax``, ``ml_dtypes`` or ``repro`` raises."""
    code = textwrap.dedent("""
        import importlib, importlib.util, sys
        from pathlib import Path

        class Block:
            def find_spec(self, name, path=None, target=None):
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "ml_dtypes", "repro"):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        from repro_torch.configs.base import ARCHITECTURES
        for m in ("repro_torch.obs", "repro_torch.obs.metrics",
                  "repro_torch.obs.export", "repro_torch.obs.spans",
                  "repro_torch.obs.timing", "repro_torch.obs.report",
                  "repro_torch.obs.history", "repro_torch.obs.html",
                  "repro_torch.obs.prof", "repro_torch.launch.obs",
                  "repro_torch.launch.regress", "repro_torch.launch.chaos",
                  "repro_torch.launch.analytics", "repro_torch.launch.index",
                  "repro_torch.launch.frontend", "repro_torch.launch.serve",
                  "repro_torch.launch.profile_tree",
                  "repro_torch.launch.profile_index", "repro_torch.convert",
                  "repro_torch.configs", "repro_torch.models",
                  "repro_torch.models.layers", "repro_torch.models.ssm",
                  "repro_torch.models.moe", "repro_torch.models.model",
                  "repro_torch.optim", "repro_torch.optim.adamw",
                  "repro_torch.optim.schedule",
                  "repro_torch.optim.grad_compress", "repro_torch.train",
                  "repro_torch.train.trainer", "repro_torch.data.pipeline",
                  "repro_torch.launch.train",
                  "repro_torch.launch.profile_train",
                  "repro_torch.launch.profile_serve",
                  *(f"repro_torch.configs.{a}" for a in ARCHITECTURES)):
            importlib.import_module(m)
        root = Path(sys.argv[1])
        for f in (*sorted((root / "examples").glob("torch_*.py")),
                  root / "chip_smoke.py"):
            spec = importlib.util.spec_from_file_location(f.stem, f)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro")]
        assert not bad, bad
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", code, str(SRC.parent)],
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(SRC),
                              "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
