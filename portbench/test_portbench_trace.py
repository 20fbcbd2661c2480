"""The yardstick's arithmetic: the busy and idle shares and the breakdown
of a synthetic chrome trace, the rooflines from the frozen work counts,
the tail over every batch, and the result line's keys."""
import json

import numpy as np
import pytest

from portbench import trace, work


def event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


SYNTHETIC = [
    event("user_annotation", "build", 0, 100),
    event("user_annotation", "build", 120, 80),
    event("user_annotation", "ProfilerStep#1", 0, 300),   # not ours
    event("cpu_op", "aten::cumsum", 5, 20),
    event("cpu_op", "aten::nonzero", 60, 30),
    event("cpu_op", "aten::item", 62, 10),
    event("kernel", "void zero_scan_kernel<false, true>(Params)", 10, 30),
    event("kernel", "void at::native::cumsum_kernel(float)", 30, 20),
    event("gpu_memcpy", "Memcpy DtoH", 100, 10),
    event("gpu_memset", "Memset", 150, 20),
    event("cuda_runtime", "cudaLaunchKernel", 10, 2),                  # host
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
]


def test_busy_and_idle_shares_of_a_synthetic_trace():
    t = trace.parse(SYNTHETIC)
    assert len(t.device) == 4 and len(t.spans) == 2
    assert trace.window(t) == (0.0, 200.0)
    # union: [10, 50) + [100, 110) + [150, 170) = 70 of 200
    assert trace.busy_us(t.device, 0, 200) == pytest.approx(70.0)
    assert trace.idle_pct(t) == pytest.approx(65.0)
    assert trace.idle_gaps(t, 0, 200) == [(0, 10), (50.0, 100), (110.0, 150),
                                          (170.0, 200)]
    assert trace.glue_us(t) == pytest.approx(50.0)
    assert trace.kernel_us(t) == {"wm_level_scan": 30.0}
    assert trace.launches(t, "wm_level_scan") == 1


def test_breakdown_names_the_host_op_of_each_gap():
    b = trace.breakdown(trace.parse(SYNTHETIC))
    gaps = dict(b["idle_gaps"])
    assert gaps["build: aten::cumsum"] == pytest.approx(10e-6)   # (0, 10)
    assert gaps["build: aten::nonzero"] == pytest.approx(50e-6)  # (50, 100)
    assert gaps["build"] == pytest.approx(70e-6)   # (110, 150), (170, 200)
    assert b["device_ops"][0][1] == pytest.approx(30e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_frozen_counts_give_the_kernel_tables_bounds():
    """The bounds of the kernel table (PERF.md) at the store's shapes."""
    rows, n, sigma = 128, 1 << 20, 151_936
    build = work.matrix_build(rows, n, sigma)
    assert len(build["wm_level_scan"]) == 18
    assert work.launches_bound_ms(build["wm_level_scan"][:1]) == \
        pytest.approx(0.326, abs=5e-4)
    assert work.launches_bound_ms(build["wm_level_zeros"]) == \
        pytest.approx(0.160, abs=1e-3)
    assert work.launches_bound_ms(build["rank_build_levels"]) == \
        pytest.approx(0.104, abs=1e-3)
    index = work.index_build(rows, n, sigma, 18)
    assert len(index["radix_scan"]) == 18
    assert work.launches_bound_ms(index["radix_scan"][:1]) == \
        pytest.approx(0.3205, abs=1e-3)
    assert work.launches_bound_ms(index["radix_totals"][:1]) == \
        pytest.approx(0.1603, abs=1e-3)
    assert len(index["rank_build_levels"]) == 2


def test_roofline_share_from_the_frozen_counts():
    per_level = work.launches_bound_ms(
        work.matrix_build(128, 1 << 20, 151_936)["wm_level_scan"][:1])
    t = trace.parse([event("user_annotation", "build", 0, 2000)] + [
        event("kernel", "zero_scan_kernel<false, true>", 100 * i, 50)
        for i in range(18)])
    share = trace.roofline_pct({"wm_level_scan": 18 * per_level}, t,
                               ("wm_level_scan",))
    assert share == pytest.approx(100 * per_level * 1e3 / 50)
    assert trace.roofline_pct({}, t, ("wm_level_scan",)) is None
    assert trace.roofline_pct({"radix_scan": 1.0}, t, ("radix_scan",)) is None


def test_quantile_bound_counts_each_sector_once():
    import torch
    los = torch.tensor([[0, 0], [10, 500]])
    his = torch.tensor([[5, 5], [300, 10]])
    # shard 0: two probes of one range, both ends in sector 0, twice;
    # shard 1: one live range (10, 300), ends in sectors 0 and 1
    probes, sectors = work.level_sectors(los, his, 0, 18, 20)
    assert probes == 6 and sectors == 3
    assert work.quantile_bound_ms(2, probes, sectors, 18) == pytest.approx(
        18 * work.L2_LOAD_NS * 1e-6)


def test_the_tail_is_taken_over_every_batch(small_run):
    run = small_run("lmcorpus.quantile")
    out, values = run["out"], run["values"]
    lat = out["latencies"]
    assert len(lat) * run["traffic"]["batch"] == out["attempted"]
    assert values["query_p95_ms"] == pytest.approx(np.percentile(lat, 95))
    assert values["query_q_s"] == pytest.approx(
        out["attempted"] / out["elapsed"])


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_lines_keys(small_run, traced):
    result = small_run("lmcorpus.build", traced=traced)["result"]
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert result["correct"] is True
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if traced:
        assert "breakdown" in keys
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert result["metrics"]["bits_per_token"]["unit"] == "bits/tok"
    else:
        assert set(result["metrics"]) == {"build_tok_s", "peak_mem_gib",
                                          "setup_s"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)
