"""The port's chaos CLI (``repro_torch.launch.chaos``) on the CPU.

One ``--smoke --device cpu --metrics-dir D`` run, in-process, for the whole
module: every scenario row passes; the rows come in the reference's order
under the reference's names (written out below from
``src/repro/launch/chaos.py``; the reference's own run takes minutes on
a CPU, so it is not run here); the overload rows carry the reference's
``FakeClock`` numbers (served 105, shed 295, 91 degraded, p99 79.2 ms);
and the capture's span tree holds the ``chaos.*`` spans with the fault
events inside them.
"""
import pytest

from repro_torch import obs
from repro_torch.launch import chaos
from repro_torch.launch import obs as obs_cli
from repro_torch.obs.report import render_span_tree

#: the reference's row names (the text before " — "), in its order
REFERENCE_ROWS = [
    "clean restore bit-identical",
    "derived corruption repaired [superblock]",
    "derived corruption repaired [block]",
    "derived corruption repaired [sel1/sample]",
    "derived corruption repaired [sel0/sample]",
    "derived corruption repaired [zeros]",
    "primary corruption raises",
    "truncated npz skipped",
    "half-deleted step skipped",
    "partial .tmp write ignored",
    "in-memory corruption verify+repair",
    "in-memory primary flip detected + repair refused",
    "fm-index corruption repaired [C]",
    "fm-index corruption repaired [mark]",
    "fm-index corruption repaired [sa_sample]",
    "degraded index serves with bounds",
    *[f"ingest crash@{step} recovers bit-identical"
      for step in ("write_tmp", "checksum", "fsync", "intent", "rename",
                   "commit")],
    "ingest torn journal tail dropped + resumed",
    "ingest quarantine serves honest bounds",
    "ingest hot swap fences generations",
    "overload storm: bounded queue, explicit sheds, full accounting",
    "overload answers honest: deadline met or degraded-tagged, bounds "
    "bracket oracle",
    "overload accepted p99 within SLO",
    "slow shard: breaker opens, answers match availability-mask oracle, "
    "half-open recovers",
    "deadline storm: every request explicitly rejected pre-dispatch",
    "stuck swap: front-end serves on (new epoch), pinned session keeps old "
    "truth, fence completes on drain",
]

#: the reference's FakeClock overload details, row by row
REFERENCE_OVERLOAD = {
    "overload storm: bounded queue, explicit sheds, full accounting":
        "served 105, shed 295 (74%: ['expired', 'queue_full'])",
    "overload answers honest: deadline met or degraded-tagged, bounds "
    "bracket oracle": "91 degraded answers, 0 violations",
    "overload accepted p99 within SLO": "p99 79.2ms ≤ 80ms over 105 accepted",
}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("chaos")
    obs.REGISTRY.reset()
    check = chaos.main(["--smoke", "--device", "cpu", "--metrics-dir",
                        str(d / "m"), "--dir", str(d / "scratch")])
    return check, d / "m"


def test_every_row_passes(run):
    check, _ = run
    assert check.failures == 0
    assert all(ok for _, ok, _ in check.rows)


def test_rows_in_the_reference_order_and_names(run):
    check, _ = run
    assert [name for name, _, _ in check.rows] == REFERENCE_ROWS


def test_overload_rows_equal_the_reference_fake_clock_numbers(run):
    check, _ = run
    got = {name: detail for name, _, detail in check.rows
           if name in REFERENCE_OVERLOAD}
    assert got == REFERENCE_OVERLOAD


def test_capture_holds_the_chaos_spans_with_their_faults(run, capsys):
    _, mdir = run
    events = obs.read_events(mdir)
    spans = {e["name"] for e in events if e["kind"] == "span"}
    assert {"chaos.snapshot", "chaos.memory", "chaos.index", "chaos.ingest",
            "chaos.overload", "chaos.scenario"} <= spans
    by_id = {e["span_id"]: e for e in events if e["kind"] == "span"}
    faults = [e for e in events if e["kind"] == "fault"]
    assert {f["name"] for f in faults} >= {
        "fault.snapshot_bitflip", "fault.truncate", "fault.delete_file",
        "fault.partial_tmp", "fault.leaf_bitflip", "fault.crash_point",
        "fault.shard_latency"}
    for f in faults:                  # each fault sits inside a chaos span
        sp = by_id[f["span_id"]]
        while not sp["name"].startswith("chaos."):
            sp = by_id[sp["parent_id"]]
    tree = render_span_tree(events)
    assert "chaos.scenario" in tree and "* fault:fault.crash_point" in tree
    assert obs_cli.main([str(mdir), "--tree"]) == 0
    assert "span tree:" in capsys.readouterr().out
    snap = obs.read_snapshot(mdir)
    assert snap["counters"]["chaos.scenario{outcome=pass}"] == len(
        REFERENCE_ROWS)
    assert snap["counters"]["robust.fault{kind=crash_point}"] == 6
