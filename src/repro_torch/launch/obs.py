"""Telemetry summary CLI: render a ``--metrics-dir`` capture into a
per-op SLO table (p50/p95/p99/max latency, q/s, batch, compile cost) with
optional threshold checks, path-selection counters, and the correlated
span tree of a run.

PYTHONPATH=src python -m repro_torch.launch.analytics --smoke --device cpu \
    --metrics-dir /tmp/m
PYTHONPATH=src python -m repro_torch.launch.obs /tmp/m
PYTHONPATH=src python -m repro_torch.launch.obs /tmp/m \
    --slo 'analytics.*:p99_ms<=2000' --slo 'analytics.quantile:qps>=100'
PYTHONPATH=src python -m repro_torch.launch.obs /tmp/m --tree       # span tree
PYTHONPATH=src python -m repro_torch.launch.obs /tmp/m --prometheus # text format
PYTHONPATH=src python -m repro_torch.launch.obs /tmp/m --html /tmp/m/dash.html
PYTHONPATH=src python -m repro_torch.launch.obs /tmp/p --stages   # --profile-dir

``--html`` writes the self-contained dashboard page (SLO table, roofline
profile, span waterfall, and — with ``--history`` or the default
``results/bench/history.jsonl`` — per-commit bench-trajectory
sparklines).

``--stages`` reads the chrome traces that a CLI's ``--profile-dir`` wrote
into the directory (``build_trace.json``, ``trace.json``) and prints, for
every span and stage in them, its host time, the device time and launches
of the operations it launched, and its host syncs (``obs.timeline``).

Exit status is nonzero when any ``--slo`` check is violated, so the
command doubles as a CI gate on serving latency. The capture's files are
the reference's: this CLI reads a ``repro`` capture as the reference's
``repro.launch.obs`` reads a ``repro_torch`` one, with the same output.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.obs import (prometheus_text, read_events, read_snapshot,
                             timeline)
from repro_torch.obs.history import read_history
from repro_torch.obs.html import render_html
from repro_torch.obs.report import check_slos, op_rows, render_span_tree, \
    render_table

DEFAULT_HISTORY = (Path(__file__).resolve().parents[3]
                   / "results" / "bench" / "history.jsonl")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render an obs --metrics-dir capture into an SLO table")
    ap.add_argument("metrics_dir", type=Path)
    ap.add_argument("--slo", action="append", default=[],
                    help="threshold check '<op-glob>:<field><=|>=value', "
                         "e.g. 'analytics.*:p99_ms<=50' or "
                         "'index.count:qps>=100'; repeatable, any "
                         "violation exits nonzero")
    ap.add_argument("--tree", action="store_true",
                    help="also render the span tree from events.jsonl "
                         "(chaos runs: injection→detection→repair)")
    ap.add_argument("--counters", action="store_true",
                    help="also dump path-selection counters and gauges")
    ap.add_argument("--prometheus", action="store_true",
                    help="print the snapshot in Prometheus text format "
                         "and exit")
    ap.add_argument("--html", type=Path, default=None, metavar="OUT",
                    help="write the static HTML dashboard to OUT and exit")
    ap.add_argument("--history", type=Path, default=DEFAULT_HISTORY,
                    help="bench history JSONL for the dashboard's "
                         f"trajectory section (default {DEFAULT_HISTORY})")
    ap.add_argument("--stages", action="store_true",
                    help="print the stage split of the --profile-dir "
                         "traces (*trace.json) in the directory and exit")
    args = ap.parse_args(argv)

    if args.stages:
        traces = sorted(args.metrics_dir.glob("*trace.json"))
        if not traces:
            print(f"no {args.metrics_dir}/*trace.json — run a CLI with "
                  f"--profile-dir first", file=sys.stderr)
            return 2
        for path in traces:
            print(f"{path.name}:")
            print(timeline.render(*timeline.split(timeline.load(path))))
        return 0

    try:
        snap = read_snapshot(args.metrics_dir)
    except FileNotFoundError:
        print(f"no {args.metrics_dir}/snapshot.json — run a CLI with "
              f"--metrics-dir first", file=sys.stderr)
        return 2

    if args.prometheus:
        print(prometheus_text(snap), end="")
        return 0

    if args.html is not None:
        page = render_html(snap=snap,
                           events=read_events(args.metrics_dir),
                           history=read_history(args.history),
                           slo_specs=args.slo or None)
        args.html.parent.mkdir(parents=True, exist_ok=True)
        args.html.write_text(page)
        print(f"wrote {args.html}")
        return 0

    rows = op_rows(snap)
    slo_results = check_slos(rows, args.slo) if args.slo else []
    if rows:
        print(render_table(rows, slo_results))
    else:
        print("no serve.* op metrics in snapshot")

    violations = [r for r in slo_results if not r.ok]
    if slo_results:
        print()
        for res in slo_results:
            mark = "ok " if res.ok else "FAIL"
            target = res.op or "(no match)"
            print(f"  [{mark}] {res.spec} @ {target}: {res.detail}")

    if args.counters:
        print("\ncounters:")
        for k, v in snap.get("counters", {}).items():
            print(f"  {k} = {v}")
        gauges = snap.get("gauges", {})
        if gauges:
            print("gauges:")
            for k, v in gauges.items():
                print(f"  {k} = {v}")

    if args.tree:
        events = read_events(args.metrics_dir)
        tree = render_span_tree(events)
        print("\nspan tree:")
        print(tree if tree else "  (no span events)")

    if violations:
        print(f"\n{len(violations)} SLO violation(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
