"""Perf regression sentry CLI: render the per-commit bench trajectory and
gate on confirmed regressions.

PYTHONPATH=src python -m repro_torch.launch.regress                 # everything
PYTHONPATH=src python -m repro_torch.launch.regress --fast          # CI records
PYTHONPATH=src python -m repro_torch.launch.regress --suite construction -v
PYTHONPATH=src python -m repro_torch.launch.regress --fail-on none  # report only

Reads ``results/bench/history.jsonl`` (appended to by every
``benchmarks.run`` invocation via ``benchmarks/common.save``; the file is
the same for either package, and this CLI gives the reference's
``repro.launch.regress`` report and exit codes), groups it
into (suite, row, fast, backend) series, and prints one verdict row per
series from ``repro_torch.obs.history.detect_regression``: median-of-last-K
baseline, MAD-scaled threshold (floored at ``--rel-floor`` relative), so
a single noisy run can't gate while a genuine step regression (e.g. a 2×
slowdown) trips immediately. ``drift`` (slow creep across many commits)
and ``improvement`` are reported but only ``--fail-on`` verdicts flip the
exit code — the default gates on confirmed step regressions only, which
is what ``scripts/ci.sh`` runs (the reference's CLI) as the soft perf
gate.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.obs.history import read_history, regress_report

#: repo-root results/bench/history.jsonl (this file lives at
#: src/repro_torch/launch/regress.py).
DEFAULT_HISTORY = (Path(__file__).resolve().parents[3]
                   / "results" / "bench" / "history.jsonl")

_MARK = {"regression": "REGRESS", "drift": "drift", "improvement": "better",
         "ok": "ok", "new": "new"}


def render_regress_table(rows: list, verbose: bool = False) -> str:
    header = ["suite", "row", "mode", "runs", "baseline_us", "latest_us",
              "delta%", "verdict"]
    table = [header]
    for r in rows:
        table.append([
            r["suite"], r["row"], "fast" if r["fast"] else "full",
            str(r["runs"]),
            "-" if r["baseline"] is None else f"{r['baseline']:.1f}",
            f"{r['latest']:.1f}",
            "-" if r["delta_pct"] is None else f"{r['delta_pct']:+.1f}",
            _MARK.get(r["verdict"], r["verdict"])])
    widths = [max(len(row[i]) for row in table) for i in range(len(header))]
    lines = []
    for j, row in enumerate(table):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    if verbose:
        for r in rows:
            if r["detail"]:
                lines.append(f"  {r['suite']}/{r['row']}: {r['detail']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="noise-aware perf regression gate over the per-commit "
                    "bench history")
    ap.add_argument("--history", type=Path, default=DEFAULT_HISTORY,
                    help=f"history JSONL (default {DEFAULT_HISTORY})")
    ap.add_argument("--suite", default=None,
                    help="restrict to one bench suite")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--fast", action="store_true",
                      help="only CI-sized (--fast) records")
    mode.add_argument("--full", action="store_true",
                      help="only full-size records")
    ap.add_argument("--last-k", type=int, default=5,
                    help="baseline window: median of the last K prior runs")
    ap.add_argument("--mad-scale", type=float, default=4.0,
                    help="threshold in robust stddevs (1.4826·MAD) above "
                         "the baseline median")
    ap.add_argument("--rel-floor", type=float, default=0.25,
                    help="minimum relative slack — a quiet series still "
                         "needs at least this fractional jump to gate")
    ap.add_argument("--min-history", type=int, default=3,
                    help="baseline runs required before gating (fewer → "
                         "'new', never gates)")
    ap.add_argument("--cross-host", action="store_true",
                    help="compare against baselines from other hosts too "
                         "(default: same-host only, so a slower CI box "
                         "doesn't read as a regression)")
    ap.add_argument("--fail-on", choices=["regression", "drift", "none"],
                    default="regression",
                    help="which verdicts flip the exit code: 'regression' "
                         "(default — confirmed steps only), 'drift' (also "
                         "gradual creep), 'none' (report only)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print per-row verdict details")
    args = ap.parse_args(argv)

    records = read_history(args.history)
    if not records:
        print(f"no bench history at {args.history} — run "
              f"`python -m benchmarks.run` (or --fast) to start the "
              f"trajectory", file=sys.stderr)
        return 2

    fast = True if args.fast else (False if args.full else None)
    rows = regress_report(records, last_k=args.last_k,
                          mad_scale=args.mad_scale,
                          rel_floor=args.rel_floor,
                          min_history=args.min_history,
                          same_host=not args.cross_host,
                          fast=fast, suite=args.suite)
    if not rows:
        print("no matching series in history", file=sys.stderr)
        return 2

    print(render_regress_table(rows, verbose=args.verbose))
    counts: dict[str, int] = {}
    for r in rows:
        counts[r["verdict"]] = counts.get(r["verdict"], 0) + 1
    summary = ", ".join(f"{v} {k}" for k, v in sorted(counts.items()))
    print(f"\n{len(rows)} series: {summary}")

    gate = {"regression"}
    if args.fail_on == "drift":
        gate.add("drift")
    elif args.fail_on == "none":
        gate = set()
    bad = [r for r in rows if r["verdict"] in gate]
    if bad:
        for r in bad:
            print(f"CONFIRMED {r['verdict'].upper()}: {r['suite']}/"
                  f"{r['row']} latest {r['latest']:.1f}us vs baseline "
                  f"{r['baseline']:.1f}us ({r['delta_pct']:+.1f}%) — "
                  f"{r['detail']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
