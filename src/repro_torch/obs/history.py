"""Append-only per-commit bench history + noise-aware regression detection.

``results/bench/*.json`` artifacts are single snapshots — the latest run
overwrites the previous one, so the cross-commit *trajectory* (the thing
a perf PR must not regress) was invisible. This module keeps it:
``benchmarks/common.save`` appends one JSONL record per (suite, row) to
``results/bench/history.jsonl`` on every run, stamped with the run's
provenance (git commit, dirty flag, backend, host, fast/full, seed).

Detection is deliberately noise-aware so a single noisy run can't gate:

* the **baseline** is the median of the last ``last_k`` prior runs of the
  same (suite, row, fast, backend) series (same host by default — CI
  containers of different speeds must not gate against each other);
* the **threshold** is ``mad_scale`` robust standard deviations
  (1.4826·MAD of the baseline window) above the baseline median, floored
  at ``rel_floor`` relative — a flat-but-noisy series grows its own
  tolerance, a quiet series still needs a real (≥ rel_floor) jump;
* a latest run above the threshold is a confirmed **regression** (the
  hard gate), below the mirrored threshold an **improvement**;
* a series whose recent median crept ``rel_floor`` above its oldest
  window without ever tripping the step test is flagged **drift**
  (reported, not gated — each individual step was within noise).

``repro_torch.launch.regress`` renders the verdict table and exits nonzero on
confirmed regressions; ``scripts/ci.sh`` runs it as the perf gate.

Records are plain JSON lines; a torn trailing line (crashed writer) is
skipped on read exactly like ``obs.read_events``.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path
from statistics import median
from typing import Dict, List, Optional, Tuple

HISTORY_FILE = "history.jsonl"

#: fields copied from a suite's run meta into every history record.
_META_FIELDS = ("seed",)


def history_records(suite: str, rows: List[dict], meta: dict) -> List[dict]:
    """One history record per bench row: provenance + the row's headline
    ``us_per_call`` + every other numeric derived field under ``metrics``."""
    base = {
        "suite": suite,
        "commit": meta.get("git_commit", "unknown"),
        "dirty": bool(meta.get("git_dirty", False)),
        "backend": meta.get("backend", "unknown"),
        "host": meta.get("host", "unknown"),
        "fast": bool(meta.get("fast", False)),
        "ts": meta.get("timestamp"),
    }
    for f in _META_FIELDS:
        if meta.get(f) is not None:
            base[f] = meta[f]
    out = []
    for row in rows:
        rec = dict(base)
        rec["row"] = str(row.get("name", "unnamed"))
        us = row.get("us_per_call")
        if us is not None:
            rec["us_per_call"] = float(us)
        metrics = {k: (float(v) if not isinstance(v, bool) else v)
                   for k, v in row.items()
                   if k not in ("name", "us_per_call")
                   and isinstance(v, (int, float, bool))}
        if metrics:
            rec["metrics"] = metrics
        out.append(rec)
    return out


def append_history(path, suite: str, rows: List[dict],
                   meta: dict) -> List[dict]:
    """Append one record per row to the JSONL history at ``path``."""
    recs = history_records(suite, rows, meta)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("a", encoding="utf-8") as fh:
        for rec in recs:
            fh.write(json.dumps(rec, default=float) + "\n")
        fh.flush()
    return recs


def read_history(path) -> List[dict]:
    """Parse the JSONL history, skipping blank and torn lines (a crashed
    writer must not poison the whole trajectory)."""
    p = Path(path)
    if not p.exists():
        return []
    out = []
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


#: series identity: same suite+row, fast and full runs never compared,
#: nor runs from different backends.
Key = Tuple[str, str, bool, str]


def group_key(rec: dict) -> Key:
    return (str(rec.get("suite", "?")), str(rec.get("row", "?")),
            bool(rec.get("fast", False)), str(rec.get("backend", "?")))


def group_history(records: List[dict]) -> Dict[Key, List[dict]]:
    """Records grouped per series, preserving append (= time) order."""
    groups: Dict[Key, List[dict]] = {}
    for rec in records:
        groups.setdefault(group_key(rec), []).append(rec)
    return groups


@dataclass
class Verdict:
    verdict: str                    # new | ok | drift | regression | improvement
    latest: float
    baseline: Optional[float]       # median of the baseline window
    threshold: Optional[float]      # regression trip point
    delta_pct: Optional[float]      # latest vs baseline median
    n_baseline: int
    detail: str = ""


def detect_regression(values: List[float], last_k: int = 5,
                      mad_scale: float = 4.0, rel_floor: float = 0.25,
                      min_history: int = 3) -> Verdict:
    """Gate verdict for the latest value of one series (see module doc).

    ``values`` is the full series in time order (latest last, in the
    metric's "lower is better" orientation — us_per_call).
    """
    latest = float(values[-1])
    base = [float(v) for v in values[:-1][-last_k:]]
    n = len(base)
    if n < min_history:
        med = median(base) if base else None
        return Verdict("new", latest, med, None, None, n,
                       f"only {n} baseline run(s), need {min_history}")
    med = median(base)
    mad = median(abs(b - med) for b in base)
    sigma = 1.4826 * mad                       # MAD → robust stddev
    slack = max(mad_scale * sigma, rel_floor * med)
    threshold = med + slack
    delta_pct = 100.0 * (latest - med) / med if med else None
    if latest > threshold:
        return Verdict("regression", latest, med, threshold, delta_pct, n,
                       f"latest {latest:.4g} > {threshold:.4g} "
                       f"(median {med:.4g} + max({mad_scale}·1.4826·MAD, "
                       f"{rel_floor:.0%}))")
    if latest < med - slack:
        return Verdict("improvement", latest, med, threshold, delta_pct, n,
                       f"latest {latest:.4g} < {med - slack:.4g}")
    # gradual drift: no single step tripped, but the recent median crept
    # above the oldest window by the relative floor
    if len(values) >= 2 * last_k:
        old_med = median(float(v) for v in values[:last_k])
        recent_med = median(float(v) for v in values[-last_k:])
        if old_med > 0 and recent_med > old_med * (1.0 + rel_floor):
            return Verdict(
                "drift", latest, med, threshold, delta_pct, n,
                f"recent median {recent_med:.4g} vs oldest window "
                f"{old_med:.4g} (+{100 * (recent_med / old_med - 1):.0f}%)")
    return Verdict("ok", latest, med, threshold, delta_pct, n, "")


def regress_report(records: List[dict], last_k: int = 5,
                   mad_scale: float = 4.0, rel_floor: float = 0.25,
                   min_history: int = 3, same_host: bool = True,
                   fast: Optional[bool] = None,
                   suite: Optional[str] = None) -> List[dict]:
    """Per-series verdict rows over a parsed history.

    ``fast=True/False`` restricts to fast/full records (None = both);
    ``suite`` filters by suite name; ``same_host`` (default) compares the
    latest run only against baseline records from the same host, so a
    trajectory seeded on a different machine reads as "new" instead of a
    phantom regression.
    """
    rows = []
    for key, recs in group_history(records).items():
        ksuite, krow, kfast, kbackend = key
        if fast is not None and kfast is not fast:
            continue
        if suite is not None and ksuite != suite:
            continue
        latest = recs[-1]
        if same_host:
            recs = [r for r in recs
                    if r.get("host") == latest.get("host")]
        vals = [r["us_per_call"] for r in recs
                if isinstance(r.get("us_per_call"), (int, float))]
        if not vals:
            continue
        vd = detect_regression(vals, last_k=last_k, mad_scale=mad_scale,
                               rel_floor=rel_floor,
                               min_history=min_history)
        rows.append({"suite": ksuite, "row": krow, "fast": kfast,
                     "backend": kbackend, "runs": len(vals),
                     "commit": latest.get("commit", "unknown"),
                     **asdict(vd)})
    rows.sort(key=lambda r: (r["suite"], r["row"], r["fast"]))
    return rows
