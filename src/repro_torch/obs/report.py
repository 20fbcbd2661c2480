"""Snapshot → human-readable reports: per-op SLO table, span tree.

The SLO table collects every ``serve.<layer>.<op>.latency_s`` histogram
in a snapshot together with its sibling gauges/counters (qps, batch,
compile_s, calls) and renders one row per op. Threshold checks are
``"<op-glob>:<field><op><value>"`` specs, e.g.::

    analytics.*:p99_ms<=50      index.count:qps>=100

evaluated against every matching row; a spec matching no rows is itself a
violation (an SLO on an op that never ran is not "met").

The span tree stitches ``events.jsonl`` span records back into their
nesting (span_id/parent_id) — a chaos run renders injection → detection →
repair as one correlated tree.
"""
from __future__ import annotations

import fnmatch
import re
from dataclasses import dataclass
from typing import List, Optional

_SLO_RE = re.compile(r"^(?P<pat>[^:]+):(?P<field>[a-z0-9_]+)"
                     r"(?P<op><=|>=|<|>)(?P<value>[0-9.eE+-]+)$")


@dataclass
class OpRow:
    op: str
    calls: int
    batch: Optional[float]
    qps: Optional[float]
    compile_s: Optional[float]
    p50_ms: Optional[float]
    p95_ms: Optional[float]
    p99_ms: Optional[float]
    max_ms: Optional[float]

    def field(self, name: str) -> Optional[float]:
        return getattr(self, name, None)


def op_rows(snap: dict) -> List[OpRow]:
    """One row per ``serve.<layer>.<op>`` metric family in the snapshot."""
    hists = snap.get("histograms", {})
    gauges = snap.get("gauges", {})
    counters = snap.get("counters", {})
    rows = []
    for key, h in sorted(hists.items()):
        if not (key.startswith("serve.") and key.endswith(".latency_s")):
            continue
        prefix = key[: -len(".latency_s")]
        op = prefix[len("serve."):]

        def ms(v):
            return None if v is None else v * 1e3

        rows.append(OpRow(
            op=op,
            calls=counters.get(prefix + ".calls", h.get("count", 0)),
            batch=gauges.get(prefix + ".batch"),
            qps=gauges.get(prefix + ".qps"),
            compile_s=gauges.get(prefix + ".compile_s"),
            p50_ms=ms(h.get("p50")), p95_ms=ms(h.get("p95")),
            p99_ms=ms(h.get("p99")), max_ms=ms(h.get("max"))))
    return rows


@dataclass
class SloResult:
    spec: str
    op: str          # matched op ("" when the spec matched nothing)
    ok: bool
    detail: str


def parse_slo(spec: str):
    m = _SLO_RE.match(spec.strip())
    if not m:
        raise ValueError(
            f"bad SLO spec {spec!r} (want '<op-glob>:<field><=|>=|<|>"
            f"<value>', e.g. 'analytics.*:p99_ms<=50')")
    return (m["pat"], m["field"], m["op"], float(m["value"]))


def check_slos(rows: List[OpRow], specs: List[str]) -> List[SloResult]:
    ops = {"<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b,
           "<": lambda a, b: a < b, ">": lambda a, b: a > b}
    out = []
    for spec in specs:
        pat, field, op, value = parse_slo(spec)
        matched = [r for r in rows if fnmatch.fnmatch(r.op, pat)]
        if not matched:
            out.append(SloResult(spec, "", False, "no op matched"))
            continue
        for r in matched:
            got = r.field(field)
            if got is None:
                out.append(SloResult(spec, r.op, False,
                                     f"{field} not recorded"))
            else:
                out.append(SloResult(
                    spec, r.op, ops[op](got, value),
                    f"{field}={got:.4g} vs {op}{value:g}"))
    return out


def _fmt(v, nd=2, dash="-"):
    if v is None:
        return dash
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def render_table(rows: List[OpRow], slo_results=None) -> str:
    """Fixed-width per-op SLO table (the ``repro_torch.launch.obs`` output)."""
    slo_by_op: dict[str, bool] = {}
    for res in slo_results or []:
        if res.op:
            slo_by_op[res.op] = slo_by_op.get(res.op, True) and res.ok
    header = ["op", "calls", "batch", "p50_ms", "p95_ms", "p99_ms",
              "max_ms", "q/s", "compile_s"]
    if slo_by_op:
        header.append("slo")
    table = [header]
    for r in rows:
        line = [r.op, str(r.calls), _fmt(r.batch, 0), _fmt(r.p50_ms, 3),
                _fmt(r.p95_ms, 3), _fmt(r.p99_ms, 3), _fmt(r.max_ms, 3),
                _fmt(r.qps, 0), _fmt(r.compile_s, 2)]
        if slo_by_op:
            line.append({True: "ok", False: "VIOLATED"}.get(
                slo_by_op.get(r.op), "-"))
        table.append(line)
    widths = [max(len(row[i]) for row in table)
              for i in range(len(header))]
    lines = []
    for j, row in enumerate(table):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def render_span_tree(events: List[dict]) -> str:
    """Indented span tree from ``events.jsonl`` records, in start order.

    Non-span events (faults, …) attach under the span that was open when
    they were emitted (their ``span_id`` names it), so a chaos scenario
    shows injection → detection → repair as one correlated subtree.
    """
    spans = [e for e in events if e.get("kind") == "span"]
    others = [e for e in events if e.get("kind") != "span"]
    children: dict[Optional[str], list] = {}
    for e in spans:
        children.setdefault(e.get("parent_id"), []).append(e)
    attached: dict[Optional[str], list] = {}
    for e in others:
        attached.setdefault(e.get("span_id"), []).append(e)
    for v in children.values():
        v.sort(key=lambda e: e.get("ts", 0))

    lines: List[str] = []

    def fmt_attrs(e):
        a = e.get("attrs")
        return " " + ", ".join(f"{k}={v}" for k, v in a.items()) if a else ""

    def walk(parent_id, depth):
        for e in children.get(parent_id, []):
            dur = e.get("dur_s")
            lines.append("  " * depth + f"{e['name']} "
                         f"[{dur * 1e3:.1f} ms]{fmt_attrs(e)}"
                         if dur is not None else
                         "  " * depth + e["name"] + fmt_attrs(e))
            for o in sorted(attached.get(e.get("span_id"), []),
                            key=lambda x: x.get("ts", 0)):
                lines.append("  " * (depth + 1)
                             + f"* {o.get('kind')}:{o.get('name')}"
                             + fmt_attrs(o))
            walk(e.get("span_id"), depth + 1)

    walk(None, 0)
    for o in sorted(attached.get(None, []), key=lambda x: x.get("ts", 0)):
        lines.append(f"* {o.get('kind')}:{o.get('name')}{fmt_attrs(o)}")
    return "\n".join(lines)
