"""Static HTML dashboard: the metrics/events/history artifacts rendered as
one self-contained page (``python -m repro_torch.launch.obs <dir> --html``).

Zero dependencies — plain string templating plus inline SVG sparklines.
Sections (each skipped when its input is absent):

* **Bench trajectories** — one sparkline per (suite, row, fast, backend)
  series from ``results/bench/history.jsonl``, annotated with the
  regression verdict from :mod:`repro_torch.obs.history` (confirmed regressions
  show red, improvements green).
* **Serving SLO table** — the ``serve.*`` per-op latency table from
  :func:`repro_torch.obs.report.op_rows`, with pass/fail when SLO specs given.
* **Roofline profile** — the ``prof.*{op=...}`` gauge family pivoted into
  one row per op: FLOPs, bytes, arithmetic intensity, achieved rates,
  roofline utilization, peak working set.
* **Counters / gauges** — the rest of the registry, verbatim.
* **Span waterfall** — ``events.jsonl`` spans as nested bars scaled to
  wall time, non-span events as ticks on their enclosing span.
"""
from __future__ import annotations

import html as _html
import json
from typing import Dict, List, Optional

from .metrics import parse_key
from .report import OpRow, check_slos, op_rows

_CSS = """
body { font-family: system-ui, sans-serif; margin: 1.5rem; color: #222; }
h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 1.6rem;
     border-bottom: 1px solid #ddd; padding-bottom: .2rem; }
table { border-collapse: collapse; font-size: .82rem; margin-top: .5rem; }
th, td { padding: .18rem .55rem; text-align: right;
         border-bottom: 1px solid #eee; }
th { background: #f5f5f5; } td.l, th.l { text-align: left; }
tr.bad td { background: #fdecea; } tr.good td { background: #eaf7ec; }
tr.warn td { background: #fff8e1; }
.spark { vertical-align: middle; }
.meta { color: #777; font-size: .78rem; }
.bar { fill: #4a90d9; } .bar:hover { fill: #2b6cb0; }
.tick { stroke: #d9534f; stroke-width: 2; }
.lbl { font-size: 9px; fill: #333; }
code { background: #f5f5f5; padding: 0 .2rem; }
"""


def _esc(v) -> str:
    return _html.escape(str(v), quote=True)


def _fmt(v, nd: int = 3) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v != 0 and (abs(v) >= 1e5 or abs(v) < 1e-3):
            return f"{v:.3g}"
        return f"{v:.{nd}f}"
    return str(v)


def sparkline(values: List[float], width: int = 160, height: int = 36,
              flag: str = "") -> str:
    """Inline SVG sparkline of a series (latest point emphasized; ``flag``
    'regression'/'improvement' colors it red/green)."""
    if not values:
        return ""
    vmin, vmax = min(values), max(values)
    span = (vmax - vmin) or 1.0
    pad = 3
    n = len(values)
    xs = [pad + i * (width - 2 * pad) / max(n - 1, 1) for i in range(n)]
    ys = [height - pad - (v - vmin) / span * (height - 2 * pad)
          for v in values]
    pts = " ".join(f"{x:.1f},{y:.1f}" for x, y in zip(xs, ys))
    dot = {"regression": "#d9534f", "improvement": "#2e9e44"}.get(
        flag, "#4a90d9")
    return (f'<svg class="spark" width="{width}" height="{height}">'
            f'<polyline points="{pts}" fill="none" stroke="#888" '
            f'stroke-width="1.2"/>'
            f'<circle cx="{xs[-1]:.1f}" cy="{ys[-1]:.1f}" r="3" '
            f'fill="{dot}"/></svg>')


def _table(header: List[str], rows: List[List[str]],
           left_cols: int = 1, row_classes: Optional[List[str]] = None,
           raw_cols: tuple = ()) -> str:
    """rows are already-formatted strings; cells in ``raw_cols`` are
    trusted HTML (sparklines), the rest are escaped."""
    out = ["<table><tr>"]
    for i, h in enumerate(header):
        cls = ' class="l"' if i < left_cols else ""
        out.append(f"<th{cls}>{_esc(h)}</th>")
    out.append("</tr>")
    for j, row in enumerate(rows):
        cls = row_classes[j] if row_classes else ""
        out.append(f'<tr class="{cls}">' if cls else "<tr>")
        for i, c in enumerate(row):
            td = ' class="l"' if i < left_cols else ""
            body = c if i in raw_cols else _esc(c)
            out.append(f"<td{td}>{body}</td>")
        out.append("</tr>")
    out.append("</table>")
    return "".join(out)


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------

def history_section(records: List[dict], last_k: int = 5) -> str:
    """Sparkline-per-series bench trajectory table with verdicts."""
    from .history import detect_regression, group_history
    if not records:
        return ""
    rows, classes = [], []
    for key, recs in sorted(group_history(records).items()):
        suite, row, fast, backend = key
        vals = [r["us_per_call"] for r in recs
                if isinstance(r.get("us_per_call"), (int, float))]
        if not vals:
            continue
        vd = detect_regression(vals, last_k=last_k)
        commit = str(recs[-1].get("commit", ""))[:9]
        rows.append([
            suite, row, "fast" if fast else "full", backend,
            sparkline(vals, flag=vd.verdict), str(len(vals)),
            _fmt(vd.baseline, 1), _fmt(vd.latest, 1),
            "-" if vd.delta_pct is None else f"{vd.delta_pct:+.1f}%",
            vd.verdict, commit])
        classes.append({"regression": "bad", "improvement": "good",
                        "drift": "warn"}.get(vd.verdict, ""))
    if not rows:
        return ""
    return ("<h2>Bench trajectories (us/call, per commit)</h2>"
            + _table(["suite", "row", "mode", "backend", "trend", "runs",
                      "baseline", "latest", "delta", "verdict", "commit"],
                     rows, left_cols=4, row_classes=classes,
                     raw_cols=(4,)))


def slo_section(snap: dict, slo_specs: Optional[List[str]] = None) -> str:
    rows = op_rows(snap)
    if not rows:
        return ""
    slo_by_op: Dict[str, bool] = {}
    if slo_specs:
        for res in check_slos(rows, slo_specs):
            if res.op:
                slo_by_op[res.op] = slo_by_op.get(res.op, True) and res.ok
    header = ["op", "calls", "batch", "p50_ms", "p95_ms", "p99_ms",
              "max_ms", "q/s", "compile_s"]
    if slo_by_op:
        header.append("slo")
    out_rows, classes = [], []
    for r in rows:
        line = [r.op, str(r.calls), _fmt(r.batch, 0), _fmt(r.p50_ms),
                _fmt(r.p95_ms), _fmt(r.p99_ms), _fmt(r.max_ms),
                _fmt(r.qps, 0), _fmt(r.compile_s, 2)]
        cls = ""
        if slo_by_op:
            ok = slo_by_op.get(r.op)
            line.append("-" if ok is None else ("ok" if ok else "VIOLATED"))
            cls = "" if ok is None else ("good" if ok else "bad")
        out_rows.append(line)
        classes.append(cls)
    return ("<h2>Serving SLOs</h2>"
            + _table(header, out_rows, row_classes=classes))


#: prof gauge field -> column header, in display order.
_PROF_COLS = [("steady_s", "steady_s"), ("flops", "flops"),
              ("int_ops", "int ops"),
              ("bytes_accessed", "bytes"), ("ai", "AI"),
              ("achieved_flops_s", "FLOP/s"),
              ("achieved_bytes_s", "B/s"),
              ("melem_per_s", "Melem/s"),
              ("roofline_util", "roofline"),
              ("peak_bytes", "peak_mem")]


def prof_rows(snap: dict) -> Dict[str, Dict[str, float]]:
    """Pivot the ``prof.<field>{op=...}`` gauges into op -> field -> value."""
    out: Dict[str, Dict[str, float]] = {}
    for key, v in snap.get("gauges", {}).items():
        name, labels = parse_key(key)
        if not name.startswith("prof.") or "op" not in labels:
            continue
        out.setdefault(labels["op"], {})[name[len("prof."):]] = v
    return out


def prof_section(snap: dict) -> str:
    pivot = prof_rows(snap)
    if not pivot:
        return ""
    rows = []
    for op in sorted(pivot):
        fields = pivot[op]
        rows.append([op] + [_fmt(fields.get(f)) for f, _ in _PROF_COLS])
    mem = {k: v for k, v in snap.get("gauges", {}).items()
           if k.startswith("prof.mem.")}
    memline = ""
    if mem:
        memline = ('<p class="meta">device memory: '
                   + ", ".join(f"{_esc(k[len('prof.mem.'):])}={_fmt(v, 0)}"
                               for k, v in sorted(mem.items())) + "</p>")
    return ("<h2>Roofline profile (per op)</h2>"
            + _table(["op"] + [h for _, h in _PROF_COLS], rows)
            + memline)


def registry_section(snap: dict) -> str:
    parts = []
    counters = {k: v for k, v in snap.get("counters", {}).items()}
    gauges = {k: v for k, v in snap.get("gauges", {}).items()
              if not k.startswith("prof.")}
    if counters:
        parts.append("<h2>Counters</h2>" + _table(
            ["counter", "value"],
            [[k, str(v)] for k, v in sorted(counters.items())]))
    if gauges:
        parts.append("<h2>Gauges</h2>" + _table(
            ["gauge", "value"],
            [[k, _fmt(v)] for k, v in sorted(gauges.items())]))
    return "".join(parts)


def span_section(events: List[dict], width: int = 760) -> str:
    """Span waterfall: nested bars scaled to wall time."""
    spans = [e for e in events if e.get("kind") == "span"
             and e.get("dur_s") is not None]
    if not spans:
        return ""
    others = [e for e in events if e.get("kind") != "span"]
    t_end = max(e.get("ts", 0) for e in spans)
    t_start = min(e.get("ts", 0) - e.get("dur_s", 0) for e in spans)
    total = max(t_end - t_start, 1e-9)
    children: Dict[Optional[str], list] = {}
    for e in spans:
        children.setdefault(e.get("parent_id"), []).append(e)
    for v in children.values():
        v.sort(key=lambda e: e.get("ts", 0))
    attached: Dict[Optional[str], list] = {}
    for e in others:
        attached.setdefault(e.get("span_id"), []).append(e)

    row_h, rows = 16, []

    def walk(parent_id, depth):
        for e in children.get(parent_id, []):
            dur = e.get("dur_s", 0.0)
            x0 = (e.get("ts", 0) - dur - t_start) / total * width
            w = max(dur / total * width, 1.5)
            y = len(rows) * row_h
            ticks = []
            for o in attached.get(e.get("span_id"), []):
                tx = (o.get("ts", 0) - t_start) / total * width
                ticks.append(
                    f'<line class="tick" x1="{tx:.1f}" y1="{y + 2}" '
                    f'x2="{tx:.1f}" y2="{y + row_h - 4}">'
                    f'<title>{_esc(o.get("kind"))}:{_esc(o.get("name"))}'
                    f'</title></line>')
            label = f"{e['name']} [{dur * 1e3:.1f} ms]"
            rows.append(
                f'<rect class="bar" x="{x0:.1f}" y="{y + 2}" '
                f'width="{w:.1f}" height="{row_h - 5}">'
                f'<title>{_esc(label)}</title></rect>'
                f'<text class="lbl" x="{x0 + w + 4:.1f}" '
                f'y="{y + row_h - 6}">{_esc(label)}</text>'
                + "".join(ticks))
            walk(e.get("span_id"), depth + 1)

    walk(None, 0)
    h = len(rows) * row_h + 4
    return ("<h2>Span waterfall</h2>"
            f'<svg width="{width + 240}" height="{h}">'
            + "".join(rows) + "</svg>")


def render_html(snap: Optional[dict] = None,
                events: Optional[List[dict]] = None,
                history: Optional[List[dict]] = None,
                slo_specs: Optional[List[str]] = None,
                title: str = "repro observability") -> str:
    """Assemble the full dashboard page from whatever artifacts exist."""
    meta = (snap or {}).get("meta", {})
    body = [f"<h1>{_esc(title)}</h1>"]
    if meta:
        body.append('<p class="meta">'
                    + _esc(json.dumps(meta, default=str)) + "</p>")
    if history:
        body.append(history_section(history))
    if snap:
        body.append(slo_section(snap, slo_specs))
        body.append(prof_section(snap))
    if events:
        body.append(span_section(events))
    if snap:
        body.append(registry_section(snap))
    return ("<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{_esc(title)}</title><style>{_CSS}</style></head>"
            "<body>" + "".join(body) + "</body></html>")
