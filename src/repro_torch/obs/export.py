"""Exporters: JSONL event log + point-in-time snapshot (+ Prometheus text).

``configure(metrics_dir)`` attaches a file exporter: structured events
(spans, fault injections, path decisions worth correlating) append to
``<dir>/events.jsonl`` as they happen, and ``write_snapshot()`` renders
the registry into ``<dir>/snapshot.json``. A snapshot is also written
automatically at interpreter exit so a crashed-late CLI still leaves its
metrics behind. The CLIs expose this as ``--metrics-dir``;
``repro_torch.launch.obs`` (or the reference's ``repro.launch.obs``: the
files are the same) renders the artifacts back into an SLO table.

Event schema (one JSON object per line, all lines share this shape)::

    {"ts": <unix float>, "kind": "span"|"fault"|"event", "name": <str>,
     ...kind-specific fields: dur_s, path, span_id, parent_id, attrs}

Snapshot schema::

    {"meta": {timestamp, pid, torch_version, backend ("cuda"|"cpu"),
              device_count, device_name (on a card)},
     "counters":   {key: int},
     "gauges":     {key: float},
     "histograms": {key: {count, sum, mean, min, max, p50, p95, p99, exact}}}

Everything no-ops (cheaply) until ``configure`` is called, and while
metrics are disabled.
"""
from __future__ import annotations

import atexit
import json
import os
import re
import threading
import time
from pathlib import Path
from typing import Optional

from .metrics import REGISTRY, _state

_lock = threading.Lock()
_dir: Optional[Path] = None
_events_fh = None
_atexit_registered = False

EVENTS_FILE = "events.jsonl"
SNAPSHOT_FILE = "snapshot.json"


def metrics_dir() -> Optional[Path]:
    return _dir


def configure(directory: str | Path | None) -> Optional[Path]:
    """Point the file exporter at ``directory`` (created if needed).

    ``None`` detaches the exporter (closing the event log). Re-configuring
    to a new directory rolls the event stream over.
    """
    global _dir, _events_fh, _atexit_registered
    with _lock:
        if _events_fh is not None:
            _events_fh.close()
            _events_fh = None
        if directory is None:
            _dir = None
            return None
        _dir = Path(directory)
        _dir.mkdir(parents=True, exist_ok=True)
        _events_fh = (_dir / EVENTS_FILE).open("a", encoding="utf-8")
        if not _atexit_registered:
            atexit.register(_atexit_snapshot)
            _atexit_registered = True
        return _dir


def _atexit_snapshot() -> None:
    try:
        if _dir is not None:
            write_snapshot()
    except Exception:                                         # noqa: BLE001
        pass


def emit_event(kind: str, name: str, ts: float | None = None,
               **fields) -> None:
    """Append one structured event line (no-op unless configured+enabled)."""
    if not _state.enabled or _events_fh is None:
        return
    rec = {"ts": time.time() if ts is None else ts, "kind": kind,
           "name": name}
    for k, v in fields.items():
        if v is not None:
            rec[k] = v
    line = json.dumps(rec, default=str)
    with _lock:
        if _events_fh is None:
            return
        _events_fh.write(line + "\n")
        _events_fh.flush()


def snapshot_dict() -> dict:
    """Registry snapshot + provenance meta (a plain-JSON dict)."""
    try:
        import torch
        cuda = torch.cuda.is_available()
        runtime = {"torch_version": torch.__version__,
                   "backend": "cuda" if cuda else "cpu",
                   "device_count": torch.cuda.device_count() if cuda else 1}
        if cuda:
            runtime["device_name"] = torch.cuda.get_device_name(0)
    except Exception:                                         # noqa: BLE001
        runtime = {}
    snap = REGISTRY.snapshot()
    snap["meta"] = {"timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
                    "pid": os.getpid(), **runtime}
    return snap


def write_snapshot(directory: str | Path | None = None) -> Optional[Path]:
    """Render the registry into ``snapshot.json`` (atomic replace)."""
    d = Path(directory) if directory is not None else _dir
    if d is None:
        return None
    d.mkdir(parents=True, exist_ok=True)
    path = d / SNAPSHOT_FILE
    tmp = d / (SNAPSHOT_FILE + ".tmp")
    tmp.write_text(json.dumps(snapshot_dict(), indent=1, default=float))
    os.replace(tmp, path)
    return path


def read_snapshot(directory: str | Path) -> dict:
    return json.loads((Path(directory) / SNAPSHOT_FILE).read_text())


def read_events(directory: str | Path) -> list[dict]:
    """Parse ``events.jsonl`` (skipping any torn trailing line)."""
    path = Path(directory) / EVENTS_FILE
    if not path.exists():
        return []
    out = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return out


#: Prometheus metric names are [a-zA-Z_:][a-zA-Z0-9_:]*; label names drop
#: the colon. Anything else maps to "_".
_PROM_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    name = _PROM_NAME_BAD.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _prom_label_value(v: str) -> str:
    # exposition-format escaping: backslash, double quote, newline
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def prometheus_text(snap: dict | None = None) -> str:
    """Render a snapshot in Prometheus exposition format (counters and
    gauges as-is; histograms as _count/_sum + quantile gauges)."""
    from .metrics import parse_key
    snap = snap if snap is not None else snapshot_dict()

    def fmt(key: str, suffix: str = "") -> str:
        name, labels = parse_key(key)
        name = _prom_name(name + suffix)
        if labels:
            inner = ",".join(
                f'{_PROM_LABEL_BAD.sub("_", k)}="{_prom_label_value(v)}"'
                for k, v in sorted(labels.items()))
            return f"{name}{{{inner}}}"
        return name

    lines = []
    for k, v in snap.get("counters", {}).items():
        lines.append(f"{fmt(k, '_total')} {v}")
    for k, v in snap.get("gauges", {}).items():
        lines.append(f"{fmt(k)} {v}")
    for k, h in snap.get("histograms", {}).items():
        lines.append(f"{fmt(k, '_count')} {h['count']}")
        lines.append(f"{fmt(k, '_sum')} {h['sum']}")
        for q in ("p50", "p95", "p99"):
            if h.get(q) is not None:
                lines.append(f"{fmt(k, '_' + q)} {h[q]}")
    return "\n".join(lines) + "\n"
