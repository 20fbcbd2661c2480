"""Readings of a ``torch.profiler`` chrome trace: the device's operations,
the benchmark's own spans, the busy share (a frozen copy of
``chip_smoke.py``'s ``device_busy`` arithmetic: the union of the kernel,
copy and set intervals over the wall time), and the breakdown of where
the device's time and its idle gaps went.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

from . import work

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the benchmark's own spans around its calls into the program
SPANS = ("build", "batch", "readback")
NAME_CHARS = 160         # a breakdown's names, cut (torch's are templates)


@dataclass
class Trace:
    """The device operations ((start, end, name) in microseconds, sorted)
    and the host's operations and spans of one traced stretch."""
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)      # (start, end, name)
    spans: list = field(default_factory=list)     # (start, end, name)


def parse(events: list) -> Trace:
    """A :class:`Trace` of a chrome trace's ``traceEvents``."""
    out = Trace()
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            out.device.append((a, b, e.get("name", cat)))
        elif cat == "user_annotation":
            if e.get("name") in SPANS:
                out.spans.append((a, b, e["name"]))
        elif cat == "cpu_op":
            out.host.append((a, b, e.get("name", "")))
    out.device.sort()
    out.host.sort()
    out.spans.sort()
    return out


def load(path: Path) -> Trace:
    return parse(json.loads(Path(path).read_text())["traceEvents"])


def busy_us(device: list, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi) in which some device operation ran: the
    union of the sorted intervals, clipped to the window."""
    total, end = 0.0, lo
    for a, b, _ in device:
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def window(t: Trace) -> tuple[float, float]:
    """The traced stretch: from the first span's start to the last span's
    end."""
    if not t.spans:
        raise ValueError("the trace holds none of the benchmark's spans")
    return t.spans[0][0], max(b for _, b, _ in t.spans)


def kernel_us(t: Trace) -> dict[str, float]:
    """Device microseconds of each hand-written kernel in the stretch."""
    out: dict[str, float] = {}
    for a, b, name in t.device:
        k = work.kernel_of(name)
        if k is not None:
            out[k] = out.get(k, 0.0) + (b - a)
    return out


def launches(t: Trace, name: str) -> int:
    """Device operations of one hand-written kernel in the stretch."""
    return sum(1 for _, _, n in t.device if work.kernel_of(n) == name)


def glue_us(t: Trace) -> float:
    """Device microseconds outside the hand-written kernels: torch's own
    kernels, copies and sets."""
    return sum(b - a for a, b, name in t.device
               if work.kernel_of(name) is None)


def _innermost(intervals: list, points: list) -> list:
    """For each of the sorted ``points``, the name of the shortest of the
    start-sorted ``intervals`` that holds it (None where none does): one
    sweep, keeping only the intervals still open."""
    out, active, i = [], [], 0
    for x in points:
        while i < len(intervals) and intervals[i][0] <= x:
            active.append(intervals[i])
            i += 1
        active = [iv for iv in active if iv[1] >= x]
        best = min(active, key=lambda iv: iv[1] - iv[0], default=None)
        out.append(None if best is None else best[2])
    return out


def idle_gaps(t: Trace, lo: float, hi: float) -> list:
    """(start, end) of each stretch of [lo, hi) in which no device
    operation ran."""
    gaps, end = [], lo
    for a, b, _ in t.device:
        if a >= hi:
            break
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if end < hi:
        gaps.append((end, hi))
    return gaps


def breakdown(t: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps by
    what the host was doing (the benchmark's span and the host operation
    running at the gap's middle), each as [name, seconds], at most ``top``
    each."""
    ops: dict[str, float] = {}
    for a, b, name in t.device:
        name = name[:NAME_CHARS]
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
    lo, hi = window(t)
    gaps: dict[str, float] = {}
    idle = idle_gaps(t, lo, hi)
    mids = [(a + b) / 2 for a, b in idle]
    for (a, b), span, op in zip(idle, _innermost(t.spans, mids),
                                _innermost(t.host, mids)):
        label = span or "between spans"
        if op is not None:
            label = f"{label}: {op}"
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6

    def most(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": most(ops), "idle_gaps": most(gaps)}


def roofline_pct(bound_ms: dict, t: Trace, kernels) -> float | None:
    """100 x the bound of ``kernels``' work over their device time in the
    stretch, over the kernels that ran there and whose work is counted;
    None where none did."""
    took = kernel_us(t)
    ran = [k for k in kernels if took.get(k, 0.0) > 0 and k in bound_ms]
    if not ran:
        return None
    return 100.0 * sum(bound_ms[k] for k in ran) * 1e3 / sum(
        took[k] for k in ran)


def idle_pct(t: Trace) -> float:
    """100 - the device's busy share of the stretch."""
    lo, hi = window(t)
    return 100.0 * (1.0 - busy_us(t.device, lo, hi) / (hi - lo))
