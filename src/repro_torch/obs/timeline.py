"""The program's stages on a ``torch.profiler`` chrome trace: where each
stage's host time, device time, launches and host syncs went.

``obs.span`` and ``obs.stage`` enter a ``record_function`` range while a
profiler records, so a trace written by ``--profile-dir`` (``obs.trace``)
holds them as ``user_annotation`` events on the host's clock, beside the
CUDA runtime calls and the device operations they launched. This module
reads such a trace back:

* a **range** is a ``user_annotation`` event (torch's own ``ProfilerStep#``
  ranges left out); ranges nest by their host intervals within their host
  thread (the event's ``pid`` and ``tid``), and a range's path joins the
  names of the ranges that hold it with ``/``;
* a **device operation** (a kernel, copy or set) belongs to the innermost
  range of the launching thread whose host interval holds the start of the
  runtime call that launched it, matched by the trace's ``correlation``
  ids;
* a **host sync** is a runtime call whose name ends in ``Synchronize``
  (``cudaStreamSynchronize`` behind ``.item()`` and ``.cpu()``,
  ``cudaDeviceSynchronize``), counted in the innermost range of its own
  thread that holds its start.

A range or a sync of another thread (a serving front-end's readers) thus
never lands in the stage that the main thread has open at that moment.
``python -m repro_torch.launch.obs DIR --stages`` renders the split of the
traces in ``DIR``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Range:
    """One range: host interval (microseconds), host thread and path."""
    start: float
    end: float
    name: str
    thread: tuple = (None, None)
    path: str = ""


@dataclass
class StageRow:
    """The totals of one path over every range that has it: host time,
    and the device time, launches and syncs of the range and everything
    inside it (``self_device_us``: of the range alone)."""
    path: str
    calls: int = 0
    host_us: float = 0.0
    device_us: float = 0.0
    self_device_us: float = 0.0
    launches: int = 0
    syncs: int = 0

    @property
    def name(self) -> str:
        return self.path.rsplit("/", 1)[-1]

    @property
    def depth(self) -> int:
        return self.path.count("/")


def load(path) -> list:
    """The ``traceEvents`` of a chrome trace file."""
    return json.loads(Path(path).read_text())["traceEvents"]


def _interval(e: dict) -> tuple[float, float]:
    a = float(e["ts"])
    return a, a + float(e.get("dur", 0))


def _correlation(e: dict):
    return (e.get("args") or {}).get("correlation")


def _thread(e: dict) -> tuple:
    return e.get("pid"), e.get("tid")


def ranges(events: list) -> list:
    """The trace's ranges in start order (an enclosing range before the
    ranges it holds), each with its path among its own thread's ranges."""
    out = sorted((Range(*_interval(e), e.get("name", ""), _thread(e))
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and not e.get("name", "").startswith("ProfilerStep#")),
                 key=lambda r: (r.start, -r.end))
    stacks: dict = {}
    for r in out:
        stack = stacks.setdefault(r.thread, [])
        while stack and stack[-1].end <= r.start:
            stack.pop()
        r.path = f"{stack[-1].path}/{r.name}" if stack else r.name
        stack.append(r)
    return out


def innermost(rs: list, points: list) -> list:
    """For each of ``points`` (microseconds), the innermost of the
    start-ordered, nested ranges ``rs`` (of one thread) that holds it, or
    None."""
    order = sorted(range(len(points)), key=points.__getitem__)
    out = [None] * len(points)
    stack: list = []
    i = 0
    for j in order:
        x = points[j]
        while i < len(rs) and rs[i].start <= x:
            while stack and stack[-1].end <= rs[i].start:
                stack.pop()
            stack.append(rs[i])
            i += 1
        while stack and stack[-1].end < x:
            stack.pop()
        out[j] = stack[-1] if stack else None
    return out


def split(events: list) -> tuple[list, float]:
    """(one :class:`StageRow` a path, in the order the paths first start;
    the device microseconds of the trace's device operations that no range
    launched)."""
    rs = ranges(events)
    rows: dict[str, StageRow] = {}
    for r in rs:
        row = rows.setdefault(r.path, StageRow(r.path))
        row.calls += 1
        row.host_us += r.end - r.start

    def holders(r: Range) -> list:
        """The rows of ``r``'s path and of every path that holds it."""
        parts = r.path.split("/")
        return [rows["/".join(parts[:k])] for k in range(1, len(parts) + 1)]

    by_thread: dict = {}
    for r in rs:
        by_thread.setdefault(r.thread, []).append(r)
    runtime: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in RUNTIME_CATS:
            runtime.setdefault(_thread(e), []).append(e)
    launched = {}                       # correlation id -> launching range
    for thread, calls in runtime.items():
        held = innermost(by_thread.get(thread, []),
                         [float(e["ts"]) for e in calls])
        for e, r in zip(calls, held):
            if r is None:
                continue
            if e.get("name", "").endswith("Synchronize"):
                for row in holders(r):
                    row.syncs += 1
            if _correlation(e) is not None:
                launched[_correlation(e)] = r
    stray = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = _interval(e)
        r = launched.get(_correlation(e))
        if r is None:
            stray += b - a
            continue
        rows[r.path].self_device_us += b - a
        for row in holders(r):
            row.device_us += b - a
            row.launches += 1
    return list(rows.values()), stray


def render(rows: list, stray_us: float = 0.0) -> str:
    """The split as an indented table, one line a path (totals over its
    calls; device ms, launches and syncs include the ranges inside)."""
    lines = [f"{'stage':<40} {'calls':>6} {'host ms':>10} {'device ms':>10} "
             f"{'self ms':>10} {'launches':>9} {'syncs':>6}"]
    for r in rows:
        label = "  " * r.depth + r.name
        lines.append(f"{label:<40} {r.calls:>6} {r.host_us / 1e3:>10.3f} "
                     f"{r.device_us / 1e3:>10.3f} "
                     f"{r.self_device_us / 1e3:>10.3f} {r.launches:>9} "
                     f"{r.syncs:>6}")
    if stray_us:
        lines.append(f"(device ms launched outside every range: "
                     f"{stray_us / 1e3:.3f})")
    return "\n".join(lines)
