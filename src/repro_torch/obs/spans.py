"""Nested trace spans: host-side timing that lines up with device profiles.

``span("restore.verify", shards=8)`` times a block, nests (a thread-local
stack gives every span a ``/``-joined path), records the duration into the
``span.<name>`` histogram, appends a structured event to the JSONL event
log when an exporter is configured, and forwards the name to
``torch.profiler.record_function`` so the same block shows up in a
``torch.profiler`` trace (``obs.prof.trace``) under the same label. The
reference forwards to ``jax.profiler.TraceAnnotation``/``named_scope``;
there is no NVTX range, as no NVTX reader runs where the port is measured.

Asynchronous launches make naive host timing lie: a CUDA kernel is queued
and the call returns before the card finishes. ``sp.sync(out)`` registers
the call's output, and the span waits at exit, *before* reading the clock,
for the device work of every CUDA tensor leaf of it (tensors, tuples,
lists, dicts and the port's dataclasses of tensors): a
``torch.cuda.synchronize`` of each device the leaves live on. CPU leaves
need nothing. Opt-in, because waiting inside a pipelined serving loop would
serialize it. The synchronize is where the card raises its asynchronous
errors: after a body that finished cleanly the span ends, then raises the
error; after a body that raised, the body's exception wins.

When metrics are disabled the context manager yields a shared no-op span
and touches nothing. A span pays for what reads it: it enters
``record_function`` only while a torch profiler is recording, and takes a
span id only while an exporter is configured (without one the stack
keeps its path and parent, with no id).

``stage("wm.levels", chunk=0)`` marks a stage of a hot path (the builds'
steps, the quantile's dispatch) on the same stack, path, parent and
exporter, with none of a span's other costs: no ``span.*`` histogram (so
the paths' histogram keys stay the reference's) and never a synchronize.
With no profiler recording and no exporter configured it returns a shared
null context after two flag reads. Under a profiler it is a
``record_function`` range, so the device operations it launches can be
told apart in the trace (``obs.timeline``); with an exporter it writes a
``span`` event, so ``launch.obs --tree`` shows it under its span. A stage
of a per-call path (``export=False``: the quantile's dispatch, whose
callers export a span a batch already) writes no event and costs an
exporter's run nothing but the flag reads.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
import time
import uuid

from . import export as _export
from .metrics import _state, histogram

_tls = threading.local()


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def tensor_leaves(value) -> list:
    """Every ``torch.Tensor`` inside ``value``: a tensor, a tuple, list or
    dict of them, or one of the port's dataclasses of tensors (through
    ``repro_torch.tree.tree_leaves``); anything else has none."""
    import torch
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in tensor_leaves(v)]
    if isinstance(value, dict):
        return [t for v in value.values() for t in tensor_leaves(v)]
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        from repro_torch.tree import tree_leaves
        return tree_leaves(value)
    return []


def wait_for(value):
    """Block until the device work behind every CUDA tensor leaf of
    ``value`` is done (a synchronize of each device the leaves live on);
    returns ``value``. CPU leaves are ready already."""
    import torch
    for dev in {t.device for t in tensor_leaves(value)
                if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return value


class Span:
    __slots__ = ("name", "path", "attrs", "t0", "ts", "dur_s", "span_id",
                 "parent_id", "_sync")

    def __init__(self, name: str, path: str, attrs: dict,
                 parent_id: str | None, exported: bool):
        self.name = name
        self.path = path
        self.attrs = attrs
        self.span_id = uuid.uuid4().hex[:12] if exported else None
        self.parent_id = parent_id
        self.ts = time.time()
        self.t0 = time.perf_counter()
        self.dur_s = None
        self._sync = None

    def set(self, key: str, value) -> None:
        """Attach an attribute discovered mid-span (exported at exit)."""
        self.attrs[key] = value

    def sync(self, value):
        """Register device work to wait for at span exit; returns it."""
        self._sync = value
        return value


class _NullSpan:
    """Disabled-mode stand-in: every method is a no-op."""
    __slots__ = ()

    def set(self, key, value):
        pass

    def sync(self, value):
        return value


_NULL = _NullSpan()


_modules = sys.modules
_PROFILER = "torch.autograd.profiler"


def profiling() -> bool:
    """Whether a torch profiler is recording: torch's own flag, read without
    importing torch (no profiler runs before its module is loaded)."""
    m = _modules.get(_PROFILER)
    return m is not None and m._is_profiler_enabled


def _open(name: str, attrs: dict, exported: bool) -> Span:
    """A span of ``name`` pushed onto the thread's stack."""
    st = _stack()
    parent = st[-1] if st else None
    sp = Span(name, f"{parent.path}/{name}" if parent else name, attrs,
              parent.span_id if parent else None, exported)
    st.append(sp)
    return sp


def _range(name: str):
    """The profiler's range of ``name`` while one records, else None."""
    if not profiling():
        return None
    import torch
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


def _emit(sp: Span) -> None:
    """The ``span`` event of a closed span."""
    _export.emit_event("span", sp.name, ts=sp.ts, dur_s=sp.dur_s,
                       path=sp.path, span_id=sp.span_id,
                       parent_id=sp.parent_id, attrs=sp.attrs or None)


def current_span() -> Span | None:
    st = _stack()
    return st[-1] if st else None


def event(name: str, kind: str = "event", **attrs) -> None:
    """Emit a structured event correlated to the currently open span (the
    fault-injection hook: a fault fired inside a chaos scenario's span
    shows up inside that span's subtree)."""
    if not _state.enabled:
        return
    sp = current_span()
    _export.emit_event(kind, name,
                       span_id=sp.span_id if sp is not None else None,
                       attrs=attrs or None)


class _Span:
    """An open span's context: its ``with`` target is the :class:`Span`."""
    __slots__ = ("name", "attrs", "exported", "sp", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> Span:
        self.exported = _export.exporting()
        self.sp = _open(self.name, self.attrs, self.exported)
        self.rf = _range(self.name)
        return self.sp

    def __exit__(self, t, v, tb):
        sp = self.sp
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        sync_error = None
        if sp._sync is not None:
            try:
                wait_for(sp._sync)
            except Exception as e:                            # noqa: BLE001
                sync_error = e    # a failed computation still ends the span
        sp.dur_s = time.perf_counter() - sp.t0
        _stack().pop()
        histogram("span." + self.name).observe(sp.dur_s)
        if self.exported:
            _emit(sp)
        # the synchronize is where the device raises its asynchronous
        # errors: one after a clean body is the span's own failure; after a
        # body that raised, the body's exception wins
        if sync_error is not None and t is None:
            raise sync_error
        return False


class _NullContext:
    """Disabled mode's span and stage: enters to ``target``, records
    nothing."""
    __slots__ = ("target",)

    def __init__(self, target):
        self.target = target

    def __enter__(self):
        return self.target

    def __exit__(self, t, v, tb):
        return False


_NULL_SPAN_CM = _NullContext(_NULL)


def span(name: str, **attrs):
    """Context manager timing a nested, attributed span (see module doc)."""
    if not _state.enabled:
        return _NULL_SPAN_CM
    return _Span(name, attrs)


class _Stage:
    """An open stage: the profiler's range and, while exported, its span
    on the stack. Its ``with`` target is None: a stage is never synced."""
    __slots__ = ("name", "attrs", "exported", "rf", "sp")

    def __init__(self, name: str, attrs: dict, exported: bool):
        self.name = name
        self.attrs = attrs
        self.exported = exported

    def __enter__(self):
        self.sp = (_open(self.name, self.attrs, True) if self.exported
                   else None)
        self.rf = _range(self.name)
        return None

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        sp = self.sp
        if sp is not None:
            sp.dur_s = time.perf_counter() - sp.t0
            _stack().pop()
            _emit(sp)
        return False


_NULL_STAGE = _NullContext(None)


def stage(name: str, *, export: bool = True, **attrs):
    """A stage of a hot path (see module doc): a context manager that
    records nothing but the profiler's range and, unless ``export`` is
    False, the exported event, and only while a profiler records or an
    exporter is configured."""
    # with nothing reading, the flag reads are the whole cost
    if _state.enabled:
        exported = export and _export.exporting()
        if exported or profiling():
            return _Stage(name, attrs, exported)
    return _NULL_STAGE
