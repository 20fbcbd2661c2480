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
and touches nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
                 parent_id: str | None):
        self.name = name
        self.path = path
        self.attrs = attrs
        self.span_id = uuid.uuid4().hex[:12]
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


@contextlib.contextmanager
def span(name: str, **attrs):
    """Context manager timing a nested, attributed span (see module doc)."""
    if not _state.enabled:
        yield _NULL
        return
    import torch
    st = _stack()
    parent = st[-1] if st else None
    path = f"{parent.path}/{name}" if parent else name
    sp = Span(name, path, dict(attrs),
              parent.span_id if parent else None)
    st.append(sp)
    sync_error = None
    try:
        with torch.profiler.record_function(name):
            yield sp
    finally:
        if sp._sync is not None:
            try:
                wait_for(sp._sync)
            except Exception as e:                            # noqa: BLE001
                sync_error = e    # a failed computation still ends the span
        sp.dur_s = time.perf_counter() - sp.t0
        st.pop()
        histogram("span." + name).observe(sp.dur_s)
        _export.emit_event("span", name, ts=sp.ts, dur_s=sp.dur_s,
                           path=sp.path, span_id=sp.span_id,
                           parent_id=sp.parent_id,
                           attrs=sp.attrs or None)
    # the synchronize is where the device raises its asynchronous errors:
    # one after a clean body is the span's own failure
    if sync_error is not None:
        raise sync_error
