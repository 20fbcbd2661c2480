"""Device-level profiling: a work model kept by the kernel wrappers,
roofline utilization, device-memory gauges, and opt-in ``torch.profiler``
trace capture.

The port's counterpart of ``repro.obs.prof``. It relates a *measured* op
time to the *hardware ceiling*, as the reference does, with two changes
that follow from PyTorch having no ahead-of-time compile:

* **Work model, not a cost model.** torch has no
  ``compiled.cost_analysis()``. In its place, while :func:`profile_op` or
  :func:`profiled_op` runs the op's first call, a thread-local accumulator
  (:func:`collect_work`) is open, and every op of ``kernels/ops.py`` adds to
  it (:func:`add_work`) the bytes its contract moves (each input read once,
  each output written once) and its int32 operations: the count behind
  ``chip_smoke.py``'s ``bound_ms`` and PERF.md's kernel table. It does not
  depend on which route ran (the CUDA kernel or its plain version), so the
  yardstick stays put when a kernel is redesigned and the CPU tests see the
  card's bytes. The bound is max(bytes / HBM rate, int32 ops / int32 peak,
  FLOPs / FLOP peak); ``prof.roofline_util`` = bound / measured steady
  time. An op that reaches no kernel wrapper records no roofline gauge,
  as the reference records none where the backend has no cost model.
  Plain torch work around the wrappers is not counted, so a build's
  utilization is a lower bound on how close the whole call came.
* **Hardware model by card name.** ``hw_model("cuda")`` holds the H100 SXM
  figures only when ``torch.cuda.get_device_name()`` names an H100; any
  other card needs ``REPRO_PEAK_FLOPS`` (its operation peak, FLOP and
  int32 alike) and ``REPRO_HBM_BW``, else profiling records
  ``prof.error`` and no roofline gauge. The reference's A100 placeholder
  row is not carried over.

Memory: ``prof.peak_bytes`` is the rise of ``torch.cuda.max_memory_allocated``
over one steady call, measured after ``reset_peak_memory_stats`` (on a card
only). ``live_memory_stats`` reads the caching allocator, under the
reference's names: ``live_bytes`` and ``device_bytes_in_use`` are both
``memory_allocated`` (bytes of live tensors, not the allocator's reserve),
``device_peak_bytes`` is ``max_memory_allocated`` since the last reset, and
``live_arrays`` is the allocator's count of active allocations
(``memory_stats()["active.all.current"]``), not a count of tensors. The CPU
records none of them.

Trace capture (``--profile-dir`` on the CLIs): ``start_trace``/``stop_trace``
(or the ``trace`` context manager) wrap ``torch.profiler.profile`` over the
CPU and CUDA activities and write its chrome trace into the directory, so
the ``obs.span`` names (``record_function`` ranges) line up with the
kernels on the device timeline. The reference's ``analyze_hlo`` (post-SPMD
XLA HLO text) has no counterpart here.
"""
from __future__ import annotations

import contextlib
import os
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

from .metrics import counter, gauge
from .spans import tensor_leaves, wait_for
from .timing import Stopwatch, record_op, timed_op

# ---------------------------------------------------------------------------
# hardware model
# ---------------------------------------------------------------------------

#: (peak dense FLOP/s, HBM bytes/s, peak int32 operations/s) per part. The
#: H100 row is the SXM part at its full 700 W limit (NVIDIA H100 Tensor Core
#: GPU Architecture whitepaper: 989 TFLOP/s dense bf16; 3.35 TB/s HBM3;
#: 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7 TOP/s int32). The CPU
#: row is the reference's order-of-magnitude container estimate, a trend
#: figure for the CPU tests and never a device metric.
HW_MODELS: Dict[str, Tuple[float, float, float]] = {
    "h100": (989e12, 3.35e12, 16.7e12),
    "cpu": (2.0e11, 5.0e10, 2.0e11),
}


def hw_model(backend: str | None = None,
             device_name: str | None = None) -> Tuple[float, float, float]:
    """(peak FLOP/s, HBM B/s, peak int32 op/s) for ``backend`` ("cuda" or
    "cpu"; default: "cuda" when a card is present). On "cuda" the H100 row
    applies when ``device_name`` (default: the current card's) names an
    H100. ``REPRO_PEAK_FLOPS`` (both operation peaks) and ``REPRO_HBM_BW``
    override everywhere; another card without both raises ``ValueError``
    (no made-up figures)."""
    import torch
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    env_ops = os.environ.get("REPRO_PEAK_FLOPS")
    env_bw = os.environ.get("REPRO_HBM_BW")
    if backend == "cuda":
        name = (device_name if device_name is not None
                else torch.cuda.get_device_name())
        row = HW_MODELS["h100"] if "H100" in name else None
    else:
        name, row = backend, HW_MODELS.get(backend, HW_MODELS["cpu"])
    if row is None and (env_ops is None or env_bw is None):
        raise ValueError(f"no hardware model for {name!r}: set "
                         f"REPRO_PEAK_FLOPS and REPRO_HBM_BW to its peaks")
    flops, bw, int_ops = row or (0.0, 0.0, 0.0)
    if env_ops is not None:
        flops = int_ops = float(env_ops)
    if env_bw is not None:
        bw = float(env_bw)
    return flops, bw, int_ops


# ---------------------------------------------------------------------------
# the work model kept by the kernel wrappers
# ---------------------------------------------------------------------------

class Work:
    """Bytes, int32 operations and FLOPs that the kernel ops of one call
    added."""
    __slots__ = ("bytes", "int_ops", "flops")

    def __init__(self):
        self.bytes = 0.0
        self.int_ops = 0.0
        self.flops = 0.0

    def add(self, nbytes: float, int_ops: float, flops: float) -> None:
        self.bytes += nbytes
        self.int_ops += int_ops
        self.flops += flops

    @property
    def empty(self) -> bool:
        return not (self.bytes or self.int_ops or self.flops)


_work_tls = threading.local()
#: accumulators open on any thread: the kernel ops' one-read pre-check
_open = [0]


def _work_stack() -> list:
    st = getattr(_work_tls, "stack", None)
    if st is None:
        st = _work_tls.stack = []
    return st


def collecting() -> bool:
    """True while a :func:`collect_work` block is open on this thread: a
    kernel op computes its work (which may cost a pass over its inputs)
    only then."""
    return bool(_open[0]) and bool(getattr(_work_tls, "stack", None))


@contextlib.contextmanager
def collect_work():
    """Open a work accumulator on this thread; yields the :class:`Work`
    that every kernel op called inside the block adds to (nested blocks
    each see the work of their own span)."""
    w = Work()
    st = _work_stack()
    st.append(w)
    _open[0] += 1
    try:
        yield w
    finally:
        _open[0] -= 1
        st.pop()


def add_work(nbytes: float, int_ops: float = 0.0,
             flops: float = 0.0) -> None:
    """Add one kernel op's work to every open accumulator of this thread
    (no-op when none is open)."""
    if not _open[0]:
        return
    for w in getattr(_work_tls, "stack", None) or ():
        w.add(float(nbytes), float(int_ops), float(flops))


# ---------------------------------------------------------------------------
# device memory
# ---------------------------------------------------------------------------

def _cuda_device(args):
    """The device of the first CUDA tensor leaf of ``args``, else None."""
    for t in tensor_leaves(list(args)):
        if t.device.type == "cuda":
            return t.device
    return None


def live_memory_stats(device=None) -> Dict[str, float]:
    """The caching allocator's view of ``device`` (default: the current
    card) under the reference's names (see the module doc); ``{}`` without
    a card."""
    import torch
    if not torch.cuda.is_available():
        return {}
    allocated = float(torch.cuda.memory_allocated(device))
    active = torch.cuda.memory_stats(device).get("active.all.current", 0)
    return {"live_arrays": float(active),
            "live_bytes": allocated,
            "device_bytes_in_use": allocated,
            "device_peak_bytes": float(torch.cuda.max_memory_allocated(
                device))}


def record_memory_gauges(device=None) -> Dict[str, float]:
    """Snapshot ``live_memory_stats`` into the ``prof.mem.*`` gauges."""
    stats = live_memory_stats(device)
    for k, v in stats.items():
        gauge("prof.mem." + k).set(v)
    return stats


# ---------------------------------------------------------------------------
# roofline profiling of one op
# ---------------------------------------------------------------------------

def _record_work_gauges(op: str, work: Work, steady_s: float,
                        backend: str,
                        work_elements: Optional[float] = None) -> dict:
    """Record the ``prof.*`` gauge family of ``op`` from its work model and
    measured steady time; returns the stats as a dict. Without work (no
    kernel op ran) only ``steady_s`` (and Melem/s) are recorded."""
    stats: dict = {"op": op, "steady_s": steady_s}
    gauge("prof.steady_s", op=op).set(steady_s)
    if work_elements and steady_s > 0:
        stats["melem_per_s"] = work_elements / steady_s / 1e6
        gauge("prof.melem_per_s", op=op).set(stats["melem_per_s"])
    if work.empty:
        return stats
    peak_flops, hbm_bw, peak_int = hw_model(backend)
    stats.update(bytes_accessed=work.bytes, int_ops=work.int_ops,
                 flops=work.flops)
    gauge("prof.bytes_accessed", op=op).set(work.bytes)
    gauge("prof.int_ops", op=op).set(work.int_ops)
    if work.flops:
        gauge("prof.flops", op=op).set(work.flops)
    if work.bytes:
        stats["ai"] = (work.int_ops + work.flops) / work.bytes
        gauge("prof.ai", op=op).set(stats["ai"])
    t_memory = work.bytes / hbm_bw
    t_compute = max(work.int_ops / peak_int, work.flops / peak_flops)
    roofline_s = max(t_compute, t_memory)
    stats["compute_s"] = t_compute
    stats["memory_s"] = t_memory
    stats["bound_s"] = roofline_s
    if steady_s > 0:
        if work.flops:
            stats["achieved_flops_s"] = work.flops / steady_s
            gauge("prof.achieved_flops_s", op=op).set(
                stats["achieved_flops_s"])
        if work.bytes:
            stats["achieved_bytes_s"] = work.bytes / steady_s
            gauge("prof.achieved_bytes_s", op=op).set(
                stats["achieved_bytes_s"])
        if roofline_s > 0:
            # fraction of the hardware ceiling achieved: bound-time /
            # measured-time. 1.0 = at the roofline; << 1 = headroom.
            stats["roofline_util"] = roofline_s / steady_s
            stats["bound"] = ("compute" if t_compute >= t_memory
                              else "memory")
            gauge("prof.roofline_util", op=op).set(stats["roofline_util"])
            counter("prof.bound", op=op, term=stats["bound"]).inc()
    return stats


def _measure(fn, args, iters: int):
    """First call with a work accumulator open (timed apart: on a fresh
    build directory it includes the kernels' nvcc build), then ``iters``
    steady calls; the first steady call's memory rise on a card.
    Returns (out, steady_s, first_s, work, peak_bytes or None, device)."""
    import torch
    dev = _cuda_device(args)
    sw = Stopwatch()
    with collect_work() as work:
        out = wait_for(fn(*args))
    first_s = sw.lap()
    if dev is None and tensor_leaves(out):
        dev = _cuda_device((out,))
    peak_bytes = None
    ts = []
    for i in range(max(1, iters)):
        if i == 0 and dev is not None:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        sw.lap()
        out = wait_for(fn(*args))
        ts.append(sw.lap())
        if i == 0 and dev is not None:
            peak_bytes = float(torch.cuda.max_memory_allocated(dev) - base)
    ts.sort()
    return out, ts[len(ts) // 2], first_s, work, peak_bytes, dev


def _device_errors() -> tuple:
    """``kernels.build.DEVICE_ERRORS``, imported when a call failed (the
    builder imports torch; this module does not at import time)."""
    from repro_torch.kernels.build import DEVICE_ERRORS
    return DEVICE_ERRORS


def profile_op(name: str, fn, *args, iters: int = 1,
               work_elements: Optional[float] = None, strict: bool = False):
    """Run ``fn(*args)`` once with the work model open, time ``iters``
    steady calls, and record the ``prof.*{op=name}`` roofline gauge family
    (+ ``prof.peak_bytes`` and the ``prof.mem.*`` gauges on a card).

    Returns ``(out, stats)``: ``stats`` holds bytes / int_ops / roofline_util
    / achieved rates / peak_bytes / compile_s (the first call), as far as
    they apply. ``work_elements`` (e.g. sequence length, query count)
    additionally derives ``prof.melem_per_s``. With ``strict=False`` (the
    CLI default) any failure, a card without a hardware model included,
    degrades to ``(None, {"op": name, "error": ...})`` and a ``prof.error``
    counter instead of raising: profiling must never take serving down. A
    failure of the device (``kernels.build.DEVICE_ERRORS``: a kernel that
    does not build or launch, a CUDA error, out of memory) always raises.
    """
    try:
        out, steady_s, first_s, work, peak, dev = _measure(fn, args, iters)
        stats = _record_work_gauges(
            name, work, steady_s, "cuda" if dev is not None else "cpu",
            work_elements=work_elements)
        stats["compile_s"] = first_s
        if peak is not None:
            stats["peak_bytes"] = peak
            gauge("prof.peak_bytes", op=name).set(peak)
            record_memory_gauges(dev)
        return out, stats
    except Exception as e:                                    # noqa: BLE001
        if strict or isinstance(e, _device_errors()):
            raise
        counter("prof.error", op=name).inc()
        return None, {"op": name, "error": f"{type(e).__name__}: {e}"}


def profiled_op(layer: str, op: str, fn, *args, batch: int = 1,
                iters: int = 1):
    """``obs.timed_op`` + roofline profiling from the same calls.

    Emits the standard ``serve.<layer>.<op>.*`` metric family (latency
    histogram, compile_s/batch/qps gauges, calls counter, shape tracking)
    AND the ``prof.*{op=<layer>.<op>}`` gauges of :func:`profile_op`. Falls
    back to plain ``timed_op`` (no prof gauges, a ``prof.error``) when the
    profile fails, unless the device failed (``kernels.build.DEVICE_ERRORS``
    raise). Returns ``(out, steady_s, compile_s)``: drop-in for
    ``timed_op``.
    """
    name = f"{layer}.{op}"
    try:
        out, steady_s, first_s, work, peak, dev = _measure(fn, args, iters)
    except Exception as e:                                    # noqa: BLE001
        if isinstance(e, _device_errors()):
            raise
        counter("prof.error", op=name).inc()
        return timed_op(layer, op, fn, *args, batch=batch, iters=iters)
    record_op(layer, op, args, steady_s, first_s, batch, iters)
    try:
        _record_work_gauges(name, work, steady_s,
                            "cuda" if dev is not None else "cpu",
                            work_elements=batch)
    except ValueError:                    # a card with no hardware model
        counter("prof.error", op=name).inc()
    if peak is not None:
        gauge("prof.peak_bytes", op=name).set(peak)
        record_memory_gauges(dev)
    return out, steady_s, first_s


# ---------------------------------------------------------------------------
# opt-in torch.profiler trace capture (--profile-dir on the CLIs)
# ---------------------------------------------------------------------------

_trace_lock = threading.Lock()
_trace_state: dict = {}

TRACE_FILE = "trace.json"


def start_trace(profile_dir) -> bool:
    """Start a ``torch.profiler`` trace (CPU and, with a card, CUDA
    activities) that :func:`stop_trace` writes into ``profile_dir`` (no-op
    and False on a falsy dir or if a trace is already running)."""
    if not profile_dir:
        return False
    import torch
    with _trace_lock:
        if _trace_state:
            return False
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        _trace_state.update(prof=prof, dir=Path(profile_dir))
    return True


def stop_trace() -> Optional[Path]:
    """Stop the running trace and write its chrome trace as
    ``<profile_dir>/trace.json``; returns that path (None, and falsy, when
    no trace is active)."""
    with _trace_lock:
        if not _trace_state:
            return None
        prof, d = _trace_state["prof"], _trace_state["dir"]
        _trace_state.clear()
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    d.mkdir(parents=True, exist_ok=True)
    path = d / TRACE_FILE
    prof.export_chrome_trace(str(path))
    return path


@contextlib.contextmanager
def trace(profile_dir):
    """Context manager form of start/stop_trace; no-op on a falsy dir."""
    started = start_trace(profile_dir)
    try:
        yield
    finally:
        if started:
            stop_trace()
