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
the ``obs.span`` and ``obs.stage`` names (``record_function`` ranges) line
up with the kernels on the device timeline; ``obs.timeline`` reads a
stage's device time, launches and host syncs back from the file.

Program analysis (the dry run's): the counterpart of the reference's
``compiled_cost``, ``compiled_memory`` and ``analyze_hlo`` over a program
recorded by :func:`lower` (see its section below).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

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
#: the CLIs' trace of their build, beside the serving section's
BUILD_TRACE_FILE = "build_trace.json"


def start_trace(profile_dir, file: str = TRACE_FILE) -> bool:
    """Start a ``torch.profiler`` trace (CPU and, with a card, CUDA
    activities) that :func:`stop_trace` writes into ``profile_dir`` as
    ``file`` (no-op and False on a falsy dir or if a trace is already
    running)."""
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
        _trace_state.update(prof=prof, dir=Path(profile_dir), file=file)
    return True


def stop_trace() -> Optional[Path]:
    """Stop the running trace and write its chrome trace as
    ``<profile_dir>/<file>`` (``trace.json`` unless :func:`start_trace` was
    given another); returns that path (None, and falsy, when no trace is
    active)."""
    with _trace_lock:
        if not _trace_state:
            return None
        prof, d = _trace_state["prof"], _trace_state["dir"]
        file = _trace_state["file"]
        _trace_state.clear()
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    d.mkdir(parents=True, exist_ok=True)
    path = d / file
    prof.export_chrome_trace(str(path))
    return path


@contextlib.contextmanager
def trace(profile_dir, file: str = TRACE_FILE):
    """Context manager form of start/stop_trace; no-op on a falsy dir."""
    started = start_trace(profile_dir, file)
    try:
        yield
    finally:
        if started:
            stop_trace()


# ---------------------------------------------------------------------------
# program analysis: the dry run's counterpart of a compiled executable
# ---------------------------------------------------------------------------
#
# PyTorch compiles nothing ahead of time, so the counterpart of XLA's
# post-SPMD HLO is a *program*: the local ops one device runs in one call
# of a step on DTensors over a (fake) mesh, recorded by :func:`lower`. Its
# text has one line per op,
#
#     %12 = bf16[4,4096,56] dot aten.mm(bf16[16384,896], bf16[896,56]) contract=896
#     %13 = bf16[4,4096,896] all-gather _c10d_functional.all_gather_into_tensor(bf16[4,4096,56])
#
# giving the local result type, the op's kind (``dot``, one of the five
# collective kinds, ``pointwise``, ``transcendental``, ``reduce``,
# ``data`` or ``view``), the op and its local operand types, inside
# ``computation <name> {`` ... ``}`` blocks. A body the step runs several
# times is recorded once, in its own computation, and called with its trip
# count (``call microbatch trip=4``), as an HLO while loop carries
# ``known_trip_count``. A ``memory`` line in the header carries the
# buffer sizes the recording measured. ``compiled_cost``,
# ``compiled_memory`` and ``analyze_program`` read everything from the
# text, so a saved program (``dryrun --save-hlo``) analyzes as the live
# one does.
#
# Trap: a dispatch mode entered around DTensor code sees each op once, at
# GLOBAL shapes, before DTensor picks its strategy. The recorder instead
# returns ``NotImplemented`` for DTensor operands, so DTensor runs first
# and the recorder sees the local ops it issues on each device's shard,
# the redistributions' collectives among them. The sharding propagator's
# own shape inference on fake tensors is not recorded.

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",      # DTensor's own (namespace _dtensor)
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "_dtensor")
#: ops that move no data: waiting on a collective, autograd wrapping
_SILENT = ("wait_tensor", "_wrap_tensor_autograd")
_DOT_OPS = {"mm": 1, "bmm": 1, "addmm": 2, "baddbmm": 2, "addbmm": 2,
            "mv": 1, "addmv": 2, "dot": 1}   # op -> index of the lhs
_TRANSCENDENTAL_OPS = {"exp", "exp2", "expm1", "log", "log1p", "log2",
                       "tanh", "sigmoid", "rsqrt", "sqrt", "sin", "cos",
                       "erf", "pow", "_softmax", "_log_softmax"}

_DTYPE_NAMES = {"bool": "pred", "uint8": "u8", "int8": "s8",
                "int16": "s16", "int32": "s32", "int64": "s64",
                "float16": "f16", "bfloat16": "bf16", "float32": "f32",
                "float64": "f64", "uint16": "u16", "uint32": "u32",
                "uint64": "u64", "complex64": "c64"}
_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "u16": 2,
                "s16": 2, "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8,
                "u64": 8, "c64": 8}

_TYPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_LINE_RE = re.compile(r"^\s*%\d+ = (\(?[a-z0-9\[\],. ]*\)?) ([a-z\-]+) "
                      r"([\w.]+)\((.*)\)(.*)$")
_COMP_RE = re.compile(r"^computation ([\w.\-]+) \{$")
_CALL_RE = re.compile(r"^\s*call ([\w.\-]+) trip=(\d+)$")
_MEMORY_RE = re.compile(r"^memory (.*)$", re.M)
_MEMORY_KEYS = ("argument_bytes", "output_bytes", "temp_bytes",
                "alias_bytes")


def _type_str(t) -> str:
    name = _DTYPE_NAMES.get(str(t.dtype).replace("torch.", ""), "f32")
    return f"{name}[{','.join(str(d) for d in t.shape)}]"


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _leaves(value) -> list:
    """Tensor leaves of nested tuples, lists, dicts and dataclasses."""
    import torch
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _leaves(v)]
    if isinstance(value, dict):
        return [t for v in value.values() for t in _leaves(v)]
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return [t for f in dataclasses.fields(value)
                for t in _leaves(getattr(value, f.name))]
    return []


def _local(t):
    """A DTensor's shard on this device; a plain tensor itself."""
    return getattr(t, "_local_tensor", t)


def _op_kind(func) -> str:
    """The kind of one op overload (see the section comment)."""
    import torch
    ns = func.namespace
    name = func._schema.name.split("::")[-1]
    if ns in _COLLECTIVE_NS:
        if name in _SILENT:
            return "silent"
        if name in _COLLECTIVE_OPS:
            return _COLLECTIVE_OPS[name]
        raise ValueError(f"collective {func} has no kind of "
                         f"{COLLECTIVES}")
    if ns == "prim":
        return "silent"
    if name in _DOT_OPS:
        return "dot"
    rets = func._schema.returns
    if rets and rets[0].alias_info is not None and \
            not rets[0].alias_info.is_write:
        return "view"
    base = name.rstrip("_")
    if base in _TRANSCENDENTAL_OPS:
        return "transcendental"
    tags = set(func.tags)
    if base != name:                    # an in-place op: its functional form
        packet = getattr(getattr(torch.ops, ns), base, None)
        over = getattr(packet, func._overloadname, None) if packet else None
        if over is not None:
            tags |= set(over.tags)
    if torch.Tag.pointwise in tags:
        return "pointwise"
    if torch.Tag.reduction in tags or base in ("cumsum", "cumprod"):
        return "reduce"
    return "data"


class _Recorder:
    """The TorchDispatchMode behind :func:`lower` (built lazily: this module
    imports no torch at import time)."""

    def __init__(self):
        self.comps: Dict[str, List[str]] = {"main": []}
        self.stack = ["main"]
        self.n = 0
        self.kinds: dict = {}
        # storage key -> [bytes, first op, last op]; strong refs keep every
        # storage's key unique for the recording's life
        self.storages: Dict[int, list] = {}
        self.keep: list = []

    def _storage(self, t, create: bool):
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        rec = self.storages.get(key)
        if rec is None:
            if not create:
                return
            self.storages[key] = [st.nbytes(), self.n, self.n]
            self.keep.append(st)
        else:
            rec[2] = self.n

    def register(self, tensors) -> set:
        """Storages of tensors that exist before the call (its arguments)."""
        keys = set()
        for t in tensors:
            t = _local(t)
            self._storage(t, create=True)
            keys.add(t.untyped_storage()._cdata)
        return keys

    def dispatch(self, func, args, kwargs):
        from torch._subclasses.fake_tensor import FakeTensor
        out = func(*args, **kwargs)
        kind = self.kinds.get(func)
        if kind is None:
            kind = self.kinds[func] = _op_kind(func)
        ins = _leaves((args, kwargs))
        outs = _leaves(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out          # DTensor's own shape inference
        self.n += 1
        for t in ins:
            self._storage(t, create=False)
        for t in outs:
            self._storage(t, create=True)
        if kind == "silent" or not outs:
            return out
        res = ", ".join(_type_str(t) for t in outs)
        if len(outs) > 1:
            res = f"({res})"
        line = (f"  %{self.n} = {res} {kind} {func._schema.name.replace('::', '.')}("
                f"{', '.join(_type_str(t) for t in ins)})")
        if kind == "dot":
            lhs = ins[_DOT_OPS[func._schema.name.split('::')[-1]] - 1]
            line += f" contract={lhs.shape[-1]}"
        self.comps[self.stack[-1]].append(line)
        return out


_recorders = threading.local()


def _mode_class():
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Mode(TorchDispatchMode):
        def __init__(self, rec):
            super().__init__()
            self.rec = rec

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented   # DTensor first: see its local ops
            return self.rec.dispatch(func, args, kwargs or {})
    return _Mode


def loop(name: str, trip: int):
    """``range(trip)``, except while :func:`lower` records: then it yields
    only 0, and the ops of that one pass are recorded as computation
    ``name``, called ``trip`` times (a microbatch loop traced once, as
    ``lax.scan`` traces its body once)."""
    rec = getattr(_recorders, "rec", None)
    if rec is None:
        yield from range(trip)
        return
    parent = rec.stack[-1]
    if name in rec.comps:
        raise ValueError(f"computation {name!r} recorded twice")
    rec.comps[parent].append(f"  call {name} trip={int(trip)}")
    rec.comps[name] = []
    rec.stack.append(name)
    try:
        yield 0
    finally:
        rec.stack.pop()


class Program:
    """What :func:`lower` recorded: the program ``text``, the call's
    ``outputs`` (meta DTensors) and ``peak_live``: the temporaries live
    where the temp bytes peak, as (bytes, the op line that made each),
    largest first."""

    def __init__(self, text: str, outputs, peak_live=()):
        self.text = text
        self.outputs = outputs
        self.peak_live = list(peak_live)


def lower(fn, *args, donate: Tuple[int, ...] = (), name: str = "step",
          mesh=None) -> Program:
    """Run ``fn(*args)`` once, on DTensors of ``meta`` shards over ``mesh``
    (or plain meta tensors), and record the program one device runs.

    The call computes nothing: ``meta`` tensors carry shapes and dtypes
    only, as the fake tensors of XLA's placeholder devices do (torch's
    ``FakeTensorMode`` would do, but autograd over fake CUDA tensors needs a
    CUDA build of torch, and DTensor moves no meta shard to the mesh's
    device). ``donate``: indices of ``args`` whose buffers the outputs may
    reuse, as ``jax.jit``'s ``donate_argnums``; an output of a donated
    argument's shape and dtype aliases it.

    Memory (per device, local shards): arguments and outputs are their
    distinct storages; temporaries are the peak over the op stream of the
    storages made inside the call that are neither, each live from the op
    that makes it to the last op that reads it (the remat recompute's
    included); peak = argument + output + temp − alias, as the reference
    reads ``memory_analysis()``."""
    rec = _Recorder()
    arg_keys = rec.register(_leaves(args))
    arg_bytes = sum(rec.storages[k][0] for k in arg_keys)
    donated = [t for i in donate for t in _leaves(args[i])]
    prev = getattr(_recorders, "rec", None)
    _recorders.rec = rec
    try:
        with _mode_class()(rec):
            out = fn(*args)
    finally:
        _recorders.rec = prev
    outs = [_local(t) for t in _leaves(out)]
    out_keys = {t.untyped_storage()._cdata for t in outs}
    for k in out_keys:
        if k not in rec.storages:           # a view the mode never saw
            rec.storages[k] = [0, rec.n, rec.n]
    out_bytes = sum(rec.storages[k][0] for k in out_keys)
    # alias: outputs written into a donated buffer in place, then outputs
    # of a donated argument's shape and dtype (buffer reuse)
    alias = 0
    free = {}
    for t in donated:
        lt = _local(t)
        free.setdefault((tuple(lt.shape), lt.dtype), []).append(
            lt.untyped_storage()._cdata)
    taken = set()
    for t in outs:
        k = t.untyped_storage()._cdata
        if k in arg_keys and any(k in v for v in free.values()):
            taken.add(k)
            alias += rec.storages[k][0]
    for t in outs:
        k = t.untyped_storage()._cdata
        if k in arg_keys:
            continue
        cands = [c for c in free.get((tuple(t.shape), t.dtype), ())
                 if c not in taken]
        if cands:
            taken.add(cands[0])
            alias += _nbytes(t)
    # temporaries: a sweep over the op stream
    delta: Dict[int, int] = {}
    for k, (nb, first, last) in rec.storages.items():
        if k in arg_keys or k in out_keys or not nb:
            continue
        delta[first] = delta.get(first, 0) + nb
        delta[last + 1] = delta.get(last + 1, 0) - nb
    live = temp = peak_at = 0
    for i in sorted(delta):
        live += delta[i]
        if live > temp:
            temp, peak_at = live, i
    devices = mesh.size() if mesh is not None else 1
    axes = (",".join(f"{a}:{s}" for a, s in zip(mesh.mesh_dim_names,
                                                 mesh.shape))
            if mesh is not None else "none")
    lines = [f"program {name} devices={devices} mesh={axes}",
             f"memory argument_bytes={arg_bytes} output_bytes={out_bytes} "
             f"temp_bytes={temp} alias_bytes={alias}"]
    for cname, body in rec.comps.items():
        lines.append(f"computation {cname} {{")
        lines.extend(body)
        lines.append("}")
    made = {int(ln.split(" = ", 1)[0].strip()[1:]): ln.strip()
            for body in rec.comps.values() for ln in body
            if ln.lstrip().startswith("%")}
    peak_live = sorted(
        ((nb, made.get(first, f"%{first} (silent)"))
         for k, (nb, first, last) in rec.storages.items()
         if k not in arg_keys and k not in out_keys and nb
         and first <= peak_at <= last), key=lambda b: -b[0])
    return Program("\n".join(lines) + "\n", out, peak_live)


def _text(program) -> str:
    return getattr(program, "text", program)


def parse_program(text: str) -> Dict[str, List[str]]:
    """computation name -> its lines (ops and calls)."""
    comps: Dict[str, List[str]] = {}
    cur = None
    for line in _text(text).splitlines():
        m = _COMP_RE.match(line)
        if m:
            cur = m.group(1)
            comps[cur] = []
        elif line.startswith("}"):
            cur = None
        elif cur is not None and line.strip():
            comps[cur].append(line)
    return comps


def _multipliers(comps: Dict[str, List[str]]) -> Dict[str, float]:
    """How many times each computation runs in one call of ``main``."""
    mult: Dict[str, float] = {}

    def visit(name: str, m: float):
        mult[name] = mult.get(name, 0.0) + m
        for line in comps.get(name, ()):
            c = _CALL_RE.match(line)
            if c:
                visit(c.group(1), m * int(c.group(2)))

    visit("main" if "main" in comps else next(iter(comps)), 1.0)
    return mult


def _ops(text: str):
    """(multiplier, result types, kind, op, operand types, attrs) of every
    op line, each weighted by how often its computation runs."""
    comps = parse_program(text)
    for cname, m in _multipliers(comps).items():
        for line in comps.get(cname, ()):
            mo = _LINE_RE.match(line)
            if mo:
                res, kind, op, operands, attrs = mo.groups()
                yield (m, _TYPE_RE.findall(res), kind, op,
                       _TYPE_RE.findall(operands), attrs)


def _numel(dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n


def _bytes_of(types) -> int:
    return sum(_numel(d) * _DTYPE_BYTES.get(dt, 4) for dt, d in types)


def _dot_flops(res, attrs: str) -> float:
    mc = re.search(r"contract=(\d+)", attrs)
    return 2.0 * _numel(res[0][1]) * (int(mc.group(1)) if mc else 1)


def analyze_program(text) -> Dict:
    """Per-device dot FLOPs (2·numel(local result)·local contraction) and
    collective bytes (result bytes) of a program, weighted by trip count:
    the port's ``analyze_hlo``, with the reference's keys."""
    flops = 0.0
    coll: Dict[str, float] = {}
    for m, res, kind, _, _, attrs in _ops(_text(text)):
        if kind == "dot":
            flops += m * _dot_flops(res, attrs)
        elif kind in COLLECTIVES:
            coll[kind] = coll.get(kind, 0.0) + m * _bytes_of(res)
    return {"dot_flops_per_device": flops,
            "collective_bytes_per_device": coll,
            "num_computations": len(parse_program(_text(text)))}


def compiled_cost(program) -> Dict[str, float]:
    """FLOPs, bytes accessed and transcendentals per device of a program,
    weighted by trip count (XLA's ``cost_analysis`` counts a while loop's
    body once; a program carries its trip counts). A dot is 2·M·N·K; a
    pointwise op one FLOP an output element; a reduction one an input
    element; a transcendental op (exp, log, tanh, rsqrt, pow, softmax …)
    one transcendental an output element. Every op but a view reads its
    operands once and writes its results once."""
    flops = nbytes = trans = 0.0
    for m, res, kind, _, operands, attrs in _ops(_text(program)):
        if kind == "view":
            continue
        nbytes += m * (_bytes_of(res) + _bytes_of(operands))
        if kind == "dot":
            flops += m * _dot_flops(res, attrs)
        elif kind == "pointwise":
            flops += m * _numel(res[0][1])
        elif kind == "reduce" and operands:
            flops += m * _numel(operands[0][1])
        elif kind == "transcendental":
            trans += m * _numel(res[0][1])
    return {"flops": flops, "bytes_accessed": nbytes,
            "transcendentals": trans}


def compiled_memory(program) -> Dict[str, float]:
    """Argument, output, temp and alias bytes per device from the program's
    ``memory`` line, plus ``peak_bytes`` = argument + output + temp − alias
    (the executable's working set, as the reference computes it)."""
    m = _MEMORY_RE.search(_text(program))
    if not m:
        return {}
    vals = dict(kv.split("=") for kv in m.group(1).split())
    out = {k: float(vals[k]) for k in _MEMORY_KEYS if k in vals}
    out["peak_bytes"] = (out.get("argument_bytes", 0.0)
                         + out.get("output_bytes", 0.0)
                         + out.get("temp_bytes", 0.0)
                         - out.get("alias_bytes", 0.0))
    return out
