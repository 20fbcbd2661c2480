"""Build and load the hand-written CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` compiles with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into its own
shared library under ``kernels/build/`` (listed in ``.gitignore``), named by
a hash of its source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source or header rebuilds. The first
call to :func:`library` compiles every source at once, one ``nvcc`` process
per file, and waits for all of them. Nothing is compiled or loaded at
import time: the CPU tests import every module.

``launches`` holds one plain integer per kernel; each wrapper adds one
(:func:`count_launch`) where it launches its kernel and nowhere else.
Several threads may launch (the serving front-end's pump, its breaker
probes, hot-swap readers): the first build and every count take a lock.

A kernel that cannot be built, loaded or launched raises
:class:`KernelError`. It and the other failures of the device
(:data:`DEVICE_ERRORS`) are no failure of a caller's input: the ingester
re-raises them instead of quarantining the shard, the breakers' probes
and the front-end's worker hand them on instead of serving around them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argtypes of every C entry point, by source; each returns an int (a CUDA
# error code, or a plain value). Every library also exports
# ``const char* kernel_error_string(int)``.
SIGNATURES: dict[str, dict[str, list]] = {
    "rank_build": {
        "rank_build_levels": [_P, _I, _I, _L, _P, _I, _P, _I, _P, _P],
        "rank_build_levels_info": [_P]},
    "wm_level": {
        "wm_counts": [_P, _I, _I, _L, _I, _P, _I, _P],
        "wm_apply": [_P, _I, _I, _L, _I, _I, _P, _P, _P, _L, _P, _I, _L,
                     _P],
        "wm_level_zeros": [_P, _I, _I, _L, _I, _I, _P, _P],
        "wm_level_scan": [_P, _I, _I, _L, _I, _P, _L, _P, _P, _L, _P, _I,
                          _L, _P, _P],
        "wm_level_move": [_P, _I, _I, _L, _I, _P, _L, _P, _P, _L, _P, _I,
                          _L, _P, _P],
        "wm_level_scan_info": [_P],
        "wm_level_move_info": [_P]},
    "wm_quantile": {
        "wm_quantile_info": [_P],
        "wm_quantile_sharded": ([_P] * 3 + [_I] + [_P, _L] * 3 + [_I, _P]
                                + [_I] * 4 + [_P, _I, _I, _P, _P])},
    "radix_rank": {
        "radix_hist": [_P, _I, _I, _L, _I, _P, _I, _P],
        "radix_apply": [_P, _I, _I, _L, _I, _I, _P, _P, _L, _P],
        "radix_totals": [_P, _I, _I, _L, _I, _P, _P],
        "radix_scan": [_P, _I, _I, _L, _I, _P, _L, _P, _L, _P, _P],
        "radix_scan_info": [_P]},
    "wt_level": {
        "wt_level_scan": [_P, _P, _I, _I, _L, _L, _I, _P, _I, _P, _L, _P,
                          _I, _L, _P, _P],
        "wt_level_scan_info": [_P]},
    "bitpack": {
        "bitpack": [_P, _I, _I, _L, _P, _I, _L, _P]},
    "wm_count": {
        "wm_count_sharded": ([_P] * 4 + [_I, _I] + [_P, _L] * 3 + [_I, _P,
                                                                  _I, _P,
                                                                  _P])},
    "topk_greedy": {
        "topk_greedy_plan": [_I, _I, _I, _P],
        "topk_greedy": ([_P, _P, _I, _I] + [_P, _L] * 3 + [_I, _P]
                        + [_I] * 4 + [_P, _L] + [_P] * 4)},
}
SOURCES = tuple(SIGNATURES)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

launches: dict[str, int] = {"rank_build_levels": 0, "wm_level_step": 0,
                            "wm_quantile_sharded": 0, "radix_rank": 0,
                            "wt_level_step": 0, "bitpack": 0,
                            "wm_count": 0, "topk_greedy": 0}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelError(RuntimeError):
    """A CUDA kernel library failed to build or load, or a launch returned
    a CUDA error."""


#: failures of the device, not of a caller's input: a kernel that could not
#: be built, loaded or launched, a CUDA error, or the card's memory running
#: out. No path of the port quarantines, retries past its budget, or serves
#: around them.
DEVICE_ERRORS = (KernelError, torch.AcceleratorError, torch.OutOfMemoryError)


def reset_launches() -> None:
    with _lock:
        for name in launches:
            launches[name] = 0


def stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream, the last
    argument of every C entry (without the ``torch.cuda.Stream`` object
    that ``torch.cuda.current_stream`` builds on each call)."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def count_launch(name: str) -> None:
    """Add one to ``name``'s launch count (wrappers call it where they
    launch the kernel)."""
    with _lock:
        launches[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all() -> dict[str, Path]:
    """Compile every stale source in parallel; returns name -> library.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    stale = {name: t for name, t in targets.items() if not t.exists()}
    if stale:
        nvcc = _nvcc()
        procs = {}
        for name, target in stale.items():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT),
                           tmp, target)
        failures = []
        for name, (proc, tmp, target) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{name}.cu:\n{out.decode(errors='replace')}")
            else:
                os.replace(tmp, target)
        if failures:
            raise KernelError("CUDA kernel build failed:\n"
                               + "\n".join(failures))
    return targets


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on first use),
    its entry points' signatures declared."""
    if name not in _loaded:
        with _lock:
            if name not in _loaded:
                for lib_name, path in build_all().items():
                    if lib_name not in _loaded:
                        _loaded[lib_name] = _load(lib_name, path)
    return _loaded[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise KernelError(f"CUDA kernel {what} failed: {msg} ({err})")
