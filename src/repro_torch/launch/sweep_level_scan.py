"""Tile shapes of the single-pass level scans, timed on the card.

Builds ``csrc/wm_level.cu`` and ``csrc/wt_level.cu`` once for each (threads
per block, 16-byte loads per thread and array) shape, each from a copy of
``csrc/`` whose ``zero_scan.cuh`` constants are rewritten, and times one
matrix level (128 rows of 2^20 keys, as ``chip_smoke.py``) and one tree
level at l = 8 (one row of 2^27 keys, 256 nodes) of each shape by CUDA
events, in two passes of opposite order, after checking its outputs
against the plain versions. Prints the registers, shared memory and
resident blocks per SM of each build and one JSON line per shape.

PYTHONPATH=src python -m repro_torch.launch.sweep_level_scan

Needs a CUDA device and ``nvcc``; there is nothing to measure on the CPU.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess

import torch

from repro_torch.core import bitops
from repro_torch.device import resolve_device
from repro_torch.kernels import build, wm_level, wt_level

SHAPES = ((128, 8), (128, 16), (256, 4), (256, 8), (256, 16), (512, 4),
          (512, 8))
ROWS, N_ROW = 128, 1 << 20
N_TREE, NODES = 1 << 27, 256
SHIFT = 7
REPS = 20


def _build(threads: int, slabs: int) -> dict:
    """name -> loaded library of one tile shape."""
    out = build.BUILD_DIR / "sweep" / f"t{threads}s{slabs}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    head = out / "zero_scan.cuh"
    text = head.read_text()
    text = re.sub(r"kThreads = \d+;", f"kThreads = {threads};", text)
    text = re.sub(r"kSlabs = \d+;", f"kSlabs = {slabs};", text)
    head.write_text(text)
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
         str(out / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for name in ("wm_level", "wt_level")}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}.cu at {threads}x{slabs}:\n"
                               f"{log.decode(errors='replace')}")
        libs[name] = build._load(name, out / f"{name}.so")
    return libs


def _ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> None:
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    keys = torch.randint(0, 256, (ROWS, N_ROW), generator=gen, device=dev,
                         dtype=torch.int32)
    totals = wm_level.wm_level_zeros(keys, SHIFT, 1, N_ROW)[:, 0].contiguous()
    sub = torch.randint(0, 256, (1, N_TREE), generator=gen, device=dev,
                        dtype=torch.int32)
    nid = torch.sort(torch.randint(0, NODES, (1, N_TREE), generator=gen,
                                   device=dev, dtype=torch.int32), 1).values
    starts = wt_level.bucket_starts_plain(sub, nid, SHIFT, 2 * NODES, N_TREE)
    table = wt_level.node_table(starts).contiguous()
    want_wm = wm_level.wm_level_plain(keys, totals, SHIFT, N_ROW)
    want_wt = wt_level.wt_level_plain(sub, nid, SHIFT, 2 * NODES, N_TREE,
                                      starts)
    W, Wt = bitops.num_words(N_ROW), bitops.num_words(N_TREE)

    runs = {}
    for threads, slabs in SHAPES:
        libs = _build(threads, slabs)
        attrs = {}
        for name in ("wm_level", "wt_level"):
            a = (ctypes.c_int * 4)()
            build.check(libs[name], getattr(libs[name],
                                            f"{name}_scan_info")(a), name)
            attrs[name] = list(a)
        # status words for the smallest tile of any shape (1,024 keys)
        status = torch.zeros(ROWS * N_ROW // 1024 + 1, dtype=torch.int64,
                             device=dev)
        status_t = torch.zeros(N_TREE // 1024 + 1, dtype=torch.int64,
                               device=dev)
        dest = torch.empty_like(keys)
        bitmap = torch.empty((ROWS, W), dtype=torch.int32, device=dev)
        zeros = torch.empty(ROWS, dtype=torch.int32, device=dev)
        dest_t = torch.empty_like(sub)
        bitmap_t = torch.empty((1, Wt), dtype=torch.int32, device=dev)

        def wm(lib=libs["wm_level"]):
            status.zero_()
            build.check(lib, lib.wm_level_scan(
                keys.data_ptr(), ROWS, N_ROW, N_ROW, SHIFT,
                totals.data_ptr(), 1, zeros.data_ptr(), dest.data_ptr(),
                N_ROW, bitmap.data_ptr(), W, W, status.data_ptr(), stream),
                "wm_level_scan")

        def wt(lib=libs["wt_level"]):
            status_t.zero_()
            build.check(lib, lib.wt_level_scan(
                sub.data_ptr(), nid.data_ptr(), 1, N_TREE, N_TREE, N_TREE,
                SHIFT, table.data_ptr(), NODES, dest_t.data_ptr(), N_TREE,
                bitmap_t.data_ptr(), Wt, Wt, status_t.data_ptr(), stream),
                "wt_level_scan")

        wm()
        wt()
        torch.cuda.synchronize()
        ok = (torch.equal(dest, want_wm[0]) and torch.equal(bitmap, want_wm[1])
              and torch.equal(zeros, want_wm[2])
              and torch.equal(dest_t, want_wt[0])
              and torch.equal(bitmap_t, want_wt[1]))
        print(f"{threads} threads x {slabs} loads: registers / shared B / "
              f"local B / blocks per SM: wm {attrs['wm_level']}, "
              f"wt {attrs['wt_level']}; equal to the plain versions: {ok}")
        runs[(threads, slabs)] = (wm, wt, ok, attrs)

    times = {shape: [] for shape in runs}
    for order in (list(runs), list(runs)[::-1]):
        for shape in order:
            wm, wt, _, _ = runs[shape]
            times[shape].append((_ms(wm), _ms(wt)))
    for (threads, slabs), t in times.items():
        print(json.dumps({
            "threads": threads, "loads_per_thread": slabs,
            "tile_keys": threads * slabs * 4,
            "wm_level_ms": [x[0] for x in t], "wt_level_ms": [x[1] for x in t],
            "equal": runs[(threads, slabs)][2],
            "wm_attrs": runs[(threads, slabs)][3]["wm_level"],
            "wt_attrs": runs[(threads, slabs)][3]["wt_level"]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
