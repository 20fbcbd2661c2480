"""Tile shapes and modes of the single-pass level scans, timed on the card.

Builds ``csrc/wm_level.cu`` and ``csrc/wt_level.cu`` once for each (threads
per block, 16-byte loads per thread and array) shape, each from a copy of
``csrc/`` whose ``zero_scan.cuh`` constants are rewritten, and times one
matrix level (128 rows of 2^20 keys, as ``chip_smoke.py``) and one tree
level at l = 8 (one row of 2^27 keys, 256 nodes) of each shape by CUDA
events, in two passes of opposite order, after checking its outputs
against the plain versions. Prints the registers, shared memory and
resident blocks per SM of each build and one JSON line per shape.

``--modes`` times instead the ways a matrix level can move its keys, at
128 rows of 2^20 keys packed as a build packs them (an 8-bit field above a
20-bit position): the dest mode alone (``wm_level``), the dest mode with
one and with two applies of its destinations (``apply_permutation_dest``:
an int64 cast and a ``scatter_`` each; a build that carries the composed
permutation as its own array applies both the field and it), and the move
mode (``wm_level_move``). Each is checked against the plain versions, timed
by CUDA events in turns (A B C D D C B A) and printed in device ms and as a
share of the 8n-byte bound of a level (4 B of key in, 4 B out, the bitmap),
with both kernels' registers and resident blocks per SM; the plain move
(``wm_level_move_plain``) is timed last, once.

PYTHONPATH=src python -m repro_torch.launch.sweep_level_scan [--modes]

Needs a CUDA device and ``nvcc``; there is nothing to measure on the CPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess

import torch

from repro_torch.core import bitops
from repro_torch.core.scan import apply_permutation_dest
from repro_torch.device import resolve_device
from repro_torch.kernels import build, wm_level, wt_level

SHAPES = ((128, 8), (128, 16), (256, 4), (256, 8), (256, 16), (512, 4),
          (512, 8))
ROWS, N_ROW = 128, 1 << 20
N_TREE, NODES = 1 << 27, 256
SHIFT = 7
REPS = 20
HBM_BYTES_PER_S = 3.35e12     # the H100 SXM's data sheet


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


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def compare_modes(dev: torch.device) -> None:
    """The move mode beside the dest mode and the dest mode's applies."""
    low = (N_ROW - 1).bit_length()
    gen = torch.Generator(device=dev).manual_seed(1)
    keys = ((torch.randint(0, 256, (ROWS, N_ROW), generator=gen, device=dev,
                           dtype=torch.int32) << low)
            | torch.arange(N_ROW, dtype=torch.int32, device=dev))
    idx = torch.arange(N_ROW, dtype=torch.int32, device=dev).expand(
        ROWS, N_ROW).contiguous()
    shift = low + SHIFT
    totals = wm_level.wm_level_zeros(keys, shift, 1, N_ROW)[:, 0].contiguous()

    def dest():
        return wm_level.wm_level(keys, totals, shift, N_ROW)

    def dest_scatter():
        d, words, zeros = dest()
        return apply_permutation_dest(keys, d), words, zeros

    def dest_two_scatters():
        d, words, zeros = dest()
        apply_permutation_dest(idx, d)
        return apply_permutation_dest(keys, d), words, zeros

    def move():
        return wm_level.wm_level_move(keys, totals, shift, N_ROW)

    want = wm_level.wm_level_move_plain(keys, totals, shift, N_ROW)
    modes = {"dest": dest, "dest_scatter": dest_scatter,
             "dest_two_scatters": dest_two_scatters, "move": move}
    equal = {}
    for name, fn in modes.items():
        got = fn()
        ref = (wm_level.wm_level_plain(keys, totals, shift, N_ROW)
               if name == "dest" else want)
        equal[name] = all(torch.equal(g, w) for g, w in zip(got, ref))
    attrs = {}
    lib = build.library("wm_level")
    for entry in ("wm_level_scan_info", "wm_level_move_info"):
        a = (ctypes.c_int * 4)()
        build.check(lib, getattr(lib, entry)(a), entry)
        attrs[entry[:-5]] = list(a)
    print(f"registers / shared B / local B / blocks per SM: {attrs}")
    times = {name: [] for name in modes}
    for order in (list(modes), list(modes)[::-1]):
        for name in order:
            times[name].append(_ms(modes[name]))
    words = bitops.num_words(N_ROW)
    bound_ms = ROWS * (8 * N_ROW + 4 * words + 4) / HBM_BYTES_PER_S * 1e3
    for name, t in times.items():
        mean = sum(t) / len(t)
        print(json.dumps({"mode": name, "rows": ROWS, "n": N_ROW,
                          "shift": shift, "device_ms": t,
                          "bound_ms": bound_ms,
                          "share_of_bound_pct": 100 * bound_ms / mean,
                          "equal": equal[name]}))
    plain = _ms(lambda: wm_level.wm_level_move_plain(keys, totals, shift,
                                                     N_ROW))
    print(json.dumps({"mode": "plain_move", "rows": ROWS, "n": N_ROW,
                      "device_ms": [plain], "bound_ms": bound_ms}))
    print(f"card: {_card()}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--modes", action="store_true",
                    help="time the level's modes of moving keys instead "
                         "of the tile shapes")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    if args.modes:
        compare_modes(dev)
        return
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
    print(f"card: {_card()}")


if __name__ == "__main__":
    main()
