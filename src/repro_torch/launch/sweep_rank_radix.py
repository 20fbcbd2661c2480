"""Tile shapes and variants of the single-pass rank-directory and
radix-rank scans, timed on the card.

Builds ``csrc/rank_build.cu`` once for each (threads per block, 16-byte
loads per thread) shape and ``csrc/radix_rank.cu`` once for each number of
warps per block, then once for each other way of its in-warp peer masks
and of its totals count, and for a few ablations of the kept kernels, each
from a copy of ``csrc/`` whose constants are rewritten or whose lines are
edited, all builds at once. Times each on the paths' shapes by CUDA
events, in two passes of opposite order, after checking its outputs
against the plain versions (an ablation computes something else and is
not checked):

- ``rank_build_levels`` at the tree's shape (18 rows of 2^22 words) and the
  matrix path's (2,304 rows of 32,768 words), random words;
- ``radix_scan`` given the bucket starts, and ``radix_totals``, on the
  tree's first big step: the top 8 of 18 bits of a 2^27-token Zipfian
  stream over σ = 151,936 (``make_corpus``, seed 0), 256 buckets, one row;
  peers by ``__match_any_sync``, by one ``__ballot_sync`` per digit bit or
  by a shared-memory ``atomicOr`` of lane bits.

Prints the registers, shared memory and resident blocks per SM of each
build and one JSON line per variant, then the card's name and power limit.

PYTHONPATH=src python -m repro_torch.launch.sweep_rank_radix

Needs a CUDA device and ``nvcc``; there is nothing to measure on the CPU.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess

import numpy as np
import torch

from repro_torch.data import make_corpus
from repro_torch.device import resolve_device
from repro_torch.kernels import build, radix_rank, rank_build

# rank_build_levels: (threads per block, 16-byte loads per thread)
RANK_SHAPES = ((128, 8), (256, 4), (256, 8), (256, 16), (512, 4), (512, 8))
RANK_ABLATIONS = {
    "no look-back": (("lookback::look_back(p.status, t, first, agg, lane)",
                      "0"),),
    "no block-rank stores": (
        ("if (b < p.nblk) blk_out[b]", "if (b < 0) blk_out[b]"),),
    "no superblock stores": (
        ("      if (b < p.nblk)\n        sb_out[b >> 3]",
         "      if (b < 0)\n        sb_out[b >> 3]"),),
}
# radix_scan: warps per block (1,024 digits each), then other ways for a
# lane to find the lanes of its digit, and ablations
RADIX_WARPS = (4, 8, 16)
RADIX_PEERS = """    atomicOr(lanes + d, 1u << lane);
    __syncwarp();
    const unsigned peers = lanes[d];"""
RADIX_EDITS = {
    "peers by __match_any_sync": ((
        RADIX_PEERS,
        "    const unsigned peers = __match_any_sync(0xffffffffu, d);"),),
    "peers by one __ballot_sync a digit bit": ((
        RADIX_PEERS, """    unsigned peers = 0xffffffffu;
    for (int k = 0; k < 32 - __clz(B); ++k) {
      const bool bit = (d >> k) & 1;
      const unsigned b = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? b : ~b;
    }"""),),
    "ablation: no look-back": ((
        "lookback::look_back_column(p.status + b, B, t, first, run)", "0"),),
    "ablation: no peer masks": ((
        RADIX_PEERS, "    const unsigned peers = 1u << lane;"),),
    "ablation: no stores": ((
        "out[32 * r + lane] = dig < B ? cnt[dig] + (v >> 16) : -1;",
        "if (v == -7) out[0] = cnt[dig];"),),
}
# radix_totals: the kept count, and a warp's equal digits merged first
TOTALS_EDITS = {
    "one shared atomic a digit": (),
    "__match_any_sync merge, then shared atomics": ((
        "if (v[g][c] < num_buckets) atomicAdd(hist + v[g][c], 1);", """{
          const unsigned peers = __match_any_sync(0xffffffffu, v[g][c]);
          if ((threadIdx.x & 31) == __ffs(peers) - 1 &&
              v[g][c] < num_buckets)
            atomicAdd(hist + v[g][c], __popc(peers));
        }"""),),
}
TREE_ROWS, TREE_W = 18, 1 << 22
MATRIX_ROWS, MATRIX_W = 2304, 32_768
N_TOKENS, SIGMA, NBITS, TAU = 1 << 27, 151_936, 18, 8
REPS = 20


def _start_build(name: str, tag: str, subs: dict,
                 edits: tuple = ()) -> tuple:
    """Copy ``csrc/`` with ``name``.cu's constants rewritten (and the
    literal ``edits`` (old, new) of an ablation made) and start its nvcc;
    returns (process, library path, tag)."""
    out = build.BUILD_DIR / "sweep_rank_radix" / tag
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    src = out / f"{name}.cu"
    text = src.read_text()
    for const, value in subs.items():
        text, count = re.subn(rf"(constexpr \w+ {const}) = [^;]+;",
                              rf"\1 = {value};", text)
        if count != 1:
            raise RuntimeError(f"{name}.cu: {const} found {count} times")
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}.cu: {old!r} found "
                               f"{text.count(old)} times")
        text = text.replace(old, new)
    src.write_text(text)
    lib = out / f"{name}.so"
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o",
                             str(lib), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, lib, tag


def _finish(name: str, started) -> ctypes.CDLL:
    proc, lib, tag = started
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"{name}.cu at {tag}:\n"
                           f"{log.decode(errors='replace')}")
    return build._load(name, lib)


def _attrs(lib, entry: str) -> list:
    a = (ctypes.c_int * 4)()
    build.check(lib, getattr(lib, entry)(a), entry)
    return list(a)


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


def _variants() -> dict:
    """(kernel, description) -> (source name, build tag, constants, edits,
    tile size or None)."""
    out = {}
    for threads, slabs in RANK_SHAPES:
        out[("rank_build_levels", f"{threads} threads x {slabs} loads")] = (
            "rank_build", f"rank_t{threads}s{slabs}",
            {"kThreads": threads, "kSlabs": slabs}, (), 4 * threads * slabs)
    for name, edits in RANK_ABLATIONS.items():
        out[("rank_build_levels", f"ablation: {name}")] = (
            "rank_build", "rank_" + name.replace(" ", "_"), {}, edits,
            rank_build.TILE)
    for warps in RADIX_WARPS:
        out[("radix_scan", f"{warps} warps")] = (
            "radix_rank", f"scan_w{warps}", {"kScanWarps": warps}, (),
            1024 * warps)
    for name, edits in RADIX_EDITS.items():
        out[("radix_scan", name)] = (
            "radix_rank", "scan_" + re.sub(r"\W+", "_", name), {}, edits,
            radix_rank.TILE)
    for name, edits in TOTALS_EDITS.items():
        out[("radix_totals", name)] = (
            "radix_rank", "totals_" + re.sub(r"\W+", "_", name), {}, edits,
            None)
    return out


def main() -> None:
    dev = resolve_device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    variants = _variants()
    started = {key: _start_build(src, tag, subs, edits)
               for key, (src, tag, subs, edits, _) in variants.items()}

    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = {"tree": (TREE_ROWS, TREE_W), "matrix": (MATRIX_ROWS, MATRIX_W)}
    words = {k: torch.randint(-(1 << 31), 1 << 31, s, generator=gen,
                              device=dev, dtype=torch.int32)
             for k, s in shapes.items()}
    want_rank = {k: rank_build.rank_build_levels_plain(w, w.shape[1])
                 for k, w in words.items()}
    toks = torch.from_numpy(make_corpus(N_TOKENS, SIGMA, seed=0).astype(
        np.int32)).to(dev)
    digits = (toks >> (NBITS - TAU))[None].contiguous()
    del toks
    B = 1 << TAU
    want_totals = radix_rank.radix_totals_plain(digits, B, N_TOKENS)
    starts = radix_rank.exclusive_starts(want_totals)
    want_radix = radix_rank.radix_rank_plain(digits, B, N_TOKENS, starts)
    # status words for the smallest tiles of any variant
    status = torch.zeros(TREE_ROWS * TREE_W // 2048 + 1, dtype=torch.int64,
                         device=dev)
    status_r = torch.zeros(N_TOKENS // 4096 * B + 1, dtype=torch.int32,
                           device=dev)
    dest = torch.empty_like(digits)
    totals = torch.empty_like(want_totals)

    runs = {}
    for key, started_build in started.items():
        src, _, _, _, tile = variants[key]
        lib = _finish(src, started_build)
        checked = not key[1].startswith("ablation")
        fns, ok = {}, True
        if key[0] == "rank_build_levels":
            attrs = _attrs(lib, "rank_build_levels_info")
            for shape, w in words.items():
                rows, W = w.shape
                sb = torch.empty((rows, W // 32), dtype=torch.int32,
                                 device=dev)
                blk = torch.empty((rows, W // 4), dtype=torch.int16,
                                  device=dev)
                used = status[:rows * W // tile + 1]

                def fn(lib=lib, w=w, rows=rows, W=W, sb=sb, blk=blk,
                       used=used):
                    used.zero_()
                    build.check(lib, lib.rank_build_levels(
                        w.data_ptr(), rows, W, W, sb.data_ptr(), W // 32,
                        blk.data_ptr(), W // 4, used.data_ptr(), stream),
                        "rank_build_levels")
                fn()
                torch.cuda.synchronize()
                ok = ok and torch.equal(sb, want_rank[shape][0]) and \
                    torch.equal(blk, want_rank[shape][1])
                fns[shape] = fn
        elif key[0] == "radix_scan":
            attrs = _attrs(lib, "radix_scan_info")
            used = status_r[:N_TOKENS // tile * B + 1]

            def fn(lib=lib, used=used):
                used.zero_()
                build.check(lib, lib.radix_scan(
                    digits.data_ptr(), 1, N_TOKENS, N_TOKENS, B,
                    starts.data_ptr(), B, dest.data_ptr(), N_TOKENS,
                    used.data_ptr(), stream), "radix_scan")
            fn()
            torch.cuda.synchronize()
            ok = torch.equal(dest, want_radix)
            fns["tree"] = fn
        else:
            attrs = None                      # no info entry for the totals

            def fn(lib=lib):
                totals.zero_()
                build.check(lib, lib.radix_totals(
                    digits.data_ptr(), 1, N_TOKENS, N_TOKENS, B,
                    totals.data_ptr(), stream), "radix_totals")
            fn()
            torch.cuda.synchronize()
            ok = torch.equal(totals, want_totals)
            fns["tree"] = fn
        print(f"{key}: registers / shared B / local B / blocks per SM "
              f"{attrs}; equal to the plain version: "
              f"{ok if checked else 'not checked (ablation)'}")
        if checked and not ok:
            raise RuntimeError(f"{key} disagrees with its plain version")
        runs[key] = (fns, ok if checked else None, attrs)

    times = {key: {shape: [] for shape in runs[key][0]} for key in runs}
    for order in (list(runs), list(runs)[::-1]):
        for key in order:
            for shape, fn in runs[key][0].items():
                times[key][shape].append(_ms(fn))
    for key, t in times.items():
        row = {"kernel": key[0], "variant": key[1],
               "tile": variants[key][4]}
        row.update({f"{shape}_ms": v for shape, v in t.items()})
        row.update({"equal": runs[key][1], "attrs": runs[key][2]})
        print(json.dumps(row))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
