"""The four phase kernels against a parent commit's designs, timed in
turns on the card.

Builds ``radix_rank.cu`` and ``wm_level.cu`` of a second source tree
(``--parent``: the ``src/repro_torch/kernels/csrc`` directory of a ``git
archive`` of the commit before a redesign) beside this checkout's, each
with ``nvcc -Xptxas -v`` (every phase kernel's registers and spills, and
those of ``radix_scan`` and ``radix_totals``, which share their code), and
calls each kernel's bare C entry, its outputs allocated once, on the inputs
of ``chip_smoke.py``: 2^27 tokens of ``make_corpus(n, 151936, seed=0)``.
``radix_hist`` and ``radix_apply`` take their first big step's digits (the
top 8 of 18 bits, one row, B = 256, most of them in bucket 0) and uniform
digits below 256, ``radix_apply`` with the offsets of their histogram
(``bucket_offsets``); ``wm_counts`` and ``wm_apply`` take the top 8 bits of
128 shards of 2^20 at shift 7, ``wm_apply`` with the scanned block offsets.
Both designs must equal the plain version. Each is timed by CUDA events
over 20 launches in the order old, new, new, old, so that a drift of the
card's clock within the call falls on both; a design's time is the mean of
its two turns. The build path's kernels that share their sources
(``radix_totals``, ``radix_scan``, ``wm_level_zeros``, ``wm_level_scan``)
are timed the same way on the same inputs: they, and any phase kernel
that the two trees share, should time alike in both builds.

It also times ``rank_build_levels`` at L = 1 (one level of one shard,
32,768 words), by its wrapper and by ``torch.profiler`` (the kernel alone),
and the same kernel on one word: the floor that a launch and the kernel's
chain of dependent loads set.

PYTHONPATH=src python -m repro_torch.launch.sweep_phase_kernels \\
    --parent DIR [--out F.json]

Needs a CUDA device and ``nvcc``; there is nothing to measure on the CPU.
"""
from __future__ import annotations

import argparse
import functools
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import bitops
from repro_torch.data import make_corpus
from repro_torch.device import resolve_device
from repro_torch.kernels import build, radix_rank, rank_build, wm_level
from repro_torch.launch.sweep_quantile import event_ms, profiled_ms

N_TOKENS, SIGMA, SHARD_BITS, TAU = 1 << 27, 151_936, 20, 8
NUM_BUCKETS = 1 << TAU
REPS = 20
HBM_BYTES_PER_S = 3.35e12
KERNELS = ("radix_hist_kernel", "radix_apply_kernel", "radix_scan_kernel",
           "radix_totals_kernel", "wm_counts_kernel", "wm_apply_kernel")


def _start(tag: str, csrc: Path, name: str):
    out = build.BUILD_DIR / "sweep_phases" / tag
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"{name}.so"
    proc = subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
         str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    return proc, lib, f"{tag} {name}.cu"


def _ptxas(log: str) -> dict:
    """kernel -> ptxas's registers line (and its spill line) for the
    phase kernels' entry functions in a build's log."""
    found, fn = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            fn = next((k for k in KERNELS if k in entry.group(1)), None)
            if fn and "ILb" in entry.group(1):     # kVec's two forms
                fn += "<true>" if "ILb1E" in entry.group(1) else "<false>"
        elif fn and ("spill" in line or "Used" in line):
            found[fn] = (found.get(fn, "") + " " + line.split(":", 1)[-1]
                         .strip()).strip()
    return found


def _finish(started, name: str):
    proc, lib, tag = started
    log, _ = proc.communicate()
    text = log.decode(errors="replace")
    if proc.returncode:
        raise RuntimeError(f"{tag}:\n{text}")
    return build._load(name, lib), _ptxas(text)


def _turns(old, new) -> dict:
    """old, new, new, old, each over REPS launches."""
    t = [event_ms([old], REPS), event_ms([new], REPS),
         event_ms([new], REPS), event_ms([old], REPS)]
    return {"old_ms": (t[0] + t[3]) / 2, "new_ms": (t[1] + t[2]) / 2,
            "turns_ms": t, "new_over_old": (t[1] + t[2]) / (t[0] + t[3])}


def _case(name: str, libs, run, want, nbytes: int) -> dict:
    """Both designs of one case: ``run(lib, outs)`` launches a library's
    kernel into ``outs``, empty tensors shaped as ``want``; each design
    must equal ``want`` before it is timed."""
    calls = {}
    for tag, lib in libs.items():
        outs = tuple(torch.empty_like(w) for w in want)
        call = functools.partial(run, lib, outs)
        call()
        torch.cuda.synchronize()
        if not all(torch.equal(o, w) for o, w in zip(outs, want)):
            raise SystemExit(f"{name} ({tag}) disagrees with its plain "
                             f"version")
        calls[tag] = call
    return {**_turns(calls["old"], calls["new"]), "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "max_abs_err": 0}


def _radix_cases(libs, digits: torch.Tensor, stream: int) -> dict:
    """radix_hist, then radix_apply with the offsets of that histogram;
    and the build path's radix_totals and radix_scan, which share their
    code, each call with its zeroed totals or status words."""
    rows, n = digits.shape
    nb = (n + radix_rank.BLOCK - 1) // radix_rank.BLOCK
    hist = radix_rank.radix_hist_plain(digits, NUM_BUCKETS, n)

    def run_hist(lib, outs):
        build.check(lib, lib.radix_hist(
            digits.data_ptr(), rows, n, digits.stride(0), NUM_BUCKETS,
            outs[0].data_ptr(), nb, stream), "radix_hist")

    offsets = radix_rank.bucket_offsets(hist)
    dest = radix_rank.radix_apply_plain(digits, offsets, NUM_BUCKETS, n)

    def run_apply(lib, outs):
        build.check(lib, lib.radix_apply(
            digits.data_ptr(), rows, n, digits.stride(0), NUM_BUCKETS, nb,
            offsets.data_ptr(), outs[0].data_ptr(), outs[0].stride(0),
            stream), "radix_apply")

    totals = radix_rank.radix_totals_plain(digits, NUM_BUCKETS, n)

    def run_totals(lib, outs):
        outs[0].zero_()
        build.check(lib, lib.radix_totals(
            digits.data_ptr(), rows, n, digits.stride(0), NUM_BUCKETS,
            outs[0].data_ptr(), stream), "radix_totals")

    starts = radix_rank.exclusive_starts(totals)
    ranked = radix_rank.radix_rank_plain(digits, NUM_BUCKETS, n, starts)
    status = torch.empty(rows * -(-n // radix_rank.TILE) * NUM_BUCKETS + 1,
                         dtype=torch.int32, device=digits.device)

    def run_scan(lib, outs):
        status.zero_()
        build.check(lib, lib.radix_scan(
            digits.data_ptr(), rows, n, digits.stride(0), NUM_BUCKETS,
            starts.data_ptr(), starts.stride(0), outs[0].data_ptr(),
            outs[0].stride(0), status.data_ptr(), stream), "radix_scan")

    return {"radix_hist": _case("radix_hist", libs, run_hist, (hist,),
                                (digits.numel() + hist.numel()) * 4),
            "radix_apply": _case("radix_apply", libs, run_apply, (dest,),
                                 (digits.numel() + dest.numel()
                                  + offsets.numel()) * 4),
            "radix_totals": _case("radix_totals", libs, run_totals,
                                  (totals,),
                                  (digits.numel() + totals.numel()) * 4),
            "radix_scan": _case("radix_scan", libs, run_scan, (ranked,),
                                (digits.numel() + ranked.numel()
                                 + starts.numel()) * 4)}


def _level_cases(libs, keys: torch.Tensor, shift: int, stream: int) -> dict:
    """wm_counts, then wm_apply with the scanned block offsets; and the
    build path's wm_level_zeros and wm_level_scan, whose source changed
    nothing but its neighbours, each call with its zeroed counts or status
    words."""
    rows, n = keys.shape
    counts = wm_level.wm_counts_plain(keys, shift, n)
    nb = counts.shape[1]

    def run_counts(lib, outs):
        build.check(lib, lib.wm_counts(
            keys.data_ptr(), rows, n, keys.stride(0), shift,
            outs[0].data_ptr(), nb, stream), "wm_counts")

    incl = torch.cumsum(counts, 1)
    zexcl, total = (incl - counts).int(), incl[:, -1].int()
    want = wm_level.wm_apply_plain(keys, zexcl, total, shift, n)
    W = want[1].shape[1]

    def run_apply(lib, outs):
        dest, bitmap = outs
        build.check(lib, lib.wm_apply(
            keys.data_ptr(), rows, n, keys.stride(0), shift, nb,
            zexcl.data_ptr(), total.data_ptr(), dest.data_ptr(),
            dest.stride(0), bitmap.data_ptr(), W, bitmap.stride(0),
            stream), "wm_apply")

    width = shift + 1
    zeros = wm_level.wm_level_zeros_plain(keys, 0, width, n)

    def run_zeros(lib, outs):
        outs[0].zero_()
        build.check(lib, lib.wm_level_zeros(
            keys.data_ptr(), rows, n, keys.stride(0), 0, width,
            outs[0].data_ptr(), stream), "wm_level_zeros")

    level = wm_level.wm_level_plain(keys, total, shift, n)
    status = torch.empty(rows * -(-n // wm_level.TILE) + 1,
                         dtype=torch.int64, device=keys.device)

    def run_scan(lib, outs):
        dest, bitmap, got = outs
        status.zero_()
        build.check(lib, lib.wm_level_scan(
            keys.data_ptr(), rows, n, keys.stride(0), shift,
            total.data_ptr(), total.stride(0), got.data_ptr(),
            dest.data_ptr(), dest.stride(0), bitmap.data_ptr(), W,
            bitmap.stride(0), status.data_ptr(), stream), "wm_level_scan")

    return {"wm_counts": _case("wm_counts", libs, run_counts, (counts,),
                               (keys.numel() + counts.numel()) * 4),
            "wm_apply": _case("wm_apply", libs, run_apply, want,
                              keys.numel() * 8 + want[1].numel() * 4
                              + zexcl.numel() * 4),
            "wm_level_zeros": _case("wm_level_zeros", libs, run_zeros,
                                    (zeros,),
                                    (keys.numel() + zeros.numel()) * 4),
            "wm_level_scan": _case("wm_level_scan", libs, run_scan, level,
                                   keys.numel() * 8 + W * rows * 4
                                   + total.numel() * 8)}


def _rank_build_l1(dev) -> dict:
    """rank_build_levels on one row of 32,768 words and of one word: the
    wrapper (CUDA events) and the kernel alone (the profiler)."""
    out = {}
    gen = torch.Generator(device=dev).manual_seed(3)
    for W in (1 << (SHARD_BITS - 5), 1):
        words = torch.randint(-(1 << 31), 1 << 31, (1, W), generator=gen,
                              device=dev, dtype=torch.int32)
        got = rank_build.rank_build_levels(words, W)
        want = rank_build.rank_build_levels_plain(words, W)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"rank_build_levels at W = {W} disagrees")
        nbytes = (W * 4 + got[0].numel() * 4 + got[1].numel() * 2)
        out[f"W={W}"] = {
            "wrapper_ms": event_ms(
                [lambda: rank_build.rank_build_levels(words, W)], REPS),
            "kernel_ms": profiled_ms(
                lambda: rank_build.rank_build_levels(words, W), REPS,
                "rank_build_levels"),
            "bytes": nbytes, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True,
                    help="csrc/ of the parent commit's source tree")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    started = {(tag, name): _start(tag, csrc, name)
               for tag, csrc in (("old", args.parent), ("new", build.CSRC))
               for name in ("radix_rank", "wm_level")}
    libs, ptxas = {}, {"old": {}, "new": {}}
    for (tag, name), s in started.items():
        libs[tag, name], found = _finish(s, name)
        ptxas[tag].update(found)
    print(json.dumps({"ptxas": ptxas}), flush=True)
    stream = build.stream(dev)

    toks = make_corpus(N_TOKENS, SIGMA, seed=0)
    nbits = int(SIGMA - 1).bit_length()
    seq = torch.from_numpy(toks.astype(np.int32)).to(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "card": card,
              "ptxas": ptxas}
    radix_libs = {tag: libs[tag, "radix_rank"] for tag in ("old", "new")}
    digits = (seq >> (nbits - TAU)).contiguous()[None]
    for name, row in _radix_cases(radix_libs, digits, stream).items():
        result[f"{name} corpus"] = row
    gen = torch.Generator(device=dev).manual_seed(1)
    uniform = torch.randint(0, NUM_BUCKETS, (1, N_TOKENS), generator=gen,
                            device=dev, dtype=torch.int32)
    for name, row in _radix_cases(radix_libs, uniform, stream).items():
        result[f"{name} uniform"] = row
    del digits, uniform
    keys = bitops.extract_field(seq.reshape(-1, 1 << SHARD_BITS),
                                nbits - TAU, TAU).to(torch.int32)
    del seq
    result.update(_level_cases(
        {tag: libs[tag, "wm_level"] for tag in ("old", "new")}, keys,
        TAU - 1, stream))
    del keys
    result["rank_build_levels L=1"] = _rank_build_l1(dev)
    for name, row in result.items():
        if isinstance(row, dict) and "new_ms" in row:
            print(f"{name}: old {row['old_ms']:.6f} ms, new "
                  f"{row['new_ms']:.6f} ms (turns {row['turns_ms']}), bound "
                  f"{row['bound_ms']:.6f} ms")
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
