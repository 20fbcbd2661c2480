"""Where the time of the full-text index goes on the card.

Builds the index of ``chip_smoke.py``'s step 8 (2^27 tokens of the Zipf
stream, σ = 151,936, 128 shards of 2^20, SA sample rate 32, τ = 8,
compose) and serves its 4,096 patterns. Each phase runs once to warm up
and once more under ``torch.profiler`` (CPU and CUDA activities): the
build from the numpy tokens, one doubling round of the suffix array (the
first, offset 1, on all shards), a count batch and a locate batch (4 hits
a shard). For each it prints the wall time, the device-busy share (the
union of kernel intervals over the wall time), the kernel launches, and
the kernels and operators that took the most device time, then one JSON
line of them all.

PYTHONPATH=src python -m repro_torch.launch.profile_index

Needs a CUDA device; there is nothing to measure on the CPU.
"""
from __future__ import annotations

import json

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.data import make_corpus
from repro_torch.device import resolve_device
from repro_torch.index import build_sharded_index, sample_patterns
from repro_torch.index.bwt import append_sentinel
from repro_torch.index.suffix_array import (_rank_bits, doubling_round,
                                            initial_ranks)
from repro_torch.launch.profile_tree import _busy_us

N = 1 << 27
VOCAB = 151_936
SHARD_BITS = 20
PATTERNS, PATTERN_LEN = 4096, 8
TOP = 12                      # rows printed of each table


def profiled(name: str, fn) -> dict:
    """Wall time, device-busy share and the top kernels and operators of
    one call of ``fn`` after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sw = obs.Stopwatch()
        fn()
        torch.cuda.synchronize()
        wall = sw.lap()
    busy = _busy_us(prof.events()) / 1e6
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"{name}: {wall:.6f} s wall under the profiler, device busy "
          f"{busy:.6f} s ({100 * busy / wall:.1f}%), {launches} kernel "
          f"launches")
    out = {"phase": name, "wall_s": wall, "device_busy_s": busy,
           "kernel_launches": launches}
    for kind in ("kernels", "operators"):
        rows = []
        for e in prof.key_averages():
            on_device = e.device_type == torch.autograd.DeviceType.CUDA
            dev_us = e.self_device_time_total
            if dev_us > 0 and on_device == (kind == "kernels"):
                rows.append((dev_us, e.key, e.count))
        rows.sort(reverse=True)
        total = sum(r[0] for r in rows)
        print(f"  {kind} by self device time, {total / 1e3:.3f} ms in all:")
        for dev_us, key, count in rows[:TOP]:
            print(f"    {dev_us / 1e3:10.3f} ms  {100 * dev_us / total:5.1f}%"
                  f"  {count:6d}x  {key[:80]}")
        out[kind] = [{"name": k[:80], "device_ms": d / 1e3, "calls": c}
                     for d, k, c in rows[:TOP]]
    return out


def main() -> None:
    dev = resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}")
    toks = make_corpus(N, VOCAB, seed=0)
    phases = [profiled("build", lambda: build_sharded_index(
        toks, VOCAB, shard_bits=SHARD_BITS, device=dev))]

    size = 1 << SHARD_BITS
    shards = torch.from_numpy(toks.astype(np.int32)).to(dev).reshape(
        -1, size)
    text = append_sentinel(shards)
    _, rank = initial_ranks(text, VOCAB + 2)
    m = text.shape[-1]
    phases.append(profiled("doubling round 1", lambda: doubling_round(
        rank, 1, _rank_bits(m))))
    del shards, text, rank

    idx = build_sharded_index(toks, VOCAB, shard_bits=SHARD_BITS, device=dev)
    pats, lens = sample_patterns(toks, PATTERNS, PATTERN_LEN, pad=VOCAB,
                                 seed=3)
    pt, lt = torch.from_numpy(pats).to(dev), torch.from_numpy(lens).to(dev)
    phases.append(profiled("count", lambda: idx.count(pt, lt)))
    phases.append(profiled("locate", lambda: idx.locate(pt, lt, 4)))
    print(json.dumps({"profile_index": phases}))


if __name__ == "__main__":
    main()
