"""Where the time of one wavelet-tree build goes on the card.

Builds the tree of ``chip_smoke.py``'s corpus (2^27 tokens, σ = 151,936,
τ = 8, radix big step) once to warm up, then once more under
``torch.profiler`` (CPU and CUDA activities), and prints the wall time,
the device-busy share of that build (the union of kernel intervals over
the wall time), and the operators and kernels that took the most device
time.

PYTHONPATH=src python -m repro_torch.launch.profile_tree

Needs a CUDA device; there is nothing to measure on the CPU.
"""
from __future__ import annotations

import json

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core.wavelet_tree import build_wavelet_tree
from repro_torch.data import make_corpus
from repro_torch.device import resolve_device

N = 1 << 27
VOCAB = 151_936
TAU = 8
BIG_STEP = "radix"
TOP = 25                      # rows printed of each table


def _busy_us(events) -> float:
    """Length of the union of the device kernel intervals (µs)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def main() -> None:
    dev = resolve_device("cuda")
    seq = torch.from_numpy(make_corpus(N, VOCAB, seed=0).astype(
        np.int32)).to(dev)

    def run():
        return build_wavelet_tree(seq, VOCAB, tau=TAU, big_step=BIG_STEP,
                                  device=dev)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sw = obs.Stopwatch()
        run()
        torch.cuda.synchronize()
        wall = sw.lap()
    events = prof.events()
    busy = _busy_us(events) / 1e6
    print(f"device: {torch.cuda.get_device_name(0)}; tree build of {N} "
          f"tokens (sigma {VOCAB}, tau {TAU}, {BIG_STEP}) "
          f"under the profiler: {wall:.6f} s wall, device busy {busy:.6f} s "
          f"({100 * busy / wall:.1f}%)")
    tables = {}
    for kind in ("kernels", "operators"):
        rows = []
        for e in prof.key_averages():
            on_device = e.device_type == torch.autograd.DeviceType.CUDA
            dev_us = e.self_device_time_total
            if dev_us > 0 and on_device == (kind == "kernels"):
                rows.append((dev_us, e.key, e.count))
        rows.sort(reverse=True)
        total = sum(r[0] for r in rows)
        print(f"{kind} by self device time, {total / 1e3:.3f} ms in all:")
        for dev_us, key, count in rows[:TOP]:
            print(f"  {dev_us / 1e3:10.3f} ms  {100 * dev_us / total:5.1f}%"
                  f"  {count:6d}x  {key[:90]}")
        tables[kind] = [{"name": k, "device_ms": d / 1e3, "calls": c}
                        for d, k, c in rows[:TOP]]
    print(json.dumps({"wall_s": wall, "device_busy_s": busy, **tables}))


if __name__ == "__main__":
    main()
