"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload lmcorpus.build --seed 7 \
        --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` the
``breakdown``, and last the ``checks``: each number compared with the
plain reference beside its limit, which also close standard error. Exits
with another code than 0, printing no result, without a CUDA card (or
fewer than the cell asks), and where a module of JAX or of the JAX package
``repro`` was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root in place of this script's folder (whose module names
# would shadow the standard library's), and the port's sources
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
# kernel and compile caches at fixed paths inside the checkout, for the
# libraries that keep one; the port's own CUDA builds go to
# src/repro_torch/kernels/build/
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".portbench_cache" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness
    bench = harness.load_benchmark(ROOT)
    cell, _ = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {torch.cuda.device_count()} CUDA devices, the "
              f"cell asks {cell['chips']}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), dev, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    result = run["result"]
    out = run["out"]
    if "latencies" in out:
        lat = out["latencies"]
        print(f"portbench: {len(lat)} batches, latency median "
              f"{sorted(lat)[len(lat) // 2]:.4f} ms", file=sys.stderr)
    print(f"portbench: {args.workload} seed {args.seed}: {out['attempted']} "
          f"attempted in {out['elapsed']:.3f} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
