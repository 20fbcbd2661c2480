"""Read each cell's control on the card: the number the cell's check
compares, with the control in the program's place, on several seeds.

    python3 portbench/control.py --workload lmcorpus.build --seeds 1,2,3

A build cell's control is its reference with one guarantee broken (the
system's ``control_build``), held against the program's build of the same
tokens, which equals the sound reference (its own check, the ``sound``
readings, shows it). A query cell's control is its op's ``control`` (for
quantiles the program's own bracket path, cut one level short), on the
first round of the traffic's batches: as many as a run compares. One JSON
line a seed; the benchmark's runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def readings(root: Path, name: str, seed: int, dev) -> dict:
    import torch
    from portbench import harness
    bench = harness.load_benchmark(root)
    cell, entry = harness.find_cell(bench, name)
    cfg = harness.load_config(root, entry)
    traffic = harness.load_traffic(cell["traffic"])
    system = harness.load_system(cfg["system"])
    toks = harness.corpora(cfg, traffic, seed, dev)[0]
    if traffic["kind"] == "build":
        result = system.build(cfg, toks, dev)
        sound = system.check_build(cfg, toks, result, dev)
        control = system.control_build(cfg, toks, result, dev)
    else:
        op = harness.load_op(traffic["op"])
        engine = system.serve(cfg, toks, dev)
        pool = op.batches(cfg, traffic, seed)
        got, bad = [], []
        for b in pool:
            b = tuple(torch.as_tensor(x, device=dev) for x in b)
            got.append(op.call(engine, *b).cpu().numpy())
            bad.append(op.control(engine, *b).cpu().numpy())
        del engine
        sound = op.check(cfg, toks, pool, got)
        control = op.check(cfg, toks, pool, bad)
    return {"cell": name, "seed": seed, "sound": sound, "control": control,
            "control_correct": all(v <= 0 for v in control.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(ROOT, args.workload, seed, dev)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
