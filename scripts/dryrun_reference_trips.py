"""The reference's multi-pod dry run on ``Auto`` mesh axes, its collectives
counted with the trip counts of its loops.

The reference counts a cell's collective bytes from its HLO text
(``repro.launch.dryrun.collective_bytes_per_device``) and reads each
loop's trip count from a ``compare ... constant(N)`` in the loop's
condition. Under jax 0.9.0 that compare sits inside a fusion and the layer
scan's loop inside a ``call``, so the layer scan and the microbatch scan
are each counted once. XLA writes every loop's count in the ``while``'s
``backend_config`` (``known_trip_count``); this script lowers each cell as
``scripts/dryrun_reference_auto.py`` does (``jax.make_mesh`` with every
axis ``Auto``, then the reference's own ``run_cell``) and recounts the
collectives with ``repro_torch.launch.dryrun_compare.
collective_bytes_with_trips``, which weighs each computation by the
product of the trip counts around it. A record holds the reference's
fields, the trip-counted ``collective_bytes_per_device``, the reference's
one-trip count as ``collective_bytes_one_trip``, and ``loop_trips``, the
known trip counts of the step's ``while`` loops, outermost first.

    PYTHONPATH=src python scripts/dryrun_reference_trips.py \\
        --arch dbrx_132b --shape train_4k --both-meshes

Records go to ``results/dryrun_ref_trips/`` unless ``--out`` says
otherwise; ``results/dryrun_ref_auto/`` is left as it is.
``--temp-buffers`` adds ``temp_buffers``: the largest values in the step's
largest temporary, from XLA's buffer assignment (what the reference's
plan holds at its peak, beside the port's ``peak_buffers``). Then
``python -m repro_torch.launch.dryrun_compare DIR results/dryrun_ref_trips``
prints both counts beside the port's. It imports the reference, on 512
host devices (1-90 s and about 2 GB of host memory a cell); the port and
``chip_smoke.py`` never do.
"""
import argparse
import json
import os
import re
import shutil
import sys
import tempfile
from pathlib import Path

#: with --temp-buffers XLA dumps each compiled step's buffer assignment
#: here; the flag must be set before the reference imports jax
_DUMP = tempfile.mkdtemp(prefix="xla_dump_") if "--temp-buffers" in sys.argv \
    else None
if _DUMP:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_dump_to={_DUMP}"
                               " --xla_dump_hlo_module_re=.*_step.*")

import repro.launch.dryrun as dryrun   # noqa: E402  (512 host devices)
import jax                             # noqa: E402
from jax.sharding import AxisType      # noqa: E402

from repro.configs.base import (ARCHITECTURES, SHAPES,  # noqa: E402
                                supports_shape)
from repro_torch.launch.dryrun_compare import (  # noqa: E402
    collective_bytes_with_trips, computations, trip_weights)

_make_mesh = jax.make_mesh


def make_auto_mesh(shape, names, **kw):
    """``jax.make_mesh`` with every axis ``Auto`` unless the caller asks."""
    kw.setdefault("axis_types", (AxisType.Auto,) * len(shape))
    return _make_mesh(shape, names, **kw)


def loop_trips(hlo_text: str) -> list:
    """[(loop body, known trip count, times one step enters the loop)] of
    every ``while`` with a known count, by how often its body runs."""
    comps, _ = computations(hlo_text)
    weights = trip_weights(hlo_text)
    out = []
    for name, lines in comps.items():
        for line in lines:
            m = re.search(r"body=%?([\w.\-]+)", line)
            t = re.search(r'"known_trip_count":\{"n":"(\d+)"\}', line)
            if " while(" in line and m and t:
                out.append((m.group(1), int(t.group(1)),
                            weights.get(name, 0)))
    return sorted(out, key=lambda x: x[1] * x[2])


_VALUE_RE = re.compile(r"^\s*value: <\d+ ([^ ]+) @\d+> \(size=(\d+),"
                       r"offset=\d+\): (\S+)")


def temp_buffers(dump_dir: str, top: int = 12) -> list:
    """[(bytes, value name, shape)] of the ``top`` largest values that XLA
    placed in the step's largest preallocated temporary, from the newest
    ``*buffer-assignment.txt`` of ``dump_dir``; removes the dump."""
    files = sorted(Path(dump_dir).glob("*after_optimizations-buffer-"
                                       "assignment.txt"),
                   key=lambda f: f.stat().st_mtime)
    if not files:
        return []
    allocs, current = {}, None
    for line in files[-1].read_text().splitlines():
        if line.startswith("allocation "):
            size = int(re.search(r"size (\d+)", line).group(1))
            current = (size, line) if "preallocated-temp" in line else None
            if current:
                allocs[current] = []
        elif current:
            m = _VALUE_RE.match(line)
            if m:
                allocs[current].append((int(m.group(2)), m.group(1),
                                        m.group(3)))
    shutil.rmtree(dump_dir)
    os.makedirs(dump_dir)
    if not allocs:
        return []
    values = allocs[max(allocs)]
    return sorted(values, reverse=True)[:top]


def record_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    """The reference's cell record, its collectives recounted (and, with
    ``--temp-buffers``, the largest values of its temporaries)."""
    with tempfile.TemporaryDirectory() as tmp:
        hlo_path = Path(tmp) / "cell.hlo.txt"
        res = dryrun.run_cell(arch, shape, multi_pod, save_hlo=hlo_path)
        hlo = hlo_path.read_text()
    res["collective_bytes_one_trip"] = res["collective_bytes_per_device"]
    res["collective_bytes_per_device"] = collective_bytes_with_trips(hlo)
    res["loop_trips"] = loop_trips(hlo)
    if _DUMP:
        res["temp_buffers"] = temp_buffers(_DUMP)
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--shape", nargs="*", default=None)
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", type=Path, default=Path("results/dryrun_ref_trips"))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--temp-buffers", action="store_true",
                    help="also record the largest values of each step's "
                         "largest temporary (XLA's buffer assignment)")
    args = ap.parse_args()
    jax.make_mesh = make_auto_mesh
    args.out.mkdir(parents=True, exist_ok=True)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for arch in args.arch or list(ARCHITECTURES):
        for shape in args.shape or list(SHAPES):
            if not supports_shape(arch, shape):
                continue
            for mp in meshes:
                cid = dryrun.cell_id(arch, shape, mp)
                out = args.out / f"{cid}.json"
                if out.exists() and not args.force:
                    continue
                print(f"=== {cid} ===", flush=True)
                try:
                    res = record_cell(arch, shape, mp)
                except Exception as e:  # noqa: BLE001
                    res = {"arch": arch, "shape": shape, "ok": False,
                           "error": repr(e)[:2000]}
                    print(f"FAILED: {e!r}"[:500], flush=True)
                out.write_text(json.dumps(res, indent=1))
                if res.get("ok"):
                    one = sum(res["collective_bytes_one_trip"].values())
                    trips = sum(res["collective_bytes_per_device"].values())
                    print(f"peak {res['memory']['peak_bytes'] / 1e9:.3f} GB; "
                          f"collectives {trips / 1e9:.2f} GB a step "
                          f"({one / 1e9:.2f} GB one trip a loop); loops "
                          f"{[t[1:] for t in res['loop_trips']]}",
                          flush=True)
    sys.stdout.flush()


if __name__ == "__main__":
    main()
