"""The port's dry-run plans against the reference's, cell by cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_compare \\
        results/dryrun_torch results/dryrun_ref_auto [--arch dbrx_132b ...]

Reads the cell JSONs of ``python -m repro_torch.launch.dryrun`` (the first
directory) and of the reference's dry run (the second, e.g. from
``scripts/dryrun_reference_auto.py``), and prints one markdown row a cell
present in both: the per-device peak of each (the port's argument + output
+ temp − alias, the reference's argument + temp, as each package reports
it), their ratio, and the collective GB a step of each. The reference's
collective bytes come from its HLO text, whose layer scan may carry no trip
count it can read (``repro.launch.dryrun.collective_bytes_per_device``):
read them as a floor. The first line counts the port's cells ok, failed
and skipped. Reads JSON only; imports neither package's model code.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def _cells(directory: Path) -> dict:
    """{cell id: record} of the cell JSONs in ``directory``."""
    out = {}
    for f in sorted(Path(directory).glob("*__*__*.json")):
        out[f.stem] = json.loads(f.read_text())
    return out


def counts(cells: dict) -> dict:
    """Cells ok, failed and skipped."""
    n = {"ok": 0, "fail": 0, "skip": 0}
    for r in cells.values():
        n["skip" if r.get("skipped") else "ok" if r.get("ok")
          else "fail"] += 1
    return n


def rows(port: dict, ref: dict, archs=None) -> list:
    """(cell id, port peak GB, reference peak GB, ratio, port collective
    GB, reference collective GB) of every cell ``ok`` in both."""
    out = []
    for cid in sorted(port):
        p, r = port[cid], ref.get(cid)
        if archs and cid.split("__")[0] not in archs:
            continue
        if not (p.get("ok") and r and r.get("ok")):
            continue
        pp, rp = p["memory"]["peak_bytes"], r["memory"]["peak_bytes"]
        out.append((cid, pp / 1e9, rp / 1e9, pp / rp,
                    sum(p["collective_bytes_per_device"].values()) / 1e9,
                    sum(r["collective_bytes_per_device"].values()) / 1e9))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("port", type=Path)
    ap.add_argument("reference", type=Path)
    ap.add_argument("--arch", nargs="*", default=None)
    args = ap.parse_args(argv)
    port = _cells(args.port)
    n = counts(port)
    print(f"port cells ok={n['ok']} fail={n['fail']} skip={n['skip']}")
    print("| cell | port peak GB | reference peak GB | port / reference "
          "| port collective GB | reference collective GB |")
    print("|---|---|---|---|---|---|")
    for cid, pp, rp, ratio, pc, rc in rows(port, _cells(args.reference),
                                           args.arch):
        print(f"| `{cid}` | {pp:.3f} | {rp:.3f} | {ratio:.3f} | {pc:.2f} "
              f"| {rc:.2f} |")


if __name__ == "__main__":
    main()
