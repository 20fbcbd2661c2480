"""The port's dry-run plans against the reference's, cell by cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_compare \\
        results/dryrun_torch results/dryrun_ref_trips [--arch dbrx_132b ...]

Reads the cell JSONs of ``python -m repro_torch.launch.dryrun`` (the first
directory) and of the reference's dry run (the second), and prints one
markdown row a cell present in both: the per-device peak of each (the
port's argument + output + temp − alias, the reference's argument + temp,
as each package reports it), their ratio, and the collective GB a step of
each.

The reference's own count (``repro.launch.dryrun.
collective_bytes_per_device``) reads a loop's trip count from a
``compare ... constant(N)`` in its condition. Under jax 0.9.0 the compare
sits in a fusion and the layer scan's loop in a ``call``, so that count
takes every loop body once. ``scripts/dryrun_reference_trips.py`` recounts
each cell's collectives with :func:`collective_bytes_with_trips`: every
computation weighted by the product of the ``known_trip_count`` of the
loops around it, which XLA writes in each ``while``'s ``backend_config``.
Its records keep the one-trip count beside it
(``collective_bytes_one_trip``), and this table prints both. Reads JSON
and HLO text only; imports neither package's model code.
"""
from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

#: a collective's result type and kind, as the reference's count reads it
_COLLECTIVE_RE = re.compile(
    r"=\s*(?:\(?)([a-z0-9]+)\[([0-9,]*)\][^ ]*\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)")

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "u16": 2,
                "s16": 2, "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8,
                "u64": 8}

_HEADER_RE = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*{\s*$")
_WHILE_RE = re.compile(r"\bwhile\(.*?condition=%?([\w.\-]+),\s*"
                       r"body=%?([\w.\-]+)")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALLEE_RE = re.compile(
    r"(?:calls|to_apply|true_computation|false_computation)=%?([\w.\-]+)")
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")


def computations(hlo_text: str) -> tuple[dict, str | None]:
    """({name: instruction lines}, the entry's name) of an HLO module's
    text."""
    comps, entry, current = {}, None, None
    for line in hlo_text.splitlines():
        m = _HEADER_RE.match(line)
        if m:
            current = m.group(2)
            comps[current] = []
            if m.group(1):
                entry = current
        elif line.startswith("}"):
            current = None
        elif current is not None:
            comps[current].append(line)
    return comps, entry


def trip_weights(hlo_text: str) -> dict:
    """{computation: how many times one step runs it}: the entry once, a
    ``while`` body its ``known_trip_count`` times the weight of the
    computation holding the loop (1 where XLA knew no count), and every
    other callee (fusions, calls, reducers, branches) its caller's weight.
    A computation called from several places adds the weights up."""
    comps, entry = computations(hlo_text)
    edges = {name: [] for name in comps}
    for name, lines in comps.items():
        for line in lines:
            w = _WHILE_RE.search(line)
            if w:
                t = _TRIP_RE.search(line)
                edges[name].append((w.group(2), int(t.group(1)) if t else 1))
                edges[name].append((w.group(1), 1))
                continue
            for c in _CALLEE_RE.findall(line):
                edges[name].append((c, 1))
            b = _BRANCHES_RE.search(line)
            if b:
                for c in b.group(1).split(","):
                    edges[name].append((c.strip().lstrip("%"), 1))
    weights: dict = {}

    def visit(name, weight, path):
        if name not in comps or name in path:
            return
        weights[name] = weights.get(name, 0) + weight
        for callee, times in edges[name]:
            visit(callee, weight * times, path | {name})

    if entry is not None:
        visit(entry, 1, frozenset())
    return weights


def collective_bytes_with_trips(hlo_text: str) -> dict:
    """{kind: bytes a device receives a step}, each collective's result
    bytes (the reference's rule: a bf16 all-reduce that XLA:CPU promoted to
    f32 counts at 2 bytes) times the weight of its computation
    (:func:`trip_weights`)."""
    comps, _ = computations(hlo_text)
    weights = trip_weights(hlo_text)
    totals: dict = {}
    for name, lines in comps.items():
        weight = weights.get(name, 0)
        if not weight:
            continue
        for line in lines:
            m = _COLLECTIVE_RE.search(line)
            if not m:
                continue
            dtype, dims, kind = m.groups()
            nbytes = _DTYPE_BYTES.get(dtype, 4)
            if dtype == "f32" and "promoted" in line:
                nbytes //= 2
            numel = 1
            for d in dims.split(","):
                if d:
                    numel *= int(d)
            totals[kind] = totals.get(kind, 0) + numel * nbytes * weight
    return totals


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
    GB, reference collective GB, reference collective GB of one trip or
    None) of every cell ``ok`` in both. The reference's collectives are its
    record's ``collective_bytes_per_device``: trip-counted in the records
    of ``scripts/dryrun_reference_trips.py``, which also keep the one-trip
    count."""
    out = []
    for cid in sorted(port):
        p, r = port[cid], ref.get(cid)
        if archs and cid.split("__")[0] not in archs:
            continue
        if not (p.get("ok") and r and r.get("ok")):
            continue
        pp, rp = p["memory"]["peak_bytes"], r["memory"]["peak_bytes"]
        one = r.get("collective_bytes_one_trip")
        out.append((cid, pp / 1e9, rp / 1e9, pp / rp,
                    sum(p["collective_bytes_per_device"].values()) / 1e9,
                    sum(r["collective_bytes_per_device"].values()) / 1e9,
                    None if one is None else sum(one.values()) / 1e9))
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
          "| port collective GB | reference collective GB "
          "| reference, one trip a loop |")
    print("|---|---|---|---|---|---|---|")
    for cid, pp, rp, ratio, pc, rc, one in rows(
            port, _cells(args.reference), args.arch):
        one = "—" if one is None else f"{one:.2f}"
        print(f"| `{cid}` | {pp:.3f} | {rp:.3f} | {ratio:.3f} | {pc:.2f} "
              f"| {rc:.2f} | {one} |")


if __name__ == "__main__":
    main()
