"""Per-leaf integrity checksums for snapshots (port of
``repro.robust.integrity``).

A snapshot carries a crc32 of every leaf's stored bytes, tagged with shape
and dtype so a reshaped or re-typed leaf never collides with its own data.
``checkpoint.save_checkpoint`` records them in ``meta.json``;
``restore_checkpoint`` re-hashes what it read and raises
:class:`IntegrityError` naming the corrupted leaves. The hashes are the
reference's: a port structure hashes the bytes and dtype the reference
stores (``checkpoint.flatten``), so the two packages' ``leaf_crc32`` maps of
one structure are equal.
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, List, Mapping

import numpy as np


class IntegrityError(Exception):
    """A snapshot failed checksum verification; ``bad_keys`` holds the
    '/'-joined paths of every leaf whose stored bytes no longer match."""

    def __init__(self, bad_keys: List[str], where: str = "snapshot"):
        self.bad_keys = list(bad_keys)
        super().__init__(
            f"{where}: checksum mismatch on {len(self.bad_keys)} leaf/leaves: "
            f"{', '.join(self.bad_keys[:8])}"
            f"{' …' if len(self.bad_keys) > 8 else ''}")


def checksum_array(arr: Any) -> str:
    """crc32 fingerprint of one array: its raw bytes and a shape/dtype tag.

    A numpy array hashes as it is; a tensor as its bytes in its own dtype
    (``checkpoint.host_array``; bfloat16 as its ``V2`` view, the form
    written to ``arrays.npz``). For the reference's dtypes of a structure's
    leaves, use :func:`tree_checksums`.
    """
    if not isinstance(arr, np.ndarray):
        from repro_torch.checkpoint.checkpoint import host_array
        arr = host_array(arr)
    a = np.ascontiguousarray(arr)
    if a.dtype.kind not in "biufc?":
        a = a.view(np.dtype(f"V{a.dtype.itemsize}"))
    h = zlib.crc32(f"{a.shape}:{a.dtype.str}".encode())
    h = zlib.crc32(a.tobytes(), h)
    return f"{h:08x}"


def checksum_flat(arrays: Mapping[str, Any]) -> Dict[str, str]:
    """Checksums of a flattened {path: array} dict (checkpoint layout)."""
    return {k: checksum_array(v) for k, v in arrays.items()}


def verify_flat(arrays: Mapping[str, Any],
                checksums: Mapping[str, str]) -> List[str]:
    """Arrays against recorded checksums → sorted bad keys. A key missing
    on either side is bad (a dropped or phantom leaf is corruption)."""
    bad = [k for k in checksums if k not in arrays]
    for k, a in arrays.items():
        want = checksums.get(k)
        if want is None or checksum_array(a) != want:
            bad.append(k)
    return sorted(set(bad))


def tree_checksums(tree: Any) -> Dict[str, str]:
    """Per-leaf checksums of a live structure, keyed by path: the
    flattening ``save_checkpoint`` uses, so directly comparable with a
    snapshot's recorded checksums (and with the reference's)."""
    from repro_torch.checkpoint.checkpoint import flatten
    return checksum_flat(flatten(tree)[0])


def _statics(tree, path: str = "") -> list:
    """(path, type, static field values) of every node: the part of a
    structure that is not its leaves (a JAX tree definition's aux data)."""
    import dataclasses
    if isinstance(tree, dict):
        return [(path, "dict", tuple(sorted(tree)))] + [
            s for k in sorted(tree) for s in _statics(tree[k], f"{path}/{k}")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out, static = [], []
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if dataclasses.is_dataclass(v) or isinstance(v, dict):
                out += _statics(v, f"{path}/.{f.name}")
            elif not hasattr(v, "shape"):
                static.append((f.name, v))
        return [(path, type(tree).__name__, tuple(static))] + out
    return []


def trees_identical(a: Any, b: Any) -> bool:
    """True iff two structures have the same nodes, static fields and leaf
    bytes."""
    from repro_torch.checkpoint.checkpoint import flatten
    if _statics(a) != _statics(b):
        return False
    fa, fb = flatten(a)[0], flatten(b)[0]
    return fa.keys() == fb.keys() and all(
        checksum_array(fa[k]) == checksum_array(fb[k]) for k in fa)
