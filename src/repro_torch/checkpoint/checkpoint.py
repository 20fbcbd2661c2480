"""Atomic step checkpoints (port of ``repro.checkpoint.checkpoint``).

Layout: ``<dir>/step_<N>/`` holding one ``arrays.npz`` (the flattened
structure, keys '/'-joined paths) and ``meta.json``. Writes go to a
``.tmp`` sibling and are published with an atomic ``os.replace``, so a
preempted writer never leaves a half-checkpoint that ``latest_step`` could
pick up; ``latest_step`` only reports steps that are structurally sound.

The file is the reference's, byte for byte in every leaf:

* paths take the reference's tokens: a dataclass field is ``.name`` (how
  a JAX ``GetAttrKey`` prints), a dict key its string (dict keys sorted,
  as JAX flattens them), a sequence item its index;
* a leaf the port keeps in another integer type of the same width is
  written as the reference's type (``BinaryRank.words`` and
  ``superblock`` as uint32, ``block`` as uint16,
  ``GeneralizedRankSelect.packed`` as uint32) and viewed back on restore,
  so the dtype tag of its checksum is the reference's too;
* bfloat16, which numpy lacks, is written as a raw ``V2`` view with its
  name in ``meta.json``'s ``dtypes``, as the reference writes its
  ``ml_dtypes`` leaves; no ``ml_dtypes`` is needed.

Every save records a per-leaf crc32 (``leaf_crc32``, see
``robust.integrity``); ``restore_checkpoint`` re-hashes what it read and
raises ``IntegrityError`` naming the corrupted leaves (``verify=False``
loads a corrupt state for repair). A structure is a tensor, a dict of
structures or a dataclass whose tensor and dataclass fields are its
children. The restore target is a structure of tensors (``device="meta"``
ones will do) that gives every leaf's path, shape and dtype; ``device``
says where the leaves go, in place of the reference's shardings.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.rank_select import BinaryRank, GeneralizedRankSelect
from repro_torch.device import resolve_device

_SEP = "/"

#: (class, field) → the reference's dtype of a leaf the port holds in the
#: signed integer type of the same width
_REFERENCE_VIEWS = {
    (BinaryRank, "words"): np.dtype(np.uint32),
    (BinaryRank, "superblock"): np.dtype(np.uint32),
    (BinaryRank, "block"): np.dtype(np.uint16),
    (GeneralizedRankSelect, "packed"): np.dtype(np.uint32),
}

_BF16 = "bfloat16"     # numpy has no such type: written as its int16 bits


def _is_node(x) -> bool:
    return (isinstance(x, (torch.Tensor, dict))
            or (dataclasses.is_dataclass(x) and not isinstance(x, type)))


def _walk(tree, path: tuple, view):
    """(path tokens, leaf, reference dtype or None) of every tensor leaf in
    the reference's flattening order."""
    if isinstance(tree, torch.Tensor):
        yield path, tree, view
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),), None)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if _is_node(v):
                yield from _walk(v, path + (f".{f.name}",),
                                 _REFERENCE_VIEWS.get((type(tree), f.name)))


def host_array(leaf: torch.Tensor, view=None) -> np.ndarray:
    """The bytes of a tensor as the reference stores them: a numpy array of
    the reference's dtype (``view``), a ``V2`` view for bfloat16."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.dtype("V2"))
    arr = t.cpu().numpy()
    return arr.view(view) if view is not None else arr


def flatten(tree: Any) -> tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """({path: host array}, {path: dtype name}) of a structure, as the
    reference's ``_flatten`` gives them."""
    out, dtypes = {}, {}
    for path, leaf, view in _walk(tree, (), None):
        key = _SEP.join(path)
        out[key] = host_array(leaf, view)
        dtypes[key] = (_BF16 if leaf.dtype == torch.bfloat16
                       else str(out[key].dtype))
    return out, dtypes


def save_checkpoint(ckpt_dir: str | Path, step: int, state: Any,
                    extra_meta: Optional[dict] = None,
                    keep: int = 3) -> Path:
    """Write an atomic checkpoint; prune to the newest ``keep`` steps."""
    from repro_torch.robust.integrity import checksum_flat
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays, dtypes = flatten(state)
    np.savez(tmp / "arrays.npz", **arrays)
    meta = {"step": int(step), "num_arrays": len(arrays),
            "dtypes": dtypes,
            "leaf_crc32": checksum_flat(arrays),
            "total_bytes": int(sum(a.nbytes for a in arrays.values()))}
    if extra_meta:
        meta.update(extra_meta)
    (tmp / "meta.json").write_text(json.dumps(meta, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    prune_checkpoints(ckpt_dir, keep)
    return final


def step_dir_valid(d: Path, deep: bool = True) -> bool:
    """Is a ``step_*`` directory a complete, readable checkpoint? A missing
    file, a meta that does not parse, a truncated npz, or a ``leaf_crc32``
    map that lacks keys the npz holds (those leaves could not be verified)
    disqualify it; ``deep=False`` does not open the npz."""
    d = Path(d)
    if not (d / "meta.json").exists() or not (d / "arrays.npz").exists():
        return False
    try:
        meta = json.loads((d / "meta.json").read_text())
    except (OSError, json.JSONDecodeError):
        return False
    if deep:
        try:
            with np.load(d / "arrays.npz") as z:
                files = set(z.files)
        except Exception:
            return False
        crcs = meta.get("leaf_crc32")
        if isinstance(crcs, dict) and not files <= set(crcs):
            return False
    return True


def checkpoint_steps(ckpt_dir: str | Path, validate: bool = True) -> list[int]:
    """Steps with a complete checkpoint directory, ascending; with
    ``validate`` the corrupt or partly written ones are left out, so every
    ``step=None`` restore falls back to the newest valid step."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    steps = []
    for p in ckpt_dir.iterdir():
        if not p.name.startswith("step_"):
            continue
        try:
            step = int(p.name[5:])
        except ValueError:
            continue
        if validate and not step_dir_valid(p):
            continue
        if not validate and not (p / "meta.json").exists():
            continue
        steps.append(step)
    return sorted(steps)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = checkpoint_steps(ckpt_dir)
    return steps[-1] if steps else None


def prune_checkpoints(ckpt_dir: str | Path, keep: int) -> None:
    steps = checkpoint_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(Path(ckpt_dir) / f"step_{s:08d}", ignore_errors=True)


def _to_tensor(arr: np.ndarray, saved: Optional[str], want: torch.Tensor,
               key: str, device: torch.device) -> torch.Tensor:
    """The stored array as a tensor of ``want``'s dtype on ``device``: raw
    bytes viewed as their saved dtype, the reference's integer types viewed
    as the port's of the same width, anything else converted."""
    if tuple(arr.shape) != tuple(want.shape):
        raise ValueError(f"shape mismatch for {key!r}: checkpoint "
                         f"{arr.shape} vs target {tuple(want.shape)}")
    arr = np.require(arr, requirements="C")      # keeps 0-d arrays 0-d
    if arr.dtype.kind == "V":
        if saved == _BF16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            return t.to(device=device, dtype=want.dtype)
        arr = arr.view(np.dtype(saved))
    if want.dtype == torch.bfloat16:
        return torch.from_numpy(arr).to(device=device, dtype=want.dtype)
    port = np.dtype(str(want.dtype).removeprefix("torch."))
    if (arr.dtype != port and arr.dtype.kind in "iu" and port.kind in "iu"
            and arr.dtype.itemsize == port.itemsize):
        arr = arr.view(port)
    return torch.from_numpy(np.require(arr.astype(port, copy=False),
                                       requirements="C")).to(device)


def _rebuild(tree, path: tuple, stored: dict, dtypes: dict, device):
    """``tree`` with every leaf replaced by its stored array."""
    if isinstance(tree, torch.Tensor):
        key = _SEP.join(path)
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        return _to_tensor(stored[key], dtypes.get(key), tree, key, device)
    if isinstance(tree, dict):
        return {k: _rebuild(v, path + (str(k),), stored, dtypes, device)
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        changes = {f.name: _rebuild(getattr(tree, f.name),
                                    path + (f".{f.name}",), stored, dtypes,
                                    device)
                   for f in dataclasses.fields(tree)
                   if _is_node(getattr(tree, f.name))}
        return dataclasses.replace(tree, **changes)
    return tree


def restore_checkpoint(ckpt_dir: str | Path, target: Any,
                       step: Optional[int] = None,
                       device: str | torch.device = "cuda",
                       verify: bool = True) -> tuple[Any, dict]:
    """Restore into the structure of ``target`` (tensors, ``device="meta"``
    ones will do), placing every leaf on ``device``. Returns (state,
    meta).

    ``verify`` re-hashes every stored leaf against the ``leaf_crc32`` table
    recorded at save time (when present) and raises
    ``robust.integrity.IntegrityError`` naming the corrupted leaves."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())
    with np.load(d / "arrays.npz") as z:
        raw = {k: z[k] for k in z.files}
    if verify and meta.get("leaf_crc32"):
        from repro_torch.robust.integrity import IntegrityError, verify_flat
        bad = verify_flat(raw, meta["leaf_crc32"])
        if bad:
            raise IntegrityError(bad, where=str(d))
    return _rebuild(target, (), raw, meta.get("dtypes", {}), dev), meta
