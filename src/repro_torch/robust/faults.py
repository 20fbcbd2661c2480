"""Seedable fault injection and bounded retry: the chaos harness (port of
``repro.robust.faults``).

Four fault surfaces, matching how corruption and stalls reach a serving
engine:

* **In-memory and stored-leaf faults**: flip bits in chosen leaves, either
  of a live structure (``flip_leaf_bit``) or inside a snapshot's
  ``arrays.npz`` (``corrupt_snapshot_leaf`` rewrites the member so the zip
  container stays readable and only the *leaf checksum* catches it: the
  failure mode of silent disk or RAM corruption).
* **File-level faults**: truncate or delete snapshot files and plant stale
  ``.tmp`` partial writes (``truncate_file`` / ``delete_file`` /
  ``delete_step`` / ``inject_partial_tmp``), the crash-mid-write failure
  modes ``checkpoint.latest_step`` must skip over.
* **Crash points**: ``crash_after(step)`` arms a named protocol step;
  instrumented write paths (the ingest commit protocol) call
  ``check_crash_point(step)`` after each step and the armed one raises
  :class:`CrashInjected`, a ``BaseException`` so no ``except Exception``
  handler on the way out can "handle" a simulated process death.
* **Per-shard latency**: ``inject_shard_latency`` arms a delay against one
  shard id; the engines' ``probe_shard`` calls ``shard_latency(s)`` and
  stalls by that much on its clock (the "one slow replica" failure mode
  hedged probes must survive).

Everything takes an explicit seed, and draws the reference's random
numbers in the reference's order: for one seed a fault hits the same leaf,
byte and bit as the reference's (the leaf order and keys are
``checkpoint.flatten``'s, which are the reference's). ``with_retry`` is
the bounded retry with full-jitter exponential backoff under an optional
deadline; all elapsed time and sleeping go through one injectable
``robust.Clock``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import shutil
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import (_SEP, _is_node, _walk,
                                              host_array)

from .clock import SYSTEM_CLOCK, Clock

#: (class name, field) of the port's derived caches that the reference's
#: structures lack: they hold no leaf a fault may pick, and a structure
#: whose leaves changed is made again with the cache reset to None (the
#: engine then takes its kernel operands from the corrupted directories)
_DERIVED_FIELDS = {("ShardedAnalytics", "quantile")}


def _norm(key: str) -> str:
    """Match-friendly leaf path: strip the dots of attribute tokens, so
    ``leaf_match="rank/words"`` matches ``".bitvectors/.rank/.words"``."""
    return key.replace(".", "")


def _derived(tree, name: str) -> bool:
    return (type(tree).__name__, name) in _DERIVED_FIELDS


def _flat_with_keys(tree: Any) -> list:
    """[(path key, leaf, reference dtype or None)] in the reference's
    flattening order (``checkpoint.flatten``'s), the port's derived caches
    left out."""
    return [(_SEP.join(path), leaf, view)
            for path, leaf, view in _walk(tree, (), None)
            if not (path and _derived(tree, path[0][1:]))]


def leaf_keys(tree: Any) -> list:
    return [k for k, _, _ in _flat_with_keys(tree)]


def _flip_bit_in_array(arr: np.ndarray, rng: np.random.Generator
                       ) -> Tuple[np.ndarray, str]:
    """Flip one random bit of one random element; returns (copy, where)."""
    a = np.ascontiguousarray(np.asarray(arr)).copy()
    if a.size == 0:
        return a, "empty leaf (no-op)"
    view = a.view(np.uint8).reshape(-1)
    byte = int(rng.integers(0, view.size))
    bit = int(rng.integers(0, 8))
    view[byte] ^= np.uint8(1 << bit)
    return a, f"byte {byte} bit {bit} of {a.size}×{a.dtype} leaf"


def _replace_leaf(tree, path: tuple, key: str, fn):
    """``tree`` with the leaf at ``key`` replaced by ``fn(leaf)``; the
    derived caches of a changed structure are reset to None."""
    if isinstance(tree, torch.Tensor):
        return fn(tree) if _SEP.join(path) == key else tree
    if isinstance(tree, dict):
        return {k: _replace_leaf(v, path + (str(k),), key, fn)
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        changes = {f.name: _replace_leaf(getattr(tree, f.name),
                                         path + (f".{f.name}",), key, fn)
                   for f in dataclasses.fields(tree)
                   if _is_node(getattr(tree, f.name))
                   and not _derived(tree, f.name)}
        changes.update({f.name: None for f in dataclasses.fields(tree)
                        if _derived(tree, f.name)})
        return dataclasses.replace(tree, **changes)
    return tree


def _flipped_tensor(leaf: torch.Tensor, view, rng: np.random.Generator
                    ) -> Tuple[torch.Tensor, str]:
    """``leaf`` with one bit flipped, on its device. The flip is made in
    the reference's dtype (``view``): the same bytes as the port's (int32
    words are the reference's uint32 ones), the same description."""
    flipped, where = _flip_bit_in_array(host_array(leaf, view), rng)
    if leaf.dtype == torch.bfloat16:
        out = torch.from_numpy(flipped.view(np.int16)).view(torch.bfloat16)
    else:
        out = torch.from_numpy(flipped.view(leaf.numpy(force=True).dtype))
    return out.to(leaf.device), where


def flip_leaf_bit(tree: Any, *, seed: int,
                  leaf_match: Optional[str] = None) -> Tuple[Any, str]:
    """Return a copy of ``tree`` with one bit flipped in one leaf.

    ``leaf_match`` restricts the choice to leaves whose '/'-joined path
    contains the substring (e.g. ``"rank/superblock"``); ``None`` picks
    any leaf. Returns ``(corrupted_tree, description)``, the description
    naming the leaf path, as the reference's does.
    """
    rng = np.random.default_rng(seed)
    flat = _flat_with_keys(tree)
    candidates = [i for i, (k, leaf, _) in enumerate(flat)
                  if (leaf_match is None or _norm(leaf_match) in _norm(k))
                  and leaf.numel() > 0]
    if not candidates:
        raise ValueError(f"no leaf matches {leaf_match!r}")
    key, _, view = flat[candidates[int(rng.integers(0, len(candidates)))]]
    where = []

    def flip(leaf):
        new, w = _flipped_tensor(leaf, view, rng)
        where.append(w)
        return new

    return _replace_leaf(tree, (), key, flip), f"{key}: {where[0]}"


# --------------------------------------------------------------------------
# snapshot-file faults
# --------------------------------------------------------------------------

def _latest_step_dir(ckpt_dir: str | Path) -> Path:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(p for p in ckpt_dir.iterdir()
                   if p.is_dir() and p.name.startswith("step_"))
    if not steps:
        raise FileNotFoundError(f"no step_* under {ckpt_dir}")
    return steps[-1]


def corrupt_snapshot_leaf(ckpt_dir: str | Path, *, seed: int,
                          leaf_match: Optional[str] = None) -> str:
    """Flip one bit of one stored leaf inside ``arrays.npz``, rewriting
    the archive so the zip container stays valid: only the per-leaf crc32
    in ``meta.json`` can catch it (the silent-corruption model)."""
    d = _latest_step_dir(ckpt_dir)
    rng = np.random.default_rng(seed)
    with np.load(d / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    keys = [k for k in arrays
            if (leaf_match is None or _norm(leaf_match) in _norm(k))
            and arrays[k].size]
    if not keys:
        raise ValueError(f"no stored leaf matches {leaf_match!r}")
    key = keys[int(rng.integers(0, len(keys)))]
    arrays[key], where = _flip_bit_in_array(arrays[key], rng)
    np.savez(d / "arrays.npz", **arrays)
    return f"{key}: {where}"


def truncate_file(ckpt_dir: str | Path, name: str = "arrays.npz",
                  keep_frac: float = 0.5) -> Path:
    """Truncate a snapshot file to ``keep_frac`` of its size (torn write)."""
    path = _latest_step_dir(ckpt_dir) / name
    size = path.stat().st_size
    with open(path, "r+b") as f:
        f.truncate(max(1, int(size * keep_frac)))
    return path


def delete_file(ckpt_dir: str | Path, name: str = "meta.json") -> Path:
    """Delete one file of the newest snapshot step (half-deleted dir)."""
    path = _latest_step_dir(ckpt_dir) / name
    path.unlink()
    return path


def delete_step(ckpt_dir: str | Path) -> Path:
    """Remove the newest step directory entirely."""
    d = _latest_step_dir(ckpt_dir)
    shutil.rmtree(d)
    return d


def inject_partial_tmp(ckpt_dir: str | Path, step: int = 99) -> Path:
    """Plant a stale ``.tmp_step_*`` partial write (writer died before
    publishing) plus a bare ``step_*`` directory missing its arrays: both
    must be invisible to ``latest_step``."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "arrays.npz").write_bytes(b"PK\x03\x04 torn")
    bare = ckpt_dir / f"step_{step:08d}"
    bare.mkdir(exist_ok=True)
    (bare / "meta.json").write_text(json.dumps({"step": step}))
    return tmp


# --------------------------------------------------------------------------
# crash-point injection (simulated process death mid-protocol)
# --------------------------------------------------------------------------

class CrashInjected(BaseException):
    """A ``crash_after``-armed step was reached: the simulated SIGKILL.

    A ``BaseException`` on purpose: a real crash is not handled by
    ``except Exception`` cleanup or retry paths, and neither is this one,
    so the injected death leaves the protocol exactly where the armed step
    ends; whatever is on disk at that instant is what recovery sees.
    """

    def __init__(self, step: str):
        self.step = step
        super().__init__(f"injected crash after step {step!r}")


_armed_crash_step: Optional[str] = None


@contextlib.contextmanager
def crash_after(step: Optional[str]):
    """Arm one named protocol step for the scope of the ``with`` block.

    The first ``check_crash_point(step)`` call for the armed step raises
    :class:`CrashInjected` (and disarms, so recovery code running in the
    same process is not killed again). ``None`` arms nothing.
    """
    global _armed_crash_step
    prev = _armed_crash_step
    _armed_crash_step = step
    try:
        yield
    finally:
        _armed_crash_step = prev


def check_crash_point(step: str) -> None:
    """Instrumented protocol steps call this after completing ``step``."""
    global _armed_crash_step
    if _armed_crash_step is not None and _armed_crash_step == step:
        _armed_crash_step = None
        raise CrashInjected(step)


# --------------------------------------------------------------------------
# per-shard latency injection (slow-replica fault model)
# --------------------------------------------------------------------------

_shard_latency: Dict[int, float] = {}


@contextlib.contextmanager
def inject_shard_latency(shard: int, seconds: float):
    """Arm a latency fault against one shard id for the ``with`` scope.

    The engines' ``probe_shard`` calls :func:`shard_latency` and stalls by
    the armed amount on its clock: one slow replica, which hedged probe
    timeouts must turn into degraded coverage instead of queue stalls.
    Nested injections against distinct shards compose.
    """
    prev = _shard_latency.get(shard)
    _shard_latency[shard] = float(seconds)
    try:
        yield
    finally:
        if prev is None:
            _shard_latency.pop(shard, None)
        else:
            _shard_latency[shard] = prev


def shard_latency(shard: int) -> float:
    """Armed extra latency (seconds) for ``shard``; 0.0 when unarmed."""
    return _shard_latency.get(int(shard), 0.0)


# --------------------------------------------------------------------------
# bounded retry / backoff
# --------------------------------------------------------------------------

def with_retry(fn: Callable, *, retries: int = 2, backoff_s: float = 0.05,
               exceptions: Sequence[type] = (Exception,),
               on_retry: Optional[Callable[[int, BaseException], None]]
               = None,
               jitter: bool = True,
               deadline_s: Optional[float] = None,
               rng: Optional[np.random.Generator] = None,
               clock: Clock = SYSTEM_CLOCK):
    """Call ``fn()`` with up to ``retries`` re-attempts, full-jitter
    exponential backoff, and an optional deadline.

    Backoff before attempt ``a+1`` is drawn uniformly from
    ``[0, backoff_s · 2^a]`` (full jitter: a fleet of retriers decorrelates
    instead of retrying in lockstep; ``jitter=False`` takes the cap).
    ``deadline_s`` bounds the total time spent inside this call: once the
    elapsed time reaches it the last exception is re-raised even if the
    retry budget remains, and every sleep is clipped so the deadline is
    never overshot by a backoff. Re-raises the last exception once either
    budget is spent. ``on_retry(attempt, exc)`` runs before each sleep.
    ``rng`` and ``clock`` (elapsed time and sleeping) are injectable; for
    one seeded generator the backoffs are the reference's.
    """
    rng = rng if rng is not None else np.random.default_rng()
    start = clock.now()
    last: BaseException | None = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except tuple(exceptions) as e:          # noqa: PERF203
            last = e
            elapsed = clock.now() - start
            out_of_time = (deadline_s is not None
                           and elapsed >= deadline_s)
            if attempt == retries or out_of_time:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            delay = backoff_s * (2 ** attempt)
            if jitter:
                delay = float(rng.uniform(0.0, delay))
            if deadline_s is not None:
                delay = min(delay, max(0.0, deadline_s - elapsed))
            clock.sleep(delay)
    raise last  # unreachable; keeps type checkers honest
