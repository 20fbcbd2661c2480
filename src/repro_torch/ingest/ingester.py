"""Crash-safe incremental shard ingest: the two-phase commit protocol (port
of ``repro.ingest.ingester``).

Per-shard builds are independent (the paper's domain decomposition), so a
streaming corpus grows one shard at a time, and every shard reaches the
serving set through a journaled two-phase commit whose every step is
crash-survivable::

      build (with_retry; permanent failure → QUARANTINE record)
        │
        ▼
      [1] write_tmp   shard npz → shards/.tmp_shard_<gen>.npz
      [2] checksum    per-leaf crc32 (robust.integrity.checksum_flat)
      [3] fsync       file + directory durability barrier
      [4] intent      INTENT journal record (file, n_tokens, crc32 map)
      [5] rename      atomic os.replace → shards/shard_<gen>.npz
      [6] commit      COMMIT journal record: the shard is serveable

A crash after steps 1–3 leaves only a ``.tmp`` orphan (recovery deletes
it; the journal never heard of the shard). A crash after 4 or 5 leaves a
dangling INTENT: recovery quarantines the unpublished file, appends an
ABORT record, and tells the caller the stream offset to re-append from.
Only after step 6 is the generation committed, and then for good (COMMIT ⇒
the file exists and matches its INTENT checksums; ``verify_manifest``
audits exactly that). Generations are monotone and never reused.

The protocol, the journal lines and the shard files are the reference's
byte for byte: a shard is flattened by ``checkpoint.flatten`` (the
reference's keys and dtypes), so either package recovers and serves the
other's directory. What differs: a shard is built on the ingester's
``device`` (CUDA by default) by the port's builders, which take a 1-D row;
a restored shard takes its structure from the placeholder shard (all
``pad_value`` tokens, the filler of quarantined slots) and its leaves come
back through the checkpoint module's dtype views. A kernel that cannot be
built or launched, a CUDA error or the card's memory running out
(``kernels.build.DEVICE_ERRORS``) is not a failure of the shard's data:
it propagates out of the commit (after ``with_retry``'s attempts) and is
never quarantined.

Telemetry (the reference's): the ``ingest.recover`` and ``ingest.commit``
spans, ``ingest.replay``, ``ingest.quarantine{reason}`` and
``ingest.shard_commit{outcome}`` counters, the ``ingest.generation`` gauge
and the ``ingest.corrupt_committed`` / ``ingest.recovered`` events.
"""
from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint.checkpoint import _rebuild, flatten
from repro_torch.device import resolve_device
from repro_torch.kernels.build import DEVICE_ERRORS
from repro_torch.robust.clock import SYSTEM_CLOCK, Clock
from repro_torch.robust.faults import check_crash_point, with_retry
from repro_torch.robust.integrity import (IntegrityError, checksum_flat,
                                          verify_flat)
from repro_torch.tree import tree_map

from .journal import (MANIFEST_NAME, ManifestState, ShardEntry,
                      append_record, load_manifest)

#: the six commit-protocol steps, in order: the crash-point sweep and the
#: recovery matrix iterate exactly this tuple.
COMMIT_STEPS = ("write_tmp", "checksum", "fsync", "intent", "rename",
                "commit")

#: extra crash-able journal append outside the happy path.
QUARANTINE_STEP = "quarantine"


class IngestError(Exception):
    """Unrecoverable ingest-layer failure (no shards, geometry drift)."""


@dataclass
class RecoveryReport:
    """What one journal replay found and did."""
    committed: List[int] = field(default_factory=list)    # gens serveable
    aborted: List[int] = field(default_factory=list)      # INTENT w/o COMMIT
    quarantined: List[int] = field(default_factory=list)  # unserveable gens
    stray_tmps: int = 0
    torn_tail: bool = False
    #: stream offset (token count) the upstream feed must resume from.
    resume_offset: int = 0

    def summary(self) -> str:
        return (f"recovery: {len(self.committed)} committed, "
                f"{len(self.aborted)} aborted, "
                f"{len(self.quarantined)} quarantined, "
                f"{self.stray_tmps} stray tmp(s), "
                f"torn_tail={self.torn_tail}, "
                f"resume@{self.resume_offset}")


def _fsync_path(path: Path) -> None:
    with open(path, "rb+") as f:
        os.fsync(f.fileno())


def _fsync_dir(path: Path) -> None:
    flags = os.O_RDONLY | getattr(os, "O_DIRECTORY", 0)
    fd = os.open(path, flags)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ShardIngester:
    """Journaled streaming ingest of one shard stream into ``directory``.

    ``build_shard(tokens)`` maps a padded (shard_size,) int64 token tensor
    on ``device`` to the shard structure (wavelet matrix, FM index, …).
    Tokens arrive through :meth:`append_tokens` in arbitrary batches;
    whole shards commit as they fill, :meth:`flush` commits the padded
    tail. Construction does not touch the journal: call :meth:`recover`
    first (the startup replay), then resume feeding from
    ``RecoveryReport.resume_offset``.

    Crash model: the in-memory buffer is volatile by design; upstream
    feeds again everything past the last committed or quarantined
    generation. ``retries``/``backoff_s``/``deadline_s`` bound the
    per-shard build (full-jitter backoff on the injectable ``clock``); a
    permanently failing build is quarantined, so the stream keeps flowing
    and serving degrades to coverage < 1. ``commit_seconds`` accumulates
    the host time of each protocol part (build, write, checksum, fsync,
    journal, rename) over the commits of this object.
    """

    def __init__(self, directory: str | Path, build_shard: Callable,
                 shard_bits: int, *, sigma: int, kind: str = "analytics",
                 pad_value: int = 0, token_dtype=np.uint32,
                 seam_overlap: int = 0,
                 retries: int = 2, backoff_s: float = 0.01,
                 deadline_s: Optional[float] = None,
                 clock: Clock = SYSTEM_CLOCK,
                 fsync: bool = True,
                 extra_meta: Optional[dict] = None,
                 device: str | torch.device = "cuda"):
        self.directory = Path(directory)
        self.shards_dir = self.directory / "shards"
        self.quarantine_dir = self.directory / "quarantine"
        self.manifest = self.directory / MANIFEST_NAME
        self.shard_bits = int(shard_bits)
        self.shard_size = 1 << self.shard_bits
        self.sigma = int(sigma)
        self.kind = kind
        self.pad_value = pad_value
        self.token_dtype = np.dtype(token_dtype)
        self.seam_overlap = int(seam_overlap)
        self.retries = retries
        self.backoff_s = backoff_s
        self.deadline_s = deadline_s
        self.clock = clock
        self.fsync = fsync
        self.extra_meta = dict(extra_meta or {})
        self.device = resolve_device(device)
        self._build = build_shard
        self._placeholder = None                 # lazy structure + filler
        self._buf = np.zeros((0,), self.token_dtype)
        self._state = ManifestState()
        self._finalized = False
        self.commit_seconds = {k: 0.0 for k in ("build", "write", "checksum",
                                                "fsync", "journal",
                                                "rename")}
        for d in (self.shards_dir, self.quarantine_dir):
            d.mkdir(parents=True, exist_ok=True)

    # ---- journal-backed state ------------------------------------------
    @property
    def state(self) -> ManifestState:
        return self._state

    @property
    def committed_tokens(self) -> int:
        """Stream offset of the next token to feed (committed and
        quarantined positions: both consumed their upstream data)."""
        return self._state.committed_tokens

    @property
    def next_gen(self) -> int:
        return self._state.next_gen

    # ---- recovery (startup replay) -------------------------------------
    def recover(self, verify_committed: bool = True) -> RecoveryReport:
        """Replay the journal, resolve every crash window, resume.

        * dangling INTENT (no COMMIT): the file, published or still
          ``.tmp``, is quarantined or deleted and an ABORT record appended;
        * stray ``.tmp`` files the journal never heard of are deleted;
        * committed shards are verified again against their INTENT
          checksums (``verify_committed=True``); a corrupt or missing
          committed file is demoted to QUARANTINE, so serving degrades to
          coverage < 1 instead of failing on an acknowledged generation.

        Idempotent: a second replay (or a crash during recovery) converges
        to the same state.
        """
        with obs.span("ingest.recover", dir=str(self.directory)) as sp:
            obs.counter("ingest.replay").inc()
            st = load_manifest(self.directory)
            rep = RecoveryReport(torn_tail=st.torn_tail)
            for e in st.pending:                    # INTENT without COMMIT
                final = self.shards_dir / (e.file or "")
                tmp = self.shards_dir / f".tmp_{e.file}"
                if e.file and final.exists():
                    shutil.move(str(final), str(self.quarantine_dir / e.file))
                if e.file and tmp.exists():
                    tmp.unlink()
                append_record(self.manifest,
                              {"type": "ABORT", "gen": e.gen,
                               "reason": "intent_without_commit"},
                              fsync=self.fsync)
                obs.counter("ingest.quarantine",
                            reason="intent_without_commit").inc()
                rep.aborted.append(e.gen)
                e.status = "aborted"
            known = {f".tmp_{e.file}" for e in st.entries.values() if e.file}
            for t in self.shards_dir.glob(".tmp_shard_*.npz"):
                if t.name not in known:
                    t.unlink()
                    rep.stray_tmps += 1
            if verify_committed:
                for e in st.committed:
                    bad = self._committed_defect(e)
                    if bad:
                        if (self.shards_dir / e.file).exists():
                            shutil.move(str(self.shards_dir / e.file),
                                        str(self.quarantine_dir / e.file))
                        append_record(
                            self.manifest,
                            {"type": "QUARANTINE", "gen": e.gen,
                             "n_tokens": e.n_tokens, "reason": bad,
                             "extra": e.extra}, fsync=self.fsync)
                        obs.counter("ingest.quarantine",
                                    reason="corrupt_committed").inc()
                        obs.event("ingest.corrupt_committed", gen=e.gen,
                                  why=bad)
                        e.status = "quarantined"
                        rep.quarantined.append(e.gen)
            rep.committed = [e.gen for e in st.committed]
            rep.quarantined += [e.gen for e in st.quarantined
                                if e.gen not in rep.quarantined]
            rep.resume_offset = st.committed_tokens
            self._state = st
            sp.set("committed", len(rep.committed))
            sp.set("aborted", len(rep.aborted))
            obs.gauge("ingest.generation").set(float(st.last_gen))
            obs.event("ingest.recovered", **{
                "committed": len(rep.committed),
                "aborted": len(rep.aborted),
                "quarantined": len(rep.quarantined),
                "resume_offset": rep.resume_offset})
            return rep

    def _committed_defect(self, e: ShardEntry) -> str:
        path = self.shards_dir / (e.file or "")
        if not e.file or not path.exists():
            return "committed_file_missing"
        try:
            with np.load(path) as z:
                arrays = {k: z[k] for k in z.files}
        except Exception:                                 # noqa: BLE001
            return "committed_file_unreadable"
        if verify_flat(arrays, e.leaf_crc32):
            return "committed_checksum_mismatch"
        return ""

    # ---- streaming append ----------------------------------------------
    def append_tokens(self, tokens) -> List[int]:
        """Buffer a token batch; commit every whole shard that fills.

        Returns the generations resolved by this call (committed or
        quarantined). A shard's own build failure is quarantined once the
        retry budget is spent; a kernel or CUDA failure raises.
        """
        if self._finalized:
            raise IngestError("ingester already flushed (stream finalized)")
        raw = np.asarray(tokens).reshape(-1)
        if raw.size and (int(raw.min()) < 0
                         or int(raw.max()) >= self.sigma):
            raise ValueError(f"tokens outside [0, {self.sigma})")
        self._buf = np.concatenate([self._buf,
                                    raw.astype(self.token_dtype)])
        gens = []
        while self._buf.size >= self.shard_size:
            head, self._buf = (self._buf[:self.shard_size],
                               self._buf[self.shard_size:])
            gens.append(self._commit_shard(head))
        return gens

    def flush(self) -> List[int]:
        """Commit the partial tail shard (padded with ``pad_value``) and
        finalize the stream. No-op on an empty buffer."""
        gens = []
        if self._buf.size:
            tail, self._buf = self._buf, np.zeros((0,), self.token_dtype)
            gens.append(self._commit_shard(tail))
        self._finalized = True
        return gens

    @property
    def buffered_tokens(self) -> int:
        return int(self._buf.size)

    # ---- the two-phase commit protocol ---------------------------------
    def _shard_extra(self, true_tokens: np.ndarray) -> dict:
        """Per-shard sidecar facts the serving assembly needs (seam
        windows for the text index)."""
        extra = {}
        if self.seam_overlap > 0:
            ov = self.seam_overlap
            extra["head"] = [int(t) for t in true_tokens[:ov]]
            extra["tail"] = [int(t) for t in true_tokens[-ov:]]
        return extra

    def _padded(self, true_tokens: np.ndarray) -> np.ndarray:
        pad = self.shard_size - true_tokens.size
        if pad:
            true_tokens = np.concatenate(
                [true_tokens,
                 np.full(pad, self.pad_value, self.token_dtype)])
        return true_tokens

    def _timed(self, part: str, t0: float) -> float:
        now = time.perf_counter()
        self.commit_seconds[part] += now - t0
        return now

    def _commit_shard(self, true_tokens: np.ndarray) -> int:
        """Run one generation through the 6-step protocol; returns gen."""
        gen = self._state.next_gen
        extra = self._shard_extra(true_tokens)
        with obs.span("ingest.commit", gen=gen,
                      n_tokens=int(true_tokens.size)) as sp:
            t = time.perf_counter()
            try:
                tree = with_retry(
                    lambda: self._built(true_tokens),
                    retries=self.retries, backoff_s=self.backoff_s,
                    deadline_s=self.deadline_s, clock=self.clock)
            except DEVICE_ERRORS:
                raise
            except Exception as e:                            # noqa: BLE001
                # permanent build failure: the stream must keep flowing, so
                # journal the hole and serve around it (coverage < 1)
                append_record(self.manifest,
                              {"type": "QUARANTINE", "gen": gen,
                               "n_tokens": int(true_tokens.size),
                               "reason": f"build_failed: {type(e).__name__}",
                               "extra": extra}, fsync=self.fsync)
                check_crash_point(QUARANTINE_STEP)
                obs.counter("ingest.quarantine", reason="build_failed").inc()
                obs.counter("ingest.shard_commit", outcome="quarantined").inc()
                sp.set("outcome", "quarantined")
                self._state.entries[gen] = ShardEntry(
                    gen=gen, status="quarantined",
                    n_tokens=int(true_tokens.size),
                    reason=f"build_failed: {type(e).__name__}", extra=extra)
                self._state.last_gen = gen
                return gen
            t = self._timed("build", t)

            arrays, dtypes = flatten(tree)
            fname = f"shard_{gen:08d}.npz"
            tmp = self.shards_dir / f".tmp_{fname}"
            np.savez(tmp, **arrays)                                # [1]
            t = self._timed("write", t)
            check_crash_point("write_tmp")
            crcs = checksum_flat(arrays)                           # [2]
            t = self._timed("checksum", t)
            check_crash_point("checksum")
            if self.fsync:                                         # [3]
                _fsync_path(tmp)
                _fsync_dir(self.shards_dir)
            t = self._timed("fsync", t)
            check_crash_point("fsync")
            append_record(self.manifest,                           # [4]
                          {"type": "INTENT", "gen": gen, "file": fname,
                           "n_tokens": int(true_tokens.size),
                           "dtypes": dtypes, "leaf_crc32": crcs,
                           "extra": extra}, fsync=self.fsync)
            t = self._timed("journal", t)
            check_crash_point("intent")
            os.replace(tmp, self.shards_dir / fname)               # [5]
            t = self._timed("rename", t)
            check_crash_point("rename")
            append_record(self.manifest,                           # [6]
                          {"type": "COMMIT", "gen": gen},
                          fsync=self.fsync)
            self._timed("journal", t)
            check_crash_point("commit")
            obs.counter("ingest.shard_commit", outcome="committed").inc()
            obs.gauge("ingest.generation").set(float(gen))
            sp.set("outcome", "committed")
            self._state.entries[gen] = ShardEntry(
                gen=gen, status="committed", file=fname,
                n_tokens=int(true_tokens.size), leaf_crc32=crcs,
                dtypes=dtypes, extra=extra)
            self._state.last_gen = gen
            return gen

    def _built(self, true_tokens: np.ndarray) -> Any:
        """The shard of ``true_tokens`` (padded), built on the device and
        synchronized, so a kernel fault surfaces here."""
        row = torch.from_numpy(self._padded(true_tokens).astype(np.int64))
        tree = self._build(row.to(self.device))
        _sync(self.device)
        return tree

    # ---- shard loading / serving assembly ------------------------------
    def _placeholder_tree(self):
        """Structure-valid filler for quarantined generations, and the
        structure every restored shard takes: a shard built from
        all-``pad_value`` tokens. Served masked out, so its content never
        reaches an answer; it only keeps the stacked structure
        rectangular."""
        if self._placeholder is None:
            self._placeholder = self._built(
                np.zeros((0,), self.token_dtype))
        return self._placeholder

    def shard_tree(self, entry: ShardEntry, verify: bool = True):
        """Load one committed generation's structure on the ingester's
        device (checksum-verified)."""
        if entry.status != "committed":
            return self._placeholder_tree()
        path = self.shards_dir / entry.file
        with np.load(path) as z:
            raw = {k: z[k] for k in z.files}
        if verify:
            bad = verify_flat(raw, entry.leaf_crc32)
            if bad:
                raise IntegrityError(bad, where=str(path))
        try:
            return _rebuild(self._placeholder_tree(), (), raw, entry.dtypes,
                            self.device)
        except KeyError as e:
            raise IntegrityError([str(e)], where=str(path)) from None

    def serve_entries(self) -> List[ShardEntry]:
        """Generation-ordered committed + quarantined entries: the
        position layout of the serveable corpus."""
        return [e for _, e in sorted(self._state.entries.items())
                if e.status in ("committed", "quarantined")]

    def stack(self, entries: List[ShardEntry], verify: bool = True):
        """The shards of ``entries`` stacked on a leading (K,) axis on the
        ingester's device."""
        trees = [self.shard_tree(e, verify=verify) for e in entries]
        return tree_map(lambda *xs: torch.stack(xs), *trees)

    def load_stacked(self, verify: bool = True):
        """(stacked structure, n_tokens, availability mask or None,
        entries).

        Quarantined generations occupy their corpus slot with a masked
        placeholder so serving stays honest about coverage; with no
        quarantine the mask is ``None``."""
        entries = self.serve_entries()
        if not entries:
            raise IngestError(f"no serveable shards under {self.directory}")
        stacked = self.stack(entries, verify=verify)
        avail = [e.status == "committed" for e in entries]
        n = sum(e.n_tokens for e in entries)
        mask = (None if all(avail)
                else torch.tensor(avail, dtype=torch.bool,
                                  device=self.device))
        return stacked, n, mask, entries

    def seam_windows(self, entries: List[ShardEntry]) -> np.ndarray:
        """(S-1, 2·seam_overlap) boundary windows from the per-shard
        head/tail sidecars: what ``index.sharded.seam_windows_from_tokens``
        derives from the raw stream (the tail of every non-final shard is
        full, and slots past the true corpus length stay ``_SEAM_PAD``)."""
        from repro_torch.index.sharded import _SEAM_PAD
        ov = self.seam_overlap
        ns = max(0, len(entries) - 1)
        win = np.full((ns, 2 * ov), _SEAM_PAD, np.int32)
        for i in range(1, len(entries)):
            tail = entries[i - 1].extra.get("tail", [])
            head = entries[i].extra.get("head", [])
            if tail:
                win[i - 1, ov - len(tail):ov] = tail
            if head:
                win[i - 1, ov:ov + len(head)] = head
        return win

    def engine(self, verify: bool = True):
        """The serving engine of this stream's current state:
        ``ShardedAnalytics`` (kind="analytics") or ``ShardedTextIndex``
        (kind="index"), quarantined generations masked unavailable."""
        stacked, n, mask, entries = self.load_stacked(verify=verify)
        if self.kind == "analytics":
            from repro_torch.analytics.engine import ShardedAnalytics
            return ShardedAnalytics(shards=stacked, n=n, sigma=self.sigma,
                                    shard_bits=self.shard_bits,
                                    available=mask)
        if self.kind == "index":
            from repro_torch.index.sharded import ShardedTextIndex
            return ShardedTextIndex(
                shards=stacked,
                seam_windows=torch.from_numpy(
                    self.seam_windows(entries)).to(self.device),
                n=n, sigma=self.sigma, shard_bits=self.shard_bits,
                seam_overlap=self.seam_overlap, available=mask)
        raise IngestError(f"unknown ingest kind {self.kind!r}")


# --------------------------------------------------------------------------
# kind-specific factories (bit-identical to the from-scratch builders)
# --------------------------------------------------------------------------

def analytics_ingester(directory: str | Path, sigma: int, *,
                       shard_bits: int = 16, tau: int = 8,
                       big_step: str = "compose", sample_rate: int = 512,
                       device: str | torch.device = "cuda",
                       **kw) -> ShardIngester:
    """Ingester whose committed stream is bit-identical to
    ``build_sharded_analytics`` over the same tokens (the same per-shard
    builder arguments, the same 0-padding): a shard built alone is the
    same matrix as its row of the batched build."""
    from repro_torch.core.wavelet_matrix import build_wavelet_matrix
    dev = resolve_device(device)

    def build(s):
        return build_wavelet_matrix(s, sigma, tau=tau, big_step=big_step,
                                    sample_rate=sample_rate, device=dev)

    return ShardIngester(directory, build, shard_bits, sigma=sigma,
                         kind="analytics", pad_value=0,
                         token_dtype=np.uint32, device=dev, **kw)


def index_ingester(directory: str | Path, sigma: int, *,
                   shard_bits: int = 14, sample_rate: int = 32,
                   tau: int = 8, big_step: str = "compose",
                   bv_sample_rate: int = 512, backend: str = "counting",
                   seam_overlap: int = 15,
                   device: str | torch.device = "cuda",
                   **kw) -> ShardIngester:
    """Ingester whose committed stream is bit-identical to
    ``build_sharded_index`` over the same tokens (σ-padding, the widened
    σ+1 alphabet, seam windows recorded per shard)."""
    from repro_torch.index.fm_index import build_fm_index
    dev = resolve_device(device)

    def build(s):
        return build_fm_index(s.to(torch.int32), sigma + 1,
                              sample_rate=sample_rate, tau=tau,
                              big_step=big_step,
                              bv_sample_rate=bv_sample_rate,
                              backend=backend, device=dev)

    return ShardIngester(directory, build, shard_bits, sigma=sigma,
                         kind="index", pad_value=sigma,
                         token_dtype=np.int64, seam_overlap=seam_overlap,
                         device=dev, **kw)
