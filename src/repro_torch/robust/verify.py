"""Structural self-checks over succinct structures and the ingest manifest
(port of ``repro.robust.verify``).

Every derived structure (rank directories, select samples, per-level zero
counts, C tables, SA-sample directories) is recomputed from the bitmaps, or
an exact invariant of it is checked, and compared with what the structure
holds. A mismatch localizes corruption to one structure of one level of
one shard and classifies it: ``derived=True`` is repairable in place by
``robust.repair``, ``derived=False`` (the bitmaps themselves, seam windows)
needs a rebuild from the source tokens.

The checks run in numpy on the host, as in the reference: each structure
is copied to the host once, with the reference's dtypes. The FM index's C
check decodes every position of the BWT on the structure's device
(``repair.wm_decode``, one scan a level) where the matrix's directories
passed their checks, and by ``wm_access`` where they did not, so its
verdict is the reference's either way.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import host_array
from repro_torch.core.rank_select import (BLOCK_BITS, BLOCK_WORDS,
                                          SUPERBLOCK_WORDS, BinaryRank,
                                          BinarySelect, BitVector)
from repro_torch.tree import tree_map

_BLOCKS_PER_SB = SUPERBLOCK_WORDS // BLOCK_WORDS


@dataclass(frozen=True)
class Violation:
    """One failed invariant: where, what, and whether repair can fix it."""
    structure: str          # e.g. "shard3/level2/rank.superblock"
    kind: str               # invariant family, e.g. "rank_superblock"
    detail: str
    derived: bool = True    # recomputable from the bitmaps?

    def __str__(self) -> str:
        tag = "derived" if self.derived else "PRIMARY"
        return f"[{tag}] {self.structure}: {self.kind} — {self.detail}"


@dataclass
class VerifyReport:
    violations: List[Violation] = dc_field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def repairable(self) -> bool:
        """True iff every violation touches a derived structure."""
        return all(v.derived for v in self.violations)

    def add(self, structure: str, kind: str, detail: str,
            derived: bool = True) -> None:
        self.violations.append(Violation(structure, kind, detail, derived))

    def extend(self, other: "VerifyReport") -> None:
        self.violations.extend(other.violations)

    def summary(self) -> str:
        if self.ok:
            return "verify: OK"
        head = (f"verify: {len(self.violations)} violation(s), "
                f"{'all repairable' if self.repairable else 'REBUILD NEEDED'}")
        return "\n".join([head] + [f"  {v}" for v in self.violations[:16]])


def _np(x) -> np.ndarray:
    return x if isinstance(x, np.ndarray) else host_array(x)


def _host(tree):
    """A structure with every tensor leaf copied to the host in one pass
    (the verification reads each of them)."""
    return tree_map(lambda x: x.cpu(), tree)


def _u32(x) -> np.ndarray:
    return _np(x).view(np.uint32)


_POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _popcount32(words: np.ndarray) -> np.ndarray:
    """Per-word popcount via a byte table."""
    v = np.ascontiguousarray(words.astype(np.uint32))
    return _POP8[v.view(np.uint8)].reshape(v.shape + (4,)) \
        .sum(axis=-1).astype(np.int64)


def _expected_rank_tables(words: np.ndarray):
    """Jacobson superblock/block tables recomputed from the words."""
    pc = _popcount32(words)
    prefix = np.concatenate([[0], np.cumsum(pc)[:-1]])
    superblock = prefix[::SUPERBLOCK_WORDS]
    blk_prefix = prefix[::BLOCK_WORDS]
    sb_of_blk = np.arange(blk_prefix.shape[0]) // _BLOCKS_PER_SB
    block = blk_prefix - superblock[sb_of_blk]
    return superblock.astype(np.uint32), block.astype(np.uint16)


def _expected_select_samples(words: np.ndarray, n: int, sample_rate: int,
                             zeros: bool) -> np.ndarray:
    """Clark sample hints recomputed (mirror of ``build_binary_select``)."""
    W = words.shape[0]
    nblk = (W + BLOCK_WORDS - 1) // BLOCK_WORDS
    pad = nblk * BLOCK_WORDS - W
    wp = np.concatenate([words, np.zeros(pad, np.uint32)]) if pad else words
    ones = _popcount32(wp.reshape(nblk, BLOCK_WORDS)).sum(axis=1)
    if zeros:
        valid = np.clip(n - np.arange(nblk) * BLOCK_BITS, 0, BLOCK_BITS)
        counts = valid - ones
    else:
        counts = ones
    cum = np.concatenate([[0], np.cumsum(counts)])
    num_samples = n // sample_rate + 2
    targets = np.arange(num_samples) * sample_rate
    return np.clip(np.searchsorted(cum, targets, side="right") - 1,
                   0, nblk - 1).astype(np.int32)


def _padding_bits_zero(words: np.ndarray, n: int) -> bool:
    """Bits at positions ≥ n must be 0 (every directory build assumes it):
    the words past the last and the high bits of the last."""
    W = words.shape[0]
    if n >= W * 32:
        return True
    last, used = divmod(n, 32)
    tail = words[last + 1:] if used else words[last:]
    if tail.any():
        return False
    return not (used and int(words[last]) >> used)


def verify_binary_rank(rank: BinaryRank, name: str,
                       report: VerifyReport | None = None) -> VerifyReport:
    """Superblock/block tables must re-aggregate to bitmap popcounts."""
    report = report if report is not None else VerifyReport()
    words = _u32(rank.words)
    if not _padding_bits_zero(words, rank.n):
        report.add(f"{name}.words", "padding_bits",
                   "nonzero bits past position n", derived=False)
    sb, blk = _expected_rank_tables(words)
    got_sb, got_blk = _u32(rank.superblock), _np(rank.block).view(np.uint16)
    if got_sb.shape != sb.shape or not np.array_equal(got_sb, sb):
        report.add(f"{name}.rank.superblock", "rank_superblock",
                   "does not re-aggregate to bitmap popcounts")
    if got_blk.shape != blk.shape or not np.array_equal(got_blk, blk):
        report.add(f"{name}.rank.block", "rank_block",
                   "does not re-aggregate to bitmap popcounts")
    return report


def verify_binary_select(rank: BinaryRank, sel: BinarySelect, name: str,
                         report: VerifyReport | None = None) -> VerifyReport:
    """Every sample must point at the block holding its target bit."""
    report = report if report is not None else VerifyReport()
    want = _expected_select_samples(_u32(rank.words), sel.n, sel.sample_rate,
                                    sel.zeros)
    got = _np(sel.sample)
    if got.shape != want.shape or not np.array_equal(got, want):
        which = "sel0" if sel.zeros else "sel1"
        report.add(f"{name}.{which}.sample", "select_sample",
                   "sample hints disagree with recomputed block positions")
    return report


def verify_bitvector(bv: BitVector, name: str,
                     report: VerifyReport | None = None) -> VerifyReport:
    report = report if report is not None else VerifyReport()
    verify_binary_rank(bv.rank, name, report)
    verify_binary_select(bv.rank, bv.sel1, name, report)
    verify_binary_select(bv.rank, bv.sel0, name, report)
    return report


def _level_bv(bitvectors: BitVector, l: int) -> BitVector:
    return tree_map(lambda x: x[l], bitvectors)


def verify_wavelet_matrix(wm, name: str = "wm",
                          report: VerifyReport | None = None) -> VerifyReport:
    """All per-level directories and ``zeros`` must derive from the bitmaps.

    Attribution uses the violation pattern: corruption of one directory
    leaf breaks at most one derived family of a level, a corrupt bitmap
    usually several at once (``zeros`` always). Two or more families off →
    the level's bitmap is reported (primary, rebuild). Snapshots also carry
    per-leaf checksums, which name the corrupted leaf exactly."""
    report = report if report is not None else VerifyReport()
    wm = _host(wm)
    zeros = _np(wm.zeros)
    if zeros.shape != (wm.nbits,):
        report.add(f"{name}.zeros", "shape",
                   f"expected ({wm.nbits},), got {zeros.shape}")
        return report
    for l in range(wm.nbits):
        bv = _level_bv(wm.bitvectors, l)
        lname = f"{name}/level{l}"
        sub = VerifyReport()
        verify_bitvector(bv, lname, sub)
        ones = int(_popcount32(_u32(bv.rank.words)).sum())
        if int(zeros[l]) != wm.n - ones:
            sub.add(f"{name}.zeros[{l}]", "zeros",
                    f"stored {int(zeros[l])}, bitmap says {wm.n - ones}")
        fams = {v.kind for v in sub.violations
                if v.kind in ("rank_superblock", "rank_block",
                              "select_sample", "zeros")}
        if len(fams) >= 2:
            report.add(f"{lname}.words", "bitmap_suspect",
                       f"{len(fams)} independent derived families disagree "
                       "with this level's bitmap at once — the bitmap "
                       "itself is the likely corruption", derived=False)
        else:
            report.extend(sub)
    return report


def verify_wavelet_tree(wt, name: str = "wt",
                        report: VerifyReport | None = None) -> VerifyReport:
    """Per-level directories, and ``node_starts`` rows non-decreasing, row
    0 starting at 0, every entry in [0, n]."""
    report = report if report is not None else VerifyReport()
    wt = _host(wt)
    for l in range(wt.nbits):
        verify_bitvector(_level_bv(wt.bitvectors, l), f"{name}/level{l}",
                         report)
    ns = _np(wt.node_starts)
    if ns[0, 0] != 0:
        report.add(f"{name}.node_starts", "node_starts_origin",
                   f"row 0 starts at {int(ns[0, 0])}, want 0")
    if ns.min() < 0 or ns.max() > wt.n:
        report.add(f"{name}.node_starts", "node_starts_range",
                   "entries outside [0, n]")
    for l in range(ns.shape[0]):
        row = ns[l, :max(1, min(1 << l, ns.shape[1]))]
        if np.any(np.diff(row) < 0):
            report.add(f"{name}.node_starts[{l}]", "node_starts_monotone",
                       "row not non-decreasing")
    return report


def _symbol_histograms(wm, sigma_work: int) -> torch.Tensor:
    """(*B, σ+1) histogram of every BWT symbol of a matrix (or stack),
    decoded on its device by ``repair.wm_decode``."""
    from .repair import wm_decode
    syms = wm_decode(wm).clamp(max=sigma_work)
    lead = syms.shape[:-1]
    rows = syms.reshape(-1, syms.shape[-1])
    flat = (torch.arange(rows.shape[0], device=rows.device)[:, None]
            * (sigma_work + 1) + rows).reshape(-1)
    hist = torch.bincount(flat, minlength=rows.shape[0] * (sigma_work + 1))
    return hist.reshape(lead + (sigma_work + 1,))[..., :sigma_work]


def verify_fm_index(fm, name: str = "fm",
                    report: VerifyReport | None = None,
                    _hist: np.ndarray | None = None) -> VerifyReport:
    """FM-index invariants: the matrix directories over the BWT bitmaps;
    ``C`` the exclusive cumsum of the symbol histogram the bitmaps encode;
    the mark directory holding exactly ⌈m/rate⌉ set bits and re-aggregating
    like any rank directory; ``sa_sample`` exactly {0, rate, 2·rate, …}."""
    from repro_torch.core.wavelet_matrix import wm_access
    report = report if report is not None else VerifyReport()
    sub = VerifyReport()
    verify_wavelet_matrix(fm.wm, f"{name}/wm", sub)
    report.extend(sub)
    m = fm.m
    if sub.ok and _hist is not None:
        hist = _hist
    elif sub.ok:
        hist = _symbol_histograms(fm.wm, fm.sigma + 1).cpu().numpy()
    else:       # directories off the bitmaps: decode through them
        syms = wm_access(fm.wm, torch.arange(
            m, device=fm.wm.zeros.device)).cpu().numpy()
        hist = np.bincount(syms, minlength=fm.sigma + 1)[:fm.sigma + 1]
    want_C = np.concatenate([[0], np.cumsum(hist)]).astype(np.int64)
    got_C = _np(fm.C).astype(np.int64)
    if got_C.shape != want_C.shape or not np.array_equal(got_C, want_C):
        report.add(f"{name}.C", "c_table",
                   "C[] inconsistent with bitmap-derived symbol histogram")
    verify_binary_rank(fm.mark, f"{name}/mark", report)
    num_samples = (m + fm.sample_rate - 1) // fm.sample_rate
    marked = int(_popcount32(_u32(fm.mark.words)).sum())
    if marked != num_samples:
        report.add(f"{name}.mark", "mark_count",
                   f"{marked} marked rows, want {num_samples}")
    got = np.sort(_np(fm.sa_sample))
    want = np.arange(num_samples) * fm.sample_rate
    if got.shape != want.shape or not np.array_equal(got, want):
        report.add(f"{name}.sa_sample", "sa_sample_multiset",
                   "values are not exactly {0, rate, 2·rate, …}")
    return report


def verify_analytics(engine, report: VerifyReport | None = None
                     ) -> VerifyReport:
    """Structural verification of every shard of a ``ShardedAnalytics``."""
    report = report if report is not None else VerifyReport()
    shards = _host(engine.shards)
    for s in range(engine.num_shards):
        verify_wavelet_matrix(tree_map(lambda x: x[s], shards), f"shard{s}",
                              report)
    if engine.available is not None:
        av = _np(engine.available)
        if av.shape != (engine.num_shards,):
            report.add("available", "mask_shape",
                       f"mask shape {av.shape} vs {engine.num_shards} shards")
    return report


def verify_manifest(ingest_dir, report: VerifyReport | None = None,
                    deep: bool = True) -> VerifyReport:
    """Self-checks over an ingest directory's journaled shard manifest.

    The manifest is the write path's source of truth, so its invariants
    get the same treatment the serving structures get: recompute what
    each record claims and classify every violation (the reference's
    kinds and classes):

    * **journal integrity** — a torn tail (single crashed append) is
      repairable (recovery drops it and upstream re-appends); a bad line
      before the tail is fatal corruption;
    * **generation monotonicity** — every INTENT/QUARANTINE must
      introduce a strictly increasing generation (the journal is a total
      order of the stream); violation is fatal;
    * **COMMIT ⇒ shard exists** — a committed generation whose file is
      missing is acked data loss: fatal;
    * **COMMIT ⇒ checksums agree** — ``deep=True`` re-hashes every
      committed shard file against its INTENT ``leaf_crc32`` map;
      disagreement is *repairable by re-append* (upstream replays the
      generation under a fresh gen — recovery quarantines it meanwhile);
    * **dangling INTENT** — an unresolved INTENT (no COMMIT/ABORT) means
      recovery has not run yet: repairable.
    """
    from pathlib import Path

    from repro_torch.ingest.journal import (MANIFEST_NAME, JournalCorrupt,
                                            read_journal, replay)
    from repro_torch.robust.integrity import verify_flat
    report = report if report is not None else VerifyReport()
    ingest_dir = Path(ingest_dir)
    journal = ingest_dir / MANIFEST_NAME
    try:
        records, torn = read_journal(journal, strict=True)
    except JournalCorrupt as e:
        report.add("manifest.jsonl", "journal_corrupt",
                   f"line {e.lineno}: {e.why} (before the tail — not a "
                   "crash artifact)", derived=False)
        records, torn = read_journal(journal, strict=False)
    if torn:
        report.add("manifest.jsonl", "journal_torn_tail",
                   "last line incomplete or checksum-failing — crashed "
                   "append; replay drops it")
    last_intro = -1
    for i, rec in enumerate(records):
        if rec["type"] in ("INTENT", "QUARANTINE") \
                and rec.get("gen", -1) not in \
                {r.get("gen") for r in records[:i]
                 if r["type"] in ("INTENT", "QUARANTINE")}:
            gen = int(rec.get("gen", -1))
            if gen <= last_intro:
                report.add(f"manifest.jsonl[{i}]", "generation_monotonicity",
                           f"record introduces gen {gen} after gen "
                           f"{last_intro}", derived=False)
            last_intro = max(last_intro, gen)
    st = replay(records, torn_tail=torn)
    shards_dir = ingest_dir / "shards"
    for e in st.committed:
        path = shards_dir / (e.file or "")
        if not e.file or not path.exists():
            report.add(f"gen{e.gen}", "commit_missing_shard",
                       f"COMMIT recorded but {e.file!r} is absent — acked "
                       "data loss", derived=False)
            continue
        if not deep:
            continue
        try:
            with np.load(path) as z:
                arrays = {k: z[k] for k in z.files}
        except Exception:                                 # noqa: BLE001
            report.add(f"gen{e.gen}", "commit_shard_unreadable",
                       f"{e.file} is not a readable npz — re-append")
            continue
        bad = verify_flat(arrays, e.leaf_crc32)
        if bad:
            report.add(f"gen{e.gen}", "commit_checksum_mismatch",
                       f"{len(bad)} leaf/leaves disagree with the INTENT "
                       f"crc32 map ({bad[0]}, …) — re-append")
    for e in st.pending:
        report.add(f"gen{e.gen}", "dangling_intent",
                   "INTENT without COMMIT/ABORT — recovery has not "
                   "replayed this journal yet")
    return report


def verify_sharded_index(idx, report: VerifyReport | None = None
                         ) -> VerifyReport:
    """Structural verification of every shard of a ``ShardedTextIndex``,
    and the seam windows' symbol range (seam windows are primary data).
    Every shard's BWT is decoded in one batch on the index's device."""
    report = report if report is not None else VerifyReport()
    hist = _symbol_histograms(idx.shards.wm,
                              idx.shards.sigma + 1).cpu().numpy()
    shards = _host(idx.shards)
    for s in range(idx.num_shards):
        verify_fm_index(tree_map(lambda x: x[s], shards), f"shard{s}",
                        report, _hist=hist[s])
    seams = _np(idx.seam_windows)
    if seams.size and (seams.min() < -2 or seams.max() >= idx.sigma):
        report.add("seam_windows", "seam_range",
                   "window symbols outside [-2, sigma)", derived=False)
    return report
