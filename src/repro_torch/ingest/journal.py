"""Append-only journaled shard manifest (``manifest.jsonl``; port of
``repro.ingest.journal``, the same encoding: a record's ``crc32`` and its
line are byte for byte the reference's).

The write-path twin of the checkpoint layer's torn-write discipline: every
durable fact about the ingest stream is one JSON line stamped with a
crc32 over its canonical encoding, appended with an fsync, and never
rewritten. Replay reconstructs the manifest state from the record
sequence; a torn *tail* line (the single writer died mid-append) is
detected by the checksum and dropped, while a bad line anywhere *before*
the tail is real corruption and surfaces as :class:`JournalCorrupt` —
the append-only contract means only the last line can legitimately be
incomplete.

Record types (the commit protocol in ``ingest.ingester`` emits them):

* ``INTENT``     — a shard file is fully written, checksummed and fsynced
  under its ``.tmp`` name; carries the generation, target file name, true
  token count, per-leaf crc32 map and builder geometry. Published *before*
  the atomic rename so a crash between rename and COMMIT is recoverable.
* ``COMMIT``     — the rename happened; the shard at this generation is
  durable and serveable. COMMIT ⇒ the shard file exists and matches the
  INTENT checksums (``robust.verify.verify_manifest`` enforces it).
* ``QUARANTINE`` — the shard build failed permanently (retry budget or
  deadline exhausted) or a committed file was later found corrupt; the
  generation's positions are served as unavailable (coverage < 1).
* ``ABORT``      — written by recovery for an INTENT with no COMMIT: the
  crash window left the shard unpublished or unverifiable, its file was
  quarantined/deleted, and upstream must re-append from the last
  committed offset.

Generations are monotone: every INTENT/QUARANTINE introduces
``last_gen + 1``, so the journal itself is a total order of the stream.
"""
from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

MANIFEST_NAME = "manifest.jsonl"

#: record types the replay understands, in no particular order.
RECORD_TYPES = ("INTENT", "COMMIT", "QUARANTINE", "ABORT")


class JournalCorrupt(Exception):
    """A manifest line *before* the tail failed to parse or checksum —
    append-only journals can only be torn at the end, so this is real
    corruption, not a crash artifact."""

    def __init__(self, path, lineno: int, why: str):
        self.path, self.lineno, self.why = str(path), lineno, why
        super().__init__(f"{path}:{lineno}: {why}")


def _canonical(rec: dict) -> bytes:
    """Canonical encoding the crc covers: sorted keys, no whitespace,
    ``crc32`` field excluded."""
    body = {k: v for k, v in rec.items() if k != "crc32"}
    return json.dumps(body, sort_keys=True, separators=(",", ":")).encode()


def record_crc(rec: dict) -> str:
    return f"{zlib.crc32(_canonical(rec)):08x}"


def append_record(journal: str | Path, rec: dict, *,
                  fsync: bool = True) -> dict:
    """Append one checksummed record line (``\\n``-terminated) and fsync.

    Returns the record as written (with its ``crc32`` stamp). The append
    is a single ``write`` of one line, so a crash can only tear the tail.
    """
    if rec.get("type") not in RECORD_TYPES:
        raise ValueError(f"unknown record type {rec.get('type')!r} "
                         f"(expected one of {RECORD_TYPES})")
    rec = dict(rec)
    rec["crc32"] = record_crc(rec)
    line = json.dumps(rec, sort_keys=True, separators=(",", ":")) + "\n"
    journal = Path(journal)
    journal.parent.mkdir(parents=True, exist_ok=True)
    with open(journal, "a", encoding="utf-8") as f:
        f.write(line)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    return rec


def read_journal(journal: str | Path, *, strict: bool = True
                 ) -> Tuple[List[dict], bool]:
    """Replay-read the manifest → ``(records, torn_tail)``.

    A final line that is incomplete, unparseable, or checksum-failing is
    the torn tail of a crashed append: it is dropped and reported via
    ``torn_tail=True``. The same defect on any earlier line raises
    :class:`JournalCorrupt` (``strict=False`` instead stops replay at the
    bad line and reports it torn — the verify path uses this to keep
    scanning for other violations).
    """
    journal = Path(journal)
    if not journal.exists():
        return [], False
    raw = journal.read_text(encoding="utf-8", errors="replace")
    lines = raw.split("\n")
    # a well-formed journal ends with "\n" → last split element is ""
    if lines and lines[-1] == "":
        lines.pop()
    records: List[dict] = []
    for i, line in enumerate(lines):
        bad: Optional[str] = None
        rec = None
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            bad = "unparseable line"
        if bad is None and not isinstance(rec, dict):
            bad = "record is not an object"
        if bad is None and rec.get("crc32") != record_crc(rec):
            bad = "record crc32 mismatch"
        if bad is None and rec.get("type") not in RECORD_TYPES:
            bad = f"unknown record type {rec.get('type')!r}"
        if bad is not None:
            if i == len(lines) - 1:
                return records, True            # torn tail: drop + report
            if strict:
                raise JournalCorrupt(journal, i + 1, bad)
            return records, True                # verify mode: stop here
        records.append(rec)
    return records, False


# --------------------------------------------------------------------------
# replay → manifest state
# --------------------------------------------------------------------------

@dataclass
class ShardEntry:
    """One generation's durable fate after replay."""
    gen: int
    status: str                    # "committed" | "quarantined" | "aborted"
    #                                | "pending" (INTENT with no resolution)
    file: Optional[str] = None
    n_tokens: int = 0
    leaf_crc32: dict = field(default_factory=dict)
    dtypes: dict = field(default_factory=dict)
    extra: dict = field(default_factory=dict)
    reason: str = ""


@dataclass
class ManifestState:
    """The manifest a journal replay reconstructs.

    ``committed`` lists serveable shards in generation order;
    ``quarantined`` generations hold positions that are part of the
    stream but cannot be served (coverage < 1); ``pending`` generations
    are INTENTs the crash window left unresolved — recovery turns each
    into an ABORT. ``committed_tokens`` counts committed + quarantined
    positions: the stream offset ingest resumes from (quarantined data
    was consumed from upstream even though it cannot be served).
    """
    entries: dict = field(default_factory=dict)      # gen -> ShardEntry
    last_gen: int = -1
    torn_tail: bool = False

    @property
    def committed(self) -> List[ShardEntry]:
        return [e for _, e in sorted(self.entries.items())
                if e.status == "committed"]

    @property
    def quarantined(self) -> List[ShardEntry]:
        return [e for _, e in sorted(self.entries.items())
                if e.status == "quarantined"]

    @property
    def pending(self) -> List[ShardEntry]:
        return [e for _, e in sorted(self.entries.items())
                if e.status == "pending"]

    @property
    def committed_tokens(self) -> int:
        """Stream offset of the next un-ingested token: every committed
        or quarantined generation consumed its tokens from upstream."""
        return sum(e.n_tokens for e in self.entries.values()
                   if e.status in ("committed", "quarantined"))

    @property
    def next_gen(self) -> int:
        return self.last_gen + 1


def replay(records: Iterable[dict], *, torn_tail: bool = False
           ) -> ManifestState:
    """Fold the record sequence into a :class:`ManifestState`.

    Tolerant by design — out-of-protocol sequences (COMMIT for an unknown
    generation, double COMMIT) do not raise here; ``verify_manifest``
    classifies them. Replay keeps the *last-writer-wins* fate per
    generation so a recovery ABORT supersedes the dangling INTENT.
    """
    st = ManifestState(torn_tail=torn_tail)
    for rec in records:
        gen = int(rec.get("gen", -1))
        typ = rec.get("type")
        st.last_gen = max(st.last_gen, gen)
        if typ == "INTENT":
            st.entries[gen] = ShardEntry(
                gen=gen, status="pending", file=rec.get("file"),
                n_tokens=int(rec.get("n_tokens", 0)),
                leaf_crc32=rec.get("leaf_crc32", {}),
                dtypes=rec.get("dtypes", {}),
                extra=rec.get("extra", {}))
        elif typ == "COMMIT":
            e = st.entries.get(gen)
            if e is not None:
                e.status = "committed"
        elif typ == "QUARANTINE":
            e = st.entries.get(gen)
            if e is None:
                e = st.entries[gen] = ShardEntry(gen=gen, status="quarantined")
            e.status = "quarantined"
            e.n_tokens = int(rec.get("n_tokens", e.n_tokens))
            e.reason = rec.get("reason", "")
            if "extra" in rec:
                e.extra = rec["extra"]
        elif typ == "ABORT":
            e = st.entries.get(gen)
            if e is None:
                e = st.entries[gen] = ShardEntry(gen=gen, status="aborted")
            e.status = "aborted"
            e.reason = rec.get("reason", "")
    return st


def load_manifest(directory: str | Path, *, strict: bool = True
                  ) -> ManifestState:
    """Read + replay ``<directory>/manifest.jsonl``."""
    records, torn = read_journal(Path(directory) / MANIFEST_NAME,
                                 strict=strict)
    return replay(records, torn_tail=torn)
