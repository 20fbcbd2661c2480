"""Crash-safe streaming ingest (port of ``repro.ingest``): journaled shard
manifests, the two-phase shard commit protocol, and epoch-fenced hot-swap
serving.

Shards reach the serving set only through the journaled commit protocol
of :mod:`.ingester`, every durable fact lives in the append-only
checksummed ``manifest.jsonl`` of :mod:`.journal`, and serving swaps
between corpus generations through the epoch fencing of :mod:`.serving`.
A process dying at any protocol step recovers by journal replay to a state
bit-identical to a clean rebuild. The directory layout, the journal lines
and the shard files are the reference's, so either package recovers and
serves the other's directory.
"""
from .ingester import (COMMIT_STEPS, QUARANTINE_STEP, IngestError,
                       RecoveryReport, ShardIngester, analytics_ingester,
                       index_ingester)
from .journal import (MANIFEST_NAME, RECORD_TYPES, JournalCorrupt,
                      ManifestState, ShardEntry, append_record,
                      load_manifest, read_journal, record_crc, replay)
from .serving import GenerationServer

__all__ = [
    "COMMIT_STEPS", "QUARANTINE_STEP", "IngestError", "RecoveryReport",
    "ShardIngester", "analytics_ingester", "index_ingester",
    "MANIFEST_NAME", "RECORD_TYPES", "JournalCorrupt", "ManifestState",
    "ShardEntry", "append_record", "load_manifest", "read_journal",
    "record_crc", "replay",
    "GenerationServer",
]
