"""Fault tolerance: integrity-verified, self-healing serving (port of
``repro.robust``).

* ``integrity`` — per-leaf crc32 recorded in every snapshot's
  ``meta.json`` and re-verified on restore (``IntegrityError`` names the
  corrupted leaves).
* ``verify``    — structural self-checks that recompute each derived
  structure from the bitmaps and classify violations as repairable
  (derived) or rebuild-needed (primary), and the ingest manifest's checks
  (``verify_manifest``).
* ``repair``    — recomputation of corrupted derived leaves through the
  builders: a successful repair is bit-identical to the structure before
  the fault.
* ``faults``    — the seedable chaos harness (leaf bit-flips, snapshot
  truncation and deletion, stale partial writes, crash points, per-shard
  latency) and bounded retry with backoff.
* ``clock``     — the one injectable monotonic ``Clock`` every deadline
  (retry budgets, ingest build deadlines, front-end request deadlines)
  measures against; ``FakeClock`` for tests.

Degraded-mode serving (per-shard availability masks, coverage-reported
answers) lives on the engines themselves (``analytics.engine``,
``index.sharded``).
"""
from .clock import SYSTEM_CLOCK, Clock, FakeClock
from .faults import (CrashInjected, corrupt_snapshot_leaf, crash_after,
                     check_crash_point, delete_file, delete_step,
                     flip_leaf_bit, inject_partial_tmp,
                     inject_shard_latency, shard_latency, truncate_file,
                     with_retry)
from .integrity import (IntegrityError, checksum_array, checksum_flat,
                        tree_checksums, trees_identical, verify_flat)
from .repair import (classify_bad_keys, is_primary_key, repair_analytics,
                     repair_fm_index, repair_sharded_index,
                     repair_wavelet_matrix, repair_wavelet_tree)
from .verify import (VerifyReport, Violation, verify_analytics,
                     verify_binary_rank, verify_binary_select,
                     verify_bitvector, verify_fm_index, verify_manifest,
                     verify_sharded_index, verify_wavelet_matrix,
                     verify_wavelet_tree)

__all__ = [
    "IntegrityError", "checksum_array", "checksum_flat", "tree_checksums",
    "trees_identical", "verify_flat",
    "VerifyReport", "Violation", "verify_analytics", "verify_binary_rank",
    "verify_binary_select", "verify_bitvector", "verify_fm_index",
    "verify_manifest", "verify_sharded_index", "verify_wavelet_matrix",
    "verify_wavelet_tree",
    "classify_bad_keys", "is_primary_key", "repair_analytics",
    "repair_fm_index", "repair_sharded_index", "repair_wavelet_matrix",
    "repair_wavelet_tree",
    "CrashInjected", "corrupt_snapshot_leaf", "crash_after",
    "check_crash_point", "delete_file", "delete_step", "flip_leaf_bit",
    "inject_partial_tmp", "inject_shard_latency", "shard_latency",
    "truncate_file", "with_retry",
    "Clock", "FakeClock", "SYSTEM_CLOCK",
]
