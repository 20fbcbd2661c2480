"""Integrity-verified, self-healing serving (port of ``repro.robust``,
without the ingest manifest check, the chaos harness, the clock and
``with_retry``).

* ``integrity`` — per-leaf crc32 recorded in every snapshot's
  ``meta.json`` and re-verified on restore (``IntegrityError`` names the
  corrupted leaves).
* ``verify``    — structural self-checks that recompute each derived
  structure from the bitmaps and classify violations as repairable
  (derived) or rebuild-needed (primary).
* ``repair``    — recomputation of corrupted derived leaves through the
  builders: a successful repair is bit-identical to the structure before
  the fault.

Degraded-mode serving (per-shard availability masks, coverage-reported
answers) lives on the engines themselves (``analytics.engine``,
``index.sharded``).
"""
from .integrity import (IntegrityError, checksum_array, checksum_flat,
                        tree_checksums, trees_identical, verify_flat)
from .repair import (classify_bad_keys, is_primary_key, repair_analytics,
                     repair_fm_index, repair_sharded_index,
                     repair_wavelet_matrix, repair_wavelet_tree)
from .verify import (VerifyReport, Violation, verify_analytics,
                     verify_binary_rank, verify_binary_select,
                     verify_bitvector, verify_fm_index, verify_sharded_index,
                     verify_wavelet_matrix, verify_wavelet_tree)

__all__ = [
    "IntegrityError", "checksum_array", "checksum_flat", "tree_checksums",
    "trees_identical", "verify_flat",
    "VerifyReport", "Violation", "verify_analytics", "verify_binary_rank",
    "verify_binary_select", "verify_bitvector", "verify_fm_index",
    "verify_sharded_index", "verify_wavelet_matrix", "verify_wavelet_tree",
    "classify_bad_keys", "is_primary_key", "repair_analytics",
    "repair_fm_index", "repair_sharded_index", "repair_wavelet_matrix",
    "repair_wavelet_tree",
]
