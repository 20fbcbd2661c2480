"""Shared pieces of the benchmark's CPU tests: the repository's root, the
small sizes a CPU run takes, and one run of a cell on the CPU."""
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
#: the configurations' CPU size: 8 shards of 2^11 tokens over 3,000 ids
SMALL = {"n_tokens": 1 << 14, "shard_bits": 11, "vocab_size": 3000}
#: the quantile traffic's CPU size: 4 batches of 256
SMALL_QUERIES = {"batch": 256, "pool": 4, "warmup": 2, "keep_every": 3,
                 "trace_skip": 2, "trace_units": 6}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips inside the test "
        "without one (run on the card with `pytest -m cuda`)")


def run_small(cell: str, seed: int = 2**31 + 11, traced: bool = False,
              seconds: float = 0.2) -> dict:
    """One run of ``cell`` on the CPU at the small sizes."""
    from portbench import harness
    return harness.run_cell(ROOT, cell, seed, seconds, traced,
                            torch.device("cpu"), time.perf_counter(), SMALL,
                            SMALL_QUERIES if "quantile" in cell else None)


@pytest.fixture
def small_run():
    return run_small
