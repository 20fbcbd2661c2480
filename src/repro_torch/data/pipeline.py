"""Deterministic batch pipeline (port of ``repro.data.pipeline``).

Batch addressing is a pure function of (seed, step, example index): each
example's corpus offset comes from a counter-mode hash, so any host can
(re)serve any batch of any step with no pipeline state, and a resumed run
restarts mid-stream exactly.

Two backing stores: a raw token array, or the wavelet-matrix
``CompressedCorpus``, from which a batch is decoded by one ``access`` of
all its B·(S+1) positions. Batches are (B, S+1) int32 numpy arrays, the
reference's.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from .compressed_store import CompressedCorpus


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — cheap counter-mode hash (vectorized)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def batch_offsets(step: int, batch: int, n_tokens: int, seq_len: int,
                  seed: int = 0) -> np.ndarray:
    """Corpus start offsets for every example of a step (stateless)."""
    limit = n_tokens - seq_len - 1
    assert limit > 0, "corpus shorter than one example"
    ctr = (np.uint64(seed) << np.uint64(40)) \
        + (np.uint64(step) << np.uint64(16)) \
        + np.arange(batch, dtype=np.uint64)
    with np.errstate(over="ignore"):
        h = _mix64(ctr)
    return (h % np.uint64(limit)).astype(np.int64)


class TokenBatcher:
    """Serves (B, S+1) next-token-prediction batches by step index."""

    def __init__(self, tokens: Optional[np.ndarray] = None,
                 corpus: Optional[CompressedCorpus] = None,
                 batch: int = 8, seq_len: int = 256, seed: int = 0):
        assert (tokens is None) != (corpus is None), \
            "exactly one of tokens/corpus"
        self.tokens = tokens
        self.corpus = corpus
        self.n = len(tokens) if tokens is not None else corpus.n
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed

    def positions(self, step: int) -> np.ndarray:
        """(B, S+1) corpus positions of a step's batch."""
        offs = batch_offsets(step, self.batch, self.n, self.seq_len,
                             self.seed)
        return offs[:, None] + np.arange(self.seq_len + 1)[None, :]

    def batch_at(self, step: int) -> np.ndarray:
        idx = self.positions(step)
        if self.tokens is not None:
            return self.tokens[idx].astype(np.int32)
        dev = self.corpus.shard_counts.device
        out = self.corpus.access(torch.from_numpy(idx).to(dev))
        return out.cpu().numpy().astype(np.int32)

    def iterate(self, start_step: int = 0,
                prefetch: int = 2) -> Iterator[np.ndarray]:
        """Host-prefetching iterator: a daemon thread keeps ``prefetch``
        batches ahead. An error in the thread (a device error of the
        store's decode among them) is raised in the consumer, at the batch
        it would have made. Closing the iterator stops and joins the
        thread."""
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                try:
                    item = (True, self.batch_at(step))
                except BaseException as e:     # re-raised in the consumer
                    item = (False, e)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if not item[0]:
                    return
                step += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                ok, value = q.get()
                if not ok:
                    raise value
                yield value
        finally:
            stop.set()
            t.join()
