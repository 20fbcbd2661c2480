"""The port's batch pipeline (``repro_torch.data.pipeline``) against the
reference's ``repro.data.pipeline``.

* ``batch_offsets`` bit for bit (the same counter-mode hash).
* ``TokenBatcher.batch_at`` from raw tokens and from the port's
  wavelet-matrix store (built on the CPU) equal to the reference's raw
  batcher, and the reference's store-backed batcher equal to both (its
  store built with ``default_use_kernels`` patched to the plain route: the
  default route fails under jax 0.9.0); int32 numpy batches.
* ``iterate`` serves ``batch_at`` in order from any start, and an error
  raised while making a batch (a device error of the store's decode) is
  raised in the consumer.
"""
import functools

import numpy as np
import pytest
import torch

import repro.core.wavelet_matrix as rwm
from repro.data import compressed_store as rstore
from repro.data import pipeline as rpipe
from repro.data.synthetic import make_corpus as r_make_corpus
from repro_torch.data import (TokenBatcher, batch_offsets,
                              build_compressed_corpus, make_corpus)
from repro_torch.kernels.build import KernelError

N, SIGMA, SHARD_BITS = 120_000, 2003, 14
STEPS = (0, 3, 1000)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _tokens() -> np.ndarray:
    toks = make_corpus(N, SIGMA, seed=3)
    np.testing.assert_array_equal(toks, r_make_corpus(N, SIGMA, seed=3))
    return toks


@functools.cache
def _port_store():
    return build_compressed_corpus(_tokens(), SIGMA, shard_bits=SHARD_BITS,
                                   device="cpu")


@functools.cache
def _reference_store():
    saved = rwm.default_use_kernels
    rwm.default_use_kernels = lambda seq: False
    try:
        return rstore.build_compressed_corpus(_tokens(), SIGMA,
                                              shard_bits=SHARD_BITS)
    finally:
        rwm.default_use_kernels = saved


@pytest.mark.parametrize("step,batch,n,seq,seed", [
    (0, 8, 1 << 17, 128, 0), (7, 3, 1000, 16, 5), (123456, 16, N, 256, 9),
    (2 ** 23, 4, 2 ** 27, 256, 0), (1, 1, 34, 32, 1)])
def test_batch_offsets_match_reference(step, batch, n, seq, seed):
    got = batch_offsets(step, batch, n, seq, seed)
    want = rpipe.batch_offsets(step, batch, n, seq, seed)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_raw_batches_match_reference():
    toks = _tokens()
    mine = TokenBatcher(tokens=toks, batch=4, seq_len=64, seed=9)
    ref = rpipe.TokenBatcher(tokens=toks, batch=4, seq_len=64, seed=9)
    for step in STEPS:
        got = mine.batch_at(step)
        assert got.dtype == np.int32 and got.shape == (4, 65)
        np.testing.assert_array_equal(got, ref.batch_at(step))


def test_store_batches_match_reference_raw():
    toks = _tokens()
    mine = TokenBatcher(corpus=_port_store(), batch=4, seq_len=64, seed=9)
    ref = rpipe.TokenBatcher(tokens=toks, batch=4, seq_len=64, seed=9)
    assert mine.n == N
    for step in STEPS:
        got = mine.batch_at(step)
        assert got.dtype == np.int32 and got.shape == (4, 65)
        np.testing.assert_array_equal(got, ref.batch_at(step))


def test_store_batch_is_one_access(monkeypatch):
    """A store-backed batch decodes all B·(S+1) positions in one
    ``access`` call, across shard boundaries."""
    store = _port_store()
    calls = []
    real = type(store).access

    def counting(self, pos):
        calls.append(tuple(pos.shape))
        return real(self, pos)
    monkeypatch.setattr(type(store), "access", counting)
    b = TokenBatcher(corpus=store, batch=8, seq_len=1 << SHARD_BITS, seed=2)
    got = b.batch_at(5)
    assert calls == [(8, (1 << SHARD_BITS) + 1)]
    np.testing.assert_array_equal(got, _tokens()[b.positions(5)])


def test_reference_store_batcher_agrees():
    toks = _tokens()
    ref_wm = rpipe.TokenBatcher(corpus=_reference_store(), batch=4,
                                seq_len=64, seed=9)
    mine = TokenBatcher(corpus=_port_store(), batch=4, seq_len=64, seed=9)
    for step in STEPS[:2]:
        np.testing.assert_array_equal(mine.batch_at(step),
                                      ref_wm.batch_at(step))
        np.testing.assert_array_equal(
            mine.batch_at(step),
            rpipe.TokenBatcher(tokens=toks, batch=4, seq_len=64,
                               seed=9).batch_at(step))


@pytest.mark.parametrize("source", ["tokens", "corpus"])
def test_iterate_serves_batch_at_in_order(source):
    kw = ({"tokens": _tokens()} if source == "tokens"
          else {"corpus": _port_store()})
    b = TokenBatcher(batch=2, seq_len=32, seed=1, **kw)
    it = b.iterate(start_step=5, prefetch=2)
    for step in (5, 6, 7):
        np.testing.assert_array_equal(next(it), b.batch_at(step))
    it.close()


def test_iterate_reraises_device_errors_in_the_consumer():
    class Failing(TokenBatcher):
        def batch_at(self, step):
            if step == 3:
                raise KernelError("CUDA kernel wm_level_step failed")
            return super().batch_at(step)

    b = Failing(tokens=_tokens(), batch=2, seq_len=16, seed=0)
    it = b.iterate(start_step=1, prefetch=2)
    np.testing.assert_array_equal(next(it), b.batch_at(1))
    np.testing.assert_array_equal(next(it), b.batch_at(2))
    with pytest.raises(KernelError):
        next(it)
