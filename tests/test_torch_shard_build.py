"""The port's ``build_shards_stacked`` (``repro_torch.data.shard_build``)
against its stacked builder and the reference's loop route.

* Every ``parallel`` mode gives the port's stacked build of the same rows
  (``build_wavelet_matrix`` of the (S, n) shards) leaf for leaf, and the
  reference's ``build_shards_stacked(..., parallel=False)`` over its
  builder with ``use_kernels=False`` (its default route fails under jax
  0.9.0), carried across by ``repro_torch.convert``.
* The reference's checks: a bad ``parallel`` raises its ``ValueError``;
  ``retries`` retries a failing build and re-raises a ``KernelError``
  once the budget is spent, never swallowing it.
* ``repro_torch.data`` re-exports it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wavelet_matrix as jwm
from repro.data import build_shards_stacked as ref_build_shards_stacked
from repro_torch import convert
from repro_torch.core import wavelet_matrix as twm
from repro_torch.data import build_shards_stacked
from repro_torch.kernels.build import KernelError
from repro_torch.tree import tree_named_leaves

SIGMA, SHARDS, N, RATE = 300, 3, 1000, 64


@functools.lru_cache(maxsize=None)
def _shards() -> np.ndarray:
    return np.random.default_rng(7).integers(0, SIGMA, (SHARDS, N)).astype(
        np.int32)


def _build_one(row):
    return twm.build_wavelet_matrix(row, SIGMA, sample_rate=RATE,
                                    device="cpu")


def _same(a, b) -> None:
    a, b = tree_named_leaves(a), tree_named_leaves(b)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("parallel", ["auto", True, False])
def test_equals_the_ports_stacked_builder(parallel):
    got = build_shards_stacked(_build_one, torch.from_numpy(_shards()),
                               parallel=parallel, jit_loop=True)
    want = twm.build_wavelet_matrix(_shards(), SIGMA, sample_rate=RATE,
                                    device="cpu")
    assert (got.n, got.nbits) == (want.n, want.nbits)
    _same(got, want)


def test_equals_the_references_loop_route():
    ref = ref_build_shards_stacked(
        lambda s: jwm.build_wavelet_matrix(s, SIGMA, sample_rate=RATE,
                                           use_kernels=False),
        jnp.asarray(_shards()), parallel=False, jit_loop=True)
    flat = {".".join(p.name for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    got = build_shards_stacked(_build_one, _shards())      # numpy rows
    assert (got.n, got.nbits) == (ref.n, ref.nbits)
    _same(got, convert.from_reference(flat, ref.n, ref.nbits,
                                      sample_rate=RATE, device="cpu"))
    leaves = convert.to_reference(got)
    for name in convert.LEAF_DTYPES:
        assert np.array_equal(leaves[name], flat[name]), name


def test_a_bad_parallel_mode_raises_the_references_error():
    for bad in ("yes", 1, None):
        with pytest.raises(ValueError, match="parallel must be"):
            build_shards_stacked(_build_one, _shards(), parallel=bad)
        with pytest.raises(ValueError, match="parallel must be"):
            ref_build_shards_stacked(lambda s: s, jnp.zeros((1, 4)),
                                     parallel=bad)


def test_retry_succeeds_on_the_second_attempt():
    calls = []

    def flaky(row):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("transient")
        return torch.as_tensor(row) * 2

    out = build_shards_stacked(flaky, _shards(), retries=1, backoff_s=0.001)
    assert torch.equal(out, torch.from_numpy(_shards()) * 2)
    assert len(calls) == 1 + SHARDS


def test_a_device_error_is_reraised_once_the_retries_are_spent():
    calls = []

    def broken(row):
        calls.append(1)
        raise KernelError("the quantile library failed to load")

    with pytest.raises(KernelError, match="failed to load"):
        build_shards_stacked(broken, _shards(), retries=2, backoff_s=0.001)
    assert len(calls) == 3
    with pytest.raises(KernelError):
        build_shards_stacked(broken, _shards())
