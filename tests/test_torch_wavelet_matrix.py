"""Port's wavelet-matrix build and queries vs the JAX reference.

The reference builds with ``use_kernels=False`` (its XLA fast path; the
default route needs a TPU check that this jax does not have). Builds are
compared leaf for leaf and bit for bit through ``repro_torch.convert``.
All outputs are exact integers: every comparison is equality.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wavelet_matrix as jwm
from repro_torch import convert
from repro_torch.core import wavelet_matrix as twm
from repro_torch.tree import tree_map, tree_named_leaves


def _flat(wm) -> dict:
    """Reference pytree → dict of numpy leaves keyed by dotted field path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(wm)[0]:
        out[".".join(p.name for p in path)] = np.asarray(leaf)
    return out


@functools.lru_cache(maxsize=None)
def _case(sigma: int, tau: int, n: int):
    seq = np.random.default_rng(sigma * 31 + tau + n).integers(
        0, sigma, n).astype(np.uint32)
    ref = jwm.build_wavelet_matrix(jnp.asarray(seq), sigma, tau=tau,
                                   sample_rate=128, use_kernels=False)
    return seq, ref, _flat(ref)


def _assert_same_leaves(port, ref_flat):
    got = convert.to_reference(port)
    for name in convert.LEAF_DTYPES:
        assert got[name].dtype == ref_flat[name].dtype, name
        assert np.array_equal(got[name], ref_flat[name]), name


@pytest.mark.parametrize("sigma", [2, 37, 256, 1 << 16])
@pytest.mark.parametrize("tau", [4, 8])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_build_is_bit_identical(sigma, tau, use_kernels):
    n = 1001 if tau == 4 else 2047
    seq, ref, flat = _case(sigma, tau, n)
    port = twm.build_wavelet_matrix(seq.astype(np.int32), sigma, tau=tau,
                                    sample_rate=128, use_kernels=use_kernels,
                                    device="cpu")
    assert (port.n, port.nbits) == (ref.n, ref.nbits)
    _assert_same_leaves(port, flat)


def test_batched_build_equals_stacked_rows():
    sigma, n = 300, 777
    rows = np.random.default_rng(0).integers(0, sigma, (3, n)).astype(
        np.int32)
    batched = twm.build_wavelet_matrix(rows, sigma, sample_rate=64,
                                       device="cpu")
    stacked = tree_map(lambda *xs: torch.stack(xs),
                       *(twm.build_wavelet_matrix(r, sigma, sample_rate=64,
                                                  device="cpu")
                         for r in rows))
    a, b = tree_named_leaves(batched), tree_named_leaves(stacked)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_queries_match_reference():
    sigma, tau, n = 37, 4, 1001
    seq, ref, flat = _case(sigma, tau, n)
    port = convert.from_reference(flat, n, ref.nbits, sample_rate=128,
                                  device="cpu")
    pos = np.arange(n, dtype=np.int32)
    got = twm.wm_access(port, torch.from_numpy(pos))
    assert np.array_equal(got.numpy(), seq)
    assert np.array_equal(got.numpy(),
                          np.asarray(jax.jit(jwm.wm_access)(ref, pos)))
    rng = np.random.default_rng(1)
    c = rng.integers(0, sigma, 64).astype(np.int32)
    c[:4] = seq[:4]
    i = rng.integers(0, n + 1, 64).astype(np.int32)
    i[:2] = [0, n]
    assert np.array_equal(twm.wm_rank(port, c, i).numpy(),
                          np.asarray(jax.jit(jwm.wm_rank)(ref, c, i)))
    counts = np.bincount(seq, minlength=sigma)
    k = (rng.integers(0, 1 << 20, 64) % np.maximum(counts[c], 1)).astype(
        np.int32)
    k[4] = counts[c[4]] - 1                        # last occurrence
    got = twm.wm_select(port, c, k).numpy()
    # eager: jit of the select descent compiles for tens of seconds
    assert np.array_equal(got, np.asarray(jwm.wm_select(ref, c, k)))
    for j in range(64):
        if counts[c[j]]:
            assert got[j] == np.flatnonzero(seq == c[j])[k[j]]


def test_descent_primitives_match_reference():
    sigma, tau, n = 37, 4, 1001
    seq, ref, flat = _case(sigma, tau, n)
    port = convert.from_reference(flat, n, ref.nbits, sample_rate=128,
                                  device="cpu")
    rng = np.random.default_rng(2)
    lo = rng.integers(0, n + 1, 50).astype(np.int32)
    hi = np.maximum(lo, rng.integers(0, n + 1, 50)).astype(np.int32)
    bit = rng.integers(0, 2, 50).astype(np.int32)
    tlo, thi, tbit = (torch.from_numpy(x) for x in (lo, hi, bit))
    for l in range(ref.nbits):
        z = twm.wm_interval_zeros(port, l, tlo, thi)
        jz = jwm.wm_interval_zeros(ref, l, jnp.asarray(lo), jnp.asarray(hi))
        assert all(np.array_equal(a.numpy(), np.asarray(b))
                   for a, b in zip(z, jz))
        ch = twm.wm_child_interval(port, l, tlo, thi, tbit)
        jch = jwm.wm_child_interval(ref, l, jnp.asarray(lo), jnp.asarray(hi),
                                    jnp.asarray(bit))
        assert all(np.array_equal(a.numpy(), np.asarray(b))
                   for a, b in zip(ch, jch))
        st = twm.wm_position_step(port, l, tlo.clamp(max=n - 1))
        jst = jwm.wm_position_step(ref, l, jnp.minimum(jnp.asarray(lo),
                                                       n - 1))
        assert all(np.array_equal(a.numpy(), np.asarray(b))
                   for a, b in zip(st, jst))


@pytest.mark.parametrize("stacked", [False, True])
def test_converter_round_trip(stacked):
    sigma, tau, n = 256, 4, 1001
    _, ref, flat = _case(sigma, tau, n)
    if stacked:
        flat = {k: np.stack([v, v]) for k, v in flat.items()}
    port = convert.from_reference(flat, n, ref.nbits, sample_rate=128,
                                  device="cpu")
    assert port.bitvectors.rank.words.dtype == torch.int32
    assert port.bitvectors.rank.block.dtype == torch.int16
    back = convert.to_reference(port)
    assert (back["n"], back["nbits"]) == (n, ref.nbits)
    for name in convert.LEAF_DTYPES:
        assert back[name].dtype == flat[name].dtype
        assert np.array_equal(back[name], flat[name])
    again = convert.from_reference(back, n, ref.nbits, sample_rate=128,
                                   device="cpu")
    a, b = tree_named_leaves(port), tree_named_leaves(again)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_unported_routes_raise():
    # fused=False is ported now (tests/test_torch_construction_variants.py)
    seq = np.arange(64, dtype=np.int32) % 16
    a = tree_named_leaves(twm.build_wavelet_matrix(seq, 16, fused=False,
                                                   device="cpu"))
    b = tree_named_leaves(twm.build_wavelet_matrix(seq, 16, device="cpu"))
    assert all(torch.equal(a[k], b[k]) for k in b)
    with pytest.raises(ValueError):
        twm.build_wavelet_matrix(seq, 16, big_step="bogus", device="cpu")
    assert twm.num_levels(151936) == jwm.num_levels(151936) == 18
