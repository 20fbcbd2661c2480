"""The rest of the port's analytics engine and store on ``device="cpu"``,
held to the JAX reference on the reference's own test inputs
(``tests/test_analytics.py``, the degraded cases of ``tests/test_robust.py``):
histogram, distinct, exact and greedy top-k, the quantile bracket, degraded
mode with its bounds and coverage, ``add_shards``, the store's additions
and ``corpus_region``.

Every output is an integer (coverage a float32 ratio): every comparison is
equality, symbols included. The reference builds through its XLA route
(``default_use_kernels`` patched for the build; nothing under
``src/repro`` changes); each reference engine is built once per module and
its ops are jitted whole.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.wavelet_matrix as jwm_mod
from repro.analytics import ShardedAnalytics as JShardedAnalytics
from repro.analytics import range_ops as jrange_ops
from repro.analytics import build_sharded_analytics as jbuild_engine
from repro.core import build_wavelet_matrix as jbuild_wm
from repro.core.wavelet_matrix import num_levels
from repro.data.synthetic import corpus_region as jcorpus_region
from repro_torch.analytics import (build_sharded_analytics, range_distinct,
                                   range_histogram, range_topk,
                                   range_topk_greedy, topk_from_histogram,
                                   topk_slot_budget)
from repro_torch.analytics import engine as tengine
from repro_torch.core.wavelet_matrix import build_wavelet_matrix
from repro_torch.data import (build_compressed_corpus, corpus_region,
                              token_histogram)

N, SB = 2100, 9                    # 5 shards of 512, cross-shard ranges


def _reference(fn, *args, **kwargs):
    """Call a reference builder through its XLA route."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwm_mod, "default_use_kernels", lambda seq: False)
        return fn(*args, **kwargs)


def _texts(n: int, sigma: int, seed: int = 0):
    """The reference's three distributions (``tests/test_analytics.py``)."""
    rng = np.random.default_rng(seed)
    return {
        "uniform": rng.integers(0, sigma, n).astype(np.uint32),
        "zipf": (rng.zipf(1.4, n) % sigma).astype(np.uint32),
        "all_equal": np.full(n, sigma - 1, np.uint32),
    }


def _ranges(n: int, num: int, rng):
    """Random ranges with a full span, empties and a single element."""
    lo = rng.integers(0, n + 1, num).astype(np.int64)
    hi = rng.integers(0, n + 1, num).astype(np.int64)
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    lo[0], hi[0] = 0, n
    lo[1], hi[1] = 5, 5
    lo[2], hi[2] = n, n
    lo[3], hi[3] = n - 1, n
    return lo.astype(np.int32), hi.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jbuilder(sigma: int, batched: bool):
    """The reference's matrix build, XLA route, jitted whole (over the
    stacked shards when ``batched``): one compile per alphabet."""
    def build(s):
        return jbuild_wm(s, sigma, sample_rate=128, use_kernels=False)
    return jax.jit(jax.vmap(build) if batched else build)


def _jengine(seq, sigma: int, shard_bits: int) -> JShardedAnalytics:
    """The reference engine of a stream: zero-padded whole shards built as
    one batch, as ``build_compressed_corpus`` pads and stacks them."""
    size = 1 << shard_bits
    shards = np.zeros(-(-len(seq) // size) * size, np.uint32)
    shards[:len(seq)] = seq
    stacked = _jbuilder(sigma, True)(jnp.asarray(shards.reshape(-1, size)))
    return JShardedAnalytics(shards=stacked, n=len(seq), sigma=sigma,
                             shard_bits=shard_bits)


@functools.lru_cache(maxsize=None)
def _engines(sigma: int, name: str):
    seq = _texts(N, sigma, seed=sigma + 5)[name]
    teng = build_sharded_analytics(seq, sigma, shard_bits=SB,
                                   sample_rate=128, device="cpu")
    return seq, _jengine(seq, sigma, SB), teng


@functools.lru_cache(maxsize=None)
def _matrices(n: int, sigma: int, seq_bytes: bytes):
    seq = np.frombuffer(seq_bytes, np.uint32)
    return (_jbuilder(sigma, False)(jnp.asarray(seq)),
            build_wavelet_matrix(seq.astype(np.int32), sigma,
                                 sample_rate=128, device="cpu"))


# the reference's ops, jitted once for the module (a compile per shape)
_jhist = jax.jit(lambda e, a, b: e.range_histogram(a, b))
_jbracket = jax.jit(lambda e, a, b, c, levels: e.range_quantile_bracket(
    a, b, c, levels), static_argnums=4)
_jgreedy = jax.jit(lambda e, a, b, k: e.range_topk_greedy(a, b, k),
                   static_argnums=3)
_jcount = jax.jit(lambda e, a, b: e.range_count(a, b, 3, 40))
_jquantile = jax.jit(lambda e, a, b, c: e.range_quantile(a, b, c))
_jcount_bounds = jax.jit(lambda e, a, b: e.range_count_bounds(a, b, 3, 40))
_jhist_bounds = jax.jit(lambda e, a, b: e.range_histogram_bounds(a, b))
_jcoverage = jax.jit(lambda e, a, b: e.coverage(a, b))


def _np(x):
    return np.asarray(x)


def _same(got, want):
    """Equal values and a reference-shaped result."""
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    g, w = got.numpy(), _np(want)
    assert g.shape == w.shape
    assert np.array_equal(g, w.astype(g.dtype)), (g, w)


# --------------------------------------------------------------------------
# sharded engine: histogram family, bracket, greedy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sigma", [4, 256, 1000])
def test_sharded_histogram_topk_distinct_match_reference(sigma):
    for name in ("uniform", "zipf", "all_equal"):
        seq, jeng, teng = _engines(sigma, name)
        assert teng.num_shards == 5
        lo, hi = _ranges(N, 12, np.random.default_rng(sigma + 2))
        jh = _jhist(jeng, jnp.asarray(lo), jnp.asarray(hi))
        got = teng.range_histogram(lo, hi)
        _same(got, jh)
        for i in range(len(lo)):                      # and numpy
            assert np.array_equal(got[i].numpy(), np.bincount(
                seq[lo[i]:hi[i]], minlength=got.shape[-1]))
        _same(teng.range_topk(lo, hi, 6),
              jrange_ops.topk_from_histogram(jh, 6))
        _same(teng.range_distinct(lo, hi),
              jnp.sum(jh > 0, axis=-1).astype(jnp.int32))
        # a scalar query keeps the reference's shapes
        _same(teng.range_histogram(int(lo[5]), int(hi[5])), jh[5])
        _same(teng.range_topk(int(lo[5]), int(hi[5]), 3),
              jrange_ops.topk_from_histogram(jh[5], 3))


@pytest.mark.parametrize("sigma", [4, 256, 1000])
def test_sharded_quantile_bracket_matches_reference(sigma):
    _, jeng, teng = _engines(sigma, "zipf")
    rng = np.random.default_rng(sigma)
    lo, hi = _ranges(N, 16, rng)
    k = rng.integers(-2, N, 16).astype(np.int32)
    nbits = teng.shards.nbits
    exact = teng.range_quantile(lo, hi, k)
    for levels in (0, nbits // 2, nbits):
        want = _jbracket(jeng, *(jnp.asarray(x) for x in (lo, hi, k)),
                         levels)
        got = teng.range_quantile_bracket(lo, hi, k, levels)
        _same(got, want)
        live = exact >= 0
        assert bool(((got[0] <= exact) & (exact < got[1]))[live].all())
    assert torch.equal(got[0], exact) and torch.equal(got[1][live],
                                                      exact[live] + 1)
    # levels past nbits clamp to nbits, as the reference's
    _same(teng.range_quantile_bracket(lo, hi, k, nbits + 3), want)


@pytest.mark.parametrize("name", ["uniform", "zipf", "all_equal"])
def test_sharded_greedy_topk_matches_reference(name):
    _, jeng, teng = _engines(4, name)
    lo, hi = _ranges(N, 10, np.random.default_rng(3))
    want = _jgreedy(jeng, jnp.asarray(lo), jnp.asarray(hi), 6)
    _same(teng.range_topk_greedy(lo, hi, 6), want)


def test_sharded_greedy_topk_is_global():
    """A symbol frequent only across many shards still wins; the same
    symbols and counts as the reference at its budget."""
    n, sigma, sb = 2048, 16, 9
    seq = (np.random.default_rng(21).zipf(1.5, n) % sigma).astype(np.uint32)
    jeng = _jengine(seq, sigma, sb)
    teng = build_sharded_analytics(seq, sigma, shard_bits=sb,
                                   sample_rate=128, device="cpu")
    got = teng.range_topk_greedy(100, 1900, 3, budget=64)
    _same(got, jeng.range_topk_greedy(100, 1900, 3, budget=64))
    bc = np.bincount(seq[100:1900], minlength=sigma)
    assert np.array_equal(got[1].numpy(), np.sort(bc)[::-1][:3])


@pytest.mark.parametrize("sigma", [256, 1000])
def test_sharded_greedy_counts_equal_exact(sigma):
    """At a budget of 2^(nbits+1) the greedy counts are the exact ones, and
    every symbol it names carries its count (the reference's contract)."""
    seq, _, teng = _engines(sigma, "zipf")
    lo, hi = _ranges(N, 6, np.random.default_rng(9))
    budget = 2 << teng.shards.nbits
    syms, cnts = teng.range_topk_greedy(lo, hi, 5, budget=budget)
    _, want = teng.range_topk(lo, hi, 5)
    assert torch.equal(cnts, want)
    for i in range(len(lo)):
        bc = np.bincount(seq[lo[i]:hi[i]], minlength=sigma)
        s = syms[i].numpy()
        assert np.array_equal(bc[s[s >= 0]], cnts[i].numpy()[s >= 0])


# --------------------------------------------------------------------------
# single wavelet matrix
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sigma", [4, 256, 1000])
def test_single_matrix_histogram_family_matches_reference(sigma):
    n = 700
    for name, seq in _texts(n, sigma, seed=sigma).items():
        jwm, twm = _matrices(n, sigma, seq.tobytes())
        lo, hi = _ranges(n, 12, np.random.default_rng(sigma + 1))
        jh = jax.jit(jax.vmap(
            lambda a, b: jrange_ops.range_histogram(jwm, a, b)))(
                jnp.asarray(lo), jnp.asarray(hi))
        _same(range_histogram(twm, lo, hi), jh)
        _same(range_topk(twm, lo, hi, 6),
              jrange_ops.topk_from_histogram(jh, 6))
        _same(range_distinct(twm, lo, hi),
              jnp.sum(jh > 0, axis=-1).astype(jnp.int32))
        _same(range_histogram(twm, 50, 50), jh[1] * 0)


def _greedy_case(seq, sigma, lo, hi, k, budget, prune):
    jwm, twm = _matrices(len(seq), sigma, seq.tobytes())
    want = jax.jit(jax.vmap(lambda a, b: jrange_ops.range_topk_greedy(
        jwm, a, b, k, budget=budget, prune=prune)))(jnp.asarray(lo),
                                                   jnp.asarray(hi))
    got = range_topk_greedy(twm, lo, hi, k, budget=budget, prune=prune)
    _same(got, want)
    return got


@pytest.mark.parametrize("name", ["uniform", "zipf", "all_equal"])
def test_greedy_full_budget_matches_reference(name):
    n, sigma = 600, 37
    seq = _texts(n, sigma, seed=7)[name]
    lo = np.array([50, 0, 7, 600], np.int32)
    hi = np.array([550, 600, 7, 600], np.int32)
    syms, cnts = _greedy_case(seq, sigma, lo, hi, 5, 2 * 64, True)
    bc = np.bincount(seq[50:550], minlength=sigma)
    assert np.array_equal(cnts[0].numpy(), np.sort(bc)[::-1][:5])


def test_greedy_default_budget_on_skewed_matches_reference():
    n, sigma = 1500, 256
    seq = (np.random.default_rng(13).zipf(1.6, n) % sigma).astype(np.uint32)
    lo = np.array([0, 300, 1499], np.int32)
    hi = np.array([n, 1200, n], np.int32)
    _, cnts = _greedy_case(seq, sigma, lo, hi, 4, None, True)
    bc = np.bincount(seq, minlength=sigma)
    assert np.array_equal(cnts[0].numpy(), np.sort(bc)[::-1][:4])


@pytest.mark.parametrize("name,prune", [("zipf", True), ("zipf", False),
                                        ("uniform", True),
                                        ("uniform", False)])
def test_greedy_pruned_matches_reference_and_exact(name, prune):
    n, sigma, k = 1200, 64, 5
    rng = np.random.default_rng(21)
    texts = {"zipf": (rng.zipf(1.5, n) % sigma).astype(np.uint32),
             "uniform": rng.integers(0, sigma, n).astype(np.uint32)}
    seq = texts[name]
    budget = None if name == "zipf" else 2 * 64
    lo, hi = np.array([100, 0], np.int32), np.array([1100, 40], np.int32)
    _, cnts = _greedy_case(seq, sigma, lo, hi, k, budget, prune)
    _, twm = _matrices(n, sigma, seq.tobytes())
    assert torch.equal(cnts, range_topk(twm, lo, hi, k)[1])


def test_topk_budget_and_ties_match_reference():
    for nbits, k in ((2, 1), (10, 8), (18, 8)):
        assert topk_slot_budget(nbits, k) == \
            jrange_ops.topk_slot_budget(nbits, k)
    hist = np.array([[3, 5, 5, 0, 5, 1], [0, 0, 0, 0, 0, 0],
                     [2, 2, 2, 2, 2, 2]], np.int32)
    for k in (2, 4, 6, 9):
        _same(topk_from_histogram(torch.from_numpy(hist), k),
              jrange_ops.topk_from_histogram(jnp.asarray(hist), k))


# --------------------------------------------------------------------------
# degraded mode (``tests/test_robust.py`` fixture: N 3000, σ 97, 2^10)
# --------------------------------------------------------------------------

DN, DSIGMA, DSB = 3000, 97, 10


@functools.lru_cache(maxsize=None)
def _degraded_pair():
    toks = np.random.default_rng(0).integers(0, DSIGMA, DN).astype(np.int64)
    jeng = _reference(jbuild_engine, toks, DSIGMA, shard_bits=DSB)
    return (toks, jeng, build_sharded_analytics(toks, DSIGMA,
                                                shard_bits=DSB,
                                                device="cpu"))


def _covered_slice(toks, lo, hi, avail, shard_size):
    parts = [toks[max(lo, s * shard_size):min(hi, (s + 1) * shard_size)]
             for s in range(len(avail)) if avail[s]]
    return np.concatenate(parts) if parts else np.empty(0, toks.dtype)


def test_degraded_ops_match_reference_and_survivor_oracle():
    toks, jeng, teng = _degraded_pair()
    jdeg = jeng.drop_shards(np.asarray([1], np.int32))
    deg = teng.drop_shards(np.asarray([1], np.int32))
    assert deg.degraded and not teng.degraded
    assert np.array_equal(deg.available.numpy(), _np(jdeg.available))
    rng = np.random.default_rng(41)
    lo = rng.integers(0, DN - 1, 8)
    hi = np.array([rng.integers(a + 1, DN + 1) for a in lo])
    k = np.array([rng.integers(0, max(1, b - a)) for a, b in zip(lo, hi)])
    lo, hi, k = (x.astype(np.int32) for x in (lo, hi, k))
    jl, jhh, jk = (jnp.asarray(x) for x in (lo, hi, k))
    _same(deg.range_count(lo, hi, 3, 40), _jcount(jdeg, jl, jhh))
    _same(deg.range_quantile(lo, hi, k), _jquantile(jdeg, jl, jhh, jk))
    jh = _jhist(jdeg, jl, jhh)
    _same(deg.range_histogram(lo, hi), jh)
    _same(deg.range_distinct(lo, hi),
          jnp.sum(jh > 0, axis=-1).astype(jnp.int32))
    _same(deg.range_topk(lo, hi, 4), jrange_ops.topk_from_histogram(jh, 4))
    avail = deg.available.numpy()
    q = deg.range_quantile(lo, hi, k).numpy()
    h = deg.range_histogram(lo, hi).numpy()
    for i in range(len(lo)):
        sl = _covered_slice(toks, lo[i], hi[i], avail, teng.shard_size)
        want = int(np.sort(sl)[min(k[i], len(sl) - 1)]) if len(sl) else -1
        assert q[i] == want
        assert np.array_equal(h[i], np.bincount(sl, minlength=h.shape[1]))


@pytest.mark.parametrize("drop", [[0, 2], [1], [0, 1, 2]])
def test_degraded_bounds_and_coverage_match_reference(drop):
    _, jeng, teng = _degraded_pair()
    jdeg = jeng.drop_shards(np.asarray(drop, np.int32))
    deg = teng.drop_shards(np.asarray(drop, np.int32))
    lo = np.array([0, 100, 1500, 2999, 7], np.int32)
    hi = np.array([DN, 1200, 2900, DN, 7], np.int32)
    jl, jhh = jnp.asarray(lo), jnp.asarray(hi)
    got = deg.range_count_bounds(lo, hi, 3, 40)
    _same(got, _jcount_bounds(jdeg, jl, jhh))
    assert got[2].dtype == torch.float32          # equal bit for bit above
    truth = teng.range_count(lo, hi, 3, 40)
    assert bool(((got[0] <= truth) & (truth <= got[1])).all())
    hb = deg.range_histogram_bounds(lo, hi)
    _same(hb, _jhist_bounds(jdeg, jl, jhh))
    htruth = teng.range_histogram(lo, hi)
    assert bool(((hb[0] <= htruth)
                 & (htruth <= hb[0] + hb[1][:, None])).all())
    want = _jcoverage(jdeg, jl, jhh)
    _same(deg.coverage(lo, hi), want)
    _same(tengine.sharded_coverage(DSB, 3, DN, lo, hi, deg.available), want)


def test_full_availability_bounds_are_tight():
    _, jeng, teng = _degraded_pair()
    lower, upper, cov = teng.range_count_bounds(10, 2000, 3, 40)
    _same((lower, upper, cov), _jcount_bounds(jeng, jnp.int32(10),
                                              jnp.int32(2000)))
    assert int(lower) == int(upper) and float(cov) == 1.0
    assert float(teng.coverage(0, DN)) == 1.0


def test_availability_roundtrip_and_mask_checks():
    _, _, teng = _degraded_pair()
    deg = teng.with_availability(np.asarray([True, False, True]))
    assert deg.degraded and deg.quantile is teng.quantile
    back = deg.with_availability(None)
    assert back.available is None
    twice = deg.drop_shards([2])
    assert twice.available.tolist() == [True, False, False]
    assert deg.available.tolist() == [True, False, True]    # not mutated
    with pytest.raises(ValueError):
        teng.with_availability(np.asarray([True, False]))
    assert torch.equal(teng.shard(1).zeros, teng.shards.zeros[1])


@pytest.mark.parametrize("new_available", [None, [True, False]])
def test_add_shards_matches_reference(new_available):
    n, sigma, sb = 4 * 512, 50, 9
    toks = np.random.default_rng(5).integers(0, sigma, n).astype(np.int64)
    jfirst = _jengine(toks[:1024], sigma, sb)
    jnew = _jengine(toks[1024:], sigma, sb)
    jall = jfirst.add_shards(jnew.shards, 1024, new_available)
    first = build_sharded_analytics(toks[:1024], sigma, shard_bits=sb,
                                    sample_rate=128, device="cpu")
    new = build_sharded_analytics(toks[1024:], sigma, shard_bits=sb,
                                  sample_rate=128, device="cpu")
    grown = first.add_shards(new.shards, 1024, new_available)
    whole = build_sharded_analytics(toks, sigma, shard_bits=sb,
                                    sample_rate=128, device="cpu")
    from repro_torch import convert
    want = convert.to_reference(whole.shards)
    for name, leaf in convert.to_reference(grown.shards).items():
        assert np.array_equal(np.asarray(leaf), np.asarray(want[name]))
    assert grown.n == jall.n == n
    if new_available is None:
        assert grown.available is None and jall.available is None
    else:
        assert np.array_equal(grown.available.numpy(),
                              _np(jall.available))
    # the kernel operands follow the merged shards
    assert grown.quantile.words.shape[0] == 4 * grown.shards.nbits
    lo, hi, k = (np.array(x, np.int32) for x in ([0, 700, 1500],
                                                 [n, 1900, 2048], [9, 3, 0]))
    _same(grown.range_quantile(lo, hi, k), _jquantile(
        jall, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(k)))
    with pytest.raises(ValueError):
        first.add_shards(new.shards, 100)
    partial = build_sharded_analytics(toks[:1000], sigma, shard_bits=sb,
                                      sample_rate=128, device="cpu")
    with pytest.raises(ValueError):
        partial.add_shards(new.shards, 1024)


# --------------------------------------------------------------------------
# store and synthetic corpus
# --------------------------------------------------------------------------

def test_store_additions_match_reference():
    """The store over the zipf stream of σ = 256: its analytics equal the
    reference engine's of the same stream, its decode and histogram the
    stream itself."""
    seq, jeng, _ = _engines(256, "zipf")
    tcorpus = build_compressed_corpus(seq, 256, shard_bits=SB,
                                      sample_rate=128, device="cpu")
    assert tcorpus.nbits == num_levels(256) == 8
    assert tcorpus.raw_bits_per_token() == 32
    assert token_histogram(tcorpus).dtype == torch.int32
    assert np.array_equal(token_histogram(tcorpus).numpy(),
                          np.bincount(seq, minlength=256))
    for start, length in ((0, 100), (500, 30), (1500, 100), (2000, 100)):
        got = tcorpus.decode_slice(start, length)    # two cross a boundary
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), seq[start:start + length])
    lo, hi = _ranges(N, 12, np.random.default_rng(256 + 2))
    jh = _jhist(jeng, jnp.asarray(lo), jnp.asarray(hi))
    _same(tcorpus.range_histogram(lo, hi), jh)
    _same(tcorpus.range_topk(lo, hi, 5),
          jrange_ops.topk_from_histogram(jh, 5))
    _same(tcorpus.range_distinct(lo, hi),
          jnp.sum(jh > 0, axis=-1).astype(jnp.int32))


@pytest.mark.parametrize("start,length", [(0, 10), (65530, 20),
                                          (200_000, 70_000)])
def test_corpus_region_is_the_reference_stream(start, length):
    got = corpus_region(300_000, 1000, start, length, seed=4)
    assert got.dtype == np.uint32
    assert np.array_equal(got, jcorpus_region(300_000, 1000, start, length,
                                              seed=4))
