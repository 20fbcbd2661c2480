"""The port's full-text index on ``device="cpu"`` against the JAX reference
(``repro.index``) and numpy oracles: suffix arrays, the BWT and its C
table, FM-index leaves (through the converters), count, locate, and the
sharded index with its seams, degraded mode and appends, at the reference
tests' own sizes.

The reference builds its matrices through its default route, which needs
a TPU check this jax lacks; the cached helpers patch
``repro.core.wavelet_matrix.default_use_kernels`` to the XLA route for the
duration of a build (nothing under ``src/repro`` changes). All outputs are
integers: every comparison is equality.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.wavelet_matrix as jwm_mod
from repro import index as jindex
from repro.data.synthetic import make_corpus as jmake_corpus
from repro.launch import index as jcli
from repro_torch import convert
from repro_torch.index import (bwt_decode, bwt_encode, build_fm_index,
                               build_sharded_index, doubling_round,
                               fm_count, fm_locate, sample_patterns,
                               seam_windows_from_tokens, suffix_array,
                               suffix_array_naive, symbol_boundaries)
from repro_torch.index import fm_index as fm_mod
from repro_torch.launch import index as cli
from repro_torch.tree import tree_named_leaves


def _flat(struct) -> dict:
    """Reference pytree → dict of numpy leaves keyed by dotted field path."""
    return {".".join(p.name for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(struct)[0]}


def _same_as_reference(got: dict, want: dict, names) -> None:
    for name in names:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name]), name


def _reference(build, *args, **kw):
    """A reference build with its matrices on the XLA route."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwm_mod, "default_use_kernels", lambda seq: False)
        return build(*args, **kw)


def _texts(n: int, sigma: int, seed: int = 0):
    """The reference tests' distributions and adversarial texts."""
    rng = np.random.default_rng(seed)
    return {
        "uniform": rng.integers(0, sigma, n).astype(np.int64),
        "skewed": (rng.zipf(1.3, n) % sigma).astype(np.int64),
        "periodic": (np.arange(n) % min(sigma, 7)).astype(np.int64),
        "all_equal": np.full(n, sigma - 1, np.int64),
    }


def _naive_count(text, pat, plen: int) -> int:
    if plen > len(text) or plen == 0:
        return 0
    win = np.lib.stride_tricks.sliding_window_view(text, plen)
    return int((win == pat[:plen]).all(axis=1).sum())


def _patterns(text, sigma: int, num: int, max_len: int, seed: int):
    """Padded patterns: every third random (usually a miss), the rest
    substrings of ``text``."""
    rng = np.random.default_rng(seed)
    pats = np.full((num, max_len), sigma, np.int32)
    lens = rng.integers(1, max_len + 1, num).astype(np.int32)
    for i in range(num):
        if i % 3 == 0:
            pats[i, :lens[i]] = rng.integers(0, sigma, lens[i])
        else:
            s = int(rng.integers(0, len(text) - lens[i]))
            pats[i, :lens[i]] = text[s:s + lens[i]]
    return pats, lens


# ---------------------------------------------------------------------------
# suffix array, BWT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 17, 300])
@pytest.mark.parametrize("kind", ["random", "run"])
def test_suffix_array_matches_reference_and_naive(n, kind):
    rng = np.random.default_rng(n)
    seq = (rng.integers(0, 5, n) if kind == "random"
           else np.full(n, 3)).astype(np.int32)
    got = suffix_array(torch.from_numpy(seq), device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), suffix_array_naive(seq))
    want = np.asarray(jindex.suffix_array(jnp.asarray(seq)))
    assert np.array_equal(got.numpy(), want)


def test_suffix_array_of_batched_rows_is_each_rows_own():
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 3, (4, 64)).astype(np.int32)
    rows[1] = 2                          # one row needs every round
    rows[2, ::2] = 0
    got = suffix_array(torch.from_numpy(rows), 3, device="cpu").numpy()
    for r in range(4):
        assert np.array_equal(got[r], suffix_array_naive(rows[r])), r
    for backend in ("xla", "counting"):
        assert np.array_equal(suffix_array(
            torch.from_numpy(rows), 3, backend=backend, max_rounds=7,
            device="cpu").numpy(), got)


def test_doubling_round_matches_reference():
    rng = np.random.default_rng(2)
    rank = rng.integers(0, 40, 300).astype(np.int32)
    for offset in (1, 4, 256):
        got = doubling_round(torch.from_numpy(rank), offset, 9)
        want = jindex.doubling_round(jnp.asarray(rank), offset, 9)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), np.asarray(w)), offset


@pytest.mark.parametrize("n,sigma", [(1, 2), (50, 3), (400, 256)])
def test_bwt_and_c_match_reference(n, sigma):
    seq = np.random.default_rng(n).integers(0, sigma, n).astype(np.int32)
    got = bwt_encode(torch.from_numpy(seq), sigma, device="cpu")
    want = jindex.bwt_encode(jnp.asarray(seq), sigma)
    for g, w in zip(got, want):             # bwt, sa, C
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    bwt, _, C = got
    assert bwt.shape[0] == n + 1 and int(C[-1]) == n + 1
    assert np.array_equal(bwt_decode(bwt, C), seq)
    assert np.array_equal(bwt_decode(bwt, C),
                          np.asarray(jindex.bwt_decode(*want[::2])))


def test_bwt_of_batched_rows_and_out_of_range_symbols():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 3, (3, 50)).astype(np.int32)
    bwt, sa, C = bwt_encode(torch.from_numpy(rows), 3, device="cpu")
    for r in range(3):
        want = jindex.bwt_encode(jnp.asarray(rows[r]), 3)
        for g, w in zip((bwt[r], sa[r], C[r]), want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        assert np.array_equal(bwt_decode(bwt[r], C[r]), rows[r])
    # the histogram drops symbols outside [0, sigma_work), as the reference
    text = np.array([0, 3, 9, 3, 1], np.int32)
    assert np.array_equal(
        symbol_boundaries(torch.from_numpy(text), 4).numpy(),
        np.asarray(jindex.symbol_boundaries(jnp.asarray(text), 4)))


# ---------------------------------------------------------------------------
# FM index
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fm_pair(sigma: int, kind: str, n: int = 300, sample_rate: int = 16):
    """(text, port index, reference index) of one acceptance text."""
    text = _texts(n, sigma, seed=sigma)[kind]
    port = build_fm_index(torch.from_numpy(text), sigma,
                          sample_rate=sample_rate, device="cpu")
    ref = _reference(jindex.build_fm_index, jnp.asarray(text, jnp.int32),
                     sigma, sample_rate=sample_rate)
    return text, port, ref


@pytest.mark.parametrize("sigma", [4, 256, 1000])
def test_fm_index_leaves_match_reference(sigma):
    text, port, ref = _fm_pair(sigma, "skewed")
    want = _flat(ref)
    got = convert.fm_index_to_reference(port)
    _same_as_reference(got, want, convert.FM_LEAF_DTYPES)
    assert set(want) == set(convert.FM_LEAF_DTYPES)
    assert (got["n"], got["sigma"], got["sample_rate"]) == (
        ref.n, ref.sigma, ref.sample_rate)
    assert port.bits_per_symbol() == ref.bits_per_symbol()
    # the reference's index, carried across, is the port's
    back = convert.fm_index_from_reference(want, ref.n, ref.sigma,
                                           ref.sample_rate, device="cpu")
    g, w = tree_named_leaves(back), tree_named_leaves(port)
    assert g.keys() == w.keys() and all(torch.equal(g[k], w[k]) for k in g)
    assert back.wm.nbits == port.wm.nbits and back.wm.n == port.wm.n


def test_fm_index_rejects_symbols_outside_the_alphabet():
    with pytest.raises(ValueError, match="outside"):
        build_fm_index(torch.tensor([0, 4, 1]), 4, device="cpu")


@functools.lru_cache(maxsize=None)
def _jit_queries(max_hits: int):
    """The reference's count and (vmapped) locate, jitted once."""
    return jax.jit(lambda fm, p, l: (
        jindex.fm_count(fm, p, l),
        jax.vmap(lambda pp, ll: jindex.fm_locate(fm, pp, ll, max_hits))(
            p, l)))


@pytest.mark.parametrize("kind", ["uniform", "skewed", "periodic",
                                  "all_equal"])
def test_fm_count_and_locate_match_reference(kind):
    sigma = 4
    text, port, ref = _fm_pair(sigma, kind)
    pats, lens = _patterns(text, sigma, 24, 6, seed=len(kind))
    pats[0, :3], lens[0] = text[:3], 3          # the adversarial prefix
    pats[1, :2], lens[1] = [sigma, -1], 2       # out of the alphabet
    lens[2] = 0                                 # the empty pattern
    want_count, want_pos = _jit_queries(64)(ref, jnp.asarray(pats),
                                            jnp.asarray(lens))
    got = fm_count(port, pats, lens)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want_count))
    want = [_naive_count(text, p, int(l)) for p, l in zip(pats, lens)]
    assert np.array_equal(got.numpy()[3:], want[3:])
    assert int(got[2]) == len(text) + 1         # m matches of the empty one
    pos = fm_locate(port, pats, lens, 64)
    assert np.array_equal(pos.numpy(), np.asarray(want_pos))
    # one pattern at a time, as the reference's signature
    one = port.locate(pats[0], lens[0], 64)
    assert np.array_equal(one.numpy(), pos[0].numpy())
    hits = [int(x) for x in one if x >= 0]
    ref_hits = [i for i in range(len(text) - 2)
                if np.array_equal(text[i:i + 3], text[:3])]
    if len(ref_hits) <= 64:
        assert hits == ref_hits                 # all matches, text order
    else:
        assert len(hits) == 64 and set(hits) <= set(ref_hits)


def test_lf_step_and_locate_row():
    text, port, _ = _fm_pair(4, "skewed")
    m = len(text) + 1
    sa = suffix_array_naive(np.append(text + 1, 0))     # of T'·$
    isa = np.empty(m, np.int64)
    isa[sa] = np.arange(m)
    rows = torch.arange(m)
    # LF(j) is the row of the suffix one position earlier
    assert np.array_equal(fm_mod._lf_step(port, rows).numpy(),
                          isa[(sa - 1) % m])
    # every row walks back to its suffix's start through the samples
    assert np.array_equal(fm_mod._locate_row(port, rows).numpy(), sa)


# ---------------------------------------------------------------------------
# sharded index
# ---------------------------------------------------------------------------

def _sharded_corpus(name: str):
    """(tokens, sigma, build arguments) of the reference tests' corpora."""
    if name == "padded":                 # 5 shards of 512, last one padded
        toks = np.asarray(jmake_corpus(2500, 64, seed=2), np.int64)
        return toks, 64, dict(shard_bits=9, sample_rate=16)
    if name in ("planted", "planted0"):
        rng = np.random.default_rng(11)
        toks = rng.integers(0, 32, 2048).astype(np.int64)
        for p in range(512, 2048, 512):  # straddle every internal boundary
            toks[p - 3:p + 3] = [9, 4, 9, 4, 9, 4]
        return toks, 32, dict(shard_bits=9, sample_rate=16,
                              seam_overlap=0 if name == "planted0" else 15)
    if name == "pad":
        return np.arange(100) % 7, 7, dict(shard_bits=6, sample_rate=8)
    if name == "one":
        return np.array([3]), 8, dict(shard_bits=6, sample_rate=4)
    assert name == "513"                 # the 2nd shard holds one token
    return np.arange(513) % 8, 8, dict(shard_bits=9, sample_rate=16)


@functools.lru_cache(maxsize=None)
def _sharded(name: str):
    toks, sigma, kw = _sharded_corpus(name)
    return toks, build_sharded_index(toks, sigma, device="cpu", **kw)


def _sharded_queries(toks, sigma: int, seed: int, num: int = 16,
                     max_len: int = 5):
    """Sampled patterns (σ-padded), the first out of the vocabulary."""
    pats, lens = sample_patterns(toks, num, max_len, pad=sigma, seed=seed)
    pats[0, :2], lens[0] = [sigma, -1], 2
    return pats, lens


def _check_locate(toks, idx, pats, lens, by_shard, max_hits: int = 4):
    """Every hit a real match, min(max_hits, count) hits a shard."""
    pos = idx.locate(pats, lens, max_hits).numpy()
    assert pos.shape == (len(pats), idx.num_shards * max_hits)
    for i, (p, l) in enumerate(zip(pats, lens)):
        hits = pos[i][pos[i] >= 0]
        assert np.array_equal(hits, np.sort(hits))
        for h in hits:
            assert np.array_equal(toks[h:h + l], p[:l]), (i, h)
        per = np.bincount(hits >> idx.shard_bits, minlength=idx.num_shards)
        assert np.array_equal(per, np.minimum(by_shard[:, i], max_hits))


def test_sharded_index_matches_reference():
    """The padded corpus built by both packages: leaves through the
    converters, and count_bounds and coverage with shards 1 and 3
    dropped (the lower bound is the degraded count: per-shard counts under
    the mask plus the seams between live shards)."""
    toks, sigma, kw = _sharded_corpus("padded")
    _, port = _sharded("padded")
    ref = _reference(jindex.build_sharded_index, toks, sigma, **kw)
    want = _flat(ref)
    got = convert.sharded_index_to_reference(port)
    _same_as_reference(got, want, convert.SHARDED_LEAF_DTYPES)
    assert set(want) == set(convert.SHARDED_LEAF_DTYPES)
    assert (port.num_shards, port.shard_size, port.n) == (
        ref.num_shards, ref.shard_size, ref.n)
    assert port.bits_per_token() == ref.bits_per_token()
    back = convert.sharded_index_from_reference(
        want, ref.n, ref.sigma, ref.shard_bits, ref.seam_overlap,
        ref.shards.sample_rate, device="cpu")
    g, w = tree_named_leaves(back), tree_named_leaves(port)
    assert g.keys() == w.keys() and all(torch.equal(g[k], w[k]) for k in g)

    pats, lens = _sharded_queries(toks, sigma, seed=3)
    deg, jdeg = port.drop_shards([1, 3]), ref.drop_shards(jnp.asarray([1, 3]))
    want = jax.jit(lambda dg, p, l: dg.count_bounds(p, l))(
        jdeg, jnp.asarray(pats), jnp.asarray(lens))
    got = deg.count_bounds(pats, lens)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        assert np.array_equal(g.numpy(), w)
    assert np.array_equal(deg.available.numpy(), np.asarray(jdeg.available))
    assert float(deg.coverage()) == float(jdeg.coverage())


@pytest.mark.parametrize("name", ["padded", "planted", "planted0", "pad",
                                  "one", "513"])
def test_sharded_count_and_locate_match_naive(name):
    """The reference tests' corpora against the reference CLI's oracles:
    global counts within the stitching domain, per-shard counts, and
    locate hits real and complete up to the per-shard cap."""
    toks, idx = _sharded(name)
    if name == "one":                    # a corpus of one token
        pats, lens = np.array([[3], [5], [8]]), np.array([1, 1, 1])
    else:
        pats, lens = _sharded_queries(toks, idx.sigma, seed=len(name))
    stitch = min(idx.seam_overlap + 1, idx.shard_size)
    got = idx.count(pats, lens)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), [
        jcli.naive_count(toks, p, int(l), idx.shard_size, stitch)
        for p, l in zip(pats, lens)])
    by_shard = idx.count_by_shard(pats, lens).numpy()
    S = idx.shard_size
    assert np.array_equal(by_shard.sum(0), [
        sum(_naive_count(toks[s0:s0 + S], p, int(l))
            for s0 in range(0, len(toks), S)) for p, l in zip(pats, lens)])
    seams = idx._seam_count(*idx._sanitize(pats, lens)).numpy()
    assert np.array_equal(by_shard.sum(0) + seams, got.numpy())
    _check_locate(toks, idx, pats, lens, by_shard)


def test_sharded_pad_symbol_never_matches_padding():
    _, port = _sharded("pad")
    pats = torch.tensor([[7, 0], [10, 0], [-1, 0]], dtype=torch.int32)
    lens = torch.tensor([1, 2, 1], dtype=torch.int32)
    assert port.count(pats, lens).tolist() == [0, 0, 0]
    assert (port.locate(pats, lens, 4) == -1).all()
    # an empty pattern counts 0 at this layer
    assert port.count([[3, 0]], [0]).tolist() == [0]


def test_sharded_planted_seams_are_counted():
    toks, port = _sharded("planted")
    _, port0 = _sharded("planted0")
    pats = np.full((2, 6), 32, np.int64)
    pats[0] = [9, 4, 9, 4, 9, 4]
    pats[1, :4] = [9, 4, 9, 4]
    lens = np.array([6, 4])
    got = port.count(pats, lens).numpy()
    assert got.tolist() == [_naive_count(toks, p, l)
                            for p, l in zip(pats, lens)]
    within = port.count_by_shard(pats, lens).sum(0).numpy()
    assert (got - within >= port.num_shards - 1).all()
    # overlap 0 disables stitching: within-shard counts only
    assert np.array_equal(port0.count(pats, lens).numpy(), within)


@pytest.mark.parametrize("drop", [[1, 3], [0], [4], [0, 1, 2, 3, 4]])
def test_degraded_mode_matches_naive(drop):
    toks, port = _sharded("padded")
    deg = port.drop_shards(drop)
    avail = np.ones(port.num_shards, bool)
    avail[drop] = False
    sizes = np.minimum(np.maximum(port.n - np.arange(5) * 512, 0), 512)
    assert deg.coverage().dtype == torch.float32
    assert float(deg.coverage()) == np.float32(
        sizes[avail].sum()) / np.float32(port.n)
    pats, lens = _sharded_queries(toks, 64, seed=7)
    lower, upper, cov = deg.count_bounds(pats, lens)
    assert float(cov) == float(deg.coverage())
    stitch = min(port.seam_overlap + 1, port.shard_size)
    for i, (p, l) in enumerate(zip(pats, lens)):
        assert int(lower[i]) == jcli.naive_count_degraded(
            toks, p, int(l), port.shard_size, stitch, avail)
        full = jcli.naive_count(toks, p, int(l), port.shard_size, stitch)
        assert int(lower[i]) <= full <= int(upper[i])
    by_shard = deg.count_by_shard(pats, lens).numpy()
    assert not by_shard[~avail].any()
    _check_locate(toks, deg, pats, lens, by_shard)
    # the leaves carry the mask across, both ways
    leaves = convert.sharded_index_to_reference(deg)
    assert np.array_equal(leaves["available"], avail)
    back = convert.sharded_index_from_reference(
        leaves, deg.n, deg.sigma, deg.shard_bits, deg.seam_overlap, 16,
        device="cpu")
    assert torch.equal(back.available, deg.available)
    # with_availability replaces the mask; None restores every shard
    again = port.with_availability(torch.from_numpy(avail))
    assert torch.equal(again.count(pats, lens), deg.count(pats, lens))
    assert again.with_availability(None).available is None
    assert deg.drop_shards([2]).available.sum() == avail.sum() - avail[2]
    with pytest.raises(ValueError, match="mask shape"):
        port.with_availability([True])


def test_add_shards_appends_the_stream():
    toks = np.asarray(jmake_corpus(5 * 256 - 40, 24, seed=4), np.int64)
    kw = dict(shard_bits=8, sample_rate=16)
    head, tail = toks[:3 * 256], toks[3 * 256:]
    base = build_sharded_index(head, 24, device="cpu", **kw)
    new = build_sharded_index(tail, 24, device="cpu", **kw)
    # the windows before each new shard, from the whole stream
    seams = seam_windows_from_tokens(toks, 5, 256, 15)[2:]
    whole = build_sharded_index(toks, 24, device="cpu", **kw)
    full = base.add_shards(new.shards, seams, len(tail))
    assert full.available is None and full.n == len(toks)
    g, w = tree_named_leaves(full), tree_named_leaves(whole)
    assert g.keys() == w.keys() and all(torch.equal(g[k], w[k]) for k in w)
    part = base.add_shards(new.shards, seams, len(tail),
                           new_available=[True, False])
    assert part.available.tolist() == [True, True, True, True, False]
    pats, lens = _sharded_queries(toks, 24, seed=5)
    assert torch.equal(part.count_bounds(pats, lens)[1],
                       whole.drop_shards([4]).count_bounds(pats, lens)[1])
    with pytest.raises(ValueError, match="partial tail"):
        full.add_shards(new.shards, seams, len(tail))
    with pytest.raises(ValueError, match="does not fill"):
        base.add_shards(new.shards, seams, 10)
    with pytest.raises(ValueError, match="new_seams shape"):
        base.add_shards(new.shards, seams[:1], len(tail))


def test_seam_windows_match_reference():
    toks = np.arange(1000) % 13
    for shards, size, ov in ((4, 256, 15), (1, 2048, 15), (3, 256, 0),
                             (8, 128, 20)):
        assert np.array_equal(
            seam_windows_from_tokens(toks, shards, size, ov),
            jindex.sharded.seam_windows_from_tokens(toks, shards, size, ov))


def test_sample_patterns_is_the_reference_copy():
    toks = np.asarray(jmake_corpus(3000, 50, seed=1))
    for seed, miss in ((1, 4), (3, None)):
        for g, w in zip(sample_patterns(toks, 40, 8, 50, seed, miss),
                        jindex.sample_patterns(toks, 40, 8, 50, seed, miss)):
            assert np.array_equal(g, w)


def test_cli_smoke_on_cpu(capsys):
    cli.main(["--smoke", "--device", "cpu", "--drop-shards", "1,3",
              "--patterns", "32"])
    out = capsys.readouterr().out
    assert "verified 16 count/locate samples" in out
    assert "bounds bracket the full-corpus truth" in out


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_sharded_index(np.arange(100) % 7, 7, shard_bits=6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--smoke"])
