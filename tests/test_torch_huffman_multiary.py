"""The port's Huffman-shaped and multiary trees (Theorems 4.3, 4.4) and the
generalized rank/select of Section 5.2, against ``repro``.

Each port build is held against the reference's own grids
(``test_segmented_construction.py``: Huffman (σ, zipf) and multiary
(width, σ); the d-way gather's (n, width)): the port's two forms against
each other, the fused form's level bitmaps against the reference's numpy
oracle (``reference_huffman_levels``) or its queries against numpy, and
the JAX reference itself, jitted, in one case for each form and parameter
value. The converters carry each of the three structures from the
reference to the port and back. Inputs come from numpy seeds; every output
is an exact integer, so every comparison is equality.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as jbitops
from repro.core import huffman as jh
from repro.core import multiary as jm
from repro.core import rank_select as jrs
from repro_torch import convert
from repro_torch.core import bitops, huffman, multiary, rank_select
from repro_torch.tree import tree_named_leaves


def _jit(fn, *args, **static):
    """The reference ``fn`` jitted with its keyword arguments fixed."""
    return jax.jit(functools.partial(fn, **static))(*args)


def _flat(struct) -> dict:
    """Reference pytree → dict of numpy leaves keyed by dotted field path."""
    return {".".join(p.name for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(struct)[0]}


def _same(port, want) -> None:
    """Port structure equal leaf for leaf to another port structure or to
    reference leaves (uint leaves read as the port's int bytes)."""
    got = tree_named_leaves(port)
    if not isinstance(want, dict):
        want = {k: v.numpy() for k, v in tree_named_leaves(want).items()}
    assert got.keys() == want.keys()
    for name, leaf in got.items():
        arr = leaf.numpy()
        assert np.array_equal(arr, np.asarray(want[name]).view(arr.dtype)), \
            name


# ---------------------------------------------------------------------------
# Huffman-shaped trees
# ---------------------------------------------------------------------------

HUFFMAN_GRID = [(2, 1.0), (17, 1.5), (64, 1.2), (256, 0.8)]


@functools.lru_cache(maxsize=None)
def _huffman_case(sigma: int, zipf: float, n: int):
    rng = np.random.default_rng(sigma * 1000 + n)
    p = np.arange(1, sigma + 1) ** (-zipf)
    seq = rng.choice(sigma, size=n, p=p / p.sum()).astype(np.int32)
    codes, lengths, max_len = huffman.huffman_codebook(
        np.bincount(seq, minlength=sigma) + 1)
    return seq, codes, lengths, max_len


@functools.lru_cache(maxsize=None)
def _huffman_port(sigma: int, zipf: float, n: int, fused: bool):
    seq, codes, lengths, max_len = _huffman_case(sigma, zipf, n)
    return huffman.build_huffman_wavelet_tree(seq, codes, lengths, max_len,
                                              fused=fused, device="cpu")


def _huffman_ref(sigma: int, zipf: float, n: int, fused: bool):
    seq, codes, lengths, max_len = _huffman_case(sigma, zipf, n)
    jc, jl = jnp.asarray(codes), jnp.asarray(lengths)   # concrete: closed over
    return jax.jit(lambda s: jh.build_huffman_wavelet_tree(
        s, jc, jl, max_len, fused=fused))(jnp.asarray(seq.astype(np.uint32)))


def test_codebook_matches_reference():
    rng = np.random.default_rng(0)
    for sigma in (1, 2, 57, 1000):
        freqs = rng.integers(1, 1000, sigma)
        got, want = huffman.huffman_codebook(freqs), jh.huffman_codebook(freqs)
        assert np.array_equal(got[0], want[0]) and got[0].dtype == np.uint32
        assert np.array_equal(got[1], want[1]) and got[2] == want[2]
        assert np.array_equal(huffman.huffman_code_lengths(freqs),
                              jh.huffman_code_lengths(freqs))
        assert np.array_equal(huffman.canonical_codes(want[1])[0],
                              jh.canonical_codes(want[1])[0])


@pytest.mark.parametrize("sigma,zipf", HUFFMAN_GRID)
def test_level_plans_match_reference(sigma, zipf):
    _, codes, lengths, max_len = _huffman_case(sigma, zipf, 1337)
    got_order, got = huffman._huffman_level_plans(codes, lengths, max_len)
    want_order, want = jh._huffman_level_plans(codes, lengths, max_len)
    assert np.array_equal(got_order, want_order)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert all(np.array_equal(g[k], w[k]) for k in w)


@pytest.mark.parametrize("sigma,zipf", HUFFMAN_GRID)
def test_huffman_forms_match_each_other_and_the_oracle(sigma, zipf):
    for n in (1, 333, 1337):
        seq, codes, lengths, max_len = _huffman_case(sigma, zipf, n)
        fused = _huffman_port(sigma, zipf, n, True)
        _same(_huffman_port(sigma, zipf, n, False), fused)
        levels = huffman.reference_huffman_levels(seq.astype(np.int64),
                                                  codes, lengths, max_len)
        for l, want in enumerate(levels):
            got = bitops.unpack_bits(fused.level(l).words, len(want))
            assert np.array_equal(got.numpy(), want), (n, l)
            assert int(fused.active[l]) == len(want)
        assert int(fused.total_bits) == int(lengths[seq].sum())


@pytest.mark.parametrize("sigma,zipf,fused", [(17, 1.5, True),
                                              (64, 1.2, False),
                                              (2, 1.0, True)])
def test_huffman_matches_reference(sigma, zipf, fused):
    _same(_huffman_port(sigma, zipf, 333, fused),
          _flat(_huffman_ref(sigma, zipf, 333, fused)))


def test_reference_huffman_levels_is_the_reference_oracle():
    seq, codes, lengths, max_len = _huffman_case(64, 1.2, 1337)
    got = huffman.reference_huffman_levels(seq.astype(np.int64), codes,
                                           lengths, max_len)
    want = jh.reference_huffman_levels(seq.astype(np.int64), codes, lengths,
                                       max_len)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_huffman_rejects_codes_past_32_bits():
    with pytest.raises(ValueError):
        huffman.build_huffman_wavelet_tree(np.zeros(4, np.int32),
                                           np.zeros(2, np.uint32),
                                           np.array([33, 33]), 33,
                                           device="cpu")


def test_huffman_converter_round_trip():
    ref = _huffman_ref(17, 1.5, 1337, True)
    flat = _flat(ref)
    port = convert.huffman_from_reference(flat, ref.n, ref.max_len,
                                          device="cpu")
    _same(port, _huffman_port(17, 1.5, 1337, True))
    back = convert.huffman_to_reference(port)
    assert (back["n"], back["max_len"]) == (ref.n, ref.max_len)
    for name in convert.HUFFMAN_LEAF_DTYPES:
        assert back[name].dtype == flat[name].dtype
        assert np.array_equal(back[name], flat[name])


# ---------------------------------------------------------------------------
# multiary trees
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _multiary_case(width: int, sigma: int, n: int, fused: bool):
    seq = np.random.default_rng(width * 100 + n).integers(
        0, sigma, n).astype(np.int32)
    return seq, multiary.build_multiary_wavelet_tree(seq, sigma, width=width,
                                                     fused=fused,
                                                     device="cpu")


def _check_queries(mwt, seq: np.ndarray, seed: int) -> None:
    rng = np.random.default_rng(seed)
    n = len(seq)
    got = multiary.mwt_access(mwt, np.arange(n))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), seq)
    c = seq[rng.integers(0, n, 24)]
    i = rng.integers(0, n + 1, 24)
    i[0] = n
    assert np.array_equal(multiary.mwt_rank(mwt, c, i).numpy(),
                          [(seq[:b] == a).sum() for a, b in zip(c, i)])
    counts = np.bincount(seq)
    k = rng.integers(0, 1 << 20, 24) % counts[c]
    k[0] = counts[c[0]] - 1                          # last occurrence
    assert np.array_equal(multiary.mwt_select(mwt, c, k).numpy(),
                          [np.flatnonzero(seq == a)[b] for a, b in zip(c, k)])


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("sigma", [2, 256, 1 << 16])
def test_multiary_forms_match_and_answer(width, sigma):
    for n in (1, 333, 1025):
        seq, fused = _multiary_case(width, sigma, n, True)
        _same(_multiary_case(width, sigma, n, False)[1], fused)
        _check_queries(fused, seq, n)


@pytest.mark.parametrize("width,sigma,fused", [(2, 256, True),
                                               (4, 1 << 16, False),
                                               (4, 2, True),
                                               (2, 2, False)])
def test_multiary_matches_reference(width, sigma, fused):
    seq, port = _multiary_case(width, sigma, 333, fused)
    ref = _jit(jm.build_multiary_wavelet_tree,
               jnp.asarray(seq.astype(np.uint32)), sigma=sigma, width=width,
               fused=fused)
    _same(port, _flat(ref))
    i = np.arange(0, 333, 7, dtype=np.int32)
    assert np.array_equal(multiary.mwt_access(port, i).numpy(),
                          np.asarray(jax.jit(jm.mwt_access)(ref,
                                                            jnp.asarray(i))))


def test_multiary_node_starts_match_reference():
    seq, _ = _multiary_case(2, 256, 1025, True)
    for width, nlevels in ((2, 4), (4, 2), (1, 9)):
        got = multiary._node_starts_multiary(torch.from_numpy(seq), width,
                                             nlevels)
        want = jm._node_starts_multiary(jnp.asarray(seq), width, nlevels)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_multiary_converter_round_trip():
    seq, port = _multiary_case(4, 1 << 16, 333, False)
    ref = _jit(jm.build_multiary_wavelet_tree,
               jnp.asarray(seq.astype(np.uint32)), sigma=1 << 16, width=4,
               fused=False)
    flat = _flat(ref)
    back = convert.multiary_to_reference(port)
    assert (back["n"], back["width"], back["nlevels"], back["chunk_syms"]) \
        == (ref.n, ref.width, ref.nlevels, ref.levels.chunk_syms)
    for name in convert.MULTIARY_LEAF_DTYPES:
        assert back[name].dtype == flat[name].dtype
        assert np.array_equal(back[name], flat[name])
    again = convert.multiary_from_reference(flat, ref.n, ref.width,
                                            ref.nlevels, device="cpu")
    _same(again, port)
    _check_queries(again, seq, 5)


# ---------------------------------------------------------------------------
# generalized rank/select and the d-way gather (paper Section 5.2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 33, 777, 1025])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_segmented_partition_gather_fields_oracle(n, width):
    rng = np.random.default_rng(n * 7 + width)
    d, nodes = 1 << width, 8
    nid = np.sort(rng.integers(0, nodes, n)).astype(np.int32)
    dig = rng.integers(0, d, n).astype(np.int32)
    starts = np.searchsorted(nid, np.arange(nodes)).astype(np.int32)
    args = (torch.from_numpy(dig), width, torch.from_numpy(nid),
            torch.from_numpy(starts), n)
    g = rank_select.segmented_partition_gather_fields(*args)
    assert g.dtype == torch.int32
    assert np.array_equal(g.numpy(),
                          np.argsort(nid * d + dig, kind="stable"))
    plan = rank_select.packed_field_counts(args[0], width, n)
    assert torch.equal(rank_select.segmented_partition_gather_fields(
        *args, plan=plan), g)
    if n == 777:                       # the reference itself, once a width
        want = jax.jit(
            lambda d_, v_, s_: jrs.segmented_partition_gather_fields(
                d_, width, v_, s_, n))(jnp.asarray(dig), jnp.asarray(nid),
                                       jnp.asarray(starts))
        assert np.array_equal(g.numpy(), np.asarray(want))
        jplan = _jit(jrs.packed_field_counts, jnp.asarray(dig), width=width,
                     n=n)
        assert np.array_equal(plan[0].numpy(),
                              np.asarray(jplan[0]).view(np.int32))
        assert np.array_equal(plan[1].numpy(), np.asarray(jplan[1]))
        got = rank_select.field_node_counts(*plan, width,
                                            torch.from_numpy(starts), n)
        want = jax.jit(lambda p_, c_, s_: jrs.field_node_counts(
            p_, c_, width, s_, n))(*jplan, jnp.asarray(starts))
        assert all(np.array_equal(a.numpy(), np.asarray(b))
                   for a, b in zip(got, want))


@functools.lru_cache(maxsize=None)
def _generalized_case(width: int, n: int):
    seq = np.random.default_rng(width * 10 + n).integers(
        0, 1 << width, n).astype(np.int32)
    ref = _jit(jrs.build_generalized, jnp.asarray(seq.astype(np.uint32)),
               width=width, n=n)
    return seq, ref, rank_select.build_generalized(torch.from_numpy(seq),
                                                   width, n)


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 130, 777])
def test_generalized_build_and_queries_match_reference(width, n):
    seq, ref, port = _generalized_case(width, n)
    _same(port, _flat(ref))
    plan = rank_select.packed_field_counts(torch.from_numpy(seq), width, n)
    _same(rank_select.build_generalized_from_counts(*plan, width=width, n=n),
          port)
    rng = np.random.default_rng(n)
    c = rng.integers(0, 1 << width, 64).astype(np.int32)
    i = rng.integers(0, n + 1, 64).astype(np.int32)
    i[:2] = [0, n]
    k = rng.integers(0, n + 3, 64).astype(np.int32)   # some past the count
    pos = np.arange(n, dtype=np.int32)
    jq = jax.jit(lambda g, c_, i_, k_, p_: (
        jrs.generalized_rank(g, c_, i_), jrs.generalized_select(g, c_, k_),
        jrs.generalized_access(g, p_)))
    want = jq(ref, jnp.asarray(c), jnp.asarray(i), jnp.asarray(k),
              jnp.asarray(pos))
    got = (rank_select.generalized_rank(port, c, i),
           rank_select.generalized_select(port, c, k),
           rank_select.generalized_access(port, pos))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(got[2].numpy(), seq)
    # scalar symbol, as the reference's other select branch takes it
    assert np.array_equal(
        rank_select.generalized_select(port, int(c[0]), k).numpy(),
        np.asarray(jax.jit(jrs.generalized_select)(
            ref, jnp.int32(int(c[0])), jnp.asarray(k))))


def test_generalized_converter_round_trip():
    seq, ref, port = _generalized_case(2, 777)
    flat = _flat(ref)
    back = convert.generalized_to_reference(port)
    assert (back["n"], back["width"], back["chunk_syms"]) == (777, 2, 128)
    for name in convert.GENERALIZED_LEAF_DTYPES:
        assert back[name].dtype == flat[name].dtype
        assert np.array_equal(back[name], flat[name])
    again = convert.generalized_from_reference(flat, 777, 2, device="cpu")
    i = np.tile(np.arange(0, 778, 97, dtype=np.int32), 4)
    c = np.repeat(np.arange(4, dtype=np.int32), len(i) // 4)
    assert torch.equal(rank_select.generalized_rank(again, c, i),
                       rank_select.generalized_rank(port, c, i))
    assert np.array_equal(rank_select.generalized_rank(again, c, i).numpy(),
                          [(seq[:b] == a).sum() for a, b in zip(c, i)])


@pytest.mark.parametrize("n", [1, 31, 33, 1000, 4096])
def test_rank_leftovers_match_reference(n):
    bits = np.random.default_rng(n).integers(0, 2, n).astype(np.uint8)
    jwords = jbitops.pack_bits(jbitops.pad_bits(jnp.asarray(bits)))
    words = bitops.pack_bits(bitops.pad_bits(torch.from_numpy(bits)))
    wide_j = jnp.concatenate([jwords, jnp.zeros(3, jnp.uint32)])
    wide = torch.cat([words, torch.zeros(3, dtype=torch.int32)])
    assert np.array_equal(rank_select.invert_words(wide, n).numpy(),
                          np.asarray(_jit(jrs.invert_words, wide_j,
                                          n=n)).view(np.int32))
    jbv = _jit(jrs.build_bitvector, jwords, n=n)
    bv = rank_select.build_bitvector(words, n)
    b = np.arange(bv.rank.num_blocks + 1)
    assert np.array_equal(rank_select.rank_at_block(bv.rank, b).numpy(),
                          np.asarray(jax.jit(jrs.rank_at_block)(
                              jbv.rank, jnp.asarray(b))))
    assert np.array_equal(
        rank_select._zero_rank_at_block(bv.rank, b).numpy(),
        np.asarray(jax.jit(jrs._zero_rank_at_block)(jbv.rank,
                                                     jnp.asarray(b))))
    assert rank_select.bitvector_bits(bv) == jrs.bitvector_bits(jbv)


def test_pack_fields_matches_reference():
    rng = np.random.default_rng(4)
    for width in (1, 2, 4, 8):
        for n in (1, 7, 33, 100):
            v = rng.integers(0, 1 << width, n).astype(np.int32)
            want = np.asarray(jbitops.pack_fields(jnp.asarray(v), width))
            got = bitops.pack_fields(torch.from_numpy(v), width)
            assert np.array_equal(got.numpy(), want.view(np.int32))
