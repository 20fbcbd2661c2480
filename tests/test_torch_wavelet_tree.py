"""Port's wavelet tree (Theorem 4.1) and the tree's kernels vs ``repro``.

The reference builds with ``use_kernels=False`` (its XLA fast path; the
default route needs a TPU check that this jax does not have). Trees are
compared leaf for leaf and bit for bit through ``repro_torch.convert``; the
port builds with and without its kernel route, whose wrappers run their
plain versions on the CPU. The ``wt_level`` and ``bitpack`` plain versions
are also held against the reference's oracles and, once each at a tiny
size, against the Pallas kernels in interpret mode. Every output is an
exact integer: every comparison is equality.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rank_select as jrs
from repro.core import wavelet_matrix as jwm
from repro.core import wavelet_tree as jwt
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import bitops, rank_select
from repro_torch.core import wavelet_matrix as twm
from repro_torch.core import wavelet_tree as twt
from repro_torch.kernels import bitpack, build, ops, ref, wt_level


def _flat(struct) -> dict:
    """Reference pytree → dict of numpy leaves keyed by dotted field path."""
    return {".".join(p.name for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(struct)[0]}


def _seq(sigma: int, n: int, seed: int, present: int | None = None):
    """n symbols below sigma; with ``present``, drawn from that many
    distinct symbols only, so most nodes are empty."""
    rng = np.random.default_rng(seed)
    if present is None:
        return rng.integers(0, sigma, n).astype(np.int32)
    alphabet = rng.choice(sigma, present, replace=False)
    return alphabet[rng.integers(0, present, n)].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _case(sigma: int, tau: int, n: int, present: int | None = None):
    seq = _seq(sigma, n, sigma + tau + n, present)
    ref_tree = jwt.build_wavelet_tree(jnp.asarray(seq.astype(np.uint32)),
                                      sigma, tau=tau, sample_rate=128,
                                      use_kernels=False)
    return seq, ref_tree, _flat(ref_tree)


def _assert_same_tree(port, ref_flat):
    got = convert.tree_to_reference(port)
    for name in convert.TREE_LEAF_DTYPES:
        assert got[name].dtype == ref_flat[name].dtype, name
        assert np.array_equal(got[name], ref_flat[name]), name


@pytest.mark.parametrize("sigma,n", [(37, 4999), (1000, 5000),
                                     (151_936, 5003)])
@pytest.mark.parametrize("tau", [3, 8])
@pytest.mark.parametrize("big_step", ["compose", "radix", "xla"])
def test_build_is_bit_identical(sigma, n, tau, big_step):
    seq, ref_tree, flat = _case(sigma, tau, n)
    for use_kernels in (False, True):
        port = twt.build_wavelet_tree(seq, sigma, tau=tau, big_step=big_step,
                                      sample_rate=128,
                                      use_kernels=use_kernels, device="cpu")
        assert (port.n, port.nbits) == (ref_tree.n, ref_tree.nbits)
        _assert_same_tree(port, flat)


def test_build_with_empty_nodes_is_bit_identical():
    """σ = 1000 (not a power of two) with 23 symbols present: most nodes
    are empty, and node starts repeat."""
    seq, _, flat = _case(1000, 4, 3001, present=23)
    for big_step in ("compose", "radix"):
        _assert_same_tree(twt.build_wavelet_tree(
            seq, 1000, tau=4, big_step=big_step, sample_rate=128,
            use_kernels=True, device="cpu"), flat)


@pytest.mark.parametrize("present", [None, 23])
def test_queries_match_reference_and_numpy(present):
    sigma, tau, n = 1000, 4, 3001
    seq, ref_tree, flat = _case(sigma, tau, n, present)
    port = convert.tree_from_reference(flat, n, ref_tree.nbits,
                                       sample_rate=128, device="cpu")
    rng = np.random.default_rng(11)
    pos = np.arange(n, dtype=np.int32)
    got = twt.wt_access(port, torch.from_numpy(pos))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), seq)
    assert np.array_equal(got.numpy(), np.asarray(
        jax.jit(jwt.wt_access)(ref_tree, pos)))
    c = rng.integers(0, sigma, 64).astype(np.int32)   # mostly absent symbols
    c[:8] = seq[rng.integers(0, n, 8)]
    c[8:10] = [0, sigma - 1]
    i = rng.integers(0, n + 1, 64).astype(np.int32)
    i[:2] = [0, n]
    got = twt.wt_rank(port, c, i).numpy()
    assert np.array_equal(got, np.asarray(jax.jit(jwt.wt_rank)(ref_tree, c,
                                                                i)))
    assert np.array_equal(got, [(seq[:b] == a).sum() for a, b in zip(c, i)])
    cc = seq[rng.integers(0, n, 64)]
    counts = np.bincount(seq, minlength=sigma)
    k = (rng.integers(0, 1 << 20, 64) % counts[cc]).astype(np.int32)
    k[0] = counts[cc[0]] - 1                          # last occurrence
    got = twt.wt_select(port, cc, k).numpy()
    # eager: jit of the select descent compiles for tens of seconds
    assert np.array_equal(got, np.asarray(jwt.wt_select(
        ref_tree, jnp.asarray(cc), jnp.asarray(k))))
    assert all(got[j] == np.flatnonzero(seq == cc[j])[k[j]]
               for j in range(64))


def test_tree_converter_round_trip():
    seq, ref_tree, flat = _case(37, 3, 4999)
    port = convert.tree_from_reference(flat, ref_tree.n, ref_tree.nbits,
                                       sample_rate=128, device="cpu")
    assert port.node_starts.dtype == torch.int32
    back = convert.tree_to_reference(port)
    assert (back["n"], back["nbits"]) == (ref_tree.n, ref_tree.nbits)
    for name in convert.TREE_LEAF_DTYPES:
        assert back[name].dtype == flat[name].dtype
        assert np.array_equal(back[name], flat[name])


def test_node_starts_and_level_nid_match_reference():
    seq, _, _ = _case(1000, 4, 3001, 23)
    for nbits in (10, 11):
        got = twt._node_starts_from_symbols(torch.from_numpy(seq), nbits)
        want = jwt._node_starts_from_symbols(jnp.asarray(seq), nbits)
        assert np.array_equal(got.numpy(), np.asarray(want))
        for l in (0, 1, 5, nbits - 1):
            assert np.array_equal(
                twt._level_nid(got, l, len(seq)).numpy(),
                np.asarray(jwt._level_nid(want, l, len(seq))))


def test_unported_tree_routes_raise():
    # fused=False is ported now (tests/test_torch_construction_variants.py)
    seq = np.arange(64, dtype=np.int32) % 16
    _assert_same_tree(twt.build_wavelet_tree(seq, 16, fused=False,
                                             device="cpu"),
                      convert.tree_to_reference(twt.build_wavelet_tree(
                          seq, 16, device="cpu")))
    with pytest.raises(ValueError):
        twt.build_wavelet_tree(seq, 16, big_step="bogus", device="cpu")
    with pytest.raises(ValueError):
        twt.build_wavelet_tree(seq.reshape(2, 32), 16, device="cpu")


# ---------------------------------------------------------------------------
# segmented_partition_gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,nodes", [(1, 1), (100, 4), (2049, 64),
                                     (3000, 300)])
def test_segmented_partition_gather_matches_reference(n, nodes):
    rng = np.random.default_rng(n + nodes)
    nid = np.sort(rng.integers(0, nodes, n)).astype(np.int32)
    starts = np.searchsorted(nid, np.arange(nodes)).astype(np.int32)
    bits = rng.integers(0, 2, n).astype(np.int32)
    words = bitops.pack_bits(bitops.pad_bits(torch.from_numpy(bits)))
    got = rank_select.segmented_partition_gather(
        words, torch.from_numpy(nid), torch.from_numpy(starts), n)
    jwords = jnp.asarray(words.numpy().view(np.uint32))
    want = jrs.segmented_partition_gather(jwords, jnp.asarray(nid),
                                          jnp.asarray(starts), n)
    assert np.array_equal(got.numpy(), np.asarray(want))
    order = np.lexsort((bits, nid))                  # stable per-node split
    assert np.array_equal(got.numpy(), order)


# ---------------------------------------------------------------------------
# wt_level_step_fused and bitpack (plain versions on the CPU)
# ---------------------------------------------------------------------------

def _level(n: int, nodes: int, seed: int):
    rng = np.random.default_rng(seed)
    nid = np.sort(rng.integers(0, nodes, n)).astype(np.int32)
    sub = rng.integers(0, 256, n).astype(np.int32)
    return sub, nid


@pytest.mark.parametrize("n", [1, 31, 1000, 1024, 1025, 5000])
@pytest.mark.parametrize("nodes", [1, 16, 256])
def test_wt_level_step_matches_oracles(n, nodes):
    sub, nid = _level(n, nodes, n + nodes)
    for shift in (0, 7):
        dest, bitmap = ops.wt_level_step_fused(
            torch.from_numpy(sub), torch.from_numpy(nid), shift, 2 * nodes, n)
        assert dest.shape == (n,) and bitmap.shape == (bitops.num_words(n),)
        jd, jb = jref.wt_level_step_ref(jnp.asarray(sub.astype(np.uint32)),
                                        jnp.asarray(nid), shift, n)
        assert np.array_equal(dest.numpy(), np.asarray(jd))
        assert np.array_equal(bitmap.numpy().view(np.uint32), np.asarray(jb))
        td, tb = ref.wt_level_step_ref(torch.from_numpy(sub),
                                       torch.from_numpy(nid), shift, n)
        assert torch.equal(td, dest) and torch.equal(tb, bitmap)


def test_wt_level_step_matches_pallas_interpret():
    """Once, tiny: against the one-launch Pallas level in interpret mode."""
    n, nodes, shift = 2100, 8, 3
    sub, nid = _level(n, nodes, 1)
    jd, jb = jops.wt_level_step_fused(jnp.asarray(sub.astype(np.uint32)),
                                      jnp.asarray(nid), shift, 2 * nodes, n,
                                      interpret=True)
    dest, bitmap = ops.wt_level_step_fused(torch.from_numpy(sub),
                                           torch.from_numpy(nid), shift,
                                           2 * nodes, n)
    assert np.array_equal(dest.numpy(), np.asarray(jd))
    assert np.array_equal(bitmap.numpy().view(np.uint32), np.asarray(jb))
    hist = wt_level.wt_counts_plain(torch.from_numpy(sub)[None],
                                    torch.from_numpy(nid)[None], shift,
                                    2 * nodes, n)
    assert hist.shape == (1, 3, 2 * nodes + 1)
    assert int(hist[0, :, :-1].sum()) == n           # padding: sentinel only


@pytest.mark.parametrize("n", [1, 31, 32, 1000, 1024, 1025, 70_001])
def test_bitpack_matches_oracles(n):
    bits = np.random.default_rng(n).integers(0, 2, (3, n)).astype(np.int32)
    bits[0] = 1
    got = ops.bitpack(torch.from_numpy(bits))
    assert got.dtype == torch.int32 and got.shape == (3, bitops.num_words(n))
    for r in range(3):
        want = jref.bitpack_ref(jnp.asarray(bits[r].astype(np.uint8)))
        assert np.array_equal(got[r].numpy().view(np.uint32),
                              np.asarray(want))
        assert torch.equal(got[r], ref.bitpack_ref(torch.from_numpy(bits[r])))


def test_bitpack_matches_pallas_interpret():
    bits = np.random.default_rng(3).integers(0, 2, 5000).astype(np.int32)
    want = jops.bitpack(jnp.asarray(bits), interpret=True)
    got = ops.bitpack(torch.from_numpy(bits))
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_tree_kernel_wrappers_reject_bad_inputs():
    z = torch.zeros((1, 10), dtype=torch.int32)
    with pytest.raises(ValueError):
        wt_level.wt_level(z, z, 0, 1024, 10)
    with pytest.raises(ValueError):
        wt_level.wt_level(z, z.long(), 0, 4, 10)
    with pytest.raises(ValueError):
        wt_level.wt_level(z, z, 0, 3, 10)             # odd bucket count
    with pytest.raises(ValueError):
        wt_level.wt_level(z, z, 0, 4, 10,
                          torch.zeros((1, 5), dtype=torch.int32))
    with pytest.raises(ValueError):
        bitpack.bitpack(torch.zeros((2, 5), dtype=torch.int32), 10)
    with pytest.raises(ValueError):
        bitpack.bitpack(torch.zeros((2, 5), dtype=torch.int64), 5)


def test_cpu_tree_build_never_launches_or_builds():
    build.reset_launches()
    seq, _, _ = _case(37, 3, 4999)
    twt.build_wavelet_tree(seq, 37, tau=3, big_step="radix",
                           use_kernels=True, device="cpu")
    assert build.launches == {name: 0 for name in build.launches}
    assert not build._loaded


# ---------------------------------------------------------------------------
# the wavelet matrix's radix and xla big steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma,tau", [(37, 4), (1 << 16, 8), (151_936, 8)])
@pytest.mark.parametrize("big_step", ["radix", "xla"])
def test_matrix_big_steps_match_reference_and_compose(sigma, tau, big_step):
    n = 3001
    seq = _seq(sigma, n, sigma)
    want = _flat(jwm.build_wavelet_matrix(jnp.asarray(seq.astype(np.uint32)),
                                          sigma, tau=tau, big_step=big_step,
                                          sample_rate=128, use_kernels=False))
    compose = convert.to_reference(twm.build_wavelet_matrix(
        seq, sigma, tau=tau, sample_rate=128, device="cpu"))
    for use_kernels in (False, True):
        got = convert.to_reference(twm.build_wavelet_matrix(
            seq, sigma, tau=tau, big_step=big_step, sample_rate=128,
            use_kernels=use_kernels, device="cpu"))
        for name in convert.LEAF_DTYPES:
            assert np.array_equal(got[name], want[name]), name
            assert np.array_equal(got[name], compose[name]), name


def test_matrix_radix_build_of_shard_rows():
    """The (S, n) shard layout: each row's radix big step ranks that row."""
    rows = _seq(5000, 3 * 2100, 4).reshape(3, 2100)
    batched = twm.build_wavelet_matrix(rows, 5000, big_step="radix",
                                       sample_rate=64, use_kernels=True,
                                       device="cpu")
    for r in range(3):
        one = twm.build_wavelet_matrix(rows[r], 5000, sample_rate=64,
                                       device="cpu")
        got = convert.to_reference(twm.tree_map(lambda x: x[r], batched))
        want = convert.to_reference(one)
        assert all(np.array_equal(got[k], want[k])
                   for k in convert.LEAF_DTYPES)
    assert torch.equal(twm.reverse_bits(torch.tensor([0b1101, 1]), 4),
                       torch.tensor([0b1011, 0b1000]))
