"""The single-pass level steps' inputs and formula vs numpy and ``repro``.

The one-launch ``wm_level_step`` and ``wt_level_step_fused`` take the
bases of a level from the build: every level's zero count per row (the
matrix) and the level's bucket starts (the tree). These tests hold those
hand-overs against numpy counts, the ops with them against the ops without
them and the reference's oracles (``repro.kernels.ref``), and the kernel's
placement formula, emulated in numpy on the wrapper's node table, against
the reference's destinations. The level that moves its own keys
(``wm_level_move``) is held against the destinations applied by a scatter,
its staging and stores emulated in numpy, and the matrix build that packs
a position below the field against the build without kernels and the
reference's step-by-step baseline. On the CPU the wrappers run their plain
versions; the kernels themselves are held against those on the card
(``test_torch_cuda.py``). Every comparison is equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core import wavelet_matrix as twm
from repro_torch.core import wavelet_tree as twt
from repro_torch.kernels import build, ops, ref, wm_level, wt_level


def _bits(keys: np.ndarray, shift: int) -> np.ndarray:
    return (keys.astype(np.int64) & 0xFFFFFFFF) >> shift & 1


def _level(n: int, l: int, seed: int):
    """Keys and non-decreasing node ids of a level with 2^l nodes, about
    half of them empty."""
    rng = np.random.default_rng(seed)
    nodes = 1 << l
    used = rng.choice(nodes, max(1, nodes // 2), replace=False)
    nid = np.sort(rng.choice(used, n)).astype(np.int32)
    sub = rng.integers(0, 256, n).astype(np.int32)
    return sub, nid


def _starts(sub: np.ndarray, nid: np.ndarray, shift: int,
            nbkt: int) -> np.ndarray:
    key = (nid.astype(np.int64) << 1) | _bits(sub, shift)
    hist = np.bincount(key, minlength=nbkt)
    return (np.cumsum(hist) - hist).astype(np.int32)


# ---------------------------------------------------------------------------
# what the builds hand over
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,lo,width", [(1, 0, 18), (1000, 0, 18),
                                        (8193, 3, 1), (5000, 0, 32),
                                        (12_289, 7, 9)])
def test_wm_level_zeros_equal_numpy(n, lo, width):
    keys = np.random.default_rng(n).integers(
        -(1 << 31), 1 << 31, (3, n)).astype(np.int32)
    keys[0] = 0
    keys[1] = -1
    got = wm_level.wm_level_zeros(torch.from_numpy(keys), lo, width, n)
    want = [[n - int(_bits(row, b).sum())
             for b in range(lo + width - 1, lo - 1, -1)] for row in keys]
    assert got.dtype == torch.int32 and got.tolist() == want


@pytest.mark.parametrize("big_step", ["compose", "radix"])
@pytest.mark.parametrize("sigma,tau", [(37, 4), (151_936, 8)])
def test_matrix_build_hands_numpy_totals_to_each_level(monkeypatch,
                                                       big_step, sigma, tau):
    """Every level, whether it moves its keys (``wm_level_move``, the
    level's bit at its own shift in the key) or writes destinations
    (``wm_level_step``), gets the zeros of its bit."""
    calls = []
    step, move = ops.wm_level_step, ops.wm_level_move

    def record(fn):
        def call(sub, shift, n, total_zeros=None):
            calls.append((sub.clone(), shift, n, total_zeros.clone()))
            return fn(sub, shift, n, total_zeros)
        return call

    monkeypatch.setattr(ops, "wm_level_step", record(step))
    monkeypatch.setattr(ops, "wm_level_move", record(move))
    seq = np.random.default_rng(sigma).integers(0, sigma, (3, 3001))
    wm = twm.build_wavelet_matrix(seq, sigma, tau=tau, big_step=big_step,
                                  use_kernels=True, device="cpu")
    nbits = twm.num_levels(sigma)
    assert len(calls) == nbits
    for l, (sub, shift, n, total) in enumerate(calls):
        want = (n - _bits(sub.numpy()[:, :n], shift).sum(-1)).tolist()
        assert total.dtype == torch.int32 and total.tolist() == want
        # the symbol's bit nbits - 1 - l: the count of the build's input
        assert want == (3001 - _bits(seq, nbits - 1 - l).sum(-1)).tolist()
    plain = twm.build_wavelet_matrix(seq, sigma, tau=tau, big_step=big_step,
                                     use_kernels=False, device="cpu")
    assert torch.equal(wm.zeros, plain.zeros)
    assert torch.equal(wm.bitvectors.rank.words, plain.bitvectors.rank.words)


@pytest.mark.parametrize("big_step", ["compose", "radix"])
@pytest.mark.parametrize("present", [None, 40])
def test_tree_build_hands_numpy_bucket_starts_to_each_level(
        monkeypatch, big_step, present):
    calls = []
    step = ops.wt_level_step_fused

    def record(sub, nid, shift, nbkt, n, bucket_starts=None):
        calls.append((sub.clone(), nid.clone(), shift, nbkt, n,
                      bucket_starts.clone()))
        return step(sub, nid, shift, nbkt, n, bucket_starts)

    monkeypatch.setattr(ops, "wt_level_step_fused", record)
    sigma, n = 151_936, 3001
    rng = np.random.default_rng(5)
    seq = (rng.integers(0, sigma, n) if present is None else
           rng.choice(rng.choice(sigma, present, replace=False), n))
    wt = twt.build_wavelet_tree(seq.astype(np.int32), sigma,
                                big_step=big_step, use_kernels=True,
                                device="cpu")
    moved = [l for l in range(9) if l != 7 or big_step == "compose"]
    assert [c[3] for c in calls] == [2 << l for l in moved]
    for sub, nid, shift, nbkt, n_, starts in calls:
        assert starts.dtype == torch.int32 and starts.shape == (nbkt,)
        assert np.array_equal(starts.numpy(), _starts(
            sub.numpy(), nid.numpy(), shift, nbkt))
    plain = twt.build_wavelet_tree(seq.astype(np.int32), sigma,
                                   big_step=big_step, use_kernels=False,
                                   device="cpu")
    assert torch.equal(wt.bitvectors.rank.words, plain.bitvectors.rank.words)


def _packed(rows: int, n: int, width: int, seed: int) -> np.ndarray:
    """(rows, n) keys as a build packs them: a ``width``-bit field above
    the key's position in ``idx_bits`` bits; an all-zero field in row 0."""
    idx_bits = max(1, (n - 1).bit_length())
    fld = np.random.default_rng(seed).integers(0, 1 << width, (rows, n))
    fld[0] = 0
    return ((fld << idx_bits) | np.arange(n)).astype(np.int32)


def _level_move_counts(**kw) -> dict:
    """The ``core.level_move`` counts by form of one kernel-route build on
    the CPU, and the build checked against ``use_kernels=False`` and
    ``fused=False``."""
    from repro_torch import obs
    from repro_torch.tree import tree_named_leaves
    obs.REGISTRY.reset()
    got = twm.build_wavelet_matrix(use_kernels=True, device="cpu", **kw)
    counts = {obs.parse_key(k)[1]["form"]: v for k, v in
              obs.REGISTRY.snapshot()["counters"].items()
              if k.startswith("core.level_move")}
    for other in (dict(use_kernels=False), dict(fused=False)):
        want = tree_named_leaves(twm.build_wavelet_matrix(
            device="cpu", **kw, **other))
        leaves = tree_named_leaves(got)
        assert leaves.keys() == want.keys()
        assert all(torch.equal(leaves[k], want[k]) for k in want), other
    return counts


@pytest.mark.parametrize("sigma,tau,shape,big_step,want", [
    # 16 + 1 levels move: the position rides below the field, but not in
    # the last chunk (no permutation is carried there)
    (151_936, 8, (3, 3001), "compose", {"packed": 16, "field": 1}),
    (151_936, 8, (3001,), "compose", {"packed": 16, "field": 1}),
    # 16 + 17 > 31 bits: the first chunk scatters the field and the
    # permutation as two arrays
    (151_936, 16, (2, (1 << 16) + 3), "compose",
     {"scatter": 16, "field": 1}),
    # a radix or xla big step carries no permutation: 7 + 7 + 1 levels move
    (151_936, 8, (3, 3001), "radix", {"field": 15}),
    (151_936, 8, (3, 3001), "xla", {"field": 15}),
    (37, 4, (4, 1), "compose", {"packed": 4, "field": 1}),
    (1000, 3, (2, 513), "compose", {"packed": 9}),
])
def test_matrix_build_moves_keys_in_the_form_its_shape_allows(
        sigma, tau, shape, big_step, want):
    seq = np.random.default_rng(sigma + tau).integers(0, sigma, shape)
    assert _level_move_counts(seq=seq, sigma=sigma, tau=tau,
                              big_step=big_step) == want


# ---------------------------------------------------------------------------
# the ops with the hand-overs, without them, and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 31, 8191, 8193, 3 * 8192 + 77])
@pytest.mark.parametrize("rows", [1, 3])
def test_wm_level_move_applies_the_level_destinations(n, rows):
    """Packed keys (an 8-bit field above the position), shifts at the
    packed field's bits and below them: the moved keys are the plain
    level's destinations, and the reference's, applied by a scatter; the
    bitmap and zeros are the plain level's."""
    keys = torch.from_numpy(_packed(rows, n, 8, n + rows))
    low = max(1, (n - 1).bit_length())
    for shift in (0, low, low + 3, low + 7):
        total = wm_level.wm_level_zeros_plain(keys, shift, 1, n)[:, 0]
        got = ops.wm_level_move(keys, shift, n, total)
        assert all(torch.equal(g, w) for g, w in zip(
            got, wm_level.wm_level_move_plain(keys, total, shift, n)))
        dest, bitmap, zeros = wm_level.wm_level_plain(keys, total, shift, n)
        assert torch.equal(got[1], bitmap) and torch.equal(got[2], zeros)
        moved = torch.empty_like(keys).scatter_(1, dest.long(), keys)
        assert torch.equal(got[0], moved)
        for r in range(rows):
            rd, _, _ = ref.wm_level_step_ref(keys[r], shift, n)
            assert torch.equal(got[0][r][rd.long()], keys[r])
        if rows == 1:                 # an (n,) row keeps its shape
            one = ops.wm_level_move(keys[0], shift, n, total[0])
            assert all(torch.equal(g, w[0]) for g, w in zip(one, got))



@pytest.mark.parametrize("n,shift", [(1, 0), (31, 7), (8191, 3), (8193, 0),
                                     (3 * 8192 + 77, 5)])
def test_wm_level_step_with_totals_matches_without_and_reference(n, shift):
    keys = np.random.default_rng(n).integers(0, 256, (3, n)).astype(np.int32)
    keys[0], keys[1] = 0, 255
    t = torch.from_numpy(keys)
    total = torch.from_numpy(
        (n - _bits(keys, shift).sum(-1)).astype(np.int32))
    got = ops.wm_level_step(t, shift, n, total)
    assert all(torch.equal(g, w) for g, w in zip(
        got, ops.wm_level_step(t, shift, n)))
    for r in range(3):
        jd, jb, jz = jref.wm_level_step_ref(
            jnp.asarray(keys[r].astype(np.uint32)), shift, n)
        assert np.array_equal(got[0][r].numpy(), np.asarray(jd))
        assert np.array_equal(got[1][r].numpy().view(np.uint32),
                              np.asarray(jb))
        assert int(got[2][r]) == int(jz)
        assert all(torch.equal(g[r], w) for g, w in zip(
            got, ref.wm_level_step_ref(t[r], shift, n)))


@pytest.mark.parametrize("n", [1, 31, 8191, 8193, 3 * 8192 + 77])
@pytest.mark.parametrize("l", [0, 1, 5, 8])
def test_wt_level_step_with_starts_matches_without_and_reference(n, l):
    sub, nid = _level(n, l, n + l)
    nbkt = 2 << l
    for shift in (0, 7):
        starts = torch.from_numpy(_starts(sub, nid, shift, nbkt))
        s, v = torch.from_numpy(sub), torch.from_numpy(nid)
        got = ops.wt_level_step_fused(s, v, shift, nbkt, n, starts)
        assert all(torch.equal(g, w) for g, w in zip(
            got, ops.wt_level_step_fused(s, v, shift, nbkt, n)))
        jd, jb = jref.wt_level_step_ref(jnp.asarray(sub.astype(np.uint32)),
                                        jnp.asarray(nid), shift, n)
        assert np.array_equal(got[0].numpy(), np.asarray(jd))
        assert np.array_equal(got[1].numpy().view(np.uint32), np.asarray(jb))
        assert all(torch.equal(g, w) for g, w in zip(
            got, ref.wt_level_step_ref(s, v, shift, n)))


def test_plain_tree_level_places_buckets_at_the_given_starts():
    """The plain level uses the given starts as its bucket bases: starts
    shifted by 5 shift every destination by 5."""
    sub, nid = _level(3000, 3, 9)
    starts = torch.from_numpy(_starts(sub, nid, 2, 16))
    s, v = torch.from_numpy(sub)[None], torch.from_numpy(nid)[None]
    base, _ = wt_level.wt_level(s, v, 2, 16, 3000, starts[None])
    moved, _ = wt_level.wt_level(s, v, 2, 16, 3000, starts[None] + 5)
    assert torch.equal(moved, base + 5)


# ---------------------------------------------------------------------------
# the kernel's formula on the wrapper's table, emulated in numpy
# ---------------------------------------------------------------------------

def _formula(bit: np.ndarray, nid: np.ndarray, table: np.ndarray):
    """dest(i) = s0 + zin if bit 0, s1 + (i - s0) - zin if bit 1, with zin
    = Z(i) - zs and Z(i) the zeros before i in the row."""
    z = np.cumsum(1 - bit) - (1 - bit)
    s0, s1, zs = (table[k][nid] for k in range(3))
    zin = z - zs
    return np.where(bit == 1, s1 + (np.arange(len(bit)) - s0) - zin,
                    s0 + zin)


@pytest.mark.parametrize("n", [1, 31, 8193, 3 * 8192 + 77])
@pytest.mark.parametrize("l", [0, 1, 5, 8])
def test_node_table_through_the_formula_gives_reference_dest(n, l):
    sub, nid = _level(n, l, 7 * n + l)
    nbkt, shift = 2 << l, 3
    starts = torch.from_numpy(_starts(sub, nid, shift, nbkt))
    table = wt_level.node_table(starts[None])[0].numpy()
    assert table.dtype == np.int32 and table.shape == (3, nbkt // 2)
    got = _formula(_bits(sub, shift), nid, table.astype(np.int64))
    jd, _ = jref.wt_level_step_ref(jnp.asarray(sub.astype(np.uint32)),
                                   jnp.asarray(nid), shift, n)
    assert np.array_equal(got, np.asarray(jd))


@pytest.mark.parametrize("n", [1, 8193, 3 * 8192 + 77])
def test_one_node_formula_gives_reference_matrix_dest(n):
    keys = np.random.default_rng(n).integers(0, 256, n).astype(np.int32)
    bit = _bits(keys, 6)
    table = np.array([[0], [int((bit == 0).sum())], [0]])
    got = _formula(bit, np.zeros(n, np.int64), table)
    jd, _, _ = jref.wm_level_step_ref(jnp.asarray(keys.astype(np.uint32)),
                                      6, n)
    assert np.array_equal(got, np.asarray(jd))


def _move_mode(keys: np.ndarray, shift: int, total: int) -> np.ndarray:
    """The move mode of ``zero_scan.cuh`` on one row, warp by warp: each
    warp's 1,024 keys (ones past n) staged, a zero at its rank among the
    warp's zeros, a one at 1,023 less its rank among the warp's ones; then
    the first ``real`` keys of the two runs stored, run place j < zeros
    (``stage[j]``) to Z(warp) + j and the others (``stage[1023 - (j -
    zeros)]``) to total + warp - Z(warp) + j - zeros."""
    n = len(keys)
    out = np.full(n, -7, np.int64)
    z_warp = 0                                  # Z(warp_base)
    for base in range(0, n, 1024):
        k = np.full(1024, -1, np.int64)
        k[:min(1024, n - base)] = keys[base:base + 1024]
        bit = (k & 0xFFFFFFFF) >> shift & 1
        z = np.cumsum(1 - bit) - (1 - bit)      # zeros before, in the warp
        zeros = int((bit == 0).sum())
        stage = np.empty(1024, np.int64)
        stage[np.where(bit == 1, 1023 - (np.arange(1024) - z), z)] = k
        real = min(1024, n - base)
        j = np.arange(real)
        out[np.where(j < zeros, z_warp + j,
                     total + base - z_warp + j - zeros)] = stage[
            np.where(j < zeros, j, 1023 - (j - zeros))]
        z_warp += zeros
    return out


@pytest.mark.parametrize("n", [1, 1023, 1025, 8193, 3 * 8192 + 77])
def test_move_mode_staging_and_stores_give_the_plain_moved_keys(n):
    keys = _packed(1, n, 8, 3 * n)[0]
    low = max(1, (n - 1).bit_length())
    for shift in (0, low + 2):
        total = n - int(_bits(keys, shift).sum())
        want, _, _ = wm_level.wm_level_move_plain(
            torch.from_numpy(keys)[None], torch.tensor([total],
                                                        dtype=torch.int32),
            shift, n)
        assert np.array_equal(_move_mode(keys, shift, total),
                              want[0].numpy())


def test_cpu_level_steps_never_launch_or_build():
    build.reset_launches()
    z = torch.zeros((2, 100), dtype=torch.int32)
    ops.wm_level_zeros(z, 5)
    ops.wm_level_step(z, 0, 100, torch.full((2,), 100, dtype=torch.int32))
    ops.wm_level_move(z, 0, 100, torch.full((2,), 100, dtype=torch.int32))
    ops.wt_level_step_fused(z, z, 0, 2, 100,
                            torch.tensor([[0, 100], [0, 100]],
                                         dtype=torch.int32))
    assert build.launches == {name: 0 for name in build.launches}
    assert not build._loaded
