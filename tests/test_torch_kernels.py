"""Port's kernel wrappers and plain versions vs ``repro.kernels``.

On the CPU every wrapper runs its kernel's plain version (the tensors lie
on the CPU), so these tests hold the wrapper contracts — padding, sentinels,
trimming, ragged N, W and Q — and the plain versions against the
reference's oracles (``repro.kernels.ref``) and, once each at a tiny size,
against the Pallas kernels in interpret mode. The CUDA kernels themselves
are held against their plain versions in ``test_torch_cuda.py``. All
outputs are exact integers: every comparison is equality.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.wavelet_matrix import build_wavelet_matrix as jbuild
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.wm_level import wm_apply_pallas, wm_counts_pallas
from repro_torch.core import bitops
from repro_torch.core.wavelet_matrix import build_wavelet_matrix
from repro_torch.kernels import build, ops, rank_build, ref, wm_level
from repro_torch.kernels import wm_quantile
from repro_torch.tree import tree_map


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(np.array(a))


def _u(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype in (np.int32, np.uint32):
        return a.view(np.uint32).astype(np.int64)
    if a.dtype in (np.int16, np.uint16):
        return a.view(np.uint16).astype(np.int64)
    return a.astype(np.int64)


def _level_rows(L: int, n: int, seed: int) -> np.ndarray:
    """(L, ceil(n/32)) uint32 packed rows: random, all-zero, all-one."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (L, n)).astype(np.uint8)
    bits[0] = 0
    if L > 1:
        bits[1] = 1
    pad = (-n) % 32
    bits = np.pad(bits, ((0, 0), (0, pad))).reshape(L, -1, 32)
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        -1).astype(np.uint32)


# ---------------------------------------------------------------------------
# rank_build_levels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 31, 128, 1000, 1025, 16384 + 7, 70000])
def test_rank_build_levels_matches_reference(n):
    words = _level_rows(4, n, n)
    sb, blk = ops.rank_build_levels(_t(words), n)
    jsb, jblk = jref.rank_build_levels_ref(jnp.asarray(words), n)
    assert sb.dtype == torch.int32 and blk.dtype == torch.int16
    assert np.array_equal(_u(sb), _u(jsb))
    assert np.array_equal(_u(blk), _u(jblk))
    tsb, tblk = ref.rank_build_levels_ref(_t(words), n)
    assert torch.equal(tsb, sb) and torch.equal(tblk, blk)
    # the single-row form is the same function at L = 1
    sb1, blk1 = ops.rank_build(_t(words[2]), n)
    assert torch.equal(sb1, sb[2]) and torch.equal(blk1, blk[2])


def test_rank_build_levels_wider_rows_are_trimmed():
    n = 1000
    words = _level_rows(3, n, 1)
    wide = np.pad(words, ((0, 0), (0, 50)))       # trailing zero words
    got = ops.rank_build_levels(_t(wide), n)
    want = ops.rank_build_levels(_t(words), n)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_rank_build_levels_matches_pallas_interpret():
    n = 3000
    words = _level_rows(3, n, 2)
    jsb, jblk = jops.rank_build_levels(jnp.asarray(words), n, interpret=True)
    sb, blk = ops.rank_build_levels(_t(words), n)
    assert np.array_equal(_u(sb), _u(jsb))
    assert np.array_equal(_u(blk), _u(jblk))


# ---------------------------------------------------------------------------
# wm_level_step
# ---------------------------------------------------------------------------

def _keys(rows: int, n: int, seed: int) -> np.ndarray:
    keys = np.random.default_rng(seed).integers(0, 256, (rows, n)).astype(
        np.uint32)
    keys[0] = 0
    if rows > 1:
        keys[1] = 255
    return keys


@pytest.mark.parametrize("n,shift", [(1, 0), (33, 7), (1000, 3), (1024, 0),
                                     (1025, 5), (5000, 1)])
def test_wm_level_step_matches_reference(n, shift):
    keys = _keys(3, n, n)
    dest, bitmap, total = ops.wm_level_step(_t(keys), shift, n)
    assert dest.shape == (3, n) and bitmap.shape == (3, bitops.num_words(n))
    for r in range(3):
        jd, jb, jz = jref.wm_level_step_ref(jnp.asarray(keys[r]), shift, n)
        assert np.array_equal(dest[r].numpy(), np.asarray(jd))
        assert np.array_equal(_u(bitmap[r]), _u(jb))
        assert int(total[r]) == int(jz)
        td, tb, tz = ref.wm_level_step_ref(_t(keys[r]), shift, n)
        assert torch.equal(td, dest[r]) and torch.equal(tb, bitmap[r])
        assert int(tz) == int(jz)
    # one unbatched row gives unbatched outputs
    d1, b1, z1 = ops.wm_level_step(_t(keys[2]), shift, n)
    assert torch.equal(d1, dest[2]) and torch.equal(b1, bitmap[2])
    assert z1.dim() == 0 and int(z1) == int(total[2])


def test_wm_level_phases_match_pallas_interpret():
    """Count/apply phases and the whole step vs the reference's one-launch
    and two-launch Pallas forms."""
    n, shift = 2500, 4
    keys = _keys(1, n, 3)[0]
    keys[:5] = 0
    jd, jb, jz = jops.wm_level_step_fused(jnp.asarray(keys), shift, n,
                                          interpret=True)
    jd2, jb2, jz2 = jops.wm_level_step(jnp.asarray(keys), shift, n,
                                       interpret=True)
    d, b, z = ops.wm_level_step(_t(keys), shift, n)
    for want in ((jd, jb, jz), (jd2, jb2, jz2)):
        assert np.array_equal(d.numpy(), np.asarray(want[0]))
        assert np.array_equal(_u(b), _u(want[1]))
        assert int(z) == int(want[2])
    counts = wm_level.wm_counts(_t(keys)[None], shift, n)
    assert counts.shape == (1, 3)                  # 2500 keys → 3 blocks
    assert int(counts.sum()) == int(jz)
    padded = np.full(3 * 1024, 0xFFFFFFFF, np.uint32)   # ones past n
    padded[:n] = keys
    jcounts = wm_counts_pallas(jnp.asarray(padded[None]), shift,
                               interpret=True)
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))


def test_wm_apply_plain_matches_pallas_interpret():
    """The apply phase's plain version, which the card kernel is held to,
    against the reference's wm_apply_pallas in interpret mode, once, tiny:
    2,500 keys in 3 blocks, the keys past n padded with ones, the block
    offsets and the total from numpy."""
    n, shift = 2500, 5
    keys = _keys(3, n, 11)[2]
    padded = np.full(3 * 1024, 0xFFFFFFFF, np.uint32)
    padded[:n] = keys
    counts = (1 - ((padded >> shift) & 1)).reshape(3, 1024).sum(1)
    zexcl = (np.cumsum(counts) - counts).astype(np.int32)
    total = np.array([[counts.sum()]], np.int32)
    jd, jb = wm_apply_pallas(jnp.asarray(padded[None]),
                             jnp.asarray(zexcl[None]), jnp.asarray(total),
                             shift, n, interpret=True)
    d, b = wm_level.wm_apply(_t(keys)[None], torch.from_numpy(zexcl)[None],
                             torch.from_numpy(total[0]), shift, n)
    assert np.array_equal(d[0].numpy(), np.asarray(jd)[0, :n])
    words = bitops.num_words(n)
    assert np.array_equal(_u(b[0]), _u(np.asarray(jb)[0, :words]))


def test_wm_level_padding_keys_read_as_ones():
    """Past n the count phase sees ones: 1000 zero keys count 1000 zeros,
    not 1024; and the bitmap keeps only the n real bits."""
    zeros = torch.zeros((1, 1000), dtype=torch.int32)
    assert wm_level.wm_counts(zeros, 3, 1000).tolist() == [[1000]]
    ones = torch.full((1, 1000), 255, dtype=torch.int32)
    assert wm_level.wm_counts(ones, 3, 1000).tolist() == [[0]]
    _, bitmap, total = ops.wm_level_step(ones, 3, 1000)
    assert int(total) == 0
    assert int(bitmap[0, -1]) == 0xFF             # 1000 = 31·32 + 8 bits


# ---------------------------------------------------------------------------
# wm_quantile_sharded
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stacked(num_shards: int, shard_bits: int, n: int, sigma: int):
    """(tokens, port stacked shards) of a random stream cut into shards."""
    size = 1 << shard_bits
    toks = np.random.default_rng(num_shards * 7 + sigma).integers(
        0, sigma, num_shards * size).astype(np.int32)
    toks[n:] = 0
    shards = build_wavelet_matrix(toks.reshape(num_shards, size), sigma,
                                  sample_rate=64, device="cpu")
    return toks, shards


def _queries(n: int, q: int, seed: int):
    rng = np.random.default_rng(seed)
    lo = rng.integers(-3, n + 3, q).astype(np.int32)
    hi = (lo + rng.integers(-2, n, q)).astype(np.int32)
    k = rng.integers(-2, n, q).astype(np.int32)
    if q >= 8:
        lo[:4], hi[:4] = [0, 5, n, n + 2], [n, 5, n, n + 9]   # full, empties
        k[4:8] = n + 50                                       # k past the end
    return lo, hi, k


def _numpy_quantile(toks, n, lo, hi, k):
    out = []
    for a, b, kk in zip(lo, hi, k):
        a, b = min(max(a, 0), n), min(max(b, 0), n)
        sl = np.sort(toks[a:max(a, b)])
        out.append(-1 if len(sl) == 0 else sl[min(max(kk, 0), len(sl) - 1)])
    return np.asarray(out)


@pytest.mark.parametrize("num_shards,shard_bits,n,sigma,q", [
    (1, 10, 1000, 37, 1), (3, 8, 700, 2, 255), (4, 9, 2048, 256, 257),
    (40, 6, 40 * 64 - 5, 1000, 100)])
def test_wm_quantile_sharded_matches_reference(num_shards, shard_bits, n,
                                               sigma, q):
    toks, shards = _stacked(num_shards, shard_bits, n, sigma)
    lo, hi, k = _queries(n, q, q)
    got = ops.wm_quantile_sharded_batch(shards, shard_bits, n, lo, hi, k)
    assert got.dtype == torch.int32 and got.shape == (q,)
    assert np.array_equal(got.numpy(), _numpy_quantile(toks, n, lo, hi, k))
    words = shards.bitvectors.rank.words.numpy().view(np.uint32)
    want = jref.wm_quantile_sharded_ref(jnp.asarray(words),
                                        jnp.asarray(shards.zeros.numpy()),
                                        shard_bits, n, jnp.asarray(lo),
                                        jnp.asarray(hi), jnp.asarray(k))
    assert np.array_equal(got.numpy(), np.asarray(want))
    tref = ref.wm_quantile_sharded_ref(shards.bitvectors.rank.words,
                                       shards.zeros, shard_bits, n, lo, hi, k)
    assert torch.equal(tref, got)


def test_wm_quantile_batch_is_the_sharded_kernel_at_one_shard():
    toks, shards = _stacked(1, 10, 1024, 300)
    one = tree_map(lambda x: x[0], shards)
    lo, hi, k = _queries(1024, 300, 4)
    got = ops.wm_quantile_batch(one, lo, hi, k)
    assert np.array_equal(got.numpy(), _numpy_quantile(toks, 1024, lo, hi, k))
    want = jref.wm_quantile_ref(
        jnp.asarray(one.bitvectors.rank.words.numpy().view(np.uint32)),
        jnp.asarray(one.zeros.numpy()), one.n, jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(k))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_wm_quantile_sharded_matches_pallas_interpret():
    """Once, tiny: 2 shards of 2^7 over σ = 8 (3 levels)."""
    shard_bits, n, sigma = 7, 250, 8
    size = 1 << shard_bits
    toks = np.random.default_rng(5).integers(0, sigma, 2 * size).astype(
        np.uint32)
    toks[n:] = 0
    jshards = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jbuild(jnp.asarray(toks[s * size:(s + 1) * size]), sigma,
               sample_rate=64, use_kernels=False) for s in range(2)])
    lo, hi, k = _queries(n, 20, 6)
    want = jops.wm_quantile_sharded_batch(jshards, shard_bits, n,
                                          jnp.asarray(lo), jnp.asarray(hi),
                                          jnp.asarray(k), interpret=True)
    tshards = build_wavelet_matrix(toks.astype(np.int32).reshape(2, size),
                                   sigma, sample_rate=64, device="cpu")
    got = ops.wm_quantile_sharded_batch(tshards, shard_bits, n, lo, hi, k)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_pad_rank_rows_contract():
    words = torch.arange(10, dtype=torch.int32).reshape(2, 5)
    sb = torch.ones((2, 1), dtype=torch.int32)
    blk = torch.ones((2, 2), dtype=torch.int16)
    w, s, b = ops._pad_rank_rows(words, sb, blk, nblocks=3)
    assert w.shape == (2, 12) and w.is_contiguous()
    assert torch.equal(w[:, :5], words) and int(w[:, 5:].abs().sum()) == 0
    w, _, _ = ops._pad_rank_rows(words, sb, blk, nblocks=1)
    assert w.shape == (2, 8)                       # rounded up to 4 words
    fits = torch.zeros((2, 8), dtype=torch.int32)
    w, _, _ = ops._pad_rank_rows(fits, sb, blk, nblocks=2)
    assert w.data_ptr() == fits.data_ptr()         # no copy when rows fit


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        rank_build.rank_build_levels(torch.zeros((2, 4), dtype=torch.int64),
                                     4)
    with pytest.raises(ValueError):
        rank_build.rank_build_levels(torch.zeros((2, 4), dtype=torch.int32),
                                     8)
    with pytest.raises(ValueError):
        wm_level.wm_counts(torch.zeros((1, 10), dtype=torch.int32), 32, 10)
    with pytest.raises(ValueError):
        wm_level.wm_apply(torch.zeros((1, 10), dtype=torch.int32),
                          torch.zeros((1, 2), dtype=torch.int32),
                          torch.zeros((1,), dtype=torch.int32), 0, 10)
    with pytest.raises(ValueError):            # an int32 block directory
        wm_quantile.quantile_operands(
            torch.zeros((2, 4), dtype=torch.int32),
            torch.zeros((2, 1), dtype=torch.int32),
            torch.zeros((2, 1), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32),
            num_shards=1, nbits=2, n=8, shard_bits=3)


def test_cpu_tensors_never_launch_or_build():
    build.reset_launches()
    toks, shards = _stacked(3, 8, 700, 2)
    ops.wm_quantile_sharded_batch(shards, 8, 700, [0], [10], [3])
    ops.rank_build_levels(_t(_level_rows(2, 100, 0)), 100)
    ops.wm_level_step(torch.zeros(50, dtype=torch.int32), 0, 50)
    assert build.launches == {name: 0 for name in build.launches}
    assert not build._loaded
