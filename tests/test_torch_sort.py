"""Port's stable integer sorts and the radix_rank wrapper vs ``repro``.

Inputs come from numpy seeds and go through ``repro.core.sort`` (on the
CPU its XLA routes) and the port's ``repro_torch.core.sort``. On the CPU
the port's ``ops.radix_rank`` runs the kernels' plain versions; those are
held against ``repro.kernels.ref.radix_rank_ref`` and, once at a tiny size,
the Pallas kernels in interpret mode. The CUDA kernels themselves are held
against the plain versions in ``test_torch_cuda.py``. Every output is an
exact integer: every comparison is equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scan as jscan
from repro.core import sort as jsort
from repro.kernels import ops as jops
from repro.kernels import radix_rank as jrr
from repro.kernels import ref as jref
from repro_torch.core import scan, sort
from repro_torch.kernels import build, ops, radix_rank, ref


def _digits(n: int, nb: int, seed: int, rows: int | None = None):
    shape = (n,) if rows is None else (rows, n)
    d = np.random.default_rng(seed).integers(0, nb, shape).astype(np.int32)
    if n > 2:
        d[..., :2] = [nb - 1, 0]
    return d


@pytest.mark.parametrize("nb", [8, 256, 512, 4096])
@pytest.mark.parametrize("n", [1000, 5000])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_counting_rank_matches_reference(nb, n, use_kernel):
    d = _digits(n, nb, nb + n)
    got = sort.counting_rank(torch.from_numpy(d), nb, use_kernel=use_kernel)
    assert got.dtype == torch.int32
    want = jsort.counting_rank(jnp.asarray(d), nb, use_kernel=False)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), np.asarray(
        jref.radix_rank_ref(jnp.asarray(d), nb)))


def test_counting_rank_rows_are_ranked_on_their_own():
    d = _digits(3000, 300, 1, rows=3)
    got = sort.counting_rank(torch.from_numpy(d), 300, use_kernel=True)
    assert got.shape == (3, 3000)
    for r in range(3):
        assert np.array_equal(got[r].numpy(), np.asarray(
            jsort.counting_rank(jnp.asarray(d[r]), 300, use_kernel=False)))
    small = _digits(100, 8, 2, rows=2)             # the vectorized route
    got = sort.counting_rank(torch.from_numpy(small), 8)
    for r in range(2):
        assert np.array_equal(got[r].numpy(), np.asarray(
            jsort.counting_rank(jnp.asarray(small[r]), 8)))


@pytest.mark.parametrize("nb,n,kernel", [(32, 5000, False),   # ≤ 32 buckets
                                         (300, 2048, False),  # n ≤ 4·512
                                         (1024, 5000, False), # > 512 buckets
                                         (33, 2049, True),
                                         (512, 5000, True)])
def test_counting_rank_reaches_the_kernel_where_the_reference_does(
        nb, n, kernel, monkeypatch):
    """The reference's routing (``repro.core.sort.counting_rank``): the
    kernel ranks only 32 < buckets ≤ 512 at n > 4·512; the rest takes the
    plain route, with the same destinations."""
    calls = []
    real = ops.radix_rank
    monkeypatch.setattr(ops, "radix_rank",
                        lambda d, b, s=None: calls.append(b) or real(d, b, s))
    d = _digits(n, nb, nb * n)
    got = sort.counting_rank(torch.from_numpy(d), nb, use_kernel=True)
    assert calls == ([nb] if kernel else [])
    assert np.array_equal(got.numpy(), np.asarray(
        jsort.counting_rank(jnp.asarray(d), nb, use_kernel=False)))


@pytest.mark.parametrize("backend", ["counting", "xla"])
@pytest.mark.parametrize("nb", [16, 256, 1024])
def test_sort_pass_matches_reference(backend, nb):
    n = 4001
    d = _digits(n, nb, nb)
    keys = np.random.default_rng(5).integers(0, 1 << 20, n).astype(np.int32)
    vals = np.arange(n, dtype=np.int32)[::-1].copy()
    got_k, (got_v,) = sort.sort_pass(torch.from_numpy(keys),
                                     torch.from_numpy(d), nb,
                                     (torch.from_numpy(vals),),
                                     backend=backend)
    want_k, (want_v,) = jsort.sort_pass(jnp.asarray(keys), jnp.asarray(d),
                                        nb, (jnp.asarray(vals),),
                                        backend=backend)
    assert np.array_equal(got_k.numpy(), np.asarray(want_k))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    perm = sort.sort_permutation(torch.from_numpy(d), nb, backend=backend)
    assert np.array_equal(perm.numpy(), np.asarray(
        jsort.sort_permutation(jnp.asarray(d), nb, backend=backend)))
    with pytest.raises(ValueError):
        sort.sort_pass(torch.from_numpy(keys), torch.from_numpy(d), nb,
                       backend="bogus")


@pytest.mark.parametrize("key_bits,bits_per_pass", [(12, 4), (20, 8),
                                                    (17, 8)])
def test_radix_sort_stable_matches_reference(key_bits, bits_per_pass):
    n = 3000
    keys = np.random.default_rng(key_bits).integers(
        0, 1 << key_bits, n).astype(np.int32)
    vals = np.random.default_rng(1).integers(0, 100, n).astype(np.int32)
    got_k, (got_v,) = sort.radix_sort_stable(
        torch.from_numpy(keys), key_bits, (torch.from_numpy(vals),),
        bits_per_pass=bits_per_pass)
    want_k, (want_v,) = jsort.radix_sort_stable(
        jnp.asarray(keys.astype(np.uint32)), key_bits, (jnp.asarray(vals),),
        bits_per_pass=bits_per_pass)
    assert np.array_equal(got_k.numpy(), np.asarray(want_k).astype(np.int32))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    assert np.array_equal(got_k.numpy(), np.sort(keys))


@pytest.mark.parametrize("nb,n", [(8, 900), (300, 3000), (1024, 5000)])
def test_bucket_ranks_matches_reference(nb, n):
    d = _digits(n, nb, n)
    got = sort.bucket_ranks(torch.from_numpy(d), nb)
    assert np.array_equal(got.numpy(), np.asarray(
        jsort.bucket_ranks(jnp.asarray(d), nb)))


def test_invert_permutation_matches_reference():
    dest = np.random.default_rng(0).permutation(777).astype(np.int32)
    got = sort._invert_permutation(torch.from_numpy(dest))
    assert np.array_equal(got.numpy(), np.asarray(
        jsort._invert_permutation(jnp.asarray(dest))))


@pytest.mark.parametrize("starts,n", [([0, 3, 3, 7], 10),     # an empty node
                                      ([0, 0, 5], 5),         # start == n
                                      ([0, 4, 4, 4], 4),      # trailing empties
                                      ([0], 1)])
def test_segment_ids_from_starts_matches_reference(starts, n):
    s = np.asarray(starts, np.int32)
    got = scan.segment_ids_from_starts(torch.from_numpy(s), n)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(
        jscan.segment_ids_from_starts(jnp.asarray(s), n)))
    x = torch.arange(5)
    assert torch.equal(scan.inclusive_sum(x), torch.cumsum(x, 0))


# ---------------------------------------------------------------------------
# ops.radix_rank and its two phases (plain versions on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 31, 1000, 1024, 1025, 5000])
@pytest.mark.parametrize("nb", [2, 33, 256, 512])
def test_radix_rank_matches_oracles(n, nb):
    d = _digits(n, nb, n * nb)
    got = ops.radix_rank(torch.from_numpy(d), nb)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert np.array_equal(got.numpy(), np.asarray(
        jref.radix_rank_ref(jnp.asarray(d), nb)))
    assert torch.equal(got, ref.radix_rank_ref(torch.from_numpy(d), nb))


def test_radix_rank_matches_pallas_interpret():
    """Once, tiny: both phases and the whole rank against the Pallas
    kernels in interpret mode, sentinel column included."""
    n, nb = 2500, 40
    d = _digits(n, nb, 7)
    want = jops.radix_rank(jnp.asarray(d), nb, interpret=True)
    got = ops.radix_rank(torch.from_numpy(d), nb)
    assert np.array_equal(got.numpy(), np.asarray(want))
    padded = np.full((1, 3 * 1024), nb, np.int32)
    padded[0, :n] = d
    jhist = jrr.radix_hist_pallas(jnp.asarray(padded), nb, interpret=True)
    hist = radix_rank.radix_hist(torch.from_numpy(d)[None], nb, n)
    assert np.array_equal(hist[0].numpy(), np.asarray(jhist))


def test_radix_apply_plain_matches_pallas_interpret():
    """The apply phase's plain version, which the card kernel is held to,
    against the reference's radix_apply_pallas in interpret mode, once,
    tiny: 2,500 digits in 3 tiles, the padding as the sentinel, the bucket
    bases and cross-tile offsets from numpy's histograms, and offsets =
    base + across."""
    n, nb = 2500, 40
    d = _digits(n, nb, 13)
    padded = np.full((1, 3 * 1024), nb, np.int32)
    padded[0, :n] = d
    hist = np.stack([np.bincount(t, minlength=nb + 1)
                     for t in padded[0].reshape(3, 1024)]).astype(np.int32)
    across = np.cumsum(hist, 0) - hist
    totals = hist.sum(0)
    base = (np.cumsum(totals) - totals)[None].astype(np.int32)
    want = jrr.radix_apply_pallas(jnp.asarray(padded), jnp.asarray(base),
                                  jnp.asarray(across.astype(np.int32)), nb,
                                  interpret=True)
    got = radix_rank.radix_apply(torch.from_numpy(d)[None],
                                 torch.from_numpy(base + across)[None], nb, n)
    assert np.array_equal(got[0].numpy(), np.asarray(want)[0, :n])


def test_radix_rank_batched_rows_and_sentinel():
    rows = _digits(2100, 256, 9, rows=4)
    got = ops.radix_rank(torch.from_numpy(rows), 256)
    for r in range(4):
        assert torch.equal(got[r], ref.radix_rank_ref(
            torch.from_numpy(rows[r]), 256))
    hist = radix_rank.radix_hist(torch.from_numpy(rows), 256, 2100)
    assert hist.shape == (4, 3, 257)
    # 3·1024 − 2100 padding digits fall in the sentinel column of the last
    # tile, none elsewhere
    assert hist[:, -1, 256].tolist() == [3 * 1024 - 2100] * 4
    assert int(hist[:, :-1, 256].sum()) == 0


def test_bucket_offsets_are_the_two_exclusive_scans():
    """One flat scan over the bucket-major layout equals the reference's
    bucket bases plus cross-tile offsets, row by row."""
    hist = torch.from_numpy(np.random.default_rng(0).integers(
        0, 50, (3, 7, 9)).astype(np.int32))
    got = radix_rank.bucket_offsets(hist)
    across = torch.cumsum(hist, 1) - hist
    totals = hist.sum(1)
    base = torch.cumsum(totals, 1) - totals
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), base[:, None, :] + across)


def test_bucket_offsets_scan_each_row_on_its_own():
    """Sums never cross rows: rows whose counts add up past 2^31 together,
    but not each on its own, still get exact int32 offsets."""
    hist = torch.full((4, 3, 5), 1 << 26, dtype=torch.int32)
    hist[:, 1, 2] = 7
    assert int(hist.long().sum()) >= 1 << 31
    got = radix_rank.bucket_offsets(hist)
    h = hist.long()
    across = torch.cumsum(h, 1) - h
    totals = h.sum(1)
    base = torch.cumsum(totals, 1) - totals
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), base[:, None, :] + across)


def test_radix_wrappers_reject_bad_inputs():
    d = torch.zeros((1, 10), dtype=torch.int32)
    with pytest.raises(ValueError):
        radix_rank.radix_hist(d, 513, 10)
    with pytest.raises(ValueError):
        radix_rank.radix_hist(d.long(), 4, 10)
    with pytest.raises(ValueError):
        radix_rank.radix_apply(d, torch.zeros((1, 2, 5), dtype=torch.int32),
                               4, 10)
    with pytest.raises(ValueError):
        ops.radix_rank(d, 1024)


def test_cpu_digits_never_launch_or_build():
    build.reset_launches()
    sort.counting_rank(torch.from_numpy(_digits(5000, 256, 0)), 256,
                       use_kernel=True)
    assert build.launches == {name: 0 for name in build.launches}
