"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test carries the ``cuda`` marker and skips inside the test when no
CUDA device is present. This file imports neither JAX nor ``repro``, so it
runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels' outputs are exact integers: every comparison of them is
equality. The LM serving path at the end has no kernel: its card logits are
held to the port's CPU run of the same params within the reference's
prefill/decode bound.
"""
import functools
import time

import numpy as np
import pytest
import torch

from repro_torch.analytics import build_sharded_analytics
from repro_torch.analytics.engine import sharded_range_quantile
from repro_torch.core import bitops, huffman, multiary, rank_select, sort
from repro_torch.core.wavelet_matrix import (build_wavelet_matrix,
                                             build_wavelet_matrix_levelwise)
from repro_torch.index import (build_sharded_index, sample_patterns,
                               suffix_array, suffix_array_naive)
from repro_torch.core.wavelet_tree import (build_wavelet_tree,
                                           build_wavelet_tree_dd,
                                           build_wavelet_tree_levelwise,
                                           wt_access, wt_rank, wt_select)
from repro_torch.kernels import (bitpack, build, ops, radix_rank, rank_build,
                                 ref, wm_level, wt_level)
from repro_torch.kernels import wm_quantile
from repro_torch.tree import tree_map, tree_named_leaves


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _queries(n: int, q: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    lo = rng.integers(-3, n + 3, q)
    hi = lo + rng.integers(-2, n, q)
    k = rng.integers(-2, n, q)
    lo[:4], hi[:4] = [0, 5, n, n + 2], [n, 5, n, n + 9]   # full, empties
    k[4:8] = n + 50                                       # k past the end
    return (torch.from_numpy(x.astype(np.int32)).to(dev) for x in (lo, hi, k))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 1000, 1025 * 32, 70001])
def test_rank_build_levels_kernel_matches_plain(n):
    dev = _card()
    bits = torch.from_numpy(np.random.default_rng(n).integers(
        0, 2, (5, n))).to(dev)
    bits[0], bits[1] = 0, 1
    words = bitops.pack_bits(bitops.pad_bits(bits))
    got = ops.rank_build_levels(words, n)
    want = rank_build.rank_build_levels_plain(words, bitops.num_words(n))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(
        ops.rank_build(words[3], n), ref.rank_build_ref(words[3], n)))


@pytest.mark.cuda
@pytest.mark.parametrize("n,shift", [(1, 0), (1000, 3), (1025, 7),
                                     (70001, 5)])
def test_wm_level_kernels_match_plain(n, shift):
    dev = _card()
    keys = torch.from_numpy(np.random.default_rng(n).integers(
        0, 256, (4, n)).astype(np.int32)).to(dev)
    keys[0], keys[1] = 0, 255
    counts = wm_level.wm_counts(keys, shift, n)
    assert torch.equal(counts, wm_level.wm_counts_plain(keys, shift, n))
    incl = torch.cumsum(counts, 1)
    zexcl, total = (incl - counts).int(), incl[:, -1].int()
    got = wm_level.wm_apply(keys, zexcl, total, shift, n)
    want = wm_level.wm_apply_plain(keys, zexcl, total, shift, n)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _wide_queries(n: int, shard_bits: int, seed: int, dev):
    """Queries over every shard count: the whole stream, and ranges that
    start and end inside shards and cover 1, 2, 31, 32, 33 and more."""
    rng = np.random.default_rng(seed)
    size = 1 << shard_bits
    spans = [1, 2, 31, 32, 33, 64, 65, 300, 10_000]
    lo = [0] + [int(rng.integers(0, n)) for _ in spans]
    hi = [n] + [a + s * size - int(rng.integers(0, size))
                for a, s in zip(lo[1:], spans)]
    k = [int(rng.integers(0, max(1, b - a))) for a, b in zip(lo, hi)]
    return (torch.tensor(x, dtype=torch.int32, device=dev)
            for x in (lo, hi, k))


@pytest.mark.cuda
@pytest.mark.parametrize("num_shards,shard_bits,n,sigma", [
    (1, 10, 1000, 37), (3, 8, 700, 2), (40, 6, 40 * 64 - 5, 1000),
    (300, 6, 300 * 64 - 9, 1000), (48, 11, 48 * 2048, 151_936)])
def test_wm_quantile_kernel_matches_plain(num_shards, shard_bits, n, sigma):
    """The kernel against the plain descent on the directories and the
    dense reference: S = 1, S = 300 (past the first kernel's cap of 256),
    ragged rows, and queries covering more than 32 shards."""
    dev = _card()
    size = 1 << shard_bits
    toks = np.random.default_rng(sigma).integers(
        0, sigma, num_shards * size).astype(np.int32)
    toks[n:] = 0
    shards = build_wavelet_matrix(toks.reshape(num_shards, size), sigma,
                                  sample_rate=64, device=dev)
    op = ops.quantile_operands(shards, shard_bits, n)
    for lo, hi, k in (_queries(n, 1001, num_shards, dev),
                      _wide_queries(n, shard_bits, num_shards, dev)):
        build.reset_launches()
        got = wm_quantile.wm_quantile_sharded(op, lo, hi, k)
        assert build.launches["wm_quantile_sharded"] == 1
        assert torch.equal(got, wm_quantile.wm_quantile_sharded_plain(
            op, lo, hi, k))
        assert torch.equal(got, ref.wm_quantile_sharded_ref(
            shards.bitvectors.rank.words, shards.zeros, shard_bits, n, lo, hi,
            k))
        assert torch.equal(got, ops.wm_quantile_sharded_batch(
            shards, shard_bits, n, lo, hi, k))
    if num_shards == 1:
        one = tree_map(lambda x: x[0], shards)
        assert torch.equal(ops.wm_quantile_batch(one, lo, hi, k),
                           ref.wm_quantile_ref(one.bitvectors.rank.words,
                                               one.zeros, one.n, lo, hi, k))


@pytest.mark.cuda
def test_wm_quantile_kernel_info():
    """The kernel spills nothing to local memory, and a grid that fills
    the card has room for every probe of the widest query."""
    dev = _card()
    info = wm_quantile.kernel_info(build.library("wm_quantile"))
    assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0
    max_blocks, over = wm_quantile.launch_shape(info, 300, dev)
    assert max_blocks >= torch.cuda.get_device_properties(
        dev).multi_processor_count
    assert over + info["register_probes"] >= 600


@pytest.mark.cuda
def test_wm_quantile_kernel_on_two_streams():
    """One engine's operands serve launches on two streams at once: each
    stream takes its own scratch, which its later launches reuse, so
    queries wide enough to use it (up to all 300 shards) still equal the
    plain descent on both."""
    dev = _card()
    num_shards, shard_bits, sigma = 300, 6, 1000
    size = 1 << shard_bits
    n = num_shards * size - 9
    toks = np.random.default_rng(3).integers(
        0, sigma, num_shards * size).astype(np.int32)
    toks[n:] = 0
    shards = build_wavelet_matrix(toks.reshape(num_shards, size), sigma,
                                  sample_rate=64, device=dev)
    op = ops.quantile_operands(shards, shard_bits, n)
    assert op.over > 0
    batches = []
    for seed in range(8):
        rng = np.random.default_rng(seed)
        lo = rng.integers(0, n // 4, 4096)
        hi = lo + rng.integers(n // 2, n, 4096)
        k = rng.integers(0, n, 4096)
        batches.append([torch.tensor(x, dtype=torch.int32, device=dev)
                        for x in (lo, hi, k)])
    want = [wm_quantile.wm_quantile_sharded_plain(op, *b) for b in batches]
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    torch.cuda.synchronize(dev)
    got = []
    for i, b in enumerate(batches):
        with torch.cuda.stream(streams[i % 2]):
            got.append(wm_quantile.wm_quantile_sharded(op, *b))
    torch.cuda.synchronize(dev)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert sorted(op.scratch) == sorted(s.cuda_stream for s in streams)


def _serving_engines(num_shards: int, shard_bits: int, sigma: int, dev):
    """One corpus as a card engine and a CPU engine (its last shard
    ragged), and the (Q, S) local ranges of a batch on the card."""
    size = 1 << shard_bits
    n = num_shards * size - 37
    toks = np.random.default_rng(num_shards).zipf(1.3, n) % sigma
    cuda = build_sharded_analytics(toks, sigma, shard_bits=shard_bits,
                                   device=dev)
    return toks, n, cuda


def _local(eng, lo, hi, available=None):
    from repro_torch.analytics.engine import local_ranges, mask_ranges
    los, his = mask_ranges(*local_ranges(eng.shard_bits, eng.num_shards,
                                         eng.n, lo, hi, eng.device),
                           available)
    return los.T.contiguous(), his.T.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("num_shards,shard_bits,q", [
    (8, 10, 32), (8, 10, 5), (128, 12, 4096), (300, 6, 777)])
def test_wm_count_kernel_matches_plain(num_shards, shard_bits, q):
    """``wm_count`` against its plain version on the same operands, at the
    front-end smoke's shape, a full-width-like batch, many small shards
    and ragged batches; symbol bounds below 0, past σ and reversed; a
    masked shard set; every answer equal."""
    from repro_torch.kernels import wm_count
    dev = _card()
    sigma = 3000
    _, n, eng = _serving_engines(num_shards, shard_bits, sigma, dev)
    lo, hi, _ = _queries(n, q, q, dev)
    rng = np.random.default_rng(q + 1)
    a = torch.from_numpy(rng.integers(-5, sigma + 5, q)).to(dev)
    b = torch.from_numpy(rng.integers(-5, 2 * sigma, q)).to(dev)
    mask = torch.from_numpy(rng.random(num_shards) > 0.25).to(dev)
    for available in (None, mask):
        los, his = _local(eng, lo, hi, available)
        build.reset_launches()
        got = wm_count.wm_count_sharded(eng.quantile, los, his, a, b)
        assert build.launches["wm_count"] == 1
        want = wm_count.wm_count_plain(eng.quantile, los, his, a, b)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_wm_count_and_topk_greedy_kernels_on_two_streams():
    """One engine's operands serve both kernels on two streams at once:
    each launch takes its own scratch and output."""
    from repro_torch.kernels import topk_greedy, wm_count
    dev = _card()
    _, n, eng = _serving_engines(64, 10, 500, dev)
    batches = [list(_queries(n, 128, seed, dev)) for seed in range(6)]
    ranges = [_local(eng, lo, hi) for lo, hi, _ in batches]
    want = [(wm_count.wm_count_plain(eng.quantile, los, his, 0, 250),
             topk_greedy.topk_greedy_plain(eng.quantile, los, his, 8, 48))
            for los, his in ranges]
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    torch.cuda.synchronize(dev)
    got = []
    for i, (los, his) in enumerate(ranges):
        with torch.cuda.stream(streams[i % 2]):
            got.append((wm_count.wm_count_sharded(eng.quantile, los, his, 0,
                                                  250),
                        topk_greedy.topk_greedy(eng.quantile, los, his, 8,
                                                48)))
    torch.cuda.synchronize(dev)
    for (gc, gt), (wc, wt) in zip(got, want):
        assert torch.equal(gc, wc)
        for x, y in zip(gt, wt):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("num_shards,shard_bits,q,budget,prune,k,sigma", [
    (8, 10, 32, 48, True, 8, 3000), (8, 10, 8, 24, True, 8, 3000),
    (8, 10, 7, 48, False, 8, 3000), (128, 12, 128, 48, True, 8, 3000),
    (300, 6, 33, None, True, 8, 3000), (8, 12, 9, None, True, 100, 151_936),
    (8, 12, 9, 2000, True, 8, 151_936), (8, 12, 9, 9000, True, 8, 151_936),
    (8, 12, 9, 9000, False, 20, 151_936)])
def test_topk_greedy_kernel_matches_plain(num_shards, shard_bits, q, budget,
                                          prune, k, sigma):
    """``topk_greedy`` against its plain version (``range_ops.
    topk_frontier`` on the same rows): the front-end smoke's budgets of 6k
    and 3k, no pruning, a full-width-like batch over 128 shards, the
    default budget over 300 shards, and budgets whose slots pass a block's
    default 48 KB of shared memory (over 1,535 pops): the default
    k·(nbits+1) at k = 100 and 18 levels (Qwen2's vocabulary), 2,000 pops
    (the larger shared memory a block opts into) and 9,000 (past it: the
    slots in global scratch); with and without a mask; syms, counts and
    found equal."""
    from repro_torch.kernels import topk_greedy
    dev = _card()
    _, n, eng = _serving_engines(num_shards, shard_bits, sigma, dev)
    lo, hi, _ = _queries(n, q, q + 7, dev)
    mask = torch.from_numpy(np.random.default_rng(q).random(num_shards)
                            > 0.25).to(dev)
    for available in (None, mask):
        los, his = _local(eng, lo, hi, available)
        build.reset_launches()
        got = topk_greedy.topk_greedy(eng.quantile, los, his, k, budget,
                                      prune)
        assert build.launches["topk_greedy"] == 1
        want = topk_greedy.topk_greedy_plain(eng.quantile, los, his, k,
                                             budget, prune)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_frontend_overload_smoke_meets_its_gate(tmp_path, capsys):
    """``launch.frontend --smoke --overload 5`` on the card, then the
    ``frontend.*:p99_ms<=250`` gate of ``scripts/ci_torch.sh`` on its
    capture: every op's accepted p99 within the 250 ms deadline."""
    from repro_torch.launch import frontend, obs as obs_cli
    _card()
    frontend.main(["--smoke", "--device", "cuda", "--overload", "5.0",
                   "--metrics-dir", str(tmp_path)])
    assert "✓" in capsys.readouterr().out
    rc = obs_cli.main([str(tmp_path), "--slo", "frontend.*:p99_ms<=250"])
    assert rc == 0, capsys.readouterr().out


@pytest.mark.cuda
def test_main_path_on_the_card_matches_the_cpu():
    dev = _card()
    toks = np.random.default_rng(0).integers(0, 5000, 6 * 4096 - 11)
    build.reset_launches()
    eng = build_sharded_analytics(toks, 5000, shard_bits=12, device=dev)
    lo, hi, k = _queries(len(toks), 2000, 1, dev)
    got = eng.range_quantile(lo, hi, k)
    assert all(build.launches[name] > 0 for name in (
        "rank_build_levels", "wm_level_step", "wm_quantile_sharded"))
    assert build.launches["wm_level_step"] == 13 + 1   # levels + totals
    cpu = build_sharded_analytics(toks, 5000, shard_bits=12, device="cpu")
    assert eng.quantile.launch_args and not cpu.quantile.launch_args
    assert eng.bits_per_token() == cpu.bits_per_token()
    a, b = tree_named_leaves(eng.shards), tree_named_leaves(cpu.shards)
    assert all(torch.equal(a[name].cpu(), b[name]) for name in a)
    assert torch.equal(got, sharded_range_quantile(eng.shards, 12, len(toks),
                                                   lo, hi, k))
    assert torch.equal(got.cpu(), cpu.range_quantile(lo.cpu(), hi.cpu(),
                                                     k.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 1000, 1024, 1025, 70001])
@pytest.mark.parametrize("nb", [2, 33, 256, 512])
def test_radix_rank_kernels_match_plain(n, nb):
    dev = _card()
    d = torch.from_numpy(np.random.default_rng(n + nb).integers(
        0, nb, (3, n)).astype(np.int32)).to(dev)
    d[0] = 0                                      # one bucket only
    hist = radix_rank.radix_hist(d, nb, n)
    assert torch.equal(hist, radix_rank.radix_hist_plain(d, nb, n))
    offsets = radix_rank.bucket_offsets(hist)
    got = radix_rank.radix_apply(d, offsets, nb, n)
    assert torch.equal(got, radix_rank.radix_apply_plain(d, offsets, nb, n))
    for r in range(3):
        assert torch.equal(got[r], ref.radix_rank_ref(d[r], nb))


def _twice(fn):
    """Run a kernel twice; both runs must give identical outputs."""
    first, second = fn(), fn()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    return first


def _level_keys(rows: int, n: int, seed: int, dev, strided: bool):
    """(rows, n) keys below 256, an all-zero and an all-one row first; with
    ``strided``, a view whose rows start off 16-byte alignment."""
    keys = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (rows, n + 1)).astype(np.int32)).to(dev)
    keys[0] = 0
    if rows > 1:
        keys[1] = 255
    return keys[:, 1:] if strided else keys[:, :n].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, rank_build.TILE - 1, rank_build.TILE + 1,
                               3 * rank_build.TILE + 100])
@pytest.mark.parametrize("strided", [False, True])
def test_rank_build_scan_walks_back_over_many_tiles(W, strided):
    """18 rows of up to 3 tiles and 100 words more, on rows longer than W
    (``strided``: starting off 16-byte alignment), run twice."""
    dev = _card()
    words = torch.from_numpy(np.random.default_rng(W).integers(
        -(1 << 31), 1 << 31, (18, W + 3)).astype(np.int32)).to(dev)
    words[0], words[1] = 0, -1
    rows = words[:, 1:] if strided else words
    got = _twice(lambda: rank_build.rank_build_levels(rows, W))
    want = rank_build.rank_build_levels_plain(rows, W)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(
        ops.rank_build(rows[5, :W], 32 * W),
        ref.rank_build_ref(rows[5, :W], 32 * W)))


def _zipf_digits(rows: int, n: int, nb: int, seed: int, dev, pad: int = 0):
    """(rows, n) Zipf-like digits below nb (a few buckets hold most), a
    third of row 0 in the last bucket; with ``pad``, a view of rows that
    start ``pad`` digits into wider rows."""
    rng = np.random.default_rng(seed)
    d = np.minimum(rng.zipf(1.2, (rows, n + pad)) - 1, nb - 1).astype(
        np.int32)
    d[0, pad:pad + n // 3] = nb - 1
    return torch.from_numpy(d).to(dev)[:, pad:]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 8191, 8193, 3 * 8192 + 100, 70001])
@pytest.mark.parametrize("nb", [2, 33, 256, 512])
def test_radix_scan_matches_plain(n, nb):
    dev = _card()
    d = _zipf_digits(3, n, nb, n + nb, dev, pad=1)
    totals = radix_rank.radix_totals(d, nb, n)
    assert torch.equal(totals, radix_rank.radix_totals_plain(d, nb, n))
    starts = radix_rank.exclusive_starts(totals)
    got = _twice(lambda: (radix_rank.radix_scan(d, nb, n, starts),))[0]
    assert torch.equal(got, radix_rank.radix_rank_plain(d, nb, n, starts))
    assert torch.equal(radix_rank.radix_rank(d, nb, n), got)
    for r in range(3):
        assert torch.equal(got[r], ref.radix_rank_ref(d[r], nb))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("nb", [2, 33, 256, 512])
def test_radix_scan_walks_back_over_many_tiles(rows, nb):
    """2^22 digits in 1 or 4 rows: the look-back of every bucket crosses
    512 or 128 tiles of 8,192 digits; with and without the starts."""
    dev = _card()
    n = (1 << 22) // rows
    d = _zipf_digits(rows, n, nb, rows * nb, dev)
    starts = radix_rank.exclusive_starts(radix_rank.radix_totals_plain(
        d, nb, n))
    got = _twice(lambda: (ops.radix_rank(d, nb, starts),))[0]
    assert torch.equal(got, radix_rank.radix_rank_plain(d, nb, n, starts))
    assert torch.equal(_twice(lambda: (ops.radix_rank(d, nb),))[0], got)
    assert torch.equal(got[rows - 1], ref.radix_rank_ref(d[rows - 1], nb))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 8191, 8193, 3 * 8192 + 100,
                               5 * 8192 + 77])
@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("strided", [False, True])
def test_wm_level_scan_matches_plain(n, rows, strided):
    dev = _card()
    keys = _level_keys(rows, n, n + rows, dev, strided)
    for shift in (0, 7):
        total = wm_level.wm_level_zeros(keys, shift, 1, n)[:, 0]
        assert torch.equal(total, wm_level.wm_level_zeros_plain(
            keys, shift, 1, n)[:, 0])
        got = _twice(lambda: wm_level.wm_level(keys, total, shift, n))
        want = wm_level.wm_level_plain(keys, total, shift, n)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert all(torch.equal(g, w) for g, w in zip(
            ops.wm_level_step(keys, shift, n), got))
        for r in range(rows):
            assert all(torch.equal(g[r], w) for g, w in zip(
                got, ref.wm_level_step_ref(keys[r], shift, n)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 12_289, 70_001])
def test_wm_level_zeros_matches_plain(n):
    dev = _card()
    keys = torch.from_numpy(np.random.default_rng(n).integers(
        0, 151_936, (3, n)).astype(np.int32)).to(dev)
    for lo, width in ((0, 18), (5, 1), (0, 32)):
        assert torch.equal(wm_level.wm_level_zeros(keys, lo, width, n),
                           wm_level.wm_level_zeros_plain(keys, lo, width, n))


@pytest.mark.cuda
def test_level_scans_walk_back_over_a_long_row():
    """One row of 2^22 + 123 keys: the look-back crosses 513 tiles."""
    dev = _card()
    n = (1 << 22) + 123
    rng = np.random.default_rng(4)
    keys = torch.from_numpy(rng.integers(0, 256, (1, n)).astype(
        np.int32)).to(dev)
    total = wm_level.wm_level_zeros(keys, 3, 1, n)[:, 0]
    got = _twice(lambda: wm_level.wm_level(keys, total, 3, n))
    assert all(torch.equal(g, w) for g, w in zip(
        got, wm_level.wm_level_plain(keys, total, 3, n)))
    nid = torch.from_numpy(np.sort(rng.integers(0, 256, (1, n)), 1).astype(
        np.int32)).to(dev)
    starts = wt_level.bucket_starts_plain(keys, nid, 3, 512, n)
    got = _twice(lambda: wt_level.wt_level(keys, nid, 3, 512, n, starts))
    assert all(torch.equal(g, w) for g, w in zip(
        got, wt_level.wt_level_plain(keys, nid, 3, 512, n, starts)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 8191, 8193, 3 * 8192 + 100,
                               5 * 8192 + 77, 70001])
@pytest.mark.parametrize("l", [0, 1, 5, 8])
def test_wt_level_scan_matches_plain(n, l):
    dev = _card()
    rng = np.random.default_rng(n + l)
    nodes, nbkt = 1 << l, 2 << l
    used = rng.choice(nodes, max(1, nodes // 2), replace=False)  # empties
    nid = torch.from_numpy(np.sort(rng.choice(used, (2, n)), 1).astype(
        np.int32)).to(dev)
    sub = torch.from_numpy(rng.integers(0, 256, (2, n)).astype(
        np.int32)).to(dev)
    sub[0] = 0                                    # all bits 0 in row 0
    for shift in (0, 7):
        starts = wt_level.bucket_starts_plain(sub, nid, shift, nbkt, n)
        got = _twice(lambda: wt_level.wt_level(sub, nid, shift, nbkt, n,
                                               starts))
        want = wt_level.wt_level_plain(sub, nid, shift, nbkt, n, starts)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert all(torch.equal(g, w) for g, w in zip(
            wt_level.wt_level(sub, nid, shift, nbkt, n), got))
        assert all(torch.equal(g, w) for g, w in zip(
            (got[0][1], got[1][1]),
            ref.wt_level_step_ref(sub[1], nid[1], shift, n)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 32, 1000, 1024, 1025, 70001])
def test_bitpack_kernel_matches_plain(n):
    dev = _card()
    bits = torch.from_numpy(np.random.default_rng(n).integers(
        0, 2, (3, n)).astype(np.int32)).to(dev)
    bits[0] = 1
    got = bitpack.bitpack(bits, n)
    assert torch.equal(got, bitpack.bitpack_plain(bits, n))
    assert torch.equal(got[2], ref.bitpack_ref(bits[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("big_step", ["compose", "radix", "xla"])
def test_tree_on_the_card_matches_the_cpu(big_step):
    dev = _card()
    sigma, n = 151_936, 9000
    seq = np.random.default_rng(1).integers(0, sigma, n).astype(np.int32)
    build.reset_launches()
    wt = build_wavelet_tree(seq, sigma, big_step=big_step, device=dev)
    # one launch a moved level l <= 8; a radix or xla big step leaves the
    # chunk's last level (7) unmoved
    assert build.launches["wt_level_step"] == (9 if big_step == "compose"
                                               else 8)
    assert build.launches["bitpack"] > 0
    # the radix big step of 256 buckets: one scan launch, given the starts
    assert build.launches["radix_rank"] == (1 if big_step == "radix" else 0)
    cpu = build_wavelet_tree(seq, sigma, big_step=big_step, device="cpu")
    a, b = tree_named_leaves(wt), tree_named_leaves(cpu)
    assert all(torch.equal(a[name].cpu(), b[name]) for name in a)
    i = torch.arange(0, n, 97, device=dev)
    assert np.array_equal(wt_access(wt, i).cpu().numpy(), seq[::97])
    c = torch.from_numpy(seq[::97]).to(dev)
    assert torch.equal(wt_rank(wt, c, i).cpu(), wt_rank(cpu, c.cpu(),
                                                        i.cpu()))
    assert torch.equal(wt_select(wt, c, torch.zeros_like(c)).cpu(),
                       wt_select(cpu, c.cpu(), torch.zeros_like(c.cpu())))


@pytest.mark.cuda
def test_matrix_radix_build_on_the_card_matches_compose():
    dev = _card()
    rows = torch.from_numpy(np.random.default_rng(2).integers(
        0, 5000, (4, 4096)).astype(np.int32)).to(dev)
    build.reset_launches()
    radix = build_wavelet_matrix(rows, 5000, big_step="radix", device=dev)
    assert build.launches["radix_rank"] == 2      # one totals + one scan
    compose = build_wavelet_matrix(rows, 5000, device=dev)
    a, b = tree_named_leaves(radix), tree_named_leaves(compose)
    assert all(torch.equal(a[name], b[name]) for name in a)


def _same_on_both(card, cpu) -> None:
    a, b = tree_named_leaves(card), tree_named_leaves(cpu)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[name].cpu(), b[name]) for name in b)


_TREE_FORMS = {
    "steps-compose": lambda s, sigma, dev: build_wavelet_tree(
        s, sigma, fused=False, device=dev),
    "steps-radix": lambda s, sigma, dev: build_wavelet_tree(
        s, sigma, big_step="radix", fused=False, device=dev),
    "steps-xla": lambda s, sigma, dev: build_wavelet_tree(
        s, sigma, big_step="xla", fused=False, device=dev),
    "levelwise": lambda s, sigma, dev: build_wavelet_tree_levelwise(
        s, sigma, device=dev),
    "levelwise-scatter": lambda s, sigma, dev: build_wavelet_tree_levelwise(
        s, sigma, fused=False, device=dev),
    "dd": lambda s, sigma, dev: build_wavelet_tree_dd(s, sigma, 8,
                                                      device=dev),
    "dd-scatter": lambda s, sigma, dev: build_wavelet_tree_dd(
        s, sigma, 8, fused=False, device=dev),
}


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(_TREE_FORMS))
def test_tree_forms_on_the_card_match_the_cpu(form):
    """Each other tree form at a ragged n (8 chunks of 1,125 for the
    domain decomposition) equals the same form on the CPU and the fused
    build; its bitmaps pack through ``bitpack``, and the unfused radix big
    step of 256 buckets ranks by a totals count and a scan."""
    dev = _card()
    sigma, n = 151_936, 9000
    seq = np.random.default_rng(3).integers(0, sigma, n).astype(np.int32)
    build.reset_launches()
    card = _TREE_FORMS[form](seq, sigma, dev)
    assert build.launches["bitpack"] > 0
    assert build.launches["radix_rank"] == (2 if form == "steps-radix"
                                            else 0)
    _same_on_both(card, _TREE_FORMS[form](seq, sigma, "cpu"))
    _same_on_both(card, build_wavelet_tree(seq, sigma, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("big_step", ["compose", "radix", "xla", None])
def test_matrix_baselines_on_the_card_match_the_cpu(big_step):
    """``fused=False`` with each big step (``None``: the levelwise
    baseline), on one ragged row and on stacked shards."""
    dev = _card()
    rng = np.random.default_rng(4)
    for seq in (rng.integers(0, 5000, 9001).astype(np.int32),
                rng.integers(0, 5000, (3, 4096)).astype(np.int32)):
        build.reset_launches()
        if big_step is None:
            card = build_wavelet_matrix_levelwise(seq, 5000, device=dev)
            cpu = build_wavelet_matrix_levelwise(seq, 5000, device="cpu")
        else:
            card = build_wavelet_matrix(seq, 5000, big_step=big_step,
                                        fused=False, device=dev)
            cpu = build_wavelet_matrix(seq, 5000, big_step=big_step,
                                       fused=False, device="cpu")
        assert build.launches["bitpack"] > 0
        # one big step of 256 buckets: a totals count and a scan
        assert build.launches["radix_rank"] == (2 if big_step == "radix"
                                                else 0)
        _same_on_both(card, cpu)
        _same_on_both(card, build_wavelet_matrix(seq, 5000, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 4])
def test_multiary_on_the_card_matches_the_cpu(width):
    dev = _card()
    sigma, n = 5000, 9001
    seq = np.random.default_rng(width).integers(0, sigma, n).astype(np.int32)
    card = multiary.build_multiary_wavelet_tree(seq, sigma, width=width,
                                                device=dev)
    cpu = multiary.build_multiary_wavelet_tree(seq, sigma, width=width,
                                               device="cpu")
    _same_on_both(card, cpu)
    _same_on_both(multiary.build_multiary_wavelet_tree(
        seq, sigma, width=width, fused=False, device=dev), cpu)
    i = np.arange(0, n, 37)
    c = seq[i]
    k = np.zeros_like(c)
    for fn, args in ((multiary.mwt_access, (i,)), (multiary.mwt_rank, (c, i)),
                     (multiary.mwt_select, (c, k))):
        got = fn(card, *(torch.from_numpy(a).to(dev) for a in args))
        assert torch.equal(got.cpu(), fn(cpu, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_huffman_on_the_card_matches_the_cpu(fused):
    dev = _card()
    sigma, n = 3000, 9001
    rng = np.random.default_rng(5)
    p = np.arange(1, sigma + 1) ** -1.1
    seq = rng.choice(sigma, size=n, p=p / p.sum()).astype(np.int32)
    codes, lengths, max_len = huffman.huffman_codebook(
        np.bincount(seq, minlength=sigma) + 1)
    build.reset_launches()
    card = huffman.build_huffman_wavelet_tree(seq, codes, lengths, max_len,
                                              fused=fused, device=dev)
    assert build.launches["bitpack"] == max_len
    _same_on_both(card, huffman.build_huffman_wavelet_tree(
        seq, codes, lengths, max_len, fused=fused, device="cpu"))
    levels = huffman.reference_huffman_levels(seq.astype(np.int64), codes,
                                              lengths, max_len)
    for l, want in enumerate(levels):
        got = bitops.unpack_bits(card.level(l).words, len(want))
        assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 4])
def test_generalized_queries_on_the_card_match_the_cpu(width):
    dev = _card()
    n = 9001
    rng = np.random.default_rng(width + 10)
    seq = rng.integers(0, 1 << width, n).astype(np.int32)
    cpu = rank_select.build_generalized(torch.from_numpy(seq), width, n)
    card = rank_select.build_generalized(torch.from_numpy(seq).to(dev),
                                         width, n)
    _same_on_both(card, cpu)
    c = rng.integers(0, 1 << width, 500)
    i = rng.integers(0, n + 1, 500)
    k = rng.integers(0, n + 2, 500)
    for fn, args in ((rank_select.generalized_rank, (c, i)),
                     (rank_select.generalized_select, (c, k)),
                     (rank_select.generalized_access, (i.clip(max=n - 1),))):
        got = fn(card, *(torch.from_numpy(a).to(dev) for a in args))
        assert torch.equal(got.cpu(), fn(cpu, *args))


@pytest.mark.cuda
def test_counting_rank_takes_long_rows_off_the_kernel(monkeypatch):
    """A row of ``radix_rank.MAX_ROW`` digits or more (here the bound is
    lowered to 4,096) is ranked by the argsort route on the card, with no
    kernel launch, instead of raising."""
    dev = _card()
    digits = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, 5000).astype(np.int32))
    monkeypatch.setattr(radix_rank, "MAX_ROW", 4096)
    build.reset_launches()
    got = sort.counting_rank(digits.to(dev), 256)
    assert build.launches["radix_rank"] == 0
    assert torch.equal(got.cpu(), sort.counting_rank(digits, 256))


# ragged corpora: (tokens, sigma, shard_bits); rows of m = 2^sb + 1 > 2,048
# symbols rank through the kernels, a tail shard is padded
_INDEX_CORPORA = {
    "tail": (3 * 4096 + 77, 151_936, 12),
    "one-shard": (3000, 5000, 12),
    "small-sigma": (5 * 2048 - 1, 3, 11),
}


@functools.lru_cache(maxsize=None)
def _index_pair(name: str):
    n, sigma, sb = _INDEX_CORPORA[name]
    dev = _card()
    toks = np.random.default_rng(n).zipf(1.2, n) % sigma
    build.reset_launches()
    card = build_sharded_index(toks, sigma, shard_bits=sb, device=dev)
    launches = dict(build.launches)
    cpu = build_sharded_index(toks, sigma, shard_bits=sb, device="cpu")
    return toks, card, cpu, launches


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_INDEX_CORPORA))
def test_index_on_the_card_matches_the_cpu(name):
    """The sharded index built on the card equals the CPU build leaf for
    leaf; its suffix array sorts rank through ``radix_rank`` (a totals
    count and a scan a pass), its matrix through ``wm_level_step`` (one a
    level and one totals count) and its marks through ``bitpack`` and
    ``rank_build_levels``."""
    _, card, cpu, launches = _index_pair(name)
    _same_on_both(card, cpu)
    assert launches["radix_rank"] > 0 and launches["radix_rank"] % 2 == 0
    nbits = card.shards.wm.nbits
    assert launches["wm_level_step"] == nbits + 1
    assert launches["bitpack"] == 1 and launches["rank_build_levels"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_INDEX_CORPORA))
def test_index_queries_on_the_card_match_the_cpu(name):
    toks, card, cpu, _ = _index_pair(name)
    pats, lens = sample_patterns(toks, 200, 8, pad=card.sigma, seed=4)
    lens[:2] = [0, 3]                        # the empty pattern, a pad run
    pats[1, :3] = card.sigma
    dev = card.device
    pt, lt = torch.from_numpy(pats).to(dev), torch.from_numpy(lens).to(dev)
    assert torch.equal(card.count(pt, lt).cpu(), cpu.count(pats, lens))
    assert torch.equal(card.count_by_shard(pt, lt).cpu(),
                       cpu.count_by_shard(pats, lens))
    assert torch.equal(card.locate(pt, lt, 4).cpu(),
                       cpu.locate(pats, lens, 4))
    drop = [0, card.num_shards - 1]
    got = card.drop_shards(drop).count_bounds(pt, lt)
    want = cpu.drop_shards(drop).count_bounds(pats, lens)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2049, 3 * 8192 + 5])
def test_suffix_array_on_the_card_matches_plain(n):
    """Batched rows of runs and random symbols: the kernel route (radix
    passes of 8 bits through ``radix_rank``) equals the argsort route and
    the numpy oracle."""
    dev = _card()
    rng = np.random.default_rng(n)
    rows = rng.integers(0, 300, (3, n)).astype(np.int32)
    rows[1] = 7
    rows[2, ::3] = 0
    t = torch.from_numpy(rows).to(dev)
    build.reset_launches()
    got = suffix_array(t, 300, device=dev)
    assert build.launches["radix_rank"] > 0
    assert torch.equal(got, suffix_array(t, 300, use_kernel=False,
                                         device=dev))
    assert np.array_equal(got[0].cpu().numpy(), suffix_array_naive(rows[0]))


# --------------------------------------------------------------------------
# the rest of the analytics engine, the store, snapshots, verify and repair
# --------------------------------------------------------------------------

_ENGINE_N, _ENGINE_SIGMA, _ENGINE_SB = 6 * 512, 300, 9     # 6 whole shards


@functools.lru_cache(maxsize=None)
def _engine_pair():
    dev = _card()
    toks = (np.random.default_rng(8).zipf(1.3, _ENGINE_N)
            % _ENGINE_SIGMA).astype(np.int64)
    args = dict(shard_bits=_ENGINE_SB, sample_rate=128)
    return (toks, build_sharded_analytics(toks, _ENGINE_SIGMA, device=dev,
                                          **args),
            build_sharded_analytics(toks, _ENGINE_SIGMA, device="cpu",
                                    **args))


def _engine_queries(dev):
    rng = np.random.default_rng(12)
    lo = rng.integers(-3, _ENGINE_N + 3, 40)
    hi = lo + rng.integers(-2, _ENGINE_N, 40)
    lo[:3], hi[:3] = [0, 9, _ENGINE_N], [_ENGINE_N, 9, _ENGINE_N]
    k = rng.integers(-2, _ENGINE_N, 40)
    return [torch.from_numpy(x.astype(np.int32)).to(dev) for x in (lo, hi, k)]


def _equal_on_both(got, want):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal_on_both(g, w)
    else:
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert torch.equal(got.cpu(), want)


_ENGINE_OPS = {
    "histogram": lambda e, lo, hi, k: e.range_histogram(lo, hi),
    "topk": lambda e, lo, hi, k: e.range_topk(lo, hi, 8),
    "distinct": lambda e, lo, hi, k: e.range_distinct(lo, hi),
    "topk_greedy": lambda e, lo, hi, k: e.range_topk_greedy(lo, hi, 8),
    "topk_greedy_budget": lambda e, lo, hi, k: e.range_topk_greedy(
        lo, hi, 4, budget=40, prune=False),
    "bracket": lambda e, lo, hi, k: e.range_quantile_bracket(lo, hi, k, 5),
    "count_bounds": lambda e, lo, hi, k: e.range_count_bounds(lo, hi, 7,
                                                              200),
    "histogram_bounds": lambda e, lo, hi, k: e.range_histogram_bounds(lo,
                                                                      hi),
    "coverage": lambda e, lo, hi, k: e.coverage(lo, hi),
}


@pytest.mark.cuda
@pytest.mark.parametrize("degraded", [False, True])
@pytest.mark.parametrize("op", sorted(_ENGINE_OPS))
def test_engine_ops_on_the_card_match_the_cpu(op, degraded):
    _, card, cpu = _engine_pair()
    if degraded:
        card, cpu = card.drop_shards([1, 4]), cpu.drop_shards([1, 4])
    lo, hi, k = _engine_queries(card.device)
    _equal_on_both(_ENGINE_OPS[op](card, lo, hi, k),
                   _ENGINE_OPS[op](cpu, lo.cpu(), hi.cpu(), k.cpu()))


@pytest.mark.cuda
def test_add_shards_on_the_card_takes_new_operands():
    """Four shards plus two built on their own equal the six-shard engine,
    and the grown engine's kernel quantiles equal its plain descent."""
    toks, card, _ = _engine_pair()
    dev = card.device
    cut = 4 * 512
    first = build_sharded_analytics(toks[:cut], _ENGINE_SIGMA,
                                    shard_bits=_ENGINE_SB, sample_rate=128,
                                    device=dev)
    new = build_sharded_analytics(toks[cut:], _ENGINE_SIGMA,
                                  shard_bits=_ENGINE_SB, sample_rate=128,
                                  device=dev)
    grown = first.add_shards(new.shards, _ENGINE_N - cut)
    _same_on_both(grown.shards, tree_map(lambda x: x.cpu(), card.shards))
    lo, hi, k = _engine_queries(dev)
    build.reset_launches()
    got = grown.range_quantile(lo, hi, k)
    assert build.launches["wm_quantile_sharded"] == 1
    assert torch.equal(got, sharded_range_quantile(
        grown.shards, _ENGINE_SB, _ENGINE_N, lo, hi, k))


@pytest.mark.cuda
def test_store_additions_on_the_card_match_the_cpu():
    toks, _, _ = _engine_pair()
    from repro_torch.data import build_compressed_corpus, token_histogram
    card = build_compressed_corpus(toks, _ENGINE_SIGMA,
                                   shard_bits=_ENGINE_SB, device=_card())
    cpu = build_compressed_corpus(toks, _ENGINE_SIGMA,
                                  shard_bits=_ENGINE_SB, device="cpu")
    got = card.decode_slice(500, 1000)
    assert np.array_equal(got.cpu().numpy(), toks[500:1500])
    _equal_on_both(token_histogram(card), token_histogram(cpu))
    lo, hi, _ = _engine_queries(card.shard_counts.device)
    _equal_on_both(card.range_topk(lo, hi, 5),
                   cpu.range_topk(lo.cpu(), hi.cpu(), 5))
    _equal_on_both(card.range_distinct(lo, hi),
                   cpu.range_distinct(lo.cpu(), hi.cpu()))


@pytest.mark.cuda
def test_repair_on_the_card_serves_kernel_quantiles_of_the_new_directories():
    """A superblock entry changed on the card: verify names it, the repair
    launches ``rank_build_levels`` once for every level of every shard, and
    the repaired engine's kernel quantiles (operands taken anew) equal the
    plain descent and the engine before the fault."""
    import dataclasses
    from repro_torch.robust import repair_analytics, verify_analytics
    _, card, cpu = _engine_pair()
    sb = card.shards.bitvectors.rank.superblock.clone()
    sb[2, 3, 0] += 1000
    shards = card.shards
    bad_rank = dataclasses.replace(shards.bitvectors.rank, superblock=sb)
    bad = dataclasses.replace(card, quantile=None, shards=dataclasses.replace(
        shards, bitvectors=dataclasses.replace(shards.bitvectors,
                                               rank=bad_rank)))
    report = verify_analytics(bad)
    assert [v.structure for v in report.violations] == \
        ["shard2/level3.rank.superblock"] and report.repairable
    lo, hi, k = _engine_queries(card.device)
    build.reset_launches()
    fixed = repair_analytics(bad)
    assert build.launches["rank_build_levels"] == 1
    _same_on_both(fixed.shards, cpu.shards)
    build.reset_launches()
    got = fixed.range_quantile(lo, hi, k)
    assert build.launches["wm_quantile_sharded"] == 1
    assert torch.equal(got, sharded_range_quantile(
        fixed.shards, _ENGINE_SB, _ENGINE_N, lo, hi, k))
    assert torch.equal(got, card.range_quantile(lo, hi, k))
    assert verify_analytics(fixed).ok


@pytest.mark.cuda
def test_snapshot_from_the_card_loads_on_the_cpu_and_back(tmp_path):
    from repro_torch.analytics import load_analytics, save_analytics
    from repro_torch.robust import tree_checksums
    _, card, cpu = _engine_pair()
    save_analytics(card, tmp_path / "card")
    on_cpu = load_analytics(tmp_path / "card", device="cpu")
    _same_on_both(card.shards, on_cpu.shards)
    assert tree_checksums(on_cpu.shards) == tree_checksums(cpu.shards)
    save_analytics(on_cpu, tmp_path / "cpu")
    back = load_analytics(tmp_path / "cpu", device=card.device)
    _same_on_both(back.shards, cpu.shards)
    lo, hi, k = _engine_queries(card.device)
    build.reset_launches()
    assert torch.equal(back.range_quantile(lo, hi, k),
                       card.range_quantile(lo, hi, k))
    assert build.launches["wm_quantile_sharded"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("deep", [False, True])
def test_index_repair_on_the_card_matches_the_cpu(deep):
    """Both repairs on the card give the index back leaf for leaf, equal to
    the CPU repair; the deep one packs its marks through ``bitpack``."""
    from repro_torch.robust import repair_sharded_index, verify_sharded_index
    _, card, cpu, _ = _index_pair("tail")
    assert verify_sharded_index(card).ok
    build.reset_launches()
    fixed = repair_sharded_index(card, deep=deep)
    assert build.launches["rank_build_levels"] >= 1
    assert build.launches["bitpack"] == (1 if deep else 0)
    _same_on_both(fixed.shards, cpu.shards)
    _same_on_both(fixed.shards, repair_sharded_index(cpu, deep=deep).shards)


# --------------------------------------------------------------------------
# ingest and the query front-end on the card
# --------------------------------------------------------------------------

_INGEST_N, _INGEST_SIGMA, _INGEST_SB = 1500, 37, 8      # 5 shards + a tail


def _ingest(kind, directory, device, toks):
    from repro_torch.ingest import analytics_ingester, index_ingester
    if kind == "analytics":
        ing = analytics_ingester(directory, _INGEST_SIGMA,
                                 shard_bits=_INGEST_SB, device=device)
    else:
        ing = index_ingester(directory, _INGEST_SIGMA, shard_bits=_INGEST_SB,
                             sample_rate=16, seam_overlap=7, device=device)
    ing.recover()
    for a, b in ((0, 100), (100, 700), (700, _INGEST_N)):   # ragged batches
        ing.append_tokens(toks[a:b])
    ing.flush()
    return ing


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["analytics", "index"])
def test_card_ingest_writes_the_cpu_ingest(kind, tmp_path):
    """The same stream ingested on the card and on the CPU: the same
    manifest lines, the same shard files, the same engine; the card's
    build launched its kernels."""
    dev = _card()
    toks = np.random.default_rng(21).integers(0, _INGEST_SIGMA,
                                              _INGEST_N).astype(np.int64)
    build.reset_launches()
    card = _ingest(kind, tmp_path / "card", dev, toks)
    launched = dict(build.launches)
    cpu = _ingest(kind, tmp_path / "cpu", "cpu", toks)
    assert launched["wm_level_step"] > 0 and launched["rank_build_levels"] > 0
    if kind == "index":
        # at 256-token shards every suffix-array pass has at most 32
        # buckets: the vectorized route, no radix_rank
        assert launched["bitpack"] > 0
    assert (tmp_path / "card" / "manifest.jsonl").read_bytes() == (
        tmp_path / "cpu" / "manifest.jsonl").read_bytes()
    names = sorted(p.name for p in (tmp_path / "cpu" / "shards").iterdir())
    assert names == sorted(
        p.name for p in (tmp_path / "card" / "shards").iterdir())
    for name in names:
        with np.load(tmp_path / "card" / "shards" / name) as a, \
                np.load(tmp_path / "cpu" / "shards" / name) as b:
            assert a.files == b.files
            for key in a.files:
                assert a[key].dtype == b[key].dtype
                assert np.array_equal(a[key], b[key]), (name, key)
    got, want = card.engine(), cpu.engine()
    assert got.device.type == "cuda"
    _same_on_both(got.shards, want.shards)


@pytest.mark.cuda
def test_wm_quantile_kernel_answers_padding_lanes_neutrally():
    """lo == hi == 0 lanes (the front-end's bucket padding) give -1 from
    the quantile kernel and 0 from counts, beside live lanes."""
    dev = _card()
    toks, card, cpu = _engine_pair()
    lo = torch.zeros(32, dtype=torch.int32, device=dev)
    hi, k = torch.zeros_like(lo), torch.zeros_like(lo)
    lo[:3] = torch.tensor([0, 17, 600], device=dev)
    hi[:3] = torch.tensor([_ENGINE_N, 1700, 2400], device=dev)
    k[:3] = torch.tensor([5, 300, 1799], device=dev)
    build.reset_launches()
    q = card.range_quantile(lo, hi, k)
    assert build.launches["wm_quantile_sharded"] == 1
    assert (q[3:] == -1).all()
    assert q[:3].tolist() == [int(np.sort(toks[a:b])[c]) for a, b, c in
                              ((0, _ENGINE_N, 5), (17, 1700, 300),
                               (600, 2400, 1799))]
    counts = card.range_count(lo, hi, 0, _ENGINE_SIGMA)
    assert (counts[3:] == 0).all() and counts[:3].tolist() == [
        _ENGINE_N, 1683, 1800]


@pytest.mark.cuda
def test_batch_runner_back_to_back_batches_on_the_card():
    """Batches of different contents run back to back on a card engine:
    each call's device block holds its own batch, padded with zeros, and
    the padding lanes of a quantile batch answer -1."""
    from repro_torch.serving import BatchRunner
    _card()
    _, card, _ = _engine_pair()
    runner = BatchRunner((8, 1 << 20))
    big = 1 << 20
    batches = [np.full((4, big), v, np.int32) for v in (1, 2, 3)]
    for b, v in zip(batches, (1, 2, 3)):
        b[:, ::7] = -v
    seen = []

    def keep(e, q):
        seen.append(q.clone())
        return q[0], q[1], q[2].float()

    for b in batches + [batches[0][:, :5]]:
        runner.run("keep", keep, card, b, b.shape[1])
    assert all(q.is_cuda for q in seen)
    for q, b in zip(seen, batches):
        assert torch.equal(q.cpu(), torch.from_numpy(b))
    assert seen[3].shape == (4, 8) and seen[3][:, 5:].abs().sum() == 0
    assert torch.equal(seen[3][:, :5].cpu(),
                       torch.from_numpy(batches[0][:, :5]))
    a, b, cov = runner.run(("quantile", 0),
                           lambda e, q: (e.range_quantile(q[0], q[1], q[2]),
                                         q[3], q[0].float()),
                           card, np.array([[0], [_ENGINE_N], [4], [0]],
                                          np.int32), 1)
    assert isinstance(a, np.ndarray) and a.shape == (8,)
    assert (a[1:] == -1).all() and runner.compiled == 3


def _fe_script(fe, clock, n):
    """A FakeClock scenario through every path of the front-end: a mixed
    queue, a burst that climbs the ladder, an expired shed, the calm, and
    a slow shard that opens its breaker."""
    from repro_torch.robust import inject_shard_latency
    tickets = []

    def drain():
        while fe.pump():
            clock.advance(0.01)

    for i in range(3):                          # level 0: exact quantiles
        tickets.append(fe.submit("quantile", 5 * i, n - 11 * i, k=33 * i,
                                 deadline_s=10.0))
    drain()
    for i in range(4):
        tickets.append(fe.submit("count", i, n - i, sym_lo=i, sym_hi=200,
                                 deadline_s=10.0))
        tickets.append(fe.submit("quantile", 7 * i, n - 3 * i, k=40 * i,
                                 deadline_s=10.0))
        tickets.append(fe.submit("topk", 100 * i, 100 * i + 900,
                                 deadline_s=10.0))
    drain()
    for i in range(14):
        tickets.append(fe.submit("quantile", i, n - i, k=i * 97,
                                 deadline_s=50.0))
    tickets.append(fe.submit("topk", 0, n, deadline_s=50.0))
    drain()
    tickets.append(fe.submit("count", 0, n, deadline_s=0.05))
    clock.advance(0.1)
    fe.pump()
    clock.advance(2.0)
    fe.pump()
    with inject_shard_latency(2, 9.0):
        for _ in range(fe.config.breaker.fail_threshold):
            tickets.append(fe.submit("count", 0, n, deadline_s=1e6))
            fe.pump()
        tickets.append(fe.submit("quantile", 0, n, k=n // 2,
                                 deadline_s=1e6))
        drain()
    return tickets


def _fe_outcomes(tickets):
    from repro_torch.serving import ShedError
    out = []
    for t in tickets:
        try:
            a = t.result(0)
        except ShedError as e:
            out.append(("shed", e.reason))
            continue
        v = a.value
        if isinstance(v, tuple) and isinstance(v[0], np.ndarray):
            v = tuple(x.tolist() for x in v)
        out.append((v, a.mode, a.degraded, a.coverage, a.level,
                    a.generation, a.latency_s, a.deadline_met))
    return out


@pytest.mark.cuda
def test_frontend_on_a_card_engine_equals_the_cpu_engine():
    """One FakeClock scenario over a card engine and over a CPU engine:
    equal answers (every Answer field) and stats; the card's exact
    quantiles and probes went through the kernel."""
    from repro_torch.ingest import GenerationServer
    from repro_torch.robust import FakeClock
    from repro_torch.serving import FrontendConfig, LadderConfig, QueryFrontend
    _card()
    _, card, cpu = _engine_pair()
    runs = []
    for eng in (card, cpu):
        clock = FakeClock()
        fe = QueryFrontend(GenerationServer(eng), clock=clock,
                           config=FrontendConfig(
                               buckets=(8, 32), capacity=16,
                               probe_shards=True,
                               ladder=LadderConfig(up_pressure=0.5)))
        build.reset_launches()
        try:
            runs.append((_fe_outcomes(_fe_script(fe, clock, _ENGINE_N)),
                         fe.stats(), build.launches["wm_quantile_sharded"]))
        finally:
            fe.breakers.close_pool()
    (got, got_stats, launched), (want, want_stats, _) = runs
    assert got == want and got_stats == want_stats
    assert launched > 0
    assert any(o[1] == "exact" and o[3] == 1.0 and isinstance(o[0], int)
               for o in got[:3])
    assert {o[1] for o in got} >= {"exact", "quantile_bracket",
                                   "topk_greedy", "expired"}
    assert any(o[0] != "shed" and o[3] < 1.0 for o in got)


@pytest.mark.cuda
def test_threaded_hot_swap_on_the_card(tmp_path):
    """Four reader threads run kernel quantile batches in sessions while
    the ingester commits generations on the card and the server swaps:
    every batch equals one generation's oracle in whole."""
    import threading

    from repro_torch.ingest import GenerationServer, analytics_ingester
    dev = _card()
    toks = np.random.default_rng(22).integers(0, 300, 8 * 512).astype(
        np.int64)
    ing = analytics_ingester(tmp_path, 300, shard_bits=9, sample_rate=128,
                             device=dev)
    ing.recover()
    ing.append_tokens(toks[:4 * 512])
    srv = GenerationServer(ing.engine())
    rng = np.random.default_rng(23)
    lo = rng.integers(0, 8 * 512, 256)
    hi = lo + rng.integers(1, 8 * 512, 256)
    k = rng.integers(0, 8 * 512, 256)
    q = [torch.from_numpy(x.astype(np.int32)).to(dev) for x in (lo, hi, k)]

    def oracle(m):
        return torch.tensor([int(np.sort(toks[a:min(b, m)])[
            min(c, min(b, m) - a - 1)]) if a < m else -1
            for a, b, c in zip(lo, hi, k)], dtype=torch.int32, device=dev)

    oracles = {0: oracle(4 * 512)}
    done, errors, seen = threading.Event(), [], []

    def reader():
        try:
            while not done.is_set():
                with srv.session() as (gen, e):
                    got = e.range_quantile(*q)
                    if not torch.equal(got, oracles[gen]):
                        errors.append(gen)
                seen.append(gen)
        except BaseException as e:              # handed to the main thread
            errors.append(e)

    threads = [threading.Thread(target=reader, daemon=True)
               for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for g in range(1, 5):
            ing.append_tokens(toks[(g + 3) * 512:(g + 4) * 512])
            new = ing.serve_entries()[-1:]
            nxt = srv.engine.add_shards(ing.stack(new), 512)
            oracles[g] = oracle((g + 4) * 512)
            srv.swap_generation(nxt, wait_drain=True, timeout_s=60)
        deadline = time.time() + 30
        while seen.count(4) < 8 and not errors and time.time() < deadline:
            time.sleep(0.01)
    finally:
        done.set()
        for t in threads:
            t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert srv.generation == 4 and set(seen) >= {0, 4}
    _same_on_both(srv.engine.shards, build_sharded_analytics(
        toks, 300, shard_bits=9, sample_rate=128, device="cpu").shards)


@pytest.mark.cuda
def test_probe_shard_on_a_card_engine_and_index():
    from repro_torch.robust import FakeClock, inject_shard_latency
    _card()
    _, card, _ = _engine_pair()
    _, icard, _, _ = _index_pair("tail")
    clock = FakeClock()
    with inject_shard_latency(1, 0.7):
        assert all(card.probe_shard(s, clock)
                   for s in range(card.num_shards))
        assert all(icard.probe_shard(s, clock)
                   for s in range(icard.num_shards))
    assert clock.sleeps == [0.7, 0.7]
    assert card.probe_shard(0) and icard.probe_shard(0)



@pytest.mark.cuda
def test_probe_kernel_error_on_the_card_stops_the_frontend(monkeypatch):
    """A breaker probe whose quantile kernel cannot be loaded raises
    ``KernelError`` out of the front-end (``pump``, and ``stop`` after the
    worker) instead of opening breakers and serving around the card."""
    from repro_torch.ingest import GenerationServer
    from repro_torch.robust import FakeClock
    from repro_torch.serving import FrontendConfig, QueryFrontend
    _card()
    _, card, _ = _engine_pair()
    library = build.library

    def broken(name):
        if name == "wm_quantile":
            raise build.KernelError("CUDA kernel library wm_quantile could "
                                    "not be loaded")
        return library(name)

    monkeypatch.setattr(build, "library", broken)
    fe = QueryFrontend(GenerationServer(card), clock=FakeClock(),
                       config=FrontendConfig(buckets=(8,), capacity=16,
                                             probe_shards=True))
    try:
        t = fe.submit("count", 0, _ENGINE_N, deadline_s=1e6)
        with pytest.raises(build.KernelError):
            fe.pump()
        with pytest.raises(build.KernelError):
            t.result(0)
        assert fe.stats()["open_breakers"] == [] and fe.served == 0
        t = fe.submit("count", 0, _ENGINE_N, deadline_s=1e6)
        fe.start()
        with pytest.raises(build.KernelError):
            t.result(30.0)
        with pytest.raises(build.KernelError):
            fe.stop()
        assert fe.stats()["open_breakers"] == []
    finally:
        fe.breakers.close_pool()

# ---------------------------------------------------------------------------
# repro_torch.obs on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def _fresh_obs():
    from repro_torch import obs
    obs.REGISTRY.reset()
    obs.reset_shape_tracking()
    yield obs
    obs.configure(None)
    obs.REGISTRY.reset()


@functools.lru_cache(maxsize=None)
def _obs_engine():
    """An engine of 2^20 Zipf tokens in 16 shards of 2^16 and 4,096 of its
    queries, on the card."""
    dev = _card()
    n, sigma = 1 << 20, 4096
    toks = (np.random.default_rng(5).zipf(1.2, n) % sigma).astype(np.int64)
    eng = build_sharded_analytics(toks, sigma, shard_bits=16, device=dev)
    rng = np.random.default_rng(6)
    lo = rng.integers(0, n - 1, 4096)
    hi = np.minimum(lo + rng.integers(1, n // 4, 4096), n)
    k = rng.integers(0, np.maximum(hi - lo, 1))
    return eng, [torch.from_numpy(x.astype(np.int32)).to(dev)
                 for x in (lo, hi, k)]


@pytest.mark.cuda
def test_span_sync_waits_for_a_long_kernel(_fresh_obs):
    obs = _fresh_obs
    dev = _card()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with obs.span("test.sleep") as sp:
        start.record()
        torch.cuda._sleep(200_000_000)                 # about 0.1 s
        end.record()
        sp.sync(torch.ones(1, device=dev) + 1)
    end.synchronize()
    span_ms = obs.REGISTRY.snapshot()["histograms"]["span.test.sleep"][
        "max"] * 1e3
    assert span_ms >= start.elapsed_time(end) > 10.0


@pytest.mark.cuda
def test_device_errors_raise_out_of_profiling_and_spans(_fresh_obs,
                                                        monkeypatch):
    """A quantile kernel that cannot be loaded raises ``KernelError`` out of
    ``profile_op``, ``profiled_op`` and a span that syncs; a device error
    at the synchronize of a span whose body finished cleanly raises too."""
    obs = _fresh_obs
    eng, (lo, hi, k) = _obs_engine()
    library = build.library

    def broken(name):
        if name == "wm_quantile":
            raise build.KernelError("CUDA kernel library wm_quantile could "
                                    "not be loaded")
        return library(name)

    def quantile(e, a, b, c):
        return e.range_quantile(a, b, c)

    monkeypatch.setattr(build, "library", broken)
    with pytest.raises(build.KernelError):
        obs.profile_op("analytics.quantile_kernel", quantile, eng, lo, hi, k)
    with pytest.raises(build.KernelError):
        obs.profiled_op("analytics", "quantile_kernel", quantile, eng, lo,
                        hi, k, batch=lo.shape[0])
    with pytest.raises(build.KernelError):
        with obs.span("test.quantile") as sp:
            sp.sync(quantile(eng, lo, hi, k))
    assert "prof.error{op=analytics.quantile_kernel}" not in \
        obs.REGISTRY.snapshot()["counters"]
    monkeypatch.setattr(build, "library", library)

    def failing_synchronize(device=None):
        raise torch.OutOfMemoryError("raised at the synchronize")

    out = quantile(eng, lo, hi, k)
    torch.cuda.synchronize()
    monkeypatch.setattr(torch.cuda, "synchronize", failing_synchronize)
    with pytest.raises(torch.OutOfMemoryError):
        with obs.span("test.quantile") as sp:
            sp.sync(out)
    assert obs.current_span() is None


@pytest.mark.cuda
def test_time_compiled_on_the_card(_fresh_obs):
    obs = _fresh_obs
    eng, (lo, hi, k) = _obs_engine()
    out, steady_s, first_s = obs.time_compiled(eng.range_quantile, lo, hi, k,
                                               iters=5)
    assert out.device.type == "cuda"
    assert torch.equal(out, sharded_range_quantile(
        eng.shards, eng.shard_bits, eng.n, lo, hi, k))
    assert 0 < steady_s and 0 < first_s


@pytest.mark.cuda
def test_profiled_op_of_the_quantile_kernel(_fresh_obs):
    obs = _fresh_obs
    eng, (lo, hi, k) = _obs_engine()
    out, steady_s, _ = obs.profiled_op(
        "analytics", "quantile_kernel",
        lambda e, a, b, c: e.range_quantile(a, b, c), eng, lo, hi, k,
        batch=lo.shape[0], iters=10)
    g = obs.REGISTRY.snapshot()["gauges"]
    util = g["prof.roofline_util{op=analytics.quantile_kernel}"]
    assert 0 < util <= 1.05
    assert g["prof.peak_bytes{op=analytics.quantile_kernel}"] > 0
    assert g["prof.bytes_accessed{op=analytics.quantile_kernel}"] == (
        wm_quantile.quantile_work(eng.quantile, lo, hi, k)[0])
    assert torch.equal(out, eng.range_quantile(lo, hi, k))


@pytest.mark.cuda
def test_memory_gauges_on_the_card(_fresh_obs):
    obs = _fresh_obs
    keep = torch.ones((1 << 20,), dtype=torch.int32, device=_card())
    stats = obs.record_memory_gauges()
    assert stats["live_bytes"] == stats["device_bytes_in_use"]
    assert stats["live_bytes"] >= keep.numel() * 4
    assert stats["device_peak_bytes"] >= stats["live_bytes"]
    assert stats["live_arrays"] >= 1
    g = obs.REGISTRY.snapshot()["gauges"]
    assert g["prof.mem.live_bytes"] == stats["live_bytes"]


@pytest.mark.cuda
def test_trace_names_the_quantile_kernel(_fresh_obs, tmp_path):
    import json
    obs = _fresh_obs
    eng, (lo, hi, k) = _obs_engine()
    eng.range_quantile(lo, hi, k)
    assert obs.start_trace(tmp_path / "prof")
    assert not obs.start_trace(tmp_path / "other")   # one at a time
    with obs.span("test.quantile"):
        eng.range_quantile(lo, hi, k)
    path = obs.stop_trace()
    assert not obs.stop_trace()
    events = json.loads(path.read_text())["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any("wm_quantile_kernel" in name for name in kernels), kernels
    assert "test.quantile" in {e["name"] for e in events
                               if e.get("cat") == "user_annotation"}


@pytest.mark.cuda
def test_trace_counts_agree_with_launches(_fresh_obs):
    obs = _fresh_obs
    dev = _card()
    rng = np.random.default_rng(3)
    n = 70_001
    build.reset_launches()
    seq = torch.from_numpy(rng.integers(0, 3000, (4, n))).to(dev)
    wm = build_wavelet_matrix(seq, 3000, device=dev)
    build_wavelet_tree(seq[0], 3000, big_step="radix", device=dev)
    d = torch.from_numpy(rng.integers(0, 64, (3, n)).astype(np.int32)).to(
        dev)
    ops.radix_rank(d, 64)
    ops.wm_level_step(d, 2, n)
    ops.rank_build(wm.bitvectors.rank.words[0, 0], n)
    lo, hi, k = _queries(n, 100, 1, dev)
    ops.wm_quantile_batch(tree_map(lambda x: x[0], wm), lo, hi, k)
    eng = build_sharded_analytics(seq.reshape(-1).cpu().numpy(), 3000,
                                  shard_bits=15, device=dev)
    eng.range_quantile(lo, hi, k)
    eng.range_count(lo, hi, 0, 1500)
    eng.range_topk_greedy(lo, hi, 8, budget=24)
    torch.cuda.synchronize()
    traced = {name: [0, 0] for name in build.launches}
    for key, v in obs.REGISTRY.snapshot()["counters"].items():
        name, labels = obs.parse_key(key)
        if name == "kernels.trace":
            assert labels["route"] == "cuda"
            kernel, least, most = ops.TRACE_LAUNCHES[labels["op"]]
            traced[kernel][0] += least * v
            traced[kernel][1] += most * v
    for name, launched in build.launches.items():
        assert traced[name][0] <= launched <= traced[name][1], name
        assert launched > 0, name


@pytest.mark.cuda
def test_chaos_on_the_card(_fresh_obs, tmp_path, capsys):
    from repro_torch.launch import chaos
    _card()
    check = chaos.main(["--smoke", "--device", "cuda", "--metrics-dir",
                        str(tmp_path / "m")])
    out = capsys.readouterr().out
    assert check.failures == 0 and len(check.rows) == 31
    assert "served 105, shed 295 (74%" in out
    assert "p99 79.2ms" in out
    assert (tmp_path / "m" / "snapshot.json").exists()


# ---- the LM serving path and the examples (no kernel: the card's logits
# ---- against the port's CPU run of the same params) ----------------------

LM_FAMILY_ARCHS = ("qwen2_0_5b", "dbrx_132b", "arctic_480b", "mamba2_370m",
                   "jamba_v0_1_52b", "whisper_medium", "llama_3_2_vision_90b")
LM_TOL = dict(rtol=0.05, atol=0.05)   # the reference's prefill/decode bound


def _lm_run(model, params, dev, prompt, extras, memory, forced):
    """Prefill logits and the decode logits of the prompt teacher-forced,
    then 8 tokens: greedy, or ``forced`` (the card's greedy tokens)."""
    from repro_torch.models.model import zero_cache
    b, plen = prompt.shape
    with torch.inference_mode():
        toks = prompt.to(dev)
        ext = {k: v.to(dev) for k, v in extras.items()} or None
        pre = model.prefill(params, toks, ext).cpu()
        cache = zero_cache(model.cfg, b, plen + 8, device=dev)
        for name, mem in memory.items():
            cache[name] = mem.to(dev)
        logits, gen, tok = [], [], toks[:, :1]
        for i in range(plen + 7):
            lg, cache = model.decode_step(
                params, tok, cache, torch.full((b,), i, dtype=torch.int32))
            logits.append(lg.cpu())
            if i + 1 < plen:
                tok = toks[:, i + 1:i + 2]
                continue
            gen.append(lg.argmax(-1).cpu())
            nxt = gen[-1] if forced is None else forced[:, len(gen) - 1]
            tok = nxt.to(dev)[:, None]
    return pre, torch.stack(logits), torch.stack(gen, dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_FAMILY_ARCHS)
def test_lm_family_on_the_card_matches_the_cpu(arch):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model, map_tree, zero_cache
    dev = _card()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    cpu = model.init(0, device="cpu")
    card = map_tree(lambda _, a: a.to(dev), cpu)
    g = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    extras = {k: torch.randn(s, generator=g).to(torch.bfloat16)
              for k, s in model.extras_shapes(2).items()}
    shapes = {k: v.shape for k, v in zero_cache(cfg, 2, 24, "cpu").items()}
    memory = {k: torch.randn(shapes[k], generator=g).to(torch.bfloat16)
              for k in ("xk", "xv") if k in shapes}
    c_pre, c_dec, c_tok = _lm_run(model, card, dev, prompt, extras, memory,
                                  None)
    h_pre, h_dec, _ = _lm_run(model, cpu, torch.device("cpu"), prompt,
                              extras, memory, c_tok)
    assert torch.isfinite(c_pre).all() and torch.isfinite(c_dec).all()
    torch.testing.assert_close(c_pre, h_pre, **LM_TOL)
    torch.testing.assert_close(c_dec, h_dec, **LM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name,n", [("torch_quickstart", 20_000),
                                    ("torch_corpus_analytics", 1 << 14),
                                    ("torch_corpus_search", 1 << 13),
                                    ("torch_serve_decode", 1 << 13)])
def test_example_on_the_card(name, n, capsys):
    import importlib.util
    from pathlib import Path
    _card()
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parents[1] / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(device="cuda", n=n)
    assert capsys.readouterr().out.strip().splitlines()[-1].endswith("✓")


# ---- the LM training half: a train step, compressed grads through the
# ---- bitpack kernel, replay and resume, a store-fed batch ----------------

TRAIN_ARCHS = ("qwen2_0_5b", "dbrx_132b", "mamba2_370m", "whisper_medium")
TRAIN_KW = dict(base_lr=1e-3, warmup=1, total_steps=10)


def _train_batch(cfg, model, seed: int, dev) -> dict:
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 33),
                                     generator=g)}
    for k, s in model.extras_shapes(4).items():
        batch[k] = torch.randn(s, generator=g).to(torch.bfloat16)
    return {k: v.to(dev) for k, v in batch.items()}


def _leaves_close_to_a_step(got, want, lr: float) -> None:
    """Params within 2·lr plus 2 bf16 ulp (a grad whose sign differs moves
    an Adam step by at most about 2·lr more)."""
    from repro_torch.models.model import tree_paths
    want = dict(tree_paths(want))
    for path, a in tree_paths(got):
        a, b = a.float().cpu(), want[path].float().cpu()
        ulp = torch.finfo(torch.bfloat16).eps * b.abs()
        assert bool(((a - b).abs() <= 2 * lr + 2 * ulp).all()), path


@pytest.mark.cuda
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_the_card_matches_the_cpu(arch):
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model, map_tree
    from repro_torch.train import init_train_state, make_train_step
    dev = _card()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    cpu = init_train_state(model, 0, compress_bits=6, device="cpu")
    card = dataclasses.replace(
        cpu, params=map_tree(lambda _, a: a.to(dev), cpu.params),
        opt=dataclasses.replace(
            cpu.opt, m=map_tree(lambda _, a: a.to(dev), cpu.opt.m),
            v=map_tree(lambda _, a: a.to(dev), cpu.opt.v),
            step=cpu.opt.step.to(dev)),
        ef=map_tree(lambda _, a: a.to(dev), cpu.ef))
    step = make_train_step(model, **TRAIN_KW)
    c_state, c_met = step(card, _train_batch(cfg, model, 0, dev))
    h_state, h_met = step(cpu, _train_batch(cfg, model, 0, "cpu"))
    assert int(c_met["skipped"]) == 0 and int(c_state.opt.step) == 1
    torch.testing.assert_close(c_met["loss"].cpu(), h_met["loss"],
                               rtol=0.05, atol=0.05)
    torch.testing.assert_close(c_met["grad_norm"].cpu(), h_met["grad_norm"],
                               rtol=0.05, atol=0)
    _leaves_close_to_a_step(c_state.params, h_state.params,
                            float(h_met["lr"]))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 6, 8])
def test_compressed_grads_go_through_bitpack(bits):
    from repro_torch.optim.grad_compress import (dequantize_bitplanes,
                                                 ef_compress_tree,
                                                 quantize_bitplanes,
                                                 zero_residuals)
    dev = _card()
    g = torch.Generator().manual_seed(bits)
    x = torch.randn(70_001, generator=g) * 3
    build.reset_launches()
    words, scale = quantize_bitplanes(x.to(dev), bits)
    torch.cuda.synchronize()
    assert build.launches["bitpack"] == 1
    want_w, want_s = quantize_bitplanes(x, bits)
    assert torch.equal(words.cpu(), want_w)
    assert torch.equal(scale.cpu(), want_s)
    assert torch.equal(dequantize_bitplanes(words, scale, bits, (70_001,),
                                            keep_planes=2).cpu(),
                       dequantize_bitplanes(want_w, want_s, bits,
                                            (70_001,), keep_planes=2))
    tree = {"a": torch.randn((33, 17), generator=g).to(torch.bfloat16),
            "b": {"c": torch.randn(1000, generator=g).to(torch.bfloat16),
                  "d": torch.zeros(5, dtype=torch.bfloat16)}}
    res = zero_residuals(tree)
    build.reset_launches()
    on_card = ef_compress_tree({"a": tree["a"].to(dev),
                                "b": {k: v.to(dev)
                                      for k, v in tree["b"].items()}},
                               {"a": res["a"].to(dev),
                                "b": {k: v.to(dev)
                                      for k, v in res["b"].items()}}, bits)
    torch.cuda.synchronize()
    assert build.launches["bitpack"] == 3            # one a leaf
    on_cpu = ef_compress_tree(tree, res, bits)
    for got, want in zip(on_card, on_cpu):
        assert torch.equal(got["a"].cpu(), want["a"])
        for k in ("c", "d"):
            assert torch.equal(got["b"][k].cpu(), want["b"][k])


@pytest.mark.cuda
def test_training_on_the_card_replays_and_resumes(tmp_path):
    from repro_torch.configs.base import get_config
    from repro_torch.data import TokenBatcher, make_corpus
    from repro_torch.models.model import build_model, tree_paths
    from repro_torch.train import Trainer
    _card()
    cfg = get_config("qwen2_0_5b", smoke=True)
    model = build_model(cfg)
    toks = make_corpus(1 << 16, cfg.vocab_size, seed=0)

    def trainer(ckpt=None):
        return Trainer(model, TokenBatcher(tokens=toks, batch=4, seq_len=64,
                                           seed=5),
                       log_every=1, ckpt_dir=ckpt, ckpt_every=5,
                       device="cuda", compress_bits=6, **TRAIN_KW)
    a, b = trainer(), trainer(str(tmp_path))
    ha, hb = a.run(10), b.run(5)
    assert [h["loss"] for h in ha[:5]] == [h["loss"] for h in hb]
    c = trainer(str(tmp_path))
    assert c.maybe_resume() == 5
    hc = c.run(5)
    assert [h["loss"] for h in ha[5:]] == [h["loss"] for h in hc]
    for (path, x), (_, y) in zip(tree_paths(a.state.params),
                                 tree_paths(c.state.params)):
        assert torch.equal(x, y), path


@pytest.mark.cuda
def test_store_fed_batch_on_the_card():
    from repro_torch.data import (TokenBatcher, build_compressed_corpus,
                                  make_corpus)
    dev = _card()
    toks = make_corpus(1 << 18, 151_936, seed=0)
    build.reset_launches()
    corpus = build_compressed_corpus(toks, 151_936, shard_bits=16,
                                     device=dev)
    torch.cuda.synchronize()
    assert build.launches["wm_level_step"] == 19
    assert build.launches["rank_build_levels"] == 1
    b = TokenBatcher(corpus=corpus, batch=8, seq_len=256, seed=0)
    for step in (0, 1, 77):
        got = b.batch_at(step)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, toks[b.positions(step)])


# ---- the XLA tools' port: --mesh host, the analytics cell, the fake group -

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "dbrx_132b"])
def test_host_mesh_train_steps_on_the_card_are_bit_identical(arch):
    """Two train steps on a 1×1 DTensor mesh of the card (nccl) equal the
    same steps without a mesh bit for bit: losses, grad norms, params."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.data import TokenBatcher, make_corpus
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model, tree_paths
    from repro_torch.train import Trainer
    dev = _card()
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    toks = make_corpus(1 << 16, cfg.vocab_size, seed=0)
    runs = {}
    try:
        for name in ("none", "host"):
            t = Trainer(model, TokenBatcher(tokens=toks, batch=4, seq_len=64,
                                            seed=0),
                        log_every=1, device=dev,
                        mesh=make_host_mesh(dev) if name == "host" else None,
                        **TRAIN_KW)
            t.run(2)
            runs[name] = ([(h["loss"], h["grad_norm"]) for h in t.history],
                          {p: (x.full_tensor() if hasattr(x, "full_tensor")
                               else x) for p, x in tree_paths(t.state.params)})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert runs["host"][0] == runs["none"][0]
    for path, x in runs["host"][1].items():
        assert torch.equal(x, runs["none"][1][path]), path


@pytest.mark.cuda
def test_analytics_cell_launches_the_quantile_kernel(tmp_path):
    from repro_torch.launch import dryrun
    _card()
    res = dryrun.run_analytics_cell(tmp_path, device="cuda")
    assert res["ok"] and res["device"].startswith("cuda")
    for part in ("serve_4op_batch", "fused_quantile_kernel"):
        cell = res[part]
        assert cell["launches"].get("wm_quantile_sharded") == 1, cell
        assert cell["bytes_accessed"] > 0 and cell["peak_rise_bytes"] >= 0


@pytest.mark.cuda
def test_fake_process_group_is_available():
    """The dry run's fake world (``torch.testing._internal.distributed.
    fake_pg``) exists in this torch: 512 ranks start in one process."""
    import subprocess
    import sys
    _card()
    code = ("import torch.distributed as dist\n"
            "from torch.testing._internal.distributed.fake_pg import "
            "FakeStore\n"
            "dist.init_process_group('fake', store=FakeStore(), rank=0, "
            "world_size=512)\n"
            "print(dist.get_world_size())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "512", (
        f"the fake process group is missing on torch {torch.__version__}: "
        f"{out.stderr[-2000:]}")
