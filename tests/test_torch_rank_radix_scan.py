"""The single-pass rank-directory and radix-rank scans vs numpy and ``repro``.

``rank_build_levels`` and ``radix_rank`` run on the card as tiled scans
with a decoupled look-back (``csrc/rank_build.cu``, ``csrc/radix_rank.cu``).
These tests emulate both formulas in numpy at tile granularity, look-back
included (a tile publishes its aggregate, walks back to the nearest
inclusive prefix, and publishes its own prefix at once or later), and hold
them against the reference's oracles (``repro.kernels.ref``) at ragged
sizes and several tile sizes. They also hold the hand-over of the tree's
bucket starts (``node_starts``) against numpy, the ops with the starts
against the ops without them, and the wrappers' input checks. On the CPU
the wrappers run their plain versions; the kernels themselves are held
against those on the card (``test_torch_cuda.py``). Every comparison is
equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wavelet_tree as jwt
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import sort
from repro_torch.core import wavelet_tree as twt
from repro_torch.kernels import build, ops, radix_rank, rank_build, ref

BLOCK_WORDS, SUPERBLOCK_WORDS = 4, 32


def _look_back(aggregates: np.ndarray, late: np.ndarray) -> np.ndarray:
    """Exclusive prefix of every tile of one row, as the look-back finds it:
    tiles run in id order; tile t publishes its aggregate, adds up its
    predecessors' words back to the nearest inclusive prefix, then publishes
    its own prefix, at once or (``late[t]``) only after every later tile has
    read its word. The first tile publishes its prefix at once."""
    status = [None] * len(aggregates)        # (is_prefix, count)
    excl = np.zeros(len(aggregates), np.int64)
    for t, agg in enumerate(aggregates):
        status[t] = (t == 0, int(agg))
        q, total = t - 1, 0
        while q >= 0:
            is_prefix, count = status[q]
            total += count
            if is_prefix:
                break
            q -= 1
        excl[t] = total
        if t == 0 or not late[t]:
            status[t] = (True, total + int(agg))
    return excl


def _popcount(words: np.ndarray) -> np.ndarray:
    w = words.astype(np.uint32)
    return np.unpackbits(w.view(np.uint8).reshape(w.shape + (4,)),
                         axis=-1).sum(-1).astype(np.int64)


def _rank_build_emulated(words: np.ndarray, W: int, tile: int, seed: int):
    """(superblock, block) of each row from the tiled scan: per tile, the
    exclusive scan of its rank blocks' popcounts; per row, the prefix of
    earlier tiles from the look-back; uint32 superblocks that wrap."""
    rng = np.random.default_rng(seed)
    nblk = -(-W // BLOCK_WORDS)
    sbs, blks = [], []
    for row in words:
        pc = _popcount(np.pad(row[:W], (0, nblk * BLOCK_WORDS - W)))
        blk_pc = pc.reshape(nblk, BLOCK_WORDS).sum(-1)
        tile_blocks = tile // BLOCK_WORDS
        tiles = -(-nblk // tile_blocks)
        parts = [blk_pc[i * tile_blocks:(i + 1) * tile_blocks]
                 for i in range(tiles)]
        local = [np.cumsum(p) - p for p in parts]      # tile-local exclusive
        prefix = _look_back(np.array([p.sum() for p in parts]),
                            rng.random(tiles) < 0.5)
        excl = np.concatenate([prefix[i] + local[i] for i in range(tiles)])
        per_sb = SUPERBLOCK_WORDS // BLOCK_WORDS
        sb_first = excl[(np.arange(nblk) // per_sb) * per_sb]
        blks.append((excl - sb_first).astype(np.uint16).view(np.int16))
        sbs.append((excl[::per_sb] & 0xFFFFFFFF).astype(np.uint32)
                   .view(np.int32))
    return np.stack(sbs), np.stack(blks)


def _words(rows: int, W: int, seed: int, stride: int | None = None):
    """(rows, stride) random words (all-zero and all-one rows first) whose
    first W are used."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (rows, stride or W),
                         dtype=np.uint64).astype(np.uint32).view(np.int32)
    words[0] = 0
    if rows > 1:
        words[1] = -1
    return words


@pytest.mark.parametrize("tile", [64, 1024, rank_build.TILE])
@pytest.mark.parametrize("W_of", [lambda t: 1, lambda t: t - 1,
                                  lambda t: t + 1, lambda t: 3 * t + 100])
def test_rank_build_tiled_scan_equals_reference(tile, W_of):
    W = W_of(tile)
    words = _words(3, W, W + tile, stride=W + 5)    # rows longer than W
    sb, blk = _rank_build_emulated(words, W, tile, tile)
    jsb, jblk = jref.rank_build_levels_ref(
        jnp.asarray(words[:, :W].view(np.uint32)), 32 * W)
    assert np.array_equal(sb.view(np.uint32), np.asarray(jsb))
    assert np.array_equal(blk.view(np.uint16), np.asarray(jblk))
    got = ops.rank_build_levels(torch.from_numpy(words[:, :W]), 32 * W)
    assert np.array_equal(got[0].numpy(), sb)
    assert np.array_equal(got[1].numpy(), blk)


def test_rank_build_single_row_form_equals_reference():
    """L = 1 (``ops.rank_build``, the reference's ``rank_build_pallas``)."""
    n = 3 * 8192 * 32 + 77
    words = _words(3, -(-n // 32), 3)[2]
    words[-1] &= (1 << (n % 32)) - 1                 # zero past bit n
    got = ops.rank_build(torch.from_numpy(words), n)
    jsb, jblk = jref.rank_build_ref(jnp.asarray(words.view(np.uint32)), n)
    assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(jsb))
    assert np.array_equal(got[1].numpy().view(np.uint16), np.asarray(jblk))


# ---------------------------------------------------------------------------
# radix_rank: in-tile rank + per-bucket counts of earlier tiles + start
# ---------------------------------------------------------------------------

def _radix_emulated(digits: np.ndarray, B: int, tile: int, warps: int,
                    starts: np.ndarray, seed: int) -> np.ndarray:
    """Destinations of the one-sweep scan: each warp of a tile ranks its
    tile // warps digits in rounds of 32 (lane l of round r holds digit
    32 r + l); the per-warp counts scanned over the warps give each warp's
    offset in the tile; the look-back of each bucket gives its count in
    earlier tiles of the row."""
    rng = np.random.default_rng(seed)
    rows, n = digits.shape
    tiles = -(-n // tile)
    out = np.empty((rows, n), np.int64)
    for r in range(rows):
        d = np.full(tiles * tile, B, np.int64)      # the sentinel past n
        d[:n] = digits[r]
        warp_d = d.reshape(tiles, warps, tile // warps)
        counts = np.zeros((tiles, warps, B + 1), np.int64)
        rank = np.zeros_like(warp_d)
        for t in range(tiles):
            for w in range(warps):
                seen = np.zeros(B + 1, np.int64)
                for rnd in range(0, tile // warps, 32):
                    lanes = warp_d[t, w, rnd:rnd + 32]
                    for lane, v in enumerate(lanes):   # lower lanes first
                        rank[t, w, rnd + lane] = seen[v]
                        seen[v] += 1
                counts[t, w] = seen
        woff = np.cumsum(counts, 1) - counts          # earlier warps
        tile_counts = counts.sum(1)                   # (tiles, B + 1)
        late = rng.random((tiles, B)) < 0.5
        earlier = np.stack([_look_back(tile_counts[:, b], late[:, b])
                            for b in range(B)], 1)
        base = (starts[r][None, None, :] + earlier[:, None, :]
                + woff[:, :, :B])                     # (tiles, warps, B)
        flat = warp_d.reshape(tiles * warps, -1)
        bw = base.reshape(tiles * warps, B)
        dest = np.where(flat < B, np.take_along_axis(
            bw, np.minimum(flat, B - 1), 1) + rank.reshape(flat.shape), -1)
        out[r] = dest.reshape(-1)[:n]
    return out


def _digits(rows: int, n: int, B: int, seed: int) -> np.ndarray:
    """Zipf-like digits (a few buckets hold most of them), one row of a
    single bucket."""
    rng = np.random.default_rng(seed)
    d = np.minimum(rng.zipf(1.3, (rows, n)) - 1, B - 1).astype(np.int32)
    d[0, : n // 2] = B - 1
    return d


def _starts(digits: np.ndarray, B: int) -> np.ndarray:
    hist = np.stack([np.bincount(row, minlength=B) for row in digits])
    return (np.cumsum(hist, 1) - hist).astype(np.int32)


@pytest.mark.parametrize("B", [2, 33, 256, 512])
@pytest.mark.parametrize("n,tile,warps", [(1, 1024, 8), (1023, 256, 2),
                                          (4 * 256 + 7, 256, 4),
                                          (3 * 8192 + 100, 8192, 8)])
def test_radix_tiled_scan_equals_reference(B, n, tile, warps):
    digits = _digits(2, n, B, n + B)
    starts = _starts(digits, B)
    got = _radix_emulated(digits, B, tile, warps, starts, B)
    for r in range(2):
        want = np.asarray(jref.radix_rank_ref(jnp.asarray(digits[r]), B))
        assert np.array_equal(got[r], want)
    port = ops.radix_rank(torch.from_numpy(digits), B,
                          torch.from_numpy(starts))
    assert np.array_equal(port.numpy(), got)


def test_radix_scan_places_buckets_at_the_given_starts():
    """The scan takes the starts as given: starts moved by 5 move every
    destination by 5, in the emulation and in the plain version."""
    digits = _digits(1, 3000, 40, 1)
    starts = _starts(digits, 40)
    base = radix_rank.radix_scan(torch.from_numpy(digits), 40, 3000,
                                 torch.from_numpy(starts))
    moved = radix_rank.radix_scan(torch.from_numpy(digits), 40, 3000,
                                  torch.from_numpy(starts + 5))
    assert torch.equal(moved, base + 5)
    assert np.array_equal(_radix_emulated(digits, 40, 256, 2, starts + 5, 0),
                          moved.numpy())


def test_radix_rank_gives_out_of_range_digits_minus_one():
    d = np.array([[3, -1, 0, 7, 3, 4, 0]], np.int32)
    got = radix_rank.radix_rank(torch.from_numpy(d), 4, 7)
    assert got.tolist() == [[2, -1, 0, -1, 3, -1, 1]]


def test_radix_totals_count_real_buckets():
    digits = _digits(3, 5000, 256, 4)
    digits[2, :10] = 300                              # out of range
    got = radix_rank.radix_totals(torch.from_numpy(digits), 256, 4990)
    want = [np.bincount(row[:4990][row[:4990] < 256], minlength=256)
            for row in digits]
    want = np.stack(want)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(radix_rank.exclusive_starts(got).numpy(),
                          np.cumsum(want, 1) - want)


@pytest.mark.parametrize("B", [33, 256, 512])
def test_counting_rank_with_starts_equals_without(B):
    digits = _digits(3, 5000, B, B)
    starts = torch.from_numpy(_starts(digits, B))
    d = torch.from_numpy(digits)
    with_starts = sort.counting_rank(d, B, use_kernel=True,
                                     bucket_starts=starts)
    assert torch.equal(with_starts, sort.counting_rank(d, B, use_kernel=True))
    assert torch.equal(ops.radix_rank(d, B, starts), ops.radix_rank(d, B))
    for r in range(3):
        assert np.array_equal(with_starts[r].numpy(), np.asarray(
            jref.radix_rank_ref(jnp.asarray(digits[r]), B)))


# ---------------------------------------------------------------------------
# what the tree build hands over
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau", [3, 8])
def test_node_starts_are_the_scan_of_the_top_digits(tau):
    sigma, n = 151_936, 5003
    seq = np.random.default_rng(tau).integers(0, sigma, n).astype(np.int32)
    wt = twt.build_wavelet_tree(seq, sigma, tau=tau, big_step="radix",
                                use_kernels=False, device="cpu")
    for consumed in range(tau, wt.nbits, tau):
        top = seq.astype(np.int64) >> (wt.nbits - consumed)
        hist = np.bincount(top, minlength=1 << consumed)
        assert np.array_equal(
            wt.node_starts[consumed, :1 << consumed].numpy(),
            np.cumsum(hist) - hist)


def test_tree_build_hands_its_starts_to_the_big_step(monkeypatch):
    calls = []
    step = sort.counting_rank

    def record(digits, num_buckets, use_kernel=None, bucket_starts=None):
        calls.append((digits.clone(), num_buckets, bucket_starts))
        return step(digits, num_buckets, use_kernel, bucket_starts)

    monkeypatch.setattr(sort, "counting_rank", record)
    sigma, n = 151_936, 5003
    seq = np.random.default_rng(8).integers(0, sigma, n).astype(np.int32)
    wt = twt.build_wavelet_tree(seq, sigma, big_step="radix",
                                use_kernels=True, device="cpu")
    assert [c[1] for c in calls] == [1 << 8, 1 << 16]
    for digits, nb, starts in calls:
        assert starts.dtype == torch.int32 and starts.shape == (nb,)
        assert np.array_equal(starts.numpy(),
                              _starts(digits.numpy()[None], nb)[0])
    # the build with the hand-over is the reference's tree, bit for bit
    ref_tree = jwt.build_wavelet_tree(jnp.asarray(seq.astype(np.uint32)),
                                      sigma, sample_rate=512,
                                      use_kernels=False)
    want = {".".join(p.name for p in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    got = convert.tree_to_reference(wt)
    for name in convert.TREE_LEAF_DTYPES:
        assert np.array_equal(got[name], want[name]), name


# ---------------------------------------------------------------------------
# the wrappers' contracts
# ---------------------------------------------------------------------------

def test_radix_wrappers_reject_bad_starts_and_buckets():
    d = torch.zeros((2, 10), dtype=torch.int32)
    good = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        radix_rank.radix_scan(d, 4, 10, good.long())          # int64
    with pytest.raises(ValueError):
        radix_rank.radix_scan(d, 4, 10, good[:1])             # rows
    with pytest.raises(ValueError):
        radix_rank.radix_rank(d, 4, 10, good[:, :3])          # buckets
    with pytest.raises(ValueError):
        ops.radix_rank(d, 4, good.reshape(8))                 # (…, B)
    for fn in (radix_rank.radix_totals, radix_rank.radix_rank):
        with pytest.raises(ValueError):
            fn(d, 513, 10)
    with pytest.raises(ValueError):
        radix_rank.radix_scan(d, 513, 10, torch.zeros((2, 513),
                                                      dtype=torch.int32))
    long_row = torch.zeros((1, 1), dtype=torch.int32).expand(1, 1 << 30)
    with pytest.raises(ValueError):
        radix_rank.radix_scan(long_row, 4, 1 << 30,
                              torch.zeros((1, 4), dtype=torch.int32))


def test_cpu_scans_never_launch_or_build():
    build.reset_launches()
    d = torch.from_numpy(_digits(2, 5000, 256, 0))
    ops.radix_rank(d, 256)
    ops.radix_rank(d, 256, torch.from_numpy(_starts(d.numpy(), 256)))
    radix_rank.radix_totals(d, 256, 5000)
    ops.rank_build_levels(torch.from_numpy(_words(3, 9000, 0)), 9000 * 32)
    assert build.launches == {name: 0 for name in build.launches}
    assert not build._loaded


def test_plain_rank_build_is_the_rank_select_directory():
    """``rank_build_levels_plain`` (the kernel's CPU stand-in) equals the
    reference oracle of the port on strided rows."""
    words = torch.from_numpy(_words(4, 8193, 5, stride=8200))
    got = rank_build.rank_build_levels_plain(words, 8193)
    want = ref.rank_build_levels_ref(words[:, :8193].contiguous(),
                                     8193 * 32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
