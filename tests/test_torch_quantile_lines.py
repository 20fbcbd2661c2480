"""The sharded range quantile's serving forms on the CPU, against the
reference: the kernel's operands and plain descent, the 32-byte rank-line
layout the sweep times as a variant (``launch.sweep_quantile.line_rows``,
``wm_quantile_lines_plain``), and a numpy emulation of how the kernel
(``csrc/wm_quantile.cu``, and with 2 or 4 queries a warp the sweep's
``launch/csrc/wm_quantile_variants.cu``) deals a query's (shard, endpoint)
probes to the lanes of a warp and descends with them.

Inputs are made from numpy seeds; every comparison is exact equality. The
reference is built through its XLA route: the fixture patches
``repro.core.wavelet_matrix.default_use_kernels`` for the build (nothing
under ``src/repro`` changes).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.wavelet_matrix as jwm_mod
from repro.analytics import engine as jengine
from repro.core import rank_select as jrs
from repro.core.wavelet_matrix import build_wavelet_matrix as jbuild
from repro.data import build_compressed_corpus as jbuild_corpus
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.analytics import build_sharded_analytics
from repro_torch.core import rank_select
from repro_torch.core.wavelet_matrix import build_wavelet_matrix
from repro_torch.data import build_compressed_corpus
from repro_torch.kernels import build, ops, wm_quantile
from repro_torch.launch import sweep_quantile

# (shards, shard bits, n, sigma): S = 1; ragged; S = 300 (past the first
# kernel's cap of 256); rows of 2^11 bits (n / 224 ragged)
CASES = [(1, 10, 1000, 37), (3, 8, 700, 2), (40, 6, 40 * 64 - 5, 1000),
         (300, 5, 300 * 32 - 7, 16), (5, 11, 5 * 2048 - 300, 300)]


def _bits(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, n).astype(np.uint8)


def _pack(bits: np.ndarray) -> np.ndarray:
    pad = (-len(bits)) % 32
    b = np.pad(bits, (0, pad)).reshape(-1, 32).astype(np.uint64)
    return (b << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)


@pytest.mark.parametrize("n", [1, 31, 33, 223, 224, 225, 1000, 4481])
def test_line_counts_match_reference_rank1(n):
    """Line j of a row holds the reference rank1 at position 224 j, and the
    row's words 7j .. 7j + 6, zero past the row; rows of n bits with n a
    multiple of neither 224 nor 32 (and a few that are)."""
    rows = np.stack([_bits(n, n + r) for r in range(3)])
    rows[0] = 1                                   # an all-one row
    words = np.stack([_pack(r) for r in rows])    # (3, ceil(n/32)) uint32
    rs = rank_select.build_binary_rank(torch.from_numpy(words.view(np.int32)),
                                       n)
    lines = sweep_quantile.line_rows(rs.words, rs.superblock, rs.block, n)
    nlines = n // sweep_quantile.LINE_BITS + 1
    assert lines.shape == (3, nlines, sweep_quantile.LINE_WORDS + 1)
    starts = np.arange(nlines) * sweep_quantile.LINE_BITS
    for r in range(3):
        jrank = jrs.build_binary_rank(jnp.asarray(words[r]), n)
        want = np.asarray(jrs.rank1(jrank, jnp.asarray(starts)))
        assert np.array_equal(lines[r, :, 0].numpy(), want)
        body = np.zeros(nlines * sweep_quantile.LINE_WORDS, np.uint32)
        body[:words.shape[1]] = words[r]
        assert np.array_equal(lines[r, :, 1:].numpy().view(np.uint32),
                              body.reshape(nlines, -1))
    # every position, read from the lines as the line variant reads them
    pos = torch.arange(n + 1)
    for r in range(3):
        got = sweep_quantile.rank_lines_plain(lines, torch.tensor(r), pos)
        want = np.concatenate([[0], np.cumsum(rows[r])])
        assert np.array_equal(got.numpy(), want)


@functools.lru_cache(maxsize=None)
def _corpora(num_shards: int, shard_bits: int, n: int, sigma: int):
    """(tokens, reference corpus built with use_kernels=False, port
    corpus) of a seeded stream."""
    toks = np.random.default_rng(num_shards + sigma).integers(
        0, sigma, n).astype(np.int32)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jwm_mod, "default_use_kernels", lambda seq: False)
        jcorpus = jbuild_corpus(toks, sigma, shard_bits=shard_bits,
                                sample_rate=64)
    finally:
        mp.undo()
    tcorpus = build_compressed_corpus(toks, sigma, shard_bits=shard_bits,
                                      sample_rate=64, device="cpu")
    return toks, jcorpus, tcorpus


def _queries(n: int, shard_bits: int, seed: int):
    """Random ranges, empties (lo = hi, lo past n, hi below lo), k below 0
    and past the range, the whole stream, and ranges that start and end
    inside shards covering 1, 2, 31, 32, 33, 64, 65 and more shards."""
    rng = np.random.default_rng(seed)
    size = 1 << shard_bits
    lo = list(rng.integers(-3, n + 3, 40))
    hi = [a + int(rng.integers(-2, n)) for a in lo]
    k = list(rng.integers(-2, n, 40))
    lo += [0, 7, n, n + 5, 9, 0]
    hi += [n, 7, n, n + 9, 3, n]
    k += [n // 3, 0, 0, 1, 2, n + 50]
    for span in (1, 2, 31, 32, 33, 64, 65, 1000):
        a = int(rng.integers(0, n))
        lo.append(a)
        hi.append(min(n + 3, a + span * size - int(rng.integers(0, size))))
        k.append(int(rng.integers(-1, max(1, hi[-1] - a) + 2)))
    return (np.asarray(x, np.int32) for x in (lo, hi, k))


def _numpy_quantile(toks, n, lo, hi, k):
    out = []
    for a, b, kk in zip(lo, hi, k):
        a, b = min(max(a, 0), n), min(max(b, 0), n)
        sl = np.sort(toks[a:max(a, b)])
        out.append(-1 if len(sl) == 0 else sl[min(max(kk, 0), len(sl) - 1)])
    return np.asarray(out)


@pytest.mark.parametrize("num_shards,shard_bits,n,sigma", CASES)
def test_lines_plain_matches_the_reference(num_shards, shard_bits, n, sigma):
    """The descent on the 32-byte lines equals the reference's dense
    oracle, its engine's descent (built with use_kernels=False) and numpy;
    the kernel's plain version on the directories equals it too."""
    toks, jcorpus, tcorpus = _corpora(num_shards, shard_bits, n, sigma)
    lo, hi, k = _queries(n, shard_bits, num_shards)
    op = ops.quantile_operands(tcorpus.shards, shard_bits, n)
    got = sweep_quantile.wm_quantile_lines_plain(op, lo, hi, k)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _numpy_quantile(toks, n, lo, hi, k))
    words = tcorpus.shards.bitvectors.rank.words.numpy().view(np.uint32)
    want = jref.wm_quantile_sharded_ref(
        jnp.asarray(words), jnp.asarray(tcorpus.shards.zeros.numpy()),
        shard_bits, n, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(k))
    assert np.array_equal(got.numpy(), np.asarray(want))
    jq = jax.jit(functools.partial(jengine.sharded_range_quantile,
                                   shard_bits=shard_bits, n=n))(
        jcorpus.shards, lo=jnp.asarray(lo), hi=jnp.asarray(hi),
        k=jnp.asarray(k))
    assert np.array_equal(got.numpy(), np.asarray(jq))
    assert torch.equal(got, wm_quantile.wm_quantile_sharded_plain(op, lo, hi,
                                                                  k))
    assert torch.equal(got, wm_quantile.wm_quantile_sharded(op, lo, hi, k))


def test_lines_plain_matches_pallas_interpret():
    """Once, tiny: 2 shards of 2^7 over σ = 8 (3 levels), the reference's
    Pallas kernel in interpret mode."""
    shard_bits, n, sigma = 7, 250, 8
    size = 1 << shard_bits
    toks = np.random.default_rng(5).integers(0, sigma, 2 * size).astype(
        np.uint32)
    toks[n:] = 0
    jshards = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jbuild(jnp.asarray(toks[s * size:(s + 1) * size]), sigma,
               sample_rate=64, use_kernels=False) for s in range(2)])
    lo, hi, k = _queries(n, shard_bits, 6)
    want = jops.wm_quantile_sharded_batch(jshards, shard_bits, n,
                                          jnp.asarray(lo), jnp.asarray(hi),
                                          jnp.asarray(k), interpret=True)
    tshards = build_wavelet_matrix(toks.astype(np.int32).reshape(2, size),
                                   sigma, sample_rate=64, device="cpu")
    op = ops.quantile_operands(tshards, shard_bits, n)
    got = sweep_quantile.wm_quantile_lines_plain(op, lo, hi, k)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the kernel's probe dealing and descent, emulated in numpy
# ---------------------------------------------------------------------------

def _popcount(x: np.ndarray) -> np.ndarray:
    return np.array([bin(int(v)).count("1") for v in np.ravel(x)]).reshape(
        np.shape(x))


def _emulate(op, lo, hi, k, T: int, R: int):
    """The kernel's descent, warp by warp: T queries a warp, their probes
    dealt in order to lane pr % 32 of round pr // 32, rounds past R in
    scratch. Returns (answers, the dealt probes as (query, shard, endpoint,
    lane, round) tuples)."""
    words = op.words.numpy().view(np.uint32).astype(np.int64)
    sb = op.superblock.numpy().astype(np.int64)
    blk = op.block.numpy().view(np.uint16).astype(np.int64)
    zeros = op.zeros.numpy().astype(np.int64)
    nbits, n, shb, nblocks = op.nbits, op.n, op.shard_bits, op.nblocks
    size = 1 << shb
    over = max(0, T * 2 * op.num_shards - 32 * R)

    def rank(row, pos):                          # rank_probe, no-copy layout
        w, bc = pos >> 5, min(pos >> 7, nblocks - 1)
        r = int(sb[row, bc >> 3] + blk[row, bc])
        for j in range(4):
            wp = 4 * bc + j
            if wp < w:
                r += int(_popcount(words[row, wp]))
            elif wp == w:
                r += int(_popcount(words[row, wp] & ((1 << (pos & 31)) - 1)))
        return r

    Q, out, dealt = len(lo), np.empty(len(lo), np.int64), []
    for q0 in range(0, Q, T):
        glo, ghi, kk, sym, off = [], [], [], [0] * T, [0]
        for t in range(T):
            a = b = m = kq = 0
            if q0 + t < Q:
                a = min(max(int(lo[q0 + t]), 0), n)
                b = min(max(int(hi[q0 + t]), a), n)
                if b > a:
                    m = ((b - 1) >> shb) - (a >> shb) + 1
                    kq = min(max(int(k[q0 + t]), 0), b - a - 1)
            glo.append(a)
            ghi.append(b)
            kk.append(kq)
            off.append(off[-1] + 2 * m)
        probes = []                              # [slot, endpoint, shard, pos]
        for pr in range(off[T]):
            t = sum(pr >= off[u] for u in range(1, T))
            j = pr - off[t]
            e, s = j & 1, (glo[t] >> shb) + (j >> 1)
            base = s << shb
            pos = min(ghi[t] - base, size) if e else max(glo[t] - base, 0)
            if pr >= 32 * R:
                assert pr - 32 * R < over        # its scratch slot exists
            probes.append([t, e, s, pos])
            dealt.append((q0 + t, s, e, pr % 32, pr // 32))
        for l in range(nbits):
            acc, steps = [0] * T, []
            for t, e, s, pos in probes:
                row = s * nbits + l
                rk = rank(row, pos)
                acc[t] += (pos - rk) if e else -(pos - rk)
                steps.append((rk, int(zeros[row])))
            bits = []
            for t in range(T):
                bit = int(kk[t] >= acc[t])
                sym[t] = (sym[t] << 1) | bit
                kk[t] -= acc[t] if bit else 0
                bits.append(bit)
            for p, (rk, zl) in zip(probes, steps):
                p[3] = zl + rk if bits[p[0]] else p[3] - rk
        for t in range(T):
            if q0 + t < Q:
                out[q0 + t] = sym[t] if off[t + 1] > off[t] else -1
    return out, dealt


@pytest.mark.parametrize("T,R", [(1, 1), (1, 2), (1, 3), (2, 2), (4, 1),
                                 (4, 3)])
@pytest.mark.parametrize("case", [2, 3])
def test_probe_dealing_covers_every_probe_once(case, T, R):
    """Every (query, covered shard, endpoint) is dealt exactly once, to one
    (warp, lane, round) that no other probe takes, and the emulated
    descent equals the plain one (S = 40 and S = 300, queries covering up
    to every shard, registers for 1-3 rounds and the rest in scratch)."""
    num_shards, shard_bits, n, sigma = CASES[case]
    _, _, tcorpus = _corpora(num_shards, shard_bits, n, sigma)
    lo, hi, k = _queries(n, shard_bits, 7 + case)
    op = ops.quantile_operands(tcorpus.shards, shard_bits, n)
    got, dealt = _emulate(op, lo, hi, k, T, R)
    want = {}
    for q, (a, b) in enumerate(zip(lo, hi)):
        a = min(max(int(a), 0), n)
        b = min(max(int(b), a), n)
        if b > a:
            for s in range((a >> shard_bits), ((b - 1) >> shard_bits) + 1):
                want[(q, s, 0)] = want[(q, s, 1)] = 1
    probes = [d[:3] for d in dealt]
    assert len(probes) == len(set(probes)) == len(want)
    assert set(probes) == set(want)
    slots = [(d[0] // T, d[3], d[4]) for d in dealt]
    assert len(slots) == len(set(slots))
    shards_of = {}
    for q, s, _ in probes:
        shards_of.setdefault(q, set()).add(s)
    assert max(len(v) for v in shards_of.values()) > 32
    assert np.array_equal(got, wm_quantile.wm_quantile_sharded_plain(
        op, lo, hi, k).numpy())


def test_operands_check_their_inputs_once():
    """The operands' builder rejects what the kernel cannot read; the CPU
    engine holds its plain operands (no launch arguments) and never builds
    a kernel."""
    z = torch.zeros(2, dtype=torch.int32)
    words = torch.zeros((2, 4), dtype=torch.int32)
    sb = torch.zeros((2, 1), dtype=torch.int32)
    blk = torch.zeros((2, 1), dtype=torch.int16)
    kw = dict(num_shards=1, nbits=2, n=8, shard_bits=3)
    with pytest.raises(ValueError):                      # block not int16
        wm_quantile.quantile_operands(words, sb, sb, z, **kw)
    with pytest.raises(ValueError):                      # not whole blocks
        wm_quantile.quantile_operands(words[:, :3], sb, blk, z, **kw)
    with pytest.raises(ValueError):                      # n past the shards
        wm_quantile.quantile_operands(words, sb, blk, z,
                                      **{**kw, "n": 9})
    op = wm_quantile.quantile_operands(words, sb, blk, z, **kw)
    with pytest.raises(ValueError):                      # ragged queries
        wm_quantile.wm_quantile_sharded(op, [0, 1], [2], [0, 0])
    build.reset_launches()
    eng = build_sharded_analytics(np.arange(300) % 7, 7, shard_bits=6,
                                  device="cpu")
    assert eng.quantile.launch_args == () and eng.quantile.num_shards == 5
    assert int(eng.range_quantile([0], [300], [5])[0]) == np.sort(
        np.arange(300) % 7)[5]
    assert build.launches == {name: 0 for name in build.launches}
