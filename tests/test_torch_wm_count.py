"""The count kernel's route (``kernels/wm_count.py``, ``csrc/wm_count.cu``)
on the CPU: ``wm_count_plain`` against the reference's
``sharded_range_count`` (the sums of its per-shard ``range_count``), with
symbol bounds at and below 0, at and past 2^nbits, equal and reversed, and
with shards masked; and a step-for-step numpy emulation of the kernel's
descents (a block a query, 16 shards a warp, lo and hi on neighbouring
lanes, one probe a level while the bounds' bits agree, none for a bound
whose answer is known) against the plain version. The kernel itself runs in
``tests/test_torch_cuda.py``."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.wavelet_matrix as jwm
from repro.analytics.engine import \
    build_sharded_analytics as jbuild_sharded_analytics
from repro.analytics.engine import \
    sharded_range_count as jsharded_range_count
from repro_torch.analytics import build_sharded_analytics, engine as eng_mod
from repro_torch.kernels.wm_count import wm_count_plain

#: 40 shards of 64 (not a multiple of a warp's 16), the last one ragged
SHARD_BITS, SHARDS, SIGMA = 6, 40, 300
N = SHARDS * (1 << SHARD_BITS) - 5


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(7).zipf(1.3, N) % SIGMA


@pytest.fixture(scope="module")
def engine(tokens):
    return build_sharded_analytics(tokens, SIGMA, shard_bits=SHARD_BITS,
                                   device="cpu")


@pytest.fixture(scope="module")
def jengine(tokens):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwm, "default_use_kernels", lambda seq: False)
        return jbuild_sharded_analytics(tokens, SIGMA, shard_bits=SHARD_BITS)


def _batch(q: int, seed: int, top: int):
    """Ranges (one empty, one a single position, one the whole corpus) and
    symbol bounds: each of <= 0, 0, inside, 2^nbits and past it on either
    side, equal and reversed pairs among them."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, N - 1, q)
    hi = np.minimum(N, lo + rng.integers(1, N, q))
    lo[:3], hi[:3] = [0, 77, 0], [0, 78, N]
    edges = np.array([-3, 0, 1, SIGMA // 2, SIGMA, top - 1, top, top + 9])
    a = np.where(rng.random(q) < 0.5, rng.choice(edges, q),
                 rng.integers(-5, top + 5, q))
    b = np.where(rng.random(q) < 0.5, rng.choice(edges, q),
                 rng.integers(-5, top + 5, q))
    b[3:6] = a[3:6]                        # equal bounds
    return [x.astype(np.int32) for x in (lo, hi, a, b)]


def _local(engine, lo, hi, mask=None):
    los, his = eng_mod.mask_ranges(*eng_mod.local_ranges(
        SHARD_BITS, engine.num_shards, N, torch.from_numpy(lo),
        torch.from_numpy(hi)), mask)
    return los.T.contiguous(), his.T.contiguous()


def test_plain_count_equals_the_reference(engine, jengine):
    top = 1 << engine.shards.nbits
    lo, hi, a, b = _batch(64, 0, top)
    ref = jax.jit(lambda e, lo, hi, a, b, m: jsharded_range_count(
        e.shards, SHARD_BITS, N, lo, hi, a, b, available=m))
    available = np.arange(SHARDS) % 5 != 2
    for mask in (None, available):
        los, his = _local(engine, lo, hi,
                          None if mask is None else torch.from_numpy(mask))
        got = wm_count_plain(engine.quantile, los, his, torch.from_numpy(a),
                             torch.from_numpy(b))
        want = ref(jengine, *(jnp.asarray(x) for x in (lo, hi, a, b)),
                   jnp.asarray(np.ones(SHARDS, bool) if mask is None
                               else mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[3:6] == 0).all()       # equal bounds count nothing


def emulate_kernel(op, los, his, sym_lo, sym_hi):
    """``wm_count_kernel`` in numpy: a block a query, each group of 16
    shards a warp, lane 2j and 2j + 1 the lo and hi endpoint of shard
    16c + j; the two bounds clamped into [0, 2^nbits], an empty symbol
    range or group skipped; per lane one descent while the bounds' bits
    agree (or one bound is known), two after; the lanes' counts summed
    into the query's total."""
    S, nbits = op.num_shards, op.nbits
    words = op.words.numpy().view(np.uint32)
    sb, blk = op.superblock.numpy(), op.block.numpy().view(np.uint16)
    zeros = op.zeros.numpy()
    nblocks = op.nblocks
    probes = 0

    def rank1(row, pos):
        nonlocal probes
        probes += 1
        bc = min(pos >> 7, nblocks - 1)
        r = int(sb[row, bc >> 3]) + int(blk[row, bc])
        for j in range(4):
            wj = 4 * bc + j
            v = int(words[row, wj])
            if wj < pos >> 5:
                r += bin(v).count("1")
            elif wj == pos >> 5:
                r += bin(v & ((1 << (pos & 31)) - 1)).count("1")
        return r

    top = 1 << nbits
    Q = los.shape[0]
    out = np.zeros(Q, np.int64)
    for q in range(Q):
        bhi = min(max(int(sym_hi[q]), 0), top)
        blo = min(max(int(sym_lo[q]), 0), top)
        if bhi <= blo:
            continue
        act_h, act_l = bhi < top, blo > 0
        part = (nbits - (bhi ^ blo).bit_length() if act_h and act_l
                else nbits)
        for c in range(-(-S // 16)):
            total = 0
            for lane in range(32):
                s, e = c * 16 + lane // 2, lane & 1
                lo, hi = (int(los[q, s]), int(his[q, s])) if s < S else (0, 0)
                if hi <= lo:
                    continue
                sign = 1 if e else -1
                pos0 = hi if e else lo
                ph = pl = pos0
                acc_h = acc_l = 0
                if act_h or act_l:
                    for l in range(nbits):
                        row = s * nbits + l
                        one = l < part or not act_h or not act_l
                        ra = rank1(row, ph if act_h else pl)
                        rl = ra if one else rank1(row, pl)
                        z = int(zeros[row])
                        sh = nbits - 1 - l
                        if act_h:
                            if (bhi >> sh) & 1:
                                acc_h += sign * (ph - ra)
                                ph = z + ra
                            else:
                                ph -= ra
                        if act_l:
                            if (blo >> sh) & 1:
                                acc_l += sign * (pl - rl)
                                pl = z + rl
                            else:
                                pl -= rl
                total += ((acc_h if act_h else sign * pos0)
                          - (acc_l if act_l else 0))
            out[q] += total
    return out, probes


@pytest.mark.parametrize("seed", [1, 2])
def test_kernel_emulation_equals_the_plain_version(engine, seed):
    """The kernel's descents (emulated) against ``wm_count_plain``, every
    shard and a masked set; the known bounds and the shared prefix take
    fewer probes than two full descents a (shard, endpoint)."""
    op = engine.quantile
    top = 1 << op.nbits
    lo, hi, a, b = _batch(48, seed, top)
    mask = torch.from_numpy(np.arange(SHARDS) % 3 != 1)
    for m in (None, mask):
        los, his = _local(engine, lo, hi, m)
        want = wm_count_plain(op, los, his, torch.from_numpy(a),
                              torch.from_numpy(b))
        got, probes = emulate_kernel(op, los.numpy(), his.numpy(), a, b)
        np.testing.assert_array_equal(want.numpy(), got)
        live = int((his > los).sum())
        assert probes < 4 * live * op.nbits
