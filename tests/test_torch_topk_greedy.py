"""The greedy top-k kernel's route (``kernels/topk_greedy.py``,
``csrc/topk_greedy.cu``) on the CPU: the front-end's degraded top-k at the
smoke's shapes through the new wrapper against the old plain route and the
reference's ``sharded_range_topk_greedy``, and a step-for-step numpy
emulation of the kernel's loop (a block a query: a warp's one pass over
its copy of the slots for the heaviest slot and the prune's threshold from
the lanes' lists of lower bounds, the skipped empty intervals) against the
plain version. The kernel itself runs in ``tests/test_torch_cuda.py``."""
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
    sharded_range_topk_greedy as jsharded_range_topk_greedy
from repro_torch.analytics import build_sharded_analytics, engine as eng_mod
from repro_torch.analytics import range_ops
from repro_torch.data import make_corpus
from repro_torch.kernels import build, ops
from repro_torch.kernels.topk_greedy import topk_greedy_plain

#: the front-end smoke's engine (``launch.frontend --smoke``)
N, VOCAB, SHARD_BITS, K = 1 << 13, 64, 10, 8


@pytest.fixture(scope="module")
def tokens():
    return np.asarray(make_corpus(N, VOCAB, seed=0), np.int64)


@pytest.fixture(scope="module")
def engine(tokens):
    return build_sharded_analytics(tokens, VOCAB, shard_bits=SHARD_BITS,
                                   device="cpu")


@pytest.fixture(scope="module")
def jengine(tokens):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwm, "default_use_kernels", lambda seq: False)
        return jbuild_sharded_analytics(tokens, VOCAB,
                                        shard_bits=SHARD_BITS)


def _queries(bucket: int, seed: int):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, N - 1, bucket)
    hi = np.minimum(N, lo + rng.integers(1, N, bucket))
    lo[-1] = hi[-1] = 0                    # a padding lane: the empty range
    return lo.astype(np.int32), hi.astype(np.int32)


#: bounds a lane of the kernel keeps for the prune (``kTop``)
KTOP = 8


def prune_threshold(lbs, need: int) -> int:
    """The kernel's prune threshold over the slots' lower bounds ``lbs`` in
    slot order (None for a dead slot, which keeps its lane): for need <=
    ``KTOP`` each of 32 lanes keeps the KTOP largest bounds of its slots
    (slot j on lane j % 32) and the warp pops the need largest heads; past
    that the distinct bounds walked downwards. -1 where fewer than need
    slots are alive."""
    if need <= KTOP:
        lists = [sorted((x for x in lbs[lane::32] if x is not None),
                        reverse=True)[:KTOP] for lane in range(32)]
        v = -1
        for _ in range(need):
            heads = [(lst[0] if lst else -1) for lst in lists]
            v = max(heads)
            if v < 0:
                return -1
            lists[heads.index(v)].pop(0)
        return v
    alive = [x for x in lbs if x is not None]
    remaining, prev = need, None
    while True:
        cand = [x for x in alive if prev is None or x < prev]
        if not cand:
            return -1
        v = max(cand)
        c = alive.count(v)
        if c >= remaining:
            return v
        remaining -= c
        prev = v


def emulate_kernel(op, los, his, k: int, budget: int, prune: bool,
                   pops=None):
    """``topk_greedy_kernel`` step for step in numpy, one query (block) at a
    time: a warp's one pass over its slots a round, which retires the
    slots under the last prune's threshold (those that existed when it was
    found), finds the heaviest slot (first among equals) and the next
    threshold (:func:`prune_threshold`); the split's empty intervals left
    unprobed (their children hold zeros). ``pops``, an array if given,
    gets each query's rounds before it stopped."""
    S, nbits = op.num_shards, op.nbits
    words = op.words.numpy().view(np.uint32)
    sb, blk = op.superblock.numpy(), op.block.numpy().view(np.uint16)
    zeros = op.zeros.numpy()
    nblocks = op.nblocks

    def rank1(row, pos):
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

    cap = 2 * budget + 1
    Q = los.shape[0]
    out_s = np.full((Q, k), -1, np.int64)
    out_c = np.zeros((Q, k), np.int64)
    found = np.zeros(Q, np.int64)
    for q in range(Q):
        iv = np.zeros((cap, S, 2), np.int64)
        iv[0, :, 0], iv[0, :, 1] = los[q], his[q]
        w = np.zeros(cap, np.int64)
        sym = np.zeros(cap, np.int64)
        lev = np.zeros(cap, np.int64)
        alive = np.zeros(cap, bool)
        w[0], alive[0] = (his[q] - los[q]).sum(), True
        nslots, nout, thresh, kill_below = 1, 0, -1, 0
        kk = min(k, cap)
        for it in range(budget + 1):
            # a warp's pass: the last prune's retirees (of the slots that
            # existed when its threshold was found) go, the heaviest alive
            # slot is found, and the prune's bounds are gathered
            used = min(nslots, cap)
            idx = np.arange(used)
            alive[:used] &= ~((idx < kill_below) & (w[:used] < thresh))
            wt = np.where(alive[:used], w[:used], -1)
            best = int(np.argmax(wt))
            bw = int(wt[best])
            need = k - nout
            thresh = -1
            if it > 0 and prune and 0 < need <= kk:
                lbs = [int((w[j] + (1 << max(nbits - int(lev[j]), 0)) - 1)
                           >> max(nbits - int(lev[j]), 0))
                       if alive[j] else None for j in range(used)]
                thresh = prune_threshold(lbs, need)
            kill_below = used
            if it >= budget or bw <= 0 or nout >= k:
                if pops is not None:
                    pops[q] = it
                break
            if lev[best] == nbits:
                out_s[q, min(nout, k - 1)], out_c[q, min(nout, k - 1)] = \
                    sym[best], bw
                nout += 1
            else:
                a = min(nslots, cap - 2)
                for child in (a, a + 1):
                    w[child], lev[child] = 0, lev[best] + 1
                    sym[child] = (sym[best] << 1) | (child - a)
                    alive[child] = True
                for s in range(S):
                    lo, hi = iv[best, s]
                    iv[a, s] = iv[a + 1, s] = 0
                    if hi > lo:
                        row = s * nbits + int(lev[best])
                        rl, rh = rank1(row, lo), rank1(row, hi)
                        z = int(zeros[row])
                        iv[a, s] = (lo - rl, hi - rh)
                        iv[a + 1, s] = (z + rl, z + rh)
                    w[a] += iv[a, s, 1] - iv[a, s, 0]
                    w[a + 1] += iv[a + 1, s, 1] - iv[a + 1, s, 0]
                nslots += 2
            alive[best] = False
        found[q] = nout
    return out_s, out_c, found


@pytest.mark.parametrize("budget,bucket", [(48, 32), (24, 8)])
def test_frontend_greedy_route_equals_the_old_route_and_the_reference(
        engine, jengine, budget, bucket):
    """The front-end's level-1 and level-2 top-k (budget 6k and 3k, prune;
    its buckets of 32 and 8) through the engine's operands equal the old
    route (``range_ops.topk_frontier`` on the shards' level rows) and the
    reference's, with every shard and with two shards masked (the
    reference gets an all-true mask for the first: one trace serves
    both)."""
    lo, hi = _queries(bucket, budget + bucket)
    ref = jax.jit(lambda e, a, b, m: jsharded_range_topk_greedy(
        e.shards, e.shard_bits, e.n, a, b, K, budget=budget, prune=True,
        available=m))
    every = np.ones(engine.num_shards, bool)
    for available in (None, np.arange(engine.num_shards) % 4 != 1):
        mask = None if available is None else torch.from_numpy(available)
        new = eng_mod.sharded_range_topk_greedy(
            engine.shards, SHARD_BITS, engine.n, torch.from_numpy(lo),
            torch.from_numpy(hi), K, budget=budget, prune=True,
            available=mask, operands=engine.quantile)
        los, his = eng_mod.mask_ranges(*eng_mod.local_ranges(
            SHARD_BITS, engine.num_shards, engine.n, torch.from_numpy(lo),
            torch.from_numpy(hi)), mask)
        old = range_ops.topk_frontier(
            range_ops.level_rows(engine.shards), engine.shards.nbits, los.T,
            his.T, K, budget, True)[:2]
        want = ref(jengine, jnp.asarray(lo), jnp.asarray(hi),
                   jnp.asarray(every if available is None else available))
        for a, b, c in zip(new, old, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))


@pytest.mark.parametrize("budget,prune", [(48, True), (24, True),
                                          (48, False), (200, True)])
def test_kernel_emulation_equals_the_plain_version(engine, budget, prune):
    """The kernel's loop (emulated) against ``topk_greedy_plain`` on the
    smoke engine's operands: syms, counts and found, bit for bit, for wide,
    narrow, single-shard and empty ranges."""
    op = engine.quantile
    lo, hi = _queries(16, budget)
    lo[:3] = [5, 1023, 4000]
    hi[:3] = [6, 1025, 4001]
    los, his = eng_mod.local_ranges(SHARD_BITS, engine.num_shards, N,
                                    torch.from_numpy(lo),
                                    torch.from_numpy(hi))
    los, his = los.T.contiguous(), his.T.contiguous()
    want = topk_greedy_plain(op, los, his, K, budget, prune)
    got = emulate_kernel(op, los.numpy(), his.numpy(), K, budget, prune)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("budget,k", [(48, 12), (120, 20)])
def test_kernel_emulation_past_the_one_pass_prune(engine, budget, k):
    """k over the lanes' lists (``KTOP``): the prune's need reaches past 8
    and the emulated kernel walks the distinct bounds; still equal to
    ``topk_greedy_plain``."""
    op = engine.quantile
    lo, hi = _queries(12, budget + k)
    los, his = eng_mod.local_ranges(SHARD_BITS, engine.num_shards, N,
                                    torch.from_numpy(lo),
                                    torch.from_numpy(hi))
    los, his = los.T.contiguous(), his.T.contiguous()
    want = topk_greedy_plain(op, los, his, k, budget, True)
    got = emulate_kernel(op, los.numpy(), his.numpy(), k, budget, True)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.numpy(), b)


def test_plain_version_counts_the_kernels_pops(engine):
    """``topk_frontier``'s ``pops`` (the greedy kernel's bound in
    ``chip_smoke.py``: the most pops of a batch × a dependent load) equal
    the emulated kernel's rounds before each query stopped."""
    op = engine.quantile
    lo, hi = _queries(16, 5)
    lo[:2], hi[:2] = [7, 900], [8, 905]
    los, his = eng_mod.local_ranges(SHARD_BITS, engine.num_shards, N,
                                    torch.from_numpy(lo),
                                    torch.from_numpy(hi))
    los, his = los.T.contiguous(), his.T.contiguous()
    got = torch.zeros(16, dtype=torch.long)
    topk_greedy_plain(op, los, his, K, 48, True, pops=got)
    want = np.zeros(16, np.int64)
    emulate_kernel(op, los.numpy(), his.numpy(), K, 48, True, pops=want)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max() <= 48 and got[-1] == 0      # the padding lane


def test_wrapper_takes_the_plain_version_on_the_cpu(engine):
    """On CPU operands ``ops.topk_greedy`` runs the plain version (no
    launch, a ``plain`` trace) and checks its arguments."""
    from repro_torch import obs
    op = engine.quantile
    los = torch.zeros((4, engine.num_shards), dtype=torch.long)
    his = los + 7
    before = build.launches["topk_greedy"]
    syms, cnts, found = ops.topk_greedy(op, los, his, K, 12)
    assert build.launches["topk_greedy"] == before
    assert syms.shape == cnts.shape == (4, K) and found.shape == (4,)
    assert syms.dtype == cnts.dtype == found.dtype == torch.int32
    plain = range_ops.topk_frontier(range_ops.level_rows(engine.shards),
                                    engine.shards.nbits, los, his, K, 12)
    for a, b in zip((syms, cnts, found), plain):
        assert torch.equal(a, b)
    assert obs.REGISTRY.snapshot()["counters"].get(
        "kernels.trace{op=topk_greedy,route=plain}", 0) >= 1
    with pytest.raises(ValueError):
        ops.topk_greedy(op, los[:, :3], his[:, :3], K)
    with pytest.raises(ValueError):
        ops.topk_greedy(op, los, his, 0)
