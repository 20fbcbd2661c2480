"""The port's other tree and matrix constructions and the scans they need,
against ``repro``.

The port's fused tree and matrix builds are held against the reference in
``test_torch_wavelet_tree.py`` and ``test_torch_wavelet_matrix.py``; here
every other form (``fused=False`` τ-chunk builds, levelwise baselines, the
domain decomposition of Theorem 4.2) is held against the port's fused
build across the reference's own grids (``test_segmented_construction.py``
and ``test_construction_fast.py``), and against the JAX reference itself
in one case for each form and parameter value, the reference jitted
(on the CPU, compiling a build function whole is several times faster
than running it op by op) and built with ``use_kernels=False`` (its default route needs
a TPU check that this jax does not have). Inputs come from numpy seeds;
every output is an exact integer, so every comparison is equality.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scan as jscan
from repro.core import wavelet_matrix as jwm
from repro.core import wavelet_tree as jwt
from repro_torch.core import scan, sort
from repro_torch.core import wavelet_matrix as twm
from repro_torch.core import wavelet_tree as twt
from repro_torch.kernels import ops, radix_rank
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
    a reference pytree (its uint leaves read as the port's int bytes)."""
    got = tree_named_leaves(port)
    if not isinstance(want, dict):
        want = {k: v.numpy() for k, v in tree_named_leaves(want).items()}
    assert got.keys() == want.keys()
    for name, leaf in got.items():
        arr = leaf.numpy()
        assert np.array_equal(arr, np.asarray(want[name]).view(arr.dtype)), \
            name


def _seq(sigma: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, sigma, n).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _fused_tree(sigma: int, n: int):
    """The port's fused tree (held against the reference elsewhere); the
    tree does not depend on τ or the big step."""
    seq = _seq(sigma, n, sigma + n)
    return seq, twt.build_wavelet_tree(seq, sigma, sample_rate=128,
                                       device="cpu")


@functools.lru_cache(maxsize=None)
def _fused_matrix(sigma: int, n: int):
    seq = _seq(sigma, n, 3 * sigma + n)
    return seq, twm.build_wavelet_matrix(seq, sigma, sample_rate=128,
                                         device="cpu")


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------

def _seg_op(a, b):
    (va, fa), (vb, fb) = a, b
    return torch.where(fb != 0, vb, va + vb), fa | fb


def _jseg_op(a, b):
    (va, fa), (vb, fb) = a, b
    return jnp.where(fb, vb, va + vb), fa | fb


@pytest.mark.parametrize("n", [1, 2, 1000])
@pytest.mark.parametrize("reverse", [False, True])
def test_prefix_scan_matches_associative_scan(n, reverse):
    rng = np.random.default_rng(n)
    x = rng.integers(-50, 50, (3, n)).astype(np.int32)
    flags = (rng.random((3, n)) < 0.2).astype(np.int32)
    got = scan.prefix_scan(_seg_op, (torch.from_numpy(x),
                                     torch.from_numpy(flags)),
                           reverse=reverse, axis=1)
    want = jax.jit(lambda t: jax.lax.associative_scan(
        _jseg_op, t, reverse=reverse, axis=1))((jnp.asarray(x),
                                                jnp.asarray(flags)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # a single tensor with a non-commutative operator: the last nonzero
    sparse = np.where(flags[0] != 0, x[0], 0)
    got = scan.prefix_scan(lambda a, b: torch.where(b != 0, b, a),
                           torch.from_numpy(sparse), reverse=reverse)
    want = jax.jit(lambda t: jax.lax.associative_scan(
        lambda a, b: jnp.where(b != 0, b, a), t,
        reverse=reverse))(jnp.asarray(sparse))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_segment_offsets_matches_reference():
    sizes = np.random.default_rng(0).integers(0, 9, 37).astype(np.int32)
    got = scan.segment_offsets(torch.from_numpy(sizes), 37)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(
        jscan.segment_offsets(jnp.asarray(sizes), num_segments=37)))


@pytest.mark.parametrize("n", [1, 2, 300, 5000])
@pytest.mark.parametrize("first", [0, 1])
def test_segmented_exclusive_sum_matches_reference(n, first):
    rng = np.random.default_rng(n + first)
    x = rng.integers(0, 10, n).astype(np.int32)
    starts = (rng.random(n) < 0.1).astype(np.int32)
    starts[0] = first
    got = scan.segmented_exclusive_sum(torch.from_numpy(x),
                                       torch.from_numpy(starts))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(
        _jit(jscan.segmented_exclusive_sum, jnp.asarray(x),
             jnp.asarray(starts))))


def test_segmented_exclusive_sum_near_int32_limit():
    """Running totals pass 2^31 inside one long segment and across
    segments: the reference's int32 scan wraps, and so must the port."""
    n = 40
    x = np.full(n, (1 << 27) + 12345, np.int32)       # 40 · 2^27 > 2^31
    starts = np.zeros(n, np.int32)
    starts[[0, 3, 30]] = 1
    got = scan.segmented_exclusive_sum(torch.from_numpy(x),
                                       torch.from_numpy(starts)).numpy()
    want = np.asarray(_jit(jscan.segmented_exclusive_sum, jnp.asarray(x),
                           jnp.asarray(starts)))
    assert np.array_equal(got, want)
    assert got.min() < 0                 # the wrap is in the compared range


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 4097])
def test_running_max_matches_numpy(n):
    x = np.random.default_rng(n).integers(-1000, 1000, (2, n))
    got = scan.running_max(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.maximum.accumulate(x, axis=1))


# ---------------------------------------------------------------------------
# the tree's other forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma", [2, 256, 1 << 16])
@pytest.mark.parametrize("tau", [4, 8])
@pytest.mark.parametrize("big_step", ["compose", "radix", "xla"])
def test_tree_steps_match_fused(sigma, tau, big_step):
    for n in (1, 33, 777, 1025):
        seq, fused = _fused_tree(sigma, n)
        for use_kernels in (False, True):
            _same(twt.build_wavelet_tree(seq, sigma, tau=tau,
                                         big_step=big_step, sample_rate=128,
                                         fused=False,
                                         use_kernels=use_kernels,
                                         device="cpu"), fused)


@pytest.mark.parametrize("sigma,tau,big_step", [(2, 8, "compose"),
                                                (256, 4, "radix"),
                                                (1 << 16, 8, "xla")])
def test_tree_steps_match_reference(sigma, tau, big_step):
    seq, _ = _fused_tree(sigma, 777)
    ref = _jit(jwt.build_wavelet_tree, jnp.asarray(seq.astype(np.uint32)),
               sigma=sigma, tau=tau, big_step=big_step, sample_rate=128,
               fused=False, use_kernels=False)
    _same(twt.build_wavelet_tree(seq, sigma, tau=tau, big_step=big_step,
                                 sample_rate=128, fused=False, device="cpu"),
          _flat(ref))


@pytest.mark.parametrize("n,sigma", [(501, 2), (1337, 256), (900, 1 << 16)])
@pytest.mark.parametrize("fused", [True, False])
def test_levelwise_matches_fused(n, sigma, fused):
    seq, want = _fused_tree(sigma, n)
    _same(twt.build_wavelet_tree_levelwise(seq, sigma, sample_rate=128,
                                           fused=fused, device="cpu"), want)


@pytest.mark.parametrize("n,sigma,fused", [(1337, 256, True),
                                           (900, 1 << 16, False)])
def test_levelwise_matches_reference(n, sigma, fused):
    seq, _ = _fused_tree(sigma, n)
    ref = _jit(jwt.build_wavelet_tree_levelwise,
               jnp.asarray(seq.astype(np.uint32)), sigma=sigma,
               sample_rate=128, fused=fused)
    _same(twt.build_wavelet_tree_levelwise(seq, sigma, sample_rate=128,
                                           fused=fused, device="cpu"),
          _flat(ref))


@pytest.mark.parametrize("m,chunks,sigma", [(7, 4, 17), (128, 8, 256),
                                            (50, 16, 1000), (33, 3, 2),
                                            (5, 1, 40)])
@pytest.mark.parametrize("fused", [True, False])
def test_dd_matches_fused(m, chunks, sigma, fused):
    seq, want = _fused_tree(sigma, m * chunks)
    _same(twt.build_wavelet_tree_dd(seq, sigma, chunks, sample_rate=128,
                                    fused=fused, device="cpu"), want)


@pytest.mark.parametrize("fused", [True, False])
def test_dd_matches_reference(fused):
    seq, _ = _fused_tree(17, 28)
    ref = _jit(jwt.build_wavelet_tree_dd, jnp.asarray(seq.astype(np.uint32)),
               sigma=17, num_chunks=4, sample_rate=128, fused=fused)
    _same(twt.build_wavelet_tree_dd(seq, 17, 4, sample_rate=128,
                                    fused=fused, device="cpu"), _flat(ref))


def test_dd_rejects_ragged_chunks():
    with pytest.raises(ValueError):
        twt.build_wavelet_tree_dd(np.zeros(10, np.int32), 4, 3, device="cpu")


def test_segmented_partition_dest_matches_reference():
    rng = np.random.default_rng(7)
    n, nodes = 777, 16
    nid = np.sort(rng.integers(0, nodes, n)).astype(np.int32)
    bit = rng.integers(0, 2, n).astype(np.int32)
    got = twt._segmented_partition_dest(torch.from_numpy(nid),
                                        torch.from_numpy(bit), 5)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(
        _jit(jwt._segmented_partition_dest, jnp.asarray(nid),
             jnp.asarray(bit), level_plus1_bits=5)))


# ---------------------------------------------------------------------------
# the matrix baselines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma", [2, 256, 1 << 16])
@pytest.mark.parametrize("tau", [4, 8])
@pytest.mark.parametrize("big_step", ["compose", "radix", "xla"])
def test_matrix_steps_and_levelwise_match_fused(sigma, tau, big_step):
    for n in (1, 2, 33, 777, 1025):
        seq, fused = _fused_matrix(sigma, n)
        _same(twm.build_wavelet_matrix(seq, sigma, tau=tau,
                                       big_step=big_step, sample_rate=128,
                                       fused=False, device="cpu"), fused)
        if tau == 4 and big_step == "compose":
            _same(twm.build_wavelet_matrix_levelwise(
                seq, sigma, sample_rate=128, device="cpu"), fused)


def test_matrix_baselines_on_stacked_shards():
    seq = _seq(300, 3 * 500, 5).reshape(3, 500)
    fused = twm.build_wavelet_matrix(seq, 300, device="cpu")
    _same(twm.build_wavelet_matrix(seq, 300, big_step="radix", fused=False,
                                   device="cpu"), fused)
    _same(twm.build_wavelet_matrix_levelwise(seq, 300, device="cpu"), fused)


def test_matrix_baselines_match_reference():
    seq, _ = _fused_matrix(256, 777)
    jseq = jnp.asarray(seq.astype(np.uint32))
    _same(twm.build_wavelet_matrix(seq, 256, tau=4, big_step="radix",
                                   sample_rate=128, fused=False,
                                   device="cpu"),
          _flat(_jit(jwm.build_wavelet_matrix, jseq, sigma=256, tau=4,
                     big_step="radix", sample_rate=128, fused=False,
                     use_kernels=False)))
    _same(twm.build_wavelet_matrix_levelwise(seq, 256, sample_rate=128,
                                             device="cpu"),
          _flat(_jit(jwm.build_wavelet_matrix_levelwise, jseq, sigma=256,
                     sample_rate=128)))


# ---------------------------------------------------------------------------
# counting_rank: rows too long for the one-sweep scan
# ---------------------------------------------------------------------------

def test_counting_rank_routes_long_rows_off_the_kernel(monkeypatch):
    """Rows of ``radix_rank.MAX_ROW`` digits or more take the argsort
    route instead of the kernel (which would raise on such a row)."""
    digits = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, 5000).astype(np.int32))
    want = sort.counting_rank(digits, 256, use_kernel=False)

    def refuse(*args, **kwargs):
        raise AssertionError("ops.radix_rank called on a row past MAX_ROW")

    monkeypatch.setattr(radix_rank, "MAX_ROW", 4096)
    monkeypatch.setattr(ops, "radix_rank", refuse)
    got = sort.counting_rank(digits, 256, use_kernel=True)
    assert torch.equal(got, want)
    # a shorter row still goes to the kernel
    with pytest.raises(AssertionError, match="MAX_ROW"):
        sort.counting_rank(digits[:4095], 256, use_kernel=True)
