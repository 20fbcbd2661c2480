"""The port's slice as a whole: sharded build, compressed store and range
analytics on ``device="cpu"``, vs the JAX engine and a numpy oracle.

The reference builds through its default route, which needs a TPU check
that this jax does not have; the fixture patches
``repro.core.wavelet_matrix.default_use_kernels`` to the XLA route for the
duration of the build (nothing under ``src/repro`` changes). All outputs
are exact integers: every comparison is equality.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.wavelet_matrix as jwm_mod
from repro.analytics import engine as jengine
from repro.data import build_compressed_corpus as jbuild_corpus
from repro.data.synthetic import make_corpus as jmake_corpus
from repro_torch import convert
from repro_torch.analytics import build_sharded_analytics
from repro_torch.analytics import engine
from repro_torch.core.wavelet_matrix import build_wavelet_matrix
from repro_torch.data import build_compressed_corpus, make_corpus
from repro_torch.kernels.build import KernelError
from repro_torch.launch import analytics as cli
from repro_torch.tree import tree_named_leaves

SIGMA, SHARD_BITS = 64, 10
N = 4 * (1 << SHARD_BITS) - 77              # 4 shards, a ragged tail


@pytest.fixture(scope="module")
def corpora():
    toks = make_corpus(N, SIGMA, seed=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwm_mod, "default_use_kernels", lambda seq: False)
        jcorpus = jbuild_corpus(toks, SIGMA, shard_bits=SHARD_BITS,
                                sample_rate=128)
    tcorpus = build_compressed_corpus(toks, SIGMA, shard_bits=SHARD_BITS,
                                      sample_rate=128, device="cpu")
    return toks, jcorpus, tcorpus


def _queries(num: int, seed: int):
    rng = np.random.default_rng(seed)
    lo = rng.integers(-5, N + 5, num).astype(np.int32)
    hi = (lo + rng.integers(-3, N // 2, num)).astype(np.int32)
    k = rng.integers(-2, N // 2, num).astype(np.int32)
    lo[:4], hi[:4] = [0, 7, N, 1000], [N, 7, N + 4, 1030]  # full, empties,
    k[4:8] = N                                              # k past the end
    return lo, hi, k


def _oracle(toks, lo, hi, k, sym_lo, sym_hi):
    q, c = [], []
    for a, b, kk, s0, s1 in zip(lo, hi, k, sym_lo, sym_hi):
        a, b = min(max(a, 0), N), min(max(b, 0), N)
        sl = np.sort(toks[a:max(a, b)].astype(np.int64))
        q.append(-1 if len(sl) == 0 else sl[min(max(kk, 0), len(sl) - 1)])
        c.append(int(((sl >= s0) & (sl < s1)).sum()))
    return np.asarray(q), np.asarray(c)


def test_make_corpus_is_the_reference_stream():
    assert np.array_equal(make_corpus(5000, 1000, seed=7),
                          jmake_corpus(5000, 1000, seed=7))


def test_build_is_bit_identical_to_reference(corpora):
    _, jcorpus, tcorpus = corpora
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jcorpus.shards)[0]:
        flat[".".join(p.name for p in path)] = np.asarray(leaf)
    got = convert.to_reference(tcorpus.shards)
    for name in convert.LEAF_DTYPES:
        assert got[name].dtype == flat[name].dtype
        assert np.array_equal(got[name], flat[name]), name
    assert np.array_equal(tcorpus.shard_counts.numpy(),
                          np.asarray(jcorpus.shard_counts))
    assert tcorpus.bits_per_token() == jcorpus.bits_per_token()
    assert (tcorpus.n, tcorpus.num_shards) == (jcorpus.n, jcorpus.num_shards)


def test_range_quantile_and_count_match_reference(corpora):
    toks, jcorpus, tcorpus = corpora
    eng = engine.ShardedAnalytics.from_corpus(tcorpus)
    jeng = jengine.ShardedAnalytics.from_corpus(jcorpus)
    lo, hi, k = _queries(300, 1)
    sym_lo = (lo % SIGMA).astype(np.int32)
    sym_hi = np.minimum(sym_lo + 9, SIGMA).astype(np.int32)
    sym_hi[:3] = [SIGMA, 0, SIGMA + 5]
    want_q, want_c = _oracle(toks, lo, hi, k, sym_lo, sym_hi)
    got_q = eng.range_quantile(lo, hi, k)
    assert got_q.dtype == torch.int32
    assert np.array_equal(got_q.numpy(), want_q)
    jq = jax.jit(lambda e, a, b, c: e.range_quantile(a, b, c))(
        jeng, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(k))
    assert np.array_equal(got_q.numpy(), np.asarray(jq))
    # the plain descent and the store's own quantile agree with the kernel
    # route (its plain version here)
    assert np.array_equal(engine.sharded_range_quantile(
        eng.shards, SHARD_BITS, N, lo, hi, k).numpy(), want_q)
    assert np.array_equal(tcorpus.range_quantile(lo, hi, k).numpy(), want_q)
    got_c = eng.range_count(lo, hi, sym_lo, sym_hi)
    assert np.array_equal(got_c.numpy(), want_c)
    jc = jax.jit(lambda e, a, b, c, d: e.range_count(a, b, c, d))(
        jeng, *(jnp.asarray(x) for x in (lo, hi, sym_lo, sym_hi)))
    assert np.array_equal(got_c.numpy(), np.asarray(jc))
    assert np.array_equal(
        tcorpus.range_count(lo, hi, sym_lo, sym_hi).numpy(), want_c)


def test_availability_mask_takes_the_plain_descent(corpora):
    toks, _, tcorpus = corpora
    eng = engine.ShardedAnalytics.from_corpus(tcorpus)
    masked = dataclasses.replace(eng, available=torch.tensor(
        [True, False, True, True]))
    lo, hi, k = _queries(50, 2)
    kept = np.ones(N, bool)
    kept[1 << SHARD_BITS:2 << SHARD_BITS] = False
    got = masked.range_quantile(lo, hi, k).numpy()
    for i, (a, b, kk) in enumerate(zip(lo, hi, k)):
        a, b = min(max(a, 0), N), min(max(b, 0), N)
        sl = np.sort(toks[a:max(a, b)][kept[a:max(a, b)]].astype(np.int64))
        want = -1 if len(sl) == 0 else sl[min(max(kk, 0), len(sl) - 1)]
        assert got[i] == want


def test_store_access_count_locate_match_reference(corpora):
    toks, jcorpus, tcorpus = corpora
    rng = np.random.default_rng(4)
    pos = rng.integers(0, N, 200).astype(np.int32)
    assert np.array_equal(tcorpus.access(pos).numpy(), toks[pos])
    assert np.array_equal(tcorpus.access(pos).numpy(),
                          np.asarray(jcorpus.access(jnp.asarray(pos))))
    tok = toks[rng.integers(0, N, 40)].astype(np.int32)
    upto = rng.integers(0, N + 1, 40).astype(np.int32)
    upto[:2] = [0, N]
    assert np.array_equal(
        tcorpus.count(tok, upto).numpy(),
        [int((toks[:u] == t).sum()) for t, u in zip(tok, upto)])
    assert np.array_equal(tcorpus.count(tok).numpy(),
                          np.asarray(jcorpus.count(jnp.asarray(tok))))
    totals = np.bincount(toks, minlength=SIGMA)
    k = (rng.integers(0, 1 << 20, 40) % totals[tok]).astype(np.int32)
    k[0] = totals[tok[0]] - 1                      # last occurrence
    got = tcorpus.locate(tok, k).numpy()
    assert np.array_equal(got, [np.flatnonzero(toks == t)[kk]
                                for t, kk in zip(tok, k)])
    assert np.array_equal(got, np.asarray(jcorpus.locate(
        jnp.asarray(tok), jnp.asarray(k))))


def test_engine_build_is_the_batched_build_of_padded_shards():
    n = 3 * 512 - 9
    toks = make_corpus(n, 40, seed=5)
    eng = build_sharded_analytics(toks, 40, shard_bits=9, sample_rate=64,
                                  device="cpu")
    padded = np.zeros(3 * 512, np.int32)
    padded[:n] = toks
    want = build_wavelet_matrix(padded.reshape(3, 512), 40, sample_rate=64,
                                device="cpu")
    got, ref = tree_named_leaves(eng.shards), tree_named_leaves(want)
    assert got.keys() == ref.keys()
    assert all(torch.equal(got[name], ref[name]) for name in got)
    assert (eng.num_shards, eng.shard_size, eng.n) == (3, 512, n)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    toks = make_corpus(1000, 16, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_sharded_analytics(toks, 16, shard_bits=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_compressed_corpus(toks, 16, shard_bits=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_wavelet_matrix(toks.astype(np.int32), 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--smoke"])


def test_cli_smoke_on_cpu(capsys):
    cli.main(["--smoke", "--device", "cpu", "--queries", "64"])
    out = capsys.readouterr().out
    assert "verified 16 samples of each op against numpy" in out



def _snapshot_run(tmp_path, monkeypatch, error):
    """Save a snapshot with the CLI, then restore it with
    ``load_analytics`` raising ``error``."""
    args = ["--smoke", "--device", "cpu", "--queries", "64",
            "--snapshot-dir", str(tmp_path / "snap")]
    cli.main(args)

    def broken(*a, **k):
        raise error("CUDA kernel rank_build_levels failed: an illegal "
                    "memory access was encountered (700)")

    monkeypatch.setattr(cli, "load_analytics", broken)
    cli.main(args)


def test_cli_rebuilds_when_the_snapshot_restore_fails(tmp_path, monkeypatch,
                                                       capsys):
    _snapshot_run(tmp_path, monkeypatch, RuntimeError)
    out = capsys.readouterr().out
    assert "WARNING: snapshot restore failed (RuntimeError" in out
    assert "verified 16 samples of each op against numpy" in out


@pytest.mark.parametrize("error", [KernelError, torch.AcceleratorError,
                                   torch.OutOfMemoryError])
def test_cli_raises_a_device_error_of_the_restore(error, tmp_path,
                                                  monkeypatch, capsys):
    """A failure of the device while restoring is no unusable snapshot:
    the CLI raises it instead of warning and rebuilding."""
    with pytest.raises(error):
        _snapshot_run(tmp_path, monkeypatch, error)
    assert "WARNING" not in capsys.readouterr().out

def test_make_queries_is_the_reference_mix():
    from repro.launch.analytics import make_queries as jmake_queries
    for a, b in zip(cli.make_queries(10_000, 100, 1),
                    jmake_queries(10_000, 100, 1)):
        assert np.array_equal(a, b)


def test_port_imports_no_jax_and_nothing_of_repro():
    root = Path(__file__).resolve().parents[1]
    files = list((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert len(files) > 15 and not offenders
