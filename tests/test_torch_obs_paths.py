"""The path counters of the port's layers against the reference's.

The reference's counters fire once per jit trace, the port's once per call,
so the builds and queries compare as key sets, after the label map of the
port (``impl=xla`` → ``impl=torch``, ``path=xla``/``degraded_xla`` →
``path=torch``/``degraded_torch``, ``kernels.trace{interpret=true}`` →
``kernels.trace{route=plain}``). The reference's builders and queries are
traced whole (``jax.eval_shape``: no compile) at shapes that no other test
uses, so every counter fires at its trace; the jit caches are left alone,
as other tests of a worker rely on them. Where
the reference runs eagerly (the front-end, the ingester, the fault
injectors) the counts compare as well: the scripted ``FakeClock`` scenario
of ``tests/test_torch_serving.py`` gives equal ``serve.frontend.*``
counters, gauges and latency-histogram counts; one ingest crash of each
kind equal ``ingest.*`` counters; the seeded faults of
``tests/test_torch_faults.py`` equal ``robust.fault`` counts.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.wavelet_matrix as jwm
from repro import obs as robs
from repro.analytics import engine as janalytics
from repro.core import huffman as jh
from repro.core import multiary as jm
from repro.core import rank_select as jrs
from repro.core import wavelet_tree as jwt
from repro.index import fm_index as jfm
from repro.index import sharded as jsharded
from repro_torch import obs as tobs
from repro_torch.analytics import (build_sharded_analytics, load_analytics,
                                   save_analytics)
from repro_torch.checkpoint.checkpoint import _REFERENCE_VIEWS, host_array
from repro_torch.core import huffman, multiary, rank_select
from repro_torch.core import wavelet_matrix as twm
from repro_torch.core import wavelet_tree as twt
from repro_torch.index import build_sharded_index
from repro_torch.obs.metrics import _key, parse_key

SIGMA = 37
FAMILIES = ("core.", "analytics.", "index.", "kernels.trace", "robust.",
            "ingest.")


@pytest.fixture(autouse=True)
def _clean():
    for o in (robs, tobs):
        o.REGISTRY.reset()
    yield
    for o in (robs, tobs):
        o.REGISTRY.reset()


@pytest.fixture(autouse=True)
def _reference_xla_route(monkeypatch):
    """The reference's default build route fails under this jax; its XLA
    route runs instead (nothing under ``src/repro`` changes)."""
    monkeypatch.setattr(jwm, "default_use_kernels", lambda seq: False)


def _port_key(key: str) -> str:
    """A reference key under the port's label names."""
    name, labels = parse_key(key)
    if labels.get("impl") == "xla":
        labels["impl"] = "torch"
    if labels.get("path") in ("xla", "degraded_xla"):
        labels["path"] = labels["path"].replace("xla", "torch")
    if "interpret" in labels:
        labels["route"] = ("plain" if labels.pop("interpret") == "true"
                           else "cuda")
    return _key(name, labels)


def _keys(o, mapped: bool = False) -> set:
    got = {k for k in o.REGISTRY.snapshot()["counters"]
           if k.startswith(FAMILIES)}
    return {_port_key(k) for k in got} if mapped else got


def _traced(fn, *args):
    """The reference's keys of one trace of ``fn(*args)``."""
    robs.REGISTRY.reset()
    jax.eval_shape(fn, *args)
    return _keys(robs, mapped=True)


def _called(fn):
    tobs.REGISTRY.reset()
    fn()
    return _keys(tobs)


def _seq(n: int) -> np.ndarray:
    return np.random.default_rng(n).integers(0, SIGMA, n).astype(np.int32)


_BUILDS = {
    "matrix fused": (
        lambda s: jwm.build_wavelet_matrix(s, SIGMA, use_kernels=False),
        lambda s: twm.build_wavelet_matrix(s, SIGMA, use_kernels=False,
                                           device="cpu")),
    "matrix fused=False": (
        lambda s: jwm.build_wavelet_matrix(s, SIGMA, use_kernels=False,
                                           fused=False),
        lambda s: twm.build_wavelet_matrix(s, SIGMA, use_kernels=False,
                                           fused=False, device="cpu")),
    "matrix kernels": (
        lambda s: jwm.build_wavelet_matrix(s, SIGMA, use_kernels=True),
        lambda s: twm.build_wavelet_matrix(s, SIGMA, use_kernels=True,
                                           device="cpu")),
    "matrix levelwise": (
        lambda s: jwm.build_wavelet_matrix_levelwise(s, SIGMA),
        lambda s: twm.build_wavelet_matrix_levelwise(s, SIGMA,
                                                     device="cpu")),
    "tree fused": (
        lambda s: jwt.build_wavelet_tree(s, SIGMA, use_kernels=False),
        lambda s: twt.build_wavelet_tree(s, SIGMA, use_kernels=False,
                                         device="cpu")),
    "tree fused=False": (
        lambda s: jwt.build_wavelet_tree(s, SIGMA, use_kernels=False,
                                         fused=False),
        lambda s: twt.build_wavelet_tree(s, SIGMA, use_kernels=False,
                                         fused=False, device="cpu")),
    "tree levelwise": (
        lambda s: jwt.build_wavelet_tree_levelwise(s, SIGMA),
        lambda s: twt.build_wavelet_tree_levelwise(s, SIGMA, device="cpu")),
    "tree dd": (
        lambda s: jwt.build_wavelet_tree_dd(s, SIGMA, 4),
        lambda s: twt.build_wavelet_tree_dd(s, SIGMA, 4, device="cpu")),
    "multiary": (
        lambda s: jm.build_multiary_wavelet_tree(s, SIGMA, 2),
        lambda s: multiary.build_multiary_wavelet_tree(s, SIGMA, 2,
                                                       device="cpu")),
}

#: counters the port's kernel route adds: the matrix build counts every
#: level's zeros in one launch of its own (the reference's fused level
#: counts them inside its level kernel) and moves a level's keys inside the
#: level's launch (the reference scatters them), and the engine's counts
#: and greedy top-k run on kernels of the port's own (the reference runs
#: them as XLA loops)
PORT_ONLY = {"kernels.trace{op=wm_level_zeros,route=plain}",
             "kernels.trace{op=wm_level_move,route=plain}",
             "core.level_move{builder=wm,form=field}",
             "kernels.trace{op=wm_count,route=plain}",
             "kernels.trace{op=topk_greedy,route=plain}"}


@pytest.mark.parametrize("name", list(_BUILDS))
def test_build_counters_equal_the_reference(name):
    jfn, tfn = _BUILDS[name]
    seq = _seq(516 + 4 * list(_BUILDS).index(name))     # its own shape
    want = _traced(jfn, jnp.asarray(seq))
    got = _called(lambda: tfn(torch.from_numpy(seq)))
    assert want and got - PORT_ONLY == want


@pytest.mark.parametrize("fused", [True, False])
def test_huffman_counters_equal_the_reference(fused):
    seq = _seq(601 if fused else 603)
    codes, lengths, max_len = jh.huffman_codebook(
        np.bincount(seq, minlength=SIGMA))
    jc, jl = jnp.asarray(codes), jnp.asarray(lengths)
    want = _traced(lambda s: jh.build_huffman_wavelet_tree(
        s, jc, jl, max_len, fused=fused), jnp.asarray(seq))
    got = _called(lambda: huffman.build_huffman_wavelet_tree(
        torch.from_numpy(seq), codes, lengths, max_len, fused=fused,
        device="cpu"))
    assert want and got == want


@pytest.mark.parametrize("use_kernels", [False, True])
def test_rank_build_counters_equal_the_reference(use_kernels):
    w = 19 if use_kernels else 21
    words = np.random.default_rng(1).integers(
        -(1 << 31), 1 << 31, (3, w), dtype=np.int64).astype(np.int32)
    want = _traced(lambda x: jrs.build_bitvector_levels(
        x, 32 * w, use_kernels=use_kernels),
        jnp.asarray(words.view(np.uint32)))
    got = _called(lambda: rank_select.build_bitvector_levels(
        torch.from_numpy(words), 32 * w, use_kernels=use_kernels))
    assert want and got == want


# ---------------------------------------------------------------------------
# engine and index queries, eager on both sides
# ---------------------------------------------------------------------------

def _to_reference(x, classes, view=None):
    """A port structure as the reference's class of the same name, leaf
    for leaf; fields the reference lacks are left out."""
    if x is None or isinstance(x, (int, bool, str)):
        return x
    if isinstance(x, torch.Tensor):
        return jnp.asarray(host_array(x, view))
    cls = classes[type(x).__name__]
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: _to_reference(getattr(x, f.name), classes,
                                        _REFERENCE_VIEWS.get(
                                            (type(x), f.name)))
                  for f in dataclasses.fields(x) if f.name in names})


_CLASSES = {"BinaryRank": jrs.BinaryRank, "BinarySelect": jrs.BinarySelect,
            "BitVector": jrs.BitVector, "WaveletMatrix": jwm.WaveletMatrix,
            "ShardedAnalytics": janalytics.ShardedAnalytics,
            "FMIndex": jfm.FMIndex,
            "ShardedTextIndex": jsharded.ShardedTextIndex}


@pytest.fixture(scope="module")
def engines():
    toks = np.random.default_rng(2).integers(0, 50, 1280).astype(np.int64)
    eng = build_sharded_analytics(toks, 61, shard_bits=8, device="cpu")
    deg = eng.drop_shards([1])
    return ((eng, _to_reference(eng, _CLASSES)),
            (deg, _to_reference(deg, _CLASSES)))


_QUERIES = (np.asarray([0, 17, 100, 3, 1200], np.int32),
            np.asarray([64, 900, 1024, 3, 1280], np.int32),
            np.asarray([3, 100, 7, 0, 30], np.int32))

_ENGINE_OPS = {
    "quantile": (lambda e, lo, hi, k: e.range_quantile(lo, hi, k,
                                                       use_kernel=True),
                 lambda e, lo, hi, k: e.range_quantile(lo, hi, k)),
    "quantile_bracket": (lambda e, lo, hi, k: e.range_quantile_bracket(
        lo, hi, k, 3),) * 2,
    "count": (lambda e, lo, hi, k: e.range_count(lo, hi, k, k + 9),) * 2,
    "count_bounds": (lambda e, lo, hi, k: e.range_count_bounds(lo, hi, k,
                                                               k + 9),) * 2,
    "topk": (lambda e, lo, hi, k: e.range_topk(lo, hi, 4),) * 2,
    "topk_greedy": (lambda e, lo, hi, k: e.range_topk_greedy(lo, hi, 4),) * 2,
    "distinct": (lambda e, lo, hi, k: e.range_distinct(lo, hi),) * 2,
    "histogram": (lambda e, lo, hi, k: e.range_histogram(lo, hi),) * 2,
    "histogram_bounds": (lambda e, lo, hi, k: e.range_histogram_bounds(
        lo, hi),) * 2,
}


@pytest.mark.parametrize("degraded", [False, True])
@pytest.mark.parametrize("op", list(_ENGINE_OPS))
def test_engine_op_counters_equal_the_reference(op, degraded, engines):
    (eng, jeng) = engines[int(degraded)]
    jfn, tfn = _ENGINE_OPS[op]
    want = _traced(jfn, jeng, *(jnp.asarray(q) for q in _QUERIES))
    got = _called(lambda: tfn(eng, *(torch.from_numpy(q)
                                     for q in _QUERIES)))
    assert f"analytics.op{{op={op}}}" in want and got - PORT_ONLY == want


@pytest.fixture(scope="module")
def indexes():
    toks = np.random.default_rng(3).integers(0, 40, 1536).astype(
        np.int64)
    idx = build_sharded_index(toks, 40, shard_bits=9, sample_rate=16,
                              seam_overlap=7, device="cpu")
    deg = idx.drop_shards([1])
    pats = toks[100:105][None].astype(np.int32)
    return pats, [(x, _to_reference(x, _CLASSES)) for x in (idx, deg)]


@pytest.mark.parametrize("degraded", [False, True])
@pytest.mark.parametrize("op", ["count", "count_bounds", "locate"])
def test_index_counters_equal_the_reference(op, degraded, indexes):
    pats, pairs = indexes
    idx, jidx = pairs[int(degraded)]
    lens = np.asarray([5], np.int32)
    want = _traced(lambda ix, p, l: getattr(ix, op)(p, l), jidx,
                   jnp.asarray(pats), jnp.asarray(lens))
    got = _called(lambda: getattr(idx, op)(torch.from_numpy(pats),
                                           torch.from_numpy(lens)))
    assert f"index.op{{op={op},path={'degraded' if degraded else 'full'}}}" \
        in want and got == want


def test_snapshot_load_that_repairs_counts_as_the_reference(tmp_path,
                                                            engines):
    from repro.analytics import load_analytics as jload_analytics
    from repro.robust import faults as jfaults
    from repro_torch.robust import faults
    eng = engines[0][0]
    mine, theirs = tmp_path / "port", tmp_path / "reference"
    save_analytics(eng, mine)
    shutil.copytree(mine, theirs)
    faults.corrupt_snapshot_leaf(mine, seed=3, leaf_match="superblock")
    jfaults.corrupt_snapshot_leaf(theirs, seed=3, leaf_match="superblock")
    robs.REGISTRY.reset()
    tobs.REGISTRY.reset()
    jload_analytics(theirs)
    load_analytics(mine, device="cpu")
    r, t = robs.REGISTRY.snapshot(), tobs.REGISTRY.snapshot()
    assert t["counters"]["robust.restore{outcome=repaired}"] == 1
    for fam in ("robust.",):
        assert ({k: v for k, v in t["counters"].items() if k.startswith(fam)}
                == {k: v for k, v in r["counters"].items()
                    if k.startswith(fam)})
    spans = {k: h["count"] for k, h in t["histograms"].items()
             if k.startswith("span.")}
    assert spans == {k: h["count"] for k, h in r["histograms"].items()
                     if k.startswith("span.")}
    assert spans == {"span.analytics.load": 1,
                     "span.analytics.load.restore": 1,
                     "span.analytics.load.repair": 1}


# ---------------------------------------------------------------------------
# eager on both sides: counts equal
# ---------------------------------------------------------------------------

def _family(o, prefix: str) -> dict:
    snap = o.REGISTRY.snapshot()
    out = {k: v for part in ("counters", "gauges")
           for k, v in snap[part].items() if k.startswith(prefix)}
    out.update({k: h["count"] for k, h in snap["histograms"].items()
                if k.startswith(prefix)})
    return out


def test_frontend_counters_equal_the_reference():
    import repro.robust as jrobust
    import repro.serving as jserving
    from repro.analytics.engine import \
        build_sharded_analytics as jbuild_sharded_analytics
    from repro.ingest.serving import GenerationServer as JGenerationServer
    from repro_torch.ingest import GenerationServer
    from repro_torch.robust import FakeClock, inject_shard_latency
    from repro_torch.serving import (FrontendConfig, LadderConfig,
                                     QueryFrontend)
    from test_torch_serving import N as FE_N, SHARD_BITS, SIGMA as FE_SIGMA
    from test_torch_serving import _script

    toks = np.random.default_rng(7).integers(0, 50, FE_N).astype(np.uint32)
    engine = build_sharded_analytics(toks, FE_SIGMA, shard_bits=SHARD_BITS,
                                     device="cpu")
    jengine = jbuild_sharded_analytics(toks, FE_SIGMA, shard_bits=SHARD_BITS)
    cfg = dict(buckets=(8,), capacity=16, probe_shards=True)
    clock, jclock = FakeClock(), jrobust.FakeClock()
    fe = QueryFrontend(GenerationServer(engine), clock=clock,
                       config=FrontendConfig(
                           ladder=LadderConfig(up_pressure=0.5), **cfg))
    jfe = jserving.QueryFrontend(
        JGenerationServer(jengine), clock=jclock,
        config=jserving.FrontendConfig(
            ladder=jserving.LadderConfig(up_pressure=0.5), **cfg))
    robs.REGISTRY.reset()
    tobs.REGISTRY.reset()
    try:
        _script(fe, clock, inject_shard_latency)
        _script(jfe, jclock, jrobust.inject_shard_latency)
    finally:
        fe.breakers.close_pool()
        jfe.breakers.close_pool()
    got, want = _family(tobs, "serve.frontend."), _family(robs,
                                                         "serve.frontend.")
    # the compile counter counts the port's new (op, bucket) variants and
    # the reference's jit compiles: one per variant in both
    assert got == want
    assert want["serve.frontend.breaker_open"] >= 1
    assert {k for k in want if ".latency_s" in k} == {
        f"serve.frontend.{op}.latency_s" for op in ("count", "quantile",
                                                     "topk")}
    assert _family(tobs, "robust.fault") == _family(robs, "robust.fault")


@pytest.mark.parametrize("kind", ["analytics", "index"])
def test_ingest_crash_counters_equal_the_reference(kind, tmp_path):
    import repro.ingest as jingest
    from repro.robust import CrashInjected as JCrashInjected
    from repro.robust import crash_after as jcrash_after
    import repro_torch.ingest as tingest
    from repro_torch.robust import CrashInjected, crash_after

    toks = np.random.default_rng(7).integers(0, 8, 1500).astype(np.int64)
    kw = dict(sample_rate=16, seam_overlap=7) if kind == "index" else {}

    def make(pkg, d):
        fn = (pkg.analytics_ingester if kind == "analytics"
              else pkg.index_ingester)
        extra = {} if pkg is jingest else {"device": "cpu"}
        return fn(d, 8, shard_bits=8, backoff_s=0.0, **kw, **extra)

    for pkg, crash, exc, d in ((tingest, crash_after, CrashInjected,
                                tmp_path / "port"),
                               (jingest, jcrash_after, JCrashInjected,
                                tmp_path / "reference")):
        ing = make(pkg, d)
        ing.recover()
        with pytest.raises(exc):
            with crash("rename"):
                ing.append_tokens(toks)
                ing.flush()
        ing = make(pkg, d)
        rep = ing.recover()
        ing.append_tokens(toks[rep.resume_offset:])
        ing.flush()
    got = {k: v for k, v in _family(tobs, "ingest.").items()
           if not k.endswith("swap_pause_s")}
    want = {k: v for k, v in _family(robs, "ingest.").items()
            if not k.endswith("swap_pause_s")}
    assert got == want and got["ingest.quarantine{reason=" 
                               "intent_without_commit}"] == 1
    assert (_family(tobs, "span.ingest.") == _family(robs, "span.ingest."))
    assert _family(tobs, "robust.") == _family(robs, "robust.")


def test_seeded_fault_counts_equal_the_reference(tmp_path, engines):
    import repro.robust as jrobust
    from repro.robust import faults as jfaults
    from repro_torch.robust import faults, with_retry
    from repro_torch.robust import FakeClock
    eng = engines[0][0]
    for name in ("port", "reference"):
        save_analytics(eng, tmp_path / name)
    for f, d, clock, retry in (
            (faults, tmp_path / "port", FakeClock(), with_retry),
            (jfaults, tmp_path / "reference", jrobust.FakeClock(),
             jrobust.with_retry)):
        f.corrupt_snapshot_leaf(d, seed=5)
        f.truncate_file(d, "arrays.npz", keep_frac=0.5)
        f.inject_partial_tmp(d, step=99)
        f.delete_file(d, "meta.json")
        f.delete_step(d)
        f.flip_leaf_bit({"w": (torch.arange(8) if f is faults
                               else jnp.arange(8))}, seed=2)
        with f.crash_after("x"):
            with pytest.raises(BaseException):
                f.check_crash_point("x")
        with f.inject_shard_latency(3, 1.0):
            pass
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise KeyError("transient")
            return 1

        retry(flaky, retries=4, backoff_s=0.1, clock=clock,
              rng=np.random.default_rng(0))
        with pytest.raises(KeyError):
            retry(lambda: {}["x"], retries=2, backoff_s=0.1, clock=clock,
                  rng=np.random.default_rng(0))
    got, want = _family(tobs, "robust."), _family(robs, "robust.")
    assert got == want
    assert got["robust.retry"] == 4 and got["robust.retry_exhausted"] == 1
    assert len([k for k in got if k.startswith("robust.fault")]) == 8
