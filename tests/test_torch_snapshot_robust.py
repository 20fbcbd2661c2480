"""The port's checkpoint, integrity, snapshot, verify and repair layer on
``device="cpu"``, held to the JAX reference on the fixtures of
``tests/test_robust.py``, ``tests/test_analytics_snapshot.py`` and
``tests/test_checkpoint.py``.

Snapshots interchange both ways: a port snapshot loads in
``repro.analytics.load_analytics`` and a reference snapshot in the port's,
with equal ``leaf_crc32`` maps (the same keys, dtypes and bytes). Verify
reports, repaired leaves and checksums equal the reference's; the deep FM
repair equals the reference's sequential LF walk. Faults are the port's
own (``repro_torch.robust.faults``, held to the reference's in
``tests/test_torch_faults.py``); the reference's flip its own structures. The reference's inputs
are the port's structures carried into its classes leaf for leaf (the
port's builds are held bit-identical to the reference's elsewhere), so no
reference build runs here.
"""
import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.analytics as janalytics
import repro.checkpoint as jckpt
import repro.core.rank_select as jrs
import repro.core.wavelet_matrix as jwm
import repro.core.wavelet_tree as jwt
import repro.index.fm_index as jfm
import repro.index.sharded as jsharded
import repro.robust as jrobust
from repro.robust import faults as jfaults
from repro.robust.repair import _rebuild_sa_directories
from repro_torch.analytics import (ShardedAnalytics, build_sharded_analytics,
                                   load_analytics, save_analytics,
                                   shards_struct, snapshot_meta)
from repro_torch.checkpoint import (checkpoint_steps, flatten, latest_step,
                                    restore_checkpoint, save_checkpoint,
                                    step_dir_valid)
from repro_torch.core.wavelet_tree import build_wavelet_tree
from repro_torch.index import build_sharded_index, suffix_array
from repro_torch.robust import faults
from repro_torch.robust import (IntegrityError, checksum_array,
                                classify_bad_keys, is_primary_key,
                                repair_analytics, repair_fm_index,
                                repair_sharded_index, repair_wavelet_tree,
                                tree_checksums, trees_identical,
                                verify_analytics, verify_fm_index,
                                verify_sharded_index, verify_wavelet_matrix,
                                verify_wavelet_tree)
from repro_torch.robust.repair import suffix_array_from_bwt, wm_decode
from repro_torch.tree import tree_map

N, SIGMA, SHARD_BITS = 3000, 97, 10

# port class → reference class (same names, same fields)
_JCLASSES = {"BinaryRank": jrs.BinaryRank, "BinarySelect": jrs.BinarySelect,
             "BitVector": jrs.BitVector, "WaveletMatrix": jwm.WaveletMatrix,
             "WaveletTree": jwt.WaveletTree, "FMIndex": jfm.FMIndex,
             "ShardedTextIndex": jsharded.ShardedTextIndex,
             "ShardedAnalytics": janalytics.ShardedAnalytics}


def _to_jax(x, view=None):
    """A port structure as the reference's, leaf for leaf (the reference's
    dtypes); fields the reference lacks (the engine's kernel operands) are
    left out."""
    from repro_torch.checkpoint.checkpoint import _REFERENCE_VIEWS, host_array
    if x is None or isinstance(x, (int, bool, str)):
        return x
    if isinstance(x, torch.Tensor):
        return jnp.asarray(host_array(x, view))
    cls = _JCLASSES[type(x).__name__]
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: _to_jax(getattr(x, f.name), _REFERENCE_VIEWS.get(
        (type(x), f.name))) for f in dataclasses.fields(x)
        if f.name in names})


def _flip(tree, *, seed: int, leaf_match=None):
    """The port's ``flip_leaf_bit`` on a port structure: the reference's
    leaf (paths and order are the reference's), byte and bit for one seed
    (``tests/test_torch_faults.py``). Returns (tree, leaf key)."""
    bad, where = faults.flip_leaf_bit(tree, seed=seed, leaf_match=leaf_match)
    return bad, where.split(": ")[0]


def _report(rep):
    return [(v.structure, v.kind, v.derived) for v in rep.violations]


@functools.lru_cache(maxsize=None)
def _engine():
    toks = np.random.default_rng(0).integers(0, SIGMA, N).astype(np.int64)
    return toks, build_sharded_analytics(toks, SIGMA, shard_bits=SHARD_BITS,
                                         device="cpu")


@functools.lru_cache(maxsize=None)
def _index():
    toks = np.random.default_rng(1).integers(0, 64, 1024).astype(np.int64)
    return toks, build_sharded_index(toks, 64, shard_bits=9, sample_rate=32,
                                     seam_overlap=7, device="cpu")


def _snap(eng, directory) -> Path:
    return save_analytics(eng, directory, extra_meta={"corpus_seed": 0})


# --------------------------------------------------------------------------
# interchange with the reference
# --------------------------------------------------------------------------

def test_checksums_equal_the_reference(tmp_path):
    _, eng = _engine()
    step_dir = _snap(eng, tmp_path)
    meta = json.loads((step_dir / "meta.json").read_text())
    crc = meta["leaf_crc32"]
    with np.load(step_dir / "arrays.npz") as z:
        stored = set(z.files)
    assert set(crc) == stored and stored
    assert all(len(v) == 8 for v in crc.values())
    jshards = _to_jax(eng.shards)
    assert crc == jrobust.tree_checksums(jshards) == tree_checksums(
        eng.shards)
    assert meta["dtypes"] == {".bitvectors/.rank/.words": "uint32",
                              ".bitvectors/.rank/.superblock": "uint32",
                              ".bitvectors/.rank/.block": "uint16",
                              ".bitvectors/.sel1/.sample": "int32",
                              ".bitvectors/.sel0/.sample": "int32",
                              ".zeros": "int32"}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_snapshot_interchange(writer, tmp_path):
    toks, eng = _engine()
    jeng = _to_jax(eng)
    if writer == "port":
        _snap(eng, tmp_path)
        back = janalytics.load_analytics(tmp_path)
        assert jrobust.tree_checksums(back.shards) == tree_checksums(
            eng.shards)
        assert (back.n, back.sigma, back.shard_bits) == (N, SIGMA,
                                                         SHARD_BITS)
    else:
        janalytics.save_analytics(jeng, tmp_path,
                                  extra_meta={"corpus_seed": 0})
        back = load_analytics(tmp_path, device="cpu")
        assert trees_identical(back.shards, eng.shards)
        assert tree_checksums(back.shards) == jrobust.tree_checksums(
            jeng.shards)
        lo, hi, k = [5, 900, 0], [64, 2600, N], [3, 100, 2999]
        assert torch.equal(back.range_quantile(lo, hi, k),
                           eng.range_quantile(lo, hi, k))
    assert snapshot_meta(tmp_path) == janalytics.snapshot_meta(tmp_path)


def test_snapshot_roundtrip_and_serving(tmp_path):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 64, 2500).astype(np.int64)
    eng = build_sharded_analytics(toks, 64, shard_bits=9, device="cpu")
    save_analytics(eng, tmp_path)
    eng2 = load_analytics(tmp_path, device="cpu")
    assert (eng2.n, eng2.sigma, eng2.shard_bits) == (2500, 64, 9)
    assert trees_identical(eng2.shards, eng.shards)
    assert eng2.quantile.words.data_ptr() == \
        eng2.shards.bitvectors.rank.words.data_ptr()
    lo = rng.integers(0, 2501, 64)
    hi = rng.integers(0, 2501, 64)
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    k = rng.integers(0, 2500, 64)
    for name in ("range_quantile", "range_distinct"):
        args = (lo, hi, k) if name == "range_quantile" else (lo, hi)
        assert torch.equal(getattr(eng2, name)(*args),
                           getattr(eng, name)(*args)), name
    got = eng2.range_quantile(lo, hi, k).numpy()
    for i in range(16):
        sl = np.sort(toks[lo[i]:hi[i]])
        assert got[i] == (sl[min(k[i], len(sl) - 1)] if len(sl) else -1)


def test_shards_struct_is_the_reference_target():
    want = janalytics.snapshot.shards_struct(5, 1000, 512, 128)
    got = shards_struct(5, 1000, 512, 128)
    jflat = {"/".join(jckpt.checkpoint._path_token(p) for p in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    from repro_torch.checkpoint.checkpoint import _walk
    tflat = {"/".join(p): (leaf, view) for p, leaf, view in _walk(got, (),
                                                                 None)}
    assert list(jflat) == list(tflat)
    for key, (leaf, view) in tflat.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == jflat[key].shape
        dt = view if view is not None else np.dtype(
            str(leaf.dtype).removeprefix("torch."))
        assert dt == jflat[key].dtype


# --------------------------------------------------------------------------
# integrity: detection, derived repair, primary escalation
# --------------------------------------------------------------------------

def test_checksum_tags_shape_and_dtype():
    a = np.arange(8, dtype=np.int32)
    assert checksum_array(a) != checksum_array(a.view(np.uint32))
    assert checksum_array(a) != checksum_array(a.reshape(2, 4))
    assert checksum_array(a) == checksum_array(a.copy())
    for x in (a, a.view(np.uint32), a.reshape(2, 4)):
        assert checksum_array(x) == jrobust.checksum_array(x)
    assert checksum_array(torch.from_numpy(a)) == checksum_array(a)


@pytest.mark.parametrize("seed", [5, 6])
def test_restore_detects_any_leaf_flip(seed, tmp_path):
    _, eng = _engine()
    _snap(eng, tmp_path)
    where = faults.corrupt_snapshot_leaf(tmp_path, seed=seed)
    with pytest.raises(IntegrityError) as exc:
        load_analytics(tmp_path, repair=False, device="cpu")
    assert where.split(":")[0] in exc.value.bad_keys


@pytest.mark.parametrize("frag", ["superblock", "block", "sel1", "sel0",
                                  "zeros"])
def test_derived_flip_repaired_bit_identical(frag, tmp_path):
    _, eng = _engine()
    _snap(eng, tmp_path)
    faults.corrupt_snapshot_leaf(tmp_path, seed=7, leaf_match=frag)
    healed = load_analytics(tmp_path, device="cpu")
    assert trees_identical(healed.shards, eng.shards)
    # the same file heals to the same leaves in the reference
    jhealed = janalytics.load_analytics(tmp_path)
    assert jrobust.tree_checksums(jhealed.shards) == tree_checksums(
        healed.shards)
    lo, hi = [5, 900], [64, 2600]
    assert torch.equal(healed.range_histogram(lo, hi),
                       eng.range_histogram(lo, hi))
    assert torch.equal(healed.range_quantile(lo, hi, [3, 100]),
                       eng.range_quantile(lo, hi, [3, 100]))


def test_primary_flip_escalates_to_rebuild(tmp_path):
    _, eng = _engine()
    _snap(eng, tmp_path)
    faults.corrupt_snapshot_leaf(tmp_path, seed=9, leaf_match="rank/words")
    with pytest.raises(IntegrityError, match="primary") as exc:
        load_analytics(tmp_path, device="cpu")
    assert exc.value.bad_keys == [".bitvectors/.rank/.words"]
    assert load_analytics(tmp_path, verify=False, device="cpu") is not None


def test_classify_bad_keys_matches_reference():
    keys = [".bitvectors/.rank/.words", ".bitvectors/.rank/.block",
            ".zeros", "seam_windows", ".shards/.mark/.words",
            ".shards/.wm/.bitvectors/.rank/.words"]
    assert classify_bad_keys(keys) == jrobust.classify_bad_keys(keys)
    for k in keys:
        assert is_primary_key(k) == jrobust.is_primary_key(k)


# --------------------------------------------------------------------------
# checkpoint layout: step discovery, dtypes
# --------------------------------------------------------------------------

def _state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(8, 4, generator=g),
                       "b": torch.ones(4, dtype=torch.bfloat16)},
            "opt": {"m": torch.zeros(8, 4), "step": torch.tensor(17)}}


def test_bfloat16_roundtrip_and_interchange(tmp_path):
    x = {"p": (torch.arange(100, dtype=torch.float32) / 7).to(
        torch.bfloat16)}
    d = save_checkpoint(tmp_path, 1, x)
    target = {"p": torch.empty(100, dtype=torch.bfloat16, device="meta")}
    y, meta = restore_checkpoint(tmp_path, target, device="cpu")
    assert y["p"].dtype == torch.bfloat16 and torch.equal(y["p"], x["p"])
    assert meta["dtypes"] == {"p": "bfloat16"}
    with np.load(d / "arrays.npz") as z:
        assert z["p"].dtype == np.dtype("V2")
    # the reference writes the same bytes and checksum, and reads ours
    jx = {"p": (jnp.arange(100, dtype=jnp.float32) / 7).astype(jnp.bfloat16)}
    jd = jckpt.save_checkpoint(tmp_path / "ref", 1, jx)
    jmeta = json.loads((jd / "meta.json").read_text())
    assert jmeta["leaf_crc32"] == meta["leaf_crc32"]
    jy, _ = jckpt.restore_checkpoint(tmp_path, jx)
    assert np.array_equal(np.asarray(jy["p"], np.float32),
                          x["p"].float().numpy())
    back, _ = restore_checkpoint(tmp_path / "ref", target, device="cpu")
    assert torch.equal(back["p"], x["p"])


def test_state_roundtrip_latest_and_prune(tmp_path):
    s = _state()
    for step in (10, 20, 30, 40):
        save_checkpoint(tmp_path, step, s, keep=2)
    assert latest_step(tmp_path) == 40
    assert checkpoint_steps(tmp_path) == [30, 40]
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]
    target = tree_like = {k: {kk: torch.empty_like(v, device="meta")
                              for kk, v in d.items()} for k, d in s.items()}
    got, meta = restore_checkpoint(tmp_path, tree_like, device="cpu")
    assert meta["step"] == 40 and target is tree_like
    for k in s:
        for kk in s[k]:
            assert got[k][kk].dtype == s[k][kk].dtype
            assert torch.equal(got[k][kk], s[k][kk])
    assert list(flatten(s)[0]) == ["opt/m", "opt/step", "params/b",
                                   "params/w"]
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(tmp_path, {"opt": {"m": torch.empty(3)},
                                      "params": {}}, device="cpu")


def test_latest_step_skips_truncated_npz(tmp_path):
    state = {"w": torch.arange(4096, dtype=torch.int32)}
    save_checkpoint(tmp_path, 0, state)
    save_checkpoint(tmp_path, 1, {"w": state["w"] + 1})
    faults.truncate_file(tmp_path, "arrays.npz", keep_frac=0.3)
    assert latest_step(tmp_path) == 0
    restored, meta = restore_checkpoint(tmp_path, state, device="cpu")
    assert meta["step"] == 0
    assert torch.equal(restored["w"], state["w"])


def test_latest_step_skips_half_deleted_dir(tmp_path):
    state = {"w": torch.ones(8, dtype=torch.int32)}
    save_checkpoint(tmp_path, 0, state)
    save_checkpoint(tmp_path, 1, state)
    faults.delete_file(tmp_path, "meta.json")
    assert latest_step(tmp_path) == 0
    assert not step_dir_valid(tmp_path / "step_00000001")


def test_latest_step_ignores_partial_tmp_and_junk(tmp_path):
    save_checkpoint(tmp_path, 3, {"w": torch.ones(8, dtype=torch.int32)})
    faults.inject_partial_tmp(tmp_path, step=99)
    (tmp_path / "step_junk").mkdir()
    assert latest_step(tmp_path) == 3


def test_no_valid_step_raises_filenotfound(tmp_path):
    _, eng = _engine()
    _snap(eng, tmp_path)
    faults.truncate_file(tmp_path, "arrays.npz")
    with pytest.raises(FileNotFoundError):
        load_analytics(tmp_path, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_analytics(tmp_path / "nope", device="cpu")


def test_step_dir_rejects_incomplete_leaf_crc32(tmp_path):
    _, eng = _engine()
    save_checkpoint(tmp_path, 1, eng.shards)
    save_checkpoint(tmp_path, 2, eng.shards, keep=3)
    step2 = tmp_path / "step_00000002"
    meta = json.loads((step2 / "meta.json").read_text())
    del meta["leaf_crc32"][sorted(meta["leaf_crc32"])[0]]
    (step2 / "meta.json").write_text(json.dumps(meta))
    assert not step_dir_valid(step2)
    assert step_dir_valid(step2, deep=False)
    assert checkpoint_steps(tmp_path) == [1] and latest_step(tmp_path) == 1
    meta.pop("leaf_crc32")
    (step2 / "meta.json").write_text(json.dumps(meta))
    assert step_dir_valid(step2)


def test_meta_geometry_and_foreign_checkpoint(tmp_path):
    _, eng = _engine()
    _snap(eng, tmp_path / "a")
    meta = snapshot_meta(tmp_path / "a")
    assert (meta["n"], meta["sigma"], meta["corpus_seed"]) == (N, SIGMA, 0)
    save_checkpoint(tmp_path / "b", 0, {"w": torch.zeros(3)},
                    extra_meta={"kind": "model"})
    with pytest.raises(ValueError):
        load_analytics(tmp_path / "b", device="cpu")


# --------------------------------------------------------------------------
# structural verification and in-memory repair
# --------------------------------------------------------------------------

def test_verify_and_repair_clean_engine():
    _, eng = _engine()
    assert verify_analytics(eng).ok
    fixed = repair_analytics(eng)
    assert trees_identical(fixed.shards, eng.shards)
    assert jrobust.tree_checksums(jrobust.repair_analytics(
        _to_jax(eng)).shards) == tree_checksums(fixed.shards)


@pytest.mark.parametrize("frag,seed", [("sel1", 11), ("superblock", 3),
                                       ("rank/block", 4), ("zeros", 17),
                                       ("rank/words", 13)])
def test_verify_localizes_like_the_reference(frag, seed):
    _, eng = _engine()
    shards, key = _flip(eng.shards, seed=seed, leaf_match=frag)
    bad = dataclasses.replace(eng, shards=shards, quantile=None)
    jbad, jkey = jfaults.flip_leaf_bit(_to_jax(eng), seed=seed,
                                       leaf_match=frag)
    assert jkey.startswith(".shards/" + key)
    report = verify_analytics(bad)
    assert _report(report) == _report(jrobust.verify_analytics(jbad))
    assert not report.ok
    healed = repair_analytics(bad)
    assert tree_checksums(healed.shards) == jrobust.tree_checksums(
        jrobust.repair_analytics(jbad).shards)
    if frag == "rank/words":
        # a repair on a corrupt bitmap cannot give back the original
        assert not report.repairable
        assert tree_checksums(healed.shards) != tree_checksums(eng.shards)
    else:
        assert report.repairable and verify_analytics(healed).ok
        assert trees_identical(healed.shards, eng.shards)
        assert torch.equal(healed.range_quantile([0, 7], [N, 2500], [5, 9]),
                           eng.range_quantile([0, 7], [N, 2500], [5, 9]))


def test_verify_single_wavelet_matrix():
    _, eng = _engine()
    wm = eng.shard(0)
    assert verify_wavelet_matrix(wm).ok
    bad, _ = _flip(wm, seed=17, leaf_match="zeros")
    report = verify_wavelet_matrix(bad)
    assert not report.ok and report.repairable
    jbad, _ = jfaults.flip_leaf_bit(_to_jax(wm), seed=17, leaf_match="zeros")
    assert _report(report) == _report(jrobust.verify_wavelet_matrix(jbad))


# --------------------------------------------------------------------------
# FM index and wavelet tree
# --------------------------------------------------------------------------

def test_index_verify_clean_and_decode():
    toks, idx = _index()
    assert verify_sharded_index(idx).ok
    syms = wm_decode(idx.shards.wm)
    from repro_torch.core.wavelet_matrix import wm_access
    assert torch.equal(syms, wm_access(idx.shards.wm, torch.arange(
        idx.shards.m).expand(2, -1)).long())


@pytest.mark.parametrize("frag", ["C", "mark", "sa_sample"])
def test_fm_index_verify_and_deep_repair(frag):
    _, idx = _index()
    shards, _ = _flip(idx.shards, seed=19, leaf_match=frag)
    bad = dataclasses.replace(idx, shards=shards)
    report = verify_sharded_index(bad)
    assert not report.ok and report.repairable
    jbad, _ = jfaults.flip_leaf_bit(_to_jax(idx), seed=19, leaf_match=frag)
    assert _report(report) == _report(jrobust.verify_sharded_index(jbad))
    healed = repair_sharded_index(bad, deep=True)
    assert trees_identical(healed.shards, idx.shards)
    assert trees_identical(healed, idx)


def test_fm_index_shallow_repair_skips_sa():
    _, idx = _index()
    fm = tree_map(lambda x: x[0], idx.shards)
    assert verify_fm_index(fm).ok
    bad, _ = _flip(fm, seed=23, leaf_match="C")
    healed = repair_fm_index(bad, deep=False)
    assert torch.equal(healed.C, fm.C)
    assert healed.mark is bad.mark and healed.sa_sample is bad.sa_sample
    assert trees_identical(repair_fm_index(bad, deep=True), fm)
    shallow = repair_sharded_index(idx, deep=False)
    assert trees_identical(shallow, idx)


_jrebuild = jax.jit(_rebuild_sa_directories, static_argnums=(2, 3))


@pytest.mark.parametrize("shard", [0, 1])
def test_deep_repair_equals_the_reference_lf_walk(shard):
    """The parallel suffix array (decode, LF by a stable argsort, pointer
    jumping) gives the directories of the reference's sequential walk."""
    _, idx = _index()
    fm = tree_map(lambda x: x[shard], idx.shards)
    jfm_ = _to_jax(fm)
    jmark, jsample = _jrebuild(jfm_.wm, jfm_.C, fm.m, fm.sample_rate)
    got = repair_fm_index(fm, deep=True)
    assert np.array_equal(np.asarray(jmark.words).view(np.int32),
                          got.mark.words.numpy())
    assert np.array_equal(np.asarray(jmark.superblock).view(np.int32),
                          got.mark.superblock.numpy())
    assert np.array_equal(np.asarray(jmark.block).view(np.int16),
                          got.mark.block.numpy())
    assert np.array_equal(np.asarray(jsample), got.sa_sample.numpy())


@pytest.mark.parametrize("n,sigma,seed", [(1, 3, 0), (700, 5, 1),
                                          (2049, 300, 2)])
def test_suffix_array_from_bwt(n, sigma, seed):
    seq = torch.from_numpy(np.random.default_rng(seed).integers(
        0, sigma, (2, n)))
    text = torch.cat([seq + 1, torch.zeros(2, 1, dtype=seq.dtype)], 1)
    sa = suffix_array(text, sigma + 1, device="cpu").long()
    bwt = torch.gather(text, 1, (sa - 1) % (n + 1))
    assert torch.equal(suffix_array_from_bwt(bwt).long(), sa)


def test_wavelet_tree_repair_and_verify():
    rng = np.random.default_rng(29)
    seq = rng.integers(0, 16, 800).astype(np.int32)
    wt = build_wavelet_tree(seq, 16, device="cpu")
    assert verify_wavelet_tree(wt).ok
    bad, _ = _flip(wt, seed=31, leaf_match="node_starts")
    healed = repair_wavelet_tree(bad)
    assert trees_identical(healed, wt)
    assert tree_checksums(healed) == jrobust.tree_checksums(
        jrobust.repair_wavelet_tree(_to_jax(bad)))
    assert _report(verify_wavelet_tree(bad)) == _report(
        jrobust.verify_wavelet_tree(_to_jax(bad)))


def test_node_starts_monotone_violation():
    seq = np.random.default_rng(37).integers(0, 16, 500).astype(np.int32)
    wt = build_wavelet_tree(seq, 16, device="cpu")
    ns = wt.node_starts.clone()
    a, b = int(ns[2, 0]), int(ns[2, 1])
    ns[2, 0], ns[2, 1] = b + 5, a
    bad = dataclasses.replace(wt, node_starts=ns)
    report = verify_wavelet_tree(bad)
    assert any(v.kind == "node_starts_monotone" for v in report.violations)
    assert _report(report) == _report(jrobust.verify_wavelet_tree(
        _to_jax(bad)))


def test_repaired_engine_takes_new_kernel_operands():
    """A repair makes its engine with ``quantile=None``: the operands read
    the repaired directories, not the corrupt ones."""
    _, eng = _engine()
    shards, _ = _flip(eng.shards, seed=3, leaf_match="superblock")
    bad = ShardedAnalytics(shards=shards, n=eng.n, sigma=eng.sigma,
                           shard_bits=eng.shard_bits)
    healed = repair_analytics(bad)
    assert healed.quantile.superblock.data_ptr() == \
        healed.shards.bitvectors.rank.superblock.data_ptr()
    assert healed.quantile.superblock.data_ptr() != \
        bad.quantile.superblock.data_ptr()
    lo, hi, k = [0, 100, 2000], [N, 1500, 2100], [1500, 7, 50]
    assert torch.equal(healed.range_quantile(lo, hi, k),
                       eng.range_quantile(lo, hi, k))
