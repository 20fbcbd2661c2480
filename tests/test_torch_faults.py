"""The port's chaos harness (``repro_torch.robust.faults``) against the
reference's (``repro.robust.faults``) on ``device="cpu"``.

For one seed each fault does what the reference's does: a snapshot fault
leaves the same stored leaves, bytes and files, a leaf flip on a live
structure picks the same leaf, byte and bit (the port's structure carried
into the reference's classes leaf for leaf, no reference build), and the
crash points and shard-latency arming behave alike.
"""
import dataclasses
import functools
import shutil

import numpy as np
import pytest
import torch

import repro.analytics as janalytics
import repro.core.rank_select as jrs
import repro.core.wavelet_matrix as jwm
import repro.robust as jrobust
from repro.robust import faults as jfaults
from repro_torch.analytics import build_sharded_analytics, save_analytics
from repro_torch.checkpoint import flatten
from repro_torch.robust import faults
from repro_torch.robust import tree_checksums

N, SIGMA, SHARD_BITS = 3000, 97, 10

_JCLASSES = {"BinaryRank": jrs.BinaryRank, "BinarySelect": jrs.BinarySelect,
             "BitVector": jrs.BitVector, "WaveletMatrix": jwm.WaveletMatrix,
             "ShardedAnalytics": janalytics.ShardedAnalytics}


def _to_jax(x, view=None):
    """A port structure as the reference's, leaf for leaf (the reference's
    dtypes); fields the reference lacks (the engine's kernel operands) are
    left out."""
    import jax.numpy as jnp

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


@functools.lru_cache(maxsize=None)
def _engine():
    toks = np.random.default_rng(0).integers(0, SIGMA, N).astype(np.int64)
    return build_sharded_analytics(toks, SIGMA, shard_bits=SHARD_BITS,
                                   device="cpu")


def _two_snapshots(tmp_path):
    """The same port snapshot in two directories: (port's, reference's)."""
    save_analytics(_engine(), tmp_path / "port", extra_meta={"seed": 0})
    shutil.copytree(tmp_path / "port", tmp_path / "reference")
    return tmp_path / "port", tmp_path / "reference"


def _stored(d):
    step = sorted(p for p in d.iterdir() if p.name.startswith("step_"))[-1]
    with np.load(step / "arrays.npz") as z:
        return {k: (z[k].dtype, z[k].tobytes()) for k in z.files}


def _files(d):
    return {str(p.relative_to(d)): p.read_bytes() if p.is_file() else None
            for p in sorted(d.rglob("*"))}


@pytest.mark.parametrize("seed,leaf_match", [(5, None), (6, None),
                                             (7, "superblock"),
                                             (9, "rank/words"),
                                             (3, "sel0")])
def test_corrupt_snapshot_leaf_equals_the_reference(seed, leaf_match,
                                                    tmp_path):
    port, ref = _two_snapshots(tmp_path)
    got = faults.corrupt_snapshot_leaf(port, seed=seed,
                                       leaf_match=leaf_match)
    want = jfaults.corrupt_snapshot_leaf(ref, seed=seed,
                                         leaf_match=leaf_match)
    assert got == want
    assert _stored(port) == _stored(ref)


def test_corrupt_snapshot_leaf_rejects_unknown_leaf(tmp_path):
    port, _ = _two_snapshots(tmp_path)
    with pytest.raises(ValueError):
        faults.corrupt_snapshot_leaf(port, seed=0, leaf_match="nope")


@pytest.mark.parametrize("name,keep", [("arrays.npz", 0.5),
                                       ("arrays.npz", 0.3),
                                       ("meta.json", 0.9)])
def test_truncate_file_equals_the_reference(name, keep, tmp_path):
    port, ref = _two_snapshots(tmp_path)
    faults.truncate_file(port, name, keep_frac=keep)
    jfaults.truncate_file(ref, name, keep_frac=keep)
    assert _files(port) == _files(ref)


@pytest.mark.parametrize("fault", ["delete_file", "delete_step",
                                   "inject_partial_tmp"])
def test_file_faults_equal_the_reference(fault, tmp_path):
    port, ref = _two_snapshots(tmp_path)
    got = getattr(faults, fault)(port)
    want = getattr(jfaults, fault)(ref)
    assert got.relative_to(port) == want.relative_to(ref)
    assert _files(port) == _files(ref)


@pytest.mark.parametrize("seed,leaf_match", [(11, "sel1"), (3, "superblock"),
                                             (4, "rank/block"),
                                             (17, "zeros"), (13, None)])
def test_flip_leaf_bit_equals_the_reference(seed, leaf_match):
    eng = _engine()
    bad, where = faults.flip_leaf_bit(eng, seed=seed, leaf_match=leaf_match)
    jbad, jwhere = jfaults.flip_leaf_bit(_to_jax(eng), seed=seed,
                                         leaf_match=leaf_match)
    assert where == jwhere
    assert tree_checksums(bad.shards) == jrobust.tree_checksums(jbad.shards)
    assert tree_checksums(bad.shards) != tree_checksums(eng.shards)
    # the engine's kernel operands are taken from the corrupted directories
    assert bad.quantile.words.data_ptr() == \
        bad.shards.bitvectors.rank.words.data_ptr()
    assert faults.leaf_keys(eng) == jfaults.leaf_keys(_to_jax(eng))


def test_flip_leaf_bit_on_a_dict_of_bfloat16():
    state = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)
             .to(torch.bfloat16), "step": torch.tensor([7], dtype=torch.int32)}
    bad, where = faults.flip_leaf_bit(state, seed=2, leaf_match="w")
    assert where.startswith("w: ") and bad["w"].dtype == torch.bfloat16
    diff = flatten(bad)[0]["w"].view(np.uint8) ^ flatten(state)[0]["w"].view(
        np.uint8)
    assert int(np.unpackbits(diff).sum()) == 1
    assert torch.equal(bad["step"], state["step"])
    with pytest.raises(ValueError):
        faults.flip_leaf_bit(state, seed=0, leaf_match="missing")


def test_crash_points_arm_one_step_once():
    faults.check_crash_point("intent")          # nothing armed: no-op
    with faults.crash_after("intent"):
        faults.check_crash_point("write_tmp")
        with pytest.raises(faults.CrashInjected) as ei:
            faults.check_crash_point("intent")
        assert ei.value.step == "intent"
        faults.check_crash_point("intent")      # disarmed after firing
    assert not isinstance(ei.value, Exception)  # survives `except Exception`
    with faults.crash_after(None):
        faults.check_crash_point("intent")


def test_shard_latency_arming_composes_and_restores():
    assert faults.shard_latency(2) == 0.0
    with faults.inject_shard_latency(2, 9.0):
        with faults.inject_shard_latency(5, 1.5):
            assert (faults.shard_latency(2), faults.shard_latency(5)) == (
                9.0, 1.5)
            with faults.inject_shard_latency(2, 0.5):
                assert faults.shard_latency(2) == 0.5
            assert faults.shard_latency(2) == 9.0
        assert faults.shard_latency(5) == 0.0
    assert faults.shard_latency(2) == 0.0
