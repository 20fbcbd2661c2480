"""The port's crash-safe ingest (``repro_torch.ingest``) on ``device="cpu"``,
held to the JAX reference (``repro.ingest``) on the fixtures of
``tests/test_ingest.py``.

The journal and the shard files interchange: for one token stream the
port's ``manifest.jsonl`` is the reference's byte for byte, its shard
files hold the same keys, dtypes and arrays, and either package recovers
and serves the other's directory. A crash after any protocol step
recovers to a state bit-identical to the port's from-scratch builds;
``verify_manifest`` reports what the reference's reports. The reference
builds through its XLA route (``default_use_kernels`` patched around its
ingest; nothing under ``src/repro`` changes); its directories are made
once per module.
"""
import json
import shutil
import threading

import numpy as np
import pytest
import torch

import repro.core.wavelet_matrix as jwm
import repro.ingest as jingest
import repro.robust as jrobust
from repro_torch.analytics import build_sharded_analytics
from repro_torch.core.wavelet_matrix import build_wavelet_matrix
from repro_torch.index import build_sharded_index
from repro_torch.ingest import (COMMIT_STEPS, QUARANTINE_STEP,
                                GenerationServer, IngestError,
                                JournalCorrupt, ShardIngester,
                                analytics_ingester, append_record,
                                index_ingester, load_manifest, read_journal,
                                record_crc)
from repro_torch.kernels.build import KernelError
from repro_torch.robust import (CrashInjected, crash_after, tree_checksums,
                                trees_identical, verify_manifest)
from repro_torch.tree import tree_map

SIGMA = 8
SHARD_BITS = 8                                 # 256-token shards: fast
N = 1500                                       # 5 full shards + tail
INDEX_KW = dict(sample_rate=16, seam_overlap=7)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(7).integers(0, SIGMA, N).astype(np.int64)


@pytest.fixture(scope="module")
def ref_analytics(tokens):
    return build_sharded_analytics(tokens, SIGMA, shard_bits=SHARD_BITS,
                                   device="cpu")


@pytest.fixture(scope="module")
def ref_index(tokens):
    return build_sharded_index(tokens, SIGMA, shard_bits=SHARD_BITS,
                               device="cpu", **INDEX_KW)


def _make(kind, d, **kw):
    if kind == "analytics":
        return analytics_ingester(d, SIGMA, shard_bits=SHARD_BITS,
                                  backoff_s=0.0, device="cpu", **kw)
    return index_ingester(d, SIGMA, shard_bits=SHARD_BITS, backoff_s=0.0,
                          device="cpu", **INDEX_KW, **kw)


def _jmake(kind, d):
    if kind == "analytics":
        return jingest.analytics_ingester(d, SIGMA, shard_bits=SHARD_BITS,
                                          backoff_s=0.0)
    return jingest.index_ingester(d, SIGMA, shard_bits=SHARD_BITS,
                                  backoff_s=0.0, **INDEX_KW)


def _reference(fn):
    """Run reference ingest code through its XLA build route."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwm, "default_use_kernels", lambda seq: False)
        return fn()


def _feed(ing, toks):
    ing.recover()
    ing.append_tokens(toks)
    ing.flush()
    return ing


def _index_identical(eng, ref):
    return (eng.n == ref.n
            and trees_identical(eng.shards, ref.shards)
            and torch.equal(eng.seam_windows, ref.seam_windows))


def _identical(kind, eng, ref):
    if kind == "index":
        return _index_identical(eng, ref)
    return eng.n == ref.n and trees_identical(eng.shards, ref.shards)


@pytest.fixture(scope="module")
def ref_dirs(tokens, tmp_path_factory):
    """{kind: directory the reference ingested the stream into}."""
    out = {}
    for kind in ("analytics", "index"):
        d = tmp_path_factory.mktemp(f"reference_{kind}")
        _reference(lambda: _feed(_jmake(kind, d), tokens))
        out[kind] = d
    return out


@pytest.fixture(scope="module")
def port_dirs(tokens, tmp_path_factory):
    """{kind: directory the port ingested the stream into}."""
    out = {}
    for kind in ("analytics", "index"):
        d = tmp_path_factory.mktemp(f"port_{kind}")
        _feed(_make(kind, d), tokens)
        out[kind] = d
    return out


def _report(rep):
    return [(v.structure, v.kind, v.derived) for v in rep.violations]


# ---------------------------------------------------------------------------
# journal: append-only, checksummed, torn-tail tolerant
# ---------------------------------------------------------------------------

def test_journal_roundtrip_and_crc(tmp_path):
    j, jj = tmp_path / "manifest.jsonl", tmp_path / "reference.jsonl"
    recs = [{"type": "INTENT", "gen": 0, "file": "shard_00000000.npz",
             "n_tokens": 10, "leaf_crc32": {"a": 1}},
            {"type": "COMMIT", "gen": 0}]
    for r in recs:
        assert append_record(j, r) == jingest.append_record(jj, r)
    back, torn = read_journal(j)
    assert not torn and len(back) == 2
    assert back[0]["file"] == "shard_00000000.npz"
    assert j.read_bytes() == jj.read_bytes()
    for line in j.read_text().splitlines():
        rec = json.loads(line)
        assert rec.pop("crc32") == record_crc(rec) == jingest.record_crc(rec)


def test_journal_rejects_bad_record_type(tmp_path):
    with pytest.raises(ValueError):
        append_record(tmp_path / "m.jsonl", {"type": "PUBLISH", "gen": 0})


def test_torn_tail_is_dropped_not_fatal(tmp_path):
    j = tmp_path / "manifest.jsonl"
    append_record(j, {"type": "INTENT", "gen": 0, "file": "f.npz",
                      "n_tokens": 4})
    append_record(j, {"type": "COMMIT", "gen": 0})
    j.write_bytes(j.read_bytes()[:-9])          # crash mid-append
    back, torn = read_journal(j)
    assert torn and len(back) == 1 and back[0]["type"] == "INTENT"
    st = load_manifest(tmp_path)
    assert st.torn_tail and [e.gen for e in st.pending] == [0]
    assert jingest.read_journal(j) == (back, torn)


def test_mid_journal_corruption_is_fatal(tmp_path):
    j = tmp_path / "manifest.jsonl"
    for g in range(3):
        append_record(j, {"type": "INTENT", "gen": g, "file": f"{g}.npz",
                          "n_tokens": 1})
    lines = j.read_text().splitlines()
    lines[1] = lines[1][:-5] + "x}"             # bit-rot before the tail
    j.write_text("\n".join(lines) + "\n")
    with pytest.raises(JournalCorrupt) as ei:
        read_journal(j, strict=True)
    assert ei.value.lineno == 2
    back, torn = read_journal(j, strict=False)
    assert torn and len(back) == 1             # scan stops at the bad line


# ---------------------------------------------------------------------------
# interchange with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["analytics", "index"])
def test_manifest_lines_equal_the_reference(kind, ref_dirs, port_dirs):
    got = (port_dirs[kind] / "manifest.jsonl").read_bytes()
    assert got == (ref_dirs[kind] / "manifest.jsonl").read_bytes()
    assert len(got.splitlines()) == 12         # INTENT + COMMIT, 6 gens


@pytest.mark.parametrize("kind", ["analytics", "index"])
def test_shard_files_equal_the_reference(kind, ref_dirs, port_dirs):
    from repro_torch.robust import checksum_flat
    files = sorted(p.name for p in (port_dirs[kind] / "shards").iterdir())
    assert files == sorted(
        p.name for p in (ref_dirs[kind] / "shards").iterdir())
    assert len(files) == 6
    for name in files:
        with np.load(port_dirs[kind] / "shards" / name) as z:
            got = {k: z[k] for k in z.files}
        with np.load(ref_dirs[kind] / "shards" / name) as z:
            want = {k: z[k] for k in z.files}
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
        assert checksum_flat(got) == jrobust.checksum_flat(want)


@pytest.mark.parametrize("kind", ["analytics", "index"])
def test_port_serves_a_reference_directory(kind, ref_dirs, tokens,
                                           ref_analytics, ref_index,
                                           tmp_path):
    d = tmp_path / "copy"
    shutil.copytree(ref_dirs[kind], d)
    ing = _make(kind, d)
    rep = ing.recover()
    assert rep.committed == list(range(6)) and rep.resume_offset == N
    eng = ing.engine()
    assert _identical(kind, eng, ref_analytics if kind == "analytics"
                      else ref_index)
    assert verify_manifest(d).ok


@pytest.mark.parametrize("kind", ["analytics", "index"])
def test_reference_serves_a_port_directory(kind, port_dirs, tokens,
                                           tmp_path):
    d = tmp_path / "copy"
    shutil.copytree(port_dirs[kind], d)
    jing = _jmake(kind, d)
    rep = jing.recover()
    assert rep.committed == list(range(6)) and rep.resume_offset == N
    jeng = _reference(jing.engine)
    eng = _make(kind, port_dirs[kind])
    eng.recover()
    eng = eng.engine()
    assert jrobust.tree_checksums(jeng.shards) == tree_checksums(eng.shards)
    if kind == "analytics":
        lo, hi, s0, s1 = 100, 1400, 2, 6
        truth = int(np.sum((tokens[lo:hi] >= s0) & (tokens[lo:hi] < s1)))
        assert int(jeng.range_count(lo, hi, s0, s1)) == truth
    else:
        assert np.array_equal(np.asarray(jeng.seam_windows),
                              eng.seam_windows.numpy())
        pat = tokens[40:43][None, :].astype(np.int32)
        assert int(jeng.count(pat, np.asarray([3], np.int32))[0]) == int(
            eng.count(pat, [3])[0])
    assert jrobust.verify_manifest(d).ok


# ---------------------------------------------------------------------------
# clean ingest ≡ from-scratch build (both kinds)
# ---------------------------------------------------------------------------

def test_analytics_ingest_bit_identical(tokens, ref_analytics, tmp_path):
    ing = _feed(_make("analytics", tmp_path), tokens)
    eng = ing.engine()
    assert eng.n == ref_analytics.n and eng.available is None
    assert trees_identical(eng.shards, ref_analytics.shards)
    lo, hi, s0, s1 = 100, 1400, 2, 6
    truth = int(np.sum((tokens[lo:hi] >= s0) & (tokens[lo:hi] < s1)))
    assert int(eng.range_count(lo, hi, s0, s1)) == truth
    assert torch.equal(eng.range_quantile([0, 300], [N, 1300], [7, 500]),
                       ref_analytics.range_quantile([0, 300], [N, 1300],
                                                    [7, 500]))


def test_index_ingest_bit_identical(tokens, ref_index, tmp_path):
    ing = _feed(_make("index", tmp_path), tokens)
    eng = ing.engine()
    assert _index_identical(eng, ref_index)
    pat = tokens[40:43][None, :].astype(np.int32)
    assert int(eng.count(pat, [3])[0]) == int(ref_index.count(pat, [3])[0])


def test_append_validates_token_range(tmp_path):
    ing = _make("analytics", tmp_path)
    ing.recover()
    with pytest.raises(ValueError):
        ing.append_tokens(np.asarray([0, SIGMA]))
    with pytest.raises(ValueError):
        ing.append_tokens(np.asarray([-1, 0]))  # must not wrap via uint cast
    ing.flush()
    with pytest.raises(IngestError):
        ing.append_tokens(np.asarray([1]))      # finalized


def test_ragged_batches_equal_one_batch(tokens, ref_analytics, tmp_path):
    """Batch edges that do not fall on shard edges change nothing."""
    ing = _make("analytics", tmp_path)
    ing.recover()
    edges = [0, 1, 200, 257, 700, 1024, 1499, N]
    for a, b in zip(edges[:-1], edges[1:]):
        ing.append_tokens(tokens[a:b])
    ing.flush()
    assert trees_identical(ing.engine().shards, ref_analytics.shards)


# ---------------------------------------------------------------------------
# the crash-point matrix: kill after every protocol step, recover, re-feed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["analytics", "index"])
@pytest.mark.parametrize("step", COMMIT_STEPS)
def test_crash_matrix(step, kind, tokens, ref_analytics, ref_index,
                      tmp_path):
    ing = _make(kind, tmp_path)
    ing.recover()
    with pytest.raises(CrashInjected):
        with crash_after(step):
            ing.append_tokens(tokens)
            ing.flush()
    # a new process: fresh ingester, journal replay, resume the stream
    ing2 = _make(kind, tmp_path)
    rep = ing2.recover()
    committed = step == "commit"               # the first shard's commit
    assert rep.resume_offset == (1 << SHARD_BITS if committed else 0)
    assert rep.aborted == ([0] if step in ("intent", "rename") else [])
    assert rep.committed == ([0] if committed else [])
    ing2.append_tokens(tokens[rep.resume_offset:])
    ing2.flush()
    eng = ing2.engine()
    assert eng.available is None               # nothing quarantined
    assert _identical(kind, eng, ref_analytics if kind == "analytics"
                      else ref_index)
    assert verify_manifest(tmp_path).ok


def test_crash_during_quarantine_append(tokens, tmp_path):
    """Crash right after the QUARANTINE record lands: the record is
    durable, so replay resumes past the poisoned shard, and a healthy
    re-feed of the same data serves under fresh generations."""
    boom = {"on": True}

    def build(s):
        if boom["on"]:
            raise RuntimeError("poisoned batch")
        return build_wavelet_matrix(s, SIGMA, sample_rate=512, device="cpu")

    ing = ShardIngester(tmp_path, build, SHARD_BITS, sigma=SIGMA,
                        kind="analytics", token_dtype=np.uint32,
                        retries=0, backoff_s=0.0, device="cpu")
    ing.recover()
    with pytest.raises(CrashInjected):
        with crash_after(QUARANTINE_STEP):
            ing.append_tokens(tokens)
    boom["on"] = False
    ing2 = _make("analytics", tmp_path)
    rep = ing2.recover()
    assert rep.quarantined == [0]
    assert rep.resume_offset == 1 << SHARD_BITS   # gen 0 consumed its data
    ing2.append_tokens(tokens)                    # full replay from 0
    ing2.flush()
    eng = ing2.engine()
    assert eng.available is not None and not bool(eng.available[0])
    assert int(eng.available.sum()) == eng.num_shards - 1


def test_recovery_is_idempotent(tokens, tmp_path):
    ing = _make("analytics", tmp_path)
    ing.recover()
    with pytest.raises(CrashInjected):
        with crash_after("intent"):
            ing.append_tokens(tokens)
    r1 = _make("analytics", tmp_path).recover()
    b = _make("analytics", tmp_path)
    r2 = b.recover()
    assert r1.aborted == [0] and r2.aborted == []
    assert r1.resume_offset == r2.resume_offset
    assert [e.gen for e in b.state.pending] == []
    n_lines = len((tmp_path / "manifest.jsonl").read_text().splitlines())
    _make("analytics", tmp_path).recover()
    assert len((tmp_path / "manifest.jsonl").read_text()
               .splitlines()) == n_lines


def test_corrupt_committed_shard_demoted_on_recovery(tokens, tmp_path):
    ing = _feed(_make("analytics", tmp_path), tokens)
    victim = ing.serve_entries()[1]
    path = tmp_path / "shards" / victim.file
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))
    ing2 = _make("analytics", tmp_path)
    rep = ing2.recover()
    assert rep.quarantined == [victim.gen]
    eng = ing2.engine()
    assert eng.available is not None and not bool(eng.available[1])
    assert rep.resume_offset == N      # the generation keeps its slot
    assert (tmp_path / "quarantine" / victim.file).exists()


# ---------------------------------------------------------------------------
# quarantine → honest partial coverage; device faults are not quarantined
# ---------------------------------------------------------------------------

def test_quarantined_shard_coverage_bounds(tokens, ref_analytics, tmp_path):
    calls = {"n": 0}

    def build(s):
        calls["n"] += 1
        if calls["n"] == 3:                    # the third shard fails
            raise RuntimeError("permanent")
        return build_wavelet_matrix(s, SIGMA, sample_rate=512, device="cpu")

    ing = ShardIngester(tmp_path, build, SHARD_BITS, sigma=SIGMA,
                        kind="analytics", token_dtype=np.uint32,
                        retries=0, backoff_s=0.0, device="cpu")
    _feed(ing, tokens)
    eng = ing.engine()
    assert eng.degraded and eng.n == N
    assert eng.available.tolist() == [True, True, False, True, True, True]
    lower, upper, cov = eng.range_count_bounds(0, N, 2, 6)
    truth = int(ref_analytics.range_count(0, N, 2, 6))
    assert int(lower) <= truth <= int(upper)
    assert 0.0 < float(cov) < 1.0
    assert verify_manifest(tmp_path).ok        # a journaled quarantine


@pytest.mark.parametrize("error", [KernelError, torch.AcceleratorError,
                                   torch.OutOfMemoryError])
def test_device_error_propagates_not_quarantined(error, tokens, tmp_path):
    """A kernel that fails to build or launch, a CUDA error, or the card's
    memory running out is no failure of the shard's data: it is retried,
    then raised, and the journal holds no QUARANTINE."""
    calls = {"n": 0}

    def build(s):
        calls["n"] += 1
        raise error("CUDA kernel wm_level_scan failed: an illegal memory "
                    "access was encountered (700)")

    ing = ShardIngester(tmp_path, build, SHARD_BITS, sigma=SIGMA,
                        kind="analytics", retries=2, backoff_s=0.0,
                        device="cpu")
    ing.recover()
    with pytest.raises(error):
        ing.append_tokens(tokens)
    assert calls["n"] == 3                      # with_retry's attempts
    records, _ = read_journal(tmp_path / "manifest.jsonl")
    assert records == [] and ing.state.entries == {}
    assert _make("analytics", tmp_path).recover().resume_offset == 0


# ---------------------------------------------------------------------------
# manifest self-checks (robust.verify.verify_manifest), held to the
# reference's reports
# ---------------------------------------------------------------------------

def _both_reports(d, **kw):
    rep = verify_manifest(d, **kw)
    assert _report(rep) == _report(jrobust.verify_manifest(d, **kw))
    return rep


def test_verify_manifest_commit_without_file_is_fatal(tokens, tmp_path):
    ing = _feed(_make("analytics", tmp_path), tokens)
    (tmp_path / "shards" / ing.serve_entries()[0].file).unlink()
    rep = _both_reports(tmp_path)
    assert not rep.ok and not rep.repairable
    assert any(v.kind == "commit_missing_shard" for v in rep.violations)


def test_verify_manifest_checksum_mismatch_repairable(tokens, tmp_path):
    ing = _feed(_make("analytics", tmp_path), tokens)
    path = tmp_path / "shards" / ing.serve_entries()[0].file
    arrays = dict(np.load(path))
    k = sorted(arrays)[0]
    arrays[k] = arrays[k].copy()
    arrays[k].flat[0] ^= 1
    np.savez(path, **arrays)
    rep = _both_reports(tmp_path)
    assert not rep.ok and rep.repairable
    assert any(v.kind == "commit_checksum_mismatch" for v in rep.violations)


def test_verify_manifest_dangling_intent_repairable(tokens, tmp_path):
    ing = _make("analytics", tmp_path)
    ing.recover()
    with pytest.raises(CrashInjected):
        with crash_after("rename"):
            ing.append_tokens(tokens)
    rep = _both_reports(tmp_path)
    assert not rep.ok and rep.repairable
    assert any(v.kind == "dangling_intent" for v in rep.violations)


def test_verify_manifest_nonmonotone_generation_fatal(tmp_path):
    j = tmp_path / "manifest.jsonl"
    append_record(j, {"type": "INTENT", "gen": 1, "file": "a.npz",
                      "n_tokens": 1})
    append_record(j, {"type": "INTENT", "gen": 0, "file": "b.npz",
                      "n_tokens": 1})
    rep = _both_reports(tmp_path, deep=False)
    assert any(v.kind == "generation_monotonicity" and not v.derived
               for v in rep.violations)


def test_verify_manifest_torn_and_corrupt_journal(tokens, tmp_path):
    _feed(_make("analytics", tmp_path), tokens[:600])
    j = tmp_path / "manifest.jsonl"
    whole = j.read_bytes()
    j.write_bytes(whole[:-7])
    rep = _both_reports(tmp_path)
    assert [v.kind for v in rep.violations] == ["journal_torn_tail",
                                                "dangling_intent"]
    lines = whole.decode().splitlines()
    lines[0] = lines[0][:-5] + "x}"
    j.write_text("\n".join(lines) + "\n")
    rep = _both_reports(tmp_path)
    assert rep.violations[0].kind == "journal_corrupt"
    assert not rep.repairable


# ---------------------------------------------------------------------------
# hot swap: add_shards + GenerationServer epoch fencing
# ---------------------------------------------------------------------------

def test_add_shards_matches_full_rebuild(tokens, ref_analytics, tmp_path):
    ing = _make("analytics", tmp_path)
    ing.recover()
    cut = 4 * (1 << SHARD_BITS)
    ing.append_tokens(tokens[:cut])
    eng0 = ing.engine()
    ing.append_tokens(tokens[cut:])
    ing.flush()
    new = ing.serve_entries()[4:]
    eng1 = eng0.add_shards(ing.stack(new), sum(e.n_tokens for e in new))
    assert eng1.n == N and eng1.available is None
    assert trees_identical(eng1.shards, ref_analytics.shards)
    assert torch.equal(eng1.range_quantile([0, 9], [N, 1200], [1000, 3]),
                       ref_analytics.range_quantile([0, 9], [N, 1200],
                                                    [1000, 3]))


def test_index_add_shards_matches_full_rebuild(tokens, ref_index, tmp_path):
    ing = _make("index", tmp_path)
    ing.recover()
    cut = 4 * (1 << SHARD_BITS)
    ing.append_tokens(tokens[:cut])
    eng0 = ing.engine()
    ing.append_tokens(tokens[cut:])
    ing.flush()
    entries = ing.serve_entries()
    new = entries[4:]
    seams = ing.seam_windows(entries)[3:]      # seam preceding each new one
    eng1 = eng0.add_shards(ing.stack(new), seams,
                           sum(e.n_tokens for e in new))
    assert _index_identical(eng1, ref_index)


def test_add_shards_rejects_partial_tail_and_bad_counts(tokens, tmp_path):
    eng = _feed(_make("analytics", tmp_path / "a"), tokens).engine()
    one = tree_map(lambda x: x[:1], eng.shards)
    with pytest.raises(ValueError):
        eng.add_shards(one, 10)                # n not shard-aligned
    full = _feed(_make("analytics", tmp_path / "full"),
                 tokens[:4 * (1 << SHARD_BITS)]).engine()
    with pytest.raises(ValueError):
        full.add_shards(one, 2 * (1 << SHARD_BITS))   # count ≠ K shards


def test_hot_swap_under_concurrent_queries(tokens, tmp_path):
    """No query batch ever observes a mixed-generation corpus: inside a
    pinned session the engine's answer must equal that generation's
    oracle, however many swaps land meanwhile."""
    ing = _make("analytics", tmp_path)
    ing.recover()
    shard = 1 << SHARD_BITS
    ing.append_tokens(tokens[:2 * shard])
    srv = GenerationServer(ing.engine())
    expected = {0: 2 * shard}
    stop = threading.Event()
    errors, batches = [], []

    def reader():
        while not stop.is_set():
            with srv.session() as (gen, eng):
                n = int(eng.range_count(0, eng.n, 0, SIGMA))
                q = eng.range_quantile([0], [eng.n], [eng.n - 1])
                batches.append(gen)
                if n != expected[gen] or int(q[0]) != int(
                        np.max(tokens[:expected[gen]])):
                    errors.append((gen, n, expected[gen]))

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for k in (3, 4, 5):                    # three live swaps
            ing.append_tokens(tokens[(k - 1) * shard:k * shard])
            new = ing.serve_entries()[k - 1:]
            eng1 = srv.engine.add_shards(ing.stack(new), shard)
            expected[srv.generation + 1] = k * shard
            srv.swap_generation(eng1, wait_drain=True, timeout_s=30)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert srv.generation == 3 and batches


def test_swap_fence_waits_for_drain(tmp_path, tokens):
    ing = _feed(_make("analytics", tmp_path), tokens)
    srv = GenerationServer(ing.engine())
    entered = threading.Event()
    release = threading.Event()
    order = []

    def holder():
        with srv.session():
            entered.set()
            release.wait(5)
            order.append("session_exit")

    t = threading.Thread(target=holder)
    t.start()
    entered.wait(5)
    with pytest.raises(TimeoutError):
        srv.swap_generation(ing.engine(), wait_drain=True, timeout_s=0.05)
    assert srv.generation == 1                 # the swap itself landed

    def swapper():
        srv.swap_generation(ing.engine(), wait_drain=True, timeout_s=10)
        order.append("swap_done")

    t2 = threading.Thread(target=swapper)
    t2.start()
    release.set()
    t.join(5)
    t2.join(5)
    assert not t.is_alive() and not t2.is_alive()
    assert order == ["session_exit", "swap_done"]
