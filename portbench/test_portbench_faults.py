"""``correct`` comes out false where it should: each cell's control (the
reference with one guarantee broken, or the program's own approximate
path), and a whole run of each cell, past the look for a card, with the
timed path broken underneath in each way the cell can break. (The cells
run on one chip: no exchange between chips to leave out.)"""
import dataclasses

import pytest
import torch

from portbench import corpus
from portbench.conftest import ROOT, SMALL, SMALL_QUERIES
from portbench.systems import analytics_store, fm_index

CPU = torch.device("cpu")


def config(name: str) -> dict:
    from portbench import harness
    bench = harness.load_benchmark(ROOT)
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return {**harness.load_config(ROOT, entry), **SMALL}


# ---- the controls -----------------------------------------------------------

def test_store_control_fails():
    cfg = config("lmcorpus")
    toks = corpus.make_tokens(cfg, 2**31 + 21, CPU)
    result = analytics_store.build(cfg, toks, CPU)
    assert max(analytics_store.control_build(cfg, toks, result,
                                             CPU).values()) > 0


def test_index_control_fails():
    cfg = config("ngram_index")
    toks = corpus.make_tokens(cfg, 2**31 + 22, CPU).numpy()
    result = fm_index.build(cfg, toks, CPU)
    assert max(fm_index.control_build(cfg, toks, result, CPU).values()) > 0


def test_quantile_control_fails():
    from portbench import harness
    cfg = config("lmcorpus")
    traffic = {**harness.load_traffic("quantile"), **SMALL_QUERIES}
    toks = corpus.make_tokens(cfg, 2**31 + 23, CPU)
    engine = analytics_store.serve(cfg, toks, CPU)
    op = harness.load_op("range_quantile")
    pool = op.batches(cfg, traffic, 2**31 + 23)
    answers = [op.control(engine, *(torch.as_tensor(x) for x in b)).numpy()
               for b in pool]
    assert op.check(cfg, toks, pool, answers)["wrong_answers"] > 0


# ---- the program broken under a whole run -----------------------------------

def _identity_partition(words, total_zeros, n):
    """A level step that leaves the order as it was."""
    return torch.arange(n).expand(words.shape[:-1] + (n,))


def _half_rows(build):
    """A build of the first half of the rows, the rest copied from it."""
    def half(seq, *args, **kw):
        rows = seq.shape[0] // 2
        out = build(seq[:rows], *args, **kw)
        return _tile(out, seq.shape[0] - rows)
    return half


def _tile(obj, extra: int):
    def cat(x):
        return torch.cat([x, x[:extra]]) if x.dim() else x
    if isinstance(obj, torch.Tensor):
        return cat(obj)
    changes = {f.name: _tile(getattr(obj, f.name), extra)
               for f in dataclasses.fields(obj)
               if isinstance(getattr(obj, f.name), torch.Tensor)
               or dataclasses.is_dataclass(getattr(obj, f.name))}
    return dataclasses.replace(obj, **changes)


def _flip_word(build):
    """One bit of one stored word flipped where the build makes it."""
    def flipped(*args, **kw):
        out = build(*args, **kw)
        wm = out.wm if hasattr(out, "wm") else out
        wm.bitvectors.rank.words.view(-1)[5] ^= 1 << 3
        return out
    return flipped


def _rounds_unchanged(rank, offset, key_bits, *args, **kw):
    """A doubling round that returns its ranks as they came."""
    n = rank.shape[-1]
    return torch.arange(n, dtype=torch.int32).expand(rank.shape), rank


STORE_FAULTS = {
    "level step leaves its state unchanged": (
        "repro_torch.core.wavelet_matrix.stable_partition_gather",
        lambda orig: _identity_partition),
    "half of the shards built, the rest copied": (
        "repro_torch.data.compressed_store.build_wavelet_matrix",
        _half_rows),
    "a stored bit altered where it is built": (
        "repro_torch.data.compressed_store.build_wavelet_matrix",
        _flip_word),
}
INDEX_FAULTS = {
    "doubling round leaves its ranks unchanged": (
        "repro_torch.index.suffix_array.doubling_round",
        lambda orig: _rounds_unchanged),
    "half of the shards indexed, the rest copied": (
        "repro_torch.index.sharded.build_fm_index", _half_rows),
    "a stored bit altered where it is built": (
        "repro_torch.index.sharded.build_fm_index", _flip_word),
}


def _stale(orig):
    """Every batch answered with the first batch's answers."""
    first = {}

    def stale(self, lo, hi, k):
        if "a" not in first:
            first["a"] = orig(self, lo, hi, k)
        return first["a"].clone()
    return stale


def _half_batch(orig):
    """The batch's first half answered, the rest left out."""
    def half(self, lo, hi, k):
        q = lo.shape[0] // 2
        out = torch.full_like(lo, -1)
        out[:q] = orig(self, lo[:q], hi[:q], k[:q])
        return out
    return half


def _altered(orig):
    """One answer altered where it is produced."""
    def altered(self, lo, hi, k):
        out = orig(self, lo, hi, k).clone()
        out[3] += 1
        return out
    return altered


QUERY_FAULTS = {"state unchanged between batches": _stale,
                "half of the batch left out": _half_batch,
                "an answer altered": _altered}


def _patch(monkeypatch, target: str, wrap):
    module, name = target.rsplit(".", 1)
    mod = __import__(module, fromlist=[name])
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))


@pytest.mark.parametrize("fault", sorted(STORE_FAULTS))
def test_a_broken_store_build_is_not_correct(monkeypatch, small_run, fault):
    _patch(monkeypatch, *STORE_FAULTS[fault])
    assert small_run("lmcorpus.build")["result"]["correct"] is False


@pytest.mark.parametrize("fault", sorted(INDEX_FAULTS))
def test_a_broken_index_build_is_not_correct(monkeypatch, small_run, fault):
    _patch(monkeypatch, *INDEX_FAULTS[fault])
    assert small_run("ngram_index.build")["result"]["correct"] is False


@pytest.mark.parametrize("fault", sorted(QUERY_FAULTS))
def test_a_broken_quantile_is_not_correct(monkeypatch, small_run, fault):
    from repro_torch.analytics.engine import ShardedAnalytics
    monkeypatch.setattr(ShardedAnalytics, "range_quantile",
                        QUERY_FAULTS[fault](ShardedAnalytics.range_quantile))
    assert small_run("lmcorpus.quantile")["result"]["correct"] is False


@pytest.mark.parametrize("cell", ["lmcorpus.build", "ngram_index.build",
                                  "lmcorpus.quantile"])
def test_the_sound_program_is_correct(small_run, cell):
    assert small_run(cell, seed=2**31 + 99)["result"]["correct"] is True
