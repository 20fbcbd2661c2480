"""The plain reference against the port's CPU route at small sizes: the
wavelet matrices and their directories, the FM index and the range quantiles, leaf for leaf."""
import numpy as np
import pytest
import torch

from portbench import corpus, harness
from portbench.conftest import ROOT, SMALL
from portbench.reference import suffix, wavelet
from portbench.systems import analytics_store, fm_index

CPU = torch.device("cpu")


def small_config(name: str, **over) -> dict:
    bench = harness.load_benchmark(ROOT)
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return {**harness.load_config(ROOT, entry), **SMALL, **over}


@pytest.mark.parametrize("seed,n", [(1, 1 << 14), (2**31 + 5, (1 << 14) - 77),
                                    (7, 3000)])
def test_store_equals_the_reference(seed, n):
    cfg = small_config("lmcorpus", n_tokens=n)
    toks = corpus.make_tokens(cfg, seed, CPU)
    result = analytics_store.build(cfg, toks, CPU)
    assert all(v == 0 for v in analytics_store.check_build(
        cfg, toks, result, CPU).values())


@pytest.mark.parametrize("seed,n", [(3, 1 << 14), (2**31 + 9, (1 << 14) - 5)])
def test_index_equals_the_reference(seed, n):
    cfg = small_config("ngram_index", n_tokens=n)
    toks = corpus.make_tokens(cfg, seed, CPU).numpy()
    result = fm_index.build(cfg, toks, CPU)
    assert all(v == 0 for v in fm_index.check_build(
        cfg, toks, result, CPU).values())


@pytest.mark.parametrize("seed", [4, 2**31 + 17])
def test_quantiles_equal_the_engine(seed):
    cfg = small_config("lmcorpus")
    toks = corpus.make_tokens(cfg, seed, CPU)
    engine = analytics_store.serve(cfg, toks, CPU)
    batch = corpus.make_queries(cfg["n_tokens"], 300, seed)
    got = harness.load_op("range_quantile").call(
        engine, *(torch.as_tensor(x) for x in batch))
    want = wavelet.quantiles(toks, cfg["vocab_size"],
                             [tuple(torch.as_tensor(x) for x in batch)])[0]
    assert torch.equal(got, want)
    t = toks.numpy()            # and by brute force over the raw tokens
    for i, (lo, hi, k) in enumerate(zip(*batch)):
        assert int(np.sort(t[lo:hi])[k]) == int(want[i])


def test_suffix_arrays_by_brute_force():
    g = torch.Generator().manual_seed(0)
    rows = torch.randint(0, 4, (3, 200), generator=g)
    text = suffix.terminated(rows)
    sa, rounds = suffix.suffix_arrays(text)
    for r in range(3):
        t = text[r].tolist()
        assert sa[r].tolist() == sorted(range(len(t)), key=lambda i: t[i:])
    assert rounds >= 2


def test_the_control_sort_stops_one_round_short():
    """The index control's suffix sort: a round short of what each seed's
    shards need leaves ties in text order, so the order is wrong."""
    cfg = small_config("ngram_index")
    for seed in (1, 2, 3):
        toks = corpus.make_tokens(cfg, seed, CPU)
        text = suffix.terminated(toks.view(-1, 1 << cfg["shard_bits"]))
        sa, rounds = suffix.suffix_arrays(text)
        short, _ = suffix.suffix_arrays(text, rounds - 1)
        assert rounds >= 2 and not torch.equal(short, sa)


def test_tokens_follow_the_seed():
    cfg = small_config("lmcorpus")
    a = corpus.make_tokens(cfg, 2**31 + 1, CPU)
    b = corpus.make_tokens(cfg, 2**31 + 1, CPU)
    c = corpus.make_tokens(cfg, 2**31 + 2, CPU)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.int32 and int(a.max()) < cfg["vocab_size"]
    assert (a[cfg["doc_len"] - 1::cfg["doc_len"]] == cfg["eos_id"]).all()


def test_queries_are_the_reference_mix():
    lo, hi, k = corpus.make_queries(1 << 20, 4096, 2**31 + 3)
    width = hi - lo
    assert (width >= 1).all() and (k < width).all() and (k >= 0).all()
    narrow = (width < 256).mean()
    assert 0.45 < narrow < 0.55
    assert width.max() < (1 << 20) // 4
