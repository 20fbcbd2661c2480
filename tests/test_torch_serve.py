"""The port's model-serving CLI (``repro_torch.launch.serve``) against the
reference's ``repro.launch.serve``.

* ``--smoke --device cpu`` runs in process and prints the reference's
  lines; ``--device cuda`` without a card raises.
* A serve checkpoint written by the reference restores in the port with
  equal leaves and gives the reference's greedy tokens; one written by the
  port restores in the reference, with the port's tokens.
* A corrupted checkpoint falls back to fresh init; a device failure in the
  restore (``kernels.build.DEVICE_ERRORS``) propagates.
* The ``serve.model.*`` metric keys are the reference's.
* ``--temperature`` samples from the seeded generator: the same seed gives
  the same tokens.
"""
import functools
import json
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.checkpoint import save_checkpoint as ref_save
from repro.configs.base import get_config as ref_config
from repro.launch import serve as rserve
from repro.models.model import init_params as ref_init
from repro_torch import obs as tobs
from repro_torch.configs.base import get_config
from repro_torch.kernels.build import KernelError
from repro_torch.launch import serve as tserve
from repro_torch.models.model import build_model, tree_paths
from repro_torch.robust.faults import corrupt_snapshot_leaf

ARCH = "qwen2_0_5b"
SMOKE = ["--arch", ARCH, "--smoke"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small eager ops: the tier-1 run's
    workers share the cores, and torch's spinning OpenMP threads then slow
    every op about a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_registries():
    yield
    for o in (robs, tobs):
        o.configure(None)
        o.REGISTRY.reset()


def _port(argv, capsys) -> str:
    tserve.main(SMOKE + ["--device", "cpu"] + argv)
    return capsys.readouterr().out


def _reference(argv, capsys, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", ["serve"] + SMOKE + argv)
    rserve.main()
    return capsys.readouterr().out


def _sample(out: str) -> list:
    line = next(ln for ln in out.splitlines()
                if ln.startswith("sample token ids:"))
    return json.loads(line.split(":", 1)[1])


@functools.cache
def _reference_params():
    cfg = ref_config(ARCH, smoke=True)
    return jax.jit(functools.partial(ref_init, cfg, 0))()


def test_smoke_run_prints_the_reference_lines(capsys):
    out = _port([], capsys)
    lines = out.splitlines()
    assert lines[0] == "params: init"
    assert re.fullmatch(r"prefill: 4×64 tokens in [\d.]+ ms \(\d+ tok/s\)",
                        lines[1])
    assert re.fullmatch(r"decode: 4×32 tokens in [\d.]+ ms \(\d+ tok/s\)",
                        lines[2])
    sample = _sample(out)
    assert len(sample) == 16
    assert all(0 <= t < get_config(ARCH, smoke=True).vocab_size
               for t in sample)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(SMOKE + ["--device", "cuda"])


def test_reference_checkpoint_serves_in_the_port(tmp_path, capsys,
                                                 monkeypatch):
    params = _reference_params()
    ref_save(tmp_path, 0, params, extra_meta={"kind": "serve_params",
                                              "seed": 0})
    model = build_model(get_config(ARCH, smoke=True))
    got, origin = tserve.params_with_checkpoint(model, 0, str(tmp_path),
                                                torch.device("cpu"))
    assert origin == "restore (verified)"
    want = {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params)[0]}
    assert len(want) == len(list(tree_paths(got)))
    for path, leaf in tree_paths(got):
        assert leaf.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            leaf.view(torch.int16).numpy(), want[path].view(np.int16))
    ref_out = _reference(["--ckpt-dir", str(tmp_path)], capsys, monkeypatch)
    port_out = _port(["--ckpt-dir", str(tmp_path)], capsys)
    assert "params: restore (verified)" in ref_out
    assert "params: restore (verified)" in port_out
    assert _sample(port_out) == _sample(ref_out)


def test_port_checkpoint_serves_in_the_reference(tmp_path, capsys,
                                                 monkeypatch):
    first = _port(["--ckpt-dir", str(tmp_path)], capsys)
    assert first.splitlines()[0] == "params: init (checkpoint saved)"
    ref_out = _reference(["--ckpt-dir", str(tmp_path)], capsys, monkeypatch)
    assert ref_out.splitlines()[0] == "params: restore (verified)"
    assert _sample(ref_out) == _sample(first)


def test_corrupt_checkpoint_falls_back_to_fresh_init(tmp_path, capsys):
    _port(["--ckpt-dir", str(tmp_path)], capsys)
    corrupt_snapshot_leaf(tmp_path, seed=0, leaf_match="lm_head")
    out = _port(["--ckpt-dir", str(tmp_path)], capsys)
    assert "WARNING: checkpoint restore failed (IntegrityError" in out
    assert "params: init (restore failed)" in out


def test_device_error_in_restore_propagates(tmp_path, capsys, monkeypatch):
    _port(["--ckpt-dir", str(tmp_path)], capsys)

    def broken(*args, **kwargs):
        raise KernelError("the card failed")

    monkeypatch.setattr("repro_torch.checkpoint.restore_checkpoint", broken)
    with pytest.raises(KernelError, match="the card failed"):
        _port(["--ckpt-dir", str(tmp_path)], capsys)


def test_metric_keys_are_the_references(tmp_path, capsys, monkeypatch):
    _port(["--metrics-dir", str(tmp_path / "port")], capsys)
    _reference(["--metrics-dir", str(tmp_path / "ref")], capsys, monkeypatch)

    def keys(d):
        snap = json.loads((d / "snapshot.json").read_text())
        return {kind: sorted(k for k in snap[kind]
                             if k.startswith("serve.model."))
                for kind in ("counters", "gauges", "histograms")}

    port, ref = keys(tmp_path / "port"), keys(tmp_path / "ref")
    assert port == ref
    assert port["histograms"] == ["serve.model.decode.latency_s",
                                  "serve.model.prefill.latency_s"]


def test_sampling_is_seeded(capsys):
    runs = [_sample(_port(["--temperature", "1.0", "--seed", str(s)],
                          capsys)) for s in (3, 3, 4)]
    assert runs[0] == runs[1] != runs[2]
