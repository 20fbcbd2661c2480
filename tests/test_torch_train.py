"""The port's training half (``Model.loss_fn`` under autograd,
``repro_torch.train``, ``launch.train``, ``examples/torch_train_lm.py``)
against the reference's.

Tolerances, each stated where it is used:

* loss of one architecture of each family (qwen2 dense, dbrx moe, mamba2
  ssm, jamba hybrid, whisper encdec, llama-3.2-vision vlm) at its smoke
  config, on the same params and tokens, against
  ``jax.value_and_grad(model.loss_fn)``: within ``rtol=atol=0.05``;
  the grads bf16, each leaf within a relative Frobenius error of 0.05
  (0.2 for the vlm's per-block scalar gates, ``gate_attn`` and
  ``gate_mlp``: each is one reduction over all B·S·D products with much
  cancellation, and the reference's own two compilations, with and
  without XLA's excess precision, differ by up to 0.17 on them), the
  global grad norm within 5%;
* one ``make_train_step`` from a state the reference (jitted as its
  ``Trainer`` jits it) carried two steps and then handed over: loss within ``rtol=atol=0.05``, ``grad_norm``
  within 5%, ``m`` and ``v`` within a relative Frobenius error of 0.05,
  the params within ``2·lr`` plus 2 bf16 ulp (a first-order Adam step
  moves a param by at most about lr, so a grad whose sign differs moves
  it by at most 2·lr more);
* the reference's six ``tests/test_train.py`` cases on the port, with
  their own bounds; ``tests/test_sharding_policies.py:20``'s padding case;
  the SSM's bf16 prefix sum equal to ``jnp.cumsum``'s bit for bit;
* a checkpoint of either package's ``Trainer`` resumes in the other's
  with every leaf equal bit for bit, the same keys, dtypes and crc32s;
* the CLI and the example in process.

The reference's loss is jitted once per architecture (module-level
caches) with XLA's excess precision off, as the models' tests compile it,
and at LLVM optimization level 0 (the same bits, checked for jamba and
llama-3.2-vision, in about 80% of the compile time). Params, and the
reference trainers' initial states, come from the port's CPU init carried
to the reference (the reference's own init runs eagerly, op by op).
"""
import dataclasses
import functools
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as rckpt
from repro.configs import base as rbase
from repro.data import pipeline as rpipe
from repro.models import model as rmodel
from repro.optim import adamw as radamw
from repro.train import trainer as rtrain
from repro_torch.configs import base as tbase
from repro_torch.convert import (params_to_reference,
                                 train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.data import TokenBatcher, make_corpus
from repro_torch.launch import train as ttrain_cli
from repro_torch.models import model as tmodel
from repro_torch.optim.adamw import global_norm
from repro_torch.train import (Trainer, init_train_state, make_train_step,
                               value_and_grad)

ROOT = Path(__file__).resolve().parents[1]
COMPILE = {"xla_allow_excess_precision": False,
           "xla_backend_optimization_level": 0}
LOSS_TOL = dict(rtol=0.05, atol=0.05)
GRAD_TOL = 0.05
GATE_TOL = 0.2
B, S = 2, 32
FAMILY_ARCHS = ("qwen2_0_5b", "dbrx_132b", "mamba2_370m", "jamba_v0_1_52b",
                "whisper_medium", "llama_3_2_vision_90b")
ARCH = "qwen2_0_5b"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_tree(tree):
    """A nested dict of host arrays (bf16 as ``V2`` views) as jnp arrays."""
    if isinstance(tree, dict):
        return {k: _ref_tree(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.kind == "V":
        a = a.view(ml_dtypes.bfloat16)
    return jnp.asarray(a)


def _by_path(tree) -> dict:
    """{path: float32 numpy} of a nested dict of arrays or tensors."""
    def host(a):
        if isinstance(a, torch.Tensor):
            return a.detach().float().numpy()
        return np.asarray(a, np.float32)
    return {p: host(a) for p, a in tmodel.tree_paths(tree)}


def _rel_frobenius(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm((got - want).ravel())
                 / max(np.linalg.norm(want.ravel()), 1e-30))


# --------------------------------------------------------------------------
# loss and grads of one architecture of each family
# --------------------------------------------------------------------------

@functools.cache
def _reference_value_and_grad(arch: str):
    model = rmodel.build_model(rbase.get_config(arch, smoke=True))
    return jax.jit(jax.value_and_grad(
        lambda p, t, e: model.loss_fn(p, t, e)), compiler_options=COMPILE)


@functools.cache
def _losses_and_grads(arch: str):
    cfg = tbase.get_config(arch, smoke=True)
    model = tmodel.build_model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    extras = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in model.extras_shapes(B).items()}
    r_loss, r_grads = _reference_value_and_grad(arch)(
        _ref_tree(params_to_reference(params)), jnp.asarray(toks),
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in extras.items()} or None)
    t_loss, t_grads = value_and_grad(
        lambda p, t, e: model.loss_fn(p, t, e), params,
        torch.from_numpy(toks).long(),
        {k: torch.from_numpy(v).to(torch.bfloat16)
         for k, v in extras.items()} or None)
    return float(r_loss), r_grads, float(t_loss), t_grads


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_matches_reference(arch):
    r_loss, _, t_loss, _ = _losses_and_grads(arch)
    assert np.isfinite(t_loss)
    np.testing.assert_allclose(t_loss, r_loss, **LOSS_TOL)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_grads_match_reference(arch):
    _, r_grads, _, t_grads = _losses_and_grads(arch)
    want = _by_path(r_grads)
    got = _by_path(t_grads)
    assert set(got) == set(want)
    for path, leaf in tmodel.tree_paths(t_grads):
        assert leaf.dtype == torch.bfloat16, path
        tol = GATE_TOL if path[-1] in ("gate_attn", "gate_mlp") else GRAD_TOL
        err = _rel_frobenius(got[path], want[path])
        assert err <= tol, (path, err)
    r_norm = np.sqrt(sum(float(np.square(a, dtype=np.float64).sum())
                         for a in want.values()))
    np.testing.assert_allclose(float(global_norm(t_grads)), r_norm,
                               rtol=0.05)


_REF_CUMSUM = jax.jit(lambda a: jnp.cumsum(a, axis=1),
                      compiler_options=COMPILE)


@pytest.mark.parametrize("n", [1, 16, 17, 40, 300, 5000])
def test_ssm_cumsum_matches_the_reference_bit_for_bit(n):
    """The SSM's bf16 prefix sum is ``jnp.cumsum``'s on the CPU, which XLA
    sums in blocks of 16 past 16 elements: equal bit for bit, on the
    summed axis in the middle as the SSM calls it."""
    from repro_torch.models.ssm import cumsum
    x = (np.random.default_rng(n).standard_normal((3, n, 2)) * -0.3
         ).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    want = _REF_CUMSUM(jnp.asarray(t.float().numpy(), jnp.bfloat16))
    got = cumsum(t, 1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_padding_never_predicted_and_loss_finite():
    """``tests/test_sharding_policies.py:20`` on the port: pad logits are
    masked, the loss finite, the pad columns' lm_head grads 0."""
    cfg = tbase.ModelConfig(name="padtest", family="dense", num_layers=2,
                            d_model=32, num_heads=2, num_kv_heads=1,
                            d_ff=64, vocab_size=250)
    assert cfg.padded_vocab == 256
    model = tmodel.build_model(cfg)
    params = model.init(0, device="cpu")
    assert tuple(params["lm_head"].shape) == (32, 256)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 250, (2, 17))).long()
    loss, grads = value_and_grad(model.loss_fn, params, tokens, None)
    assert np.isfinite(float(loss))
    pad_grad = grads["lm_head"][:, 250:].float().abs()
    real_grad = grads["lm_head"][:, :250].float().abs()
    assert float(pad_grad.max()) < 1e-6
    assert float(real_grad.max()) > 0
    with torch.inference_mode():
        logits, _ = model.decode_step(
            params, tokens[:, :1], tmodel.zero_cache(cfg, 2, 8, "cpu"),
            torch.zeros((2,), dtype=torch.int32))
    assert bool((logits[:, 250:] < -1e29).all())


def test_remat_keeps_the_loss_and_grads():
    """The rematerialized blocks give the same loss and grads, bit for bit,
    as a forward that keeps its activations."""
    cfg = tbase.get_config(ARCH, smoke=True)
    model = tmodel.build_model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 17))).long()
    loss, grads = value_and_grad(model.loss_fn, params, toks)
    real = tmodel._remat
    try:
        tmodel._remat = lambda fn, *args: fn(*args)
        loss2, grads2 = value_and_grad(model.loss_fn, params, toks)
    finally:
        tmodel._remat = real
    assert float(loss) == float(loss2)
    for (path, a), (_, b) in zip(tmodel.tree_paths(grads),
                                 tmodel.tree_paths(grads2)):
        assert torch.equal(a, b), path


# --------------------------------------------------------------------------
# one train step from carried state; checkpoints across packages
# --------------------------------------------------------------------------

STEP_KW = dict(base_lr=1e-3, warmup=1, total_steps=10)


@functools.cache
def _qwen():
    cfg = tbase.get_config(ARCH, smoke=True)
    toks = make_corpus(1 << 17, cfg.vocab_size, seed=0)
    return (cfg, tmodel.build_model(cfg),
            rmodel.build_model(rbase.get_config(ARCH, smoke=True)), toks)


@functools.cache
def _reference_step_plain():
    _, _, rm, _ = _qwen()
    return rtrain.make_train_step(rm, **STEP_KW)


@functools.cache
def _reference_step():
    """The reference's step, jitted as its ``Trainer`` jits it (one
    compile serves this module's reference trainers too)."""
    return jax.jit(_reference_step_plain())


def _reference_state(tree: dict):
    """A reference ``TrainState`` from ``train_state_to_reference``'s
    dict."""
    return rtrain.TrainState(
        params=_ref_tree(tree["params"]),
        opt=radamw.AdamWState(m=_ref_tree(tree["opt"]["m"]),
                              v=_ref_tree(tree["opt"]["v"]),
                              step=jnp.asarray(tree["opt"]["step"])),
        ef=_ref_tree(tree["ef"]))


def test_train_step_from_carried_state_matches_reference():
    cfg, tm, _, toks = _qwen()
    batcher = TokenBatcher(tokens=toks, batch=4, seq_len=64, seed=6)
    batches = [batcher.batch_at(i) for i in range(3)]
    ref_step = _reference_step()
    rstate = _reference_state(train_state_to_reference(
        init_train_state(tm, 0, device="cpu")))
    for b in batches[:2]:
        rstate, _ = ref_step(rstate, {"tokens": jnp.asarray(b)})
    state = train_state_from_reference(rstate, device="cpu")
    assert int(state.opt.step) == 2
    rnew, rmet = ref_step(rstate, {"tokens": jnp.asarray(batches[2])})
    tnew, tmet = make_train_step(tm, **STEP_KW)(
        state, {"tokens": torch.from_numpy(batches[2]).long()})
    np.testing.assert_allclose(float(tmet["loss"]), float(rmet["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=0.05)
    np.testing.assert_allclose(float(tmet["lr"]), float(rmet["lr"]),
                               rtol=1e-6)
    assert int(tmet["skipped"]) == int(rmet["skipped"]) == 0
    assert int(tnew.opt.step) == int(rnew.opt.step) == 3
    lr = float(rmet["lr"])
    for name in ("m", "v"):
        got = _by_path(getattr(tnew.opt, name))
        for path, want in _by_path(getattr(rnew.opt, name)).items():
            assert _rel_frobenius(got[path], want) <= GRAD_TOL, (name, path)
    got = _by_path(tnew.params)
    for path, want in _by_path(rnew.params).items():
        ulp = np.spacing(np.abs(want)) * 2 ** 16
        assert np.all(np.abs(got[path] - want) <= 2 * lr + 2 * ulp), path


def _reference_init(model, seed: int = 0, compress_bits: int = 0):
    """The reference's ``init_train_state`` from the port's CPU init (its
    own init runs eagerly, op by op, for seconds; a resume replaces it)."""
    _, tm, _, _ = _qwen()
    return _reference_state(train_state_to_reference(
        init_train_state(tm, seed, compress_bits, device="cpu")))


def _trainer_pair(tmp_path, kind: str, monkeypatch):
    cfg, tm, rm, toks = _qwen()
    monkeypatch.setattr(rtrain, "init_train_state", _reference_init)
    if kind == "port":
        return Trainer(tm, TokenBatcher(tokens=toks, batch=4, seq_len=32,
                                        seed=3),
                       ckpt_dir=str(tmp_path), ckpt_every=5, log_every=5,
                       device="cpu", **STEP_KW)
    return rtrain.Trainer(rm, rpipe.TokenBatcher(tokens=toks, batch=4,
                                                 seq_len=32, seed=3),
                          ckpt_dir=str(tmp_path), ckpt_every=5, log_every=5,
                          step_fn=_reference_step_plain())


def _npz_leaves(step_dir: Path) -> tuple[dict, dict]:
    with np.load(step_dir / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, json.loads((step_dir / "meta.json").read_text())


def _assert_same_checkpoint(a: Path, b: Path):
    arr_a, meta_a = _npz_leaves(a)
    arr_b, meta_b = _npz_leaves(b)
    assert list(arr_a) == list(arr_b)
    for k in arr_a:
        assert arr_a[k].dtype == arr_b[k].dtype, k
        assert arr_a[k].tobytes() == arr_b[k].tobytes(), k
    for key in ("step", "num_arrays", "dtypes", "leaf_crc32", "total_bytes"):
        assert meta_a[key] == meta_b[key], key


def test_port_checkpoint_resumes_in_the_reference(tmp_path, monkeypatch):
    port = _trainer_pair(tmp_path / "p", "port", monkeypatch)
    port.run(5)
    ref = _trainer_pair(tmp_path / "p", "reference", monkeypatch)
    assert ref.maybe_resume() == 5
    assert int(ref.state.opt.step) == 5
    ours = train_state_to_reference(port.state)
    theirs = jax.tree.map(np.asarray, ref.state)
    for mine, other in ((ours["params"], theirs.params),
                        (ours["opt"]["m"], theirs.opt.m),
                        (ours["opt"]["v"], theirs.opt.v)):
        flat = dict(tmodel.tree_paths(other))
        for path, leaf in tmodel.tree_paths(mine):
            assert leaf.tobytes() == flat[path].tobytes(), path
    # the reference writes the same file back
    rckpt.save_checkpoint(tmp_path / "r", 5, ref.state)
    _assert_same_checkpoint(tmp_path / "p" / "step_00000005",
                            tmp_path / "r" / "step_00000005")
    ref.run(1)
    assert int(ref.state.opt.step) == 6


def test_reference_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    ref = _trainer_pair(tmp_path / "r", "reference", monkeypatch)
    ref.run(5)
    port = _trainer_pair(tmp_path / "r", "port", monkeypatch)
    assert port.maybe_resume() == 5
    assert port.state.opt.step.dtype == torch.int32
    assert int(port.state.opt.step) == 5
    theirs = jax.tree.map(np.asarray, ref.state)
    ours = train_state_to_reference(port.state)
    flat = dict(tmodel.tree_paths(theirs.params))
    for path, leaf in tmodel.tree_paths(ours["params"]):
        assert leaf.tobytes() == flat[path].tobytes(), path
    from repro_torch.checkpoint import save_checkpoint
    save_checkpoint(tmp_path / "p", 5, port.state)
    _assert_same_checkpoint(tmp_path / "r" / "step_00000005",
                            tmp_path / "p" / "step_00000005")
    port.run(5)
    assert int(port.state.opt.step) == 10


# --------------------------------------------------------------------------
# the reference's tests/test_train.py, on the port
# --------------------------------------------------------------------------

def test_loss_decreases():
    _, model, _, toks = _qwen()
    batcher = TokenBatcher(tokens=toks, batch=8, seq_len=128, seed=0)
    trainer = Trainer(model, batcher, log_every=5, base_lr=1e-3,
                      warmup=5, total_steps=60, device="cpu")
    hist = trainer.run(60)
    first = np.mean([h["loss"] for h in hist[:2]])
    last = np.mean([h["loss"] for h in hist[-2:]])
    assert last < first - 0.1, (first, last)


def test_grad_accum_matches_full_batch():
    _, model, _, toks = _qwen()
    batcher = TokenBatcher(tokens=toks, batch=8, seq_len=64, seed=1)
    batch = {"tokens": torch.from_numpy(batcher.batch_at(0)).long()}
    s1 = init_train_state(model, 0, device="cpu")
    s2 = init_train_state(model, 0, device="cpu")
    n1, m1 = make_train_step(model, grad_accum=1, base_lr=1e-3)(s1, batch)
    n4, m4 = make_train_step(model, grad_accum=4, base_lr=1e-3)(s2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=2e-2)
    for (_, a), (_, b) in zip(tmodel.tree_paths(n1.params),
                              tmodel.tree_paths(n4.params)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-2, atol=2e-4)


def test_nan_skip():
    _, model, _, toks = _qwen()
    batcher = TokenBatcher(tokens=toks, batch=4, seq_len=64, seed=2)
    batch = {"tokens": torch.from_numpy(batcher.batch_at(0)).long()}
    state = init_train_state(model, 0, device="cpu")
    step = make_train_step(model, base_lr=1e-3, nan_skip=True)

    def poison(_, p):
        p = p.clone()
        if p.numel():
            p[(0,) * p.dim()] = float("nan")
        return p
    pstate = dataclasses.replace(
        init_train_state(model, 0, device="cpu"),
        params=tmodel.map_tree(poison, state.params))
    new_state, metrics = step(pstate, batch)
    assert int(metrics["skipped"]) == 1
    assert int(new_state.opt.step) == int(pstate.opt.step)
    new_state, metrics = step(state, batch)
    assert int(metrics["skipped"]) == 0
    assert int(new_state.opt.step) == 1


def test_trainer_checkpoint_resume(tmp_path):
    _, model, _, toks = _qwen()
    batcher = TokenBatcher(tokens=toks, batch=4, seq_len=64, seed=3)
    t1 = Trainer(model, batcher, ckpt_dir=str(tmp_path), ckpt_every=5,
                 log_every=5, base_lr=1e-3, device="cpu")
    t1.run(10)
    t2 = Trainer(model, batcher, ckpt_dir=str(tmp_path), ckpt_every=5,
                 log_every=5, base_lr=1e-3, device="cpu")
    assert t2.maybe_resume() == 10
    assert int(t2.state.opt.step) == 10
    for (_, a), (_, b) in zip(tmodel.tree_paths(t1.state.params),
                              tmodel.tree_paths(t2.state.params)):
        assert torch.equal(a, b)
    t2.run(5)
    assert int(t2.state.opt.step) == 15


def test_compressed_training_still_learns():
    _, model, _, toks = _qwen()
    batcher = TokenBatcher(tokens=toks, batch=8, seq_len=128, seed=4)
    trainer = Trainer(model, batcher, log_every=10, base_lr=1e-3,
                      warmup=5, total_steps=60, compress_bits=6,
                      device="cpu")
    hist = trainer.run(60)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.05


def test_deterministic_replay():
    _, model, _, toks = _qwen()
    h = []
    for _ in range(2):
        batcher = TokenBatcher(tokens=toks, batch=4, seq_len=64, seed=5)
        tr = Trainer(model, batcher, log_every=5, base_lr=1e-3,
                     device="cpu")
        h.append(tr.run(10))
    assert h[0][-1]["loss"] == h[1][-1]["loss"]


def test_device_errors_pass_through_the_trainer(monkeypatch, tmp_path):
    """A failed ``bitpack`` launch raises ``KernelError`` out of
    ``Trainer.run``; a device error while checkpointing is not caught
    either."""
    from repro_torch.kernels import build, ops
    from repro_torch.train import trainer as ttrainer
    _, model, _, toks = _qwen()
    batcher = TokenBatcher(tokens=toks, batch=2, seq_len=16, seed=0)

    def broken(bits):
        raise build.KernelError("CUDA kernel bitpack failed: test (1)")
    with monkeypatch.context() as m:
        m.setattr(ops, "bitpack", broken)
        tr = Trainer(model, batcher, compress_bits=6, device="cpu")
        with pytest.raises(build.KernelError):
            tr.run(1)
    assert int(tr.state.opt.step) == 0

    def oom(*args, **kwargs):
        raise torch.OutOfMemoryError("test")
    monkeypatch.setattr(ttrainer, "save_checkpoint", oom)
    tr = Trainer(model, batcher, ckpt_dir=str(tmp_path), ckpt_every=1,
                 device="cpu")
    with pytest.raises(torch.OutOfMemoryError):
        tr.run(2)


# --------------------------------------------------------------------------
# the CLI and the example, in process
# --------------------------------------------------------------------------

def test_train_cli_prints_the_reference_lines(capsys, tmp_path):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "10",
            "--compressed-corpus", "--corpus-tokens", str(1 << 16),
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
            "--log-every", "5"]
    trainer = ttrain_cli.main(argv)
    lines = capsys.readouterr().out.splitlines()
    r_count = rtrain_cli_param_count(ARCH)
    assert lines[0] == (f"arch=qwen2_0_5b_smoke family=dense "
                        f"params={r_count:,}")
    assert re.fullmatch(r"compressed corpus: \d+\.\d\d bits/token \(raw 32\)",
                        lines[1])
    assert re.fullmatch(r"step +5  loss \d+\.\d{4}  gnorm \d+\.\d{3}  "
                        r"\d+\.\ds", lines[2])
    assert re.fullmatch(r"loss \d+\.\d{4} -> \d+\.\d{4} over 10 steps",
                        lines[-1])
    assert [h["step"] for h in trainer.history] == [5, 10]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000005", "step_00000010"]
    again = ttrain_cli.main(argv + ["--resume", "--steps", "5"])
    assert "resumed at step 10" in capsys.readouterr().out
    assert int(again.state.opt.step) == 15


def rtrain_cli_param_count(arch: str) -> int:
    from repro.launch.train import model_param_count
    return model_param_count(rmodel.build_model(rbase.get_config(
        arch, smoke=True)))


def test_train_cli_mesh_waits_for_the_xla_tools(capsys):
    with pytest.raises(SystemExit):
        ttrain_cli.main(["--smoke", "--device", "cpu", "--mesh", "host"])
    assert "XLA tools" in capsys.readouterr().err


def test_train_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain_cli.main(["--smoke", "--steps", "1"])


def test_example_trains_and_resumes(capsys, tmp_path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = ["--tiny", "--device", "cpu", "--steps", "10", "--ckpt-dir",
            str(tmp_path)]
    hist = mod.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "model lm_tiny: 0.1M params"
    assert re.fullmatch(r"corpus: 131072 tokens at \d+\.\d\d bits/token "
                        r"\(raw 32\) → \d+\.\d\d× smaller", out[1])
    assert out[-1] == (f"final loss {hist[-1]['loss']:.4f} "
                       f"(started {hist[0]['loss']:.4f})")
    mod.main(argv + ["--resume"])
    assert "resumed at step 10" in capsys.readouterr().out
