"""The port's LM serving path (``repro_torch.configs``, ``repro_torch.models``)
against the reference's ``repro.configs`` and ``repro.models``.

* ``param_shapes``, ``cache_shapes`` and ``count_params`` equal the
  reference's for all ten architectures at full width.
* For one architecture of each family (qwen2 dense, dbrx moe, arctic moe
  with a dense residual, mamba2 ssm, jamba hybrid, whisper encdec,
  llama-3.2-vision vlm) at its smoke config, the reference's params (its
  own init, carried across by ``convert.params_from_reference``) give the
  port's prefill logits and its decode logits (the prompt teacher-forced,
  then 8 steps of the reference's greedy tokens fed to both) within
  ``rtol=atol=0.05``, the bound of the reference's own prefill/decode test
  (``tests/test_models_smoke.py``); the greedy tokens are equal wherever
  the reference's top-two logit margin is at least 0.1. The same at Qwen2's
  full width and depth 2.
* The port's init follows the reference's per-leaf rules; ``top_k`` breaks
  ties as ``jax.lax.top_k`` does; chunked attention equals full attention.

The reference's init, prefill and decode are jitted once per architecture
(module-level cache); its eager ops would compile op by op. Its prefill and
decode are compiled with XLA's excess precision off (``PER_OP_ROUNDING``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import model as rmodel
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_reference, params_to_reference
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.moe import top_k

TOL = dict(rtol=0.05, atol=0.05)   # tests/test_models_smoke.py:163-186
#: the reference compiled to round every bf16 op as its program says (the
#: port's eager ops do): with XLA's default excess precision some fused
#: intermediates stay f32, and a near-tied MoE routing then flips (dbrx's
#: decode: 105 of 12,288 logits off by up to 0.27)
PER_OP_ROUNDING = {"xla_allow_excess_precision": False}
MARGIN = 0.1
B, PROMPT, STEPS = 2, 16, 8
FAMILY_ARCHS = ("qwen2_0_5b", "dbrx_132b", "arctic_480b", "mamba2_370m",
                "jamba_v0_1_52b", "whisper_medium", "llama_3_2_vision_90b")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small eager ops: the tier-1 run's
    workers share the cores, and torch's spinning OpenMP threads then slow
    every op about a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape_tuples(tree):
    return {"/".join(p): tuple(s) for p, s in tmodel.tree_paths(tree)}


def _ref_shape_tuples(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))[0]
    return {"/".join(k.key for k in path): tuple(s) for path, s in flat}


@pytest.mark.parametrize("arch", rbase.ARCHITECTURES)
def test_param_and_cache_shapes_match_reference(arch):
    rcfg, tcfg = rbase.get_config(arch), tbase.get_config(arch)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(tcfg)
    assert (_shape_tuples(tmodel.param_shapes(tcfg))
            == _ref_shape_tuples(rmodel.param_shapes(rcfg)))
    assert (_shape_tuples(tmodel.cache_shapes(tcfg, 3, 40))
            == _ref_shape_tuples(rmodel.cache_shapes(rcfg, 3, 40)))


@pytest.mark.parametrize("arch", rbase.ARCHITECTURES)
def test_count_params_matches_reference(arch):
    rcfg, tcfg = rbase.get_config(arch), tbase.get_config(arch)
    for active in (False, True):
        assert (tmodel.count_params(tcfg, active_only=active)
                == rmodel.count_params(rcfg, active_only=active))
    assert tcfg.param_count() == rcfg.param_count()


def test_qwen2_full_width_param_count():
    assert tbase.get_config("qwen2_0_5b").param_count() == 630_396_800


@functools.cache
def _reference(arch: str, depth: int = 0):
    """(cfg, reference params as numpy, jitted prefill, jitted decode) of a
    smoke config, or of the full config cut to ``depth`` layers."""
    cfg = rbase.get_config(arch, smoke=not depth)
    if depth:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    model = rmodel.build_model(cfg)
    params = jax.jit(functools.partial(rmodel.init_params, cfg, 0))()
    prefill = jax.jit(lambda p, t, e: model.prefill(p, t, e),
                      compiler_options=PER_OP_ROUNDING)
    decode = jax.jit(model.decode_step, compiler_options=PER_OP_ROUNDING)
    return cfg, params, prefill, decode


@functools.cache
def _runs(arch: str, depth: int = 0):
    """The reference's and the port's logits (as numpy) on the same params
    and inputs: prefill (B, V); decode (PROMPT + STEPS, B, V)."""
    cfg, params, prefill, decode = _reference(arch, depth)
    tcfg = dataclasses.replace(tbase.get_config(arch, smoke=not depth),
                               num_layers=cfg.num_layers)
    tparams = params_from_reference(jax.tree.map(np.asarray, params), "cpu")
    tm = tmodel.build_model(tcfg)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    extras = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in tm.extras_shapes(B).items()}
    r_ext = {k: jnp.asarray(v, jnp.bfloat16) for k, v in extras.items()}
    t_ext = {k: torch.from_numpy(v).to(torch.bfloat16)
             for k, v in extras.items()}
    r_pre = np.asarray(prefill(params, jnp.asarray(prompt), r_ext or None),
                       np.float32)
    with torch.inference_mode():
        t_pre = tm.prefill(tparams, torch.from_numpy(prompt).long(),
                           t_ext or None).numpy()

    r_cache = rmodel.zero_cache(cfg, B, PROMPT + STEPS)
    t_cache = tmodel.zero_cache(tcfg, B, PROMPT + STEPS, "cpu")
    for name in ("xk", "xv"):              # the cross-attention memory
        if name in r_cache:
            mem = rng.standard_normal(r_cache[name].shape).astype(np.float32)
            r_cache[name] = jnp.asarray(mem, jnp.bfloat16)
            t_cache[name] = torch.from_numpy(mem).to(torch.bfloat16)
    r_dec, t_dec = [], []
    tok = prompt[:, :1]
    for i in range(PROMPT + STEPS):
        rl, r_cache = decode(params, jnp.asarray(tok), r_cache,
                             jnp.full((B,), i, jnp.int32))
        with torch.inference_mode():
            tl, t_cache = tm.decode_step(
                tparams, torch.from_numpy(tok).long(), t_cache,
                torch.full((B,), i, dtype=torch.int32))
        r_dec.append(np.asarray(rl, np.float32))
        t_dec.append(tl.numpy())
        tok = (prompt[:, i + 1:i + 2] if i + 1 < PROMPT
               else r_dec[-1].argmax(-1)[:, None].astype(np.int32))
    return r_pre, t_pre, np.stack(r_dec), np.stack(t_dec)


def _assert_greedy_equal_where_clear(ref: np.ndarray,
                                     port: np.ndarray) -> int:
    """Greedy tokens equal wherever the reference's top-two margin is at
    least MARGIN; returns the number of such rows."""
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] >= MARGIN
    np.testing.assert_array_equal(port.argmax(-1)[clear],
                                  ref.argmax(-1)[clear])
    return int(clear.sum())


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_matches_reference(arch):
    r_pre, t_pre, _, _ = _runs(arch)
    np.testing.assert_allclose(t_pre, r_pre, **TOL)
    _assert_greedy_equal_where_clear(r_pre, t_pre)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_matches_reference(arch):
    _, _, r_dec, t_dec = _runs(arch)
    np.testing.assert_allclose(t_dec, r_dec, **TOL)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_greedy_tokens_match_reference_where_clear(arch):
    _, _, r_dec, t_dec = _runs(arch)
    assert _assert_greedy_equal_where_clear(r_dec, t_dec) > 0


def test_qwen2_full_width_depth_2_matches_reference():
    r_pre, t_pre, r_dec, t_dec = _runs("qwen2_0_5b", depth=2)
    assert r_pre.shape == (B, 152_064)          # padded to 256s
    np.testing.assert_allclose(t_pre, r_pre, **TOL)
    np.testing.assert_allclose(t_dec, r_dec, **TOL)
    assert _assert_greedy_equal_where_clear(r_dec, t_dec) > 0


def test_params_round_trip_through_the_reference_layout():
    _, params, _, _ = _reference("jamba_v0_1_52b")
    ref = jax.tree.map(np.asarray, params)
    back = params_to_reference(params_from_reference(ref, "cpu"))
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_r) == len(flat_b)
    for path, leaf in flat_r:
        got = flat_b[path]
        assert got.shape == leaf.shape
        np.testing.assert_array_equal(got.view(leaf.dtype), leaf)


@pytest.mark.parametrize("arch", ("jamba_v0_1_52b", "whisper_medium",
                                  "llama_3_2_vision_90b"))
def test_init_follows_the_reference_rules(arch):
    """Constant leaves equal the reference's bit for bit; random ones have
    its scale (fan-in and depth scaling) within sampling error."""
    _, params, _, _ = _reference(arch)
    ref = {tuple(k.key for k in path): np.asarray(a, np.float32)
           for path, a in jax.tree_util.tree_flatten_with_path(params)[0]}
    port = tmodel.init_params(tbase.get_config(arch, smoke=True), 0, "cpu")
    for path, leaf in tmodel.tree_paths(port):
        want = ref[path]
        got = leaf.float().numpy()
        assert leaf.dtype == torch.bfloat16 and got.shape == want.shape
        if np.all(want == want.flat[0]) or path[-1] == "A_log":
            np.testing.assert_array_equal(got, want, err_msg=str(path))
        else:
            np.testing.assert_allclose(got.std(), want.std(), rtol=0.25,
                                       err_msg=str(path))


def test_top_k_breaks_ties_as_the_reference():
    rng = np.random.default_rng(0)
    logits = rng.integers(-3, 3, (64, 8)).astype(np.float32)   # many ties
    rv, ri = jax.lax.top_k(jnp.asarray(logits), 3)
    tv, ti = top_k(torch.from_numpy(logits), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def test_chunked_attention_equals_full_attention():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 64, 4, 16), generator=g).to(torch.bfloat16)
               for _ in range(3))
    full = tlayers.full_attention(q, k, v)
    chunked = tlayers.chunked_attention(q, k, v, q_chunk=16)
    torch.testing.assert_close(chunked, full, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tlayers.chunked_attention(q, k, v, q_chunk=24)
