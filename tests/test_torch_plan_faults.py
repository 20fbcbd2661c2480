"""The dry run's plan faults against the reference, closed: the
vocabulary-parallel cross-entropy (``repro_torch.models.model``:
``_vocab_parallel_logz``, ``_ShardLogZ``) and the head-parallel Mamba-2
mixer (``repro_torch.models.ssm._head_parallel``) on DTensors, against the
plain route and against the reference's plan; and the query chunks of
``layers.chunked_attention`` rematerialized one by one, as the
reference's ``jax.checkpoint`` of its chunk, without changing a bit.

* Plan against plan, on the fake 16×16 mesh (a subprocess: one process
  holds one default process group) and the reference on 512 host devices
  with ``Auto`` axes (a second subprocess; under jax 0.9.0 the default
  ``Explicit`` axes turn a sharding constraint into a failing assertion):
  - a loss head: hidden states (16, 256, 64) over ("data", None, None),
    an lm_head (64, 8,192) over ("data", "model") whose vocabulary of
    8,000 pads to 8,192, the logits pinned to ("dp", None, "model") and
    ``Model.loss_fn`` (its ``forward_train`` replaced by that product, in
    either package) with the gradients of both inputs. The new route
    plans within 1.5× of the reference's argument + temp (1.85 MB against
    1.81); the parent's plan of the same ops, forced in the same run,
    holds the logits' gradient at the whole vocabulary (9.59 MB, 5.3×);
  - one Mamba-2 layer of jamba's smoke config at head dim 8 (16 heads),
    (16, 1,024, 64) over ("data", None, None), its params by jamba's
    rules, forward: the head-parallel route 2.99 MB against the
    reference's 2.80; the parent's route, forced, runs every head on every
    device (18.26 MB, 6.5×).
* Values on a real mesh: 4 gloo ranks as a 2×2 ("data", "model") mesh, in
  a subprocess with its own timeout.
  - The loss head at qwen2's smoke width with a vocabulary of 250 padded
    to 256 (pad slots in the second vocabulary shard): the loss within
    1e-6 relative of the plain route's; the gradients of the hidden state
    and the lm_head within a relative Frobenius 1e-3 at f32 inputs, 1e-2
    at bf16 (the sharded contraction's bf16 partial sums).
  - ``mamba2_370m``'s smoke mixer (8 heads, 4 a model shard) at chunk 16
    over 64 tokens: the gated SSD output of the head-parallel route
    (before the norm, whose mean reduces across the heads) equal to the
    plain route's bit for bit; the layer's output and its input gradient
    within ``rtol=atol=0.05`` (``test_torch_moe_dispatch.py``'s bound),
    the parameters' gradients within a relative Frobenius 0.02.
* Plain tensors keep their op sequence: ``tests/test_torch_models.py`` and
  ``tests/test_torch_train.py`` hold the plain route to the reference.
  Chunked attention (4 chunks of 16 queries) gives the same output and
  input gradients, bit for bit, with its chunks rematerialized and kept.
"""
import json
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.models import layers

SRC = Path(__file__).resolve().parents[1] / "src"
ENV = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
       "OMP_NUM_THREADS": "1"}
RATIO = 1.5

SIZES = """
import dataclasses
B, S, D, V, VOCAB = 16, 256, 64, 8192, 8000   # the loss head
MB, MS, HD = 16, 1024, 8                       # the Mamba layer: 16 heads
"""

PORT = SIZES + textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh, set_mesh
    from repro_torch.models import model as M, ssm
    from repro_torch.models.shard_ctx import axis_sizes, constrain, gather_dp
    from repro_torch.obs import prof

    mesh = make_production_mesh()
    sizes = axis_sizes(mesh)
    vocab_dims, head_parallel = M._vocab_dims, ssm._head_parallel

    def placed(spec, shape, dtype=torch.bfloat16):
        return dryrun._placed(M.fit_spec(spec, shape, sizes),
                              torch.empty(shape, dtype=dtype, device="meta"),
                              mesh)

    cfg = dataclasses.replace(get_config("qwen2_0_5b", smoke=True),
                              d_model=D, vocab_size=VOCAB)
    mcfg = dataclasses.replace(get_config("jamba_v0_1_52b", smoke=True),
                               ssm_headdim=HD)
    shapes = M.mamba2_param_shapes(mcfg)
    specs = M.param_specs(mcfg, sizes)["blocks"]["mamba"]
    out = {}
    for route in ("new", "parent"):
        if route == "parent":
            M._vocab_dims = lambda logits: []
            ssm._head_parallel = lambda *a: None
        with set_mesh(mesh):
            x = placed(("data", None, None), (B, S, D)).requires_grad_()
            w = placed(("data", "model"), (D, V)).requires_grad_()
            tok = placed(("data", None), (B, S + 1), torch.int32)

            def head(x, w, tok):
                M.forward_train = lambda params, cfg, inp, extras, q_chunk: \\
                    constrain(x @ gather_dp(w), "dp", None, "model").float()
                loss = M.Model(cfg).loss_fn({}, tok)
                return (loss, *torch.autograd.grad(loss, (x, w)))
            loss = prof.lower(head, x, w, tok, name="loss_head", mesh=mesh)
            p = {k: placed(tuple(specs[k])[2:], shapes[k]) for k in shapes}
            xm = placed(("data", None, None), (MB, MS, mcfg.d_model))

            def layer(x, p):
                with torch.no_grad():
                    return ssm.mamba2_block(
                        x, {k: gather_dp(v) for k, v in p.items()}, mcfg)
            mamba = prof.lower(layer, xm, p, name="mamba2_block", mesh=mesh)
        out[route] = {"loss": prof.compiled_memory(loss),
                      "mamba": prof.compiled_memory(mamba)}
    M._vocab_dims, ssm._head_parallel = vocab_dims, head_parallel
    print(json.dumps(out))
""")

REFERENCE = SIZES + textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs.base import get_config
    from repro.models import model as M, shard_ctx, ssm

    mesh = jax.make_mesh((16, 16), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    sizes = {"data": 16, "model": 16}
    shard_ctx.set_mesh_context(("data",), sizes)

    def named(spec, shape):
        return NamedSharding(mesh, M.fit_spec(P(*spec), shape, sizes))

    def memory(compiled):
        m = compiled.memory_analysis()
        return {"argument_bytes": m.argument_size_in_bytes,
                "temp_bytes": m.temp_size_in_bytes}

    def sds(shape, dtype=jnp.bfloat16):
        return jax.ShapeDtypeStruct(shape, dtype)

    cfg = dataclasses.replace(get_config("qwen2_0_5b", smoke=True),
                              d_model=D, vocab_size=VOCAB)
    M.forward_train = lambda params, cfg, inp, extras, q_chunk: \\
        shard_ctx.constrain(jnp.einsum("bsd,dv->bsv", params["x"],
                                       params["w"]),
                            "dp", None, "model").astype(jnp.float32)

    def head(x, w, tok):
        return M.Model(cfg).loss_fn({"x": x, "w": w}, tok)
    sh = (named(("data", None, None), (B, S, D)),
          named(("data", "model"), (D, V)), named(("data", None), (B, S + 1)))
    mcfg = dataclasses.replace(get_config("jamba_v0_1_52b", smoke=True),
                               ssm_headdim=HD)
    shapes = ssm.mamba2_param_shapes(mcfg)
    specs = M.param_specs(mcfg, sizes)["blocks"]["mamba"]
    ps = {k: NamedSharding(mesh, P(*tuple(specs[k])[2:])) for k in shapes}
    xs = named(("data", None, None), (MB, MS, mcfg.d_model))
    with jax.set_mesh(mesh):
        loss = jax.jit(jax.value_and_grad(head, argnums=(0, 1)),
                       in_shardings=sh, out_shardings=(None, sh[:2])).lower(
            sds((B, S, D)), sds((D, V)), sds((B, S + 1), jnp.int32)
        ).compile()
        mamba = jax.jit(lambda p, x: ssm.mamba2_block(x, p, mcfg),
                        in_shardings=(ps, xs), out_shardings=xs).lower(
            {k: sds(shapes[k]) for k in shapes},
            sds((MB, MS, mcfg.d_model))).compile()
    print(json.dumps({"loss": memory(loss), "mamba": memory(mamba)}))
""")


def _run(code: str, timeout=300) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=ENV, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def plans():
    return _run(PORT), _run(REFERENCE, timeout=180)


@pytest.mark.parametrize("part", ["loss", "mamba"])
def test_plan_within_1_5x_of_the_reference_where_the_parent_was_not(
        plans, part):
    port, ref = plans
    want = ref[part]["argument_bytes"] + ref[part]["temp_bytes"]
    new = port["new"][part]["peak_bytes"]
    parent = port["parent"][part]["peak_bytes"]
    assert new <= RATIO * want, (new, want, new / want)
    assert parent > RATIO * want, (parent, want, parent / want)
    # the same arguments: the local shards of the inputs
    assert port["new"][part]["argument_bytes"] == ref[part]["argument_bytes"]


GLOO = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def bf16(a, dtype=torch.bfloat16):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)

    def rel(a, b):
        a, b = a.double(), b.double()
        return ((a - b).norm() / b.norm()).item()

    def loss_head(res, dtype):
        from repro_torch.configs.base import get_config
        from repro_torch.launch.mesh import set_mesh
        from repro_torch.models import model as M
        from repro_torch.models.shard_ctx import (axis_sizes, constrain,
                                                  distribute, gather_dp,
                                                  placements)
        cfg = dataclasses.replace(get_config("qwen2_0_5b", smoke=True),
                                  vocab_size=250)
        b, s, d, v = 4, 32, cfg.d_model, cfg.padded_vocab
        rng = np.random.default_rng(0)
        x = bf16(rng.normal(size=(b, s, d)), dtype)
        w = bf16(rng.normal(size=(d, v)) * 0.3, dtype)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1))
                               .astype(np.int32))
        forward_train = M.forward_train

        def loss(x, w, tok):
            M.forward_train = lambda params, cfg, inp, extras, q_chunk: \\
                constrain(x @ gather_dp(w), "dp", None, "model").float()
            out = M.Model(cfg).loss_fn({}, tok)
            M.forward_train = forward_train
            return out
        xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
        want = loss(xp, wp, tok)
        want.backward()
        mesh = res["mesh"]
        sizes = axis_sizes(mesh)
        res = res.setdefault(str(dtype), {})
        with set_mesh(mesh):
            def put(t, spec):
                return distribute(t, mesh, placements(
                    M.fit_spec(spec, t.shape, sizes), mesh))
            xd = put(x, ("data", None, None)).requires_grad_()
            wd = put(w, ("data", "model")).requires_grad_()
            got = loss(xd, wd, put(tok, ("data", None)))
            got.backward()
            logits = constrain(xd @ gather_dp(wd), "dp", None, "model")
            res["loss_route"] = bool(M._vocab_dims(logits))
        res["loss_rel"] = abs(got.full_tensor().item() - want.item()) / abs(
            want.item())
        res["grad_x_rel"] = rel(xd.grad.full_tensor(), xp.grad)
        res["grad_w_rel"] = rel(wd.grad.full_tensor(), wp.grad)

    def mixer(res):
        from torch.distributed.tensor import Shard
        from repro_torch.configs.base import get_config
        from repro_torch.launch.mesh import set_mesh
        from repro_torch.models import model as M, ssm
        from repro_torch.models.shard_ctx import (axis_sizes, distribute,
                                                  gather_dp, placements)
        cfg = get_config("mamba2_370m", smoke=True)
        b, s, d, chunk = 4, 64, cfg.d_model, 16
        h, n = cfg.ssm_heads, cfg.ssm_state
        shapes = M.mamba2_param_shapes(cfg)
        rng = np.random.default_rng(1)
        p = {k: bf16(rng.normal(size=shp) * 0.2) for k, shp in shapes.items()}
        p["dt_bias"] = bf16(rng.uniform(-3, -1, h))
        p["A_log"] = bf16(np.log(np.linspace(1, 8, h)))
        p["D_skip"] = bf16(1 + 0.1 * rng.normal(size=h))
        p["out_norm"] = bf16(1 + 0.1 * rng.normal(size=shapes["out_norm"]))
        x = bf16(rng.normal(size=(b, s, d)))
        g = bf16(rng.normal(size=(b, s, d)))
        zx = x @ p["in_proj"]
        y_plain = ssm._mixer(*ssm._split_in_proj(zx, cfg), p["conv_w"],
                             p["dt_bias"], p["A_log"], p["D_skip"], chunk)
        pp = {k: t.clone().requires_grad_() for k, t in p.items()}
        xp = x.clone().requires_grad_()
        want = ssm.mamba2_block(xp, pp, cfg, chunk=chunk)
        (want.float() * g.float()).sum().backward()
        mesh = res["mesh"]
        sizes = axis_sizes(mesh)
        specs = M.param_specs(cfg, sizes)["blocks"]["mamba"]
        with set_mesh(mesh):
            xpl = placements(("data", None, None), mesh)
            pd = {k: distribute(t, mesh, placements(tuple(specs[k])[1:],
                                                    mesh)).requires_grad_()
                  for k, t in p.items()}
            zxd = distribute(zx, mesh, [Shard(0), Shard(2)])
            y = ssm._head_parallel(zxd, {k: gather_dp(t) for k, t in
                                         pd.items()}, cfg, chunk)
            res["mixer_route"] = y is not None
            res["y_placements"] = [[type(q).__name__, getattr(q, "dim", None)]
                                  for q in y.placements]
            res["y_bits"] = torch.equal(y.full_tensor(), y_plain)
            xd = distribute(x, mesh, xpl).requires_grad_()
            out = ssm.mamba2_block(xd, {k: gather_dp(t) for k, t in
                                        pd.items()}, cfg, chunk=chunk)
            (out.float() * distribute(g, mesh, xpl).float()).sum().backward()
        res["out_ok"] = torch.allclose(out.full_tensor().float(),
                                       want.float(), rtol=0.05, atol=0.05)
        res["grad_x_ok"] = torch.allclose(xd.grad.full_tensor().float(),
                                          xp.grad.float(), rtol=0.05,
                                          atol=0.05)
        res["param_grad_rel"] = {k: rel(pd[k].grad.full_tensor(),
                                        pp[k].grad) for k in p}

    def run(rank, world, port, res_path):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        from torch.distributed.device_mesh import init_device_mesh
        res = {"mesh": init_device_mesh("cpu", (2, 2),
                                        mesh_dim_names=("data", "model"))}
        loss_head(res, torch.float32)
        loss_head(res, torch.bfloat16)
        mixer(res)
        del res["mesh"]
        dist.destroy_process_group()
        if rank == 0:
            with open(res_path, "w") as fh:
                json.dump(res, fh)

    if __name__ == "__main__":
        mp.spawn(run, args=(4, int(sys.argv[1]), sys.argv[2]), nprocs=4)
""")


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("head_vocab_gloo")
    script = tmp / "head_vocab_gloo.py"          # spawned ranks import it
    script.write_text(GLOO)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = subprocess.run([sys.executable, str(script), str(port),
                          str(tmp / "res.json")], capture_output=True,
                         text=True, timeout=180, env=ENV)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads((tmp / "res.json").read_text())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vocab_parallel_loss_on_a_gloo_mesh(gloo_run, dtype):
    """f32 hidden states and lm_head hold the loss's own arithmetic: its
    gradients within 1e-3 (measured 2.4e-7). At bf16, the path's dtype,
    the products' contraction over the vocabulary shards rounds each
    shard's partial gradient of the hidden state to bf16 before the sum:
    2.9e-3 (the parent's gathered route: 0 for the hidden state, 3.3e-3
    for the lm_head), held within 1e-2, about one bf16 rounding."""
    r = gloo_run[f"torch.{dtype}"]
    bound = 1e-3 if dtype == "float32" else 1e-2
    assert r["loss_route"]
    assert r["loss_rel"] <= 1e-6, r
    assert r["grad_x_rel"] <= bound and r["grad_w_rel"] <= bound, r


def test_head_parallel_mixer_bit_for_bit_per_head(gloo_run):
    r = gloo_run
    assert r["mixer_route"]
    assert r["y_placements"] == [["Shard", 0], ["Shard", 2]], r

    assert r["y_bits"]


def test_head_parallel_layer_and_gradients_on_a_gloo_mesh(gloo_run):
    r = gloo_run
    assert r["out_ok"] and r["grad_x_ok"], r
    assert max(r["param_grad_rel"].values()) <= 0.02, r["param_grad_rel"]


def test_chunked_attention_remat_keeps_the_values(monkeypatch):
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 64, 4, 8)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    g = torch.from_numpy(rng.normal(size=(2, 64, 4, 8)).astype(np.float32))

    def run():
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        out = layers.chunked_attention(*qkv, q_chunk=16)
        (out.float() * g).sum().backward()
        return [out] + [t.grad for t in qkv]
    remat = run()
    monkeypatch.setattr(layers, "remat", lambda fn, *args: fn(*args))
    kept = run()
    for a, b in zip(remat, kept):
        assert torch.equal(a, b)
