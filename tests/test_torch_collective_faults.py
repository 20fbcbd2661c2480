"""The dry run's collective faults, closed (``repro_torch.models``): the
decode step's attention over a sequence-sharded KV cache
(``layers.cache_attention``, a split softmax) and its slot write
(``layers.write_slot``), attention over each device's own heads with the
KV repeat and the out-projection inside (``layers._local_gqa``), the MLP
over each device's hidden slice (``layers._local_mlp``), heads that
``model`` does not divide kept whole where sharding them would move more
(``layers._heads_pay``) and, without gradients, attended a KV group at
a time (``layers._by_kv_group``), and the Mamba-2 mixer's projection
gathered in pieces without gradients (``ssm._head_parallel``).

* Values on a real mesh: 4 gloo ranks as a 2×2 ("data", "model") mesh, in
  a subprocess with its own timeout.
  - Decode: q (4, 1, 4, 8) against a cache (4, 32, 2, 8) sharded over
    ("data", "model") on its batch and sequence, a valid length per row:
    within 1e-5 relative (Frobenius) of the plain ``decode_attention`` at
    f32 and 1e-2 at bf16; the split softmax sums its max, exponentials and
    weighted values over the sequence's shards in another order than the
    plain softmax. A cache sharded on its batch alone (the cross-attention
    memory) within the same bounds, and the slot written into either
    sequence shard equal to the plain write bit for bit.
  - The MLP (SwiGLU and GELU) on each device's slice of the hidden dim:
    the layer within 0.05 of the plain route, the gradients within 2%.
  - The head-parallel Mamba-2 mixer without gradients, its projection
    gathered a piece of the sequence at a time: its gated output equal to
    the plain route's bit for bit.
  - Training attention over each device's heads (4 query heads, 2 a
    device) with 2 KV heads (sharded with them) and 1 (replicated, its
    gradient summed over ``model``), and 3 query heads, which ``model``
    does not divide, at a width where the reference's plan (every head on
    every device) moves fewer bytes: the layer within 0.05 of the plain
    route and the gradients of its input and every weight within 2% in
    norm (``tests/test_torch_head_parallel.py``'s bounds).
  - Prefill of 9 query heads on 3 KV heads, kept whole without gradients
    and attended a KV group at a time: each head's attention output and
    the layer equal to the ungrouped call's bit for bit, the layer within
    0.05 of the plain route.
* ``_heads_pay``'s choice, by bytes, for qwen2's and arctic's weights at
  train_4k's and prefill_32k's rows a device.
* The 1×1 host mesh (one gloo rank) and plain tensors: the decode
  attention and the slot write equal today's route bit for bit.
* Plan against plan on the fake 16×16 mesh (a subprocess): a decode cell
  of qwen2's smoke config, batch 128 against 2,048 cache slots; the new
  route's plan has no all-gather; the parent's route, forced in the same
  run, gathers each layer's cache (both K and V, at least once each).
  And a prefill cell of 14 query heads on 2 KV heads: kept whole, it
  moves fewer collective bytes than the head-parallel route and, a KV
  group at a time, holds a lower peak than ungrouped.
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

GLOO = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    B, S, H, KV, HD = 4, 32, 4, 2, 8

    def arr(a, dtype=torch.bfloat16):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)

    def rel(a, b):
        a, b = a.double(), b.double()
        return ((a - b).norm() / b.norm()).item()

    def decode_inputs(dtype):
        rng = np.random.default_rng(0)
        q = arr(rng.normal(size=(B, 1, H, HD)), dtype)
        k = arr(rng.normal(size=(B, S, KV, HD)), dtype)
        v = arr(rng.normal(size=(B, S, KV, HD)), dtype)
        new = arr(rng.normal(size=(B, 1, KV, HD)), dtype)
        lengths = torch.tensor([3, 17, 31, 9])
        mask = torch.arange(S)[None, :] <= lengths[:, None]
        return q, k, v, new, mask

    def plain_decode(q, k, v, mask):
        from repro_torch.models import layers as L
        return L.decode_attention(q, L._repeat_kv(k, H // KV),
                                  L._repeat_kv(v, H // KV), mask)

    def decode(res, mesh, dtype):
        from repro_torch.models import layers as L
        from repro_torch.models.shard_ctx import distribute, placements
        q, k, v, new, mask = decode_inputs(dtype)
        want = plain_decode(q, k, v, mask)
        out = res.setdefault(str(dtype), {})
        for name, spec in (("seq", ("data", "model", None, None)),
                           ("batch", ("data", None, None, None))):
            pl = placements(spec, mesh)
            kd, vd = (distribute(t, mesh, pl) for t in (k, v))
            qd = distribute(q, mesh, placements(("data", None, None, None),
                                                mesh))
            md = distribute(mask, mesh, placements(("data", None), mesh))
            got = L.cache_attention(qd, kd, vd, md, H // KV)
            out[name + "_rel"] = rel(got.full_tensor(), want)
            slots = []
            for start in (3, 19):
                kd = distribute(k.clone(), mesh, pl)
                L.write_slot(kd, distribute(new, mesh, placements(
                    ("data", None, None, None), mesh)), start)
                kp = k.clone()
                kp[:, start:start + 1] = new
                slots.append(torch.equal(kd.full_tensor(), kp))
            out[name + "_slot_bits"] = all(slots)

    def train(res, mesh, heads, kv, width):
        from repro_torch.configs.base import get_config
        from repro_torch.launch.mesh import set_mesh
        from repro_torch.models import layers as L, model as M
        from repro_torch.models.shard_ctx import (axis_sizes, distribute,
                                                  placements)
        cfg = dataclasses.replace(get_config("qwen2_0_5b", smoke=True),
                                  num_heads=heads, num_kv_heads=kv,
                                  head_dim=HD, d_model=width)
        shapes = M.param_shapes(cfg)["blocks"]["attn"]
        rng = np.random.default_rng(heads * 10 + kv)
        p = {k: arr(rng.normal(size=shp[1:]) * 0.3)
             for k, shp in shapes.items()}
        b, s = 4, 64
        x = arr(rng.normal(size=(b, s, width)))
        g = arr(rng.normal(size=(b, s, width)))
        pos = torch.arange(s)[None].expand(b, s)
        pp = {k: t.clone().requires_grad_() for k, t in p.items()}
        xp = x.clone().requires_grad_()
        want = L.gqa_attention_train(xp, pp, cfg, pos, q_chunk=16)
        (want.float() * g.float()).sum().backward()
        routes = []
        local_gqa, head_parallel = L._local_gqa, L._head_parallel

        def rec(name, fn):
            def wrapped(*a):
                y = fn(*a)
                routes.append(name if y is not None else None)
                return y
            return wrapped
        L._local_gqa = rec("local_gqa", local_gqa)
        L._head_parallel = rec("head_parallel", head_parallel)
        sizes = axis_sizes(mesh)
        specs = M.param_specs(cfg, sizes)["blocks"]["attn"]
        with set_mesh(mesh):
            pd = {k: distribute(t, mesh, placements(tuple(specs[k])[1:],
                                                    mesh)).requires_grad_()
                  for k, t in p.items()}
            xpl = placements(("data", None, None), mesh)
            xd = distribute(x, mesh, xpl).requires_grad_()
            w = M._fsdp({"attn": pd}, cfg)["attn"]
            out = L.gqa_attention_train(xd, w, cfg, pos, q_chunk=16)
            (out.float() * distribute(g, mesh, xpl).float()).sum(
                ).backward()
        L._local_gqa, L._head_parallel = local_gqa, head_parallel
        res[f"train_{heads}_{kv}"] = {
            "routes": [r for r in routes if r],
            "out_ok": torch.allclose(out.full_tensor().float(),
                                     want.float(), rtol=0.05, atol=0.05),
            "grad_x_rel": rel(xd.grad.full_tensor(), xp.grad),
            "grads_rel": {k: rel(pd[k].grad.full_tensor(), pp[k].grad)
                          for k in p}}

    def mlp(res, mesh, kind):
        from repro_torch.launch.mesh import set_mesh
        from repro_torch.models import layers as L
        from repro_torch.models.shard_ctx import (axis_sizes, distribute,
                                                  gather_dp, placements)
        rng = np.random.default_rng(5)
        d, f = 32, 48
        names = ("w1", "w3", "w2") if kind == "swiglu" else ("w1", "w2")
        p = {k: arr(rng.normal(size=(f, d) if k == "w2" else (d, f)) * 0.3)
             for k in names}
        x = arr(rng.normal(size=(4, 16, d)))
        g = arr(rng.normal(size=(4, 16, d)))
        fn = L.swiglu_mlp if kind == "swiglu" else L.gelu_mlp
        pp = {k: t.clone().requires_grad_() for k, t in p.items()}
        xp = x.clone().requires_grad_()
        want = fn(xp, pp)
        (want.float() * g.float()).sum().backward()
        routes = []
        local_mlp = L._local_mlp

        def rec(*a):
            y = local_mlp(*a)
            routes.append(y is not None)
            return y
        L._local_mlp = rec
        with set_mesh(mesh):
            specs = {"w1": ("data", "model"), "w3": ("data", "model"),
                     "w2": ("model", "data")}
            pd = {k: distribute(t, mesh, placements(specs[k], mesh))
                  .requires_grad_() for k, t in p.items()}
            xpl = placements(("data", None, None), mesh)
            xd = distribute(x, mesh, xpl).requires_grad_()
            out = fn(xd, {k: gather_dp(t) for k, t in pd.items()})
            (out.float() * distribute(g, mesh, xpl).float()).sum(
                ).backward()
        L._local_mlp = local_mlp
        res[f"mlp_{kind}"] = {
            "routes": routes,
            "out_ok": torch.allclose(out.full_tensor().float(),
                                     want.float(), rtol=0.05, atol=0.05),
            "grad_x_rel": rel(xd.grad.full_tensor(), xp.grad),
            "grads_rel": {k: rel(pd[k].grad.full_tensor(), pp[k].grad)
                          for k in p},
            "grad_placements": all(pd[k].grad.placements == pd[k].placements
                                   for k in p)}

    def mixer(res, mesh):
        from torch.distributed.tensor import Shard
        from repro_torch.configs.base import get_config
        from repro_torch.launch.mesh import set_mesh
        from repro_torch.models import model as M, ssm
        from repro_torch.models.shard_ctx import (axis_sizes, distribute,
                                                  gather_dp, placements)
        cfg = get_config("mamba2_370m", smoke=True)
        b, s, chunk = 4, 64, 16
        h = cfg.ssm_heads
        shapes = M.mamba2_param_shapes(cfg)
        rng = np.random.default_rng(1)
        p = {k: arr(rng.normal(size=shp) * 0.2) for k, shp in shapes.items()}
        p["dt_bias"] = arr(rng.uniform(-3, -1, h))
        p["A_log"] = arr(np.log(np.linspace(1, 8, h)))
        x = arr(rng.normal(size=(b, s, cfg.d_model)))
        zx = x @ p["in_proj"]
        with torch.no_grad():
            y_plain = ssm._mixer(*ssm._split_in_proj(zx, cfg), p["conv_w"],
                                 p["dt_bias"], p["A_log"], p["D_skip"],
                                 chunk)
            want = ssm.mamba2_block(x, p, cfg, chunk=chunk)
        gathers = []
        all_gather = ssm.all_gather

        def rec(t, *a):
            gathers.append(tuple(t.shape))
            return all_gather(t, *a)
        ssm.all_gather = rec
        sizes = axis_sizes(mesh)
        specs = M.param_specs(cfg, sizes)["blocks"]["mamba"]
        with set_mesh(mesh), torch.no_grad():
            pd = {k: gather_dp(distribute(t, mesh, placements(
                      tuple(specs[k])[1:], mesh))) for k, t in p.items()}
            zxd = distribute(zx, mesh, [Shard(0), Shard(2)])
            y = ssm._head_parallel(zxd, pd, cfg, chunk)
            out = ssm.mamba2_block(distribute(x, mesh, placements(
                ("data", None, None), mesh)), pd, cfg, chunk=chunk)
        ssm.all_gather = all_gather
        res["mixer_no_grad"] = {
            "pieces": sorted(set(gathers)),
            "y_bits": torch.equal(y.full_tensor(), y_plain),
            "out_ok": torch.allclose(out.full_tensor().float(),
                                     want.float(), rtol=0.05, atol=0.05)}

    def prefill(res, mesh):
        # heads ``model`` does not divide (9 query heads, 3 KV heads, on
        # 2), kept whole without gradients: the layer's per-head attention
        # output (what ``_out_project`` receives) and its output, attended
        # a KV group at a time and ungrouped
        from repro_torch.configs.base import get_config
        from repro_torch.launch.mesh import set_mesh
        from repro_torch.models import layers as L, model as M
        from repro_torch.models.shard_ctx import (axis_sizes, distribute,
                                                  placements)
        cfg = dataclasses.replace(get_config("qwen2_0_5b", smoke=True),
                                  num_heads=9, num_kv_heads=3, head_dim=HD,
                                  d_model=32)
        shapes = M.param_shapes(cfg)["blocks"]["attn"]
        rng = np.random.default_rng(9)
        p = {k: arr(rng.normal(size=shp[1:]) * 0.3)
             for k, shp in shapes.items()}
        b, s = 4, 128
        x = arr(rng.normal(size=(b, s, cfg.d_model)))
        pos = torch.arange(s)[None].expand(b, s)
        with torch.no_grad():
            want = L.gqa_attention_train(x, p, cfg, pos, q_chunk=32)
        group, out_project, head_parallel = (L._by_kv_group, L._out_project,
                                             L._head_parallel)
        seen, heads_o = [], []

        def rec_group(fn, groups):
            seen.append("by_kv_group")
            return group(fn, groups)

        def rec_head_parallel(*a):
            y = head_parallel(*a)
            seen.append("head_parallel" if y is not None else None)
            return y

        def rec_out_project(o, w):
            heads_o.append(o.full_tensor())
            return out_project(o, w)

        def ungrouped(fn, groups):
            return lambda q, k, v: fn(q, L._repeat_kv(k, groups),
                                      L._repeat_kv(v, groups))
        L._head_parallel, L._out_project = rec_head_parallel, rec_out_project
        specs = M.param_specs(cfg, axis_sizes(mesh))["blocks"]["attn"]
        outs = {}
        with set_mesh(mesh), torch.no_grad():
            pd = {k: distribute(t, mesh, placements(tuple(specs[k])[1:],
                                                    mesh))
                  for k, t in p.items()}
            xd = distribute(x, mesh, placements(("data", None, None), mesh))
            w = M._fsdp({"attn": pd}, cfg)["attn"]
            for route, fn in (("grouped", rec_group),
                              ("ungrouped", ungrouped)):
                L._by_kv_group = fn
                outs[route] = L.gqa_attention_train(xd, w, cfg, pos,
                                                    q_chunk=32).full_tensor()
        L._by_kv_group, L._out_project, L._head_parallel = (
            group, out_project, head_parallel)
        grouped_o, ungrouped_o = heads_o
        res["prefill_9_3"] = {
            "routes": [r for r in seen if r],
            "head_bits": [torch.equal(grouped_o[:, :, h], ungrouped_o[:, :, h])
                          for h in range(cfg.num_heads)],
            "out_bits": torch.equal(outs["grouped"], outs["ungrouped"]),
            "out_ok": torch.allclose(outs["grouped"].float(), want.float(),
                                     rtol=0.05, atol=0.05)}

    def host(res):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate
        from repro_torch.models import layers as L
        from repro_torch.models.shard_ctx import distribute
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        rep = [Replicate(), Replicate()]
        q, k, v, new, mask = decode_inputs(torch.bfloat16)
        want = plain_decode(q, k, v, mask)
        kd, vd, qd, md = (distribute(t, mesh, rep) for t in (k, v, q, mask))
        got = L.cache_attention(qd, kd, vd, md, H // KV)
        L.write_slot(kd, distribute(new, mesh, rep), 5)
        k[:, 5:6] = new
        res["host"] = {"out_bits": torch.equal(got.full_tensor(), want),
                       "slot_bits": torch.equal(kd.full_tensor(), k)}

    def run(rank, world, port, res_path):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        from torch.distributed.device_mesh import init_device_mesh
        res = {}
        if world == 1:
            host(res)
        else:
            mesh = init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("data", "model"))
            decode(res, mesh, torch.float32)
            decode(res, mesh, torch.bfloat16)
            train(res, mesh, 4, 2, 32)
            train(res, mesh, 4, 1, 32)
            train(res, mesh, 3, 1, 32)
            mlp(res, mesh, "swiglu")
            mlp(res, mesh, "gelu")
            mixer(res, mesh)
            prefill(res, mesh)
        dist.destroy_process_group()
        if rank == 0:
            with open(res_path, "w") as fh:
                json.dump(res, fh)

    if __name__ == "__main__":
        world = int(sys.argv[3])
        mp.spawn(run, args=(world, int(sys.argv[1]), sys.argv[2]),
                 nprocs=world)
""")


def _gloo(tmp_path_factory, world: int) -> dict:
    tmp = tmp_path_factory.mktemp(f"collective_faults_{world}")
    script = tmp / "collective_faults_gloo.py"   # spawned ranks import it
    script.write_text(GLOO)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = subprocess.run([sys.executable, str(script), str(port),
                          str(tmp / "res.json"), str(world)],
                         capture_output=True, text=True, timeout=240,
                         env=ENV)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads((tmp / "res.json").read_text())


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    return _gloo(tmp_path_factory, 4)


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5),
                                         ("bfloat16", 1e-2)])
@pytest.mark.parametrize("layout", ["seq", "batch"])
def test_decode_attention_on_a_gloo_mesh(gloo_run, dtype, bound, layout):
    r = gloo_run[f"torch.{dtype}"]
    assert r[f"{layout}_rel"] <= bound, r
    assert r[f"{layout}_slot_bits"], r


@pytest.mark.parametrize("heads,kv,route", [(4, 2, "local_gqa"),
                                            (4, 1, "local_gqa"),
                                            (3, 1, None)])
def test_training_attention_routes_on_a_gloo_mesh(gloo_run, heads, kv,
                                                  route):
    r = gloo_run[f"train_{heads}_{kv}"]
    assert r["routes"] == ([route] if route else []), r
    assert r["out_ok"], r
    assert r["grad_x_rel"] <= 0.02, r
    assert max(r["grads_rel"].values()) <= 0.02, r["grads_rel"]


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_over_the_hidden_shards_on_a_gloo_mesh(gloo_run, kind):
    """The MLP on each device's slice of the hidden dim (``_local_mlp``):
    the layer within 0.05 of the plain route, its input's and every
    weight's gradient within 2%, each weight's gradient in its own
    placements."""
    r = gloo_run[f"mlp_{kind}"]
    assert r["routes"] == [True], r
    assert r["out_ok"] and r["grad_placements"], r
    assert r["grad_x_rel"] <= 0.02, r
    assert max(r["grads_rel"].values()) <= 0.02, r["grads_rel"]


def test_mamba_mixer_without_gradients_gathers_pieces(gloo_run):
    """Without gradients (prefill) the head-parallel Mamba-2 mixer gathers
    its projection a piece of the sequence at a time (2 pieces of 32 of
    the 64 tokens on a 2-device ``model`` axis): the gated SSD output
    equal to the plain route's bit for bit, the block within 0.05."""
    r = gloo_run["mixer_no_grad"]
    assert r["pieces"] and all(shape[1] == 32 for shape in r["pieces"]), r
    assert r["y_bits"] and r["out_ok"], r


def test_prefill_heads_whole_a_kv_group_at_a_time(gloo_run):
    """Without gradients, 9 query heads on a 2-device ``model`` axis stay
    whole where that moves fewer bytes (``_heads_pay``) and are attended
    one KV group (3 query heads) at a time (``_by_kv_group``): each head's
    attention output equal to the ungrouped call's bit for bit, the layer
    too, and within 0.05 of the plain route."""
    r = gloo_run["prefill_9_3"]
    assert r["routes"] == ["by_kv_group"], r
    assert len(r["head_bits"]) == 9 and all(r["head_bits"]), r
    assert r["out_bits"] and r["out_ok"], r


def _meta(*shape):
    return torch.empty(shape, device="meta")


class _Shard:
    """A stand-in for a DTensor's local shard (``_heads_pay`` reads only
    its size)."""

    def __init__(self, *shape):
        self.local = _meta(*shape)

    def to_local(self):
        return self.local


# (arch, rows a device, sequence, gradients, heads sharded): train_4k's
# microbatch rows on 16×16 (qwen2 64 / 16, arctic 16 / 16), prefill_32k's
# 32 rows on 16×16 and 2×16×16
HEADS_PAY = [("qwen2_0_5b", 4, 4096, True, False),
             ("qwen2_0_5b", 2, 32768, False, False),
             ("qwen2_0_5b", 1, 32768, False, False),
             ("arctic_480b", 1, 4096, True, True),
             ("arctic_480b", 2, 32768, False, False),
             ("arctic_480b", 1, 32768, False, False),
             # a short prefill shards: one sum moves less than the gathers
             ("qwen2_0_5b", 1, 512, False, True),
             ("arctic_480b", 1, 4096, False, True)]


@pytest.mark.parametrize("arch,rows,seq,grad,shard", HEADS_PAY)
def test_heads_pay_by_bytes(arch, rows, seq, grad, shard):
    """``_heads_pay``: in training the head-parallel route's three
    activation sums a layer against two whole gathers of ``wq`` and
    ``wo``; without gradients one sum against one gather of ``wq``, ``wo``
    and ``bq``."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config(arch)
    shapes = M.param_shapes(cfg)["blocks"]["attn"]
    p = {k: _meta(*shp[1:]) for k, shp in shapes.items()}
    with torch.set_grad_enabled(grad):
        assert layers._heads_pay(_Shard(rows, seq, cfg.d_model), p) is shard


def test_host_mesh_and_plain_tensors_bit_for_bit(tmp_path_factory):
    r = _gloo(tmp_path_factory, 1)["host"]
    assert r["out_bits"] and r["slot_bits"], r
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=shp).astype(np.float32))
               .to(torch.bfloat16)
               for shp in ((2, 1, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8)))
    mask = torch.arange(16)[None] <= torch.tensor([[4], [15]])
    want = layers.decode_attention(q, layers._repeat_kv(k, 2),
                                   layers._repeat_kv(v, 2), mask)
    assert torch.equal(layers.cache_attention(q, k, v, mask, 2), want)
    new = torch.ones(2, 1, 2, 8, dtype=torch.bfloat16)
    kp = k.clone()
    layers.write_slot(kp, new, 7)
    k[:, 7:8] = new
    assert torch.equal(kp, k)


FAKE_MESH = textwrap.dedent("""
    import dataclasses
    import json
    import torch
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import layers as L
    from repro_torch.obs import prof

    cfg = get_config("qwen2_0_5b", smoke=True)
    mesh = make_production_mesh()
    shape = ShapeConfig("decode_32k", 2048, 128, "decode")
    new_attention, new_write = L.cache_attention, L.write_slot

    def parent_attention(q, k, v, mask, groups):
        return L.decode_attention(q, L._repeat_kv(k, groups),
                                  L._repeat_kv(v, groups), mask)

    def parent_write(cache, new, start):
        cache[:, start:start + 1] = new

    out = {}
    for route in ("new", "parent"):
        if route == "parent":
            L.cache_attention, L.write_slot = parent_attention, parent_write
        program = dryrun.lower_cell(cfg, shape, mesh)
        gathers = [line for line in program.text.splitlines()
                   if " all-gather " in line]
        out[route] = {"collectives": prof.analyze_program(program)[
                          "collective_bytes_per_device"],
                      "gathers": gathers}
    L.cache_attention, L.write_slot = new_attention, new_write

    # prefill of 14 query heads on 2 KV heads (qwen2's), 2,048 tokens a
    # row, 2 rows a device: heads whole a KV group at a time, the
    # head-parallel route forced, and heads whole ungrouped
    wide = dataclasses.replace(cfg, num_heads=14, num_kv_heads=2,
                               head_dim=8)
    pay, group = L._heads_pay, L._by_kv_group

    def ungrouped(fn, groups):
        return lambda q, k, v: fn(q, L._repeat_kv(k, groups),
                                  L._repeat_kv(v, groups))
    prefill = {}
    for route in ("new", "head_parallel", "ungrouped"):
        L._heads_pay = (lambda x, p: True) if route == "head_parallel" else pay
        L._by_kv_group = ungrouped if route == "ungrouped" else group
        program = dryrun.lower_cell(
            wide, ShapeConfig("prefill_2k", 2048, 32, "prefill"), mesh)
        prefill[route] = {
            "collectives": sum(prof.analyze_program(program)[
                "collective_bytes_per_device"].values()),
            "peak": prof.compiled_memory(program)["peak_bytes"]}
    L._heads_pay, L._by_kv_group = pay, group
    print(json.dumps({"cfg": [cfg.num_blocks, cfg.num_kv_heads,
                              cfg.head_dim], "plans": out,
                      "prefill": prefill}))
""")


@pytest.fixture(scope="module")
def fake_mesh_run():
    out = subprocess.run([sys.executable, "-c", FAKE_MESH],
                         capture_output=True, text=True, env=ENV,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_decode_plan_gathers_no_cache_where_the_parent_did(fake_mesh_run):
    blocks, kv, hd = fake_mesh_run["cfg"]
    plans = fake_mesh_run["plans"]
    assert "all-gather" not in plans["new"]["collectives"], plans["new"]
    assert not plans["new"]["gathers"]
    # the parent gathers a (8, 2,048, KV, hd) layer cache from its
    # (8, 128, KV, hd) sequence shards, K and V in every block
    cache = f"bf16[8,2048,{kv},{hd}]"
    held = [g for g in plans["parent"]["gathers"] if cache in g
            or f"bf16[128,128,{kv},{hd}]" in g]
    assert len(held) >= 2 * blocks, plans["parent"]["gathers"][:4]
    layer = 8 * 2048 * kv * hd * 2
    assert plans["parent"]["collectives"]["all-gather"] >= 2 * blocks * layer


def test_prefill_plan_keeps_heads_whole_at_a_lower_peak(fake_mesh_run):
    """A prefill cell of qwen2's 14 query and 2 KV heads (smoke widths,
    2,048 tokens, 2 rows a device) on the fake 16×16 mesh: heads kept
    whole move fewer collective bytes than the head-parallel route forced
    in the same run (no sum of the attention's output over ``model``),
    and attending them a KV group at a time holds a lower peak than the
    ungrouped heads-whole route (one group's scores live, not all
    heads')."""
    r = fake_mesh_run["prefill"]
    assert r["new"]["collectives"] < r["head_parallel"]["collectives"], r
    assert r["new"]["collectives"] == r["ungrouped"]["collectives"], r
    assert r["new"]["peak"] < r["ungrouped"]["peak"], r
