"""Attention heads sharded over ``model`` where ``model`` does not divide
them (``models/layers.py`` ``_head_parallel``), as the reference's GSPMD
plan pads and shards them.

* Values on a real mesh: 8 gloo ranks as a 2×4 ("data", "model") mesh, in
  a subprocess with its own timeout, a GQA layer of 6 query and 2 KV heads
  (qwen2's QKV bias, RoPE): every rank's local attention output of each
  real head, and that output's gradient, equal the plain route's bit for
  bit, in training (chunked) and in prefill (full attention), with the
  weights gathered whole and as ``model._fsdp`` hands them over (the
  query and output weights still sharded over ``data``, gathered by head
  slice); the layer's output within 0.05 of the plain route, and the
  gradients of its input and every weight within 2% in norm (measured
  0.3-0.7%: the sums over the heads' shards, the KV heads' groups among
  them, add bf16 partials in another order), each in its weight's own
  placements.
* The 1×1 host mesh (one gloo rank): the route does not apply, and the
  layer's output and gradients equal the plain route's bit for bit.
* :func:`layers.head_slices` pads 14 → 16 and 56 → 64 heads and finds each
  device's KV heads.
"""
import json
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

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

    B, S, HD, CHUNK = 4, 64, 16, 16

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    def close(a, b):
        return bool(torch.allclose(a.float(), b.float(), rtol=0.05,
                                   atol=0.05))

    def rel(a, b):
        a, b = a.double(), b.double()
        return ((a - b).norm() / b.norm()).item()

    def setup():
        from repro_torch.configs.base import get_config
        from repro_torch.models import model as M
        cfg = dataclasses.replace(get_config("qwen2_0_5b", smoke=True),
                                  num_heads=6, num_kv_heads=2, head_dim=HD)
        shapes = M.param_shapes(cfg)["blocks"]["attn"]
        rng = np.random.default_rng(0)
        p = {k: bf16(rng.normal(size=shp[1:]) * 0.3)
             for k, shp in shapes.items()}
        x = bf16(rng.normal(size=(B, S, cfg.d_model)))
        g = bf16(rng.normal(size=(B, S, cfg.d_model)))
        return cfg, M, p, x, g

    def case(res, mesh, train, fsdp):
        from repro_torch.launch.mesh import set_mesh
        from repro_torch.models import layers as L
        from repro_torch.models.shard_ctx import (axis_sizes, distribute,
                                                  gather_dp, placements)
        cfg, M, p, x, g = setup()
        q_chunk = CHUNK if train else None
        pos = torch.arange(S)[None].expand(B, S)
        seen = []
        attend, out_project = L._attend, L._out_project

        def rec_attend(q, k, v, qc):
            o = attend(q, k, v, qc)
            entry = {"o": o.detach().clone()}
            if o.requires_grad:
                o.register_hook(lambda gr: entry.update(g=gr.clone()))
            seen.append(entry)
            return o
        plain = {}

        def rec_out_project(o, w):
            plain["o"] = o.detach().clone()
            if o.requires_grad:
                o.register_hook(lambda gr: plain.update(g=gr.clone()))
            return out_project(o, w)
        L._out_project = rec_out_project
        pp = {k: t.clone().requires_grad_(train) for k, t in p.items()}
        xp = x.clone().requires_grad_(train)
        with torch.set_grad_enabled(train):
            want = L.gqa_attention_train(xp, pp, cfg, pos, q_chunk=q_chunk)
            if train:
                (want.float() * g.float()).sum().backward()
        L._out_project = out_project
        L._attend = rec_attend
        sizes = axis_sizes(mesh)
        specs = M.param_specs(cfg, sizes)["blocks"]["attn"]
        with set_mesh(mesh), torch.set_grad_enabled(train):
            pd = {k: distribute(t, mesh, placements(tuple(specs[k])[1:],
                                                    mesh)).requires_grad_(train)
                  for k, t in p.items()}
            xpl = placements(("data", None, None), mesh)
            xd = distribute(x, mesh, xpl).requires_grad_(train)
            # the weights FSDP-gathered whole, or as the model's blocks
            # hand them over (``model._fsdp`` with the config: the query
            # and output weights still sharded over ``data``)
            w = (M._fsdp({"attn": pd}, cfg)["attn"] if fsdp
                 else {k: gather_dp(t) for k, t in pd.items()})
            out = L.gqa_attention_train(xd, w, cfg, pos, q_chunk=q_chunk)
            if train:
                (out.float() * distribute(g, mesh, xpl).float()).sum(
                    ).backward()
        L._attend = attend
        names = list(mesh.mesh_dim_names)
        parts = mesh.size(names.index("model"))
        heads, real, _, _ = L.head_slices(cfg.num_heads, cfg.num_kv_heads,
                                          parts, mesh.get_local_rank(
                                              names.index("model")))
        d = mesh.get_local_rank(names.index("data"))
        rows = slice(d * B // 2, (d + 1) * B // 2)
        (local,) = seen
        o_bits = all(torch.equal(local["o"][:, :, i],
                                 plain["o"][rows, :, h])
                     for i, h in enumerate(heads) if real[i])
        r = {"route": out.placements is not None and parts > 1,
             "o_bits": o_bits,
             "out_ok": close(out.full_tensor(), want)}
        if train:
            r["do_bits"] = all(torch.equal(local["g"][:, :, i],
                                           plain["g"][rows, :, h])
                               for i, h in enumerate(heads) if real[i])
            r["grad_x_rel"] = rel(xd.grad.full_tensor(), xp.grad)
            r["grads_rel"] = {k: rel(pd[k].grad.full_tensor(), pp[k].grad)
                              for k in p}
            r["grad_placements"] = all(pd[k].grad.placements
                                       == pd[k].placements for k in p)
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, r)
        res[("train" if train else "prefill")
            + ("_fsdp" if fsdp else "")] = gathered

    def host(res):
        from repro_torch.launch.mesh import set_mesh
        from repro_torch.models import layers as L
        from repro_torch.models.shard_ctx import distribute
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate
        cfg, M, p, x, g = setup()
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        pos = torch.arange(S)[None].expand(B, S)
        pp = {k: t.clone().requires_grad_() for k, t in p.items()}
        xp = x.clone().requires_grad_()
        want = L.gqa_attention_train(xp, pp, cfg, pos, q_chunk=CHUNK)
        (want.float() * g.float()).sum().backward()
        rep = [Replicate(), Replicate()]
        with set_mesh(mesh):
            pd = {k: distribute(t, mesh, rep).requires_grad_()
                  for k, t in p.items()}
            xd = distribute(x, mesh, rep).requires_grad_()
            out = L.gqa_attention_train(xd, pd, cfg, pos, q_chunk=CHUNK)
            (out.float() * distribute(g, mesh, rep).float()).sum().backward()
        res["host"] = {
            "out_bits": torch.equal(out.full_tensor(), want),
            "grad_bits": torch.equal(xd.grad.full_tensor(), xp.grad) and all(
                torch.equal(pd[k].grad.full_tensor(), pp[k].grad)
                for k in p)}

    def run(rank, world, port, res_path):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        from torch.distributed.device_mesh import init_device_mesh
        res = {}
        if world == 1:
            host(res)
        else:
            mesh = init_device_mesh("cpu", (2, world // 2),
                                    mesh_dim_names=("data", "model"))
            for fsdp in (False, True):
                case(res, mesh, True, fsdp)
                case(res, mesh, False, fsdp)
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
    tmp = tmp_path_factory.mktemp(f"head_parallel_{world}")
    script = tmp / "head_parallel_gloo.py"       # spawned ranks import it
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
    return _gloo(tmp_path_factory, 8)


PHASES = ["train", "prefill", "train_fsdp", "prefill_fsdp"]


@pytest.mark.parametrize("phase", PHASES)
def test_each_heads_output_bit_for_bit_on_a_gloo_mesh(gloo_run, phase):
    """6 query heads over ``model`` = 4: 2 a device, the last device's two
    padding heads zero. Each rank's real heads' attention output equals
    the plain route's rows of those heads bit for bit (and, training, the
    output's gradient too), with the weights gathered whole and as the
    model's blocks hand them over (``_fsdp``: query and output weights
    gathered by head slice)."""
    for r in gloo_run[phase]:
        assert r["route"] and r["o_bits"], r
        if phase.startswith("train"):
            assert r["do_bits"], r


@pytest.mark.parametrize("phase", PHASES)
def test_layer_and_gradients_on_a_gloo_mesh(gloo_run, phase):
    """The layer's output within 0.05, its input's and every weight's
    gradient within 2% in norm, each weight's gradient in its own
    placements."""
    for r in gloo_run[phase]:
        assert r["out_ok"], r
        if phase.startswith("train"):
            assert r["grad_x_rel"] <= 0.02, r
            assert max(r["grads_rel"].values()) <= 0.02, r["grads_rel"]
            assert r["grad_placements"], r


def test_host_mesh_bit_for_bit(tmp_path_factory):
    r = _gloo(tmp_path_factory, 1)["host"]
    assert r["out_bits"] and r["grad_bits"], r


@pytest.mark.parametrize("h,kv,parts,j,want", [
    (14, 2, 16, 0, ([0], [True], [0], [0])),
    (14, 2, 16, 7, ([7], [True], [1], [0])),
    (14, 2, 16, 15, ([13], [False], [1], [0])),
    (56, 8, 16, 1, ([4, 5, 6, 7], [True] * 4, [0, 1], [0, 0, 0, 1])),
    (56, 8, 16, 14, ([55] * 4, [False] * 4, [7], [0] * 4)),
    (6, 2, 4, 3, ([5, 5], [False, False], [1], [0, 0])),
])
def test_head_slices_pad_and_find_their_kv_heads(h, kv, parts, j, want):
    assert layers.head_slices(h, kv, parts, j) == want
