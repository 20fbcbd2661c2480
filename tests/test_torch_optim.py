"""The port's optimizer substrate (``repro_torch.optim``) against the
reference's ``repro.optim`` on the same inputs.

* ``cosine_schedule`` over warmup, decay and past the end: within
  ``rtol=1e-6`` (f32 on both sides; ``cos`` may differ in the last bit).
* ``adamw_update`` from the same params (bf16), grads (bf16), moments (f32)
  and step, with the clip active and inactive: ``grad_norm``, ``m`` and
  ``v`` within ``rtol=1e-6`` (the f32 sum of squares is taken over the
  leaves in the reference's order, but each leaf's reduction order is
  the library's own); the new params within 1 bf16 ulp; ``step`` equal.
* ``quantize_bitplanes`` words and scale bit for bit for bits 2, 4 and 8
  at n not a multiple of 32, and for an all-zero leaf;
  ``dequantize_bitplanes`` bit for bit, ``keep_planes`` included;
  ``ef_compress_tree`` grads and residuals bit for bit.
* The reference's five single-process ``tests/test_grad_compress.py``
  properties on the port (its hypothesis test as fixed cases), and
  ``compressed_allreduce_mean`` over a 4-process gloo group within the
  reference's 2% of the mean.
"""
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as radamw
from repro.optim import grad_compress as rgc
from repro.optim import schedule as rschedule
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim import schedule as tschedule

SRC = Path(__file__).resolve().parents[1] / "src"
RTOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_pair(a: np.ndarray):
    """(reference bf16 array, port bf16 tensor) of the same values."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("step", [0, 1, 4, 5, 6, 37, 99, 100, 150])
def test_cosine_schedule_matches_reference(step):
    for base_lr, warmup, total in ((3e-4, 5, 100), (1e-3, 0, 60),
                                   (2e-3, 20, 20)):
        want = np.float32(rschedule.cosine_schedule(step, base_lr, warmup,
                                                    total))
        got = tschedule.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                        base_lr, warmup, total)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=RTOL)


SHAPES = {"b": {"w": (7, 5), "bias": (33,)}, "a": (4, 3, 2), "z": ()}


def _tree(fn, shapes=SHAPES, path=()):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v, path + (k,)) for k, v in shapes.items()}
    return fn(path, shapes)


def _adamw_inputs(grad_scale: float):
    rng = np.random.default_rng(7)
    pairs = {}

    def make(path, shp):
        p = _bf16_pair(rng.standard_normal(shp))
        g = _bf16_pair(rng.standard_normal(shp) * grad_scale)
        m = np.asarray(rng.standard_normal(shp) * 0.01, np.float32)
        v = np.asarray(rng.random(shp) * 1e-4, np.float32)
        pairs[path] = (p, g, m, v)
        return path
    paths = _tree(make)
    pick = lambda i, j=None: _tree(  # noqa: E731
        lambda path, _: (pairs[path][i] if j is None
                         else pairs[path][i][j]), paths)
    ref = (pick(0, 0), pick(1, 0), pick(2), pick(3))
    port = (pick(0, 1), pick(1, 1),
            _tree(lambda path, _: torch.from_numpy(pairs[path][2]), paths),
            _tree(lambda path, _: torch.from_numpy(pairs[path][3]), paths))
    return ref, port


@pytest.mark.parametrize("grad_scale,clipped", [(3.0, True),
                                                (1e-3, False)])
def test_adamw_update_matches_reference(grad_scale, clipped):
    (rp, rg, rm, rv), (tp, tg, tm, tv) = _adamw_inputs(grad_scale)
    step = 3
    lr_r = rschedule.cosine_schedule(step, 0.05, 5, 100)
    lr_t = tschedule.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                     0.05, 5, 100)
    rstate = radamw.AdamWState(
        m=_tree(lambda path, _: jnp.asarray(_get(rm, path))),
        v=_tree(lambda path, _: jnp.asarray(_get(rv, path))),
        step=jnp.int32(step))
    tstate = tadamw.AdamWState(m=tm, v=tv,
                               step=torch.tensor(step, dtype=torch.int32))
    rnew, rst, rmet = radamw.adamw_update(rp, rg, rstate, lr_r)
    tnew, tst, tmet = tadamw.adamw_update(tp, tg, tstate, lr_t)
    gnorm = float(rmet["grad_norm"])
    assert (gnorm > 1.0) == clipped
    np.testing.assert_allclose(float(tmet["grad_norm"]), gnorm, rtol=RTOL)
    assert int(tst.step) == int(rst.step) == step + 1
    assert tst.step.dtype == torch.int32
    moved = 0
    for path, _ in _leaves(SHAPES):
        np.testing.assert_allclose(_f32(_get(tst.m, path)),
                                   _f32(_get(rst.m, path)), rtol=RTOL,
                                   atol=1e-12)
        np.testing.assert_allclose(_f32(_get(tst.v, path)),
                                   _f32(_get(rst.v, path)), rtol=RTOL,
                                   atol=1e-15)
        new_t = _get(tnew, path)
        assert new_t.dtype == torch.bfloat16
        want = _f32(_get(rnew, path))
        ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16
        assert np.all(np.abs(_f32(new_t) - want) <= ulp), path
        moved += int((want != _f32(_get(tp, path))).sum())
    assert moved > 0


def test_global_norm_leaf_order():
    (_, rg, _, _), (_, tg, _, _) = _adamw_inputs(1.0)
    np.testing.assert_allclose(float(tadamw.global_norm(tg)),
                               float(radamw.global_norm(rg)), rtol=RTOL)


def _leaves(shapes, path=()):
    if isinstance(shapes, dict):
        for k in sorted(shapes):
            yield from _leaves(shapes[k], path + (k,))
    else:
        yield path, shapes


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# --------------------------------------------------------------------------
# gradient compression
# --------------------------------------------------------------------------

def _words(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("n", [77, 1000])
def test_quantize_bitplanes_bit_for_bit(bits, n):
    x = np.random.default_rng(bits * n).standard_normal(n).astype(
        np.float32)
    rw, rs = rgc.quantize_bitplanes(jnp.asarray(x), bits)
    tw, ts = tgc.quantize_bitplanes(torch.from_numpy(x), bits)
    assert tw.dtype == torch.int32 and tuple(tw.shape) == (bits, (n + 31)
                                                           // 32)
    np.testing.assert_array_equal(tw.numpy(), _words(rw))
    assert ts.dtype == torch.float32
    assert np.float32(ts) == np.float32(rs)
    for keep in (None, bits, max(2, bits // 2), 2):
        rdq = rgc.dequantize_bitplanes(rw, rs, bits, (n,), keep_planes=keep)
        tdq = tgc.dequantize_bitplanes(tw, ts, bits, (n,), keep_planes=keep)
        np.testing.assert_array_equal(tdq.numpy(), np.asarray(rdq))


def test_quantize_all_zero_leaf():
    x = np.zeros((5, 13), np.float32)
    rw, rs = rgc.quantize_bitplanes(jnp.asarray(x), 4)
    tw, ts = tgc.quantize_bitplanes(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(tw.numpy(), _words(rw))
    assert float(ts) == float(rs) == 1.0
    np.testing.assert_array_equal(
        tgc.dequantize_bitplanes(tw, ts, 4, x.shape).numpy(), x)


def test_ef_compress_tree_bit_for_bit():
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((9, 7)), "b": {"c": rng.standard_normal(40)}}
    r = {"a": rng.standard_normal((9, 7)).astype(np.float32) * 0.01,
         "b": {"c": rng.standard_normal(40).astype(np.float32) * 0.01}}
    rg = {"a": _bf16_pair(g["a"])[0], "b": {"c": _bf16_pair(g["b"]["c"])[0]}}
    tg = {"a": _bf16_pair(g["a"])[1], "b": {"c": _bf16_pair(g["b"]["c"])[1]}}
    rq, rres = rgc.ef_compress_tree(
        rg, {"a": jnp.asarray(r["a"]), "b": {"c": jnp.asarray(r["b"]["c"])}},
        6)
    tq, tres = tgc.ef_compress_tree(
        tg, {"a": torch.from_numpy(r["a"]),
             "b": {"c": torch.from_numpy(r["b"]["c"])}}, 6)
    for path in (("a",), ("b", "c")):
        assert _get(tq, path).dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(_get(tq, path)),
                                      _f32(_get(rq, path)))
        np.testing.assert_array_equal(_f32(_get(tres, path)),
                                      _f32(_get(rres, path)))


# the reference's tests/test_grad_compress.py, on the port --------------------

@pytest.mark.parametrize("n,bits,seed", [(1, 2, 0), (31, 4, 1), (1000, 8, 2),
                                         (4999, 12, 3), (5000, 2, 4)])
def test_quantization_error_bound(n, bits, seed):
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=n)
                         .astype(np.float32))
    words, scale = tgc.quantize_bitplanes(x, bits)
    dq = tgc.dequantize_bitplanes(words, scale, bits, tuple(x.shape))
    assert float((dq - x).abs().max()) <= float(scale) * 0.5 + 1e-7


def test_wire_format_size():
    x = torch.ones((1000,), dtype=torch.float32)
    for bits in (4, 8):
        words, _ = tgc.quantize_bitplanes(x, bits)
        assert tuple(words.shape) == (bits, (1000 + 31) // 32)
        assert tgc.compression_ratio(bits) == bits / 32


def test_plane_truncation_degrades_gracefully():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    words, scale = tgc.quantize_bitplanes(x, 8)
    errs = [float((tgc.dequantize_bitplanes(words, scale, 8, tuple(x.shape),
                                            keep_planes=keep) - x)
                  .abs().mean()) for keep in (8, 6, 4, 2)]
    assert errs == sorted(errs)


def test_error_feedback_unbiased_over_time():
    rng = np.random.default_rng(1)
    g_true = [torch.from_numpy(rng.normal(size=256).astype(np.float32))
              for _ in range(30)]
    residual = torch.zeros(256)
    total_sent = torch.zeros(256)
    for g in g_true:
        (sent,), (residual,) = tgc.ef_compress_tree((g,), (residual,),
                                                    bits=3)
        total_sent = total_sent + sent
    total_true = sum(g_true)
    drift = (total_sent - total_true).abs().numpy()
    assert drift.max() <= float(residual.abs().max()) + 1e-5
    assert drift.max() / (float(total_true.abs().max()) + 1e-9) < 0.5


def test_tree_structure_preserved():
    params = {"a": torch.ones((8, 8)), "b": {"c": torch.ones((3,))}}
    res = tgc.zero_residuals(params)
    grads = {"a": params["a"] * 0.5, "b": {"c": params["b"]["c"] * 0.5}}
    q, new_res = tgc.ef_compress_tree(grads, res, bits=8)
    for tree in (res, q, new_res):
        assert set(tree) == {"a", "b"} and set(tree["b"]) == {"c"}
        assert tuple(tree["a"].shape) == (8, 8)
        assert tuple(tree["b"]["c"].shape) == (3,)


def test_compressed_allreduce_over_four_gloo_ranks(tmp_path):
    """Each of 4 ranks holds one row of a (4, 64) matrix; the compressed
    mean equals the mean within the reference's 2% and is the same on
    every rank. A subprocess, with its own timeout, as the reference's."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        import torch.distributed as dist
        import torch.multiprocessing as mp

        def run(rank, world, port):
            torch.set_num_threads(1)
            dist.init_process_group("gloo",
                                    init_method=f"tcp://localhost:{port}",
                                    world_size=world, rank=rank)
            from repro_torch.optim.grad_compress import (
                compressed_allreduce_mean)
            x = torch.from_numpy(np.random.default_rng(0).normal(
                size=(world, 64)).astype(np.float32))
            out = compressed_allreduce_mean({"g": x[rank]}, bits=8)["g"]
            want = x.mean(0)
            err = float((out - want).abs().max()
                        / (want.abs().max() + 1e-9))
            assert err < 0.02, err
            every = [torch.empty_like(out) for _ in range(world)]
            dist.all_gather(every, out)
            assert all(torch.equal(e, out) for e in every)
            dist.destroy_process_group()
            if rank == 0:
                print("OK")

        if __name__ == "__main__":
            mp.spawn(run, args=(4, int(sys.argv[1])), nprocs=4)
    """)
    script = tmp_path / "allreduce.py"     # spawned ranks import it
    script.write_text(code)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = subprocess.run([sys.executable, str(script), str(port)],
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC),
                              "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-2000:]
