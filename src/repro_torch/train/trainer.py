"""Training runtime (port of ``repro.train.trainer``): the step function
factory and the fault-tolerant ``Trainer`` loop.

``make_train_step`` builds one update, run eagerly where the reference
jits it:
  microbatch gradient accumulation in f32 (autograd through the
  rematerialized model) →
  optional error-feedback gradient compression →
  AdamW with global-norm clip →
  NaN/Inf step rejection: ``torch.where`` per leaf keeps the old state
  unless the loss and the grad norm are finite, so a poisoned batch
  skips without a host round trip.

``Trainer`` owns the loop: deterministic batches by step index, periodic
atomic checkpoints through the port's ``checkpoint`` (a ``TrainState``
flattens to the reference's keys: ``.params/...``, ``.opt/.m/...``,
``.opt/.v/...``, ``.opt/.step``, ``.ef/...``, so a checkpoint of either
package's trainer resumes in the other's), resume from the newest, and a
metric history. Device errors (``kernels.build.DEVICE_ERRORS``) are not
caught anywhere in the loop.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.device import resolve_device
from repro_torch.models.model import map_tree, tree_paths
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.grad_compress import ef_compress_tree, zero_residuals
from repro_torch.optim.schedule import cosine_schedule


@dataclass(frozen=True)
class TrainState:
    params: Any
    opt: AdamWState
    ef: Any            # error-feedback residuals ({} when compression off)


def init_train_state(model, seed: int = 0, compress_bits: int = 0,
                     device: str | torch.device = "cuda") -> TrainState:
    params = model.init(seed, device=device)
    return TrainState(
        params=params, opt=adamw_init(params),
        ef=zero_residuals(params) if compress_bits else {})


def _map2(fn: Callable, a, b):
    """``fn(leaf of a, leaf of b)`` over two nested dicts of one shape."""
    other = dict(tree_paths(b))
    return map_tree(lambda path, leaf: fn(leaf, other[path]), a)


def value_and_grad(loss_fn: Callable, params, *args):
    """(loss, grads) of ``loss_fn(params, *args)``: the grads a tree of the
    params' shape and dtype (zeros for a leaf the loss does not reach)."""
    paths = [path for path, _ in tree_paths(params)]
    leaves = {path: leaf.detach().requires_grad_()
              for path, leaf in tree_paths(params)}
    with torch.enable_grad():
        loss = loss_fn(map_tree(lambda path, _: leaves[path], params), *args)
        grads = torch.autograd.grad(loss, [leaves[p] for p in paths],
                                    allow_unused=True,
                                    materialize_grads=True)
    by_path = dict(zip(paths, grads))
    return loss.detach(), map_tree(lambda path, _: by_path[path], params)


def make_train_step(model, *, grad_accum: int = 1, base_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    compress_bits: int = 0, q_chunk: Optional[int] = 512,
                    nan_skip: bool = True) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``; the metrics are
    0-d tensors on the state's device (reading one waits for the step).

    ``batch``: {"tokens": (B, S+1), **extras}. B must divide by grad_accum.
    """
    extras_keys = tuple(model.extras_shapes(1).keys())

    def loss_of(params, tokens, extras):
        return model.loss_fn(params, tokens, extras, q_chunk=q_chunk)

    def grads_of(params, batch):
        tokens = batch["tokens"]
        extras = {k: batch[k] for k in extras_keys} or None
        if grad_accum == 1:
            return value_and_grad(loss_of, params, tokens, extras)
        b = tokens.shape[0]
        assert b % grad_accum == 0
        mb = b // grad_accum
        acc_loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        acc_g = map_tree(lambda _, p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        for i in range(grad_accum):
            part = slice(i * mb, (i + 1) * mb)
            ext = {k: v[part] for k, v in extras.items()} if extras else None
            loss, g = value_and_grad(loss_of, params, tokens[part], ext)
            acc_loss = acc_loss + loss
            acc_g = _map2(torch.add, acc_g, g)
        inv = 1.0 / grad_accum
        return acc_loss * inv, map_tree(lambda _, g: g * inv, acc_g)

    def step(state: TrainState, batch) -> tuple[TrainState, Dict]:
        loss, grads = grads_of(state.params, batch)
        ef = state.ef
        if compress_bits:
            grads, ef = ef_compress_tree(grads, ef, compress_bits)
        lr = cosine_schedule(state.opt.step, base_lr, warmup, total_steps)
        new_params, new_opt, metrics = adamw_update(
            state.params, grads, state.opt, lr)
        if nan_skip:
            good = torch.isfinite(loss) & torch.isfinite(metrics["grad_norm"])

            def sel(new, old):
                return _map2(lambda a, b: torch.where(good, a, b), new, old)
            new_params = sel(new_params, state.params)
            new_opt = AdamWState(m=sel(new_opt.m, state.opt.m),
                                 v=sel(new_opt.v, state.opt.v),
                                 step=torch.where(good, new_opt.step,
                                                  state.opt.step))
            ef = sel(ef, state.ef) if compress_bits else ef
            metrics = {**metrics, "skipped": (~good).to(torch.int32)}
        new_state = TrainState(params=new_params, opt=new_opt, ef=ef)
        return new_state, {"loss": loss, "lr": lr, **metrics}

    return step


class Trainer:
    """Fault-tolerant training loop over a deterministic batcher, on
    ``device`` (``"cuda"`` by default; raises without a card)."""

    def __init__(self, model, batcher, *, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 100, keep: int = 3, seed: int = 0,
                 log_every: int = 10, step_fn: Optional[Callable] = None,
                 compress_bits: int = 0,
                 device: str | torch.device = "cuda", **step_kwargs):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # bf16 products accumulate in f32, as the reference's do
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = False
        self.model = model
        self.batcher = batcher
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.log_every = log_every
        self.compress_bits = compress_bits
        self.step_fn = step_fn or make_train_step(
            model, compress_bits=compress_bits, **step_kwargs)
        self.state = init_train_state(model, seed, compress_bits,
                                      self.device)
        self.start_step = 0
        self.history: list[dict] = []

    def maybe_resume(self) -> int:
        """Resume from the newest checkpoint if one exists."""
        if not self.ckpt_dir:
            return 0
        step = latest_step(self.ckpt_dir)
        if step is None:
            return 0
        self.state, meta = restore_checkpoint(self.ckpt_dir, self.state,
                                              device=self.device)
        self.start_step = int(meta["step"])
        return self.start_step

    def run(self, num_steps: int) -> list[dict]:
        t0 = time.time()
        step = self.start_step
        end = self.start_step + num_steps
        while step < end:
            batch_np = self.batcher.batch_at(step)
            batch = {"tokens": torch.from_numpy(batch_np).to(
                self.device).long()}
            for k, shp in self.model.extras_shapes(
                    batch_np.shape[0]).items():
                batch[k] = torch.zeros(shp, dtype=torch.bfloat16,
                                       device=self.device)
            self.state, metrics = self.step_fn(self.state, batch)
            step += 1
            if step % self.log_every == 0 or step == end:
                rec = {"step": step,
                       "loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "elapsed_s": round(time.time() - t0, 2)}
                self.history.append(rec)
                print(f"step {rec['step']:6d}  loss {rec['loss']:.4f}  "
                      f"gnorm {rec['grad_norm']:.3f}  "
                      f"{rec['elapsed_s']:.1f}s", flush=True)
            if self.ckpt_dir and (step % self.ckpt_every == 0
                                  or step == end):
                save_checkpoint(self.ckpt_dir, step, self.state,
                                keep=self.keep)
        self.start_step = step
        return self.history
