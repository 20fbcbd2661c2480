"""Where the time of a training step of Qwen2-0.5B goes on the card.

Trains ``chip_smoke.py``'s step-13 model (Qwen2-0.5B at its full config,
fresh init on the card) at its shape: batch 8, 256 tokens a row, AdamW at
lr 3e-4. Each phase runs once to warm up and once more under
``torch.profiler`` (CPU and CUDA activities): a batch served from the
wavelet-matrix store of a 2^24-token corpus (the step's data), the
forward pass of the loss (blocks rematerialized), the forward and
backward pass (``value_and_grad``), the optimizer (schedule and AdamW on
those grads), and the whole ``make_train_step`` step. For each it prints
the wall time, the device-busy share (the union of kernel intervals over
the wall time), the kernel launches, and the kernels and operators that
took the most device time, then one JSON line of them all with the card's
name and power limit (``nvidia-smi``). The backward pass is the
forward-and-backward phase less the forward one.

PYTHONPATH=src python -m repro_torch.launch.profile_train

Needs a CUDA device; there is nothing to measure on the CPU.
"""
from __future__ import annotations

import json
import subprocess

import torch

from repro_torch.configs.base import get_config
from repro_torch.data import TokenBatcher, build_compressed_corpus, make_corpus
from repro_torch.device import resolve_device
from repro_torch.launch.profile_index import profiled
from repro_torch.models.model import build_model, map_tree
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.train import make_train_step, value_and_grad
from repro_torch.train.trainer import TrainState

ARCH = "qwen2_0_5b"
BATCH, SEQ = 8, 256
CORPUS_TOKENS, SHARD_BITS = 1 << 24, 20
LR, WARMUP, STEPS = 3e-4, 5, 20


def main() -> None:
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} ({card})")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config(ARCH)
    model = build_model(cfg)
    corpus = build_compressed_corpus(
        make_corpus(CORPUS_TOKENS, cfg.vocab_size, seed=0), cfg.vocab_size,
        shard_bits=SHARD_BITS, device=dev)
    batcher = TokenBatcher(corpus=corpus, batch=BATCH, seq_len=SEQ, seed=0)
    params = model.init(0, device=dev)
    state = TrainState(params=params, opt=adamw_init(params), ef={})
    tokens = torch.from_numpy(batcher.batch_at(0)).to(dev).long()
    # one step first, so that the profiled update has a nonzero lr
    step = make_train_step(model, base_lr=LR, warmup=WARMUP,
                           total_steps=STEPS)
    state, _ = step(state, {"tokens": tokens})

    live = map_tree(lambda _, a: a.detach().requires_grad_(), state.params)

    def forward():                 # the graph the backward pass would use
        with torch.enable_grad():
            return model.loss_fn(live, tokens)

    def grads():
        return value_and_grad(model.loss_fn, state.params, tokens)[1]

    g = grads()

    def optimizer():
        lr = cosine_schedule(state.opt.step, LR, WARMUP, STEPS)
        return adamw_update(state.params, g, state.opt, lr)

    phases = [profiled(f"batch {BATCH}x{SEQ + 1} from the store",
                       lambda: batcher.batch_at(1)),
              profiled("forward (loss)", forward),
              profiled("forward and backward", grads),
              profiled("optimizer (schedule + AdamW)", optimizer),
              profiled("train step", lambda: step(state,
                                                  {"tokens": tokens}))]
    print(json.dumps({"card": card, "profile_train": phases}))


if __name__ == "__main__":
    main()
