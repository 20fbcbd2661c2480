"""Where the time of serving Qwen2-0.5B goes on the card.

Serves ``chip_smoke.py``'s step-12 model (Qwen2-0.5B at its full config,
fresh init on the card) at its long shape: batch 8, a 2,048-token prompt
prefilled in four 512-query chunks, then single-token decode steps against
a cache warmed to position 2,048. Each phase runs once to warm up and once
more under ``torch.profiler`` (CPU and CUDA activities): the prefill, one
decode step, and 16 decode steps in a row. For each it prints the wall
time, the device-busy share (the union of kernel intervals over the wall
time), the kernel launches, and the kernels and operators that took the
most device time, then one JSON line of them all.

PYTHONPATH=src python -m repro_torch.launch.profile_serve

Needs a CUDA device; there is nothing to measure on the CPU.
"""
from __future__ import annotations

import json

import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.profile_index import profiled
from repro_torch.launch.serve import make_prompts
from repro_torch.models.model import build_model, zero_cache

ARCH = "qwen2_0_5b"
BATCH, PROMPT, STEPS = 8, 2048, 16


def main() -> None:
    dev = resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config(ARCH)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    prompts = torch.from_numpy(make_prompts(cfg.vocab_size, BATCH, PROMPT,
                                            0)).to(dev).long()
    with torch.inference_mode():
        phases = [profiled(f"prefill {BATCH}x{PROMPT}",
                           lambda: model.prefill(params, prompts))]
        # a cache holding the prompt's keys and values at every layer (the
        # values do not change the work of a step)
        cache = zero_cache(cfg, BATCH, PROMPT + 2 * STEPS + 2, device=dev)
        tok = prompts[:, -1:]

        def steps(n: int):
            logits = None
            for i in range(n):
                logits, _ = model.decode_step(
                    params, tok, cache,
                    torch.full((BATCH,), PROMPT + i, dtype=torch.int32))
            return logits

        phases.append(profiled("decode step", lambda: steps(1)))
        phases.append(profiled(f"{STEPS} decode steps", lambda: steps(STEPS)))
    print(json.dumps({"profile_serve": phases}))


if __name__ == "__main__":
    main()
