"""*Model*-serving CLI of the port (port of ``repro.launch.serve``): batched
prefill + autoregressive decode.

(The analytics *query* front-end has its own CLI in
``repro_torch.launch.frontend``.)

PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \\
    --smoke --device cpu --batch 4 --prompt-len 64 --decode-steps 32
PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b  # card

The flags, prints and ``serve.model.*`` metrics are the reference's, plus
``--device`` (``cuda`` by default; it raises when no card is present).
Prompts come from ``make_corpus``, the reference's tokens. The prefill
returns last-position logits; the cache is then warmed by a teacher-forced
decode of the prompt, and decode runs greedily (``--temperature 0``) or
samples from a ``torch.Generator`` seeded by ``--seed``: at a temperature
above 0 the sampled tokens differ from the reference's, which draws with
``jax.random.categorical``. Everything runs under ``torch.inference_mode``.

``--ckpt-dir`` restores params from an integrity-verified checkpoint
(first run saves one) through ``repro_torch.checkpoint``, whose files are
the reference's: a serve checkpoint written by either package loads in the
other. Model weights are not derivable from anything, so a failed
verification cannot be repaired — the CLI warns and falls back to fresh
init rather than serving silently corrupted weights. A failure of the
device (``kernels.build.DEVICE_ERRORS``) is raised instead.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import get_config
from repro_torch.data import make_corpus
from repro_torch.device import resolve_device
from repro_torch.kernels.build import DEVICE_ERRORS
from repro_torch.models.model import Model, build_model, zero_cache
from repro_torch.obs.spans import wait_for


def params_with_checkpoint(model: Model, seed: int, ckpt_dir: Optional[str],
                           device: torch.device):
    """(params, origin): fresh-init params, replaced by a verified
    checkpoint restore when ``ckpt_dir`` holds one. A restore failure —
    corruption, torn write, structure mismatch — warns and serves the fresh
    init; an empty directory is seeded with a checkpoint for the next run."""
    params = model.init(seed, device=device)
    if not ckpt_dir:
        return params, "init"
    from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                        save_checkpoint)
    if latest_step(ckpt_dir) is None:
        save_checkpoint(ckpt_dir, 0, params,
                        extra_meta={"kind": "serve_params", "seed": seed})
        return params, "init (checkpoint saved)"
    try:
        restored, meta = restore_checkpoint(ckpt_dir, params, device=device)
        if meta.get("kind") not in (None, "serve_params"):
            raise ValueError(f"not a serve checkpoint "
                             f"(kind={meta.get('kind')!r})")
        return restored, "restore (verified)"
    except DEVICE_ERRORS:
        raise                           # the card failed, not the checkpoint
    except Exception as e:                                  # noqa: BLE001
        print(f"WARNING: checkpoint restore failed ({type(e).__name__}: "
              f"{e}) — serving fresh init")
        return params, "init (restore failed)"


def make_prompts(vocab_size: int, batch: int, prompt_len: int,
                 seed: int) -> np.ndarray:
    """(batch, prompt_len) int32 prompts: the first tokens of the
    reference's corpus."""
    toks = make_corpus(prompt_len * batch * 4, vocab_size, seed=seed)
    return toks[:batch * prompt_len].reshape(batch, prompt_len).astype(
        np.int32)


def serve(model: Model, params, prompts: np.ndarray, decode_steps: int,
          device: torch.device, max_seq: int = 0, temperature: float = 0.0,
          seed: int = 0) -> dict:
    """Prefill, teacher-forced cache warm-up and decode of ``prompts``,
    timed on the host clock (each part ending in a wait for the card) and
    recorded in the ``serve.model.*`` metrics. Returns the prefill logits
    (B, V), the warm-up's logits at the last prompt position (the
    teacher-forced decode of the prompt), the generated tokens (B,
    decode_steps) and the times."""
    cfg = model.cfg
    b, plen = prompts.shape
    max_seq = max_seq or (plen + decode_steps)
    # bf16 products accumulate in f32 end to end, as the reference's do
    # (cuBLAS may otherwise add split-K partial sums in bf16)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    with torch.inference_mode():
        prompt_t = torch.from_numpy(prompts).to(device=device,
                                                dtype=torch.long)
        extras = {k: torch.zeros(shp, dtype=torch.bfloat16, device=device)
                  for k, shp in model.extras_shapes(b).items()} or None

        # ---- prefill: batch forward, last-position logits --------------
        sw = obs.Stopwatch()
        logits = wait_for(model.prefill(params, prompt_t, extras))
        t_prefill = sw.lap()
        obs.histogram("serve.model.prefill.latency_s").observe(t_prefill)
        obs.gauge("serve.model.prefill.batch").set(b)

        # ---- warm the cache with the prompt (teacher-forced decode) ----
        # positions stay on the host: the decode reads its cache slot from
        # them without waiting for the card
        cache = zero_cache(cfg, b, max_seq, device=device)
        warm = None
        for i in range(plen):
            warm, cache = model.decode_step(
                params, prompt_t[:, i:i + 1], cache,
                torch.full((b,), i, dtype=torch.int32))

        # ---- autoregressive decode -------------------------------------
        gen = (torch.Generator(device=device).manual_seed(seed)
               if temperature > 0 else None)
        tok = logits.argmax(-1)[:, None]
        out = [tok]
        wait_for(warm)
        sw.lap()
        for s in range(decode_steps - 1):
            pos = torch.full((b,), plen + s, dtype=torch.int32)
            step_logits, cache = model.decode_step(params, tok, cache, pos)
            if gen is not None:
                probs = torch.softmax(step_logits / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)
            else:
                tok = step_logits.argmax(-1)[:, None]
            out.append(tok)
        tokens = wait_for(torch.cat(out, dim=1))
        t_dec = sw.lap()
    obs.histogram("serve.model.decode.latency_s").observe(t_dec)
    obs.gauge("serve.model.decode.batch").set(b)
    obs.gauge("serve.model.decode.qps").set(
        b * (decode_steps - 1) / max(t_dec, 1e-9))
    return {"prefill_logits": logits, "warm_logits": warm, "tokens": tokens,
            "prefill_s": t_prefill, "decode_s": t_dec}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="cache length (default prompt+decode)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", type=str, default=None,
                    help="params checkpoint: verified restore when "
                         "present, fresh init (saved here) otherwise")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--metrics-dir", type=str, default=None,
                    help="export obs metrics snapshot + JSONL events here "
                         "(inspect with `python -m repro_torch.launch.obs`)")
    ap.add_argument("--profile-dir", type=str, default=None,
                    help="capture a torch.profiler trace of "
                         "prefill+decode into this directory")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.metrics_dir:
        obs.configure(args.metrics_dir)
    obs.start_trace(args.profile_dir)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    params, origin = params_with_checkpoint(model, args.seed, args.ckpt_dir,
                                            dev)
    print(f"params: {origin}")
    b = args.batch
    prompts = make_prompts(cfg.vocab_size, b, args.prompt_len, args.seed)
    res = serve(model, params, prompts, args.decode_steps, dev,
                max_seq=args.max_seq, temperature=args.temperature,
                seed=args.seed)
    t_prefill, t_dec = res["prefill_s"], res["decode_s"]
    print(f"prefill: {b}×{args.prompt_len} tokens in {t_prefill*1e3:.1f} ms "
          f"({b*args.prompt_len/t_prefill:.0f} tok/s)")
    gen = res["tokens"].cpu().numpy()
    print(f"decode: {b}×{args.decode_steps} tokens in {t_dec*1e3:.1f} ms "
          f"({b*(args.decode_steps-1)/max(t_dec,1e-9):.0f} tok/s)")
    print("sample token ids:", gen[0, :16].tolist())
    obs.record_memory_gauges()
    if obs.stop_trace():
        print(f"device trace → {args.profile_dir}")
    if args.metrics_dir:
        obs.write_snapshot()
        obs.configure(None)
        print(f"metrics → {args.metrics_dir}")


if __name__ == "__main__":
    main()
