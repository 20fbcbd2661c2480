"""Batched serving on the port: prefill + KV-cache decode on three families
(attention, SSM and the hybrid) with prompts decoded out of the compressed
store.

PYTHONPATH=src python examples/torch_serve_decode.py               # the card
PYTHONPATH=src python examples/torch_serve_decode.py --device cpu --n 8192
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.data import build_compressed_corpus, make_corpus
from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve
from repro_torch.models.model import build_model

ARCHS = ("qwen2_0_5b", "mamba2_370m", "jamba_v0_1_52b")
TOL = 0.05                # the reference's prefill/decode agreement bound


def serve_arch(arch: str, dev: torch.device, n: int, batch: int = 4,
               prompt_len: int = 48, decode_steps: int = 24) -> None:
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(0, device=dev)

    # prompts come straight out of the compressed store: one access of
    # every prompt position (4 shards of 2^14 at the default size)
    toks = make_corpus(n, cfg.vocab_size, seed=1)
    corpus = build_compressed_corpus(toks, cfg.vocab_size,
                                     shard_bits=min(14, n.bit_length() - 3),
                                     device=dev)
    starts = torch.arange(batch, device=dev) * 999
    prompts = corpus.access(
        starts[:, None] + torch.arange(prompt_len, device=dev)).cpu().numpy()
    want = np.stack([toks[s:s + prompt_len] for s in range(0, 999 * batch,
                                                           999)])
    assert np.array_equal(prompts, want.astype(prompts.dtype))

    res = serve(model, params, prompts, decode_steps, dev)
    dt = res["decode_s"]
    gen = res["tokens"].cpu().numpy()
    print(f"{arch:>16} [{cfg.family}]: {batch}×{decode_steps} tokens "
          f"in {dt*1e3:6.1f} ms ({batch*(decode_steps-1)/dt:7.0f} tok/s) "
          f"sample: {gen[0, :8].tolist()}")
    pre, warm = res["prefill_logits"].cpu(), res["warm_logits"].cpu()
    assert torch.isfinite(pre).all() and torch.isfinite(warm).all()
    # the prefill and the teacher-forced decode of the prompt agree; an MoE
    # layer's capacity depends on the tokens of a step, so its prefill and
    # decode drop different routings (as the reference's do)
    if not cfg.num_experts:
        torch.testing.assert_close(warm, pre, rtol=TOL, atol=TOL)
    assert gen.shape == (batch, decode_steps)
    assert ((gen >= 0) & (gen < cfg.vocab_size)).all()


def main(device: str = "cuda", n: int | None = None) -> None:
    dev = resolve_device(device)
    for arch in ARCHS:
        serve_arch(arch, dev, n or 1 << 16)
    print("prompts equal the raw stream; prefill and teacher-forced decode "
          "agree where no MoE layer drops routings ✓")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None,
                    help="corpus tokens (default 2^16)")
    a = ap.parse_args()
    main(a.device, a.n)
