"""End-to-end example of the port (port of ``examples/train_lm.py``): train
a ~100M-parameter LM for a few hundred steps on a wavelet-matrix
compressed corpus, with checkpointing and resume.

PYTHONPATH=src python examples/torch_train_lm.py            # card, 200 steps
PYTHONPATH=src python examples/torch_train_lm.py --tiny --device cpu

The flags are the reference's, plus ``--device`` (``cuda`` by default; it
raises without a card). Checkpoints go to ``--ckpt-dir`` (by default a
directory under the system's temporary directory).
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data import (TokenBatcher, build_compressed_corpus,  # noqa: E402
                              make_corpus)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.model import build_model, count_params  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402


def config_100m() -> ModelConfig:
    """~100M params: 12L, d=768, 12H (GQA kv=4), ff=2048, V=32000."""
    return ModelConfig(name="lm100m", family="dense", num_layers=12,
                       d_model=768, num_heads=12, num_kv_heads=4,
                       d_ff=2048, vocab_size=32000)


def config_tiny() -> ModelConfig:
    return ModelConfig(name="lm_tiny", family="dense", num_layers=2,
                       d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, vocab_size=512)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config_tiny() if args.tiny else config_100m()
    steps = args.steps or (50 if args.tiny else 200)
    batch, seq = (8, 128) if args.tiny else (8, 512)
    batch = args.batch or batch
    seq = args.seq or seq

    model = build_model(cfg)
    print(f"model {cfg.name}: {count_params(cfg)/1e6:.1f}M params")

    # corpus lives compressed: ⌈log σ⌉ bits/token + o(n) directories
    toks = make_corpus(1 << (17 if args.tiny else 21), cfg.vocab_size, seed=0)
    corpus = build_compressed_corpus(toks, cfg.vocab_size,
                                     shard_bits=14 if args.tiny else 17,
                                     device=dev)
    print(f"corpus: {corpus.n} tokens at {corpus.bits_per_token():.2f} "
          f"bits/token (raw 32) → {32/corpus.bits_per_token():.2f}× smaller")
    batcher = TokenBatcher(corpus=corpus, batch=batch, seq_len=seq, seed=0)

    trainer = Trainer(model, batcher, ckpt_dir=args.ckpt_dir,
                      ckpt_every=max(25, steps // 4), log_every=10,
                      base_lr=3e-4, warmup=20, total_steps=steps, device=dev)
    if args.resume:
        print(f"resumed at step {trainer.maybe_resume()}")
    hist = trainer.run(steps)
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(started {hist[0]['loss']:.4f})")
    return hist


if __name__ == "__main__":
    main()
