"""Training CLI of the port (port of ``repro.launch.train``).

PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \\
    --smoke --device cpu --steps 20
PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b  # card

The flags and printed lines are the reference's, plus ``--device``
(``cuda`` by default; it raises when no card is present). Batches come
from ``make_corpus``'s tokens, raw or (``--compressed-corpus``) decoded
from the wavelet-matrix store built on the device. ``--mesh host`` places
params and optimizer state as DTensors with the shardings the dry run
lowers (``param_specs``) on a 1×1 mesh of the device
(``launch.mesh.make_host_mesh``), so the sharded code path runs end to end
on one card (or the CPU); its losses, grad norms and params are the
``--mesh none`` run's bit for bit, and its checkpoints the same files.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import get_config
from repro_torch.data import TokenBatcher, build_compressed_corpus, make_corpus
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import build_model, tree_paths
from repro_torch.train import Trainer


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--compress-bits", type=int, default=0,
                    help="error-feedback bitplane gradient compression")
    ap.add_argument("--corpus-tokens", type=int, default=1 << 20)
    ap.add_argument("--compressed-corpus", action="store_true",
                    help="serve batches from the wavelet-matrix store")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=["none", "host"], default="none")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={model_param_count(model):,}")

    toks = make_corpus(args.corpus_tokens, cfg.vocab_size, seed=args.seed)
    if args.compressed_corpus:
        corpus = build_compressed_corpus(toks, cfg.vocab_size, device=dev)
        print(f"compressed corpus: {corpus.bits_per_token():.2f} bits/token "
              f"(raw 32)")
        batcher = TokenBatcher(corpus=corpus, batch=args.batch,
                               seq_len=args.seq, seed=args.seed)
    else:
        batcher = TokenBatcher(tokens=toks, batch=args.batch,
                               seq_len=args.seq, seed=args.seed)

    mesh = make_host_mesh(dev) if args.mesh == "host" else None
    trainer = Trainer(
        model, batcher, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, seed=args.seed,
        log_every=args.log_every, grad_accum=args.grad_accum,
        base_lr=args.lr, warmup=args.warmup, total_steps=args.steps,
        compress_bits=args.compress_bits, device=dev, mesh=mesh)
    if args.resume:
        start = trainer.maybe_resume()
        print(f"resumed at step {start}")
    trainer.run(args.steps)
    if trainer.history:
        first, last = trainer.history[0], trainer.history[-1]
        print(f"loss {first['loss']:.4f} -> {last['loss']:.4f} over "
              f"{last['step'] - trainer.history[0]['step'] + trainer.log_every} steps")
    return trainer


def model_param_count(model) -> int:
    return sum(p.numel() for _, p in tree_paths(model.abstract_params()))


if __name__ == "__main__":
    main()
