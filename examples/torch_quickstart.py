"""Quickstart on the PyTorch/CUDA port: build the paper's structures and
query them, each answer asserted against the raw sequence.

PYTHONPATH=src python examples/torch_quickstart.py                # the card
PYTHONPATH=src python examples/torch_quickstart.py --device cpu --n 20000
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (build_wavelet_matrix, build_wavelet_tree,
                              wm_access, wm_rank, wm_select,
                              wt_access, wt_rank, wt_select)
from repro_torch.core.huffman import (build_huffman_wavelet_tree,
                                      huffman_codebook)
from repro_torch.device import resolve_device


def main(device: str = "cuda", n: int | None = None) -> None:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n, sigma = n or 100_000, 1000
    seq = rng.integers(0, sigma, n).astype(np.uint32)
    seqt = torch.from_numpy(seq.astype(np.int32)).to(dev)

    # --- balanced wavelet tree (paper Theorem 4.1: τ-chunked parallel) ----
    wt = build_wavelet_tree(seqt, sigma, tau=8, device=dev)
    i = min(12345, n - 1)
    c = int(wt_access(wt, i))
    print(f"wavelet tree: S[{i}] = {c} (truth {seq[i]})")
    assert c == seq[i]
    r = int(wt_rank(wt, c, i))
    print(f"rank_{c}(S, {i}) = {r} (truth {(seq[:i] == c).sum()})")
    assert r == (seq[:i] == c).sum()
    s = int(wt_select(wt, c, r))
    want = np.flatnonzero(seq == c)[r]
    print(f"select_{c}(S, {r}) = {s} (the occurrence at/after {i}: {want})")
    assert s == want

    # --- wavelet matrix (Theorem 4.5) --------------------------------------
    wm = build_wavelet_matrix(seqt, sigma, tau=8, device=dev)
    pos = [0, 1, n // 2, n - 1]
    got = wm_access(wm, torch.tensor(pos, device=dev)).cpu().numpy()
    print("wavelet matrix access:", got, "truth:", seq[pos])
    assert np.array_equal(got, seq[pos])
    top = int(np.bincount(seq).argmax())
    cnt = int(wm_rank(wm, top, n))
    print(f"count of most frequent symbol {top}:", cnt,
          "truth:", int((seq == top).sum()))
    assert cnt == (seq == top).sum()
    tenth = int(wm_select(wm, top, 9))
    print("its 10th occurrence at:", tenth,
          "truth:", int(np.flatnonzero(seq == top)[9]))
    assert tenth == np.flatnonzero(seq == top)[9]

    # --- Huffman-shaped tree (Theorem 4.3): entropy-sized storage ----------
    zipf = rng.choice(sigma, size=n,
                      p=(lambda p: p / p.sum())(
                          np.arange(1, sigma + 1.) ** -1.3)).astype(np.uint32)
    freqs = np.bincount(zipf, minlength=sigma) + 1
    codes, lengths, max_len = huffman_codebook(freqs)
    hwt = build_huffman_wavelet_tree(zipf.astype(np.int32), codes, lengths,
                                     max_len, device=dev)
    bits = int(hwt.total_bits) / n
    want_bits = float((lengths[zipf]).sum()) / n
    print(f"huffman tree on zipf data: {bits:.2f} bits/symbol vs "
          f"{np.ceil(np.log2(sigma)):.0f} balanced")
    assert bits == want_bits
    print("every answer verified against the raw sequence ✓")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None,
                    help="sequence length (default 100,000)")
    a = ap.parse_args()
    main(a.device, a.n)
