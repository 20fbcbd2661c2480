#!/usr/bin/env bash
# CI entry point of the PyTorch/CUDA port (src/repro_torch), step for step
# what scripts/ci.sh does for the JAX reference: the port's tests, the
# time-source lint, the index and analytics smokes, the obs export checks
# and the SLO gate's exit codes, the chaos smoke, the front-end at 5×
# overload behind its p99 gate, the fused tree-family equality smoke, and
# the model-serving smoke; then a model-training smoke fed from the store,
# which the reference's script lacks.
#
#   bash scripts/ci_torch.sh                  # on the card (the default)
#   bash scripts/ci_torch.sh --device cpu     # the plain versions, no card
#
# On the card the tests are the card tests (tests/test_torch_cuda.py, no
# JAX needed); on the CPU they are every tests/test_torch_*.py, which hold
# the port against the reference and so need JAX. The reference's bench
# smoke and regression gate have no counterpart: benchmarks/ is not ported.
set -euo pipefail
cd "$(dirname "$0")/.."

DEVICE=cuda
if [[ "${1:-}" == "--device" ]]; then
    DEVICE="${2:?--device needs a value}"
fi
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

echo "== port tests ($DEVICE) =="
if [[ "$DEVICE" == "cpu" ]]; then
    python -m pytest -x -q tests/test_torch_*.py
else
    python -m pytest -x -q -m cuda tests/test_torch_cuda.py
fi

# telemetry: the port's launch layer must time through repro_torch.obs
# (Stopwatch / time_compiled / timed_op) — a raw perf_counter there
# bypasses the metrics the SLO gate reads
echo "== obs time-source lint =="
if grep -rn "time\.perf_counter\|time\.time(" src/repro_torch/launch/; then
    echo "FAIL: raw time.* call in src/repro_torch/launch/ — use repro_torch.obs timers"
    exit 1
fi
echo "launch timing goes through repro_torch.obs ✓"

echo "== full-text index smoke =="
python -m repro_torch.launch.index --smoke --device "$DEVICE"

echo "== range analytics smoke =="
python -m repro_torch.launch.analytics --smoke --device "$DEVICE"

# end-to-end metrics pipeline: serve with --metrics-dir, then validate the
# exported snapshot/JSONL and the SLO gate's pass/fail exit codes
echo "== obs export smoke =="
OBS_DIR="$(mktemp -d)"
FE_DIR="$(mktemp -d)"
trap 'rm -rf "$OBS_DIR" "$FE_DIR"' EXIT
python -m repro_torch.launch.analytics --smoke --device "$DEVICE" \
    --metrics-dir "$OBS_DIR"
python - "$OBS_DIR" <<'PY'
import json, sys
from pathlib import Path
d = Path(sys.argv[1])
snap = json.loads((d / "snapshot.json").read_text())
hists = snap["histograms"]
for op in ("quantile", "count", "topk", "distinct"):
    h = hists[f"serve.analytics.{op}.latency_s"]
    assert h["count"] >= 1 and h["p99"] > 0, (op, h)
builds = {k: v for k, v in snap["counters"].items()
          if k.startswith("core.build")}
assert sum(builds.values()) >= 1, builds
events = [json.loads(ln) for ln in
          (d / "events.jsonl").read_text().splitlines() if ln.strip()]
spans = [e for e in events if e["kind"] == "span"]
assert any(e["name"] == "analytics.serve" for e in spans), spans
assert all("span_id" in e for e in spans)
print(f"obs export ✓ ({len(hists)} histograms, {len(events)} events)")
PY
python -m repro_torch.launch.obs "$OBS_DIR" --slo 'analytics.*:p99_ms<=600000'
if python -m repro_torch.launch.obs "$OBS_DIR" --slo 'analytics.*:qps>=1e18' \
        >/dev/null; then
    echo "FAIL: SLO gate did not reject an impossible bound"
    exit 1
fi
echo "SLO gate pass/fail exit codes ✓"

# every fault class of the reference's chaos suite against the port
echo "== fault-injection smoke (chaos) =="
python -m repro_torch.launch.chaos --smoke --device "$DEVICE"

# the overload-hardened front-end at 5× pacing, its accepted-request tail
# gated on the exported histograms (the CLI's default 250 ms deadline)
echo "== serving front-end overload smoke =="
python -m repro_torch.launch.frontend --smoke --device "$DEVICE" \
    --overload 5.0 --metrics-dir "$FE_DIR"
python -m repro_torch.launch.obs "$FE_DIR" --slo 'frontend.*:p99_ms<=250'
echo "front-end overload + SLO gate ✓"

echo "== fused tree-family equality smoke =="
python - "$DEVICE" <<'PY'
import sys
import numpy as np
import torch
from repro_torch.core.huffman import (build_huffman_wavelet_tree,
                                      huffman_codebook)
from repro_torch.core.multiary import build_multiary_wavelet_tree
from repro_torch.core.wavelet_tree import (build_wavelet_tree,
                                           build_wavelet_tree_dd)
from repro_torch.tree import tree_named_leaves

dev = sys.argv[1]

def eq(a, b):
    la, lb = tree_named_leaves(a), tree_named_leaves(b)
    return la.keys() == lb.keys() and all(torch.equal(la[k], lb[k])
                                          for k in la)

rng = np.random.default_rng(0)
n, sigma = 999, 64
seq = torch.from_numpy(rng.integers(0, sigma, n).astype(np.int32))
assert eq(build_wavelet_tree(seq, sigma, device=dev),
          build_wavelet_tree(seq, sigma, fused=False, device=dev)), "tree"
assert eq(build_wavelet_tree_dd(seq[:992], sigma, 8, device=dev),
          build_wavelet_tree_dd(seq[:992], sigma, 8, fused=False,
                                device=dev)), "dd"
assert eq(build_multiary_wavelet_tree(seq, sigma, width=2, device=dev),
          build_multiary_wavelet_tree(seq, sigma, width=2, fused=False,
                                      device=dev)), "multiary"
freqs = np.bincount(seq.numpy(), minlength=sigma) + 1
codes, lengths, max_len = huffman_codebook(freqs)
assert eq(build_huffman_wavelet_tree(seq, codes, lengths, max_len,
                                     device=dev),
          build_huffman_wavelet_tree(seq, codes, lengths, max_len,
                                     fused=False, device=dev)), "huffman"
print("fused tree-family equality ✓")
PY

echo "== model serving smoke =="
python -m repro_torch.launch.serve --arch qwen2_0_5b --smoke \
    --device "$DEVICE"

echo "== model training smoke =="
python -m repro_torch.launch.train --arch qwen2_0_5b --smoke \
    --device "$DEVICE" --steps 20 --compressed-corpus
