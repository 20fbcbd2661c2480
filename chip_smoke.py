#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check every kernel.

    python3 chip_smoke.py          # from the root of a checkout, one card

1. Prints the card, its power limit, and the torch and CUDA versions.
2. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and prints
   the registers, shared and local memory and resident blocks per SM of the
   four single-pass scans (the two level scans, ``rank_build_levels`` and
   ``radix_scan``).
3. Holds each kernel against its plain PyTorch version on the card at
   ragged shapes (exact equality: every output is an integer); each
   single-pass scan runs twice on the same inputs and must repeat itself.
   The quantile kernel is held against the plain descent on the
   directories and the dense reference at S = 1, S = 300 (past the first
   kernel's cap of 256) and queries covering more than 32 shards. On the
   same operands the front-end's count (``wm_count``) and greedy top-k
   (``topk_greedy``) kernels are held against their plain versions, with
   every shard and with a masked set, symbol bounds past both ends, and
   the greedy at budgets of 6k and 3k pops with and without pruning; at
   one query, 129 and 4,096, every seventh row all empty; and (at 18
   levels) the greedy at k = 100 and at budgets of 2,000 and 9,000 pops
   (past a block's shared memory: the per-stream global scratch).
4. Runs the main path at full width: a 2^27-token Zipfian stream over
   Qwen2's vocabulary (σ = 151,936, 18 levels), 128 shards of 2^20,
   τ = 8, sample rate 512; the build through the kernels, checked leaf for
   leaf against the plain build on the card; 4,096 range quantiles through
   the sharded quantile kernel, all checked against the plain descent and
   32 against numpy, and the same batch of range counts, 32 checked
   against numpy. Launch counts are zeroed just before this run and read
   just after it; each kernel must have launched, ``wm_level_step`` once a
   level plus once for every level's zero totals. Then 20 more quantile
   batches of other queries, on the host clock: all their queries over
   all their time, and the median batch.
5. Runs the second path on the same stream: the whole 2^27 tokens built as
   one τ-chunked wavelet tree (Theorem 4.1) with the radix big step,
   through the tree's kernels (launch counts zeroed just before, each must
   have launched, ``wt_level_step`` once for each of the 8 moved levels
   l ≤ 8, ``radix_rank`` exactly once, given the bucket starts), then with
   the compose big step and by the plain build; all three equal leaf for
   leaf. The sharded matrix of step 4 is rebuilt with the radix big step
   (``radix_rank`` exactly 4 launches: a totals count and a scan for each
   of its 2 big steps) and must equal its compose build. 4,096 each of
   tree access, rank and select run on the card, 32 of each checked
   against numpy.
6. Times each kernel by CUDA events at its path's shapes beside its plain
   version, its bound and, where one torch call computes the same
   function, that call. The quantile rows also carry ``device_ms``, the
   bare C entry's time on the same batch (``device_ms_cold``: cycling
   eight batches), and a bound whose bytes are the distinct 32-byte
   sectors the batch's rank probes fall in (a sector holding a count and
   224 bits: one sector a probe, the least any layout needs) and which
   includes nbits dependent DRAM round trips, measured by a one-thread
   pointer chase over a buffer the directories' size. The count and
   greedy top-k rows take the front-end's widest bucket (128 queries over
   the 128 full-width shards, every symbol, 6k pops): their launches are
   step 10b's. The ``wm_level_move`` row is the level's move mode on the
   store's own packed keys ((field << 20) | position, the level's bit at
   TAU - 1 + 20), held against its plain version (the plain level's
   destinations applied by a scatter); it is counted under
   ``wm_level_step`` (``counted_as``), so its launches are that
   counter's. Prints the ``phases`` JSON line (the single-row
   and single-shard forms, the totals count, the reference's two matrix
   phase kernels and the two-launch level they make, ``radix_rank``
   without the starts and its totals count, the reference's two radix
   phase kernels, the tree level at l = 0) and the ``kernels`` JSON line.
7. Builds every other construction of the paper from the same 2^27
   tokens on the same stream, each on the host clock ending in a
   synchronize, with its peak device memory and launch counts (zeroed just
   before each build): the τ-chunked tree with ``fused=False`` (compose;
   radix, exactly 2 ``radix_rank`` launches: a totals count and a scan for
   its 256-bucket big step, the 65,536-bucket one takes the argsort
   route), the levelwise tree and the domain decomposition (128 chunks of
   2^20) in both forms, each equal leaf for leaf to the fused tree of step
   5; the matrix with ``fused=False`` (radix, exactly 4 ``radix_rank``
   launches) and the levelwise matrix, each equal to an unsharded fused
   matrix built here; the multiary trees of widths 2 and 4 in both forms,
   equal to each other, whose 4,096 access, rank and select answers equal
   the binary tree's of step 5; the Huffman-shaped tree of the stream's
   codebook (``bincount + 1``) in both forms, equal to each other, its
   first 2^20 tokens' levels equal to the numpy oracle. Prints the
   ``construction`` JSON line; each kernel row gains the launches of this
   phase.
8. Builds the full-text index of the same stream through
   ``build_sharded_index`` (128 shards of 2^20, m = 2^20 + 1 a shard,
   SA sample rate 32, rank sample rate 512, τ = 8, compose, seam overlap
   15), on the host clock from the numpy tokens, with its peak device
   memory; launch counts zeroed just before and read just after:
   ``radix_rank`` exactly a totals count and a scan for each of the
   2 + 4·R kernel passes of R doubling rounds, ``wm_level_step`` 19,
   ``rank_build_levels`` and ``bitpack`` at least once. Runs the same
   build step by step (round 0, each doubling round, BWT, C, the matrix,
   marks and samples; R comes from here), each on the host clock, equal
   leaf for leaf to the entry point's, and times each of the four kernels
   at the shapes the index gives it (kernel rows with path ``index``,
   each against its plain version); then the plain build on the card
   (``use_kernels=False``), equal leaf for leaf; decodes the BWT of shards
   0 and 127 (read back by ``wm_access``) to their tokens with the numpy
   ``bwt_decode``. Counts 4,096 patterns (``sample_patterns``, lengths
   1–8, one in four random): all equal to a sliding compare on the card
   that shares no code with the index, 16 to numpy's ``naive_count``,
   and ``count_by_shard`` summed plus the seam count to ``count``. Locates
   up to 4 hits a shard: every hit a match, min(4, its count) hits a
   (pattern, shard). Drops shards 1 and 3: ``count_bounds``' lower bound
   equals ``naive_count_degraded`` for 16 patterns, both bounds bracket
   the full count of all 4,096, coverage is 126/128. Prints the ``index``
   JSON line (build seconds and parts, peak, rounds, bits a token by
   leaf, query times, launches); each kernel row gains ``index_launches``.
9. Serves the rest of the analytics engine from step 4's engine (kept on
   the card through steps 7 and 8) and queries, and verifies and repairs
   it and step 8's index; every op on the host clock ending in a
   synchronize, with its q/s. Quantile brackets at 0, 9 and 18 levels
   hold every kernel quantile ([q, q + 1) at 18). Histogram, exact top-k
   (k = 8), distinct and histogram bounds of the first 512 queries, 32
   against numpy's bincount. Greedy top-k of all 4,096 at the default
   budget: on the 512, counts a prefix of the exact top-k's, each symbol
   carrying its count; at budgets covering every node of weight at least
   the k-th count, equal to the exact top-k. Shards 1 and 3 dropped:
   coverage equals numpy's, 32 counts and masked quantiles equal the
   survivors', the count and histogram bounds bracket the full answers.
   The last 8 shards built alone and appended to the first 120 equal the
   engine leaf for leaf, with step 4's kernel quantiles. The store:
   ``decode_slice`` of 2^16 tokens at 4 starts (two across a shard
   boundary), ``token_histogram``, 32 raw bits a token, and its top-k,
   distinct and histogram equal the engine's. A snapshot saved and loaded
   equals the engine; a superblock bit flipped in the file is repaired on
   load with exactly 1 ``rank_build_levels`` launch, a bitmap bit raises
   ``IntegrityError``. ``verify_analytics`` is clean; a block entry of
   shard 5 changed on the card is named, ``repair_analytics`` restores it
   (1 ``rank_build_levels`` launch) and its kernel quantiles equal the
   plain descent. ``verify_sharded_index`` is clean and both index
   repairs equal the index (the deep one launches ``bitpack``). Prints the
   ``analytics`` JSON line; each kernel row gains ``analytics_launches``,
   the step's launches, which must include ``rank_build_levels``,
   ``wm_quantile_sharded``, ``bitpack`` and ``wm_level_step``.
10. Ingests and serves the same stream, in a temporary directory.
   ``analytics_ingester`` (shards of 2^20, τ = 8, sample rate 512, on the
   card) takes the first 120 shards' tokens in ragged batches (no inner
   batch edge on a shard edge); a crash is armed after the rename of the
   first commit from generation 60 on; a new ingester's ``recover()``
   must give one ABORT and resume at that generation's start, and the
   stream is fed again from there. A ``GenerationServer`` over the 120
   generations serves four reader threads kernel quantile batches (step
   4's queries) in sessions while the last 8 shards are committed,
   appended by ``add_shards`` and swapped in (``wait_drain=True``): every
   batch must equal one generation's oracle in whole. The ingested engine
   must equal step 4's leaf for leaf, its kernel quantiles step 4's, and
   ``verify_manifest`` must be clean; the commit's host seconds are split
   by protocol part (build, write, checksum, fsync, journal, rename).
   ``index_ingester`` (sample rate 32, seam overlap 15) takes the first 16
   shards (2^24 tokens) and must equal ``build_sharded_index`` of them
   leaf for leaf, seam windows included. The ``QueryFrontend`` (buckets 8,
   32 and 128, capacity 256, a 250 ms deadline, top-k 8, the CLI's breaker
   timings) is warmed up and driven on the system clock by
   ``launch.frontend.make_trace`` (2,000 requests, seed 0, 200 q/s base,
   2,000 q/s bursts of 0.5 s every 2 s) at overload 1 and 5: per op and
   overall, offered, served, shed by reason, degraded, deadline misses,
   q/s, p50 and p99; the accounting identity must hold, up to 64 exact
   answers of each op must equal plain torch on the stream on the card,
   every degraded answer must bracket the exact one, and the exact
   quantiles must have launched ``wm_quantile_sharded``. On a
   ``FakeClock``, shard 2 stalled 9 s must open its breaker after the
   failure threshold, the answers must equal the ``drop_shards([2])``
   oracle with coverage < 1, and the breaker must close past the reset
   window. Prints the ``ingest`` and ``serving`` JSON lines; each kernel
   row gains ``ingest_launches`` and ``serving_launches``, which leave out
   the launches of the checks (oracles, identity quantiles, the reference
   index build; counted apart as ``check_launches``). The ingest must have
   launched ``wm_level_step``, ``rank_build_levels``, ``radix_rank`` and
   ``bitpack``, serving ``wm_level_step``, ``rank_build_levels``,
   ``wm_quantile_sharded`` and ``wm_count``.
10b. The front-end smoke of ``scripts/ci_torch.sh`` three times: ``launch.
   frontend --smoke --overload 5`` (8,192 tokens, 8 shards, 300 requests,
   buckets 8 and 32, the 250 ms deadline) through the CLI's own functions
   (``launch.profile_frontend.run_trace``), each run captured with
   metrics on and put through the gate ``launch.obs --slo
   'frontend.*:p99_ms<=250'``; a run that misses the gate fails the
   script. Prints each op's served count, p50, p99, median batch ms and
   kernel launches a batch. Launch counts are zeroed before the three
   runs and read after: ``wm_count``, ``topk_greedy`` and
   ``wm_quantile_sharded`` must have launched. Prints the
   ``frontend_gate`` JSON line; each kernel row gains
   ``frontend_gate_launches``.
11. Waits for the dry run's processes of step 14a to end (they share the
   host's cores with its host-clock timings; prints how many still ran).
   Drives ``repro_torch.obs`` through step 4's engine and queries, with
   metrics configured to a temporary directory (every count and the
   registry set to 0 first). ``profiled_op`` of the 4,096 kernel quantiles
   (20 repeats): the roofline must lie in (0, 1.05], the steady time
   within 2x of step 5's wrapper time, and the work model's bytes must
   equal the bytes step 5's bound counts for the batch. ``profile_op`` of
   one 2^20-token shard build and of the 128-shard build: a peak-memory
   rise above 0 and a roofline in (0, 1.05]. The front-end at overload 1
   (step 10's configuration and trace): the ``serve.frontend.*`` counters
   must account for every request as ``stats()`` does, and each op's
   latency histogram count equal its served count; ``launch.obs`` renders
   the capture as a table, ``--tree``, ``--prometheus`` and ``--html``. A
   ``torch.profiler`` trace of the 20 quantile batches and one shard build
   must name each kernel launched in it by its ``__global__`` name and
   the ``obs.span`` names; the device-busy share of the window is
   printed. The 20 quantile batches on the host clock with metrics on and
   under ``obs.disabled()``, eight runs each in turns. Over the step, each
   kernel's ``kernels.trace{route=cuda}`` counts must agree with the rise
   of its launch count (``kernels.ops.TRACE_LAUNCHES``, printed; the
   launches of the warm-up and the metrics-off runs are counted apart).
   Then
   ``launch.chaos --smoke --device cuda`` and the analytics, index and
   front-end CLIs at ``--smoke`` with ``--metrics-dir`` and
   ``--profile-dir``, four processes at once: each must exit 0 and write
   ``snapshot.json``, chaos must pass every row and its overload rows must
   equal the reference's ``FakeClock`` numbers (served 105, shed 295, 91
   degraded, p99 79.2 ms). Chaos and the CLIs run at their documented
   sizes. Prints the ``obs`` JSON line; each kernel row gains
   ``obs_launches``.
12. The LM serving path and the examples. (a) The four port examples
   (``examples/torch_*.py``) at their default sizes on the card, each
   ending in its ✓ line, with the launch counts zeroed before each and
   read after it: exactly the kernels its path reaches must have launched
   (``EXAMPLE_KERNELS``). (b) ``qwen2_0_5b`` at its full config (24
   layers, d_model 896, 14 heads, 2 KV heads, d_ff 4864, vocab 151,936,
   630,396,800 parameters), fresh init on the card, served through
   ``launch/serve.py``'s functions at the CLI's defaults (batch 4, prompt
   64, 32 decode steps) and at batch 8, prompt 2,048 (four 512-query
   chunks), 128 decode steps: prefill and decode tok/s, the peak memory
   and its rise, finite logits, and the prefill's last-position logits
   equal to the teacher-forced decode of the prompt within
   ``rtol=atol=0.05`` (the reference's own bound). (c) At full width and
   depth 2, the card's prefill logits and 8 greedy decode steps against
   the port's CPU run of the same params: logits within the same bound,
   the tokens equal wherever the CPU's top-two margin is at least 0.1.
   (d) The serve path launches no wavelet kernel. Prints the ``lm`` JSON
   line; each kernel row gains ``lm_launches`` (the examples' launches).
13. The LM training half, fed from the wavelet-matrix store. (a) The
   store of the whole stream (128 shards of 2^20, τ = 8, sample rate 512)
   built on the card: exactly 19 ``wm_level_step`` (18 levels and the
   totals) and 1 ``rank_build_levels`` launch. Every batch below comes
   from ``TokenBatcher(corpus=..., batch=8, seq_len=256)`` and is held
   against the numpy stream at ``batch_offsets``; its time is kept.
   (b) ``qwen2_0_5b`` at its full config, fresh init on the card, trained
   20 steps at the train CLI's defaults (batch 8, 256 tokens, lr 3e-4,
   warmup 5): s a step (the first apart, then the median), tok/s, the
   6·N·tokens work model's share of 989 TFLOP/s, peak memory and its
   rise, the loss and grad norm of every step; the mean loss of the last
   two steps must fall below the first two's by 0.1. (c) A second run
   from scratch saves at step 10, a fresh ``Trainer`` resumes there and
   runs to 20: the losses of both equal (b)'s and the final params equal
   (b)'s bit for bit. (d) ``grad_accum=4`` against 1 on one batch within
   ``tests/test_train.py``'s tolerances. (e) 3 steps with 6-bit
   error-feedback compression: ``bitpack`` exactly once a leaf a step;
   the words of one step's gradients (their first 2^22 elements a leaf)
   equal the CPU's; ``bitpack`` at the embedding's 6 planes against its
   plain version, timed. (f) At depth 2, one step from the same carried
   state on the card and the CPU: loss within ``rtol=atol=0.05``, grad
   norm within 5%, params within 2·lr + 2 bf16 ulp; a poisoned step is
   skipped and keeps the step. (g) ``examples/torch_train_lm.py --steps
   20`` on the card. Prints the ``train`` JSON line; each kernel row
   gains ``train_launches``, the step's launches without its checks'.

14. The XLA tools' port. (a) At the start, beside steps 1–10b and at the
   lowest priority (step 11 waits for them to end before it times), eight processes (one a line of ``DRYRUN_CELLS``) run
   the dry run on the CPU only (``python -m repro_torch.launch.dryrun``):
   ``qwen2_0_5b`` at its full config in train_4k, prefill_32k and
   decode_32k (and the long_500k skip record) on both production meshes
   (16×16 and 2×16×16 fake ranks), ``dbrx_132b`` × decode_32k × 16×16
   (its MoE pins run), the MoE prefills ``dbrx_132b`` and
   ``arctic_480b`` × prefill_32k × 16×16 (the expert-parallel dispatch
   and combine), ``jamba_v0_1_52b`` × train_4k on both meshes (the
   head-parallel Mamba mixer; qwen2's and jamba's train cells take the
   vocabulary-parallel loss), ``arctic_480b`` × train_4k on both meshes
   (its 56 heads sharded over ``model``, padded to 64; its expert banks'
   gradients reduce-scattered a layer at a time) and ``dbrx_132b`` and
   ``llama_3_2_vision_90b`` × train_4k × 2×16×16, which with arctic's
   run the reference's 16 microbatches there (a microbatch of 16 sharded
   over ``data``, replicated over ``pod``). Each cell must be ``ok``; its
   ``argument_bytes`` must equal the local shard bytes counted in numpy
   from the spec tuples and the shapes; its per-device peak must lie under
   the card's memory; a train cell's FLOPs a device × devices must reach
   6·(N − N_embed)·tokens, N the parameters a token meets (an MoE's top k
   of its experts); collectives are counted under the reference's
   five kinds only. The peaks of the two MoE prefills, of qwen2's
   prefill_32k and of the train_4k cells of qwen2, jamba and arctic (both
   meshes), dbrx and llama-vision (2×16×16) must lie within 1.5× of the
   reference's plan (``REFERENCE_PEAK_BYTES``: 34.82 and 43.55 GB; qwen2
   prefill 4.840 and 2.454 GB, train 4.181 and 2.191 GB, jamba 20.42 and
   17.42 GB, arctic 55.43 and 95.19 GB on 16×16 and 2×16×16; dbrx 25.48
   and llama-vision 32.96 GB on 2×16×16). The collectives a step of
   qwen2's decode_32k, train_4k and prefill_32k (both meshes), dbrx's
   decode_32k (16×16) and arctic's prefill_32k (16×16) must lie within
   1.5× of the reference's trip-counted total
   (``REFERENCE_COLLECTIVE_BYTES``; qwen2 prefill 3.240 and 1.863 GB,
   arctic prefill 366.2 GB), or within 0.1 GB of it where the reference
   moves under 0.2 GB: the decode step attends over the sequence-sharded
   cache in place, and qwen2's 14 heads (and arctic's 56 in prefill) stay
   whole on every device, as the reference's plan keeps them, attended a
   KV group at a time without gradients.
   Prints each cell's ``lower_s``, ``compile_s``, per-device peak against
   the card's memory (and the reference's, where known) and collective
   bytes by kind. (b) The analytics cell on the card: its four-op batch
   and the fused quantile kernel each launch
   ``wm_quantile_sharded`` exactly once. (c) ``--mesh host``: Qwen2-0.5B
   at full width trained 5 steps from step 13's store (batch 8 × 256,
   seed 0) on a 1×1 DTensor mesh, and without a mesh: losses, grad norms
   and every param leaf bit for bit equal; s a step and peak memory of
   both. Prints the ``dryrun`` JSON line; each kernel row gains
   ``dryrun_launches`` (steps 14b and 14c).

Exits non-zero on any failure; prints no result without a CUDA device or
outside a checkout. The last line is the ``{"ok": true, ...}`` object.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

N_TOKENS = 1 << 27
SIGMA = 151_936               # Qwen2's tokenizer vocabulary
SHARD_BITS = 20
TAU = 8
SAMPLE_RATE = 512
NUM_QUERIES = 4096
NUM_NUMPY_CHECKS = 32
SERVE_BATCHES = 20
COLD_BATCHES = 8              # query batches a cold kernel time cycles through

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 16.7e12     # H100 SXM simple int32 ops on the CUDA cores:
#                               132 SMs x 64 INT32 lanes x 1.98 GHz boost
#                               (NVIDIA H100 Tensor Core GPU Architecture
#                               whitepaper, SM and clock tables)
SECTOR_BYTES = 32             # one 32-byte sector a rank probe, the least
#                               any layout of the directories needs
MATRIX_KERNELS = ("rank_build_levels", "wm_level_step", "wm_quantile_sharded")
TREE_KERNELS = ("wt_level_step", "bitpack", "radix_rank", "rank_build_levels")
DD_CHUNKS = 128               # the domain decomposition's P: chunks of 2^20
HUFFMAN_CHECK_TOKENS = 1 << 20  # Huffman levels held against numpy
MULTIARY_WIDTHS = (2, 4)      # 9 and 5 levels at sigma = 151,936
INDEX_SAMPLE_RATE = 32        # the reference's SA sample rate
SEAM_OVERLAP = 15             # the reference's seam half-width
NUM_PATTERNS = 4096
PATTERN_LEN = 8
INDEX_DROP = (1, 3)           # shards dropped for degraded mode
INDEX_NUMPY_CHECKS = 16
LOCATE_HITS = 4               # locate hits a shard
INDEX_KERNELS = ("radix_rank", "wm_level_step", "rank_build_levels",
                 "bitpack")
BRACKET_LEVELS = (0, 9, 18)   # quantile brackets: 2^18, 2^9 and 1 symbols
HIST_QUERIES = 512            # queries of the histogram family
TOPK = 8
ADD_SHARDS = 8                # shards appended by add_shards
DECODE_LEN = 1 << 16          # tokens of each decode_slice
GREEDY_GROUP = 128            # queries of one exact-budget greedy call
ANALYTICS_KERNELS = ("rank_build_levels", "wm_quantile_sharded", "bitpack",
                     "wm_level_step")
CRASH_GEN = 60                # the ingest crashes at the first commit from
#                               this generation on
SWAP_SHARDS = 8               # generations committed under the hot swap
READERS = 4                   # hot-swap reader threads
INDEX_INGEST_SHARDS = 16      # the index ingest: 2^24 tokens, widths kept
FE_BUCKETS = (8, 32, 128)
FE_CAPACITY = 256
FE_DEADLINE_S = 0.25
FE_TOPK = 8
FE_REQUESTS = 2000
FE_OVERLOADS = (1.0, 5.0)
FE_SAMPLE = 64                # exact front-end answers checked, per op
BREAKER_SHARD = 2
#: kernels each part of step 10 must launch (the checks' launches are
#: counted apart): the ingest builds matrices and indexes; serving builds
#: the hot swap's generations and answers exact quantiles
#: kernels each example's path launches; every other kernel must not
EXAMPLE_KERNELS = {
    "torch_quickstart": ("wt_level_step", "bitpack", "rank_build_levels",
                         "wm_level_step"),
    # the store's range counts run the count kernel
    "torch_corpus_analytics": ("wm_level_step", "rank_build_levels",
                               "wm_quantile_sharded", "wm_count"),
    "torch_corpus_search": ("radix_rank", "wm_level_step",
                            "rank_build_levels", "bitpack"),
    "torch_serve_decode": ("wm_level_step", "rank_build_levels"),
}
LM_ARCH = "qwen2_0_5b"
LM_PARAMS = 630_396_800
#: (batch, prompt, decode steps): the serve CLI's defaults, then a long
#: prompt that the prefill takes in four 512-query chunks
LM_SHAPES = ((4, 64, 32), (8, 2048, 128))
LM_TOL = 0.05                 # tests/test_models_smoke.py:163-186
LM_CHECK_DEPTH = 2
LM_CHECK_STEPS = 8
LM_MARGIN = 0.1
TRAIN_BATCH, TRAIN_SEQ = 8, 256   # launch/train.py's defaults
TRAIN_LR = 3e-4
TRAIN_STEPS, TRAIN_WARMUP = 20, 5
TRAIN_RESUME_AT = 10
TRAIN_ACCUM = 4
TRAIN_ACCUM_LR = 1e-3             # tests/test_train.py's accumulation case
TRAIN_COMPRESS_BITS, TRAIN_COMPRESS_STEPS = 6, 3
TRAIN_CHECK_SHAPE = (2, 64)       # batch, tokens a row of the depth-2 check
TRAIN_LOSS_DROP = 0.1             # tests/test_train.py::test_loss_decreases
TRAIN_WORDS_CHECK = 1 << 22       # leading elements of a vocabulary-sized
#                                   gradient whose words the CPU repacks
BF16_DENSE_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
#                                   (NVIDIA H100 Tensor Core GPU datasheet)
TRAIN_KERNELS = ("wm_level_step", "rank_build_levels", "bitpack")
DRYRUN_CELLS = (("qwen2_0_5b", "--both-meshes"),   # its four shapes
                ("dbrx_132b", "--shape", "decode_32k"),
                ("dbrx_132b", "--shape", "prefill_32k"),
                ("arctic_480b", "--shape", "prefill_32k"),
                ("jamba_v0_1_52b", "--shape", "train_4k", "--both-meshes"),
                ("arctic_480b", "--shape", "train_4k", "--both-meshes"),
                ("dbrx_132b", "--shape", "train_4k", "--multi-pod"),
                ("llama_3_2_vision_90b", "--shape", "train_4k",
                 "--multi-pod"))
#: the reference's per-device peak (argument + temp bytes) of a dry-run
#: cell: ``scripts/dryrun_reference_auto.py`` (``repro.launch.dryrun`` on
#: mesh axes of type Auto) under jax 0.9.0 on 512 host devices of a CPU;
#: the card's machine has no JAX to plan it again
REFERENCE_PEAK_BYTES = {"dbrx_132b__prefill_32k__16x16": 34824435184,
                        "arctic_480b__prefill_32k__16x16": 43545513208,
                        "qwen2_0_5b__train_4k__16x16": 4181040948,
                        "qwen2_0_5b__train_4k__2x16x16": 2191033436,
                        "jamba_v0_1_52b__train_4k__16x16": 20424699204,
                        "jamba_v0_1_52b__train_4k__2x16x16": 17415621844,
                        "arctic_480b__train_4k__16x16": 55431705396,
                        "arctic_480b__train_4k__2x16x16": 95192942924,
                        "dbrx_132b__train_4k__2x16x16": 25479634276,
                        "llama_3_2_vision_90b__train_4k__2x16x16":
                            32962499252,
                        # ``memory.peak_bytes`` of the trip-counted records
                        # (``results/dryrun_ref_trips/``)
                        "qwen2_0_5b__prefill_32k__16x16": 4840478384,
                        "qwen2_0_5b__prefill_32k__2x16x16": 2453788208}
REFERENCE_PEAK_RATIO = 1.5       # the port's peak at most this × the reference's
#: the reference's collective bytes a device a step, its loops' trips
#: counted (``scripts/dryrun_reference_trips.py``, committed in
#: ``results/dryrun_ref_trips/``; jax 0.9.0 on 512 host devices of a CPU)
REFERENCE_COLLECTIVE_BYTES = {"qwen2_0_5b__decode_32k__16x16": 723968,
                              "qwen2_0_5b__decode_32k__2x16x16": 361984,
                              "dbrx_132b__decode_32k__16x16": 86033086464,
                              "qwen2_0_5b__train_4k__16x16": 7789973760,
                              "qwen2_0_5b__train_4k__2x16x16": 6224253056,
                              "qwen2_0_5b__prefill_32k__16x16": 3240148992,
                              "qwen2_0_5b__prefill_32k__2x16x16": 1862597632,
                              "arctic_480b__prefill_32k__16x16": 366223834828}
REFERENCE_COLLECTIVE_RATIO = 1.5  # the port's collectives at most this ×
REFERENCE_COLLECTIVE_SLACK = 0.1e9   # or this much over, where the
REFERENCE_COLLECTIVE_SMALL = 0.2e9   # reference moves less than this
DRYRUN_QWEN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_TIMEOUT_S = 900           # the dry run's processes, from their start
MESH_HOST_STEPS = 5
DRYRUN_KERNELS = ("wm_level_step", "rank_build_levels", "wm_quantile_sharded")
PART_KERNELS = {"ingest": ("wm_level_step", "rank_build_levels",
                           "radix_rank", "bitpack"),
                "serving": ("wm_level_step", "rank_build_levels",
                            "wm_quantile_sharded", "wm_count")}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int, nops: int, latency_ms: float = 0.0) -> float:
    """The least time for the work: its bytes at the HBM rate, its int32
    operations at the peak rate, or its chain of dependent loads."""
    return max(nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_OPS_PER_S * 1e3,
               latency_ms)


def max_abs_err(got, want) -> int:
    """Largest absolute difference over matching tensors (exact = 0)."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            fail(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def bits_per_token(struct, n: int) -> float:
    """Stored bits of every tensor leaf per token."""
    from repro_torch.tree import tree_leaves
    return sum(x.numel() * x.element_size() * 8
               for x in tree_leaves(struct)) / n


def same_leaves(a, b, what: str) -> None:
    from repro_torch.tree import tree_named_leaves
    got, want = tree_named_leaves(a), tree_named_leaves(b)
    if got.keys() != want.keys():
        fail(f"{what}: leaves {sorted(got)} != {sorted(want)}")
    for name, leaf in want.items():
        if leaf.dtype != got[name].dtype or not torch.equal(leaf, got[name]):
            fail(f"{what}: differs at {name}")


def read_launches(path: str, kernels) -> dict:
    """Launch counts after a path's run; fails if one of its kernels never
    launched."""
    from repro_torch.kernels import build
    launches = dict(build.launches)
    print(f"{path} launches: {json.dumps(launches)}")
    missing = [name for name in kernels if launches[name] <= 0]
    if missing:
        fail(f"kernels not launched on the {path}: {missing}")
    return launches


def construction_phase(dev, toks: np.ndarray, seq: torch.Tensor, wt,
                       queries, answers) -> tuple[list, dict]:
    """Step 7: every other construction of the full stream ``seq`` (the
    card copy of ``toks``), each held against its fused counterpart (``wt``,
    the fused tree of step 5, or an unsharded fused matrix built here); the
    multiary queries against ``answers``, the binary tree's answers to
    ``queries``. Returns the rows of the ``construction`` line and each
    kernel's launches over the phase."""
    from repro_torch.core import bitops, huffman, multiary
    from repro_torch.core import wavelet_tree as wtree
    from repro_torch.core.wavelet_matrix import (
        build_wavelet_matrix, build_wavelet_matrix_levelwise)
    from repro_torch.kernels import build
    n = seq.shape[0]
    rows, totals = [], {k: 0 for k in build.launches}

    def form(name, fn, want=None, need=()):
        """Build one form: host seconds ending in a synchronize, peak
        device memory (and its rise over what was allocated before) and
        launch counts; fails if a kernel of ``need`` never launched or a
        count of ``want`` differs."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {k: v for k, v in build.launches.items() if v}
        for k, v in build.launches.items():
            totals[k] += v
        row = {"form": name, "s": dt, "peak_bytes": peak,
               "rise_bytes": peak - before,
               "bits_per_token": bits_per_token(out, n),
               "launches": launches}
        rows.append(row)
        print(f"construction {name}: {dt:.6f} s ({n / dt:.1f} tok/s), peak "
              f"device memory {peak} B ({peak / 2**30:.3f} GiB, "
              f"{(peak - before) / 2**30:.3f} GiB above the "
              f"{before / 2**30:.3f} GiB held before), "
              f"{row['bits_per_token']:.4f} stored bits/token, launches "
              f"{json.dumps(launches)}")
        missing = [k for k in need if build.launches[k] <= 0]
        if missing:
            fail(f"construction {name}: kernels not launched: {missing}")
        for k, v in (want or {}).items():
            if build.launches[k] != v:
                fail(f"construction {name}: {build.launches[k]} {k} "
                     f"launches, want {v}")
        return out

    # the tree's other forms, each against the fused tree of step 5
    tree_forms = (
        ("tree fused=False, compose big step",
         lambda: wtree.build_wavelet_tree(
             seq, SIGMA, tau=TAU, sample_rate=SAMPLE_RATE, fused=False,
             device=dev), {"radix_rank": 0}),
        # 256 buckets after chunk 0: a totals count and a scan; 65,536 after
        # chunk 1: past the kernel's bucket bound, the argsort route
        ("tree fused=False, radix big step",
         lambda: wtree.build_wavelet_tree(
             seq, SIGMA, tau=TAU, big_step="radix", sample_rate=SAMPLE_RATE,
             fused=False, device=dev), {"radix_rank": 2}),
        ("tree levelwise", lambda: wtree.build_wavelet_tree_levelwise(
            seq, SIGMA, sample_rate=SAMPLE_RATE, device=dev), None),
        ("tree levelwise fused=False",
         lambda: wtree.build_wavelet_tree_levelwise(
             seq, SIGMA, sample_rate=SAMPLE_RATE, fused=False, device=dev),
         None),
        (f"tree domain decomposition, P = {DD_CHUNKS}",
         lambda: wtree.build_wavelet_tree_dd(
             seq, SIGMA, DD_CHUNKS, sample_rate=SAMPLE_RATE, device=dev),
         None),
        (f"tree domain decomposition fused=False, P = {DD_CHUNKS}",
         lambda: wtree.build_wavelet_tree_dd(
             seq, SIGMA, DD_CHUNKS, sample_rate=SAMPLE_RATE, fused=False,
             device=dev), None))
    for name, fn, want in tree_forms:
        out = form(name, fn, want, need=("bitpack",))
        same_leaves(out, wt, f"{name} against the fused tree")
        del out
    print("construction: every tree form equals the fused tree leaf for leaf")

    # the matrix baselines, against one unsharded fused matrix
    wm = form("matrix fused, unsharded (compose big step)",
              lambda: build_wavelet_matrix(seq, SIGMA, tau=TAU,
                                           sample_rate=SAMPLE_RATE,
                                           device=dev),
              need=("wm_level_step", "rank_build_levels"))
    for name, fn, want in (
            ("matrix fused=False, radix big step",
             lambda: build_wavelet_matrix(
                 seq, SIGMA, tau=TAU, big_step="radix",
                 sample_rate=SAMPLE_RATE, fused=False, device=dev),
             {"radix_rank": 4}),
            ("matrix levelwise", lambda: build_wavelet_matrix_levelwise(
                seq, SIGMA, sample_rate=SAMPLE_RATE, device=dev), None)):
        out = form(name, fn, want, need=("bitpack",))
        same_leaves(out, wm, f"{name} against the fused matrix")
        del out
    del wm
    print("construction: both matrix baselines equal the unsharded fused "
          "matrix leaf for leaf")

    # multiary trees: both forms equal, queries equal the binary tree's
    for width in MULTIARY_WIDTHS:
        fused = form(f"multiary width {width}",
                     lambda: multiary.build_multiary_wavelet_tree(
                         seq, SIGMA, width=width, device=dev))
        scatter = form(f"multiary width {width} fused=False",
                       lambda: multiary.build_multiary_wavelet_tree(
                           seq, SIGMA, width=width, fused=False, device=dev))
        same_leaves(scatter, fused, f"multiary width {width}: the two forms")
        del scatter
        pos_t, sym_t, end_t, kk_t = queries
        rates, got = [], []
        for op, args in (("access", (pos_t,)), ("rank", (sym_t, end_t)),
                         ("select", (sym_t, kk_t))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = getattr(multiary, f"mwt_{op}")(fused, *args)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got.append(out.cpu().numpy())
            rates.append(f"{op} {dt * 1e3:.6f} ms")
        for op, g, want in zip(("access", "rank", "select"), got, answers):
            if not np.array_equal(g, want):
                fail(f"multiary width {width}: {int((g != want).sum())} of "
                     f"{NUM_QUERIES} {op} answers differ from the binary "
                     f"tree's")
        print(f"multiary width {width} ({fused.nlevels} levels): both forms "
              f"equal leaf for leaf; {NUM_QUERIES} each of access, rank and "
              f"select equal the binary tree's ({', '.join(rates)})")
        del fused

    # the Huffman-shaped tree of the stream's codebook
    t0 = time.perf_counter()
    codes, lengths, max_len = huffman.huffman_codebook(
        np.bincount(toks, minlength=SIGMA) + 1)
    t_book = time.perf_counter() - t0
    print(f"huffman codebook (host, numpy): sigma {SIGMA}, max_len {max_len}"
          f" in {t_book:.6f} s")
    if max_len > 32:
        fail(f"huffman max_len {max_len} > 32: the reference left-justifies "
             f"codewords in 32 bits")
    t0 = time.perf_counter()
    huffman._huffman_level_plans(codes, lengths, max_len)
    print(f"huffman level plans (host, a loop over sigma a level): "
          f"{time.perf_counter() - t0:.6f} s, inside the fused build's time "
          f"below")
    hf = form("huffman", lambda: huffman.build_huffman_wavelet_tree(
        seq, codes, lengths, max_len, device=dev), need=("bitpack",))
    hs = form("huffman fused=False",
              lambda: huffman.build_huffman_wavelet_tree(
                  seq, codes, lengths, max_len, fused=False, device=dev),
              need=("bitpack",))
    same_leaves(hs, hf, "huffman: the two forms")
    del hs
    total_bits = int(hf.total_bits)
    if total_bits != int(lengths.astype(np.int64)[toks].sum()):
        fail(f"huffman: {total_bits} bits, not the sum of the code lengths")
    rows[-2]["code_bits_per_token"] = rows[-1]["code_bits_per_token"] = (
        total_bits / n)
    print(f"huffman: both forms equal leaf for leaf (level bitmaps, rank "
          f"directories, active); max_len {max_len}, total_bits / n = "
          f"{total_bits / n:.6f} code bits a token (the balanced tree: "
          f"{wt.nbits} levels)")
    del hf
    m = HUFFMAN_CHECK_TOKENS
    head = huffman.build_huffman_wavelet_tree(seq[:m], codes, lengths,
                                              max_len, device=dev)
    t0 = time.perf_counter()
    levels = huffman.reference_huffman_levels(toks[:m].astype(np.int64),
                                              codes, lengths, max_len)
    t_oracle = time.perf_counter() - t0
    for l, want in enumerate(levels):
        got = bitops.unpack_bits(head.level(l).words, len(want))
        if (int(head.active[l]) != len(want)
                or not np.array_equal(got.cpu().numpy(), want)):
            fail(f"huffman: level {l} of the first {m} tokens differs from "
                 f"reference_huffman_levels")
    print(f"huffman: the first {m} tokens' {len(levels)} levels equal "
          f"reference_huffman_levels on the host ({t_oracle:.6f} s)")
    return rows, totals


def sliding_counts(seq: torch.Tensor, pats: torch.Tensor,
                   lens: torch.Tensor) -> torch.Tensor:
    """Occurrences of each pattern in ``seq`` by a plain sliding compare,
    sharing no code with the index: every window of length j + 1 is named
    by the dense rank of (its length-j prefix's name, its last token),
    from one ``torch.unique`` over the windows and the patterns together,
    and a pattern of length j counts the windows of its name. (B,)
    int64."""
    n = seq.numel()
    base = SIGMA + 1                    # above every token and the pad
    toks = seq.long()
    wid, pid = toks, pats[:, 0].long()  # names of length 1: the tokens
    out = torch.zeros(pats.shape[0], dtype=torch.long, device=seq.device)
    for j in range(1, pats.shape[1] + 1):
        names = base
        if j > 1:
            keys = torch.cat([wid[:n - j + 1] * base + toks[j - 1:],
                              pid * base + pats[:, j - 1].long()])
            _, inv = torch.unique(keys, return_inverse=True)
            wid, pid = inv[:n - j + 1], inv[n - j + 1:]
            names = int(inv.max()) + 1
        hist = torch.bincount(wid, minlength=names)
        out = torch.where(lens == j, hist[pid], out)
    return out


def index_kernel_rows(report, launches: dict, sa: torch.Tensor,
                      bwt: torch.Tensor, wm) -> None:
    """The kernel rows of the index path, each kernel at the shapes the
    index build gives it (128 rows of m = 2^20 + 1): ``radix_rank``
    without bucket starts on a byte of the suffix arrays, one
    ``wm_level_step`` of the matrix over the BWT, ``rank_build_levels``
    over its levels and ``bitpack`` of the marks; each against its plain
    version, timed, and reported with the index path's launches."""
    from repro_torch.core import bitops
    from repro_torch.kernels import bitpack, ops, radix_rank, rank_build
    from repro_torch.kernels import wm_level
    rows, m = sa.shape
    digits = (sa & 255).contiguous()
    got = ops.radix_rank(digits, 256)
    report("radix_rank", "src/repro_torch/kernels/csrc/radix_rank.cu",
           "src/repro/kernels/radix_rank.py:52",
           ["src/repro/kernels/radix_rank.py:79"], got,
           radix_rank.radix_rank_plain(digits, 256, m),
           cuda_ms(lambda: ops.radix_rank(digits, 256), 20),
           cuda_ms(lambda: radix_rank.radix_rank_plain(digits, 256, m), 3),
           digits.numel() * 8, digits.numel() * 8, path="index",
           path_launches=launches,
           library_ms=cuda_ms(lambda: torch.sort(digits, dim=-1,
                                                 stable=True), 20))
    nbits = wm.nbits
    keys = bitops.extract_field(bwt, nbits - TAU, TAU).to(torch.int32)
    totals = ops.wm_level_zeros(bwt, nbits)[:, 0]
    level_bits = (keys >> (TAU - 1)) & 1
    got = ops.wm_level_step(keys, TAU - 1, m, totals)
    report("wm_level_step", "src/repro_torch/kernels/csrc/wm_level.cu",
           "src/repro/kernels/wm_level.py:132",
           ["src/repro/kernels/wm_level.py:52",
            "src/repro/kernels/wm_level.py:166"], got,
           wm_level.wm_level_plain(keys, totals, TAU - 1, m),
           cuda_ms(lambda: ops.wm_level_step(keys, TAU - 1, m, totals), 20),
           cuda_ms(lambda: wm_level.wm_level_plain(keys, totals, TAU - 1,
                                                   m), 3),
           keys.numel() * 8 + got[1].numel() * 4 + got[2].numel() * 4,
           keys.numel() * 24, path="index", path_launches=launches,
           library_ms=cuda_ms(lambda: torch.sort(level_bits, dim=1,
                                                 stable=True), 20))
    del keys, level_bits
    words = wm.bitvectors.rank.words.reshape(-1, wm.bitvectors.rank.words
                                             .shape[-1])
    W = words.shape[1]
    got = ops.rank_build_levels(words, m)
    report("rank_build_levels", "src/repro_torch/kernels/csrc/rank_build.cu",
           "src/repro/kernels/rank_build.py:98",
           ["src/repro/kernels/rank_build.py:53"], got,
           rank_build.rank_build_levels_plain(words, W),
           cuda_ms(lambda: ops.rank_build_levels(words, m), 20),
           cuda_ms(lambda: rank_build.rank_build_levels_plain(words, W), 5),
           words.numel() * 4 + got[0].numel() * 4 + got[1].numel() * 2,
           words.numel() * 8, path="index", path_launches=launches)
    marks = (sa % INDEX_SAMPLE_RATE == 0).to(torch.int32)
    got = ops.bitpack(marks)
    report("bitpack", "src/repro_torch/kernels/csrc/bitpack.cu",
           "src/repro/kernels/bitpack.py:26", [], got,
           bitpack.bitpack_plain(marks, m),
           cuda_ms(lambda: ops.bitpack(marks), 20),
           cuda_ms(lambda: bitpack.bitpack_plain(marks, m), 3),
           marks.numel() * 4 + got.numel() * 4, marks.numel() * 2,
           path="index", path_launches=launches)


def index_phase(dev, toks: np.ndarray, seq: torch.Tensor, report):
    """Step 8: the full-text index of the stream ``toks`` (``seq`` its card
    copy) built through ``build_sharded_index``, checked against the plain
    build, the BWT decode of two shards, an on-card sliding compare and
    numpy, then counts, locates and degraded-mode bounds; ``report`` takes
    the index path's kernel rows (:func:`index_kernel_rows`). Returns the
    ``index`` line, each kernel's launches in the build and the index
    (step 9 verifies and repairs it)."""
    from repro_torch.core import wavelet_matrix as wmat
    from repro_torch.index import (bwt_decode, build_sharded_index,
                                   sample_patterns)
    from repro_torch.index import fm_index as fm_mod
    from repro_torch.index.bwt import (append_sentinel, bwt_from_sa,
                                       symbol_boundaries)
    from repro_torch.index.suffix_array import (_rank_bits, all_distinct,
                                                doubling_round,
                                                initial_ranks)
    from repro_torch.kernels import build
    from repro_torch.launch.index import naive_count, naive_count_degraded
    from repro_torch.tree import tree_named_leaves
    t_phase = time.perf_counter()
    n = seq.numel()
    size = 1 << SHARD_BITS
    args = dict(shard_bits=SHARD_BITS, sample_rate=INDEX_SAMPLE_RATE,
                tau=TAU, big_step="compose", bv_sample_rate=SAMPLE_RATE,
                seam_overlap=SEAM_OVERLAP, device=dev)

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # ---- 8.1 the build through the entry point -------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    build.reset_launches()
    idx, t_build = sync_time(lambda: build_sharded_index(toks, SIGMA,
                                                         **args))
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches("index path", INDEX_KERNELS)
    S, m = idx.num_shards, idx.shards.m
    print(f"index build: {n} tokens, {S} shards of {size} (m = {m}) in "
          f"{t_build:.6f} s ({n / t_build:.1f} tok/s, host tokens to "
          f"index), {idx.bits_per_token():.4f} bits/token; peak device "
          f"memory {peak} B ({peak / 2**30:.3f} GiB, "
          f"{(peak - before) / 2**30:.3f} GiB above the "
          f"{before / 2**30:.3f} GiB held before)")

    # ---- 8.2 where the build's time goes, the same work step by step ---
    sigma_work = SIGMA + 2             # shards over sigma + 1, then $
    parts = {}
    build.reset_launches()
    shards, parts["upload and pad"] = sync_time(
        lambda: torch.nn.functional.pad(
            torch.from_numpy(toks.astype(np.int32)).to(dev),
            (0, S * size - n), value=SIGMA).reshape(S, size))
    text = append_sentinel(shards)
    (sa, rank), parts["suffix array round 0 (symbols)"] = sync_time(
        lambda: initial_ranks(text, sigma_work))
    rounds, offset = 0, 1
    while offset < m:             # the loop of ``suffix_array``, timed
        (sa, rank), dt = sync_time(lambda: doubling_round(
            rank, offset, _rank_bits(m)))
        done, dt_sync = sync_time(lambda: all_distinct(sa, rank))
        rounds += 1
        parts[f"suffix array round {rounds} (offset {offset})"] = dt + dt_sync
        offset *= 2
        if done:
            break
    del rank
    sa_launches = build.launches["radix_rank"]
    bwt, parts["bwt gather"] = sync_time(lambda: bwt_from_sa(text,
                                                                     sa))
    C, parts["C table"] = sync_time(
        lambda: symbol_boundaries(text, sigma_work))
    wm, parts["wavelet matrix"] = sync_time(lambda: wmat.build_wavelet_matrix(
        bwt, SIGMA + 2, tau=TAU, sample_rate=SAMPLE_RATE, device=dev))
    (mark, samples), parts["marks and samples"] = sync_time(
        lambda: fm_mod.sample_directories(sa, INDEX_SAMPLE_RATE, True))
    steps = fm_mod.FMIndex(wm=wm, C=C, mark=mark, sa_sample=samples,
                           n=size, sigma=SIGMA + 1,
                           sample_rate=INDEX_SAMPLE_RATE)
    same_leaves(steps, idx.shards, "index: the build step by step against "
                "the entry point's")
    print(f"index build step by step (equal to the entry point's, leaf for "
          f"leaf): {json.dumps(parts)}; {rounds} doubling rounds, "
          f"{sa_launches} radix_rank launches in the suffix array")
    index_kernel_rows(report, launches, sa, bwt, wm)
    del text, sa, bwt, C, wm, mark, samples, steps, shards
    # 8-bit passes take the kernels, passes of at most 32 buckets the
    # vectorized route: 2 for the symbols, 4 a doubling round
    passes = 2 + 4 * rounds
    if launches["radix_rank"] != 2 * passes or sa_launches != 2 * passes:
        fail(f"index: {launches['radix_rank']} radix_rank launches in the "
             f"build, {sa_launches} step by step; want a totals count and "
             f"a scan for each of the 2 + 4 x {rounds} kernel passes "
             f"({2 * passes})")
    want = wmat.num_levels(SIGMA + 2) + 1
    if launches["wm_level_step"] != want:
        fail(f"index: {launches['wm_level_step']} wm_level_step launches, "
             f"want one a level and one totals count ({want})")

    # ---- 8.3 against the plain build on the card -----------------------
    plain, t_plain = sync_time(lambda: build_sharded_index(
        toks, SIGMA, use_kernels=False, **args))
    same_leaves(idx, plain, "index: kernel build against the plain build")
    del plain
    print(f"index build: bit-identical to the plain build on the card "
          f"(plain route {t_plain:.6f} s), leaf for leaf")

    # ---- 8.4 the BWT of two shards decodes to their tokens --------------
    for s in (0, S - 1):
        fm = idx.shard(s)
        bwt_s = wmat.wm_access(fm.wm, torch.arange(m, device=dev))
        t0 = time.perf_counter()
        dec = bwt_decode(bwt_s, fm.C)
        want_s = np.full(size, SIGMA, np.int64)
        chunk = toks[s * size:(s + 1) * size]
        want_s[:len(chunk)] = chunk
        if not np.array_equal(dec, want_s):
            fail(f"index: the BWT of shard {s} does not decode to its "
                 f"tokens")
        print(f"index: shard {s}'s BWT (read back by wm_access) decodes "
              f"to its {size} tokens ({time.perf_counter() - t0:.3f} s on "
              f"the host)")

    # ---- 8.5 count ------------------------------------------------------
    pats, lens = sample_patterns(toks, NUM_PATTERNS, PATTERN_LEN, pad=SIGMA,
                                 seed=3)
    pt, lt = torch.from_numpy(pats).to(dev), torch.from_numpy(lens).to(dev)
    counts, t_count = sync_time(lambda: idx.count(pt, lt))
    by_shard, t_by_shard = sync_time(lambda: idx.count_by_shard(pt, lt))
    seams, t_seams = sync_time(lambda: idx._seam_count(
        *idx._sanitize(pt, lt)))
    sliding, t_sliding = sync_time(lambda: sliding_counts(seq, pt, lt))
    if not torch.equal(counts.long(), sliding):
        bad = int((counts.long() != sliding).sum())
        fail(f"index: {bad} of {NUM_PATTERNS} counts differ from the "
             f"sliding compare")
    if not torch.equal(by_shard.sum(0) + seams, counts.long()):
        fail("index: count_by_shard summed plus the seam count is not count")
    toks64 = toks.astype(np.int64)
    stitch = min(SEAM_OVERLAP + 1, size)
    cnt_np = counts.cpu().numpy()
    for i in range(INDEX_NUMPY_CHECKS):
        want_c = naive_count(toks64, pats[i], int(lens[i]), size, stitch)
        if cnt_np[i] != want_c:
            fail(f"index: pattern {i} counts {cnt_np[i]}, numpy {want_c}")
    print(f"index count: {NUM_PATTERNS} patterns (lengths 1-{PATTERN_LEN}, "
          f"one in four random) in {t_count * 1e3:.6f} ms "
          f"({NUM_PATTERNS / t_count:.1f} patterns/s; count_by_shard "
          f"{t_by_shard * 1e3:.6f} ms, seams {t_seams * 1e3:.6f} ms); all "
          f"equal the sliding compare on the card ({t_sliding:.3f} s), "
          f"{INDEX_NUMPY_CHECKS} equal numpy; total hits "
          f"{int(counts.long().sum())}, {int((counts == 0).sum())} misses")

    # ---- 8.6 locate -----------------------------------------------------
    pos, t_locate = sync_time(lambda: idx.locate(pt, lt, LOCATE_HITS))
    p64 = pos.long()
    valid = p64 >= 0
    for j in range(PATTERN_LEN):
        used = valid & (j < lt.long())[:, None]
        at = seq[(p64 + j).clamp(0, n - 1)]
        if bool((used & ((p64 + j >= n) | (at != pt[:, j:j + 1]))).any()):
            fail(f"index locate: a hit does not match its pattern at "
                 f"offset {j}")
    per = torch.zeros((NUM_PATTERNS, S), dtype=torch.long, device=dev)
    per.scatter_add_(1, torch.where(valid, p64 >> SHARD_BITS, 0),
                     valid.long())
    if not torch.equal(per, by_shard.T.long().clamp(max=LOCATE_HITS)):
        fail(f"index locate: hits a (pattern, shard) are not min("
             f"{LOCATE_HITS}, its count)")
    print(f"index locate: {NUM_PATTERNS} patterns x <= {LOCATE_HITS} hits "
          f"a shard in {t_locate * 1e3:.6f} ms; {int(valid.sum())} hits, "
          f"every one a match, min({LOCATE_HITS}, count) a shard")

    # ---- 8.7 degraded mode ---------------------------------------------
    deg = idx.drop_shards(list(INDEX_DROP))
    (lower, upper, cov), t_bounds = sync_time(
        lambda: deg.count_bounds(pt, lt))
    avail = np.ones(S, bool)
    avail[list(INDEX_DROP)] = False
    lo_np = lower.cpu().numpy()
    for i in range(INDEX_NUMPY_CHECKS):
        want_d = naive_count_degraded(toks64, pats[i], int(lens[i]), size,
                                      stitch, avail)
        if lo_np[i] != want_d:
            fail(f"index degraded: pattern {i} lower bound {lo_np[i]}, "
                 f"numpy {want_d}")
    if not bool(((lower <= counts) & (counts <= upper)).all()):
        fail("index degraded: the bounds do not bracket the full count")
    if float(cov) != (S - len(INDEX_DROP)) / S:
        fail(f"index degraded: coverage {float(cov)}, want "
             f"{S - len(INDEX_DROP)}/{S}")
    print(f"index degraded mode: shards {list(INDEX_DROP)} dropped, "
          f"coverage {float(cov)}; count_bounds in {t_bounds * 1e3:.6f} ms; "
          f"{INDEX_NUMPY_CHECKS} lower bounds equal numpy, all {NUM_PATTERNS}"
          f" bracket the full count")

    leaf_bits = {name: x.numel() * x.element_size() * 8 / n
                 for name, x in tree_named_leaves(idx.shards).items()}
    report = {
        "tokens": n, "sigma": SIGMA, "shards": S, "shard_size": size,
        "m": m, "sample_rate": INDEX_SAMPLE_RATE,
        "bv_sample_rate": SAMPLE_RATE, "seam_overlap": SEAM_OVERLAP,
        "build_s": t_build, "plain_build_s": t_plain, "peak_bytes": peak,
        "rise_bytes": peak - before, "rounds": rounds,
        "bits_per_token": idx.bits_per_token(),
        "bits_per_token_by_leaf": leaf_bits,
        "build_parts_s": parts,
        "launches": {k: v for k, v in launches.items() if v},
        "patterns": NUM_PATTERNS, "pattern_len": PATTERN_LEN,
        "count_ms": t_count * 1e3, "count_by_shard_ms": t_by_shard * 1e3,
        "seam_count_ms": t_seams * 1e3, "locate_ms": t_locate * 1e3,
        "locate_hits": int(valid.sum()), "count_bounds_ms": t_bounds * 1e3,
        "sliding_compare_s": t_sliding, "coverage": float(cov),
        "phase_s": time.perf_counter() - t_phase}
    print(f"index: step 8 took {report['phase_s']:.3f} s on the host clock")
    del deg
    return report, launches, idx


def analytics_phase(dev, toks: np.ndarray, eng, idx, queries, quant, cnt):
    """Step 9: the rest of the analytics engine on step 4's engine ``eng``
    and queries (``quant``/``cnt`` its kernel quantiles and counts), the
    store, snapshots, verify and repair of the engine and of step 8's index
    ``idx``. Every check fails the run. Returns the ``analytics`` line and
    each kernel's launches in the step (the counts are read and set to 0
    around the repair whose launches are checked, and summed)."""
    import dataclasses
    import os
    import tempfile

    from repro_torch.analytics import (ShardedAnalytics,
                                       build_sharded_analytics,
                                       load_analytics, save_analytics)
    from repro_torch.analytics.engine import sharded_range_quantile
    from repro_torch.data import build_compressed_corpus, token_histogram
    from repro_torch.kernels import build
    from repro_torch.robust import (IntegrityError, repair_analytics,
                                    repair_sharded_index, verify_analytics,
                                    verify_sharded_index)
    from repro_torch.tree import tree_map
    t_phase = time.perf_counter()
    n = len(toks)
    size, S, nbits = eng.shard_size, eng.num_shards, eng.shards.nbits
    lo, hi, k, sym_lo, sym_hi = queries
    lo_t, hi_t, k_t, s0_t, s1_t = (torch.from_numpy(x).to(dev)
                                   for x in queries)
    Q, H = len(lo), HIST_QUERIES
    hl_t, hh_t = lo_t[:H], hi_t[:H]
    toks64 = toks.astype(np.int64)
    step_launches = {name: 0 for name in build.launches}
    build.reset_launches()

    def take_launches() -> dict:
        """This part's launches, added to the step's and set to 0."""
        got = dict(build.launches)
        for name, v in got.items():
            step_launches[name] += v
        build.reset_launches()
        return got

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def peak_timed(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out, t = timed(fn)
        return out, t, torch.cuda.max_memory_allocated() - before

    ops, report = {}, {}

    def op_line(name, t, q):
        ops[name] = {"s": t, "queries": q, "q_per_s": q / t}
        print(f"analytics {name}: {q} queries in {t * 1e3:.6f} ms "
              f"({q / t:.1f} q/s)")

    # ---- 9.1 brackets: each holds the kernel's exact quantile -----------
    live = quant >= 0
    for levels in BRACKET_LEVELS:
        (blo, bhi), t = timed(lambda: eng.range_quantile_bracket(
            lo_t, hi_t, k_t, levels))
        op_line(f"quantile_bracket_{levels}", t, Q)
        width = 1 << (nbits - min(levels, nbits))
        if not (bool(((blo <= quant) & (quant < bhi) & (bhi - blo == width)
                      )[live].all())
                and bool(((blo == -1) & (bhi == -1))[~live].all())):
            fail(f"analytics: brackets at {levels} levels do not hold the "
                 f"kernel's quantiles")
        if levels >= nbits and not (torch.equal(blo[live], quant[live])
                                    and torch.equal(bhi[live],
                                                    quant[live] + 1)):
            fail("analytics: the full-depth bracket is not [q, q + 1)")
    print(f"analytics: brackets at {list(BRACKET_LEVELS)} levels hold all "
          f"{Q} kernel quantiles, [q, q + 1) at {nbits}")

    # ---- 9.1 histogram family on the first HIST_QUERIES queries ---------
    hist, t = timed(lambda: eng.range_histogram(hl_t, hh_t))
    op_line("histogram", t, H)
    (tsyms, tcnts), t = timed(lambda: eng.range_topk(hl_t, hh_t, TOPK))
    op_line("topk", t, H)
    distinct, t = timed(lambda: eng.range_distinct(hl_t, hh_t))
    op_line("distinct", t, H)
    (hlow, unc, hcov), t = timed(lambda: eng.range_histogram_bounds(hl_t,
                                                                    hh_t))
    op_line("histogram_bounds", t, H)
    if hist.shape != (H, 1 << nbits) or not (torch.equal(hlow, hist)
                                             and int(unc.abs().sum()) == 0
                                             and bool((hcov == 1).all())):
        fail("analytics: histogram bounds of the full engine are not the "
             "histogram")
    want_top = topk_of(hist, TOPK)
    if not (torch.equal(tsyms, want_top[0]) and torch.equal(tcnts,
                                                            want_top[1])):
        fail("analytics: range_topk is not the histogram's top k")
    if not torch.equal(distinct, (hist > 0).sum(1).to(torch.int32)):
        fail("analytics: range_distinct is not the histogram's support")
    h_np = hist[:NUM_NUMPY_CHECKS].cpu().numpy()
    s_np, c_np = tsyms.cpu().numpy(), tcnts.cpu().numpy()
    d_np = distinct.cpu().numpy()
    for i in range(NUM_NUMPY_CHECKS):
        bc = np.bincount(toks64[lo[i]:hi[i]], minlength=1 << nbits)
        top = np.sort(bc[bc > 0])[::-1][:TOPK]
        s_i = s_np[i][s_np[i] >= 0]
        if not (np.array_equal(h_np[i], bc)
                and np.array_equal(c_np[i][:len(s_i)], top)
                and np.array_equal(bc[s_i], top)
                and d_np[i] == int((bc > 0).sum())):
            fail(f"analytics: query {i}: histogram, top-k or distinct "
                 f"differs from numpy")
    print(f"analytics: histogram, top-k and distinct of {H} queries agree; "
          f"{NUM_NUMPY_CHECKS} equal numpy's bincount")

    # ---- 9.1 greedy top-k on every query ---------------------------------
    # exact when the budget covers every node heavier than the k-th answer
    # (the reference's contract); at the default budget of k·(nbits+1)
    # pops it returns the heaviest symbols it reached: a prefix of the exact
    # answer, each symbol with its count
    (gsyms, gcnts), t = timed(lambda: eng.range_topk_greedy(lo_t, hi_t,
                                                            TOPK))
    op_line("topk_greedy", t, Q)
    found = (gsyms[:H] >= 0).sum(1)
    prefix = torch.arange(TOPK, device=dev)[None, :] < found[:, None]
    carried = torch.gather(hist, 1, gsyms[:H].long().clamp(min=0))
    if not (bool(((gcnts[:H] == tcnts) | ~prefix).all())
            and bool(((gcnts[:H] == 0) | prefix).all())
            and bool(((carried == gcnts[:H]) | ~prefix).all())):
        fail(f"analytics: greedy top-k at the default budget is not a "
             f"prefix of the exact top-k on the first {H} queries")
    short = int((gcnts[:H] != tcnts).any(1).sum())
    # every node a greedy pops before its k-th answer weighs at least the
    # k-th count: that many pops make it exact
    kth = tcnts[:, -1].clamp(min=1).long()[:, None]
    need = torch.zeros(H, dtype=torch.long, device=dev)
    for level in range(nbits + 1):
        weights = hist.reshape(H, 1 << level, -1).sum(-1)
        need += (weights >= kth).sum(1)
    order = torch.argsort(need)
    t_exact, budgets = 0.0, []
    for g in range(0, H, GREEDY_GROUP):
        sel = order[g:g + GREEDY_GROUP]
        budget = int(need[sel].max())
        (esyms, ecnts), t = timed(lambda: eng.range_topk_greedy(
            hl_t[sel], hh_t[sel], TOPK, budget=budget))
        t_exact += t
        budgets.append(budget)
        got = torch.gather(hist[sel], 1, esyms.long().clamp(min=0))
        if not (torch.equal(ecnts, tcnts[sel])
                and bool(((got == ecnts) | (esyms < 0)).all())):
            fail(f"analytics: greedy top-k at a budget of {budget} pops "
                 f"differs from the exact top-k")
    ops["topk_greedy_exact_budget"] = {"s": t_exact, "queries": H,
                                       "q_per_s": H / t_exact,
                                       "budgets": budgets}
    print(f"analytics: greedy top-k (default budget, pruned) of {Q} "
          f"queries; on the first {H} its counts are a prefix of the exact "
          f"top-k's, each symbol carrying its count, and {short} stop short "
          f"of k; with budgets covering every node of weight >= the k-th "
          f"count ({budgets} pops for groups of {GREEDY_GROUP}) all {H} "
          f"equal the exact top-k ({t_exact:.6f} s)")
    report["greedy_short_at_default_budget"] = short
    del carried, got

    # ---- 9.1 degraded mode ----------------------------------------------
    deg = eng.drop_shards(list(INDEX_DROP))
    cov, t = timed(lambda: deg.coverage(lo_t, hi_t))
    op_line("coverage", t, Q)
    glo, ghi = np.clip(lo, 0, n), np.clip(hi, 0, n)
    total = np.maximum(ghi - glo, 0)
    covered = total.copy()
    for s in INDEX_DROP:
        covered -= np.maximum(np.minimum(ghi, (s + 1) * size)
                              - np.maximum(glo, s * size), 0)
    want_cov = np.where(total > 0, covered.astype(np.float32)
                        / np.maximum(total, 1).astype(np.float32),
                        np.float32(1))
    if not np.array_equal(cov.cpu().numpy(), want_cov):
        fail("analytics degraded: coverage differs from numpy's")
    dcnt, t = timed(lambda: deg.range_count(lo_t, hi_t, s0_t, s1_t))
    op_line("degraded_count", t, Q)
    dq, t = timed(lambda: deg.range_quantile(lo_t, hi_t, k_t))
    op_line("degraded_quantile", t, Q)
    avail = np.ones(S, bool)
    avail[list(INDEX_DROP)] = False
    dc_np, dq_np = dcnt.cpu().numpy(), dq.cpu().numpy()
    for i in range(NUM_NUMPY_CHECKS):
        parts = [toks64[max(lo[i], s * size):min(hi[i], (s + 1) * size)]
                 for s in range(S) if avail[s]]
        sl = np.concatenate(parts)
        want_q = (int(np.partition(sl, min(k[i], len(sl) - 1))[
            min(k[i], len(sl) - 1)]) if len(sl) else -1)
        want_c = int(((sl >= sym_lo[i]) & (sl < sym_hi[i])).sum())
        if dq_np[i] != want_q or dc_np[i] != want_c:
            fail(f"analytics degraded: query {i}: quantile {dq_np[i]} "
                 f"(survivors {want_q}), count {dc_np[i]} ({want_c})")
    (clow, cup, ccov), t = timed(lambda: deg.range_count_bounds(
        lo_t, hi_t, s0_t, s1_t))
    op_line("count_bounds", t, Q)
    (dlow, dunc, _), t = timed(lambda: deg.range_histogram_bounds(hl_t,
                                                                  hh_t))
    op_line("degraded_histogram_bounds", t, H)
    if not (torch.equal(clow, dcnt) and bool(((clow <= cnt)
                                              & (cnt <= cup)).all())
            and torch.equal(ccov, cov)
            and bool(((dlow <= hist) & (hist <= dlow + dunc[:, None])
                      ).all())):
        fail("analytics degraded: the bounds do not bracket the full "
             "answers")
    print(f"analytics degraded mode: shards {list(INDEX_DROP)} dropped; "
          f"coverage of {Q} queries equals numpy's; {NUM_NUMPY_CHECKS} "
          f"counts and masked quantiles equal the survivors'; count bounds "
          f"bracket all {Q} counts, histogram bounds all {H} histograms")
    del deg, hist, hlow, dlow, dq, dcnt
    torch.cuda.empty_cache()

    # ---- 9.1 add_shards: the first S - K shards and K built alone -------
    K = ADD_SHARDS
    head = ShardedAnalytics(shards=tree_map(lambda x: x[:S - K], eng.shards),
                            n=(S - K) * size, sigma=eng.sigma,
                            shard_bits=eng.shard_bits)
    tail, t_tail = timed(lambda: build_sharded_analytics(
        toks[(S - K) * size:], eng.sigma, shard_bits=eng.shard_bits,
        tau=TAU, sample_rate=SAMPLE_RATE, device=dev))
    grown, t_add = timed(lambda: head.add_shards(tail.shards, n - (S - K)
                                                 * size))
    same_leaves(grown.shards, eng.shards, "add_shards against the engine")
    if not torch.equal(grown.range_quantile(lo_t, hi_t, k_t), quant):
        fail("add_shards: the grown engine's kernel quantiles differ from "
             "step 4's")
    print(f"analytics add_shards: {K} shards built alone in {t_tail:.6f} s, "
          f"appended to {S - K} in {t_add:.6f} s; equal to the engine leaf "
          f"for leaf, kernel quantiles equal step 4's")
    del head, tail, grown
    report["add_shards"] = {"shards": K, "build_s": t_tail, "append_s": t_add}
    report["engine_launches"] = take_launches()

    # ---- 9.2 the store ----------------------------------------------------
    corpus, t_store = timed(lambda: build_compressed_corpus(
        toks, eng.sigma, shard_bits=eng.shard_bits, tau=TAU,
        sample_rate=SAMPLE_RATE, device=dev))
    decode_t = 0.0
    for start in (12_345, 5 * size - 1000, (S // 2) * size - 30_000,
                  n - DECODE_LEN):
        start = min(start, n - DECODE_LEN)
        got, t = timed(lambda: corpus.decode_slice(start, DECODE_LEN))
        decode_t += t
        if not np.array_equal(got.cpu().numpy(),
                              toks[start:start + DECODE_LEN]):
            fail(f"store: decode_slice at {start} differs from the tokens")
    if not np.array_equal(token_histogram(corpus).cpu().numpy(),
                          np.bincount(toks64, minlength=eng.sigma)):
        fail("store: token_histogram differs from numpy's bincount")
    if corpus.raw_bits_per_token() != 32:
        fail("store: raw_bits_per_token is not 32")
    c_lo, c_hi = lo_t[:NUM_NUMPY_CHECKS], hi_t[:NUM_NUMPY_CHECKS]
    if not (torch.equal(corpus.range_histogram(c_lo, c_hi),
                        eng.range_histogram(c_lo, c_hi))
            and all(torch.equal(a, b) for a, b in zip(
                corpus.range_topk(c_lo, c_hi, TOPK),
                (tsyms[:NUM_NUMPY_CHECKS], tcnts[:NUM_NUMPY_CHECKS])))
            and torch.equal(corpus.range_distinct(c_lo, c_hi),
                            distinct[:NUM_NUMPY_CHECKS])):
        fail("store: range_topk, range_distinct or range_histogram differ "
             "from the engine's")
    print(f"store: built in {t_store:.6f} s; decode_slice of {DECODE_LEN} "
          f"tokens at 4 starts (two across a shard boundary) in "
          f"{decode_t * 1e3:.6f} ms equal the tokens; token_histogram "
          f"equals numpy; 32 raw bits a token; top-k, distinct and "
          f"histogram of {NUM_NUMPY_CHECKS} queries equal the engine's")
    report["store"] = {"build_s": t_store, "decode_slice_s": decode_t,
                       "decode_tokens": 4 * DECODE_LEN}
    del corpus
    torch.cuda.empty_cache()

    # ---- 9.3 snapshots ----------------------------------------------------
    rank_w = eng.shards.bitvectors.rank.words.shape[-1]
    rank_sb = eng.shards.bitvectors.rank.superblock.shape[-1]
    with tempfile.TemporaryDirectory() as tmp:
        step_dir, t_save = timed(lambda: save_analytics(
            eng, tmp, extra_meta={"corpus_seed": 0}))
        npz = step_dir / "arrays.npz"
        nbytes = npz.stat().st_size + (step_dir / "meta.json").stat().st_size
        back, t_load = timed(lambda: load_analytics(tmp, device=dev))
        same_leaves(back.shards, eng.shards, "snapshot round trip")
        if not torch.equal(back.range_quantile(lo_t, hi_t, k_t), quant):
            fail("snapshot: the restored engine's kernel quantiles differ "
                 "from step 4's")
        del back
        take_launches()

        def flip(key: str, index) -> None:
            with np.load(npz) as z:
                arrays = {name: z[name] for name in z.files}
            arrays[key][index] ^= 1 << 5
            np.savez(npz, **arrays)

        sb_entry = (7, 4, rank_sb // 2)
        flip(".bitvectors/.rank/.superblock", sb_entry)
        healed, t_heal = timed(lambda: load_analytics(tmp, device=dev))
        heal_launches = take_launches()
        if heal_launches["rank_build_levels"] != 1:
            fail(f"snapshot: the derived-leaf repair launched "
                 f"rank_build_levels {heal_launches['rank_build_levels']} "
                 f"times, want 1 (all {S * nbits} rows at once)")
        same_leaves(healed.shards, eng.shards, "snapshot superblock repair")
        if not torch.equal(healed.range_quantile(lo_t, hi_t, k_t), quant):
            fail("snapshot: the repaired engine's kernel quantiles differ")
        del healed
        flip(".bitvectors/.rank/.superblock", sb_entry)
        flip(".bitvectors/.rank/.words", (S - 3, 11, rank_w // 3))
        try:
            load_analytics(tmp, device=dev)
        except IntegrityError as err:
            if err.bad_keys != [".bitvectors/.rank/.words"]:
                fail(f"snapshot: the primary flip names {err.bad_keys}")
        else:
            fail("snapshot: a flipped bitmap bit loaded without an "
                 "IntegrityError")
    print(f"snapshot: saved {nbytes} B in {t_save:.6f} s, loaded in "
          f"{t_load:.6f} s, equal leaf for leaf, kernel quantiles equal "
          f"step 4's; a superblock bit flipped in the file repaired in "
          f"{t_heal:.6f} s with 1 rank_build_levels launch, bit-identical; "
          f"a bitmap bit flipped raises IntegrityError naming "
          f".bitvectors/.rank/.words")
    report["snapshot"] = {"bytes": nbytes, "save_s": t_save,
                          "load_s": t_load, "repair_load_s": t_heal,
                          "repair_launches": heal_launches}

    # ---- 9.4 verify and repair --------------------------------------------
    rep, t_verify = timed(lambda: verify_analytics(eng))
    if not rep.ok:
        fail(f"verify: the engine is not clean: {rep.summary()}")
    rank = eng.shards.bitvectors.rank
    block = rank.block.clone()
    block[5, 6, block.shape[-1] // 2] += 3
    bad = dataclasses.replace(eng, quantile=None, shards=dataclasses.replace(
        eng.shards, bitvectors=dataclasses.replace(
            eng.shards.bitvectors, rank=dataclasses.replace(rank,
                                                            block=block))))
    rep = verify_analytics(bad)
    if [v.structure for v in rep.violations] != [
            "shard5/level6.rank.block"] or not rep.repairable:
        fail(f"verify: the changed block is not named: {rep.summary()}")
    take_launches()
    fixed, t_repair, peak_repair = peak_timed(lambda: repair_analytics(bad))
    repair_launches = take_launches()
    if repair_launches["rank_build_levels"] != 1:
        fail(f"repair_analytics launched rank_build_levels "
             f"{repair_launches['rank_build_levels']} times, want 1")
    same_leaves(fixed.shards, eng.shards, "repair_analytics")
    got = fixed.range_quantile(lo_t, hi_t, k_t)
    if build.launches["wm_quantile_sharded"] != 1 or not (
            torch.equal(got, sharded_range_quantile(
                fixed.shards, eng.shard_bits, n, lo_t, hi_t, k_t))
            and torch.equal(got, quant)):
        fail("repair_analytics: the repaired engine's kernel quantiles "
             "differ from the plain descent")
    del bad, fixed, block
    print(f"verify: the engine is clean ({t_verify:.6f} s on the host); a "
          f"block entry of shard 5 changed on the card is named, "
          f"repaired in {t_repair:.6f} s (peak rise {peak_repair} B, 1 "
          f"rank_build_levels launch) leaf for leaf; the repaired engine's "
          f"kernel quantiles equal the plain descent")
    rep, t_iverify = timed(lambda: verify_sharded_index(idx))
    if not rep.ok:
        fail(f"verify: the index is not clean: {rep.summary()}")
    index_repairs = {}
    for deep in (False, True):
        take_launches()
        fixed, t, peak = peak_timed(lambda: repair_sharded_index(idx,
                                                                 deep=deep))
        got = take_launches()
        same_leaves(fixed.shards, idx.shards,
                    f"repair_sharded_index(deep={deep})")
        if got["rank_build_levels"] < 1 or (deep and got["bitpack"] < 1):
            fail(f"repair_sharded_index(deep={deep}) launched {got}")
        index_repairs["deep" if deep else "shallow"] = {
            "s": t, "peak_rise_bytes": peak, "launches": got}
        print(f"index repair (deep={deep}): {t:.6f} s, peak rise {peak} B, "
              f"launches {json.dumps(got)}; equal to the index leaf for "
              f"leaf")
        del fixed
    print(f"verify: the index is clean ({t_iverify:.6f} s)")
    report.update({
        "tokens": n, "shards": S, "queries": Q, "histogram_queries": H,
        "topk": TOPK, "ops": ops, "verify_engine_s": t_verify,
        "repair_engine_s": t_repair, "repair_engine_peak_rise_bytes":
        peak_repair, "repair_engine_launches": repair_launches,
        "verify_index_s": t_iverify, "index_repairs": index_repairs})
    take_launches()
    launches = step_launches
    print(f"analytics step launches: {json.dumps(launches)}")
    missing = [name for name in ANALYTICS_KERNELS if launches[name] <= 0]
    if missing:
        fail(f"kernels not launched in step 9: {missing}")
    report["launches"] = {name: v for name, v in launches.items() if v}
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"analytics: step 9 took {report['phase_s']:.3f} s on the host "
          f"clock")
    return report, launches


def ingest_serving_phase(dev, toks: np.ndarray, seq: torch.Tensor, eng,
                         queries, quant):
    """Step 10: crash-safe ingest and the query front-end at full width,
    on step 4's stream, engine ``eng``, queries and kernel quantiles
    ``quant``, and ``seq`` (the stream on the card, the front-end's
    oracle). Every check fails the run. Returns the ``ingest`` and
    ``serving`` lines and each kernel's launches in the ingest and in the
    serving parts (the counts are read and set to 0 at each part's
    edges; the checks' launches go to a third part, ``check``)."""
    import tempfile
    import threading

    from repro_torch.index import build_sharded_index
    from repro_torch.ingest import (GenerationServer, analytics_ingester,
                                    index_ingester)
    from repro_torch.kernels import build, ops
    from repro_torch.launch import frontend as fe_cli
    from repro_torch.robust import (CrashInjected, FakeClock, crash_after,
                                    inject_shard_latency, trees_identical,
                                    verify_manifest)
    from repro_torch.serving import (FrontendConfig, QueryFrontend,
                                     ShedError)
    t_phase = time.perf_counter()
    n = len(toks)
    size = 1 << SHARD_BITS
    num_shards = n // size
    lo, hi, k = queries
    lo_t, hi_t, k_t = (torch.from_numpy(x).to(dev) for x in queries)
    launches = {part: {name: 0 for name in build.launches}
                for part in ("ingest", "serving", "check")}
    build.reset_launches()

    def take_launches(part: str) -> dict:
        """The launches since the last call, added to ``part``'s."""
        got = dict(build.launches)
        for name, v in got.items():
            launches[part][name] += v
        build.reset_launches()
        return got

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def batches(start: int, stop: int, seed: int):
        """Ragged [a, b) batches over [start, stop): no inner edge falls
        on a shard edge."""
        rng = np.random.default_rng(seed)
        cuts = [start]
        while cuts[-1] < stop:
            nxt = cuts[-1] + int(rng.integers(size // 3, 3 * size))
            nxt += nxt % size == 0
            cuts.append(min(stop, nxt))
        return list(zip(cuts[:-1], cuts[1:]))

    ingest, serving = {}, {}
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_ingest_")
    root = Path(work.name)
    try:
        # ---- 10.1 ingest the first S - K shards, a crash in the middle --
        d = root / "analytics"

        def make():
            return analytics_ingester(d, SIGMA, shard_bits=SHARD_BITS,
                                      tau=TAU, sample_rate=SAMPLE_RATE,
                                      device=dev)

        first = (num_shards - SWAP_SHARDS) * size
        ing = make()
        ing.recover()
        fed, crashed = 0, None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a, b in batches(0, first, 10):
            if (crashed is None and ing.next_gen >= CRASH_GEN
                    and ing.buffered_tokens + b - a >= size):
                crashed = ing.next_gen
                try:
                    with crash_after("rename"):
                        ing.append_tokens(toks[a:b])
                except CrashInjected:
                    fed += b - a
                    break
                fail(f"ingest: no crash after the rename of gen {crashed}")
            ing.append_tokens(toks[a:b])
            fed += b - a
        t_crash = time.perf_counter() - t0
        commit_first = dict(ing.commit_seconds)
        ing = make()                            # a new process: replay
        rep, t_recover = timed(ing.recover)
        if (rep.aborted != [crashed] or rep.resume_offset != crashed * size
                or rep.committed != list(range(crashed))):
            fail(f"ingest: recovery after the crash at gen {crashed}: "
                 f"{rep.summary()}")
        print(f"ingest: crash after the rename of gen {crashed}; "
              f"{rep.summary()} in {t_recover:.6f} s")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a, b in batches(rep.resume_offset, first, 11):
            ing.append_tokens(toks[a:b])
            fed += b - a
        torch.cuda.synchronize()
        t_ingest = t_crash + time.perf_counter() - t0
        commit_first = {part: v + ing.commit_seconds[part]
                        for part, v in commit_first.items()}
        resumed = dict(ing.commit_seconds)
        eng0, t_load0 = timed(ing.engine)
        if eng0.n != first or eng0.num_shards != num_shards - SWAP_SHARDS:
            fail(f"ingest: {eng0.num_shards} shards, n {eng0.n} after "
                 f"{first} tokens")
        print(f"ingest: {first} tokens ({num_shards - SWAP_SHARDS} "
              f"generations committed, {fed} fed with the replay after the "
              f"crash) in {t_ingest:.6f} s ({first / t_ingest:.1f} tok/s); "
              f"commit parts (s) {json.dumps(commit_first)}; engine "
              f"loaded in {t_load0:.6f} s")
        ingest.update({"tokens": first, "tokens_fed": fed,
                       "crashed_gen": crashed, "ingest_s": t_ingest,
                       "tokens_per_s": first / t_ingest,
                       "recover_s": t_recover})
        take_launches("ingest")

        # ---- 10.3 hot swap: commit the last K, swap under readers --------
        srv = GenerationServer(eng0)
        r_lo, r_hi, r_k = lo_t, hi_t, k_t
        oracle = {0: eng0.range_quantile(r_lo, r_hi, r_k), 1: quant}
        take_launches("check")
        if torch.equal(oracle[0], oracle[1]):
            fail("hot swap: the two generations' oracles do not differ")
        done = threading.Event()
        errors, seen = [], {0: 0, 1: 0}
        seen_lock = threading.Lock()

        def reader():
            try:
                while not done.is_set():
                    with srv.session() as (gen, e):
                        got = e.range_quantile(r_lo, r_hi, r_k)
                        same = torch.equal(got, oracle[gen])
                    with seen_lock:
                        seen[gen] += 1
                    if not same:
                        errors.append(gen)
            except BaseException as e:          # handed to the main thread
                errors.append(e)

        threads = [threading.Thread(target=reader, name=f"reader-{i}",
                                    daemon=True) for i in range(READERS)]
        for t in threads:
            t.start()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for a, b in batches(first, n, 12):
                ing.append_tokens(toks[a:b])
            ing.flush()
            new = ing.serve_entries()[-SWAP_SHARDS:]
            nxt = srv.engine.add_shards(ing.stack(new), n - first)
            torch.cuda.synchronize()
            t_commit = time.perf_counter() - t0
            t0 = time.perf_counter()
            srv.swap_generation(nxt, wait_drain=True, timeout_s=60)
            t_pause = time.perf_counter() - t0
            # the readers go on until each had a few batches of the new one
            t0 = time.perf_counter()
            while seen[1] < 4 * READERS and not errors \
                    and time.perf_counter() - t0 < 60:
                time.sleep(0.01)
        finally:
            done.set()
            for t in threads:
                t.join(120)
        if any(t.is_alive() for t in threads):
            fail("hot swap: a reader did not finish")
        bad = [e for e in errors if not isinstance(e, int)]
        if bad:
            raise bad[0]
        if errors:
            fail(f"hot swap: {len(errors)} batches equal no generation's "
                 f"oracle (generations {sorted(set(errors))})")
        if min(seen.values()) < 1:
            fail(f"hot swap: batches by generation {seen}")
        print(f"hot swap: {SWAP_SHARDS} generations committed and appended "
              f"in {t_commit:.6f} s under {READERS} reader threads; swap "
              f"pause (fenced drain) {t_pause:.6f} s; {sum(seen.values())} "
              f"quantile batches, by generation {seen}, each equal to its "
              f"generation's oracle in whole")
        serving["hot_swap"] = {"commit_append_s": t_commit,
                               "swap_pause_s": t_pause, "readers": READERS,
                               "batches": seen}
        take_launches("serving")

        # ---- 10.1 the whole stream against step 4's engine ---------------
        full, t_load = timed(ing.engine)
        if full.n != n or not trees_identical(full.shards, eng.shards):
            fail("ingest: the ingested engine differs from step 4's")
        if not trees_identical(srv.engine.shards, eng.shards):
            fail("hot swap: the swapped engine differs from step 4's")
        take_launches("ingest")
        got, t_q = timed(lambda: full.range_quantile(lo_t, hi_t, k_t))
        take_launches("check")
        if not torch.equal(got, quant):
            fail(f"ingest: {int((got != quant).sum())} kernel quantiles "
                 f"differ from step 4's")
        report, t_verify = timed(lambda: verify_manifest(d))
        if not report.ok:
            fail(f"ingest: verify_manifest: {report.summary()}")
        disk = sum(p.stat().st_size for p in d.rglob("*") if p.is_file())
        commit = {part: v - resumed[part]
                  for part, v in ing.commit_seconds.items()}
        print(f"ingest: the {num_shards} generations equal step 4's engine "
              f"leaf for leaf, and their {len(lo)} kernel quantiles step "
              f"4's ({t_q * 1e3:.6f} ms); loaded in {t_load:.6f} s; "
              f"verify_manifest clean ({t_verify:.6f} s); {disk} B on disk")
        ingest.update({"commit_s": commit_first,
                       "swap_commit_s": commit, "load_s": t_load,
                       "load_first_s": t_load0, "verify_manifest_s":
                       t_verify, "bytes_on_disk": disk,
                       "generations": ing.next_gen, "quantile_s": t_q})
        del eng0, srv, nxt, oracle
        take_launches("ingest")

        # ---- 10.2 index ingest of the first shards -----------------------
        m = INDEX_INGEST_SHARDS * size
        iing = index_ingester(root / "index", SIGMA, shard_bits=SHARD_BITS,
                              sample_rate=INDEX_SAMPLE_RATE,
                              seam_overlap=SEAM_OVERLAP, device=dev)
        iing.recover()

        def index_feed():
            for a, b in batches(0, m, 13):
                iing.append_tokens(toks[a:b])
            iing.flush()

        _, t_iingest = timed(index_feed)
        ieng, t_iload = timed(iing.engine)
        index_launches = take_launches("ingest")
        ref, t_iref = timed(lambda: build_sharded_index(
            toks[:m], SIGMA, shard_bits=SHARD_BITS,
            sample_rate=INDEX_SAMPLE_RATE, seam_overlap=SEAM_OVERLAP,
            device=dev))
        take_launches("check")
        if (ieng.n != m or not trees_identical(ieng.shards, ref.shards)
                or not torch.equal(ieng.seam_windows, ref.seam_windows)):
            fail("index ingest: differs from build_sharded_index")
        print(f"index ingest: {m} tokens, {INDEX_INGEST_SHARDS} shards in "
              f"{t_iingest:.6f} s ({m / t_iingest:.1f} tok/s; commit parts "
              f"{json.dumps(iing.commit_seconds)}), loaded in "
              f"{t_iload:.6f} s; equal to build_sharded_index "
              f"({t_iref:.6f} s) leaf for leaf, seam windows included")
        ingest["index"] = {"tokens": m, "shards": INDEX_INGEST_SHARDS,
                           "ingest_s": t_iingest, "load_s": t_iload,
                           "build_sharded_index_s": t_iref,
                           "commit_s": iing.commit_seconds,
                           "launches": {name: v for name, v in
                                        index_launches.items() if v}}
        del ieng, ref
    finally:
        work.cleanup()

    # ---- 10.4 the front-end on the system clock --------------------------
    trace = fe_cli.make_trace(n, FE_REQUESTS, 0, base_qps=200.0,
                              burst_qps=2000.0, burst_every_s=2.0,
                              burst_len_s=0.5, deadline_s=FE_DEADLINE_S,
                              topk_k=FE_TOPK)
    runs = {}
    for overload in FE_OVERLOADS:
        fe = QueryFrontend(GenerationServer(full), config=FrontendConfig(
            buckets=FE_BUCKETS, capacity=FE_CAPACITY,
            default_deadline_s=FE_DEADLINE_S, topk_k=FE_TOPK,
            breaker=fe_cli.CLI_BREAKER))
        t0 = time.perf_counter()
        steady = fe_cli.warm_up(fe, n, SIGMA)
        t_warm = time.perf_counter() - t0
        take_launches("serving")
        # a breaker probe is one quantile launch too: count them apart
        probes, probe = [0], fe.breakers._probe

        def counted(s, probe=probe, probes=probes):
            probes[0] += 1                      # hedged: one at a time
            return probe(s)

        fe.breakers._probe = counted
        fe.start()
        t0 = time.perf_counter()
        try:
            results = fe_cli.collect(fe_cli.drive(fe, trace, overload,
                                                  SIGMA))
            wall = time.perf_counter() - t0
        finally:
            fe.stop(drain=True)
        out = fe_cli.report(fe, trace, results, wall)
        st = fe.stats()
        drive_launches = take_launches("serving")
        if st["submitted"] != st["served"] + st["total_shed"] + st["queued"]:
            fail(f"front-end x{overload}: accounting {st}")
        if out["served"] + out["shed"] != len(trace):
            fail(f"front-end x{overload}: {out['served']} served and "
                 f"{out['shed']} shed of {len(trace)}")
        exact_q = sum(ev["op"] == "quantile" and not isinstance(a, ShedError)
                      and a.mode == "exact" and a.coverage == 1.0
                      for ev, a in zip(trace, results))
        query_launches = drive_launches["wm_quantile_sharded"] - probes[0]
        if exact_q and query_launches < 1:
            fail(f"front-end x{overload}: {exact_q} exact quantiles served "
                 f"and no wm_quantile_sharded launch but the probes'")
        checked = check_frontend_answers(full, seq, trace, results)
        take_launches("check")
        out.update({"warmup_s": t_warm, "steady_batch_s": steady,
                    "wall_s": wall, "checked": checked, "probes": probes[0],
                    "exact_quantiles": exact_q,
                    "quantile_query_launches": query_launches,
                    "launches": {k_: v for k_, v in drive_launches.items()
                                 if v}})
        runs[f"x{overload:g}"] = out
        print(f"front-end x{overload:g}: warm-up {t_warm:.3f} s (steady "
              f"batch {steady * 1e3:.3f} ms); offered {out['offered']}, "
              f"served {out['served']}, shed {out['shed']} "
              f"{json.dumps(out['shed_reasons'])}, degraded "
              f"{out['degraded']}, deadline misses {out['deadline_misses']},"
              f" {out['qps']:.1f} q/s, p50 {out['p50_ms']:.3f} ms, p99 "
              f"{out['p99_ms']:.3f} ms, final level {out['final_level']}")
        for op, o in out["per_op"].items():
            print(f"  {op}: offered {o['offered']}, served {o['served']}, "
                  f"shed {json.dumps(o['shed_reasons'])}, degraded "
                  f"{o['degraded']}, deadline misses "
                  f"{o['deadline_misses']}, {o['qps']:.1f} q/s, p50 "
                  f"{o['p50_ms']:.3f} ms, p99 {o['p99_ms']:.3f} ms")
        print(f"  checked: {json.dumps(checked)}; launches "
              f"{json.dumps(out['launches'])} ({probes[0]} of the "
              f"quantile launches breaker probes, {query_launches} for "
              f"{exact_q} exact quantiles)")
    serving["frontend"] = runs
    if sum(r["quantile_query_launches"] for r in runs.values()) < 1:
        fail("front-end: no exact quantile launched wm_quantile_sharded")

    # ---- 10.5 breakers on a FakeClock at full width ----------------------
    clock = FakeClock()
    fe = QueryFrontend(GenerationServer(full), clock=clock,
                       config=FrontendConfig(buckets=FE_BUCKETS,
                                             capacity=FE_CAPACITY,
                                             topk_k=FE_TOPK,
                                             probe_shards=True))
    try:
        t0 = time.perf_counter()
        with inject_shard_latency(BREAKER_SHARD, 9.0):
            for _ in range(fe.config.breaker.fail_threshold):
                fe.submit("count", 0, n, deadline_s=1e6)
                fe.pump()
        if fe.stats()["open_breakers"] != [BREAKER_SHARD]:
            fail(f"breakers: open {fe.stats()['open_breakers']}")
        b_lo, b_hi, b_k = (x[:FE_BUCKETS[0]].copy() for x in (lo, hi, k))
        b_lo[0], b_hi[0], b_k[0] = 0, n, n // 2     # covers shard 2
        tc = [fe.submit("count", int(a), int(b), deadline_s=1e6)
              for a, b in zip(b_lo, b_hi)]
        tq = [fe.submit("quantile", int(a), int(b), k=int(c),
                        deadline_s=1e6) for a, b, c in zip(b_lo, b_hi, b_k)]
        while fe.pump():
            pass
        take_launches("serving")
        dropped = full.drop_shards([BREAKER_SHARD])
        want_c = dropped.range_count(b_lo, b_hi, 0, SIGMA).tolist()
        want_q = dropped.range_quantile(b_lo, b_hi, b_k).tolist()
        want_cov = dropped.coverage(b_lo, b_hi).tolist()
        take_launches("check")
        ac, aq = [t.result(0) for t in tc], [t.result(0) for t in tq]
        if ([a.value for a in ac] != want_c
                or [a.value for a in aq] != want_q
                or [a.coverage for a in ac] != want_cov
                or not ac[0].coverage < 1.0 or not ac[0].degraded):
            fail("breakers: answers differ from the drop_shards oracle")
        clock.advance(fe.config.breaker.reset_after_s + 1)
        fe.submit("count", 0, n, deadline_s=1e6)
        fe.pump()
        if fe.stats()["open_breakers"]:
            fail(f"breakers: still open {fe.stats()['open_breakers']} past "
                 f"the reset window")
        t_breakers = time.perf_counter() - t0
    finally:
        fe.breakers.close_pool()
    print(f"breakers: shard {BREAKER_SHARD} stalled 9 s on a FakeClock "
          f"opens after {fe.config.breaker.fail_threshold} probes; "
          f"{len(tc)} counts and {len(tq)} quantiles equal the "
          f"drop_shards([{BREAKER_SHARD}]) oracle (coverage "
          f"{ac[0].coverage:.6f} on the whole stream); the half-open probe "
          f"closes it past the reset window ({t_breakers:.3f} s host time)")
    serving["breakers"] = {"shard": BREAKER_SHARD, "s": t_breakers,
                           "coverage_whole_stream": ac[0].coverage}
    take_launches("serving")
    del full
    for part, line in (("ingest", ingest), ("serving", serving)):
        missing = [name for name in PART_KERNELS[part]
                   if launches[part][name] <= 0]
        if missing:
            fail(f"kernels not launched in step 10's {part}: {missing}")
        line["launches_total"] = {name: v for name, v in
                                  launches[part].items() if v}
    ingest["check_launches"] = {name: v for name, v in
                                launches["check"].items() if v}
    ingest["phase_s"] = serving["phase_s"] = time.perf_counter() - t_phase
    print(f"ingest and serving: step 10 took {ingest['phase_s']:.3f} s on "
          f"the host clock")
    return ingest, serving, launches["ingest"], launches["serving"]


#: the __global__ functions each launch counter covers, as a trace names them
FE_GATE_RUNS = 3
FE_GATE_OVERLOAD = 5.0
FE_GATE_SLO = "frontend.*:p99_ms<=250"   # scripts/ci_torch.sh's gate
FE_GATE_KERNELS = ("wm_count", "topk_greedy", "wm_quantile_sharded")


def frontend_gate_phase(dev) -> tuple[dict, dict]:
    """Step 10b: ``launch.frontend --smoke --overload 5`` three times
    through the CLI's own ``run`` (``launch.profile_frontend.run_trace``:
    the CLI's engine, trace, warm-up, paced drive, answer and accounting
    checks, its batches recorded), each captured with metrics on
    (``--metrics-dir``) and put through ``scripts/ci_torch.sh``'s
    gate (``launch.obs`` with ``--slo 'frontend.*:p99_ms<=250'``). Fails if
    a run misses the gate. Prints each op's p50, p99, batch ms and the
    port's kernel launches a batch. The launch counts are zeroed before the
    three runs and read after: the count and greedy top-k kernels (and the
    quantile's) must have launched."""
    import contextlib
    import io
    from repro_torch import obs
    from repro_torch.kernels import build
    from repro_torch.launch import frontend as fe_cli
    from repro_torch.launch import obs as obs_cli
    from repro_torch.launch import profile_frontend as pf

    args = pf.smoke_args(str(dev), FE_GATE_OVERLOAD)
    toks, eng = fe_cli.build_engine(args)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_frontend_gate_"))
    torch.cuda.synchronize()
    build.reset_launches()
    runs = []
    try:
        for i in range(FE_GATE_RUNS):
            args.metrics_dir = str(work / f"run{i + 1}")
            obs.REGISTRY.reset()
            try:
                run = pf.run_trace(args, toks, eng)
            finally:
                obs.configure(None)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = obs_cli.main([args.metrics_dir, "--slo", FE_GATE_SLO])
            table = pf._batch_table(run["batches"])
            s = run["summary"]
            per_op = {}
            for op, o in s["per_op"].items():
                rows = [r for r in table if r["op"] == op]
                n_b = sum(r["batches"] for r in rows)
                per_op[op] = {
                    "served": o["served"], "p50_ms": o["p50_ms"],
                    "p99_ms": o["p99_ms"],
                    "batch_ms_median": (float(np.median(
                        [b["batch_ms"] for b in run["batches"]
                         if b["op"] == op and "batch_ms" in b]))
                        if n_b else None),
                    "kernel_launches_a_batch": (sum(
                        r["kernel_launches_a_batch"] * r["batches"]
                        for r in rows) / n_b if n_b else None)}
            runs.append({"gate_rc": rc, "served": s["served"],
                         "shed": run["shed"],
                         "deadline_misses": s["deadline_misses"],
                         "final_level": s["final_level"], "per_op": per_op,
                         "by_op_level": table})
            print(f"front-end gate run {i + 1}: {FE_GATE_SLO} "
                  f"{'passed' if rc == 0 else 'FAILED'}; served "
                  f"{s['served']}, shed {json.dumps(run['shed'])}, "
                  f"{s['deadline_misses']} deadline misses, final level "
                  f"{s['final_level']}")
            for op, o in per_op.items():
                bm = ("—" if o["batch_ms_median"] is None
                      else f"{o['batch_ms_median']:.3f}")
                kl = ("—" if o["kernel_launches_a_batch"] is None
                      else f"{o['kernel_launches_a_batch']:.2f}")
                print(f"  {op}: served {o['served']}, p50 {o['p50_ms']:.3f} "
                      f"ms, p99 {o['p99_ms']:.3f} ms, batch {bm} ms "
                      f"(median), {kl} kernel launches a batch")
            if rc != 0:
                print(buf.getvalue())
                fail(f"front-end gate run {i + 1}: {FE_GATE_SLO} violated")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    launches = dict(build.launches)
    missing = [k for k in FE_GATE_KERNELS if launches[k] <= 0]
    print(f"front-end gate: launches over its {FE_GATE_RUNS} runs "
          f"{json.dumps({k: v for k, v in launches.items() if v})}")
    if missing:
        fail(f"front-end gate: {missing} never launched")
    return {"runs": runs, "launches": launches}, launches


KERNEL_SYMBOLS = {"wm_quantile_sharded": ("wm_quantile_kernel",),
                  "wm_level_step": ("wm_level_zeros_kernel",
                                    "zero_scan_kernel"),
                  "rank_build_levels": ("rank_build_levels_kernel",),
                  "wt_level_step": ("zero_scan_kernel",),
                  "radix_rank": ("radix_scan_kernel",),
                  "bitpack": ("bitpack_kernel",),
                  "wm_count": ("wm_count_kernel",),
                  "topk_greedy": ("topk_greedy_kernel",)}
OBS_KERNELS = ("wm_level_step", "rank_build_levels", "wm_quantile_sharded")
METRICS_COST_ROUNDS = 4          # (on, off, off, on) rounds of 11.6
OBS_CLI_TIMEOUT_S = 300
#: the reference's FakeClock overload rows, which the port's chaos repeats
CHAOS_OVERLOAD_ROWS = ("served 105, shed 295 (74%",
                       "91 degraded answers, 0 violations", "p99 79.2ms",
                       "over 105 accepted")


def device_busy(trace_path: Path, span_names) -> dict:
    """Kernel names, span names and, for each of ``span_names`` and for
    the window from the first of them to the end of the last, the wall
    time and the device-busy share (the union of the kernel, copy and set
    intervals inside it over its wall time) of a ``torch.profiler``
    chrome trace."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    device, names, user = [], set(), {}
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X":
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((a, b))
            if cat == "kernel":
                names.add(e["name"])
        elif cat == "user_annotation":
            lo, hi = user.get(e["name"], (a, b))
            user[e["name"]] = (min(lo, a), max(hi, b))
    device.sort()

    def busy(lo: float, hi: float) -> dict:
        total, end = 0.0, lo
        for a, b in device:
            a, b = max(a, end), min(b, hi)
            if b > a:
                total += b - a
                end = b
        return {"wall_s": (hi - lo) / 1e6, "busy_s": total / 1e6,
                "busy_share": total / max(hi - lo, 1e-9)}

    out = {"kernel_names": sorted(names), "span_names": sorted(user),
           "spans": {n: busy(*user[n]) for n in span_names if n in user}}
    if out["spans"]:
        out["window"] = busy(min(user[n][0] for n in out["spans"]),
                             max(user[n][1] for n in out["spans"]))
    return out


def obs_phase(dev, toks: np.ndarray, eng, queries, serve_batches,
              wrapper_ms: float, batch_bytes: int, dryrun_procs):
    """Step 11: ``repro_torch.obs`` through step 4's engine ``eng`` and its
    queries at full width, metrics on; ``wrapper_ms`` is the quantile
    kernel's wrapper time of step 5, ``batch_bytes`` the bytes its bound
    counts for the batch ``queries``. The dry run's processes
    (``dryrun_procs``) end first: they share the host's cores with the
    host clock's timings. Returns (report, launches)."""
    import contextlib
    import io
    import os
    import tempfile

    from repro_torch import obs
    from repro_torch.analytics.engine import build_sharded_analytics
    from repro_torch.core.wavelet_matrix import build_wavelet_matrix
    from repro_torch.ingest.serving import GenerationServer
    from repro_torch.kernels import build, ops
    from repro_torch.launch import frontend as fe_cli
    from repro_torch.launch import obs as obs_cli
    from repro_torch.serving import FrontendConfig, QueryFrontend

    lo_t, hi_t, k_t = queries
    report = {}
    t_phase = time.perf_counter()
    running = finish_dryrun(dryrun_procs)
    report["dryrun_wait"] = {"running": running,
                             "s": time.perf_counter() - t_phase}
    print(f"obs: {running} of {len(dryrun_procs)} dry-run processes were "
          f"still running; waited {report['dryrun_wait']['s']:.3f} s for "
          f"them")
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_obs_")
    mdir = Path(work.name) / "metrics"
    obs.REGISTRY.reset()
    obs.reset_shape_tracking()
    obs.configure(mdir)
    torch.cuda.synchronize()
    # the earlier steps leave the caching allocator holding many blocks,
    # which slows the small allocations of every quantile launch: return
    # them, so the step times the serving path as a fresh server runs it
    torch.cuda.empty_cache()
    build.reset_launches()
    untraced = {name: 0 for name in build.launches}

    def gauge(name: str, op: str) -> float:
        return obs.REGISTRY.snapshot()["gauges"].get(f"{name}{{op={op}}}")

    try:
        # ---- 11.1 the quantile kernel under profiled_op ----------------
        out, steady_s, first_s = obs.profiled_op(
            "analytics", "quantile_kernel",
            lambda e, a, b, c: e.range_quantile(a, b, c), eng, lo_t, hi_t,
            k_t, batch=NUM_QUERIES, iters=20)
        util = gauge("prof.roofline_util", "analytics.quantile_kernel")
        nbytes = gauge("prof.bytes_accessed", "analytics.quantile_kernel")
        print(f"obs: profiled_op analytics.quantile_kernel: steady "
              f"{steady_s * 1e3:.6f} ms (step 5's wrapper {wrapper_ms:.6f} "
              f"ms), first call {first_s * 1e3:.6f} ms, roofline {util}, "
              f"work model {nbytes} B (step 5's bound {batch_bytes} B), "
              f"{gauge('prof.int_ops', 'analytics.quantile_kernel')} int32 "
              f"ops")
        if util is None or not 0 < util <= 1.05:
            fail(f"obs: quantile roofline {util} outside (0, 1.05]")
        if not wrapper_ms / 2 <= steady_s * 1e3 <= 2 * wrapper_ms:
            fail(f"obs: quantile steady {steady_s * 1e3:.6f} ms not within "
                 f"2x of the wrapper's {wrapper_ms:.6f} ms")
        if nbytes != batch_bytes:
            fail(f"obs: the work model's {nbytes} B for the batch differ "
                 f"from the bound's {batch_bytes} B")
        report["quantile"] = {"steady_s": steady_s, "first_s": first_s,
                              "roofline_util": util, "bytes": nbytes,
                              "wrapper_ms": wrapper_ms}

        # ---- 11.2 one shard build and the 128-shard build ----------------
        shard0 = torch.from_numpy(toks[:1 << SHARD_BITS].astype(
            np.int32)).to(dev)
        builds = {}
        for name, fn, args in (
                ("analytics.construct_shard",
                 lambda s: build_wavelet_matrix(s, SIGMA, tau=TAU,
                                                sample_rate=SAMPLE_RATE,
                                                device=dev), (shard0,)),
                ("analytics.build_sharded",
                 lambda: build_sharded_analytics(
                     toks, SIGMA, shard_bits=SHARD_BITS, tau=TAU,
                     sample_rate=SAMPLE_RATE, device=dev), ())):
            _, st = obs.profile_op(name, fn, *args)
            builds[name] = st
            print(f"obs: profile_op {name}: steady {st.get('steady_s')} s, "
                  f"first call {st.get('compile_s')} s, roofline "
                  f"{st.get('roofline_util')} ({st.get('bound')}-bound), "
                  f"{st.get('bytes_accessed')} B and {st.get('int_ops')} "
                  f"int32 ops in the kernels, peak rise "
                  f"{st.get('peak_bytes')} B")
            if "error" in st or not st.get("peak_bytes", 0) > 0:
                fail(f"obs: {name}: no peak memory ({st})")
            if not 0 < st.get("roofline_util", 0) <= 1.05:
                fail(f"obs: {name}: roofline {st.get('roofline_util')} "
                     f"outside (0, 1.05]")
        report["builds"] = builds
        del shard0

        # ---- 11.4 the front-end at overload 1, metrics on --------------
        trace = fe_cli.make_trace(eng.n, FE_REQUESTS, 0, base_qps=200.0,
                                  burst_qps=2000.0, burst_every_s=2.0,
                                  burst_len_s=0.5, deadline_s=FE_DEADLINE_S,
                                  topk_k=FE_TOPK)
        fe = QueryFrontend(GenerationServer(eng), config=FrontendConfig(
            buckets=FE_BUCKETS, capacity=FE_CAPACITY,
            default_deadline_s=FE_DEADLINE_S, topk_k=FE_TOPK,
            breaker=fe_cli.CLI_BREAKER))
        before = build.launches.copy()
        fe_cli.warm_up(fe, eng.n, SIGMA)              # metrics off inside
        for name, v in build.launches.items():
            untraced[name] += v - before[name]
        st0 = fe.stats()
        fe.start()
        t0 = time.perf_counter()
        try:
            with obs.span("frontend.drive", requests=len(trace),
                          overload=1.0):
                results = fe_cli.collect(fe_cli.drive(fe, trace, 1.0,
                                                      SIGMA))
            wall = time.perf_counter() - t0
        finally:
            fe.stop(drain=True)
        out = fe_cli.report(fe, trace, results, wall)
        st = fe.stats()
        snap = obs.REGISTRY.snapshot()
        c, h = snap["counters"], snap["histograms"]

        def total(prefix: str, **want) -> int:
            got = 0
            for key, v in c.items():
                name, labels = obs.parse_key(key)
                if name == prefix and all(labels.get(k_) == v_
                                          for k_, v_ in want.items()):
                    got += v
            return got

        submitted, served = (total("serve.frontend.submitted"),
                             total("serve.frontend.served"))
        shed = total("serve.frontend.shed")
        queued = snap["gauges"].get("serve.frontend.queue_depth")
        print(f"obs: front-end x1 counters: submitted {submitted}, served "
              f"{served}, shed {shed}, queue depth {queued}; stats() "
              f"{json.dumps({k_: st[k_] - st0[k_] for k_ in ('submitted', 'served', 'total_shed')})}"
              f" over the drive, {st['queued']} queued; {out['served']} "
              f"served, {out['shed']} shed, p99 {out['p99_ms']:.3f} ms")
        if submitted != len(trace):
            fail(f"obs: {submitted} submitted counted, {len(trace)} sent")
        if (served + shed + queued != submitted
                or served != st["served"] - st0["served"]
                or shed != st["total_shed"] - st0["total_shed"]
                or queued != st["queued"]):
            fail(f"obs: front-end counters {served} + {shed} + {queued} "
                 f"disagree with stats() {st} (from {st0})")
        for op in ("count", "quantile", "topk"):
            n_op = h.get(f"serve.frontend.{op}.latency_s", {}).get("count", 0)
            if n_op != total("serve.frontend.served", op=op):
                fail(f"obs: {op}: {n_op} latencies, "
                     f"{total('serve.frontend.served', op=op)} served")
        report["frontend"] = {"submitted": submitted, "served": served,
                              "shed": shed, "queued": queued,
                              "p99_ms": out["p99_ms"], "wall_s": wall}
        obs.write_snapshot()
        sink = io.StringIO()
        for mode in ([], ["--tree"], ["--prometheus"],
                     ["--html", str(Path(work.name) / "dash.html")]):
            with contextlib.redirect_stdout(sink):
                rc = obs_cli.main([str(mdir), *mode])
            if rc != 0:
                fail(f"obs: launch.obs {mode} exited {rc}")
        print(f"obs: launch.obs rendered the capture (table, --tree, "
              f"--prometheus, --html): {len(sink.getvalue())} characters")

        # ---- 11.5 a torch.profiler trace of a short window -------------
        pdir = Path(work.name) / "profile"
        window0 = build.launches.copy()
        torch.cuda.synchronize()
        obs.start_trace(pdir)
        with obs.span("analytics.serve", queries=NUM_QUERIES):
            for b in serve_batches:
                eng.range_quantile(*b)
        with obs.span("analytics.build", n=1 << SHARD_BITS) as sp:
            sp.sync(build_wavelet_matrix(
                torch.from_numpy(toks[:1 << SHARD_BITS].astype(np.int32)
                                 ).to(dev), SIGMA, tau=TAU,
                sample_rate=SAMPLE_RATE, device=dev))
        path = obs.stop_trace()
        window = device_busy(path, ("analytics.serve", "analytics.build"))
        in_window = [k_ for k_, v in build.launches.items()
                     if v > window0[k_]]
        want = {sym for k_ in in_window for sym in KERNEL_SYMBOLS[k_]}
        missing = sorted(sym for sym in want if not any(
            sym in name for name in window["kernel_names"]))
        spans_missing = sorted({"analytics.serve", "analytics.build"}
                               - set(window["span_names"]))
        if missing or spans_missing:
            print(f"obs: kernels in the trace: {window['kernel_names']}")
            fail(f"obs: the trace misses kernels {missing} or spans "
                 f"{spans_missing}")
        for name, b in [*window["spans"].items(),
                        ("both", window["window"])]:
            print(f"obs: torch.profiler trace, {name}: {b['wall_s']:.6f} s "
                  f"wall, device busy {b['busy_s']:.6f} s "
                  f"({100 * b['busy_share']:.3f}%)")
        print(f"obs: the trace names {sorted(want)} and the spans")
        window.pop("span_names")
        window["kernel_names"] = [name[:120] for name in
                                  window["kernel_names"]]
        report["trace_window"] = window

        # ---- 11.6 the cost of metrics on the quantile batches ----------
        def serve_rate() -> tuple[float, float]:
            ts = []
            for b in serve_batches:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                eng.range_quantile(*b)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t1)
            return (len(ts) * NUM_QUERIES / sum(ts),
                    float(np.median(ts)))

        cost = {"on": [], "off": []}
        for mode in ("on", "off", "off", "on") * METRICS_COST_ROUNDS:
            if mode == "on":
                cost["on"].append(serve_rate())
            else:
                before = build.launches.copy()
                with obs.disabled():
                    cost["off"].append(serve_rate())
                for name, v in build.launches.items():
                    untraced[name] += v - before[name]
        for mode, runs in cost.items():
            cost[mode] = {"qps": [r[0] for r in runs],
                          "median_batch_s": [r[1] for r in runs]}
            cost[mode]["median_of_medians_s"] = float(np.median(
                cost[mode]["median_batch_s"]))
        print(f"obs: {SERVE_BATCHES} quantile batches on the host clock, "
              f"{2 * METRICS_COST_ROUNDS} runs each in turns (on, off, off, "
              f"on): metrics on {cost['on']['qps']} q/s, median batch "
              f"{cost['on']['median_batch_s']} s; obs.disabled() "
              f"{cost['off']['qps']} q/s, median batch "
              f"{cost['off']['median_batch_s']} s; the median of the "
              f"medians {cost['on']['median_of_medians_s']:.9f} s on, "
              f"{cost['off']['median_of_medians_s']:.9f} s off")
        report["metrics_cost"] = cost

        # ---- 11.3 trace counters against the launch log ----------------
        torch.cuda.synchronize()
        launches = dict(build.launches)
        traced = {name: [0, 0] for name in build.launches}
        for key, v in obs.REGISTRY.snapshot()["counters"].items():
            name, labels = obs.parse_key(key)
            if name == "kernels.trace" and labels.get("route") == "cuda":
                kernel, least, most = ops.TRACE_LAUNCHES[labels["op"]]
                traced[kernel][0] += least * v
                traced[kernel][1] += most * v
        bad = {name: (traced[name], launches[name] - untraced[name])
               for name in launches
               if not traced[name][0] <= launches[name] - untraced[name]
               <= traced[name][1]}
        print(f"obs: kernels.trace op -> (launch counter, launches a trace: "
              f"least, most) {json.dumps(ops.TRACE_LAUNCHES)}")
        print(f"obs: launches over step 11 {json.dumps(launches)} "
              f"({json.dumps({k_: v for k_, v in untraced.items() if v})} "
              f"with metrics off); traced {json.dumps(traced)}")
        if bad:
            fail(f"obs: kernels.trace{{route=cuda}} counts disagree with "
                 f"build.launches: {bad}")
        missing = [k_ for k_ in OBS_KERNELS if launches[k_] <= 0]
        if missing:
            fail(f"kernels not launched in step 11: {missing}")
        report["launches"] = launches
        report["untraced_launches"] = untraced
        obs.configure(None)

        # ---- 11.7 chaos and the three CLIs on the card ------------------
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   PYTHONIOENCODING="utf-8")
        runs = {}
        for name, args in (
                ("chaos", ["--smoke", "--device", "cuda"]),
                ("analytics", ["--smoke", "--device", "cuda"]),
                ("index", ["--smoke", "--device", "cuda", "--drop-shards",
                           "1,3"]),
                ("frontend", ["--smoke", "--device", "cuda"])):
            d = Path(work.name) / name
            extra = ["--metrics-dir", str(d / "metrics")]
            if name != "chaos":
                extra += ["--profile-dir", str(d / "profile")]
            runs[name] = (subprocess.Popen(
                [sys.executable, "-m", f"repro_torch.launch.{name}", *args,
                 *extra], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                env=env, cwd=str(ROOT), text=True, encoding="utf-8"), d,
                time.perf_counter())
        clis = {}
        for name, (proc, d, t1) in runs.items():
            try:
                text, _ = proc.communicate(timeout=OBS_CLI_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for other, _, _ in runs.values():
                    other.kill()
                fail(f"obs: launch.{name} ran past {OBS_CLI_TIMEOUT_S} s")
            lines = text.splitlines()
            clis[name] = {"rc": proc.returncode,
                          "s": time.perf_counter() - t1,
                          "snapshot": (d / "metrics" / "snapshot.json"
                                       ).exists()}
            if proc.returncode != 0 or not clis[name]["snapshot"]:
                print("\n".join(lines[-40:]).encode("ascii", "replace")
                      .decode(), file=sys.stderr)
                fail(f"obs: launch.{name} exited {proc.returncode}, "
                     f"snapshot.json written: {clis[name]['snapshot']}")
            if name == "chaos":
                rows = [ln for ln in lines if "[PASS]" in ln
                        or "[FAIL]" in ln]
                done = [ln for ln in lines if "scenarios survived" in ln]
                got = [want for want in CHAOS_OVERLOAD_ROWS
                       if any(want in ln for ln in rows)]
                clis[name].update(rows=len(rows),
                                  overload=[ln for ln in rows
                                            if "overload" in ln])
                if not done or len(got) != len(CHAOS_OVERLOAD_ROWS):
                    fail(f"obs: chaos: {done}, overload rows "
                         f"{clis[name]['overload']}")
                print(f"obs: chaos: {len(rows)} rows, all passed, the "
                      f"overload rows equal the reference's FakeClock rows")
        print(f"obs: chaos and the analytics, index and front-end CLIs at "
              f"--smoke on the card: {json.dumps(clis)}")
        report["clis"] = clis
    finally:
        obs.configure(None)
        work.cleanup()
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"obs: step 11 took {report['phase_s']:.3f} s on the host clock")
    return report, launches


def lm_phase(dev) -> tuple[dict, dict]:
    """Step 12: the four port examples on the card, then the LM serving
    path at Qwen2-0.5B's full width. Returns (report, the examples'
    launches summed)."""
    import contextlib
    import dataclasses
    import importlib.util
    import io

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model import build_model, map_tree, tree_paths

    report = {"examples": {}, "serve": []}
    t_phase = time.perf_counter()
    total = {name: 0 for name in build.launches}

    # ---- 12a. the examples at their default sizes -----------------------
    for name, want in EXAMPLE_KERNELS.items():
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(build.launches)
        out = buf.getvalue().strip().splitlines()
        print("\n".join(f"  {name}: {ln}" for ln in out))
        if not out or not out[-1].endswith("✓"):
            fail(f"lm: {name} did not end in its check line")
        wrong = {k: v for k, v in launches.items()
                 if (v > 0) != (k in want)}
        print(f"lm: {name}: {secs:.3f} s, launches {json.dumps(launches)}")
        if wrong:
            fail(f"lm: {name} launched {wrong}; its path launches exactly "
                 f"{list(want)}")
        report["examples"][name] = {"s": secs, "launches": launches}
        for k, v in launches.items():
            total[k] += v

    # ---- 12b. Qwen2-0.5B at full width, two shapes ---------------------
    cfg = get_config(LM_ARCH)
    dims = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.param_count())
    if dims != (24, 896, 14, 2, 4864, 151_936, LM_PARAMS):
        fail(f"lm: {LM_ARCH} config {dims}")
    model = build_model(cfg)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    report["init_s"] = time.perf_counter() - t0
    report["param_bytes"] = sum(leaf.numel() * leaf.element_size()
                                for _, leaf in tree_paths(params))
    print(f"lm: {LM_ARCH} full config, {LM_PARAMS} parameters "
          f"({report['param_bytes'] / 2**30:.3f} GiB bf16), fresh init on "
          f"the card in {report['init_s']:.3f} s")
    for b, plen, steps in LM_SHAPES:
        prompts = serve_cli.make_prompts(cfg.vocab_size, b, plen, 0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = serve_cli.serve(model, params, prompts, steps, dev)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        pre, warm = res["prefill_logits"], res["warm_logits"]
        row = {"batch": b, "prompt": plen, "decode_steps": steps,
               "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
               "prefill_tok_s": b * plen / res["prefill_s"],
               "decode_tok_s": b * (steps - 1) / res["decode_s"],
               "warmup_decode_steps": plen, "s": secs,
               "peak_gib": peak / 2**30, "peak_rise_gib": (peak - base)
               / 2**30,
               "prefill_vs_decode_max_abs": float(
                   (pre - warm).abs().max())}
        print(f"lm: serve batch {b}, prompt {plen}, {steps} decode steps: "
              f"prefill {row['prefill_s'] * 1e3:.3f} ms "
              f"({row['prefill_tok_s']:.1f} tok/s), decode "
              f"{row['decode_s'] * 1e3:.3f} ms ({row['decode_tok_s']:.1f} "
              f"tok/s), {plen} teacher-forced warm-up steps, {secs:.3f} s "
              f"in all; peak {row['peak_gib']:.3f} GiB (rise "
              f"{row['peak_rise_gib']:.3f} GiB); prefill vs teacher-forced "
              f"decode max abs {row['prefill_vs_decode_max_abs']:.6f}")
        if not (torch.isfinite(pre).all() and torch.isfinite(warm).all()):
            fail("lm: non-finite logits")
        toks = res["tokens"]
        if (tuple(toks.shape) != (b, steps) or int(toks.min()) < 0
                or int(toks.max()) >= cfg.vocab_size):
            fail(f"lm: generated tokens {tuple(toks.shape)} out of range")
        try:
            torch.testing.assert_close(warm, pre, rtol=LM_TOL, atol=LM_TOL)
        except AssertionError as e:
            fail(f"lm: prefill and teacher-forced decode disagree: {e}")
        report["serve"].append(row)
        del res, pre, warm
    del params
    torch.cuda.empty_cache()

    # ---- 12c. full width, depth 2: the card against the CPU ------------
    cfg2 = dataclasses.replace(cfg, num_layers=LM_CHECK_DEPTH)
    model2 = build_model(cfg2)
    card = model2.init(0, device=dev)
    cpu = map_tree(lambda _, a: a.cpu(), card)
    prompts = serve_cli.make_prompts(cfg.vocab_size, 2, 16, 1)
    c = teacher_forced(model2, card, dev, prompts, None)
    h = teacher_forced(model2, cpu, torch.device("cpu"), prompts,
                       c["tokens"])
    err = {k: float((c[k] - h[k]).abs().max()) for k in ("prefill",
                                                         "decode")}
    plen = prompts.shape[1]
    top2 = h["decode"][plen - 1:].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] >= LM_MARGIN).T
    same = bool((c["tokens"][clear] == h["tokens"][clear]).all())
    report["card_vs_cpu"] = {"depth": LM_CHECK_DEPTH, "max_abs_err": err,
                             "clear_tokens": int(clear.sum()),
                             "tokens_equal": same,
                             "card_tokens": c["tokens"].tolist()}
    print(f"lm: full width, depth {LM_CHECK_DEPTH}: card against CPU, max "
          f"abs err {json.dumps(err)}; greedy tokens "
          f"{c['tokens'].tolist()}, equal at the {int(clear.sum())} steps "
          f"with a clear margin: {same}")
    for key in ("prefill", "decode"):
        try:
            torch.testing.assert_close(c[key], h[key], rtol=LM_TOL,
                                       atol=LM_TOL)
        except AssertionError as e:
            fail(f"lm: card and CPU {key} logits disagree: {e}")
    if not same:
        fail("lm: card and CPU greedy tokens differ at a clear margin")
    del card, cpu

    # ---- 12d. no wavelet kernel on the serve path ----------------------
    serve_launches = dict(build.launches)
    report["serve_launches"] = serve_launches
    print(f"lm: launches over the serve path {json.dumps(serve_launches)}")
    if any(serve_launches.values()):
        fail("lm: the serve path launched a wavelet kernel")
    report["launches"] = total
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"lm: step 12 took {report['phase_s']:.3f} s on the host clock")
    return report, total


def teacher_forced(model, params, dev, prompts: np.ndarray, forced):
    """Prefill logits (B, V) and decode logits (P + LM_CHECK_STEPS - 1, B,
    V) on the host of ``prompts`` (B, P), the prompt teacher-forced and
    then LM_CHECK_STEPS greedy tokens (B, LM_CHECK_STEPS), or the tokens
    ``forced`` fed in their place."""
    from repro_torch.models.model import zero_cache
    b, plen = prompts.shape
    with torch.inference_mode():
        toks = torch.from_numpy(prompts).to(dev).long()
        pre = model.prefill(params, toks).cpu()
        cache = zero_cache(model.cfg, b, plen + LM_CHECK_STEPS, device=dev)
        logits, gen = [], []
        tok = toks[:, :1]
        for i in range(plen + LM_CHECK_STEPS - 1):
            lg, cache = model.decode_step(
                params, tok, cache, torch.full((b,), i, dtype=torch.int32))
            logits.append(lg.cpu())
            if i + 1 < plen:
                tok = toks[:, i + 1:i + 2]
                continue
            gen.append(lg.argmax(-1).cpu())
            k = len(gen) - 1
            tok = (gen[k] if forced is None else forced[:, k]).to(dev)[:,
                                                                     None]
    return {"prefill": pre, "decode": torch.stack(logits),
            "tokens": torch.stack(gen, dim=1)}


def train_phase(dev, toks: np.ndarray) -> tuple[dict, dict, object]:
    """Step 13: the LM training half at Qwen2-0.5B's full width, fed from
    the wavelet-matrix store of the stream. Returns (report, the step's
    launches, the checks' own left out, the store for step 14)."""
    import dataclasses
    import importlib.util
    import tempfile

    from repro_torch.configs.base import get_config
    from repro_torch.data import (TokenBatcher, batch_offsets,
                                  build_compressed_corpus)
    from repro_torch.kernels import bitpack, build
    from repro_torch.models.model import (build_model, count_params,
                                          map_tree, tree_paths)
    from repro_torch.optim.grad_compress import quantize_bitplanes
    from repro_torch.train import Trainer, make_train_step, value_and_grad

    report = {}
    t_phase = time.perf_counter()
    total = {name: 0 for name in build.launches}

    def add_launches(part: str) -> dict:
        launches = dict(build.launches)
        for k, v in launches.items():
            total[k] += v
        print(f"train: {part} launches {json.dumps(launches)}")
        return launches

    # ---- 13a. the store that feeds the batcher -------------------------
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    corpus = build_compressed_corpus(toks, SIGMA, shard_bits=SHARD_BITS,
                                     tau=TAU, sample_rate=SAMPLE_RATE,
                                     device=dev)
    torch.cuda.synchronize()
    report["store_build_s"] = time.perf_counter() - t0
    launches = add_launches("store build")
    want = {"wm_level_step": corpus.nbits + 1, "rank_build_levels": 1}
    if any(launches[k] != v for k, v in want.items()) or any(
            v for k, v in launches.items() if k not in want):
        fail(f"train: the store build launched {launches}, not {want}")
    report["store_bits_per_token"] = corpus.bits_per_token()
    print(f"train: store of {corpus.n} tokens in {corpus.num_shards} shards "
          f"of 2^{SHARD_BITS} built in {report['store_build_s']:.3f} s, "
          f"{report['store_bits_per_token']:.4f} bits a token")
    batch_s = []

    class CheckedBatcher(TokenBatcher):
        """The store's batcher; every batch held against the numpy stream
        and timed."""
        def batch_at(self, step: int) -> np.ndarray:
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = super().batch_at(step)
            batch_s.append(time.perf_counter() - t)
            offs = batch_offsets(step, self.batch, self.n, self.seq_len,
                                 self.seed)
            want = toks[offs[:, None] + np.arange(self.seq_len + 1)]
            if got.dtype != np.int32 or not np.array_equal(got, want):
                fail(f"train: the store's batch of step {step} differs "
                     f"from the stream")
            return got

    def batcher():
        return CheckedBatcher(corpus=corpus, batch=TRAIN_BATCH,
                              seq_len=TRAIN_SEQ, seed=0)

    # ---- 13b. Qwen2-0.5B at full width, 20 steps -----------------------
    cfg = get_config(LM_ARCH)
    n_params = count_params(cfg)
    if n_params != LM_PARAMS or cfg.num_layers != 24:
        fail(f"train: {LM_ARCH} has {n_params} params, {cfg.num_layers} "
             f"layers")
    model = build_model(cfg)
    kw = dict(base_lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=TRAIN_STEPS,
              device=dev)

    def trainer(**extra):
        return Trainer(model, batcher(), log_every=1, **{**kw, **extra})

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    a = trainer()
    step_s = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.run(1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    add_launches("full-width training")
    losses = [h["loss"] for h in a.history]
    gnorms = [h["grad_norm"] for h in a.history]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = float(np.median(step_s[1:]))
    report["full_width"] = {
        "arch": LM_ARCH, "params": n_params, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "lr": TRAIN_LR, "warmup": TRAIN_WARMUP,
        "steps": TRAIN_STEPS, "first_step_s": step_s[0],
        "median_step_s": med, "step_s": step_s, "tok_s": tokens / med,
        "work_model_share": 6 * n_params * tokens / med / BF16_DENSE_FLOPS,
        "batch_s_median": float(np.median(batch_s)),
        "peak_gib": peak / 2**30, "peak_rise_gib": (peak - base) / 2**30,
        "loss": losses, "grad_norm": gnorms}
    fw = report["full_width"]
    print(f"train: {LM_ARCH} full width, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: first step {step_s[0]:.3f} s, then median "
          f"{med:.4f} s a step ({fw['tok_s']:.1f} tok/s, 6·N·tokens "
          f"{100 * fw['work_model_share']:.2f}% of 989 TFLOP/s), a store "
          f"batch {1e3 * fw['batch_s_median']:.2f} ms; peak "
          f"{fw['peak_gib']:.3f} GiB (rise {fw['peak_rise_gib']:.3f} GiB)")
    print(f"train: losses {json.dumps(losses)}")
    print(f"train: grad norms {json.dumps(gnorms)}")
    if not all(np.isfinite(losses + gnorms)):
        fail("train: a non-finite loss or grad norm")
    first, last = np.mean(losses[:2]), np.mean(losses[-2:])
    if not last < first - TRAIN_LOSS_DROP:
        fail(f"train: the loss fell from {first:.4f} to {last:.4f}, not by "
             f"{TRAIN_LOSS_DROP}")
    final = {p: x.clone() for p, x in tree_paths(a.state.params)}
    del a
    torch.cuda.empty_cache()

    # ---- 13c. resume and replay ----------------------------------------
    from repro_torch.train import trainer as trainer_mod
    save_s = []

    def timed_save(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = save(*args, **kwargs)
        save_s.append(time.perf_counter() - t)
        return out
    save, trainer_mod.save_checkpoint = trainer_mod.save_checkpoint, timed_save
    with tempfile.TemporaryDirectory() as ckpt:
        build.reset_launches()
        b = trainer(ckpt_dir=ckpt, ckpt_every=TRAIN_RESUME_AT)
        b.run(TRAIN_RESUME_AT)
        trainer_mod.save_checkpoint = save
        replay = [h["loss"] for h in b.history]
        del b
        torch.cuda.empty_cache()
        c = trainer(ckpt_dir=ckpt, ckpt_every=TRAIN_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = c.maybe_resume()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        c.run(TRAIN_STEPS - TRAIN_RESUME_AT)
        resumed = [h["loss"] for h in c.history]
        same = all(torch.equal(x, final[p])
                   for p, x in tree_paths(c.state.params))
        del c
        torch.cuda.empty_cache()
        add_launches("resume and replay")
    report["resume"] = {"at": start, "save_s": save_s[0],
                        "restore_s": restore_s,
                        "replay_equal": replay == losses[:TRAIN_RESUME_AT],
                        "resumed_equal": resumed == losses[TRAIN_RESUME_AT:],
                        "params_equal": same}
    print(f"train: replay from scratch {replay == losses[:TRAIN_RESUME_AT]}"
          f"; the state saved at step {TRAIN_RESUME_AT} in {save_s[0]:.3f} "
          f"s; resumed at step {start} (restore {restore_s:.3f} s), losses "
          f"equal {resumed == losses[TRAIN_RESUME_AT:]}, params bit for bit "
          f"{same}")
    if not (start == TRAIN_RESUME_AT and all(report["resume"].values())):
        fail(f"train: resume or replay is not bit-identical: "
             f"{report['resume']}")
    del final

    # ---- 13d. accumulation ---------------------------------------------
    from repro_torch.train import init_train_state
    build.reset_launches()
    batch = {"tokens": torch.from_numpy(batcher().batch_at(0)).to(
        dev).long()}
    outs = []
    for accum in (1, TRAIN_ACCUM):
        state = init_train_state(model, 0, device=dev)
        outs.append(make_train_step(model, grad_accum=accum,
                                    base_lr=TRAIN_ACCUM_LR)(state, batch))
        del state
    (n1, m1), (n4, m4) = outs
    acc = {"loss": [float(m1["loss"]), float(m4["loss"])],
           "grad_norm": [float(m1["grad_norm"]), float(m4["grad_norm"])]}
    ok = abs(acc["loss"][1] - acc["loss"][0]) <= 2e-2 * abs(acc["loss"][0])
    ok &= (abs(acc["grad_norm"][1] - acc["grad_norm"][0])
           <= 2e-2 * abs(acc["grad_norm"][0]))
    for (_, x), (_, y) in zip(tree_paths(n1.params), tree_paths(n4.params)):
        ok &= bool(torch.allclose(y.float(), x.float(), rtol=2e-2,
                                  atol=2e-4))
    report["accumulation"] = {**acc, "within": ok}
    print(f"train: grad_accum {TRAIN_ACCUM} against 1: loss "
          f"{acc['loss']}, grad norm {acc['grad_norm']}, within "
          f"tests/test_train.py's tolerances: {ok}")
    del outs, n1, n4
    torch.cuda.empty_cache()
    add_launches("accumulation")
    if not ok:
        fail("train: accumulation disagrees with the full batch")

    # ---- 13e. compression ----------------------------------------------
    build.reset_launches()
    comp = trainer(compress_bits=TRAIN_COMPRESS_BITS)
    comp.run(TRAIN_COMPRESS_STEPS)
    torch.cuda.synchronize()
    leaves = len(list(tree_paths(comp.state.params)))
    launches = add_launches("compressed training")
    comp_losses = [h["loss"] for h in comp.history]
    # the words of one step's gradients, card against CPU (check launches
    # counted apart)
    _, grads = value_and_grad(model.loss_fn, comp.state.params,
                              batch["tokens"])
    del comp
    torch.cuda.empty_cache()
    build.reset_launches()
    words_equal = True
    for _, g in tree_paths(grads):
        g = g.reshape(-1)[:TRAIN_WORDS_CHECK]
        w, sc = quantize_bitplanes(g, TRAIN_COMPRESS_BITS)
        hw, hs = quantize_bitplanes(g.cpu(), TRAIN_COMPRESS_BITS)
        words_equal &= torch.equal(w.cpu(), hw) and torch.equal(sc.cpu(), hs)
    # the kernel at the path's widest planes against its plain version
    big = grads["embed"].reshape(-1)
    planes = torch.empty((TRAIN_COMPRESS_BITS, big.numel()),
                         dtype=torch.int32, device=dev)
    planes.copy_((torch.rand(planes.shape, device=dev) < 0.5).int())
    n = big.numel()
    got = bitpack.bitpack(planes, n)
    err = max_abs_err(got, bitpack.bitpack_plain(planes, n))
    kernel_ms = cuda_ms(lambda: bitpack.bitpack(planes, n), 10)
    plain_ms = cuda_ms(lambda: bitpack.bitpack_plain(planes, n), 2)
    nbytes = planes.numel() * 4 + got.numel() * 4
    nops = planes.numel() * 2
    del planes, got, grads, big
    torch.cuda.empty_cache()
    report["compression"] = {
        "bits": TRAIN_COMPRESS_BITS, "steps": TRAIN_COMPRESS_STEPS,
        "leaves": leaves, "bitpack_launches": launches["bitpack"],
        "loss": comp_losses, "words_equal_cpu": words_equal,
        "bitpack_at_embedding": {"planes": TRAIN_COMPRESS_BITS, "n": n,
                                 "ms": kernel_ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms(nbytes, nops),
                                 "max_abs_err": err}}
    print(f"train: compressed ({TRAIN_COMPRESS_BITS} bits) for "
          f"{TRAIN_COMPRESS_STEPS} steps, losses {comp_losses}; bitpack "
          f"{launches['bitpack']} launches for {leaves} leaves a step; "
          f"words equal to the CPU's: {words_equal}; bitpack of the "
          f"embedding's {TRAIN_COMPRESS_BITS} x {n} planes {kernel_ms:.4f} "
          f"ms (plain {plain_ms:.4f} ms, bound "
          f"{report['compression']['bitpack_at_embedding']['bound_ms']:.4f}"
          f" ms), max_abs_err {err}")
    if launches["bitpack"] != leaves * TRAIN_COMPRESS_STEPS:
        fail(f"train: bitpack launched {launches['bitpack']} times, not once "
             f"a leaf a step ({leaves * TRAIN_COMPRESS_STEPS})")
    if not words_equal or err or not all(np.isfinite(comp_losses)):
        fail("train: compressed gradients disagree with the CPU's or the "
             "plain pack")

    # ---- 13f. the card against the CPU at depth 2; a poisoned step -----
    build.reset_launches()
    cfg2 = dataclasses.replace(cfg, num_layers=LM_CHECK_DEPTH)
    model2 = build_model(cfg2)
    cb, cs = TRAIN_CHECK_SHAPE
    small = TokenBatcher(corpus=corpus, batch=cb, seq_len=cs, seed=1)
    step2 = make_train_step(model2, base_lr=TRAIN_LR, warmup=1,
                            total_steps=TRAIN_STEPS)
    card = init_train_state(model2, 0, device=dev)
    card, _ = step2(card, {"tokens": torch.from_numpy(small.batch_at(0)).to(
        dev).long()})                       # carried: the next lr is > 0
    host = dataclasses.replace(
        card, params=map_tree(lambda _, x: x.cpu(), card.params),
        opt=dataclasses.replace(
            card.opt, m=map_tree(lambda _, x: x.cpu(), card.opt.m),
            v=map_tree(lambda _, x: x.cpu(), card.opt.v),
            step=card.opt.step.cpu()))
    tok1 = torch.from_numpy(small.batch_at(1)).long()
    c_new, c_met = step2(card, {"tokens": tok1.to(dev)})
    h_new, h_met = step2(host, {"tokens": tok1})
    lr = float(h_met["lr"])
    worst = 0.0
    within = True
    for path, x in tree_paths(c_new.params):
        y = dict(tree_paths(h_new.params))[path].float()
        d = (x.float().cpu() - y).abs()
        within &= bool((d <= 2 * lr + 2 * torch.finfo(torch.bfloat16).eps
                        * y.abs()).all())
        worst = max(worst, float(d.max()))
    cvh = {"depth": LM_CHECK_DEPTH, "shape": list(TRAIN_CHECK_SHAPE),
           "loss": [float(c_met["loss"]), float(h_met["loss"])],
           "grad_norm": [float(c_met["grad_norm"]),
                         float(h_met["grad_norm"])],
           "lr": lr, "param_max_abs_diff": worst,
           "params_within": within}
    ok = (abs(cvh["loss"][0] - cvh["loss"][1]) <= 0.05 + 0.05
          * abs(cvh["loss"][1]) and abs(cvh["grad_norm"][0]
                                        - cvh["grad_norm"][1])
          <= 0.05 * cvh["grad_norm"][1] and within)
    def poison(_, x):                       # tests/test_train.py's poison
        x = x.clone()
        x[(0,) * x.dim()] = float("nan")
        return x
    poisoned = dataclasses.replace(card, params=map_tree(poison,
                                                         card.params))
    p_new, p_met = step2(poisoned, {"tokens": tok1.to(dev)})
    cvh["poisoned_skipped"] = int(p_met["skipped"])
    cvh["poisoned_step_kept"] = int(p_new.opt.step) == int(card.opt.step)
    report["card_vs_cpu"] = cvh
    print(f"train: depth {LM_CHECK_DEPTH}, {cb} x {cs}, card against CPU: "
          f"loss {cvh['loss']}, grad norm {cvh['grad_norm']}, params max "
          f"abs diff {worst:.6g} at lr {lr:.6g} (within 2·lr + 2 ulp: "
          f"{within}); a poisoned step skipped {cvh['poisoned_skipped']}, "
          f"step kept {cvh['poisoned_step_kept']}")
    del card, host, c_new, h_new, poisoned, p_new
    torch.cuda.empty_cache()
    add_launches("card against CPU")
    if not ok:
        fail("train: the card's step disagrees with the CPU's")
    if cvh["poisoned_skipped"] != 1 or not cvh["poisoned_step_kept"]:
        fail("train: a poisoned step was not skipped")

    # ---- 13g. the example ------------------------------------------------
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        hist = mod.main(["--steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt])
        torch.cuda.synchronize()
        example_s = time.perf_counter() - t0
    launches = add_launches("examples/torch_train_lm.py")
    report["example"] = {"s": example_s, "loss": [hist[0]["loss"],
                                                  hist[-1]["loss"]],
                         "launches": launches}
    print(f"train: examples/torch_train_lm.py --steps {TRAIN_STEPS}: "
          f"{example_s:.3f} s, loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f}")
    if not all(launches[k] > 0 for k in ("wm_level_step",
                                         "rank_build_levels")):
        fail("train: the example's store build launched no kernel")

    missing = [k for k in TRAIN_KERNELS if total[k] <= 0]
    if missing:
        fail(f"kernels not launched in step 13: {missing}")
    report["launches"] = total
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"train: step 13 took {report['phase_s']:.3f} s on the host clock")
    return report, total, corpus


def start_dryrun(out_dir: Path) -> list:
    """Start the dry run of step 14a: one process a line of
    ``DRYRUN_CELLS``, on the CPU only (no card is visible to them), at the
    lowest priority, so they run beside steps 1–10b on the host's idle cores
    (the 2×16×16 train cell records for minutes). Output goes to
    ``out_dir``."""
    import atexit
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    procs = []

    def stop():
        for proc, log, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    atexit.register(stop)
    for i, args in enumerate(DRYRUN_CELLS):
        log = open(out_dir / f"dryrun_{i}.log", "w")
        procs.append((subprocess.Popen(
            ["nice", "-n", "19", sys.executable, "-m",
             "repro_torch.launch.dryrun", "--arch", *args, "--out",
             str(out_dir), "--force"], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log, time.perf_counter()))
    return procs


def finish_dryrun(procs) -> int:
    """Wait for the dry-run processes of ``start_dryrun`` (each within
    ``DRYRUN_TIMEOUT_S`` of its start); fail if one runs over or exits
    with an error. Returns how many were still running when called."""
    running = sum(proc.poll() is None for proc, _, _ in procs)
    for proc, log, t0 in procs:
        try:
            proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                  - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for p, _, _ in procs:
                p.kill()
                p.wait()
            fail(f"dryrun: the dry run did not finish in "
                 f"{DRYRUN_TIMEOUT_S} s")
        log.close()
        if proc.returncode != 0:
            fail(f"dryrun: a dry-run process exited {proc.returncode}: "
                 f"{Path(log.name).read_text()[-2000:]}")
    return running


def cell_argument_bytes(cfg, shape, sizes: dict) -> int:
    """The local shard bytes of a dry-run step's arguments, counted in
    numpy from the spec tuples and the shapes: params (bf16); for train
    the f32 moments, the int32 step and the int32 batch, for train and
    prefill with its bf16 extras (a VLM's image embeddings, an encoder's
    frames); for decode the bf16 cache, the int32 tokens and pos."""
    from repro_torch.models.model import (abstract_params, build_model,
                                          cache_shapes, cache_specs,
                                          fit_spec, param_specs, tree_paths)

    def local(shape_, spec, itemsize):
        n = 1
        for dim, ax in zip(shape_, tuple(spec) + (None,) * len(shape_)):
            axes = (() if ax is None else ax if isinstance(ax, tuple)
                    else (ax,))
            n *= dim // int(np.prod([sizes[a] for a in axes], dtype=np.int64))
        return n * itemsize

    dp = tuple(a for a in ("pod", "data") if a in sizes)
    b, s = shape.global_batch, shape.seq_len
    mode = "decode" if shape.kind == "decode" else "train"
    shapes = dict(tree_paths(abstract_params(cfg)))
    pbytes = sum(local(shapes[p].shape, sp, 2)
                 for p, sp in tree_paths(param_specs(cfg, sizes, mode)))
    extras = sum(local(shp, fit_spec((dp,) + (None,) * (len(shp) - 1),
                                      shp, sizes), 2)
                 for shp in build_model(cfg).extras_shapes(b).values())
    if shape.kind == "train":
        return pbytes + 2 * 2 * pbytes + 4 + extras + local(
            (b, s + 1), fit_spec((dp, None), (b, s + 1), sizes), 4)
    if shape.kind == "prefill":
        return pbytes + extras + local(
            (b, s), fit_spec((dp, None), (b, s), sizes), 4)
    cshapes = dict(tree_paths(cache_shapes(cfg, b, s)))
    return (pbytes + sum(local(cshapes[p], sp, 2) for p, sp in tree_paths(
        cache_specs(cfg, dp, b, s, sizes)))
        + local((b, 1), fit_spec((dp, None), (b, 1), sizes), 4)
        + local((b,), fit_spec((dp,), (b,), sizes), 4))


def check_dryrun_cells(out_dir: Path, card_memory: float) -> list:
    """Step 14a's checks of the dry-run cells in ``out_dir`` (see the
    module doc) against ``card_memory`` bytes a card; returns their
    records."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.model import count_params

    cells = [(LM_ARCH, s, mp) for s in DRYRUN_QWEN_SHAPES
             for mp in (False, True)] + [
        ("dbrx_132b", "decode_32k", False),
        ("dbrx_132b", "prefill_32k", False),
        ("arctic_480b", "prefill_32k", False),
        ("jamba_v0_1_52b", "train_4k", False),
        ("jamba_v0_1_52b", "train_4k", True),
        ("arctic_480b", "train_4k", False),
        ("arctic_480b", "train_4k", True),
        ("dbrx_132b", "train_4k", True),
        ("llama_3_2_vision_90b", "train_4k", True)]
    out = []
    for arch, shape_name, mp in cells:
        cid = dryrun.cell_id(arch, shape_name, mp)
        res = json.loads((out_dir / f"{cid}.json").read_text())
        out.append(res)
        if not res.get("ok"):
            fail(f"dryrun: cell {cid} failed: {res.get('error')}")
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        sizes = ({"pod": 2, "data": 16, "model": 16} if mp
                 else {"data": 16, "model": 16})
        want = cell_argument_bytes(cfg, shape, sizes)
        mem = res["memory"]
        coll = res["collective_bytes_per_device"]
        line = (f"dryrun: {cid}: lower {res['lower_s']} s, analysis "
                f"{res['compile_s']} s; per device {res['flops_per_device']:.4g}"
                f" FLOP, peak {mem['peak_bytes'] / 1e9:.3f} GB of the card's "
                f"{card_memory / 1e9:.3f} GB "
                f"({100 * mem['peak_bytes'] / card_memory:.2f}%), arguments "
                f"{mem['argument_bytes']:.0f} B (counted {want}); collective "
                f"GB " + json.dumps({k: round(v / 1e9, 4)
                                     for k, v in sorted(coll.items())}))
        if shape.kind == "train":
            # the parameters a token meets: an MoE's top k of its experts
            n = count_params(cfg, active_only=True)
            n_embed = cfg.padded_vocab * cfg.d_model
            tokens = shape.global_batch * shape.seq_len
            total = res["flops_per_device"] * res["devices"]
            res["matmul_floor_ratio"] = total / (6 * (n - n_embed) * tokens)
            res["ratio_to_6nt"] = total / (6 * n * tokens)
            line += (f"; FLOPs x devices / 6·N·tokens "
                     f"{res['ratio_to_6nt']:.3f} (floor 6·(N − N_embed)"
                     f"·tokens: {res['matmul_floor_ratio']:.3f})")
            if res["matmul_floor_ratio"] < 1:
                fail(f"dryrun: {cid} counts fewer FLOPs than the matmul "
                     f"floor")
            line += f"; grad_accum {res.get('grad_accum')}"
            if res.get("grad_accum") != dryrun.GRAD_ACCUM.get(arch, 1):
                fail(f"dryrun: {cid} ran {res.get('grad_accum')} "
                     f"microbatches, not the reference's "
                     f"{dryrun.GRAD_ACCUM.get(arch, 1)}")
        ref_peak = REFERENCE_PEAK_BYTES.get(cid)
        if ref_peak is not None:
            res["reference_peak_bytes"] = ref_peak
            res["peak_to_reference"] = mem["peak_bytes"] / ref_peak
            line += (f"; the reference's peak {ref_peak / 1e9:.3f} GB, the "
                     f"port's {res['peak_to_reference']:.3f}x of it")
        print(line)
        if mem["peak_bytes"] >= card_memory:
            fail(f"dryrun: {cid} needs {mem['peak_bytes'] / 1e9:.3f} GB a "
                 f"device, over the card's {card_memory / 1e9:.3f} GB")
        if ref_peak is not None and (mem["peak_bytes"]
                                     > REFERENCE_PEAK_RATIO * ref_peak):
            fail(f"dryrun: {cid} peak {mem['peak_bytes'] / 1e9:.3f} GB is "
                 f"over {REFERENCE_PEAK_RATIO}x the reference's "
                 f"{ref_peak / 1e9:.3f} GB")
        if mem["argument_bytes"] != want:
            fail(f"dryrun: {cid} argument bytes {mem['argument_bytes']} "
                 f"differ from the spec count {want}")
        if not set(coll) <= {"all-gather", "all-reduce", "reduce-scatter",
                             "all-to-all", "collective-permute"}:
            fail(f"dryrun: {cid} counts collectives {sorted(coll)}")
        ref_coll = REFERENCE_COLLECTIVE_BYTES.get(cid)
        if ref_coll is not None:
            total = sum(coll.values())
            bar = (ref_coll + REFERENCE_COLLECTIVE_SLACK
                   if ref_coll < REFERENCE_COLLECTIVE_SMALL
                   else REFERENCE_COLLECTIVE_RATIO * ref_coll)
            res["reference_collective_bytes"] = ref_coll
            print(f"dryrun: {cid}: collectives {total / 1e9:.4f} GB a step, "
                  f"the reference's {ref_coll / 1e9:.4f} GB, bar "
                  f"{bar / 1e9:.4f} GB")
            if total > bar:
                fail(f"dryrun: {cid} moves {total / 1e9:.4f} GB of "
                     f"collectives a step, over the bar {bar / 1e9:.4f} GB "
                     f"(the reference's {ref_coll / 1e9:.4f})")
    skip_id = dryrun.cell_id(LM_ARCH, "long_500k", False)
    skip = json.loads((out_dir / f"{skip_id}.json").read_text())
    if "skipped" not in skip:
        fail("dryrun: long_500k of a full-attention arch is not skipped")
    return out


def dryrun_phase(dev, corpus, procs, out_dir: Path) -> tuple[dict, dict]:
    """Step 14: the XLA tools' port. (a) Reads the dry-run cells started at
    the beginning (``start_dryrun``); (b) the analytics cell on the card;
    (c) ``--mesh host`` training at Qwen2-0.5B's full width against
    ``--mesh none``. Returns (report, the phase's launches)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import TokenBatcher
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model, tree_paths
    from repro_torch.train import Trainer

    report = {}
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    build.reset_launches()

    # ---- 14b. the analytics cell on the card ---------------------------
    cell = dryrun.run_analytics_cell(out_dir, device=str(dev))
    report["analytics"] = cell
    for part in ("serve_4op_batch", "fused_quantile_kernel"):
        c = cell[part]
        print(f"dryrun: analytics {part}: {c['s']:.4f} s on the host clock, "
              f"work {c['bytes_accessed']:.0f} B, {c['int_ops']:.0f} int32 "
              f"ops, launches {json.dumps(c['launches'])}, peak rise "
              f"{c.get('peak_rise_bytes', float('nan')) / 2**20:.3f} MiB")
        if c["launches"].get("wm_quantile_sharded") != 1:
            fail(f"dryrun: the analytics cell's {part} launched "
                 f"wm_quantile_sharded {c['launches']}, not once (one batch)")

    # ---- 14c. --mesh host at full width against --mesh none -----------
    cfg = get_config(LM_ARCH)
    model = build_model(cfg)
    runs = {}
    for mesh_name in ("none", "host"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mesh = make_host_mesh(dev) if mesh_name == "host" else None
        t = Trainer(model, TokenBatcher(corpus=corpus, batch=TRAIN_BATCH,
                                        seq_len=TRAIN_SEQ, seed=0),
                    log_every=1, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                    total_steps=TRAIN_STEPS, device=dev, mesh=mesh)
        step_s = []
        for _ in range(MESH_HOST_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.run(1)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        params = {p: (x.full_tensor() if hasattr(x, "full_tensor") else x)
                  for p, x in tree_paths(t.state.params)}
        runs[mesh_name] = {
            "loss": [h["loss"] for h in t.history],
            "grad_norm": [h["grad_norm"] for h in t.history],
            "step_s": step_s, "first_step_s": step_s[0],
            "median_step_s": float(np.median(step_s[1:])),
            "peak_gib": peak / 2**30, "peak_rise_gib": (peak - base) / 2**30,
            "params": params}
        del t
    same = all(torch.equal(x, runs["none"]["params"][p])
               for p, x in runs["host"]["params"].items())
    mh = {"steps": MESH_HOST_STEPS, "params_equal": same,
          "loss_equal": runs["host"]["loss"] == runs["none"]["loss"],
          "grad_norm_equal": (runs["host"]["grad_norm"]
                              == runs["none"]["grad_norm"])}
    for name, r in runs.items():
        del r["params"]
        mh[name] = r
        print(f"dryrun: --mesh {name}, {LM_ARCH} full width, batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} from the store: first step "
              f"{r['first_step_s']:.3f} s, then median "
              f"{r['median_step_s']:.4f} s a step ({r['step_s']}); peak "
              f"{r['peak_gib']:.3f} GiB (rise {r['peak_rise_gib']:.3f} GiB); "
              f"losses {r['loss']}")
    report["mesh_host"] = mh
    del runs
    torch.cuda.empty_cache()
    print(f"dryrun: --mesh host against --mesh none over {MESH_HOST_STEPS} "
          f"steps: losses equal {mh['loss_equal']}, grad norms equal "
          f"{mh['grad_norm_equal']}, params bit for bit {same}")
    if not (same and mh["loss_equal"] and mh["grad_norm_equal"]):
        fail("dryrun: --mesh host training is not bit-identical to "
             "--mesh none")
    torch.cuda.synchronize()
    launches = dict(build.launches)

    # ---- 14a. the dry-run cells ----------------------------------------
    finish_dryrun(procs)
    report["cells"] = check_dryrun_cells(
        out_dir, torch.cuda.get_device_properties(dev).total_memory)

    missing = [k for k in DRYRUN_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"kernels not launched in step 14: {missing}")
    report["launches"] = launches
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"dryrun: step 14 took {report['phase_s']:.3f} s on the host clock "
          f"(the dry-run cells ran beside steps 1-10b)")
    return report, launches


def check_frontend_answers(full, seq: torch.Tensor, trace: list,
                           results: list) -> dict:
    """Hold the front-end's answers against the card: up to FE_SAMPLE
    exact answers of each op against plain torch on the raw stream
    (``seq``), and every degraded answer: a count's bounds hold the range's
    length, a quantile bracket the kernel's exact quantile, a greedy
    top-k's counts are true counts. Fails the run on a mismatch; returns
    what was checked."""
    from repro_torch.serving import ShedError
    dev = seq.device
    exact = {"count": [], "quantile": [], "topk": []}
    degraded = {"count": [], "quantile": [], "topk": []}
    for ev, a in zip(trace, results):
        if isinstance(a, ShedError):
            continue
        if a.mode == "exact" and a.coverage == 1.0:
            if len(exact[ev["op"]]) < FE_SAMPLE:
                exact[ev["op"]].append((ev, a))
        else:
            degraded[ev["op"]].append((ev, a))
    for ev, a in exact["count"]:
        if a.value != int((seq[ev["lo"]:ev["hi"]] < SIGMA).sum()):
            fail(f"front-end: count {ev} = {a.value}")
    for ev, a in exact["quantile"]:
        want = int(torch.sort(seq[ev["lo"]:ev["hi"]]).values[ev["k"]])
        if a.value != want:
            fail(f"front-end: quantile {ev} = {a.value}, plain {want}")
    for ev, a in exact["topk"]:
        bc = torch.bincount(seq[ev["lo"]:ev["hi"]].long(), minlength=SIGMA)
        syms, cnts = (torch.from_numpy(x).to(dev).long() for x in a.value)
        live = syms >= 0
        top = torch.sort(bc[bc > 0], descending=True).values[:len(cnts)]
        if not (torch.equal(bc[syms[live]], cnts[live])
                and torch.equal(cnts[live], top)):
            fail(f"front-end: top-k {ev} = {a.value}")
    for ev, a in degraded["count"]:
        length = ev["hi"] - ev["lo"]
        lower, upper = (a.value if isinstance(a.value, tuple)
                        else (a.value, length))
        if not lower <= length <= upper:
            fail(f"front-end: count bounds {ev} = {a.value}")
    if degraded["quantile"]:
        q = [ev for ev, _ in degraded["quantile"]]
        want = full.range_quantile(*(torch.tensor([e[f] for e in q],
                                                  device=dev)
                                     for f in ("lo", "hi", "k"))).tolist()
        for (ev, a), w in zip(degraded["quantile"], want):
            ok = (a.value[0] <= w < a.value[1] if isinstance(a.value, tuple)
                  else True)
            if not ok:
                fail(f"front-end: bracket {ev} = {a.value}, exact {w}")
    pairs = [(ev["lo"], ev["hi"], s, c) for ev, a in degraded["topk"]
             for s, c in zip(*a.value) if s >= 0]
    if pairs:
        p_lo, p_hi, p_s, p_c = (torch.tensor(x, device=dev)
                                for x in zip(*pairs))
        if not torch.equal(full.range_count(p_lo, p_hi, p_s, p_s + 1).long(),
                           p_c.long()):
            fail("front-end: a greedy top-k count is not a true count")
    return {f"{kind}_{op}": len(v) for kind, d in (("exact", exact),
                                                   ("degraded", degraded))
            for op, v in d.items()}


def topk_of(hist: torch.Tensor, k: int):
    """(syms, counts) of the k largest of each row, ties to the smaller
    symbol: numpy's stable argsort on the host, sharing no code with the
    port's top-k."""
    h = hist.cpu().numpy()
    order = np.argsort(-h.astype(np.int64), axis=1, kind="stable")[:, :k]
    cnts = np.take_along_axis(h, order, 1)
    syms = np.where(cnts > 0, order, -1)
    return (torch.from_numpy(syms.astype(np.int32)).to(hist.device),
            torch.from_numpy(cnts.astype(np.int32)).to(hist.device))


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (src/repro_torch "
             f"is missing)")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.analytics.engine import (build_sharded_analytics,
                                              local_ranges,
                                              sharded_range_quantile)
    from repro_torch.core import bitops
    from repro_torch.core import wavelet_tree as wtree
    from repro_torch.core.wavelet_matrix import (build_wavelet_matrix,
                                                 wm_child_interval,
                                                 wm_interval_zeros)
    from repro_torch.data import make_corpus
    from repro_torch.kernels import (bitpack, build, ops, radix_rank,
                                     rank_build, ref, topk_greedy, wm_count,
                                     wm_level, wt_level)
    from repro_torch.kernels import wm_quantile
    from repro_torch.launch import sweep_quantile
    from repro_torch.launch.analytics import make_queries
    from repro_torch.tree import tree_map

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind} (count {count}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"nvidia-smi name, power.limit: {smi}")
    dryrun_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    dryrun_procs = start_dryrun(dryrun_dir)

    # ---- 2. build the kernels ------------------------------------------
    t0 = time.perf_counter()
    chase_build = sweep_quantile.start_source("pointer_chase")
    for name in build.SOURCES:
        build.library(name)
    print(f"kernel build (nvcc, {len(build.SOURCES)} sources in parallel): "
          f"{time.perf_counter() - t0:.3f} s")
    for src, entry, shared, threads in (
            ("wm_level", "wm_level_scan_info", "static", 256),
            ("wm_level", "wm_level_move_info", "static", 256),
            ("wt_level", "wt_level_scan_info", "static", 256),
            ("rank_build", "rank_build_levels_info", "static", 512),
            ("radix_rank", "radix_scan_info",
             "static and dynamic (at 256 buckets)", 256)):
        attrs = (ctypes.c_int * 4)()
        lib = build.library(src)
        build.check(lib, getattr(lib, entry)(attrs), entry)
        print(f"{entry[:-5]} kernel: {attrs[0]} registers, {attrs[1]} B "
              f"{shared} shared memory, {attrs[2]} B local memory, "
              f"{attrs[3]} resident blocks of {threads} threads per SM")

    # ---- 3. each kernel against its plain version, ragged shapes -------
    gen = torch.Generator(device=dev).manual_seed(0)
    ragged_err = {k: 0 for k in build.launches}
    ragged_err["wm_level_move"] = 0      # counted under wm_level_step

    def bit_rows(n: int, rows: int) -> torch.Tensor:
        """Random rows plus an all-zero and an all-one row."""
        bits = torch.randint(0, 2, (rows, n), generator=gen, device=dev)
        bits[0] = 0
        bits[1] = 1
        return bits

    def twice(fn):
        """A kernel's outputs, after a second run gave the same ones."""
        first, second = fn(), fn()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            fail("two runs of a kernel on the same inputs differ")
        return first

    for n in (1, 31, 32, 128, 1000, 1024, 32 * 1025, 40_000, 131_072 + 77):
        words = bitops.pack_bits(bitops.pad_bits(bit_rows(n, 5)))
        W = bitops.num_words(n)
        got = twice(lambda: ops.rank_build_levels(words, n))
        ragged_err["rank_build_levels"] = max(
            ragged_err["rank_build_levels"],
            max_abs_err(got, rank_build.rank_build_levels_plain(words, W)),
            max_abs_err(got, ref.rank_build_levels_ref(words, n)),
            max_abs_err(ops.rank_build(words[2], n),      # L = 1
                        ref.rank_build_ref(words[2], n)))
    # the tiled scan: W of 1, a tile (16,384 words) - 1, a tile + 1 and
    # three tiles + 100, on rows longer than W (strided: off 16-byte
    # alignment), 18 rows and one (L = 1)
    tile = rank_build.TILE
    for W in (1, tile - 1, tile + 1, 3 * tile + 100):
        for rows, strided in ((18, False), (18, True), (1, True)):
            wide = torch.randint(-(1 << 31), 1 << 31, (rows, W + 3),
                                 generator=gen, device=dev,
                                 dtype=torch.int32)
            wide[0] = -1
            words = wide[:, 1:] if strided else wide
            got = twice(lambda: rank_build.rank_build_levels(words, W))
            ragged_err["rank_build_levels"] = max(
                ragged_err["rank_build_levels"],
                max_abs_err(got, rank_build.rank_build_levels_plain(words, W)))

    # the zero scans: ragged n (one tile is 8,192 keys), 1 and 4 rows, rows
    # off 16-byte alignment, all-zero and all-one rows, and one row of
    # 2^22 + 123 keys whose look-back crosses 513 tiles
    for n, rows, strided in ((1, 4, False), (31, 1, False), (1000, 4, True),
                             (8191, 4, False), (8193, 1, False),
                             (3 * 8192 + 100, 4, False),
                             (5 * 8192 + 77, 4, True), (70_001, 1, True),
                             ((1 << 22) + 123, 1, False)):
        keys = torch.randint(0, 256, (rows, n + 1), generator=gen,
                             device=dev, dtype=torch.int32)
        if rows > 1:
            keys[0], keys[1] = 0, 255
        keys = keys[:, 1:] if strided else keys[:, :n].contiguous()
        e = 0
        for shift in (0, 3, 7):
            total = wm_level.wm_level_zeros(keys, shift, 1, n)[:, 0]
            e = max(e, max_abs_err(total, wm_level.wm_level_zeros_plain(
                keys, shift, 1, n)[:, 0]))
            got = twice(lambda: wm_level.wm_level(keys, total, shift, n))
            e = max(e, max_abs_err(got, wm_level.wm_level_plain(
                keys, total, shift, n)))
            e = max(e, max_abs_err(ops.wm_level_step(keys, shift, n), got))
            ragged_err["wm_level_move"] = max(
                ragged_err["wm_level_move"], max_abs_err(
                    twice(lambda: wm_level.wm_level_move(keys, total, shift,
                                                         n)),
                    wm_level.wm_level_move_plain(keys, total, shift, n)))
            for r in range(min(rows, 2) if n < 1 << 22 else 0):
                e = max(e, max_abs_err(tuple(x[r] for x in got),
                                       ref.wm_level_step_ref(keys[r], shift,
                                                             n)))
            if n < 1 << 22:        # the kept two-launch phases
                counts = wm_level.wm_counts(keys, shift, n)
                e = max(e, max_abs_err(counts, wm_level.wm_counts_plain(
                    keys, shift, n)))
                incl = torch.cumsum(counts, 1)
                zexcl = (incl - counts).int()
                e = max(e, max_abs_err(
                    wm_level.wm_apply(keys, zexcl, total, shift, n),
                    wm_level.wm_apply_plain(keys, zexcl, total, shift, n)))
        syms = torch.randint(0, SIGMA, (rows, n), generator=gen, device=dev,
                             dtype=torch.int32)
        e = max(e, max_abs_err(
            wm_level.wm_level_zeros(syms, 0, 18, n),
            wm_level.wm_level_zeros_plain(syms, 0, 18, n)))
        ragged_err["wm_level_step"] = max(ragged_err["wm_level_step"], e)

        # a tree level at l = 0, 1, 5, 8 on the same keys; about half of the
        # nodes are empty
        for l in (0, 1, 5, 8):
            nodes, nbkt = 1 << l, 2 << l
            used = torch.randperm(nodes, generator=gen, device=dev)[
                :max(1, nodes // 2)]
            nid = torch.sort(used[torch.randint(
                0, used.numel(), (rows, n), generator=gen, device=dev)],
                1).values.to(torch.int32)
            shift = l % 8
            starts = wt_level.bucket_starts_plain(keys, nid, shift, nbkt, n)
            got = twice(lambda: wt_level.wt_level(keys, nid, shift, nbkt, n,
                                                  starts))
            e = max(max_abs_err(got, wt_level.wt_level_plain(
                        keys, nid, shift, nbkt, n, starts)),
                    max_abs_err(wt_level.wt_level(keys, nid, shift, nbkt, n),
                                got))
            if n < 1 << 22:
                e = max(e, max_abs_err((got[0][rows - 1], got[1][rows - 1]),
                                       ref.wt_level_step_ref(
                                           keys[rows - 1], nid[rows - 1],
                                           shift, n)))
            ragged_err["wt_level_step"] = max(ragged_err["wt_level_step"], e)
    del keys, syms, nid, starts, got

    # the quantile kernel against the plain descent on the directories and
    # the dense reference: S = 1, ragged n, S = 300 (past the
    # first kernel's cap of 256), and besides 1,001 random queries some that
    # cover 1, 2, 31, 32, 33, 64, 65 and more shards
    for num_shards, shard_bits, n, sigma in ((1, 12, 3000, 37),
                                             (3, 10, 2500, 2),
                                             (40, 9, 40 * 512 - 17, 1000),
                                             (128, 7, 128 * 128, 151_936),
                                             (300, 8, 300 * 256 - 5, 5000)):
        size = 1 << shard_bits
        toks = torch.randint(0, sigma, (num_shards * size,), generator=gen,
                             device=dev, dtype=torch.int32)
        toks[n:] = 0
        shards = build_wavelet_matrix(toks.reshape(num_shards, size), sigma,
                                      tau=TAU, sample_rate=SAMPLE_RATE,
                                      device=dev)
        op = ops.quantile_operands(shards, shard_bits, n)
        q = 1001                          # not a multiple of the 8-query block
        lo = torch.randint(-5, n + 5, (q,), generator=gen, device=dev)
        hi = lo + torch.randint(-3, n, (q,), generator=gen, device=dev)
        k = torch.randint(-2, n, (q,), generator=gen, device=dev)
        lo[:4] = torch.tensor([0, 5, n, n + 3], device=dev)  # full, empties
        hi[:4] = torch.tensor([n, 5, n, n + 9], device=dev)
        k[4:8] = n + 100                                     # k past the end
        spans = torch.tensor([1, 2, 31, 32, 33, 64, 65, 300, 1 << 20],
                             device=dev)
        wlo = torch.randint(0, n, (spans.numel(),), generator=gen, device=dev)
        whi = (wlo + spans * size - torch.randint(
            0, size, (spans.numel(),), generator=gen, device=dev)).clamp(
                max=n + 7)
        lo, hi = torch.cat([lo, wlo]), torch.cat([hi, whi])
        k = torch.cat([k, torch.randint(0, n, (spans.numel(),),
                                        generator=gen, device=dev)])
        got = wm_quantile.wm_quantile_sharded(op, lo, hi, k)
        e = max(max_abs_err(got, wm_quantile.wm_quantile_sharded_plain(
                    op, lo, hi, k)),
                max_abs_err(got, ref.wm_quantile_sharded_ref(
                    shards.bitvectors.rank.words, shards.zeros, shard_bits,
                    n, lo, hi, k)))
        if num_shards == 1:                # the single-matrix form, S = 1
            one = tree_map(lambda x: x[0], shards)
            e = max(e, max_abs_err(ops.wm_quantile_batch(one, lo, hi, k),
                                   ref.wm_quantile_ref(
                                       one.bitvectors.rank.words, one.zeros,
                                       one.n, lo, hi, k)))
        ragged_err["wm_quantile_sharded"] = max(
            ragged_err["wm_quantile_sharded"], e)
        # the serving front-end's count and greedy top-k kernels on the
        # same operands, every shard and a masked set: symbol bounds past
        # both ends and reversed; the greedy at the front-end's budgets of
        # 6k and 3k pops with pruning, and without it
        los, his = (t.T.contiguous() for t in local_ranges(
            shard_bits, num_shards, n, lo, hi, dev))
        s0 = torch.randint(-3, sigma + 3, (lo.numel(),), generator=gen,
                           device=dev)
        s1 = torch.randint(-3, 2 * sigma, (lo.numel(),), generator=gen,
                           device=dev)
        mask = torch.rand(num_shards, generator=gen, device=dev) > 0.3
        for his_m in (his, torch.where(mask[None], his, los)):
            ragged_err["wm_count"] = max(ragged_err["wm_count"], max_abs_err(
                wm_count.wm_count_sharded(op, los, his_m, s0, s1),
                wm_count.wm_count_plain(op, los, his_m, s0, s1)))
            for budget, prune in ((6 * FE_TOPK, True), (3 * FE_TOPK, True),
                                  (6 * FE_TOPK, False)):
                got = topk_greedy.topk_greedy(op, los[:129], his_m[:129],
                                              FE_TOPK, budget, prune)
                want = topk_greedy.topk_greedy_plain(
                    op, los[:129], his_m[:129], FE_TOPK, budget, prune)
                ragged_err["topk_greedy"] = max(
                    ragged_err["topk_greedy"],
                    *(max_abs_err(a, b) for a, b in zip(got, want)))
        # the front-end's kernels at ragged batch sizes: one query, 129 and
        # 4,096 (the batch repeated), every seventh row all empty
        for rows_q in (1, 129, 4096):
            idx = torch.arange(rows_q, device=dev) % los.shape[0]
            ql, qh = los[idx], his[idx].clone()
            qh[::7] = ql[::7]
            ragged_err["wm_count"] = max(ragged_err["wm_count"], max_abs_err(
                wm_count.wm_count_sharded(op, ql, qh, s0[idx], s1[idx]),
                wm_count.wm_count_plain(op, ql, qh, s0[idx], s1[idx])))
            if rows_q < 4096 or num_shards == 40:
                got = topk_greedy.topk_greedy(op, ql, qh, FE_TOPK,
                                              6 * FE_TOPK)
                want = topk_greedy.topk_greedy_plain(op, ql, qh, FE_TOPK,
                                                     6 * FE_TOPK)
                ragged_err["topk_greedy"] = max(
                    ragged_err["topk_greedy"],
                    *(max_abs_err(a, b) for a, b in zip(got, want)))
        if shards.nbits == 18:
            # budgets past a block's default 48 KB of shared memory: the
            # default at k = 100, 2,000 pops (opted-in shared memory) and
            # 9,000 (the slots in global scratch)
            for kk, budget in ((100, None), (FE_TOPK, 2000),
                               (FE_TOPK, 9000)):
                got = topk_greedy.topk_greedy(op, los[:9], his[:9], kk,
                                              budget)
                want = topk_greedy.topk_greedy_plain(op, los[:9], his[:9],
                                                     kk, budget)
                ragged_err["topk_greedy"] = max(
                    ragged_err["topk_greedy"],
                    *(max_abs_err(a, b) for a, b in zip(got, want)))
    del op, los, his, his_m
    for n in (1, 31, 1000, 1024, 1025, 70_001):
        for nb in (2, 33, 256, 512):
            d = torch.randint(0, nb, (3, n), generator=gen, device=dev,
                              dtype=torch.int32)
            d[0] = nb - 1                        # one bucket only
            hist = radix_rank.radix_hist(d, nb, n)
            e = max_abs_err(hist, radix_rank.radix_hist_plain(d, nb, n))
            offsets = radix_rank.bucket_offsets(hist)
            got = radix_rank.radix_apply(d, offsets, nb, n)
            e = max(e, max_abs_err(got, radix_rank.radix_apply_plain(
                d, offsets, nb, n)))
            for r in range(3):
                e = max(e, max_abs_err(got[r], ref.radix_rank_ref(d[r], nb)))
            ragged_err["radix_rank"] = max(ragged_err["radix_rank"], e)

        bits = torch.randint(0, 2, (3, n), generator=gen, device=dev,
                             dtype=torch.int32)
        bits[0] = 1
        got = bitpack.bitpack(bits, n)
        ragged_err["bitpack"] = max(
            ragged_err["bitpack"],
            max_abs_err(got, bitpack.bitpack_plain(bits, n)),
            max_abs_err(got[2], ref.bitpack_ref(bits[2])))
    # the one-sweep rank: ragged n (a tile is 8,192 digits) on 3 rows off
    # 16-byte alignment, and 2^22 + 123 digits in one row and 2^20 + 8 in 4,
    # so each bucket's look-back crosses up to 513 tiles; skewed digits, a
    # third of row 0 in the last bucket; with and without the bucket starts
    rtile = radix_rank.TILE
    for n, rows in ((1, 3), (rtile - 1, 3), (rtile + 1, 3),
                    (3 * rtile + 100, 3), (70_001, 3), ((1 << 22) + 123, 1),
                    ((1 << 20) + 8, 4)):
        for nb in (2, 33, 256, 512):
            u = torch.rand((rows, n + 1), generator=gen, device=dev)
            wide = (u.pow(4) * nb).to(torch.int32).clamp_(max=nb - 1)
            wide[0, 1:1 + n // 3] = nb - 1
            d = wide[:, 1:] if rows == 3 else wide[:, :n].contiguous()
            totals = twice(lambda: (radix_rank.radix_totals(d, nb, n),))[0]
            e = max_abs_err(totals, radix_rank.radix_totals_plain(d, nb, n))
            starts = radix_rank.exclusive_starts(totals)
            got = twice(lambda: (radix_rank.radix_scan(d, nb, n, starts),))[0]
            e = max(e, max_abs_err(got, radix_rank.radix_rank_plain(
                        d, nb, n, starts)),
                    max_abs_err(ops.radix_rank(d, nb), got),
                    max_abs_err(ops.radix_rank(d, nb, starts), got))
            for r in range(min(rows, 2)):
                e = max(e, max_abs_err(got[r], ref.radix_rank_ref(d[r], nb)))
            ragged_err["radix_rank"] = max(ragged_err["radix_rank"], e)
    del u, wide, d, totals, starts, got

    torch.cuda.synchronize()
    print(f"ragged checks, max_abs_err vs plain versions: "
          f"{json.dumps(ragged_err)}")
    if any(ragged_err.values()):
        fail(f"kernel disagrees with its plain version: {ragged_err}")

    # ---- 4. the main path at full width --------------------------------
    t0 = time.perf_counter()
    toks = make_corpus(N_TOKENS, SIGMA, seed=0)
    print(f"corpus: {N_TOKENS} tokens, sigma {SIGMA} "
          f"({time.perf_counter() - t0:.3f} s on the host)")
    lo, hi, k = make_queries(N_TOKENS, NUM_QUERIES, 1)
    sym_lo = (lo % SIGMA).astype(np.int32)
    sym_hi = np.minimum(sym_lo + 64, SIGMA).astype(np.int32)
    lo_t, hi_t, k_t, s0_t, s1_t = (torch.from_numpy(x).to(dev)
                                   for x in (lo, hi, k, sym_lo, sym_hi))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    eng = build_sharded_analytics(toks, SIGMA, shard_bits=SHARD_BITS, tau=TAU,
                                  sample_rate=SAMPLE_RATE, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    quant = eng.range_quantile(lo_t, hi_t, k_t)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    t0 = time.perf_counter()
    cnt = eng.range_count(lo_t, hi_t, s0_t, s1_t)
    torch.cuda.synchronize()
    t_count = time.perf_counter() - t0
    launches = read_launches("matrix path", MATRIX_KERNELS)
    if launches["wm_level_step"] != eng.shards.nbits + 1:
        fail(f"matrix path: {launches['wm_level_step']} wm_level_step "
             f"launches, want one a level and one totals count "
             f"({eng.shards.nbits + 1})")
    peak = torch.cuda.max_memory_allocated()
    # more batches, each of other queries, on the host clock
    serve_batches = [[torch.from_numpy(x).to(dev) for x in make_queries(
        N_TOKENS, NUM_QUERIES, 100 + b)[:3]] for b in range(SERVE_BATCHES)]
    t_batches = []
    for b in serve_batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.range_quantile(*b)
        torch.cuda.synchronize()
        t_batches.append(time.perf_counter() - t0)
    t_median = float(np.median(t_batches))
    t_all = float(np.sum(t_batches))
    print(f"build: {N_TOKENS} tokens, {eng.num_shards} shards of "
          f"{eng.shard_size} in {t_build:.6f} s "
          f"({N_TOKENS / t_build:.1f} tok/s, "
          f"{eng.bits_per_token():.4f} bits/token)")
    rank = eng.shards.bitvectors.rank
    dir_bytes = sum(x.numel() * x.element_size()
                    for x in (rank.words, rank.superblock, rank.block))
    copied = eng.quantile.words.data_ptr() != rank.words.data_ptr()
    print(f"quantile kernel operands (fixed once in the build above): the "
          f"directories read in place ({dir_bytes} B, "
          f"{'copied to pad' if copied else 'no copy'}); a launch allocates "
          f"{eng.quantile.scratch_elems * 4} B of scratch")
    print(f"serve: {NUM_QUERIES} quantiles in {t_quant * 1e3:.6f} ms "
          f"({NUM_QUERIES / t_quant:.1f} q/s) the first batch; "
          f"{SERVE_BATCHES} more batches, {SERVE_BATCHES * NUM_QUERIES} "
          f"quantiles in {t_all * 1e3:.6f} ms "
          f"({SERVE_BATCHES * NUM_QUERIES / t_all:.1f} q/s), median batch "
          f"{t_median * 1e3:.6f} ms; {NUM_QUERIES} counts in "
          f"{t_count * 1e3:.6f} ms ({NUM_QUERIES / t_count:.1f} q/s)")
    print(f"peak device memory (build + serve, the quantile scratch "
          f"included): "
          f"{peak} B ({peak / 2**30:.3f} GiB)")

    # build: leaf for leaf against the plain build on the card
    shards_in = torch.nn.functional.pad(
        torch.from_numpy(toks.astype(np.int32)).to(dev),
        (0, eng.num_shards * eng.shard_size - N_TOKENS)).reshape(
            eng.num_shards, eng.shard_size)
    t0 = time.perf_counter()
    again = build_wavelet_matrix(shards_in, SIGMA, tau=TAU,
                                 sample_rate=SAMPLE_RATE, device=dev)
    torch.cuda.synchronize()
    t_again = time.perf_counter() - t0
    del again
    t0 = time.perf_counter()
    plain = build_wavelet_matrix(shards_in, SIGMA, tau=TAU,
                                 sample_rate=SAMPLE_RATE, use_kernels=False,
                                 device=dev)
    torch.cuda.synchronize()
    print(f"build of the shards already on the card: kernel route "
          f"{t_again:.6f} s, plain route {time.perf_counter() - t0:.6f} s")
    same_leaves(eng.shards, plain, "kernel build against the plain build")
    del plain
    print("build: bit-identical to the plain build, leaf for leaf")

    want = sharded_range_quantile(eng.shards, SHARD_BITS, N_TOKENS, lo_t,
                                  hi_t, k_t)
    if not torch.equal(quant, want):
        bad = int((quant != want).sum())
        fail(f"{bad} of {NUM_QUERIES} quantiles differ from the plain descent")
    q_np, c_np = quant.cpu().numpy(), cnt.cpu().numpy()
    for i in range(NUM_NUMPY_CHECKS):
        sl = toks[lo[i]:hi[i]].astype(np.int64)
        want_q = np.partition(sl, k[i])[k[i]] if len(sl) else -1
        want_c = int(((sl >= sym_lo[i]) & (sl < sym_hi[i])).sum())
        if q_np[i] != want_q or c_np[i] != want_c:
            fail(f"query {i}: quantile {q_np[i]} (numpy {want_q}), count "
                 f"{c_np[i]} (numpy {want_c})")
    print(f"serve: {NUM_QUERIES} quantiles equal the plain descent; "
          f"{NUM_NUMPY_CHECKS} quantiles and counts equal numpy")

    # ---- 5. kernel times at the matrix path's shapes --------------------
    lat = sweep_quantile.latencies(dev, dir_bytes, sweep_quantile.finish(
        chase_build, {"pointer_chase": sweep_quantile.CHASE_ARGS}))
    print(f"dependent-load latency (one-thread pointer chase): DRAM "
          f"{lat['dram_ns']:.3f} ns over {dir_bytes} B, L2 "
          f"{lat['l2_ns']:.3f} ns over 16 MiB")
    kernels = []

    def quantile_probes(shards, shard_bits, n, lo_, hi_, k_):
        """(probes, sectors) of a batch's descent: the rank probes of its
        non-empty local ranges, and the distinct sectors of 224 bits and a
        count that they fall in (probes that share a sector need it from
        HBM once)."""
        nbits_ = shards.nbits
        S = shards.zeros.shape[0]
        los_, his_ = local_ranges(shard_bits, S, n, lo_, hi_)
        kk_ = torch.minimum(k_.long().clamp(min=0),
                            ((his_ - los_).sum(0) - 1).clamp(min=0))
        per_row = (1 << shard_bits) // sweep_quantile.LINE_BITS + 1
        first_row = torch.arange(S, device=dev)[:, None] * nbits_
        probes_, keys = 0, []
        for l in range(nbits_):
            live = his_ > los_
            probes_ += 2 * int(live.sum())
            row = (first_row + l).expand_as(los_)[live] * per_row
            keys += [row + los_[live] // sweep_quantile.LINE_BITS,
                     row + his_[live] // sweep_quantile.LINE_BITS]
            lo0, hi0 = wm_interval_zeros(shards, l, los_, his_)
            z = (hi0 - lo0).sum(0)
            bit = (kk_ >= z).long()
            kk_ = torch.where(bit == 1, kk_ - z, kk_)
            los_, his_ = wm_child_interval(shards, l, los_, his_, bit, lo0,
                                           hi0)
        return probes_, int(torch.unique(torch.cat(keys)).numel())

    def count_probes(shards, los_, his_, sym_lo, sym_hi):
        """(probes, sectors) of ``wm_count``'s descents over the (S, Q)
        local ranges ``los_``/``his_``: per level each live endpoint's
        probe for each bound that needs one, once while the two bounds'
        bits agree; none for an empty symbol range or a bound at most 0 or
        at least 2^nbits. Sectors as :func:`quantile_probes` counts them."""
        nbits_ = shards.nbits
        top = 1 << nbits_
        S = los_.shape[0]
        per_row = (1 << SHARD_BITS) // sweep_quantile.LINE_BITS + 1
        first_row = torch.arange(S, device=dev)[:, None] * nbits_
        bhi = sym_hi.long().clamp(0, top)
        blo = sym_lo.long().clamp(0, top)
        live = (his_ > los_) & (bhi > blo)[None]
        act_h = live & (bhi < top)[None]
        act_l = live & (blo > 0)[None]
        diff, length = bhi ^ blo, torch.zeros_like(bhi)
        while bool((diff > 0).any()):
            length += (diff > 0).long()
            diff = diff >> 1
        part = torch.where((bhi < top) & (blo > 0), nbits_ - length, nbits_)
        ends = {"hi": [los_.long(), his_.long()],
                "lo": [los_.long(), his_.long()]}
        probes_, keys = 0, []
        for l in range(nbits_):
            row = (first_row + l).expand_as(los_) * per_row
            second = act_l & ~((l < part)[None] & act_h)
            for m, (a_, b_) in ((act_h, ends["hi"]), (second, ends["lo"])):
                probes_ += 2 * int(m.sum())
                keys += [row[m] + a_[m] // sweep_quantile.LINE_BITS,
                         row[m] + b_[m] // sweep_quantile.LINE_BITS]
            for name, bound in (("hi", bhi), ("lo", blo)):
                a_, b_ = ends[name]
                bit = (bound >> (nbits_ - 1 - l)) & 1
                lo0, hi0 = wm_interval_zeros(shards, l, a_, b_)
                ends[name] = list(wm_child_interval(shards, l, a_, b_, bit,
                                                    lo0, hi0))
        sectors_ = int(torch.unique(torch.cat(keys)).numel()) if keys else 0
        return probes_, sectors_

    def quantile_extra(op, batches, probes, sectors, nbits, latency_ns):
        """The bare C entry's time on the first batch repeated (its probes'
        sectors warm in L2) and cycling through ``batches``, the bound's
        terms (``latency_ns`` a dependent load; bytes: the distinct
        sectors) and the scratch a launch allocates."""
        out = torch.empty(NUM_QUERIES, dtype=torch.int32, device=dev)
        scratch = torch.empty(max(1, op.scratch_elems), dtype=torch.int32,
                              device=dev)
        call = sweep_quantile.bare_entry(
            build.library("wm_quantile"),
            (*op.launch_args, scratch.data_ptr(), op.over, op.max_blocks),
            out, dev)
        heads = [tuple(x.to(torch.int32).contiguous() for x in b)
                 for b in batches]
        ptrs = [(lo_.data_ptr(), hi_.data_ptr(), k_.data_ptr(), NUM_QUERIES)
                for lo_, hi_, k_ in heads]
        return {"device_ms": sweep_quantile.event_ms(
                    [lambda: call(ptrs[0])]),
                "device_ms_cold": sweep_quantile.event_ms(
                    [lambda p=p: call(p) for p in ptrs]),
                "bound_terms_ms": {
                    "bytes": quantile_bytes(sectors) / HBM_BYTES_PER_S * 1e3,
                    "operations": probes * 40 / INT32_OPS_PER_S * 1e3,
                    "latency": nbits * latency_ns * 1e-6},
                "load_latency_ns": latency_ns, "probes": probes,
                "sectors": sectors, "scratch_bytes": op.scratch_elems * 4}

    def quantile_bytes(sectors):
        """The quantile bound's bytes: each distinct sector once, and each
        query's lo, hi, k and answer."""
        return NUM_QUERIES * 16 + sectors * SECTOR_BYTES

    def report(name, source, replaces, also, got, want, ms, plain_ms,
               nbytes, nops, path="matrix", path_launches=None,
               library_ms=None, latency_ms=0.0, extra=None, counted_as=None):
        path_launches = path_launches or launches
        counted_as = counted_as or name
        bound = bound_ms(nbytes, nops, latency_ms)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "also_replaces": also, "path": path,
               "counted_as": counted_as,
               "launches": path_launches[counted_as], "max_abs_err": max(
                   max_abs_err(got, want), ragged_err[name]),
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                            >= nops / INT32_OPS_PER_S else "operations"),
               "library_ms": library_ms, "bytes": nbytes, "ops": nops,
               **(extra or {})}
        row["check"] = "pass" if row["max_abs_err"] == 0 else "FAIL"
        lib = "" if library_ms is None else f", library {library_ms:.6f} ms"
        dev_ms = ("" if "device_ms" not in row else
                  f", device {row['device_ms']:.6f} ms warm / "
                  f"{row['device_ms_cold']:.6f} ms cold")
        print(f"{name} ({path} path): {ms:.6f} ms{dev_ms} (plain "
              f"{plain_ms:.6f} ms, bound {bound:.6f} ms by {row['bound_by']}"
              f"{' and latency' if latency_ms else ''}{lib}), "
              f"{path_launches[counted_as]} {counted_as} launches on the "
              f"{path} path")
        kernels.append(row)

    size = eng.shard_size
    rank = eng.shards.bitvectors.rank
    words = rank.words.reshape(-1, rank.words.shape[-1])
    R, W = words.shape
    got = ops.rank_build_levels(words, size)
    report("rank_build_levels", "src/repro_torch/kernels/csrc/rank_build.cu",
           "src/repro/kernels/rank_build.py:98",
           ["src/repro/kernels/rank_build.py:53"], got,
           rank_build.rank_build_levels_plain(words, W),
           cuda_ms(lambda: ops.rank_build_levels(words, size), 20),
           cuda_ms(lambda: rank_build.rank_build_levels_plain(words, W), 5),
           R * W * 4 + got[0].numel() * 4 + got[1].numel() * 2, R * W * 8)

    nbits = eng.shards.nbits
    keys = bitops.extract_field(shards_in, nbits - TAU, TAU).to(torch.int32)
    totals = ops.wm_level_zeros(shards_in, nbits)[:, 0]
    level_bits = (keys >> (TAU - 1)) & 1
    got = ops.wm_level_step(keys, TAU - 1, size, totals)
    report("wm_level_step", "src/repro_torch/kernels/csrc/wm_level.cu",
           "src/repro/kernels/wm_level.py:132",
           ["src/repro/kernels/wm_level.py:52",
            "src/repro/kernels/wm_level.py:166"], got,
           wm_level.wm_level_plain(keys, totals, TAU - 1, size),
           cuda_ms(lambda: ops.wm_level_step(keys, TAU - 1, size, totals), 20),
           cuda_ms(lambda: wm_level.wm_level_plain(keys, totals, TAU - 1,
                                                   size), 3),
           keys.numel() * 8 + got[1].numel() * 4 + got[2].numel() * 4,
           keys.numel() * 24,
           library_ms=cuda_ms(lambda: torch.sort(level_bits, dim=1,
                                                 stable=True), 20))
    del level_bits
    # the move mode on the store's own packed keys: (field << 20) | position,
    # the level's bit 20 higher (the build's first level of a chunk)
    low = max(1, (size - 1).bit_length())
    packed = (keys << low) | torch.arange(size, dtype=torch.int32, device=dev)
    got = ops.wm_level_move(packed, TAU - 1 + low, size, totals)
    report("wm_level_move", "src/repro_torch/kernels/csrc/wm_level.cu",
           "src/repro/kernels/wm_level.py:132",
           ["src/repro/kernels/wm_level.py:52",
            "src/repro/kernels/wm_level.py:166"], got,
           wm_level.wm_level_move_plain(packed, totals, TAU - 1 + low, size),
           cuda_ms(lambda: ops.wm_level_move(packed, TAU - 1 + low, size,
                                             totals), 20),
           cuda_ms(lambda: wm_level.wm_level_move_plain(
               packed, totals, TAU - 1 + low, size), 3),
           packed.numel() * 8 + got[1].numel() * 4 + got[2].numel() * 4,
           packed.numel() * 24, counted_as="wm_level_step")
    del packed, got
    probes, sectors = quantile_probes(eng.shards, SHARD_BITS, N_TOKENS, lo_t,
                                      hi_t, k_t)
    print(f"wm_quantile_sharded: {probes} rank probes for {NUM_QUERIES} "
          f"queries ({probes / NUM_QUERIES:.2f} per query) in {sectors} "
          f"distinct 32-byte sectors")
    cold_batches = [(lo_t, hi_t, k_t)] + serve_batches[:COLD_BATCHES - 1]
    op = eng.quantile
    got = wm_quantile.wm_quantile_sharded(op, lo_t, hi_t, k_t)
    report("wm_quantile_sharded",
           "src/repro_torch/kernels/csrc/wm_quantile.cu",
           "src/repro/kernels/wm_quantile.py:128",
           ["src/repro/kernels/wm_quantile.py:165"],
           (got, got), (want, wm_quantile.wm_quantile_sharded_plain(
               op, lo_t, hi_t, k_t)),
           cuda_ms(lambda: wm_quantile.wm_quantile_sharded(
               op, lo_t, hi_t, k_t), 20),
           cuda_ms(lambda: wm_quantile.wm_quantile_sharded_plain(
               op, lo_t, hi_t, k_t), 3),
           quantile_bytes(sectors), probes * 40,
           latency_ms=nbits * lat["dram_ns"] * 1e-6,
           extra=quantile_extra(op, cold_batches, probes, sectors, nbits,
                                lat["dram_ns"]))

    # the front-end's count and greedy top-k kernels at its widest bucket
    # on the full-width engine: the counts over every symbol, [0, σ) (the
    # low bound known, no probe), and over random [s0, s1) pairs of the
    # run's seed; the greedy top-k at most 6k pops, ladder level 1. Their
    # launches are those of the front-end gate (step 10b), filled in there.
    # Bounds: the count's distinct directory sectors (as the quantile's)
    # against its nbits dependent DRAM loads; the greedy's pops, one
    # dependent DRAM load each (a pop reads the weights of the pop before),
    # the most pops of the batch's queries, against its bytes
    fe_q = FE_BUCKETS[-1]
    fe_los, fe_his = (t.T.contiguous() for t in local_ranges(
        SHARD_BITS, eng.num_shards, N_TOKENS, lo_t[:fe_q], hi_t[:fe_q], dev))
    fe_s0 = torch.zeros(fe_q, dtype=torch.int32, device=dev)
    fe_s1 = torch.full((fe_q,), SIGMA, dtype=torch.int32, device=dev)
    rnd = torch.randint(0, SIGMA + 1, (2, fe_q), generator=torch.Generator(
        device=dev).manual_seed(27), device=dev,
        dtype=torch.int32).sort(0).values
    live = int((fe_his > fe_los).sum())
    terms = {}
    for tag, (a0, a1) in (("all", (fe_s0, fe_s1)), ("random", rnd)):
        c_probes, c_sectors = count_probes(eng.shards, fe_los.T, fe_his.T,
                                           a0, a1)
        c_bytes = fe_los.numel() * 8 + fe_q * 12 + c_sectors * SECTOR_BYTES
        terms[tag] = {
            "ms": cuda_ms(lambda a0=a0, a1=a1: wm_count.wm_count_sharded(
                op, fe_los, fe_his, a0, a1), 20),
            "probes": c_probes, "sectors": c_sectors, "bytes": c_bytes,
            "bound_ms": bound_ms(c_bytes, c_probes * wm_quantile.PROBE_OPS,
                                 nbits * lat["dram_ns"] * 1e-6),
            "check": max_abs_err(wm_count.wm_count_sharded(op, fe_los, fe_his,
                                                           a0, a1),
                                 wm_count.wm_count_plain(op, fe_los, fe_his,
                                                         a0, a1))}
        ragged_err["wm_count"] = max(ragged_err["wm_count"],
                                     terms[tag]["check"])
    print("wm_count: [0, σ) and random symbol ranges: " + json.dumps(terms))
    got = wm_count.wm_count_sharded(op, fe_los, fe_his, fe_s0, fe_s1)
    report("wm_count", "src/repro_torch/kernels/csrc/wm_count.cu",
           "src/repro/analytics/engine.py:97 sharded_range_count (XLA; no "
           "Pallas kernel)", [], got,
           wm_count.wm_count_plain(op, fe_los, fe_his, fe_s0, fe_s1),
           terms["all"]["ms"],
           cuda_ms(lambda: wm_count.wm_count_plain(
               op, fe_los, fe_his, fe_s0, fe_s1), 3),
           terms["all"]["bytes"],
           terms["all"]["probes"] * wm_quantile.PROBE_OPS,
           path="frontend", path_launches={"wm_count": 0},
           latency_ms=nbits * lat["dram_ns"] * 1e-6,
           extra={"queries": fe_q, "live_pairs": live,
                  "symbol_ranges": terms})
    got = topk_greedy.topk_greedy(op, fe_los, fe_his, FE_TOPK, 6 * FE_TOPK)
    pops = torch.zeros(fe_q, dtype=torch.long, device=dev)
    want = topk_greedy.topk_greedy_plain(op, fe_los, fe_his, FE_TOPK,
                                         6 * FE_TOPK, pops=pops)
    most_pops = int(pops.max())
    report("topk_greedy", "src/repro_torch/kernels/csrc/topk_greedy.cu",
           "src/repro/analytics/range_ops.py:198 _topk_frontier (XLA loop; "
           "no Pallas kernel)", [], got, want,
           cuda_ms(lambda: topk_greedy.topk_greedy(
               op, fe_los, fe_his, FE_TOPK, 6 * FE_TOPK), 20),
           cuda_ms(lambda: topk_greedy.topk_greedy_plain(
               op, fe_los, fe_his, FE_TOPK, 6 * FE_TOPK), 2),
           fe_los.numel() * 8 + fe_q * (2 * FE_TOPK + 1) * 4, 0,
           path="frontend", path_launches={"topk_greedy": 0},
           latency_ms=most_pops * lat["dram_ns"] * 1e-6,
           extra={"queries": fe_q, "budget": 6 * FE_TOPK,
                  "most_pops": most_pops,
                  "mean_pops": float(pops.float().mean())})
    del fe_los, fe_his, fe_s0, fe_s1

    # the single-row and single-shard forms, and the two phases of each
    # two-launch kernel, each timed alone (they share the rows' launch
    # counters)
    phases = []

    def report_phase(name, replaces, got, want, ms, plain_ms, nbytes, nops,
                     launches_on_path, latency_ms=0.0, extra=None):
        bound = bound_ms(nbytes, nops, latency_ms)
        err = max_abs_err(got, want)
        phases.append({"name": name, "replaces": replaces, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                                    >= nops / INT32_OPS_PER_S
                                    else "operations"),
                       "launches": launches_on_path, "max_abs_err": err,
                       "bytes": nbytes, "ops": nops, **(extra or {})})
        dev_ms = ("" if not extra else
                  f", device {extra['device_ms']:.6f} ms warm / "
                  f"{extra['device_ms_cold']:.6f} ms cold")
        print(f"{name}: {ms:.6f} ms{dev_ms} (plain {plain_ms:.6f} ms, bound "
              f"{bound:.6f} ms), max_abs_err {err}")
        if err:
            fail(f"{name} disagrees with its plain version")

    zeros = ops.wm_level_zeros(shards_in, nbits)
    report_phase("wm_level_zeros (every level's totals, once a build)",
                 "src/repro/kernels/wm_level.py:132", zeros,
                 wm_level.wm_level_zeros_plain(shards_in, 0, nbits, size),
                 cuda_ms(lambda: ops.wm_level_zeros(shards_in, nbits), 20),
                 cuda_ms(lambda: wm_level.wm_level_zeros_plain(
                     shards_in, 0, nbits, size), 3),
                 shards_in.numel() * 4 + zeros.numel() * 4,
                 shards_in.numel() * nbits, 1)
    del zeros
    # the reference's two phase kernels, off the build path, and the
    # two-launch level they make, at the same shape as the one-launch level
    counts = wm_level.wm_counts(keys, TAU - 1, size)
    report_phase("wm_counts", "src/repro/kernels/wm_level.py:52", counts,
                 wm_level.wm_counts_plain(keys, TAU - 1, size),
                 cuda_ms(lambda: wm_level.wm_counts(keys, TAU - 1, size), 20),
                 cuda_ms(lambda: wm_level.wm_counts_plain(keys, TAU - 1,
                                                          size), 3),
                 keys.numel() * 4 + counts.numel() * 4, keys.numel() * 4, 0)
    incl = torch.cumsum(counts, 1)
    zexcl, total = (incl - counts).int(), incl[:, -1].int()
    got = wm_level.wm_apply(keys, zexcl, total, TAU - 1, size)
    report_phase("wm_apply", "src/repro/kernels/wm_level.py:166", got,
                 wm_level.wm_apply_plain(keys, zexcl, total, TAU - 1, size),
                 cuda_ms(lambda: wm_level.wm_apply(keys, zexcl, total,
                                                   TAU - 1, size), 20),
                 cuda_ms(lambda: wm_level.wm_apply_plain(
                     keys, zexcl, total, TAU - 1, size), 3),
                 keys.numel() * 8 + got[1].numel() * 4 + zexcl.numel() * 4,
                 keys.numel() * 20, 0)

    def two_launch_level():
        c = wm_level.wm_counts(keys, TAU - 1, size)
        inc = torch.cumsum(c, 1)
        t = inc[:, -1].int()
        return (*wm_level.wm_apply(keys, (inc - c).int(), t, TAU - 1, size),
                t)

    report_phase("wm_level two-launch (wm_counts + cumsum + wm_apply)",
                 "src/repro/kernels/wm_level.py:132", two_launch_level(),
                 wm_level.wm_level_plain(keys, totals, TAU - 1, size),
                 cuda_ms(two_launch_level, 20),
                 cuda_ms(lambda: wm_level.wm_level_plain(keys, totals,
                                                         TAU - 1, size), 3),
                 keys.numel() * 8 + got[1].numel() * 4 + total.numel() * 4,
                 keys.numel() * 24, 0)
    row0 = words[:1]
    got = ops.rank_build(row0[0], size)
    report_phase("rank_build (L = 1, one level of one shard)",
                 "src/repro/kernels/rank_build.py:53", got,
                 tuple(x[0] for x in rank_build.rank_build_levels_plain(
                     row0, W)),
                 cuda_ms(lambda: ops.rank_build(row0[0], size), 20),
                 cuda_ms(lambda: rank_build.rank_build_levels_plain(row0, W),
                         5),
                 W * 4 + got[0].numel() * 4 + got[1].numel() * 2, W * 8, 0)
    one = tree_map(lambda x: x[0], eng.shards)

    def fold(lo_, hi_, k_):
        """The same widths inside shard 0."""
        lo1_ = lo_ % size
        return lo1_, torch.minimum(lo1_ + (hi_ - lo_).clamp(min=0),
                                   torch.tensor(size, device=dev,
                                                dtype=lo1_.dtype)), k_
    lo1, hi1, _ = fold(lo_t, hi_t, k_t)
    op1 = ops.quantile_operands(tree_map(lambda x: x[None], one),
                                SHARD_BITS, size)
    got = wm_quantile.wm_quantile_sharded(op1, lo1, hi1, k_t)
    want1 = ref.wm_quantile_ref(one.bitvectors.rank.words, one.zeros, one.n,
                                lo1, hi1, k_t)
    probes1, sectors1 = quantile_probes(
        tree_map(lambda x: x[None], one), SHARD_BITS, size, lo1, hi1, k_t)
    report_phase("wm_quantile (S = 1, one shard)",
                 "src/repro/kernels/wm_quantile.py:165",
                 (got, got, ops.wm_quantile_batch(one, lo1, hi1, k_t)),
                 (want1, wm_quantile.wm_quantile_sharded_plain(
                     op1, lo1, hi1, k_t), want1),
                 cuda_ms(lambda: wm_quantile.wm_quantile_sharded(
                     op1, lo1, hi1, k_t), 20),
                 cuda_ms(lambda: wm_quantile.wm_quantile_sharded_plain(
                     op1, lo1, hi1, k_t), 3),
                 quantile_bytes(sectors1), probes1 * 40, 0,
                 latency_ms=nbits * lat["l2_ns"] * 1e-6,  # 2.4 MB: in L2
                 extra=quantile_extra(op1, [fold(*b) for b in cold_batches],
                                      probes1, sectors1, nbits,
                                      lat["l2_ns"]))
    del op1
    del keys, totals, counts, incl, zexcl, total, got, one

    # ---- 6. the tree path at full width: one wavelet tree of the stream --
    seq = shards_in.reshape(-1)[:N_TOKENS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    wt = wtree.build_wavelet_tree(seq, SIGMA, tau=TAU, big_step="radix",
                                  sample_rate=SAMPLE_RATE, device=dev)
    torch.cuda.synchronize()
    t_tree = time.perf_counter() - t0
    tree_launches = read_launches("tree path", TREE_KERNELS)
    if tree_launches["wt_level_step"] != 8:
        fail(f"tree path: {tree_launches['wt_level_step']} wt_level_step "
             f"launches, want one for each moved level l <= 8 (8)")
    if tree_launches["radix_rank"] != 1:
        fail(f"tree path: {tree_launches['radix_rank']} radix_rank launches, "
             f"want one scan given the bucket starts (1)")
    peak_tree = torch.cuda.max_memory_allocated()
    print(f"tree build (radix big step, tokens already on the card): "
          f"{N_TOKENS} tokens in {t_tree:.6f} s "
          f"({N_TOKENS / t_tree:.1f} tok/s, "
          f"{bits_per_token(wt, N_TOKENS):.4f} bits/token); peak device "
          f"memory {peak_tree} B ({peak_tree / 2**30:.3f} GiB)")

    build.reset_launches()
    t0 = time.perf_counter()
    wt_compose = wtree.build_wavelet_tree(seq, SIGMA, tau=TAU,
                                          sample_rate=SAMPLE_RATE, device=dev)
    torch.cuda.synchronize()
    t_compose = time.perf_counter() - t0
    print(f"tree build (compose big step) launches: "
          f"{json.dumps(build.launches)}")
    t0 = time.perf_counter()
    wt_plain = wtree.build_wavelet_tree(seq, SIGMA, tau=TAU, big_step="radix",
                                        sample_rate=SAMPLE_RATE,
                                        use_kernels=False, device=dev)
    torch.cuda.synchronize()
    print(f"tree build: compose big step {t_compose:.6f} s, plain route "
          f"{time.perf_counter() - t0:.6f} s")
    same_leaves(wt, wt_compose, "tree: radix build against the compose "
                "build")
    same_leaves(wt, wt_plain, "tree: kernel build against the plain build")
    del wt_compose, wt_plain
    print("tree build: radix, compose and plain builds equal leaf for leaf")

    build.reset_launches()
    t0 = time.perf_counter()
    radix_shards = build_wavelet_matrix(shards_in, SIGMA, tau=TAU,
                                        big_step="radix",
                                        sample_rate=SAMPLE_RATE, device=dev)
    torch.cuda.synchronize()
    radix_launches = dict(build.launches)
    print(f"sharded matrix, radix big step: {time.perf_counter() - t0:.6f} s,"
          f" launches {json.dumps(radix_launches)}")
    if radix_launches["radix_rank"] != 4:
        fail(f"sharded matrix, radix big step: {radix_launches['radix_rank']} "
             f"radix_rank launches, want a totals count and a scan for each "
             f"of its 2 big steps (4)")
    same_leaves(eng.shards, radix_shards, "sharded matrix: radix build "
                "against the compose build")
    del radix_shards
    print("sharded matrix: radix build equals the compose build leaf for leaf")

    rng = np.random.default_rng(2)
    q_pos = rng.integers(0, N_TOKENS, NUM_QUERIES)
    q_sym = toks[rng.integers(0, N_TOKENS, NUM_QUERIES)].astype(np.int64)
    q_end = rng.integers(0, N_TOKENS + 1, NUM_QUERIES)
    q_k = rng.integers(0, 1 << 30, NUM_QUERIES) % np.bincount(
        toks, minlength=SIGMA)[q_sym]
    pos_t, sym_t, end_t, kk_t = (torch.from_numpy(x).to(dev)
                                 for x in (q_pos, q_sym, q_end, q_k))
    answers, rates = [], []
    for op, args in (("access", (pos_t,)), ("rank", (sym_t, end_t)),
                     ("select", (sym_t, kk_t))):
        fn = getattr(wtree, f"wt_{op}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(wt, *args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        answers.append(out.cpu().numpy())
        rates.append(f"{op} {dt * 1e3:.6f} ms ({NUM_QUERIES / dt:.1f} q/s)")
    print(f"tree queries, {NUM_QUERIES} each: {', '.join(rates)}")
    acc, rnk, sel = answers
    for j in range(NUM_NUMPY_CHECKS):
        c = q_sym[j]
        want = (int(toks[q_pos[j]]),
                int(np.count_nonzero(toks[:q_end[j]] == c)),
                int(np.flatnonzero(toks == c)[q_k[j]]))
        if (acc[j], rnk[j], sel[j]) != want:
            fail(f"tree query {j}: access/rank/select {acc[j]}, {rnk[j]}, "
                 f"{sel[j]} (numpy {want})")
    print(f"tree queries: {NUM_NUMPY_CHECKS} each of access, rank and select "
          f"equal numpy")

    # tree kernels at the tree path's shapes
    n = N_TOKENS
    nbkt0 = 1 << TAU
    digits = (seq >> (nbits - TAU)).contiguous()  # first big step's digits
    starts = wt.node_starts[TAU, :nbkt0]          # the tree's hand-over

    def radix_plain():
        return radix_rank.radix_rank_plain(digits[None], nbkt0, n,
                                           starts[None])[0]

    got = ops.radix_rank(digits, nbkt0, starts)
    report("radix_rank", "src/repro_torch/kernels/csrc/radix_rank.cu",
           "src/repro/kernels/radix_rank.py:52",
           ["src/repro/kernels/radix_rank.py:79"], got, radix_plain(),
           cuda_ms(lambda: ops.radix_rank(digits, nbkt0, starts), 20),
           cuda_ms(radix_plain, 3), n * 8 + nbkt0 * 4, n * 8, path="tree",
           path_launches=tree_launches,
           library_ms=cuda_ms(lambda: torch.sort(digits, stable=True), 20))

    # the form without starts (the matrix radix build's), its totals count,
    # and the reference's two phase kernels, off every path
    report_phase("radix_rank without starts (radix_totals + radix_scan)",
                 "src/repro/kernels/radix_rank.py:52",
                 ops.radix_rank(digits, nbkt0), got,
                 cuda_ms(lambda: ops.radix_rank(digits, nbkt0), 20),
                 cuda_ms(lambda: radix_rank.radix_rank_plain(
                     digits[None], nbkt0, n), 3),
                 n * 8, n * 8, radix_launches["radix_rank"])
    totals = radix_rank.radix_totals(digits[None], nbkt0, n)
    report_phase("radix_totals", "src/repro/kernels/radix_rank.py:52",
                 totals, radix_rank.radix_totals_plain(digits[None], nbkt0,
                                                       n),
                 cuda_ms(lambda: radix_rank.radix_totals(digits[None], nbkt0,
                                                         n), 20),
                 cuda_ms(lambda: radix_rank.radix_totals_plain(
                     digits[None], nbkt0, n), 3),
                 n * 4 + totals.numel() * 4, n * 4,
                 radix_launches["radix_rank"] // 2)
    hist = radix_rank.radix_hist(digits[None], nbkt0, n)
    report_phase("radix_hist", "src/repro/kernels/radix_rank.py:52", hist,
                 radix_rank.radix_hist_plain(digits[None], nbkt0, n),
                 cuda_ms(lambda: radix_rank.radix_hist(digits[None], nbkt0,
                                                       n), 20),
                 cuda_ms(lambda: radix_rank.radix_hist_plain(
                     digits[None], nbkt0, n), 3),
                 n * 4 + hist.numel() * 4, n * 4, 0)
    offsets = radix_rank.bucket_offsets(hist)
    report_phase("radix_apply", "src/repro/kernels/radix_rank.py:79",
                 radix_rank.radix_apply(digits[None], offsets, nbkt0, n),
                 radix_rank.radix_apply_plain(digits[None], offsets,
                                              nbkt0, n),
                 cuda_ms(lambda: radix_rank.radix_apply(
                     digits[None], offsets, nbkt0, n), 20),
                 cuda_ms(lambda: radix_rank.radix_apply_plain(
                     digits[None], offsets, nbkt0, n), 3),
                 n * 8 + offsets.numel() * 4, n * 8, 0)
    del hist, offsets, totals, digits

    # level TAU: the first level after the first big step, 2^(TAU+1) buckets
    order = wtree._tree_big_step(seq, nbits, TAU, "radix", True,
                                 wt.node_starts)
    sub = bitops.extract_field(order, nbits - 2 * TAU, TAU).to(torch.int32)
    nid = wtree._level_nid(wt.node_starts, TAU, n)
    nbkt, shift = 1 << (TAU + 1), TAU - 1
    starts = wt.node_starts[TAU + 1, :nbkt]
    del order

    def wt_plain():
        dest, bitmap = wt_level.wt_level_plain(sub[None], nid[None], shift,
                                               nbkt, n, starts[None])
        return dest[0], bitmap[0]

    key = (nid << 1) | ((sub >> shift) & 1)
    got = ops.wt_level_step_fused(sub, nid, shift, nbkt, n, starts)
    report("wt_level_step", "src/repro_torch/kernels/csrc/wt_level.cu",
           "src/repro/kernels/wt_level.py:83", [], got, wt_plain(),
           cuda_ms(lambda: ops.wt_level_step_fused(sub, nid, shift, nbkt, n,
                                                   starts), 20),
           cuda_ms(wt_plain, 3), n * 12 + got[1].numel() * 4, n * 12,
           path="tree", path_launches=tree_launches,
           library_ms=cuda_ms(lambda: torch.sort(key, stable=True), 20))
    del key

    # level 0: one node, two buckets, the same work per key
    sub0 = bitops.extract_field(seq, nbits - TAU, TAU).to(torch.int32)
    nid0 = torch.zeros_like(sub0)
    starts0 = wt.node_starts[1, :2]
    got = ops.wt_level_step_fused(sub0, nid0, TAU - 1, 2, n, starts0)
    report_phase("wt_level_step (l = 0)", "src/repro/kernels/wt_level.py:83",
                 got, tuple(x[0] for x in wt_level.wt_level_plain(
                     sub0[None], nid0[None], TAU - 1, 2, n, starts0[None])),
                 cuda_ms(lambda: ops.wt_level_step_fused(
                     sub0, nid0, TAU - 1, 2, n, starts0), 20),
                 cuda_ms(lambda: wt_level.wt_level_plain(
                     sub0[None], nid0[None], TAU - 1, 2, n, starts0[None]),
                     3),
                 n * 12 + got[1].numel() * 4, n * 12,
                 tree_launches["wt_level_step"])
    del sub0, nid0

    bits = ((sub >> (shift - 1)) & 1).contiguous()
    got = ops.bitpack(bits)
    report("bitpack", "src/repro_torch/kernels/csrc/bitpack.cu",
           "src/repro/kernels/bitpack.py:26", [], got,
           bitpack.bitpack_plain(bits[None], n)[0],
           cuda_ms(lambda: ops.bitpack(bits), 20),
           cuda_ms(lambda: bitpack.bitpack_plain(bits[None], n), 3),
           n * 4 + got.numel() * 4, n * 2, path="tree",
           path_launches=tree_launches)

    tw = wt.bitvectors.rank.words
    TL, TW = tw.shape
    got = ops.rank_build_levels(tw, n)
    report("rank_build_levels", "src/repro_torch/kernels/csrc/rank_build.cu",
           "src/repro/kernels/rank_build.py:98",
           ["src/repro/kernels/rank_build.py:53"], got,
           rank_build.rank_build_levels_plain(tw, TW),
           cuda_ms(lambda: ops.rank_build_levels(tw, n), 20),
           cuda_ms(lambda: rank_build.rank_build_levels_plain(tw, TW), 5),
           TL * TW * 4 + got[0].numel() * 4 + got[1].numel() * 2,
           TL * TW * 8, path="tree", path_launches=tree_launches)

    # ---- 7. every other construction at full width ---------------------
    # (the engine of step 4 stays on the card for step 9)
    del shards_in
    construction, phase_launches = construction_phase(
        dev, toks, seq, wt, (pos_t, sym_t, end_t, kk_t), (acc, rnk, sel))

    # ---- 8. the full-text index at full width --------------------------
    index, index_launches, idx = index_phase(dev, toks, seq, report)

    # ---- 9. the rest of the analytics engine, the store, snapshots,
    #         verify and repair at full width -------------------------------
    analytics, analytics_launches = analytics_phase(
        dev, toks, eng, idx, (lo, hi, k, sym_lo, sym_hi), quant, cnt)
    del idx

    # ---- 10. crash-safe ingest and the query front-end at full width ----
    ingest, serving, ingest_launches, serving_launches = ingest_serving_phase(
        dev, toks, seq, eng, (lo, hi, k), quant)

    # ---- 10b. the front-end smoke at overload 5 behind its p99 gate ------
    gate_report, gate_launches = frontend_gate_phase(dev)
    for row in kernels:
        if row["path"] == "frontend":
            row["launches"] = gate_launches[row["name"]]

    # ---- 11. repro_torch.obs through the engine, the CLIs and chaos -----
    wrapper_ms = next(row["ms"] for row in kernels
                      if row["name"] == "wm_quantile_sharded")
    obs_report, obs_launches = obs_phase(
        dev, toks, eng, (lo_t, hi_t, k_t), serve_batches, wrapper_ms,
        quantile_bytes(sectors), dryrun_procs)
    del eng

    # ---- 12. the examples and the LM serving path ----------------------
    lm_report, lm_launches = lm_phase(dev)

    # ---- 13. the LM training half, fed from the store ------------------
    train_report, train_launches, corpus = train_phase(dev, toks)

    # ---- 14. the XLA tools: dry run, analytics cell, --mesh host -------
    dryrun_report, dryrun_launches = dryrun_phase(dev, corpus, dryrun_procs,
                                                  dryrun_dir)
    del corpus
    shutil.rmtree(dryrun_dir, ignore_errors=True)
    for row in kernels:
        key = row["counted_as"]
        row["construction_launches"] = phase_launches[key]
        row["index_launches"] = index_launches[key]
        row["analytics_launches"] = analytics_launches[key]
        row["ingest_launches"] = ingest_launches[key]
        row["serving_launches"] = serving_launches[key]
        row["frontend_gate_launches"] = gate_launches[key]
        row["obs_launches"] = obs_launches[key]
        row["lm_launches"] = lm_launches[key]
        row["train_launches"] = train_launches[key]
        row["dryrun_launches"] = dryrun_launches[key]

    print(json.dumps({"construction": construction}))
    print(json.dumps({"index": index}))
    print(json.dumps({"analytics": analytics}))
    print(json.dumps({"ingest": ingest}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"frontend_gate": gate_report}))
    print(json.dumps({"obs": obs_report}))
    print(json.dumps({"lm": lm_report}))
    print(json.dumps({"train": train_report}))
    print(json.dumps({"dryrun": dryrun_report}))
    print(json.dumps({"phases": phases}))
    print(json.dumps({"kernels": kernels}))
    if any(row["check"] != "pass" for row in kernels):
        fail("a kernel disagrees with its plain version at full width")
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
