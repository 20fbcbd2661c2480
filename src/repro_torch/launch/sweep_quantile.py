"""Variants of the sharded range-quantile kernel, timed on the card at the
bare C entry, beside the card's dependent-load latency.

Builds ``launch/csrc/wm_quantile_variants.cu`` once for each layout (the
directories read in place, "no-copy", as the serving kernel does; a copy
cut into 32-byte "rank lines", one sector a probe, built by
:func:`line_rows`; 64-byte lines) and each (queries a warp, probe rounds
kept in registers, resident blocks asked of nvcc) shape, from copies whose
constants are rewritten; the serving kernel (``kernels/csrc/wm_quantile.cu``)
as it is; two ablations of it (every probe reads block 0 of its row, so no
probe reaches DRAM; no probe loads at all); and the first CUDA form of the
kernel (``launch/csrc/wm_quantile_warp_v1.cu``, "warp_v1") as it is. All
builds run at once.

Every variant answers the matrix path's batch at full width (4,096
queries of ``make_queries``, seed 1, over 128 shards of 2^20 of a
2^27-token Zipfian stream, σ = 151,936), its narrow (width < 256) and wide
halves alone, and the single-shard form (the same queries folded into
shard 0, S = 1), and is checked against the plain descent (not the
ablations; the line layouts' plain descent, :func:`wm_quantile_lines_plain`,
is held against the reference on the CPU in
``tests/test_torch_quantile_lines.py``). It is timed by CUDA events over back-to-back launches of its
C entry with every pointer resolved once, in two passes of opposite order:
on one batch repeated (``*_ms``, the batch's sectors warm in L2) and on
eight batches of seeds 1-8 in turn (``*_cold_ms``, as a server meets
them). The serving kernel, the best line and no-copy variants and warp_v1
are also read by ``torch.profiler`` (device time of the kernel alone).
The last line applies the layout rule: keep the no-copy layout if its
best time is within 1.3x of the best line layout's.

A one-thread pointer chase (``launch/csrc/pointer_chase.cu``) over a buffer
the size of the directories gives the DRAM round trip, and over 16 MB the
L2 round trip; nbits DRAM round trips are the descent's latency floor.

PYTHONPATH=src python -m repro_torch.launch.sweep_quantile

Needs a CUDA device and ``nvcc``; there is nothing to measure on the CPU.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.analytics import build_sharded_analytics
from repro_torch.core import bitops
from repro_torch.core.rank_select import BinaryRank, rank1
from repro_torch.data import make_corpus
from repro_torch.device import resolve_device
from repro_torch.kernels import build, ops, wm_quantile
from repro_torch.launch.analytics import make_queries
from repro_torch.tree import tree_map

HERE = Path(__file__).resolve().parent / "csrc"
VARIANTS = HERE / "wm_quantile_variants.cu"
LINE_WORDS = 7                 # words of a 32-byte rank line after its count
LINE_BITS = 32 * LINE_WORDS    # positions a line covers
LAYOUTS = {"no-copy": 0, "lines32": 7, "lines64": 15}
# (queries a warp, probe rounds of 32 kept in registers, resident blocks an
# SM asked of nvcc)
SHAPES = ((1, 1, 1), (1, 2, 1), (1, 3, 1), (1, 3, 4), (1, 4, 1), (1, 4, 4),
          (2, 2, 1), (2, 4, 1), (4, 2, 1), (4, 4, 1))
# edits of the serving kernel that take a part away (not checked: they
# compute something else)
ABLATIONS = {
    "probes read block 0 of their row (no DRAM)": ((
        "const int bc = min(pos >> 7, r.nblocks - 1);\n  p.q = __ldg(",
        "const int bc = 0;\n  p.q = __ldg("),),
    "no probe loads": ((
        """  p.q = __ldg(reinterpret_cast<const int4*>(r.words + row * r.words_stride) +
              bc);
  p.base = __ldg(r.super + row * r.super_stride + (bc >> 3)) +
           static_cast<uint16_t>(__ldg(r.block + row * r.block_stride + bc));""",
        """  p.q = make_int4(pos, pos ^ 0x5555, bc, static_cast<int>(row));
  p.base = pos >> 1;"""),
        ("zl[r] = __ldg(p.zeros + row);", "zl[r] = static_cast<int>(row);"),
        ("const int z0 = __ldg(p.zeros + row);",
         "const int z0 = static_cast<int>(row);")),
}
N_TOKENS, SIGMA, SHARD_BITS, TAU, SAMPLE_RATE = 1 << 27, 151_936, 20, 8, 512
NUM_QUERIES, COLD_BATCHES = 4096, 8
REPS = 20
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
V1_ARGS = [_P] * 3 + [_I] + [_P, _L] * 3 + [_P] + [_I] * 5 + [_P, _P]
CHASE_ARGS = [_P, _I, _I, _P, _P]


def line_rows(words, superblock, block, size: int,
              line_words: int = LINE_WORDS) -> torch.Tensor:
    """(R, nlines, line_words + 1) int32 rank lines of R directory rows of
    ``size`` bits: line j holds rank1 at ``j * 32 * line_words`` (read from
    the directories) and the row's words from ``j * line_words`` on, zero
    past the row. Position ``size`` has a line too."""
    rows, nw = words.shape[0], bitops.num_words(size)
    line_bits = 32 * line_words
    nlines = size // line_bits + 1
    starts = (torch.arange(nlines, device=words.device) * line_bits).expand(
        rows, nlines)
    rs = BinaryRank(words=words[:, :nw], superblock=superblock, block=block,
                    n=size)
    counts = rank1(rs, starts).to(torch.int32)
    body = F.pad(words[:, :nw], (0, nlines * line_words - nw))
    return torch.cat([counts[..., None],
                      body.reshape(rows, nlines, line_words)], -1).contiguous()


def rank_lines_plain(lines: torch.Tensor, rows: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """rank1 at ``pos`` of row ``rows`` (broadcast together) read from
    (R, nlines, LINE_WORDS + 1) lines as the 32-byte line variant reads
    them: the line's count plus the ones of its words below ``pos``.
    int64."""
    pos = pos.long()
    line = pos // LINE_BITS
    data = lines[rows, line]
    off = (pos - line * LINE_BITS)[..., None]
    below = off - 32 * torch.arange(LINE_WORDS, device=pos.device)
    ones = bitops.rank1_word(data[..., 1:], below.clamp(0, 32)).sum(-1)
    return data[..., 0].long() + ones


def wm_quantile_lines_plain(op: wm_quantile.QuantileOperands, lo, hi,
                            k) -> torch.Tensor:
    """The descent in plain torch on the 32-byte line layout built from the
    operands' directories (:func:`line_rows`), as the line variant reads
    it: (Q,) int32, -1 if empty."""
    lines = line_rows(op.words, op.superblock, op.block, 1 << op.shard_bits)
    shard_rows = (torch.arange(op.num_shards, device=lines.device)
                  * op.nbits)[:, None]
    return wm_quantile.descend(
        lambda l, pos: rank_lines_plain(lines, shard_rows + l, pos), op, lo,
        hi, k)


def _nvcc(src: Path, lib: Path):
    return subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def start_variant(tag: str, source: Path, subs: dict, edits: tuple = ()):
    """Copy ``source`` with its constants rewritten and the literal
    ``edits`` (old, new) made, and start its nvcc; returns (process,
    library path, tag)."""
    out = build.BUILD_DIR / "sweep_quantile" / re.sub(r"\W+", "_", tag)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    src = out / "wm_quantile.cu"
    text = source.read_text()
    for const, value in subs.items():
        text, count = re.subn(rf"(constexpr int {const}) = [^;]+;",
                              rf"\1 = {value};", text)
        if count != 1:
            raise RuntimeError(f"{source.name}: {const} found {count} times")
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{source.name}: {old!r} found "
                               f"{text.count(old)} times")
        text = text.replace(old, new)
    src.write_text(text)
    lib = out / "wm_quantile.so"
    return _nvcc(src, lib), lib, tag


def start_source(name: str):
    """Start nvcc on ``launch/csrc/<name>.cu`` as it is."""
    out = build.BUILD_DIR / "sweep_quantile"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"{name}.so"
    return _nvcc(HERE / f"{name}.cu", lib), lib, name


def finish(started, entries: dict) -> ctypes.CDLL:
    """Wait for a build and load it with ``entries`` (name -> argtypes)."""
    proc, lib_path, tag = started
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"{tag}:\n{log.decode(errors='replace')}")
    lib = ctypes.CDLL(str(lib_path))
    for entry, argtypes in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def event_ms(fns, reps: int = REPS) -> float:
    """Mean ms a call over ``reps`` rounds of the calls ``fns`` in turn
    (CUDA events, one warm-up round)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for fn in fns:
            fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def profiled_ms(fn, reps: int = REPS, name: str = "quantile") -> float | None:
    """Mean device ms of the kernels whose name holds ``name`` over ``reps``
    calls, as ``torch.profiler`` reads them; None if it saw none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0.0)
                for e in prof.key_averages() if name in e.key)
    return total / reps / 1e3 if total else None


def chase_latency_ns(lib, nbytes: int, dev, steps: int = 20_000,
                     warm: bool = False) -> float:
    """ns a dependent load over a random cycle of 128-byte slots filling
    ``nbytes`` (one warm pass over the whole cycle first if ``warm``)."""
    slots = max(2, nbytes // 128)
    gen = torch.Generator(device=dev).manual_seed(0)
    perm = torch.randperm(slots, generator=gen, device=dev) * 32
    buf = torch.zeros(slots * 32, dtype=torch.int32, device=dev)
    buf[perm] = torch.roll(perm, -1).to(torch.int32)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    start = int(perm[0])

    def run(n):
        build.check(lib, lib.pointer_chase(buf.data_ptr(), start, n,
                                           out.data_ptr(), stream),
                    "pointer_chase")
    run(slots if warm else 1000)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    run(steps)
    ev1.record()
    ev1.synchronize()
    return ev0.elapsed_time(ev1) * 1e6 / steps


def latencies(dev, dram_bytes: int, lib=None) -> dict:
    """DRAM and L2 dependent-load latencies (ns) of the card."""
    if lib is None:
        lib = finish(start_source("pointer_chase"),
                     {"pointer_chase": CHASE_ARGS})
    return {"dram_ns": chase_latency_ns(lib, dram_bytes, dev),
            "l2_ns": chase_latency_ns(lib, 16 << 20, dev, warm=True)}


def bare_entry(lib, args: tuple, out: torch.Tensor, dev):
    """A call of ``lib.wm_quantile_sharded`` with every argument resolved:
    ``args`` after (lo, hi, k, Q), before (out, stream)."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn, tail = lib.wm_quantile_sharded, (out.data_ptr(), stream)

    def call(head):
        err = fn(*head, *args, *tail)
        if err:
            build.check(lib, err, "wm_quantile_sharded")
    return call


def _queries(n: int, seed: int, dev, fold: int | None = None):
    lo, hi, k = make_queries(n, NUM_QUERIES, seed)
    t = [torch.from_numpy(x).to(dev) for x in (lo, hi, k)]
    if fold is not None:                  # the same widths inside one shard
        lo1 = t[0] % fold
        t[1] = torch.minimum(lo1 + (t[1] - t[0]).clamp(min=0),
                             torch.tensor(fold, device=dev, dtype=lo1.dtype))
        t[0] = lo1
    return [x.to(torch.int32).contiguous() for x in t]


def _variants() -> dict:
    """label -> (layout, source, constants, edits, checked)."""
    serving = build.CSRC / "wm_quantile.cu"
    out = {"serving kernel": ("no-copy", serving, {}, (), True)}
    for layout, words in LAYOUTS.items():
        for T, R, M in SHAPES:
            label = f"{layout} T={T} R={R}" + (f" min{M}" if M > 1 else "")
            out[label] = (layout, VARIANTS,
                          {"kQueriesPerWarp": T, "kRegRounds": R,
                           "kMinBlocks": M, "kLineWords": words}, (), True)
    for name, edits in ABLATIONS.items():
        out[f"ablation: {name}"] = ("no-copy", serving, {}, edits, False)
    return out


def variant_info(lib, source: Path) -> dict:
    """``wm_quantile.kernel_info`` of a build, with the variants' compiled
    queries a warp and words a line (1 and 0 for the serving kernel)."""
    if source != VARIANTS:
        return {**wm_quantile.kernel_info(lib), "queries_per_warp": 1,
                "line_words": 0}
    a = (ctypes.c_int * 7)()
    build.check(lib, lib.wm_quantile_info(a), "wm_quantile_info")
    keys = ("registers", "local_bytes", "blocks_per_sm", "warps_per_block",
            "queries_per_warp", "register_probes", "line_words")
    return dict(zip(keys, a))


def _entry_args(info, rows, zeros, S, nbits, n, shard_bits, dev):
    """The C entry's per-operand arguments, and the scratch they point to."""
    max_blocks, _ = wm_quantile.launch_shape(info, S, dev)
    over = max(0, info["queries_per_warp"] * 2 * S - info["register_probes"])
    scratch = torch.empty(max(1, max_blocks * info["warps_per_block"] * 2
                              * over), dtype=torch.int32, device=dev)
    ptrs = tuple(x.data_ptr() if isinstance(x, torch.Tensor) else x
                 for x in rows)
    return (*ptrs, zeros.data_ptr(), S, nbits, n, shard_bits,
            scratch.data_ptr(), over, max_blocks), scratch


def main() -> None:
    dev = resolve_device("cuda")
    variants = _variants()
    started = {"warp_v1": start_source("wm_quantile_warp_v1"),
               "chase": start_source("pointer_chase")}
    for label, (layout, source, subs, edits, _) in variants.items():
        started[label] = start_variant(label, source, subs, edits)

    toks = make_corpus(N_TOKENS, SIGMA, seed=0)
    eng = build_sharded_analytics(toks, SIGMA, shard_bits=SHARD_BITS, tau=TAU,
                                  sample_rate=SAMPLE_RATE, device=dev)
    del toks
    size = eng.shard_size
    one = tree_map(lambda x: x[:1], eng.shards)
    shapes = {"full": (eng.shards, SHARD_BITS, N_TOKENS),
              "s1": (one, SHARD_BITS, size)}
    batches = {"full": [_queries(N_TOKENS, 1 + b, dev)
                        for b in range(COLD_BATCHES)],
               "s1": [_queries(N_TOKENS, 1 + b, dev, size)
                      for b in range(COLD_BATCHES)]}
    # the batch's narrow (width < 256) and wide halves alone, at full width
    for half, keep in (("narrow", lambda w: w < 256),
                       ("wide", lambda w: w >= 256)):
        shapes[f"full_{half}"] = shapes["full"]
        batches[f"full_{half}"] = [
            [x[keep(hi - lo)].contiguous() for x in (lo, hi, k)]
            for lo, hi, k in batches["full"]]
    plain_ops = {name: ops.quantile_operands(*shapes[name])
                 for name in ("full", "s1")}
    plain_ops["full_narrow"] = plain_ops["full_wide"] = plain_ops["full"]
    want = {name: [wm_quantile.wm_quantile_sharded_plain(plain_ops[name], *q)
                   for q in batches[name]] for name in shapes}
    operands = {}          # (shape, layout) -> (rows tuple, zeros, bytes)
    for name in ("full", "s1"):
        op = plain_ops[name]
        operands[name, "no-copy"] = (
            (op.words, op.words.stride(0), op.superblock,
             op.superblock.stride(0), op.block, op.block.stride(0),
             op.nblocks), op.zeros,
            sum(x.numel() * x.element_size()
                for x in (op.words, op.superblock, op.block)))
        for layout in ("lines32", "lines64"):
            lines = line_rows(op.words, op.superblock, op.block,
                                          size, LAYOUTS[layout])
            operands[name, layout] = ((lines, lines.stride(0), None, 0, None,
                                       0, 0), op.zeros,
                                      lines.numel() * lines.element_size())
    for half in ("full_narrow", "full_wide"):
        for layout in LAYOUTS:
            operands[half, layout] = operands["full", layout]
    dir_bytes = operands["full", "no-copy"][2]
    print(f"layouts at full width: directories {dir_bytes} B, 32-byte lines "
          f"{operands['full', 'lines32'][2]} B, 64-byte lines "
          f"{operands['full', 'lines64'][2]} B")
    for name, bs in batches.items():
        print(f"{name}: {sum(b[0].numel() for b in bs)} queries in "
              f"{len(bs)} batches")

    lat = latencies(dev, dir_bytes, finish(
        started.pop("chase"), {"pointer_chase": CHASE_ARGS}))
    print(f"dependent-load latency: {json.dumps(lat)}")

    out = torch.empty(NUM_QUERIES, dtype=torch.int32, device=dev)
    runs = {}
    for label, st in started.items():
        if label == "warp_v1":
            lib = finish(st, {"wm_quantile_sharded": V1_ARGS})
            info, layout, checked = None, "no-copy", True
        else:
            lib = finish(st, build.SIGNATURES["wm_quantile"])
            layout, source, _, _, checked = variants[label]
            info = variant_info(lib, source)
        calls, ok = {}, True
        for name, (sh, sb, n) in shapes.items():
            S, nbits = sh.zeros.shape
            rows, zeros, _ = operands[name, layout]
            if label == "warp_v1":
                w, ws, s_, ss, b, bs, nblocks = rows
                args = (w.data_ptr(), ws, s_.data_ptr(), ss, b.data_ptr(), bs,
                        zeros.data_ptr(), S, nbits, n, sb, nblocks)
                held = None
            else:
                args, held = _entry_args(info, rows, zeros, S, nbits, n, sb,
                                         dev)
            call = bare_entry(lib, args, out, dev)
            heads = [(lo.data_ptr(), hi.data_ptr(), k.data_ptr(), lo.numel())
                     for lo, hi, k in batches[name]]
            for head, w_ in zip(heads, want[name]):
                call(head)
                torch.cuda.synchronize()
                ok = ok and torch.equal(out[:head[3]], w_)
            calls[name] = (call, heads, (rows, held))
        print(f"{label}: {info}; equal to the plain descent: "
              f"{ok if checked else 'not checked (ablation)'}")
        if checked and not ok:
            raise RuntimeError(f"{label} disagrees with the plain descent")
        runs[label] = (calls, info)

    times = {label: {} for label in runs}
    for order in (list(runs), list(runs)[::-1]):
        for label in order:
            for name, (call, heads, _) in runs[label][0].items():
                warm = event_ms([lambda c=call, h=heads[0]: c(h)])
                cold = event_ms([lambda c=call, h=h: c(h) for h in heads])
                times[label].setdefault(f"{name}_ms", []).append(warm)
                times[label].setdefault(f"{name}_cold_ms", []).append(cold)
    results = {}
    for label, t in times.items():
        row = {"variant": label}
        row.update({k: sum(v) / len(v) for k, v in t.items()})
        row["passes"] = t
        row["info"] = runs[label][1]
        results[label] = row
    grid = [r for label, r in results.items()
            if label != "warp_v1" and variants[label][4]]
    best = min((r for r in grid if r["variant"].startswith("lines")),
               key=lambda r: r["full_cold_ms"])
    best_nocopy = min((r for r in grid
                       if r["variant"].startswith(("no-copy", "serving"))),
                      key=lambda r: r["full_cold_ms"])
    for label, row in results.items():
        if label in ("warp_v1", "serving kernel", best["variant"],
                     best_nocopy["variant"]):
            for name, (call, heads, _) in runs[label][0].items():
                row[f"{name}_profiled_ms"] = profiled_ms(
                    lambda c=call, h=heads[0]: c(h))
        print(json.dumps(row))
    ratio = best_nocopy["full_cold_ms"] / best["full_cold_ms"]
    print(f"decision: best line variant {best['variant']} "
          f"{best['full_cold_ms']:.6f} ms, best no-copy variant "
          f"{best_nocopy['variant']} {best_nocopy['full_cold_ms']:.6f} ms, "
          f"ratio {ratio:.4f} ({'keep no-copy' if ratio <= 1.3 else 'keep the lines'}"
          f" by the 1.3x rule); the serving kernel "
          f"{results['serving kernel']['full_cold_ms']:.6f} ms, warp_v1 "
          f"{results['warp_v1']['full_cold_ms']:.6f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
