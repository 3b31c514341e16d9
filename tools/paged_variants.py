#!/usr/bin/env python3
"""Time variants of the paged-attention CUDA source side by side on one card.

    python3 tools/paged_variants.py [--wide] [OTHER.cu ...]

Each variant is ``csrc/paged_attention.cu`` with a few text substitutions
(``VARIANTS`` below; the first is the source as committed): the span
length S, the block size, the one-launch combine (the last-arriving
block combines in place of the second launch), int8 conversion by
integer ops, and
ablations that skip one stage
each (their results are wrong and reported so; only their times are
read).  Each OTHER is a whole ``paged_attention.cu`` (an earlier commit's,
say, written out with ``git show <commit>:src/repro_torch/kernels/csrc/
paged_attention.cu``), timed beside them.  With ``--wide``, the wide
variants (``WIDE_VARIANTS``: the committed source and ablations of
``paged_wide_kernel``) and the OTHERs, at the wide timed shapes of
``chip_smoke.py``'s phase 1 (heads past 256), with the committed
source's device time split by kernel (span kernel, combine); without it,
every variant at the narrow ones.  All are built with the
port's ``nvcc`` flags in parallel, their registers, spills and (wide
instantiations) SASS HMMA counts printed, checked against the plain
version at the timed shapes (bf16, ``2e-2``; both kernels), and timed in
one process, in turns (each variant twice per round, in forward and
reverse order), so that two designs are compared on one card under one
load.  Two times per call, each cycling over 8 layers' pools so that L2 is
cold: the device time of its kernels (``torch.profiler``), and the time
of a CUDA graph of 8 calls per call, which counts the gap between two
launches and no host time; and the CUDA launches per call that the device
trace holds.  The card's name and power limit come first.  Builds go to
the git-ignored ``build/``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import itertools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from chip_smoke import _build, ops, pa, ref  # noqa: E402

# the narrow route's combine launch, after its span kernel's
SPLIT_COMBINE = (
    "  kernel<<<a.batch * a.hkv * a.max_splits, kThreads, smem, stream>>>(a);\n"
    "  const cudaError_t err = cudaGetLastError();\n"
    "  if (err != cudaSuccess || a.max_splits == 1) return static_cast<int>(err);\n"
    "  paged_combine_kernel<TQ><<<a.batch * a.hq, kCombineThreads, 0, stream>>>(a);")
VARIANTS = {
    "committed": [],
    "S 32": [("constexpr int kSplit = 64;", "constexpr int kSplit = 32;")],
    "S 128": [("constexpr int kSplit = 64;", "constexpr int kSplit = 128;")],
    "256 threads": [("constexpr int kThreads = 128;",
                     "constexpr int kThreads = 256;")],
    "S 128, 256 threads": [
        ("constexpr int kSplit = 64;", "constexpr int kSplit = 128;"),
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 256;")],
    # one launch per call: the block that arrives last at its (row, kv
    # head) combines its spans in place of the second launch, counted by
    # one int32 atomicAdd per block after a __threadfence() (counters zero
    # when the module loads, reset by the combining block)
    "one launch": [
        ("constexpr int kCombineThreads = 256;",
         "constexpr int kCombineThreads = kThreads;"),
        ("// One block per (row b, kv head h, span s), numbered",
         "__device__ int g_arrivals[1 << 20];\n\n"
         "// One block per (row b, kv head h, span s), numbered"),
        ("    heads_pass<TQ, TKV, kQuant, kMaxG, false>(a, sp, qb, c0, gc, c0 == 0);\n"
         "  }\n}\n",
         "    heads_pass<TQ, TKV, kQuant, kMaxG, false>(a, sp, qb, c0, gc, c0 == 0);\n"
         "  }\n"
         "  if (n_spans == 1) return;\n"
         "  __shared__ int last;\n"
         "  __syncthreads();\n"
         "  if (threadIdx.x == 0) {\n"
         "    __threadfence();\n"
         "    int* count = g_arrivals + static_cast<size_t>(b) * a.hkv + h;\n"
         "    last = atomicAdd(count, 1) == n_spans - 1;\n"
         "    if (last) {\n"
         "      *count = 0;\n"
         "      __threadfence();\n"
         "    }\n"
         "  }\n"
         "  __syncthreads();\n"
         "  if (!last) return;\n"
         "  for (int j = 0; j < g; ++j) combine_head<TQ>(a, sp.head0 + j, b, sp.sc);\n"
         "}\n"),
        (SPLIT_COMBINE, SPLIT_COMBINE.rsplit("\n", 1)[0])],
    # int8 to f32 by integer ops (the byte as the low bits of 2^23's
    # mantissa) in place of I2F
    "int8 by byte_perm": [
        ("  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);\n#pragma unroll\n"
         "  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(c[i]);",
         "#pragma unroll\n  for (int i = 0; i < 4; ++i) {\n"
         "    o[i] = __uint_as_float(__byte_perm(raw.x ^ 0x80808080u, 0x4B000000u, 0x7540 | i)) - 8388736.f;\n"
         "    o[4 + i] = __uint_as_float(__byte_perm(raw.y ^ 0x80808080u, 0x4B000000u, 0x7540 | i)) - 8388736.f;\n"
         "  }"),
        ("  const char2 c = *reinterpret_cast<const char2*>(p);\n"
         "  o[0] = static_cast<float>(c.x);\n  o[1] = static_cast<float>(c.y);",
         "  const unsigned w = *reinterpret_cast<const unsigned short*>(p) ^ 0x8080u;\n"
         "  o[0] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540)) - 8388736.f;\n"
         "  o[1] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7541)) - 8388736.f;")],
    # ablations: each skips work, so its results are wrong; only its time
    # is read
    "no combine": [(SPLIT_COMBINE, SPLIT_COMBINE.rsplit("\n", 1)[0])],
    "no p V": [("  for (int r4 = lo; r4 < hi; r4 += 4) {",
                "  for (int r4 = lo; r4 < lo; r4 += 4) {"),
               ("    for (int kk = 0; kk < kend; kk += 16) {",
                "    for (int kk = 0; kk < 0; kk += 16) {")],
    "no scores": [("  if (r >= sp.rows) return;", "  return;"),
                  ("  for (int kk = 0; kk < a.d; kk += 16) {",
                   "  for (int kk = 0; kk < 0; kk += 16) {")],
    "no copies": [("  while (r < rows) {", "  while (r < 0) {")],
}
# the wide route's variants (``--wide``): the committed source; design
# alternatives (a cp.async ring of 64-column boxes in place of whole-row
# bulk copies, 256-column combine slices, one chain of score products);
# ablations that skip one stage of paged_wide_kernel each (wrong results,
# only their times read); and a traced build (%globaltimer stamps of one
# block's stages and of every block's start and end)
WIDE_COMBINE = (
    "  if (err != cudaSuccess || a.max_splits == 1) return static_cast<int>(err);\n"
    "  paged_combine_kernel<TQ, true><<<a.batch * a.hq * combine_slices(a.d),\n"
    "                                   kWideCombineThreads, 0, stream>>>(a);")
WIDE_VARIANTS = {
    "committed": [],
    "wide: no combine": [(WIDE_COMBINE, WIDE_COMBINE.split("\n")[0])],
    # the span's rows by 16-byte cp.async into a ring of 64-column boxes
    # (an mbarrier per box) in place of whole-row bulk copies
    "wide: cp.async ring": [("constexpr bool kWideBulk = true;",
                             "constexpr bool kWideBulk = false;")],
    "wide: combine slices of 256": [("constexpr int kWideCombineThreads = 128;",
                                     "constexpr int kWideCombineThreads = 256;")],
    "wide: one score chain": [("        if (kb + 1 < nb) box_scores(kb + 1, c_odd);",
                               "        if (kb + 1 < nb) box_scores(kb + 1, c);")],
    "wide: no scores": [
        ("          for (int kk = k_lo; kk < k_hi; kk += 16) {",
         "          for (int kk = k_lo; kk < k_lo; kk += 16) {"),
        ("          for (int cc = 0; cc < w; cc += 4) {",
         "          for (int cc = 0; cc < 0; cc += 4) {")],
    "wide: empty": [
        ("  if (s >= n_spans) return;\n"
         "  const int len = max(0, min(a.lengths[b], a.np * a.page));\n\n"
         "  const WideLayout lay",
         "  if (s >= n_spans || s >= 0) return;\n"
         "  const int len = max(0, min(a.lengths[b], a.np * a.page));\n\n"
         "  const WideLayout lay")],
    "wide: no softmax": [
        ("    for (int j = warp; j < gc; j += kWideWarps) {",
         "    for (int j = warp; j < 0; j += kWideWarps) {")],
    "wide: no puts": [
        ("  if (sp.n_spans == 1) {\n#pragma unroll\n    for (int e = 0; e < n; ++e)",
         "  if (x[0] != 12345.f) return;\n  if (sp.n_spans == 1) {\n#pragma unroll\n    for (int e = 0; e < n; ++e)")],
    "wide: traced": [
        ("namespace {\n\nconstexpr int kThreads = 128;",
         "namespace {\n\n__device__ unsigned long long g_trace[16];\n"
         "__device__ unsigned long long g_blocks[3 * 4096];\n"
         "__device__ __forceinline__ void block_at(int k) {\n"
         "  if (threadIdx.x == 0 && blockIdx.x < 4096) {\n"
         "    unsigned long long t;\n"
         "    unsigned sm;\n"
         "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
         "    g_blocks[3 * blockIdx.x + k] = t;\n"
         "    g_blocks[3 * blockIdx.x + 2] = sm;\n  }\n}\n"
         "__device__ __forceinline__ void trace_at(int k, bool on) {\n"
         "  if (on && threadIdx.x == 0) {\n"
         "    unsigned long long t;\n"
         "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "    g_trace[k] = t;\n  }\n}\n#define TRACED (blockIdx.x == (a.max_splits - 1) * a.batch * a.hkv + (a.batch - 1) * a.hkv)\n\n"
         "constexpr int kThreads = 128;"),
        ("  if (tid < kSplit && r0 + tid < a.np * a.page) {",
         "  trace_at(0, TRACED);\n  block_at(0);\n  if (tid < kSplit && r0 + tid < a.np * a.page) {"),
        ("  const WideLayout lay = wide_layout<TQ, TKV>(d);\n  extern",
         "  const WideLayout lay = wide_layout<TQ, TKV>(d);\n  trace_at(1, TRACED);\n  extern"),
        ("    asm volatile(\"fence.mbarrier_init.release.cluster;\" ::: \"memory\");\n  }\n  __syncthreads();\n",
         "    asm volatile(\"fence.mbarrier_init.release.cluster;\" ::: \"memory\");\n  }\n  __syncthreads();\n"
         "  trace_at(2, TRACED);\n"),
        ("    for (int i = 0; i < min(total, lay.stages); ++i) issue(i);\n  }\n",
         "    for (int i = 0; i < min(total, lay.stages); ++i) issue(i);\n  }\n  trace_at(3, TRACED);\n"),
        ("      __syncthreads();\n      // scores: positions p0",
         "      __syncthreads();\n      trace_at(4, TRACED);\n      // scores: positions p0"),
        ("          if (!lay.bulk) wait(i);\n          const char* box = box_at(i);",
         "          if (!lay.bulk) wait(i);\n          trace_at(5, TRACED);\n          const char* box = box_at(i);"),
        ("    __syncthreads();\n\n    // the span's softmax",
         "    trace_at(6, TRACED);\n    __syncthreads();\n    trace_at(7, TRACED);\n\n    // the span's softmax"),
        ("    __syncthreads();\n\n    if constexpr (kP16) {",
         "    __syncthreads();\n    trace_at(8, TRACED);\n\n    if constexpr (kP16) {"),
        ("            if (!lay.bulk) wait(i);\n            char* box = box_at(i);",
         "            if (!lay.bulk) wait(i);\n            trace_at(9, TRACED);\n            char* box = box_at(i);"),
        ("            rows_wait(kWideRowGroups + ks * 16 / kWideBarRows);\n",
         "            rows_wait(kWideRowGroups + ks * 16 / kWideBarRows);\n            trace_at(9, TRACED);\n"),
        ("          const int i = base + nb + v;\n          if (!lay.bulk) wait(i);",
         "          const int i = base + nb + v;\n          if (!lay.bulk) wait(i);\n          trace_at(9, TRACED);"),
        ("    if (sp.n_spans > 1 && tid < gc) {\n      float* st",
         "    trace_at(10, TRACED);\n    block_at(1);\n    if (sp.n_spans > 1 && tid < gc) {\n      float* st"),
        ("    combine_head<TQ, kWideCombineThreads>(a, head, static_cast<int>(head / a.hq), ws,",
         "    trace_at(11, blockIdx.x == 0);\n    combine_head<TQ, kWideCombineThreads>(a, head, static_cast<int>(head / a.hq), ws,"),
        ("        n = spans_of(a, b);\n", "        n = spans_of(a, b);\n        trace_at(12, blockIdx.x == 0);\n"),
        ("      for (int i = 0; i < ns; ++i) l += lw_s[i];\n",
         "      for (int i = 0; i < ns; ++i) l += lw_s[i];\n      trace_at(13, blockIdx.x == 0);\n"),
        ("      if (col < c_hi) {\n", "      trace_at(14, blockIdx.x == 0);\n      if (col < c_hi) {\n"),
        ("// positions per span\nextern \"C\" int repro_paged_split_tokens() { return kSplit; }",
         "// positions per span\nextern \"C\" int repro_paged_split_tokens() { return kSplit; }\n"
         "extern \"C\" int repro_paged_trace(void* out) {\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace)));\n}\n"
         "extern \"C\" int repro_paged_blocks(void* out) {\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_blocks, sizeof(g_blocks)));\n}\n"
         "extern \"C\" int repro_paged_blocks_reset() {\n"
         "  static unsigned long long zero[3 * 4096] = {};\n"
         "  return static_cast<int>(cudaMemcpyToSymbol(g_blocks, zero, sizeof(zero)));\n}"),
    ],
    "wide: no p V": [
        ("              if (16 * ks < kend) {\n                unsigned fb[2];",
         "              if (16 * ks < 0) {\n                unsigned fb[2];"),
        ("                mma_bf16(acc[v], fp[ks], fb[0], fb[1]);", ""),
        ("          for (int r = 0; r < rows; ++r) {",
         "          for (int r = 0; r < 0; ++r) {")],
}
# ablation: the copies and their waits alone
WIDE_VARIANTS["wide: copies only"] = (WIDE_VARIANTS["wide: no scores"]
                                      + WIDE_VARIANTS["wide: no softmax"]
                                      + WIDE_VARIANTS["wide: no p V"])
TRACE_POINTS = ("start", "lengths in", "barriers set", "copies issued",
                "q rows in", "warp 0 starts its last K box", "scores done (warp 0)",
                "scores done (block)", "softmax done", "warp 0: last V rows in",
                "p V done (thread 0)", "combine starts (block 0)",
                "combine: lengths in", "combine: l summed", "combine: stores")
TOL = cs.BF16_TOL
LAYERS = 8


def say(*parts) -> None:
    print(*parts, flush=True)


def build(variants: dict, others: list) -> dict:
    """Build every variant and every OTHER source in parallel; return the
    loaded libraries."""
    src = (_build.CSRC / "paged_attention.cu").read_text()
    out = ROOT / "build" / "paged_variants"
    out.mkdir(parents=True, exist_ok=True)
    texts = {}
    for label, subs in variants.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise AssertionError(f"{label}: substitution does not match once")
            text = text.replace(old, new)
        texts[label] = text
    for path in others:
        texts[str(path)] = Path(path).read_text()
    procs = {}
    for i, (label, text) in enumerate(texts.items()):
        cu, so = out / f"v{i}.cu", out / f"v{i}.so"
        cu.write_text(text)
        procs[label] = (so, subprocess.Popen(
            [_build.nvcc()] + _build.NVCC_FLAGS + ["-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{label}: nvcc failed\n{log}")
        report = cs.ptxas_report(log)
        regs = sorted({e.get("registers") for e in report.values()})
        spills = {k: e for k, e in report.items()
                  if e.get("spill_stores") or e.get("spill_loads")}
        say(f"{label}: built; registers {regs}; spills: "
            + ("none" if not spills else "".join(
                f"\n  {k}: {e}" for k, e in spills.items())))
        for k, e in report.items():
            if "paged_wide_kernel" in k:
                say(f"  {k}: {e}")
        for k, n in cs.paged_sass(so).items():
            say(f"  {k}: SASS HMMA {n}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build.SIGNATURES["paged_attention"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[label] = lib
    return libs


def block_summary(blocks) -> str:
    """Start and end stamps of every block of one span-kernel launch
    (the traced variant): when the active blocks (those that reach the
    end) start and end after the first start, and how many an SM ran."""
    import statistics
    rows = [(blocks[3 * i], blocks[3 * i + 1], blocks[3 * i + 2])
            for i in range(4096) if blocks[3 * i]]
    t0 = min(r[0] for r in rows)
    active = [r for r in rows if r[1]]
    starts = sorted(r[0] - t0 for r in active)
    ends = sorted(r[1] - t0 for r in active)
    spans = sorted(r[1] - r[0] for r in active)
    per_sm = collections.Counter(r[2] for r in active)

    def q(xs):
        return "/".join(str(int(x)) for x in (xs[0], statistics.median(xs), xs[-1]))
    return (f"{len(rows)} blocks, {len(active)} active on {len(per_sm)} SMs "
            f"(at most {max(per_sm.values())} an SM); ns min/median/max: "
            f"active starts {q(starts)}, ends {q(ends)}, durations {q(spans)}; "
            f"early exits end by {int(max(r[0] for r in rows) - t0)}")


def graph_ms(fn, calls=LAYERS, replays=20) -> float:
    """Time per call of a CUDA graph of ``calls`` calls."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def by_kernel(fn, reps=40) -> dict:
    """Device ms per call of each kernel ``fn`` launches, by name."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: ev.device_time_total / reps / 1e3
            for ev in prof.key_averages() if ev.device_time_total > 0}


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_variants: no CUDA device", file=sys.stderr)
        return 2
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--wide", action="store_true",
                        help="the wide timed shapes only, the wide variants "
                             "and the OTHERs")
    parser.add_argument("--only", default="",
                        help="comma-separated labels of the variants to keep "
                             "(default: all)")
    parser.add_argument("others", nargs="*", metavar="OTHER.cu",
                        help="whole paged_attention.cu sources to time beside it")
    args = parser.parse_args()
    variants = WIDE_VARIANTS if args.wide else VARIANTS
    if args.only:
        keep = args.only.split(",")
        variants = {k: v for k, v in variants.items() if k in keep}
    libs = build(variants, args.others)
    for key, (label, _) in cs.PAGED_TIMED.items():
        if key.startswith("wide") != args.wide:
            continue
        b, hq, hkv, d, page, n_p, lens = cs.PAGED_SHAPES[label]
        q, k, v, table, lengths = cs.make_case(b, hq, hkv, d, page, n_p, lens,
                                               torch.bfloat16, layers=LAYERS)
        kq, ks = ref.quantize_pages(k)
        vq, vs = ref.quantize_pages(v)
        layer = itertools.cycle(range(LAYERS))

        def plain(i):
            return pa.paged_attention(q, k[i], v[i], table, lengths)

        def quant(i):
            return pa.paged_attention_quant(q, kq[i], ks[i], vq[i], vs[i],
                                            table, lengths)

        calls = {"paged_attention": (plain, lambda: plain(next(layer))),
                 "paged_attention_quant": (quant, lambda: quant(next(layer)))}
        want = {"paged_attention": ops.paged_attention(
                    q, k[0], v[0], table, lengths, use_kernel=False),
                "paged_attention_quant": ops.paged_attention_quant(
                    q, kq[0], ks[0], vq[0], vs[0], table, lengths,
                    use_kernel=False)}
        times = {(lbl, name): ([], []) for lbl in libs for name in calls}
        for lbl, lib in libs.items():
            _build._loaded["paged_attention"] = lib
            for name, (one, _) in calls.items():
                got, w = one(0).float(), want[name].float()
                ok = ((got - w).abs() <= TOL["atol"] + TOL["rtol"] * w.abs()).all().item()
                say(f"{key}, {lbl}, {name}: {'agrees with' if ok else 'DIFFERS from'} "
                    f"the plain version (bf16 {TOL['atol']})")
                if hasattr(lib, "repro_paged_trace"):
                    stamps = (ctypes.c_ulonglong * 16)()
                    blocks = (ctypes.c_ulonglong * (3 * 4096))()
                    one(1)
                    torch.cuda.synchronize()
                    lib.repro_paged_blocks_reset()
                    one(0)
                    torch.cuda.synchronize()
                    lib.repro_paged_trace(ctypes.cast(stamps, ctypes.c_void_p))
                    lib.repro_paged_blocks(ctypes.cast(blocks, ctypes.c_void_p))
                    t0 = stamps[0]
                    say(f"{key}, {lbl}, {name}: ns since the block's start: " + ", ".join(
                        f"{what} {int(stamps[i]) - int(t0)}"
                        for i, what in enumerate(TRACE_POINTS)))
                    say(f"{key}, {lbl}, {name}: " + block_summary(blocks))
        if args.wide:
            _build._loaded["paged_attention"] = libs["committed"]
            for name, (_, fn) in calls.items():
                split = ", ".join(f"{k} {ms:.5f}" for k, ms in by_kernel(fn).items())
                say(f"{key}, committed, {name}: device ms by kernel: {split}")
        launches = {}
        for _ in range(2):
            for lbl in list(libs) + list(libs)[::-1]:
                _build._loaded["paged_attention"] = libs[lbl]
                for name, (_, fn) in calls.items():
                    dev = cs.device_time(fn, traces=5)
                    times[(lbl, name)][0].append(dev.ms)
                    times[(lbl, name)][1].append(graph_ms(fn))
                    launches[(lbl, name)] = dev.launches
        bound = {"paged_attention": cs.kernel_bound_ms(q, k[0], table, lengths)[0],
                 "paged_attention_quant": cs.kernel_bound_ms(
                     q, kq[0], table, lengths, quant=True)[0]}
        for (lbl, name), (dev, graph) in times.items():
            say(f"{key}, {lbl}, {name}: device ms {min(dev):.5f}-{max(dev):.5f}, "
                f"graph ms {min(graph):.5f}-{max(graph):.5f} (bound "
                f"{bound[name]:.5f}); {launches[(lbl, name)]:g} CUDA launches "
                "per call traced")
        del q, k, v, kq, ks, vq, vs, want
        torch.cuda.empty_cache()
    _build._loaded["paged_attention"] = libs["committed"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
