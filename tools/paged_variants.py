#!/usr/bin/env python3
"""Time variants of the paged-attention CUDA source side by side on one card.

    python3 tools/paged_variants.py

Each variant is ``csrc/paged_attention.cu`` with a few text substitutions
(``VARIANTS`` below; the first is the source as committed): the span
length S, the block size, the one-launch combine (the last-arriving
block combines in place of the second launch), int8 conversion by
integer ops, and
ablations that skip one stage
each (their results are wrong and reported so; only their times are
read).  All are built with the port's
``nvcc`` flags in parallel, checked against the plain version at the
timed shapes of ``chip_smoke.py``'s phase 1 (bf16, ``2e-2``; both
kernels), and timed in one process, in turns (each variant twice per
round, in forward and reverse order), so that two designs are compared
on one card under one load.  Two times per call, each cycling over 8
layers' pools so that L2 is cold: the device time of its kernels
(``torch.profiler``), and the time of a CUDA graph of 8 calls per call,
which counts the gap between two launches and no host time; and the
CUDA launches per call that the device trace holds.  The card's name and
power limit come first.  Builds go to the git-ignored
``build/``.
"""

from __future__ import annotations

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
        ("  paged_combine_kernel<TQ><<<a.batch * a.hq, kCombineThreads, 0, stream>>>(a);",
         "")],
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
    "no combine": [("  paged_combine_kernel<TQ><<<a.batch * a.hq, kCombineThreads, 0, stream>>>(a);",
                    "")],
    "no p V": [("  for (int r4 = lo; r4 < hi; r4 += 4) {",
                "  for (int r4 = lo; r4 < lo; r4 += 4) {"),
               ("    for (int kk = 0; kk < kend; kk += 16) {",
                "    for (int kk = 0; kk < 0; kk += 16) {")],
    "no scores": [("  if (r >= sp.rows) return;", "  return;"),
                  ("  for (int kk = 0; kk < a.d; kk += 16) {",
                   "  for (int kk = 0; kk < 0; kk += 16) {")],
    "no copies": [("  while (r < rows) {", "  while (r < 0) {")],
}
TOL = cs.BF16_TOL
LAYERS = 8


def say(*parts) -> None:
    print(*parts, flush=True)


def build() -> dict:
    """Build every variant in parallel; return the loaded libraries."""
    src = (_build.CSRC / "paged_attention.cu").read_text()
    out = ROOT / "build" / "paged_variants"
    out.mkdir(parents=True, exist_ok=True)
    texts = {}
    for label, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise AssertionError(f"{label}: substitution does not match once")
            text = text.replace(old, new)
        texts[label] = text
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
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build.SIGNATURES["paged_attention"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[label] = lib
    return libs


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


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_variants: no CUDA device", file=sys.stderr)
        return 2
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    libs = build()
    for key, (label, _) in cs.PAGED_TIMED.items():
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
        launches = {}
        for _ in range(2):
            for lbl in list(libs) + list(libs)[::-1]:
                _build._loaded["paged_attention"] = libs[lbl]
                for name, (_, fn) in calls.items():
                    dev = cs.device_time(fn)
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
