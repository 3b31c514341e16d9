#!/usr/bin/env python3
"""Time variants of the WKV6 CUDA source side by side on one card.

    python3 tools/wkv6_variants.py

Each variant is ``csrc/wkv6.cu`` with a few text substitutions
(``VARIANTS`` below; the first is the source as committed), built with the
port's ``nvcc`` flags in parallel, checked at rwkv6-3b's training shape
(B 4, T 512, 40 heads of 64, bf16, no initial state) against the plain
version run on the same inputs cast to float32 (each output's and
gradient's largest error over its largest magnitude), and timed in one
process, in turns (each variant twice per round, in forward and reverse
order), so that two designs are compared on one card under one load: the
forward with and without saving the chunk-start states, and the backward.
Each variant's outputs are also compared bit for bit with the committed
source's.  (The source ties its warps to the four 16-token sub-blocks of a
64-token chunk, so other chunk lengths are not a text variant of it.)  The
card's name and power limit come first.  Builds go to the git-ignored
``build/``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as wkv  # noqa: E402

VARIANTS = {
    "committed": [],
    # f32 operands rounded once to bf16: one mma pass where a split takes two
    "single pass": [("constexpr bool kLoPass = true;", "constexpr bool kLoPass = false;", 1)],
    # every diagonal sub-block taken exactly on the CUDA cores (no channel
    # factorised)
    "exact diagonal": [("constexpr float kSafe = 60.f;", "constexpr float kSafe = -1.f;", 1)],
    # the forward's value columns cut across 2 or 4 blocks per (batch row,
    # head), each recomputing the chunk's decays and A
    "forward split 2": [("constexpr int kSplit = 1;", "constexpr int kSplit = 2;", 1)],
    "forward split 4": [("constexpr int kSplit = 1;", "constexpr int kSplit = 4;", 1)],
    # dkS in sixteen 16 x 16 strips on the dv warps (warp w its strips
    # [0, 0, 3, 8][w] .. [0, 3, 8, 16][w]), where the products count
    # evenly in mma (256 - 40 w for dv, 16 a strip, 248 on the other warps)
    "dkS strips on the dv warps": [
        ("    // dkS: rows j, columns channels, to its own table (outside the union)\n"
         "    float Z[8][4];\n    zero(Z);\n"
         "    product<T, 8>(Z, ex_a<true>(sm.v), sp_b<true>(f.g, nullptr), m0, 0, kDim, 0, "
         "lane);\n    scale_by(Z, f.ek, dc.delta[Iw], m0, lane);\n"
         "    put_tab_t(sm.dks, Z, m0, lane);\n", "", 1),
        ("      write_acc(dv + base, stride, U, rows, d, m0, lane);\n    }\n",
         "      write_acc(dv + base, stride, U, rows, d, m0, lane);\n    }\n"
         "#pragma unroll 1\n"
         "    for (int q = Iw == 3 ? 8 : Iw == 2 ? 3 : 0; q < (Iw == 3 ? 16 : Iw == 2 ? 8 : "
         "Iw == 1 ? 3 : 0); ++q) {\n"
         "      const int j0 = (q >> 2) * kSub, c0 = (q & 3) * 16;\n"
         "      float Z[2][4];\n      zero(Z);\n"
         "      product<T, 2>(Z, ex_a<true>(sm.v), sp_b<true>(f.g, nullptr), j0, 0, kDim, c0, "
         "lane);\n"
         "      scale_by(Z, f.ek + c0, dc.delta[q >> 2] + c0, j0, lane);\n"
         "      put_tab_t(sm.dks + c0 * kTS, Z, j0, lane);\n    }\n", 1)],
}
SHAPE = (4, 512, 40, 64)


def say(*parts) -> None:
    print(*parts, flush=True)


def build() -> dict:
    """Build every variant in parallel; return the loaded libraries."""
    src = (_build.CSRC / "wkv6.cu").read_text()
    out = ROOT / "build" / "wkv6_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new, count in subs:
            if text.count(old) != count:
                raise AssertionError(f"{label}: substitution matches "
                                     f"{text.count(old)} times, not {count}")
            text = text.replace(old, new)
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
        lines = log.splitlines()
        notes = [f"{lines[k - 1].split('wkv6_')[-1][:30]}: {line.strip()}; "
                 f"{lines[k + 1].split(':')[-1].strip()}"
                 for k, line in enumerate(lines)
                 if "spill" in line and "bfloat16" in lines[k - 1]]
        say(f"{label}: built" + "".join(f"\n  {n}" for n in notes))
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build.SIGNATURES["wkv6"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[label] = lib
    return libs


def inputs(b, t, h, d):
    gen = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    bf = torch.bfloat16
    return ((mk(b, t, h, d) * 0.5).to(bf), (mk(b, t, h, d) * 0.5).to(bf),
            mk(b, t, h, d).to(bf),
            torch.exp(-torch.exp((mk(b, t, h, d) * 2).clamp(-8.0, 1.0))),
            mk(h, d) * 0.1, mk(b, t, h, d).to(bf))


def time_ms(fn, iters=50, warmup=5) -> float:
    """Mean ms per call by CUDA events, the calls queued behind a sleep on
    the card that outlasts twice their launch time on the host (as
    ``chip_smoke.time_ms`` times them)."""
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * iters * host_s + 1e-3, 0.5) * 2.0e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv6_variants: no CUDA device", file=sys.stderr)
        return 2
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    libs = build()
    r, k, v, w, u, dy = inputs(*SHAPE)
    leaves = [x.float().requires_grad_() for x in (r, k, v, w, u)]
    y32, s32 = ops.wkv6_chunked(*leaves)
    want = [y32.detach(), s32.detach(),
            *torch.autograd.grad(y32, leaves, dy.float())]
    del leaves, y32, s32
    names = ("y", "state", "dr", "dk", "dv", "dw", "du")
    first = None
    for label, lib in libs.items():
        _build._loaded["wkv6"] = lib
        y, s, ckpt = wkv.wkv6_fwd(r, k, v, w, u, save=True)
        got = [y, s, *wkv.wkv6_bwd(r, k, v, w, u, ckpt, dy)[:5]]
        errs = [(g.float() - x).abs().max().item() / x.abs().max().item()
                for g, x in zip(got, want)]
        first = got if first is None else first
        same = [n for n, g, c in zip(names, got, first) if torch.equal(g, c)]
        say(f"{label}: error / largest magnitude vs the plain version on "
            "float32 casts: " + ", ".join(f"{n} {e:.2e}" for n, e in zip(names, errs))
            + f"; the committed source's bits in {same or 'none'}")
    times = {label: ([], [], []) for label in libs}
    for _ in range(2):
        for label in list(libs) + list(libs)[::-1]:
            _build._loaded["wkv6"] = libs[label]
            _, _, ckpt = wkv.wkv6_fwd(r, k, v, w, u, save=True)
            times[label][0].append(time_ms(
                lambda: wkv.wkv6_fwd(r, k, v, w, u, save=True)))
            times[label][1].append(time_ms(lambda: wkv.wkv6_fwd(r, k, v, w, u)))
            times[label][2].append(time_ms(
                lambda: wkv.wkv6_bwd(r, k, v, w, u, ckpt, dy)))
    for label, (fs, fn, bw) in times.items():
        say(f"{label}: forward (save) ms {sorted(round(x, 5) for x in fs)}, "
            f"forward ms {sorted(round(x, 5) for x in fn)}, "
            f"backward ms {sorted(round(x, 5) for x in bw)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
