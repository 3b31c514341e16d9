#!/usr/bin/env python3
"""Time variants of the flash-attention CUDA source side by side on one card.

    python3 tools/flash_variants.py

Each variant is ``csrc/flash_attention.cu`` with a few text substitutions
(``VARIANTS`` below; the first is the source as committed).  All are
built with the port's ``nvcc`` flags in parallel, checked against the
plain version at phi3's and zamba2's training shapes (bf16, ``3e-2``),
and timed in one process, in turns (each variant twice per round, in
forward and reverse order), so that two designs are compared on one card
under one load.  Then ``torch.profiler`` gives the device time of each
kernel of the committed source and of ``scaled_dot_product_attention``
pinned to its flash backend, forward and backward.  The card's name and
power limit come first.  Builds go to the git-ignored ``build/``.

The variants are ablations (a variant that skips work gives wrong
results and is reported as such: only its time is read) and the
alternatives the design was chosen against.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

FWD_LOOP = "    mbar_wait(k_full(s), ph);\n    if (live) {"
VARIANTS = {
    "committed": [],
    # the forward's TMA loads, barriers and stores with no arithmetic
    "fwd skeleton": [(FWD_LOOP, "    mbar_wait(k_full(s), ph);\n"
                                "    mbar_wait(v_full(s), ph);\n"
                                "    if (live && scale_log2 > 1e30f) {")],
    # the forward without P V
    "fwd scores only": [("      mma_rows<S::kWV>(o0, o1, a, v_s + s * v_stage + "
                         "part * (S::kWV / kBox) * kTileBox,\n"
                         "                       kTileBox);\n", "")],
    # CUDA's exp2f in place of ex2.approx
    "exp2f": [('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
               "  y = exp2f(x);")],
    # a 3-stage forward ring
    "fwd 3 stages": [("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 3;")],
    # dK/dV without moving registers to its consumers (168 each)
    "dK/dV no setmaxnreg": [("    regs_give<kProducerRegs>();\n", ""),
                            ("  regs_take<kConsumerRegs>();\n", "")],
    # two forward blocks per SM
    "fwd 2 blocks/SM": [("__global__ void __launch_bounds__(kThreadsH, 1)\nfwd_kernel(",
                         "__global__ void __launch_bounds__(kThreadsH, 2)\nfwd_kernel(")],
}
SHAPES = {"phi3 D 96": (4, 512, 512, 32, 32, 96),
          "zamba2 shared block D 80": (4, 512, 512, 32, 32, 80)}
TOL = 3e-2


def say(*parts) -> None:
    print(*parts, flush=True)


def build() -> dict:
    """Build every variant in parallel; return the loaded libraries."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out = ROOT / "build" / "flash_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise AssertionError(f"{label}: substitution does not match once")
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
        notes = [line.strip() for line in log.splitlines() if "C75" in line]
        say(f"{label}: built" + "".join(f"\n  {n[:200]}" for n in notes))
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build.SIGNATURES["flash_attention"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _build.RESTYPES.get(fn, ctypes.c_int)
        libs[label] = lib
    return libs


def inputs(b, tq, tk, hq, hkv, d):
    gen = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    return mk(b, tq, hq, d), mk(b, tk, hkv, d), mk(b, tk, hkv, d), mk(b, tq, hq, d)


def time_ms(fn, iters=100, warmup=10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, reps=10) -> dict:
    """Mean device time per call of each CUDA kernel ``fn`` launches."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.device_time_total / reps for ev in prof.key_averages()
            if ev.device_time_total > 0}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 2
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    libs = build()
    for name, shape in SHAPES.items():
        q, k, v, dout = inputs(*shape)
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        plain = ref.flash_attention(qr, kr, vr)
        want = [plain.detach(), *torch.autograd.grad(plain, (qr, kr, vr), dout)]
        times = {label: ([], []) for label in libs}
        for label, lib in libs.items():
            _build._loaded["flash_attention"] = lib
            out, lse = fa.flash_attention_fwd(q, k, v)
            got = [out, *fa.flash_attention_bwd(q, k, v, out, lse, dout)]
            ok = all(((g.float() - w.float()).abs()
                      <= TOL * (1 + w.float().abs())).all().item()
                     for g, w in zip(got, want))
            say(f"{name}, {label}: {'agrees with' if ok else 'DIFFERS from'} "
                f"the plain version (bf16 {TOL})")
        for _ in range(2):
            for label in list(libs) + list(libs)[::-1]:
                _build._loaded["flash_attention"] = libs[label]
                out, lse = fa.flash_attention_fwd(q, k, v)
                times[label][0].append(time_ms(lambda: fa.flash_attention_fwd(q, k, v)))
                times[label][1].append(time_ms(
                    lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout), iters=50))
        for label, (f, b) in times.items():
            say(f"{name}, {label}: forward ms {sorted(round(x, 5) for x in f)}, "
                f"backward ms {sorted(round(x, 5) for x in b)}")

    from torch.nn.attention import SDPBackend, sdpa_kernel
    _build._loaded["flash_attention"] = libs["committed"]
    for name, shape in SHAPES.items():
        q, k, v, dout = inputs(*shape)
        out, lse = fa.flash_attention_fwd(q, k, v)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            so = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)
            calls = {
                "kernels, forward": lambda: fa.flash_attention_fwd(q, k, v),
                "kernels, backward": lambda: fa.flash_attention_bwd(
                    q, k, v, out, lse, dout),
                "sdpa/flash, forward": lambda: torch.nn.functional.
                scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                "sdpa/flash, backward": lambda: torch.autograd.grad(
                    so, (qt, kt, vt), dout.transpose(1, 2), retain_graph=True),
            }
            for what, fn in calls.items():
                events = time_ms(fn, iters=50)
                say(f"{name}, {what}: {events:.5f} ms by CUDA events; device us "
                    "per call: " + ", ".join(
                        f"{key[:70]} {us:.2f}" for key, us in device_us(fn).items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
