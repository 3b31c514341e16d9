#!/usr/bin/env python3
"""Time variants of the Mamba2 SSD CUDA source side by side on one card.

    python3 tools/ssd_variants.py

Each variant is ``csrc/mamba2_ssd.cu`` with a few text substitutions
(``VARIANTS`` below; the first is the source as committed).  All are
built with the port's ``nvcc`` flags in parallel, checked at zamba2-2.7b's
training shape (B 4, T 512, 80 heads, P = N = 64, bf16, no initial state)
against the plain version run on the same inputs cast to float32 (each
output's and gradient's largest error over its largest magnitude), and
timed in one process, in turns (each variant twice per round, in forward
and reverse order), so that two designs are compared on one card under
one load: the forward with and without saving the chunk-start states,
and the backward.  The committed source's backward is also timed at
every cluster size (:data:`repro_torch.kernels.mamba2_ssd.MAX_GROUP`).
The card's name and power limit come first.  Builds go to the
git-ignored ``build/``.

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

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import mamba2_ssd as ssd  # noqa: E402

LAUNCH_BOUNDS = "__launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 1)"
VARIANTS = {
    "committed": [],
    # f32 operands rounded once to bf16: one mma pass where a split takes two
    "single pass": [("constexpr bool kLoPass = true;", "constexpr bool kLoPass = false;", 1)],
    # the fast exponential for every decay (the decay matrices, e^L, w)
    "fast exp": [("expf(static_cast<float>(", "__expf(static_cast<float>(", 7)],
    # registers for two blocks per SM instead of three
    "2 blocks/SM": [(LAUNCH_BOUNDS, "__launch_bounds__(kThreads, 2)", 2)],
    # ablation: the forward without its state update (the chain over chunks)
    "fwd no state update": [(
        "    product(S, a_scaled<false>(sm.x[buf], sm.wdt), b_of<false>(sm.b[buf]), "
        "m0, lane);\n", "", 1)],
    # ablation: the backward without its head-group sum
    "bwd no cluster sum": [("          sb += pb[ob];\n          sc += pc[oc];\n", "", 1)],
}
SHAPE = (4, 512, 80, 64, 64)
GROUPS = (1, 2, 4, 8)


def say(*parts) -> None:
    print(*parts, flush=True)


def build() -> dict:
    """Build every variant in parallel; return the loaded libraries."""
    src = (_build.CSRC / "mamba2_ssd.cu").read_text()
    out = ROOT / "build" / "ssd_variants"
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
        notes = [f"{lines[k - 1].split('ssd_')[-1][:20]}: {line.strip()}; "
                 f"{lines[k + 1].split(':')[-1].strip()}"
                 for k, line in enumerate(lines)
                 if "spill" in line and "bfloat16" in lines[k - 1]]
        say(f"{label}: built" + "".join(f"\n  {n}" for n in notes))
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build.SIGNATURES["mamba2_ssd"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[label] = lib
    return libs


def inputs(b, t, h, p, n):
    gen = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    bf = torch.bfloat16
    return (mk(b, t, h, p).to(bf), torch.nn.functional.softplus(mk(b, t, h)),
            -torch.exp(torch.rand(h, generator=gen, device="cuda")),
            (mk(b, t, n) * 0.5).to(bf), (mk(b, t, n) * 0.5).to(bf),
            mk(b, t, h, p).to(bf))


def time_ms(fn, iters=50, warmup=5) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_variants: no CUDA device", file=sys.stderr)
        return 2
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    libs = build()
    x, dt, A, Bm, Cm, dy = inputs(*SHAPE)
    leaves = [v.float().requires_grad_() for v in (x, dt, A, Bm, Cm)]
    y32, s32 = ops.mamba2_chunked(*leaves)
    want = [y32.detach(), s32.detach(),
            *torch.autograd.grad(y32, leaves, dy.float())]
    del leaves, y32, s32
    names = ("y", "state", "dx", "ddt", "dA", "dB", "dC")
    for label, lib in libs.items():
        _build._loaded["mamba2_ssd"] = lib
        y, s, ckpt = ssd.ssd_fwd(x, dt, A, Bm, Cm, save=True)
        got = [y, s, *ssd.ssd_bwd(x, dt, A, Bm, Cm, ckpt, dy)[:5]]
        errs = [(g.float() - w).abs().max().item() / w.abs().max().item()
                for g, w in zip(got, want)]
        say(f"{label}: error / largest magnitude vs the plain version on "
            "float32 casts: " + ", ".join(f"{k} {e:.2e}" for k, e in zip(names, errs)))
    times = {label: ([], [], []) for label in libs}
    for _ in range(2):
        for label in list(libs) + list(libs)[::-1]:
            _build._loaded["mamba2_ssd"] = libs[label]
            _, _, ckpt = ssd.ssd_fwd(x, dt, A, Bm, Cm, save=True)
            times[label][0].append(time_ms(
                lambda: ssd.ssd_fwd(x, dt, A, Bm, Cm, save=True)))
            times[label][1].append(time_ms(lambda: ssd.ssd_fwd(x, dt, A, Bm, Cm)))
            times[label][2].append(time_ms(
                lambda: ssd.ssd_bwd(x, dt, A, Bm, Cm, ckpt, dy)))
    for label, (fs, fn, bw) in times.items():
        say(f"{label}: forward (save) ms {sorted(round(v, 5) for v in fs)}, "
            f"forward ms {sorted(round(v, 5) for v in fn)}, "
            f"backward ms {sorted(round(v, 5) for v in bw)}")
    _build._loaded["mamba2_ssd"] = libs["committed"]
    _, _, ckpt = ssd.ssd_fwd(x, dt, A, Bm, Cm, save=True)
    committed = ssd.MAX_GROUP
    for g in GROUPS:
        ssd.MAX_GROUP = g
        ms = sorted(time_ms(lambda: ssd.ssd_bwd(x, dt, A, Bm, Cm, ckpt, dy))
                    for _ in range(3))
        say(f"committed, backward at cluster size {g}: ms "
            f"{[round(v, 5) for v in ms]}")
    ssd.MAX_GROUP = committed
    return 0


if __name__ == "__main__":
    sys.exit(main())
