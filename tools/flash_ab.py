#!/usr/bin/env python3
"""Time the committed flash-attention CUDA source against other versions
of it on one card.

    python3 tools/flash_ab.py [--wide] [OTHER.cu ...]

Each OTHER is a whole ``flash_attention.cu`` (an earlier commit's, say,
written out with ``git show <commit>:src/repro_torch/kernels/csrc/
flash_attention.cu``); one whose entry points predate the ``prefix_len``
argument is called without it.  All are built with the port's ``nvcc``
flags in parallel.  Printed: the card's name and power limit; per
version and bf16 kernel, its SASS instruction count and its BSSY
(divergent-branch) count; whether each version's outputs (out, lse, dq,
dk, dv) equal the committed source's bit for bit at prefix 0; and the
bf16 forward and backward times at the training shapes by CUDA events,
in turns (each version twice per round, in forward and reverse order),
so that the versions are compared on one card under one load (with no
OTHER, the committed source alone).  With ``--wide``, first the checks of
``chip_smoke.py``'s phase 10 past 256 columns: the committed source built
anew, its ``wgmma`` ptxas lines and every bf16 kernel's registers, spills,
shared memory and HGMMA / UTMALDG counts (``chip_smoke.flash_sass``), the
masked cases (``REPAIR_FLASH_MASKS``) and the wide ``REPAIR_FLASH``
widths, f32 and bf16 against the plain version, twice bit-identical
(``chip_smoke.repair_flash``, untimed); then the times at those widths,
the backward with the workspace each version asks for where it takes one.
Builds go to the git-ignored ``build/``.
"""

from __future__ import annotations

import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SHAPES = {   # b, tq, tk, hq, hkv, d, dv: the training shapes of chip_smoke.py
    "phi3 D 96": (4, 512, 512, 32, 32, 96, 96),
    "zamba2 shared block D 80": (4, 512, 512, 32, 32, 80, 80),
    "deepseek-moe-16b D 128": (4, 512, 512, 16, 16, 128, 128),
    "minicpm3-4b (96, 64)": (4, 512, 512, 40, 40, 96, 64),
}
KERNEL = re.compile(r"hopper\d+(fwd_kernel|dq_kernel|dkdv_kernel)ILi(\d+)ELi(\d+)E")


def say(*parts) -> None:
    print(*parts, flush=True)


def build(sources: dict) -> dict:
    """Build every version in parallel; return its loaded library and
    whether its entry points take ``prefix_len`` and its backward a
    workspace."""
    out = ROOT / "build" / "flash_ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, src) in enumerate(sources.items()):
        so = out / f"v{i}.so"
        text = src.read_text()
        # entry points with prefix_len, and a backward with a workspace
        procs[label] = (so, ("int causal, int prefix_len, void* stream" in text,
                             "void* workspace, void* stream" in text),
                        subprocess.Popen([_build.nvcc()] + _build.NVCC_FLAGS
                                         + ["-o", str(so), str(src)],
                                         stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, prefix, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{label}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [F, I] + ([I] if prefix[0] else [])
        lib.repro_flash_fwd.argtypes = [I] + [P] * 5 + [I] * 7 + tail + [P]
        lib.repro_flash_bwd.argtypes = ([I] + [P] * 10 + [I] * 7 + tail
                                        + ([P] if prefix[1] else []) + [P])
        if prefix[1]:
            lib.repro_flash_bwd_workspace.argtypes = [I] * 7
            lib.repro_flash_bwd_workspace.restype = ctypes.c_longlong
        libs[label] = (lib, prefix, so)
    return libs


def sass_counts(so: Path) -> dict:
    """kernel -> (instructions, BSSY) in the library's SASS."""
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    if not tool.exists():   # the copy in Triton's package
        import triton
        tool = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = collections.defaultdict(collections.Counter), None
    for line in sass.splitlines():
        if "Function :" in line:
            m = KERNEL.search(line)
            cur = f"{m[1]}<{m[2]},{m[3]}>" if m else None
        elif cur:
            op = re.search(r"/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
            if op:
                counts[cur]["total"] += 1
                counts[cur]["BSSY"] += op[2] == "BSSY"
    return counts


def time_ms(fn, iters=100, warmup=10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))   # queue the calls behind the card
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wide_checks() -> dict:
    """Phase 10's checks past 256 columns, as ``chip_smoke.py`` runs them;
    return the wide ``REPAIR_FLASH`` shapes."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    # build in this process, so that its ptxas report is at hand
    _build.library_path("flash_attention").unlink(missing_ok=True)
    _build.library("flash_attention")
    for line in _build.build_log["flash_attention"].splitlines():
        if "wgmma" in line.lower():
            say(f"  ptxas: {line.strip()}")
    cs.flash_sass()
    for label, shape in cs.REPAIR_FLASH_MASKS.items():
        cs.repair_flash(label, shape[:7], *shape[7:], timed=False)
    wide = {label: shape for label, shape in cs.REPAIR_FLASH.items()
            if fa.is_wide(*shape[5:])}
    for label, shape in wide.items():
        cs.repair_flash(label, shape, timed=False)
        cs.release()
    return wide


def main() -> int:
    wide = "--wide" in sys.argv[1:]
    args = [a for a in sys.argv[1:] if a != "--wide"]
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    shapes = wide_checks() if wide else SHAPES
    sources = {"committed": _build.CSRC / "flash_attention.cu"}
    sources.update({Path(p).name: Path(p) for p in args})
    libs = build(sources)
    for label, (_, _, so) in libs.items():
        for kernel, c in sorted(sass_counts(so).items()):
            if kernel.endswith(("<96,96>", "<80,80>")):
                say(f"{label} {kernel}: {c['total']} instructions, {c['BSSY']} BSSY")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for name, (b, tq, tk, h, hkv, d, dv) in shapes.items():
        d, dv = fa.padded_dims(d, dv)   # the widths the wrapper hands the kernels
        gen = torch.Generator(device="cuda").manual_seed(0)
        mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v, dout = (mk(b, tq, h, d), mk(b, tk, hkv, d), mk(b, tk, hkv, dv),
                         mk(b, tq, h, dv))
        outs = {}
        for label, (lib, prefix, _) in libs.items():
            o, lse = torch.empty_like(dout), torch.empty((b, h, tq), device="cuda")
            delta = torch.empty_like(lse)
            dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            extra = (0,) if prefix[0] else ()
            work = (torch.empty(lib.repro_flash_bwd_workspace(1, b, tk, h, hkv, d, dv),
                                dtype=torch.uint8, device="cuda")
                    if prefix[1] else None)
            split = () if work is None else (work.data_ptr() if work.numel() else None,)
            fwd = (lambda lib=lib, o=o, lse=lse, extra=extra: lib.repro_flash_fwd(
                1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                b, tq, tk, h, hkv, d, dv, d ** -0.5, 1, *extra, stream()))
            bwd = (lambda lib=lib, o=o, lse=lse, delta=delta, dq=dq, dk=dk, dvv=dvv,
                   extra=extra, split=split, work=work: lib.repro_flash_bwd(
                       1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                       dk.data_ptr(), dvv.data_ptr(), b, tq, tk, h, hkv, d, dv, d ** -0.5,
                       1, *extra, *split, stream()))
            if fwd() or bwd():
                raise RuntimeError(f"{label}: launch failed at {name}")
            torch.cuda.synchronize()
            outs[label] = (fwd, bwd, [x.clone() for x in (o, lse, dq, dk, dvv)])
        ref = outs["committed"][2]
        for label, (_, _, got) in outs.items():
            same = [torch.equal(x, y) for x, y in zip(got, ref)]
            say(f"{name}, {label}: out, lse, dq, dk, dv equal to the committed "
                f"source's: {same}")
        times = collections.defaultdict(list)
        for _ in range(2):
            for label in list(outs) + list(outs)[::-1]:
                fwd, bwd, _ = outs[label]
                times[label, "forward"].append(time_ms(fwd))
                times[label, "backward"].append(time_ms(bwd, iters=50))
        for (label, kind), xs in times.items():
            say(f"{name}, {label}, {kind} ms: {' '.join(f'{x:.5f}' for x in sorted(xs))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
