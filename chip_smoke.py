#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives its serving path with full-width, full-depth phi3-mini-3.8b and
its training-and-recovery path with full-width phi3-mini-3.8b cut to 2
layers, rwkv6-3b cut to 2 and zamba2-2.7b cut to 6 (random weights from
a seed).  Phases, each of which raises on a
failed check:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, TF32 off, and the kernels' build time;
1. the paged kernels against their plain PyTorch versions on the card,
   at phi3's attention shape (32 heads, head dim 96) with serving
   lengths (up to 256) and long-context ones (up to 4096),
   starcoder2-7b's (36 over 4 kv heads, head dim 128) short and long (up
   to 2048) and an odd one (7 query heads per kv head, head dim 72, page
   5), ragged lengths, shared prefix pages and out-of-range table
   entries, float32 and bfloat16, the multi-token fold and the int8
   kernel; every paged kernel's registers and spills (ptxas; none may
   spill); then at the three timed shapes (phi3 serving and long
   context, starcoder2-7b long; bf16, L2 cold): two launches
   bit-identical, each row alone equal to its row in the batch and the
   fold's rows equal to single-row calls, and the device time of kernel,
   plain version and ``scaled_dot_product_attention`` (each backend
   pinned in turn, the fastest kept) beside the bound, gated: at most
   0.020 ms at phi3's serving shape, at most 3x the bound at its long
   context, and no slower than SDPA at each;
2. ``Serve.local`` serving 8 requests with speculative decode (spec_k=3),
   4 slots, round-robin parking: tokens/s, steps, acceptance, kernel
   launches (one per layer per token), peak memory;
3. the same requests with spec_k=0: the tokens must be identical;
4. two requests at float32 compute through the kernel and through the
   plain versions: the tokens must be identical (a difference where the
   plain path's top two logits tie within the float32 bound is reported
   as a tie);
5. the phase-2 requests over an int8 pool through the int8 kernel, with
   token agreement against phase 2 reported;
6. the flash-attention kernels (forward, and backward through autograd)
   against their plain version: phi3 heads (32/32, D 96) at the training
   shape (B 4, T 512), starcoder2-7b's (36 over 4, D 128), zamba2's
   shared block (32/32, D 80) and a D 64 shape, a ragged T 200, Tq < Tk
   and non-causal Tq > Tk, float32 (CUDA-core route) and bfloat16
   (tensor-core route:
   wgmma fed by TMA), with the float32 gradients also held against a
   float64 computation; the bf16 kernels' registers, spills and shared
   memory (ptxas) and their HGMMA / UTMALDG counts (cuobjdump -sass), none
   without HGMMA; two bf16 forward and backward launches at phi3's
   training shape bit-identical; the kernel path refuses prefix_len != 0
   and causal Tq > Tk; then forward and backward times at both training shapes
   (B 4, T 512, bf16: phi3 heads, and zamba2's shared block at D 80,
   recorded under ``at_head_dim_80``) beside their bounds, the plain
   version's and ``scaled_dot_product_attention``'s pinned to its flash
   backend;
7. the XOR kernel against its plain version, R = 2, 4, 8, byte-exact;
8. ``Trainer`` as ``examples/quickstart.py`` drives it (BUDDY with async
   drain, IntervalPolicy(4), node 3 killed at step 6 of 8) with phi3 at
   full width and 2 layers, B 4 x T 512, deterministic algorithms and
   TF32 off: one recovery from step 4, the loss falls, flash launches
   are 2 forward (remat) + 1 backward pass (3 launches) per layer per
   step with no plain or library attention call, and the final state's
   SHA-256 equals an
   uninterrupted run's; step ms, checkpoint bytes and seconds, restore
   seconds, peak device memory and free disk reported;
9. the phase-8 state checkpointed with NAM_XOR, node 3 killed and the
   state restored byte-identically; each XOR group's fragments stacked on
   the card and reduced through the XOR kernel equal the NAM parity the
   SCR stored; the kernel timed at that shape;
10. the WKV6 and SSD scan kernels (forward, and backward through
   autograd) against their plain versions at rwkv6-3b's training shape
   (B 4, T 512, 40 heads of 64) and zamba2-2.7b's (80 heads, P = N = 64)
   and a ragged T 200 (WKV6 also D 16 at T 77, T 64 (one chunk) and T 1;
   SSD also odd P 16 / N 8 at T 77, and T 64), zero and non-zero initial
   state, float32 and bfloat16, the float32 gradients also held against a
   float64 computation, the bf16 results also against the plain version
   on float32 casts (1%), a repeated run bit-identical; the WKV6 kernels
   also below the model's decay clip (w down to 1e-20) against the
   sequential oracle; both sources' registers and spills; then forward
   and backward times at the training shapes beside their bounds and the
   plain versions', each kernel's CUDA launches per call from a device
   trace (as ``CUDA_LAUNCHES`` of its wrapper plans them) and their time
   gates (SSD forward <= 0.100 ms, backward <= 0.300 ms; WKV6 <= 0.150 /
   0.350 ms);
11. rwkv6-3b: a full-depth (32 layers) bf16 prefill through
   ``make_prefill_step`` (one WKV6 launch per layer, no plain scan), the
   float32 forward through the kernels against the plain path, then
   ``Trainer`` at published width cut to 2 layers (PARTNER copies,
   IntervalPolicy(4), node 3 killed at step 6 of 8): one recovery, a
   falling loss, 2 forward and 1 backward WKV6 launches per layer per step
   and no plain scan, and a final-state SHA-256 equal to an uninterrupted
   run's;
12. zamba2-2.7b, the same: full depth 54 layers (one SSD launch per Mamba
   layer, one flash launch per shared-block group), training cut to 6
   layers (one group): 2 forward and 1 backward SSD launches per Mamba
   layer per step, 1 flash forward and 3 flash backward launches per
   group per step.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import hashlib
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

# deterministic cuBLAS for the training phases: read when cuBLAS starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.api import IntervalPolicy, ResilienceSession  # noqa: E402
from repro_torch.cluster.topology import NodeState, VirtualCluster  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import parity  # noqa: E402
from repro_torch.core.scr import SCRManager, Strategy, _nam_region  # noqa: E402
from repro_torch.convert import state_to_numpy  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.io.serialization import serialize_state_stream  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba2_ssd as ssd  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as wkv  # noqa: E402
from repro_torch.kernels import xor_parity as xp  # noqa: E402
from repro_torch.memory.stack import TierStack  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, tree_leaves  # noqa: E402
from repro_torch.serve import Serve, ServeConfig, scheduler  # noqa: E402
from repro_torch.train.step import (init_train_state, make_prefill_step,  # noqa: E402
                                    make_train_step)
from repro_torch.train.trainer import FailureEvent, Trainer  # noqa: E402

SEED = 0
F32_TOL = dict(atol=3e-6, rtol=1e-5)     # tests/test_paged_attention.py
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
QUANT_VS_F32 = 0.05                      # tests/test_codecs.py:238
# bf16 paged kernels against their own algorithm in f32 arithmetic (the
# split form in kernels.ref, p rounded as the kernel rounds it): the
# output's one bf16 rounding (at most 2^-7 of a value) plus p's roundings
# moved by f32 noise, the latter against the rms of each row's output
SPLIT_TOL = dict(rtol=1e-2, rms=2e-2)
HBM_BYTES_PER_S = 3.35e12                # H100 SXM
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}   # non-tensor f32, bf16
DEVICE = "cuda"
SERVE = dict(arch="phi3-mini-3.8b", full_size=True, prefix=False, slots=4,
             max_len=256, page_tokens=16, quantum=4, device=DEVICE)
N_REQUESTS, MAX_NEW = 8, 32
FLASH_F32_TOL = dict(atol=3e-6, rtol=1e-5)   # tests/test_kernels.py:35-73
FLASH_BF16_TOL = dict(atol=3e-2, rtol=3e-2)
# float32 gradients sum up to g * T = 9 * 512 products per element; the
# plain version itself lies up to 6.4e-6 from a float64 computation at the
# starcoder2-7b shape, so two float32 summation orders may differ by about
# twice that: the backward is held at atol 2e-5 against the plain version,
# and beside that the kernel's distance to the float64 computation may not
# exceed the larger of the plain version's distance and FLASH_F64_ATOL
FLASH_BWD_F32_TOL = dict(atol=2e-5, rtol=1e-5)
FLASH_F64_ATOL = 1e-5
# the scans at float32: the reference's own tolerance for its chunked and
# Pallas scans (tests/test_kernels.py:107-125, 175-193); bf16 as the flash
SCAN_F32_TOL = dict(atol=5e-5, rtol=1e-4)
SCAN_BF16_TOL = dict(atol=3e-2, rtol=3e-2)
# scan gradients sum over up to T tokens and P x N (D x D) state cells, so
# they are held relative to each gradient's largest magnitude: within
# SCAN_BWD_F32_REL of the plain version's, and nearer float64 than the
# plain version or SCAN_F64_REL
SCAN_BWD_F32_REL = 1e-4
SCAN_F64_REL = 1e-5
SCAN_CASES = {   # the first of each kind is its training shape
    "wkv6": {"rwkv6-3b B=4 T=512 (H=40, D=64)": (4, 512, 40, 64),
             "rwkv6-3b T=200": (2, 200, 40, 64),
             # a head under 64 (zero-padded in the kernel), a ragged chunk
             "D=16 T=77": (1, 77, 3, 16),
             "one chunk T=64": (2, 64, 4, 64),
             "T=1": (1, 1, 2, 64)},
    "ssd": {"zamba2-2.7b B=4 T=512 (H=80, P=N=64)": (4, 512, 80, 64, 64),
            "zamba2-2.7b T=200": (2, 200, 80, 64, 64),
            # odd P and N (zero-padded in the kernel), a ragged last chunk
            "odd P=16 N=8 T=77": (1, 77, 3, 16, 8),
            "one chunk T=64": (2, 64, 4, 64, 64)},
}
# the bf16 scan kernels (SSD and WKV6) against the plain version on the
# same inputs cast to float32: y and the final state within SCAN_TIGHT_REL
# of a value plus SCAN_TIGHT_REL of its (batch row, head)'s rms, each
# gradient within SCAN_TIGHT_REL of its largest magnitude (bf16 outputs
# round at 2^-9)
SCAN_TIGHT_REL = 1e-2
# the SSD kernels' times at zamba2-2.7b's training shape (bf16): gates,
# checked after every time is printed, and goals, reported
SSD_GATE_MS = {"mamba2_ssd_fwd": 0.100, "mamba2_ssd_bwd": 0.300}
SSD_GOAL_MS = {"mamba2_ssd_fwd": 0.045, "mamba2_ssd_bwd": 0.120}
# the WKV6 kernels' times at rwkv6-3b's training shape (bf16, the forward
# saving its chunk-start states): gates and goals, as the SSD's
WKV6_GATE_MS = {"wkv6_fwd": 0.150, "wkv6_bwd": 0.350}
WKV6_GOAL_MS = {"wkv6_fwd": 0.060, "wkv6_bwd": 0.150}
# phase 10's case below the model's decay clip: w down to 1e-20 on every
# other channel, against the sequential oracle (the chunked plain version
# overflows there)
BELOW_CLIP_SHAPE = (1, 77, 2, 64)
# phases 11-12: the recurrent families at published width; training cuts
# the depth (rwkv6-3b 32 -> 2 layers, zamba2-2.7b 54 -> 6, one group)
FAMILY = dict(layers={"rwkv6-3b": 2, "zamba2-2.7b": 6}, batch=4, seq=512,
              steps=8, ckpt_every=4, fail_step=6, fail_rank=3, lr=1e-3,
              warmup=4)
# kernel path vs plain path of a whole float32 forward: 1.6e-5 measured on
# an H100 (rwkv6-3b, 2 layers)
FAMILY_F32_TOL = dict(atol=1e-4, rtol=1e-4)
# the training run: phi3-mini-3.8b at published width, depth cut to 2
TRAIN = dict(arch="phi3-mini-3.8b", layers=2, batch=4, seq=512, steps=8,
             ckpt_every=4, fail_step=6, fail_rank=3, lr=1e-3, warmup=4)
# free disk a 2-layer run needs: BUDDY keeps 2 checkpoints of ~5.1 GB,
# each as local, buddy and global copies
TRAIN_DISK_2L = 40 * 2**30


def say(*parts) -> None:
    print(*parts, flush=True)


def check_close(name, got, want, atol, rtol):
    """Raise unless |got - want| <= atol + rtol |want|; return max |err|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    over = (err - (atol + rtol * want.abs())).max().item()
    worst = err.max().item()
    say(f"  {name}: max_abs_err={worst:.3e} (atol={atol}, rtol={rtol})")
    if not torch.isfinite(got).all() or over > 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {worst:.3e})")
    return worst


def check_scaled(name, got, want, rel):
    """Raise unless max |got - want| <= rel * max |want|; return that
    relative distance."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    worst = (got - want).abs().max().item() / max(scale, 1e-30)
    say(f"  {name}: max_abs_err / max|want| = {worst:.3e} (max|want| "
        f"{scale:.3e}, limit {rel})")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()
            and worst <= rel):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(relative error {worst:.3e})")
    return worst


def check_split(name, got, want, rows):
    """Raise unless |got - want| <= rtol |want| + rms * (the rms of want's
    row), over ``rows`` rows (a length-0 row must match exactly); return
    the largest error over its row's rms."""
    got, want = got.float().reshape(rows, -1), want.float().reshape(rows, -1)
    rms = want.pow(2).mean(dim=1, keepdim=True).sqrt()
    err = (got - want).abs()
    over = (err - SPLIT_TOL["rtol"] * want.abs()
            - SPLIT_TOL["rms"] * rms).max().item()
    worst = (err / rms.clamp(min=1e-30)).max().item()
    say(f"  {name}: max_abs_err / row rms = {worst:.3e} (rtol="
        f"{SPLIT_TOL['rtol']}, {SPLIT_TOL['rms']} x row rms)")
    if not torch.isfinite(got).all() or over > 0:
        raise AssertionError(f"{name}: kernel disagrees with its algorithm "
                             f"in f32 (max error / row rms {worst:.3e})")
    return worst


# an upper bound on the SM clock (Hz): a sleep of s seconds spins s x this
# many cycles, so it lasts at least s at any clock
SLEEP_HZ = 2.0e9


def time_ms(fn, iters=100, warmup=10) -> float:
    """Mean ms of ``fn`` by CUDA events over ``iters`` calls.  The calls
    are queued behind a sleep on the card that outlasts twice their launch
    time on the host (taken over the warm-up), so that the events time the
    card's work, not the host's rate of launching it."""
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * iters * host_s + 1e-3, 0.5) * SLEEP_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class DeviceTime(NamedTuple):
    ms: float          # the median trace's device time per call
    traces_ms: list    # every trace's, in the order taken
    launches: float    # the median trace's device activities per call


def device_time(fn, reps=40, traces=3) -> DeviceTime:
    """Device time per call of everything ``fn`` launches: the durations
    of its kernels in a ``torch.profiler`` trace of ``reps`` calls, summed,
    so neither host time nor the gaps between launches count; the median
    of ``traces`` traces (a trace now and then comes back empty or short),
    with the number of device activities (kernels, copies, sets) per call
    that the same trace holds."""
    from torch.autograd import DeviceType
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call, launches = [], []
    for _ in range(traces):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per_call.append(sum(ev.device_time_total for ev in prof.key_averages())
                        / reps / 1e3)
        launches.append(sum(ev.device_type == DeviceType.CUDA
                            for ev in prof.events()) / reps)
    mid = sorted(range(traces), key=per_call.__getitem__)[traces // 2]
    if per_call[mid] <= 0:
        raise AssertionError("the profiler saw no device time")
    return DeviceTime(per_call[mid], per_call, launches[mid])


# ---------------------------------------------------------------------- #
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------- #


def make_case(b, hq, hkv, d, page, n_p, lengths, dtype, layers=1, seed=SEED):
    """A pool of ``layers`` layers (for timing with a cold L2) plus one
    batch: rows share row 0's first two pages, one entry is -1 and one
    lies past the pool inside the valid range (both clamped), and
    entries past a row's valid pages are -1."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    n = 1 + 2 * b * n_p                   # a trash page, then room to spare
    q = torch.randn(b, hq, d, generator=gen, device=DEVICE).to(dtype)
    shape = (layers, n, page, hkv, d)
    k = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    v = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    perm = torch.randperm(n - 1, generator=gen, device=DEVICE)[: b * n_p] + 1
    table = perm.reshape(b, n_p).to(torch.int32)
    table[1:, :2] = table[0, :2]          # shared prefix pages
    lengths = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    for r in range(b):
        used = -(-int(lengths[r]) // page)
        table[r, used:] = -1
    if b > 2:
        table[2, 0] = -1                  # clamps to page 0
    if b > 3:
        table[3, 1] = n + 7               # clamps to page n-1
    return q, k, v, table, lengths


def kernel_bound_ms(q, k_pages, table, lengths, quant=False) -> tuple:
    """Least time for the work of one call: the unique valid K/V rows (and
    scales) read once plus q, table and lengths read and out written,
    over HBM bandwidth; against 4 flops per (q head, position, dim) over
    the peak of the inputs' type."""
    n, page, hkv, d = k_pages.shape
    t = table.clamp(0, n - 1).cpu().numpy()
    rows = set()
    for r, ln in enumerate(lengths.cpu().tolist()):
        for p in range(min(ln, t.shape[1] * page)):
            rows.add((int(t[r, p // page]), p % page))
    per_row = hkv * d * k_pages.element_size() + (hkv * 4 if quant else 0)
    nbytes = (2 * len(rows) * per_row + 2 * q.numel() * q.element_size()
              + table.numel() * 4 + lengths.numel() * 4)
    ops_n = 4 * q.shape[1] * d * int(lengths.clamp(0, t.shape[1] * page).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops_n / PEAK_OPS[str(q.dtype).split(".")[-1]]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def sdpa_ms(q, k_layers, v_layers, table, lengths, traces=5) -> tuple:
    """One PyTorch call computing the same function (the yardstick; the
    port never calls it): SDPA over each layer's cache gathered
    beforehand, cycling over the layers as the kernel is timed, so that
    each call finds L2 cold.  Each backend is pinned in turn, with the kv
    heads shared through ``enable_gqa`` where the backend takes it and
    repeated to every query head where not; returns the fastest that takes
    the boolean mask by device time, as (:class:`DeviceTime`,
    "sdpa/<backend>", eager ms)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    n = k_layers.shape[1]
    b, hq, d = q.shape
    g = hq // k_layers.shape[3]
    tb = table.clamp(0, n - 1).long()

    def gathered(pages, repeat):
        c = ref.gather_pages(pages, tb).to(q.dtype)
        return (c.repeat_interleave(g, 2) if repeat else c).transpose(1, 2).contiguous()

    s = tb.shape[1] * k_layers.shape[2]
    mask = (torch.arange(s, device=DEVICE)[None, :] < lengths[:, None].long())
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    best = (None, None, None)
    for repeat in ((False, True) if g > 1 else (True,)):
        caches = [(gathered(kl, repeat), gathered(vl, repeat))
                  for kl, vl in zip(k_layers, v_layers)]
        layer = itertools.cycle(caches)
        for backend in (SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            def call():
                kc, vc = next(layer)
                return F.scaled_dot_product_attention(
                    q4, kc, vc, attn_mask=mask, enable_gqa=not repeat)
            try:
                with sdpa_kernel(backend):
                    call()
                    torch.cuda.synchronize()
                    dev = device_time(call, traces=traces)
                    eager = time_ms(call)
            except RuntimeError:
                continue          # this backend does not take these inputs
            name = f"sdpa/{backend.name.lower().replace('_attention', '')}"
            name += "" if g == 1 else ("+repeated_kv" if repeat else "+gqa")
            say(f"    {name}: {dev.ms:.5f} ms on the device (traces "
                f"{', '.join(f'{x:.5f}' for x in dev.traces_ms)}), "
                f"{eager:.5f} ms eager")
            if best[0] is None or dev.ms < best[0].ms:
                best = (dev, name, eager)
        del caches, layer
        release()
    if best[1] is None:
        raise AssertionError("no SDPA backend took the boolean mask")
    return best


# correctness shapes of the paged kernels: b, hq, hkv, d, page, nP, lengths
PAGED_SHAPES = {
    "phi3 (Hq=Hkv=32, D=96)": (4, 32, 32, 96, 16, 16, [256, 203, 96, 37]),
    "starcoder2-7b (Hq=36, Hkv=4, D=128)": (3, 36, 4, 128, 16, 8,
                                            [128, 77, 1]),
    "phi3 long context": (4, 32, 32, 96, 16, 256, [4096, 3001, 1024, 200]),
    "starcoder2-7b long context": (4, 36, 4, 128, 16, 128,
                                   [2048, 1500, 512, 64]),
    # g = 7 (passes of 4, 2 and 1 query heads), int8 rows of D % 16 = 8
    # (8-byte copies), an odd page, a row one past a span and one on it
    "Hq=28, Hkv=4, D=72, page 5": (3, 28, 4, 72, 5, 13, [65, 64, 7]),
}
# timed shapes (bf16, cold L2) and their gates, each on both kernels: a
# fixed ceiling in ms, a multiple of the bound, and no slower than SDPA
PAGED_TIMED = {
    "serving": ("phi3 (Hq=Hkv=32, D=96)", dict(max_ms=0.020)),
    "long_context": ("phi3 long context", dict(max_bound_x=3.0)),
    "starcoder2": ("starcoder2-7b long context", {}),
}


def ptxas_report(log: str) -> dict:
    """Registers and spills per kernel instantiation in an ``-Xptxas -v``
    log, by demangled name where ``cu++filt`` is at hand."""
    report, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m[1]
            report[cur] = {}
        elif cur and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill", line)
            report[cur].update(spill_stores=int(stores), spill_loads=int(loads))
        elif cur and "Used" in line and "registers" in line:
            report[cur]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
    filt = Path(_build.nvcc()).parent / "cu++filt"
    names = list(report)
    if filt.exists() and names:
        out = subprocess.run([str(filt)] + names, capture_output=True,
                             text=True).stdout.splitlines()
        if len(out) == len(names):   # "void <unnamed>::f<...>(<unnamed>::Args)"
            report = {nice.rsplit("(", 1)[0].replace("void ", "", 1)
                      .replace("<unnamed>::", ""): report[raw]
                      for raw, nice in zip(names, out)}
    return report


def paged_ptxas() -> dict:
    """Registers and spills of every paged kernel instantiation, from the
    build's ``-Xptxas -v`` report; raises if one spills."""
    log = _build.build_log.get("paged_attention")
    if log is None:
        raise AssertionError("no ptxas report: paged_attention.cu was not built "
                             "by this run (delete build/repro_torch_kernels)")
    report = ptxas_report(log)
    for key, entry in report.items():
        say(f"  ptxas {key}: {entry.get('registers')} registers, spill stores "
            f"{entry.get('spill_stores')} B / loads {entry.get('spill_loads')} B")
    spilled = [k for k, e in report.items()
               if e.get("spill_stores", 0) or e.get("spill_loads", 0)]
    if not report or spilled:
        raise AssertionError(f"paged kernels that spill: {spilled}")
    return report


def paged_checks(label, shape, dtype, errs) -> None:
    """Both paged kernels (and their multi-token folds) against their plain
    versions at one shape; length-0 rows give zeros."""
    b, hq, hkv, d, page, n_p, lens = shape
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    q, k, v, table, lengths = make_case(b, hq, hkv, d, page, n_p, lens, dtype)
    k, v = k[0], v[0]
    tag = f"{label} {str(dtype)[6:]}"
    split = pa.split_tokens()
    got = ops.paged_attention(q, k, v, table, lengths)
    want = ops.paged_attention(q, k, v, table, lengths, use_kernel=False)
    errs["paged_attention"] = max(errs["paged_attention"], check_close(
        f"paged_attention {tag}", got, want, **tol))
    if dtype == torch.bfloat16:
        check_split(f"paged_attention {tag} vs its algorithm in f32", got,
                    ref.paged_attention_split(q, k, v, table, lengths, split), b)
    # the multi-token fold: 4 candidate rows per lane, which are rows of
    # lane b's table at lengths positions + 1
    t_rows = 4
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    qm = torch.randn(b, t_rows, hq, d, generator=gen, device=DEVICE).to(dtype)
    base = (lengths.clamp(min=t_rows) - t_rows).to(torch.int32)
    positions = base[:, None] + torch.arange(
        t_rows, dtype=torch.int32, device=DEVICE)[None]
    fold = (qm.reshape(b * t_rows, hq, d), table.repeat_interleave(t_rows, 0),
            positions.reshape(-1) + 1)
    got = ops.paged_attention_multitok(qm, k, v, table, positions)
    want = ops.paged_attention_multitok(qm, k, v, table, positions,
                                        use_kernel=False)
    check_close(f"paged_attention_multitok {tag}", got, want, **tol)
    if dtype == torch.bfloat16:
        check_split(f"paged_attention_multitok {tag} vs its algorithm in f32",
                    got, ref.paged_attention_split(fold[0], k, v, *fold[1:],
                                                   split), b * t_rows)
    # the int8 kernel against its plain version
    kq, ks = ref.quantize_pages(k)
    vq, vs = ref.quantize_pages(v)
    got = ops.paged_attention_quant(q, kq, ks, vq, vs, table, lengths)
    want = ops.paged_attention_quant(q, kq, ks, vq, vs, table, lengths,
                                     use_kernel=False)
    errs["paged_attention_quant"] = max(
        errs["paged_attention_quant"],
        check_close(f"paged_attention_quant {tag}", got, want, **tol))
    if dtype == torch.bfloat16:
        check_split(f"paged_attention_quant {tag} vs its algorithm in f32",
                    got, ref.paged_attention_quant_split(
                        q, kq, ks, vq, vs, table, lengths, split), b)
    got = ops.paged_attention_quant_multitok(qm, kq, ks, vq, vs, table,
                                             positions)
    want = ops.paged_attention_quant_multitok(
        qm, kq, ks, vq, vs, table, positions, use_kernel=False)
    check_close(f"paged_attention_quant_multitok {tag}", got, want, **tol)
    if dtype == torch.bfloat16:
        check_split(f"paged_attention_quant_multitok {tag} vs its algorithm "
                    "in f32", got, ref.paged_attention_quant_split(
                        fold[0], kq, ks, vq, vs, *fold[1:], split), b * t_rows)
    if dtype == torch.float32:
        # the int8 kernel is the float32 kernel on the dequantized pool,
        # and within the reference's int8 gate of the float32 kernel on
        # the original pool
        got = ops.paged_attention_quant(q, kq, ks, vq, vs, table, lengths)
        deq = ops.paged_attention(q, kq.float() * ks[..., None],
                                  vq.float() * vs[..., None], table, lengths)
        check_close(f"paged_attention_quant vs float32 kernel on the "
                    f"dequantized pool {tag}", got, deq, **F32_TOL)
        orig = ops.paged_attention(q, k, v, table, lengths)
        check_close(f"paged_attention_quant vs float32 kernel on the "
                    f"original pool {tag}", got, orig,
                    atol=QUANT_VS_F32, rtol=QUANT_VS_F32)
    # rows of length 0 give zeros, as the reference kernel's _fin
    zero = torch.zeros_like(lengths)
    if ops.paged_attention(q, k, v, table, zero).abs().max() != 0:
        raise AssertionError(f"length-0 rows are not zero ({tag})")
    if ops.paged_attention_quant(q, kq, ks, vq, vs, table,
                                 zero).abs().max() != 0:
        raise AssertionError(f"length-0 quant rows not zero ({tag})")


def paged_exact(label, q, calls, table, lengths) -> None:
    """Each kernel repeats bit for bit, and each row computed alone (B = 1,
    its table row and its length) equals the same row in the batch."""
    for name, call in calls.items():
        full = call(q, table, lengths)
        if not torch.equal(full, call(q, table, lengths)):
            raise AssertionError(f"{name} at {label}: two launches differ")
        for r in range(q.shape[0]):
            alone = call(q[r:r + 1], table[r:r + 1], lengths[r:r + 1])
            if not torch.equal(alone[0], full[r]):
                raise AssertionError(f"{name} at {label}: row {r} alone "
                                     "differs from the batch's row")
    say(f"  {label}: both kernels repeat bit for bit; every row alone equals "
        f"its row in the batch ({q.shape[0]} rows)")


def paged_fold_exact(q, k, v, table, lengths) -> None:
    """The multi-token fold's rows equal single-row calls at the same
    lengths, bit for bit, on both kernels."""
    b, hq, d = q.shape
    t_rows = 4
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    qm = torch.randn(b, t_rows, hq, d, generator=gen, device=DEVICE).to(q.dtype)
    positions = ((lengths.clamp(min=t_rows) - t_rows)[:, None]
                 + torch.arange(t_rows, device=DEVICE)[None]).to(torch.int32)
    kq, ks = ref.quantize_pages(k)
    vq, vs = ref.quantize_pages(v)
    folds = {
        "paged_attention": (
            pa.paged_attention_multitok(qm, k, v, table, positions),
            lambda x, t, ln: pa.paged_attention(x, k, v, t, ln)),
        "paged_attention_quant": (
            pa.paged_attention_quant_multitok(qm, kq, ks, vq, vs, table,
                                              positions),
            lambda x, t, ln: pa.paged_attention_quant(x, kq, ks, vq, vs, t, ln)),
    }
    for name, (fold, single) in folds.items():
        for i in range(b):
            for j in range(t_rows):
                one = single(qm[i, j][None].contiguous(), table[i:i + 1],
                             positions[i, j:j + 1] + 1)
                if not torch.equal(one[0], fold[i, j]):
                    raise AssertionError(f"{name}: fold row ({i}, {j}) differs "
                                         "from the single-row call")
    say(f"  the multi-token folds' {b * t_rows} rows equal single-row calls "
        "on both kernels")


def paged_times(key, label, gates, failures) -> dict:
    """Kernel, plain, SDPA and bound at one shape (bf16, one layer's pool
    per call out of 8, so each call finds L2 cold); the repeat and
    batch-independence checks there; the gates, collected in
    ``failures``."""
    b, hq, hkv, d, page, n_p, lens = PAGED_SHAPES[label]
    q, k, v, table, lengths = make_case(b, hq, hkv, d, page, n_p, lens,
                                        torch.bfloat16, layers=8)
    kq, ks = ref.quantize_pages(k)
    vq, vs = ref.quantize_pages(v)
    paged_exact(label, q, {
        "paged_attention": lambda x, t, ln: pa.paged_attention(
            x, k[0], v[0], t, ln),
        "paged_attention_quant": lambda x, t, ln: pa.paged_attention_quant(
            x, kq[0], ks[0], vq[0], vs[0], t, ln)}, table, lengths)
    if key == "serving":
        paged_fold_exact(q, k[0], v[0], table, lengths)
    layer = itertools.cycle(range(8))

    def plain_call(li, use_kernel=False):
        return ops.paged_attention(q, k[li], v[li], table, lengths,
                                   use_kernel=use_kernel)

    def quant_call(li, use_kernel=None):
        return ops.paged_attention_quant(q, kq[li], ks[li], vq[li], vs[li],
                                         table, lengths, use_kernel=use_kernel)

    timed = {
        "paged_attention": (
            lambda: plain_call(next(layer), use_kernel=None),
            lambda: plain_call(next(layer)),
            lambda: sdpa_ms(q, k, v, table, lengths),
            kernel_bound_ms(q, k[0], table, lengths)),
        "paged_attention_quant": (
            lambda: quant_call(next(layer)),
            lambda: quant_call(next(layer), use_kernel=False),
            lambda: sdpa_ms(q, kq.float() * ks[..., None],
                            vq.float() * vs[..., None], table, lengths),
            kernel_bound_ms(q, kq[0], table, lengths, quant=True)),
    }
    plan = pa.split_plan(b, hq, hkv, d, page, n_p, pa.split_tokens())
    say(f"  {label}: {plan.max_splits} spans per row at most, {plan.blocks} "
        f"blocks, {plan.cuda_launches} CUDA launch(es) per call planned")
    rec = {}
    for name, (kern, plain, lib, (bound, bound_by)) in timed.items():
        dev = device_time(kern, traces=5)
        ms = dev.ms
        eager = time_ms(kern)
        plain_ms = device_time(plain, reps=10).ms
        library_dev, library, library_eager = lib()
        library_ms = library_dev.ms
        rec[name] = {"ms": ms, "kernel_ms": ms, "eager_ms": eager,
                     "traces_ms": dev.traces_ms,
                     "cuda_launches_per_call": dev.launches,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "library": library, "library_eager_ms": library_eager,
                     "library_traces_ms": library_dev.traces_ms,
                     "shape": {"B": b, "Hq": hq, "Hkv": hkv, "D": d,
                               "page": page, "nP": n_p, "lengths": lens,
                               "dtype": "bfloat16"}}
        say(f"  {name} at {label}: kernel {ms:.5f} ms ({eager:.5f} eager; "
            f"{dev.launches:g} CUDA launches per call in its trace; traces "
            f"{', '.join(f'{x:.5f}' for x in dev.traces_ms)}), plain "
            f"{plain_ms:.5f} ms, {library} {library_ms:.5f} ms "
            f"({library_eager:.5f} eager), bound {bound:.5f} ms ({bound_by}; "
            f"kernel at {bound / ms:.1%} of it)")
        if dev.launches != plan.cuda_launches:
            failures.append(f"{name} at {label}: {dev.launches:g} CUDA "
                            f"launches per call traced, {plan.cuda_launches} "
                            "planned")
        limits = [("SDPA", library_ms)]
        if "max_ms" in gates:
            limits.append((f"{gates['max_ms']} ms", gates["max_ms"]))
        if "max_bound_x" in gates:
            limits.append((f"{gates['max_bound_x']}x its bound",
                           gates["max_bound_x"] * bound))
        for what, limit in limits:
            if ms > limit:
                failures.append(f"{name} at {label}: {ms:.5f} ms > {what} "
                                f"({limit:.5f} ms)")
    del q, k, v, kq, ks, vq, vs, timed
    release()
    return rec


def phase1() -> dict:
    say("== phase 1: kernels against their plain versions")
    errs = {"paged_attention": 0.0, "paged_attention_quant": 0.0}
    for label, shape in PAGED_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            paged_checks(label, shape, dtype, errs)
            release()
    torch.cuda.synchronize()
    ptxas = paged_ptxas()

    failures = []
    times = {key: paged_times(key, label, gates, failures)
             for key, (label, gates) in PAGED_TIMED.items()}
    rec = {}
    for name, replaces in (("paged_attention",
                            "src/repro/kernels/paged_attention.py:130"),
                           ("paged_attention_quant",
                            "src/repro/kernels/paged_attention.py:341")):
        rec[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": replaces, "launches": 0,
            "design": "split-sequence spans of "
                      f"{pa.split_tokens()} positions, in-order combine",
            "max_abs_err": errs[name], **times["serving"][name],
            "at_long_context": times["long_context"][name],
            "at_starcoder2": times["starcoder2"][name],
            "ptxas": ptxas,
        }
    if failures:
        raise AssertionError("paged kernel gates failed:\n  "
                             + "\n  ".join(failures))
    return rec


# ---------------------------------------------------------------------- #
# phases 2-5: serving
# ---------------------------------------------------------------------- #


def serve_arch():
    """The served model's config, as ``Serve.local`` builds it."""
    arch = get_config(SERVE["arch"])
    return arch if SERVE["full_size"] else arch.reduced()


def requests(vocab: int):
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, size=int(rng.integers(16, 65))).tolist()
            for _ in range(N_REQUESTS)]


def reset_launches() -> None:
    pa.paged_attention.launches = 0
    pa.paged_attention_quant.launches = 0


def release() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def serve(cfg: ServeConfig, prompts):
    """Serve ``prompts`` through ``Serve.local(cfg)``; returns the outputs,
    stats, wall seconds, the number of token iterations that ran the
    decode step (prefill chunks included) and the layer count."""
    torch.cuda.reset_peak_memory_stats()
    srv = Serve.local(cfg)
    sids = [srv.submit(p, max_new=MAX_NEW) for p in prompts]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = dict(srv.stats)
    outs = [srv.output(s) for s in sids]
    iters = (stats["prefill_calls"] * scheduler.PREFILL_BUCKET
             + stats["steps"] * (cfg.spec_k + 1))
    n_layers = srv.arch.n_layers
    srv.close()
    del srv
    release()
    return outs, stats, wall, iters, n_layers


def report_serve(tag, outs, stats, wall, iters, launches, n_layers):
    n_tok = sum(len(o) for o in outs)
    say(f"  {tag}: {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.2f} tok/s; "
        f"steps={stats['steps']} prefill_calls={stats['prefill_calls']} "
        f"parked={stats['parked']} resumed={stats['resumed']} "
        f"spec_proposed={stats['spec_proposed']} "
        f"spec_accepted={stats['spec_accepted']}")
    say(f"  {tag}: kernel launches {launches} = {n_layers} layers x {iters} "
        f"token iterations; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if launches <= 0 or launches != n_layers * iters:
        raise AssertionError(f"{tag}: {launches} kernel launches, want one per "
                             f"layer per token iteration ({n_layers * iters})")


def first_difference(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def top2_gap(arch, params, tokens) -> float:
    """The plain path's top-2 logit gap after consuming ``tokens``
    (contiguous float32 decode, plain attention)."""
    model = get_model(arch)
    cache = model.init_cache(arch, 1, SERVE["max_len"], device=DEVICE)
    with torch.inference_mode():
        for i, tok in enumerate(tokens):
            logits, cache = model.decode_step(
                params, cache, torch.tensor([tok], device=DEVICE), i, arch)
    top = logits[0].float().topk(2).values
    return float(top[0] - top[1])


def phase4(prompts) -> None:
    say("== phase 4: float32 compute, kernel path against plain path")
    arch = dataclasses.replace(serve_arch(), compute_dtype="float32")
    model = get_model(arch)
    params = model.init(SEED, arch, device=DEVICE)
    runs = {}
    plain_fn = ops.paged_attention
    for path in ("kernel", "plain"):
        if path == "plain":   # every attention call of the step: plain version
            ops.paged_attention = (lambda *a, **kw:
                                   plain_fn(*a, use_kernel=False, **kw))
        sched = scheduler.PagedServeScheduler(
            arch, model, params, slots=2, max_len=SERVE["max_len"],
            quantum=SERVE["quantum"], page_tokens=SERVE["page_tokens"])
        sids = [sched.submit(p, max_new=16) for p in prompts[:2]]
        reset_launches()
        sched.run()
        runs[path] = [sched.output(s) for s in sids]
        launches = pa.paged_attention.launches
        say(f"  {path} path: launches={launches} tokens={runs[path]}")
        if (launches > 0) != (path == "kernel"):
            raise AssertionError(f"the {path} path made {launches} launches")
        ops.paged_attention = plain_fn
        del sched
        release()
    for i, p in enumerate(prompts[:2]):
        j = first_difference(runs["kernel"][i], runs["plain"][i])
        if j is None:
            continue
        gap = top2_gap(arch, params, p + runs["plain"][i][:j])
        bound = F32_TOL["atol"] + F32_TOL["rtol"]
        if gap >= bound:
            raise AssertionError(f"request {i}: kernel and plain paths differ "
                                 f"at token {j} with top-2 gap {gap:.3e}")
        say(f"  request {i}: tie at token {j} (top-2 gap {gap:.3e} < {bound})")
    del params
    release()


# ---------------------------------------------------------------------- #
# phase 6: flash attention against its plain version
# ---------------------------------------------------------------------- #


def flash_inputs(b, tq, tk, hq, hkv, d, dtype, seed=SEED):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def mk(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

    return mk(b, tq, hq, d), mk(b, tk, hkv, d), mk(b, tk, hkv, d), mk(b, tq, hq, d)


def flash_grads(q, k, v, dout, use_kernel, causal=True):
    """(out, dq, dk, dv) through ops.flash_attention and autograd."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(q, k, v, causal=causal, use_kernel=use_kernel)
    return (out.detach(),) + torch.autograd.grad(out, (q, k, v), dout)


def flash_bound_ms(b, tq, tk, hq, hkv, d, elem, backward) -> tuple:
    """Least time for one call: q, k, v (and o, dO for the backward) read
    once, o or dq, dk, dv written once, plus the f32 log-sum-exp; against
    2 flops per multiply-add over the causal (query, key) pairs this run
    has (2 products forward, 5 backward) at the inputs' peak rate."""
    pairs = sum(min(tk, i + 1 + tk - tq) for i in range(tq))
    q_bytes, kv_bytes = b * tq * hq * d * elem, b * tk * hkv * d * elem
    lse = b * hq * tq * 4
    if backward:
        nbytes = 3 * q_bytes + 2 * kv_bytes + lse + q_bytes + 2 * kv_bytes
        flops = 5 * 2 * b * hq * pairs * d
    else:
        nbytes = q_bytes + 2 * kv_bytes + q_bytes + lse
        flops = 2 * 2 * b * hq * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_OPS["bfloat16" if elem == 2 else "float32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cuobjdump() -> str:
    """cuobjdump beside nvcc, or the copy in Triton's package."""
    path = Path(_build.nvcc()).parent / "cuobjdump"
    if not path.exists():
        import triton
        path = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
    if not path.exists():
        raise RuntimeError("cuobjdump not found beside nvcc or in triton")
    return str(path)


def flash_sass() -> dict:
    """Per bfloat16 flash kernel: registers and spills from the build's
    ``-Xptxas -v`` report, its dynamic shared memory, and the count of
    HGMMA (wgmma) and UTMALDG (TMA load) instructions in the library's SASS.
    Raises if a kernel has no HGMMA: the route would not be on the tensor
    cores."""
    name = re.compile(r"hopper\d+(fwd_kernel|dq_kernel|dkdv_kernel)ILi(\d+)E")
    log = _build.build_log.get("flash_attention")
    if log is None:
        raise AssertionError("no ptxas report: flash_attention.cu was not built "
                             "by this run (delete build/repro_torch_kernels)")
    report, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = name.search(line)
            cur = f"{m[1]}<{m[2]}>" if m else None
            if cur:
                report[cur] = {"HGMMA": 0, "UTMALDG": 0}
        elif cur and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill", line)
            report[cur].update(spill_stores=int(stores), spill_loads=int(loads))
        elif cur and "registers" in line:
            report[cur]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
    sass = subprocess.run([cuobjdump(), "-sass",
                           str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    cur = None
    for line in sass.splitlines():
        if "Function :" in line:
            m = name.search(line)
            cur = f"{m[1]}<{m[2]}>" if m else None
        elif cur:
            report[cur]["HGMMA"] += " HGMMA." in line
            report[cur]["UTMALDG"] += " UTMALDG." in line
    lib = _build.library("flash_attention")
    for key, entry in report.items():
        kind, d = key[:-1].split("<")
        entry["dynamic_smem_bytes"] = lib.repro_flash_bf16_smem(
            ("fwd_kernel", "dq_kernel", "dkdv_kernel").index(kind), int(d))
        say(f"  {key}: {entry['registers']} registers, spill stores "
            f"{entry['spill_stores']} B / loads {entry['spill_loads']} B, "
            f"{entry['dynamic_smem_bytes']} B dynamic shared memory; SASS "
            f"HGMMA {entry['HGMMA']}, UTMALDG {entry['UTMALDG']}")
    want = {f"{k}<{d}>" for k in ("fwd_kernel", "dq_kernel", "dkdv_kernel")
            for d in fa.BF16_HEAD_DIMS}
    if set(report) != want:
        raise AssertionError(f"bf16 flash kernels in the build: {sorted(report)}, "
                             f"want {sorted(want)}")
    if not all(e["HGMMA"] for e in report.values()):
        raise AssertionError("a bf16 flash kernel has no HGMMA instruction")
    return report


def phase6() -> dict:
    say("== phase 6: flash attention, forward and backward, against the "
        "plain version")
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = {   # the first is the training shape of phase 8
        f"phi3 B={TRAIN['batch']} T={TRAIN['seq']}": (
            TRAIN["batch"], TRAIN["seq"], TRAIN["seq"], 32, 32, 96),
        "phi3 T=200": (2, 200, 200, 32, 32, 96),
        "phi3 Tq=100 < Tk=300": (2, 100, 300, 32, 32, 96),
        "starcoder2-7b T=512": (1, 512, 512, 36, 4, 128),
        "starcoder2-7b T=200": (2, 200, 200, 36, 4, 128),
        # zamba2's shared block: D 80 runs the float32 kernels' col < d
        # branch and the bf16 kernels' zero-filled second 64-column box
        "zamba2-2.7b B=4 T=512 (Hq=Hkv=32, D=80)": (4, 512, 512, 32, 32, 80),
        "zamba2-2.7b T=200": (2, 200, 200, 32, 32, 80),
        # whisper's head dim, the bf16 route's fourth instantiation
        "D=64 T=200": (2, 200, 200, 8, 8, 64),
        # non-causal Tq > Tk (whisper's cross-attention: more decoder rows
        # than encoder frames)
        "non-causal Tq=64 > Tk=32": (2, 64, 32, 8, 8, 64),
    }
    non_causal = {"non-causal Tq=64 > Tk=32"}
    say("  bf16 route (wgmma + TMA) build report:")
    sass = flash_sass()
    errs = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0}
    for label, shape in shapes.items():
        for dtype in (f32, bf16):
            tol = FLASH_F32_TOL if dtype == f32 else FLASH_BF16_TOL
            bwd_tol = FLASH_BWD_F32_TOL if dtype == f32 else FLASH_BF16_TOL
            tag = f"{label} {str(dtype)[6:]}"
            causal = label not in non_causal
            q, k, v, dout = flash_inputs(*shape, dtype)
            got = flash_grads(q, k, v, dout, None, causal)
            want = flash_grads(q, k, v, dout, False, causal)
            errs["flash_attention_fwd"] = max(
                errs["flash_attention_fwd"],
                check_close(f"flash fwd {tag}", got[0], want[0], **tol))
            for name, g, w in zip(("dQ", "dK", "dV"), got[1:], want[1:]):
                errs["flash_attention_bwd"] = max(
                    errs["flash_attention_bwd"],
                    check_close(f"flash bwd {name} {tag}", g, w, **bwd_tol))
            if dtype == f32:
                exact = flash_grads(q.double(), k.double(), v.double(),
                                    dout.double(), False, causal)
                dist = lambda xs: max((x.double() - e).abs().max().item()
                                      for x, e in zip(xs, exact[1:]))
                kern_d, plain_d = dist(got[1:]), dist(want[1:])
                say(f"    distance to float64, dQ/dK/dV: kernel {kern_d:.3e}, "
                    f"plain {plain_d:.3e} (limit max(plain, {FLASH_F64_ATOL}))")
                if kern_d > max(plain_d, FLASH_F64_ATOL):
                    raise AssertionError(f"flash bwd {tag}: the kernel lies "
                                         f"{kern_d:.3e} from float64")
                del exact
    torch.cuda.synchronize()
    q, k, v, _ = flash_inputs(1, 64, 32, 4, 4, 96, bf16)
    for what, call in (("prefix_len=4", lambda: ops.flash_attention(
                            q[:, :32], k, v, prefix_len=4)),
                       ("causal Tq=64 > Tk=32",
                        lambda: ops.flash_attention(q, k, v))):
        try:
            call()
        except ValueError as e:
            say(f"  kernel path refuses {what}: {e}")
        else:
            raise AssertionError(f"the flash kernel path accepted {what}")

    # the bf16 route repeats bit for bit at phi3's training shape
    q, k, v, dout = flash_inputs(*shapes[next(iter(shapes))], bf16)
    fwd = [fa.flash_attention_fwd(q, k, v) for _ in range(2)]
    bwd = [fa.flash_attention_bwd(q, k, v, *fwd[0], dout) for _ in range(2)]
    same = {n: torch.equal(a, b) for n, a, b in zip(
        ("out", "lse", "dq", "dk", "dv"), fwd[0] + bwd[0], fwd[1] + bwd[1])}
    say(f"  bf16 repeats bit-identical at phi3's training shape: {same}")
    if not all(same.values()):
        raise AssertionError(f"the bf16 flash kernels did not repeat: {same}")
    del q, k, v, dout, fwd, bwd

    # times at the two training shapes, bf16: phi3's (phase 8) and zamba2's
    # shared block (phase 12, D 80); the first fills the entry's keys.  The
    # yardstick is SDPA pinned to its flash backend, forward and backward.
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    flash_backend = functools.partial(sdpa_kernel, SDPBackend.FLASH_ATTENTION)
    b, t = TRAIN["batch"], TRAIN["seq"]
    rec = {}
    for label, h, d in (("phi3", 32, 96), ("zamba2-2.7b shared block", 32, 80)):
        q, k, v, dout = flash_inputs(b, t, t, h, h, d, bf16)
        out, lse = fa.flash_attention_fwd(q, k, v)
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        plain_out = ref.flash_attention(qr, kr, vr)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        with flash_backend():
            sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dout_t = dout.transpose(1, 2)
        timed = {
            "flash_attention_fwd": (
                lambda: fa.flash_attention_fwd(q, k, v),
                lambda: ref.flash_attention(q, k, v),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True),
                flash_bound_ms(b, t, t, h, h, d, 2, backward=False)),
            "flash_attention_bwd": (
                lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout),
                lambda: torch.autograd.grad(plain_out, (qr, kr, vr), dout,
                                            retain_graph=True),
                lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t,
                                            retain_graph=True),
                flash_bound_ms(b, t, t, h, h, d, 2, backward=True)),
        }
        for name, (kern, plain, lib, (bound, bound_by)) in timed.items():
            ms = time_ms(kern, iters=50)
            plain_ms = time_ms(plain, iters=10, warmup=2)
            with flash_backend():
                library_ms = time_ms(lib, iters=50)
            times = {"ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": bound_by,
                     "library_ms": library_ms, "library": "sdpa/flash",
                     "shape": {"B": b, "T": t, "Hq": h, "Hkv": h, "D": d,
                               "dtype": "bfloat16", "causal": True}}
            if name not in rec:
                rec[name] = {
                    "name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention.py:123",
                    "design": "wgmma+tma",
                    "launches": 0, "max_abs_err": errs[name], **times}
            else:
                rec[name]["at_head_dim_80"] = times
            say(f"  {name} at {label}'s training shape (D {d}): kernel "
                f"{ms:.5f} ms, plain {plain_ms:.5f} ms, sdpa/flash "
                f"{library_ms:.5f} ms, bound {bound:.5f} ms ({bound_by})")
        del q, k, v, dout, out, lse, qr, kr, vr, plain_out, qt, kt, vt
        del sdpa_out, dout_t, timed
        release()
    rec["flash_attention_bwd"]["note"] = (
        "the reference has no backward kernel: JAX differentiates "
        "layers.flash_attention, whose TPU kernel the forward replaces; "
        "one backward pass is 3 launches (delta, dQ, dK/dV), each counted, "
        "and ms is the time of one pass")
    kinds = {"flash_attention_fwd": ("fwd_kernel",),
             "flash_attention_bwd": ("dq_kernel", "dkdv_kernel")}
    for name, names in kinds.items():
        rec[name]["sass"] = {k: v for k, v in sass.items()
                             if k.split("<")[0] in names}
    return rec


# ---------------------------------------------------------------------- #
# phase 10: the WKV6 and SSD scan kernels against their plain versions
# ---------------------------------------------------------------------- #


def scan_inputs(kind, shape, dtype, nonzero_state, seed=SEED):
    """Inputs of one scan as the models feed it, made on the card from a
    seed: for ``"wkv6"`` (r, k, v, w, u, state) with w = exp(-exp(.))
    under the model's clip (so w spans e^-e .. 1), for ``"ssd"`` (x, dt,
    A, Bm, Cm, state) with dt a softplus and A = -exp(U[0, 1)); r, k, v,
    u (x, Bm, Cm) in ``dtype``, the rest float32; then dy."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def mk(*dims, scale=1.0):
        return torch.randn(*dims, generator=gen, device=DEVICE) * scale

    if kind == "wkv6":
        b, t, h, d = shape
        ins = (mk(b, t, h, d, scale=0.5).to(dtype),
               mk(b, t, h, d, scale=0.5).to(dtype), mk(b, t, h, d).to(dtype),
               torch.exp(-torch.exp(mk(b, t, h, d, scale=2.0).clamp(-8.0, 1.0))),
               mk(h, d, scale=0.1).to(dtype),
               mk(b, h, d, d, scale=0.5) if nonzero_state else None)
        return ins, mk(b, t, h, d).to(dtype)
    b, t, h, p, n = shape
    ins = (mk(b, t, h, p).to(dtype),
           torch.nn.functional.softplus(mk(b, t, h)),
           -torch.exp(torch.rand(h, generator=gen, device=DEVICE)),
           mk(b, t, n, scale=0.5).to(dtype), mk(b, t, n, scale=0.5).to(dtype),
           mk(b, h, p, n, scale=0.5) if nonzero_state else None)
    return ins, mk(b, t, h, p).to(dtype)


def scan_call(kind, ins, use_kernel):
    fn = ops.wkv6 if kind == "wkv6" else ops.mamba2_ssd
    return fn(*ins, use_kernel=use_kernel)


def scan_grads(kind, ins, dy, use_kernel):
    """(y, final state, grads of every input that is given) through
    ``ops`` and autograd."""
    leaves = [x.detach().requires_grad_() if x is not None else None
              for x in ins]
    y, s = scan_call(kind, leaves, use_kernel)
    wrt = [x for x in leaves if x is not None]
    return (y.detach(), s.detach()) + torch.autograd.grad(y, wrt, dy)


def scan_bound_ms(kind, shape, elem, backward) -> tuple:
    """Least time for one call as the training step makes it (no initial
    state): every input read once and every output written once, over HBM
    bandwidth -- the forward writes y and the final state, the backward
    reads the inputs and dy and writes their gradients (no state-shaped
    tensor: there is no initial state to differentiate, and the saved
    chunk states are the kernel's choice, not the function's); against the
    multiply-adds of the recurrence (5 flops per state element and token
    forward, 14 backward: the states, G, and the four gradient
    contractions) at the inputs' peak rate."""
    if kind == "wkv6":
        b, t, h, d = shape
        act = b * t * h * d
        state = b * h * d * d * 4
        fwd_bytes = 3 * act * elem + act * 4 + h * d * 4 + act * elem + state
        bwd_bytes = (3 * act * elem + act * 4 + h * d * 4 + act * elem
                     + 3 * act * elem + act * 4 + h * d * 4)
        cells = b * t * h * d * d
    else:
        b, t, h, p, n = shape
        act = b * t * h * p
        bc = 2 * b * t * n * elem
        state = b * h * p * n * 4
        fwd_bytes = act * elem + b * t * h * 4 + h * 4 + bc + act * elem + state
        bwd_bytes = (act * elem + b * t * h * 4 + h * 4 + bc + act * elem
                     + act * elem + b * t * h * 4 + h * 4 + bc)
        cells = b * t * h * p * n
    nbytes = bwd_bytes if backward else fwd_bytes
    flops = (14 if backward else 5) * cells
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_OPS["bfloat16" if elem == 2 else "float32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_head_rms(name, got, want, head_dim):
    """Raise unless |got - want| <= SCAN_TIGHT_REL (|want| + the rms of want
    over its (batch row, head)); return the largest error over that rms."""
    g = got.float().movedim(head_dim, 1)
    w = want.float().movedim(head_dim, 1)
    g, w = g.reshape(*w.shape[:2], -1), w.reshape(*w.shape[:2], -1)
    rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    err = (g - w).abs()
    over = (err - SCAN_TIGHT_REL * (w.abs() + rms)).max().item()
    worst = (err / rms.clamp(min=1e-30)).max().item()
    say(f"  {name}: max_abs_err / head rms = {worst:.3e} (limit {SCAN_TIGHT_REL} "
        f"of a value + {SCAN_TIGHT_REL} x head rms)")
    if not torch.isfinite(got).all() or over > 0:
        raise AssertionError(f"{name}: the bf16 kernel is farther than "
                             f"{SCAN_TIGHT_REL} from the float32 plain version")
    return worst


SCAN_GRAD_NAMES = {"wkv6": ("dr", "dk", "dv", "dw", "du", "dstate"),
                   "ssd": ("dx", "ddt", "dA", "dB", "dC", "dstate")}


def scan_tight(kind, tag, ins, dy, got) -> None:
    """A bf16 scan kernel's results against the plain version run on the
    same inputs (and dy) cast to float32."""
    ins32 = [None if x is None else x.float() for x in ins]
    want = scan_grads(kind, ins32, dy.float(), False)
    check_head_rms(f"{kind} y {tag} vs float32 plain", got[0], want[0], 2)
    check_head_rms(f"{kind} final state {tag} vs float32 plain", got[1],
                   want[1], 1)
    for name, g, w in zip(SCAN_GRAD_NAMES[kind], got[2:], want[2:]):
        check_scaled(f"{kind} {name} {tag} vs float32 plain", g, w,
                     SCAN_TIGHT_REL)


def below_clip(dtype) -> float:
    """The WKV6 kernels where every other channel's decay is drawn as
    e^{-46 U}, U uniform in [0, 1) (down to 1e-20, far below the model's
    clip e^-e), against the sequential oracle ``ref.rwkv6_ref`` and its
    autograd (the chunked plain version exponentiates before its mask and
    overflows there): outputs at the scans' tolerance, gradients relative
    to their largest magnitude, dw as w * dw (the gradient in log w: dw's
    own rounding grows as 1/w); returns the largest gradient error."""
    (r, k, v, w, u, s0), dy = scan_inputs("wkv6", BELOW_CLIP_SHAPE, dtype, True)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    tiny = torch.exp(-46.0 * torch.rand(BELOW_CLIP_SHAPE, generator=gen,
                                        device=DEVICE))
    w = w.clone()
    w[..., ::2] = tiny[..., ::2]
    ins = (r, k, v, w, u, s0)
    got = scan_grads("wkv6", ins, dy, None)
    leaves = [x.detach().float().requires_grad_() for x in ins]
    y, s = ref.rwkv6_ref(*leaves)
    want = (y.detach(), s.detach()) + torch.autograd.grad(y, leaves, dy.float())
    tag = f"below the clip (w >= {w.min().item():.1e}) {str(dtype)[6:]}"
    tol = SCAN_F32_TOL if dtype == torch.float32 else SCAN_BF16_TOL
    rel = SCAN_BWD_F32_REL if dtype == torch.float32 else SCAN_BF16_TOL["rtol"]
    check_close(f"wkv6 y {tag} vs sequential", got[0], want[0], **tol)
    check_close(f"wkv6 final state {tag} vs sequential", got[1], want[1], **tol)
    worst = 0.0
    for name, g, wg in zip(SCAN_GRAD_NAMES["wkv6"], got[2:], want[2:]):
        if name == "dw":
            name, g, wg = "w*dw", g * w, wg * w
        worst = max(worst, check_scaled(f"wkv6 {name} {tag} vs sequential",
                                        g, wg, rel))
    return worst


def scan_ptxas(name: str) -> dict:
    """Registers and spills of a scan source's kernels, from this run's
    build."""
    log = _build.build_log.get(name)
    if log is None:
        raise AssertionError(f"no ptxas report: {name}.cu was not built by "
                             "this run (delete build/repro_torch_kernels)")
    report = ptxas_report(log)
    for key, entry in report.items():
        say(f"  ptxas {key}: {entry.get('registers')} registers, spill stores "
            f"{entry.get('spill_stores')} B / loads {entry.get('spill_loads')} B")
    return report


def scan_traces() -> dict:
    """The scan kernels' device time and CUDA launches per call at
    zamba2-2.7b's and rwkv6-3b's training shapes (bf16, as the training
    step calls them), from ``torch.profiler`` traces."""
    shape = next(iter(SCAN_CASES["ssd"].values()))
    (x, dt, A, Bm, Cm, _), dy = scan_inputs("ssd", shape, torch.bfloat16, False)
    _, _, ckpt = ssd.ssd_fwd(x, dt, A, Bm, Cm, save=True)
    calls = {"mamba2_ssd_fwd": lambda: ssd.ssd_fwd(x, dt, A, Bm, Cm, save=True),
             "mamba2_ssd_bwd": lambda: ssd.ssd_bwd(x, dt, A, Bm, Cm, ckpt, dy)}
    out = {name: device_time(fn, reps=20, traces=3)._asdict()
           for name, fn in calls.items()}
    shape = next(iter(SCAN_CASES["wkv6"].values()))
    (r, k, v, w, u, _), dy = scan_inputs("wkv6", shape, torch.bfloat16, False)
    uf = u.float()
    _, _, ckpt = wkv.wkv6_fwd(r, k, v, w, uf, save=True)
    calls = {"wkv6_fwd": lambda: wkv.wkv6_fwd(r, k, v, w, uf, save=True),
             "wkv6_bwd": lambda: wkv.wkv6_bwd(r, k, v, w, uf, ckpt, dy)}
    out.update({name: device_time(fn, reps=20, traces=3)._asdict()
                for name, fn in calls.items()})
    return out


def scan_traces_fresh() -> dict:
    """:func:`scan_traces` in a child process of this script: after the
    training phases the profiler of this process has come back with no
    device records at all."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--scan-traces"], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    if out.returncode:
        raise AssertionError(f"the scan trace process failed:\n{out.stdout}"
                             f"\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase10() -> dict:
    say("== phase 10: the WKV6 and SSD scan kernels, forward and backward, "
        "against their plain versions")
    f32, bf16 = torch.float32, torch.bfloat16
    cases = SCAN_CASES
    names = SCAN_GRAD_NAMES
    errs = {}
    for kind, shapes in cases.items():
        fwd_err = bwd_err = 0.0
        for label, shape in shapes.items():
            for dtype, nonzero in itertools.product((f32, bf16), (False, True)):
                tag = (f"{label} {str(dtype)[6:]} "
                       f"{'non-zero' if nonzero else 'zero'} initial state")
                ins, dy = scan_inputs(kind, shape, dtype, nonzero)
                got = scan_grads(kind, ins, dy, None)
                want = scan_grads(kind, ins, dy, False)
                tol = SCAN_F32_TOL if dtype == f32 else SCAN_BF16_TOL
                fwd_err = max(fwd_err, check_close(f"{kind} y {tag}", got[0],
                                                   want[0], **tol))
                fwd_err = max(fwd_err, check_close(
                    f"{kind} final state {tag}", got[1], want[1], **tol))
                rel = SCAN_BWD_F32_REL if dtype == f32 else SCAN_BF16_TOL["rtol"]
                gnames = names[kind][:len(got) - 2]
                for name, g, w in zip(gnames, got[2:], want[2:]):
                    bwd_err = max(bwd_err, check_scaled(
                        f"{kind} {name} {tag}", g, w, rel))
                again = scan_grads(kind, ins, dy, None)
                if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                    raise AssertionError(f"{kind} {tag}: a repeated run gave "
                                         "other bits")
                if dtype == bf16:
                    scan_tight(kind, tag, ins, dy, got)
                if dtype == f32:
                    exact = scan_grads(kind, [None if x is None else x.double()
                                              for x in ins], dy.double(), False)
                    for name, g, w, e in zip(gnames, got[2:], want[2:],
                                             exact[2:]):
                        # (a gradient that is 0 everywhere, as dw at T 1
                        # from a zero state, compares at scale 1e-30)
                        scale = max(e.abs().max().item(), 1e-30)
                        kd = (g.double() - e).abs().max().item() / scale
                        pd = (w.double() - e).abs().max().item() / scale
                        say(f"    {name} distance to float64 (relative to "
                            f"max |{name}| {scale:.3e}): kernel {kd:.3e}, plain "
                            f"{pd:.3e} (limit max(plain, {SCAN_F64_REL}))")
                        if not kd <= max(pd, SCAN_F64_REL):   # NaN fails
                            raise AssertionError(f"{kind} {name} {tag}: the "
                                                 f"kernel lies {kd:.3e} from "
                                                 "float64")
                    del exact
                del got, want, again
        if kind == "wkv6":
            for dtype in (f32, bf16):
                bwd_err = max(bwd_err, below_clip(dtype))
        errs[kind] = (fwd_err, bwd_err)
        say(f"  {kind}: a repeated forward and backward gave the same bits "
            "at every case")
    torch.cuda.synchronize()
    release()

    say("  SSD kernels' build report (P and N padded to 64: one "
        "instantiation per dtype):")
    regs = {"ssd": scan_ptxas("mamba2_ssd")}
    say("  WKV6 kernels' build report (heads padded to 64: one instantiation "
        "per dtype):")
    regs["wkv6"] = scan_ptxas("wkv6")
    lib = _build.library("wkv6")
    occupancy = {"fwd": lib.repro_wkv6_blocks_per_sm(0),
                 "bwd_state_part": lib.repro_wkv6_blocks_per_sm(1),
                 "bwd_chunk": lib.repro_wkv6_blocks_per_sm(2)}
    say(f"  WKV6 bf16 blocks per SM (occupancy): forward {occupancy['fwd']}, "
        f"backward dG kernel {occupancy['bwd_state_part']}, chunk kernel "
        f"{occupancy['bwd_chunk']}")

    # times at the training shapes, bf16, as the training step calls them
    rec = {}
    failures = []
    traces = scan_traces_fresh()
    for kind, shapes in cases.items():
        label, shape = next(iter(shapes.items()))
        ins, dy = scan_inputs(kind, shape, bf16, False)
        if kind == "wkv6":
            r, k, v, w, u, _ = ins
            uf = u.float()
            fwd = lambda: wkv.wkv6_fwd(r, k, v, w, uf, save=True)
            _, _, ckpt = fwd()
            bwd = lambda: wkv.wkv6_bwd(r, k, v, w, uf, ckpt, dy)
            names_ = ("wkv6_fwd", "wkv6_bwd")
            src, replaces = ("src/repro_torch/kernels/csrc/wkv6.cu",
                             "src/repro/kernels/rwkv6_scan.py:110")
        else:
            x, dt, A, Bm, Cm, _ = ins
            fwd = lambda: ssd.ssd_fwd(x, dt, A, Bm, Cm, save=True)
            _, _, ckpt = fwd()
            bwd = lambda: ssd.ssd_bwd(x, dt, A, Bm, Cm, ckpt, dy)
            names_ = ("mamba2_ssd_fwd", "mamba2_ssd_bwd")
            src, replaces = ("src/repro_torch/kernels/csrc/mamba2_ssd.cu",
                             "src/repro/kernels/mamba2_ssd.py:101")
        leaves = [x.detach().requires_grad_() if x is not None else None
                  for x in ins]
        plain_y, _ = scan_call(kind, leaves, False)
        wrt = [x for x in leaves if x is not None]
        plain_fwd = lambda: scan_call(kind, ins, False)
        plain_bwd = lambda: torch.autograd.grad(plain_y, wrt, dy,
                                                retain_graph=True)
        for name, kern, plain, backward in (
                (names_[0], fwd, plain_fwd, False),
                (names_[1], bwd, plain_bwd, True)):
            with torch.no_grad() if not backward else contextlib.nullcontext():
                ms = time_ms(kern, iters=20, warmup=3)
                plain_ms = time_ms(plain, iters=5, warmup=1)
            bound, bound_by = scan_bound_ms(kind, shape, 2, backward)
            rec[name] = {
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": 0,
                "max_abs_err": errs[kind][1 if backward else 0], "ms": ms,
                "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": None,
                "shape": dict(zip(("B", "T", "H", "D") if kind == "wkv6" else
                                  ("B", "T", "H", "P", "N"), shape),
                              dtype="bfloat16"),
            }
            say(f"  {name} at the training shape ({label}): kernel {ms:.5f} "
                f"ms, plain {plain_ms:.5f} ms, bound {bound:.5f} ms "
                f"({bound_by}); no single PyTorch call computes it")
            # CUDA launches per wrapper call, from a device trace
            dev = DeviceTime(**traces[name])
            mod = wkv if kind == "wkv6" else ssd
            planned = mod.CUDA_LAUNCHES["bwd" if backward else "fwd"]
            say(f"    device time {dev.ms:.5f} ms (traces "
                f"{[round(v, 5) for v in dev.traces_ms]}, a fresh process); "
                f"CUDA launches per call {dev.launches:g}, planned {planned}")
            if dev.launches != planned:
                failures.append(f"{name}: {dev.launches:g} CUDA launches per "
                                f"call, the wrapper plans {planned}")
            gates, goals = ((WKV6_GATE_MS, WKV6_GOAL_MS) if kind == "wkv6"
                            else (SSD_GATE_MS, SSD_GOAL_MS))
            gate, goal = gates[name], goals[name]
            say(f"    gate <= {gate} ms: {'held' if ms <= gate else 'MISSED'}"
                f"; goal <= {goal} ms (reported): "
                f"{'met' if ms <= goal else 'not met'}")
            if not ms <= gate:
                failures.append(f"{name}: {ms:.5f} ms over its {gate} ms gate")
            rec[name].update(
                device_ms=dev.ms, cuda_launches_per_call=dev.launches,
                gate_ms=gate, goal_ms=goal, design="chunked mma.sync",
                ptxas={k: v for k, v in regs[kind].items()
                       if ("bwd" if backward else "fwd") in k
                       or (backward and "finish" in k)})
            if kind == "wkv6":
                rec[name]["blocks_per_sm"] = (
                    {k: occupancy[k] for k in ("bwd_state_part", "bwd_chunk")}
                    if backward else occupancy["fwd"])
                rec[name]["plan"] = wkv.plan(*shape)
        rec[names_[1]]["note"] = (
            "the reference has no backward kernel: JAX differentiates the "
            "chunked jnp version, whose TPU kernel the forward replaces; "
            "max_abs_err of a backward is relative to each gradient's largest "
            "magnitude")
        del ins, dy, ckpt, plain_y, leaves, wrt
        release()
    if failures:
        raise AssertionError("; ".join(failures))
    return rec


# ---------------------------------------------------------------------- #
# phase 7: the XOR kernel against its plain version
# ---------------------------------------------------------------------- #


def phase7() -> None:
    say("== phase 7: XOR reduce against the plain version")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for r in (2, 4, 8):
        m = 1000 + 37 * r            # not a multiple of any block size
        x = torch.randint(-2**31, 2**31 - 1, (r, m, 128), generator=gen,
                          dtype=torch.int32, device=DEVICE)
        got = ops.xor_reduce(x)
        want = ops.xor_reduce(x, use_kernel=False)
        if not torch.equal(got, want):
            raise AssertionError(f"XOR kernel differs from its plain version "
                                 f"at R={r}, M={m}")
        say(f"  xor_reduce R={r} M={m}: byte-exact")


# ---------------------------------------------------------------------- #
# phases 8-9: train, survive a node kill, NAM_XOR parity
# ---------------------------------------------------------------------- #


def train_arch(layers: int):
    return dataclasses.replace(get_config(TRAIN["arch"]), n_layers=layers)


def dir_bytes(root: Path) -> int:
    return sum(p.stat().st_size for p in root.rglob("*") if p.is_file())


def train_run(cfg, root: Path, failures, keep_state=False):
    """``examples/quickstart.py``'s loop on the card; returns the report,
    the final checkpoint's manifest, bytes on disk and (optionally) the
    final state restored to host tensors."""
    cluster = VirtualCluster(n_cluster=4, n_booster=4, root=root)
    scr = SCRManager(cluster, TierStack.for_cluster(cluster),
                     strategy=Strategy.BUDDY, procs_per_node=2,
                     async_drain=True)
    pipeline = TokenPipeline(cfg.vocab_size, global_batch=TRAIN["batch"],
                             seq_len=TRAIN["seq"], seed=SEED)
    state = None
    with ResilienceSession(scr, policy=IntervalPolicy(TRAIN["ckpt_every"])
                           ) as session:
        trainer = Trainer(cfg, get_model(cfg), pipeline, session,
                          opt_cfg=AdamWConfig(lr=TRAIN["lr"],
                                              warmup_steps=TRAIN["warmup"]),
                          failure_schedule=failures, seed=SEED, device=DEVICE)
        report = trainer.run(total_steps=TRAIN["steps"])
        manifest = scr._descriptor(TRAIN["steps"])["manifest"]
        on_disk = dir_bytes(root)
        if keep_state:
            template = init_train_state(SEED, cfg, trainer.model, DEVICE)
            t0 = time.perf_counter()
            state, _ = session.restore_latest(template)
            report.restore_wall_s.append(time.perf_counter() - t0)
            del template
    cluster.teardown()
    return report, manifest, on_disk, state


def report_train(tag, report, manifest, on_disk):
    steps = sorted(report.step_wall_s[1:])
    say(f"  {tag}: steps_run={report.steps_run} failures={report.failures} "
        f"recoveries={report.recoveries} restarts_from={report.restarts_from_step}")
    say(f"  {tag}: loss {report.losses[0]:.4f} -> {report.losses[-1]:.4f}; "
        f"step median {1e3 * steps[len(steps) // 2]:.1f} ms (first step "
        f"{1e3 * report.step_wall_s[0]:.1f} ms)")
    say(f"  {tag}: {report.checkpoints} checkpoints of "
        f"{manifest['total_bytes']} state bytes, commit wall s "
        f"{[round(x, 3) for x in report.checkpoint_wall_s]}, final drain "
        f"barrier {report.drain_wait_s:.3f} s, drains completed "
        f"{report.drains_completed}, restore wall s "
        f"{[round(x, 3) for x in report.restore_wall_s]}, {on_disk} bytes "
        f"on disk at the end")


def phase8() -> tuple:
    say("== phase 8: train phi3-mini-3.8b and survive a node kill")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    free = shutil.disk_usage(tmp).free
    layers = TRAIN["layers"] if free >= TRAIN_DISK_2L else 1
    cfg = train_arch(layers)
    say(f"  free disk under {tmp.parent}: {free} bytes; phi3-mini-3.8b at "
        f"published width (d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
        f"depth cut 32 -> {layers} layers; B {TRAIN['batch']} x T "
        f"{TRAIN['seq']}, {TRAIN['steps']} steps, BUDDY async drain, "
        f"IntervalPolicy({TRAIN['ckpt_every']}), node {TRAIN['fail_rank']} "
        f"killed at step {TRAIN['fail_step']}")
    torch.use_deterministic_algorithms(True)
    say(f"  deterministic algorithms on, CUBLAS_WORKSPACE_CONFIG="
        f"{os.environ['CUBLAS_WORKSPACE_CONFIG']}, TF32 off")
    try:
        clean, clean_manifest, disk, state = train_run(
            cfg, tmp / "clean", None, keep_state=True)
        report_train("uninterrupted", clean, clean_manifest, disk)
        release()

        # the main path: counts from zero, plain and library attention
        # wrapped to count any call
        calls = {"plain": 0, "sdpa": 0}
        plain_fn = ref.flash_attention
        sdpa_fn = torch.nn.functional.scaled_dot_product_attention

        def counted(name, fn):
            def wrapper(*a, **kw):
                calls[name] += 1
                return fn(*a, **kw)
            return wrapper

        ref.flash_attention = counted("plain", plain_fn)
        torch.nn.functional.scaled_dot_product_attention = counted("sdpa", sdpa_fn)
        fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        try:
            faulty, manifest, disk, _ = train_run(
                cfg, tmp / "faulty",
                [FailureEvent(step=TRAIN["fail_step"], rank=TRAIN["fail_rank"])])
        finally:
            ref.flash_attention = plain_fn
            torch.nn.functional.scaled_dot_product_attention = sdpa_fn
        fwd, bwd = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
        peak = torch.cuda.max_memory_allocated()
        report_train("node kill", faulty, manifest, disk)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"  node kill: flash launches forward {fwd}, backward {bwd} over "
        f"{faulty.steps_run} steps x {layers} layers; plain attention calls "
        f"{calls['plain']}, sdpa calls {calls['sdpa']}; peak device memory "
        f"{peak / 2**30:.3f} GiB")
    if faulty.recoveries != 1 or faulty.restarts_from_step != [TRAIN["ckpt_every"]]:
        raise AssertionError(f"want one recovery from step {TRAIN['ckpt_every']}, "
                             f"got {faulty.recoveries} from "
                             f"{faulty.restarts_from_step}")
    if not faulty.losses[-1] < faulty.losses[0]:
        raise AssertionError("the loss did not fall")
    if (fwd != 2 * layers * faulty.steps_run
            or bwd != 3 * layers * faulty.steps_run):
        raise AssertionError(f"flash launches fwd {fwd}, bwd {bwd}: want "
                             f"{2 * layers} forward (remat) and {3 * layers} "
                             f"backward (one pass of 3 per layer) per step")
    if calls["plain"] or calls["sdpa"]:
        raise AssertionError(f"the training path called plain or library "
                             f"attention: {calls}")
    if (manifest["sha256"], manifest["total_bytes"]) != (
            clean_manifest["sha256"], clean_manifest["total_bytes"]):
        raise AssertionError("the recovered run's final state differs from "
                             "the uninterrupted run's")
    say(f"  final state byte-identical to the uninterrupted run: sha256 "
        f"{manifest['sha256'][:16]}.. over {manifest['total_bytes']} bytes")
    main_path = {"arch": TRAIN["arch"], "layers": layers,
                 "layers_published": get_config(TRAIN["arch"]).n_layers,
                 "batch": TRAIN["batch"], "seq": TRAIN["seq"],
                 "steps_run": faulty.steps_run}
    return state, cfg, {"fwd": fwd, "bwd": bwd, "main_path": main_path}


def phase9(state) -> dict:
    say("== phase 9: NAM_XOR checkpoint of the phase-8 state, node kill, "
        "parity through the XOR kernel")
    step = TRAIN["steps"]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_nam_"))
    cluster = VirtualCluster(n_cluster=4, n_booster=4, root=tmp)
    try:
        with ResilienceSession.for_cluster(cluster, strategy=Strategy.NAM_XOR,
                                           procs_per_node=2) as session:
            t0 = time.perf_counter()
            session.save(step, state)
            session.wait_drained()
            save_s = time.perf_counter() - t0
            cluster.fail(TRAIN["fail_rank"], NodeState.FAILED_NODE)
            session.invalidate_node(TRAIN["fail_rank"])
            cluster.recover(TRAIN["fail_rank"])
            session.invalidate_node(TRAIN["fail_rank"])
            t0 = time.perf_counter()
            restored, got = session.restore_latest(state)
            restore_s = time.perf_counter() - t0
            same = got == step and all(
                torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                                  tree_leaves(state)))
            say(f"  NAM_XOR save + drain {save_s:.3f} s, restore after the "
                f"kill of node {TRAIN['fail_rank']} {restore_s:.3f} s, "
                f"byte-identical: {same}")
            if not same:
                raise AssertionError("NAM_XOR restore is not byte-identical")
            del restored
            scr = session.scr
            frags = serialize_state_stream(state, step=step).fragments(
                cluster.size * scr.procs_per_node)
            xp.xor_reduce.launches = 0
            stacks = []
            for gid, group in enumerate(cluster.xor_groups):
                node_frags = [scr._node_fragment(frags, n) for n in group]
                stacked = parity.pack_words(node_frags, device=DEVICE)
                out = parity.unpack_words(parity.xor_reduce(stacked),
                                          len(node_frags[0]))
                if out != scr.stack.get(_nam_region(step, gid)):
                    raise AssertionError(f"XOR kernel parity of group {gid} "
                                         f"differs from the stored NAM parity")
                say(f"  group {gid} (nodes {group}): kernel parity of "
                    f"{len(node_frags[0])} bytes per fragment equals the "
                    f"NAM parity")
                stacks.append(stacked)
                del node_frags
            launches = xp.xor_reduce.launches
            del frags
    finally:
        cluster.teardown()
        shutil.rmtree(tmp, ignore_errors=True)
    stacked = stacks[0]
    r, m, _ = stacked.shape
    ms = time_ms(lambda: xp.xor_reduce(stacked), iters=20, warmup=3)
    plain_ms = time_ms(lambda: ref.xor_reduce(stacked), iters=5, warmup=1)
    bound = (r + 1) * m * 512 / HBM_BYTES_PER_S * 1e3
    say(f"  xor_reduce at R={r}, M={m}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes)")
    return {"name": "xor_reduce", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/xor_parity.cu",
            "replaces": "src/repro/kernels/xor_parity.py:47",
            "launches": launches, "max_abs_err": 0.0, "ms": ms,
            "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None,
            "shape": {"R": r, "M": m, "lanes": 128, "dtype": "int32"}}


# ---------------------------------------------------------------------- #
# phases 11-12: train the recurrent families through the scan kernels
# ---------------------------------------------------------------------- #


@contextlib.contextmanager
def counting_calls(targets):
    """Count the calls of module functions the main path must not reach
    (the plain versions of its kernels) while in effect: yields the
    counts by name."""
    calls = {name: 0 for _, name in targets}
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    for mod, name, fn in saved:
        def wrapper(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        setattr(mod, name, wrapper)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def plain_kernels():
    """Every call of the path's kernels goes to the plain version instead
    (for the float32 kernel-path vs plain-path comparison)."""
    saved = {name: getattr(ops, name)
             for name in ("wkv6", "mamba2_ssd", "flash_attention")}
    for name, fn in saved.items():
        setattr(ops, name, functools.partial(fn, use_kernel=False))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


PLAIN_SCANS = [(ops, "wkv6_chunked"), (ops, "mamba2_chunked"),
               (ref, "flash_attention")]


def family_launches():
    return {"wkv6_fwd": wkv.wkv6_fwd.launches,
            "wkv6_bwd": wkv.wkv6_bwd.launches,
            "mamba2_ssd_fwd": ssd.ssd_fwd.launches,
            "mamba2_ssd_bwd": ssd.ssd_bwd.launches,
            "flash_attention_fwd": fa.flash_attention_fwd.launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches}


def reset_family_launches() -> None:
    for fn in (wkv.wkv6_fwd, wkv.wkv6_bwd, ssd.ssd_fwd, ssd.ssd_bwd,
               fa.flash_attention_fwd, fa.flash_attention_bwd):
        fn.launches = 0


def prefill_full_depth(arch: str, kernels: tuple) -> dict:
    """The published config at full depth: one ``make_prefill_step`` on B
    x T tokens, timed, with the kernels' launches counted."""
    cfg = get_config(arch)
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(SEED, cfg, device=DEVICE)
    n_params = sum(p.numel() for p in tree_leaves(params))
    prefill = make_prefill_step(cfg, model)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (FAMILY["batch"], FAMILY["seq"]), dtype=np.int32)
        ).to(DEVICE)
    nxt = prefill(params, {"tokens": tokens})      # warm-up
    torch.cuda.synchronize()
    reset_family_launches()
    with counting_calls(PLAIN_SCANS) as plain:
        t0 = time.perf_counter()
        nxt = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    launches = family_launches()
    peak = torch.cuda.max_memory_allocated()
    ok = (tuple(nxt.shape) == (FAMILY["batch"],)
          and bool(((nxt >= 0) & (nxt < cfg.vocab_size)).all()))
    say(f"  full depth: {cfg.n_layers} layers, {n_params} parameters, B "
        f"{FAMILY['batch']} x T {FAMILY['seq']} bf16 prefill {ms:.1f} ms, "
        f"peak {peak / 2**30:.3f} GiB; launches "
        f"{ {k: launches[k] for k in kernels} }; plain calls {plain}; "
        f"next tokens {nxt.tolist()}")
    want = {kernels[0]: cfg.n_layers}
    if cfg.attn_every:   # the shared block, once per group
        want["flash_attention_fwd"] = cfg.n_layers // cfg.attn_every
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{arch} prefill: {launches[name]} {name} "
                                 f"launches, want {n}")
    if any(plain.values()) or not ok:
        raise AssertionError(f"{arch} prefill: plain calls {plain}, "
                             f"next tokens {nxt.tolist()}")
    del params
    release()
    return {"arch": arch, "layers": cfg.n_layers, "parameters": n_params,
            "ms": ms, "peak_bytes": peak}


def check_kernel_path_f32(cfg, model) -> float:
    """At float32 compute, the forward's logits through the kernels and
    through their plain versions agree (B 1, ragged T 200)."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params = model.init(SEED + 1, cfg32, device=DEVICE)
    rng = np.random.default_rng(SEED + 1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 200),
                                           dtype=np.int32)).to(DEVICE)
    with torch.no_grad():
        got, _ = model.forward(params, {"tokens": tokens}, cfg32, remat=False)
        with plain_kernels():
            want, _ = model.forward(params, {"tokens": tokens}, cfg32,
                                    remat=False)
    err = check_close(f"{cfg.name} float32 logits, kernel path vs plain path",
                      got, want, **FAMILY_F32_TOL)
    del params, got, want
    release()
    return err


def clean_sha(cfg, model) -> tuple:
    """The uninterrupted run, no checkpoints: the trainer's steps in order
    (same init, same batches) and the SHA-256 of its final state's bytes,
    as a checkpoint's manifest computes it."""
    state = init_train_state(SEED, cfg, model, device=DEVICE)
    pipe = TokenPipeline(cfg.vocab_size, global_batch=FAMILY["batch"],
                         seq_len=FAMILY["seq"], seed=SEED)
    step = make_train_step(cfg, model, AdamWConfig(
        lr=FAMILY["lr"], warmup_steps=FAMILY["warmup"]))
    losses, walls = [], []
    for _ in range(FAMILY["steps"]):
        batch = {k: torch.from_numpy(v).to(DEVICE)
                 for k, v in pipe.next_batch().items()}
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
    manifest = serialize_state_stream(state_to_numpy(state)).manifest
    del state
    release()
    return manifest, losses, walls


def phase_family(phase: int, arch: str, kernels: tuple) -> dict:
    """Full-depth prefill, then training at published width with the
    depth cut, one node killed, recovered, and the final state's SHA-256
    against the uninterrupted run's."""
    layers = FAMILY["layers"][arch]
    say(f"== phase {phase}: {arch} through the {kernels[0].rsplit('_', 1)[0]} "
        "kernels: full-depth prefill, then training with a node kill")
    prefill = prefill_full_depth(arch, kernels)
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = get_model(cfg)
    f32_err = check_kernel_path_f32(cfg, model)
    n_params = sum(p.numel() for p in tree_leaves(model.param_shapes(cfg)))
    torch.use_deterministic_algorithms(True)
    tmp = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{arch}_"))
    try:
        say(f"  training: published width, depth cut {get_config(arch).n_layers}"
            f" -> {layers} layers, {n_params} parameters ({3 * 4 * n_params} "
            f"bytes of params + m + v); B {FAMILY['batch']} x T "
            f"{FAMILY['seq']}, {FAMILY['steps']} steps, PARTNER copies "
            f"without a global flush, IntervalPolicy({FAMILY['ckpt_every']}), "
            f"node {FAMILY['fail_rank']} killed at step {FAMILY['fail_step']}; "
            f"free disk {shutil.disk_usage(tmp).free} bytes")
        clean, clean_losses, clean_walls = clean_sha(cfg, model)
        walls = sorted(clean_walls[1:])
        say(f"  uninterrupted (no checkpoints): loss {clean_losses[0]:.4f} -> "
            f"{clean_losses[-1]:.4f}; step median {1e3 * walls[len(walls) // 2]:.1f}"
            f" ms (first {1e3 * clean_walls[0]:.1f} ms); final state sha256 "
            f"{clean['sha256'][:16]}.. over {clean['total_bytes']} bytes")

        # the main path: counts from zero, plain versions wrapped to count
        cluster = VirtualCluster(n_cluster=4, n_booster=4, root=tmp / "faulty")
        scr = SCRManager(cluster, TierStack.for_cluster(cluster),
                         strategy=Strategy.PARTNER, procs_per_node=2,
                         flush_every=0)
        pipeline = TokenPipeline(cfg.vocab_size, global_batch=FAMILY["batch"],
                                 seq_len=FAMILY["seq"], seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        reset_family_launches()
        with counting_calls(PLAIN_SCANS) as plain, \
                ResilienceSession(scr, policy=IntervalPolicy(
                    FAMILY["ckpt_every"])) as session:
            trainer = Trainer(cfg, model, pipeline, session,
                              opt_cfg=AdamWConfig(lr=FAMILY["lr"],
                                                  warmup_steps=FAMILY["warmup"]),
                              failure_schedule=[FailureEvent(
                                  step=FAMILY["fail_step"],
                                  rank=FAMILY["fail_rank"])],
                              seed=SEED, device=DEVICE)
            report = trainer.run(total_steps=FAMILY["steps"])
            manifest = scr._descriptor(FAMILY["steps"])["manifest"]
            on_disk = dir_bytes(tmp)
        launches = family_launches()
        peak = torch.cuda.max_memory_allocated()
        cluster.teardown()
        report_train("node kill", report, manifest, on_disk)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    steps = report.steps_run
    groups = layers // max(1, cfg.attn_every) if cfg.attn_every else 0
    want = {kernels[0]: 2 * layers * steps, kernels[1]: layers * steps}
    if groups:
        want["flash_attention_fwd"] = groups * steps
        want["flash_attention_bwd"] = 3 * groups * steps
    say(f"  node kill: launches {launches} over {steps} steps x {layers} "
        f"layers; plain calls {plain}; peak device memory "
        f"{peak / 2**30:.3f} GiB")
    if report.recoveries != 1 or report.restarts_from_step != [FAMILY["ckpt_every"]]:
        raise AssertionError(f"want one recovery from step {FAMILY['ckpt_every']}"
                             f", got {report.recoveries} from "
                             f"{report.restarts_from_step}")
    if not report.losses[-1] < report.losses[0]:
        raise AssertionError("the loss did not fall")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{launches[name]} {name} launches, want {n}")
    if any(plain.values()):
        raise AssertionError(f"the training path called plain versions: "
                             f"{plain}")
    if (manifest["sha256"], manifest["total_bytes"]) != (
            clean["sha256"], clean["total_bytes"]):
        raise AssertionError("the recovered run's final state differs from "
                             "the uninterrupted run's")
    say(f"  final state byte-identical to the uninterrupted run: sha256 "
        f"{manifest['sha256'][:16]}.. over {manifest['total_bytes']} bytes")
    main_path = {"arch": arch, "layers": layers,
                 "layers_published": get_config(arch).n_layers,
                 "batch": FAMILY["batch"], "seq": FAMILY["seq"],
                 "steps_run": steps}
    release()
    return {"launches": {k: launches[k] for k in want}, "main_path": main_path,
            "prefill": prefill, "f32_logits_err": f32_err}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--scan-traces"]:   # phase 10's child process
        print(json.dumps(scan_traces()))
        return 0

    say("== phase 0: device and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    t0 = time.perf_counter()
    _build.build_all()
    say(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                say(f"  [{name}] {line.strip()}")

    kernels = phase1()

    prompts = requests(serve_arch().vocab_size)
    say(f"== phase 2: Serve.local, {N_REQUESTS} requests of "
        f"{[len(p) for p in prompts]} tokens, max_new={MAX_NEW}, spec_k=3")
    outs2, stats, wall, iters, n_layers = serve(ServeConfig(spec_k=3, **SERVE),
                                                prompts)
    launches = pa.paged_attention.launches
    report_serve("spec_k=3", outs2, stats, wall, iters, launches, n_layers)
    digest = hashlib.sha256(json.dumps(outs2).encode()).hexdigest()[:16]
    say(f"  emitted tokens sha256[:16] = {digest}")
    if stats["parked"] == 0 or stats["resumed"] == 0:
        raise AssertionError("the serve run never parked and resumed")
    kernels["paged_attention"]["launches"] = launches
    kernels["paged_attention"]["launches_per_token_iteration"] = launches / iters

    say("== phase 3: the same requests with spec_k=0")
    outs3, stats, wall, iters, n_layers = serve(ServeConfig(spec_k=0, **SERVE),
                                                prompts)
    report_serve("spec_k=0", outs3, stats, wall, iters,
                 pa.paged_attention.launches, n_layers)
    if outs3 != outs2:
        raise AssertionError("spec_k=3 and spec_k=0 emitted different tokens")
    say("  spec_k=3 and spec_k=0 emitted identical tokens")

    phase4(prompts)

    say("== phase 5: int8 pool through the int8 kernel")
    outs5, stats, wall, iters, n_layers = serve(
        ServeConfig(spec_k=3, kv_codec="int8", **SERVE), prompts)
    launches = pa.paged_attention_quant.launches
    report_serve("int8 spec_k=3", outs5, stats, wall, iters, launches, n_layers)
    if pa.paged_attention.launches:
        raise AssertionError("the int8 pool ran the plain-pool kernel")
    kernels["paged_attention_quant"]["launches"] = launches
    kernels["paged_attention_quant"]["launches_per_token_iteration"] = (
        launches / iters)
    same = sum(a == b for o5, o2 in zip(outs5, outs2) for a, b in zip(o5, o2))
    total = sum(len(o) for o in outs2)
    say(f"  int8 token agreement with phase 2: {same}/{total} = "
        f"{same / total:.4f} (reported, not gated)")

    del outs2, outs3, outs5
    release()
    kernels.update(phase6())
    phase7()
    state, cfg, launches = phase8()
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        kernels[name]["launches"] = launches[name.rsplit("_", 1)[1]]
        kernels[name]["main_path"] = launches["main_path"]
    release()
    kernels["xor_reduce"] = phase9(state)
    del state
    release()

    kernels.update(phase10())
    for phase, arch, names in ((11, "rwkv6-3b", ("wkv6_fwd", "wkv6_bwd")),
                               (12, "zamba2-2.7b", ("mamba2_ssd_fwd",
                                                    "mamba2_ssd_bwd"))):
        got = phase_family(phase, arch, names)
        for name in names:
            kernels[name]["launches"] = got["launches"][name]
            kernels[name]["main_path"] = got["main_path"]
        kernels[names[0]]["prefill_full_depth"] = got["prefill"]
        kernels[names[0]]["f32_logits_err"] = got["f32_logits_err"]
        for name in ("flash_attention_fwd", "flash_attention_bwd"):
            if name in got["launches"]:   # zamba2's shared block
                kernels[name]["launches_" + arch] = got["launches"][name]

    say(smi)
    say(json.dumps({"kernels": list(kernels.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
