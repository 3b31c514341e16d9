#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives its serving path (paged, resilient and contiguous) with
full-width, full-depth phi3-mini-3.8b, minicpm3-4b (MLA, paged),
deepseek-moe-16b (MoE, contiguous), whisper-tiny and paligemma-3b
(contiguous), and its training-and-recovery path with full-width
phi3-mini-3.8b cut to 2 layers, rwkv6-3b cut to 2, zamba2-2.7b cut to 6,
minicpm3-4b cut to 2, deepseek-moe-16b cut to 2, paligemma-3b cut to 2 and
whisper-tiny at full size (random weights from a seed).  Phases, each of
which raises on a failed check:

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
   shared block (32/32, D 80) and a D 64 shape, a ragged T 200, Tq < Tk,
   non-causal Tq > Tk and the prefix-LM mask (D 96: T 512 with prefix
   128, T 200 with prefix 77, Tq 100 < Tk 300 with prefix 150), float32
   (CUDA-core route) and bfloat16 (tensor-core route:
   wgmma fed by TMA), with the float32 gradients also held against a
   float64 computation; the bf16 kernels' registers, spills and shared
   memory (ptxas) and their HGMMA / UTMALDG counts (cuobjdump -sass), none
   without HGMMA; two bf16 forward and backward launches at phi3's
   training shape bit-identical; the kernel path refuses causal Tq > Tk;
   then forward and backward times at three training
   shapes (B 4, T 512, bf16: phi3 heads, zamba2's shared block at D 80 and
   deepseek-moe-16b's 16 heads of 128, recorded under ``at_head_dim_80``
   and ``at_head_dim_128``) beside their bounds, the plain
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
   group per step;
13. resilient serving of full-size phi3-mini-3.8b through ``Serve.local``
   (4 slots, max_len 256, page 16, quantum 4, spec_k=3; 8 requests
   sharing a 48-token system prompt, 8-32 tokens of their own, 32 new
   tokens): (a) no prefix cache, the default pool; (b) the prefix cache
   and a pool of 80 pages (five lanes), so admission spills: (a)'s
   tokens, spills, refills, prefix hits and saved prefill tokens > 0,
   resume bytes equal to the refills' alone (clean resumes move none),
   paged launches = layers x token iterations with no plain attention
   call; (c) (b) under an XOR ``ResilienceSession`` on a virtual
   cluster, checkpointed once a stream is spilled and a prefix page is
   bound in the pool, the stack closed, node 1 failed and recovered, a
   fresh stack restored (pool SHA-256, allocator, pager tables and trie
   equal to the saved) and finished with (a)'s tokens; (d) the
   contiguous scheduler (2 slots, quantum 2, 4 requests, 4 new tokens,
   full depth) with pager and prefix cache, uninterrupted and through
   the same kill and restore: the same tokens, parks and resumes through
   the pager, no paged launch, one plain decode attention call per
   layer per slot per step and per prefill token;
14. minicpm3-4b (MLA: qk heads of 96, v heads of 64): (a) the flash
   kernels with V of its own width against their plain version, forward
   and backward, f32 and bf16, the f32 gradients also against float64,
   at minicpm3's training shape (B 4, T 512, 40 heads) and two odd ones
   (Tq 100 > Tk 77 non-causal and Tq 77 < Tk 100 causal, 8 query heads
   over 2); the (96, 64) instantiations' registers and spills; their
   times beside (96, 96) at the same shape, the bound and the fastest
   SDPA backend that takes Dv != D; (b) a full-depth (62 layers) bf16
   prefill, one flash launch per layer, no plain call; (c) the float32
   forward through the kernels against the plain path; (d) ``Trainer``
   at published width cut to 2 layers (PARTNER, node 3 killed at step 6
   of 8): one recovery, a falling loss, 2 forward and 3 backward flash
   launches per layer per step, the uninterrupted run's state bytes;
   (e) ``Serve.local`` paged with the prefix cache at full size (4
   slots, page 16, 8 requests of 16-48 tokens sharing a 16-token page,
   8 new tokens): spec_k=3 and spec_k=0 emit identical tokens, with no
   kernel launch (MLA decodes in latent space with plain einsums, as
   the reference does);
15. deepseek-moe-16b (28 layers, the first dense; 64 routed experts,
   top-6, 2 shared): (a) a full-depth bf16 prefill from the float32
   weights (28 flash launches, peak memory reported); (b) the float32
   kernel path against the plain path at 2 layers; (c) training at
   published width cut to 2 layers (one dense, one MoE), twice,
   uninterrupted, under deterministic algorithms: the same final state
   bytes, a falling loss, ``router_aux`` reported, flash launches
   counted; (d) ``Serve.local(paged=False)`` with the prefix cache at
   full size (2 slots, 4 requests of 16-32 tokens, 8 new tokens), then
   the same through a serving save, a node kill and a restore into a
   fresh ``Serve.local``: the same tokens; tok/s, and the batch-1 decode
   step (every expert read, the reference's design) by CUDA events
   against the time to read its weights;
16. whisper-tiny and paligemma-3b: (a) the flash kernels against their
   plain version (f32 and bf16, forward and backward, the f32 gradients
   also against float64) at paligemma's training shape (B 4, T 512 = 256
   patches + 256 text, 8 query heads over 1 of 256, causal, prefix 256
   and 0), a ragged T 200 with prefix 77, whisper's encoder (B 4, 1500
   frames, 6 heads of 64, non-causal) and cross-attention (448 text rows
   over 1500 frames); two bf16 launches bit-identical at the three timed
   shapes; times beside the bound, the plain version and the fastest SDPA
   form that takes the call (the prefix as a boolean mask, kv heads as
   given and repeated); (b) paligemma-3b at full depth (18 layers):
   one bf16 prefill, 18 flash launches, no plain or library attention
   call; (c) training at published width cut to 2 layers, twice, under
   deterministic algorithms: the same final state bytes, 2 forward and 3
   backward flash launches per layer per step; (d) whisper-tiny at full
   size (4 + 4 layers, B 4 x T 448 over 1500 frames): a full-depth
   prefill (12 flash launches), the f32 kernel path against the plain
   path, and ``Trainer`` with PARTNER copies and node 3 killed at step 6
   of 8: one recovery, 20 forward calls (4 encoder + 2 x 8 decoder) and
   12 backward passes per step, the uninterrupted run's state bytes; (e)
   ``Serve.local(paged=False)`` at full size for both (2 slots, 4
   requests, 8 new tokens), uninterrupted and through a save, a node kill
   and a restore: the same tokens, decode attention only through
   ``layers.decode_attention``; ``paged=True`` refused with the
   reference's message; tok/s and ms per slot-step;
17. the serving fleet, every worker a spawned process with its own CUDA
   context and its own full-width phi3-mini-3.8b on the one card, all
   over one shared cache domain per fleet (three fleets of 2, 1 and 2
   workers launched together): (a) fig12's set-up (slots 2, page 4,
   max_len 32, quantum 3): worker B reuses the whole 12-token prefix
   worker A published (B's prefill = its target less the 12 saved,
   shared-tier hits and adopted nodes > 0), 8 requests of 4 new tokens on
   1 and on 2 workers, five batches of fresh prompts (tok/s and the
   speedup's median and range beside fig12's 1.5, reported), a noisy tenant over its quota of 1 throttled while all 9
   requests complete (the quiet tenant's p99 admission beside fig12's
   1.0 s, reported); (b) fig13's set-up (max_len 256, an epoch checkpoint
   every 4 steps, heartbeats 0.05 s, timeout 0.3 s, 4 streams of 64 new
   tokens, fig13's 160 cut for time): worker 0 SIGKILLed after its first epoch record while its
   streams are unfinished; every stream ends with the tokens of the
   in-process ``Serve.local`` oracle, the victim is ``dead``, one worker
   failed, its unfinished streams migrated, every request completed, and
   its flight records (read from the shared domain) hold decode steps;
   the survivors' p99 gap and the recovery stall beside fig13's bounds
   (reported); (c) the oracle's paged launches = layers x token
   iterations, with no plain decode attention call, and the same of every
   worker's own counts since its ``ready`` (read from its ``stats`` reply:
   the victim's just before the kill, the others' at the end of their
   runs).

Phase 10 also runs the repair cases: the scans' gradient through the
final state (a loss on y and on the final state) at 64-wide shapes, WKV6
at head sizes 128 and 80 and SSD at (P, N) = (64, 128) and (128, 64)
(tiles of the 64-wide kernels on the float32 route), and flash at (D, Dv)
= (72, 72), (112, 112), (160, 160), (100, 100) and (96, 32) (zero-padded
to the next instantiation), each f32 and bf16 against the plain version
(f32 gradients also against float64), twice bit-identical, with bf16
times; flash refuses D 264 by name.

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
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.models import registry  # noqa: E402
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
# phase 10's repair cases: a loss on the final state too (its gradient
# seeds the backward's state chain) at a 64-wide shape of each scan, the
# scans past 64 (tiles of 64, partials summed in float32), and flash at head
# widths with no instantiation of their own (zero-padded to the next one)
REPAIR_SCANS = {
    "wkv6": {"D=64 T=200": (2, 200, 4, 64), "D=128 T=200": (2, 200, 4, 128),
             "D=80 T=77": (1, 77, 2, 80)},
    "ssd": {"P=N=64 T=200": (2, 200, 8, 64, 64),
            "P=64 N=128 T=200": (2, 200, 8, 64, 128),
            "P=128 N=64 T=200": (2, 200, 8, 128, 64)},
}
REPAIR_FLASH = {   # b, tq, tk, hq, hkv, d, dv
    "(64, 64)": (2, 256, 256, 8, 2, 64, 64),
    "(72, 72)": (2, 256, 256, 8, 2, 72, 72),
    "(112, 112)": (2, 256, 256, 8, 2, 112, 112),
    "(160, 160)": (2, 256, 256, 8, 2, 160, 160),
    "(100, 100)": (2, 256, 256, 8, 2, 100, 100),
    "(96, 32)": (2, 256, 256, 8, 2, 96, 32),
}
# phase 10's case below the model's decay clip: w down to 1e-20 on every
# other channel, against the sequential oracle (the chunked plain version
# overflows there)
BELOW_CLIP_SHAPE = (1, 77, 2, 64)
# phases 11-12: the recurrent families at published width; training cuts
# the depth (rwkv6-3b 32 -> 2 layers, zamba2-2.7b 54 -> 6, one group)
FAMILY = dict(layers={"rwkv6-3b": 2, "zamba2-2.7b": 6, "minicpm3-4b": 2,
                      "deepseek-moe-16b": 2, "paligemma-3b": 2,
                      "whisper-tiny": 4}, batch=4, seq=512,
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


def time_ms(fn, iters=100, warmup=10, max_sleep_s=0.5) -> float:
    """Mean ms of ``fn`` by CUDA events over ``iters`` calls.  The calls
    are queued behind a sleep on the card that outlasts twice their launch
    time on the host (taken over the warm-up; at most ``max_sleep_s``), so
    that the events time the card's work, not the host's rate of launching
    it (as long as ``fn`` never waits for the card)."""
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * iters * host_s + 1e-3, max_sleep_s) * SLEEP_HZ))
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


def flash_inputs(b, tq, tk, hq, hkv, d, dtype, seed=SEED, dv=None):
    """q, k, v and dO; v and dO are ``dv`` wide (default: d)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dv = d if dv is None else dv

    def mk(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

    return (mk(b, tq, hq, d), mk(b, tk, hkv, d), mk(b, tk, hkv, dv),
            mk(b, tq, hq, dv))


def flash_grads(q, k, v, dout, use_kernel, causal=True, prefix_len=0):
    """(out, dq, dk, dv) through ops.flash_attention and autograd."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(q, k, v, causal=causal, prefix_len=prefix_len,
                              use_kernel=use_kernel)
    return (out.detach(),) + torch.autograd.grad(out, (q, k, v), dout)


def visible_pairs(tq, tk, causal=True, prefix_len=0) -> int:
    """The (query, key) pairs one head attends: every pair without
    ``causal``; with it, each row's keys up to its diagonal or below the
    prefix, whichever reaches further."""
    if not causal:
        return tq * tk
    return sum(max(min(tk, i + 1 + tk - tq), min(prefix_len, tk))
               for i in range(tq))


def flash_bound_ms(b, tq, tk, hq, hkv, d, elem, backward, dv=None,
                   causal=True, prefix_len=0) -> tuple:
    """Least time for one call: q, k, v (and o, dO for the backward) read
    once, o or dq, dk, dv written once, plus the f32 log-sum-exp; against
    2 flops per multiply-add over the visible (query, key) pairs this run
    has (forward: Q K^T over d and P V over dv; backward: Q K^T, dS K and
    dS^T Q over d, dO V^T and P^T dO over dv) at the inputs' peak rate."""
    dv = d if dv is None else dv
    pairs = visible_pairs(tq, tk, causal, prefix_len)
    q_bytes, k_bytes = b * tq * hq * d * elem, b * tk * hkv * d * elem
    o_bytes, v_bytes = b * tq * hq * dv * elem, b * tk * hkv * dv * elem
    lse = b * hq * tq * 4
    if backward:
        nbytes = (q_bytes + k_bytes + v_bytes + 2 * o_bytes + lse    # read
                  + q_bytes + k_bytes + v_bytes)                     # written
        flops = 2 * b * hq * pairs * (3 * d + 2 * dv)
    else:
        nbytes = q_bytes + k_bytes + v_bytes + o_bytes + lse
        flops = 2 * b * hq * pairs * (d + dv)
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
    name = re.compile(r"hopper\d+(fwd_kernel|dq_kernel|dkdv_kernel)ILi(\d+)ELi(\d+)E")
    log = _build.build_log.get("flash_attention")
    if log is None:
        raise AssertionError("no ptxas report: flash_attention.cu was not built "
                             "by this run (delete build/repro_torch_kernels)")
    report, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = name.search(line)
            cur = f"{m[1]}<{m[2]},{m[3]}>" if m else None
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
            cur = f"{m[1]}<{m[2]},{m[3]}>" if m else None
        elif cur:
            report[cur]["HGMMA"] += " HGMMA." in line
            report[cur]["UTMALDG"] += " UTMALDG." in line
    lib = _build.library("flash_attention")
    for key, entry in report.items():
        kind, dims = key[:-1].split("<")
        d, dv = map(int, dims.split(","))
        entry["dynamic_smem_bytes"] = lib.repro_flash_bf16_smem(
            ("fwd_kernel", "dq_kernel", "dkdv_kernel").index(kind), d, dv)
        say(f"  {key}: {entry['registers']} registers, spill stores "
            f"{entry['spill_stores']} B / loads {entry['spill_loads']} B, "
            f"{entry['dynamic_smem_bytes']} B dynamic shared memory; SASS "
            f"HGMMA {entry['HGMMA']}, UTMALDG {entry['UTMALDG']}")
    want = {f"{k}<{d},{dv}>" for k in ("fwd_kernel", "dq_kernel", "dkdv_kernel")
            for d, dv in fa.BF16_PAIRS}
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
        # the prefix-LM mask (paligemma's): tiles below, across and past
        # the prefix, a ragged one, and Tq < Tk
        "prefix-LM T=512, prefix 128": (2, 512, 512, 32, 32, 96),
        "prefix-LM T=200, prefix 77": (2, 200, 200, 32, 32, 96),
        "prefix-LM Tq=100 < Tk=300, prefix 150": (2, 100, 300, 32, 32, 96),
    }
    non_causal = {"non-causal Tq=64 > Tk=32"}
    prefixes = {"prefix-LM T=512, prefix 128": 128,
                "prefix-LM T=200, prefix 77": 77,
                "prefix-LM Tq=100 < Tk=300, prefix 150": 150}
    say("  bf16 route (wgmma + TMA) build report:")
    sass = flash_sass()
    errs = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0}
    for label, shape in shapes.items():
        for dtype in (f32, bf16):
            tol = FLASH_F32_TOL if dtype == f32 else FLASH_BF16_TOL
            bwd_tol = FLASH_BWD_F32_TOL if dtype == f32 else FLASH_BF16_TOL
            tag = f"{label} {str(dtype)[6:]}"
            causal = label not in non_causal
            prefix_len = prefixes.get(label, 0)
            q, k, v, dout = flash_inputs(*shape, dtype)
            got = flash_grads(q, k, v, dout, None, causal, prefix_len)
            want = flash_grads(q, k, v, dout, False, causal, prefix_len)
            errs["flash_attention_fwd"] = max(
                errs["flash_attention_fwd"],
                check_close(f"flash fwd {tag}", got[0], want[0], **tol))
            for name, g, w in zip(("dQ", "dK", "dV"), got[1:], want[1:]):
                errs["flash_attention_bwd"] = max(
                    errs["flash_attention_bwd"],
                    check_close(f"flash bwd {name} {tag}", g, w, **bwd_tol))
            if dtype == f32:
                exact = flash_grads(q.double(), k.double(), v.double(),
                                    dout.double(), False, causal, prefix_len)
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
    try:
        ops.flash_attention(q, k, v)
    except ValueError as e:
        say(f"  kernel path refuses causal Tq=64 > Tk=32: {e}")
    else:
        raise AssertionError("the flash kernel path accepted causal Tq > Tk")

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

    # times at the training shapes, bf16: phi3's (phase 8), zamba2's shared
    # block (phase 12, D 80) and deepseek-moe-16b's (phase 15, D 128); the
    # first fills the entry's keys.  The yardstick is SDPA pinned to its
    # flash backend, forward and backward.
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    flash_backend = functools.partial(sdpa_kernel, SDPBackend.FLASH_ATTENTION)
    b, t = TRAIN["batch"], TRAIN["seq"]
    rec = {}
    for label, h, d in (("phi3", 32, 96), ("zamba2-2.7b shared block", 32, 80),
                        ("deepseek-moe-16b", 16, 128)):
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
                rec[name][f"at_head_dim_{d}"] = times
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


def scan_grads(kind, ins, dy, use_kernel, dstate=None):
    """(y, final state, grads of every input that is given) through
    ``ops`` and autograd, of a loss on y (``dy``) and, given ``dstate``,
    on the final state too."""
    leaves = [x.detach().requires_grad_() if x is not None else None
              for x in ins]
    y, s = scan_call(kind, leaves, use_kernel)
    wrt = [x for x in leaves if x is not None]
    if dstate is None:
        return (y.detach(), s.detach()) + torch.autograd.grad(y, wrt, dy)
    return (y.detach(), s.detach()) + torch.autograd.grad((y, s), wrt,
                                                          (dy, dstate))


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


def scan_tight(kind, tag, ins, dy, got, dstate=None) -> None:
    """A bf16 scan kernel's results against the plain version run on the
    same inputs (and dy, dstate) cast to float32."""
    ins32 = [None if x is None else x.float() for x in ins]
    want = scan_grads(kind, ins32, dy.float(), False, dstate)
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


def scan_state_grad(kind, shape, dtype) -> dict:
    """One repair case of a scan: forward and backward with a loss on y and
    the final state, from a non-zero initial state, kernel against the
    plain version (and float64 at f32, float32 casts at bf16), twice
    bit-identical; returns the largest errors."""
    ins, dy = scan_inputs(kind, shape, dtype, True, seed=SEED + 11)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    ds = torch.randn(ins[5].shape, generator=gen, device=DEVICE)
    tag = f"{shape} {str(dtype)[6:]} with dstate"
    got = scan_grads(kind, ins, dy, None, ds)
    want = scan_grads(kind, ins, dy, False, ds)
    f32 = dtype == torch.float32
    tol = SCAN_F32_TOL if f32 else SCAN_BF16_TOL
    fwd_err = max(check_close(f"{kind} y {tag}", got[0], want[0], **tol),
                  check_close(f"{kind} final state {tag}", got[1], want[1],
                              **tol))
    rel = SCAN_BWD_F32_REL if f32 else SCAN_BF16_TOL["rtol"]
    bwd_err = 0.0
    for name, g, w in zip(SCAN_GRAD_NAMES[kind], got[2:], want[2:]):
        bwd_err = max(bwd_err, check_scaled(f"{kind} {name} {tag}", g, w, rel))
    again = scan_grads(kind, ins, dy, None, ds)
    if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
        raise AssertionError(f"{kind} {tag}: a repeated run gave other bits")
    if f32:
        exact = scan_grads(kind, [x.double() for x in ins], dy.double(), False,
                           ds.double())
        for name, g, w, e in zip(SCAN_GRAD_NAMES[kind], got[2:], want[2:],
                                 exact[2:]):
            scale = max(e.abs().max().item(), 1e-30)
            kd = (g.double() - e).abs().max().item() / scale
            pd = (w.double() - e).abs().max().item() / scale
            say(f"    {name} distance to float64: kernel {kd:.3e}, plain "
                f"{pd:.3e} (limit max(plain, {SCAN_F64_REL}))")
            if not kd <= max(pd, SCAN_F64_REL):
                raise AssertionError(f"{kind} {name} {tag}: the kernel lies "
                                     f"{kd:.3e} from float64")
    else:
        scan_tight(kind, tag, ins, dy, got, ds)
    return {"fwd": fwd_err, "bwd": bwd_err}


def scan_repair_ms(kind, shape) -> dict:
    """bf16 kernel times of one repair shape: the forward saving its states
    and the backward with dstate, beside the bound."""
    ins, dy = scan_inputs(kind, shape, torch.bfloat16, False, seed=SEED + 13)
    mod, fwd_fn, bwd_fn = ((wkv, wkv.wkv6_fwd, wkv.wkv6_bwd) if kind == "wkv6"
                           else (ssd, ssd.ssd_fwd, ssd.ssd_bwd))
    a = ins[:5]
    if kind == "wkv6":
        a = a[:4] + (a[4].float(),)
    _, s_out, ckpt = fwd_fn(*a, save=True)
    ds = torch.ones_like(s_out)
    fwd_ms = time_ms(lambda: fwd_fn(*a, save=True), iters=20, warmup=3)
    bwd_ms = time_ms(lambda: bwd_fn(*a, ckpt, dy, ds), iters=20, warmup=3)
    fb, _ = scan_bound_ms(kind, shape, 2, False)
    bb, _ = scan_bound_ms(kind, shape, 2, True)
    tiles = (len(mod.tile_plan(shape[3])["launches"]) if kind == "wkv6"
             else len(mod.tile_plan(shape[3], shape[4])["launches"]))
    say(f"  {kind} {shape} bf16: forward {fwd_ms:.5f} ms (bound {fb:.5f}), "
        f"backward with dstate {bwd_ms:.5f} ms (bound {bb:.5f}); "
        f"{tiles} tile launch(es) a call")
    return {"shape": list(shape), "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
            "fwd_bound_ms": fb, "bwd_bound_ms": bb, "tile_launches": tiles}


def phase10_repairs() -> dict:
    """Faults 5 and 3 repaired: the scans' final-state gradient, the scans
    past 64 and flash at every width up to 256, each against its plain
    version, twice bit-identical, with bf16 times."""
    say("== phase 10 (repairs): the scans' final-state gradient and widths "
        "past 64; flash at widths with no instantiation of their own")
    f32, bf16 = torch.float32, torch.bfloat16
    out = {"wkv6": {}, "ssd": {}, "flash": {}}
    for kind, shapes in REPAIR_SCANS.items():
        for label, shape in shapes.items():
            errs = {str(dtype)[6:]: scan_state_grad(kind, shape, dtype)
                    for dtype in (f32, bf16)}
            out[kind][label] = dict(scan_repair_ms(kind, shape), errors=errs)
            release()
    for label, (b, tq, tk, hq, hkv, d, dv) in REPAIR_FLASH.items():
        rec = {"shape": [b, tq, tk, hq, hkv, d, dv],
               "kernel_dims": {"float32": list(fa.padded_dims(d, dv)),
                               "bfloat16": list(fa.bf16_kernel_dims(d, dv))}}
        for dtype in (f32, bf16):
            tol = FLASH_F32_TOL if dtype == f32 else FLASH_BF16_TOL
            bwd_tol = FLASH_BWD_F32_TOL if dtype == f32 else FLASH_BF16_TOL
            tag = f"(D, Dv) = {label} {str(dtype)[6:]}"
            q, k, v, dout = flash_inputs(b, tq, tk, hq, hkv, d, dtype,
                                         seed=SEED + 14, dv=dv)
            got = flash_grads(q, k, v, dout, None)
            want = flash_grads(q, k, v, dout, False)
            err = check_close(f"flash fwd {tag}", got[0], want[0], **tol)
            for name, g, w in zip(("dQ", "dK", "dV"), got[1:], want[1:]):
                err = max(err, check_close(f"flash bwd {name} {tag}", g, w,
                                           **bwd_tol))
            if dtype == f32:
                exact = flash_grads(q.double(), k.double(), v.double(),
                                    dout.double(), False)
                dist = lambda xs: max((x.double() - e).abs().max().item()
                                      for x, e in zip(xs, exact[1:]))
                kern_d, plain_d = dist(got[1:]), dist(want[1:])
                say(f"    distance to float64, dQ/dK/dV: kernel {kern_d:.3e}, "
                    f"plain {plain_d:.3e} (limit max(plain, {FLASH_F64_ATOL}))")
                if kern_d > max(plain_d, FLASH_F64_ATOL):
                    raise AssertionError(f"flash bwd {tag}: the kernel lies "
                                         f"{kern_d:.3e} from float64")
            again = flash_grads(q, k, v, dout, None)
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                raise AssertionError(f"flash {tag}: a repeated run gave other "
                                     "bits")
            rec[f"max_abs_err_{str(dtype)[6:]}"] = err
        q, k, v, dout = flash_inputs(b, tq, tk, hq, hkv, d, bf16,
                                     seed=SEED + 15, dv=dv)
        o, lse = fa.flash_attention_fwd(q, k, v)
        rec["fwd_ms"] = time_ms(lambda: fa.flash_attention_fwd(q, k, v),
                                iters=20, warmup=3)
        rec["bwd_ms"] = time_ms(
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, dout), iters=20,
            warmup=3)
        rec["fwd_bound_ms"] = flash_bound_ms(b, tq, tk, hq, hkv, d, 2, False,
                                             dv=dv)[0]
        rec["bwd_bound_ms"] = flash_bound_ms(b, tq, tk, hq, hkv, d, 2, True,
                                             dv=dv)[0]
        say(f"  flash {label} bf16 at {rec['kernel_dims']['bfloat16']}: "
            f"forward {rec['fwd_ms']:.5f} ms (bound {rec['fwd_bound_ms']:.5f}), "
            f"backward {rec['bwd_ms']:.5f} ms (bound {rec['bwd_bound_ms']:.5f})")
        out["flash"][label] = rec
        release()
    q, k, v, _ = flash_inputs(1, 16, 16, 2, 2, 264, bf16)
    try:
        ops.flash_attention(q, k, v)
    except ValueError as e:
        say(f"  flash refuses D 264 by name: {e}")
    else:
        raise AssertionError("the flash kernel path accepted D 264")
    return out


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
               (ref, "flash_attention"),
               (torch.nn.functional, "scaled_dot_product_attention")]


class ModalPipeline(TokenPipeline):
    """The token pipeline, plus for an ``encdec`` / ``vlm`` config the stub
    frontend's embeddings (whisper's ``enc_frames``, paligemma's
    ``patches``): standard normal float32 from a Philox stream keyed by
    (seed + 1, step), so each batch stays a pure function of its step, as
    the trainer's recovery needs.  For other families it is the token
    pipeline itself."""

    def __init__(self, cfg, global_batch, seq_len, seed=SEED):
        super().__init__(cfg.vocab_size, global_batch=global_batch,
                         seq_len=seq_len, seed=seed)
        self.modal = {"encdec": ("enc_frames", cfg.enc_seq),
                      "vlm": ("patches", cfg.n_prefix)}.get(cfg.family)
        self.d_model = cfg.d_model

    def batch_at(self, step):
        batch = super().batch_at(step)
        if self.modal is not None:
            name, rows = self.modal
            rng = np.random.Generator(np.random.Philox(
                key=self.seed + 1, counter=np.uint64(step + 1)))
            batch[name] = rng.standard_normal(
                (self.global_batch, rows, self.d_model), dtype=np.float32)
        return batch


def text_len(cfg, seq: int) -> int:
    """Text tokens of a sequence of ``seq`` positions: paligemma's patches
    take the first ``n_prefix`` of them."""
    return seq - cfg.n_prefix if cfg.family == "vlm" else seq


def flash_calls_per_pass(cfg) -> int:
    """Flash attention calls in one forward: one per layer; whisper's
    encoder layers one each, its decoder layers two (self and cross)."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


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


def prefill_full_depth(arch: str, kernels: tuple, seq=None) -> dict:
    """The published config at full depth: one ``make_prefill_step`` on B
    x T positions, timed, with the kernels' launches counted.  The stub
    frontends' inputs come from ``registry.make_inputs`` (paligemma's
    patches take the first ``n_prefix`` of the T positions)."""
    cfg = get_config(arch)
    model = get_model(cfg)
    seq = FAMILY["seq"] if seq is None else seq
    torch.cuda.reset_peak_memory_stats()
    params = model.init(SEED, cfg, device=DEVICE)
    n_params = sum(p.numel() for p in tree_leaves(params))
    prefill = make_prefill_step(cfg, model)
    if cfg.family in ("encdec", "vlm"):
        batch = registry.make_inputs(
            cfg, ShapeSpec("chip_smoke", seq, FAMILY["batch"], "prefill"),
            torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    else:
        rng = np.random.default_rng(SEED)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (FAMILY["batch"], seq), dtype=np.int32)
            ).to(DEVICE)}
    nxt = prefill(params, batch)      # warm-up
    torch.cuda.synchronize()
    reset_family_launches()
    with counting_calls(PLAIN_SCANS) as plain:
        t0 = time.perf_counter()
        nxt = prefill(params, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    launches = family_launches()
    peak = torch.cuda.max_memory_allocated()
    ok = (tuple(nxt.shape) == (FAMILY["batch"],)
          and bool(((nxt >= 0) & (nxt < cfg.vocab_size)).all()))
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    say(f"  full depth: {cfg.n_layers} layers, {n_params} parameters, "
        f"inputs {shapes} bf16 prefill {ms:.1f} ms, "
        f"peak {peak / 2**30:.3f} GiB; launches "
        f"{ {k: launches[k] for k in kernels} }; plain calls {plain}; "
        f"next tokens {nxt.tolist()}")
    want = {kernels[0]: flash_calls_per_pass(cfg)
            if kernels[0] == "flash_attention_fwd" else cfg.n_layers}
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
            "ms": ms, "peak_bytes": peak, "inputs": shapes,
            "flash_launches": launches["flash_attention_fwd"]}


def check_kernel_path_f32(cfg, model) -> float:
    """At float32 compute, the forward's logits through the kernels and
    through their plain versions agree (B 1, ragged T 200 text tokens,
    after paligemma's patches, beside whisper's frames)."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params = model.init(SEED + 1, cfg32, device=DEVICE)
    rng = np.random.default_rng(SEED + 1)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in ModalPipeline(
        cfg, 1, 200, seed=SEED + 1).batch_at(0).items() if k != "labels"}
    batch["tokens"] = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, 200), dtype=np.int32)).to(DEVICE)
    with torch.no_grad():
        got, _ = model.forward(params, batch, cfg32, remat=False)
        with plain_kernels():
            want, _ = model.forward(params, batch, cfg32, remat=False)
    err = check_close(f"{cfg.name} float32 logits, kernel path vs plain path",
                      got, want, **FAMILY_F32_TOL)
    del params, got, want
    release()
    return err


def clean_sha(cfg, model, seq=None) -> tuple:
    """The uninterrupted run, no checkpoints: the trainer's steps in order
    (same init, same batches) and the SHA-256 of its final state's bytes,
    as a checkpoint's manifest computes it."""
    state = init_train_state(SEED, cfg, model, device=DEVICE)
    pipe = ModalPipeline(cfg, FAMILY["batch"],
                         text_len(cfg, FAMILY["seq"] if seq is None else seq))
    step = make_train_step(cfg, model, AdamWConfig(
        lr=FAMILY["lr"], warmup_steps=FAMILY["warmup"]))
    losses, walls, auxes = [], [], []
    for _ in range(FAMILY["steps"]):
        batch = {k: torch.from_numpy(v).to(DEVICE)
                 for k, v in pipe.next_batch().items()}
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
        if "router_aux" in metrics:
            auxes.append(float(metrics["router_aux"]))
    manifest = serialize_state_stream(state_to_numpy(state)).manifest
    del state
    release()
    return manifest, losses, walls, auxes


def phase_family(phase: int, arch: str, kernels: tuple, seq=None) -> dict:
    """Full-depth prefill, then training at published width with the
    depth cut, one node killed, recovered, and the final state's SHA-256
    against the uninterrupted run's.  ``seq``: positions per sequence
    (default ``FAMILY["seq"]``)."""
    layers = FAMILY["layers"][arch]
    seq = FAMILY["seq"] if seq is None else seq
    say(f"== phase {phase}: {arch} through the {kernels[0].rsplit('_', 1)[0]} "
        "kernels: full-depth prefill, then training with a node kill")
    prefill = prefill_full_depth(arch, kernels, seq)
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
            f"{seq}, {FAMILY['steps']} steps, PARTNER copies "
            f"without a global flush, IntervalPolicy({FAMILY['ckpt_every']}), "
            f"node {FAMILY['fail_rank']} killed at step {FAMILY['fail_step']}; "
            f"free disk {shutil.disk_usage(tmp).free} bytes")
        clean, clean_losses, clean_walls, _ = clean_sha(cfg, model, seq)
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
        pipeline = ModalPipeline(cfg, FAMILY["batch"], text_len(cfg, seq))
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
    if kernels[0] == "flash_attention_fwd":
        # attention in every layer: 2 forward launches (remat) and one
        # backward pass of 3 launches per layer per step
        want[kernels[1]] = 3 * layers * steps
    if cfg.family == "encdec":
        # whisper: the encoder's layers (not remat'd) one forward each, the
        # decoder's two calls (self, cross) twice; a backward pass per call
        calls = flash_calls_per_pass(cfg)
        want = {kernels[0]: (calls + 2 * cfg.n_layers) * steps,
                kernels[1]: 3 * calls * steps}
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
                 "batch": FAMILY["batch"], "seq": seq,
                 "steps_run": steps}
    release()
    return {"launches": {k: launches[k] for k in want}, "main_path": main_path,
            "prefill": prefill, "f32_logits_err": f32_err}


# ---------------------------------------------------------------------- #
# phase 13: resilient serving of full-size phi3
# ---------------------------------------------------------------------- #

# 8 requests share a 48-token system prompt (3 pages of 16) and add 8-32
# tokens of their own; the resilient runs' pool of 80 pages holds five
# lanes, so 8 streams over 4 slots must spill.  The contiguous run (d)
# serves 4 of them over 2 slots at full depth.
# (d)'s streams: 4 new tokens (cut from 8 for the script's time limit;
# quantum 2 still parks every stream once)
RESILIENT = dict(system=48, own=(8, 32), pool_pages=80, fail_rank=1,
                 contig_requests=4, contig_slots=2, contig_quantum=2,
                 contig_max_new=4)


def resilient_requests(vocab: int):
    rng = np.random.default_rng(SEED)
    system = rng.integers(0, vocab, size=RESILIENT["system"]).tolist()
    lo, hi = RESILIENT["own"]
    return [system + rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))
                                  ).tolist() for _ in range(N_REQUESTS)]


def tree_sha(tree) -> str:
    """SHA-256 over a dict of tensors' raw bytes, in sorted name order."""
    h = hashlib.sha256()
    for name in sorted(tree):
        t = tree[name].detach().contiguous().cpu()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
                 .numpy().tobytes())
    return h.hexdigest()


def serving_fingerprint(sched) -> dict:
    """What a restore must reproduce exactly: the pool's bytes (or the
    lanes'), the allocator, the parked pager tables, the prefix trie and
    the stream set."""
    out = {}
    if isinstance(sched, scheduler.PagedServeScheduler):
        out["pool_sha256"] = tree_sha(sched.pool.snapshot())
        out["allocator"] = [sched.pool.refcounts(), sorted(sched.pool._free),
                            sched.pool.resident_digests(),
                            dict(sorted(sched._ptables.items()))]
    else:
        out["lanes_sha256"] = tree_sha(sched.slots_cache)
    out["pager"] = {sid: [sched.pager.page_table(sid),
                          sched.pager.parked_nbytes(sid),
                          sched.pager.parked_kind(sid)]
                    for sid in sched.pager.parked_sids()}
    out["trie"] = [sched.prefix.export_records(), sched.prefix.stream_refs()]
    out["streams"] = sched.live_descriptors()
    return out


def checkpointable(sched) -> bool:
    """A stream parked off its slot through the pager (spilled, on the
    paged path) and, on the paged path, a prefix page bound in the pool."""
    if isinstance(sched, scheduler.PagedServeScheduler):
        return (sched.stats["spilled"] > 0 and bool(sched.pager.parked_sids())
                and bool(sched.pool.resident_digests()))
    return bool(sched.pager.parked_sids())


def token_iterations(stats, spec_k) -> int:
    return (stats["prefill_calls"] * scheduler.PREFILL_BUCKET
            + stats["steps"] * (spec_k + 1))


def resilient_run(tag, cfg, prompts, max_new, kill=False) -> dict:
    """Serve ``prompts`` through ``Serve.local(cfg)`` with the paged
    kernels' counts and the plain decode attention's calls from zero.
    With ``kill``: run until ``checkpointable``, save through an XOR
    session on a virtual cluster, close the stack, fail and recover a
    node, restore a fresh stack (its pool, allocator, pager tables and
    trie must equal the saved ones) and finish."""
    torch.cuda.reset_peak_memory_stats()
    tmp = cluster = session = None
    if kill:
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
        cluster = VirtualCluster(n_cluster=4, n_booster=4, root=tmp)
        session = ResilienceSession.for_cluster(
            cluster, strategy=Strategy.XOR, procs_per_node=2)
    out = {"stats": [], "iters": 0, "ckpt": None}
    try:
        srv = Serve.local(cfg, session=session)
        n_layers = srv.arch.n_layers
        sids = [srv.submit(p, max_new=max_new) for p in prompts]
        torch.cuda.synchronize()
        reset_launches()
        with counting_calls([(model_layers, "decode_attention")]) as calls:
            t0 = time.perf_counter()
            if kill:
                while srv.scheduler.unfinished() and not checkpointable(
                        srv.scheduler):
                    srv.step()
                if not checkpointable(srv.scheduler):
                    raise AssertionError(f"{tag}: finished before a stream "
                                         "parked off its slot")
                torch.cuda.synchronize()
                before = time.perf_counter() - t0
                out["stats"].append(dict(srv.stats))
                out["iters"] += token_iterations(srv.stats, cfg.spec_k)
                t1 = time.perf_counter()
                rec = srv.save()
                session.wait_drained()
                commit_s = time.perf_counter() - t1
                saved = serving_fingerprint(srv.scheduler)
                srv.close()
                del srv
                release()
                rank = RESILIENT["fail_rank"]
                cluster.fail(rank, NodeState.FAILED_NODE)
                cluster.recover(rank)
                session.invalidate_node(rank)
                srv = Serve.local(cfg, session=session)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                srv.restore()
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t1
                same = serving_fingerprint(srv.scheduler) == saved
                out["ckpt"] = {
                    "bytes": rec.total_bytes, "commit_s": commit_s,
                    "restore_s": restore_s, "at_step": rec.step,
                    "restored_equal": same,
                    "pool_sha256": saved.get("pool_sha256"),
                    "lanes_sha256": saved.get("lanes_sha256")}
                say(f"  {tag}: checkpoint at step {rec.step} after "
                    f"{before:.3f} s: {rec.total_bytes} bytes, commit + drain "
                    f"{commit_s:.3f} s; node {rank} failed and recovered; "
                    f"restore into a fresh stack {restore_s:.3f} s; pool / "
                    f"allocator / pager tables / trie equal to the saved: "
                    f"{same}")
                if not same:
                    raise AssertionError(f"{tag}: the restored serving state "
                                         "differs from the saved one")
                t0 = time.perf_counter()
            srv.run()
            torch.cuda.synchronize()
            out["wall"] = time.perf_counter() - t0
        out["stats"].append(dict(srv.stats))
        out["iters"] += token_iterations(srv.stats, cfg.spec_k)
        out["launches"] = pa.paged_attention.launches
        out["plain_calls"] = calls["decode_attention"]
        out["outs"] = [srv.output(s) for s in sids]
        out["n_layers"] = n_layers
        if isinstance(srv.scheduler, scheduler.PagedServeScheduler):
            pool = srv.scheduler.pool
            out["lane_bytes"] = pool.pages_per_lane * pool.page_nbytes
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        srv.close()
        del srv
    finally:
        if session is not None:
            session.close()
            cluster.teardown()
            shutil.rmtree(tmp, ignore_errors=True)
        release()
    total = {k: sum(st.get(k, 0) for st in out["stats"])
             for k in out["stats"][-1]}
    out["total"] = total
    n_tok = sum(len(o) for o in out["outs"])
    leg = (f"after the restore in {out['wall']:.3f} s" if kill else
           f"in {out['wall']:.3f} s = {n_tok / out['wall']:.2f} tok/s")
    say(f"  {tag}: {n_tok} tokens {leg}; steps={total['steps']} "
        f"prefill_calls={total['prefill_calls']} "
        f"prefill_tokens={total['prefill_tokens']} parked={total['parked']} "
        f"resumed={total['resumed']} spilled={total.get('spilled', 0)} "
        f"refilled={total.get('refilled', 0)} "
        f"prefix_hits={total['prefix_hits']} "
        f"prefill_tokens_saved={total['prefill_tokens_saved']} "
        f"kv_resume_bytes_moved={total.get('kv_resume_bytes_moved', 0)}; "
        f"paged launches {out['launches']}, plain decode attention calls "
        f"{out['plain_calls']}, token iterations {out['iters']}; peak device "
        f"memory {out['peak_gib']:.3f} GiB")
    return out


def phase13(kernels: dict) -> dict:
    say("== phase 13: resilient serving of full-size phi3-mini-3.8b (pager, "
        "prefix cache, spills, kill and restore)")
    t_phase = time.perf_counter()
    arch = serve_arch()
    prompts = resilient_requests(arch.vocab_size)
    say(f"  {N_REQUESTS} requests of {[len(p) for p in prompts]} tokens "
        f"({RESILIENT['system']} shared), max_new={MAX_NEW}, spec_k=3; "
        f"slots {SERVE['slots']}, max_len {SERVE['max_len']}, page "
        f"{SERVE['page_tokens']}, quantum {SERVE['quantum']}")
    base = dict(SERVE, spec_k=3)
    runs = {}
    runs["a"] = resilient_run("(a) plain", ServeConfig(**base), prompts,
                              MAX_NEW)
    resilient = ServeConfig(**dict(base, prefix=True,
                                   pool_pages=RESILIENT["pool_pages"]))
    runs["b"] = resilient_run("(b) resilient", resilient, prompts, MAX_NEW)
    runs["c"] = resilient_run("(c) kill and restore", resilient, prompts,
                              MAX_NEW, kill=True)
    contig = ServeConfig(**dict(SERVE, paged=False, prefix=True,
                                slots=RESILIENT["contig_slots"],
                                quantum=RESILIENT["contig_quantum"]))
    few = prompts[:RESILIENT["contig_requests"]]
    runs["d"] = resilient_run("(d) contiguous", contig, few,
                              RESILIENT["contig_max_new"])
    runs["d_kill"] = resilient_run("(d) contiguous, kill and restore", contig,
                                   few, RESILIENT["contig_max_new"], kill=True)

    failures = []
    for key in ("b", "c"):
        r, t = runs[key], runs[key]["total"]
        if r["outs"] != runs["a"]["outs"]:
            failures.append(f"({key}) tokens differ from (a)'s")
        for name in ("spilled", "refilled", "prefix_hits",
                     "prefill_tokens_saved"):
            if t[name] <= 0:
                failures.append(f"({key}) {name} = {t[name]}")
        # clean resumes move 0 KV bytes: only the refills move pages
        refills = t["refilled"] * r["lane_bytes"]
        if t["kv_resume_bytes_moved"] != refills:
            failures.append(
                f"({key}) kv_resume_bytes_moved {t['kv_resume_bytes_moved']} "
                f"!= refills x lane bytes {refills}")
        if r["launches"] != r["n_layers"] * r["iters"] or r["plain_calls"]:
            failures.append(
                f"({key}) {r['launches']} paged launches, want "
                f"{r['n_layers']} layers x {r['iters']} token iterations, and "
                f"{r['plain_calls']} plain decode attention calls, want 0")
    d, dk = runs["d"], runs["d_kill"]
    if dk["outs"] != d["outs"]:
        failures.append("(d) tokens after the kill differ from the "
                        "uninterrupted contiguous run's")
    for tag, r in (("(d)", d), ("(d) kill", dk)):
        t = r["total"]
        want = r["n_layers"] * (RESILIENT["contig_slots"] * t["steps"]
                                + t["prefill_tokens"])
        if r["launches"] or r["plain_calls"] != want:
            failures.append(f"{tag}: {r['launches']} paged launches (want 0) "
                            f"and {r['plain_calls']} plain decode attention "
                            f"calls (want {want})")
        if t["parked"] <= 0 or t["resumed"] <= 0 or t["prefix_hits"] <= 0:
            failures.append(f"{tag}: parked {t['parked']} resumed "
                            f"{t['resumed']} prefix_hits {t['prefix_hits']}")
    same_d = sum(a == b for x, y in zip(d["outs"], runs["a"]["outs"])
                 for a, b in zip(x, y))
    say(f"  (d) token agreement with (a) over their common tokens: {same_d} "
        f"(contiguous plain attention against the paged kernel at bf16; "
        f"reported, not gated)")
    seconds = time.perf_counter() - t_phase
    say(f"  phase 13 took {seconds:.1f} s")
    if failures:
        raise AssertionError("phase 13 gates failed:\n  "
                             + "\n  ".join(failures))
    say("  (b) and (c) emitted (a)'s tokens; (d) after a kill and restore "
        "emitted the uninterrupted contiguous run's")
    for key in ("b", "c"):
        kernels["paged_attention"][f"launches_phase13_{key}"] = runs[key]["launches"]
    summary = {}
    for key, r in runs.items():
        n_tok = sum(len(o) for o in r["outs"])
        summary[key] = {
            "tokens": n_tok, "wall_s": r["wall"],
            "tok_per_s": None if r["ckpt"] else n_tok / r["wall"],
            "steps": r["total"]["steps"],
            "spilled": r["total"].get("spilled", 0),
            "refilled": r["total"].get("refilled", 0),
            "prefix_hits": r["total"]["prefix_hits"],
            "prefill_tokens_saved": r["total"]["prefill_tokens_saved"],
            "kv_resume_bytes_moved": r["total"].get("kv_resume_bytes_moved", 0),
            "paged_launches": r["launches"], "plain_calls": r["plain_calls"],
            "peak_gib": r["peak_gib"], "checkpoint": r["ckpt"]}
    summary["seconds"] = seconds
    say("  phase 13 record: " + json.dumps(summary))
    return summary


# ---------------------------------------------------------------------- #
# phase 14: minicpm3-4b (MLA) and the flash kernels with Dv != D
# ---------------------------------------------------------------------- #

# minicpm3's MLA heads: qk 96 (64 nope + 32 rope), v 64, 40 heads
MLA_D, MLA_DV, MLA_HEADS = 96, 64, 40
MLA_SHAPES = {   # b, tq, tk, hq, hkv, causal; the first is the training shape
    f"minicpm3-4b B={TRAIN['batch']} T={TRAIN['seq']} (H=40, D=96, Dv=64)": (
        TRAIN["batch"], TRAIN["seq"], TRAIN["seq"], MLA_HEADS, MLA_HEADS, True),
    # non-causal, Tq != Tk, g = 4, ragged T
    "non-causal Tq=100 > Tk=77, Hq=8 over Hkv=2": (2, 100, 77, 8, 2, False),
    "causal Tq=77 < Tk=100, Hq=8 over Hkv=2": (2, 77, 100, 8, 2, True),
}
# phase 14 (e): full-size minicpm3-4b served paged with the prefix cache
MLA_SERVE = dict(arch="minicpm3-4b", full_size=True, prefix=True, slots=4,
                 max_len=80, page_tokens=16, quantum=4, device=DEVICE)
# 8 new tokens (cut from 16 for the script's time limit)
MLA_REQUESTS = dict(n=8, system=16, own=(0, 32), max_new=8)


def sdpa_dv_ms(q, k, v, dout, causal, scale) -> dict:
    """SDPA on the same inputs (no repeat: Hq = Hkv), each backend pinned
    in turn; the fastest that takes Dv != D, forward and backward, by
    CUDA events, with every backend's times and refusals printed."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dt = dout.transpose(1, 2)
    best = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        name = f"sdpa/{backend.name.lower().replace('_attention', '')}"
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                     scale=scale)
                fwd = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale), iters=20)
                bwd = time_ms(lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dt, retain_graph=True), iters=10)
        except RuntimeError as e:
            say(f"    {name} refuses Dv != D: {str(e).splitlines()[0][:90]}")
            continue
        say(f"    {name}: forward {fwd:.5f} ms, backward {bwd:.5f} ms")
        for kind, ms in (("fwd", fwd), ("bwd", bwd)):
            if kind not in best or ms < best[kind][0]:
                best[kind] = (ms, name)
        del out
    if len(best) != 2:
        raise AssertionError("no SDPA backend took Dv != D")
    return best


def phase14_kernels(sass: dict) -> dict:
    """(a): the flash kernels with V of its own width against their plain
    version (forward and backward, f32 and bf16, the f32 gradients also
    against float64), the (96, 64) instantiations' build report, and the
    times at minicpm3's training shape beside (96, 96) at the same shape,
    the bound and SDPA."""
    say("  (a) the flash kernels with Dv != D against their plain version")
    f32, bf16 = torch.float32, torch.bfloat16
    scale = MLA_D ** -0.5
    errs = {"fwd": 0.0, "bwd": 0.0}
    for label, (b, tq, tk, hq, hkv, causal) in MLA_SHAPES.items():
        for dtype in (f32, bf16):
            tol = FLASH_F32_TOL if dtype == f32 else FLASH_BF16_TOL
            bwd_tol = FLASH_BWD_F32_TOL if dtype == f32 else FLASH_BF16_TOL
            tag = f"{label} {str(dtype)[6:]}"
            q, k, v, dout = flash_inputs(b, tq, tk, hq, hkv, MLA_D, dtype,
                                         dv=MLA_DV)
            got = flash_grads(q, k, v, dout, None, causal)
            want = flash_grads(q, k, v, dout, False, causal)
            if tuple(got[0].shape) != (b, tq, hq, MLA_DV) or \
                    tuple(got[3].shape) != (b, tk, hkv, MLA_DV):
                raise AssertionError(f"{tag}: out {tuple(got[0].shape)}, dV "
                                     f"{tuple(got[3].shape)} are not Dv wide")
            errs["fwd"] = max(errs["fwd"], check_close(
                f"flash fwd {tag}", got[0], want[0], **tol))
            for name, g, w in zip(("dQ", "dK", "dV"), got[1:], want[1:]):
                errs["bwd"] = max(errs["bwd"], check_close(
                    f"flash bwd {name} {tag}", g, w, **bwd_tol))
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
            del q, k, v, dout, got, want
            release()
    pair = f"<{MLA_D},{MLA_DV}>"
    ptxas = {k: v for k, v in sass.items() if k.endswith(pair)}
    for key, e in ptxas.items():
        say(f"  {key}: {e['registers']} registers, spill stores "
            f"{e['spill_stores']} B / loads {e['spill_loads']} B, "
            f"{e['dynamic_smem_bytes']} B dynamic shared memory")

    b, t = TRAIN["batch"], TRAIN["seq"]
    h = MLA_HEADS
    q, k, v, dout = flash_inputs(b, t, t, h, h, MLA_D, bf16, dv=MLA_DV)
    q96, k96, v96, dout96 = flash_inputs(b, t, t, h, h, MLA_D, bf16)
    out, lse = fa.flash_attention_fwd(q, k, v, scale=scale)
    out96, lse96 = fa.flash_attention_fwd(q96, k96, v96, scale=scale)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    plain_out = ref.flash_attention(qr, kr, vr, scale=scale)
    say(f"  SDPA at minicpm3's training shape (D {MLA_D}, Dv {MLA_DV}):")
    lib = sdpa_dv_ms(q, k, v, dout, True, scale)
    rec = {}
    for kind in ("fwd", "bwd"):
        if kind == "fwd":
            kern = lambda: fa.flash_attention_fwd(q, k, v, scale=scale)
            square = lambda: fa.flash_attention_fwd(q96, k96, v96, scale=scale)
            plain = lambda: ref.flash_attention(q, k, v, scale=scale)
        else:
            kern = lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                                  scale=scale)
            square = lambda: fa.flash_attention_bwd(q96, k96, v96, out96, lse96,
                                                    dout96, scale=scale)
            plain = lambda: torch.autograd.grad(plain_out, (qr, kr, vr), dout,
                                                retain_graph=True)
        # (96, 64) and (96, 96) in turns, twice each
        ms, sq = [], []
        for _ in range(2):
            ms.append(time_ms(kern, iters=50))
            sq.append(time_ms(square, iters=50))
        plain_ms = time_ms(plain, iters=10, warmup=2)
        bound, bound_by = flash_bound_ms(b, t, t, h, h, MLA_D, 2,
                                         backward=kind == "bwd", dv=MLA_DV)
        name = f"flash_attention_{kind}"
        rec[name] = {"ms": min(ms), "kernel_ms": min(ms), "ms_runs": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": lib[kind][0],
                     "library": lib[kind][1], "max_abs_err": errs[kind],
                     "square_96_ms": min(sq), "square_96_ms_runs": sq,
                     "shape": {"B": b, "T": t, "Hq": h, "Hkv": h, "D": MLA_D,
                               "Dv": MLA_DV, "dtype": "bfloat16",
                               "causal": True},
                     "sass": {k: v for k, v in ptxas.items()
                              if (k.startswith("fwd") == (kind == "fwd"))}}
        say(f"  {name} (96, 64) at minicpm3's training shape: kernel "
            f"{min(ms):.5f} ms (runs {', '.join(f'{x:.5f}' for x in ms)}); "
            f"(96, 96) at the same B, T, H {min(sq):.5f} ms; plain "
            f"{plain_ms:.5f} ms; {lib[kind][1]} {lib[kind][0]:.5f} ms; bound "
            f"{bound:.5f} ms ({bound_by})")
    del q, k, v, dout, q96, k96, v96, dout96, out, lse, out96, lse96
    del qr, kr, vr, plain_out
    release()
    return rec


def mla_requests(vocab: int):
    rng = np.random.default_rng(SEED + 14)
    r = MLA_REQUESTS
    system = rng.integers(0, vocab, size=r["system"]).tolist()
    lo, hi = r["own"]
    return [system + rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))
                                  ).tolist() for _ in range(r["n"])]


def phase14(sass: dict) -> dict:
    say("== phase 14: minicpm3-4b (MLA): the flash kernels with Dv != D, "
        "full-depth prefill, training with a node kill, paged serving")
    t_phase = time.perf_counter()
    out = {"kernels": phase14_kernels(sass)}
    # (b) full-depth prefill, (c) float32 kernel path, (d) training
    out["family"] = phase_family(14, "minicpm3-4b",
                                 ("flash_attention_fwd", "flash_attention_bwd"))

    # (e) paged serving of full-size minicpm3-4b, spec_k 3 and 0
    arch = get_config(MLA_SERVE["arch"])
    prompts = mla_requests(arch.vocab_size)
    say(f"  (e) Serve.local, paged, prefix cache: {len(prompts)} requests of "
        f"{[len(x) for x in prompts]} tokens ({MLA_REQUESTS['system']} shared), "
        f"max_new={MLA_REQUESTS['max_new']}; slots {MLA_SERVE['slots']}, "
        f"max_len {MLA_SERVE['max_len']}, page {MLA_SERVE['page_tokens']}")
    runs = {}
    for spec_k in (3, 0):
        reset_family_launches()
        with counting_calls([(ref, "flash_attention")]) as plain:
            runs[spec_k] = resilient_run(
                f"spec_k={spec_k}", ServeConfig(spec_k=spec_k, **MLA_SERVE),
                prompts, MLA_REQUESTS["max_new"])
        launches = family_launches()
        if any(launches.values()) or runs[spec_k]["launches"] or any(plain.values()):
            raise AssertionError(f"MLA serving launched {launches}, paged "
                                 f"{runs[spec_k]['launches']}, plain flash "
                                 f"{plain}: its decode attends in latent space")
    if runs[3]["outs"] != runs[0]["outs"]:
        raise AssertionError("minicpm3-4b: spec_k=3 and spec_k=0 emitted "
                             "different tokens")
    t3 = runs[3]["total"]
    if t3["prefix_hits"] <= 0:
        raise AssertionError("minicpm3-4b serving: no prefix hit")
    say("  (e) spec_k=3 and spec_k=0 emitted identical tokens (latent-space "
        "decode: plain einsums, no kernel launch)")
    serve = {}
    for spec_k, r in runs.items():
        n_tok = sum(len(o) for o in r["outs"])
        serve[f"spec_k={spec_k}"] = {
            "tokens": n_tok, "wall_s": r["wall"], "tok_per_s": n_tok / r["wall"],
            "token_iterations": r["iters"], "steps": r["total"]["steps"],
            "spec_accepted": r["total"].get("spec_accepted", 0),
            "prefix_hits": r["total"]["prefix_hits"], "peak_gib": r["peak_gib"],
            "digest": hashlib.sha256(json.dumps(r["outs"]).encode()
                                     ).hexdigest()[:16]}
    out["serve"] = serve
    out["seconds"] = time.perf_counter() - t_phase
    say(f"  phase 14 record: {json.dumps(serve)}; took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------- #
# phase 15: deepseek-moe-16b (MoE)
# ---------------------------------------------------------------------- #

MOE_ARCH = "deepseek-moe-16b"
MOE_SERVE = dict(arch=MOE_ARCH, full_size=True, paged=False, prefix=True,
                 slots=2, max_len=48, page_tokens=16, quantum=2, device=DEVICE)
# 4 requests of 16-32 prompt tokens: a shared 16-token page, then 0-16
# of their own
MOE_REQUESTS = dict(n=4, system=16, own=(0, 16), max_new=8)


def train_twice(cfg, model, tag: str) -> dict:
    """Two uninterrupted training runs under deterministic algorithms,
    each with the flash kernels' launches counted from zero and the plain
    and library attention's calls counted; their final states must be the
    same bytes."""
    n_params = sum(p.numel() for p in tree_leaves(model.param_shapes(cfg)))
    kinds = (f" (1 dense, {cfg.n_layers - cfg.moe.n_dense_layers} MoE)"
             if cfg.moe is not None else "")
    inputs = {k: v.shape for k, v in ModalPipeline(
        cfg, FAMILY["batch"], text_len(cfg, FAMILY["seq"])).batch_at(0).items()}
    say(f"  {tag} training: published width, depth cut "
        f"{get_config(cfg.name).n_layers} -> {cfg.n_layers} layers{kinds}, "
        f"{n_params} parameters ({3 * 4 * n_params} bytes of params + m + v); "
        f"inputs {inputs}, {FAMILY['steps']} steps, twice, deterministic "
        f"algorithms")
    torch.use_deterministic_algorithms(True)
    runs = []
    try:
        for i in range(2):
            torch.cuda.reset_peak_memory_stats()
            reset_family_launches()
            with counting_calls(PLAIN_SCANS[2:]) as plain:
                manifest, losses, walls, auxes = clean_sha(cfg, model)
            launches = family_launches()
            runs.append((manifest, losses, walls, auxes, launches, dict(plain),
                         torch.cuda.max_memory_allocated()))
            steps = sorted(walls[1:])
            say(f"  run {i + 1}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
                f"router_aux {[round(a, 5) for a in auxes]}; step median "
                f"{1e3 * steps[len(steps) // 2]:.1f} ms (first "
                f"{1e3 * walls[0]:.1f} ms); flash launches "
                f"{launches['flash_attention_fwd']} / "
                f"{launches['flash_attention_bwd']}; plain calls {plain}; "
                f"peak {runs[-1][6] / 2**30:.3f} GiB; sha256 "
                f"{manifest['sha256'][:16]}..")
    finally:
        torch.use_deterministic_algorithms(False)
    (m1, l1, _, a1, n1, p1, _), (m2, *_rest) = runs
    want = {"flash_attention_fwd": 2 * cfg.n_layers * FAMILY["steps"],
            "flash_attention_bwd": 3 * cfg.n_layers * FAMILY["steps"]}
    for r in runs:
        if {k: r[4][k] for k in want} != want or any(r[5].values()):
            raise AssertionError(f"flash launches {r[4]} (want {want}), plain "
                                 f"calls {r[5]}")
    if not l1[-1] < l1[0]:
        raise AssertionError("the loss did not fall")
    if (m1["sha256"], m1["total_bytes"]) != (m2["sha256"], m2["total_bytes"]):
        raise AssertionError("two deterministic runs ended on different state "
                             "bytes")
    say(f"  both runs' final states byte-identical: sha256 "
        f"{m1['sha256'][:16]}.. over {m1['total_bytes']} bytes")
    steps = sorted(runs[0][2][1:])
    return {"launches": n1, "router_aux": a1, "losses": l1,
            "step_ms": 1e3 * steps[len(steps) // 2], "sha256": m1["sha256"],
            "state_bytes": m1["total_bytes"], "peak_bytes": runs[0][6],
            "main_path": {"arch": cfg.name, "layers": cfg.n_layers,
                          "layers_published": get_config(cfg.name).n_layers,
                          "batch": FAMILY["batch"], "seq": FAMILY["seq"],
                          "steps_run": FAMILY["steps"]}}


def moe_slot_step(cfg: ServeConfig) -> dict:
    """The contiguous path's unit of work, one batch-1 ``decode_step`` of
    the full model as served (bf16 weights): its device time (the sum of
    its kernels' durations in a profiler trace; not measured where the
    profiler returns no records), its host-clock time, and CUDA events over
    calls queued behind a sleep (a step launches more kernels than the
    card's launch queue holds, so the host's launch rate shows in them),
    beside the least time to read the weights it reads (every leaf but the
    embedding table, of which one row)."""
    srv = Serve.local(cfg)
    arch, model, params = srv.arch, srv.model, srv.scheduler.params
    lane = model.init_cache(arch, 1, cfg.max_len, device=DEVICE)
    tok = torch.tensor([1], device=DEVICE)
    nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    embed = params["embed"]
    nbytes += embed[0].numel() * embed.element_size() - embed.numel() * embed.element_size()
    step = lambda: model.decode_step(params, lane, tok, 5, arch)
    with torch.inference_mode():
        events_ms = time_ms(step, iters=10, warmup=2, max_sleep_s=5.0)
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / 5
        try:
            dev = device_time(step, reps=3, traces=3)
            dev_ms, dev_launches = dev.ms, dev.launches
        except AssertionError as e:   # the profiler returned no records
            dev_ms = dev_launches = None
            say(f"  (device trace: {e}; reported as not measured)")
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    srv.close()
    del srv, params, lane, model
    release()
    share = "not measured" if dev_ms is None else f"{bound / dev_ms:.1%}"
    say(f"  one slot-step (batch-1 decode_step, {arch.n_layers} layers, every "
        f"expert): {dev_ms} ms of kernels on the card in a trace "
        f"({dev_launches} device activities; the bound is {share} of it), "
        f"{host_ms:.3f} ms on the host clock, {events_ms:.3f} ms by queued "
        f"CUDA events (held to the host's launch rate); weight reads {nbytes} "
        f"bytes, bound {bound:.3f} ms")
    return {"ms": dev_ms, "launches": dev_launches, "host_ms": host_ms,
            "events_ms": events_ms, "bound_ms": bound, "weight_bytes": nbytes}


def phase15() -> dict:
    say(f"== phase 15: {MOE_ARCH} (MoE): full-depth prefill, training twice, "
        "contiguous serving with a save and restore")
    t_phase = time.perf_counter()
    out = {"prefill": prefill_full_depth(MOE_ARCH, ("flash_attention_fwd",))}
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              n_layers=FAMILY["layers"][MOE_ARCH])
    model = get_model(cfg)
    out["f32_logits_err"] = check_kernel_path_f32(cfg, model)
    out["train"] = train_twice(cfg, model, "(c)")

    # (d) contiguous serving at full size, uninterrupted, then through a
    # serving save and a restore into a fresh Serve.local
    serve_cfg = ServeConfig(**MOE_SERVE)
    rng = np.random.default_rng(SEED + 15)
    system = rng.integers(0, cfg.vocab_size, size=MOE_REQUESTS["system"]).tolist()
    lo, hi = MOE_REQUESTS["own"]
    prompts = [system + rng.integers(0, cfg.vocab_size,
                                     size=int(rng.integers(lo, hi + 1))).tolist()
               for _ in range(MOE_REQUESTS["n"])]
    say(f"  (d) Serve.local(paged=False), prefix cache: {len(prompts)} requests "
        f"of {[len(x) for x in prompts]} tokens, max_new="
        f"{MOE_REQUESTS['max_new']}; slots {MOE_SERVE['slots']}, quantum "
        f"{MOE_SERVE['quantum']}")
    slot = moe_slot_step(serve_cfg)
    clean = resilient_run("(d) contiguous", serve_cfg, prompts,
                          MOE_REQUESTS["max_new"])
    killed = resilient_run("(d) save and restore", serve_cfg, prompts,
                           MOE_REQUESTS["max_new"], kill=True)
    if killed["outs"] != clean["outs"]:
        raise AssertionError("deepseek-moe-16b: the tokens after a serving "
                             "restore differ from the uninterrupted run's")
    t = clean["total"]
    units = MOE_SERVE["slots"] * t["steps"] + t["prefill_tokens"]
    n_tok = sum(len(o) for o in clean["outs"])
    serve = {"tokens": n_tok, "wall_s": clean["wall"],
             "tok_per_s": n_tok / clean["wall"],
             "slot_steps": units, "wall_ms_per_slot_step": 1e3 * clean["wall"] / units,
             "device_ms_per_slot_step": slot["ms"],
             "device_activities_per_slot_step": slot["launches"],
             "host_ms_per_slot_step": slot["host_ms"],
             "events_ms_per_slot_step": slot["events_ms"],
             "weight_read_bound_ms": slot["bound_ms"],
             "parked": t["parked"], "resumed": t["resumed"],
             "prefix_hits": t["prefix_hits"],
             "peak_gib": clean["peak_gib"], "checkpoint": killed["ckpt"],
             "digest": hashlib.sha256(json.dumps(clean["outs"]).encode()
                                      ).hexdigest()[:16]}
    if t["parked"] <= 0 or t["prefix_hits"] <= 0 or killed["ckpt"] is None \
            or not killed["ckpt"]["restored_equal"]:
        raise AssertionError(f"(d) parked {t['parked']}, prefix hits "
                             f"{t['prefix_hits']}, checkpoint {killed['ckpt']}")
    say(f"  (d) the same tokens after the save and restore; {n_tok} tokens in "
        f"{clean['wall']:.3f} s = {serve['tok_per_s']:.2f} tok/s, "
        f"{serve['wall_ms_per_slot_step']:.2f} ms per slot-step on the host "
        f"clock ({units} = {MOE_SERVE['slots']} slots x {t['steps']} steps + "
        f"{t['prefill_tokens']} prefill tokens); one slot-step {slot['ms']} ms "
        f"on the card against the {slot['bound_ms']:.3f} ms weight-read bound, "
        f"{slot['host_ms']:.3f} ms on the host clock")
    out["serve"] = serve
    out["seconds"] = time.perf_counter() - t_phase
    say(f"  phase 15 record: {json.dumps(serve)}; took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------- #
# phase 16: whisper-tiny and paligemma-3b; the flash kernels at D 256 and
# with the prefix-LM mask
# ---------------------------------------------------------------------- #

PALI_ARCH, WHISPER_ARCH = "paligemma-3b", "whisper-tiny"
WHISPER_TEXT = 448        # whisper's decoder context (its max target positions)
# b, tq, tk, hq, hkv, d, causal, prefix_len; the timed ones are named in
# PHASE16_TIMED
PHASE16_SHAPES = {
    "paligemma-3b B=4 T=512 (256 patches + 256 text; Hq=8 over 1, D=256), "
    "prefix 256": (4, 512, 512, 8, 1, 256, True, 256),
    "paligemma-3b B=4 T=512, no prefix": (4, 512, 512, 8, 1, 256, True, 0),
    "paligemma-3b T=200, prefix 77": (2, 200, 200, 8, 1, 256, True, 77),
    "whisper-tiny encoder B=4 T=1500 (H=6, D=64), non-causal": (
        4, 1500, 1500, 6, 6, 64, False, 0),
    f"whisper-tiny cross-attention Tq={WHISPER_TEXT} over Tk=1500, non-causal": (
        4, WHISPER_TEXT, 1500, 6, 6, 64, False, 0),
}
PHASE16_TIMED = {   # record key -> shape label
    "paligemma": next(iter(PHASE16_SHAPES)),
    "whisper_encoder": list(PHASE16_SHAPES)[3],
    "whisper_cross": list(PHASE16_SHAPES)[4],
}
PHASE16_SERVE = dict(full_size=True, paged=False, prefix=True, slots=2,
                     max_len=48, page_tokens=16, quantum=2, device=DEVICE)
PHASE16_REQUESTS = dict(n=4, system=16, own=(0, 16), max_new=8)
# the reference's refusal of a paged scheduler for a snapshot family
PAGED_REFUSAL = ("model family {!r} has no paged_decode_step (snapshot-state "
                 "families cannot decode through page tables)")


def prefix_mask(tq, tk, prefix_len, device):
    """(Tq, Tk) booleans, True where a key is visible: causal from Tk - Tq
    on, and every key below the prefix."""
    q_pos = torch.arange(tq, device=device)[:, None] + (tk - tq)
    k_pos = torch.arange(tk, device=device)[None, :]
    return (k_pos <= q_pos) | (k_pos < prefix_len)


def sdpa_best_ms(q, k, v, dout, causal, prefix_len) -> dict:
    """SDPA on the same inputs, each backend pinned in turn, kv heads given
    as they are (``enable_gqa``) and repeated over their groups; a causal
    call with a prefix passes its visibility as a boolean mask.  The
    fastest forms that take the call, forward and backward, by CUDA
    events, with every form's times and refusals printed."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    dt = dout.transpose(1, 2)
    kw = {}
    if causal and prefix_len:
        kw["attn_mask"] = prefix_mask(q.shape[1], k.shape[1], prefix_len,
                                      q.device)
    elif causal:
        kw["is_causal"] = True
    forms = {"": dict(enable_gqa=g > 1)}
    if g > 1:
        forms["+repeat"] = {}
    best = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        for form, extra in forms.items():
            name = f"sdpa/{backend.name.lower().replace('_attention', '')}{form}"
            rep = 1 if form == "" else g
            kt, vt = (x.transpose(1, 2).repeat_interleave(rep, dim=1).detach()
                      .requires_grad_() for x in (k, v))
            call = lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw,
                                                          **extra)
            try:
                with sdpa_kernel(backend):
                    out = call()
                    fwd = time_ms(call, iters=20, warmup=3)
                    bwd = time_ms(lambda: torch.autograd.grad(
                        out, (qt, kt, vt), dt, retain_graph=True),
                        iters=10, warmup=2)
            except RuntimeError as e:
                say(f"    {name} refuses: {str(e).splitlines()[0][:90]}")
                continue
            say(f"    {name}: forward {fwd:.5f} ms, backward {bwd:.5f} ms")
            for kind, ms in (("fwd", fwd), ("bwd", bwd)):
                if kind not in best or ms < best[kind][0]:
                    best[kind] = (ms, name)
            del out
    if len(best) != 2:
        raise AssertionError("no SDPA backend took the call")
    return best


def phase16_kernels() -> dict:
    """(a): the flash kernels at paligemma's and whisper's shapes against
    their plain version (the f32 gradients also against float64), two bf16
    launches bit-identical, and the times at the three training shapes
    beside the bound, the plain version and the fastest SDPA form."""
    say("  (a) the flash kernels at D 256 with the prefix-LM mask and at "
        "whisper's shapes, against their plain version")
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {}
    for label, (b, tq, tk, hq, hkv, d, causal, pl) in PHASE16_SHAPES.items():
        key = "256" if d == 256 else "whisper"
        for dtype in (f32, bf16):
            tol = FLASH_F32_TOL if dtype == f32 else FLASH_BF16_TOL
            bwd_tol = FLASH_BWD_F32_TOL if dtype == f32 else FLASH_BF16_TOL
            tag = f"{label} {str(dtype)[6:]}"
            q, k, v, dout = flash_inputs(b, tq, tk, hq, hkv, d, dtype)
            got = flash_grads(q, k, v, dout, None, causal, pl)
            want = flash_grads(q, k, v, dout, False, causal, pl)
            errs[f"fwd_{key}"] = max(errs.get(f"fwd_{key}", 0.0), check_close(
                f"flash fwd {tag}", got[0], want[0], **tol))
            for name, g_, w in zip(("dQ", "dK", "dV"), got[1:], want[1:]):
                errs[f"bwd_{key}"] = max(errs.get(f"bwd_{key}", 0.0), check_close(
                    f"flash bwd {name} {tag}", g_, w, **bwd_tol))
            if dtype == f32:
                exact = flash_grads(q.double(), k.double(), v.double(),
                                    dout.double(), False, causal, pl)
                dist = lambda xs: max((x.double() - e).abs().max().item()
                                      for x, e in zip(xs, exact[1:]))
                kern_d, plain_d = dist(got[1:]), dist(want[1:])
                say(f"    distance to float64, dQ/dK/dV: kernel {kern_d:.3e}, "
                    f"plain {plain_d:.3e} (limit max(plain, {FLASH_F64_ATOL}))")
                if kern_d > max(plain_d, FLASH_F64_ATOL):
                    raise AssertionError(f"flash bwd {tag}: the kernel lies "
                                         f"{kern_d:.3e} from float64")
                del exact
            del q, k, v, dout, got, want
            release()

    rec = {}
    for key, label in PHASE16_TIMED.items():
        b, tq, tk, hq, hkv, d, causal, pl = PHASE16_SHAPES[label]
        q, k, v, dout = flash_inputs(b, tq, tk, hq, hkv, d, bf16)
        fwd = [fa.flash_attention_fwd(q, k, v, causal, None, pl) for _ in range(2)]
        bwd = [fa.flash_attention_bwd(q, k, v, *fwd[0], dout, causal, None, pl)
               for _ in range(2)]
        same = {n: torch.equal(x, y) for n, x, y in zip(
            ("out", "lse", "dq", "dk", "dv"), fwd[0] + bwd[0], fwd[1] + bwd[1])}
        say(f"  bf16 repeats bit-identical at {label}: {same}")
        if not all(same.values()):
            raise AssertionError(f"the bf16 flash kernels did not repeat at "
                                 f"{label}: {same}")
        out, lse = fwd[0]
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        plain_out = ref.flash_attention(qr, kr, vr, causal=causal, prefix_len=pl)
        say(f"  SDPA at {label}:")
        lib = sdpa_best_ms(q, k, v, dout, causal, pl)
        timed = {
            "fwd": (lambda: fa.flash_attention_fwd(q, k, v, causal, None, pl),
                    lambda: ref.flash_attention(q, k, v, causal=causal,
                                                prefix_len=pl)),
            "bwd": (lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                                   causal, None, pl),
                    lambda: torch.autograd.grad(plain_out, (qr, kr, vr), dout,
                                                retain_graph=True)),
        }
        for kind, (kern, plain) in timed.items():
            ms = time_ms(kern, iters=50)
            plain_ms = time_ms(plain, iters=10, warmup=2)
            bound, bound_by = flash_bound_ms(b, tq, tk, hq, hkv, d, 2,
                                             backward=kind == "bwd",
                                             causal=causal, prefix_len=pl)
            rec.setdefault(key, {})[kind] = {
                "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "library_ms": lib[kind][0], "library": lib[kind][1],
                "max_abs_err": errs[f"{kind}_{'256' if d == 256 else 'whisper'}"],
                "shape": {"B": b, "Tq": tq, "Tk": tk, "Hq": hq, "Hkv": hkv,
                          "D": d, "dtype": "bfloat16", "causal": causal,
                          "prefix_len": pl}}
            say(f"  flash_attention_{kind} at {label}: kernel {ms:.5f} ms, "
                f"plain {plain_ms:.5f} ms, {lib[kind][1]} {lib[kind][0]:.5f} "
                f"ms, bound {bound:.5f} ms ({bound_by})")
        del q, k, v, dout, fwd, bwd, out, lse, qr, kr, vr, plain_out, timed
        release()
    return rec


def phase16_serve(arch: str) -> dict:
    """(e): ``Serve.local(paged=False)`` at full size, uninterrupted and
    through a save, a node kill and a restore: the same tokens, decode
    attention through ``layers.decode_attention`` (no flash, no paged
    kernel, no plain flash); the paged scheduler refused as the reference
    refuses it."""
    cfg = ServeConfig(arch=arch, **PHASE16_SERVE)
    vocab = get_config(arch).vocab_size
    rng = np.random.default_rng(SEED + 16)
    system = rng.integers(0, vocab, size=PHASE16_REQUESTS["system"]).tolist()
    lo, hi = PHASE16_REQUESTS["own"]
    prompts = [system + rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))
                                     ).tolist()
               for _ in range(PHASE16_REQUESTS["n"])]
    say(f"  (e) {arch}: Serve.local(paged=False), prefix cache: {len(prompts)} "
        f"requests of {[len(x) for x in prompts]} tokens, max_new="
        f"{PHASE16_REQUESTS['max_new']}; slots {cfg.slots}, quantum "
        f"{cfg.quantum}")
    runs = {}
    for kill in (False, True):
        reset_family_launches()
        with counting_calls(PLAIN_SCANS[2:]) as plain:
            runs[kill] = resilient_run(
                f"(e) {arch}" + (", save and restore" if kill else ""), cfg,
                prompts, PHASE16_REQUESTS["max_new"], kill=kill)
        runs[kill]["flash"] = family_launches()
        runs[kill]["plain_flash"] = dict(plain)
    clean, killed = runs[False], runs[True]
    per_token = 2 if get_config(arch).family == "encdec" else 1
    failures = []
    if killed["outs"] != clean["outs"]:
        failures.append("the tokens after the restore differ")
    for tag, r in (("uninterrupted", clean), ("restored", killed)):
        t = r["total"]
        want = per_token * r["n_layers"] * (cfg.slots * t["steps"]
                                            + t["prefill_tokens"])
        if r["launches"] or any(r["flash"].values()) \
                or any(r["plain_flash"].values()) or r["plain_calls"] != want:
            failures.append(
                f"{tag}: paged launches {r['launches']}, flash {r['flash']}, "
                f"plain flash / SDPA {r['plain_flash']}, decode attention "
                f"calls {r['plain_calls']} (want {want})")
        if t["parked"] <= 0 or t["prefix_hits"] <= 0:
            failures.append(f"{tag}: parked {t['parked']}, prefix hits "
                            f"{t['prefix_hits']}")
    if killed["ckpt"] is None or not killed["ckpt"]["restored_equal"]:
        failures.append(f"checkpoint {killed['ckpt']}")
    try:
        Serve.local(dataclasses.replace(cfg, paged=True, full_size=False))
    except ValueError as e:
        refusal = str(e)
    else:
        refusal = None
    if refusal != PAGED_REFUSAL.format(get_config(arch).family):
        failures.append(f"paged=True: {refusal!r}")
    if failures:
        raise AssertionError(f"phase 16 (e) {arch}: " + "; ".join(failures))
    t = clean["total"]
    units = cfg.slots * t["steps"] + t["prefill_tokens"]
    n_tok = sum(len(o) for o in clean["outs"])
    rec = {"tokens": n_tok, "wall_s": clean["wall"],
           "tok_per_s": n_tok / clean["wall"], "slot_steps": units,
           "wall_ms_per_slot_step": 1e3 * clean["wall"] / units,
           "decode_attention_calls": clean["plain_calls"],
           "parked": t["parked"], "resumed": t["resumed"],
           "prefix_hits": t["prefix_hits"], "peak_gib": clean["peak_gib"],
           "checkpoint": killed["ckpt"], "paged_refusal": refusal,
           "digest": hashlib.sha256(json.dumps(clean["outs"]).encode()
                                    ).hexdigest()[:16]}
    say(f"  (e) {arch}: the same tokens after the save and restore; {n_tok} "
        f"tokens in {clean['wall']:.3f} s = {rec['tok_per_s']:.2f} tok/s, "
        f"{rec['wall_ms_per_slot_step']:.2f} ms per slot-step on the host clock "
        f"({units} = {cfg.slots} slots x {t['steps']} steps + "
        f"{t['prefill_tokens']} prefill tokens); paged=True refused: "
        f"{refusal}")
    return rec


def phase16() -> dict:
    say("== phase 16: whisper-tiny and paligemma-3b: the flash kernels at D "
        "256 and with the prefix-LM mask, paligemma's full-depth prefill and "
        "training, whisper's training with a node kill, contiguous serving")
    t_phase = time.perf_counter()
    out = {"kernels": phase16_kernels()}
    say(f"  (b) {PALI_ARCH} at full depth")
    out["prefill"] = prefill_full_depth(PALI_ARCH, ("flash_attention_fwd",))
    cfg = dataclasses.replace(get_config(PALI_ARCH),
                              n_layers=FAMILY["layers"][PALI_ARCH])
    model = get_model(cfg)
    out["f32_logits_err"] = check_kernel_path_f32(cfg, model)
    out["train"] = train_twice(cfg, model, "(c)")
    say(f"  (d) {WHISPER_ARCH} at full size")
    out["whisper"] = phase_family(16, WHISPER_ARCH, ("flash_attention_fwd",
                                                     "flash_attention_bwd"),
                                  seq=WHISPER_TEXT)
    out["serve"] = {arch: phase16_serve(arch)
                    for arch in (WHISPER_ARCH, PALI_ARCH)}
    out["seconds"] = time.perf_counter() - t_phase
    say(f"  phase 16 record: {json.dumps(out['serve'])}; took "
        f"{out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------- #
# phase 17: the serving fleet (workers in their own CUDA processes)
# ---------------------------------------------------------------------- #

# fig12's and fig13's set-ups (benchmarks/fig12_fleet_scaling.py,
# fig13_elastic_fleet.py) with full-width phi3-mini-3.8b workers: (a) slots
# 2, page 4, max_len 32, quantum 3; (b) the same over max_len 256 with an
# epoch checkpoint every 4 steps and heartbeats of 0.05 s (timeout 0.3 s)
FLEET = dict(arch="phi3-mini-3.8b", full_size=True, device=DEVICE, slots=2,
             page_tokens=4, quantum=3)
FLEET_A = dict(FLEET, max_len=32)
FLEET_B = dict(FLEET, max_len=256, ckpt_every=4, hb_interval_s=0.05,
               hb_timeout_s=0.3)
# fig13 --smoke decodes 160 new tokens a stream; cut to 64 to keep the
# script inside its time limit (the kill lands after the first epoch, a
# few tokens in, either way)
FLEET_RUN = dict(requests=8, shared=9, max_new=4,     # fig12 --smoke
                 reps=5,            # the 1- and 2-worker batches, repeated
                 criterion_prefix=12, noisy=6, quiet=3,
                 streams=4, elastic_max_new=64,       # fig13 --smoke: 160
                 survivor_slack_s=4.0, recovery_slack_s=8.0,
                 quiet_p99_s=1.0, speedup=1.5, timeout_s=300.0,
                 draw=1000)                           # tokens drawn below


def fleet_prompts(rng, n, shared_len, lo=3, hi=7):
    """fig12's and fig13's prompt generator: a shared system prompt and a
    tail of lo .. hi - 1 tokens of each request's own."""
    top = FLEET_RUN["draw"]
    sysp = rng.integers(0, top, size=shared_len).tolist()
    return [sysp + rng.integers(0, top, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def run_direct(w, rid, prompt, max_new, timeout):
    """One request straight through a worker's pipe (no front-end)."""
    w.submit(rid, prompt, max_new=max_new)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for m in w.messages():
            if m.get("op") == "done" and m["rid"] == rid:
                return m["tokens"]
        time.sleep(0.005)
    raise TimeoutError(f"request {rid} never finished")


def fleet_throughput(fe, prompts, max_new, timeout, warm: bool) -> dict:
    """fig12's scaling measurement on one fleet: with ``warm``, a warm-up
    request per worker first; then every prompt; tokens over the wall and
    over the critical path (the busiest worker's host CPU seconds)."""
    if warm:
        fe.wait([fe.submit(prompts[i % len(prompts)], max_new=1)
                 for i in range(len(fe.workers))], timeout=timeout)
    cpu0 = [s["cpu_s"] for s in fe.worker_stats()]
    t0 = time.perf_counter()
    rids = [fe.submit(p, max_new=max_new) for p in prompts]
    fe.wait(rids, timeout=timeout)
    wall = time.perf_counter() - t0
    emitted = sum(len(fe.result(r)) for r in rids)
    stats = fe.worker_stats()
    cpu = max(s["cpu_s"] - c for s, c in zip(stats, cpu0))
    return {"workers": len(fe.workers), "tokens": emitted, "wall_s": wall,
            "tok_per_s": emitted / wall, "critical_path_s": cpu,
            "critical_path_tok_per_s": emitted / cpu,
            "prefill_tokens_saved": sum(s["scheduler"]["prefill_tokens_saved"]
                                        for s in stats)}


def worker_kernels(fe, n_layers, failures, only=None) -> list:
    """(c) each live worker's decode held to the paged kernel: its launches
    since ``ready`` (``kernel_counts`` in its stats reply) = layers x its
    token iterations, and no plain decode attention call.  ``only``
    limits the check to those workers' indices."""
    out = []
    for wi, w in enumerate(fe.workers):
        if (only is not None and wi not in only) or fe.worker_state(wi) == "dead":
            continue
        st = w.stats()
        k, s = st["kernels"], st["scheduler"]
        iters = s["prefill_calls"] * scheduler.PREFILL_BUCKET + s["steps"]
        rec = {"worker": w.spec.name, "paged_launches": k["paged_attention"],
               "token_iterations": iters, "plain_calls": k["decode_attention"],
               "quant_launches": k["paged_attention_quant"]}
        say(f"  (c) worker {w.spec.name} (pid {w.proc.pid}): paged launches "
            f"{rec['paged_launches']} = {n_layers} layers x {iters} token "
            f"iterations: {rec['paged_launches'] == n_layers * iters}; plain "
            f"decode attention calls {rec['plain_calls']}")
        if (iters <= 0 or rec["paged_launches"] != n_layers * iters
                or rec["plain_calls"] or rec["quant_launches"]):
            failures.append(f"(c) worker {w.spec.name}: {rec}, want "
                            f"{n_layers} x {iters} paged launches only")
        out.append(rec)
    return out


def inter_token_gaps(stamps, t_from):
    """fig13's gaps: the arrival gaps from the last arrival at or before
    ``t_from`` on (so the gap across it is the first)."""
    pre = [t for t in stamps if t <= t_from]
    post = [t for t in stamps if t > t_from]
    pts = (pre[-1:] if pre else [t_from]) + post
    return [b - a for a, b in zip(pts, pts[1:])]


def fleet_elastic(fe, prompts, oracle, max_new, n_layers, failures) -> dict:
    """fig13 on one fleet: every prompt submitted, worker 0 SIGKILLed once
    its epoch record (after the submit) is on the board and each of its
    streams has emitted at least one token and not all; the streams run
    to the end on the survivor."""
    from repro_torch.serve.fleet import PrefixBoard
    from repro_torch.serve.fleet.board import record_kind

    n_workers = len(fe.workers)
    victim = 0
    name0 = fe.workers[victim].spec.name
    warm = [fe.submit(prompts[i % len(prompts)], max_new=1)
            for i in range(n_workers)]
    fe.wait(warm, timeout=FLEET_RUN["timeout_s"])
    board = PrefixBoard(fe.workers[0].spec.shared_root)
    board.poll()                           # the warm-up's records
    t_submit = time.time()
    rids = [fe.submit(p, max_new=max_new) for p in prompts]
    arrivals = {r: [] for r in rids}
    seen = {r: 0 for r in rids}
    victims, migrated, t_kill, epoch_seen, counts = [], [], None, False, []
    deadline = time.monotonic() + FLEET_RUN["timeout_s"]
    while not all(seen[r] >= max_new for r in rids):
        if time.monotonic() > deadline:
            raise TimeoutError(f"the elastic run stalled: {seen}")
        fe.pump()
        now = time.perf_counter()
        for r in rids:
            n = len(fe.progress(r))
            if n > seen[r]:
                arrivals[r].extend([now] * (n - seen[r]))
                seen[r] = n
        if t_kill is None:
            victims = victims or [r for r in rids if fe.assignment(r) == victim]
            epoch_seen = epoch_seen or any(
                record_kind(rec) == "epoch" and rec.get("worker") == name0
                and rec.get("t", 0.0) >= t_submit for rec in board.poll())
            if victims and epoch_seen and all(1 <= seen[r] < max_new
                                              for r in victims):
                migrated = list(victims)
                counts = worker_kernels(fe, n_layers, failures, only=[victim])
                fe.workers[victim].kill()
                t_kill = time.perf_counter()
                say(f"  (b) SIGKILLed {name0} with streams {migrated} at "
                    f"{[seen[r] for r in migrated]} of {max_new} tokens")
        time.sleep(0.002)
    if t_kill is None or not migrated:
        raise AssertionError("(b) the kill never fired (no epoch record, or "
                             "no unfinished stream on the victim)")
    # a stream's last tokens can reach the front-end a pump before its
    # "done"
    fe.wait(rids, timeout=FLEET_RUN["timeout_s"])
    outs = [fe.result(r) for r in rids]
    counts += worker_kernels(fe, n_layers, failures)
    stats = dict(fe.stats.items())
    states = [fe.worker_state(i) for i in range(n_workers)]
    post = fe.postmortem(victim, last=64)
    names = sorted({r.get("name") for r in post["records"] if r.get("name")})
    mismatched = [i for i, o in enumerate(outs) if o != oracle[i]]
    if mismatched:
        i = mismatched[0]
        failures.append(f"(b) streams {mismatched} differ from the in-process "
                        f"oracle (stream {i} from token "
                        f"{first_difference(outs[i], oracle[i])})")
    if states[victim] != "dead":
        failures.append(f"(b) the victim's state is {states[victim]!r}")
    if stats["workers_failed"] != 1:
        failures.append(f"(b) workers_failed = {stats['workers_failed']}")
    if stats["streams_migrated"] != len(migrated):
        failures.append(f"(b) streams_migrated = {stats['streams_migrated']}, "
                        f"{len(migrated)} victims were unfinished")
    if stats["completed"] != len(prompts) + n_workers:
        failures.append(f"(b) completed = {stats['completed']}, want "
                        f"{len(prompts) + n_workers}")
    if "step" not in names:
        failures.append(f"(b) the post-mortem has no decode step: {names}")
    survivors = [r for r in rids if r not in migrated]
    pre = [g for r in rids
           for g in np.diff([t for t in arrivals[r] if t <= t_kill])]
    median_step = float(np.median(pre)) if pre else 0.0
    surv = [g for r in survivors for g in inter_token_gaps(arrivals[r], t_kill)]
    p99 = float(np.quantile(surv, 0.99, method="higher")) if surv else None
    stall = max(inter_token_gaps(arrivals[r], t_kill)[0] for r in migrated)
    hb = FLEET_B["hb_timeout_s"]
    surv_bound = hb + FLEET_RUN["survivor_slack_s"]
    rec_bound = (hb + FLEET_B["ckpt_every"] * median_step
                 + FLEET_RUN["recovery_slack_s"])
    say(f"  (b) tokens equal the in-process oracle's: {not mismatched}; "
        f"states {states}; {stats}")
    say(f"  (b) survivors' p99 inter-token gap {p99} s (fig13's bound "
        f"{surv_bound} s: {'held' if p99 is not None and p99 <= surv_bound else 'MISSED'}); "
        f"recovery stall {stall:.4f} s (bound {rec_bound:.4f} s = {hb} + "
        f"{FLEET_B['ckpt_every']} x median step {median_step:.4f} s + "
        f"{FLEET_RUN['recovery_slack_s']}: "
        f"{'held' if stall <= rec_bound else 'MISSED'}); reported, not gated")
    say(f"  (b) post-mortem of {post['worker']}: {len(post['records'])} "
        f"records, {post['torn']} torn, span names {names}")
    return {"workers": n_workers, "streams": len(prompts), "max_new": max_new,
            "victims": len(migrated), "token_identity": not mismatched,
            "worker_states": states, "stats": stats,
            "median_step_s": median_step, "p99_stall_survivors_s": p99,
            "survivor_stall_bound_s": surv_bound,
            "recovery_stall_s": stall, "recovery_stall_bound_s": rec_bound,
            "postmortem_records": len(post["records"]),
            "postmortem_names": names, "worker_kernels": counts,
            "shared_gc": fe.gc_shared(ttl_s=0.0)}


def phase17() -> dict:
    """The serving fleet: (a) fig12's scale-out and sharing, (b) fig13's
    kill of one of two workers, (c) the in-process oracle's paged launches;
    every worker a spawned process with its own CUDA context and its own
    full-width phi3 on the one card."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.serve.fleet import TenantQuota

    say("== phase 17: the serving fleet, full-width phi3-mini-3.8b workers "
        "in spawned processes sharing one domain")
    t_phase = time.perf_counter()
    run = FLEET_RUN
    failures = []
    out = {}
    cfg_a, cfg_b = ServeConfig(**FLEET_A), ServeConfig(**FLEET_B)
    rng = np.random.default_rng(13)
    elastic_prompts = fleet_prompts(rng, run["streams"], 2 * FLEET["page_tokens"])

    # (c) the oracle of (b): the same config in-process, its decode
    # attention through the paged kernel only
    reset_launches()
    with counting_calls([(model_layers, "decode_attention")]) as calls:
        t0 = time.perf_counter()
        with Serve.local(cfg_b) as srv:
            sids = [srv.submit(p, max_new=run["elastic_max_new"])
                    for p in elastic_prompts]
            srv.run()
            oracle = [srv.output(s) for s in sids]
            st = dict(srv.stats)
            n_layers = srv.arch.n_layers
        oracle_s = time.perf_counter() - t0
    iters = st["prefill_calls"] * scheduler.PREFILL_BUCKET + st["steps"]
    launches = pa.paged_attention.launches
    say(f"  (c) in-process oracle: {sum(map(len, oracle))} tokens in "
        f"{oracle_s:.2f} s (model built in the time); paged launches "
        f"{launches} = {n_layers} layers x {iters} token iterations; plain "
        f"decode attention calls {calls['decode_attention']}")
    if launches != n_layers * iters or calls["decode_attention"]:
        failures.append(f"(c) {launches} paged launches (want {n_layers} x "
                        f"{iters}) and {calls['decode_attention']} plain calls")
    out["oracle"] = {"tokens": sum(map(len, oracle)), "seconds": oracle_s,
                     "paged_launches": launches, "token_iterations": iters,
                     "plain_calls": calls["decode_attention"]}
    release()

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    if DEVICE == "cpu":
        os.environ.setdefault("OMP_NUM_THREADS", "1")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        jobs = {"two": pool.submit(Serve.fleet, cfg_a, 2,
                                   shared_root=str(root / "fleet2")),
                "one": pool.submit(Serve.fleet, cfg_a, 1,
                                   shared_root=str(root / "fleet1")),
                "elastic": pool.submit(Serve.fleet, cfg_b, 2,
                                       shared_root=str(root / "elastic"))}
        fleets = {}
        try:
            for key, job in jobs.items():
                fleets[key] = job.result()
        except BaseException:
            for fe in fleets.values():
                fe.stop()
            raise
    up = time.perf_counter() - t0
    say(f"  5 workers up (3 fleets launched together) in {up:.2f} s")
    out["bring_up_s"] = up
    try:
        # (a) sharing: A computes a 12-token prefix, B must reuse all of it
        a, b = fleets["two"].workers
        rng = np.random.default_rng(3)
        top = run["draw"]
        sysp = rng.integers(0, top, size=run["criterion_prefix"]).tolist()
        run_direct(a, "a1", sysp + rng.integers(0, top, size=4).tolist(),
                   run["max_new"], run["timeout_s"])
        out_b = run_direct(b, "b1", sysp + rng.integers(0, top, size=5).tolist(),
                           run["max_new"], run["timeout_s"])
        sb = b.stats()
        target = run["criterion_prefix"] + 5 - 1    # B prefills plen - 1
        saved = sb["scheduler"]["prefill_tokens_saved"]
        computed = sb["scheduler"]["prefill_tokens"]
        say(f"  (a) B saved {saved} of its {target} prefill tokens and "
            f"computed {computed}; shared-tier hits {sb['tier']['hits_shared']}, "
            f"nodes adopted {sb['prefix']['nodes_adopted']}")
        if saved != run["criterion_prefix"] or computed != target - saved:
            failures.append(f"(a) B saved {saved} and computed {computed} "
                            f"prefill tokens, want {run['criterion_prefix']} "
                            f"and {target - run['criterion_prefix']}")
        if sb["tier"]["hits_shared"] <= 0 or sb["prefix"]["nodes_adopted"] <= 0:
            failures.append("(a) B never read the shared tier or adopted a node")
        if len(out_b) != run["max_new"]:
            failures.append(f"(a) B emitted {len(out_b)} tokens")
        out["sharing"] = {"saved": saved, "computed": computed,
                          "hits_shared": sb["tier"]["hits_shared"],
                          "nodes_adopted": sb["prefix"]["nodes_adopted"]}

        # (a) scaling: fig12's batch of 8 requests on one worker and on two,
        # repeated with fresh prompts (a new shared prefix each time), the
        # fleets taking turns at going first
        reps = []
        for rep in range(run["reps"]):
            prompts = fleet_prompts(np.random.default_rng(7 + rep),
                                    run["requests"], run["shared"])
            got = {}
            for key in (("one", "two") if rep % 2 == 0 else ("two", "one")):
                m = fleet_throughput(fleets[key], prompts, run["max_new"],
                                     run["timeout_s"], warm=rep == 0)
                if m["tokens"] != run["requests"] * run["max_new"]:
                    failures.append(f"(a) {m['workers']} worker(s) emitted "
                                    f"{m['tokens']} tokens")
                got[key] = m
            got["speedup_wall"] = got["two"]["tok_per_s"] / got["one"]["tok_per_s"]
            got["speedup_critical_path"] = (
                got["two"]["critical_path_tok_per_s"]
                / got["one"]["critical_path_tok_per_s"])
            say(f"  (a) batch {rep}: 1 worker {got['one']['tok_per_s']:.2f} "
                f"tok/s ({got['one']['wall_s']:.3f} s), 2 workers "
                f"{got['two']['tok_per_s']:.2f} tok/s "
                f"({got['two']['wall_s']:.3f} s): {got['speedup_wall']:.3f}x "
                f"by the wall, {got['speedup_critical_path']:.3f}x by the "
                "critical path")
            reps.append(got)
        med = lambda xs: float(np.median(xs))
        sp = [r["speedup_wall"] for r in reps]
        scaling = {
            key: {"workers": reps[0][key]["workers"],
                  "tokens_per_batch": reps[0][key]["tokens"],
                  "tok_per_s_median": med([r[key]["tok_per_s"] for r in reps]),
                  "tok_per_s": [r[key]["tok_per_s"] for r in reps],
                  "critical_path_tok_per_s_median": med(
                      [r[key]["critical_path_tok_per_s"] for r in reps])}
            for key in ("one", "two")}
        verdict = ("held" if min(sp) >= run["speedup"] else "not held"
                   if max(sp) < run["speedup"] else "unresolved")
        say(f"  (a) 2 workers / 1 over {len(reps)} batches: median "
            f"{med(sp):.3f}x, range {min(sp):.3f}x .. {max(sp):.3f}x by the "
            f"wall (median {med([r['speedup_critical_path'] for r in reps]):.3f}x "
            f"by the critical path); fig12's claim >= {run['speedup']}: "
            f"{verdict} (held only if every batch reaches it; reported, not "
            "gated)")
        out["scaling"] = dict(
            scaling, speedups_wall=sp, speedup_wall=med(sp),
            speedup_critical_path=med([r["speedup_critical_path"]
                                       for r in reps]),
            fig12_claim=verdict)
        out["worker_kernels"] = worker_kernels(fleets["two"], n_layers,
                                               failures)

        # (a) tenants: a noisy tenant over its quota of 1 on one worker
        fe = fleets["one"]
        fe.quotas = {"noisy": TenantQuota(1), "quiet": TenantQuota(4)}
        before = dict(fe.stats.items())
        rng = np.random.default_rng(11)
        noisy = [fe.submit(p, max_new=run["max_new"], tenant="noisy")
                 for p in fleet_prompts(rng, run["noisy"], run["shared"])]
        quiet = [fe.submit(p, max_new=run["max_new"], tenant="quiet",
                           prio="interactive")
                 for p in fleet_prompts(rng, run["quiet"], run["shared"])]
        fe.wait(noisy + quiet, timeout=run["timeout_s"])
        throttled = fe.stats["throttle_events"] - before["throttle_events"]
        completed = fe.stats["completed"] - before["completed"]
        p99_quiet = fe.admission_latency_p99("quiet")
        say(f"  (a) tenants: {completed} of {run['noisy'] + run['quiet']} "
            f"completed, throttle events {throttled}; quiet tenant's p99 "
            f"admission {p99_quiet:.4f} s (fig12's bound {run['quiet_p99_s']} "
            f"s: {'held' if p99_quiet < run['quiet_p99_s'] else 'MISSED'}; "
            f"reported, not gated), noisy's "
            f"{fe.admission_latency_p99('noisy'):.4f} s")
        if throttled <= 0 or completed != run["noisy"] + run["quiet"]:
            failures.append(f"(a) tenants: {completed} completed, "
                            f"{throttled} throttle events")
        out["tenants"] = {"completed": completed, "throttle_events": throttled,
                          "p99_quiet_s": p99_quiet,
                          "p99_noisy_s": fe.admission_latency_p99("noisy")}
        out["worker_kernels"] += worker_kernels(fe, n_layers, failures)

        # (b) kill one of two
        out["elastic"] = fleet_elastic(fleets["elastic"], elastic_prompts,
                                       oracle, run["elastic_max_new"],
                                       n_layers, failures)
        obs = Serve.stats(fleets["elastic"])
        out["elastic"]["merged_finished"] = (
            obs["merged"]["counters"].get("sched", {}).get("finished"))
    finally:
        for fe in fleets.values():
            fe.stop()
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    say(f"  phase 17 took {out['seconds']:.1f} s")
    say("  phase 17 record: " + json.dumps(out, default=str))
    if failures:
        raise AssertionError("phase 17 gates failed:\n  " + "\n  ".join(failures))
    return out


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
    repairs = phase10_repairs()
    for kind, names in (("wkv6", ("wkv6_fwd", "wkv6_bwd")),
                        ("ssd", ("mamba2_ssd_fwd", "mamba2_ssd_bwd"))):
        for name in names:
            kernels[name]["repair_cases"] = repairs[kind]
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        kernels[name]["repair_widths"] = repairs["flash"]
    release()
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

    phase13(kernels)

    sass = {**kernels["flash_attention_fwd"]["sass"],
            **kernels["flash_attention_bwd"]["sass"]}
    mla = phase14(sass)
    moe = phase15()
    for kind in ("fwd", "bwd"):
        name = f"flash_attention_{kind}"
        dv = dict(mla["kernels"][name])
        kernels[f"{name}_96x64"] = {
            "name": f"{name}_96x64", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:123",
            "design": "wgmma+tma, V of its own width (D 96, Dv 64)",
            "launches": mla["family"]["launches"][name],
            "main_path": mla["family"]["main_path"],
            "prefill_full_depth_launches": (mla["family"]["prefill"]["layers"]
                                            if kind == "fwd" else 0),
            **dv}
        kernels[name][f"launches_{MOE_ARCH}"] = moe["train"]["launches"][name]
        kernels[name][f"main_path_{MOE_ARCH}"] = moe["train"]["main_path"]
    kernels["flash_attention_fwd"][f"prefill_full_depth_{MOE_ARCH}"] = moe["prefill"]

    p16 = phase16()
    for kind in ("fwd", "bwd"):
        name = f"flash_attention_{kind}"
        kernels[f"{name}_256x256"] = {
            "name": f"{name}_256x256", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:123",
            "design": "wgmma+tma, D 256: both consumer warpgroups on the same "
                      "64 rows, each with half the output columns; prefix-LM "
                      "mask (paligemma-3b: 8 query heads over 1, prefix 256)",
            "launches": p16["train"]["launches"][name],
            "main_path": p16["train"]["main_path"],
            "prefill_full_depth_launches": (p16["prefill"]["flash_launches"]
                                            if kind == "fwd" else 0),
            "sass": {k: v for k, v in sass.items() if k.endswith("<256,256>")
                     and k.startswith("fwd") == (kind == "fwd")},
            **p16["kernels"]["paligemma"][kind]}
        for key in ("whisper_encoder", "whisper_cross"):
            kernels[name][f"at_{key}"] = p16["kernels"][key][kind]
        kernels[name][f"launches_{WHISPER_ARCH}"] = (
            p16["whisper"]["launches"][name])
        kernels[name][f"main_path_{WHISPER_ARCH}"] = p16["whisper"]["main_path"]
    kernels["flash_attention_fwd"][f"prefill_full_depth_{PALI_ARCH}"] = p16["prefill"]
    kernels["flash_attention_fwd"][f"prefill_full_depth_{WHISPER_ARCH}"] = (
        p16["whisper"]["prefill"])

    p17 = phase17()
    kernels["paged_attention"]["launches_phase17_oracle"] = (
        p17["oracle"]["paged_launches"])
    workers = p17["worker_kernels"] + p17["elastic"]["worker_kernels"]
    kernels["paged_attention"]["launches_phase17_workers"] = sum(
        w["paged_launches"] for w in workers)
    kernels["paged_attention"]["phase17_workers"] = workers
    kernels["paged_attention"]["fleet"] = {
        key: p17[key] for key in ("bring_up_s", "sharing", "tenants", "seconds")}
    kernels["paged_attention"]["fleet"]["speedup_wall"] = {
        k: p17["scaling"][k] for k in ("speedup_wall", "speedups_wall",
                                       "fig12_claim")}
    kernels["paged_attention"]["fleet"]["elastic"] = {
        k: v for k, v in p17["elastic"].items()
        if k not in ("stats", "worker_kernels")}

    say(smi)
    say(json.dumps({"kernels": list(kernels.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
