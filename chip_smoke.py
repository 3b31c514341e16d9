#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives its serving path (paged, resilient and contiguous) with
full-width, full-depth phi3-mini-3.8b, minicpm3-4b (MLA, paged),
deepseek-moe-16b (MoE, contiguous), whisper-tiny and paligemma-3b
(contiguous), and its training-and-recovery path with full-width
phi3-mini-3.8b cut to 1 layer, rwkv6-3b cut to 1, zamba2-2.7b cut to 6,
minicpm3-4b cut to 1, deepseek-moe-16b cut to 2, paligemma-3b cut to 1 and
whisper-tiny at full size (random weights from a seed); and the mesh
paths (Ulysses prefill of starcoder2-7b and minicpm3-4b, qwen2-moe-a2.7b's
expert island), xPic's Cluster-Booster offload and the training launcher
over ranks that share the card.  Phases, each of which raises on a failed
check:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, TF32 off, and the kernels' build time;
1. the paged kernels against their plain PyTorch versions on the card,
   at phi3's attention shape (32 heads, head dim 96) with serving
   lengths (up to 256) and long-context ones (up to 4096),
   starcoder2-7b's (36 over 4 kv heads, head dim 128) short and long (up
   to 2048) and an odd one (7 query heads per kv head, head dim 72, page
   5), and the wide route (heads past 256: D 320 with 8 query heads over
   2, D 576 with 16 over 1, at lengths up to 256 and at phi3's
   long-context lengths), ragged lengths, shared prefix pages and
   out-of-range table entries, float32 and bfloat16, the multi-token fold
   and the int8 kernel; every paged kernel's registers and spills
   (ptxas; none may spill) and each wide instantiation's HMMA count
   (SASS; every bf16-query one must have some); then at the seven timed
   shapes (phi3 serving and long context, starcoder2-7b long, the four
   wide ones; bf16, L2 cold): two launches bit-identical, each row alone
   equal to its row in the batch and the fold's rows equal to single-row
   calls, and the device time of kernel, plain version and
   ``scaled_dot_product_attention`` (each backend pinned in turn, the
   fastest kept) beside the bound, gated: at most 0.020 ms at phi3's
   serving shape, at most 3x the bound at its long context, the bf16
   kernel at most 4x the bound at both wide long-context shapes, and no
   slower than SDPA at each; the wide route's goals (0.020 ms short, 2x
   and 3x the bound long) reported beside, and its launches in the
   serving phases counted by route and gated at 0;
2. ``Serve.local`` serving 8 requests with speculative decode (spec_k=3),
   4 slots, round-robin parking: tokens/s, steps, acceptance, kernel
   launches (one per layer per token), peak memory;
3. the same requests with spec_k=0: the tokens must be identical;
4. two requests at float32 compute through the kernel and through the
   plain versions: the tokens must be identical (a difference where the
   plain path's top two logits tie within the float32 bound is reported
   as a tie);
5. the first 2 phase-2 requests over an int8 pool through the int8
   kernel (16 new tokens a request), with token agreement against phase 2
   reported;
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
   full width and 1 layer, B 4 x T 512, deterministic algorithms and
   TF32 off: one recovery from step 4, the loss falls, flash launches
   are 2 forward (remat) + 1 backward pass (3 launches) per layer per
   step with no plain or library attention call, and the final state's
   SHA-256 equals an
   uninterrupted run's (the same steps without checkpoints, as phases
   11-12 run theirs); step ms, checkpoint bytes and seconds, restore
   seconds, peak device memory and free disk reported;
9. the phase-8 parameters checkpointed with NAM_XOR, node 3 killed and
   the parameters restored byte-identically; each XOR group's fragments
   stacked on the card and reduced through the XOR kernel equal the NAM
   parity the SCR stored; the kernel timed at that shape (the whole
   state with AdamW's moments, three times the bytes, was cut for time);
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
   training at published width cut to 1 layer, 8 steps, twice and
   uninterrupted under deterministic algorithms (through a node kill and
   PARTNER copies before its checkpoint I/O was cut for time): a falling
   loss, 2 forward and 1 backward WKV6 launches per layer per step and no
   plain scan, and both runs' final states the same bytes;
12. zamba2-2.7b, the same: full depth 54 layers (one SSD launch per Mamba
   layer, one flash launch per shared-block group), training cut to 6
   layers (one group), twice: 2 forward and 1 backward SSD launches per Mamba
   layer per step, 1 flash forward and 3 flash backward launches per
   group per step;
13. resilient serving of full-size phi3-mini-3.8b through ``Serve.local``
   (4 slots, max_len 256, page 16, quantum 4, spec_k=3; 6 requests
   sharing a 48-token system prompt, 8-32 tokens of their own, 6 new
   tokens): (a) no prefix cache, the default pool; (b) the prefix cache
   and a pool of 80 pages (five lanes), so admission spills: (a)'s
   tokens, spills, refills, prefix hits and saved prefill tokens > 0,
   resume bytes equal to the refills' alone (clean resumes move none),
   paged launches = layers x token iterations with no plain attention
   call; (c) (b) under an XOR ``ResilienceSession`` on a virtual
   cluster, checkpointed once a stream is spilled and a prefix page is
   bound in the pool, the stack closed, node 1 failed and recovered, a
   fresh stack restored (pool SHA-256, allocator, pager tables and trie
   equal to the saved) and finished with (a)'s tokens (phi3's contiguous
   scheduler through a kill and restore, formerly (d), was cut for time:
   phases 15 (d) and 16 (e) serve the contiguous scheduler's slice mode,
   whose lanes are attention caches, through a save, a node kill and a
   restore at full depth, and phase 22 (a), (b) its snapshot mode, whose
   lanes are whole recurrent states);
14. minicpm3-4b (MLA: qk heads of 96, v heads of 64): (a) the flash
   kernels with V of its own width against their plain version, forward
   and backward, f32 and bf16, the f32 gradients also against float64,
   at minicpm3's training shape (B 4, T 512, 40 heads) and two odd ones
   (Tq 100 > Tk 77 non-causal and Tq 77 < Tk 100 causal, 8 query heads
   over 2); the (96, 64) instantiations' registers and spills; their
   times beside (96, 96) at the same shape, the bound and the fastest
   SDPA backend that takes Dv != D; (b) a full-depth (62 layers) bf16
   prefill, one flash launch per layer, no plain call; (c) the float32
   forward through the kernels against the plain path; (d) training at
   published width cut to 1 layer, twice and uninterrupted (phase 11's
   form): a falling loss, 2 forward and 3 backward flash launches per
   layer per step, both runs' final states the same bytes;
   (e) ``Serve.local`` paged with the prefix cache at full size (4
   slots, page 16, 4 requests of 16-48 tokens sharing a 16-token page,
   4 new tokens): spec_k=3 and spec_k=0 emit identical tokens, with no
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
   call; (c) training at published width cut to 1 layer, twice, under
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
   1 and on 2 workers, two batches of fresh prompts (tok/s and the
   speedup's median and range beside fig12's 1.5, reported), a noisy tenant over its quota of 1 throttled while all 9
   requests complete (the quiet tenant's p99 admission beside fig12's
   1.0 s, reported); (b) fig13's set-up (max_len 256, an epoch checkpoint
   every 4 steps, heartbeats 0.05 s, timeout 0.3 s, 4 streams of 16 new
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
   runs);
18. the task runtime, error-feedback compression and the collectives:
   (a) fig10's task-resilience scenarios on the card (8 cycles of its FWI
   proxy over a 96 x 96 grid, rank 5): clean (journaled), resilient with a
   failure armed at the last cycle, and no resiliency (a full restart):
   the resilient model equal to the clean one bit for bit, 1 retry and 1
   restart, and a fresh runtime over the journal fast-forwarding every
   cycle with 0 launches to the clean model on the card; the wall times
   and fig10's ratios reported; (b) one ``train_step`` of phi3-mini-3.8b
   at phase 8's size as a task with a failure armed on its rank: one retry
   from the host snapshot, the state byte-identical to the same step run
   outside the runtime; the snapshot's bytes and seconds; (c) a
   full-width phi3 gradient tree (phase 8's shapes, values from a seed)
   compressed to int8 and back on the card: every leaf within half its
   scale (plus one float32 rounding), GB/s, q and scale against a CPU run
   at three leaves (a reading); (d) ``xor_all_reduce`` over 4 ranks, one
   process and CUDA context each on the one card, of (1,241,902, 128)
   int32 blocks: gloo carries the exchange through host buffers and the
   CUDA XOR kernel does each combine; every rank ends with the numpy XOR
   of the four blocks, with 2 kernel launches and no plain XOR call each;
   seconds per round (exchange, kernel); then ``hierarchical_psum`` of an
   (8192, 3072) f32 leaf over a 2 x 2 grouping, allclose to the flat sum;
19. the mesh paths, the offload and the launcher, over two spawned ranks
   that share the card (gloo through host buffers; the parent makes each
   part's weights and hands them over by CUDA IPC, a rank keeping copies
   only of its own blocks): (a) starcoder2-7b and (b) minicpm3-4b at
   published width and full depth (32 and 62 layers), ``tp`` 2,
   ``seq_parallel``, a (data 1 x model 2) mesh, B 2 x T 512 through
   ``make_prefill_step``: each rank's next tokens equal the single-process
   forward's, the relative logit error (max |a - b| / max |a| over the
   logical vocabulary) below the reference's 3e-2, and per rank one flash
   launch per layer with no plain call; each rank's gloo exchange seconds
   beside its flash kernel's time; (c) qwen2-moe-a2.7b: the expert island's
   prefill at full depth (24 layers) with the same gates, then AdamW
   steps at published width and depth 1, B 4 x T 512, against the same
   steps in one process on the whole batch (loss and aux within 1%,
   parameters within 2 lr a step), first over (data 1 x model 2) twice
   (one SHA-256 of each rank's parameters), then the first step over
   (data 2 x model 1) (two whole AdamW states and the single-process
   parameters do not fit one card together, so this run is held by its
   loss and aux); flash launches 2 forward and 3 backward per layer per
   step, no plain call;
   (d) xPic (``examples/xpic_offload.py``, in the port
   ``examples/torch_xpic_offload.py``) at 2^24 particles on a 4,096-
   cell grid for 8 steps: the field solve on the Cluster (rank 0, CPU),
   the particle push offloaded to the Booster (rank 1, the card; the
   device is asserted inside the push) under ``TaskRuntime.run`` with a
   transient Booster failure armed in step 3, the particles kept on the
   Booster and the current gathered back: energies bit-equal to a run
   without the failure (deterministic algorithms), retried >= 1, failed
   0, the fabric hops' bytes and seconds printed; (e) ``python -m
   repro_torch.launch.train --arch phi3-mini-3.8b --steps 6 --fail-at 3
   --ckpt-every 2`` on the card: one failure and one recovery, the last
   loss equal to the same command's without ``--fail-at``;
20. (a) contiguous caches at phi3-mini-3.8b's serving width (B 4, its 32
   heads over 32 kv heads of 96, page 16; S 2,048 and 2,041, lengths 1 to
   S) laid out as pools by ``paginate_cache`` (no host synchronisation,
   identity tables on the card, zero padding) and put through both paged
   kernels, float32 and bfloat16: each against its plain version over the
   same pools (phase 1's tolerances) and against contiguous decode
   attention on the unpaged cache (the int8 kernel on the dequantized
   cache at those tolerances, and on the original at 0.05); launches
   gated by route (all narrow); kernel, plain, contiguous and
   ``paginate_cache`` times (CUDA events, L2 warm) beside the bound; (b)
   the dry run (``repro_torch.launch.dryrun.main``) of phi3-mini-3.8b's
   and deepseek-moe-16b's train cells, plain and with ``--set
   fused_gate_up=1 --set capacity_factor=2.0``: ``model_flops`` equal to
   6·N·T·B, the variant in the record and the config, the parameter
   leaves and bytes those of the layout built (MoE's gate and up in one
   ``w_in`` leaf), and an unknown key refused by name;
21. the dry run's count on the card: one training step of phi3 and
   rwkv6-3b at published width and 1 layer against ``lower_cell`` on the
   meta device (FLOPs, bytes, kernel calls and launches, peak memory),
   and a full-depth phi3 decode step's memory;
22. the port's examples (``examples/torch_*.py``, loaded by path and run
   through their ``main``): (a) rwkv6-3b (32 layers) and (b) zamba2-2.7b
   (54 layers) served at published width through ``torch_serve.py
   --full-size`` (6 streams sharing a 9-token prompt, 2 slots, quantum 3,
   6 new tokens, saved after 8 steps, a node killed, restored; the
   contiguous scheduler's snapshot mode, whose lanes are whole recurrent
   states): the example's own assert (the restored tokens equal the
   uninterrupted run's), the reference example's counts (36 tokens, 6
   parks, 6 resumes, max 6 resident, 5 prefix hits, 40 prefill tokens
   saved, 43 computed, 4 parked at the save); tok/s, parks, resumes, the
   save's commit and the restore from the example's trace; then a stack
   from the config it served, its lanes and parameters on the card, and
   its batch-1 slot-step by CUDA events beside its weight-read bound; (c)
   both at published width and full depth with float32 compute:
   ``decode_step`` token by token over B 2 x T 128 against one
   ``forward`` through the WKV6 kernel (rwkv6) or the SSD and flash
   kernels (zamba2), and each against a float64 forward, at every
   position within 1e-4 relative logit error; where the float32 noise
   (the plain float32 forward's distance to the float64 one) passes 1e-4
   (rwkv6-3b's stack amplifies float32 rounding to ~1e-2 at 32 layers),
   each float32 evaluation within 8 times its position's noise from the
   float64 forward and the chain within twice that of the kernel
   forward; rwkv6-3b's decode chain also in
   float64 against the float64 forward within 1e-9; one scan launch per
   layer and one flash launch per group, no plain scan or attention; (d)
   ``torch_quickstart.py``, ``torch_fault_tolerant_train.py --steps
   30``, ``torch_xpic_offload.py`` and ``torch_serve.py --workers 2
   --arch phi3-mini-3.8b`` on the card: their counterparts' OK lines and
   counts, flash launches of 2 forward and 3 backward per layer per step
   run, each fleet worker's paged
   launches = layers x token iterations.

Phase 10 also runs the repair cases: the scans' gradient through the
final state (a loss on y and on the final state) at 64-wide shapes, WKV6
at head sizes 128 and 80 and SSD at (P, N) = (64, 128) and (128, 64)
(tiles of the 64-wide kernels on the float32 route), flash at (D, Dv)
= (72, 72), (112, 112), (160, 160), (100, 100) and (96, 32) (zero-padded
to the next instantiation) and past 256 on the wide kernels (bf16 on the
tensor cores, f32 on the CUDA cores), (264, 264), (300, 300), (320, 320),
(512, 512), absorbed MLA's (576, 512) and its MQA prefill (B 1 x T 1024,
16 query heads over 1; bf16 there against the plain version in float64),
each f32 and bf16 against the plain version (f32 gradients also against
float64), twice bit-identical, past 256 with bf16 times beside every SDPA
form that takes the call (and those that refuse it, named; the narrower
widths' times were cut for time); the wide kernels with
the prefix-LM mask, Tq < Tk and non-causal Tq > Tk (REPAIR_FLASH_MASKS);
and both paged kernels (plain
and int8 pools, f32 and bf16, the multi-token folds) at D 100 (padded to
104), 320 and 576 (the boxed span kernel) against their plain versions,
twice bit-identical, with bf16 times beside the bound and the fastest SDPA
backend that takes the call; and flash past the 65,535 limit of grid
dimensions y and z (every launcher folds its blocks into grid x): B
65,600 x T 16 x 1 head of D 64, and Hq 32,768 over Hkv 16,384 at (512,
512), B 1 x T 16 (65,536 forward and 65,536 dK/dV slice blocks), forward
and backward, bf16 against the plain version and f32 against float64.
For time, phase 5 runs 2 requests of 16
new tokens (8 of 32, then 4 of 16 before), phase 13 6 requests of 6 new tokens in (a)
to (c) (8 of 32 before) and no contiguous run (d), and phase 17
two scaling batches (five before) and fig13's streams to 16 new tokens
(64 before); phase 8's uninterrupted run takes its steps without
checkpoints (two and a restore before) and phase 14 (e) serves 4
requests of 4 new tokens (8 of 8 before); phases 8 (and so 9 and 18),
11, 14 and 16 (c) train at 1 layer (2 before), and phases 11, 12 and 14
(d) train twice without checkpoints (through a node kill before: two
checkpoint commits and a restore of 3-6 GB each; the node kill stays in
phases 8 and 16 (d)).  To make room for phase 22, phase 13 runs no
contiguous (d) (phases 15 (d) and 16 (e) keep the contiguous
scheduler's kill and restore), phase 9 checkpoints and restores the
parameters alone (the whole state before), and phase 19 (c) takes one
step over (data 2 x model 1) (three before).

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
import importlib.util
import io
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
from repro_torch.kernels import work  # noqa: E402
from repro_torch.kernels import xor_parity as xp  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.memory.stack import TierStack  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, get_shape  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.obs.trace import Tracer, set_default_tracer  # noqa: E402
from repro_torch.core.tasks import TaskError, TaskRuntime, _snapshot  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.memory.tiers import MemoryTier, TierKind, TierSpec  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: E402
                                     tree_leaves, tree_map)
from repro_torch.optim.compression import (compress_grads,  # noqa: E402
                                           decompress_grads, init_residual)
from repro_torch.serve import Serve, ServeConfig, scheduler  # noqa: E402
from repro_torch.train.step import (init_train_state, make_prefill_step,  # noqa: E402
                                    make_serve_step, make_train_step)
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
INT8_REQUESTS, INT8_MAX_NEW = 2, 16   # phase 5 (8 of 32, then 4, before cuts for time)
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
    # past 256 columns (the wide kernels, both dtypes); (576, 512) is
    # absorbed MLA decode's (DeepSeek-V2/V3: a 512-wide latent plus 64 rope
    # columns)
    "(264, 264)": (2, 256, 256, 8, 2, 264, 264),
    "(300, 300)": (2, 256, 256, 8, 2, 300, 300),
    "(320, 320)": (2, 256, 256, 8, 2, 320, 320),
    "(512, 512)": (2, 256, 256, 8, 2, 512, 512),
    "(576, 512)": (2, 256, 256, 8, 2, 576, 512),
    # absorbed MLA's geometry (DeepSeek-V2/V3) as a prefill: MQA, 16 query
    # heads over 1 latent head; bound by operations, not bytes
    "(576, 512) MQA T 1024": (1, 1024, 1024, 16, 1, 576, 512),
}
# phase 10's cases whose bf16 results are held against the plain version
# computed in float64 on the same bf16 inputs (at FLASH_BF16_TOL), not
# against its bf16 run: with 16 query heads over one kv head and T 1024 a
# dK or dV element sums 16,384 products, and the plain bf16 version rounds
# each head's share to bf16 before their sum (the repeat's gradient), which
# leaves it up to 6e-2 from the exact sum where the shares cancel; the
# kernel rounds once.  Both distances to float64 are printed.
FLASH_BF16_AGAINST_F64 = {"(576, 512) MQA T 1024"}
# the masks on the wide kernels (fault 4's prefix-LM mask and fault 1's
# non-causal Tq > Tk, as phases 6 and 16 (a) hold them up to 256):
# b, tq, tk, hq, hkv, d, dv, causal, prefix_len
REPAIR_FLASH_MASKS = {
    "(576, 512) T 200 prefix 77": (2, 200, 200, 8, 2, 576, 512, True, 77),
    "(264, 264) Tq 77 < Tk 300 prefix 150": (2, 77, 300, 8, 2, 264, 264, True, 150),
    "(320, 100) non-causal Tq 100 > Tk 77": (2, 100, 77, 8, 2, 320, 100, False, 0),
    "(40, 296) non-causal, prefix ignored": (1, 130, 130, 4, 4, 40, 296, False, 50),
}
# fault 6: flash past the 65,535 limit of grid dimensions y and z (every
# launcher folds its blocks into grid x): a batch of 65,600, and a wide call
# of 65,536 column-slice blocks forward and 65,536 dK/dV slice blocks
REPAIR_GRID = {   # b, tq, tk, hq, hkv, d, dv
    "B 65600": (65600, 16, 16, 1, 1, 64, 64),
    "Hq 32768 over 16384 at (512, 512)": (1, 16, 16, 32768, 16384, 512, 512),
}
# the paged kernels off a multiple of 8 (padded by the wrapper) and past 256
# (the boxed span kernel): b, hq, hkv, d, page, nP, lengths (phase 1's
# ragged lengths, two spans and more)
REPAIR_PAGED = {
    "D=100": (4, 8, 2, 100, 16, 16, [1, 63, 130, 256]),
    "D=320": (4, 8, 2, 320, 16, 16, [1, 63, 130, 256]),
    "D=576": (4, 16, 1, 576, 16, 16, [1, 63, 130, 256]),
}
# phase 10's case below the model's decay clip: w down to 1e-20 on every
# other channel, against the sequential oracle (the chunked plain version
# overflows there)
BELOW_CLIP_SHAPE = (1, 77, 2, 64)
# phases 11-12: the recurrent families at published width; training cuts
# the depth (rwkv6-3b 32 -> 1 layer, zamba2-2.7b 54 -> 6, one group;
# minicpm3-4b and paligemma-3b -> 1; deepseek-moe-16b -> 2, its first layer
# dense); 1 layer where 2 ran before, for the script's time limit
FAMILY = dict(layers={"rwkv6-3b": 1, "zamba2-2.7b": 6, "minicpm3-4b": 1,
                      "deepseek-moe-16b": 2, "paligemma-3b": 1,
                      "whisper-tiny": 4}, batch=4, seq=512,
              steps=8, ckpt_every=4, fail_step=6, fail_rank=3, lr=1e-3,
              warmup=4,
              # the families whose training runs through a node kill and a
              # restore; the others run twice uninterrupted and end on the
              # same bytes (their kill runs' checkpoint I/O, ~35-75 s each on
              # a slow host's disk, cut for the script's time limit)
              kill={"whisper-tiny"})
# kernel path vs plain path of a whole float32 forward: 1.6e-5 measured on
# an H100 (rwkv6-3b, 2 layers)
FAMILY_F32_TOL = dict(atol=1e-4, rtol=1e-4)
# the training run: phi3-mini-3.8b at published width, depth cut to 1 (2
# before, cut for the script's time limit: the state each checkpoint
# commits, and phase 9 parity-protects, shrinks from 5.09 to ~3.7 GB)
TRAIN = dict(arch="phi3-mini-3.8b", layers=1, batch=4, seq=512, steps=8,
             ckpt_every=4, fail_step=6, fail_rank=3, lr=1e-3, warmup=4)
# free disk a 2-layer run needs: BUDDY keeps 2 checkpoints of ~5.1 GB,
# each as local, buddy and global copies
TRAIN_DISK_2L = 40 * 2**30


T_START = time.perf_counter()


def say(*parts) -> None:
    """Print a line; a phase's header (``== ...``) carries the seconds
    since the script started."""
    if parts and str(parts[0]).startswith("== "):
        parts = (f"[{time.perf_counter() - T_START:.1f} s]",) + parts
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


def bound_ms(work_done, dtype_name: str) -> tuple:
    """Least time for ``(flops, bytes)`` of work: the larger of the bytes
    over HBM bandwidth and the operations over the peak of the inputs'
    type; and which of the two it is."""
    flops, nbytes = work_done
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_bound_ms(q, k_pages, table, lengths, quant=False) -> tuple:
    """Least time for the work of one call (``kernels.work.paged``): the
    unique valid K/V rows (and scales) read once, deduplicated from the
    table's values here, plus q, table and lengths read and out written,
    over HBM bandwidth; against 4 flops per (q head, position, dim) over
    the peak of the inputs' type."""
    n, page, hkv, d = k_pages.shape
    t = table.clamp(0, n - 1).cpu().numpy()
    rows = set()
    for r, ln in enumerate(lengths.cpu().tolist()):
        for p in range(min(ln, t.shape[1] * page)):
            rows.add((int(t[r, p // page]), p % page))
    positions = int(lengths.clamp(0, t.shape[1] * page).sum())
    return bound_ms(work.paged(q.shape[0], q.shape[1], hkv, d, q.element_size(),
                               k_pages.element_size(), t.shape[1], page,
                               quant=quant, rows=len(rows), positions=positions),
                    str(q.dtype).split(".")[-1])


def sdpa_ms(q, k_layers, v_layers, table, lengths, traces=5) -> tuple:
    """One PyTorch call computing the same function (the yardstick; the
    port never calls it): SDPA over each layer's cache gathered
    beforehand, cycling over the layers as the kernel is timed, so that
    each call finds L2 cold.  Each backend is pinned in turn, with the kv
    heads shared through ``enable_gqa`` where the backend takes it and
    repeated to every query head where not; returns the fastest that takes
    the boolean mask by device time, as (:class:`DeviceTime`,
    "sdpa/<backend>", eager ms).  A form is traced once, and ``traces``
    times (with its eager time) only while within 1.5x of the fastest so
    far: the slow forms (the math backend) are not traced again."""
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
                    dev = device_time(call, traces=1)
                    contender = best[0] is None or dev.ms < 1.5 * best[0].ms
                    if contender:
                        dev = device_time(call, traces=traces)
                        eager = time_ms(call)
            except RuntimeError:
                continue          # this backend does not take these inputs
            name = f"sdpa/{backend.name.lower().replace('_attention', '')}"
            name += "" if g == 1 else ("+repeated_kv" if repeat else "+gqa")
            if not contender:
                say(f"    {name}: {dev.ms:.5f} ms on the device (one trace; "
                    f"over 1.5x the fastest)")
                continue
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
    # the wide route (paged_wide_kernel): phase 10's REPAIR_PAGED widths
    # past 256, then at phi3's long-context lengths; D 576 over one kv head
    # is absorbed MLA's latent width (DeepSeek-V2/V3: 512 + 64)
    "wide D=320 (Hq=8, Hkv=2)": (4, 8, 2, 320, 16, 16, [1, 63, 130, 256]),
    "wide D=576 (Hq=16, Hkv=1)": (4, 16, 1, 576, 16, 16, [1, 63, 130, 256]),
    "wide D=320 long context": (4, 8, 2, 320, 16, 256,
                                [4096, 3001, 1024, 200]),
    "wide D=576 long context": (4, 16, 1, 576, 16, 256,
                                [4096, 3001, 1024, 200]),
}
# timed shapes (bf16, cold L2) and their gates: a fixed ceiling in ms and
# a multiple of the bound, on both kernels (``bf16_bound_x``: on the bf16
# pool's kernel only), and no slower than SDPA
PAGED_TIMED = {
    "serving": ("phi3 (Hq=Hkv=32, D=96)", dict(max_ms=0.020)),
    "long_context": ("phi3 long context", dict(max_bound_x=3.0)),
    "starcoder2": ("starcoder2-7b long context", {}),
    "wide_320": ("wide D=320 (Hq=8, Hkv=2)", {}),
    "wide_576": ("wide D=576 (Hq=16, Hkv=1)", {}),
    "wide_320_long": ("wide D=320 long context", dict(bf16_bound_x=4.0)),
    "wide_576_long": ("wide D=576 long context", dict(bf16_bound_x=4.0)),
}
# goals of the wide route, reported beside its times and not gated: at
# most 0.020 ms at the short shapes, and at the long shapes 2x the bound
# (bf16 pool) and 3x (int8 pool)
PAGED_WIDE_GOALS = {"short_ms": 0.020, "bf16_bound_x": 2.0,
                    "int8_bound_x": 3.0}


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
            frame = re.search(r"(\d+) bytes stack frame", line)
            if frame:
                report[cur]["stack_frame"] = int(frame[1])
        elif cur and "Used" in line and "registers" in line:
            report[cur]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
    return demangled(report)


def demangled(report: dict) -> dict:
    """``report`` keyed by demangled kernel names where ``cu++filt`` is at
    hand ("f<...>"), else as given."""
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


def paged_sass(library) -> dict:
    """HMMA (mma.sync) instructions of each wide paged kernel
    instantiation (``paged_wide_kernel``) in a built library's SASS
    (``cuobjdump -sass``)."""
    sass = subprocess.run([cuobjdump(), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m[1] if "paged_wide_kernel" in m[1] else None
            if cur:
                counts[cur] = 0
        elif cur:
            counts[cur] += " HMMA." in line
    return demangled(counts)


def bf16_query(kernel: str) -> bool:
    """Whether a wide instantiation's name (demangled or not) takes bf16
    queries: its first template argument."""
    return re.search(r"paged_wide_kernel(<|I)(13)?__nv_bfloat16", kernel) is not None


def paged_ptxas() -> dict:
    """Registers and spills of every paged kernel instantiation, from the
    build's ``-Xptxas -v`` report, and the HMMA count of each wide one
    (SASS); raises if one spills, or if a wide instantiation that takes
    bf16 queries has no HMMA (its scores would not be on the tensor
    cores)."""
    log = _build.build_log.get("paged_attention")
    if log is None:
        raise AssertionError("no ptxas report: paged_attention.cu was not built "
                             "by this run (delete build/repro_torch_kernels)")
    report = ptxas_report(log)
    hmma = paged_sass(_build.library_path("paged_attention"))
    for key, count in hmma.items():
        report.setdefault(key, {})["HMMA"] = count
    for key, entry in report.items():
        say(f"  ptxas {key}: {entry.get('registers')} registers, stack frame "
            f"{entry.get('stack_frame')} B, spill stores {entry.get('spill_stores')} B "
            f"/ loads {entry.get('spill_loads')} B"
            + (f"; SASS HMMA {entry['HMMA']}" if "HMMA" in entry else ""))
    spilled = [k for k, e in report.items()
               if e.get("spill_stores", 0) or e.get("spill_loads", 0)]
    if not report or spilled:
        raise AssertionError(f"paged kernels that spill: {spilled}")
    if len(hmma) != 4:
        raise AssertionError(f"wide paged instantiations in the SASS: {sorted(hmma)}")
    no_tc = [k for k, n in hmma.items() if bf16_query(k) and not n]
    if no_tc or not any(map(bf16_query, hmma)):
        raise AssertionError(f"bf16-query wide paged kernels without HMMA: {no_tc}")
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
        if "bf16_bound_x" in gates and name == "paged_attention":
            limits.append((f"{gates['bf16_bound_x']}x its bound",
                           gates["bf16_bound_x"] * bound))
        for what, limit in limits:
            if ms > limit:
                failures.append(f"{name} at {label}: {ms:.5f} ms > {what} "
                                f"({limit:.5f} ms)")
    del q, k, v, kq, ks, vq, vs, timed
    release()
    return rec


def phase1() -> dict:
    say("== phase 1: kernels against their plain versions")
    t0 = time.perf_counter()
    errs = {route: {"paged_attention": 0.0, "paged_attention_quant": 0.0}
            for route in pa.ROUTES}
    for label, shape in PAGED_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            paged_checks(label, shape, dtype, errs[pa.route(shape[3])])
            release()
    torch.cuda.synchronize()
    ptxas = paged_ptxas()

    failures = []
    times = {key: paged_times(key, label, gates, failures)
             for key, (label, gates) in PAGED_TIMED.items()}
    wide_keys = [key for key in PAGED_TIMED if key.startswith("wide")]
    goals = paged_wide_goals({key: times[key] for key in wide_keys})
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
            "max_abs_err": errs["narrow"][name], **times["serving"][name],
            "at_long_context": times["long_context"][name],
            "at_starcoder2": times["starcoder2"][name],
            "ptxas": ptxas,
        }
        rec[name + "_wide"] = {
            "name": name + "_wide", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": replaces, "launches": 0,
            "design": "paged_wide_kernel past 256 columns: each span's whole "
                      "K and V rows by bulk copies, all in flight at once (a "
                      "cp.async ring of 64-column boxes where they do not "
                      "fit); scores of bf16 queries and p V over bf16 pools "
                      "on mma.sync; the narrow route's spans, combine in "
                      "128-column slices",
            "main_path": "no configuration has a paged head past 256 (MLA "
                         "decodes in latent space with einsums): the serving "
                         "phases gate these launches at 0; phase 1 holds the "
                         "kernel against the plain version",
            "max_abs_err": errs["wide"][name],
            **times["wide_576_long"][name],
            **{f"at_{key}": times[key][name] for key in wide_keys
               if key != "wide_576_long"},
            "goals": goals[name],
            "ptxas": {k: e for k, e in ptxas.items() if "paged_wide_kernel" in k},
        }
    say(f"  phase 1 took {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError("paged kernel gates failed:\n  "
                             + "\n  ".join(failures))
    return rec


def paged_wide_goals(times: dict) -> dict:
    """Whether each wide kernel met ``PAGED_WIDE_GOALS`` at each wide timed
    shape (reported, not gated)."""
    out = {}
    for name, bound_x in (("paged_attention", PAGED_WIDE_GOALS["bf16_bound_x"]),
                          ("paged_attention_quant",
                           PAGED_WIDE_GOALS["int8_bound_x"])):
        out[name] = {}
        for key, rec in times.items():
            r = rec[name]
            if key.endswith("_long"):
                goal, limit = f"<= {bound_x}x the bound", bound_x * r["bound_ms"]
            else:
                goal, limit = (f"<= {PAGED_WIDE_GOALS['short_ms']} ms",
                               PAGED_WIDE_GOALS["short_ms"])
            out[name][key] = {"goal": goal, "limit_ms": limit,
                              "ms": r["ms"], "met": r["ms"] <= limit}
            say(f"  goal {name} at {key}: {r['ms']:.5f} ms, {goal} "
                f"({limit:.5f} ms): {'met' if r['ms'] <= limit else 'missed'}")
    return out


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
    for fn in (pa.paged_attention, pa.paged_attention_quant):
        fn.launches = 0
        fn.by_route = dict.fromkeys(fn.by_route, 0)


def wide_serving_launches(name: str, kernels: dict) -> None:
    """The wide route's launches in the serving run just ended, counted by
    route where the wrapper launches (phi3's heads are 96 wide: 0, gated),
    into the kernels line's wide entry."""
    fn = getattr(pa, name)
    wide = fn.by_route["wide"]
    say(f"  {name} launches by route: {fn.by_route}")
    if wide or fn.by_route["narrow"] != fn.launches:
        raise AssertionError(f"{name}: {fn.by_route} by route, {fn.launches} "
                             "in all; the served heads are narrow")
    kernels[name + "_wide"]["launches"] = wide


def release() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def serve(cfg: ServeConfig, prompts, max_new=MAX_NEW):
    """Serve ``prompts`` through ``Serve.local(cfg)``; returns the outputs,
    stats, wall seconds, the number of token iterations that ran the
    decode step (prefill chunks included) and the layer count."""
    torch.cuda.reset_peak_memory_stats()
    srv = Serve.local(cfg)
    sids = [srv.submit(p, max_new=max_new) for p in prompts]
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


def flash_bound_ms(b, tq, tk, hq, hkv, d, elem, backward, dv=None,
                   causal=True, prefix_len=0) -> tuple:
    """Least time for one call (``kernels.work.flash_fwd`` / ``flash_bwd``):
    q, k, v (and o, dO for the backward) read once, o or dq, dk, dv written
    once, plus the f32 log-sum-exp; against 2 flops per multiply-add over
    the visible (query, key) pairs this run has (forward: Q K^T over d and
    P V over dv; backward: Q K^T, dS K and dS^T Q over d, dO V^T and P^T
    dO over dv) at the inputs' peak rate."""
    dv = d if dv is None else dv
    fn = work.flash_bwd if backward else work.flash_fwd
    return bound_ms(fn(b, tq, tk, hq, hkv, d, dv, elem, causal, prefix_len),
                    "bfloat16" if elem == 2 else "float32")


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
    name = re.compile(r"hopper\d+(fwd_kernel|dq_kernel|dkdv_kernel)ILi(\d+)ELi(\d+)E"
                      r"|hopper\d+(wide_(?:fwd|dq|dkdv)_kernel)(?:ILi(\d)E)?")

    def key_of(m):
        """ "fwd_kernel<96,96>"; past 256 the widths are taken at run time:
        "wide_dq_kernel", and "wide_fwd_kernel<2>" / "<4>" by the boxes a
        warpgroup takes of V's columns """
        if m is None:
            return None
        if m[1]:
            return f"{m[1]}<{m[2]},{m[3]}>"
        return m[4] + (f"<{m[5]}>" if m[5] else "")

    log = _build.build_log.get("flash_attention")
    if log is None:
        raise AssertionError("no ptxas report: flash_attention.cu was not built "
                             "by this run (delete build/repro_torch_kernels)")
    report, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = key_of(name.search(line))
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
            cur = key_of(name.search(line))
        elif cur:
            report[cur]["HGMMA"] += " HGMMA." in line
            report[cur]["UTMALDG"] += " UTMALDG." in line
    lib = _build.library("flash_attention")
    for key, entry in report.items():
        if key.startswith("wide_"):   # at widths that take it
            kind = key[5:].split("<")[0]
            d, dv = (576, 256) if key.endswith("<2>") else (576, 512)
        else:
            kind, dims = key[:-1].split("<")
            d, dv = map(int, dims.split(","))
        entry["dynamic_smem_bytes"] = lib.repro_flash_bf16_smem(
            ("fwd_kernel", "dq_kernel", "dkdv_kernel").index(kind), d, dv)
        say(f"  {key}: {entry['registers']} registers, spill stores "
            f"{entry['spill_stores']} B / loads {entry['spill_loads']} B, "
            f"{entry['dynamic_smem_bytes']} B dynamic shared memory; SASS "
            f"HGMMA {entry['HGMMA']}, UTMALDG {entry['UTMALDG']}")
    fwd_wide, *bwd_wide = fa.ROUTE_KERNELS["bf16_wide"]
    want = ({f"{k}<{d},{dv}>" for k in fa.ROUTE_KERNELS["bf16"]
             for d, dv in fa.BF16_PAIRS} | set(bwd_wide)
            | {f"{fwd_wide}<2>", f"{fwd_wide}<4>"})
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
        # the wide kernels' own entries (main) take these
        rec[name]["sass_wide"] = {k: v for k, v in sass.items()
                                  if k.split("<")[0] in {"wide_" + n for n in names}}
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
    state; ``kernels.work.wkv6_fwd`` and the rest): every input read once
    and every output written once, over HBM bandwidth -- the forward
    writes y and the final state, the backward reads the inputs and dy and
    writes their gradients (no state-shaped tensor: there is no initial
    state to differentiate, and the saved chunk states are the kernel's
    choice, not the function's); against the multiply-adds of the
    recurrence (5 flops per state element and token forward, 14 backward:
    the states, G, and the four gradient contractions) at the inputs' peak
    rate."""
    fn = {("wkv6", False): work.wkv6_fwd, ("wkv6", True): work.wkv6_bwd,
          ("ssd", False): work.mamba2_ssd_fwd,
          ("ssd", True): work.mamba2_ssd_bwd}[kind, backward]
    return bound_ms(fn(*shape, elem), "bfloat16" if elem == 2 else "float32")


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


def sdpa_decode_ms(q, k, v, table, lengths) -> dict:
    """Paged decode as one SDPA call over the cache gathered beforehand
    (kv heads repeated, the lengths as a boolean mask), each backend pinned
    in turn, by CUDA events: the fastest that takes it, and the refusals."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    n, page, hkv, d = k.shape
    g = q.shape[1] // hkv
    tb = table.clamp(0, n - 1).long()
    kc, vc = (ref.gather_pages(x, tb).to(q.dtype).repeat_interleave(g, 2)
              .transpose(1, 2).contiguous() for x in (k, v))
    s = tb.shape[1] * page
    mask = (torch.arange(s, device=q.device)[None, :]
            < lengths[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    best, refused = None, []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        name = f"sdpa/{backend.name.lower().replace('_attention', '')}"
        call = lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kc, vc, attn_mask=mask)
        try:
            with sdpa_kernel(backend):
                call()
                ms = time_ms(call, iters=20, warmup=3)
        except RuntimeError:
            refused.append(name)
            continue
        if best is None or ms < best[0]:
            best = (ms, name)
    return {"library_ms": None if best is None else best[0],
            "library": "none" if best is None else best[1],
            "refused": refused}


def repair_paged(label, shape) -> dict:
    """The paged kernels (plain and int8 pools, float32 and bfloat16, the
    multi-token folds) against their plain versions at one width, twice
    bit-identical; bf16 times beside the bound and the fastest SDPA."""
    b, hq, hkv, d, page, n_p, lens = shape
    errs = {"paged_attention": 0.0, "paged_attention_quant": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        paged_checks(f"{label}", shape, dtype, errs)
    q, k, v, table, lengths = make_case(b, hq, hkv, d, page, n_p, lens,
                                        torch.bfloat16, seed=SEED + 16)
    k, v = k[0], v[0]
    kq, ks = ref.quantize_pages(k)
    vq, vs = ref.quantize_pages(v)
    calls = {"paged_attention": lambda: ops.paged_attention(q, k, v, table,
                                                            lengths),
             "paged_attention_quant": lambda: ops.paged_attention_quant(
                 q, kq, ks, vq, vs, table, lengths)}
    rec = {"shape": [b, hq, hkv, d, page, n_p, lens],
           "kernel_d": -(-d // 8) * 8}
    lib = sdpa_decode_ms(q, k, v, table, lengths)
    for name, call in calls.items():
        if not torch.equal(call(), call()):
            raise AssertionError(f"{name} {label}: a repeated run gave other "
                                 "bits")
        bound, by = kernel_bound_ms(q, kq if name.endswith("quant") else k,
                                    table, lengths,
                                    quant=name.endswith("quant"))
        plain = {"paged_attention": lambda: ops.paged_attention(
                     q, k, v, table, lengths, use_kernel=False),
                 "paged_attention_quant": lambda: ops.paged_attention_quant(
                     q, kq, ks, vq, vs, table, lengths, use_kernel=False)}[name]
        rec[name] = {"ms": time_ms(call, iters=20, warmup=3),
                     "plain_ms": time_ms(plain, iters=5, warmup=1),
                     "bound_ms": bound, "bound_by": by,
                     "max_abs_err": errs[name], **lib}
        say(f"  {name} {label} bf16 (kernel at D {rec['kernel_d']}): "
            f"{rec[name]['ms']:.5f} ms, plain {rec[name]['plain_ms']:.5f} ms, "
            f"bound {bound:.5f} ({by}); "
            f"{lib['library']} {lib['library_ms']}, refused {lib['refused']}")
    return rec


def phase10_repairs() -> dict:
    """Faults 5 and 3 repaired: the scans' final-state gradient, the scans
    past 64, flash at every width (past 256 on the wide kernels) and the
    paged kernels off a multiple of 8 and past 256, each against its plain
    version, twice bit-identical, with bf16 times."""
    say("== phase 10 (repairs): the scans' final-state gradient and widths "
        "past 64; flash and paged at every head width")
    f32, bf16 = torch.float32, torch.bfloat16
    out = {"wkv6": {}, "ssd": {}, "flash": {}, "paged": {}}
    for kind, shapes in REPAIR_SCANS.items():
        for label, shape in shapes.items():
            errs = {str(dtype)[6:]: scan_state_grad(kind, shape, dtype)
                    for dtype in (f32, bf16)}
            out[kind][label] = dict(scan_repair_ms(kind, shape), errors=errs)
            release()
    for label, shape in REPAIR_FLASH.items():
        # the widths up to 256 are checked, not timed (their times beside
        # every SDPA form were cut for time: PERF.md keeps the last ones)
        out["flash"][label] = repair_flash(label, shape, timed=shape[5] > 256)
        release()
    out["flash_masks"] = {
        label: repair_flash(label, shape[:7], *shape[7:], timed=False)
        for label, shape in REPAIR_FLASH_MASKS.items()}
    for label, shape in REPAIR_PAGED.items():
        out["paged"][label] = repair_paged(label, shape)
        release()
    out["flash_grid"] = {label: repair_grid(label, shape)
                         for label, shape in REPAIR_GRID.items()}
    release()
    return out


def repair_grid(label, shape) -> dict:
    """Flash past the grid's y / z limit, forward and backward, f32 and
    bf16, against the plain version (phase 6's tolerances)."""
    b, tq, tk, hq, hkv, d, dv = shape
    slices = -(-dv // fa.WIDE_ABOVE) if fa.is_wide(d, dv) else 0
    rec = {"shape": [b, tq, tk, hq, hkv, d, dv], "wide": fa.is_wide(d, dv),
           "fwd_slice_blocks": hq * slices,
           "dkdv_slice_blocks": hkv * (-(-d // fa.WIDE_ABOVE)
                                       + -(-dv // fa.WIDE_ABOVE)) if slices
           else 0}
    for dtype in (torch.float32, torch.bfloat16):
        tag = f"{label} {str(dtype)[6:]}"
        q, k, v, dout = flash_inputs(b, tq, tk, hq, hkv, d, dtype,
                                     seed=SEED + 16, dv=dv)
        got = flash_grads(q, k, v, dout, None)
        want = flash_grads(q, k, v, dout, False)
        if dtype == torch.bfloat16:
            err = check_close(f"flash fwd {tag}", got[0], want[0],
                              **FLASH_BF16_TOL)
            for name, g, w in zip(("dQ", "dK", "dV"), got[1:], want[1:]):
                err = max(err, check_close(f"flash bwd {name} {tag}", g, w,
                                           **FLASH_BF16_TOL))
        else:
            # float32 sums of 512 products: over 2^28 outputs the plain
            # version's own rounding reaches past phase 6's tolerance, so
            # the kernel is held against float64 (no farther from it than
            # the plain version, or FLASH_F64_ATOL)
            exact = flash_grads(q.double(), k.double(), v.double(),
                                dout.double(), False)
            err = 0.0
            for name, g, w, e in zip(("out", "dQ", "dK", "dV"), got, want,
                                     exact):
                kern = (g.double() - e).abs().max().item()
                plain = (w.double() - e).abs().max().item()
                err = max(err, (g - w).abs().max().item())
                say(f"  flash {name} {tag}: distance to float64 kernel "
                    f"{kern:.3e}, plain {plain:.3e} (limit max(plain, "
                    f"{FLASH_F64_ATOL}))")
                if kern > max(plain, FLASH_F64_ATOL):
                    raise AssertionError(f"flash {name} {tag}: the kernel lies "
                                         f"{kern:.3e} from float64")
            del exact
        rec[f"max_abs_err_{str(dtype)[6:]}"] = err
        del q, k, v, dout, got, want
        release()
    say(f"  flash {label}: {rec['fwd_slice_blocks'] or b} forward blocks "
        "past grid y / z's 65,535 held against the plain version")
    return rec


def repair_flash(label, shape, causal=True, prefix_len=0, timed=True) -> dict:
    """Flash at one (D, Dv) against the plain version, forward and
    backward, f32 (also against float64) and bf16, twice bit-identical;
    where ``timed``, bf16 times beside the bound and every SDPA form that
    takes the call (and those that refuse it)."""
    b, tq, tk, hq, hkv, d, dv = shape
    f32, bf16 = torch.float32, torch.bfloat16
    rec = {"shape": [b, tq, tk, hq, hkv, d, dv], "wide": fa.is_wide(d, dv),
           "causal": causal, "prefix_len": prefix_len,
           "route": {str(t)[6:]: fa.route(t, d, dv) for t in (f32, bf16)},
           "kernel_dims": {"float32": list(fa.padded_dims(d, dv)),
                           "bfloat16": list(fa.bf16_kernel_dims(d, dv))}}
    for dtype in (f32, bf16):
        tol = FLASH_F32_TOL if dtype == f32 else FLASH_BF16_TOL
        bwd_tol = FLASH_BWD_F32_TOL if dtype == f32 else FLASH_BF16_TOL
        tag = f"(D, Dv) = {label} {str(dtype)[6:]}"
        q, k, v, dout = flash_inputs(b, tq, tk, hq, hkv, d, dtype,
                                     seed=SEED + 14, dv=dv)
        got = flash_grads(q, k, v, dout, None, causal, prefix_len)
        want = flash_grads(q, k, v, dout, False, causal, prefix_len)
        if dtype == bf16 and label in FLASH_BF16_AGAINST_F64:
            exact = flash_grads(q.double(), k.double(), v.double(),
                                dout.double(), False, causal, prefix_len)
            for name, g, w, e in zip(("out", "dQ", "dK", "dV"), got, want,
                                     exact):
                say(f"    {name}: distance to float64 kernel "
                    f"{(g.double() - e).abs().max().item():.3e}, plain bf16 "
                    f"{(w.double() - e).abs().max().item():.3e}")
            want = exact
            tag += " against float64"
        err = check_close(f"flash fwd {tag}", got[0], want[0], **tol)
        for name, g, w in zip(("dQ", "dK", "dV"), got[1:], want[1:]):
            err = max(err, check_close(f"flash bwd {name} {tag}", g, w,
                                       **bwd_tol))
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
        again = flash_grads(q, k, v, dout, None, causal, prefix_len)
        if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
            raise AssertionError(f"flash {tag}: a repeated run gave other "
                                 "bits")
        rec[f"max_abs_err_{str(dtype)[6:]}"] = err
        del q, k, v, dout, got, want, again
        release()
    if not timed:
        return rec
    q, k, v, dout = flash_inputs(b, tq, tk, hq, hkv, d, bf16,
                                 seed=SEED + 15, dv=dv)
    o, lse = fa.flash_attention_fwd(q, k, v)
    rec["fwd_ms"] = time_ms(lambda: fa.flash_attention_fwd(q, k, v),
                            iters=20, warmup=3)
    rec["bwd_ms"] = time_ms(
        lambda: fa.flash_attention_bwd(q, k, v, o, lse, dout), iters=20,
        warmup=3)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    plain_out = ref.flash_attention(qr, kr, vr, causal=True)
    rec["plain_fwd_ms"] = time_ms(lambda: ref.flash_attention(q, k, v),
                                  iters=5, warmup=1)
    rec["plain_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        plain_out, (qr, kr, vr), dout, retain_graph=True), iters=5, warmup=1)
    del qr, kr, vr, plain_out
    rec["fwd_bound_ms"], rec["fwd_bound_by"] = flash_bound_ms(
        b, tq, tk, hq, hkv, d, 2, False, dv=dv)
    rec["bwd_bound_ms"], rec["bwd_bound_by"] = flash_bound_ms(
        b, tq, tk, hq, hkv, d, 2, True, dv=dv)
    say(f"  flash {label} bf16 at {rec['kernel_dims']['bfloat16']} "
        f"({rec['route']['bfloat16']}): "
        f"forward {rec['fwd_ms']:.5f} ms (bound {rec['fwd_bound_ms']:.5f}, "
        f"plain {rec['plain_fwd_ms']:.5f}), backward {rec['bwd_ms']:.5f} ms "
        f"(bound {rec['bwd_bound_ms']:.5f}, plain {rec['plain_bwd_ms']:.5f})")
    refused = []
    say(f"  SDPA at {label}:")
    lib = sdpa_best_ms(q, k, v, dout, True, 0, refused=refused)
    rec.update(library_fwd_ms=lib["fwd"][0], library_fwd=lib["fwd"][1],
               library_bwd_ms=lib["bwd"][0], library_bwd=lib["bwd"][1],
               library_refused=refused)
    return rec


def wide_flash_entry(kind, repairs, sass, launches) -> dict:
    """The kernels line's entry for the bf16 wide kernels (heads past 256,
    ``route`` "bf16_wide"), forward or backward: ``launches`` on the main
    path (phase 8's run, counted by route), times at absorbed MLA's MQA
    case, each wide width's beside them, the largest bf16 error over phase
    10's wide and masked cases."""
    name = f"flash_attention_{kind}_wide"
    wide = {label: r for label, r in repairs["flash"].items() if r["wide"]}
    head = wide["(576, 512) MQA T 1024"]
    errs = [r["max_abs_err_bfloat16"] for r in wide.values()] + [
        r["max_abs_err_bfloat16"] for r in repairs["flash_masks"].values()
        if r["wide"]]
    keys = (f"{kind}_ms", f"plain_{kind}_ms", f"{kind}_bound_ms",
            f"{kind}_bound_by", f"library_{kind}_ms", f"library_{kind}")
    b, tq, tk, hq, hkv, d, dv = head["shape"]
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:123",
        "design": "wgmma+tma past 256 columns: " + (
            "wide_fwd_kernel" if kind == "fwd" else
            "delta, wide_dq_kernel, wide_dkdv_kernel") +
            "; contractions streamed through a ring of 64 x 64 box pairs "
            "split between two consumer warpgroups on the same 64 rows, each "
            "block a slice of <= 256 output columns (the forward's 512 where "
            "V is wider than 256)",
        "launches": launches,
        "main_path": "no configuration has a head past 256 (paligemma-3b's "
                     "256 is the widest): every main-path run gates these "
                     "launches at 0; phase 10 holds them against the plain "
                     "version",
        "max_abs_err": max(errs),
        "ms": head[f"{kind}_ms"], "plain_ms": head[f"plain_{kind}_ms"],
        "bound_ms": head[f"{kind}_bound_ms"],
        "bound_by": head[f"{kind}_bound_by"],
        "library_ms": head[f"library_{kind}_ms"],
        "library": head[f"library_{kind}"],
        "shape": {"B": b, "Tq": tq, "Tk": tk, "Hq": hq, "Hkv": hkv, "D": d,
                  "Dv": dv, "dtype": "bfloat16", "causal": True},
        "at_widths": {label: {k: r[k] for k in keys}
                      for label, r in wide.items()},
        "masks": repairs["flash_masks"],
        "sass": sass}


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


def train_plain(cfg) -> tuple:
    """The uninterrupted run without checkpoints: the trainer's steps in
    order (same init, same batches, same optimizer), as phases 11-12 run
    theirs; returns the manifest a checkpoint of the final state would
    carry, the losses, the step walls and the final state (host tensors,
    as a restore gives them)."""
    model = get_model(cfg)
    state = init_train_state(SEED, cfg, model, device=DEVICE)
    pipe = TokenPipeline(cfg.vocab_size, global_batch=TRAIN["batch"],
                         seq_len=TRAIN["seq"], seed=SEED)
    step = make_train_step(cfg, model, AdamWConfig(
        lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"]))
    losses, walls = [], []
    for _ in range(TRAIN["steps"]):
        batch = {k: torch.from_numpy(v).to(DEVICE)
                 for k, v in pipe.next_batch().items()}
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
    manifest = serialize_state_stream(state_to_numpy(state)).manifest
    return manifest, losses, walls, tree_map(lambda t: t.detach().cpu(), state)


def train_run(cfg, root: Path, failures):
    """``examples/quickstart.py``'s loop on the card; returns the report,
    the final checkpoint's manifest and the bytes on disk."""
    cluster = VirtualCluster(n_cluster=4, n_booster=4, root=root)
    scr = SCRManager(cluster, TierStack.for_cluster(cluster),
                     strategy=Strategy.BUDDY, procs_per_node=2,
                     async_drain=True)
    pipeline = TokenPipeline(cfg.vocab_size, global_batch=TRAIN["batch"],
                             seq_len=TRAIN["seq"], seed=SEED)
    with ResilienceSession(scr, policy=IntervalPolicy(TRAIN["ckpt_every"])
                           ) as session:
        trainer = Trainer(cfg, get_model(cfg), pipeline, session,
                          opt_cfg=AdamWConfig(lr=TRAIN["lr"],
                                              warmup_steps=TRAIN["warmup"]),
                          failure_schedule=failures, seed=SEED, device=DEVICE)
        report = trainer.run(total_steps=TRAIN["steps"])
        manifest = scr._descriptor(TRAIN["steps"])["manifest"]
        on_disk = dir_bytes(root)
    cluster.teardown()
    return report, manifest, on_disk


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
        # the uninterrupted run without checkpoints (a Trainer run with
        # two checkpoints and a restore before a cut for time); its final
        # state goes on to phase 9
        clean_manifest, losses, walls, state = train_plain(cfg)
        say(f"  uninterrupted (no checkpoints): loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}; step median "
            f"{1e3 * sorted(walls)[len(walls) // 2]:.1f} ms (first "
            f"{1e3 * walls[0]:.1f} ms); final state sha256 "
            f"{clean_manifest['sha256'][:16]}.. over "
            f"{clean_manifest['total_bytes']} bytes")
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
        reset_flash_launches()
        torch.cuda.reset_peak_memory_stats()
        try:
            faulty, manifest, disk = train_run(
                cfg, tmp / "faulty",
                [FailureEvent(step=TRAIN["fail_step"], rank=TRAIN["fail_rank"])])
        finally:
            ref.flash_attention = plain_fn
            torch.nn.functional.scaled_dot_product_attention = sdpa_fn
        fwd, bwd = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
        wide = wide_flash_launches()
        peak = torch.cuda.max_memory_allocated()
        report_train("node kill", faulty, manifest, disk)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"  node kill: flash launches forward {fwd}, backward {bwd} over "
        f"{faulty.steps_run} steps x {layers} layers (of them past 256 "
        f"columns: {wide}); plain attention calls "
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
    if any(wide.values()):
        raise AssertionError(f"phi3's heads of 96 launched the kernels past "
                             f"256 columns: {wide}")
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
    return state, cfg, {"fwd": fwd, "bwd": bwd, **wide, "main_path": main_path}


def phase9(state) -> dict:
    say("== phase 9: NAM_XOR checkpoint of the phase-8 parameters, node "
        "kill, parity through the XOR kernel")
    step = TRAIN["steps"]
    # the parameters alone (a third of the state with AdamW's moments)
    state = state["params"]
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
    bound = work.xor_reduce(r, m)[1] / HBM_BYTES_PER_S * 1e3
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
            "flash_attention_bwd": fa.flash_attention_bwd.launches,
            **{f"flash_attention_{k}": n for k, n in wide_flash_launches().items()}}


def wide_flash_launches() -> dict:
    """The flash wrappers' launches past 256 columns (route "bf16_wide"),
    counted where they launch, since the counts were last reset."""
    return {"fwd_wide": fa.flash_attention_fwd.by_route["bf16_wide"],
            "bwd_wide": fa.flash_attention_bwd.by_route["bf16_wide"]}


def reset_flash_launches() -> None:
    for fn in (fa.flash_attention_fwd, fa.flash_attention_bwd):
        fn.launches = 0
        fn.by_route = dict.fromkeys(fn.by_route, 0)


def reset_family_launches() -> None:
    for fn in (wkv.wkv6_fwd, wkv.wkv6_bwd, ssd.ssd_fwd, ssd.ssd_bwd):
        fn.launches = 0
    reset_flash_launches()


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


def family_want(cfg, kernels: tuple, steps: int) -> dict:
    """The kernel launches a family's training makes in ``steps`` steps."""
    layers = cfg.n_layers
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
    if "flash_attention_fwd" in want:
        # no configuration has a head past 256 columns
        want["flash_attention_fwd_wide"] = want["flash_attention_bwd_wide"] = 0
    return want


def family_twice(arch, cfg, model, kernels, seq, prefill, f32_err) -> dict:
    """Training at published width with the depth cut, twice and
    uninterrupted under deterministic algorithms: each run's kernel
    launches counted from zero and no plain call, a falling loss, and the
    two final states the same bytes."""
    say(f"  training: published width, depth cut {get_config(arch).n_layers}"
        f" -> {cfg.n_layers} layers; B {FAMILY['batch']} x T {seq}, "
        f"{FAMILY['steps']} steps, twice, no checkpoints (the node-kill run "
        "is phases 8 and 16 (d)'s)")
    torch.use_deterministic_algorithms(True)
    runs = []
    try:
        for i in range(2):
            torch.cuda.reset_peak_memory_stats()
            reset_family_launches()
            with counting_calls(PLAIN_SCANS) as plain:
                manifest, losses, walls, _ = clean_sha(cfg, model, seq)
            runs.append((manifest, losses, family_launches(), dict(plain)))
            steps = sorted(walls[1:])
            say(f"  run {i + 1}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
                f"step median {1e3 * steps[len(steps) // 2]:.1f} ms (first "
                f"{1e3 * walls[0]:.1f} ms); launches {runs[-1][2]}; plain "
                f"calls {runs[-1][3]}; peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; sha256 "
                f"{manifest['sha256'][:16]}.. over {manifest['total_bytes']} "
                "bytes")
    finally:
        torch.use_deterministic_algorithms(False)
    want = family_want(cfg, kernels, FAMILY["steps"])
    for manifest, losses, launches, plain in runs:
        for name, n in want.items():
            if launches[name] != n:
                raise AssertionError(f"{launches[name]} {name} launches, "
                                     f"want {n}")
        if any(plain.values()):
            raise AssertionError(f"the training path called plain versions: "
                                 f"{plain}")
        if not losses[-1] < losses[0]:
            raise AssertionError("the loss did not fall")
    (m1, *_), (m2, *_) = runs
    if (m1["sha256"], m1["total_bytes"]) != (m2["sha256"], m2["total_bytes"]):
        raise AssertionError("two deterministic runs ended on different state "
                             "bytes")
    say(f"  both runs' final states byte-identical: sha256 "
        f"{m1['sha256'][:16]}.. over {m1['total_bytes']} bytes")
    release()
    return {"launches": {k: runs[0][2][k] for k in want},
            "main_path": {"arch": arch, "layers": cfg.n_layers,
                          "layers_published": get_config(arch).n_layers,
                          "batch": FAMILY["batch"], "seq": seq,
                          "steps_run": FAMILY["steps"]},
            "prefill": prefill, "f32_logits_err": f32_err}


def phase_family(phase: int, arch: str, kernels: tuple, seq=None) -> dict:
    """Full-depth prefill, then training at published width with the
    depth cut, one node killed, recovered, and the final state's SHA-256
    against the uninterrupted run's.  ``seq``: positions per sequence
    (default ``FAMILY["seq"]``)."""
    layers = FAMILY["layers"][arch]
    seq = FAMILY["seq"] if seq is None else seq
    say(f"== phase {phase}: {arch} through the {kernels[0].rsplit('_', 1)[0]} "
        "kernels: full-depth prefill, then training "
        + ("with a node kill" if arch in FAMILY["kill"] else "twice"))
    prefill = prefill_full_depth(arch, kernels, seq)
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = get_model(cfg)
    f32_err = check_kernel_path_f32(cfg, model)
    n_params = sum(p.numel() for p in tree_leaves(model.param_shapes(cfg)))
    if arch not in FAMILY["kill"]:
        return family_twice(arch, cfg, model, kernels, seq, prefill, f32_err)
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
    want = family_want(cfg, kernels, steps)
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

# 6 requests share a 48-token system prompt (3 pages of 16) and add 8-32
# tokens of their own; the resilient runs' pool of 80 pages holds five
# lanes, so 6 streams over 4 slots must spill.
RESILIENT = dict(system=48, own=(8, 32), pool_pages=80, fail_rank=1,
                 requests=6, max_new=6)


def resilient_requests(vocab: int):
    rng = np.random.default_rng(SEED)
    system = rng.integers(0, vocab, size=RESILIENT["system"]).tolist()
    lo, hi = RESILIENT["own"]
    return [system + rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))
                                  ).tolist() for _ in range(RESILIENT["requests"])]


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
    max_new = RESILIENT["max_new"]
    say(f"  {len(prompts)} requests of {[len(p) for p in prompts]} tokens "
        f"({RESILIENT['system']} shared), max_new={max_new}, spec_k=3; "
        f"slots {SERVE['slots']}, max_len {SERVE['max_len']}, page "
        f"{SERVE['page_tokens']}, quantum {SERVE['quantum']}")
    base = dict(SERVE, spec_k=3)
    runs = {}
    runs["a"] = resilient_run("(a) plain", ServeConfig(**base), prompts,
                              max_new)
    say("  (a) emitted tokens sha256[:16] = " + hashlib.sha256(json.dumps(
        runs["a"]["outs"]).encode()).hexdigest()[:16])
    resilient = ServeConfig(**dict(base, prefix=True,
                                   pool_pages=RESILIENT["pool_pages"]))
    runs["b"] = resilient_run("(b) resilient", resilient, prompts, max_new)
    runs["c"] = resilient_run("(c) kill and restore", resilient, prompts,
                              max_new, kill=True)

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
    seconds = time.perf_counter() - t_phase
    say(f"  phase 13 took {seconds:.1f} s")
    if failures:
        raise AssertionError("phase 13 gates failed:\n  "
                             + "\n  ".join(failures))
    say("  (b) and (c) emitted (a)'s tokens")
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
MLA_REQUESTS = dict(n=4, system=16, own=(0, 32), max_new=4)   # 8 x 8 before a cut


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
        "full-depth prefill, training twice, paged serving")
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
            "flash_attention_bwd": 3 * cfg.n_layers * FAMILY["steps"],
            # no configuration has a head past 256 columns
            "flash_attention_fwd_wide": 0, "flash_attention_bwd_wide": 0}
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


def sdpa_best_ms(q, k, v, dout, causal, prefix_len, refused=None) -> dict:
    """SDPA on the same inputs, each backend pinned in turn, kv heads given
    as they are (``enable_gqa``) and repeated over their groups; a causal
    call with a prefix passes its visibility as a boolean mask.  The
    fastest forms that take the call, forward and backward, by CUDA
    events, with every form's times and refusals printed (and the refusing
    forms' names appended to ``refused``)."""
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
                if refused is not None:
                    refused.append(name)
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
# fig13 --smoke decodes 160 new tokens a stream; cut to 16 to keep the
# script inside its time limit (the kill lands after the first epoch, a
# few tokens in, either way)
FLEET_RUN = dict(requests=8, shared=9, max_new=4,     # fig12 --smoke
                 reps=2,            # the 1- and 2-worker batches, repeated
                 criterion_prefix=12, noisy=6, quiet=3,
                 streams=4, elastic_max_new=16,       # fig13 --smoke: 160
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


# ---------------------------------------------------------------------- #
# phase 18: the task runtime, error-feedback compression, the collectives
# ---------------------------------------------------------------------- #

# fig10's FWI proxy (benchmarks/fig10_task_resilience.py): 8 frequency
# cycles as tasks on rank 5 over a 96 x 96 grid
FIG10 = dict(cycles=8, grid=96, fail_rank=5)
# (d): phase 9's XOR group block (rows of 128 int32) on each of 4 ranks, and
# one phi3-sized f32 leaf (d_model x d_model) for the two-level sum
XOR_RANKS, XOR_M = 4, 1_241_902
PSUM_SHAPE = (8192, 3072)
RANK_TIMEOUT_S = 60


def fwi_cycle(model, freq):
    """fig10's toy frequency-domain sweep: 20 Jacobi smoothing passes."""
    m = model
    for _ in range(20):
        lap = (torch.roll(m, 1, 0) + torch.roll(m, -1, 0)
               + torch.roll(m, 1, 1) + torch.roll(m, -1, 1) - 4 * m)
        m = m + 0.2 * lap + 0.01 * torch.sin(freq * m)
    return m


def fig10_scenario(cluster, fail_task, resilient, journal=None):
    """fig10's ``run_scenario`` on the card: -> (final model, stats,
    restarts, wall s).  With a journal every cycle is a persistent task."""
    n, g, rank = FIG10["cycles"], FIG10["grid"], FIG10["fail_rank"]
    rt = TaskRuntime(cluster, journal_tier=journal,
                     max_retries=3 if resilient else 0)
    start = lambda: torch.full((g, g), 0.5, device=DEVICE)
    model, restarts, cycle = start(), 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while cycle < n:
        try:
            if fail_task is not None and cycle == fail_task:
                cluster.arm_failure(rank, NodeState.FAILED_TRANSIENT)
                fail_task = None
            model = rt.run(f"cycle{cycle}_{restarts}", fwi_cycle, model,
                           torch.tensor(float(cycle + 1), device=DEVICE),
                           rank=rank, persistent=journal is not None)
            cycle += 1
        except TaskError:
            # no resiliency: a full application restart from cycle 0
            cluster.recover(rank)
            model, cycle = start(), 0
            restarts += 1
    torch.cuda.synchronize()
    return model, rt.stats, restarts, time.perf_counter() - t0


def phase18_tasks(root: Path) -> dict:
    """(a) fig10's three scenarios on the card, and the journal's replay."""
    n = FIG10["cycles"]
    say(f"  (a) fig10's scenarios: {n} cycles over a {FIG10['grid']}^2 grid on "
        f"the card, a failure armed on rank {FIG10['fail_rank']} at cycle {n - 1}")
    cluster = VirtualCluster(n_cluster=8, n_booster=8, root=root / "fig10")
    fig10_scenario(cluster, None, True)    # warm-up, as fig10 warms its jit
    journal = MemoryTier(TierSpec(TierKind.GLOBAL, 10**9, 1e9, 1e9, 0))
    clean, cst, _, t_clean = fig10_scenario(cluster, None, True, journal)
    res, rst, _, t_res = fig10_scenario(cluster, n - 1, True)
    rest, _, restarts, t_rest = fig10_scenario(cluster, n - 1, False)
    replay = TaskRuntime(cluster, journal_tier=journal)
    calls = []
    model = torch.full_like(clean, 0.5)
    for cycle in range(n):
        model = replay.run(f"cycle{cycle}_0", lambda *a: calls.append(1),
                           model, torch.tensor(float(cycle + 1), device=DEVICE),
                           rank=FIG10["fail_rank"], persistent=True)
    cluster.teardown()
    rec = {"wall_s": {"clean": t_clean, "resilient": t_res, "restart": t_rest},
           "restart_over_clean": t_rest / t_clean,
           "resilient_over_clean_minus_1": t_res / t_clean - 1,
           "retried": rst.retried, "restarts": restarts,
           "replayed": replay.stats.replayed,
           "replay_launches": replay.stats.launched,
           "clean_sum": float(clean.sum())}
    say(f"    wall s: clean {t_clean:.4f}, resilient {t_res:.4f}, no "
        f"resiliency {t_rest:.4f}; restart / clean {rec['restart_over_clean']:.3f} "
        f"(fig10 ~2x), resilient / clean - 1 "
        f"{rec['resilient_over_clean_minus_1']:+.3f} (fig10 ~+15%): readings")
    say(f"    retried {rst.retried}, restarts {restarts}; journal replay: "
        f"{replay.stats.replayed} replayed, {replay.stats.launched} launched, "
        f"on {model.device}; final sum {rec['clean_sum']!r}")
    failures = []
    if not torch.equal(res, clean):
        failures.append("(a) the resilient run's model differs from the clean "
                        "run's")
    if rst.retried != 1 or restarts != 1 or cst.retried:
        failures.append(f"(a) want 1 retry and 1 restart, got {rst.retried} "
                        f"and {restarts} (clean retried {cst.retried})")
    if (replay.stats.replayed != n or replay.stats.launched or calls
            or model.device.type != "cuda" or not torch.equal(model, clean)):
        failures.append("(a) the journal did not fast-forward every cycle "
                        "with 0 launches to the clean model on the card")
    return rec, failures


def phase18_step(root: Path) -> dict:
    """(b) one phi3 training step at phase 8's size wrapped in a task with
    a failure armed on its rank, against the same step outside."""
    cfg = train_arch(TRAIN["layers"])
    model = get_model(cfg)
    say(f"  (b) one train_step of phi3-mini-3.8b at published width, "
        f"{cfg.n_layers} layers, B {TRAIN['batch']} x T {TRAIN['seq']}, as a "
        f"task on rank {TRAIN['fail_rank']} with a failure armed there")
    torch.use_deterministic_algorithms(True)
    try:
        state = init_train_state(SEED, cfg, model, DEVICE)
        pipe = TokenPipeline(cfg.vocab_size, global_batch=TRAIN["batch"],
                             seq_len=TRAIN["seq"], seed=SEED)
        batch = {k: torch.from_numpy(v).to(DEVICE)
                 for k, v in pipe.batch_at(0).items()}
        step = make_train_step(cfg, model, AdamWConfig(
            lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"]))
        outside, out_metrics = step(state, batch)
        want_loss = float(out_metrics["loss"])
        nbytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(state) + list(batch.values()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = _snapshot((state, batch))
        snap_s = time.perf_counter() - t0
        del snap
        cluster = VirtualCluster(n_cluster=4, n_booster=4, root=root / "step")
        cluster.arm_failure(TRAIN["fail_rank"], NodeState.FAILED_TRANSIENT)
        rt = TaskRuntime(cluster, max_retries=2)
        t0 = time.perf_counter()
        got, metrics = rt.run("phi3_step", step, state, batch,
                              rank=TRAIN["fail_rank"])
        torch.cuda.synchronize()
        task_s = time.perf_counter() - t0
        # byte-identical: every leaf's bits equal, compared on the card
        bits = lambda t: t.view({1: torch.uint8, 2: torch.int16,
                                 4: torch.int32, 8: torch.int64}[t.element_size()])
        pairs = list(zip(tree_leaves(got), tree_leaves(outside)))
        same = all(a.shape == b.shape and a.dtype == b.dtype
                   and torch.equal(bits(a), bits(b)) for a, b in pairs)
        cluster.teardown()
    finally:
        torch.use_deterministic_algorithms(False)
    rec = {"snapshot_bytes": nbytes, "snapshot_s": snap_s, "task_s": task_s,
           "stats": dataclasses.asdict(rt.stats), "identical": same,
           "leaves": len(pairs), "loss": float(metrics["loss"])}
    say(f"    snapshot {nbytes} bytes to the host in {snap_s:.3f} s; the task "
        f"(failed attempt, retry from the snapshot, step) {task_s:.3f} s; "
        f"stats {rec['stats']}; the state's {len(pairs)} leaves bit-identical "
        f"to the step outside: {same}; loss {rec['loss']!r} (outside "
        f"{want_loss!r})")
    failures = []
    if rt.stats.retried != 1 or rt.stats.completed != 1 or rt.stats.launched != 2:
        failures.append(f"(b) want one retry from the snapshot, got "
                        f"{rec['stats']}")
    if not same or rec["loss"] != want_loss:
        failures.append("(b) the step in the task differs from the step "
                        "outside")
    del state, batch, got, outside, pairs
    release()
    return rec, failures


def phase18_compression() -> dict:
    """(c) a full-width phi3 gradient tree (phase 8's layers, shapes of the step's
    parameters, values from a seed) compressed and decompressed on the
    card; each leaf within half its scale (plus one float32 rounding of
    the product) of the gradient."""
    cfg = train_arch(TRAIN["layers"])
    shapes = get_model(cfg).param_shapes(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 18)
    grads = tree_map(lambda m: torch.randn(tuple(m.shape), generator=gen,
                                           device=DEVICE) * 1e-3, shapes)
    leaves = tree_leaves(grads)
    nbytes = sum(t.numel() * 4 for t in leaves)
    say(f"  (c) error-feedback int8 over {len(leaves)} gradient leaves, "
        f"{nbytes} bytes (phi3 at published width, {cfg.n_layers} layers)")
    residual = init_residual(grads)
    times = {}
    for _ in range(2):   # the second pass is timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qs, ss, rs = compress_grads(grads, residual)
        torch.cuda.synchronize()
        times["compress_s"] = time.perf_counter() - t0
        back = decompress_grads(qs, ss)
        torch.cuda.synchronize()
        times["decompress_s"] = time.perf_counter() - t0 - times["compress_s"]
    failures = []
    worst = 0.0
    for g, q, sc, b in zip(leaves, tree_leaves(qs), tree_leaves(ss),
                           tree_leaves(back)):
        bound = float(sc) / 2 + 127 * float(sc) * torch.finfo(torch.float32).eps
        err = (b - g).abs().max().item()
        worst = max(worst, err / float(sc))
        if q.dtype != torch.int8 or q.device != g.device or err > bound:
            failures.append(f"(c) a {tuple(g.shape)} leaf: |dequant - g| {err} "
                            f"> {bound} or q not int8 on the card")
    same = []
    for i in (0, len(leaves) // 2, len(leaves) - 1):
        cq, cs, _ = compress_grads({"g": leaves[i].cpu()},
                                   {"g": torch.zeros(leaves[i].shape)})
        same.append(torch.equal(cq["g"], tree_leaves(qs)[i].cpu())
                    and torch.equal(cs["g"], tree_leaves(ss)[i].cpu()))
    rec = {"leaves": len(leaves), "bytes": nbytes, **times,
           "compress_gb_s": nbytes / times["compress_s"] / 1e9,
           "decompress_gb_s": nbytes / times["decompress_s"] / 1e9,
           "max_err_over_scale": worst, "cpu_equal_checked": same}
    say(f"    compress {times['compress_s']:.4f} s ({rec['compress_gb_s']:.2f} "
        f"GB/s of gradient), decompress {times['decompress_s']:.4f} s "
        f"({rec['decompress_gb_s']:.2f} GB/s); max |dequant - g| / scale "
        f"{worst:.6f} (gate 0.5 + a rounding); q and scale equal to a CPU "
        f"run at 3 leaves: {same} (reading)")
    del grads, residual, qs, ss, rs, back, leaves
    release()
    return rec, failures


def xor_block(rank: int) -> torch.Tensor:
    """Rank ``rank``'s (XOR_M, 128) int32 block, from a seed, on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 180 + rank)
    return torch.randint(-2**31, 2**31 - 1, (XOR_M, 128), generator=gen,
                         dtype=torch.int32, device=DEVICE)


def psum_leaf(rank: int) -> torch.Tensor:
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 190 + rank)
    return torch.randn(PSUM_SHAPE, generator=gen, device=DEVICE)


def phase18_rank(rank: int, store: str, out: str) -> None:
    """One rank of (d), a spawned process with its own CUDA context: the
    butterfly XOR all-reduce of its block (gloo exchange through host
    buffers, each combine through the CUDA XOR kernel), then the two-level
    sum over a 2 x 2 grouping."""
    from datetime import timedelta

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, XOR_RANKS),
                            rank=rank, world_size=XOR_RANKS,
                            timeout=timedelta(seconds=RANK_TIMEOUT_S))
    try:
        x = xor_block(rank)
        plain = {"calls": 0}
        plain_fn = ref.xor_reduce

        def counted(*a, **kw):
            plain["calls"] += 1
            return plain_fn(*a, **kw)

        ref.xor_reduce = counted
        torch.cuda.synchronize()
        dist.barrier()
        xp.xor_reduce.launches = 0       # the main path's count, from zero
        rounds = []
        y = collectives.xor_all_reduce(x, rounds=rounds)
        launches = xp.xor_reduce.launches
        ref.xor_reduce = plain_fn
        digest = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
        inner, outer = collectives.grid_groups(2, 2)
        leaves = [psum_leaf(r) for r in range(XOR_RANKS)]
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        got = collectives.hierarchical_psum(leaves[rank], inner, outer)
        torch.cuda.synchronize()
        psum_s = time.perf_counter() - t0
        flat = leaves[0] + leaves[1] + leaves[2] + leaves[3]
        rec = {"rank": rank, "launches": launches, "plain_calls": plain["calls"],
               "rounds": rounds, "sha256": digest, "psum_s": psum_s,
               "psum_max_err": (got - flat).abs().max().item(),
               "psum_close": bool(torch.allclose(got, flat, rtol=1e-5,
                                                 atol=1e-5))}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps(rec))


def phase18_collectives(root: Path) -> tuple:
    """(d) the XOR all-reduce on its reference path: 4 ranks on the one
    card, gloo carrying the exchange through host buffers, the CUDA XOR
    kernel doing each combine; then the two-level sum."""
    import multiprocessing as mp

    say(f"  (d) xor_all_reduce over {XOR_RANKS} ranks (one process and CUDA "
        f"context each) of ({XOR_M}, 128) int32 blocks; hierarchical_psum "
        f"of a {PSUM_SHAPE} f32 leaf over a 2 x 2 grouping")
    want = None
    for r in range(XOR_RANKS):
        b = xor_block(r).cpu().numpy()
        want = b if want is None else np.bitwise_xor(want, b)
    want_sha = hashlib.sha256(want.tobytes()).hexdigest()
    del want, b
    release()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=phase18_rank,
                         args=(r, str(root / "store"), str(root / f"rank{r}.json")))
             for r in range(XOR_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + 4 * RANK_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    wall = time.perf_counter() - t0
    failures, held = [], True
    if any(p.exitcode != 0 for p in procs):
        return {"exitcodes": [p.exitcode for p in procs]}, [
            f"(d) ranks exited with {[p.exitcode for p in procs]}"]
    recs = [json.loads((root / f"rank{r}.json").read_text())
            for r in range(XOR_RANKS)]
    for rec in recs:
        r = rec["rank"]
        per = ", ".join(f"exchange {x['exchange_s']:.4f} s + kernel "
                        f"{x['combine_s']:.4f} s" for x in rec["rounds"])
        say(f"    rank {r}: rounds [{per}]; xor_reduce launches "
            f"{rec['launches']}, plain XOR calls {rec['plain_calls']}; "
            f"psum {rec['psum_s']:.4f} s, max |psum - flat sum| "
            f"{rec['psum_max_err']:.3e}")
        if rec["sha256"] != want_sha:
            held = False
            failures.append(f"(d) rank {r} does not hold the 4-way XOR")
        if rec["launches"] != 2 or rec["plain_calls"]:
            failures.append(f"(d) rank {r}: {rec['launches']} XOR kernel "
                            f"launches (want 2) and {rec['plain_calls']} plain "
                            "calls (want 0)")
        if not rec["psum_close"]:
            failures.append(f"(d) rank {r}: hierarchical_psum differs from "
                            "the flat sum")
    say(f"    every rank holds the numpy XOR of all four blocks: "
        f"{held} (sha256 {want_sha[:16]}..); "
        f"ranks' wall {wall:.2f} s with start-up")
    return {"ranks": recs, "wall_s": wall, "xor_sha256": want_sha}, failures


def phase18() -> dict:
    """The task runtime, error-feedback compression and the collectives on
    the card; every gate checked after every part has run."""
    say("== phase 18: the task runtime, error-feedback compression and the "
        "XOR all-reduce on the card")
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_p18_"))
    failures = []
    out = {}
    try:
        for key, part in (("tasks", phase18_tasks), ("step", phase18_step),
                          ("compression", lambda _: phase18_compression()),
                          ("collectives", phase18_collectives)):
            t1 = time.perf_counter()
            out[key], fails = part(root)
            out[key]["seconds"] = time.perf_counter() - t1
            say(f"    ({key}: {out[key]['seconds']:.1f} s)")
            failures += fails
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    say(f"  phase 18 took {out['seconds']:.1f} s")
    if failures:
        raise AssertionError("phase 18 gates failed:\n  " + "\n  ".join(failures))
    return out


# ---------------------------------------------------------------------- #
# phase 19: the mesh paths, the Cluster-Booster offload and the launcher
# ---------------------------------------------------------------------- #

# (a)-(b): Ulysses prefill at published width and full depth, (c) the MoE
# island of qwen2-moe-a2.7b (prefill at full depth; training at depth 1),
# over 2 ranks on the one card; (d) xPic split between a CPU Cluster rank
# and a Booster rank on the card; (e) the training launcher
P19 = dict(seqpar=("starcoder2-7b", "minicpm3-4b"), batch=2, seq=512,
           moe_arch="qwen2-moe-a2.7b", train_batch=4, train_seq=512,
           train_steps=3, lr=1e-3, warmup=2,
           xpic_part=2**24, xpic_grid=4096, xpic_steps=8, xpic_fail=3,
           launch=["--arch", "phi3-mini-3.8b", "--steps", "6",
                   "--ckpt-every", "2"], launch_fail=3)
P19_RANKS = 2
P19_PART_TIMEOUT_S = 300
# the reference's own bound for the sequence-parallel logits
# (tests/test_dryrun.py: max |a - b| / max |a| < 3e-2)
P19_LOGIT_REL = 3e-2
# bf16 training on a mesh against one process on the whole batch: loss and
# aux within 1% (the batch's rows and the experts' hidden dims split into
# other bf16 matmul shapes); a parameter within 2 lr a step of AdamW (an
# update is about lr whatever its gradient, so a near-zero gradient whose
# sign flips moves its parameter by up to 2 lr)
P19_LOSS_REL = 1e-2


def p19_config(arch, **kw):
    return dataclasses.replace(get_config(arch), tp=P19_RANKS, **kw)


def p19_mesh(data, model):
    from repro_torch.distributed.mesh import Mesh
    return Mesh((data, model), ("data", "model"))


@contextlib.contextmanager
def p19_counted():
    """Flash launches from zero, plain attention calls counted, and the
    gloo exchanges timed (synchronized), for one main-path run."""
    from repro_torch.distributed import collectives as C
    calls = {"plain": 0, "exchange_s": 0.0, "exchanges": 0}
    plain_fn = ref.flash_attention
    saved = {n: getattr(C, n)
             for n in ("_a2a", "_gather", "_sum", "average_gradients")}

    def plain(*a, **kw):
        calls["plain"] += 1
        return plain_fn(*a, **kw)

    def timed(fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            calls["exchange_s"] += time.perf_counter() - t0
            calls["exchanges"] += 1
            return out
        return wrapper

    ref.flash_attention = plain
    for n, fn in saved.items():
        setattr(C, n, timed(fn))
    reset_flash_launches()
    try:
        yield calls
    finally:
        ref.flash_attention = plain_fn
        for n, fn in saved.items():
            setattr(C, n, fn)
        calls["fwd"] = fa.flash_attention_fwd.launches
        calls["bwd"] = fa.flash_attention_bwd.launches


def tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def p19_prefill(rank, arch, params, tokens, logits, moe=False):
    """(a)-(c) on one rank: the prefill step on the mesh (counted), then
    the rank's block of the logits against the single-process forward's."""
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    cfg = p19_config(arch, seq_parallel=not moe)
    model = get_model(cfg)
    mesh = p19_mesh(1, P19_RANKS)
    local = (M.island_params if moe else T.seqpar_params)(params, cfg, mesh)
    shared = {id(t) for t in tree_leaves(params)}
    own = sum(t.numel() * t.element_size() for t in tree_leaves(local)
              if id(t) not in shared)
    step = make_prefill_step(cfg, model, mesh=mesh)
    batch = {"tokens": tokens}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with p19_counted() as calls:
        toks = step(local, batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.no_grad():
        got, _ = model.forward(local, batch, cfg, remat=False, mesh=mesh)
    ti = mesh.index("model")
    want = logits if moe else logits[:, ti * got.shape[1]:(ti + 1) * got.shape[1]]
    v = cfg.vocab_size       # the padded columns hold -1e30 on both sides
    err = (got[..., :v].float() - want[..., :v].float()).abs().max().item()
    scale = logits[..., :v].float().abs().max().item()
    # the flash call a rank makes: Ulysses, its heads over all of T (kv
    # heads repeated to them); the island, every head over its rows
    b, t = tokens.shape
    if moe:
        hq, hkv = cfg.padded_heads, cfg.padded_kv_heads
        d = dv = cfg.resolved_head_dim
    else:
        hq = hkv = cfg.padded_heads // P19_RANKS
        d = (cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim if cfg.mla
             else cfg.resolved_head_dim)
        dv = cfg.mla.v_head_dim if cfg.mla else d
    q_shape = (b, t, hq, hkv, d, dv)
    q, k, v, _ = flash_inputs(b, t, t, hq, hkv, d, torch.bfloat16, dv=dv)
    scale_qk = (d ** -0.5)
    flash_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, True, scale_qk),
                       iters=20, warmup=3)
    rec = {"rank": rank, "arch": arch, "tokens": toks.tolist(),
           "wall_s": wall, "exchange_s": calls["exchange_s"],
           "exchanges": calls["exchanges"], "fwd": calls["fwd"],
           "plain": calls["plain"], "max_abs_err": err, "max_abs_ref": scale,
           "own_bytes": own, "param_bytes": tensor_bytes(local),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "flash_ms": flash_ms, "flash_shape": list(q_shape)}
    del local, got, want, q, k, v
    return rec


def p19_fingerprint(tree) -> str:
    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def p19_train(rank, data, model_n, params, batches, ref_params, runs):
    """(c) training on one rank of a (data x model) mesh: ``runs`` runs of
    the steps from the same initial state; losses, aux, the final
    parameters' SHA-256 and their distance to the single-process run's."""
    from repro_torch.models import moe as M
    cfg = p19_config(P19["moe_arch"], n_layers=1)
    model = get_model(cfg)
    mesh = p19_mesh(data, model_n)
    step = make_train_step(cfg, model, AdamWConfig(lr=P19["lr"],
                                                   warmup_steps=P19["warmup"]),
                           mesh=mesh)
    local = M.island_params(params, cfg, mesh)
    ref_local = (None if ref_params is None
                 else M.island_params(ref_params, cfg, mesh))
    rec = {"rank": rank, "mesh": [data, model_n], "runs": []}
    torch.use_deterministic_algorithms(True)
    try:
        for run in range(runs):
            torch.cuda.reset_peak_memory_stats()
            state = {"params": local, "opt": adamw_init(local),
                     "step": torch.zeros((), dtype=torch.int32, device=DEVICE)}
            losses, auxes = [], []
            t0 = time.perf_counter()
            with p19_counted() as calls:
                for b in batches:
                    state, met = step(state, b)
                    losses.append(met["loss"].item())
                    auxes.append(met["router_aux"].item())
            wall = time.perf_counter() - t0
            dist_ = None if ref_local is None else max(
                (a.float() - w.float()).abs().max().item()
                for a, w in zip(tree_leaves(state["params"]),
                                tree_leaves(ref_local)))
            rec["runs"].append({
                "losses": losses, "aux": auxes, "wall_s": wall,
                "exchange_s": calls["exchange_s"], "fwd": calls["fwd"],
                "bwd": calls["bwd"], "plain": calls["plain"],
                "param_max_abs_diff": dist_,
                "sha256": (p19_fingerprint(state["params"]) if runs > 1
                           else None),
                "param_bytes": tensor_bytes(state["params"]),
                "peak_bytes": torch.cuda.max_memory_allocated()})
            del state, met
            release()
    finally:
        torch.use_deterministic_algorithms(False)
    del local, ref_local
    return rec


def xpic_field_solve(e_field, current):
    """Cluster side: the field from the deposited current (toy Maxwell).
    Its counterpart in the port's examples is
    ``examples/torch_xpic_offload.py``'s ``field_solve`` (the reference's
    is ``examples/xpic_offload.py``'s); this copy runs on a rank of a
    Cluster-Booster split, which the example, one process, does not."""
    lap = torch.roll(e_field, 1) - 2 * e_field + torch.roll(e_field, -1)
    return e_field + 0.1 * (0.5 * lap - current)


def xpic_particle_push(pos, vel, e_field):
    """Booster side: push the particles in the interpolated field and
    deposit the current (index_put with accumulate: deterministic), as
    ``examples/torch_xpic_offload.py``'s ``particle_push`` does, with the
    grid and particle counts taken from the inputs."""
    if pos.device.type != torch.device(DEVICE).type:
        raise AssertionError(f"the particle push ran on {pos.device}")
    grid, n = e_field.shape[0], pos.shape[0]
    cell = ((pos * grid).to(torch.int32) % grid).long()
    vel = vel + 0.1 * e_field[cell]
    pos = (pos + 0.1 * vel) % 1.0
    current = torch.zeros(grid, dtype=vel.dtype, device=vel.device)
    current = current.index_put((cell,), vel, accumulate=True) / (n / grid)
    return pos, vel, current


def xpic_kinetic(vel):
    return (vel * vel).sum()


def p19_xpic(rank):
    """(d) on one rank: rank 0 the Cluster (CPU), rank 1 the Booster (the
    card); the loop with a Booster failure armed and without."""
    import torch.distributed as dist
    from repro_torch.cluster.topology import Module
    from repro_torch.core.offload import OffloadEngine, split_mesh
    eng = OffloadEngine(split_mesh(p19_mesh(2, 1), 1),
                        device="cpu" if rank == 0 else DEVICE)
    n, grid = P19["xpic_part"], P19["xpic_grid"]
    rec = {"rank": rank}
    torch.use_deterministic_algorithms(True)
    try:
        for fail in (True, False):
            gen = torch.Generator().manual_seed(SEED + 195)
            pos = eng.put(torch.rand(n, generator=gen), Module.CLUSTER)
            vel = eng.put(torch.zeros(n), Module.CLUSTER)
            e_field = eng.put(torch.sin(torch.linspace(0, 6.28, grid)),
                              Module.CLUSTER)
            current = eng.put(torch.zeros(grid), Module.CLUSTER)
            root = Path(tempfile.mkdtemp(prefix=f"chip_smoke_xpic{rank}_"))
            cluster = VirtualCluster(n_cluster=2, n_booster=2, root=root)
            runtime = TaskRuntime(cluster, max_retries=3)
            booster = cluster.ranks(Module.BOOSTER)[0]
            energy = []
            before = dict(eng.fabric)
            t0 = time.perf_counter()
            for s in range(P19["xpic_steps"]):
                e_field = runtime.run(
                    f"field_{s}",
                    lambda e, c: eng.offload(xpic_field_solve, Module.CLUSTER, e, c),
                    e_field, current, rank=cluster.ranks(Module.CLUSTER)[0])
                if fail and s == P19["xpic_fail"]:
                    cluster.arm_failure(booster, NodeState.FAILED_TRANSIENT)
                pos, vel, cur = runtime.run(
                    f"particles_{s}",
                    lambda p, v, e: eng.offload(xpic_particle_push,
                                                Module.BOOSTER, p, v, e),
                    pos, vel, e_field, rank=booster)
                current = eng.gather(cur, Module.CLUSTER)
                ke = eng.gather(eng.offload(xpic_kinetic, Module.BOOSTER, vel),
                                Module.CLUSTER)
                if rank == 0:
                    energy.append(float(ke.value + (e_field.value ** 2).sum()))
            wall = time.perf_counter() - t0
            cluster.teardown()
            shutil.rmtree(root, ignore_errors=True)
            rec[f"fail_{fail}"] = {
                "energy": energy, "wall_s": wall,
                "retried": runtime.stats.retried, "failed": runtime.stats.failed,
                "booster_device": None if rank == 0 else str(pos.value.device),
                **{k: eng.fabric[k] - before[k] for k in eng.fabric}}
            del pos, vel, e_field, current, cur, ke
    finally:
        torch.use_deterministic_algorithms(False)
    return rec


P19_PARTS = {"prefill": p19_prefill, "train": p19_train, "xpic": p19_xpic}


def phase19_rank(rank: int, store: str, cmd_q, res_q) -> None:
    """One rank of phase 19's world (gloo through host buffers: the two
    ranks share the card): each command from the parent runs one part;
    tensors arrive through CUDA IPC from the parent, which holds them."""
    from datetime import timedelta

    import torch.distributed as dist

    # before the first allocation: (c)'s training holds two whole AdamW
    # states on the card, and fragments would not fit
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, P19_RANKS),
                            rank=rank, world_size=P19_RANKS,
                            timeout=timedelta(seconds=RANK_TIMEOUT_S))
    try:
        while True:
            msg = cmd_q.get(timeout=P19_PART_TIMEOUT_S)
            if msg is None:
                break
            part, kw = msg
            try:
                rec = P19_PARTS[part](rank, **kw)
            except Exception as e:   # reported, then the rank exits non-zero
                res_q.put((rank, part, {"error": f"{type(e).__name__}: {e}"}))
                raise
            del msg, kw
            release()
            res_q.put((rank, part, rec))
    finally:
        dist.destroy_process_group()


class P19World:
    """Phase 19's two ranks, spawned once; ``run`` sends a part to both and
    waits for their records.  A rank that dies or hangs fails the phase
    and every rank is stopped."""

    def __init__(self, root: Path):
        import torch.multiprocessing as tmp
        ctx = tmp.get_context("spawn")
        self.cmd = [ctx.Queue() for _ in range(P19_RANKS)]
        self.res = ctx.Queue()
        self.procs = [ctx.Process(target=phase19_rank,
                                  args=(r, str(root / "store"), self.cmd[r],
                                        self.res))
                      for r in range(P19_RANKS)]
        for p in self.procs:
            p.start()

    def run(self, part: str, **kw) -> list:
        for q in self.cmd:
            q.put((part, kw))
        recs = {}
        deadline = time.monotonic() + P19_PART_TIMEOUT_S
        while len(recs) < P19_RANKS:
            try:
                r, got_part, rec = self.res.get(timeout=5)
            except Exception:
                if (time.monotonic() > deadline
                        or any(not p.is_alive() for p in self.procs)):
                    raise AssertionError(
                        f"phase 19 {part}: ranks exited with "
                        f"{[p.exitcode for p in self.procs]} or timed out")
                continue
            if "error" in rec:
                raise AssertionError(f"phase 19 {part}: rank {r} failed: "
                                     f"{rec['error']}")
            recs[r] = rec
        return [recs[r] for r in range(P19_RANKS)]

    def close(self) -> None:
        for q in self.cmd:
            try:
                q.put(None)
            except Exception:
                pass
        deadline = time.monotonic() + 30
        for p in self.procs:
            p.join(max(1.0, deadline - time.monotonic()))
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()


def p19_reference_prefill(arch, moe=False):
    """The weights (a bf16 serving tree from a seed), the tokens and the
    single-process forward's logits on the card."""
    cfg = p19_config(arch)
    model = get_model(cfg)
    params = model.init(SEED + 190, cfg, device=DEVICE, cast=True)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 191)
    tokens = torch.randint(0, cfg.vocab_size, (P19["batch"], P19["seq"]),
                           generator=gen, device=DEVICE, dtype=torch.int32)
    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": tokens}, cfg, remat=False)
    return cfg, params, tokens, logits


def p19_check_prefill(tag, cfg, recs, logits, failures, rel_gate=True) -> dict:
    """Each rank's tokens, launches and (``rel_gate``) the relative logit
    error against the single-process forward's."""
    want = logits[:, -1].argmax(-1).tolist()
    rel = max(r["max_abs_err"] for r in recs) / max(recs[0]["max_abs_ref"], 1e-6)
    for r in recs:
        say(f"    rank {r['rank']}: prefill {r['wall_s']:.3f} s (gloo exchange "
            f"{r['exchange_s']:.3f} s in {r['exchanges']} collectives; flash "
            f"kernel {r['flash_ms']:.5f} ms a call at {r['flash_shape']} x "
            f"{r['fwd']} launches), tokens {r['tokens']}; flash launches "
            f"{r['fwd']}, plain calls {r['plain']}; holds "
            f"{r['own_bytes']} B of its own blocks, {r['param_bytes']} B of "
            f"parameters in all; peak {r['peak_bytes'] / 2**30:.2f} GiB")
        if r["tokens"] != want:
            failures.append(f"{tag} rank {r['rank']}: tokens {r['tokens']} != "
                            f"the single-process forward's {want}")
        if r["fwd"] != cfg.n_layers or r["plain"]:
            failures.append(f"{tag} rank {r['rank']}: {r['fwd']} flash launches "
                            f"(want {cfg.n_layers}), {r['plain']} plain calls")
    say(f"    single-process tokens {want}; relative logit error {rel:.3e} "
        + (f"(limit {P19_LOGIT_REL})" if rel_gate else "(reported)"))
    if rel_gate and not rel < P19_LOGIT_REL:
        failures.append(f"{tag}: relative logit error {rel:.3e}")
    return {"ranks": recs, "rel_err": rel, "tokens": want,
            "layers": cfg.n_layers}


def p19_moe_train(world, failures) -> dict:
    """(c) training: the single-process steps on the whole batch, then the
    mesh runs from the same initial state."""
    cfg = p19_config(P19["moe_arch"], n_layers=1)
    model = get_model(cfg)
    state = init_train_state(SEED + 193, cfg, model, device=DEVICE)
    init_params = state["params"]
    pipe = TokenPipeline(cfg.vocab_size, P19["train_batch"], P19["train_seq"])
    batches = [{k: torch.from_numpy(v).to(DEVICE)
                for k, v in pipe.batch_at(i).items()}
               for i in range(P19["train_steps"])]
    step = make_train_step(cfg, model, AdamWConfig(lr=P19["lr"],
                                                   warmup_steps=P19["warmup"]))
    torch.use_deterministic_algorithms(True)
    losses, auxes = [], []
    try:
        for b in batches:
            state, met = step(state, b)
            losses.append(met["loss"].item())
            auxes.append(met["router_aux"].item())
    finally:
        torch.use_deterministic_algorithms(False)
    ref_params = state["params"]
    del state, met
    release()
    say(f"    single process, whole batch (B {P19['train_batch']} x T "
        f"{P19['train_seq']}): losses {losses}, router aux {auxes}")
    out = {"single": {"losses": losses, "aux": auxes}}
    tol_p = 2 * P19["lr"] * P19["train_steps"]
    # (data 2 x model 1) takes the first step only: its gloo exchange of
    # the whole gradient is ~10 s a step
    for data, model_n, runs, steps in ((1, P19_RANKS, 2, P19["train_steps"]),
                                       (P19_RANKS, 1, 1, 1)):
        tag = f"(c) train data {data} x model {model_n}"
        if data > 1:
            # each rank holds the whole AdamW state: no room for the
            # single-process parameters beside two of them
            ref_params = None
            release()
        recs = world.run("train", data=data, model_n=model_n,
                         params=init_params, batches=batches[:steps],
                         ref_params=ref_params, runs=runs)
        for r in recs:
            for i, run in enumerate(r["runs"]):
                say(f"    {tag} rank {r['rank']} run {i}: losses "
                    f"{run['losses']}, aux {run['aux']}; {run['wall_s']:.3f} s "
                    f"(gloo {run['exchange_s']:.3f} s); flash fwd {run['fwd']} "
                    f"bwd {run['bwd']}, plain {run['plain']}; params "
                    f"{run['param_bytes']} B, peak "
                    f"{run['peak_bytes'] / 2**30:.2f} GiB; max |param - "
                    f"single| {run['param_max_abs_diff']} (limit {tol_p}); "
                    f"sha256 {(run['sha256'] or '-')[:16]}..")
                for name, got, want in (("loss", run["losses"], losses),
                                        ("aux", run["aux"], auxes)):
                    if any(abs(g - w) > P19_LOSS_REL * abs(w)
                           for g, w in zip(got, want)):
                        failures.append(f"{tag} rank {r['rank']}: {name} {got} "
                                        f"vs single {want}")
                if (run["param_max_abs_diff"] is not None
                        and run["param_max_abs_diff"] > tol_p):
                    failures.append(f"{tag} rank {r['rank']}: params "
                                    f"{run['param_max_abs_diff']:.3e} from "
                                    "the single-process run")
                if (run["fwd"] != 2 * cfg.n_layers * steps
                        or run["bwd"] != 3 * cfg.n_layers * steps
                        or run["plain"]):
                    failures.append(f"{tag} rank {r['rank']}: flash fwd "
                                    f"{run['fwd']} bwd {run['bwd']} plain "
                                    f"{run['plain']}")
            if runs == 2 and r["runs"][0]["sha256"] != r["runs"][1]["sha256"]:
                failures.append(f"{tag} rank {r['rank']}: two runs differ")
        out[f"data{data}_model{model_n}"] = recs
    del init_params, batches
    release()
    return out


def phase19() -> dict:
    """The mesh paths, the offload and the launcher on the card; every
    gate checked after every part has run."""
    say("== phase 19: Ulysses prefill (starcoder2-7b, minicpm3-4b), the MoE "
        "island (qwen2-moe-a2.7b), xPic's Cluster-Booster offload and the "
        "training launcher")
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_p19_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    launches = {}
    for tag, extra in (("fail", ["--fail-at", str(P19["launch_fail"])]),
                       ("clean", [])):
        launches[tag] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *P19["launch"],
             *extra, "--run-dir", str(root / f"launch_{tag}")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
            cwd=ROOT)
    failures, out = [], {}
    world = P19World(root)
    try:
        for part, arch in zip("ab", P19["seqpar"]):
            t1 = time.perf_counter()
            cfg, params, tokens, logits = p19_reference_prefill(arch)
            say(f"  ({part}) {arch}: {cfg.n_layers} layers at published width, "
                f"tp {P19_RANKS}, seq_parallel, data 1 x model {P19_RANKS}, "
                f"B {P19['batch']} x T {P19['seq']}")
            recs = world.run("prefill", arch=arch, params=params,
                             tokens=tokens, logits=logits)
            out[part] = p19_check_prefill(f"({part}) {arch}", cfg, recs,
                                          logits, failures)
            del params, tokens, logits
            release()
            out[part]["seconds"] = time.perf_counter() - t1
            say(f"    ({part}: {out[part]['seconds']:.1f} s)")
        t1 = time.perf_counter()
        arch = P19["moe_arch"]
        cfg, params, tokens, logits = p19_reference_prefill(arch, moe=True)
        say(f"  (c) {arch}: the island's prefill, {cfg.n_layers} layers, data "
            f"1 x model {P19_RANKS}, B {P19['batch']} x T {P19['seq']}")
        recs = world.run("prefill", arch=arch, params=params, tokens=tokens,
                         logits=logits, moe=True)
        # the reference bounds its sequence-parallel logits only; the
        # island's 24 layers of bf16 expert blocks are held by their tokens
        # (3.163e-02 relative to one process, reported)
        out["c"] = {"prefill": p19_check_prefill(f"(c) {arch}", cfg, recs,
                                                 logits, failures,
                                                 rel_gate=False)}
        del params, tokens, logits
        release()
        say(f"  (c) {arch} at depth 1, {P19['train_steps']} AdamW steps: data "
            f"1 x model {P19_RANKS} twice, then the first over data "
            f"{P19_RANKS} x model 1")
        out["c"]["train"] = p19_moe_train(world, failures)
        out["c"]["seconds"] = time.perf_counter() - t1
        say(f"    (c: {out['c']['seconds']:.1f} s)")
        t1 = time.perf_counter()
        say(f"  (d) xPic: {P19['xpic_part']} particles, grid "
            f"{P19['xpic_grid']}, {P19['xpic_steps']} steps; field solve on "
            f"the Cluster (rank 0, CPU), particle push offloaded to the "
            f"Booster (rank 1, the card) under TaskRuntime.run, a transient "
            f"Booster failure armed in step {P19['xpic_fail']}")
        recs = world.run("xpic")
        cl, bo = recs
        for fail in (True, False):
            c, b = cl[f"fail_{fail}"], bo[f"fail_{fail}"]
            say(f"    {'with' if fail else 'without'} the failure: energy "
                f"{c['energy'][0]:.6f} -> {c['energy'][-1]:.6f}; retried "
                f"{c['retried']}, failed {c['failed']}; push on "
                f"{b['booster_device']}; fabric: Cluster sent "
                f"{c['bytes_sent']} B, received {c['bytes_received']} B in "
                f"{c['seconds']:.3f} s, Booster sent {b['bytes_sent']} B, "
                f"received {b['bytes_received']} B in {b['seconds']:.3f} s; "
                f"loop {c['wall_s']:.3f} s")
        if cl["fail_True"]["energy"] != cl["fail_False"]["energy"]:
            failures.append("(d) the energies with the failure differ from "
                            "the run without")
        if (cl["fail_True"]["retried"] < 1 or cl["fail_True"]["failed"]
                or bo["fail_True"]["retried"] < 1):
            failures.append("(d) want retried >= 1 and failed 0")
        if not str(bo["fail_True"]["booster_device"]).startswith("cuda"):
            failures.append("(d) the particle push did not run on the card")
        out["d"] = {"ranks": recs, "seconds": time.perf_counter() - t1}
    finally:
        world.close()
        for p in launches.values():
            if p.poll() is None:
                try:
                    p.wait(timeout=P19_PART_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    p.kill()
        shutil.rmtree(root, ignore_errors=True)
    say("  (e) python -m repro_torch.launch.train " + " ".join(P19["launch"])
        + f" [--fail-at {P19['launch_fail']}], on the card")
    reports = {}
    for tag, p in launches.items():
        stdout, stderr = p.communicate()
        if p.returncode != 0:
            failures.append(f"(e) the launcher ({tag}) exited {p.returncode}: "
                            f"{stderr[-800:]}")
            continue
        reports[tag] = json.loads(stdout[stdout.index("{"):])
        say(f"    {tag}: {json.dumps(reports[tag])}")
    if len(reports) == 2:
        f, c = reports["fail"], reports["clean"]
        if f["failures"] != 1 or f["recoveries"] != 1:
            failures.append(f"(e) failures {f['failures']}, recoveries "
                            f"{f['recoveries']}: want 1 and 1")
        if f["last_loss"] != c["last_loss"]:
            failures.append(f"(e) last loss {f['last_loss']} != the run "
                            f"without a failure's {c['last_loss']}")
    out["e"] = reports
    out["seconds"] = time.perf_counter() - t0
    say(f"  phase 19 took {out['seconds']:.1f} s")
    if failures:
        raise AssertionError("phase 19 gates failed:\n  " + "\n  ".join(failures))
    return out


# ---------------------------------------------------------------------- #
# phase 20: paginate_cache through the paged kernels; the dry run's model
# FLOPs and variants
# ---------------------------------------------------------------------- #

# (a) phi3-mini-3.8b's serving width (its heads over its kv heads of its
# head dim, page 16), B 4: a cache of 2,048 positions (whole pages: the
# pools are views of it) and one of 2,041 (padded by 7 zero rows), each
# stream's length from 1 to S; (b) the dry run of two train cells with and
# without the variant
P20 = dict(arch="phi3-mini-3.8b", page=16,
           caches=((2048, (2048, 1, 1037, 16)), (2041, (2041, 17, 1, 640))),
           dtypes=(torch.float32, torch.bfloat16),
           cells=(("phi3-mini-3.8b", "train_4k"), (MOE_ARCH, "train_4k")),
           variant=("fused_gate_up=1", "capacity_factor=2.0"))
FLOPS_PER_PARAM = {"train": 6.0, "prefill": 2.0, "decode": 2.0}


def paginated(kc, vc, page) -> tuple:
    """``pa.paginate_cache`` with every host synchronisation an error (a
    host-made table would need a copy to the card), and its layout
    checked: slot b*nP + j holds stream b's page j, zeros past S."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        kp, vp, table = pa.paginate_cache(kc, vc, page)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    b, s = kc.shape[:2]
    n_p = -(-s // page)
    ident = torch.arange(b * n_p, dtype=torch.int32, device=kc.device)
    if table.dtype != torch.int32 or not torch.equal(table, ident.reshape(b, n_p)):
        raise AssertionError(f"paginate_cache: table {table.dtype} "
                             f"{tuple(table.shape)} is not the identity")
    for pool, cache in ((kp, kc), (vp, vc)):
        flat = pool.reshape((b, n_p * page) + tuple(cache.shape[2:]))
        if (pool.device != kc.device or not torch.equal(flat[:, :s], cache)
                or flat[:, s:].any()):
            raise AssertionError("paginate_cache: the pool is not the cache "
                                 "page by page with zero padding")
    return kp, vp, table


def phase20_roundtrip() -> dict:
    """(a) Contiguous caches through ``paginate_cache`` and both paged
    kernels, against their plain versions over the same pools and
    contiguous decode attention on the unpaged cache; the wrappers'
    launches counted by route; times (CUDA events, L2 warm)."""
    cfg = get_config(P20["arch"])
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    page = P20["page"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    errs = {"paged_attention": 0.0, "paged_attention_quant": 0.0}
    calls, timed = 0, {}
    reset_launches()
    for s, lens in P20["caches"]:
        b = len(lens)
        q0 = torch.randn(b, hq, d, generator=gen, device=DEVICE)
        kc0 = torch.randn(b, s, hkv, d, generator=gen, device=DEVICE)
        vc0 = torch.randn(b, s, hkv, d, generator=gen, device=DEVICE)
        lengths = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        for dtype in P20["dtypes"]:
            q, kc, vc = (t.to(dtype) for t in (q0, kc0, vc0))
            tag = f"S {s} {str(dtype)[6:]}"
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            kp, vp, table = paginated(kc, vc, page)
            say(f"  {tag}: pools {tuple(kp.shape)}, table {tuple(table.shape)}"
                f" on {table.device}, views of the cache: "
                f"{kp.data_ptr() == kc.data_ptr()}")
            got = pa.paged_attention(q, kp, vp, table, lengths)
            want = ref.paged_attention(q, kp, vp, table, lengths)
            errs["paged_attention"] = max(errs["paged_attention"], check_close(
                f"paged_attention {tag} vs its plain version over the pool",
                got, want, **tol))
            check_close(f"paged_attention {tag} vs contiguous decode attention",
                        got, ref.decode_attention_ref(q, kc, vc, lengths), **tol)
            kq, ks = pa.quantize_pages(kp)
            vq, vs = pa.quantize_pages(vp)
            got8 = pa.paged_attention_quant(q, kq, ks, vq, vs, table, lengths)
            want8 = ref.paged_attention_quant(q, kq, ks, vq, vs, table, lengths)
            errs["paged_attention_quant"] = max(
                errs["paged_attention_quant"], check_close(
                    f"paged_attention_quant {tag} vs its plain version over "
                    "the pool", got8, want8, **tol))
            # the dequantized pools laid back out as contiguous caches
            unpaged = [(qp.float() * sc[..., None]).reshape(
                (b, -1, hkv, d))[:, :s] for qp, sc in ((kq, ks), (vq, vs))]
            check_close(f"paged_attention_quant {tag} vs contiguous decode "
                        "attention on the dequantized cache", got8,
                        ref.decode_attention_ref(q, *unpaged, lengths), **tol)
            check_close(f"paged_attention_quant {tag} vs contiguous decode "
                        "attention on the original cache", got8,
                        ref.decode_attention_ref(q, kc, vc, lengths),
                        atol=QUANT_VS_F32, rtol=QUANT_VS_F32)
            if dtype == torch.bfloat16:
                split = pa.split_tokens()
                check_split(f"paged_attention {tag} vs its algorithm in f32",
                            got, ref.paged_attention_split(
                                q, kp, vp, table, lengths, split), b)
                check_split(f"paged_attention_quant {tag} vs its algorithm "
                            "in f32", got8, ref.paged_attention_quant_split(
                                q, kq, ks, vq, vs, table, lengths, split), b)
                timed[s] = (q, kc, vc, kp, vp, kq, ks, vq, vs, table, lengths)
            calls += 1
            del kp, vp, kq, vq, got, want, got8, want8, unpaged
    launches = {}
    for name in ("paged_attention", "paged_attention_quant"):
        fn = getattr(pa, name)
        launches[name] = fn.launches
        say(f"  {name}: {fn.launches} launches, by route {fn.by_route}")
        if fn.launches != calls or fn.by_route != {"narrow": calls, "wide": 0}:
            raise AssertionError(f"{name}: {fn.launches} launches by route "
                                 f"{fn.by_route}; want {calls}, all narrow")

    times = {}
    for s, (q, kc, vc, kp, vp, kq, ks, vq, vs, table, lengths) in timed.items():
        lens = lengths.tolist()
        rec = {"lengths": lens,
               "paginate_cache_ms": time_ms(lambda: pa.paginate_cache(kc, vc, page)),
               "contiguous_plain_ms": time_ms(
                   lambda: ref.decode_attention_ref(q, kc, vc, lengths))}
        for name, kern, plain, quant in (
                ("paged_attention",
                 lambda: pa.paged_attention(q, kp, vp, table, lengths),
                 lambda: ref.paged_attention(q, kp, vp, table, lengths), False),
                ("paged_attention_quant",
                 lambda: pa.paged_attention_quant(q, kq, ks, vq, vs, table,
                                                  lengths),
                 lambda: ref.paged_attention_quant(q, kq, ks, vq, vs, table,
                                                   lengths), True)):
            bound, by = kernel_bound_ms(q, kq if quant else kp, table, lengths,
                                        quant=quant)
            rec[name] = {"ms": time_ms(kern), "plain_ms": time_ms(plain),
                         "bound_ms": bound, "bound_by": by}
        say(f"  S {s} bf16 {lens}: {json.dumps(rec)}")
        times[f"S_{s}"] = rec
    release()
    return {"launches": launches, "calls": calls, "max_abs_err": errs,
            "shape": f"B 4, {hq} heads over {hkv} of {d}, page {page}, bf16, "
                     "L2 warm (the same pools each call)",
            "times": times}


def meta_layout(cfg) -> dict:
    """Leaf paths and bytes of the parameters ``cfg`` builds on the meta
    device, at the production mesh's ``model`` size."""
    mesh = dryrun.make_production_mesh()
    cfg = cfg.with_tp(mesh.axis_size("model"))
    model = get_model(cfg)
    paths = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                paths[prefix + k] = v

    walk(model.param_shapes(cfg), "")
    return {"paths": sorted(paths), "bytes": sum(
        t.numel() * t.element_size() for t in paths.values())}


def phase20_dryrun() -> dict:
    """(b) ``python -m repro_torch.launch.dryrun --fast`` (its ``main``,
    the meta layout's fields; phase 21 holds the full count) for each
    cell, plain and with ``--set`` of the variant: the records' model FLOPs
    against the closed form, the variant in the config and in the built
    layout, the parameter bytes of that layout; an unknown key refused."""
    sets = [a for kv in P20["variant"] for a in ("--set", kv)]
    variant = dryrun.parse_set(list(P20["variant"]))
    out = {}
    for arch, shape_name in P20["cells"]:
        shape = get_shape(shape_name)
        recs, layouts = {}, {}
        for tag, extra, var in (("plain", [], {}), ("variant", sets, variant)):
            rec, = dryrun.main(["--arch", arch, "--shape", shape_name,
                                "--fast", *extra])
            cfg = dryrun.apply_variant(get_config(arch), var)
            tokens = shape.global_batch * (
                1 if shape.kind == "decode" else shape.seq_len)
            flops = (FLOPS_PER_PARAM[shape.kind]
                     * cfg.param_count(active_only=True) * tokens)
            layout = meta_layout(cfg)
            if rec["variant"] != var or rec["model_flops"] != flops:
                raise AssertionError(
                    f"dry run {arch} {tag}: variant {rec['variant']}, model "
                    f"flops {rec['model_flops']!r}; want {var}, {flops!r}")
            if (rec["param_bytes_total"] != layout["bytes"]
                    or rec["param_leaves"] != len(layout["paths"])):
                raise AssertionError(
                    f"dry run {arch} {tag}: {rec['param_leaves']} leaves, "
                    f"{rec['param_bytes_total']} B; the built layout has "
                    f"{len(layout['paths'])}, {layout['bytes']} B")
            for key, value in var.items():
                if key != "capacity_factor":
                    got = getattr(cfg, key)
                elif cfg.moe is not None:
                    got = cfg.moe.capacity_factor
                else:
                    continue          # the reference ignores it without MoE
                if got != value:
                    raise AssertionError(f"dry run {arch}: {key} is {got}, "
                                         f"not the variant's {value}")
            recs[tag], layouts[tag] = rec, layout
        fused = [p for p in layouts["variant"]["paths"] if p.endswith(".w_in")]
        unfused = [p for p in layouts["plain"]["paths"]
                   if p.startswith("moe_layers.moe.w")]
        moe = get_config(arch).moe is not None
        want_leaves = recs["plain"]["param_leaves"] - (1 if moe else 0)
        if (recs["variant"]["param_leaves"] != want_leaves
                or len(fused) != (1 if moe else 0)
                or (moe and unfused != ["moe_layers.moe.wd", "moe_layers.moe.wg",
                                        "moe_layers.moe.wu"])
                or recs["variant"]["param_bytes_total"]
                != recs["plain"]["param_bytes_total"]):
            raise AssertionError(
                f"dry run {arch}: fused_gate_up's layout {fused}, "
                f"{recs['variant']['param_leaves']} leaves against "
                f"{recs['plain']['param_leaves']}; MoE {moe}")
        say(f"  {arch} {shape_name}: model_flops {recs['plain']['model_flops']!r}"
            f" ({FLOPS_PER_PARAM[shape.kind]} x "
            f"{get_config(arch).param_count(active_only=True)} active params "
            f"x B {shape.global_batch} x T {shape.seq_len}); variant "
            f"{variant}: leaves {recs['plain']['param_leaves']} -> "
            f"{recs['variant']['param_leaves']} ({fused or 'no MoE'}), "
            f"{recs['variant']['param_bytes_total']} B of parameters, "
            f"{recs['variant']['param_bytes_per_device']} B a device")
        out[arch] = recs
    try:
        dryrun.main(["--arch", P20["arch"], "--shape", "train_4k", "--fast",
                     "--set", "no_such_flag=1"])
    except TypeError as e:
        if "no_such_flag" not in str(e):
            raise
        say(f"  an unknown key is refused by name: {e}")
    else:
        raise AssertionError("dry run: --set no_such_flag=1 was not refused")
    return out


def phase20() -> dict:
    say("== phase 20: paginate_cache through the paged kernels at phi3's "
        "serving width; the dry run's model FLOPs and variants")
    t0 = time.perf_counter()
    out = {"roundtrip": phase20_roundtrip(), "dryrun": phase20_dryrun()}
    out["seconds"] = time.perf_counter() - t0
    say(f"  phase 20 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------- #
# phase 21: the dry run's count held against a step on the card
# ---------------------------------------------------------------------- #

# (a) phi3-mini-3.8b at published width with phase 8's depth and B x T,
# (b) rwkv6-3b at one layer (the WKV6 kernels): one training step on the
# card under the counter against lower_cell's count of the same cell on
# meta; (c) one full-depth phi3 decode step over a B 4 x 2,048 cache:
# memory only
P21 = dict(train=((TRAIN["arch"], TRAIN["layers"]), ("rwkv6-3b", 1)),
           batch=TRAIN["batch"], seq=TRAIN["seq"],
           decode=(TRAIN["arch"], 4, 2048), reps=5,
           mem_rel=0.10, mem_abs=64 * 2**20)
# each kernel function's wrapper and its ``.launches`` per call on these
# paths (bf16, heads of at most 256 and 64: no workspace, no tiles)
P21_WRAPPERS = {"flash_attention_fwd": (fa.flash_attention_fwd, 1),
                "flash_attention_bwd": (fa.flash_attention_bwd, 3),
                "wkv6_fwd": (wkv.wkv6_fwd, 1), "wkv6_bwd": (wkv.wkv6_bwd, 1)}


def p21_memory_gate(tag, card_peak, meta_temp, failures) -> dict:
    """The card's peak over the step (less what was held before it)
    against the meta tracker's ``temp_size_in_bytes``: within 10% or 64
    MiB, whichever is larger (the cuBLAS workspace, the allocator's 512 B
    rounding)."""
    tol = max(P21["mem_rel"] * meta_temp, P21["mem_abs"])
    say(f"  {tag}: peak over the step {card_peak} B on the card, "
        f"{meta_temp} B by the meta tracker ({card_peak / max(meta_temp, 1):.4f}"
        f"x; tolerance {tol:.0f} B)")
    if abs(card_peak - meta_temp) > tol:
        failures.append(f"{tag}: peak {card_peak} B on the card against "
                        f"{meta_temp} B on meta (tolerance {tol:.0f} B)")
    return {"card_peak_bytes": card_peak, "meta_temp_bytes": meta_temp,
            "tolerance_bytes": tol}


def p21_diff(meta_ops: dict, card_ops: dict) -> list:
    """The operators whose counts differ between meta and the card."""
    return [(name, meta_ops.get(name), card_ops.get(name))
            for name in sorted(set(meta_ops) | set(card_ops))
            if meta_ops.get(name) != card_ops.get(name)]


def phase21_train(arch: str, layers: int, smi: str, failures) -> dict:
    shape = ShapeSpec(f"B{P21['batch']}xT{P21['seq']}", P21["seq"],
                      P21["batch"], "train")
    t0 = time.perf_counter()
    meta = dryrun.lower_cell(arch, shape, None, tp=1, n_layers=layers)
    meta_s = time.perf_counter() - t0
    cfg = dataclasses.replace(get_config(arch), n_layers=layers).with_tp(1)
    model = get_model(cfg)
    state = init_train_state(SEED, cfg, model, device=DEVICE)
    batch = registry.make_inputs(
        cfg, shape, torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    step = make_train_step(cfg, model, remat=True,
                           micro_batches=meta["micro_batches"])
    step(state, batch)                 # warm-up: first launches, cuBLAS
    release()
    torch.cuda.synchronize()
    base = {name: fn.launches for name, (fn, _) in P21_WRAPPERS.items()}
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with dryrun.CostCounter(DEVICE) as counter:
        out = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    del out
    card = counter.record()
    launches = {name: fn.launches - base[name]
                for name, (fn, _) in P21_WRAPPERS.items()}
    tag = f"(a) {arch}" if arch == TRAIN["arch"] else f"(b) {arch}"
    say(f"  {tag}: published width, {layers} layer(s), B {P21['batch']} x T "
        f"{P21['seq']}, {meta['micro_batches']} micro-batches (lower_cell's "
        f"choice), remat; meta count in {meta_s:.2f} s")
    say(f"  {tag}: FLOPs card {card['flops']} meta {meta['flops']}; bytes "
        f"card {card['bytes']} meta {meta['bytes']}")
    say(f"  {tag}: kernels card {json.dumps(card['kernels'])}")
    say(f"  {tag}: kernels meta {json.dumps(meta['kernels'])}")
    say(f"  {tag}: wrapper launches in the counted step {launches}")
    same = (card["flops"], card["bytes"], card["kernels"]) == (
        meta["flops"], meta["bytes"], meta["kernels"])
    if not same:
        for name, m, c in p21_diff(meta["ops"], counter.ops):
            say(f"    differs: {name}: meta {m}, card {c}")
        failures.append(f"{tag}: the card's count differs from the meta count")
    for name, rec in meta["kernels"].items():
        per_call = P21_WRAPPERS[name][1]
        if launches.get(name) != rec["calls"] * per_call or not rec["calls"]:
            failures.append(f"{tag}: {name}: {launches.get(name)} launches for "
                            f"{rec['calls']} calls x {per_call}")
    for name, n in launches.items():
        if n and name not in meta["kernels"]:
            failures.append(f"{tag}: {name} launched {n} times, counted never")
    memory = p21_memory_gate(tag, peak, meta["memory"]["temp_size_in_bytes"],
                             failures)
    times = []
    for _ in range(P21["reps"]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(state, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        del out
    ms = sorted(times)[len(times) // 2]
    tflops = meta["flops"] / (ms * 1e-3) / 1e12
    share = tflops * 1e12 / PEAK_OPS["bfloat16"]
    say(f"  {tag}: step {ms:.3f} ms (CUDA events, median of "
        f"{P21['reps']} after a warm-up: {[round(t, 3) for t in times]}); "
        f"{meta['flops']} counted FLOPs -> {tflops:.2f} TFLOP/s, "
        f"{100 * share:.2f}% of the bf16 peak of "
        f"{PEAK_OPS['bfloat16'] / 1e12:.0f} TFLOP/s ({smi})")
    del state, batch, step
    release()
    return {"arch": arch, "layers": layers, "batch": P21["batch"],
            "seq": P21["seq"], "micro_batches": meta["micro_batches"],
            "flops": meta["flops"], "bytes": meta["bytes"],
            "kernels": meta["kernels"], "counts_equal": same,
            "launches": launches, "memory": memory, "step_ms": ms,
            "step_ms_all": times, "tflops": tflops, "bf16_peak_share": share,
            "meta_count_s": meta_s, "card": smi}


def phase21_decode(failures) -> dict:
    arch, rows, seq = P21["decode"]
    shape = ShapeSpec(f"B{rows}xS{seq}", seq, rows, "decode")
    meta = dryrun.lower_cell(arch, shape, None, tp=1)
    cfg = get_config(arch).with_tp(1)
    model = get_model(cfg)
    params = model.init(SEED, cfg, device=DEVICE)
    cache = model.init_cache(cfg, rows, seq, device=DEVICE)
    tokens = torch.randint(0, cfg.vocab_size, (rows,), dtype=torch.int32,
                           device=DEVICE)
    step = make_serve_step(cfg, model)
    out = step(params, cache, tokens, seq - 1)      # warm-up
    del out
    release()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with dryrun.CostCounter(DEVICE) as counter:
        out = step(params, cache, tokens, seq - 1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    del out
    card = counter.record()
    tag = f"(c) {arch} decode"
    say(f"  {tag}: full depth ({cfg.n_layers} layers), B {rows} over a cache "
        f"of {seq}; FLOPs card {card['flops']} meta {meta['flops']}, bytes "
        f"card {card['bytes']} meta {meta['bytes']} (reported)")
    memory = p21_memory_gate(tag, peak, meta["memory"]["temp_size_in_bytes"],
                             failures)
    del params, cache, tokens
    release()
    return {"arch": arch, "rows": rows, "cache": seq, "memory": memory,
            "counts_equal": (card["flops"], card["bytes"]) == (
                meta["flops"], meta["bytes"])}


def phase21(smi: str) -> dict:
    say("== phase 21: the dry run's count (lower_cell on meta) against steps "
        "on the card")
    t0 = time.perf_counter()
    failures = []
    out = {"train": [phase21_train(arch, layers, smi, failures)
                     for arch, layers in P21["train"]],
           "decode": phase21_decode(failures)}
    out["seconds"] = time.perf_counter() - t0
    say(f"  phase 21 took {out['seconds']:.1f} s")
    if failures:
        raise AssertionError("phase 21: " + "; ".join(failures))
    return out


# ---------------------------------------------------------------------- #
# phase 22: the port's examples (examples/torch_*.py) on the card
# ---------------------------------------------------------------------- #

EXAMPLES = ROOT / "examples"
# (a), (b): the serve example's local flow at published width and depth
# (``--full-size`` pages a 21.3 MB rwkv6-3b or 75.4 MB zamba2-2.7b lane in
# 1 MiB pages)
# (c): the float32 decode chain over B 2 x T 128 (two 64-token chunks of
# the scan kernels) against one forward through the kernels, and each of
# them against a float64 forward, at every position within the relative
# logit error of tests/test_torch_family_parity.py's LOGIT_TOL (rtol) or,
# where float32 itself cannot meet that at this depth, each float32
# evaluation within ``noise_x`` times that position's float32 noise (the
# plain float32 forward's distance to the float64 one: rwkv6-3b's 32
# random layers amplify float32 rounding to ~1e-2) from the float64
# forward, and the chain within twice that of the kernel forward; for
# ``chain64`` also the decode chain in
# float64 against the float64 forward at ``chain64_rel``, float64
# rounding through the same depth: the test of ``decode_step`` itself
# (d): the examples at their own sizes; ``argv`` is added to every
# example's command line (empty: each runs on the card, its default)
P22 = dict(serve=("rwkv6-3b", "zamba2-2.7b"), serve_argv=("--full-size",),
           chain=(2, 128), chain_rel=1e-4, noise_x=8,
           chain64=("rwkv6-3b",), chain64_rel=1e-9, ft_steps=30,
           fleet=("--workers", "2", "--arch", "phi3-mini-3.8b"), argv=())
# the reference examples' counts at the same settings (their runs on the
# CPU: examples/serve.py --arch rwkv6-3b and --arch zamba2-2.7b,
# examples/quickstart.py, examples/fault_tolerant_train.py --steps 30,
# examples/xpic_offload.py); they follow from the schedule and the
# prompts, not from the widths or the weights
P22_SERVE_COUNTS = dict(tokens=36, parked=6, resumed=6, max_resident=6,
                        prefix_hits=5, prefill_tokens_saved=40,
                        prefill_tokens=43, parked_at_save=4)
P22_TRAIN_COUNTS = {
    "torch_quickstart": dict(steps_run=37, failures=1, recoveries=1,
                             restarts_from_step=[10], checkpoints=3,
                             drains_completed=3),
    "torch_fault_tolerant_train": dict(steps_run=40, failures=2, recoveries=2,
                                       restarts_from_step=[0, 20],
                                       checkpoints=2)}
P22_XPIC_COUNTS = dict(launched=18, retried=2, replayed=0, failed=0,
                       replayed_after_crash=1)
# the OK lines of each example's counterpart
P22_OK = {
    "torch_quickstart": [
        "OK: failure survived, training resumed from the buddy copy."],
    "torch_fault_tolerant_train": [
        "OK: two node losses survived via NAM-XOR parity reconstruction."],
    "torch_xpic_offload": [
        "OK: offloaded particle task survived a Booster failure without "
        "global rollback.",
        "OK: persistent journal fast-forwards recomputation after a crash."],
    "torch_serve": [
        "OK: killed mid-decode with 4 streams parked + a node loss; restored "
        "scheduler finished every stream byte-identically."],
    "torch_serve --workers": [
        "OK: cross-process prefix sharing through one cache domain."]}


def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` does not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name: str, argv: list) -> tuple:
    """``main(argv)`` of ``examples/<name>.py`` in this process, its
    output captured and echoed: (the module, what ``main`` returned, the
    printed lines).  A failing example raises; the printed OK lines must
    be its counterpart's."""
    mod = load_example(name)
    argv = list(argv) + list(P22["argv"])
    say(f"  $ python examples/{name}.py {' '.join(argv)}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            ret = mod.main(argv)
    finally:
        lines = buf.getvalue().splitlines()
        for line in lines:
            say(f"  | {line}")
    say(f"  ({time.perf_counter() - t0:.1f} s)")
    want = P22_OK[name + (" --workers" if "--workers" in argv else "")]
    ok = [line for line in lines if line.startswith("OK:")]
    if ok != want:
        raise AssertionError(f"examples/{name}.py printed {ok}, want {want}")
    return mod, ret, lines


@contextlib.contextmanager
def serve_trace():
    """While in effect, a fresh process-default tracer: the schedulers
    and sessions built meanwhile take it at construction, so it holds
    their spans (``step``, ``park``, ``resume``, ``ckpt_txn``,
    ``restore``) and ``submit`` events.  Yields it."""
    tracer = Tracer(capacity=1 << 16)
    prev = set_default_tracer(tracer)
    try:
        yield tracer
    finally:
        set_default_tracer(prev)


def serve_runs(records, streams: int) -> list:
    """The serve example's three runs from its trace: the uninterrupted
    run (before the second stack's first ``submit``), the run up to the
    save (before ``ckpt_txn``) and the restored run (after ``restore``);
    each as steps, tokens and the host seconds of its ``step`` spans
    (admission, prefill, parks and the decode, tokens read back)."""
    ts = lambda name: [x["ts"] for x in records if x["name"] == name]
    bounds = [0.0, ts("submit")[streams], ts("ckpt_txn")[0], ts("restore")[0],
              float("inf")]
    runs = []
    for lo, hi in ((bounds[0], bounds[1]), (bounds[1], bounds[2]),
                   (bounds[3], bounds[4])):
        steps = [x for x in records
                 if x["name"] == "step" and lo <= x["ts"] < hi]
        runs.append({"steps": len(steps),
                     "tokens": sum(x["args"].get("emitted", 0) for x in steps),
                     "wall_s": sum(x["dur"] for x in steps)})
    return runs


def slot_step_ms(arch, model, params) -> dict:
    """One batch-1 ``decode_step`` as the contiguous scheduler runs it
    per slot: CUDA events over calls queued behind a sleep (the host's
    launch rate shows in them: a step launches more kernels than the
    card's queue holds) and the host clock, beside the least time to read
    the weights it reads (every leaf, the embedding table but one row;
    zamba2's shared block once per group)."""
    lane = model.init_cache(arch, 1, 32, device=DEVICE)
    tok = torch.tensor([1], device=DEVICE)
    leaf = lambda t: t.numel() * t.element_size()
    nbytes = sum(leaf(x) for x in tree_leaves(params))
    nbytes += leaf(params["embed"][0]) - leaf(params["embed"])
    if arch.attn_every:
        groups = arch.n_layers // arch.attn_every
        nbytes += (groups - 1) * sum(leaf(x) for x in tree_leaves(params["shared"]))
    step = lambda: model.decode_step(params, lane, tok, 5, arch)
    with torch.inference_mode():
        events = time_ms(step, iters=5, warmup=1, max_sleep_s=5.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        host = 1e3 * (time.perf_counter() - t0) / 3
    return {"events_ms": events, "host_ms": host, "weight_bytes": nbytes,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}


def p22_serve(arch: str, failures: list) -> dict:
    """(a), (b): ``examples/torch_serve.py --arch <arch> --full-size`` on
    the card through its ``main``, its counts held to the reference
    example's and its parks, resumes, save and restore read from its
    trace; then a stack built from the config it served takes two steps,
    its lanes and parameters are held to the card, and one slot-step of
    its weights is timed."""
    release()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", arch, *P22["serve_argv"]]
    with serve_trace() as tracer:
        t0 = time.perf_counter()
        _, r, _ = run_example("torch_serve", argv)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = {k: r[k] for k in P22_SERVE_COUNTS}
    if got != P22_SERVE_COUNTS:
        failures.append(f"({arch}) counts {got}, want the reference "
                        f"example's {P22_SERVE_COUNTS}")
    records = tracer.records()
    runs = serve_runs(records, r["streams"])
    spans = lambda name: [round(x["dur"], 6) for x in records
                          if x["name"] == name]
    cfg = r["cfg"]
    srv = Serve.local(cfg)
    try:
        srv.submit(list(range(1, 13)), max_new=2)
        srv.run(max_steps=2)
        sched = srv.scheduler
        n_off = sum(t.device.type != "cuda" for t in tree_leaves(sched.params))
        off = [f"lane {k}" for k, v in sched.slots_cache.items()
               if v.device.type != "cuda"]
        off += [f"{n_off} parameter leaves"] if n_off else []
        if off:
            failures.append(f"({arch}) off the card: {off}")
        if srv.arch.n_layers != get_config(arch).n_layers:
            failures.append(f"({arch}) served {srv.arch.n_layers} layers")
        lane = srv.model.init_cache(srv.arch, 1, cfg.max_len, device="meta")
        lane_bytes = sum(v.numel() * v.element_size() for v in lane.values())
        slot = slot_step_ms(srv.arch, srv.model, sched.params)
    finally:
        srv.close()
        del srv
    first = runs[0]
    save = [{"s": round(x["dur"], 6), "bytes": x["args"]["bytes"],
             "step": x["args"]["step"]}
            for x in records if x["name"] == "ckpt_txn"]
    out = {"counts": got, "wall_s": wall,
           "tok_per_s": first["tokens"] / first["wall_s"],
           "uninterrupted": first, "runs": runs, "slot_step": slot,
           "lane_bytes": lane_bytes, "park_s": spans("park"),
           "resume_s": spans("resume"), "save": save,
           "restore_s": spans("restore"), "page_bytes": cfg.page_bytes,
           "peak_gib": peak / 2**30, "argv": argv,
           "layers": get_config(arch).n_layers}
    say(f"  ({arch}) {first['tokens']} tokens in {first['wall_s']:.3f} s "
        f"uninterrupted = {out['tok_per_s']:.3f} tok/s; one slot-step "
        f"{slot['events_ms']:.3f} ms by CUDA events ({slot['host_ms']:.3f} ms "
        f"on the host clock) against the {slot['bound_ms']:.3f} ms weight-read "
        f"bound ({slot['weight_bytes']} bytes); parks of a {lane_bytes}-byte "
        f"lane {out['park_s']} s, resumes {out['resume_s']} s; save (commit) "
        f"{save}; restore {out['restore_s']} s; peak {out['peak_gib']:.3f} "
        f"GiB; lanes and parameters on the card: {not off}")
    release()
    return out


def rel_per_position(got, want, vocab):
    """max |got - want| / max |want| at each position of (B, T, V)
    logits, over the batch and the logical vocabulary, in float64."""
    got, want = got[..., :vocab].double(), want[..., :vocab].double()
    return ((got - want).abs().amax(dim=(0, 2))
            / want.abs().amax(dim=(0, 2))).cpu()


def decode_chain(model, params, cfg, tokens, v) -> tuple:
    """``decode_step`` token by token over (B, T) tokens from a fresh
    cache in ``cfg``'s compute dtype: the (B, T, v) logits and ms a
    token."""
    b, t = tokens.shape
    cache = model.init_cache(cfg, b, t, device=DEVICE)
    steps = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        for i in range(t):
            logits, cache = model.decode_step(params, cache, tokens[:, i], i, cfg)
            steps.append(logits[:, :v])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / t
    return torch.stack(steps, dim=1), ms


def p22_chain(arch: str, failures: list) -> dict:
    """(c): at published width and full depth with float32 compute, the
    decode chain token by token over B x T against one forward through
    the scan kernels (and zamba2's shared block through flash), and the
    forward's launches (one scan per Mamba or RWKV layer, one flash per
    group, no plain scan or attention).  At every position the relative
    logit error of the chain against the kernel forward, and of each
    against a float64 forward of the same weights on the plain path, is
    held to 1e-4.  Where float32 itself cannot meet that at this depth
    (the plain float32 forward, the float32 noise, lies past 1e-4 from
    the float64 one at some position), each float32 evaluation is held
    instead to ``P22["noise_x"]`` times that position's noise from the
    float64 forward, and the chain to the kernel forward to the sum of
    the two allowances (the triangle inequality).  For
    ``P22["chain64"]`` the decode chain also runs in float64 (every
    float32 island, its WKV state too, in float64) and is held to the
    float64 forward at ``P22["chain64_rel"]``."""
    t_part = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    cfg64 = dataclasses.replace(cfg, compute_dtype="float64")
    model = get_model(cfg)
    params = model.init(SEED + 22, cfg, device=DEVICE)
    b, t = P22["chain"]
    rng = np.random.default_rng(SEED + 22)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, t),
                                           dtype=np.int32)).to(DEVICE)
    v = cfg.vocab_size
    batch = {"tokens": tokens}
    torch.cuda.synchronize()
    reset_family_launches()
    with torch.inference_mode(), counting_calls(PLAIN_SCANS) as plain:
        t0 = time.perf_counter()
        fwd, _ = model.forward(params, batch, cfg, remat=False)
        torch.cuda.synchronize()
        fwd_ms = 1e3 * (time.perf_counter() - t0)
    launches = family_launches()
    with torch.inference_mode(), plain_kernels():
        plain32, _ = model.forward(params, batch, cfg, remat=False)
        plain64, _ = model.forward(params, batch, cfg64, remat=False)
    chain, chain_ms = decode_chain(model, params, cfg, tokens, v)
    rel = {"chain_vs_kernel": rel_per_position(chain, fwd, v),
           "kernel_vs_f64": rel_per_position(fwd, plain64, v),
           "chain_vs_f64": rel_per_position(chain, plain64, v),
           "plain_f32_vs_f64": rel_per_position(plain32, plain64, v)}
    noise = rel["plain_f32_vs_f64"]
    # where the float32 noise itself is past 1e-4 somewhere, each float32
    # evaluation gets noise_x times its position's noise from float64,
    # and two of them may lie the sum of their allowances apart
    noisy = bool((noise > P22["chain_rel"]).any())
    each = (torch.clamp(P22["noise_x"] * noise, min=P22["chain_rel"]) if noisy
            else torch.full_like(noise, P22["chain_rel"]))
    limits = {"chain_vs_kernel": 2 * each if noisy else each,
              "kernel_vs_f64": each, "chain_vs_f64": each}
    over = {k: [int(i) for i in torch.nonzero(~(rel[k] <= lim))]
            for k, lim in limits.items()}
    over = {k: x for k, x in over.items() if x}
    worst = {k: r.max().item() for k, r in rel.items()}
    share = {k: (rel[k] / lim).max().item() for k, lim in limits.items()}
    at = int(rel["chain_vs_kernel"].argmax())
    finite = all(bool(torch.isfinite(x).all()) for x in (fwd, chain, plain64))
    f64 = None
    if arch in P22["chain64"]:
        chain64, chain64_ms = decode_chain(model, params, cfg64, tokens, v)
        r64 = rel_per_position(chain64, plain64, v)
        f64 = {"rel_max": r64.max().item(), "at_position": int(r64.argmax()),
               "limit": P22["chain64_rel"], "decode_ms_per_token": chain64_ms,
               "rel": [float(x) for x in r64]}
        say(f"  ({arch} chain, float64) decode chain vs float64 forward: max "
            f"{f64['rel_max']:.3e} at position {f64['at_position']} (limit "
            f"{f64['limit']:.0e}), {chain64_ms:.2f} ms a token")
        if not f64["rel_max"] <= P22["chain64_rel"]:
            failures.append(f"({arch} chain) the float64 decode chain lies "
                            f"{f64['rel_max']:.3e} from the float64 forward "
                            f"(limit {P22['chain64_rel']:.0e})")
        del chain64
    groups = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    want_launches = ({"mamba2_ssd_fwd": cfg.n_layers, "flash_attention_fwd": groups}
                     if cfg.attn_every else {"wkv6_fwd": cfg.n_layers})
    got_launches = {k: launches[k] for k in want_launches}
    r = rel["chain_vs_kernel"]
    say(f"  ({arch} chain) {cfg.n_layers} layers at float32, B {b} x T {t}: "
        f"forward {fwd_ms:.1f} ms, decode {chain_ms:.2f} ms a token; relative "
        f"logit error, decode chain vs kernel forward: max {worst['chain_vs_kernel']:.3e} "
        f"at position {at}, first / second / last {r[0].item():.3e} / "
        f"{r[1].item():.3e} / {r[-1].item():.3e}; against a float64 forward: "
        f"kernel {worst['kernel_vs_f64']:.3e}, decode chain "
        f"{worst['chain_vs_f64']:.3e}, plain float32 forward {worst['plain_f32_vs_f64']:.3e} "
        f"(the float32 noise; at the first / second / last position "
        f"{noise[0].item():.3e} / {noise[1].item():.3e} / {noise[-1].item():.3e}); "
        + (f"limit at each position max({P22['chain_rel']:.0e}, {P22['noise_x']} "
           f"x noise), twice that between the chain and the kernel forward"
           if noisy else f"limit {P22['chain_rel']:.0e} at every position")
        + f", the largest share of it taken {share}; "
        f"launches {got_launches} (want {want_launches}); plain calls {plain}")
    if not finite or over:
        failures.append(f"({arch} chain) positions over the limit: {over}, "
                        f"finite {finite}")
    if got_launches != want_launches or any(plain.values()):
        failures.append(f"({arch} chain) launches {got_launches}, want "
                        f"{want_launches}; plain calls {plain}")
    del params, fwd, chain, plain32, plain64
    release()
    say(f"  ({arch} chain: {time.perf_counter() - t_part:.1f} s)")
    return {"layers": cfg.n_layers, "batch": b, "seq": t,
            "rel_logit_err_max": worst["chain_vs_kernel"], "at_position": at,
            "against_f64": {k: worst[k] for k in ("kernel_vs_f64",
                                                   "chain_vs_f64",
                                                   "plain_f32_vs_f64")},
            "limit_share": share, "noise_limits": noisy,
            "noise_x": P22["noise_x"],
            "floor": P22["chain_rel"],
            "rel_logit_err": [float(x) for x in r],
            "noise": [float(x) for x in noise], "float64_chain": f64,
            "forward_ms": fwd_ms, "decode_ms_per_token": chain_ms,
            "launches": got_launches}


def p22_train(name: str, argv: list, failures: list) -> dict:
    """(d) a training example on the card: its counts against the
    reference's, its flash launches (2 forward with the recompute and 3
    backward per layer per step run), no plain or library attention."""
    release()
    reset_family_launches()
    with counting_calls(PLAIN_SCANS[2:]) as plain:
        mod, r, _ = run_example(name, argv)
    launches = family_launches()
    layers = (mod.build_cfg(False).n_layers if hasattr(mod, "build_cfg")
              else get_config("phi3-mini-3.8b").reduced().n_layers)
    got = {k: r[k] for k in P22_TRAIN_COUNTS[name]}
    if got != P22_TRAIN_COUNTS[name]:
        failures.append(f"({name}) {got}, want the reference's "
                        f"{P22_TRAIN_COUNTS[name]}")
    steps = r["steps_run"]
    want = {"flash_attention_fwd": 2 * layers * steps,
            "flash_attention_bwd": 3 * layers * steps,
            "flash_attention_fwd_wide": 0, "flash_attention_bwd_wide": 0}
    have = {k: launches[k] for k in want}
    say(f"  ({name}) {layers} layers x {steps} steps run: flash launches "
        f"{have} (want {want}); plain calls {plain}")
    if have != want or any(plain.values()):
        failures.append(f"({name}) flash launches {have}, want {want}; "
                        f"plain calls {plain}")
    return {"counts": got, "layers": layers, "launches": have,
            "losses": [r["losses"][0], r["losses"][-1]]}


def p22_examples(failures: list) -> dict:
    """(d) the quickstart, fault_tolerant at ``--steps 30``, xPic and the
    serve example's fleet over two spawned workers on the card."""
    out = {"quickstart": p22_train("torch_quickstart", [], failures),
           "fault_tolerant": p22_train("torch_fault_tolerant_train",
                                       ["--steps", str(P22["ft_steps"])],
                                       failures)}
    release()
    _, r, _ = run_example("torch_xpic_offload", [])
    got = {k: r[k] for k in P22_XPIC_COUNTS}
    if got != P22_XPIC_COUNTS or not r["device"].startswith("cuda"):
        failures.append(f"(xpic) {got} on {r['device']}, want the "
                        f"reference's {P22_XPIC_COUNTS} on the card")
    out["xpic"] = {"counts": got, "device": r["device"],
                   "energy": [r["energy"][0], r["energy"][-1]]}
    release()
    _, r, _ = run_example("torch_serve", list(P22["fleet"]))
    layers = get_config(P22["fleet"][-1]).reduced().n_layers
    workers = []
    for st in r["worker_stats"]:
        k, s = st["kernels"], st["scheduler"]
        iters = s["prefill_calls"] * scheduler.PREFILL_BUCKET + s["steps"]
        workers.append({"paged_launches": k["paged_attention"],
                        "token_iterations": iters,
                        "plain_calls": k["decode_attention"]})
        if (k["paged_attention"] != layers * iters or k["decode_attention"]
                or k["paged_attention_quant"]):
            failures.append(f"(fleet) worker {k}, want {layers} layers x "
                            f"{iters} token iterations of paged launches only")
    if r["tokens"] != 6 * 6 or r["saved"] <= 0:
        failures.append(f"(fleet) {r['tokens']} tokens, {r['saved']} saved")
    say(f"  (fleet) workers' paged launches and token iterations: {workers}")
    out["fleet"] = {k: r[k] for k in ("tokens", "saved", "computed", "adopted",
                                      "shared_hits", "throttle_events")}
    out["fleet"]["workers"] = workers
    return out


def phase22() -> dict:
    say("== phase 22: the port's examples on the card: (a) rwkv6-3b and (b) "
        "zamba2-2.7b served at full size through examples/torch_serve.py, "
        "(c) their float32 decode chains against the scan kernels' forward, "
        "(d) the quickstart, fault_tolerant, xPic and fleet examples")
    t_phase = time.perf_counter()
    failures = []
    out = {"serve": {}, "chain": {}}
    for arch in P22["serve"]:
        out["serve"][arch] = p22_serve(arch, failures)
        out["chain"][arch] = p22_chain(arch, failures)
    out["examples"] = p22_examples(failures)
    out["seconds"] = time.perf_counter() - t_phase
    say(f"  phase 22 record: {json.dumps(out)}; took {out['seconds']:.1f} s")
    if failures:
        raise AssertionError("phase 22 gates failed:\n  " + "\n  ".join(failures))
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
    wide_serving_launches("paged_attention", kernels)

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
        ServeConfig(spec_k=3, kv_codec="int8", **SERVE),
        prompts[:INT8_REQUESTS], INT8_MAX_NEW)
    launches = pa.paged_attention_quant.launches
    report_serve("int8 spec_k=3", outs5, stats, wall, iters, launches, n_layers)
    if pa.paged_attention.launches:
        raise AssertionError("the int8 pool ran the plain-pool kernel")
    kernels["paged_attention_quant"]["launches"] = launches
    kernels["paged_attention_quant"]["launches_per_token_iteration"] = (
        launches / iters)
    wide_serving_launches("paged_attention_quant", kernels)
    same = sum(a == b for o5, o2 in zip(outs5, outs2) for a, b in zip(o5, o2))
    total = sum(min(len(o5), len(o2)) for o5, o2 in zip(outs5, outs2))
    say(f"  int8 token agreement with phase 2 over their common tokens: "
        f"{same}/{total} = "
        f"{same / total:.4f} (reported, not gated)")

    del outs2, outs3, outs5
    release()
    kernels.update(phase6())
    phase7()
    state, cfg, launches = phase8()
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        kernels[name]["launches"] = launches[name.rsplit("_", 1)[1]]
        kernels[name]["main_path"] = launches["main_path"]
    wide_main = {kind: launches[f"{kind}_wide"] for kind in ("fwd", "bwd")}
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
        kernels[name]["repair_widths"] = {
            label: r for label, r in repairs["flash"].items() if not r["wide"]}
        kernels[name]["repair_grid"] = repairs["flash_grid"]
    for kind in ("fwd", "bwd"):
        entry = wide_flash_entry(kind, repairs,
                                 kernels[f"flash_attention_{kind}"].pop("sass_wide"),
                                 wide_main[kind])
        kernels[entry["name"]] = entry
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
                kernels[name + "_wide"]["launches_" + arch] = (
                    got["launches"][name + "_wide"])

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
        for run in (mla["family"], moe["train"]):
            kernels[name + "_wide"]["launches_" + run["main_path"]["arch"]] = (
                run["launches"][name + "_wide"])
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
        for run in (p16["train"], p16["whisper"]):
            kernels[name + "_wide"]["launches_" + run["main_path"]["arch"]] = (
                run["launches"][name + "_wide"])
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

    p18 = phase18()
    kernels["xor_reduce"]["launches_phase18"] = [
        r["launches"] for r in p18["collectives"]["ranks"]]
    kernels["xor_reduce"]["phase18"] = {
        "rounds": {r["rank"]: r["rounds"] for r in p18["collectives"]["ranks"]},
        "psum_s": [r["psum_s"] for r in p18["collectives"]["ranks"]],
        "tasks": p18["tasks"], "step": p18["step"],
        "compression": p18["compression"], "seconds": p18["seconds"]}

    p19 = phase19()
    for kind in ("fwd", "bwd"):
        name = f"flash_attention_{kind}"
        kernels[name]["launches_phase19"] = {
            "a_" + P19["seqpar"][0]: [r["fwd"] if kind == "fwd" else 0
                                      for r in p19["a"]["ranks"]],
            "b_" + P19["seqpar"][1]: [r["fwd"] if kind == "fwd" else 0
                                      for r in p19["b"]["ranks"]],
            "c_prefill": [r["fwd"] if kind == "fwd" else 0
                          for r in p19["c"]["prefill"]["ranks"]],
            "c_train": {mesh: [run[kind] for r in recs for run in r["runs"]]
                        for mesh, recs in p19["c"]["train"].items()
                        if mesh != "single"}}
    kernels["flash_attention_fwd"]["phase19"] = {
        part: {k: v for k, v in p19[part].items() if k != "ranks"}
        for part in ("a", "b")}

    roundtrip = phase20()["roundtrip"]
    for name in ("paged_attention", "paged_attention_quant"):
        kernels[name]["launches_phase20"] = roundtrip["launches"][name]
        kernels[name]["phase20_roundtrip"] = {
            "shape": roundtrip["shape"],
            "max_abs_err": roundtrip["max_abs_err"][name],
            **{key: {"lengths": r["lengths"],
                     "paginate_cache_ms": r["paginate_cache_ms"], **r[name]}
               for key, r in roundtrip["times"].items()}}

    p21 = phase21(smi)
    for run in p21["train"]:
        for name, rec in run["kernels"].items():
            kernels[name]["phase21_" + run["arch"]] = {
                **rec, "launches": run["launches"][name]}

    p22 = phase22()
    chain, ex = p22["chain"], p22["examples"]
    for arch, name in (("rwkv6-3b", "wkv6_fwd"), ("zamba2-2.7b", "mamba2_ssd_fwd")):
        kernels[name]["launches_phase22"] = chain[arch]["launches"][name]
        kernels[name]["phase22"] = {
            "serve": {k: v for k, v in p22["serve"][arch].items() if k != "runs"},
            "chain": {k: v for k, v in chain[arch].items()
                      if k not in ("rel_logit_err", "noise", "float64_chain")},
            "float64_chain": chain[arch]["float64_chain"] and {
                k: v for k, v in chain[arch]["float64_chain"].items()
                if k != "rel"}}
    for kind in ("fwd", "bwd"):
        name = f"flash_attention_{kind}"
        kernels[name]["launches_phase22"] = {
            key: ex[key]["launches"][name] for key in ("quickstart",
                                                       "fault_tolerant")}
    kernels["flash_attention_fwd"]["launches_phase22"]["zamba2-2.7b_chain"] = (
        chain["zamba2-2.7b"]["launches"]["flash_attention_fwd"])
    kernels["paged_attention"]["launches_phase22_fleet_workers"] = sum(
        w["paged_launches"] for w in ex["fleet"]["workers"])

    say(smi)
    say(json.dumps({"kernels": list(kernels.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
