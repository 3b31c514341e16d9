#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives its serving path with full-width, full-depth phi3-mini-3.8b and
its training-and-recovery path with full-width phi3-mini-3.8b cut to 2
layers (random weights from a seed).  Phases, each of which raises on a
failed check:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, TF32 off, and the kernels' build time;
1. every kernel against its plain PyTorch version on the card, at
   phi3's attention shape (32 heads, head dim 96) and starcoder2-7b's
   (36 over 4 kv heads, head dim 128), page 16, ragged lengths, shared
   prefix pages and out-of-range table entries, float32 and bfloat16,
   the multi-token fold and the int8 kernel; then kernel, plain and
   ``scaled_dot_product_attention`` times at phi3's serving shape;
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
   shape (B 4, T 512) and starcoder2-7b's (36 over 4, D 128), a ragged
   T 200 and Tq < Tk, float32 and bfloat16, with the float32 gradients
   also held against a float64 computation; the kernel path refuses
   prefix_len != 0 and
   Tq > Tk; then forward and backward times at the training shape (B 4,
   T 512, phi3 heads, bf16) beside their bounds, the plain version's and
   ``scaled_dot_product_attention``'s;
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
   SCR stored; the kernel timed at that shape.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.io.serialization import serialize_state_stream  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import xor_parity as xp  # noqa: E402
from repro_torch.memory.stack import TierStack  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, tree_leaves  # noqa: E402
from repro_torch.serve import Serve, ServeConfig, scheduler  # noqa: E402
from repro_torch.train.step import init_train_state  # noqa: E402
from repro_torch.train.trainer import FailureEvent, Trainer  # noqa: E402

SEED = 0
F32_TOL = dict(atol=3e-6, rtol=1e-5)     # tests/test_paged_attention.py
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
QUANT_VS_F32 = 0.05                      # tests/test_codecs.py:238
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


def sdpa_ms(q, k_pages, v_pages, table, lengths) -> float:
    """One PyTorch call computing the same function over the cache gathered
    beforehand (the yardstick; the port never calls it)."""
    F = torch.nn.functional
    n = k_pages.shape[0]
    b, hq, d = q.shape
    g = hq // k_pages.shape[2]
    tb = table.clamp(0, n - 1).long()
    kc = ref.gather_pages(k_pages, tb).repeat_interleave(g, 2).transpose(1, 2)
    vc = ref.gather_pages(v_pages, tb).repeat_interleave(g, 2).transpose(1, 2)
    kc, vc = kc.contiguous().to(q.dtype), vc.contiguous().to(q.dtype)
    s = kc.shape[2]
    mask = (torch.arange(s, device=DEVICE)[None, :] < lengths[:, None].long())
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(q4, kc, vc,
                                                          attn_mask=mask))


def phase1() -> dict:
    say("== phase 1: kernels against their plain versions")
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = {
        "phi3 (Hq=Hkv=32, D=96)": (4, 32, 32, 96, 16, 16, [256, 203, 96, 37]),
        "starcoder2-7b (Hq=36, Hkv=4, D=128)": (3, 36, 4, 128, 16, 8,
                                                [128, 77, 1]),
    }
    errs = {"paged_attention": 0.0, "paged_attention_quant": 0.0}
    for label, (b, hq, hkv, d, page, n_p, lens) in shapes.items():
        for dtype in (f32, bf16):
            tol = F32_TOL if dtype == f32 else BF16_TOL
            q, k, v, table, lengths = make_case(b, hq, hkv, d, page, n_p,
                                                lens, dtype)
            k, v = k[0], v[0]
            tag = f"{label} {str(dtype)[6:]}"
            got = ops.paged_attention(q, k, v, table, lengths)
            want = ops.paged_attention(q, k, v, table, lengths,
                                       use_kernel=False)
            errs["paged_attention"] = max(errs["paged_attention"], check_close(
                f"paged_attention {tag}", got, want, **tol))
            # the multi-token fold: 4 candidate rows per lane
            t_rows = 4
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
            qm = torch.randn(b, t_rows, hq, d, generator=gen,
                             device=DEVICE).to(dtype)
            base = (lengths.clamp(min=t_rows) - t_rows).to(torch.int32)
            positions = base[:, None] + torch.arange(
                t_rows, dtype=torch.int32, device=DEVICE)[None]
            got = ops.paged_attention_multitok(qm, k, v, table, positions)
            want = ops.paged_attention_multitok(qm, k, v, table, positions,
                                                use_kernel=False)
            check_close(f"paged_attention_multitok {tag}", got, want, **tol)
            # the int8 kernel against its plain version
            kq, ks = ref.quantize_pages(k)
            vq, vs = ref.quantize_pages(v)
            got = ops.paged_attention_quant(q, kq, ks, vq, vs, table, lengths)
            want = ops.paged_attention_quant(q, kq, ks, vq, vs, table, lengths,
                                             use_kernel=False)
            errs["paged_attention_quant"] = max(
                errs["paged_attention_quant"],
                check_close(f"paged_attention_quant {tag}", got, want, **tol))
            got = ops.paged_attention_quant_multitok(qm, kq, ks, vq, vs,
                                                     table, positions)
            want = ops.paged_attention_quant_multitok(
                qm, kq, ks, vq, vs, table, positions, use_kernel=False)
            check_close(f"paged_attention_quant_multitok {tag}", got, want,
                        **tol)
            if dtype == f32:
                # the int8 kernel is the float32 kernel on the dequantized
                # pool, and within the reference's int8 gate of the float32
                # kernel on the original pool
                got = ops.paged_attention_quant(q, kq, ks, vq, vs, table,
                                                lengths)
                deq = ops.paged_attention(q, kq.float() * ks[..., None],
                                          vq.float() * vs[..., None], table,
                                          lengths)
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
    torch.cuda.synchronize()

    # times at phi3's serving shape: 4 slots over a 128-page pool, bf16,
    # one layer's pool per call out of 8, so each call finds L2 cold
    b, hq, hkv, d, page, n_p, lens = shapes["phi3 (Hq=Hkv=32, D=96)"]
    q, k, v, table, lengths = make_case(b, hq, hkv, d, page, n_p, lens, bf16,
                                        layers=8)
    kq, ks = ref.quantize_pages(k)
    vq, vs = ref.quantize_pages(v)
    layer = itertools.cycle(range(8))
    rec = {}

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
            lambda: sdpa_ms(q, k[0], v[0], table, lengths),
            kernel_bound_ms(q, k[0], table, lengths),
            "src/repro/kernels/paged_attention.py:130"),
        "paged_attention_quant": (
            lambda: quant_call(next(layer)),
            lambda: quant_call(next(layer), use_kernel=False),
            lambda: sdpa_ms(q, kq[0].float() * ks[0][..., None],
                            vq[0].float() * vs[0][..., None], table, lengths),
            kernel_bound_ms(q, kq[0], table, lengths, quant=True),
            "src/repro/kernels/paged_attention.py:341"),
    }
    for name, (kern, plain, lib, (bound, bound_by), replaces) in timed.items():
        ms = time_ms(kern)
        plain_ms = time_ms(plain, iters=20, warmup=3)
        library_ms = lib()
        rec[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": replaces, "launches": 0,
            "max_abs_err": errs[name], "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": {"B": b, "Hq": hq, "Hkv": hkv, "D": d, "page": page,
                      "lengths": lens, "dtype": "bfloat16"},
        }
        say(f"  {name} at phi3's serving shape: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound:.4f} "
            f"ms ({bound_by})")
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


def flash_grads(q, k, v, dout, use_kernel):
    """(out, dq, dk, dv) through ops.flash_attention and autograd."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(q, k, v, use_kernel=use_kernel)
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
    }
    errs = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0}
    for label, shape in shapes.items():
        for dtype in (f32, bf16):
            tol = FLASH_F32_TOL if dtype == f32 else FLASH_BF16_TOL
            bwd_tol = FLASH_BWD_F32_TOL if dtype == f32 else FLASH_BF16_TOL
            tag = f"{label} {str(dtype)[6:]}"
            q, k, v, dout = flash_inputs(*shape, dtype)
            got = flash_grads(q, k, v, dout, None)
            want = flash_grads(q, k, v, dout, False)
            errs["flash_attention_fwd"] = max(
                errs["flash_attention_fwd"],
                check_close(f"flash fwd {tag}", got[0], want[0], **tol))
            for name, g, w in zip(("dQ", "dK", "dV"), got[1:], want[1:]):
                errs["flash_attention_bwd"] = max(
                    errs["flash_attention_bwd"],
                    check_close(f"flash bwd {name} {tag}", g, w, **bwd_tol))
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
                del exact
    torch.cuda.synchronize()
    q, k, v, _ = flash_inputs(1, 64, 32, 4, 4, 96, bf16)
    for what, call in (("prefix_len=4", lambda: ops.flash_attention(
                            q[:, :32], k, v, prefix_len=4)),
                       ("Tq=64 > Tk=32", lambda: ops.flash_attention(q, k, v))):
        try:
            call()
        except ValueError as e:
            say(f"  kernel path refuses {what}: {e}")
        else:
            raise AssertionError(f"the flash kernel path accepted {what}")

    # times at the training shape, bf16
    F = torch.nn.functional
    b, t, h, d = TRAIN["batch"], TRAIN["seq"], 32, 96
    q, k, v, dout = flash_inputs(b, t, t, h, h, d, bf16)
    out, lse = fa.flash_attention_fwd(q, k, v)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    plain_out = ref.flash_attention(qr, kr, vr)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dout_t = dout.transpose(1, 2)
    timed = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v),
            lambda: ref.flash_attention(q, k, v),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            flash_bound_ms(b, t, t, h, h, d, 2, backward=False)),
        "flash_attention_bwd": (
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout),
            lambda: torch.autograd.grad(plain_out, (qr, kr, vr), dout,
                                        retain_graph=True),
            lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t,
                                        retain_graph=True),
            flash_bound_ms(b, t, t, h, h, d, 2, backward=True)),
    }
    rec = {}
    for name, (kern, plain, lib, (bound, bound_by)) in timed.items():
        ms = time_ms(kern, iters=50)
        plain_ms = time_ms(plain, iters=10, warmup=2)
        library_ms = time_ms(lib, iters=50)
        rec[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:123",
            "launches": 0, "max_abs_err": errs[name], "ms": ms,
            "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": {"B": b, "T": t, "Hq": h, "Hkv": h, "D": d,
                      "dtype": "bfloat16", "causal": True},
        }
        say(f"  {name} at the training shape: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound:.4f} "
            f"ms ({bound_by})")
    rec["flash_attention_bwd"]["note"] = (
        "the reference has no backward kernel: JAX differentiates "
        "layers.flash_attention, whose TPU kernel the forward replaces; "
        "one backward pass is 3 launches (delta, dQ, dK/dV), each counted, "
        "and ms is the time of one pass")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2

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

    say(smi)
    say(json.dumps({"kernels": list(kernels.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
