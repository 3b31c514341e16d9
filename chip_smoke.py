#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives its serving path with full-width, full-depth phi3-mini-3.8b
(random weights from a seed).  Phases, each of which raises on a failed
check:

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
   token agreement against phase 2 reported.

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
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve import Serve, ServeConfig, scheduler  # noqa: E402

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
            if "registers" in line or "spill" in line:
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

    say(smi)
    say(json.dumps({"kernels": list(kernels.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
