"""Dispatch between the CUDA kernels and their plain versions, by device.

Counterpart of ``repro/kernels/ops.py``, which picks by JAX backend.
Here the tensor decides:

* a CUDA tensor launches the hand-written kernel, or the wrapper raises —
  nothing falls back;
* a CPU tensor runs the plain PyTorch version in
  :mod:`repro_torch.kernels.ref`;
* ``use_kernel=False`` runs the plain version on a CUDA tensor (the
  comparisons in ``chip_smoke.py`` use it); ``use_kernel=True`` on a CPU
  tensor raises.

The two recurrent scans (WKV6 and Mamba2 SSD) have their plain versions
here: the chunked forms of the reference's ``ops.wkv6_chunked`` and
``ops.mamba2_chunked`` (same blocking, f32 state, differentiable by
autograd), whose own oracles are the sequential ``ref.rwkv6_ref`` and
``ref.mamba2_ref``.  Their kernels take an initial state, so both paths
carry one.

Both paged-attention sides see the same clamped page table.  The flash
kernel has no prefix-LM mask (neither has the reference's Pallas kernel,
whose dispatch drops ``prefix_len``): on the kernel path a non-zero
``prefix_len`` raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rwkv6_scan as wkv
from repro_torch.kernels import xor_parity as xp


def _kernel_for(x: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    if use_kernel is None:
        return x.device.type == "cuda"
    if use_kernel and x.device.type != "cuda":
        raise ValueError(f"use_kernel=True needs a CUDA tensor, got {x.device}")
    return bool(use_kernel)


def _clamped(table: torch.Tensor, n: int) -> torch.Tensor:
    return table.clamp(0, n - 1)


def xor_reduce(stacked, use_kernel: Optional[bool] = None):
    """(R, M, 128) int32 -> (M, 128): XOR over axis 0."""
    if _kernel_for(stacked, use_kernel):
        return xp.xor_reduce(stacked)
    return kref.xor_reduce(stacked)


def flash_attention(q, k, v, causal=True, prefix_len=0, scale=None,
                    use_kernel: Optional[bool] = None):
    """(B, Tq, Hq, D) attention over (B, Tk, Hkv, D) keys and values;
    differentiable on both paths (the kernel path through the backward
    kernel)."""
    # refused before the device check, so the refusal is the same anywhere
    if prefix_len and (use_kernel or (use_kernel is None and q.is_cuda)):
        raise ValueError(f"prefix_len={prefix_len}: the flash kernel has no "
                         "prefix-LM mask (nor has the reference's Pallas "
                         "kernel); only prefix_len=0 runs on the card")
    if _kernel_for(q, use_kernel):
        return fa.flash_attention(q, k, v, causal=causal, scale=scale)
    return kref.flash_attention(q, k, v, causal=causal, scale=scale,
                                prefix_len=prefix_len)


def paged_attention(q, k_pages, v_pages, page_table, lengths, scale=None,
                    use_kernel: Optional[bool] = None):
    """(B, Hq, D) decode attention over a paged pool."""
    if _kernel_for(q, use_kernel):
        return pa.paged_attention(q, k_pages, v_pages, page_table, lengths,
                                  scale)
    return kref.paged_attention(q, k_pages, v_pages,
                                _clamped(page_table, k_pages.shape[0]),
                                lengths, scale)


def paged_attention_multitok(q, k_pages, v_pages, page_table, positions,
                             scale=None, use_kernel: Optional[bool] = None):
    """(B, T, Hq, D) speculative rows over a paged pool."""
    if _kernel_for(q, use_kernel):
        return pa.paged_attention_multitok(q, k_pages, v_pages, page_table,
                                           positions, scale)
    return kref.paged_attention_multitok(
        q, k_pages, v_pages, _clamped(page_table, k_pages.shape[0]),
        positions, scale)


def paged_attention_quant(q, k_pages, k_scales, v_pages, v_scales,
                          page_table, lengths, scale=None,
                          use_kernel: Optional[bool] = None):
    """(B, Hq, D) decode attention over an int8 pool."""
    if _kernel_for(q, use_kernel):
        return pa.paged_attention_quant(q, k_pages, k_scales, v_pages,
                                        v_scales, page_table, lengths, scale)
    return kref.paged_attention_quant(
        q, k_pages, k_scales, v_pages, v_scales,
        _clamped(page_table, k_pages.shape[0]), lengths, scale)


def paged_attention_quant_multitok(q, k_pages, k_scales, v_pages, v_scales,
                                   page_table, positions, scale=None,
                                   use_kernel: Optional[bool] = None):
    """(B, T, Hq, D) speculative rows over an int8 pool."""
    if _kernel_for(q, use_kernel):
        return pa.paged_attention_quant_multitok(
            q, k_pages, k_scales, v_pages, v_scales, page_table, positions,
            scale)
    return kref.paged_attention_quant_multitok(
        q, k_pages, k_scales, v_pages, v_scales,
        _clamped(page_table, k_pages.shape[0]), positions, scale)


# ---------------------------------------------------------------------- #
# rwkv6 chunked WKV (Finch recurrence, data-dependent per-channel decay)
# ---------------------------------------------------------------------- #


def wkv6_chunked(
    r: torch.Tensor,   # (B, T, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,   # (B, T, H, D) decay in (0, 1)
    u: torch.Tensor,   # (H, D)
    state: Optional[torch.Tensor] = None,   # (B, H, D, D) f32
    chunk: int = 32,
    d_block: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6 (the reference's ``wkv6_chunked``): intra-chunk
    pairwise decays in ``d_block`` channel slices, an f32 state carried
    across chunks; padded tail rows decay by 1 and add nothing."""
    b, t, h, d = r.shape
    if d % d_block:
        raise ValueError(f"head size {d} is not a multiple of d_block "
                         f"{d_block}")
    # f32 for f32 and bf16 inputs, as the reference; float64 inputs stay
    # float64 (an oracle for the float32 paths)
    acc = torch.promote_types(r.dtype, torch.float32)
    if state is None:
        state = torch.zeros((b, h, d, d), dtype=acc, device=r.device)
    nc = -(-t // chunk)
    pad = nc * chunk - t
    if pad:
        padw = (0, 0, 0, 0, 0, pad)
        r, k, v = (F.pad(x, padw) for x in (r, k, v))
        w = F.pad(w, padw, value=1.0)      # identity decay on padding
    rs, ks, vs, ws = (x.to(acc).reshape(b, nc, chunk, h, d)
                      for x in (r, k, v, w))
    mask_lt = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                    device=r.device), -1)       # j < i
    uf = u.to(acc)
    S = state
    ys = []
    for c in range(nc):
        rc, kc, vc, wc = rs[:, c], ks[:, c], vs[:, c], ws[:, c]  # (B, c, H, D)
        logw = torch.log(torch.clamp(wc, min=1e-30))
        L = torch.cumsum(logw, dim=1)               # L_i = sum_{t<=i}
        Lprev = L - logw                            # L_{i-1}
        # A_ij = sum_d r_id k_jd e^{Lp_i - L_j}, in d_block slices
        A = torch.zeros((b, h, chunk, chunk), dtype=acc, device=r.device)
        for lo in range(0, d, d_block):
            sl = slice(lo, lo + d_block)
            diff = Lprev[:, :, None, :, sl] - L[:, None, :, :, sl]
            A = A + torch.einsum("bihd,bjhd,bijhd->bhij", rc[..., sl],
                                 kc[..., sl], torch.exp(diff))
        A = A * mask_lt
        # diagonal bonus term: (r_i . u*k_i) v_i
        diag = torch.einsum("bihd,hd,bihd->bhi", rc, uf, kc)
        y_intra = torch.einsum("bhij,bjhd->bihd", A, vc)
        y_intra = y_intra + diag.transpose(1, 2)[..., None] * vc
        # inter-chunk: y_i += (r_i * e^{Lprev_i}) S
        y_inter = torch.einsum("bihd,bhde->bihe", rc * torch.exp(Lprev), S)
        # S' = diag(e^{L_c}) S + sum_j (k_j e^{L_c - L_j}) v_j^T
        Ltot = L[:, -1]
        kdec = kc * torch.exp(Ltot[:, None] - L)
        S = (torch.exp(Ltot)[..., None] * S
             + torch.einsum("bjhd,bjhe->bhde", kdec, vc))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(b, nc * chunk, h, d)[:, :t]
    return y.to(r.dtype), S


def wkv6(r, k, v, w, u, state=None, use_kernel: Optional[bool] = None):
    """WKV6 over (B, T, H, D) -> ``(y in r's dtype, f32 state)``;
    differentiable on both paths (the kernel path through the backward
    kernel)."""
    if _kernel_for(r, use_kernel):
        return wkv.wkv6(r, k, v, w.float(), u.float(), state)
    return wkv6_chunked(r, k, v, w, u, state)


def wkv6_decode_step(r, k, v, w, u, state):
    """Single-token WKV6: r, k, v, w (B, H, D); state (B, H, D, D)."""
    f32 = torch.float32
    r_, k_, v_, w_ = (x.to(f32) for x in (r, k, v, w))
    kv = k_[..., :, None] * v_[..., None, :]
    y = torch.einsum("bhd,bhde->bhe", r_, state + u.to(f32)[..., :, None] * kv)
    state = w_[..., :, None] * state + kv
    return y.to(r.dtype), state


# ---------------------------------------------------------------------- #
# mamba2 SSD chunked scan
# ---------------------------------------------------------------------- #


def mamba2_chunked(
    x: torch.Tensor,    # (B, T, H, P)
    dt: torch.Tensor,   # (B, T, H) softplus'd, > 0
    A: torch.Tensor,    # (H,) negative decay rate
    Bm: torch.Tensor,   # (B, T, N)
    Cm: torch.Tensor,   # (B, T, N)
    state: Optional[torch.Tensor] = None,   # (B, H, P, N) f32
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (the reference's ``mamba2_chunked``): the scalar
    per-head decay makes A_ij a plain (c, c) matrix; the update includes
    the current token (mask j <= i); padded tail rows add nothing.  The
    same values as the reference; unlike its autograd, the gradient is
    finite where a chunk's decays overflow above the diagonal."""
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)   # as wkv6_chunked
    if state is None:
        state = torch.zeros((b, h, p, n), dtype=acc, device=x.device)
    nc = -(-t // chunk)
    pad = nc * chunk - t
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    xs = x.to(acc).reshape(b, nc, chunk, h, p)
    dts = dt.to(acc).reshape(b, nc, chunk, h)
    bs = Bm.to(acc).reshape(b, nc, chunk, n)
    cs = Cm.to(acc).reshape(b, nc, chunk, n)
    mask_le = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                    device=x.device))           # j <= i
    S = state
    ys = []
    for c in range(nc):
        xc, dtc, bc, cc = xs[:, c], dts[:, c], bs[:, c], cs[:, c]
        L = torch.cumsum(A.to(acc)[None, None, :] * dtc, dim=1)  # (B, c, H)
        # A_ij = (C_i . B_j) e^{L_i - L_j} dt_j   for j <= i
        G = torch.einsum("bin,bjn->bij", cc, bc)
        # e^{L_i - L_j}, masked in the exponent: above the diagonal
        # L_i - L_j > 0 can overflow to inf, and the reference's
        # where(mask, G D dt, 0) after the exp gives its gradient 0 * inf =
        # NaN there; the forward values are the same either way
        seg = L[:, :, None] - L[:, None, :]                        # (B, i, j, H)
        seg = torch.where(mask_le[None, :, :, None], seg,
                          torch.full((), float("-inf"), dtype=acc,
                                     device=x.device))
        Aij = G[..., None] * torch.exp(seg) * dtc[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", Aij, xc)
        # inter: y_i += (C_i e^{L_i}) . S
        cdec = cc[:, :, None, :] * torch.exp(L)[..., None]        # (B, c, H, N)
        y_inter = torch.einsum("bihn,bhpn->bihp", cdec, S)
        # S' = e^{L_c} S + sum_j dt_j x_j (B_j e^{L_c - L_j})^T
        Ltot = L[:, -1]                                           # (B, H)
        bdec = bc[:, :, None, :] * torch.exp(Ltot[:, None, :, None]
                                             - L[..., None])
        upd = torch.einsum("bjhp,bjhn,bjh->bhpn", xc, bdec, dtc)
        S = torch.exp(Ltot)[..., None, None] * S + upd
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(b, nc * chunk, h, p)[:, :t]
    return y.to(x.dtype), S


def mamba2_ssd(x, dt, A, Bm, Cm, state=None,
               use_kernel: Optional[bool] = None):
    """SSD scan over (B, T, H, P) -> ``(y in x's dtype, f32 state)``;
    differentiable on both paths (the kernel path through the backward
    kernel)."""
    if _kernel_for(x, use_kernel):
        return ssd.mamba2_ssd(x, dt.float(), A.float(), Bm, Cm, state)
    return mamba2_chunked(x, dt, A, Bm, Cm, state)


def mamba2_decode_step(x, dt, A, Bm, Cm, state):
    """Single-token SSD step: x (B, H, P), dt (B, H), Bm/Cm (B, N)."""
    f32 = torch.float32
    decay = torch.exp(A[None, :] * dt.to(f32))
    upd = ((dt.to(f32)[..., None, None] * x.to(f32)[..., :, None])
           * Bm.to(f32)[:, None, None, :])
    state = decay[..., None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", state, Cm.to(f32))
    return y.to(x.dtype), state
