"""Dispatch between the CUDA kernels and their plain versions, by device.

Counterpart of ``repro/kernels/ops.py``, which picks by JAX backend.
Here the tensor decides:

* a CUDA tensor launches the hand-written kernel, or the wrapper raises —
  nothing falls back;
* a meta tensor takes the kernel's shape rule: the wrapper's checks and
  allocations (outputs, what the autograd function saves, workspaces),
  no launch and never the plain body, so a dry run on the meta device
  (:mod:`repro_torch.launch.dryrun`) sees what the card allocates;
* a CPU tensor runs the plain PyTorch version in
  :mod:`repro_torch.kernels.ref`;
* ``use_kernel=False`` runs the plain version on a CUDA or meta tensor
  (the comparisons in ``chip_smoke.py`` use it); ``use_kernel=True`` on a
  CPU tensor raises.

Each call of a kernel function on the card or on meta reports its work
(:mod:`repro_torch.kernels.work`) to an active dry-run counter, once per
call: the paged functions and ``xor_reduce`` here, flash and the scans in
their wrappers' entry points and autograd backwards.

The two recurrent scans (WKV6 and Mamba2 SSD) have their plain versions
here: the chunked forms of the reference's ``ops.wkv6_chunked`` and
``ops.mamba2_chunked`` (same blocking, f32 state, differentiable by
autograd), whose own oracles are the sequential ``ref.rwkv6_ref`` and
``ref.mamba2_ref``.  Their kernels take an initial state, so both paths
carry one.

Both paged-attention sides see the same clamped page table.  Both flash
paths apply the prefix-LM mask (``prefix_len``) as the reference's jnp
``layers.flash_attention`` does; the reference's own Pallas dispatch drops
it, and the port does not copy that.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rwkv6_scan as wkv
from repro_torch.kernels import work
from repro_torch.kernels import xor_parity as xp


def _kernel_for(x: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    """Whether ``x`` goes to the kernel's wrapper (a CUDA or meta tensor,
    unless ``use_kernel=False``) or to the plain body."""
    if use_kernel is None:
        return x.device.type in _build.KERNEL_DEVICES
    if use_kernel and x.device.type not in _build.KERNEL_DEVICES:
        raise ValueError(f"use_kernel=True needs a CUDA tensor, got {x.device}")
    return bool(use_kernel)


def _paged_work(q, k_pages, page_table, quant=False, t=1):
    """A paged call's work (:func:`work.paged`) from its shapes."""
    _, page, hkv, d = k_pages.shape
    return work.paged(q.shape[0], q.shape[-2], hkv, d, q.element_size(),
                      k_pages.element_size(), page_table.shape[1], page,
                      quant=quant, t=t)


def _clamped(table: torch.Tensor, n: int) -> torch.Tensor:
    return table.clamp(0, n - 1)


def xor_reduce(stacked, use_kernel: Optional[bool] = None):
    """(R, M, 128) int32 -> (M, 128): XOR over axis 0."""
    if _kernel_for(stacked, use_kernel):
        return work.counted("xor_reduce",
                            lambda: work.xor_reduce(*stacked.shape[:2]),
                            xp.xor_reduce, stacked)
    return kref.xor_reduce(stacked)


def flash_attention(q, k, v, causal=True, prefix_len=0, scale=None,
                    use_kernel: Optional[bool] = None):
    """(B, Tq, Hq, D) queries over (B, Tk, Hkv, D) keys and (B, Tk, Hkv,
    Dv) values -> (B, Tq, Hq, Dv); Dv may differ from D on both paths.
    With ``causal``, the first ``prefix_len`` keys are visible to every
    row (prefix-LM); without it, ``prefix_len`` changes nothing.
    Differentiable on both paths (the kernel path through the backward
    kernel)."""
    if _kernel_for(q, use_kernel):
        return fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                  prefix_len=prefix_len)
    return kref.flash_attention(q, k, v, causal=causal, scale=scale,
                                prefix_len=prefix_len)


def paged_attention(q, k_pages, v_pages, page_table, lengths, scale=None,
                    use_kernel: Optional[bool] = None):
    """(B, Hq, D) decode attention over a paged pool."""
    if _kernel_for(q, use_kernel):
        return work.counted("paged_attention",
                            lambda: _paged_work(q, k_pages, page_table),
                            pa.paged_attention, q, k_pages, v_pages,
                            page_table, lengths, scale)
    return kref.paged_attention(q, k_pages, v_pages,
                                _clamped(page_table, k_pages.shape[0]),
                                lengths, scale)


def paged_attention_multitok(q, k_pages, v_pages, page_table, positions,
                             scale=None, use_kernel: Optional[bool] = None):
    """(B, T, Hq, D) speculative rows over a paged pool."""
    if _kernel_for(q, use_kernel):
        return work.counted(
            "paged_attention_multitok",
            lambda: _paged_work(q, k_pages, page_table, t=q.shape[1]),
            pa.paged_attention_multitok, q, k_pages, v_pages, page_table,
            positions, scale)
    return kref.paged_attention_multitok(
        q, k_pages, v_pages, _clamped(page_table, k_pages.shape[0]),
        positions, scale)


def paged_attention_quant(q, k_pages, k_scales, v_pages, v_scales,
                          page_table, lengths, scale=None,
                          use_kernel: Optional[bool] = None):
    """(B, Hq, D) decode attention over an int8 pool."""
    if _kernel_for(q, use_kernel):
        return work.counted(
            "paged_attention_quant",
            lambda: _paged_work(q, k_pages, page_table, quant=True),
            pa.paged_attention_quant, q, k_pages, k_scales, v_pages,
            v_scales, page_table, lengths, scale)
    return kref.paged_attention_quant(
        q, k_pages, k_scales, v_pages, v_scales,
        _clamped(page_table, k_pages.shape[0]), lengths, scale)


def paged_attention_quant_multitok(q, k_pages, k_scales, v_pages, v_scales,
                                   page_table, positions, scale=None,
                                   use_kernel: Optional[bool] = None):
    """(B, T, Hq, D) speculative rows over an int8 pool."""
    if _kernel_for(q, use_kernel):
        return work.counted(
            "paged_attention_quant_multitok",
            lambda: _paged_work(q, k_pages, page_table, quant=True,
                                t=q.shape[1]),
            pa.paged_attention_quant_multitok, q, k_pages, k_scales, v_pages,
            v_scales, page_table, positions, scale)
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
    """Single-token WKV6: r, k, v, w (B, H, D); state (B, H, D, D).  In
    f32, or float64 for float64 inputs, as ``wkv6_chunked``."""
    acc = torch.promote_types(r.dtype, torch.float32)
    r_, k_, v_, w_ = (x.to(acc) for x in (r, k, v, w))
    kv = k_[..., :, None] * v_[..., None, :]
    y = torch.einsum("bhd,bhde->bhe", r_, state + u.to(acc)[..., :, None] * kv)
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
