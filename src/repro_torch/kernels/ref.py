"""Plain PyTorch versions of the port's kernels: paged attention, flash
attention and the XOR parity reduce.

Each function is the obvious, untiled computation its kernel performs,
written as the reference's jnp oracles are (``repro/kernels/ref.py`` and
the jnp fallbacks in ``repro/kernels/paged_attention.py``).  The CPU
tests hold these against the reference, :mod:`repro_torch.kernels.ops`
runs them for CPU tensors, and ``chip_smoke.py`` holds the CUDA kernels
against them on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.memory.codecs import int8_dequantize, int8_quantize

# the kernels' masking constant (repro/kernels/flash_attention.py:26)
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _promoted(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Cast to the common dtype, as jnp's einsum promotes mixed inputs."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) for x in xs)


def decode_attention_ref(
    q: torch.Tensor,         # (B, Hq, D) one new query token per sequence
    k_cache: torch.Tensor,   # (B, S, Hkv, D)
    v_cache: torch.Tensor,   # (B, S, Hkv, Dv)
    length,                  # (B,) valid cache lengths, or a scalar
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention over a (possibly padded) KV cache."""
    b, s, hkv, d = k_cache.shape
    group = q.shape[1] // hkv
    scale = (d ** -0.5) if scale is None else scale
    kq = k_cache.repeat_interleave(group, dim=2)
    vq = v_cache.repeat_interleave(group, dim=2)
    qs, kq = _promoted(q * scale, kq)
    logits = torch.einsum("bhd,bshd->bhs", qs, kq).float()
    lengths = torch.as_tensor(length, device=q.device).expand(b)
    mask = torch.arange(s, device=q.device)[None, None, :] < lengths[:, None, None]
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs, vq = _promoted(probs.to(vq.dtype), vq)
    return torch.einsum("bhs,bshd->bhd", probs, vq)


def gather_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(N, page, *rest) pool through a (B, nP) table -> (B, nP*page, *rest)
    contiguous view (``jnp.take(pages, table, axis=0)`` reshaped)."""
    out = pages[table.long()]
    b, n_p, page = out.shape[:3]
    return out.reshape((b, n_p * page) + tuple(out.shape[3:]))


def paged_attention(
    q: torch.Tensor,          # (B, Hq, D)
    k_pages: torch.Tensor,    # (N, page, Hkv, D)
    v_pages: torch.Tensor,    # (N, page, Hkv, Dv)
    page_table: torch.Tensor,  # (B, nP) int32, entries in [0, N)
    lengths: torch.Tensor,    # (B,)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather the table's pages into a contiguous view and run exact
    masked decode attention — the same operations, in the same order, as
    the reference's ``paged_decode_step`` gather followed by
    ``layers.decode_attention`` (mixed dtypes promote as jnp's do)."""
    b, hq, d = q.shape
    hkv, dv = v_pages.shape[2:]
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    qg, k = _promoted((q * scale).reshape(b, hkv, g, d), k)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k).float()
    mask = (torch.arange(k.shape[1], device=q.device)[None, None, None, :]
            < lengths[:, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1)
    probs, v = _promoted(probs.to(v.dtype), v)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v)
    return out.reshape(b, hq, dv)


def paged_attention_multitok(
    q: torch.Tensor,          # (B, T, Hq, D)
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, nP)
    positions: torch.Tensor,  # (B, T) absolute position of each candidate row
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Row ``(b, t)`` attends to pool positions ``<= positions[b, t]`` of
    lane ``b``'s table (speculative verification)."""
    b, t, hq, d = q.shape
    hkv, dv = v_pages.shape[2:]
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    qg, k = _promoted((q * scale).reshape(b, t, hkv, g, d), k)
    s = torch.einsum("bthgd,bshd->bthgs", qg, k).float()
    mask = (torch.arange(k.shape[1], device=q.device)[None, None, None, None, :]
            <= positions[:, :, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1)
    probs, v = _promoted(probs.to(v.dtype), v)
    out = torch.einsum("bthgs,bshd->bthgd", probs, v)
    return out.reshape(b, t, hq, dv)


def quantize_pages(pages: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, page, Hkv, D) pool -> (int8 values, (N, page, Hkv) f32 scales),
    one scale per (slot, token, head)."""
    q, scale = int8_quantize(pages, axis=-1)
    return q, scale[..., 0]


def paged_attention_quant(
    q: torch.Tensor,          # (B, Hq, D)
    k_pages: torch.Tensor,    # (N, page, Hkv, D) int8
    k_scales: torch.Tensor,   # (N, page, Hkv) f32
    v_pages: torch.Tensor,    # (N, page, Hkv, Dv) int8
    v_scales: torch.Tensor,   # (N, page, Hkv) f32
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dequantize the pool and attend in f32; out in q's dtype.

    q is scaled in its own dtype and then promoted against the f32
    pages, as the reference's int8 decode path computes it
    (``transformer.py:471-477`` then ``layers.decode_attention``); the
    reference's jnp oracle casts q to f32 first, which agrees exactly at
    fp32 and within bf16 rounding otherwise."""
    kf = int8_dequantize(k_pages, k_scales[..., None])
    vf = int8_dequantize(v_pages, v_scales[..., None])
    return paged_attention(q, kf, vf, page_table, lengths,
                           scale=scale).to(q.dtype)


def paged_attention_quant_multitok(
    q: torch.Tensor,          # (B, T, Hq, D)
    k_pages: torch.Tensor,
    k_scales: torch.Tensor,
    v_pages: torch.Tensor,
    v_scales: torch.Tensor,
    page_table: torch.Tensor,
    positions: torch.Tensor,  # (B, T)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The multi-row form of :func:`paged_attention_quant`."""
    b, t = q.shape[:2]
    out = paged_attention_quant(
        q.reshape((b * t,) + q.shape[2:]), k_pages, k_scales, v_pages,
        v_scales, page_table.repeat_interleave(t, dim=0),
        positions.reshape(b * t) + 1, scale=scale)
    return out.reshape((b, t) + out.shape[1:])


def flash_attention(
    q: torch.Tensor,          # (B, Tq, Hq, D)
    k: torch.Tensor,          # (B, Tk, Hkv, D)
    v: torch.Tensor,          # (B, Tk, Hkv, Dv)
    causal: bool = True,
    scale: Optional[float] = None,
    prefix_len: int = 0,      # prefix-LM: the first keys are visible to all
) -> torch.Tensor:
    """Exact attention computed as ``flash_attention_pallas`` computes it:
    scores from f32 copies of q and k, keys after ``q_pos = row + Tk -
    Tq`` masked with :data:`NEG_INF` (causal), softmax statistics in f32,
    ``p`` cast to V's dtype before ``p.V``, output in q's dtype.  GQA
    repeats each kv head over its group.  Differentiable: autograd through
    it is the plain version of the backward kernel.  float64 inputs are
    computed in float64 (an oracle for the float32 paths)."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    acc = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(acc).repeat_interleave(g, dim=2)
    vf = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), kf) * scale
    if causal:
        q_pos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        k_pos = torch.arange(tk, device=q.device)[None, :]
        visible = (k_pos <= q_pos) | (k_pos < prefix_len)
        s = torch.where(visible, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).to(acc), vf.to(acc))
    out = pv / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def xor_reduce(stacked: torch.Tensor) -> torch.Tensor:
    """(R, M, 128) int32 -> (M, 128): XOR over axis 0."""
    out = stacked[0].clone()
    for i in range(1, stacked.shape[0]):
        out ^= stacked[i]
    return out
