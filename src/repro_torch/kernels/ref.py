"""Plain PyTorch versions of the port's kernels: paged attention, flash
attention, the XOR parity reduce, and the sequential WKV6 and Mamba2-SSD
recurrences (the oracles of the chunked scans in :mod:`.ops`).

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


def paged_attention_split(
    q: torch.Tensor,          # (B, Hq, D)
    k_pages: torch.Tensor,    # (N, page, Hkv, D)
    v_pages: torch.Tensor,    # (N, page, Hkv, Dv)
    page_table: torch.Tensor,  # (B, nP) int32, clamped to [0, N) here
    lengths: torch.Tensor,    # (B,)
    split: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The CUDA kernel's algorithm, written plainly: each row's valid
    positions (``min(lengths[b], nP*page)``) are cut into spans of
    ``split``; each span takes its own max ``m_s``, ``e = exp(s - m_s)``,
    ``l_s = sum e`` and ``acc_s = p V`` with ``p`` rounded to the pool's
    dtype; the spans combine in order 0, 1, ...: ``m = max m_s``, ``l =
    sum l_s e^(m_s - m)``, ``acc = sum acc_s e^(m_s - m)``, and the output
    is ``acc / max(l, 1e-30)`` in q's dtype (zeros where the length is
    0).  Scores are ``(q . k) * scale`` in f32.  For the tests and
    ``chip_smoke.py``; the port's paths call :func:`paged_attention`."""
    b, hq, d = q.shape
    n, page, hkv, dv = v_pages.shape
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    span = page_table.shape[1] * page
    table = page_table.long().clamp(0, n - 1)
    k = gather_pages(k_pages, table)
    v = gather_pages(v_pages, table)
    f32 = torch.float32
    out = torch.zeros((b, hkv, g, dv), dtype=f32, device=q.device)
    for r in range(b):
        length = max(0, min(int(lengths[r]), span))
        qr = q[r].to(f32).reshape(hkv, g, d)
        parts = []
        for lo in range(0, length, split):
            hi = min(length, lo + split)
            s = torch.einsum("hgd,thd->hgt", qr, k[r, lo:hi].to(f32)) * scale
            m = s.amax(dim=-1)
            e = torch.exp(s - m[..., None])
            p = e.to(v.dtype).to(f32)
            parts.append((m, e.sum(dim=-1),
                          torch.einsum("hgt,thd->hgd", p, v[r, lo:hi].to(f32))))
        if not parts:
            continue
        m = torch.stack([m_s for m_s, _, _ in parts]).amax(dim=0)
        l = torch.zeros_like(m)
        acc = torch.zeros((hkv, g, dv), dtype=f32, device=q.device)
        for m_s, l_s, acc_s in parts:
            w = torch.exp(m_s - m)
            l = l + l_s * w
            acc = acc + acc_s * w[..., None]
        out[r] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, dv).to(q.dtype)


def paged_attention_quant_split(q, k_pages, k_scales, v_pages, v_scales,
                                page_table, lengths, split: int,
                                scale: Optional[float] = None) -> torch.Tensor:
    """:func:`paged_attention_split` over an int8 pool, each row
    dequantized by its f32 scale (``p`` stays f32)."""
    kf = int8_dequantize(k_pages, k_scales[..., None])
    vf = int8_dequantize(v_pages, v_scales[..., None])
    return paged_attention_split(q, kf, vf, page_table, lengths, split,
                                 scale=scale)


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


def rwkv6_ref(
    r: torch.Tensor,   # (B, T, H, D) receptance
    k: torch.Tensor,   # (B, T, H, D)
    v: torch.Tensor,   # (B, T, H, D)
    w: torch.Tensor,   # (B, T, H, D) per-step decay in (0, 1)
    u: torch.Tensor,   # (H, D) bonus of the current token
    state: Optional[torch.Tensor] = None,   # (B, H, D, D) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive sequential WKV6: ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``,
    ``o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)``; f32 state, output in
    r's dtype."""
    b, t, h, d = r.shape
    f32 = torch.float32
    s = (torch.zeros((b, h, d, d), dtype=f32, device=r.device)
         if state is None else state)
    uf = u.to(f32)
    outs = []
    for i in range(t):
        rt, kt, vt, wt = (x[:, i].to(f32) for x in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        outs.append(torch.einsum("bhd,bhde->bhe", rt, s + uf[..., :, None] * kv))
        s = wt[..., :, None] * s + kv
    return torch.stack(outs, 1).to(r.dtype), s


def mamba2_ref(
    x: torch.Tensor,    # (B, T, H, P) input heads
    dt: torch.Tensor,   # (B, T, H) softplus'd timestep
    A: torch.Tensor,    # (H,) negative decay rate
    Bm: torch.Tensor,   # (B, T, N) input -> state, shared by the heads
    Cm: torch.Tensor,   # (B, T, N) state -> output
    state: Optional[torch.Tensor] = None,   # (B, H, P, N) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive sequential Mamba2 SSD: ``S_t = exp(A dt_t) S_{t-1} + dt_t x_t
    B_t^T``, ``y_t = S_t C_t``; f32 state, output in x's dtype."""
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    f32 = torch.float32
    s = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
         if state is None else state)
    outs = []
    for i in range(t):
        xt, dtt, bt, ct = (y[:, i].to(f32) for y in (x, dt, Bm, Cm))
        decay = torch.exp(A[None, :] * dtt)
        upd = (dtt[..., None, None] * xt[..., :, None]) * bt[:, None, None, :]
        s = decay[..., None, None] * s + upd
        outs.append(torch.einsum("bhpn,bn->bhp", s, ct))
    return torch.stack(outs, 1).to(x.dtype), s


def _ssd_chunks(x, dt, Bm, Cm, chunk):
    """x, dt, Bm, Cm zero-padded to whole chunks, in f32 (or wider), as
    (B, nc, chunk, ...) views."""
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    nc = -(-t // chunk)
    pad = nc * chunk - t

    def padded(v, *tail):
        v = v.to(acc)
        if pad:
            v = torch.cat([v, v.new_zeros((b, pad) + tuple(tail))], 1)
        return v.reshape((b, nc, chunk) + tuple(tail))

    return (padded(x, h, p), padded(dt, h), padded(Bm, n), padded(Cm, n),
            nc, acc)


def _ssd_decays(A, dtc, mask):
    """Per chunk: L (B, c, H) the inclusive sums of A dt, E (B, i, j, H) =
    e^{L_i - L_j} below the diagonal (masked before the exp, so no exponent
    is positive), w_j = e^{L_last - L_j}, e^{L_i} and e^{L_last}."""
    L = torch.cumsum(A.to(dtc.dtype)[None, None, :] * dtc, dim=1)
    seg = L[:, :, None, :] - L[:, None, :, :]
    E = torch.exp(torch.where(mask[None, :, :, None], seg,
                              torch.full((), float("-inf"), dtype=L.dtype)))
    last = L[:, -1]
    return L, E, torch.exp(last[:, None, :] - L), torch.exp(L), torch.exp(last)


def mamba2_ssd_chunked(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, state: Optional[torch.Tensor] = None, chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SSD kernels' forward in their chunk form, written plainly:
    ``(y in x's dtype, final state, chunk-start states (B, H, nc, P, N))``.
    Per chunk, with L_i the inclusive sum of A dt, u_j = dt_j x_j and S0
    the chunk's start state::

        M_ij = (C_i . B_j) e^{L_i - L_j} [j <= i]
        y_i  = sum_j M_ij u_j + e^{L_i} S0 C_i
        S1   = e^{L_last} S0 + sum_j e^{L_last - L_j} u_j B_j^T
    """
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    xs, dts, bs, cs, nc, acc = _ssd_chunks(x, dt, Bm, Cm, chunk)
    S = (torch.zeros((b, h, p, n), dtype=acc, device=x.device)
         if state is None else state.to(acc))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    ys, starts = [], []
    for c in range(nc):
        xc, dtc, bc, cc = xs[:, c], dts[:, c], bs[:, c], cs[:, c]
        _, E, w, eL, eLl = _ssd_decays(A, dtc, mask)
        starts.append(S)
        M = torch.einsum("bin,bjn->bij", cc, bc)[..., None] * E
        y = (torch.einsum("bijh,bjh,bjhp->bihp", M, dtc, xc)
             + eL[..., None] * torch.einsum("bin,bhpn->bihp", cc, S))
        S = (eLl[..., None, None] * S
             + torch.einsum("bjhp,bjh,bjn->bhpn", xc, w * dtc, bc))
        ys.append(y)
    y = torch.stack(ys, 1).reshape(b, nc * chunk, h, p)[:, :t]
    return y.to(x.dtype), S, torch.stack(starts, 2)


def mamba2_ssd_chunked_grads(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, starts: torch.Tensor, dy: torch.Tensor, chunk: int = 64,
    dstate: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The SSD backward kernel's arithmetic, written plainly, from the
    chunk-start states of :func:`mamba2_ssd_chunked`, dy and the gradient
    on the final state ``dstate`` (None: zero): ``(dx, ddt, dA, dB, dC,
    dstate0)``, all in f32.

    The chunks run in reverse with dS1, the gradient on the chunk's end
    state (``dstate`` after the last).  With dM_ij = dt_j (dy_i . x_j) [j <= i] and
    Z = dM * M (off its diagonal, where the two sums below cancel)::

        du_j  = sum_i M_ij dy_i + w_j dS1 B_j            dx = dt du
        dB_j  = sum_i (dM E)_ij C_i + w_j dt_j dS1^T x_j
        dC_i  = sum_j (dM E)_ij B_j + e^{L_i} S0^T dy_i
        dS0   = e^{L_last} dS1 + sum_i e^{L_i} dy_i C_i^T
        da_k  = sum_{i >= k} (rowZ_i - colZ_i + r_i) + sum_{j < k} q_j
                + e^{L_last} <dS1, S0>
        ddt_k = x_k . du_k + A da_k,    dA = sum_k dt_k da_k

    with r_i = e^{L_i} dy_i . (S0 C_i) and q_j = w_j dt_j x_j . (dS1 B_j).
    No decay is divided out, and no sum takes a difference of the
    chunk's whole-state terms."""
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    xs, dts, bs, cs, nc, acc = _ssd_chunks(x, dt, Bm, Cm, chunk)
    dys = _ssd_chunks(dy, dt, Bm, Cm, chunk)[0]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    off = mask & ~torch.eye(chunk, dtype=torch.bool, device=x.device)
    dS = (torch.zeros((b, h, p, n), dtype=acc, device=x.device)
          if dstate is None else dstate.to(acc))
    dA = torch.zeros((h,), dtype=acc, device=x.device)
    dxs, ddts, dBs, dCs = [], [], [], []
    for c in reversed(range(nc)):
        xc, dtc, bc, cc, dyc = xs[:, c], dts[:, c], bs[:, c], cs[:, c], dys[:, c]
        S0 = starts[:, :, c].to(acc)
        _, E, w, eL, eLl = _ssd_decays(A, dtc, mask)
        M = torch.einsum("bin,bjn->bij", cc, bc)[..., None] * E
        dM = (torch.einsum("bihp,bjhp->bijh", dyc, xc) * dtc[:, None]
              * mask[None, :, :, None])
        dME = dM * E
        Z = dM * M * off[None, :, :, None]
        Q = torch.einsum("bjn,bhpn->bjhp", bc, dS)
        du = torch.einsum("bijh,bihp->bjhp", M, dyc) + w[..., None] * Q
        q = w * dtc * (xc * Q).sum(-1)
        YS = torch.einsum("bihp,bhpn->bihn", dyc, S0)
        r = eL * (YS * cc[:, :, None, :]).sum(-1)
        dBs.append(torch.einsum("bijh,bin->bjn", dME, cc)
                   + torch.einsum("bjh,bjhp,bhpn->bjn", w * dtc, xc, dS))
        dCs.append(torch.einsum("bijh,bjn->bin", dME, bc)
                   + torch.einsum("bih,bihn->bin", eL, YS))
        v = Z.sum(2) - Z.sum(1) + r
        da = (torch.flip(torch.cumsum(torch.flip(v, (1,)), 1), (1,))
              + torch.cumsum(q, 1) - q
              + (eLl * (dS * S0).sum((-1, -2)))[:, None])
        dxs.append(dtc[..., None] * du)
        ddts.append((xc * du).sum(-1) + A.to(acc) * da)
        dA = dA + (dtc * da).sum((0, 1))
        dS = (eLl[..., None, None] * dS
              + torch.einsum("bihp,bih,bin->bhpn", dyc, eL, cc))
    cat = lambda vs: torch.cat(vs[::-1], 1)[:, :t]
    return cat(dxs), cat(ddts), dA, cat(dBs), cat(dCs), dS


# a sub-block's per-channel decay total down to -WKV6_SAFE takes the
# factorised diagonal (its factors stay within e^{+-WKV6_SAFE}); below it the
# channel's diagonal entries are taken exactly (kChannelSafe in wkv6.cu)
WKV6_SAFE = 60.0


def _wkv6_chunks(r, k, v, w, chunk):
    """r, k, v, w zero-padded (w one-padded: no decay) to whole chunks, in
    f32 (or wider), as (B, nc, chunk, H, D) views."""
    b, t, h, d = r.shape
    acc = torch.promote_types(r.dtype, torch.float32)
    nc = -(-t // chunk)
    pad = nc * chunk - t

    def padded(x, fill=0.0):
        x = x.to(acc)
        if pad:
            x = torch.cat([x, x.new_full((b, pad, h, d), fill)], 1)
        return x.reshape(b, nc, chunk, h, d)

    return padded(r), padded(k), padded(v), padded(w, 1.0), nc, acc


def _wkv6_factors(wc, sub):
    """One chunk's decays (B, c, H, D) as the kernels factor them, with
    sub-blocks of ``sub`` tokens, l the inclusive and lp the exclusive sums
    of log w inside a sub-block, tot its total and B_I the sum of the totals
    before sub-block I:

        ea = e^{lp}, ek = e^{tot - l}               (per token, both <= 1)
        gam[I][J] = e^{B_I - B_{J+1}} (J < I)      (<= 1)
        gam[I][I] = e^{-tot_I} where tot_I >= -WKV6_SAFE, else 0
        eB[I] = e^{B_I}, etot[I] = e^{tot_I}, delta[J] = e^{Ltot - B_{J+1}}

    and Ex[I] (B, sub, sub, H, D), the diagonal block's exact factors
    e^{lp_i - l_j} masked to j < i before the exponent, kept only where the
    channel is not safe."""
    b, c, h, d = wc.shape
    ns = c // sub
    acc = wc.dtype
    # the sums of log w in float64, so that a difference keeps f32's
    # precision however far the decays have summed; each exponent is then
    # taken in the working dtype
    lw = torch.log(torch.clamp(wc, min=1e-30)).double().reshape(b, ns, sub, h, d)
    l = torch.cumsum(lw, 2)
    lp = l - lw
    tot = l[:, :, -1]                                   # (B, ns, H, D)
    Bs = torch.cumsum(tot, 1) - tot
    Ltot = tot.sum(1)
    safe = tot >= -WKV6_SAFE
    ex = lambda x: torch.exp(x.to(acc))
    lower = torch.tril(torch.ones((sub, sub), dtype=torch.bool,
                                  device=wc.device), -1)
    seg = lp[:, :, :, None] - l[:, :, None, :]          # (B, ns, i, j, H, D)
    seg = torch.where(lower[None, None, :, :, None, None], seg,
                      torch.full((), float("-inf"), dtype=seg.dtype))
    Ex = ex(seg) * (~safe)[:, :, None, None]
    gam = [[None] * ns for _ in range(ns)]
    for I in range(ns):
        for J in range(I):
            gam[I][J] = ex(Bs[:, I] - Bs[:, J] - tot[:, J])
        gam[I][I] = torch.where(safe[:, I], ex(-tot[:, I]),
                                torch.zeros((), dtype=acc))
    return dict(
        ea=ex(lp).reshape(b, c, h, d),
        ek=ex(tot[:, :, None] - l).reshape(b, c, h, d),
        gam=gam, eB=ex(Bs), etot=ex(tot), Ex=Ex,
        delta=ex(Ltot[:, None] - Bs - tot), eLtot=ex(Ltot))


def _wkv6_scores(rc, kc, uf, f, sub):
    """A (B, H, c, c): A_ij = sum_d r_id k_jd e^{Lp_i - L_j} below the
    diagonal, from the factors of :func:`_wkv6_factors` (off-diagonal
    sub-blocks and safe channels of the diagonal ones factorised, the rest
    exact), and the bonus r_i . (u k_i) on the diagonal."""
    b, c, h, d = rc.shape
    ns = c // sub
    a, kk = rc * f["ea"], kc * f["ek"]
    A = rc.new_zeros((b, h, c, c))
    for I in range(ns):
        si = slice(I * sub, (I + 1) * sub)
        for J in range(I + 1):
            sj = slice(J * sub, (J + 1) * sub)
            A[:, :, si, sj] = torch.einsum("bihd,bjhd->bhij",
                                           a[:, si] * f["gam"][I][J][:, None],
                                           kk[:, sj])
        A[:, :, si, si] += torch.einsum("bihd,bjhd,bijhd->bhij", rc[:, si],
                                        kc[:, si], f["Ex"][:, I])
    A = A * torch.tril(torch.ones((c, c), dtype=A.dtype, device=A.device), -1)
    beta = torch.einsum("bihd,hd,bihd->bhi", rc, uf, kc)
    return A + torch.diag_embed(beta)


def wkv6_chunked_form(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, state: Optional[torch.Tensor] = None, chunk: int = 64,
    sub: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The WKV6 kernels' forward in their chunk form, written plainly:
    ``(y in r's dtype, final state, chunk-start states (B, H, nc, D, D))``.
    Per chunk, with S0 its start state, Lp_i / L_i the exclusive / inclusive
    sums of log w from the chunk's start and A from :func:`_wkv6_scores`::

        y  = A v + (r e^{Lp}) S0
        S1 = e^{Ltot} S0 + sum_j (k_j e^{Ltot - L_j}) v_j^T

    where e^{Lp_i} = ea_i eB[I] and S1 is built sub-block by sub-block,
    S <- etot[J] S + (k ek)_J^T v_J.  No exponent is positive except the
    diagonal's factorised e^{-tot}, which is taken only where tot >=
    -WKV6_SAFE."""
    b, t, h, d = r.shape
    rs, ks, vs, ws, nc, acc = _wkv6_chunks(r, k, v, w, chunk)
    uf = u.to(acc)
    S = (torch.zeros((b, h, d, d), dtype=acc, device=r.device)
         if state is None else state.to(acc))
    ys, starts = [], []
    for c in range(nc):
        rc, kc, vc = rs[:, c], ks[:, c], vs[:, c]
        f = _wkv6_factors(ws[:, c], sub)
        starts.append(S)
        A = _wkv6_scores(rc, kc, uf, f, sub)
        y = torch.einsum("bhij,bjhe->bihe", A, vc)
        a, kk = rc * f["ea"], kc * f["ek"]
        for I in range(chunk // sub):
            si = slice(I * sub, (I + 1) * sub)
            y[:, si] += torch.einsum("bihd,bhde->bihe",
                                     a[:, si] * f["eB"][:, I][:, None], S)
        for J in range(chunk // sub):
            sj = slice(J * sub, (J + 1) * sub)
            S = (f["etot"][:, J][..., None] * S
                 + torch.einsum("bjhd,bjhe->bhde", kk[:, sj], vc[:, sj]))
        ys.append(y)
    y = torch.stack(ys, 1).reshape(b, nc * chunk, h, d)[:, :t]
    return y.to(r.dtype), S, torch.stack(starts, 2)


def wkv6_chunked_form_grads(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, starts: torch.Tensor, dy: torch.Tensor, chunk: int = 64,
    sub: int = 16, dstate: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The WKV6 backward kernel's arithmetic, written plainly, from the
    chunk-start states of :func:`wkv6_chunked_form`, dy and the gradient on
    the final state ``dstate`` (None: zero): ``(dr, dk, dv, dw, du,
    dstate0)``, all in f32.

    The chunks run in reverse with G, the gradient on the chunk's end state
    (``dstate`` after the last).  With dA_ij = dy_i . v_j below the diagonal and
    dbeta_i = dy_i . v_i::

        dv   = A^T dy + (k e^{Ltot - L}) G
        drA  = e^{Lp - Lp_I} (sum_J dA_IJ (k ek)_J gam[I][J]
                              + dy S0^T eB[I])   (+ the exact diagonal)
        dkA  = ek sum_I dA_IJ^T (r ea)_I gam[I][J] (+ the exact diagonal)
        dkS  = e^{Ltot - L} (v G^T)
        dr   = drA + u k dbeta,  dk = dkA + dkS + u r dbeta
        da_t = sum_{s>t} (r drA - k dkA)_s - (k dkA)_t
               + sum_{s<t} (k dkS)_s + e^{Ltot} <G, S0>_row
        dw   = da / w (0 where w <= 1e-30),  du = sum_t dbeta_t r_t k_t
        dS0  = e^{Ltot} G + sum_i (r e^{Lp})_i dy_i^T

    (drA holds the state term too).  The per-token sums are over one chunk,
    the state terms summed from the front (dkS) or the back (drA), so no
    sum takes the difference of two whole-chunk totals, and no decay is
    divided out: S0 comes from the forward's saved states."""
    b, t, h, d = r.shape
    rs, ks, vs, ws, nc, acc = _wkv6_chunks(r, k, v, w, chunk)
    dys = _wkv6_chunks(dy, k, v, w, chunk)[0]
    uf = u.to(acc)
    ns = chunk // sub
    lower = torch.tril(torch.ones((chunk, chunk), dtype=acc, device=r.device),
                       -1)
    G = (torch.zeros((b, h, d, d), dtype=acc, device=r.device)
         if dstate is None else dstate.to(acc))
    du = torch.zeros((h, d), dtype=acc, device=r.device)
    drs, dks, dvs, dws = [], [], [], []
    for c in reversed(range(nc)):
        rc, kc, vc, wc, dyc = rs[:, c], ks[:, c], vs[:, c], ws[:, c], dys[:, c]
        S0 = starts[:, :, c].to(acc)
        f = _wkv6_factors(wc, sub)
        a, kk = rc * f["ea"], kc * f["ek"]
        A = _wkv6_scores(rc, kc, uf, f, sub)
        dAf = torch.einsum("bihe,bjhe->bhij", dyc, vc)
        dbeta = torch.diagonal(dAf, dim1=-2, dim2=-1)            # (B, H, c)
        dA = dAf * lower
        dvs.append(torch.einsum("bhij,bihe->bjhe", A, dyc)
                   + torch.einsum("bjhd,bhde->bjhe",
                                  kk * f["delta"].repeat_interleave(sub, 1), G))
        drA = torch.zeros_like(rc)
        dkA = torch.zeros_like(rc)
        for I in range(ns):
            si = slice(I * sub, (I + 1) * sub)
            x = (torch.einsum("bihe,bhde->bihd", dyc[:, si], S0)
                 * f["eB"][:, I][:, None])
            for J in range(I + 1):
                sj = slice(J * sub, (J + 1) * sub)
                x = x + (torch.einsum("bhij,bjhd->bihd", dA[..., si, sj],
                                      kk[:, sj])
                         * f["gam"][I][J][:, None])
            drA[:, si] = x * f["ea"][:, si] + torch.einsum(
                "bhij,bjhd,bijhd->bihd", dA[..., si, si], kc[:, si],
                f["Ex"][:, I])
        for J in range(ns):
            sj = slice(J * sub, (J + 1) * sub)
            y = 0
            for I in range(J, ns):
                si = slice(I * sub, (I + 1) * sub)
                y = y + (torch.einsum("bhij,bihd->bjhd", dA[..., si, sj],
                                      a[:, si])
                         * f["gam"][I][J][:, None])
            dkA[:, sj] = y * f["ek"][:, sj] + torch.einsum(
                "bhij,bihd,bijhd->bjhd", dA[..., sj, sj], rc[:, sj],
                f["Ex"][:, J])
        dkS = (torch.einsum("bjhe,bhde->bjhd", vc, G) * f["ek"]
               * f["delta"].repeat_interleave(sub, 1))
        sigma = f["eLtot"] * (G * S0).sum(-1)                   # (B, H, D)
        db = dbeta.transpose(1, 2)[..., None]                    # (B, c, H, 1)
        drs.append(drA + uf * kc * db)
        dks.append(dkA + dkS + uf * rc * db)
        du = du + (db * rc * kc).sum((0, 1))
        p = rc * drA - kc * dkA
        q = kc * dkS
        suffix = torch.flip(torch.cumsum(torch.flip(p, (1,)), 1), (1,)) - p
        da = suffix - kc * dkA + torch.cumsum(q, 1) - q + sigma[:, None]
        dws.append(torch.where(wc > 1e-30, da / wc, torch.zeros_like(da)))
        reB = a * f["eB"].repeat_interleave(sub, 1)
        G = (f["eLtot"][..., None] * G
             + torch.einsum("bihd,bihe->bhde", reB, dyc))
    cat = lambda vs: torch.cat(vs[::-1], 1)[:, :t]
    return cat(drs), cat(dks), cat(dvs), cat(dws), du, G
