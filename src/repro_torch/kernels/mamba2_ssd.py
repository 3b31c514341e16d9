"""The Mamba2 SSD scan on Hopper: the CUDA kernels' wrappers and their
autograd function.

Counterpart of ``repro/kernels/mamba2_ssd.py``.  The Pallas kernel
``mamba2_pallas`` becomes the hand-written CUDA source
``csrc/mamba2_ssd.cu``, built at first use
(:mod:`repro_torch.kernels._build`).  Both kernels run the TPU kernel's
chunked matmul form (chunks of 64 tokens) on tensor cores for bf16
inputs (``mma.sync``, f32 operands as hi + lo bf16 pairs) and on the CUDA
cores in f32 for f32 inputs; one block per (batch row, head) walks the
chunks with the state in registers.  The forward takes an initial state
(the Pallas kernel asserts a zero one) and, for the backward, saves the
state at every chunk start.  The backward (the reference needs none:
JAX differentiates its chunked jnp version) walks the chunks in reverse
from those states, deterministically (no atomics): its dB and dC are
summed over a cluster of :func:`head_group` heads in the kernel, and a
second small launch sums the head groups and dA's batch rows in a fixed
order.  ``kernels.ref.mamba2_ssd_chunked`` and
``kernels.ref.mamba2_ssd_chunked_grads`` write the same arithmetic
plainly.

The kernels hold P and N up to :data:`MAX_DIM`.  A wider head runs as
tiles of at most that many (:func:`tile_plan`): state entry (p, n) evolves
alone under the head's scalar decay, and y sums over n, so each (P tile, N
tile) pair is one launch of the same kernels on its slices.  The tiles
run on the float32 route (bfloat16 inputs are widened as they are
sliced), so every partial is float32: y and dx sum their partials over
the N tiles; dB, dC, ddt and dA over the P tiles (ddt and dA over every
launch), in the plan's order (no atomics), and are cast once; the states
are assembled from the tiles' blocks.

:func:`mamba2_ssd` is the differentiable entry point
(``torch.autograd.Function``); :func:`ssd_fwd` and :func:`ssd_bwd` launch
the kernels and count their wrapper calls in ``.launches`` (CUDA launches
per call: :data:`CUDA_LAUNCHES`).  They take CUDA tensors only; the plain
version is :func:`repro_torch.kernels.ops.mamba2_chunked`, and
:mod:`repro_torch.kernels.ops` picks between the two by device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tiles import block, check_ckpts, cols, fsum, put_block

CHUNK = 64          # tokens per chunk; the state-save interval (kChunk)
MAX_DIM = 64        # the kernels' P and N (kDim); wider heads run in tiles
MAX_GROUP = 8       # heads per cluster in the backward (portable cluster size)
CUDA_LAUNCHES = {"fwd": 1, "bwd": 2}   # per wrapper call
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["CHUNK", "CUDA_LAUNCHES", "bwd_plan", "head_group", "mamba2_ssd",
           "ssd_fwd", "ssd_bwd", "tile_plan"]


def head_group(heads: int) -> int:
    """Heads per cluster in the backward: the largest power of two up to
    :data:`MAX_GROUP` that divides ``heads``."""
    g = MAX_GROUP
    while heads % g:
        g //= 2
    return g


def bwd_plan(b: int, t: int, h: int, p: int, n: int) -> dict:
    """What one backward call launches: its cluster size, the shape of the
    per-head-group dB / dC partials, and the CUDA launches."""
    g = head_group(h)
    return {"group": g, "partial_shape": (b, t, h // g, n),
            "chunks": -(-t // CHUNK), "launches": CUDA_LAUNCHES["bwd"]}


def _cut(width: int) -> List[Tuple[int, int]]:
    return [(s, min(MAX_DIM, width - s)) for s in range(0, width, MAX_DIM)]


def tile_plan(p: int, n: int) -> dict:
    """How a head of P x N state runs: its ``p_tiles`` and ``n_tiles``
    ((start, width) of at most :data:`MAX_DIM`), and the kernel ``launches``
    as (P tile, N tile) pairs in the order they run, P tile outermost.
    Each partial sum adds its parts in that order: y's and dx's over the N
    tiles, dB's and dC's over the P tiles, ddt's and dA's over every
    launch."""
    pt, nt = _cut(p), _cut(n)
    return {"p_tiles": pt, "n_tiles": nt,
            "launches": [(i, j) for i in range(len(pt)) for j in range(len(nt))]}


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check(x, dt, A, Bm, Cm, state) -> None:
    """Raise on anything the kernels do not take."""
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"the SSD kernel takes CUDA tensors on one device; "
                             f"{name} is on {t.device} (ops.mamba2_chunked is "
                             "the plain version)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPE_CODE or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm, Cm must share float32 or bfloat16, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    if x.dim() != 4:
        raise ValueError(f"want x (B, T, H, P), got {tuple(x.shape)}")
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    if (tuple(dt.shape) != (b, t, h) or tuple(A.shape) != (h,)
            or tuple(Bm.shape) != (b, t, n) or Cm.shape != Bm.shape):
        raise ValueError(f"want dt {(b, t, h)}, A {(h,)}, Bm and Cm (B, T, N); "
                         f"got {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if t < 1 or p < 1 or n < 1:
        raise ValueError(f"T={t}, P={p} and N={n} must be >= 1")
    if state is not None and (tuple(state.shape) != (b, h, p, n)
                              or state.dtype != torch.float32
                              or not state.is_contiguous()
                              or state.device != x.device):
        raise ValueError(f"state must be a contiguous float32 {(b, h, p, n)} "
                         f"tensor on {x.device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def ssd_fwd(x, dt, A, Bm, Cm, state: Optional[torch.Tensor] = None,
            save: bool = False):
    """The forward: ``(y (B, T, H, P) in x's dtype, final state (B, H, P,
    N) f32, chunk-start states or None)``; the chunk-start states are
    written only with ``save``: a tuple of one (B, H, ceil(T/64), P', N')
    f32 tensor per launch of :func:`tile_plan` (P', N' its tiles' widths;
    one launch for P and N of at most :data:`MAX_DIM`).  No ``state`` is a
    zero one."""
    _check(x, dt, A, Bm, Cm, state)
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    if p <= MAX_DIM and n <= MAX_DIM:
        y, s_out, ckpt = _fwd1(x, dt, A, Bm, Cm, state, save)
        return y, s_out, (ckpt,) if save else None
    tp = tile_plan(p, n)
    pt, nt = tp["p_tiles"], tp["n_tiles"]
    y = torch.empty_like(x)
    s_out = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    y_parts: List[List[torch.Tensor]] = [[] for _ in pt]
    ckpts = []
    for i, j in tp["launches"]:
        ti, tj = pt[i], nt[j]
        yp, sp, cp = _fwd1(cols(x, ti), dt, A, cols(Bm, tj), cols(Cm, tj),
                           block(state, ti, tj), save)
        y_parts[i].append(yp)
        put_block(s_out, ti, tj, sp)
        ckpts.append(cp)
    for (start, width), parts in zip(pt, y_parts):
        y[..., start:start + width] = fsum(parts, x.dtype)
    return y, s_out, tuple(ckpts) if save else None


def _fwd1(x, dt, A, Bm, Cm, state, save):
    """One forward launch on P and N of at most :data:`MAX_DIM`."""
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    y = torch.empty_like(x)
    s_out = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    ckpt = (torch.empty((b, h, -(-t // CHUNK), p, n), dtype=torch.float32,
                        device=x.device) if save else None)
    lib = _build.library("mamba2_ssd")
    err = lib.repro_ssd_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), 0 if state is None else state.data_ptr(),
        y.data_ptr(), s_out.data_ptr(), 0 if ckpt is None else ckpt.data_ptr(),
        b, t, h, p, n, _stream(x))
    _raise_on(err, "ssd_fwd")
    ssd_fwd.launches += 1
    return y, s_out, ckpt


ssd_fwd.launches = 0


def ssd_bwd(x, dt, A, Bm, Cm, ckpt, dy, dstate: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, ...]:
    """The backward (:data:`CUDA_LAUNCHES` ``["bwd"]`` kernels for each
    launch of :func:`tile_plan`) from the forward's chunk-start states
    (its tuple ``ckpt``):
    ``(dx in x's dtype, ddt f32, dA (H,) f32, dB, dC in Bm's dtype, dstate0
    (B, H, P, N) f32)``; dA is summed over the batch, dB and dC over the
    heads, each in a fixed order.  ``dstate`` is the gradient on the final
    state (B, H, P, N) f32; None is a zero one."""
    _check(x, dt, A, Bm, Cm, None)
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous {x.dtype} tensor of x's shape")
    if dstate is not None and (tuple(dstate.shape) != (b, h, p, n)
                               or dstate.dtype != torch.float32
                               or not dstate.is_contiguous()
                               or dstate.device != x.device):
        raise ValueError(f"dstate must be a contiguous float32 {(b, h, p, n)} "
                         f"tensor on {x.device}")
    tp = tile_plan(p, n)
    pt, nt = tp["p_tiles"], tp["n_tiles"]
    check_ckpts(ckpt, [(b, h, -(-t // CHUNK), pt[i][1], nt[j][1])
                       for i, j in tp["launches"]], f"(P, N) = {(p, n)}")
    if p <= MAX_DIM and n <= MAX_DIM:
        return _bwd1(x, dt, A, Bm, Cm, ckpt[0], dy, dstate)
    dx_parts: List[List[torch.Tensor]] = [[] for _ in pt]
    db_parts: List[List[torch.Tensor]] = [[] for _ in nt]
    dc_parts: List[List[torch.Tensor]] = [[] for _ in nt]
    ddt_parts, da_parts = [], []
    ds0 = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    for (i, j), ck in zip(tp["launches"], ckpt):
        ti, tj = pt[i], nt[j]
        dx_, ddt_, dA_, dB_, dC_, ds_ = _bwd1(
            cols(x, ti), dt, A, cols(Bm, tj), cols(Cm, tj), ck, cols(dy, ti),
            block(dstate, ti, tj))
        dx_parts[i].append(dx_)
        db_parts[j].append(dB_)
        dc_parts[j].append(dC_)
        ddt_parts.append(ddt_)
        da_parts.append(dA_)
        put_block(ds0, ti, tj, ds_)
    dx, dB, dC = torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm)
    for (start, width), parts in zip(pt, dx_parts):
        dx[..., start:start + width] = fsum(parts, x.dtype)
    for (start, width), pb, pc in zip(nt, db_parts, dc_parts):
        dB[..., start:start + width] = fsum(pb, Bm.dtype)
        dC[..., start:start + width] = fsum(pc, Cm.dtype)
    return (dx, fsum(ddt_parts, torch.float32), fsum(da_parts, torch.float32),
            dB, dC, ds0)


def _bwd1(x, dt, A, Bm, Cm, ckpt, dy, dstate):
    """One backward call on P and N of at most :data:`MAX_DIM`."""
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    plan = bwd_plan(b, t, h, p, n)
    f32, dev = torch.float32, x.device
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA_part = torch.empty((b, h), dtype=torch.float64, device=dev)
    dB_part = torch.empty(plan["partial_shape"], dtype=f32, device=dev)
    dC_part = torch.empty(plan["partial_shape"], dtype=f32, device=dev)
    ds0 = torch.empty((b, h, p, n), dtype=f32, device=dev)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.empty((h,), dtype=f32, device=dev)
    lib = _build.library("mamba2_ssd")
    err = lib.repro_ssd_bwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), ckpt.data_ptr(), dy.data_ptr(),
        0 if dstate is None else dstate.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dA_part.data_ptr(), dB_part.data_ptr(),
        dC_part.data_ptr(), ds0.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dA.data_ptr(), b, t, h, p, n, plan["group"], _stream(x))
    _raise_on(err, "ssd_bwd")
    ssd_bwd.launches += 1
    return dx, ddt, dA, dB, dC, ds0


ssd_bwd.launches = 0


class _SSD(torch.autograd.Function):
    """Forward kernel in ``forward``, backward kernel in ``backward``."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, state):
        y, s_out, ckpt = ssd_fwd(x, dt, A, Bm, Cm, state, save=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, *ckpt)
        ctx.set_materialize_grads(False)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm, *ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC, ds0 = ssd_bwd(
            x, dt, A, Bm, Cm, tuple(ckpt), dy.contiguous(), None if dstate is None else dstate.contiguous())
        return dx, ddt, dA, dB, dC, ds0 if ctx.needs_input_grad[5] else None


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan through the CUDA kernels: ``(y, final state)``,
    differentiable in x, dt, A, Bm, Cm and the initial state, through y and
    the final state.  Without a gradient to track, the forward alone,
    saving nothing."""
    ins = (x, dt, A, Bm, Cm) + (() if state is None else (state,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        if state is None:
            b, _, h, p = x.shape
            state = torch.zeros((b, h, p, Bm.shape[-1]), dtype=torch.float32,
                                device=x.device)
        return _SSD.apply(x, dt, A, Bm, Cm, state)
    y, s_out, _ = ssd_fwd(x, dt, A, Bm, Cm, state)
    return y, s_out
