"""The Mamba2 SSD scan on Hopper: the CUDA kernels' wrappers and their
autograd function.

Counterpart of ``repro/kernels/mamba2_ssd.py``.  The Pallas kernel
``mamba2_pallas`` becomes the hand-written CUDA source
``csrc/mamba2_ssd.cu``, built at first use
(:mod:`repro_torch.kernels._build`): a forward that takes an initial state
(the Pallas kernel asserts a zero one) and saves the state at every
32-token chunk start, and a deterministic backward (no atomics)
recomputed from those states.  The reference needs no backward kernel
because JAX differentiates its chunked jnp version; the port's training
loss runs through the forward kernel, so it has one.

:func:`mamba2_ssd` is the differentiable entry point
(``torch.autograd.Function``); :func:`ssd_fwd` and :func:`ssd_bwd` launch
the kernels and count their launches in ``.launches``.  They take CUDA
tensors only; the plain version is
:func:`repro_torch.kernels.ops.mamba2_chunked`, and
:mod:`repro_torch.kernels.ops` picks between the two by device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

CHUNK = 32          # the kernels' state-save interval (kChunk in mamba2_ssd.cu)
MAX_DIM = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["CHUNK", "mamba2_ssd", "ssd_fwd", "ssd_bwd"]


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
    if t < 1 or p > MAX_DIM or n > MAX_DIM:
        raise ValueError(f"T={t} must be >= 1, P={p} and N={n} <= {MAX_DIM}")
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
            save: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One forward launch: ``(y (B, T, H, P) in x's dtype, final state
    (B, H, P, N) f32, chunk-start states (B, H, ceil(T/32), P, N) f32 or
    None)``; the chunk-start states are written only with ``save``."""
    _check(x, dt, A, Bm, Cm, state)
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    if state is None:
        state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    s_out = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    ckpt = (torch.empty((b, h, -(-t // CHUNK), p, n), dtype=torch.float32,
                        device=x.device) if save else None)
    lib = _build.library("mamba2_ssd")
    err = lib.repro_ssd_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), state.data_ptr(), y.data_ptr(),
        s_out.data_ptr(), 0 if ckpt is None else ckpt.data_ptr(), b, t, h, p, n,
        _stream(x))
    _raise_on(err, "ssd_fwd")
    ssd_fwd.launches += 1
    return y, s_out, ckpt


ssd_fwd.launches = 0


def ssd_bwd(x, dt, A, Bm, Cm, ckpt, dy) -> Tuple[torch.Tensor, ...]:
    """One backward launch from the forward's chunk-start states:
    ``(dx in x's dtype, ddt f32, dA (H,) f32, dB, dC in Bm's dtype,
    dstate (B, H, P, N) f32)``; dA is summed over the batch, dB and dC over
    the heads, each in a fixed order."""
    _check(x, dt, A, Bm, Cm, None)
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    if (tuple(ckpt.shape) != (b, h, -(-t // CHUNK), p, n)
            or ckpt.dtype != torch.float32 or not ckpt.is_contiguous()):
        raise ValueError("ckpt must be the forward's chunk-start states")
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous {x.dtype} tensor of x's shape")
    f32 = torch.float32
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA_part = torch.empty((b, h), dtype=f32, device=x.device)
    dB_head = torch.empty((b, t, h, n), dtype=f32, device=x.device)
    dC_head = torch.empty((b, t, h, n), dtype=f32, device=x.device)
    ds0 = torch.empty((b, h, p, n), dtype=f32, device=x.device)
    lib = _build.library("mamba2_ssd")
    err = lib.repro_ssd_bwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), ckpt.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dA_part.data_ptr(), dB_head.data_ptr(),
        dC_head.data_ptr(), ds0.data_ptr(), b, t, h, p, n, _stream(x))
    _raise_on(err, "ssd_bwd")
    ssd_bwd.launches += 1
    return (dx, ddt, dA_part.sum(dim=0), dB_head.sum(dim=2).to(Bm.dtype),
            dC_head.sum(dim=2).to(Cm.dtype), ds0)


ssd_bwd.launches = 0


class _SSD(torch.autograd.Function):
    """Forward kernel in ``forward``, backward kernel in ``backward``."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, state):
        y, s_out, ckpt = ssd_fwd(x, dt, A, Bm, Cm, state, save=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, ckpt)
        ctx.set_materialize_grads(False)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, dstate):
        if dstate is not None:
            raise NotImplementedError(
                "the SSD backward kernel takes no gradient on the final state "
                "(the training loss never uses it)")
        x, dt, A, Bm, Cm, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC, ds0 = ssd_bwd(x, dt, A, Bm, Cm, ckpt,
                                           dy.contiguous())
        return dx, ddt, dA, dB, dC, ds0 if ctx.needs_input_grad[5] else None


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan through the CUDA kernels: ``(y, final state)``,
    differentiable in x, dt, A, Bm, Cm and the initial state (not through
    the final state).  Without a gradient to track, one forward launch
    that saves nothing."""
    ins = (x, dt, A, Bm, Cm) + (() if state is None else (state,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        if state is None:
            b, _, h, p = x.shape
            state = torch.zeros((b, h, p, Bm.shape[-1]), dtype=torch.float32,
                                device=x.device)
        return _SSD.apply(x, dt, A, Bm, Cm, state)
    y, s_out, _ = ssd_fwd(x, dt, A, Bm, Cm, state)
    return y, s_out
