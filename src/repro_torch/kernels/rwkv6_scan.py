"""The WKV6 recurrence on Hopper: the CUDA kernels' wrappers and their
autograd function.

Counterpart of ``repro/kernels/rwkv6_scan.py``.  The Pallas kernel
``wkv6_pallas`` becomes the hand-written CUDA source ``csrc/wkv6.cu``,
built at first use (:mod:`repro_torch.kernels._build`).  The kernels run
the chunked matmul form (chunks of :data:`CHUNK` = 64 tokens cut into
sub-blocks of 16, the pairwise decays re-centred per sub-block) on tensor
cores for bf16 inputs (``mma.sync``, f32 operands as hi + lo bf16 pairs)
and on the CUDA cores in f32 for f32 inputs.  The forward walks the chunks
of each (batch row, head) in one block, with the state in registers; it
takes an initial state (the
Pallas kernel asserts a zero one) and, for the backward, saves the state
at every chunk start.  The backward (the reference needs none: JAX
differentiates its chunked jnp version) runs every chunk at once: one
kernel for each chunk's part of the state gradient, an elementwise chain
of those parts over the chunks in reverse (the state gradient at every
chunk end), then one block per chunk for everything else, from the
chunk's saved state and state gradient.
No atomics: the same inputs give the same bits.
``kernels.ref.wkv6_chunked_form`` and ``kernels.ref.wkv6_chunked_form_grads``
write the same arithmetic plainly.

:func:`wkv6` is the differentiable entry point (``torch.autograd.Function``);
:func:`wkv6_fwd` and :func:`wkv6_bwd` launch the kernels and count their
wrapper calls in ``.launches`` (CUDA launches per call:
:data:`CUDA_LAUNCHES`).  They take CUDA tensors only; the plain version is
:func:`repro_torch.kernels.ops.wkv6_chunked`, and
:mod:`repro_torch.kernels.ops` picks between the two by device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

CHUNK = 64          # tokens per chunk; the state-save interval (kChunk in wkv6.cu)
MAX_HEAD = 64
# per wrapper call: the forward kernel; the backward's per-chunk state
# gradient parts, their chain, the chunk kernel and du's sum over the batch
# rows and chunks (each of the last three launched behind the one before)
CUDA_LAUNCHES = {"fwd": 1, "bwd": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["CHUNK", "CUDA_LAUNCHES", "plan", "wkv6", "wkv6_fwd", "wkv6_bwd"]


def plan(b: int, t: int, h: int, d: int) -> dict:
    """What one call launches: the forward's blocks (one per batch row and
    head, whatever the head size ``d``), the chunks, and the backward's
    chunk-kernel blocks (its dG and chunk kernels run one block per chunk;
    the chain over the chunks one thread per state element); the CUDA
    launches."""
    chunks = -(-t // CHUNK)
    return {"fwd_blocks": b * h, "chunks": chunks, "bwd_blocks": b * h * chunks,
            "launches": CUDA_LAUNCHES}


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check(r, k, v, w, u, state) -> None:
    """Raise on anything the kernels do not take."""
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.device.type != "cuda" or t.device != r.device:
            raise ValueError(f"the WKV6 kernel takes CUDA tensors on one device; "
                             f"{name} is on {t.device} (ops.wkv6_chunked is the "
                             "plain version)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"w and u must be float32, got {w.dtype}, {u.dtype}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"want r, k, v, w of one (B, T, H, D) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    b, t, h, d = r.shape
    if t < 1 or d > MAX_HEAD:
        raise ValueError(f"T={t} must be >= 1 and head size {d} <= {MAX_HEAD}")
    if tuple(u.shape) != (h, d):
        raise ValueError(f"u must be {(h, d)}, got {tuple(u.shape)}")
    if state is not None and (tuple(state.shape) != (b, h, d, d)
                              or state.dtype != torch.float32
                              or not state.is_contiguous()
                              or state.device != r.device):
        raise ValueError(f"state must be a contiguous float32 {(b, h, d, d)} "
                         f"tensor on {r.device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def wkv6_fwd(r, k, v, w, u, state: Optional[torch.Tensor] = None,
             save: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One forward launch: ``(y (B, T, H, D) in r's dtype, final state
    (B, H, D, D) f32, chunk-start states (B, H, ceil(T/64), D, D) f32 or
    None)``; the chunk-start states are written only with ``save``.  No
    ``state`` is a zero one."""
    _check(r, k, v, w, u, state)
    b, t, h, d = r.shape
    y = torch.empty_like(r)
    s_out = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    ckpt = (torch.empty((b, h, -(-t // CHUNK), d, d), dtype=torch.float32,
                        device=r.device) if save else None)
    lib = _build.library("wkv6")
    err = lib.repro_wkv6_fwd(
        _DTYPE_CODE[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), 0 if state is None else state.data_ptr(),
        y.data_ptr(), s_out.data_ptr(), 0 if ckpt is None else ckpt.data_ptr(),
        b, t, h, d, _stream(r))
    _raise_on(err, "wkv6_fwd")
    wkv6_fwd.launches += 1
    return y, s_out, ckpt


wkv6_fwd.launches = 0


def wkv6_bwd(r, k, v, w, u, ckpt, dy
             ) -> Tuple[torch.Tensor, ...]:
    """One backward call (:data:`CUDA_LAUNCHES` ``["bwd"]`` launches) from
    the forward's chunk-start states: ``(dr, dk, dv in r's dtype, dw f32,
    du (H, D) f32, dstate (B, H, D, D) f32)``; du is summed over the batch
    rows and chunks in a fixed order."""
    _check(r, k, v, w, u, None)
    b, t, h, d = r.shape
    if (tuple(ckpt.shape) != (b, h, -(-t // CHUNK), d, d)
            or ckpt.dtype != torch.float32 or not ckpt.is_contiguous()):
        raise ValueError("ckpt must be the forward's chunk-start states")
    if dy.shape != r.shape or dy.dtype != r.dtype or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous {r.dtype} tensor of r's shape")
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw = torch.empty_like(w)
    du_part = torch.empty((b, h, -(-t // CHUNK), d), dtype=torch.float32,
                          device=r.device)
    du = torch.empty((h, d), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    gsave = torch.empty_like(ckpt)   # the state gradient at every chunk's end
    eltot = torch.empty((b, h, -(-t // CHUNK), d), dtype=torch.float32,
                        device=r.device)
    lib = _build.library("wkv6")
    err = lib.repro_wkv6_bwd(
        _DTYPE_CODE[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), ckpt.data_ptr(), dy.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
        du_part.data_ptr(), du.data_ptr(), ds0.data_ptr(), gsave.data_ptr(),
        eltot.data_ptr(), b, t, h, d, _stream(r))
    _raise_on(err, "wkv6_bwd")
    wkv6_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


wkv6_bwd.launches = 0


class _WKV6(torch.autograd.Function):
    """Forward kernel in ``forward``, backward kernel in ``backward``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        y, s_out, ckpt = wkv6_fwd(r, k, v, w, u, state, save=True)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.set_materialize_grads(False)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, dstate):
        if dstate is not None:
            raise NotImplementedError(
                "the WKV6 backward kernel takes no gradient on the final "
                "state (the training loss never uses it)")
        r, k, v, w, u, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        dr, dk, dv, dw, du, ds0 = wkv6_bwd(r, k, v, w, u, ckpt, dy.contiguous())
        return dr, dk, dv, dw, du, ds0 if ctx.needs_input_grad[5] else None


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 through the CUDA kernels: ``(y, final state)``, differentiable
    in r, k, v, w, u and the initial state (not through the final state).
    Without a gradient to track, one forward launch that saves nothing."""
    ins = (r, k, v, w, u) + (() if state is None else (state,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        if state is None:
            b, _, h, d = r.shape
            state = torch.zeros((b, h, d, d), dtype=torch.float32,
                                device=r.device)
        return _WKV6.apply(r, k, v, w, u, state)
    y, s_out, _ = wkv6_fwd(r, k, v, w, u, state)
    return y, s_out
