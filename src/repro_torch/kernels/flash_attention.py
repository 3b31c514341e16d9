"""Flash attention on Hopper: the CUDA kernels' wrappers and their
autograd function.

Counterpart of ``repro/kernels/flash_attention.py``.  The Pallas kernel
``flash_attention_pallas`` becomes the hand-written CUDA source
``csrc/flash_attention.cu``, built at first use
(:mod:`repro_torch.kernels._build`), with a forward that also writes the
per-row log-sum-exp and a deterministic backward (no atomics) recomputed
from q, k, v, o, dO and that log-sum-exp.  The reference needs no
backward kernel because JAX differentiates its jnp version; the port's
training loss runs through the forward kernel, so it has one.  The
source has two routes, chosen by dtype: bfloat16 runs on the tensor
cores (``wgmma`` fed by TMA, head dims :data:`BF16_HEAD_DIMS`), float32
in exact f32 on the CUDA cores.

:func:`flash_attention` is the differentiable entry point
(``torch.autograd.Function``); :func:`flash_attention_fwd` and
:func:`flash_attention_bwd` launch the kernels and count their launches
in ``.launches``.  They take CUDA tensors only; the plain version lives
in :mod:`repro_torch.kernels.ref` and :mod:`repro_torch.kernels.ops`
picks between the two by device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# one instantiation each of the bfloat16 (tensor-core) route; float32 takes
# any multiple of 8 up to 256
BF16_HEAD_DIMS = (64, 80, 96, 128)

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd"]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    """Raise on anything the kernels do not take: dtypes and shapes first
    (so a CPU tensor shows them too), then the device and the layout."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, Tq, Hq, D) and k, v (B, Tk, Hkv, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, tq, hq, d = q.shape
    _, tk, hkv, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    if d % 8 or d > 256:
        raise ValueError(f"head dim {d} must be a multiple of 8 and <= 256")
    if q.dtype == torch.bfloat16 and d not in BF16_HEAD_DIMS:
        raise ValueError(f"head dim {d}: the bfloat16 kernels take head dims "
                         f"{BF16_HEAD_DIMS}")
    if tq < 1 or tk < 1:
        raise ValueError(f"Tq={tq} and Tk={tk} must be >= 1")
    if causal and tq > tk:
        raise ValueError(f"Tq={tq} > Tk={tk}: the kernel's causal offset "
                         "Tk - Tq must be >= 0 (so is the reference's)")
    for t in (q, k, v):
        if t.device.type != "cuda":
            raise ValueError("the flash-attention kernel takes CUDA tensors; "
                             "kernels.ref holds the plain version")
        if t.device != q.device:
            raise ValueError(f"all tensors must be on {q.device}, got {t.device}")
        _check_layout(t)


def _check_layout(t: torch.Tensor) -> None:
    if not t.is_contiguous():
        raise ValueError("the kernel takes contiguous (B, T, H, D) tensors")
    # the bfloat16 kernels read through TMA, which wants 16-byte alignment
    if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
        raise ValueError("the bfloat16 kernel takes 16-byte-aligned tensors")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def _scale(d: int, scale: Optional[float]) -> float:
    return float(d ** -0.5) if scale is None else float(scale)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward launch: ``(out (B, Tq, Hq, D) in q's dtype, lse (B, Hq,
    Tq) f32)``."""
    _check(q, k, v, causal)
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention")
    err = lib.repro_flash_fwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, tq, tk, hq, hkv, d, _scale(d, scale),
        int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One backward pass (three kernel launches: delta = dO . O, dQ, and
    dK/dV): ``(dq, dk, dv)`` in the inputs' dtype."""
    _check(q, k, v, causal)
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be a {q.dtype} tensor of q's shape "
                             f"{tuple(q.shape)} on {q.device}")
        _check_layout(t)
    if lse.shape != (b, hq, tq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(b, hq, tq)}")
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.library("flash_attention")
    err = lib.repro_flash_bwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, tq, tk, hq, hkv, d,
        _scale(d, scale), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 3     # delta, dQ and dK/dV
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward kernel in ``forward``, backward kernel in ``backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Differentiable flash attention through the CUDA kernels."""
    return _FlashAttention.apply(q, k, v, causal, scale)
