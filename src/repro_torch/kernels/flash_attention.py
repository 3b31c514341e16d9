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
cores (``wgmma`` fed by TMA, the (qk, v) head-dim pairs
:data:`BF16_PAIRS`), float32 in exact f32 on the CUDA cores.  As in the
TPU kernel, V may be narrower or wider than Q and K: ``v (B, Tk, Hkv,
Dv)`` gives an output ``(B, Tq, Hq, Dv)``, natively in every kernel.
Both routes take the reference model's prefix-LM mask (``prefix_len``:
with ``causal``, the first ``prefix_len`` keys are visible to every
row), which the reference's Pallas dispatch drops.

Both routes take every head width up to 256: a width that is not a
multiple of 8 (TMA wants 16-byte rows) is zero-padded to the next one by
the wrapper on both routes (:func:`padded_dims`) and the result sliced
back; the bfloat16 route runs a pair it has no instantiation for at the
smallest one that holds it (``with_head_dims`` in the CUDA source picks
it; :func:`bf16_kernel_dims` asks), its tensor maps at the true widths
(the boxes read the columns past them as zeros) and its stores stopping
at them.
Zero columns change neither Q K^T nor the kept columns of P V, and the
softmax scale stays the true width's.  Above 256 is refused: Q K^T
contracts over D, and no configuration reaches it.

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
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the bfloat16 (tensor-core) route's instantiations: square head dims (256:
# PaliGemma's), and the (D, Dv) pairs with a V of its own width (MiniCPM3's
# MLA heads); float32 takes any D and Dv that are multiples of 8 up to 256
BF16_HEAD_DIMS = (64, 80, 96, 128, 256)
BF16_PAIRS = tuple((d, d) for d in BF16_HEAD_DIMS) + ((96, 64),)
MAX_HEAD_DIM = 256

__all__ = ["bf16_kernel_dims", "flash_attention", "flash_attention_fwd",
           "flash_attention_bwd", "padded_dims"]


def padded_dims(d: int, dv: int) -> Tuple[int, int]:
    """The head dims (D, Dv) the wrappers hand the kernels for a (d, dv)
    call: each rounded up to a multiple of 8 (the float32 route runs at
    these)."""
    return -(-d // 8) * 8, -(-dv // 8) * 8


def bf16_kernel_dims(d: int, dv: int) -> Tuple[int, int]:
    """The instantiation (D, Dv) the bfloat16 route runs a (d, dv) call
    at, as the CUDA source picks it (the smallest pair of
    :data:`BF16_PAIRS` that holds both, by D + Dv, then D).  Loads the
    built library, so it runs where the kernels do."""
    dims = _build.library("flash_attention").repro_flash_bf16_dims(
        *padded_dims(d, dv))
    if dims < 0:
        raise ValueError(f"the bfloat16 route takes no ({d}, {dv}) call")
    return dims // 65536, dims % 65536


def _pad(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with its last axis zero-padded to ``width`` (as it is when
    it already has that width): a width that is not a multiple of 8 goes
    to the next one."""
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))


def _unpad(t: torch.Tensor, width: int) -> torch.Tensor:
    return t if t.shape[-1] == width else t[..., :width].contiguous()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, prefix_len: int = 0, **outputs: torch.Tensor) -> None:
    """Raise on anything the kernels do not take: dtypes and shapes first
    (so a CPU tensor shows them too), then the device and the layout.
    ``outputs`` (the backward's ``out`` and ``dout``) must be (B, Tq, Hq,
    Dv) in q's dtype."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"want q (B, Tq, Hq, D), k (B, Tk, Hkv, D) and v (B, "
                         f"Tk, Hkv, Dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, tq, hq, d = q.shape
    _, tk, hkv, dk = k.shape
    dv = v.shape[3]
    if k.shape[0] != b or dk != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    for name, width in (("head dim", d), ("v head dim", dv)):
        if width < 1 or width > MAX_HEAD_DIM:
            raise ValueError(
                f"{name} {width} must be in [1, {MAX_HEAD_DIM}]: the kernels "
                f"contract Q K^T over at most {MAX_HEAD_DIM} columns, and no "
                "configuration needs more")
    if tq < 1 or tk < 1:
        raise ValueError(f"Tq={tq} and Tk={tk} must be >= 1")
    if causal and tq > tk:
        raise ValueError(f"Tq={tq} > Tk={tk}: the kernel's causal offset "
                         "Tk - Tq must be >= 0 (so is the reference's)")
    if prefix_len < 0:
        raise ValueError(f"prefix_len={prefix_len} must be >= 0")
    for name, t in outputs.items():
        if tuple(t.shape) != (b, tq, hq, dv) or t.dtype != q.dtype:
            raise ValueError(f"{name} must be a {q.dtype} tensor of shape "
                             f"{(b, tq, hq, dv)}")
    for t in (q, k, v, *outputs.values()):
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


def _prefix(k: torch.Tensor, prefix_len: int) -> int:
    """The prefix as the kernels' C int takes it: clipped to Tk (a prefix
    past the last key leaves every key visible, as Tk does)."""
    return min(int(prefix_len), k.shape[1])


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        prefix_len: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward launch: ``(out (B, Tq, Hq, Dv) in q's dtype, lse (B,
    Hq, Tq) f32)``."""
    _check(q, k, v, causal, prefix_len)
    b, tq, hq, d = q.shape
    tk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    kd, kdv = padded_dims(d, dv)
    q, k, v = _pad(q, kd), _pad(k, kd), _pad(v, kdv)
    out = torch.empty((b, tq, hq, kdv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention")
    err = lib.repro_flash_fwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, tq, tk, hq, hkv, kd, kdv,
        _scale(d, scale), int(causal), _prefix(k, prefix_len),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return _unpad(out, dv), lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True,
                        scale: Optional[float] = None, prefix_len: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One backward pass (three kernel launches: delta = dO . O, dQ, and
    dK/dV): ``(dq, dk, dv)`` in the inputs' dtype, dv of V's width."""
    _check(q, k, v, causal, prefix_len, out=out, dout=dout)
    b, tq, hq, d = q.shape
    tk, hkv, dv_ = k.shape[1], k.shape[2], v.shape[3]
    if lse.shape != (b, hq, tq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(b, hq, tq)}")
    kd, kdv = padded_dims(d, dv_)
    q, k, v = _pad(q, kd), _pad(k, kd), _pad(v, kdv)
    out, dout = _pad(out, kdv), _pad(dout, kdv)
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.library("flash_attention")
    err = lib.repro_flash_bwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, tq, tk, hq, hkv, kd,
        kdv, _scale(d, scale), int(causal), _prefix(k, prefix_len),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 3     # delta, dQ and dK/dV
    return _unpad(dq, d), _unpad(dk, d), _unpad(dv, dv_)


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward kernel in ``forward``, backward kernel in ``backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, prefix_len):
        out, lse = flash_attention_fwd(q, k, v, causal, scale, prefix_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.prefix_len = causal, scale, prefix_len
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         ctx.causal, ctx.scale, ctx.prefix_len)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """Differentiable flash attention through the CUDA kernels."""
    return _FlashAttention.apply(q, k, v, causal, scale, prefix_len)
