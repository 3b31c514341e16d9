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

Both routes take every head width: a width that is not a multiple of 8
(TMA wants 16-byte rows) is zero-padded to the next one by the wrapper
on both routes (:func:`padded_dims`) and the result sliced back; the
bfloat16 route runs a pair it has no instantiation for at the smallest
one that holds it (``with_head_dims`` in the CUDA source picks it;
:func:`bf16_kernel_dims` asks), its tensor maps at the true widths (the
boxes read the columns past them as zeros) and its stores stopping at
them.  Zero columns change neither Q K^T nor the kept columns of P V,
and the softmax scale stays the true width's.  Past :data:`WIDE_ABOVE`
columns (D or Dv; absorbed MLA attends at (576, 512)) each dtype runs
the source's wide kernels, a static rule by dtype and width
(:func:`route`, which the CUDA launchers follow): bfloat16 on the tensor
cores (``wide_fwd_kernel``, ``wide_dq_kernel``, ``wide_dkdv_kernel``:
every contraction streamed through shared memory in 64-column boxes fed
by TMA, the box count taken at run time, so every width runs), float32
exact on the CUDA cores (``flash_wide_*``: the same boxes staged as f32
tiles).  Both split the output columns over blocks of 256, each block
recomputing the same scores, so no sum crosses blocks and the bits stay
fixed.

:func:`flash_attention` is the differentiable entry point
(``torch.autograd.Function``); :func:`flash_attention_fwd` and
:func:`flash_attention_bwd` launch the kernels and count their launches
in ``.launches``, and by :func:`route` in ``.by_route``.  They take CUDA
tensors, or meta tensors for the kernels' shape rule (the same checks and
allocations, the backward's workspace from :func:`bwd_workspace_bytes`;
no launch and no count); the plain version lives in
:mod:`repro_torch.kernels.ref` and :mod:`repro_torch.kernels.ops` picks
between the two by device.  Each forward and backward of the autograd
function reports its work (:mod:`repro_torch.kernels.work`) to an active
dry-run counter.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, work

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the bfloat16 (tensor-core) route's instantiations: square head dims (256:
# PaliGemma's), and the (D, Dv) pairs with a V of its own width (MiniCPM3's
# MLA heads); float32 takes any D and Dv that are multiples of 8 up to 256
BF16_HEAD_DIMS = (64, 80, 96, 128, 256)
BF16_PAIRS = tuple((d, d) for d in BF16_HEAD_DIMS) + ((96, 64),)
# past this many columns (D or Dv) both dtypes run their wide kernels
WIDE_ABOVE = 256
# the CUDA source's kernels (forward, dQ, dK/dV) of each route; every
# backward pass also launches a delta kernel first
ROUTE_KERNELS = {
    "bf16": ("fwd_kernel", "dq_kernel", "dkdv_kernel"),
    "bf16_wide": ("wide_fwd_kernel", "wide_dq_kernel", "wide_dkdv_kernel"),
    "f32": ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel"),
    "f32_wide": ("flash_wide_fwd_kernel", "flash_wide_dq_kernel",
                 "flash_wide_dkdv_kernel"),
}
# the source's route codes (repro_flash_route)
ROUTE_CODES = {"f32": 0, "bf16": 1, "f32_wide": 2, "bf16_wide": 3}
# the CUDA source's constants that size the bf16 wide backward's split
# (bwd_workspace_bytes): the H100's SMs, hopper::kTile, kSliceW
_SM_COUNT, _KEY_TILE, _SLICE_W = 132, 64, 256

__all__ = ["bf16_kernel_dims", "bwd_workspace_bytes", "flash_attention",
           "flash_attention_fwd", "flash_attention_bwd", "is_wide",
           "padded_dims", "route"]


def padded_dims(d: int, dv: int) -> Tuple[int, int]:
    """The head dims (D, Dv) the wrappers hand the kernels for a (d, dv)
    call: each rounded up to a multiple of 8 (the float32 route runs at
    these)."""
    return -(-d // 8) * 8, -(-dv // 8) * 8


def is_wide(d: int, dv: int) -> bool:
    """Whether a (d, dv) call runs the wide kernels (either width past
    :data:`WIDE_ABOVE`)."""
    return max(padded_dims(d, dv)) > WIDE_ABOVE


def route(dtype: torch.dtype, d: int, dv: int) -> str:
    """The kernels a (d, dv) call in ``dtype`` launches on the card, a
    static rule by dtype and padded width (the CUDA source's ``route_of``
    applies the same; :data:`ROUTE_KERNELS` names each route's kernels):
    ``"bf16"`` the tensor-core kernels at :func:`bf16_kernel_dims`,
    ``"bf16_wide"`` the wide tensor-core kernels past :data:`WIDE_ABOVE`
    (either width), ``"f32"`` and ``"f32_wide"`` the CUDA-core kernels
    (exact float32: tensor cores would round to TF32)."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {dtype}")
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    return name + "_wide" if is_wide(d, dv) else name


def bf16_kernel_dims(d: int, dv: int) -> Tuple[int, int]:
    """The widths (D, Dv) the bfloat16 route runs a (d, dv) call at: the
    tensor cores' instantiation as the CUDA source picks it (the smallest
    pair of :data:`BF16_PAIRS` that holds both, by D + Dv, then D), or
    :func:`padded_dims` for a wide call (:func:`is_wide`: the wide kernels
    take their box counts at run time).  Loads the built library for the
    former, so it runs where the kernels do."""
    if is_wide(d, dv):
        return padded_dims(d, dv)
    dims = _build.library("flash_attention").repro_flash_bf16_dims(
        *padded_dims(d, dv))
    if dims < 0:
        raise ValueError(f"the bfloat16 route takes no ({d}, {dv}) call")
    return dims // 65536, dims % 65536


def bwd_workspace_bytes(dtype: torch.dtype, b: int, tk: int, hq: int,
                        hkv: int, d: int, dv: int) -> int:
    """The f32 workspace the backward takes at padded widths (d, dv), as
    the CUDA source's ``bwd_workspace_bytes`` sizes it (its
    ``repro_flash_bwd_workspace``, which the card's calls ask): on the
    bf16 wide route only, the split's partial sums (groups, B, Tk, Hkv,
    d + dv) where ``kv_groups`` splits each kv head's query heads, the
    smallest divisor of the group that brings the dK/dV grid to four
    waves of the SMs; 0 elsewhere.  The meta device's shape rule uses
    it."""
    if route(dtype, d, dv) != "bf16_wide":
        return 0
    g = hq // hkv
    blocks = b * hkv * -(-tk // _KEY_TILE) * (-(-d // _SLICE_W)
                                              + -(-dv // _SLICE_W))
    groups = next((n for n in range(1, g) if g % n == 0
                   and blocks * n >= 4 * _SM_COUNT), g)
    return 0 if groups == 1 else 4 * groups * b * tk * hkv * (d + dv)


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
        if width < 1:
            raise ValueError(f"{name} {width} must be >= 1")
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
        if t.device.type not in _build.KERNEL_DEVICES:
            raise ValueError("the flash-attention kernel takes CUDA (or meta) "
                             "tensors; kernels.ref holds the plain version")
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
    if q.device.type == "meta":
        return _unpad(out, dv), lse
    lib = _build.library("flash_attention")
    err = lib.repro_flash_fwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, tq, tk, hq, hkv, kd, kdv,
        _scale(d, scale), int(causal), _prefix(k, prefix_len),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.by_route[route(q.dtype, kd, kdv)] += 1
    return _unpad(out, dv), lse


flash_attention_fwd.launches = 0
# the same launches by route (:func:`route`)
flash_attention_fwd.by_route = dict.fromkeys(ROUTE_CODES, 0)


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True,
                        scale: Optional[float] = None, prefix_len: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One backward pass (three kernel launches: delta = dO . O, dQ, and
    dK/dV; a fourth, which adds the dK/dV partial sums, where the bf16 wide
    route splits each kv head's query heads over blocks, as the CUDA source
    decides from the shape and sizes the f32 workspace for, which it asks of
    ``repro_flash_bwd_workspace``): ``(dq, dk, dv)`` in the inputs' dtype,
    dv of V's width."""
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
    meta = q.device.type == "meta"
    lib = None if meta else _build.library("flash_attention")
    nbytes = (bwd_workspace_bytes(q.dtype, b, tk, hq, hkv, kd, kdv) if meta
              else lib.repro_flash_bwd_workspace(_DTYPE_CODE[q.dtype], b, tk,
                                                 hq, hkv, kd, kdv))
    if nbytes < 0:
        raise ValueError(f"the backward takes no {tuple(q.shape)} over "
                         f"{tuple(k.shape)} call")
    space = (torch.empty(nbytes // 4, dtype=torch.float32, device=q.device)
             if nbytes else None)
    if meta:
        return _unpad(dq, d), _unpad(dk, d), _unpad(dv, dv_)
    err = lib.repro_flash_bwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, tq, tk, hq, hkv, kd,
        kdv, _scale(d, scale), int(causal), _prefix(k, prefix_len),
        None if space is None else space.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention_bwd")
    n = 3 if space is None else 4    # delta, dQ, dK/dV and the split's sum
    flash_attention_bwd.launches += n
    flash_attention_bwd.by_route[route(q.dtype, kd, kdv)] += n
    return _unpad(dq, d), _unpad(dk, d), _unpad(dv, dv_)


flash_attention_bwd.launches = 0
flash_attention_bwd.by_route = dict.fromkeys(ROUTE_CODES, 0)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel in ``forward``, backward kernel in ``backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, prefix_len):
        out, lse = work.counted(
            "flash_attention_fwd",
            lambda: work.flash_fwd(*_work_shape(q, k, v), causal, prefix_len),
            flash_attention_fwd, q, k, v, causal, scale, prefix_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.prefix_len = causal, scale, prefix_len
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = work.counted(
            "flash_attention_bwd",
            lambda: work.flash_bwd(*_work_shape(q, k, v), ctx.causal,
                                   ctx.prefix_len),
            flash_attention_bwd, q, k, v, out, lse, dout.contiguous(),
            ctx.causal, ctx.scale, ctx.prefix_len)
        return dq, dk, dv, None, None, None


def _work_shape(q, k, v) -> tuple:
    """(B, Tq, Tk, Hq, Hkv, D, Dv, element size) of a call, for
    :mod:`repro_torch.kernels.work`."""
    b, tq, hq, d = q.shape
    return b, tq, k.shape[1], hq, k.shape[2], d, v.shape[3], q.element_size()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """Differentiable flash attention through the CUDA kernels."""
    return _FlashAttention.apply(q, k, v, causal, scale, prefix_len)
