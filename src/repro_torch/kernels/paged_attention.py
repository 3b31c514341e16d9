"""Paged decode attention on Hopper: the CUDA kernel's wrappers.

Counterpart of ``repro/kernels/paged_attention.py``.  The Pallas kernels
``paged_attention_pallas`` and ``paged_attention_pallas_quant`` become one
hand-written CUDA source, ``csrc/paged_attention.cu``, built at first use
(:mod:`repro_torch.kernels._build`).  The wrappers here take CUDA tensors
only and launch the kernel on PyTorch's current stream; the plain
versions live in :mod:`repro_torch.kernels.ref`, and
:mod:`repro_torch.kernels.ops` picks between the two by device.

Each kernel wrapper counts its calls in ``<wrapper>.launches``, so a
run can show that its attention went through the kernel; a call is two
CUDA launches, the spans and their combine, or one when no row can have
two spans (:func:`split_plan`).  Table entries are clamped to ``[0, N-1]``
as the reference clamps them (``paged_attention.py:109``, ``:316``); the
kernel applies the clamp as it reads each entry, which saves a separate
launch per call.

The kernel cuts every row into spans of a fixed number of positions (a
constant of the source) and writes each span's partial softmax to a
workspace that the wrapper allocates here; :func:`split_plan` is that
arithmetic.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import quantize_pages

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["SplitPlan", "paged_attention", "paged_attention_multitok",
           "paged_attention_quant", "paged_attention_quant_multitok",
           "quantize_pages", "split_plan", "split_tokens"]


def _check(q: torch.Tensor, pages: torch.Tensor, table: torch.Tensor,
           lengths: torch.Tensor, quant: bool) -> None:
    """Raise on anything the kernel does not take."""
    if q.device.type != "cuda":
        raise ValueError("the paged-attention kernel takes CUDA tensors; "
                         "kernels.ref holds the plain version")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    want = torch.int8 if quant else q.dtype
    if pages.dtype != want:
        raise TypeError(f"pages must be {want}, got {pages.dtype}")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page table and lengths must be int32")
    if q.dim() != 3 or pages.dim() != 4:
        raise ValueError(f"want q (B, Hq, D) and pages (N, page, Hkv, D), got "
                         f"{tuple(q.shape)} and {tuple(pages.shape)}")
    b, hq, d = q.shape
    hkv = pages.shape[2]
    if pages.shape[3] != d:
        raise ValueError(f"pages head dim {pages.shape[3]} != q head dim {d}")
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    if d % 8 or d > 256:
        raise ValueError(f"head dim {d} must be a multiple of 8 and <= 256")
    if table.dim() != 2 or table.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(f"want table (B, nP) and lengths (B,) with B={b}, got "
                         f"{tuple(table.shape)} and {tuple(lengths.shape)}")


def _checked(ts, dev: torch.device) -> None:
    """Same device and contiguous; q and the pages (the first three)
    16-byte aligned for the kernel's vector loads."""
    for i, t in enumerate(ts):
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
        if i < 3 and t.data_ptr() % 16:
            raise ValueError("q and the pages must be 16-byte aligned")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


class SplitPlan(NamedTuple):
    """What one call launches and allocates."""
    max_splits: int     # spans per row at most: ceil(nP * page / split)
    blocks: int         # blocks of the span kernel, one per (row, kv head, span)
    workspace: int      # f32 elements: (B, Hq, max_splits, D) partial
    #                     numerators, then (B, Hq, max_splits, 2) max and sum
    cuda_launches: int  # 2 (spans, then their combine), or 1 for one span


def split_plan(b: int, hq: int, hkv: int, d: int, page: int, n_p: int,
               split: int) -> SplitPlan:
    """The kernel's spans for a (B, Hq, D) query over (B, nP) tables of
    ``page``-position pages, ``split`` positions per span: no workspace and
    no combine launch when no row can have two spans."""
    max_splits = -(-(n_p * page) // split)
    several = max_splits > 1
    return SplitPlan(
        max_splits=max_splits, blocks=b * hkv * max_splits,
        workspace=b * hq * max_splits * (d + 2) if several else 0,
        cuda_launches=2 if several else 1)


_spans: Dict[int, int] = {}


def _library():
    """The built library and its span length, looked up once per call."""
    lib = _build.library("paged_attention")
    split = _spans.get(id(lib))
    if split is None:
        split = _spans[id(lib)] = lib.repro_paged_split_tokens()
    return lib, split


def split_tokens() -> int:
    """Positions per span in the built source."""
    return _library()[1]


def _workspace(plan: SplitPlan, dev: torch.device) -> Optional[torch.Tensor]:
    """The plan's workspace, fresh for each call (the kernel allocates
    nothing); None when the plan needs none."""
    if not plan.workspace:
        return None
    return torch.empty(plan.workspace, dtype=torch.float32, device=dev)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def paged_attention(
    q: torch.Tensor,          # (B, Hq, D) one new token per sequence
    k_pages: torch.Tensor,    # (N, page, Hkv, D) physical key pool
    v_pages: torch.Tensor,    # (N, page, Hkv, D) physical value pool
    page_table: torch.Tensor,  # (B, nP) int32: logical page j -> pool slot
    lengths: torch.Tensor,    # (B,) int32 valid token counts
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Paged decode attention through the CUDA kernel; output in q's
    dtype.  Pages share q's dtype (float32 or bfloat16)."""
    _check(q, k_pages, page_table, lengths, quant=False)
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages must match in shape and dtype")
    _checked((q, k_pages, v_pages, page_table, lengths), q.device)
    b, hq, d = q.shape
    n, page, hkv, _ = k_pages.shape
    n_p = page_table.shape[1]
    scale = float(d ** -0.5) if scale is None else float(scale)
    out = torch.empty_like(q)
    lib, split = _library()
    plan = split_plan(b, hq, hkv, d, page, n_p, split)
    ws = _workspace(plan, q.device)
    err = lib.repro_paged_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), _ptr(ws), b, hq, hkv, d, n, page,
        n_p, plan.max_splits, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_quant(
    q: torch.Tensor,          # (B, Hq, D)
    k_pages: torch.Tensor,    # (N, page, Hkv, D) int8
    k_scales: torch.Tensor,   # (N, page, Hkv) f32
    v_pages: torch.Tensor,    # (N, page, Hkv, D) int8
    v_scales: torch.Tensor,   # (N, page, Hkv) f32
    page_table: torch.Tensor,  # (B, nP) int32
    lengths: torch.Tensor,    # (B,) int32
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`paged_attention` over an int8 pool: each K/V row is
    dequantized by its f32 scale inside the kernel's softmax loop."""
    _check(q, k_pages, page_table, lengths, quant=True)
    if v_pages.shape != k_pages.shape or v_pages.dtype != torch.int8:
        raise ValueError("k_pages and v_pages must match in shape and dtype")
    n, page, hkv, _ = k_pages.shape
    for s in (k_scales, v_scales):
        if s.dtype != torch.float32 or tuple(s.shape) != (n, page, hkv):
            raise ValueError(f"scales must be float32 {(n, page, hkv)}, got "
                             f"{s.dtype} {tuple(s.shape)}")
    _checked((q, k_pages, v_pages, k_scales, v_scales, page_table, lengths),
             q.device)
    b, hq, d = q.shape
    n_p = page_table.shape[1]
    scale = float(d ** -0.5) if scale is None else float(scale)
    out = torch.empty_like(q)
    lib, split = _library()
    plan = split_plan(b, hq, hkv, d, page, n_p, split)
    ws = _workspace(plan, q.device)
    err = lib.repro_paged_attention_quant(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        k_scales.data_ptr(), v_pages.data_ptr(), v_scales.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        _ptr(ws), b, hq, hkv, d, n, page, n_p,
        plan.max_splits, scale, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_attention_quant")
    paged_attention_quant.launches += 1
    return out


paged_attention_quant.launches = 0


def _fold(q: torch.Tensor, page_table: torch.Tensor, positions: torch.Tensor):
    """(B, T) candidate rows -> a (B*T)-row batch: row (b, t) reuses lane
    b's table with length ``positions[b, t] + 1``."""
    b, t = q.shape[:2]
    rows = q.reshape((b * t,) + tuple(q.shape[2:]))
    tables = page_table.repeat_interleave(t, dim=0)
    lengths = (positions.reshape(b * t) + 1).to(torch.int32)
    return rows, tables, lengths


def paged_attention_multitok(
    q: torch.Tensor,          # (B, T, Hq, D)
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, nP) int32
    positions: torch.Tensor,  # (B, T)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """All T candidates of every lane in one kernel launch."""
    rows, tables, lengths = _fold(q, page_table, positions)
    out = paged_attention(rows, k_pages, v_pages, tables, lengths, scale)
    return out.reshape(q.shape)


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
    """The (B, T) fold over the quantized kernel."""
    rows, tables, lengths = _fold(q, page_table, positions)
    out = paged_attention_quant(rows, k_pages, k_scales, v_pages, v_scales,
                                tables, lengths, scale)
    return out.reshape(q.shape)
