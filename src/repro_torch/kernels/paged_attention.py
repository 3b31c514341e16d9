"""Paged decode attention on Hopper: the CUDA kernel's wrappers.

Counterpart of ``repro/kernels/paged_attention.py``.  The Pallas kernels
``paged_attention_pallas`` and ``paged_attention_pallas_quant`` become one
hand-written CUDA source, ``csrc/paged_attention.cu``, built at first use
(:mod:`repro_torch.kernels._build`).  The wrappers here take CUDA tensors
and launch the kernel on PyTorch's current stream, or meta tensors for its
shape rule (the same checks, output and workspace, at
:data:`SPLIT_TOKENS` positions a span; no launch and no count); the plain
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

Every head width runs.  A width that is not a multiple of 8 (the
kernel's 16- and 8-byte copies) is zero-padded to the next one here, q
and both pools, and the output sliced back, the softmax scale the true
width's: zero columns add nothing to q.k and give zero output columns.
The pad copies the pools on every call; no configuration has such a
width (:func:`repro_torch.kernels.flash_attention.padded_dims`, the
flash wrappers' rounding).

Past 256 columns (after that padding) a call takes the wide route
(:func:`route`): ``paged_wide_kernel``, with the same spans, workspace
and combine.  It stages each span's whole K and V rows in shared memory
in the pool's dtype by bulk copies, all in flight at once (bf16 heads to
~740 columns, int8 to ~1,340, float32 to ~400; wider heads, and int8 rows
of a width that is not a multiple of 16, through a ``cp.async`` ring of
64-column boxes), and runs the scores of bf16 queries, and p V over bf16
pools, on the tensor cores (``mma.sync``) for any number of query heads
per kv head; float32 queries, and p V over int8 pools, stay on the CUDA
cores.  Each wrapper counts its launches by route in ``.by_route``
beside ``.launches``.

:func:`paginate_cache` lays a contiguous (B, S, Hkv, D) cache out as a
pool with identity tables, the layout fig11 holds against the contiguous
path before any page is shared.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import _pad, padded_dims
from repro_torch.kernels.ref import quantize_pages

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["ROUTES", "SplitPlan", "paged_attention", "paged_attention_multitok",
           "paged_attention_quant", "paged_attention_quant_multitok",
           "paginate_cache", "quantize_pages", "route", "split_plan",
           "split_tokens"]

# the CUDA source's routes: paged_split_kernel up to WIDE_ABOVE columns,
# paged_wide_kernel past them (``launch`` in csrc/paged_attention.cu)
ROUTES = ("narrow", "wide")
WIDE_ABOVE = 256
# positions per span (kSplit in csrc/paged_attention.cu): the shape rule's
# span length; on the card the built library's answer (:func:`split_tokens`)
SPLIT_TOKENS = 64


def route(d: int) -> str:
    """The route a call of head width ``d`` takes, by the width the kernel
    sees: ``d`` padded to a multiple of 8, as the wrappers pad it."""
    return "wide" if padded_dims(d, d)[0] > WIDE_ABOVE else "narrow"


def _check(q: torch.Tensor, pages: torch.Tensor, table: torch.Tensor,
           lengths: torch.Tensor, quant: bool) -> None:
    """Raise on anything the kernel does not take."""
    if q.device.type not in _build.KERNEL_DEVICES:
        raise ValueError("the paged-attention kernel takes CUDA (or meta) "
                         "tensors; kernels.ref holds the plain version")
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
    if d < 1:
        raise ValueError(f"head dim {d} must be >= 1")
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
    kd = padded_dims(d, d)[0]
    q, k_pages, v_pages = (_pad(t, kd) for t in (q, k_pages, v_pages))
    out = torch.empty_like(q)
    meta = q.device.type == "meta"
    lib, split = (None, SPLIT_TOKENS) if meta else _library()
    plan = split_plan(b, hq, hkv, kd, page, n_p, split)
    ws = _workspace(plan, q.device)
    if meta:
        return out if kd == d else out[..., :d].contiguous()
    err = lib.repro_paged_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), _ptr(ws), b, hq, hkv, kd, n, page,
        n_p, plan.max_splits, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_attention")
    paged_attention.launches += 1
    paged_attention.by_route[route(d)] += 1
    return out if kd == d else out[..., :d].contiguous()


paged_attention.launches = 0
paged_attention.by_route = dict.fromkeys(ROUTES, 0)


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
    kd = padded_dims(d, d)[0]
    q, k_pages, v_pages = (_pad(t, kd) for t in (q, k_pages, v_pages))
    out = torch.empty_like(q)
    meta = q.device.type == "meta"
    lib, split = (None, SPLIT_TOKENS) if meta else _library()
    plan = split_plan(b, hq, hkv, kd, page, n_p, split)
    ws = _workspace(plan, q.device)
    if meta:
        return out if kd == d else out[..., :d].contiguous()
    err = lib.repro_paged_attention_quant(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        k_scales.data_ptr(), v_pages.data_ptr(), v_scales.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        _ptr(ws), b, hq, hkv, kd, n, page, n_p,
        plan.max_splits, scale, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_attention_quant")
    paged_attention_quant.launches += 1
    paged_attention_quant.by_route[route(d)] += 1
    return out if kd == d else out[..., :d].contiguous()


paged_attention_quant.launches = 0
paged_attention_quant.by_route = dict.fromkeys(ROUTES, 0)


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


def paginate_cache(
    k_cache: torch.Tensor,    # (B, S, Hkv, D) contiguous per-stream cache
    v_cache: torch.Tensor,    # (B, S, Hkv, Dv)
    page: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lay a contiguous batched cache out as a page pool and identity
    tables: stream b's logical page j sits in pool slot b*nP + j, the
    padding to a whole page is zeros, and the int32 table lies on the
    cache's device (nothing is made on the host).  A round trip through
    :func:`paged_attention` matches decode attention on the contiguous
    cache.  Where S is a whole number of pages and the cache is
    contiguous, the pools are views of the cache, not copies."""
    b, s, hkv, d = k_cache.shape
    dv = v_cache.shape[-1]
    if tuple(v_cache.shape[:3]) != (b, s, hkv):
        raise ValueError(f"v_cache {tuple(v_cache.shape)} does not match "
                         f"k_cache {tuple(k_cache.shape)}")
    n_p = -(-s // page)
    pad = n_p * page - s
    if pad:
        k_cache = torch.nn.functional.pad(k_cache, (0, 0, 0, 0, 0, pad))
        v_cache = torch.nn.functional.pad(v_cache, (0, 0, 0, 0, 0, pad))
    k_pages = k_cache.reshape(b * n_p, page, hkv, d).contiguous()
    v_pages = v_cache.reshape(b * n_p, page, hkv, dv).contiguous()
    table = torch.arange(b * n_p, dtype=torch.int32,
                         device=k_cache.device).reshape(b, n_p)
    return k_pages, v_pages, table
