"""Dispatch between the CUDA kernels and their plain versions, by device.

Counterpart of ``repro/kernels/ops.py``, which picks by JAX backend.
Here the tensor decides:

* a CUDA tensor launches the hand-written kernel, or the wrapper raises —
  nothing falls back;
* a CPU tensor runs the plain PyTorch version in
  :mod:`repro_torch.kernels.ref`;
* ``use_kernel=False`` runs the plain version on a CUDA tensor (the
  comparisons in ``chip_smoke.py`` use it); ``use_kernel=True`` on a CPU
  tensor raises.

Both paged-attention sides see the same clamped page table.  The flash
kernel has no prefix-LM mask (neither has the reference's Pallas kernel,
whose dispatch drops ``prefix_len``): on the kernel path a non-zero
``prefix_len`` raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as kref
from repro_torch.kernels import xor_parity as xp


def _kernel_for(x: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    if use_kernel is None:
        return x.device.type == "cuda"
    if use_kernel and x.device.type != "cuda":
        raise ValueError(f"use_kernel=True needs a CUDA tensor, got {x.device}")
    return bool(use_kernel)


def _clamped(table: torch.Tensor, n: int) -> torch.Tensor:
    return table.clamp(0, n - 1)


def xor_reduce(stacked, use_kernel: Optional[bool] = None):
    """(R, M, 128) int32 -> (M, 128): XOR over axis 0."""
    if _kernel_for(stacked, use_kernel):
        return xp.xor_reduce(stacked)
    return kref.xor_reduce(stacked)


def flash_attention(q, k, v, causal=True, prefix_len=0, scale=None,
                    use_kernel: Optional[bool] = None):
    """(B, Tq, Hq, D) attention over (B, Tk, Hkv, D) keys and values;
    differentiable on both paths (the kernel path through the backward
    kernel)."""
    # refused before the device check, so the refusal is the same anywhere
    if prefix_len and (use_kernel or (use_kernel is None and q.is_cuda)):
        raise ValueError(f"prefix_len={prefix_len}: the flash kernel has no "
                         "prefix-LM mask (nor has the reference's Pallas "
                         "kernel); only prefix_len=0 runs on the card")
    if _kernel_for(q, use_kernel):
        return fa.flash_attention(q, k, v, causal=causal, scale=scale)
    return kref.flash_attention(q, k, v, causal=causal, scale=scale,
                                prefix_len=prefix_len)


def paged_attention(q, k_pages, v_pages, page_table, lengths, scale=None,
                    use_kernel: Optional[bool] = None):
    """(B, Hq, D) decode attention over a paged pool."""
    if _kernel_for(q, use_kernel):
        return pa.paged_attention(q, k_pages, v_pages, page_table, lengths,
                                  scale)
    return kref.paged_attention(q, k_pages, v_pages,
                                _clamped(page_table, k_pages.shape[0]),
                                lengths, scale)


def paged_attention_multitok(q, k_pages, v_pages, page_table, positions,
                             scale=None, use_kernel: Optional[bool] = None):
    """(B, T, Hq, D) speculative rows over a paged pool."""
    if _kernel_for(q, use_kernel):
        return pa.paged_attention_multitok(q, k_pages, v_pages, page_table,
                                           positions, scale)
    return kref.paged_attention_multitok(
        q, k_pages, v_pages, _clamped(page_table, k_pages.shape[0]),
        positions, scale)


def paged_attention_quant(q, k_pages, k_scales, v_pages, v_scales,
                          page_table, lengths, scale=None,
                          use_kernel: Optional[bool] = None):
    """(B, Hq, D) decode attention over an int8 pool."""
    if _kernel_for(q, use_kernel):
        return pa.paged_attention_quant(q, k_pages, k_scales, v_pages,
                                        v_scales, page_table, lengths, scale)
    return kref.paged_attention_quant(
        q, k_pages, k_scales, v_pages, v_scales,
        _clamped(page_table, k_pages.shape[0]), lengths, scale)


def paged_attention_quant_multitok(q, k_pages, k_scales, v_pages, v_scales,
                                   page_table, positions, scale=None,
                                   use_kernel: Optional[bool] = None):
    """(B, T, Hq, D) speculative rows over an int8 pool."""
    if _kernel_for(q, use_kernel):
        return pa.paged_attention_quant_multitok(
            q, k_pages, k_scales, v_pages, v_scales, page_table, positions,
            scale)
    return kref.paged_attention_quant_multitok(
        q, k_pages, k_scales, v_pages, v_scales,
        _clamped(page_table, k_pages.shape[0]), positions, scale)
