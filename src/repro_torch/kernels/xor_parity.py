"""XOR parity reduce on Hopper: the CUDA kernel's wrapper.

Counterpart of ``repro/kernels/xor_parity.py``.  The Pallas kernel
``xor_reduce_pallas`` — the NAM's near-memory parity combine, encode
(reduce over all fragments) and reconstruct (parity + survivors) alike —
becomes the hand-written CUDA source ``csrc/xor_parity.cu``, built at
first use.  :func:`xor_reduce` takes CUDA tensors and counts its
launches in ``.launches``, or a meta tensor for its shape rule (no launch,
no count); the plain version is :func:`repro_torch.kernels.ref.xor_reduce`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

LANES = 128

__all__ = ["LANES", "xor_reduce"]


def xor_reduce(stacked: torch.Tensor) -> torch.Tensor:
    """XOR-reduce ``stacked``: (R, M, 128) int32 -> (M, 128) int32."""
    if stacked.device.type not in _build.KERNEL_DEVICES:
        raise ValueError("the XOR kernel takes CUDA (or meta) tensors; "
                         "kernels.ref holds the plain version")
    if stacked.dtype != torch.int32:
        raise TypeError(f"want int32 words, got {stacked.dtype}")
    if stacked.dim() != 3 or stacked.shape[-1] != LANES or stacked.shape[0] < 1:
        raise ValueError(f"expected (R, M, {LANES}), got {tuple(stacked.shape)}")
    if not stacked.is_contiguous() or stacked.data_ptr() % 16:
        raise ValueError("the kernel takes a contiguous, 16-byte aligned tensor")
    r, m, _ = stacked.shape
    out = torch.empty((m, LANES), dtype=torch.int32, device=stacked.device)
    if stacked.device.type == "meta":
        return out
    sms = torch.cuda.get_device_properties(stacked.device).multi_processor_count
    lib = _build.library("xor_parity")
    err = lib.repro_xor_reduce(stacked.data_ptr(), out.data_ptr(), r, m, sms,
                               torch.cuda.current_stream(stacked.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"xor_reduce launch failed with CUDA error {err}")
    xor_reduce.launches += 1
    return out


xor_reduce.launches = 0
