"""The shared int8 quantization math, in torch.

Counterpart of ``repro/memory/codecs.py``'s :func:`int8_quantize` /
:func:`int8_dequantize` and :data:`SCALE_SUFFIX`: the quantized page pool
and the quantized paged-attention path call these two functions, so the
int8 values and scales are bit-equal to the reference's (same ``EPS``,
float32 division, round-half-to-even, clip to +-127).  The byte-blob
codecs wait for the resilient-serving slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

EPS = 1e-12  # zero-page guard; matches the reference

# companion-buffer naming for quantized device pools: leaf "k" holds int8
# values, "k__scale" the per-channel float32 scales
SCALE_SUFFIX = "__scale"


def int8_quantize(x: torch.Tensor, axis: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization: ``q = round(x / scale)`` with
    ``scale = max(|x|) / 127`` over the whole tensor (``axis=None``) or
    per channel along ``axis`` (keepdims).  Returns ``(q int8, scale
    f32)``."""
    xf = x.to(torch.float32)
    if axis is None:
        amax = xf.abs().amax()
    else:
        amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=EPS) / 127.0
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`int8_quantize` (float32 result)."""
    return q.to(torch.float32) * scale
