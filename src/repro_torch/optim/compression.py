"""Error-feedback int8 gradient compression for the slow cross-pod hop.

Counterpart of ``repro/optim/compression.py``.  The Cluster<->Booster link
(pod axis) is the scarce fabric resource, as in DEEP-ER's two-module
prototype.  Before the cross-pod gradient reduction the gradients can be
quantized to int8 with per-tensor scales and an error-feedback residual
(the quantization error is added back into the next step's gradients,
keeping the optimizer unbiased in expectation): 4x less cross-pod
traffic, and the residual is checkpointed with the optimizer state so
restarts stay exact.

The quantization is :func:`repro_torch.memory.codecs.int8_quantize` in
its per-tensor mode (``axis=None``: one scalar scale), as in the
reference; this module owns only the error-feedback residual around it.
Trees are the port's nested dicts; every output leaf lies on its
gradient's device, the residual in float32.  The residual is ``g32 - q * scale`` with the product rounded
before the subtraction; XLA may fuse the reference's into one
multiply-add, so the two residuals can differ by an ulp of ``scale``
while ``q`` and ``scale`` agree bit for bit.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.memory.codecs import int8_dequantize, int8_quantize
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten

__all__ = ["compress_grads", "decompress_grads", "init_residual"]


def compress_grads(grads: Any, residual: Any) -> Tuple[Any, Any, Any]:
    """-> (int8 grads, f32 scales, new residual carried to the next step)."""

    def comp(g: torch.Tensor, r: torch.Tensor):
        g32 = g.to(torch.float32) + r
        q, scale = int8_quantize(g32)
        return q, scale, g32 - int8_dequantize(q, scale)

    out = [comp(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(residual))]
    return tuple(tree_unflatten(grads, (o[i] for o in out)) for i in range(3))


def decompress_grads(qs: Any, ss: Any) -> Any:
    """float32 gradients from int8 grads and their scales."""
    return tree_unflatten(qs, [int8_dequantize(q, s) for q, s in
                               zip(tree_leaves(qs), tree_leaves(ss))])


def init_residual(grads_like: Any) -> Any:
    """A zero float32 residual per gradient leaf, on that leaf's device."""
    return tree_map(lambda g: torch.zeros(tuple(g.shape), dtype=torch.float32,
                                          device=g.device), grads_like)
