"""Collectives for the DEEP-ER parity path, on ``torch.distributed``.

Counterpart of ``repro/distributed/collectives.py``.  The NAM's
near-memory XOR (§II-B2) becomes an XOR all-reduce over a process group:
each rank contributes its checkpoint block, and a recursive-halving
butterfly of log2(N) exchange rounds combines blocks with the XOR kernel
(bitwise XOR has no reduce op, so the butterfly is built explicitly).  In
each round rank i swaps its block with rank i ^ step
(``batch_isend_irecv``), stacks ``[x, other]`` and reduces the stack with
:func:`repro_torch.kernels.ops.xor_reduce`: the CUDA XOR kernel for a card
tensor.  The reference's rule decides where the kernel runs: only a
``(2, M, 128)`` stack goes to it, any other shape to an elementwise
``bitwise_xor`` (the reference's own dispatch, not a fallback).  Every rank
ends with the XOR of all blocks (parity everywhere: any single lost block
is reconstructible from any survivor's copy).

A group in place of a mesh axis name.  NCCL refuses two ranks on one
device, so ranks that share a card run on a gloo group; gloo's exchange
and sums then go through host staging buffers (a card tensor is copied to
the host, sent, received and copied back), and each combine runs on the
card.  An NCCL group takes card tensors as they are.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import ops

__all__ = ["grid_groups", "hierarchical_psum", "xor_all_reduce",
           "xor_reduce_to"]


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` goes through a host buffer on ``group`` (a card
    tensor on a gloo group)."""
    return x.device.type != "cpu" and dist.get_backend(group) == dist.Backend.GLOO


def _sync(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _exchange(x: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send ``x`` to group rank ``peer`` and receive its block."""
    staged = _staged(x, group)
    send = x.cpu() if staged else x.contiguous()
    recv = torch.empty_like(send)
    dst = peer if group is None else dist.get_global_rank(group, peer)
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, group),
            dist.P2POp(dist.irecv, recv, dst, group)]):
        work.wait()
    return recv.to(x.device) if staged else recv


def _combine(x: torch.Tensor, other: torch.Tensor,
             use_kernel: Optional[bool]) -> torch.Tensor:
    stacked = torch.stack([x, other])
    if stacked.dim() == 3 and stacked.shape[-1] == 128:
        return ops.xor_reduce(stacked, use_kernel=use_kernel)
    return torch.bitwise_xor(x, other)


def xor_all_reduce(x: torch.Tensor, group=None,
                   use_kernel: Optional[bool] = None,
                   rounds: Optional[List[dict]] = None) -> torch.Tensor:
    """Butterfly XOR all-reduce over ``group`` (the default group when
    None; its size a power of two).  ``x``: int32, the same shape on every
    rank.  ``rounds``, when given, receives each round's ``exchange_s`` and
    ``combine_s`` (host clock, the card synchronized around each part)."""
    n = dist.get_world_size(group)
    if n & (n - 1):
        raise ValueError(f"xor_all_reduce needs a power-of-two group, got {n} "
                         "ranks: the butterfly pairs rank i with i ^ step")
    me = dist.get_rank(group)
    step = 1
    while step < n:
        t0 = time.perf_counter()
        other = _exchange(x, me ^ step, group)
        if rounds is not None:
            _sync(x)
        t1 = time.perf_counter()
        x = _combine(x, other, use_kernel)
        if rounds is not None:
            _sync(x)
            rounds.append({"exchange_s": t1 - t0,
                           "combine_s": time.perf_counter() - t1})
        step *= 2
    return x


def xor_reduce_to(x: torch.Tensor, group=None, root: int = 0) -> torch.Tensor:
    """Butterfly XOR reduce; the result is only guaranteed on ``root``
    (the all-reduce form doubles as replication, which is what checkpoint
    parity wants anyway)."""
    return xor_all_reduce(x, group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if _staged(x, group):
        host = x.cpu()
        dist.all_reduce(host, group=group)
        return host.to(x.device)
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def hierarchical_psum(x: torch.Tensor, inner=None, outer=None) -> torch.Tensor:
    """Two-level gradient reduction: the sum inside the ``inner`` group
    (a pod), then over the ``outer`` group (the slow cross-pod hop),
    matching the Cluster-Booster bandwidth asymmetry.  A new tensor; ``x``
    is left as it is."""
    return _all_reduce(_all_reduce(x, inner), outer)


def grid_groups(n_outer: int, n_inner: int, backend: Optional[str] = None
                ) -> Tuple[object, object]:
    """This rank's (inner, outer) groups over a 2-D grid of the default
    group's ranks, rank = outer index * n_inner + inner index: inner
    groups are the grid's rows, outer groups its columns.  Every rank
    creates every group, in the same order, as ``new_group`` requires."""
    if n_outer * n_inner != dist.get_world_size():
        raise ValueError(f"a {n_outer} x {n_inner} grid needs "
                         f"{n_outer * n_inner} ranks, the world has "
                         f"{dist.get_world_size()}")
    me = dist.get_rank()
    inner = outer = None
    for o in range(n_outer):
        g = dist.new_group([o * n_inner + i for i in range(n_inner)],
                           backend=backend)
        if me // n_inner == o:
            inner = g
    for i in range(n_inner):
        g = dist.new_group([o * n_inner + i for o in range(n_outer)],
                           backend=backend)
        if me % n_inner == i:
            outer = g
    return inner, outer
