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

Under an active dry-run counter (:mod:`repro_torch.launch.dryrun`) each
collective records its kind, the bytes of its result on one rank and its
group's size; the operators inside it are not counted.  On a dry mesh
(:meth:`repro_torch.distributed.mesh.Mesh.dry_run`) the group is a
:class:`~repro_torch.distributed.mesh.DryGroup`: a collective of meta
tensors records itself and returns a meta result of the right shape, and
no process group is made.  What each records is what the port runs:
``psum_scatter`` is an all-reduce and a slice here, so it records an
all-reduce.

A group in place of a mesh axis name.  NCCL refuses two ranks on one
device, so ranks that share a card run on a gloo group; gloo's exchange
and sums then go through host staging buffers (a card tensor is copied to
the host, sent, received and copied back), and each combine runs on the
card.  An NCCL group takes card tensors as they are.

The collectives of an island (a ``shard_map`` body of the reference),
each over one group (a mesh axis: :meth:`repro_torch.distributed.mesh.Mesh.group`),
with JAX's ``tiled=True`` layout and a ``torch.autograd.Function`` each,
whose backward is the transpose JAX gives the same collective:

* :func:`all_to_all` (``jax.lax.all_to_all``): split ``split_axis`` into
  one chunk per rank, chunk ``j`` to rank ``j``, the received chunks
  concatenated along ``concat_axis`` in rank order; its backward is the
  all-to-all with the two axes swapped.  ``all_to_all_single`` splits
  and joins dim 0 only, so the split axis is moved to the front, the
  tensor made contiguous, and the chunks put back in place;
* :func:`all_gather` (``tiled``): every rank's block concatenated along
  ``axis``; backward, the summed gradient's own block;
* :func:`psum_scatter` (``tiled``): the sum over the group, rank ``i``
  keeping block ``i`` of ``axis``; backward, the all-gather;
* :func:`psum`: the sum; backward, the sum (JAX's transpose of ``psum``
  for values that differ across the group).

Megatron's pair for a tensor-parallel island that trains, the reference's
``psum`` under ``shard_map(check_rep=False)`` made explicit:
:func:`copy_to_group` (identity forward, sum backward: where a replicated
input enters) and :func:`reduce_from_group` (sum forward, identity
backward: where the partial output leaves).  :func:`pmean` is the mean
whose backward is the mean, for statistics every rank's loss reads
(the router's density and mean probability over the data ranks), and
:func:`average_gradients` the data-parallel mean of a gradient tree, in
place, leaf by leaf in the tree's fixed order.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.mesh import DryGroup
from repro_torch.kernels import ops, work

__all__ = ["all_gather", "all_to_all", "average_gradients", "copy_to_group",
           "grid_groups", "hierarchical_psum", "pmean", "psum",
           "psum_scatter", "reduce_from_group", "xor_all_reduce",
           "xor_reduce_to"]


def _dry(x: torch.Tensor, group) -> bool:
    """Whether ``group`` is a dry mesh's record-only group, whose
    collectives move nothing: they take meta tensors only."""
    if not isinstance(group, DryGroup):
        return False
    if x.device.type != "meta":
        raise ValueError(f"a dry mesh's collectives take meta tensors, got "
                         f"{x.device}")
    return True


def _recorded(kind: str, nbytes: int, group):
    """The context of one collective of ``kind`` whose result holds
    ``nbytes`` on each rank: an active dry-run counter records it (and
    counts none of the operators inside)."""
    if work.ACTIVE is None:
        return contextlib.nullcontext()
    return work.ACTIVE.collective(kind, nbytes, _size(group))


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` goes through a host buffer on ``group`` (a card
    tensor on a gloo group)."""
    return (x.device.type != "cpu" and not isinstance(group, DryGroup)
            and dist.get_backend(group) == dist.Backend.GLOO)


def _sync(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _exchange(x: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send ``x`` to group rank ``peer`` and receive its block."""
    with _recorded("collective-permute", _nbytes(x), group):
        return _swap(x, peer, group)


def _swap(x: torch.Tensor, peer: int, group) -> torch.Tensor:
    if _dry(x, group):
        return torch.empty_like(x)
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
    n = _size(group)
    if n & (n - 1):
        raise ValueError(f"xor_all_reduce needs a power-of-two group, got {n} "
                         "ranks: the butterfly pairs rank i with i ^ step")
    me = _rank(group)
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
    with _recorded("all-reduce", _nbytes(x), group):
        return _reduced(x, group)


def _reduced(x: torch.Tensor, group) -> torch.Tensor:
    if _dry(x, group):
        return torch.empty_like(x)
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


# ---------------------------------------------------------------------- #
# island collectives (tiled, differentiable)
# ---------------------------------------------------------------------- #


def _size(group) -> int:
    if isinstance(group, DryGroup):
        return group.size()
    return dist.get_world_size(group)


def _rank(group) -> int:
    if isinstance(group, DryGroup):
        return group.rank()
    return dist.get_rank(group)


def _a2a(x: torch.Tensor, group, split_axis: int, concat_axis: int
         ) -> torch.Tensor:
    n = _size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    with _recorded("all-to-all", _nbytes(x), group):
        if _dry(x, group):
            shape = list(x.shape)
            shape[split_axis] //= n
            shape[concat_axis] *= n
            return x.new_empty(shape)
        return _a2a_moved(x, group, split_axis, concat_axis, n)


def _a2a_moved(x: torch.Tensor, group, split_axis: int, concat_axis: int,
               n: int) -> torch.Tensor:
    staged = _staged(x, group)
    # (n, chunk, rest...) with the split axis in front, contiguous
    front = x.movedim(split_axis, 0)
    send = front.reshape((n, front.shape[0] // n) + front.shape[1:])
    send = (send.cpu() if staged else send).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        recv = recv.to(x.device)
    chunks = [c.movedim(0, split_axis) for c in recv.unbind(0)]
    return torch.cat(chunks, dim=concat_axis)


def _gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    n = _size(group)
    with _recorded("all-gather", n * _nbytes(x), group):
        if _dry(x, group):
            shape = list(x.shape)
            shape[axis] *= n
            return x.new_empty(shape)
        return _gathered(x, group, axis, n)


def _gathered(x: torch.Tensor, group, axis: int, n: int) -> torch.Tensor:
    staged = _staged(x, group)
    send = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(parts, send, group=group)
    out = torch.cat(parts, dim=axis)
    return out.to(x.device) if staged else out


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(x.contiguous(), group)


def _scatter_sum(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    n = _size(group)
    if x.shape[axis] % n:
        raise ValueError(f"psum_scatter: axis {axis} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    block = x.shape[axis] // n
    return _sum(x, group).narrow(axis, _rank(group) * block,
                                 block).contiguous()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _a2a(g, group, concat_axis, split_axis), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.args = (group, axis)
        return _gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        group, axis = ctx.args
        return _scatter_sum(g, group, axis), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.args = (group, axis)
        return _scatter_sum(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        group, axis = ctx.args
        return _gather(g, group, axis), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group) / _size(group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group) / _size(ctx.group), None


def _one(group) -> bool:
    return _size(group) == 1


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int
               ) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    over ``group``."""
    if _one(group):
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis_name, axis=axis, tiled=True)``."""
    if _one(group):
        return x
    return _AllGather.apply(x, group, axis)


def psum_scatter(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis_name, scatter_dimension=axis,
    tiled=True)``."""
    if _one(group):
        return x
    return _PsumScatter.apply(x, group, axis)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.psum(x, axis_name)``; its backward is the sum."""
    if _one(group):
        return x
    return _Psum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated input entering a tensor-parallel island: identity
    forward, the gradient summed over ``group`` backward."""
    if _one(group):
        return x
    return _CopyTo.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """A partial output leaving the island: summed over ``group`` forward,
    the gradient passed through backward."""
    if _one(group):
        return x
    return _ReduceFrom.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over ``group``; backward, the mean of the gradients (each
    rank's loss reads the same mean)."""
    if _one(group):
        return x
    return _Pmean.apply(x, group)


def average_gradients(grads, group):
    """The mean over ``group`` of every leaf of a gradient tree (nested
    dicts and lists), in place: one all-reduce per leaf in the tree's
    order, so no second copy of the tree is held on the device.  Returns
    the tree."""
    from repro_torch.optim.adamw import tree_leaves

    n = _size(group)
    if n == 1:
        return grads
    for g in tree_leaves(grads):
        with _recorded("all-reduce", _nbytes(g), group):
            if _dry(g, group):
                pass
            elif _staged(g, group):
                host = g.cpu()
                dist.all_reduce(host, group=group)
                g.copy_(host)
            else:
                dist.all_reduce(g, group=group)
        g.div_(n)
    return grads
