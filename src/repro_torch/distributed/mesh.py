"""A mesh in the port: the ranks of a ``torch.distributed`` world on a
named grid.

Where the reference's ``jax.sharding.Mesh`` lays devices out on named
axes, :class:`Mesh` lays out process ranks: ``ranks`` is an integer array
of the mesh's shape (by default ``arange(size)`` in row-major order, the
first axis major).  A JAX island (a ``shard_map`` body) becomes the body
each rank runs on its own shards; a collective over a mesh axis becomes a
collective over that axis's process group (:meth:`Mesh.group`: the ranks
that share this rank's coordinates on every other axis).  A rank's
coordinate along an axis is its index in that group, which is JAX's
``axis_index``.

A dry mesh (:meth:`Mesh.dry_run`) is the same grid seen from its first
rank, with no world at all: its groups are :class:`DryGroup` records of
the axis's members, and the collectives of
:mod:`repro_torch.distributed.collectives` on meta tensors record
themselves there and return meta results (the dry run's step on the meta
device, :mod:`repro_torch.launch.dryrun`).

Building a mesh touches no process group; the groups are made at first
use, each once per process for its set of ranks
(``use_local_synchronization``: only the members take part, so a mesh
over part of the world, a module of :mod:`repro_torch.core.offload`,
needs nothing of the other ranks).  The sharding functions of
:mod:`repro_torch.distributed.sharding` read a mesh through
``mesh_dim_names`` and ``shape``, as they read a ``DeviceMesh``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DATA_AXES", "MODEL_AXIS", "DryGroup", "Mesh"]

DATA_AXES = ("pod", "data")
MODEL_AXIS = "model"

# one process group per set of ranks, made once in this process
_GROUPS: Dict[Tuple[int, ...], object] = {}

Axes = Union[str, Sequence[str]]


class DryGroup:
    """A record-only group: the global ranks of one axis group of a dry
    mesh, and the viewing rank's place among them.  It makes no process
    group and moves nothing."""

    def __init__(self, members: Sequence[int], rank: int):
        self.members = tuple(members)
        self._rank = rank

    def size(self) -> int:
        return len(self.members)

    def rank(self) -> int:
        return self._rank

    def __repr__(self) -> str:
        return f"DryGroup({self.members}, rank={self._rank})"


class Mesh:
    """Ranks on a named grid: ``shape`` and ``axis_names`` as in JAX's
    ``jax.make_mesh(shape, axis_names)``, ``ranks`` the global rank at
    each grid point; ``dry`` for :meth:`dry_run`'s view."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 ranks: Optional[np.ndarray] = None, dry: bool = False):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} does not match axes "
                             f"{self.axis_names}")
        if ranks is None:
            ranks = np.arange(int(np.prod(self.shape))).reshape(self.shape)
        self.ranks = np.asarray(ranks, dtype=np.int64)
        if self.ranks.shape != self.shape:
            raise ValueError(f"ranks {self.ranks.shape} do not match shape "
                             f"{self.shape}")
        self.dry = dry

    def dry_run(self) -> "Mesh":
        """This grid as its first rank sees it, with no world: coordinates
        are that rank's and :meth:`group` gives :class:`DryGroup` records."""
        return Mesh(self.shape, self.axis_names, self.ranks, dry=True)

    # the names ``sharding`` reads, as a DeviceMesh gives them
    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self.axis_names

    @property
    def shape_tuple(self) -> Tuple[Tuple[str, int], ...]:
        """``((name, size), ...)``, as JAX's ``Mesh.shape_tuple``."""
        return tuple(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape_tuple)})"

    def _names(self, axes: Axes) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in names if a in self.axis_names)

    def axis_size(self, axes: Axes) -> int:
        """The product of the named axes' sizes (axes the mesh lacks count
        1, as the reference's ``_strip_pod`` drops them)."""
        return int(np.prod([self.shape[self.axis_names.index(a)]
                            for a in self._names(axes)], dtype=np.int64))

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Axis name -> ``rank``'s coordinate (this process's rank when
        None; a dry mesh's first rank)."""
        if rank is None:
            rank = int(self.ranks.flat[0]) if self.dry else dist.get_rank()
        at = np.argwhere(self.ranks == rank)
        if not len(at):
            raise ValueError(f"rank {rank} is not in {self}")
        return dict(zip(self.axis_names, (int(c) for c in at[0])))

    def __contains__(self, rank: int) -> bool:
        return bool((self.ranks == rank).any())

    def index(self, axes: Axes, rank: Optional[int] = None) -> int:
        """This rank's index along ``axes`` (several axes: mixed radix, the
        first named major), JAX's ``axis_index``."""
        c = self.coords(rank)
        i = 0
        for a in self._names(axes):
            i = i * self.shape[self.axis_names.index(a)] + c[a]
        return i

    def group_ranks(self, axes: Axes, rank: Optional[int] = None
                    ) -> Tuple[int, ...]:
        """The global ranks that differ from ``rank`` only along ``axes``,
        in the order of their index along ``axes``."""
        names = self._names(axes)
        c = self.coords(rank)
        take = tuple(slice(None) if a in names else c[a]
                     for a in self.axis_names)
        sub = self.ranks[take]
        # the kept axes, in the order ``axes`` names them
        kept = [a for a in self.axis_names if a in names]
        sub = np.transpose(sub, [kept.index(a) for a in names])
        return tuple(int(r) for r in sub.reshape(-1))

    def group(self, axes: Axes):
        """The process group over ``axes`` that holds this rank (made at
        first use; the default group when it is the whole world); on a dry
        mesh, its :class:`DryGroup`."""
        members = self.group_ranks(axes)
        if self.dry:
            return DryGroup(members, members.index(int(self.ranks.flat[0])))
        if members == tuple(range(dist.get_world_size())):
            return dist.group.WORLD
        if members not in _GROUPS:
            _GROUPS[members] = dist.new_group(list(members),
                                              use_local_synchronization=True)
        return _GROUPS[members]

    def sub(self, axis: str, start: int, stop: int) -> "Mesh":
        """The rows ``start:stop`` along ``axis``, with every axis kept."""
        take = [slice(None)] * len(self.shape)
        take[self.axis_names.index(axis)] = slice(start, stop)
        ranks = self.ranks[tuple(take)]
        return Mesh(ranks.shape, self.axis_names, ranks, dry=self.dry)

    def shard_rows(self, x: torch.Tensor, axes: Axes = DATA_AXES,
                   dim: int = 0) -> torch.Tensor:
        """This rank's shard of ``x`` along ``dim`` over ``axes`` (the
        data-parallel batch by default).  An uneven split is refused: a
        mean over unequal shards is not the global mean."""
        n = self.axis_size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"a dim of {x.shape[dim]} does not split evenly "
                             f"over {n} ranks of {self._names(axes)}: refused, "
                             "since unequal shards break the mean")
        size = x.shape[dim] // n
        return x.narrow(dim, self.index(axes) * size, size)

    def block(self, w: torch.Tensor, dim: int, full: int,
              axes: Axes = MODEL_AXIS) -> torch.Tensor:
        """This rank's block of ``w`` along ``dim`` over ``axes``: a view
        of the block when ``w`` is whole (``full`` long), ``w`` itself
        when it already is the block."""
        n = self.axis_size(axes)
        if n == 1:
            return w
        if full % n:
            raise ValueError(f"a dim of {full} does not split over {n} ranks "
                             f"of {self._names(axes)}")
        if w.shape[dim] == full:
            return w.narrow(dim, self.index(axes) * (full // n), full // n)
        if w.shape[dim] * n != full:
            raise ValueError(f"dim {dim} of {tuple(w.shape)} is neither "
                             f"{full} nor its block over {n} ranks")
        return w

    def local_tree(self, tree, axes_tree, names, axes: Axes = MODEL_AXIS):
        """This rank's copy of a parameter tree whose leaves shard over
        ``axes`` where their logical axis is in ``names`` (each such leaf
        its own contiguous block, the others as they are): what a rank of
        a tensor-parallel island holds."""
        if isinstance(tree, dict):
            return {k: self.local_tree(v, axes_tree[k], names, axes)
                    for k, v in tree.items()}
        out = tree
        for dim, name in enumerate(axes_tree):
            if name in names:
                out = self.block(out, dim, tree.shape[dim], axes)
        return out if out is tree else out.clone(memory_format=torch.contiguous_format)
