"""Cluster<->Booster offload over mesh sub-grids (DEEP-ER §III-A/B).

Counterpart of ``repro/core/offload.py``.  The Cluster-Booster
architecture lets an application split itself across two heterogeneous
modules joined by one fabric: xPic runs its field solver on the Cluster
and offloads the particle solver to the Booster.  DEEP-ER does it with
``MPI_Comm_spawn`` and the OmpSs offload pragma; the reference uses
device sub-grids of one JAX mesh.

The design here: a module is a set of **process ranks** of one
``torch.distributed`` world, a sub-grid of a :class:`Mesh` of ranks
(:func:`split_mesh`: the leading rows along ``axis`` form the CLUSTER,
the rest the BOOSTER), and every rank of the world runs the same program
(SPMD), each with its own device (``OffloadEngine(device=...)``: on one
H100, a CPU rank is the Cluster and a rank on the card the Booster).

* A value on a module is a :class:`Placed`: each member rank holds its
  block of the global value as ``spec`` shards it over the module's
  sub-grid (``P()``: the whole value on every member); the other ranks
  hold ``local = None``.
* ``offload(fn, target, *args, in_specs, out_specs)`` places each input
  on the target module per its spec: the fabric hop, point to point from
  the source module's first rank to each member, carrying only that
  member's block (a plain tensor argument is a value the ranks outside
  the target hold whole; :meth:`OffloadEngine.put` makes a value on the
  module that holds it; a :class:`Placed` already on the target with the
  same spec does not move).  ``fn`` then runs with global semantics: each
  member assembles the whole inputs from the module's blocks and calls
  ``fn`` on them (every member computes the same whole result, which
  holds for any ``fn``; no part of the work is split), and keeps its
  block of each output per ``out_specs`` (``P()`` when None).  The
  outputs stay on the target, so chained offloads do not bounce back
  through the source.
* ``gather(result, target, spec)`` is the return hop.
* The cache of prepared functions is keyed as the reference's compiled
  cache, ``(fn, target, mesh.shape_tuple)``: the first call's
  ``out_specs`` and ``donate`` stay with the key, as the jitted function
  does.  The target's received copies are dropped once ``fn`` has run;
  ``donate=True`` also releases every :class:`Placed` input (its blocks
  are dropped and using it again raises, as a donated JAX buffer does).

Every rank of the world must call ``offload`` and ``gather`` in the same
order.  Tensors cross between ranks over the world group (gloo carries
a card tensor through a host buffer); ``fabric`` counts this rank's hop
bytes and seconds.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.cluster.topology import Module
from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import P, PartitionSpec

__all__ = ["ModuleMesh", "OffloadEngine", "Placed", "split_mesh"]

_DTYPES = [torch.float32, torch.float64, torch.bfloat16, torch.float16,
           torch.int32, torch.int64, torch.int8, torch.uint8, torch.bool]
_HEADER = 10     # dtype, ndim and up to 8 dims


@dataclasses.dataclass
class ModuleMesh:
    """A module's slice of the global rank grid."""

    module: Module
    mesh: Mesh


def split_mesh(mesh: Mesh, n_cluster_rows: int, axis: str = "data"
               ) -> Dict[Module, ModuleMesh]:
    """Partition a mesh along ``axis`` into CLUSTER and BOOSTER sub-meshes:
    the leading ``n_cluster_rows`` slices along ``axis`` become the Cluster
    module, the rest the Booster (the prototype's 16 + 8 split)."""
    n_total = mesh.shape[mesh.axis_names.index(axis)]
    if not (0 < n_cluster_rows < n_total):
        raise ValueError(f"need 0 < n_cluster_rows < {n_total}")
    return {
        Module.CLUSTER: ModuleMesh(Module.CLUSTER,
                                   mesh.sub(axis, 0, n_cluster_rows)),
        Module.BOOSTER: ModuleMesh(Module.BOOSTER,
                                   mesh.sub(axis, n_cluster_rows, n_total)),
    }


@dataclasses.dataclass
class Placed:
    """A global value on a module: ``local`` is this rank's block (None
    off the module), ``spec`` how the blocks shard it over the module's
    sub-grid."""

    module: ModuleMesh
    spec: PartitionSpec
    local: Optional[torch.Tensor]
    shape: Optional[Tuple[int, ...]] = None
    deleted: bool = False

    def ranks(self) -> set:
        """The ranks that hold a block: the module's."""
        return set(int(r) for r in self.module.mesh.ranks.flat)

    @property
    def value(self) -> torch.Tensor:
        """This rank's block (the whole value for ``P()``)."""
        if self.deleted:
            raise RuntimeError("this value was donated to an offload")
        if self.local is None:
            raise RuntimeError(f"rank {dist.get_rank()} holds no block of a "
                               f"value on the {self.module.module.value}")
        return self.local


def _block_slices(shape: Sequence[int], spec: PartitionSpec, mesh: Mesh,
                  rank: int) -> Tuple[slice, ...]:
    """The slices of ``rank``'s block of a ``shape`` value sharded by
    ``spec`` over ``mesh`` (a dim over several axes: the first major)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(slice(None))
            continue
        n = mesh.axis_size(entry)
        if dim % n:
            raise ValueError(f"a dim of {dim} does not split over {n} ranks "
                             f"of {entry!r}")
        i = mesh.index(entry, rank)
        out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(out)


def _header(t: torch.Tensor) -> torch.Tensor:
    if t.dim() > _HEADER - 2:
        raise ValueError(f"offload moves tensors of at most {_HEADER - 2} dims")
    h = torch.zeros(_HEADER, dtype=torch.int64)
    h[0], h[1] = _DTYPES.index(t.dtype), t.dim()
    h[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    return h


class OffloadEngine:
    """Spawn-like offload of functions onto a module sub-grid of ranks;
    ``device`` is where this rank keeps the blocks it receives: the card
    unless the caller asks for the CPU, as every entry point of the port."""

    def __init__(self, modules: Dict[Module, ModuleMesh], device="cuda"):
        self.modules = modules
        self.device = torch.device(device)
        self._cache: Dict[Tuple, Any] = {}
        self.fabric = {"bytes_sent": 0, "bytes_received": 0, "seconds": 0.0,
                       "hops": 0}

    # -- transport --------------------------------------------------------- #

    def _send(self, t: torch.Tensor, dst: int) -> None:
        t0 = time.perf_counter()
        host = t.detach().cpu().contiguous()
        dist.send(_header(host), dst)
        dist.send(host, dst)
        self.fabric["bytes_sent"] += host.numel() * host.element_size()
        self.fabric["seconds"] += time.perf_counter() - t0

    def _recv(self, src: int) -> torch.Tensor:
        t0 = time.perf_counter()
        h = torch.empty(_HEADER, dtype=torch.int64)
        dist.recv(h, src)
        shape = tuple(int(d) for d in h[2:2 + int(h[1])])
        host = torch.empty(shape, dtype=_DTYPES[int(h[0])])
        dist.recv(host, src)
        out = host.to(self.device)
        self.fabric["bytes_received"] += host.numel() * host.element_size()
        self.fabric["seconds"] += time.perf_counter() - t0
        return out

    # -- placement --------------------------------------------------------- #

    def _whole_at_leader(self, x: Placed) -> Optional[torch.Tensor]:
        """The whole value of ``x`` on the first rank of its module (None
        elsewhere): the members' blocks sent to it and put in place."""
        mesh, me = x.module.mesh, dist.get_rank()
        ranks = [int(r) for r in mesh.ranks.flat]
        leader = ranks[0]
        if all(e is None for e in x.spec):      # every member holds it whole
            return x.value if me == leader else None
        if me != leader:
            if me in ranks:
                dist.send(x.value.detach().cpu().contiguous(), leader)
            return None
        whole = torch.empty(x.shape, dtype=x.value.dtype)
        for r in ranks:
            sl = _block_slices(x.shape, x.spec, mesh, r)
            if r == leader:
                whole[sl] = x.value.cpu()
            else:
                part = torch.empty(whole[sl].shape, dtype=whole.dtype)
                dist.recv(part, r)
                whole[sl] = part
        return whole

    def _place(self, a: Any, mm: ModuleMesh, spec: PartitionSpec) -> Placed:
        """``a`` on module ``mm`` per ``spec`` (the fabric hop)."""
        spec = P(*spec)
        if isinstance(a, Placed):
            if a.deleted:
                raise RuntimeError("this value was donated to an offload")
            if a.module.mesh is mm.mesh:     # on the target: re-blocked there
                if tuple(a.spec) == tuple(spec):
                    return a
                if dist.get_rank() not in mm.mesh:
                    return Placed(mm, spec, None, a.shape)
                return self.put(self._assemble(a), mm.module, spec)
            src_ranks = [int(r) for r in a.module.mesh.ranks.flat]
            whole = self._whole_at_leader(a)
        else:
            src_ranks = [r for r in range(dist.get_world_size())
                         if r not in mm.mesh]
            whole = a if dist.get_rank() in src_ranks else None
        me = dist.get_rank()
        members = [int(r) for r in mm.mesh.ranks.flat]
        if not src_ranks:        # every rank is on the target: no hop
            return self.put(a, mm.module, spec)
        leader = src_ranks[0]
        self.fabric["hops"] += 1
        if me == leader:
            for r in members:
                self._send(whole[_block_slices(whole.shape, spec, mm.mesh, r)],
                           r)
            return Placed(mm, spec, None, tuple(whole.shape))
        if me in members:
            local = self._recv(leader)
            shape = tuple(d * mm.mesh.axis_size(e) if e is not None else d
                          for d, e in zip(local.shape, tuple(spec) + (None,)
                                          * (local.dim() - len(spec))))
            return Placed(mm, spec, local, shape)
        return Placed(mm, spec, None)

    def _assemble(self, x: Placed) -> torch.Tensor:
        """The whole value of ``x`` on each member: the blocks all-gathered
        over the module and put in place."""
        if all(e is None for e in x.spec):
            return x.value
        mesh = x.module.mesh
        ranks = [int(r) for r in mesh.ranks.flat]
        group = mesh.group(mesh.axis_names)
        blk = x.value.detach()
        host = blk.cpu().contiguous() if dist.get_backend(group) == "gloo" \
            else blk.contiguous()
        parts = [torch.empty_like(host) for _ in ranks]
        dist.all_gather(parts, host, group=group)
        whole = torch.empty(x.shape, dtype=blk.dtype, device=host.device)
        for r, part in zip(sorted(ranks), parts):
            whole[_block_slices(x.shape, x.spec, mesh, r)] = part
        return whole.to(blk.device)

    def put(self, x: torch.Tensor, target: Module,
            spec: PartitionSpec = P()) -> Placed:
        """``x``, which every rank of ``target`` holds whole (it was made
        there), as a value on that module: each member keeps its block,
        nothing moves."""
        mm = self.modules[target]
        me = dist.get_rank()
        if me not in mm.mesh:
            return Placed(mm, P(*spec), None)
        local = x[_block_slices(x.shape, spec, mm.mesh, me)].to(self.device)
        return Placed(mm, P(*spec), local, tuple(x.shape))

    # -- the reference's surface ------------------------------------------ #

    def offload(
        self,
        fn: Callable[..., Any],
        target: Module,
        *args: Any,
        in_specs: Optional[Sequence[PartitionSpec]] = None,
        out_specs: Optional[Any] = None,
        donate: bool = False,
    ) -> Any:
        """Run ``fn(*args)`` on the target module's sub-grid.  Inputs are
        placed on it per ``in_specs`` (the Cluster -> Booster transfer);
        outputs stay there as :class:`Placed` values per ``out_specs`` (a
        spec, or one per output)."""
        mm = self.modules[target]
        in_specs = list(in_specs or [P()] * len(args))
        placed = [self._place(a, mm, s) for a, s in zip(args, in_specs)]
        key = (fn, target, mm.mesh.shape_tuple)
        prepared = self._cache.get(key)
        if prepared is None:
            prepared = (fn, out_specs, donate)
            self._cache[key] = prepared
        fn, out_specs, donate = prepared
        me = dist.get_rank()
        members = [int(r) for r in mm.mesh.ranks.flat]
        meta: List[Any] = [None]
        if me in members:
            out = fn(*[self._assemble(p) for p in placed])
            single = isinstance(out, torch.Tensor)
            outs = (out,) if single else tuple(out)
            specs = (out_specs if isinstance(out_specs, (list, tuple))
                     and not isinstance(out_specs, PartitionSpec)
                     else [out_specs] * len(outs))
            result = [Placed(mm, P(*(s if s is not None else P())),
                             o[_block_slices(o.shape, s or P(), mm.mesh, me)],
                             tuple(o.shape)) for o, s in zip(outs, specs)]
            meta = [(single, len(outs))]
        dist.broadcast_object_list(meta, src=members[0])
        single, n_out = meta[0]
        if me not in members:
            result = [Placed(mm, P(), None) for _ in range(n_out)]
        for a, p in zip(args, placed):
            if p is not a:
                p.local = None          # the received copy
            if donate and isinstance(a, Placed):
                a.local, a.deleted = None, True
        return result[0] if single else tuple(result)

    def gather(self, module_result: Any, target: Module,
               spec: PartitionSpec = P()) -> Any:
        """Bring a result back to another module (the return fabric hop)."""
        if isinstance(module_result, (tuple, list)):
            return type(module_result)(self.gather(r, target, spec)
                                       for r in module_result)
        return self._place(module_result, self.modules[target], spec)
