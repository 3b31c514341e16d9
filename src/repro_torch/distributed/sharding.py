"""Logical-axis -> mesh-axis sharding rules (DP/TP/EP/SP + pod axis).

Counterpart of ``repro/distributed/sharding.py``, with the same rules.
Models annotate every parameter and cache dim with a *logical* name
(``models/layers.py`` ``LeafSpec.axes``); this module maps those names
onto the production mesh:

  batch        -> (pod, data)      data parallelism, hierarchical over pods
  heads_dh     -> model            attention TP (heads padded to TP degree)
  kv_heads_dh  -> model            KV heads sharded when divisible ...
  kv_heads_rep -> None             ... replicated otherwise (GQA kv=4)
  d_ff         -> model            FFN TP (column/row parallel pairs)
  d_expert     -> model            TP-inside-experts
  vocab        -> model            embedding + logits sharded
  kv_seq       -> model            decode KV cache sharded along SEQUENCE
  layers       -> None             scan dim (stacked params)

A partition spec is :class:`PartitionSpec` (alias ``P``): a tuple with one
entry per tensor dim, each ``None``, a mesh axis name or a tuple of names,
equal as a tuple to the reference's ``jax.sharding.PartitionSpec`` (a
tuple of one name reads as that name, as in JAX).
Unknown logical names fail loudly rather than silently replicating.

The functions read only a mesh's axis names and sizes: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``,
``shape``) serves, and so does :class:`AxisMesh`, which needs no process
group.  :func:`shardings_for` gives, per leaf, the DTensor placements
over the mesh's dims: ``Shard(d)`` where tensor dim ``d`` names that mesh
axis, else ``Replicate()``.  A dim split over several mesh axes is split
in the mesh's order (the first axis major), as JAX's ``NamedSharding``
splits it in the entry's order; an entry that names its axes out of the
mesh's order is refused, since DTensor cannot express it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["AxisMesh", "DECODE_RULES", "P", "PartitionSpec", "ShardingRules",
           "TRAIN_RULES", "fit_spec", "placements_for", "shardings_for",
           "shardings_for_shapes", "specs_from_axes"]


def _canonical(entry: Any) -> Any:
    """An entry as JAX's ``PartitionSpec`` keeps it: a tuple of one name
    is that name, an empty tuple is ``None``."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name or a tuple of
    names (canonical as in JAX: ``("data",)`` is ``"data"``).  Dims past
    the entries are replicated."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AxisMesh:
    """A mesh's axis names and sizes, as a ``DeviceMesh`` gives them
    (``mesh_dim_names``, ``shape``), without devices or a process group."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def _axes(mesh: Any) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: Dict[str, Any]

    def spec_for(self, axes: Tuple[Optional[str], ...]) -> PartitionSpec:
        entries = []
        for name in axes:
            if name is None:
                entries.append(None)
                continue
            if name not in self.rules:
                raise KeyError(f"no sharding rule for logical axis {name!r}")
            entries.append(self.rules[name])
        return P(*entries)


_COMMON = {
    "batch": ("pod", "data"),
    "layers": None,
    "d_model": None,
    "d_model2": None,
    "vocab": "model",
    "heads_dh": "model",
    "heads": "model",
    "kv_heads_dh": "model",
    "kv_heads_rep": None,
    "d_ff": "model",
    "q_lora": None,
    "kv_lora": None,
    "experts": None,           # expert-stacked dim replicated ...
    "d_expert": "model",       # ... hidden dim sharded (TP-inside-experts)
    "experts_router": None,
}

TRAIN_RULES = ShardingRules({**_COMMON, "kv_seq": None})
# decode: KV cache sequence-sharded over `model` => flash-decoding combine
DECODE_RULES = ShardingRules({**_COMMON, "kv_seq": "model"})


def _map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts and lists, a tuple being a
    leaf (axes and specs are tuples), with the matching leaves of
    ``rest``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _strip_pod(spec: PartitionSpec, mesh: Any) -> PartitionSpec:
    """Drop mesh axes the current mesh doesn't have (single-pod mode)."""
    names = set(_axes(mesh))
    entries = []
    for e in spec:
        if e is None:
            entries.append(None)
        elif isinstance(e, tuple):
            kept = tuple(a for a in e if a in names)
            entries.append(kept if kept else None)
        else:
            entries.append(e if e in names else None)
    return P(*entries)


def specs_from_axes(axes_tree: Any, rules: ShardingRules, mesh: Any) -> Any:
    """Tree of logical-axis tuples -> tree of partition specs."""
    return _map(lambda axes: _strip_pod(rules.spec_for(tuple(axes)), mesh),
                axes_tree)


def _axis_size(mesh: Any, entry: Any) -> int:
    if entry is None:
        return 1
    sizes = _axes(mesh)
    size = 1
    for n in entry if isinstance(entry, tuple) else (entry,):
        size *= sizes[n]
    return size


def fit_spec(spec: PartitionSpec, shape: Tuple[int, ...], mesh: Any
             ) -> PartitionSpec:
    """Replicate dims whose size is not divisible by the assigned mesh
    axes (e.g. global_batch=1 on a 16-way data axis: long_500k decode)."""
    entries = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is not None and dim % _axis_size(mesh, entry) != 0:
            entry = None
        entries.append(entry)
    return P(*entries)


def placements_for(spec: PartitionSpec, mesh: Any) -> Tuple[Any, ...]:
    """The DTensor placements over the mesh's dims that shard a tensor as
    ``spec`` does: ``Shard(d)`` on each mesh axis tensor dim ``d`` names,
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(_axes(mesh))
    placements: List[Any] = [Replicate()] * len(order)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        idx = [order.index(n) for n in names]
        if idx != sorted(idx):
            raise ValueError(f"entry {entry!r} names its mesh axes out of the "
                             f"mesh's order {tuple(order)}: DTensor splits a "
                             "dim over mesh dims in the mesh's order")
        for i in idx:
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"mesh axis {order[i]!r} shards two dims of "
                                 f"{spec!r}")
            placements[i] = Shard(dim)
    return tuple(placements)


def shardings_for(axes_tree: Any, rules: ShardingRules, mesh: Any) -> Any:
    """Tree of logical-axis tuples -> tree of DTensor placements."""
    return _map(lambda s: placements_for(s, mesh),
                specs_from_axes(axes_tree, rules, mesh))


def shardings_for_shapes(axes_tree: Any, shapes_tree: Any, rules: ShardingRules,
                         mesh: Any) -> Any:
    """Shape-aware variant: prunes non-divisible axis assignments."""
    return _map(lambda s, shp: placements_for(fit_spec(s, tuple(shp.shape), mesh),
                                              mesh),
                specs_from_axes(axes_tree, rules, mesh), shapes_tree)
