"""Dry run on the meta device: every (arch x shape) cell's per-device
bytes on the production mesh, with nothing allocated.

Counterpart of the part of ``repro/launch/dryrun.py`` that exists outside
XLA.  For each cell it builds the shapes the step would hold, on
``torch.device("meta")``: the parameters, and for a training shape the
AdamW moments and the step counter, for a decode shape the cache at the
shape's batch and length; applies the port's sharding rules
(``TRAIN_RULES``, or ``DECODE_RULES`` for decode, whose cache is
sequence-sharded; the cache's non-divisible dims replicated, as
``shardings_for_shapes`` prunes them) over the mesh at ``tp`` = its
``model`` size, and reports each group's bytes on one device.

Each record also carries the cell's ``model_flops`` (6·N·T·B to train,
2·N·T·B to prefill, 2·N·B to decode, N the active parameter count: what
an MFU divides by) and its ``variant``: the performance flags applied to
the config before anything is built (:func:`apply_variant`; ``--set
key=value``, repeatable: ``precast_params``, ``seq_parallel``,
``fused_gate_up`` as 0 or 1, MoE's ``capacity_factor`` as a float).
``fused_gate_up`` stacks MoE's gate and up weights into one ``w_in``
leaf, so the parameter bytes and ``param_leaves`` are those of the
layout the variant builds.

Out of scope, with no PyTorch counterpart: the reference's
``memory_analysis`` (XLA's buffer assignment, activations included),
``cost_analysis`` (HLO FLOPs and bytes) and the parsing of collectives
from SPMD-partitioned HLO.

Usage:
  python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out FILE]
  python -m repro_torch.launch.dryrun --arch deepseek-moe-16b \
      --shape train_4k --set fused_gate_up=1 --set capacity_factor=2.0
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import REGISTRY, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec, get_shape, shapes_for
from repro_torch.distributed.sharding import (DECODE_RULES, TRAIN_RULES,
                                              shardings_for,
                                              shardings_for_shapes)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import adamw_init, tree_leaves
from repro_torch.train.step import train_state_axes


def _leaves(tree: Any) -> List[Any]:
    """Leaves of nested dicts in key order (a tuple is a leaf)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def device_bytes(t: torch.Tensor, placements: Tuple[Any, ...], mesh) -> int:
    """Bytes of ``t``'s block on one device under DTensor ``placements``
    (each sharded dim split evenly, rounded up)."""
    from torch.distributed.tensor import Shard

    shape = list(t.shape)
    for size, pl in zip(tuple(mesh.shape), placements):
        if isinstance(pl, Shard):
            shape[pl.dim] = -(-shape[pl.dim] // size)
    n = 1
    for d in shape:
        n *= d
    return n * t.element_size()


def tree_bytes(shapes: Any, placements: Any, mesh) -> int:
    return sum(device_bytes(t, p, mesh)
               for t, p in zip(_leaves(shapes), _leaves(placements)))


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """The cell's useful FLOPs: 6·N·T·B to train, 2·N·T·B to prefill,
    2·N·B for one decode step, N = the active parameter count."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch


def apply_variant(cfg: ArchConfig, variant: Optional[Dict] = None) -> ArchConfig:
    """``cfg`` with the performance flags of ``variant`` set: the config's
    own fields (``precast_params``, ``seq_parallel``, ``fused_gate_up``)
    and MoE's ``capacity_factor`` (ignored for a config without MoE).
    A key that is no field of the config raises ``TypeError``, by name."""
    if not variant:
        return cfg
    kw = dict(variant)
    cf = kw.pop("capacity_factor", None)
    if cf is not None and cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, capacity_factor=float(cf))
    return dataclasses.replace(cfg, **kw)


def parse_set(pairs: List[str]) -> Dict[str, Any]:
    """``--set key=value`` pairs as a variant: a float for
    ``capacity_factor``, ``bool(int(value))`` for every other key."""
    variant: Dict[str, Any] = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        variant[k] = float(v) if k == "capacity_factor" else bool(int(v))
    return variant


def meta_cell(arch: str, shape_name: str, mesh,
              variant: Optional[Dict] = None) -> Dict[str, Any]:
    """One cell's per-device bytes (params, optimizer state, cache) for
    the config with ``variant`` applied, its model FLOPs and variant."""
    shape = get_shape(shape_name)
    base = apply_variant(get_config(arch), variant)
    cfg = base.with_tp(mesh.axis_size("model"))
    model = get_model(cfg)
    params = model.param_shapes(cfg)
    rules = DECODE_RULES if shape.kind == "decode" else TRAIN_RULES
    p_shard = shardings_for(model.param_axes(cfg), rules, mesh)
    leaves = tree_leaves(params)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(s) for s in mesh.shape), "kind": shape.kind,
           "variant": dict(variant or {}),
           "model_flops": model_flops(base, shape),
           "param_leaves": len(leaves),
           "param_bytes_per_device": tree_bytes(params, p_shard, mesh),
           "param_bytes_total": sum(t.numel() * t.element_size()
                                    for t in leaves)}
    if shape.kind == "train":
        opt = adamw_init(params)
        axes = train_state_axes(cfg, model)
        o_shard = shardings_for(axes["opt"], rules, mesh)
        rec["opt_bytes_per_device"] = tree_bytes(opt, o_shard, mesh)
        rec["step_bytes_per_device"] = 4
    elif shape.kind == "decode":
        cache = model.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device="meta")
        c_shard = shardings_for_shapes(model.cache_axes(cfg), cache, rules,
                                       mesh)
        rec["cache_bytes_per_device"] = tree_bytes(cache, c_shard, mesh)
    rec["total_bytes_per_device"] = sum(
        v for k, v in rec.items() if k.endswith("_per_device"))
    return rec


def all_cells() -> List[Tuple[str, str]]:
    return [(arch, shape.name) for arch, cfg in sorted(REGISTRY.items())
            for shape in shapes_for(cfg.family)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None, help="write the records here too")
    ap.add_argument("--set", action="append", default=[],
                    help="variant flag key=value (e.g. precast_params=1)")
    args = ap.parse_args(argv)
    variant = parse_set(args.set)
    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape required unless --all")
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    records = [meta_cell(arch, shape, mesh, variant) for arch, shape in cells]
    for r in records:
        print(json.dumps(r))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    return records


if __name__ == "__main__":
    main()
