"""Dry run on the meta device: every (arch x shape) cell's per-device
bytes, FLOPs, memory and collectives on the production mesh, with nothing
allocated.

Counterpart of ``repro/launch/dryrun.py``.  For each cell
:func:`lower_cell` builds, at full width and depth on
``torch.device("meta")``, the step the port itself runs for the shape's
kind: ``make_train_step`` with ``remat=True`` and the reference's
micro-batches (per-device batch / 2), ``make_prefill_step``, or the
decode step over the model's cache; it runs that step once, from the
first rank's view of the mesh (:meth:`Mesh.dry_run`), under a
:class:`CostCounter`.  The kernels take their shape rule on meta
(:mod:`repro_torch.kernels.ops`): the outputs, what their autograd
functions save and the workspaces the card's wrappers allocate, never the
plain body.

The counter counts:

* ``flops``: each aten operator's by torch's own formulas (the registry
  of ``torch.utils.flop_counter``: matmuls, convolutions, attention;
  elementwise operators count 0), plus each kernel call's declared work;
* ``bytes``: each aten operator's tensor operands plus its outputs (views,
  allocations and metadata operators 0), plus each kernel call's declared
  bytes (:mod:`repro_torch.kernels.work`: inputs read once, outputs
  written once).  Operators inside a kernel call or a collective are not
  counted again;
* ``kernels``: ``{name: {calls, flops, bytes}}`` per kernel function,
  once per call whatever its CUDA launches;
* ``collectives``: ``{kind: {count, bytes}}``, the port's own collectives
  (:mod:`repro_torch.distributed.collectives`) at the ring model's
  per-device bytes (:func:`collective_bytes`);
* ``memory``: ``argument_size_in_bytes`` (the step's inputs),
  ``output_size_in_bytes`` (its outputs not among them) and
  ``temp_size_in_bytes``: the peak, over the step, of the storages made
  during it and still referenced (outputs included while they live),
  which is what ``torch.cuda.max_memory_allocated`` over the step, less
  what was held before it, reads on the card.

What the count is not.  Eager PyTorch runs every layer, so there is no
unrolled-scan correction as in the reference's cost analysis, and no
fusion: ``bytes`` is each operator's operands and outputs, not the HBM
traffic a cache sees (a fused XLA program reads far less).  The
collectives are the port's own mesh paths (data-parallel training with
whole parameters on every rank, MoE's expert island over ``model``,
Ulysses prefill under ``seq_parallel``), not GSPMD's partitioning, so a
dense cell's ``model`` axis moves nothing and each rank holds the whole
state: ``memory`` is that, while ``*_bytes_per_device`` are the sharding
rules' layout.  The decode step has no mesh path: rank 0 serves its
ceil(B / data ranks) rows alone.  The paged kernels' work counts every
table entry (:func:`repro_torch.kernels.work.paged`).  A cell the port has
no path for gets ``ok: false`` with the error.

Each record keeps :func:`meta_cell`'s fields: the per-device bytes under
the port's sharding rules (``TRAIN_RULES``, or ``DECODE_RULES`` for
decode, whose cache is sequence-sharded; the cache's non-divisible dims
replicated, as ``shardings_for_shapes`` prunes them) over the mesh at
``tp`` = its ``model`` size; the cell's ``model_flops`` (6·N·T·B to
train, 2·N·T·B to prefill, 2·N·B to decode, N the active parameter
count: what an MFU divides by) and its ``variant``: the performance flags
applied to the config before anything is built (:func:`apply_variant`;
``--set key=value``, repeatable: ``precast_params``, ``seq_parallel``,
``fused_gate_up`` as 0 or 1, MoE's ``capacity_factor`` as a float).
``fused_gate_up`` stacks MoE's gate and up weights into one ``w_in``
leaf, so the parameter bytes and ``param_leaves`` are those of the
layout the variant builds.  ``--fast`` gives those fields alone.

:func:`run_cells` is the resumable sweep: cells already ok under the same
mesh and variant are skipped, a failure is recorded with its error and
the tail of its traceback, and the file is written after each cell.
Without ``--out`` nothing is written.

Usage:
  python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--fast]
      [--test-mesh] [--out FILE]
  python -m repro_torch.launch.dryrun --arch deepseek-moe-16b \
      --shape train_4k --set fused_gate_up=1 --set capacity_factor=2.0
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import REGISTRY, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec, get_shape, shapes_for
from repro_torch.distributed.mesh import DATA_AXES
from repro_torch.distributed.sharding import (DECODE_RULES, TRAIN_RULES,
                                              shardings_for,
                                              shardings_for_shapes)
from repro_torch.kernels import work
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models.registry import get_model, input_specs
from repro_torch.optim.adamw import adamw_init, tree_leaves
from repro_torch.train.step import (make_prefill_step, make_serve_step,
                                    make_train_step, train_state_axes)

aten = torch.ops.aten
# operators that move no tensor data: allocations and metadata (views are
# found by their schema)
_NO_BYTES = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
             aten.new_empty_strided, aten._unsafe_view, aten.lift_fresh,
             aten.set_, aten.resize_}
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


def collective_bytes(kind: str, nbytes: int, group_size: int) -> float:
    """Per-device bytes one collective moves under the ring model, from
    the bytes ``nbytes`` of its result on one device and its group's size
    g (the reference's ``parse_collectives`` accounting without the HLO):
    all-reduce 2·S·(g−1)/g, all-gather S·(g−1)/g, reduce-scatter S·(g−1)
    (S its scattered block), all-to-all S·(g−1)/g, collective-permute S."""
    s, g = float(nbytes), group_size
    if kind == "all-reduce":
        return 2.0 * s * (g - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return s * (g - 1) / g
    if kind == "reduce-scatter":
        return s * (g - 1)
    if kind == "collective-permute":
        return s
    raise ValueError(f"unknown collective {kind!r}; one of {COLLECTIVE_KINDS}")


def _op_tensors(x, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of an operator's arguments or results, or of a step's
    (nested dicts, lists and tuples of tensors), in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _op_tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _op_tensors(y, out)
    return out


_ALIASING: Dict[Any, bool] = {}


def _aliasing(func) -> bool:
    """Whether ``func`` may return one of its inputs' storages (a view, an
    in-place or ``out=`` operator: an alias annotation on a result)."""
    got = _ALIASING.get(func)
    if got is None:
        got = _ALIASING[func] = any(r.alias_info is not None
                                    for r in func._schema.returns)
    return got


def storage_bytes(tree, device: str) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors on ``device``
    (a device type)."""
    seen = {}
    for t in _op_tensors(tree, []):
        if t.device.type == device:
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class CostCounter(TorchDispatchMode):
    """Counts a step's FLOPs, bytes, kernel calls, collectives and peak
    memory on one device type (``"meta"``, ``"cuda"`` or ``"cpu"``);
    tensors elsewhere (the host's RNG state under remat, say) count
    nothing.  Entering it makes it the active counter that kernel
    functions (:func:`repro_torch.kernels.work.counted`) and collectives
    report to.  :meth:`record` gives the totals."""

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.device = device
        self.flops = 0
        self.bytes = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.collectives: Dict[str, Dict[str, float]] = {}
        self.ops: Dict[str, Dict[str, int]] = {}
        self.live = 0
        self.peak = 0
        self._sizes = WeakIdKeyDictionary()
        self._inside = 0
        self._outer = None

    def __enter__(self):
        self._outer, work.ACTIVE = work.ACTIVE, self
        return super().__enter__()

    def __exit__(self, *exc):
        work.ACTIVE = self._outer
        return super().__exit__(*exc)

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _track(self, func, ins, outs) -> None:
        """Storages an operator made: each output storage on the device
        that is no input's and not yet known, live until its last
        reference dies."""
        mine = ({t.untyped_storage()._cdata for t in ins
                 if t.device.type == self.device}
                if _aliasing(func) else ())
        for t in outs:
            if t.device.type != self.device:
                continue
            st = t.untyped_storage()
            if st._cdata in mine or st in self._sizes:
                continue
            n = st.nbytes()
            self._sizes[st] = n
            weakref.finalize(st, self._free, n)
            self.live += n
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _op_tensors(kwargs, _op_tensors(args, []))
        outs = _op_tensors(out, [])
        self._track(func, ins, outs)
        if self._inside:
            return out
        packet = func.overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        nbytes = 0
        if not func.is_view and packet not in _NO_BYTES:
            nbytes = sum(t.numel() * t.element_size() for t in ins + outs
                         if t.device.type == self.device)
        if flops or nbytes:
            self.flops += flops
            self.bytes += nbytes
            rec = self.ops.setdefault(str(packet), {"calls": 0, "flops": 0,
                                                    "bytes": 0})
            rec["calls"] += 1
            rec["flops"] += flops
            rec["bytes"] += nbytes
        return out

    @contextlib.contextmanager
    def kernel(self, name: str, cost: Tuple[int, int]):
        """One call of kernel function ``name`` with declared work
        ``(flops, bytes)``; the operators inside are the kernel's."""
        flops, nbytes = cost
        rec = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                             "bytes": 0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    @contextlib.contextmanager
    def collective(self, kind: str, nbytes: int, group_size: int):
        """One collective of ``kind`` whose result holds ``nbytes`` on each
        rank of a group of ``group_size``; the operators inside (host
        staging, copies) are the collective's."""
        rec = self.collectives.setdefault(kind, {"count": 0, "bytes": 0.0})
        rec["count"] += 1
        rec["bytes"] += collective_bytes(kind, nbytes, group_size)
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    def record(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes": self.bytes,
                "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
                "collectives": {k: dict(v) for k, v in
                                sorted(self.collectives.items())},
                "temp_size_in_bytes": self.peak}


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


def meta_cell(arch: str, shape_name: Union[str, ShapeSpec], mesh,
              variant: Optional[Dict] = None,
              cfg: Optional[ArchConfig] = None) -> Dict[str, Any]:
    """One cell's per-device bytes (params, optimizer state, cache) for
    the config with ``variant`` applied (``cfg``: that config, given),
    its model FLOPs and variant."""
    shape = shape_name if isinstance(shape_name, ShapeSpec) else get_shape(shape_name)
    base = apply_variant(get_config(arch), variant) if cfg is None else cfg
    cfg = base.with_tp(mesh.axis_size("model"))
    model = get_model(cfg)
    params = model.param_shapes(cfg)
    rules = DECODE_RULES if shape.kind == "decode" else TRAIN_RULES
    p_shard = shardings_for(model.param_axes(cfg), rules, mesh)
    leaves = tree_leaves(params)
    rec = {"arch": arch, "shape": shape.name,
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


def _meta_inputs(cfg: ArchConfig, shape: ShapeSpec, rows: int
                 ) -> Dict[str, torch.Tensor]:
    spec = ShapeSpec(shape.name, shape.seq_len, rows, shape.kind)
    return {name: torch.empty(dims, dtype=dtype, device="meta")
            for name, (dims, dtype) in sorted(input_specs(cfg, spec).items())}


def step_inputs(cfg: ArchConfig, shape: ShapeSpec, mesh=None,
                micro_batches: int = 1) -> Tuple[Any, tuple]:
    """The step the port runs for ``shape``'s kind and its arguments on
    the meta device, from the first rank's view of ``mesh`` (a dry mesh;
    None for one device): ``(step, args)``.  Training and prefill take
    the whole batch and their own rows of it, as every rank does; the
    decode step, which has no mesh path, takes rank 0's ceil(B / data
    ranks) rows."""
    model = get_model(cfg)
    params = model.param_shapes(cfg)
    if shape.kind == "train":
        state = {"params": params, "opt": adamw_init(params),
                 "step": torch.zeros((), dtype=torch.int32, device="meta")}
        step = make_train_step(cfg, model, mesh=mesh, remat=True,
                               micro_batches=micro_batches)
        return step, (state, _meta_inputs(cfg, shape, shape.global_batch))
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, model, mesh=mesh)
        return step, (params, _meta_inputs(cfg, shape, shape.global_batch))
    n_dp = 1 if mesh is None else mesh.axis_size(DATA_AXES)
    rows = -(-shape.global_batch // n_dp)
    cache = model.init_cache(cfg, rows, shape.seq_len, device="meta")
    tokens = _meta_inputs(cfg, shape, rows)["tokens"]
    return make_serve_step(cfg, model), (params, cache, tokens,
                                         shape.seq_len - 1)


def count_step(step, args, device: str = "meta") -> Dict[str, Any]:
    """Run ``step(*args)`` once under a :class:`CostCounter` on ``device``:
    the counter's record with ``memory`` under the reference's keys."""
    counter = CostCounter(device)
    with counter:
        out = step(*args)
    rec = counter.record()
    held = storage_bytes(args, device)
    both = storage_bytes((args, out), device)
    rec["memory"] = {"argument_size_in_bytes": held,
                     "output_size_in_bytes": both - held,
                     "temp_size_in_bytes": rec.pop("temp_size_in_bytes")}
    rec["ops"] = counter.ops
    return rec


def micro_batches_for(shape: ShapeSpec, mesh) -> int:
    """The reference's micro-batches for a train cell: two sequences a
    device (per-device batch / 2, at least 1); 1 for other kinds."""
    if shape.kind != "train":
        return 1
    n_dp = 1 if mesh is None else mesh.axis_size(DATA_AXES)
    return max(1, shape.global_batch // n_dp // 2)


def lower_cell(arch: str, shape_name: Union[str, ShapeSpec], mesh, tp: int,
               fast: bool = False, variant: Optional[Dict] = None,
               n_layers: Optional[int] = None) -> Dict[str, Any]:
    """One cell's record: :func:`meta_cell`'s fields, and (unless
    ``fast``) the port's step for the shape's kind at full width on the
    meta device, run once from the first rank's view of ``mesh`` (None:
    one device, no mesh) under a :class:`CostCounter`: ``flops``,
    ``bytes``, ``kernels``, ``collectives``, ``memory``,
    ``micro_batches`` and ``ops`` (the aten operators' calls, FLOPs and
    bytes by name).  ``shape_name`` may be a :class:`ShapeSpec`;
    ``n_layers`` cuts the depth (the card's smoke runs do)."""
    shape = shape_name if isinstance(shape_name, ShapeSpec) else get_shape(shape_name)
    base = apply_variant(get_config(arch), variant)
    if n_layers is not None:
        base = dataclasses.replace(base, n_layers=n_layers)
    layout = make_production_mesh() if mesh is None else mesh
    rec = meta_cell(arch, shape, layout, variant, cfg=base)
    rec.update(ok=True, tp=tp)
    if mesh is None:
        rec["mesh"] = "none"
    if fast:
        return rec
    dry = None if mesh is None else mesh.dry_run()
    micro = micro_batches_for(shape, dry)
    t0 = time.monotonic()
    step, args = step_inputs(base.with_tp(tp), shape, dry, micro)
    counted = count_step(step, args)
    rec.update(micro_batches=micro, **counted,
               timings={"count_s": round(time.monotonic() - t0, 1)})
    return rec


def all_cells() -> List[Tuple[str, str]]:
    return [(arch, shape.name) for arch, cfg in sorted(REGISTRY.items())
            for shape in shapes_for(cfg.family)]


def _vkey(variant) -> str:
    return json.dumps(variant or {}, sort_keys=True)


def run_cells(cells, multi_pod: bool, out_path: Optional[Path],
              test_mesh: bool = False, fast: bool = False,
              variant: Optional[Dict] = None) -> List[Dict[str, Any]]:
    """The reference's resumable sweep: cells already ok on this mesh
    under the same variant in ``out_path`` are skipped; a failure becomes
    an ``ok: false`` record with its error and the tail of its traceback;
    the file is rewritten after each cell (None: no file).  Progress goes
    to stderr."""
    mesh = (make_test_mesh if test_mesh else make_production_mesh)(
        multi_pod=multi_pod)
    tp = mesh.shape[-1]
    results = []
    if out_path is not None and out_path.exists():
        results = json.loads(out_path.read_text())
    vkey = _vkey(variant)
    mesh_name = "x".join(str(s) for s in mesh.shape)
    done = {(r["arch"], r["shape"], r["mesh"], _vkey(r.get("variant")))
            for r in results if r.get("ok")}
    out = []
    for arch, shape_name in cells:
        key = (arch, shape_name, mesh_name, vkey)
        if key in done:
            print(f"[skip] {arch} {shape_name} {mesh_name} (cached)",
                  file=sys.stderr, flush=True)
            out += [r for r in results if r.get("ok") and (
                r["arch"], r["shape"], r["mesh"], _vkey(r.get("variant"))) == key]
            continue
        print(f"[dryrun] {arch} x {shape_name} on {mesh_name} ...",
              file=sys.stderr, flush=True)
        t0 = time.monotonic()
        try:
            record = lower_cell(arch, shape_name, mesh, tp, fast=fast,
                                variant=variant)
            print(f"  ok in {time.monotonic() - t0:.1f}s", file=sys.stderr,
                  flush=True)
        except Exception as e:
            record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                      "ok": False, "variant": dict(variant or {}),
                      "error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()[-2000:]}
            print(f"  FAIL: {record['error']}", file=sys.stderr, flush=True)
        results = [r for r in results
                   if (r["arch"], r["shape"], r["mesh"],
                       _vkey(r.get("variant"))) != key]
        results.append(record)
        out.append(record)
        if out_path is not None:
            out_path.parent.mkdir(parents=True, exist_ok=True)
            out_path.write_text(json.dumps(results, indent=1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fast", action="store_true",
                    help="meta_cell's bytes and model FLOPs only")
    ap.add_argument("--test-mesh", action="store_true")
    ap.add_argument("--out", default=None,
                    help="write the records here too (resumes from them)")
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
    for arch in {a for a, _ in cells}:
        if arch in REGISTRY:     # an unknown key is refused before the sweep
            apply_variant(get_config(arch), variant)
    records = run_cells(cells, args.multi_pod,
                        Path(args.out) if args.out else None,
                        test_mesh=args.test_mesh, fast=args.fast,
                        variant=variant)
    for r in records:
        print(json.dumps(r))
    return records


if __name__ == "__main__":
    main()
