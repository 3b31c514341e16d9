"""Sharding rules: the port against the reference.

Every case of ``tests/test_sharding.py`` runs on both packages, with the
specs equal as tuples (``AxisMesh`` stands in for the reference's fake
mesh: the rules read only axis names and sizes).  Then the placements:
one spawned 4-rank gloo world on the CPU, in which each rank's
``distribute_tensor(x, mesh, placements).to_local()`` must equal the
slice that the reference's ``NamedSharding(...).devices_indices_map``
gives for the same mesh coordinate (the reference runs in a subprocess on
4 forced host devices).

Spawned ranks import this module, so the reference is imported only
inside the tests that use it.
"""

import json
import multiprocessing as mp
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.sharding import (DECODE_RULES, TRAIN_RULES, AxisMesh,
                                              P, fit_spec, specs_from_axes)
from repro_torch.models.registry import get_model

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 60

# (mesh axis names, spec entries, global shape) for the 4-rank world: one
# tensor dim over one axis, over two (the first major), several dims, and
# the rules' batch entry on a ("pod", "data") mesh
PLACED = [
    (("data", "model"), ("model", None), (8, 6)),
    (("data", "model"), (("data",), "model"), (4, 8)),
    (("data", "model"), (None, ("data", "model")), (3, 8)),
    (("data", "model"), ("data", None, "model"), (2, 3, 4)),
    (("data", "model"), (None, None), (5, 2)),
    (("pod", "data"), (("pod", "data"), None), (8, 3)),
]


def jax_mesh(shape=(2, 2), axes=("data", "model")):
    import jax
    from jax.sharding import Mesh
    devs = np.array([jax.devices("cpu")[0]] * int(np.prod(shape))).reshape(shape)
    return Mesh(devs, axes)


def axis_mesh(shape=(2, 2), axes=("data", "model")):
    return AxisMesh(tuple(axes), tuple(shape))


def as_tuples(tree):
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def test_rules_map_known_axes():
    from repro.distributed.sharding import TRAIN_RULES as JR, specs_from_axes as jspecs
    axes = {"x": ("vocab", "d_model")}
    want = as_tuples(jspecs(axes, JR, jax_mesh()))
    assert as_tuples(specs_from_axes(axes, TRAIN_RULES, axis_mesh())) == want
    assert want == {"x": ("model", None)}


def test_unknown_axis_fails_loudly():
    from repro.distributed.sharding import TRAIN_RULES as JR
    with pytest.raises(KeyError):
        JR.spec_for(("not_an_axis",))
    with pytest.raises(KeyError, match="not_an_axis"):
        TRAIN_RULES.spec_for(("not_an_axis",))


@pytest.mark.parametrize("shape,axes,logical,rules", [
    ((2, 2), ("data", "model"), ("batch", None), "train"),
    ((2, 2, 2), ("pod", "data", "model"), ("batch", None), "train"),
    ((2, 2), ("data", "model"), ("layers", "batch", "kv_seq", None, None),
     "decode"),
    ((2, 2), ("data", "model"), ("layers", "batch", "kv_seq", None, None),
     "train"),
])
def test_pod_stripping_and_decode_rules_match(shape, axes, logical, rules):
    """The pod axis stripped on one pod and kept on several; decode rules
    shard kv_seq, train rules do not: specs equal as tuples."""
    from repro.distributed import sharding as jsh
    jr = jsh.DECODE_RULES if rules == "decode" else jsh.TRAIN_RULES
    tr = DECODE_RULES if rules == "decode" else TRAIN_RULES
    want = as_tuples(jsh.specs_from_axes({"x": logical}, jr,
                                         jax_mesh(shape, axes)))
    got = as_tuples(specs_from_axes({"x": logical}, tr, axis_mesh(shape, axes)))
    assert got == want


@pytest.mark.parametrize("spec,shape", [
    ((("data",), "model"), (1, 64)),
    ((("data",), "model"), (8, 63)),
    ((("data",), "model"), (8, 64)),
    (("model",), (6, 5, 4)),
])
def test_fit_spec_prunes_non_divisible(spec, shape):
    from jax.sharding import PartitionSpec as JP
    from repro.distributed.sharding import fit_spec as jfit
    want = tuple(jfit(JP(*spec), shape, jax_mesh((4, 2), ("data", "model"))))
    assert tuple(fit_spec(P(*spec), shape, axis_mesh((4, 2)))) == want


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "deepseek-moe-16b",
                                  "rwkv6-3b", "zamba2-2.7b", "whisper-tiny"])
def test_param_axes_all_resolvable(arch):
    """Every logical axis every port model emits has a rule, and the specs
    equal the reference's for the reference's model."""
    from repro.configs import get_config as jget
    from repro.distributed import sharding as jsh
    from repro.models.registry import get_model as jmodel
    cfg = get_config(arch).with_tp(16)
    model = get_model(cfg)
    jcfg = jget(arch).with_tp(16)
    jm = jmodel(jcfg)
    for fn, tr, jr in (("param_axes", TRAIN_RULES, jsh.TRAIN_RULES),
                       ("cache_axes", DECODE_RULES, jsh.DECODE_RULES)):
        got = as_tuples(specs_from_axes(getattr(model, fn)(cfg), tr,
                                        axis_mesh((16, 16))))
        want = as_tuples(jsh.specs_from_axes(getattr(jm, fn)(jcfg), jr,
                                             jax_mesh((16, 16))))
        assert got == want, fn


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "starcoder2-7b",
                                  "minicpm3-4b", "qwen2-moe-a2.7b"])
def test_padded_dims_divisible_at_tp16(arch):
    """At TP=16 every sharded param dim of the port's models divides."""
    cfg = get_config(arch).with_tp(16)
    model = get_model(cfg)
    mesh = axis_mesh((16, 16))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    shapes = _leaves(model.param_shapes(cfg))
    specs = _leaves(specs_from_axes(model.param_axes(cfg), TRAIN_RULES, mesh))
    assert len(shapes) == len(specs) > 0
    for shp, spec in zip(shapes, specs):
        for dim, entry in zip(shp.shape, tuple(spec)):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            size = int(np.prod([sizes[n] for n in names]))
            assert dim % size == 0, (arch, tuple(shp.shape), spec)


def test_placements_and_shapes_variant():
    """``shardings_for`` gives Shard(d) on each mesh axis a dim names and
    Replicate elsewhere; the shape-aware variant prunes first; an entry
    out of the mesh's order is refused."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = axis_mesh((2, 2))
    got = tsh.shardings_for({"x": ("vocab", "batch")}, TRAIN_RULES, mesh)
    assert got == {"x": (Shard(1), Shard(0))}
    shapes = {"x": torch.empty((7, 4), device="meta")}
    got = tsh.shardings_for_shapes({"x": ("vocab", "batch")}, shapes,
                                   TRAIN_RULES, mesh)
    assert got == {"x": (Shard(1), Replicate())}
    with pytest.raises(ValueError, match="order"):
        tsh.placements_for(P(("model", "data")), mesh)


# ---------------------------------------------------------------------- #
# the 4-rank gloo world
# ---------------------------------------------------------------------- #


def _rank_main(rank, world, store_path, out_dir):
    """One rank: every PLACED case distributed over its mesh; the local
    shards saved as ``<case>_<rank>.npy``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor

    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        meshes = {}
        for i, (names, spec, shape) in enumerate(PLACED):
            if names not in meshes:
                meshes[names] = DeviceMesh("cpu", torch.arange(world).reshape(2, 2),
                                           mesh_dim_names=names)
            mesh = meshes[names]
            x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
            local = distribute_tensor(x, mesh, tsh.placements_for(P(*spec), mesh))
            np.save(os.path.join(out_dir, f"{i}_{rank}.npy"),
                    local.to_local().numpy())
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def local_shards(tmp_path_factory):
    """Spawn the 4-rank world once for the module."""
    root = tmp_path_factory.mktemp("shard_world")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, 4, str(root / "store"), str(root)))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return {(i, r): np.load(root / f"{i}_{r}.npy")
            for i in range(len(PLACED)) for r in range(4)}


REFERENCE_MAPS = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.loads(sys.argv[1])
out = []
for names, spec, shape in cases:
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, tuple(names))
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    per = {}
    for r in range(4):
        d = devs[r // 2, r % 2]
        per[r] = [[s.start, s.stop] for s in idx[d]]
    out.append(per)
print(json.dumps(out))
"""


def test_local_shards_match_jax_index_map(local_shards):
    """On every rank, each case's local shard equals the global tensor's
    slice that JAX's ``NamedSharding`` assigns to the device at the same
    mesh coordinate (rank = 2 * row + column)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", REFERENCE_MAPS,
                          json.dumps(PLACED)], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    maps = json.loads(out.stdout.strip().splitlines()[-1])
    for i, (_, _, shape) in enumerate(PLACED):
        x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
        for r in range(4):
            sl = tuple(slice(a, b) for a, b in maps[i][str(r)])
            np.testing.assert_array_equal(local_shards[(i, r)], x[sl],
                                          err_msg=f"case {PLACED[i]}, rank {r}")
