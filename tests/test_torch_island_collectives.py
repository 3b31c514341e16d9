"""The island collectives on ``torch.distributed`` against ``jax.lax``.

One spawned gloo world of 4 CPU ranks on a (data 2 x model 2) mesh runs
the port's ``all_to_all``, ``all_gather``, ``psum_scatter`` and ``psum``
over ``model`` on each rank's block of seeded float32 inputs, and their
gradients (autograd through each collective's backward, each rank with
its own block of a seeded cotangent).  The reference runs the same
``jax.lax`` collectives (``tiled=True``) under ``shard_map`` on a (2, 2)
mesh of forced host devices in a subprocess, and ``jax.grad`` through the
same ``shard_map``.  Values and gradients must agree exactly (float32:
every element is a copy or a sum of two).

Megatron's pair (``copy_to_group`` where a replicated input enters,
``reduce_from_group`` where the partial output leaves) gets a test of its
own: a column- then row-parallel product over ``model`` must give the
no-mesh function's value and ``jax.grad`` (the data ranks' weight
gradients summed), within 1e-5.

Spawned ranks import this module, so the reference is imported only
inside a subprocess.
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

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 60
WORLD = 4
X_SHAPE = (2, 8, 6, 8)          # spec P("data", "model")
OPS = {   # name -> (the port's call on a rank's block, its output's global shape)
    "all_to_all": (2, 16, 3, 8),
    "all_gather": (2, 16, 6, 8),
    "psum_scatter": (2, 8, 3, 8),
    "psum": (2, 8, 6, 8),
}
PAIR = dict(x=(2, 5, 6), w1=(6, 8), w2=(8, 3))


def inputs():
    rng = np.random.default_rng(0)
    out = {"x": rng.normal(size=X_SHAPE).astype(np.float32)}
    for name, shape in OPS.items():
        out["ct_" + name] = rng.normal(size=shape).astype(np.float32)
    for name, shape in PAIR.items():
        out["pair_" + name] = rng.normal(size=shape).astype(np.float32)
    out["pair_c"] = rng.normal(size=(2, 5, 3)).astype(np.float32)
    return out


def block(a, d, m, spec):
    """Device (d, m)'s block of a global array under a 2-entry spec of
    'data' / 'model' / None on the leading dims."""
    idx = []
    for dim, entry in zip(a.shape, spec):
        if entry is None:
            idx.append(slice(None))
        else:
            i = d if entry == "data" else m
            n = dim // 2
            idx.append(slice(i * n, (i + 1) * n))
    return a[tuple(idx)]


def _rank_main(rank, store_path, out_dir):
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_test_mesh

    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=TIMEOUT_S))
    out = {}
    try:
        mesh = make_test_mesh()
        d, m = mesh.index("data"), mesh.index("model")
        g = mesh.group("model")
        ins = inputs()
        calls = {
            "all_to_all": lambda x: C.all_to_all(x, g, split_axis=2, concat_axis=1),
            "all_gather": lambda x: C.all_gather(x, g, axis=1),
            "psum_scatter": lambda x: C.psum_scatter(x, g, axis=2),
            "psum": lambda x: C.psum(x, g),
        }
        for name, fn in calls.items():
            x = torch.from_numpy(block(ins["x"], d, m, ("data", "model"))
                                 ).requires_grad_()
            y = fn(x)
            ct = torch.from_numpy(block(ins["ct_" + name], d, m,
                                        ("data", "model")))
            (y * ct).sum().backward()
            out[name] = y.detach().numpy()
            out["grad_" + name] = x.grad.numpy()
        # Megatron's pair: x replicated over model, w1 column blocks, w2 row
        # blocks, one sum where the partial output leaves
        x = torch.from_numpy(block(ins["pair_x"], d, m, ("data", None))
                             ).requires_grad_()
        w1 = torch.from_numpy(block(ins["pair_w1"], d, m, (None, "model"))
                              ).requires_grad_()
        w2 = torch.from_numpy(block(ins["pair_w2"], d, m, ("model", None))
                              ).requires_grad_()
        c = torch.from_numpy(block(ins["pair_c"], d, m, ("data", None)))
        y = C.reduce_from_group((C.copy_to_group(x, g) @ w1) @ w2, g)
        (y * c).sum().backward()
        out.update(pair_y=y.detach().numpy(), pair_dx=x.grad.numpy(),
                   pair_dw1=w1.grad.numpy(), pair_dw2=w2.grad.numpy())
        # an axis over the whole world: its group is the default one
        from repro_torch.distributed.mesh import Mesh
        whole = Mesh((WORLD, 1), ("data", "model"))
        out["pmean_world"] = C.pmean(torch.tensor([float(rank)]),
                                     whole.group("data")).numpy()
        out["psum_one"] = C.psum(torch.tensor([float(rank)]),
                                 whole.group("model")).numpy()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"{rank}.npz"), **out)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("island_world")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(root / "store"), str(root)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return {r: dict(np.load(root / f"{r}.npz")) for r in range(WORLD)}


REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
a = dict(np.load(sys.argv[1]))
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
ops = {
    "all_to_all": lambda x: jax.lax.all_to_all(x, "model", 2, 1, tiled=True),
    "all_gather": lambda x: jax.lax.all_gather(x, "model", axis=1, tiled=True),
    "psum_scatter": lambda x: jax.lax.psum_scatter(x, "model",
                                                   scatter_dimension=2, tiled=True),
    "psum": lambda x: jax.lax.psum(x, "model"),
}
out = {}
spec = P("data", "model")
for name, op in ops.items():
    f = shard_map(op, mesh=mesh, in_specs=spec, out_specs=spec, check_rep=False)
    out[name] = np.asarray(jax.jit(f)(a["x"])).tolist()
    ct = a["ct_" + name]
    g = jax.grad(lambda x: jnp.sum(f(x) * ct))(a["x"])
    out["grad_" + name] = np.asarray(g).tolist()
def plain(x, w1, w2):
    return (x @ w1) @ w2
c = a["pair_c"]
out["pair_y"] = np.asarray(plain(a["pair_x"], a["pair_w1"], a["pair_w2"])).tolist()
gx, g1, g2 = jax.grad(lambda x, w1, w2: jnp.sum(plain(x, w1, w2) * c),
                      argnums=(0, 1, 2))(a["pair_x"], a["pair_w1"], a["pair_w2"])
out.update(pair_dx=np.asarray(gx).tolist(), pair_dw1=np.asarray(g1).tolist(),
           pair_dw2=np.asarray(g2).tolist())
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("island_ref") / "inputs.npz"
    np.savez(path, **inputs())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(path)],
                         capture_output=True, text=True, env=env, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    return {k: np.asarray(v, np.float32) for k, v in got.items()}


@pytest.mark.parametrize("name", list(OPS))
def test_collective_matches_jax(name, results, reference):
    """Each rank's output block is the reference's device block, exactly
    (JAX's tiled layout: all_to_all splits heads-like axis 2 and joins
    axis 1)."""
    for r in range(WORLD):
        d, m = divmod(r, 2)
        want = block(reference[name], d, m, ("data", "model"))
        np.testing.assert_array_equal(results[r][name], want)


@pytest.mark.parametrize("name", list(OPS))
def test_collective_gradient_matches_jax_grad(name, results, reference):
    """Autograd through the port's collective equals ``jax.grad`` through
    the same ``shard_map`` (``check_rep=False``), exactly."""
    for r in range(WORLD):
        d, m = divmod(r, 2)
        want = block(reference["grad_" + name], d, m, ("data", "model"))
        np.testing.assert_array_equal(results[r]["grad_" + name], want)


def test_megatron_pair_matches_the_no_mesh_gradient(results, reference):
    """copy_to_group / reduce_from_group: the island's output and every
    gradient equal the no-mesh function's (1e-5): without the sum in
    copy_to_group's backward, dx would hold one rank's share."""
    tol = dict(rtol=1e-5, atol=1e-5)
    for r in range(WORLD):
        d, m = divmod(r, 2)
        np.testing.assert_allclose(results[r]["pair_y"],
                                   block(reference["pair_y"], d, m,
                                         ("data", None)), **tol)
        np.testing.assert_allclose(results[r]["pair_dx"],
                                   block(reference["pair_dx"], d, m,
                                         ("data", None)), **tol)
    for m in range(2):
        dw1 = sum(results[2 * d + m]["pair_dw1"] for d in range(2))
        dw2 = sum(results[2 * d + m]["pair_dw2"] for d in range(2))
        np.testing.assert_allclose(dw1, block(reference["pair_dw1"], 0, m,
                                              (None, "model")), **tol)
        np.testing.assert_allclose(dw2, block(reference["pair_dw2"], 0, m,
                                              ("model", None)), **tol)


def test_axis_over_the_whole_world_and_an_axis_of_one(results):
    """A (4 x 1) mesh: 'data' spans the world (the default group), the
    mean over it is every rank's; 'model' has one rank: the sum is the
    rank's own value."""
    for r in range(WORLD):
        np.testing.assert_array_equal(results[r]["pmean_world"], [1.5])
        np.testing.assert_array_equal(results[r]["psum_one"], [float(r)])
