"""The Cluster-Booster offload against the reference.

Two spawned gloo worlds of CPU ranks, together once for the module:

* 8 ranks on a (data 4 x model 2) mesh, split after 2 rows of ``data``
  (ranks 0-3 the Cluster, 4-7 the Booster): the reference's
  ``test_offload_engine_on_split_mesh`` in the port's terms (``x`` placed
  on the Booster as ``P('data', None)``, doubled there, kept there as
  ``P('data', None)`` and gathered back to the Cluster as ``P()``), the
  ``ValueError`` bounds of ``split_mesh``, the prepared-function cache's
  key, and ``donate``;
* 2 ranks (rank 0 the Cluster, rank 1 the Booster): xPic's loop
  (``examples/xpic_offload.py``'s ``field_solve`` and ``particle_push``,
  inlined), the field solve on the Cluster, the particle push offloaded
  to the Booster under ``TaskRuntime.run`` with a transient Booster
  failure armed in step 3, the particles staying on the Booster and the
  current gathered back; and the same loop without the failure.

The reference runs the same in a subprocess on forced host devices, from
the same numpy inputs.  Energies agree within ``rtol=1e-5`` (float32 sums
of 4,160 squares and a scatter-add of 4,096 velocities, in other orders);
the run with the failure is bit-equal to the run without; the runtime's
stats on every rank: retried 1, failed 0.

Spawned ranks import this module, so the reference is imported only
inside the subprocess.
"""

import json
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 90
GRID, N_PART, DT, STEPS, FAIL_STEP = 64, 4096, 0.1, 8, 3
ENERGY_TOL = dict(rtol=1e-5, atol=0)


def xpic_inputs():
    rng = np.random.default_rng(0)
    return (rng.uniform(size=N_PART).astype(np.float32),
            np.zeros(N_PART, np.float32),
            np.sin(np.linspace(0, 6.28, GRID)).astype(np.float32),
            np.zeros(GRID, np.float32))


def field_solve(e_field, current):
    """Cluster side: update E field from deposited current (toy Maxwell)."""
    import torch
    lap = torch.roll(e_field, 1) - 2 * e_field + torch.roll(e_field, -1)
    return e_field + DT * (0.5 * lap - current)


def particle_push(pos, vel, e_field):
    """Booster side: push particles in the interpolated field, deposit
    current (index_put with accumulate: deterministic on the card)."""
    import torch
    cell = ((pos * GRID).to(torch.int32) % GRID).long()
    vel = vel + DT * e_field[cell]
    pos = (pos + DT * vel) % 1.0
    current = torch.zeros(GRID, dtype=vel.dtype, device=vel.device)
    current = current.index_put((cell,), vel, accumulate=True) / (N_PART / GRID)
    return pos, vel, current


def kinetic(vel):
    return (vel * vel).sum()


def xpic_loop(engine, runtime, cluster, fail: bool):
    """xPic on a Cluster-Booster split, every rank running it; the
    energies on the Cluster ranks (None elsewhere)."""
    import torch
    import torch.distributed as dist
    from repro_torch.cluster.topology import Module, NodeState

    # the initial state, made on the Cluster
    pos, vel, e_field, current = (engine.put(torch.from_numpy(a), Module.CLUSTER)
                                  for a in xpic_inputs())
    on_cluster = dist.get_rank() in engine.modules[Module.CLUSTER].mesh
    cl_rank = cluster.ranks(Module.CLUSTER)[0]
    booster_rank = cluster.ranks(Module.BOOSTER)[0]
    energy = []
    for step in range(STEPS):
        e_field = runtime.run(
            f"field_{step}",
            lambda e, c: engine.offload(field_solve, Module.CLUSTER, e, c),
            e_field, current, rank=cl_rank)
        if fail and step == FAIL_STEP:
            cluster.arm_failure(booster_rank, NodeState.FAILED_TRANSIENT)
        pos, vel, cur_b = runtime.run(
            f"particles_{step}",
            lambda p, v, e: engine.offload(particle_push, Module.BOOSTER, p, v, e),
            pos, vel, e_field, rank=booster_rank)
        current = engine.gather(cur_b, Module.CLUSTER)
        ke = engine.gather(engine.offload(kinetic, Module.BOOSTER, vel),
                           Module.CLUSTER)
        if on_cluster:
            energy.append(float(ke.value + (e_field.value ** 2).sum()))
    return energy if on_cluster else None


def _split_main(rank, store_path, out_dir):
    import torch
    import torch.distributed as dist
    from repro_torch.cluster.topology import Module
    from repro_torch.core.offload import OffloadEngine, split_mesh
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.sharding import P

    dist.init_process_group("gloo", store=dist.FileStore(store_path, 8),
                            rank=rank, world_size=8,
                            timeout=timedelta(seconds=TIMEOUT_S))
    out = {}
    try:
        mesh = Mesh((4, 2), ("data", "model"))
        refused = []
        for n in (0, 4):
            try:
                split_mesh(mesh, n, axis="data")
            except ValueError as e:
                refused.append(str(e))
        mods = split_mesh(mesh, 2, axis="data")
        eng = OffloadEngine(mods, device="cpu")
        x = torch.arange(16.0).reshape(4, 4)
        double = lambda a: a * 2
        y = eng.offload(double, Module.BOOSTER, x, in_specs=[P("data", None)],
                        out_specs=P("data", None))
        z = eng.gather(y, Module.CLUSTER, P())
        eng.offload(double, Module.BOOSTER, y, in_specs=[P("data", None)])
        keys = [[k[1].value, [list(t) for t in k[2]]] for k in eng._cache]
        w = eng.offload(double, Module.BOOSTER, x, in_specs=[P()])
        eng.offload(lambda a: a + 1, Module.BOOSTER, w, donate=True)
        try:
            w.value
            donated = "kept"
        except RuntimeError as e:
            donated = str(e)
        out = {"refused": refused, "keys": keys, "y_ranks": sorted(y.ranks()),
               "y_local": None if y.local is None else y.local.tolist(),
               "z": None if z.local is None else z.local.tolist(),
               "donated": donated, "fabric": eng.fabric}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"split{rank}.json").write_text(json.dumps(out))


def _xpic_main(rank, store_path, out_dir):
    import torch
    import torch.distributed as dist
    from repro_torch.cluster.topology import VirtualCluster
    from repro_torch.core.offload import OffloadEngine, split_mesh
    from repro_torch.core.tasks import TaskRuntime
    from repro_torch.distributed.mesh import Mesh

    torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=TIMEOUT_S))
    out = {}
    try:
        eng = OffloadEngine(split_mesh(Mesh((2, 1), ("data", "model")), 1),
                            device="cpu")
        for fail in (True, False):
            with tempfile.TemporaryDirectory() as root:
                cluster = VirtualCluster(n_cluster=2, n_booster=2, root=Path(root))
                runtime = TaskRuntime(cluster, max_retries=3)
                out[f"energy_{fail}"] = xpic_loop(eng, runtime, cluster, fail)
                out[f"stats_{fail}"] = [runtime.stats.retried,
                                        runtime.stats.failed]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"xpic{rank}.json").write_text(json.dumps(out))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("offload_worlds")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_split_main, args=(r, str(root / "s8"), str(root)))
             for r in range(8)]
    procs += [ctx.Process(target=_xpic_main, args=(r, str(root / "s2"), str(root)))
              for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    out = {f"split{r}": json.loads((root / f"split{r}.json").read_text())
           for r in range(8)}
    out.update({f"xpic{r}": json.loads((root / f"xpic{r}.json").read_text())
                for r in range(2)})
    return out


REFERENCE = r"""
import json, sys, tempfile
from pathlib import Path
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
sys.path.insert(0, sys.argv[1])
from test_torch_offload import DT, FAIL_STEP, GRID, N_PART, STEPS, xpic_inputs
from repro.cluster.topology import Module, NodeState, VirtualCluster
from repro.core.offload import OffloadEngine, split_mesh
from repro.core.tasks import TaskRuntime
out = {}
devs = np.array(jax.devices()[:8])
mesh = Mesh(devs.reshape(4, 2), ("data", "model"))
refused = []
for n in (0, 4):
    try:
        split_mesh(mesh, n, axis="data")
    except ValueError as e:
        refused.append(str(e))
mods = split_mesh(mesh, 2, axis="data")
eng = OffloadEngine(mods)
x = jnp.arange(16.0).reshape(4, 4)
double = lambda a: a * 2
y = eng.offload(double, Module.BOOSTER, x, in_specs=[P("data", None)],
                out_specs=P("data", None))
z = eng.gather(y, Module.CLUSTER, P())
eng.offload(double, Module.BOOSTER, y, in_specs=[P("data", None)])
out["refused"] = refused
out["keys"] = [[k[1].value, [list(t) for t in k[2]]] for k in eng._cache]
out["z"] = np.asarray(z).tolist()

def field_solve(e_field, current):
    lap = jnp.roll(e_field, 1) - 2 * e_field + jnp.roll(e_field, -1)
    return e_field + DT * (0.5 * lap - current)

def particle_push(pos, vel, e_field):
    cell = (pos * GRID).astype(jnp.int32) % GRID
    vel = vel + DT * e_field[cell]
    pos = (pos + DT * vel) % 1.0
    current = jnp.zeros((GRID,)).at[cell].add(vel) / (N_PART / GRID)
    return pos, vel, current

xmods = split_mesh(Mesh(devs[:2].reshape(2, 1), ("data", "model")), 1)
xeng = OffloadEngine(xmods)
for fail in (True, False):
    cluster = VirtualCluster(n_cluster=2, n_booster=2,
                             root=Path(tempfile.mkdtemp()))
    runtime = TaskRuntime(cluster, max_retries=3)
    pos, vel, e_field, current = (jnp.asarray(a) for a in xpic_inputs())
    booster = cluster.ranks(Module.BOOSTER)[0]
    energy = []
    for step in range(STEPS):
        e_field = runtime.run(f"field_{step}", field_solve, e_field, current,
                              rank=cluster.ranks(Module.CLUSTER)[0])
        if fail and step == FAIL_STEP:
            cluster.arm_failure(booster, NodeState.FAILED_TRANSIENT)
        pos, vel, current = runtime.run(
            f"particles_{step}",
            lambda p, v, e: xeng.offload(particle_push, Module.BOOSTER, p, v, e),
            pos, vel, e_field, rank=booster)
        current = xeng.gather(current, Module.CLUSTER)
        energy.append(float(jnp.sum(vel ** 2) + jnp.sum(e_field ** 2)))
    out[f"energy_{fail}"] = energy
    out[f"stats_{fail}"] = [runtime.stats.retried, runtime.stats.failed]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", REFERENCE,
                          str(Path(__file__).parent)],
                         capture_output=True, text=True, env=env, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_offload_engine_on_split_mesh(results, reference):
    """The doubled value stays on the Booster's four ranks, each holding
    its rows of ``P('data', None)``; gathered back as ``P()``, every
    Cluster rank holds the whole of it, as the reference's Cluster does."""
    want = np.arange(16.0).reshape(4, 4) * 2
    np.testing.assert_array_equal(np.asarray(reference["z"]), want)
    for r in range(8):
        got = results[f"split{r}"]
        assert got["y_ranks"] == [4, 5, 6, 7]
        if r < 4:
            assert got["y_local"] is None
            np.testing.assert_array_equal(np.asarray(got["z"]), want)
        else:
            d = (r - 4) // 2           # the rank's row of the Booster's data axis
            np.testing.assert_array_equal(np.asarray(got["y_local"]),
                                          want[2 * d:2 * d + 2])
            assert got["z"] is None


def test_split_mesh_bounds_refused_as_the_reference(results, reference):
    for r in range(8):
        assert results[f"split{r}"]["refused"] == reference["refused"]
    assert reference["refused"] == ["need 0 < n_cluster_rows < 4"] * 2


def test_cache_key_as_the_reference(results, reference):
    """One prepared function per (fn, target, sub-mesh shape): the second
    call with the same function reuses it, as the jit cache does."""
    for r in range(8):
        keys = results[f"split{r}"]["keys"]
        assert keys[:1] == reference["keys"]
        assert keys[0] == ["booster", [["data", 2], ["model", 2]]]


def test_donate_releases_the_input(results):
    for r in range(8):
        assert "donated" in results[f"split{r}"]["donated"]


def test_fabric_hop_moves_only_each_members_block(results):
    """The Cluster's first rank sends each Booster rank its 2 rows (32 B
    each) of ``x`` for ``P('data', None)``: the hop counts blocks, not
    copies of the whole."""
    sent = results["split0"]["fabric"]["bytes_sent"]
    received = [results[f"split{r}"]["fabric"]["bytes_received"]
                for r in range(4, 8)]
    assert received[0] >= 32 and sent >= 4 * 32


def test_xpic_energies_match_the_reference(results, reference):
    got = results["xpic0"]
    assert results["xpic1"]["energy_True"] is None
    for fail in (True, False):
        np.testing.assert_allclose(got[f"energy_{fail}"],
                                   reference[f"energy_{fail}"], **ENERGY_TOL)


def test_xpic_survives_the_booster_failure(results, reference):
    """The failed push is retried from its snapshot on every rank, no
    task fails, and the energies are bit-equal to the run without it."""
    assert results["xpic0"]["energy_True"] == results["xpic0"]["energy_False"]
    for r in range(2):
        assert results[f"xpic{r}"]["stats_True"] == [1, 0]
        assert results[f"xpic{r}"]["stats_False"] == [0, 0]
    assert reference["stats_True"] == [1, 0]


def test_default_engine_keeps_received_blocks_on_the_card():
    """Built without a device, the engine keeps the blocks it receives on
    the card, as every entry point of the port does unless the caller asks
    for the CPU (the tests above ask by name).  Needs no card: nothing is
    received."""
    from repro_torch.core.offload import OffloadEngine

    assert OffloadEngine({}).device.type == "cuda"
    assert OffloadEngine({}, device="cpu").device.type == "cpu"
