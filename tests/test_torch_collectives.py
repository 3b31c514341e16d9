"""Collectives on ``torch.distributed``: the port against the reference.

One spawned gloo world of 4 ranks on the CPU (and a 2-rank world beside
it) runs the port's ``xor_all_reduce`` on (M, 128) int32 blocks (the
kernel side of the reference's shape rule, here through the plain
``ref.xor_reduce``: the blocks are CPU tensors) and on (M, 64) blocks (the
elementwise side), ``xor_reduce_to``, ``hierarchical_psum`` over a 2 x 2
grouping, and a 3-rank group, which must be refused by name.  The
reference runs the same under ``shard_map`` on 4 forced host devices in a
subprocess: XOR results must be exact, sums allclose at 1e-6.

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
import torch

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 60
SEED = 0
M = 37                # rows of a block: no multiple of any tile
SUM_SHAPE = (5, 7)


def blocks(world, width):
    rng = np.random.default_rng(SEED + width)
    return rng.integers(-2**31, 2**31 - 1, (world, M, width), dtype=np.int64
                        ).astype(np.int32)


def sum_leaves(world):
    return np.random.default_rng(SEED + 1).normal(
        size=(world,) + SUM_SHAPE).astype(np.float32)


def _rank_main(rank, world, store_path, out_dir):
    """One rank: every collective on its own rows of the seeded data; the
    results and the kernel-side call counts saved under ``out_dir``."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels import ops

    calls = []
    plain = ops.xor_reduce

    def counting(stacked, use_kernel=None):
        calls.append(tuple(stacked.shape))
        return plain(stacked, use_kernel=use_kernel)

    ops.xor_reduce = counting
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    out = {}
    try:
        for width in (128, 64):
            x = torch.from_numpy(blocks(world, width)[rank])
            before = len(calls)
            y = coll.xor_all_reduce(x)
            out[f"xor{width}"] = y.numpy()
            out[f"calls{width}"] = np.array(calls[before:]).reshape(-1, 3)
            assert torch.equal(x, torch.from_numpy(blocks(world, width)[rank]))
        out["xor_to"] = coll.xor_reduce_to(
            torch.from_numpy(blocks(world, 128)[rank]), root=0).numpy()
        if world == 4:
            inner, outer = coll.grid_groups(2, 2)
            leaf = torch.from_numpy(sum_leaves(world)[rank])
            out["psum"] = coll.hierarchical_psum(leaf, inner, outer).numpy()
            three = dist.new_group([0, 1, 2])
            if rank < 3:
                try:
                    coll.xor_all_reduce(torch.zeros(2, 128, dtype=torch.int32),
                                        group=three)
                except ValueError as e:
                    out["refused"] = np.array(str(e))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"{world}_{rank}.npz"), **out)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The 4-rank and 2-rank worlds, spawned together once for the module."""
    root = tmp_path_factory.mktemp("coll_world")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, w, str(root / f"store{w}"), str(root)))
             for w in (4, 2) for r in range(w)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return {(w, r): dict(np.load(root / f"{w}_{r}.npz"))
            for w in (4, 2) for r in range(w)}


REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed import collectives as coll
args = np.load(sys.argv[1])
m = int(args["m"])
out = {}
devs = np.array(jax.devices()[:4])
mesh = Mesh(devs, ("x",))
for width in (128, 64):
    x = args[f"blocks{width}"].reshape(4 * m, width)
    f = shard_map(lambda b: coll.xor_all_reduce(b, "x"), mesh=mesh,
                  in_specs=P("x"), out_specs=P("x"), check_rep=False)
    out[str(width)] = np.asarray(jax.jit(f)(x)).tolist()
mesh2 = Mesh(devs.reshape(2, 2), ("pod", "data"))
s = args["sums"]
shape = s.shape
g = shard_map(lambda b: coll.hierarchical_psum(b, "data", "pod"), mesh=mesh2,
              in_specs=P(("pod", "data")), out_specs=P(("pod", "data")),
              check_rep=False)
out["psum"] = np.asarray(jax.jit(g)(s.reshape((4 * shape[1],) + shape[2:]))).tolist()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("coll_ref") / "inputs.npz"
    np.savez(path, m=M, blocks128=blocks(4, 128), blocks64=blocks(4, 64),
             sums=sum_leaves(4))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(path)],
                         capture_output=True, text=True, env=env, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    return {k: np.asarray(v, np.float32 if k == "psum" else np.int32)
            for k, v in got.items()}


@pytest.mark.parametrize("width", [128, 64])
def test_xor_all_reduce_matches_reference(width, results, reference):
    """Every rank ends with the XOR of all four blocks, exactly the
    reference's per-shard result; (M, 128) blocks take the kernel side
    (two (2, M, 128) stacks through ``ops.xor_reduce``), (M, 64) blocks the
    elementwise side (no call)."""
    want = np.bitwise_xor.reduce(blocks(4, width), axis=0)
    ref = reference[str(width)].reshape(4, M, width)
    for r in range(4):
        got = results[(4, r)]
        np.testing.assert_array_equal(got[f"xor{width}"], want)
        np.testing.assert_array_equal(got[f"xor{width}"], ref[r])
        calls = [tuple(c) for c in got[f"calls{width}"]]
        assert calls == ([(2, M, 128)] * 2 if width == 128 else [])


def test_xor_reduce_to_holds_the_parity_on_every_rank(results):
    want = np.bitwise_xor.reduce(blocks(4, 128), axis=0)
    for r in range(4):
        np.testing.assert_array_equal(results[(4, r)]["xor_to"], want)


def test_hierarchical_psum_matches_reference(results, reference):
    """The inner (row) sums, then the outer (column) sums: every rank
    holds the sum over all four, allclose 1e-6 to the reference's and to a
    flat sum."""
    leaves = sum_leaves(4)
    ref = reference["psum"].reshape((4,) + SUM_SHAPE)
    for r in range(4):
        got = results[(4, r)]["psum"]
        np.testing.assert_allclose(got, ref[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, leaves.sum(0), rtol=1e-6, atol=1e-6)


def test_two_rank_world(results):
    """A 2-rank world: one round, the XOR of both blocks on both ranks."""
    for width in (128, 64):
        want = np.bitwise_xor.reduce(blocks(2, width), axis=0)
        for r in range(2):
            np.testing.assert_array_equal(results[(2, r)][f"xor{width}"], want)
        assert len(results[(2, 0)][f"calls{width}"]) == (1 if width == 128 else 0)


def test_three_ranks_refused_by_name(results):
    for r in range(3):
        msg = str(results[(4, r)]["refused"])
        assert "power-of-two" in msg and "3 ranks" in msg
    assert "refused" not in results[(4, 3)]


def test_exports_match_the_reference():
    import repro_torch.distributed as tdist
    assert tdist.__all__ == ["ShardingRules", "TRAIN_RULES", "DECODE_RULES",
                             "specs_from_axes", "shardings_for"]
