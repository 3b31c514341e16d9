"""xPic-style Cluster-Booster offload with OmpSs-style task resiliency,
on the PyTorch port.

The counterpart of ``examples/xpic_offload.py`` on ``repro_torch``, with
its flow, its printed lines and its closing asserts.  A miniature
particle-in-cell (PIC) simulation split like the paper's xPic (§IV): the
FIELD solver runs on the Cluster module, the PARTICLE solver is
offloaded to the Booster module; the two exchange moments/fields every
step.  The offloaded particle tasks run under the resilient task
runtime: an injected Booster-rank failure restarts only that task from
its input snapshot — no global rollback (the paper's OmpSs
resilient-offload result, Fig 10).

Both solvers run on the card; ``--device cpu`` runs them on the host.
Without a card the default raises.  The current is deposited with
``index_put(..., accumulate=True)`` under deterministic algorithms.  One
process holds both modules here; ``tests/test_torch_offload.py`` runs
the same loop with the Booster on a rank of its own.

  PYTHONPATH=src python examples/torch_xpic_offload.py [--device cpu]
"""

import argparse
import tempfile
from pathlib import Path

import torch

from repro_torch.cluster.topology import Module, NodeState, VirtualCluster
from repro_torch.core.tasks import TaskRuntime
from repro_torch.memory.tiers import MemoryHierarchy

GRID = 64          # field grid cells
N_PART = 4096      # particles
DT = 0.1


def field_solve(e_field, current):
    """Cluster side: update E field from deposited current (toy Maxwell)."""
    lap = torch.roll(e_field, 1) - 2 * e_field + torch.roll(e_field, -1)
    return e_field + DT * (0.5 * lap - current)


def particle_push(pos, vel, e_field):
    """Booster side: push particles in the interpolated field, deposit
    current (toy moment gathering)."""
    cell = ((pos * GRID).to(torch.int32) % GRID).long()
    e_at_p = e_field[cell]
    vel = vel + DT * e_at_p
    pos = (pos + DT * vel) % 1.0
    current = torch.zeros(GRID, dtype=vel.dtype, device=vel.device)
    current = current.index_put((cell,), vel, accumulate=True) / (N_PART / GRID)
    return pos, vel, current


def run(device: str = "cuda") -> dict:
    """Eight field / particle steps with a transient Booster failure
    armed in step 3, then a fresh runtime's journal replay; returns the
    numbers ``main`` prints."""
    cluster = VirtualCluster(n_cluster=2, n_booster=2,
                             root=Path(tempfile.mkdtemp(prefix="xpic_")))
    # task journal only needs the durable global tier, no stack
    hierarchy = MemoryHierarchy(cluster)
    runtime = TaskRuntime(cluster, journal_tier=hierarchy.global_tier,
                          max_retries=3)

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        gen = torch.Generator().manual_seed(0)
        pos = torch.rand(N_PART, generator=gen).to(device)
        vel = torch.zeros(N_PART, device=device)
        e_field = torch.sin(torch.linspace(0, 6.28, GRID, device=device))
        current = torch.zeros(GRID, device=device)

        booster_rank = cluster.ranks(Module.BOOSTER)[0]
        cluster.arm_failure(booster_rank, NodeState.FAILED_TRANSIENT)  # fires in step 3

        energy = []
        for step in range(8):
            # field solve on the Cluster module
            e_field = runtime.run(
                f"field_{step}", field_solve, e_field, current,
                rank=cluster.ranks(Module.CLUSTER)[0], persistent=True,
            )
            # particle push OFFLOADED to the Booster module; step 3 hits
            # the armed failure, the runtime snapshots inputs + retries on
            # recovery
            if step == 3:
                cluster.arm_failure(booster_rank, NodeState.FAILED_TRANSIENT)
            pos, vel, current = runtime.run(
                f"particles_{step}", particle_push, pos, vel, e_field,
                rank=booster_rank, persistent=True,
            )
            energy.append(float((vel ** 2).sum() + (e_field ** 2).sum()))
        s = runtime.stats
        out = {"steps": 8, "launched": s.launched, "retried": s.retried,
               "replayed": s.replayed, "failed": s.failed, "energy": energy,
               "device": str(pos.device)}

        # fast-forward replay: a fresh runtime (post-crash) skips
        # journaled tasks
        runtime2 = TaskRuntime(cluster, journal_tier=hierarchy.global_tier)
        runtime2.run("field_0", field_solve, None, None,
                     rank=cluster.ranks(Module.CLUSTER)[0], persistent=True)
        out["replayed_after_crash"] = runtime2.stats.replayed
    finally:
        torch.use_deterministic_algorithms(deterministic)
        cluster.teardown()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where both solvers run (the card unless 'cpu')")
    args = ap.parse_args(argv)
    r = run(args.device)
    energy = r["energy"]
    print(f"steps completed      : {r['steps']}")
    print(f"tasks launched       : {r['launched']} (retried {r['retried']}, "
          f"replayed {r['replayed']}, failed {r['failed']})")
    print(f"field energy t0 -> t7: {energy[0]:.3f} -> {energy[-1]:.3f}")
    assert r["retried"] >= 1 and r["failed"] == 0
    print("OK: offloaded particle task survived a Booster failure without "
          "global rollback.")
    assert r["replayed_after_crash"] == 1
    print("OK: persistent journal fast-forwards recomputation after a crash.")
    return r


if __name__ == "__main__":
    main()
