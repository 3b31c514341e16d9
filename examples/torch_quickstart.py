"""Quickstart on the PyTorch port: train a small LM with DEEP-ER
multi-level checkpointing.

The counterpart of ``examples/quickstart.py`` on ``repro_torch``, with
its flow, its printed lines and its closing assert.  Demonstrates:
  * the Cluster-Booster virtual topology (4+4 nodes),
  * the SCR-style session API (ResilienceSession: need/start/route/
    complete checkpoint transactions over a pluggable policy),
  * BUDDY checkpointing (SIONlib-aggregated containers on the partner),
  * the asynchronous BeeOND->global drain (training overlaps the flush),
  * a node failure mid-run, fragment reconstruction, and resume.

It runs on the card (its attention through the CUDA flash kernels,
forward and backward); ``--device cpu`` runs the plain versions on the
host instead.  Without a card the default raises.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import tempfile
from pathlib import Path

import torch

from repro_torch.api import IntervalPolicy, ResilienceSession
from repro_torch.cluster.topology import VirtualCluster
from repro_torch.configs import get_config
from repro_torch.core.scr import SCRManager, Strategy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.memory.stack import TierStack
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import FailureEvent, Trainer


def run(device: str = "cuda") -> dict:
    """Train reduced phi3 for 30 steps with node 3 killed at step 17;
    returns the report's numbers that ``main`` prints."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("phi3-mini-3.8b").reduced()
    model = get_model(cfg)
    root = Path(tempfile.mkdtemp(prefix="deeper_quickstart_"))

    cluster = VirtualCluster(n_cluster=4, n_booster=4, root=root)
    # BeeOND cache domain + global tier composed by the TierStack router;
    # SCR drains checkpoints through the cache domain to global storage.
    # The session is the user surface: transactional checkpoints, policy-
    # driven cadence, context-managed shutdown (no leaked drain threads).
    stack = TierStack.for_cluster(cluster)
    scr = SCRManager(cluster, stack, strategy=Strategy.BUDDY,
                     procs_per_node=2, async_drain=True)
    pipeline = TokenPipeline(cfg.vocab_size, global_batch=8, seq_len=128)

    try:
        with ResilienceSession(scr, policy=IntervalPolicy(10)) as session:
            trainer = Trainer(
                cfg, model, pipeline, session,
                opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=10),
                failure_schedule=[FailureEvent(step=17, rank=3)],  # kill node 3
                device=device,
            )
            report = trainer.run(total_steps=30)
    finally:
        cluster.teardown()
    return {"steps_run": report.steps_run, "failures": report.failures,
            "recoveries": report.recoveries,
            "restarts_from_step": list(report.restarts_from_step),
            "checkpoints": report.checkpoints,
            "drains_completed": report.drains_completed,
            "losses": list(report.losses)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (the card unless 'cpu')")
    args = ap.parse_args(argv)
    r = run(args.device)
    losses = r["losses"]
    print(f"steps run           : {r['steps_run']}")
    print(f"node failures       : {r['failures']}")
    print(f"recoveries          : {r['recoveries']} "
          f"(restarted from step {r['restarts_from_step']})")
    print(f"checkpoints written : {r['checkpoints']} "
          f"({r['drains_completed']} drained in background)")
    print(f"loss first -> last  : {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert r["recoveries"] == 1 and losses[-1] < losses[0]
    print("OK: failure survived, training resumed from the buddy copy.")
    return r


if __name__ == "__main__":
    main()
