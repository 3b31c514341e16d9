"""End-to-end driver on the PyTorch port: train a ~100M-param LM for a
few hundred steps with the full DEEP-ER resiliency stack (NAM-XOR
checkpointing + failures).

The counterpart of ``examples/fault_tolerant_train.py`` on
``repro_torch``, with its flow, its flags, its printed lines and its
closing asserts.  Default arguments train a ~20M model for 60 steps;
``--hundred-m`` switches to a ~100M model and 200 steps.  It runs on the
card; ``--device cpu`` runs on the host instead.  Without a card the
default raises.

  PYTHONPATH=src python examples/torch_fault_tolerant_train.py [--hundred-m] [--device cpu]
"""

import argparse
import dataclasses
import tempfile
import time
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


def build_cfg(hundred_m: bool):
    base = get_config("phi3-mini-3.8b")
    if hundred_m:
        # ~100M params: 12L x 768 x 12H, 3072 FFN, 32k vocab
        return dataclasses.replace(
            base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
            head_dim=64, d_ff=3072, vocab_size=32064,
        )
    return dataclasses.replace(
        base, n_layers=6, d_model=384, n_heads=6, n_kv_heads=6,
        head_dim=64, d_ff=1536, vocab_size=8192,
    )


def run(hundred_m: bool = False, steps=None, device: str = "cuda") -> dict:
    """Train ``build_cfg(hundred_m)`` for ``steps`` (200 or 60 by
    default) with nodes 5 and 9 lost at a third and two thirds of the
    run; returns the numbers ``main`` prints."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = build_cfg(hundred_m)
    steps = steps or (200 if hundred_m else 60)

    model = get_model(cfg)
    root = Path(tempfile.mkdtemp(prefix="deeper_ft_"))
    cluster = VirtualCluster(n_cluster=8, n_booster=4, root=root, xor_group_size=4)
    # TierStack router: BeeOND cache domain + NAM level + global tier,
    # composed by placement policy (memory/stack.py); NAM-XOR parity is
    # routed to the nam level via TierStack.offload
    stack = TierStack.for_cluster(cluster, with_nam=True)
    scr = SCRManager(cluster, stack, strategy=Strategy.NAM_XOR,
                     procs_per_node=2, keep=2, async_redundancy=True)
    pipeline = TokenPipeline(cfg.vocab_size, global_batch=8, seq_len=256)

    t0 = time.monotonic()
    try:
        with ResilienceSession(scr, policy=IntervalPolicy(20)) as session:
            trainer = Trainer(
                cfg, model, pipeline, session,
                opt_cfg=AdamWConfig(lr=6e-4, warmup_steps=20),
                failure_schedule=[
                    FailureEvent(step=steps // 3, rank=5),
                    FailureEvent(step=2 * steps // 3, rank=9),
                ],
                device=device,
            )
            report = trainer.run(total_steps=steps)
        wall = time.monotonic() - t0
    finally:
        cluster.teardown()
    return {"name": cfg.name, "n_params": cfg.param_count(), "steps": steps,
            "steps_run": report.steps_run, "wall_s": wall,
            "failures": report.failures, "recoveries": report.recoveries,
            "restarts_from_step": list(report.restarts_from_step),
            "checkpoints": report.checkpoints,
            "checkpoint_fg_s": report.checkpoint_fg_s,
            "losses": list(report.losses)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (the card unless 'cpu')")
    args = ap.parse_args(argv)
    cfg = build_cfg(args.hundred_m)
    steps = args.steps or (200 if args.hundred_m else 60)
    print(f"model: {cfg.name} variant, ~{cfg.param_count()/1e6:.0f}M params, "
          f"{steps} steps")

    r = run(args.hundred_m, steps, args.device)
    losses = r["losses"]
    print(f"steps run            : {r['steps_run']} in {r['wall_s']:.0f}s")
    print(f"failures / recoveries: {r['failures']} / {r['recoveries']}")
    print(f"restarts from        : {r['restarts_from_step']}")
    print(f"checkpoints          : {r['checkpoints']} "
          f"(modelled fg {r['checkpoint_fg_s']*1e3:.1f} ms total)")
    print(f"loss first -> last   : {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert r["recoveries"] == 2
    assert losses[-1] < losses[0]
    print("OK: two node losses survived via NAM-XOR parity reconstruction.")
    return r


if __name__ == "__main__":
    main()
