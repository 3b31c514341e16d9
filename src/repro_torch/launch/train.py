"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Counterpart of ``repro/launch/train.py``, with its flags, its checkpoint
policy selection and its JSON report, key for key.  Wires the full stack
for a run: VirtualCluster topology + memory hierarchy + (optional) NAM +
SCR strategy + TokenPipeline + Trainer.  It runs on the card unless
``--device cpu`` is given (the one flag the reference lacks, for tests);
the reduced (small) config is the default, ``--full`` the published one.
The run uses deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG`` set
when unset), so a recovery replays its steps bit for bit, as the
reference's XLA run does; the previous setting is restored on return.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import torch

from repro_torch.api.policy import (
    DalyPolicy,
    DrainAwarePolicy,
    FailureHistoryPolicy,
    IntervalPolicy,
)
from repro_torch.api.session import ResilienceSession
from repro_torch.cluster.topology import VirtualCluster
from repro_torch.configs import get_config
from repro_torch.core.scr import Strategy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import FailureEvent, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the reduced (small) config")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--strategy", default="buddy",
                    choices=[s.value for s in Strategy])
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--mtbf-s", type=float, default=None,
                    help="use the Daly-optimal checkpoint policy for this "
                         "MTBF (wrapped drain-aware) instead of a fixed "
                         "--ckpt-every interval")
    ap.add_argument("--policy", default="auto",
                    choices=["auto", "interval", "daly", "failure-history"],
                    help="checkpoint cadence policy; 'auto' keeps the "
                         "legacy selection (--mtbf-s => daly, else "
                         "interval); 'failure-history' adapts cadence AND "
                         "the engine's keep/flush_every knobs to the "
                         "observed failure rate (seeded by --mtbf-s)")
    ap.add_argument("--n-cluster", type=int, default=4)
    ap.add_argument("--n-booster", type=int, default=4)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a node failure at this step")
    ap.add_argument("--fail-rank", type=int, default=2)
    ap.add_argument("--run-dir", default=".deeper_run")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (the card unless 'cpu')")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = get_model(cfg)

    cluster = VirtualCluster(args.n_cluster, args.n_booster, root=Path(args.run_dir))
    choice = args.policy
    if choice == "auto":
        choice = "daly" if args.mtbf_s is not None else "interval"
    mtbf_s = args.mtbf_s if args.mtbf_s is not None else 3600.0
    if choice == "failure-history":
        policy = DrainAwarePolicy(FailureHistoryPolicy(mtbf_s=mtbf_s))
    elif choice == "daly":
        policy = DrainAwarePolicy(DalyPolicy(mtbf_s))
    else:
        policy = IntervalPolicy(args.ckpt_every)
    session = ResilienceSession.for_cluster(
        cluster, strategy=Strategy(args.strategy), policy=policy,
        procs_per_node=2)

    pipeline = TokenPipeline(cfg.vocab_size, args.global_batch, args.seq_len)
    schedule = []
    if args.fail_at is not None:
        schedule.append(FailureEvent(step=args.fail_at, rank=args.fail_rank))

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with session:
            trainer = Trainer(
                cfg, model, pipeline, session,
                opt_cfg=AdamWConfig(lr=args.lr),
                ckpt_every=args.ckpt_every,
                micro_batches=args.micro_batches,
                failure_schedule=schedule,
                device=args.device,
            )
            report = trainer.run(args.steps)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    print(json.dumps({
        "arch": cfg.name,
        "steps_run": report.steps_run,
        "failures": report.failures,
        "recoveries": report.recoveries,
        "restarts_from_step": report.restarts_from_step,
        "checkpoints": report.checkpoints,
        "modelled_ckpt_fg_s": round(report.checkpoint_fg_s, 4),
        "first_loss": report.losses[0] if report.losses else None,
        "last_loss": report.losses[-1] if report.losses else None,
    }, indent=1))


if __name__ == "__main__":
    main()
