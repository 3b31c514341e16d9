"""Fault-tolerant training loop: the DEEP-ER stack end-to-end.

The trainer composes every layer of the framework:

  * train_step (jit, sharded) over the TokenPipeline,
  * SCR multi-level checkpointing (any of the five strategies), with the
    data-pipeline state carried in the checkpoint manifest so restarts
    resume the exact token stream,
  * failure handling: injected (or detected) node failures tear down the
    rank, a replacement is provisioned, the lost checkpoint fragment is
    reconstructed from buddy/XOR/NAM redundancy, and training resumes
    from the last checkpoint — the SCR_PARTNER experiment of Fig 8,
  * straggler mitigation: heartbeat-based detection flags late ranks; with
    ``SCRManager(async_drain=True)`` the BeeOND->global flush runs on the
    drain executor so training steps overlap with drains end-to-end, and
    ``run()`` ends with a ``wait_drained()`` durability barrier,
  * elastic restart: a checkpoint taken on R nodes restores onto R'
    (fragments are re-partitioned from the recovered global blob).

PyTorch port of ``repro/train/trainer.py``: the step runs eagerly on
``device`` (the card unless the caller passes the CPU), the state is
copied to host numpy for each checkpoint (where the reference calls
``jax.device_get``) and restored onto ``device``.  The report also keeps
measured wall seconds (steps, checkpoint commits, restores) beside the
modelled tier times.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.policy import CheckpointPolicy, IntervalPolicy
from repro_torch.api.session import ResilienceSession
from repro_torch.cluster.topology import NodeFailure, NodeState, VirtualCluster
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import state_to_numpy
from repro_torch.core.scr import SCRManager, Strategy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.registry import ModelApi
from repro_torch.optim.adamw import AdamWConfig, tree_map
from repro_torch.train.step import init_train_state, make_train_step


@dataclasses.dataclass
class FailureEvent:
    step: int
    rank: int
    kind: NodeState = NodeState.FAILED_NODE


@dataclasses.dataclass
class TrainReport:
    steps_run: int = 0
    failures: int = 0
    recoveries: int = 0
    restarts_from_step: Optional[List[int]] = None
    checkpoints: int = 0
    checkpoint_fg_s: float = 0.0   # modelled foreground checkpoint time
    checkpoint_bg_s: float = 0.0   # modelled background (drained/overlapped)
    drains_completed: int = 0      # async drains that reached global storage
    drain_wait_s: float = 0.0      # wall time blocked on the final barrier
    losses: Optional[List[float]] = None
    stragglers_flagged: int = 0
    # measured wall seconds on the host clock (the port's additions)
    step_wall_s: Optional[List[float]] = None        # per train step, synced
    checkpoint_wall_s: Optional[List[float]] = None  # per committed save
    restore_wall_s: Optional[List[float]] = None     # per restore

    def __post_init__(self):
        self.restarts_from_step = self.restarts_from_step or []
        self.losses = self.losses or []
        self.step_wall_s = self.step_wall_s or []
        self.checkpoint_wall_s = self.checkpoint_wall_s or []
        self.restore_wall_s = self.restore_wall_s or []


class Trainer:
    def __init__(
        self,
        cfg: ArchConfig,
        model: ModelApi,
        pipeline: TokenPipeline,
        scr,
        opt_cfg: Optional[AdamWConfig] = None,
        mesh=None,
        ckpt_every: int = 10,
        micro_batches: int = 1,
        failure_schedule: Optional[List[FailureEvent]] = None,
        seed: int = 0,
        policy: Optional[CheckpointPolicy] = None,
        device="cuda",
    ):
        """``scr`` is a :class:`ResilienceSession` (the user API) or —
        compatibility shim — a raw :class:`SCRManager`, which is wrapped
        in a caller-owned session whose policy defaults to
        ``IntervalPolicy(ckpt_every)`` (or ``policy`` when given).  A
        session that carries an explicit policy keeps it — pass the
        policy on the session, not here."""
        self.cfg = cfg
        self.model = model
        self.pipeline = pipeline
        if isinstance(scr, ResilienceSession):
            if policy is not None:
                raise ValueError("pass the checkpoint policy on the "
                                 "ResilienceSession, not to the Trainer")
            self.session = scr
            if self.session.policy_is_default:
                # a bare session would make every step checkpoint-eligible;
                # in the trainer the session IS the gate, so install the
                # trainer's cadence
                self.session.policy = IntervalPolicy(ckpt_every)
                self.session.policy_is_default = False
        else:
            self.session = ResilienceSession(
                scr, policy=policy or IntervalPolicy(ckpt_every),
                own_engine=False)
        self.scr: SCRManager = self.session.scr   # the engine, for tests/ops
        self.cluster: VirtualCluster = self.scr.cluster
        self.mesh = mesh
        self.seed = seed
        self.device = torch.device(device)
        self.failures = {(e.step): e for e in (failure_schedule or [])}
        self.train_step = make_train_step(cfg, model, opt_cfg, mesh=mesh,
                                          micro_batches=micro_batches)
        self.report = TrainReport()

    @classmethod
    def for_cluster(
        cls,
        cfg: ArchConfig,
        model: ModelApi,
        pipeline: TokenPipeline,
        cluster: VirtualCluster,
        strategy: Strategy = Strategy.BUDDY,
        procs_per_node: int = 2,
        scr_kw: Optional[Dict[str, Any]] = None,
        policy: Optional[CheckpointPolicy] = None,
        **trainer_kw,
    ) -> "Trainer":
        """Build the storage side via the TierStack router: the BeeOND
        cache domain, (optional) NAM level, and global tier are composed
        by policy instead of hand-wired tiers — see memory/stack.py.  The
        resulting engine is wrapped in a trainer-owned
        :class:`ResilienceSession` driven by ``policy`` (default:
        ``IntervalPolicy(ckpt_every)``)."""
        session = ResilienceSession.for_cluster(
            cluster, strategy=strategy,
            policy=policy or IntervalPolicy(trainer_kw.get("ckpt_every", 10)),
            procs_per_node=procs_per_node, **(scr_kw or {}))
        return cls(cfg, model, pipeline, session, **trainer_kw)

    # ------------------------------------------------------------------ #

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def close(self) -> None:
        """Idempotent: close the trainer's session — and, when the session
        owns its engine (`for_cluster`), the drain-executor and
        cache-domain threads with it."""
        self.session.close()

    def _template(self) -> Dict[str, Any]:
        return init_train_state(self.seed, self.cfg, self.model, self.device)

    def _restore(self, template: Dict[str, Any]) -> Tuple[Dict[str, Any], int]:
        """The newest checkpoint, on the trainer's device."""
        t0 = time.perf_counter()
        state, step = self.session.restore_latest(template)
        state = tree_map(lambda t: t.to(self.device), state)
        self.report.restore_wall_s.append(time.perf_counter() - t0)
        return state, step

    def _initial_state(self) -> Tuple[Dict[str, Any], int]:
        """Restore from the newest checkpoint if one exists, else init."""
        template = self._template()
        try:
            state, step = self._restore(template)
            meta = self.session.checkpoint_meta(step)
            if meta and "pipeline" in meta:
                self.pipeline.load_state(meta["pipeline"])
            else:
                self.pipeline.step = step
            self.report.restarts_from_step.append(step)
            return state, step
        except IOError:
            return template, 0

    def _checkpoint(self, step: int, state: Dict[str, Any]) -> None:
        """One checkpoint transaction: every top-level entry of the train
        state is routed under its own key, so the on-tier layout matches
        checkpointing the state dict directly."""
        t0 = time.perf_counter()
        host_state = state_to_numpy(state)
        rec = self.session.save(step, host_state,
                                meta={"pipeline": self.pipeline.state()})
        self.report.checkpoint_wall_s.append(time.perf_counter() - t0)
        self.report.checkpoints += 1
        self.report.checkpoint_fg_s += rec.foreground_s
        self.report.checkpoint_bg_s += rec.background_s  # sync drains only

    def _heartbeats(self) -> None:
        for rank in self.cluster.up_ranks():
            self.cluster.heartbeat(rank)
        self.report.stragglers_flagged += len(self.cluster.detect_stragglers())

    # ------------------------------------------------------------------ #

    def run(self, total_steps: int, max_recoveries: int = 8) -> TrainReport:
        state, step = self._initial_state()
        recoveries = 0
        while step < total_steps:
            try:
                # fire any injected failure armed for this step
                ev = self.failures.pop(step, None)
                if ev is not None:
                    self.cluster.fail(ev.rank, ev.kind)
                    self.session.invalidate_node(ev.rank)
                    self.report.failures += 1
                    raise NodeFailure(ev.rank, ev.kind)

                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in self.pipeline.next_batch().items()}
                t0 = time.perf_counter()
                state, metrics = self.train_step(state, batch)
                loss = float(metrics["loss"])   # waits for the step
                self.report.step_wall_s.append(time.perf_counter() - t0)
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}")
                self.report.losses.append(loss)
                self._heartbeats()
                step += 1
                self.report.steps_run += 1

                if self.session.need_checkpoint(step):
                    self._checkpoint(step, state)
            except NodeFailure as e:
                recoveries += 1
                if recoveries > max_recoveries:
                    raise RuntimeError("recovery budget exhausted") from e
                # replacement node comes up; redundancy rebuilds its data
                self.cluster.recover(e.rank)
                self.session.invalidate_node(e.rank)
                state, step = self._recover()
                self.report.recoveries += 1
        # final checkpoint so the run is resumable at exactly total_steps
        if self.session.last_checkpoint_step != total_steps:
            self._checkpoint(total_steps, state)
        # durability barrier: training steps overlap with drains, but the
        # run only ends once every checkpoint reached global storage
        t0 = time.perf_counter()
        self.session.wait_drained()
        self.report.drain_wait_s = time.perf_counter() - t0
        self.report.checkpoint_bg_s += self.scr.drain_stats["modelled_bg_s"]
        self.report.drains_completed = int(self.scr.drain_stats["completed"])
        return self.report

    def _recover(self) -> Tuple[Dict[str, Any], int]:
        template = self._template()
        try:
            state, step = self._restore(template)
        except IOError:
            # failed before the first checkpoint: restart from scratch
            self.pipeline.step = 0
            self.report.restarts_from_step.append(0)
            return template, 0
        meta = self.session.checkpoint_meta(step)
        if meta and "pipeline" in meta:
            self.pipeline.load_state(meta["pipeline"])
        else:
            self.pipeline.step = step
        self.report.restarts_from_step.append(step)
        return state, step
