"""SCR-style transactional checkpoint sessions — the user-facing API.

DEEP-ER's resiliency layer wins by "sticking to standard user-interfaces":
applications talk the small SCR vocabulary (need / start / route /
complete a checkpoint) and stay portable while the multi-level
NVM/NAM/global hierarchy works underneath (§III-D1).
:class:`ResilienceSession` is that surface over the
:class:`~repro.core.scr.SCRManager` engine:

    with ResilienceSession.for_cluster(cluster, policy=DalyPolicy(3600)) as s:
        for step in run():
            ...
            if s.need_checkpoint(step):          # SCR_Need_checkpt
                s.start_checkpoint(step)         # SCR_Start_checkpt
                for name, part in state.items():
                    s.route(name, part)          # SCR_Route_file
                s.complete_checkpoint()          # SCR_Complete_checkpt
        state, step = s.restore_latest(template)

Semantics worth pinning down:

* **Transactional.**  ``route`` only *stages* values in memory; nothing
  touches any tier until ``complete_checkpoint`` commits.  An abort
  (``complete_checkpoint(valid=False)`` / ``abort_checkpoint``) discards
  the staged state, and a commit that fails mid-save sweeps every
  partial artifact via :meth:`SCRManager.discard` — an aborted
  transaction leaves no partial fragments in any tier.
* **Policy-driven.**  ``need_checkpoint`` consults a pluggable
  :class:`~repro.api.policy.CheckpointPolicy` (interval, Daly-optimal,
  drain-aware) with a context the session assembles: step cadence,
  measured save cost, async-drain backlog.
* **A context manager.**  ``close()`` is idempotent, aborts any open
  transaction, and (when the session owns its engine) shuts down the
  drain-executor and cache-domain threads.

The engine (``SCRManager``) remains available for tests and internal
plumbing; application code — trainer, serving engine, launcher,
examples, benchmarks — goes through the session.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

from repro_torch.api.policy import CheckpointPolicy, IntervalPolicy, PolicyContext
from repro_torch.core.scr import CheckpointRecord, SCRManager, Strategy
from repro_torch.obs.trace import Tracer, default_tracer


class ResilienceSession:
    """Transactional checkpoint sessions over an :class:`SCRManager`.

    ``policy`` defaults to ``IntervalPolicy(1)`` (every step eligible) so
    callers that gate checkpoints themselves keep working; pass a real
    policy to make ``need_checkpoint`` a decision point.  ``own_engine``
    controls whether ``close()`` also closes the engine (True for
    sessions that built it, False when wrapping a caller-owned one).
    """

    def __init__(
        self,
        scr: SCRManager,
        policy: Optional[CheckpointPolicy] = None,
        own_engine: bool = True,
        tracer: Optional[Tracer] = None,
    ):
        self.scr = scr
        self.tracer = tracer if tracer is not None else default_tracer()
        # with no explicit policy every step is *eligible* (callers that
        # gate checkpoints themselves keep working); the flag lets a layer
        # that owns the cadence (Trainer) install its own default instead
        self.policy_is_default = policy is None
        self.policy = policy if policy is not None else IntervalPolicy(1)
        self._own_engine = own_engine
        self._txn_step: Optional[int] = None
        self._txn_state: "OrderedDict[str, Any]" = OrderedDict()
        self._closed = False
        self.last_checkpoint_step: Optional[int] = None
        self._last_cp_wall: Optional[float] = None
        self._last_need: Optional[Tuple[int, float]] = None
        self._mean_step_s: Optional[float] = None
        self.last_record: Optional[CheckpointRecord] = None
        self.stats: Dict[str, int] = {"committed": 0, "aborted": 0, "declined": 0}

    @classmethod
    def for_cluster(
        cls,
        cluster,
        strategy: Strategy = Strategy.BUDDY,
        policy: Optional[CheckpointPolicy] = None,
        **scr_kw,
    ) -> "ResilienceSession":
        """One-call construction: the engine's storage side is composed by
        the TierStack router (``SCRManager.for_cluster``) and the session
        owns the resulting engine."""
        scr = SCRManager.for_cluster(cluster, strategy=strategy, **scr_kw)
        return cls(scr, policy=policy, own_engine=True)

    @classmethod
    def for_shared_tier(
        cls,
        shared_root,
        n_cluster: int = 2,
        n_booster: int = 0,
        strategy: Strategy = Strategy.BUDDY,
        policy: Optional[CheckpointPolicy] = None,
        domain: str = "scr",
        **scr_kw,
    ) -> "ResilienceSession":
        """A session whose whole storage hierarchy lives under a serving
        fleet's shared domain root (``<shared_root>/<domain>``).
        Checkpoints land on the fleet's shared filesystem, so a *fresh
        process* opening a session over the same root discovers and
        restores them (``available_steps`` scans committed descriptors
        from disk) — the fleet-worker analogue of restarting onto
        BeeOND-cached checkpoints instead of re-pulling from global
        storage.

        ``domain`` namespaces sessions within one shared root: each
        fleet worker checkpoints its live stream set under its own
        domain (``scr-<worker>``), so the frontend can open exactly the
        dead worker's checkpoint line during recovery, and two workers'
        epochs never contend on one descriptor sequence."""
        from pathlib import Path

        from repro_torch.cluster.topology import VirtualCluster

        cluster = VirtualCluster(n_cluster=n_cluster, n_booster=n_booster,
                                 root=Path(shared_root) / domain)
        return cls.for_cluster(cluster, strategy=strategy, policy=policy,
                               **scr_kw)

    # -- lifecycle -------------------------------------------------------- #

    def __enter__(self) -> "ResilienceSession":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Idempotent shutdown: abort any open transaction, then (if the
        session owns its engine) stop the drain executor and cache-domain
        threads via ``SCRManager.close``."""
        if self._closed:
            return
        self._closed = True
        if self._txn_step is not None:
            self._txn_step = None
            self._txn_state = OrderedDict()
            self.stats["aborted"] += 1
        if self._own_engine:
            self.scr.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("ResilienceSession is closed")

    # -- the SCR vocabulary ----------------------------------------------- #

    def need_checkpoint(self, step: int) -> bool:
        """SCR_Need_checkpt: should this step pay for a checkpoint?

        Consults the policy with a fresh context; also measures the step
        cadence (wall seconds per step between successive calls) that
        adaptive policies can use."""
        self._check_open()
        now = time.monotonic()
        if self._last_need is not None:
            last_step, last_wall = self._last_need
            if step > last_step:
                per = (now - last_wall) / (step - last_step)
                self._mean_step_s = (per if self._mean_step_s is None
                                     else 0.5 * self._mean_step_s + 0.5 * per)
        self._last_need = (step, now)
        ctx = PolicyContext(
            step=step,
            last_checkpoint_step=self.last_checkpoint_step,
            now_s=now,
            last_checkpoint_wall_s=self._last_cp_wall,
            mean_step_s=self._mean_step_s,
            drain_backlog=self.scr.outstanding_drains(),
            drain_depth=self.scr.drain_depth,
        )
        want = self.policy.should_checkpoint(ctx)
        if not want:
            self.stats["declined"] += 1
        self._apply_engine_hints()
        return want

    def _apply_engine_hints(self) -> None:
        """Adaptive policies (FailureHistoryPolicy) may steer the
        engine's retention knobs; applied at each decision point."""
        hints = self.policy.engine_hints()
        if not hints:
            return
        if "keep" in hints:
            self.scr.keep = int(hints["keep"])
        if "flush_every" in hints:
            self.scr.flush_every = int(hints["flush_every"])

    def start_checkpoint(self, step: int) -> None:
        """SCR_Start_checkpt: open a transaction for ``step``."""
        self._check_open()
        if self._txn_step is not None:
            raise RuntimeError(
                f"checkpoint transaction for step {self._txn_step} already open")
        self._txn_step = int(step)
        self._txn_state = OrderedDict()

    def route(self, key: str, value: Any) -> None:
        """SCR_Route_file: stage one named part of the checkpoint state.

        Staging is purely in-memory — no tier is touched until commit.
        Keys are unique within a transaction (a duplicate is a bug in the
        caller's routing, not an overwrite)."""
        self._check_open()
        if self._txn_step is None:
            raise RuntimeError("route() outside a checkpoint transaction "
                               "(call start_checkpoint first)")
        if key in self._txn_state:
            raise ValueError(f"key {key!r} already routed in this transaction")
        self._txn_state[key] = value

    def complete_checkpoint(
        self, valid: bool = True, meta: Optional[Dict] = None
    ) -> Optional[CheckpointRecord]:
        """SCR_Complete_checkpt: commit (``valid=True``) or abort.

        On commit the staged parts become the checkpoint pytree (one
        entry per routed key) handed to the engine; if the engine's save
        fails mid-flight, every partial artifact of the step is swept
        before the error propagates.  On abort the staged state is
        discarded — nothing was ever written.  Returns the
        :class:`CheckpointRecord` on commit, ``None`` on abort."""
        self._check_open()
        if self._txn_step is None:
            raise RuntimeError("no open checkpoint transaction")
        step, state = self._txn_step, self._txn_state
        self._txn_step, self._txn_state = None, OrderedDict()
        if not valid:
            self.stats["aborted"] += 1
            return None
        if not state:
            raise RuntimeError("complete_checkpoint with nothing routed")
        t0 = time.perf_counter()
        _sp = self.tracer.begin("ckpt_txn", step=step, parts=len(state))
        try:
            record = self.scr.save(step, dict(state), meta=meta)
        except BaseException:
            # transactional guarantee: a failed commit leaves no partial
            # fragments in any tier (descriptor, NVM, staged, NAM parity)
            self.scr.discard(step)
            self.stats["aborted"] += 1
            self.tracer.end(_sp, committed=False)
            raise
        self.tracer.end(_sp, committed=True)
        wall = time.perf_counter() - t0
        self.policy.observe_save(record, wall)
        self.last_checkpoint_step = step
        self._last_cp_wall = time.monotonic()
        self.last_record = record
        self.stats["committed"] += 1
        return record

    def abort_checkpoint(self) -> None:
        """Abort the open transaction (sugar for ``complete_checkpoint(valid=False)``)."""
        self.complete_checkpoint(valid=False)

    @contextlib.contextmanager
    def checkpoint(self, step: int, meta: Optional[Dict] = None) -> Iterator["ResilienceSession"]:
        """Scoped transaction: commits on clean exit, aborts on exception.
        A body that already resolved the transaction itself (an explicit
        ``abort_checkpoint``/``complete_checkpoint``) is left alone.

            with session.checkpoint(step):
                session.route("w", w)
        """
        self.start_checkpoint(step)
        try:
            yield self
        except BaseException:
            if self._txn_step == step:
                self.abort_checkpoint()
            raise
        if self._txn_step == step:
            self.complete_checkpoint(meta=meta)

    def save(self, step: int, state: Mapping[str, Any],
             meta: Optional[Dict] = None) -> CheckpointRecord:
        """One-shot transaction over a mapping: start, route every
        top-level entry, complete.  Keeps the on-tier layout identical to
        checkpointing the mapping directly."""
        self.start_checkpoint(step)
        for key, value in state.items():
            self.route(key, value)
        record = self.complete_checkpoint(meta=meta)
        assert record is not None
        return record

    # -- restore ----------------------------------------------------------- #

    def restore_latest(
        self, like: Any, step: Optional[int] = None, rebuild: bool = True
    ) -> Tuple[Any, int]:
        """Recover the newest (or given) checkpoint against the template
        pytree ``like``.  An open transaction is aborted first — restoring
        mid-transaction means the transaction's step is lost anyway."""
        self._check_open()
        if self._txn_step is not None:
            self.abort_checkpoint()
        with self.tracer.span("restore"):
            state, got = self.scr.restore(like, step=step, rebuild=rebuild)
        self.last_checkpoint_step = got
        self._last_cp_wall = time.monotonic()
        return state, got

    def checkpoint_meta(self, step: int) -> Dict:
        """The ``meta`` dict committed with ``step`` (empty if none)."""
        try:
            return dict(self.scr._descriptor(step)["manifest"].get("meta") or {})
        except Exception:
            return {}

    # -- engine passthroughs ----------------------------------------------- #

    def wait_drained(self, step: Optional[int] = None,
                     timeout: Optional[float] = None) -> None:
        """Durability barrier (see :meth:`SCRManager.wait_drained`)."""
        self.scr.wait_drained(step=step, timeout=timeout)

    def invalidate_node(self, rank: int) -> None:
        """Drop cached per-node tier handles after a failure/recovery.

        Also the session's failure-observation point: adaptive policies
        (:class:`~repro.api.policy.FailureHistoryPolicy`) learn the
        failure rate from these calls and may retune the engine's
        ``keep``/``flush_every`` knobs in response."""
        self.scr.invalidate_node(rank)
        self.policy.observe_failure(time.monotonic())
        self._apply_engine_hints()

    def available_steps(self):
        return self.scr.available_steps()

    @property
    def drain_backlog(self) -> int:
        return self.scr.outstanding_drains()
