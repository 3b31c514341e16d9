"""Checkpoint policies: *when* to checkpoint, split out of the engine.

SCR's user API starts with ``SCR_Need_checkpoint`` — the library, not the
application, decides whether this iteration should pay for a checkpoint
(DEEP-ER §III-D1: "sticking to standard user-interfaces").  Before this
module every caller hand-rolled a ``step % ckpt_every`` modulo; now the
decision is a pluggable policy consulted by
:meth:`repro.api.session.ResilienceSession.need_checkpoint`:

* :class:`IntervalPolicy` — the classic fixed cadence (every N steps).
* :class:`DalyPolicy` — failure-rate-driven: computes Daly's optimal
  checkpoint interval from the platform MTBF and the *measured* cost of
  the checkpoints it has already taken (J. T. Daly, "A higher order
  estimate of the optimum checkpoint interval for restart dumps", FGCS
  2006), so the cadence adapts as drain cost changes.
* :class:`DrainAwarePolicy` — a decorator that refuses to checkpoint
  while the async drain queue is backed up: piling a new checkpoint onto
  a saturated drain executor only converts background time into
  foreground backpressure.
* :class:`FailureHistoryPolicy` — learns the MTBF online from an EMA of
  observed inter-failure gaps and adapts both the Daly cadence and the
  engine's ``keep``/``flush_every`` retention knobs to it.

Policies are consulted with a :class:`PolicyContext` snapshot assembled
by the session (step counters, wall clocks, measured costs, drain
backlog) and observe each committed save via ``observe_save`` so they
can learn the real checkpoint cost.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional


@dataclasses.dataclass
class PolicyContext:
    """Snapshot handed to ``should_checkpoint`` — everything a policy may
    consult, assembled by the session (all wall clocks are
    ``time.monotonic`` seconds)."""

    step: int
    last_checkpoint_step: Optional[int] = None
    now_s: float = 0.0
    last_checkpoint_wall_s: Optional[float] = None   # monotonic at last commit
    mean_step_s: Optional[float] = None              # measured step cadence
    drain_backlog: int = 0                           # drains not yet landed
    drain_depth: int = 1                             # executor in-flight bound


class CheckpointPolicy:
    """Base class: decide per step; observe committed saves to learn cost."""

    def should_checkpoint(self, ctx: PolicyContext) -> bool:
        raise NotImplementedError

    def observe_save(self, record, wall_s: float) -> None:
        """Called after each committed checkpoint with its
        :class:`~repro.core.scr.CheckpointRecord` and the measured wall
        seconds the save spent on the caller's thread."""

    def observe_failure(self, wall_s: float) -> None:
        """Called by the session when the application reports a node
        failure (``ResilienceSession.invalidate_node``) with the
        ``time.monotonic`` timestamp — adaptive policies learn the
        failure rate from the gaps between these calls."""

    def engine_hints(self) -> Optional[Dict[str, int]]:
        """Optional engine-knob overrides (``keep`` / ``flush_every``)
        the session applies to its SCRManager after each decision point.
        ``None`` (the default) leaves the engine untouched."""
        return None


class IntervalPolicy(CheckpointPolicy):
    """Checkpoint every ``every`` steps (``every=0`` disables)."""

    def __init__(self, every: int = 10):
        if every < 0:
            raise ValueError("interval must be >= 0")
        self.every = int(every)

    def should_checkpoint(self, ctx: PolicyContext) -> bool:
        return self.every > 0 and ctx.step > 0 and ctx.step % self.every == 0

    def __repr__(self) -> str:
        return f"IntervalPolicy(every={self.every})"


class DalyPolicy(CheckpointPolicy):
    """Daly's optimum checkpoint interval from MTBF + measured drain cost.

    With checkpoint cost ``d`` (seconds of application time per
    checkpoint) and platform MTBF ``M``, Daly's higher-order estimate of
    the optimum compute time between checkpoints is::

        tau = sqrt(2 d M) * [1 + (1/3) sqrt(d / 2M) + (1/9)(d / 2M)] - d
              (for d < 2M;  tau = M otherwise)

    ``d`` starts from ``checkpoint_cost_s`` (a seed estimate, optional)
    and is refined by an exponential moving average over the *measured*
    wall cost of committed saves (``observe_save``) — the foreground
    seconds the save actually kept on the application's thread, which
    with an async drain is exactly the cost Daly's model prices.  Until
    any cost estimate exists the policy says yes immediately, so the
    first checkpoint bootstraps the measurement.
    """

    def __init__(
        self,
        mtbf_s: float,
        checkpoint_cost_s: Optional[float] = None,
        ema: float = 0.5,
        min_interval_s: float = 0.0,
    ):
        if mtbf_s <= 0:
            raise ValueError("MTBF must be positive")
        if not 0.0 < ema <= 1.0:
            raise ValueError("ema weight must be in (0, 1]")
        self.mtbf_s = float(mtbf_s)
        self.seed_cost_s = checkpoint_cost_s
        self.ema = float(ema)
        self.min_interval_s = float(min_interval_s)
        self._measured_cost_s: Optional[float] = None
        self.observed_saves = 0

    @property
    def checkpoint_cost_s(self) -> Optional[float]:
        """Current cost estimate ``d``: measured EMA, else the seed."""
        if self._measured_cost_s is not None:
            return self._measured_cost_s
        return self.seed_cost_s

    def observe_save(self, record, wall_s: float) -> None:
        sample = max(0.0, float(wall_s))
        if self._measured_cost_s is None:
            self._measured_cost_s = sample
        else:
            self._measured_cost_s = (
                (1 - self.ema) * self._measured_cost_s + self.ema * sample)
        self.observed_saves += 1

    def optimal_interval_s(self) -> float:
        """Daly's tau for the current cost estimate (see class docstring)."""
        d = self.checkpoint_cost_s
        if d is None:
            return 0.0   # no estimate yet: checkpoint now, measure
        if d <= 0:
            return self.min_interval_s
        m = self.mtbf_s
        if d >= 2 * m:
            return max(m, self.min_interval_s)
        x = d / (2 * m)
        tau = math.sqrt(2 * d * m) * (1 + math.sqrt(x) / 3 + x / 9) - d
        return max(tau, self.min_interval_s)

    def should_checkpoint(self, ctx: PolicyContext) -> bool:
        if self.checkpoint_cost_s is None:
            return True   # bootstrap: take one checkpoint to measure d
        if ctx.last_checkpoint_wall_s is None:
            return True   # nothing durable yet
        return (ctx.now_s - ctx.last_checkpoint_wall_s) >= self.optimal_interval_s()

    def __repr__(self) -> str:
        return (f"DalyPolicy(mtbf_s={self.mtbf_s}, "
                f"cost_s={self.checkpoint_cost_s}, tau_s={self.optimal_interval_s():.3g})")


class DrainAwarePolicy(CheckpointPolicy):
    """Decorator: defer checkpoints while the drain queue is backed up.

    Wraps an ``inner`` policy; when the number of drains that have not
    yet reached global storage is at least ``max_backlog`` (default: the
    executor's ``drain_depth``, i.e. the point where the next save would
    block in backpressure), the checkpoint is skipped regardless of the
    inner decision.  Skips are counted in ``deferred``.
    """

    def __init__(self, inner: CheckpointPolicy, max_backlog: Optional[int] = None):
        if max_backlog is not None and max_backlog < 1:
            raise ValueError("max_backlog must be >= 1")
        self.inner = inner
        self.max_backlog = max_backlog
        self.deferred = 0

    def should_checkpoint(self, ctx: PolicyContext) -> bool:
        limit = self.max_backlog if self.max_backlog is not None else ctx.drain_depth
        if ctx.drain_backlog >= max(1, limit):
            if self.inner.should_checkpoint(ctx):
                self.deferred += 1
            return False
        return self.inner.should_checkpoint(ctx)

    def observe_save(self, record, wall_s: float) -> None:
        self.inner.observe_save(record, wall_s)

    def observe_failure(self, wall_s: float) -> None:
        self.inner.observe_failure(wall_s)

    def engine_hints(self) -> Optional[Dict[str, int]]:
        return self.inner.engine_hints()

    def __repr__(self) -> str:
        return f"DrainAwarePolicy({self.inner!r}, max_backlog={self.max_backlog})"


class FailureHistoryPolicy(CheckpointPolicy):
    """Failure-history-adaptive policy (the ROADMAP's adaptive-cadence
    follow-up): learn the platform MTBF online and adjust both *when* to
    checkpoint and *how the engine retains/flushes* checkpoints.

    Every ``ResilienceSession.invalidate_node`` call reports one observed
    failure; the policy keeps an EMA over the gaps between them — an
    online MTBF estimate seeded by ``mtbf_s`` — and

    * **cadence**: delegates to an internal :class:`DalyPolicy` whose
      MTBF tracks the live estimate, so the Daly-optimal interval
      tightens as failures cluster and relaxes as they thin out;
    * **retention** (``keep``): frequent failures retain more checkpoint
      steps (up to ``max_keep`` — a recovery that itself fails can fall
      back further), rare failures retain fewer (down to ``min_keep`` —
      less multi-level storage pinned);
    * **drain cadence** (``flush_every``): frequent failures drain every
      save to global storage (``flush_every=1`` — node-local copies are
      likely to be needed *and* likely to be lost), rare failures batch
      drains (up to ``max_flush_every`` — the global tier sees 1/N of
      the traffic).

    The knob values interpolate log-linearly between ``tight_mtbf_s``
    (full paranoia) and ``loose_mtbf_s`` (full relaxation) and are
    surfaced via :meth:`engine_hints`; the session applies them to its
    ``SCRManager`` at each decision point.  Selectable from the launcher
    via ``--policy failure-history``.
    """

    def __init__(
        self,
        mtbf_s: float = 3600.0,
        checkpoint_cost_s: Optional[float] = None,
        ema: float = 0.4,
        min_keep: int = 2,
        max_keep: int = 8,
        max_flush_every: int = 4,
        tight_mtbf_s: float = 60.0,
        loose_mtbf_s: float = 86400.0,
        min_gap_s: float = 1.0,
    ):
        if mtbf_s <= 0:
            raise ValueError("MTBF seed must be positive")
        if not 0.0 < ema <= 1.0:
            raise ValueError("ema weight must be in (0, 1]")
        if not 1 <= min_keep <= max_keep:
            raise ValueError("need 1 <= min_keep <= max_keep")
        if max_flush_every < 1:
            raise ValueError("max_flush_every must be >= 1")
        if not 0 < tight_mtbf_s < loose_mtbf_s:
            raise ValueError("need 0 < tight_mtbf_s < loose_mtbf_s")
        if min_gap_s < 0:
            raise ValueError("min_gap_s must be >= 0")
        self.ema = float(ema)
        self.min_keep, self.max_keep = int(min_keep), int(max_keep)
        self.max_flush_every = int(max_flush_every)
        self.tight_mtbf_s, self.loose_mtbf_s = float(tight_mtbf_s), float(loose_mtbf_s)
        self.min_gap_s = float(min_gap_s)
        self.mtbf_estimate_s = float(mtbf_s)
        self.failures_observed = 0
        self._last_failure_wall: Optional[float] = None
        self._daly = DalyPolicy(mtbf_s, checkpoint_cost_s=checkpoint_cost_s)

    # -- learning ---------------------------------------------------------- #

    def observe_failure(self, wall_s: float) -> None:
        """Record one failure report.  Reports closer than ``min_gap_s``
        to the last counted one are duplicate sightings of the *same*
        incident (the trainer invalidates a node both when the failure
        fires and again after recovery) and are ignored — otherwise every
        incident would feed a near-zero gap into the EMA and collapse the
        MTBF estimate regardless of the true failure rate."""
        if self._last_failure_wall is not None:
            gap = float(wall_s) - self._last_failure_wall
            if gap < self.min_gap_s:
                return
            self.mtbf_estimate_s = (
                (1 - self.ema) * self.mtbf_estimate_s + self.ema * max(gap, 1e-3))
        self._last_failure_wall = float(wall_s)
        self.failures_observed += 1
        self._daly.mtbf_s = self.mtbf_estimate_s

    def observe_save(self, record, wall_s: float) -> None:
        self._daly.observe_save(record, wall_s)

    # -- decisions ---------------------------------------------------------- #

    def should_checkpoint(self, ctx: PolicyContext) -> bool:
        return self._daly.should_checkpoint(ctx)

    def optimal_interval_s(self) -> float:
        return self._daly.optimal_interval_s()

    def _relaxation(self) -> float:
        """0.0 = failures at/below tight_mtbf_s (paranoid), 1.0 = at/above
        loose_mtbf_s (relaxed); log-linear in between."""
        m = min(max(self.mtbf_estimate_s, self.tight_mtbf_s), self.loose_mtbf_s)
        return (math.log(m) - math.log(self.tight_mtbf_s)) / (
            math.log(self.loose_mtbf_s) - math.log(self.tight_mtbf_s))

    def engine_hints(self) -> Dict[str, int]:
        t = self._relaxation()
        keep = int(round(self.max_keep + t * (self.min_keep - self.max_keep)))
        flush_every = int(round(1 + t * (self.max_flush_every - 1)))
        return {"keep": keep, "flush_every": flush_every}

    def __repr__(self) -> str:
        h = self.engine_hints()
        return (f"FailureHistoryPolicy(mtbf_est_s={self.mtbf_estimate_s:.3g}, "
                f"failures={self.failures_observed}, keep={h['keep']}, "
                f"flush_every={h['flush_every']})")
