"""Fleet front-end: admission control + routing over a worker pool.

Counterpart of ``repro/serve/fleet/frontend.py``: the same admission,
routing, failure detection and recovery decisions over the port's
workers.

The traffic-facing half of the serving fleet.  Requests arrive tagged
with a *tenant* and a *priority class*; the front-end enforces
per-tenant in-flight quotas (a tenant over quota queues in its own
backlog — it is throttled, it never blocks anyone else), maps the
priority class onto the scheduler's weighted round-robin quanta
(``quantum_weight``), routes each admitted request to the least-loaded
worker by outstanding-token estimate, and streams tokens back
incrementally as workers emit them.

The front-end is single-threaded and cooperative: callers drive it by
calling :meth:`pump` (or :meth:`wait`, which pumps).  Every pump drains
worker pipes first — so completions free quota before admission runs —
then runs the failure detector, then admits from the backlogs in
arrival order per tenant.

**Failure detection** follows the detection / containment / recovery
decomposition of the HPC resilience pattern language: heartbeat
staleness (``hb_timeout_s`` without any pipe traffic) is the cheap
*trigger*, process liveness is the authoritative *classification* — a
slow-but-alive worker goes ``suspect`` and keeps its streams (its
eventual output is still correct), only an actually-exited process is
declared ``dead``.  This conjunction makes false positives structurally
impossible: no amount of scheduling jitter can kill a live worker's
streams.

**Recovery** re-admits a dead worker's unfinished streams on the
survivors: the frontend loads the worker's last epoch checkpoint
(:func:`~repro_torch.serve.fleet.worker.load_epoch`), takes for each stream
the longer of the token prefix it streamed itself and the checkpointed
prefix — both are prefixes of the *same* deterministic greedy
continuation, so "longer" is strictly more recovered work, never a
conflict — and re-dispatches with ``prompt' = prompt + emitted`` and
``max_new' = remaining``.  The replayed prefix is recorded per request
and merged in front of the surviving worker's output, so callers see
token streams identical to an uninterrupted run.  Survivors adopt the
dead worker's epoch-published KV pages from the board, turning most of
the replayed-prefix prefill into page reuse (park-on-A / resume-on-B).

Admission latency (submit -> dispatch-to-worker) is recorded per
tenant; :meth:`admission_latency_p99` is the metric the fig12 benchmark
gates on — an under-quota tenant's p99 must stay bounded while a noisy
tenant is throttled.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence

from repro_torch.obs.metrics import Registry, StatsView, merge_snapshots
from repro_torch.obs.recorder import read_flight
from repro_torch.obs.trace import Tracer, default_tracer
from repro_torch.serve.fleet.worker import WorkerHandle, WorkerSpec


@dataclass(frozen=True)
class PriorityClass:
    """A named priority level, expressed as a quantum multiplier: a
    weight-``w`` stream decodes ``w * quantum`` consecutive steps before
    the scheduler's round-robin parks it."""
    name: str
    quantum_weight: int = 1


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission limit: at most ``max_inflight`` requests
    dispatched-but-unfinished at once.  Excess requests wait in the
    tenant's own backlog."""
    max_inflight: int = 4


DEFAULT_CLASSES = {
    "batch": PriorityClass("batch", 1),
    "interactive": PriorityClass("interactive", 2),
}


@dataclass
class _Request:
    rid: int
    tenant: str
    prompt: List[int]
    max_new: int
    weight: int
    submitted_s: float
    dispatched_s: Optional[float] = None
    worker: Optional[int] = None
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    # tokens recovered (streamed and/or checkpointed) before a
    # migration: replayed into the resumed stream as prompt suffix and
    # merged in front of the surviving worker's output
    replayed: List[int] = field(default_factory=list)

    @property
    def cost(self) -> int:
        # outstanding-work estimate for least-loaded routing
        return len(self.prompt) + self.max_new


class FleetFrontend:
    """Admission + routing + failure recovery over ``workers``
    (WorkerHandle list)."""

    def __init__(
        self,
        workers: Sequence[WorkerHandle],
        quotas: Optional[Dict[str, TenantQuota]] = None,
        classes: Optional[Dict[str, PriorityClass]] = None,
        default_quota: TenantQuota = TenantQuota(),
        hb_timeout_s: float = 2.0,
        registry: Optional[Registry] = None,
        tracer: Optional[Tracer] = None,
    ):
        if not workers:
            raise ValueError("need at least one worker")
        self.workers = list(workers)
        self.quotas = dict(quotas or {})
        self.classes = dict(classes or DEFAULT_CLASSES)
        self.default_quota = default_quota
        self.hb_timeout_s = float(hb_timeout_s)
        self._requests: Dict[int, _Request] = {}
        self._backlog: Dict[str, Deque[int]] = {}
        self._inflight: Dict[str, int] = {}
        self._load = [0] * len(self.workers)    # outstanding cost / worker
        self._dead: set = set()
        self._next_rid = 0
        self.registry = registry if registry is not None else Registry()
        self.tracer = tracer if tracer is not None else default_tracer()
        self.stats = StatsView(self.registry, "frontend", {
            "submitted": 0, "dispatched": 0, "completed": 0,
            "throttle_events": 0, "workers_failed": 0,
            "streams_migrated": 0, "streams_completed_on_recovery": 0,
        })

    # -- lifecycle --------------------------------------------------------- #

    @classmethod
    def launch(cls, specs: Sequence[WorkerSpec],
               ready_timeout: float = 600.0, **kw) -> "FleetFrontend":
        """Spawn a worker per spec (in parallel — jit warm-up dominates)
        and wait until every one is ready.  Unnamed specs get the fleet
        identity ``w<i>``, which namespaces their epoch checkpoints."""
        specs = [s if s.name else dataclasses.replace(s, name=f"w{i}")
                 for i, s in enumerate(specs)]
        workers = [WorkerHandle.launch(s) for s in specs]
        for w in workers:
            w.wait_ready(ready_timeout)
        return cls(workers, **kw)

    def stop(self) -> None:
        for wi, w in enumerate(self.workers):
            if wi in self._dead:
                continue
            w.stop()

    def __enter__(self) -> "FleetFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission --------------------------------------------------------- #

    def submit(self, prompt: Sequence[int], max_new: int,
               tenant: str = "default", prio: str = "batch") -> int:
        """Queue a request; returns its rid.  Dispatch happens on the
        next :meth:`pump` (quota and load decide when and where)."""
        klass = self.classes.get(prio)
        if klass is None:
            raise ValueError(f"unknown priority class {prio!r}")
        rid = self._next_rid
        self._next_rid += 1
        self._requests[rid] = _Request(
            rid=rid, tenant=tenant, prompt=[int(t) for t in prompt],
            max_new=int(max_new), weight=klass.quantum_weight,
            submitted_s=time.monotonic())
        self._backlog.setdefault(tenant, deque()).append(rid)
        self.stats["submitted"] += 1
        self.tracer.event("submit", tid=rid, tenant=tenant, prio=prio)
        return rid

    # -- the pump ----------------------------------------------------------- #

    def pump(self) -> None:
        """One cooperative cycle: collect worker output, run the
        failure detector, then admit."""
        self._collect()
        self._detect_failures()
        self._admit()

    def _collect(self) -> None:
        for wi, w in enumerate(self.workers):
            if wi in self._dead:
                continue
            for msg in w.messages():
                op = msg.get("op")
                req = self._requests.get(msg.get("rid"))
                if req is None:
                    continue
                if op == "tokens":
                    req.tokens.extend(msg["tokens"])
                elif op == "done":
                    # the worker reports only what it decoded itself; a
                    # migrated stream's replayed prefix goes in front
                    req.tokens = req.replayed + list(msg["tokens"])
                    if not req.done:
                        req.done = True
                        self.stats["completed"] += 1
                        self._inflight[req.tenant] = (
                            self._inflight.get(req.tenant, 1) - 1)
                        if req.worker is not None:
                            self._load[req.worker] -= req.cost

    # -- failure detection --------------------------------------------------- #

    def worker_state(self, wi: int) -> str:
        """``"ok"`` / ``"suspect"`` (heartbeat stale but process alive)
        / ``"dead"`` (classified and recovered from)."""
        if wi in self._dead:
            return "dead"
        w = self.workers[wi]
        age_fn = getattr(w, "heartbeat_age", None)
        if age_fn is None or age_fn() <= self.hb_timeout_s:
            return "ok"
        return "suspect"

    def _detect_failures(self) -> None:
        for wi, w in enumerate(self.workers):
            if wi in self._dead:
                continue
            # heartbeat staleness is only the trigger: probing liveness
            # costs a syscall, so healthy-looking workers are never
            # probed.  Handles without the liveness surface (test
            # stubs) are trusted alive.
            age_fn = getattr(w, "heartbeat_age", None)
            alive_fn = getattr(w, "alive", None)
            if age_fn is None or alive_fn is None:
                continue
            if age_fn() <= self.hb_timeout_s:
                continue
            if alive_fn():
                continue        # suspect: slow, not dead — no recovery
            self._recover_worker(wi)

    def _recover_worker(self, wi: int) -> None:
        """Containment + recovery for one dead worker: mark it dead (no
        further routing/collection), restore its last epoch checkpoint,
        and re-admit every unfinished stream it held with the recovered
        token prefix replayed."""
        w = self.workers[wi]
        spec0 = getattr(w, "spec", None)
        _sp = self.tracer.begin(
            "recover_worker", worker=getattr(spec0, "name", str(wi)))
        self._dead.add(wi)
        self._load[wi] = 0
        self.stats["workers_failed"] += 1
        epochs: Dict[Any, Dict[str, Any]] = {}
        spec = getattr(w, "spec", None)
        if spec is not None and getattr(spec, "ckpt_every", 0):
            from repro_torch.serve.fleet.worker import load_epoch
            epochs = load_epoch(spec.shared_root, spec.name)
        victims = sorted(
            (r for r in self._requests.values()
             if r.worker == wi and not r.done),
            key=lambda r: r.rid)
        for req in victims:
            # frontend-streamed tokens and the epoch checkpoint are both
            # prefixes of the same greedy continuation: take the longer
            emitted = list(req.tokens)
            ep = epochs.get(req.rid)
            if ep and len(ep["emitted"]) > len(emitted):
                emitted = [int(t) for t in ep["emitted"]]
            emitted = emitted[:req.max_new]
            req.replayed = emitted
            req.tokens = list(emitted)
            req.worker = None
            self._inflight[req.tenant] = self._inflight.get(req.tenant, 1) - 1
            self.stats["streams_migrated"] += 1
            self.tracer.event("migrate", tid=req.rid,
                              replayed=len(emitted))
            if len(emitted) >= req.max_new:
                # budget already spent before the failure: complete
                # directly from the recovered prefix
                req.done = True
                self.stats["completed"] += 1
                self.stats["streams_completed_on_recovery"] += 1
            else:
                # front of its tenant's backlog: it was admitted once
                # already, so it outranks never-dispatched arrivals
                self._backlog.setdefault(req.tenant, deque()).appendleft(
                    req.rid)
        self.tracer.end(_sp, migrated=len(victims))

    def live_workers(self) -> List[int]:
        return [i for i in range(len(self.workers)) if i not in self._dead]

    # -- admission ----------------------------------------------------------- #

    def _quota(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default_quota)

    def _admit(self) -> None:
        for tenant in sorted(self._backlog):
            q = self._backlog[tenant]
            limit = self._quota(tenant).max_inflight
            throttled = False
            while q:
                if self._inflight.get(tenant, 0) >= limit:
                    throttled = True
                    break
                self._dispatch(q.popleft())
            if throttled:
                self.stats["throttle_events"] += 1

    def _dispatch(self, rid: int) -> None:
        req = self._requests[rid]
        live = self.live_workers()
        if not live:
            raise RuntimeError("no live workers left in the fleet")
        wi = min(live, key=lambda i: self._load[i])
        # a migrated request resumes where it left off: the recovered
        # prefix rides as prompt suffix, the budget shrinks to match —
        # greedy decode over the same token history continues the very
        # same continuation on the new worker
        self.workers[wi].submit(
            rid, req.prompt + req.replayed,
            req.max_new - len(req.replayed), weight=req.weight)
        req.worker = wi
        req.dispatched_s = time.monotonic()
        self._load[wi] += req.cost
        self._inflight[req.tenant] = self._inflight.get(req.tenant, 0) + 1
        self.registry.histogram(
            "frontend.admission_latency_s", tenant=req.tenant,
        ).observe(req.dispatched_s - req.submitted_s)
        self.stats["dispatched"] += 1

    # -- completion --------------------------------------------------------- #

    def wait(self, rids: Optional[Sequence[int]] = None,
             timeout: float = 600.0) -> None:
        """Pump until every rid (default: all) is done."""
        if rids is None:
            rids = list(self._requests)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.pump()
            if all(self._requests[r].done for r in rids):
                return
            time.sleep(0.005)
        pending = [r for r in rids if not self._requests[r].done]
        raise TimeoutError(f"requests never finished: {pending}")

    def result(self, rid: int) -> List[int]:
        req = self._requests[rid]
        if not req.done:
            raise ValueError(f"request {rid} not finished")
        return list(req.tokens)

    def progress(self, rid: int) -> List[int]:
        """Tokens streamed back so far (replayed prefix included), done
        or not — the incremental view fig13's stall probe samples."""
        return list(self._requests[rid].tokens)

    def assignment(self, rid: int) -> Optional[int]:
        """Worker index currently holding ``rid`` (``None`` while it
        waits in a backlog — including between a failure and its
        re-dispatch)."""
        return self._requests[rid].worker

    # -- maintenance --------------------------------------------------------- #

    def gc_shared(self, ttl_s: float = 60.0) -> Dict[str, int]:
        """Sweep the fleet's shared KV domain for objects stranded by
        dead publishers (``SharedTier.gc``).  Explicit, not automatic:
        call it *after* recovered streams have re-admitted, with a TTL
        comfortably above the checkpoint cadence, so a just-dead
        worker's epoch pages survive long enough to be adopted."""
        for w in self.workers:
            spec = getattr(w, "spec", None)
            if spec is not None:
                from pathlib import Path

                from repro_torch.memory.shared import SharedTier
                tier = SharedTier(Path(spec.shared_root) / "domain",
                                  capacity_bytes=spec.shared_capacity)
                return tier.gc(ttl_s=ttl_s)
        return {}

    # -- metrics ------------------------------------------------------------ #

    def admission_latency_p99(self, tenant: str) -> float:
        """p99 of submit->dispatch latency for ``tenant`` (seconds);
        0.0 when the tenant never dispatched.  Served from the tenant's
        registry sketch — relative error <= the sketch's alpha (1%)."""
        h = self.registry.histogram("frontend.admission_latency_s",
                                    tenant=tenant)
        if h.sketch.count == 0:
            return 0.0
        return h.sketch.quantile(0.99)

    def worker_stats(self) -> List[Dict[str, Any]]:
        return [w.stats() for wi, w in enumerate(self.workers)
                if wi not in self._dead]

    def fleet_stats(self) -> Dict[str, Any]:
        """The fleet-wide observability view: every live worker's
        registry snapshot plus the frontend's own, *merged* — counters
        and gauges sum, quantile sketches merge bucket-wise (the merge
        of the parts is exactly the sketch of the whole; averaging
        per-worker percentiles would be wrong).  Returns::

            {"merged": <snapshot>, "frontend": <snapshot>,
             "workers": {name: <snapshot>}}
        """
        per_worker: Dict[str, Any] = {}
        for wi, w in enumerate(self.workers):
            if wi in self._dead:
                continue
            try:
                snap = w.stats().get("registry")
            except (TimeoutError, OSError, EOFError):
                continue
            if snap:
                name = getattr(getattr(w, "spec", None), "name", "") or f"w{wi}"
                per_worker[name] = snap
        own = self.registry.snapshot()
        merged = merge_snapshots([own] + list(per_worker.values()))
        return {"merged": merged, "frontend": own, "workers": per_worker}

    def postmortem(self, wi: int, last: Optional[int] = None,
                   ) -> Dict[str, Any]:
        """Read a worker's flight journal back from the shared domain —
        the black box, readable whether the worker is alive, stopped, or
        SIGKILL'd (a kill mid-append tears at most the final record;
        ``torn`` counts what was dropped).  Returns
        ``{"worker", "records", "torn"}``."""
        spec = getattr(self.workers[wi], "spec", None)
        if spec is None:
            return {"worker": str(wi), "records": [], "torn": 0}
        from pathlib import Path

        from repro_torch.memory.shared import SharedTier
        tier = SharedTier(Path(spec.shared_root) / "domain",
                          capacity_bytes=spec.shared_capacity)
        records, torn = read_flight(tier, spec.name, last=last)
        return {"worker": spec.name, "records": records, "torn": torn}
