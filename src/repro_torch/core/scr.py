"""SCR-style multi-level checkpoint/restart (DEEP-ER §III-D1).

Implements the paper's full strategy lattice over the VirtualCluster +
MemoryHierarchy substrate:

  SINGLE   — node-local NVM only; survives transient (process) failures.
  PARTNER  — stock SCR_PARTNER: write local, *re-read* from local storage,
             send to partner node, partner writes one file per process.
  BUDDY    — DEEP-ER enhancement: SIONlib streams the data directly from
             memory to the buddy (no local re-read) and bundles all
             processes of a node into ONE container file on the buddy.
  XOR      — stock SCR Distributed-XOR: RAID-5-rotated parity blocks,
             each node stores parity of size |F|/(G-1) on its own NVM.
  NAM_XOR  — DEEP-ER enhancement: plain group parity computed *on the NAM*
             (near-memory FPGA logic) and stored there, off the failure
             domain; nodes only trigger the pull.

Every strategy additionally drains checkpoints to global storage through
the BeeOND cache level every ``flush_every`` checkpoints (the multi-level
part: NVM for frequent/fast, PFS for rare/durable).

With ``async_drain=True`` the drain is *genuinely* asynchronous (§III-D1,
Figs 7-8): ``save()`` returns after the foreground phase (NVM write +
partner/parity redundancy) and a bounded background executor — one worker
thread over a ``drain_depth``-slot queue, i.e. double-buffered staging by
default — moves the BeeOND→global flush, SION container packing, and NAM
parity pushes off the critical path.  Each save hands back a
:class:`DrainTicket` future; ``wait_drained()`` is the durability barrier;
``restore()`` cancels queued drains and absorbs in-flight drain failures
(failure injection can legitimately kill a drain mid-flush).  A
checkpoint's descriptor is only marked ``drained`` *after* its global
copy lands, so restore never trusts a flush that did not complete.

The manager is also a *performance model*: each save returns modelled
foreground/background seconds derived from the tier and fabric specs, so
the benchmark harness can reproduce the paper's Figs 4, 8, 9 at paper
scale without the paper's hardware.

This class is the *engine*.  The user-facing surface is the SCR-style
transactional session API (``repro/api/session.py``: need / start /
route / complete a checkpoint, ``restore_latest``) — application code
goes through a :class:`~repro.api.session.ResilienceSession`; ``save``/
``restore`` here remain for tests and internal plumbing.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.topology import NodeFailure, NodeState, VirtualCluster
from repro_torch.core import parity
from repro_torch.core.nam import NAMDevice
from repro_torch.io.beeond import CacheFS
from repro_torch.io.serialization import (
    StateBlob,
    deserialize_state,
    join_fragments,
    serialize_state_stream,
)
from repro_torch.io.sion import SionContainer
from repro_torch.memory.stack import TierStack
from repro_torch.memory.store import OffloadOp
from repro_torch.memory.tiers import MemoryHierarchy, TierSpec


class Strategy(str, enum.Enum):
    SINGLE = "single"
    PARTNER = "partner"
    BUDDY = "buddy"
    XOR = "xor"
    NAM_XOR = "nam_xor"


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    """Inter-node fabric (EXTOLL Tourmalet in the prototype)."""

    bandwidth: float = 12.5e9   # 100 Gbit/s
    latency_s: float = 1.5e-6

    def time(self, nbytes: int, concurrent: int = 1) -> float:
        return self.latency_s + nbytes * concurrent / self.bandwidth


EXTOLL = FabricSpec()
TPU_ICI = FabricSpec(bandwidth=50e9, latency_s=1e-6)


class DrainState(str, enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"


class DrainTicket:
    """Future for one checkpoint's background work (redundancy + flush)."""

    def __init__(self, step: int):
        self.step = step
        self.error: Optional[BaseException] = None
        self.background_s = 0.0   # modelled seconds of the off-path work
        self.wall_s = 0.0         # measured wall seconds spent off-path
        self._state = DrainState.QUEUED
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._error_observed = False

    @property
    def state(self) -> DrainState:
        return self._state

    def done(self) -> bool:
        return self._event.is_set()

    def cancelled(self) -> bool:
        return self._state == DrainState.CANCELLED

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> float:
        """Block until the drain lands; return its modelled seconds."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"drain of step {self.step} still in flight")
        if self._state == DrainState.FAILED:
            # the caller observed this failure; the executor must not
            # re-raise it at the next save()/wait() barrier
            self._error_observed = True
            raise IOError(f"drain of step {self.step} failed") from self.error
        if self._state == DrainState.CANCELLED:
            raise RuntimeError(f"drain of step {self.step} was cancelled")
        return self.background_s

    # -- executor-side transitions (atomic vs. try_cancel) --------------- #

    def try_cancel(self) -> bool:
        with self._lock:
            if self._state != DrainState.QUEUED:
                return False
            self._state = DrainState.CANCELLED
        self._event.set()
        return True

    def _begin(self) -> bool:
        with self._lock:
            if self._state != DrainState.QUEUED:
                return False
            self._state = DrainState.RUNNING
            return True

    def _finish(self, state: DrainState) -> None:
        with self._lock:
            self._state = state
        self._event.set()


class DrainExecutor:
    """Bounded single-worker background executor for checkpoint drains.

    ``depth`` is the number of checkpoints that may be in flight (running
    + staged) before ``submit`` blocks the caller — the backpressure that
    keeps a fast checkpoint cadence from piling unbounded state in memory.
    The default depth of 2 is classic double-buffered staging: one drain
    on the wire, one staged behind it.
    """

    def __init__(self, depth: int = 2):
        if depth < 1:
            raise ValueError("drain depth must be >= 1")
        self.depth = depth
        self._q: "queue.Queue[Optional[Tuple[DrainTicket, Callable]]]" = queue.Queue()
        self._slots = threading.Semaphore(depth)
        self._cv = threading.Condition()
        self._outstanding = 0
        self._live: List[DrainTicket] = []
        self._errors: List[Tuple[DrainTicket, BaseException]] = []
        self._thread: Optional[threading.Thread] = None

    def submit(self, ticket: DrainTicket, fn: Callable[[DrainTicket], float]) -> DrainTicket:
        self._slots.acquire()  # backpressure: blocks when `depth` in flight
        with self._cv:
            self._outstanding += 1
            self._live.append(ticket)
        self._ensure_worker()
        self._q.put((ticket, fn))
        return ticket

    def _ensure_worker(self) -> None:
        with self._cv:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="scr-drain"
                )
                self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            ticket, fn = item
            try:
                if ticket._begin():
                    t0 = time.perf_counter()
                    ticket.background_s = fn(ticket)
                    ticket.wall_s = time.perf_counter() - t0
                    ticket._finish(DrainState.DONE)
            except BaseException as e:
                ticket.error = e
                ticket._finish(DrainState.FAILED)
                with self._cv:
                    self._errors.append((ticket, e))
            finally:
                self._slots.release()
                with self._cv:
                    self._outstanding -= 1
                    if ticket in self._live:
                        self._live.remove(ticket)
                    self._cv.notify_all()

    def cancel_queued(self) -> List[DrainTicket]:
        """Cancel every not-yet-started drain; returns the cancelled tickets."""
        with self._cv:
            candidates = list(self._live)
        return [t for t in candidates if t.try_cancel()]

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        with self._cv:
            return self._cv.wait_for(lambda: self._outstanding == 0, timeout)

    def pop_errors(self) -> List[BaseException]:
        """Drain unobserved failures (ones no caller saw via a ticket)."""
        with self._cv:
            errs, self._errors = self._errors, []
        return [e for t, e in errs if not t._error_observed]

    def close(self) -> None:
        self.wait_idle()
        with self._cv:
            thread = self._thread
            self._thread = None
        if thread is not None and thread.is_alive():
            self._q.put(None)
            thread.join(timeout=10)


@dataclasses.dataclass
class CheckpointRecord:
    step: int
    strategy: Strategy
    total_bytes: int
    node_frag_bytes: int
    foreground_s: float    # modelled time on the application's critical path
    background_s: float    # modelled time of offloaded/async work
    drained: bool          # True only once the global copy has landed
    ticket: Optional[DrainTicket] = None   # future for in-flight async work


def _desc_key(step: int) -> str:
    return f"scr/desc/step{step:08d}.json"


def _local_key(step: int, proc: int) -> str:
    return f"ckpt/step{step:08d}/proc{proc:03d}.bin"


def _container_key(step: int) -> str:
    return f"ckpt/step{step:08d}/node.sion"


def _partner_key(step: int, origin: int, proc: int) -> str:
    return f"ckpt/step{step:08d}/partner{origin:05d}_proc{proc:03d}.bin"


def _buddy_container_key(step: int, origin: int) -> str:
    return f"ckpt/step{step:08d}/buddy{origin:05d}.sion"


def _parity_key(step: int) -> str:
    return f"ckpt/step{step:08d}/xor_parity.bin"


def _nam_region(step: int, group_id: int) -> str:
    return f"nam_parity/step{step:08d}/group{group_id:03d}"


def _global_key(step: int, node: int) -> str:
    return f"ckpt/step{step:08d}/node{node:05d}.bin"


class SCRManager:
    def __init__(
        self,
        cluster: VirtualCluster,
        hierarchy,
        nam: Optional[NAMDevice] = None,
        strategy: Strategy = Strategy.BUDDY,
        procs_per_node: int = 4,
        keep: int = 2,
        flush_every: int = 1,
        fabric: FabricSpec = EXTOLL,
        async_redundancy: bool = False,
        async_drain: bool = False,
        drain_depth: int = 2,
        beeond_mode: str = "async",
    ):
        """``hierarchy`` is either a :class:`MemoryHierarchy` (a TierStack
        is built over it, capturing its current global tier) or a ready
        :class:`TierStack` from ``TierStack.for_cluster``/``for_hierarchy``
        — the shared-storage path (descriptors, BeeOND-staged fragments,
        drained global copies) is routed through the stack either way."""
        self.cluster = cluster
        if isinstance(hierarchy, TierStack):
            self.stack = hierarchy
            if hierarchy.hierarchy is None:
                raise ValueError("TierStack must carry a MemoryHierarchy "
                                 "(build it with for_cluster/for_hierarchy)")
            self.hierarchy: MemoryHierarchy = hierarchy.hierarchy
            if nam is None:
                nam = hierarchy.nam_device
        else:
            self.hierarchy = hierarchy
            self.stack = TierStack.for_hierarchy(
                hierarchy, nam=nam, beeond_mode=beeond_mode)
        if self.stack.beeond is None:
            raise ValueError("the SCR drain path needs a BeeOND cache "
                             "domain level in the TierStack")
        if self.stack.beeond.mode not in ("sync", "async"):
            # a local-only domain never reaches global storage, so
            # _commit_drained would mark descriptors drained on a lie
            raise ValueError("the SCR BeeOND domain must drain to global "
                             f"storage (mode={self.stack.beeond.mode!r})")
        self.beeond = self.stack.beeond
        self.nam = nam
        self.strategy = Strategy(strategy)
        self.procs_per_node = int(procs_per_node)
        self.keep = keep
        self.flush_every = flush_every
        self.fabric = fabric
        self.async_redundancy = async_redundancy
        self.async_drain = async_drain
        self._save_count = 0
        self._closed = False
        self._executor = DrainExecutor(depth=drain_depth)
        self._tickets: Dict[int, DrainTicket] = {}
        self._meta_lock = threading.RLock()
        self.drain_stats: Dict[str, float] = {
            "completed": 0, "cancelled": 0, "failed": 0, "modelled_bg_s": 0.0,
        }
        if self.strategy == Strategy.NAM_XOR and nam is None:
            raise ValueError("NAM_XOR strategy requires a NAMDevice")

    @classmethod
    def for_cluster(cls, cluster: VirtualCluster,
                    strategy: Strategy = Strategy.BUDDY,
                    specs=None, **kw) -> "SCRManager":
        """Compose the storage side via the TierStack router — BeeOND
        cache domain, a NAM level when the strategy needs one, global
        tier — and wire an SCRManager over it.  The one construction
        path the trainer, serving engine, and launcher all share."""
        strategy = Strategy(strategy)
        stack = TierStack.for_cluster(
            cluster, specs=specs, with_nam=(strategy == Strategy.NAM_XOR))
        return cls(cluster, stack, strategy=strategy, **kw)

    # ------------------------------------------------------------------ #
    # helpers
    # ------------------------------------------------------------------ #

    def _nvm(self, rank: int):
        return self.hierarchy.nvm(rank)

    def invalidate_node(self, rank: int) -> None:
        """Drop cached per-node tier handles after a failure/recovery —
        the layers above (trainer/engine) go through this instead of
        poking the raw hierarchy."""
        self.hierarchy.invalidate(rank)

    def _node_fragment(self, frags: List[bytes], node: int) -> bytes:
        p = self.procs_per_node
        return b"".join(frags[node * p : (node + 1) * p])

    def wait(self) -> None:
        """Barrier on all outstanding async redundancy/drain work."""
        self._executor.wait_idle()
        self._raise_failed("async checkpoint background work failed")
        self._reap_tickets()

    def wait_drained(self, step: Optional[int] = None,
                     timeout: Optional[float] = None) -> None:
        """Durability barrier: block until checkpoint(s) reached global storage.

        With a `step`, waits on that checkpoint's drain ticket (a no-op if
        it was drained synchronously or never scheduled for a flush).
        Without one, waits for every outstanding background job.  Raises
        IOError if the awaited work failed, TimeoutError on timeout.
        """
        if step is not None:
            with self._meta_lock:
                ticket = self._tickets.get(step)
            if ticket is None:
                return
            ticket.result(timeout)
            return
        if not self._executor.wait_idle(timeout):
            raise TimeoutError("checkpoint drain still in flight")
        self._raise_failed("checkpoint drain failed")
        self._reap_tickets()

    def drain_future(self, step: int) -> Optional[DrainTicket]:
        """The DrainTicket for `step`'s in-flight background work, if any."""
        with self._meta_lock:
            return self._tickets.get(step)

    def cancel_pending_drains(self, wait: bool = True) -> List[int]:
        """Failure-injection-safe drain shutdown, used by ``restore()``.

        Queued (not yet started) drains are cancelled — their descriptors
        stay ``drained=False``, so restore never trusts a global copy that
        did not land.  The running drain, if any, is allowed to finish;
        its failure is absorbed into ``drain_stats`` rather than raised,
        because a dead drain is exactly what restore exists to recover
        from.  Returns the cancelled steps.
        """
        cancelled = self._executor.cancel_queued()
        if wait:
            self._executor.wait_idle()
        self._executor.pop_errors()   # absorbed, already counted by the job
        self.drain_stats["cancelled"] += len(cancelled)
        with self._meta_lock:
            for t in cancelled:
                self._tickets.pop(t.step, None)
        self._reap_tickets(include_failed=True)
        return [t.step for t in cancelled]

    def outstanding_drains(self) -> int:
        """Number of checkpoints whose background work has not landed."""
        with self._meta_lock:
            return sum(1 for t in self._tickets.values() if not t.done())

    @property
    def drain_depth(self) -> int:
        """The executor's in-flight bound (backpressure threshold)."""
        return self._executor.depth

    def discard(self, step: int) -> None:
        """Remove every artifact of ``step`` from every tier: descriptor,
        NVM copies, BeeOND-staged and drained fragments, NAM parity.  Any
        queued drain of the step is cancelled first.  Idempotent, and the
        abort path of the session API (repro/api/session.py) — a failed
        or abandoned checkpoint transaction must leave no partial
        fragments behind."""
        with self._meta_lock:
            ticket = self._tickets.get(step)
        if ticket is not None and ticket.try_cancel():
            self.drain_stats["cancelled"] += 1
        self._delete_step(step)

    def __enter__(self) -> "SCRManager":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def close(self) -> None:
        """Stop the drain worker after finishing outstanding work, then
        shut down the storage stack's threads.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._executor.close()
        self.stack.close()

    def _reap_tickets(self, include_failed: bool = False) -> None:
        """Drop finished tickets.  FAILED tickets are kept by default so a
        re-issued durability barrier keeps raising until the failure is
        explicitly absorbed (restore) or the step pruned."""
        with self._meta_lock:
            for s in [
                s for s, t in self._tickets.items()
                if t.done() and (include_failed or t.state != DrainState.FAILED)
            ]:
                del self._tickets[s]

    def _raise_failed(self, msg: str) -> None:
        """Surface background failures: unobserved executor errors first,
        then any still-registered FAILED ticket (idempotent barrier)."""
        errs = self._executor.pop_errors()
        if errs:
            raise IOError(msg) from errs[0]
        with self._meta_lock:
            failed = [t for t in self._tickets.values()
                      if t.state == DrainState.FAILED]
        if failed:
            raise IOError(msg) from failed[0].error

    # ------------------------------------------------------------------ #
    # save
    # ------------------------------------------------------------------ #

    def save(self, step: int, state: Any, meta: Optional[Dict] = None) -> CheckpointRecord:
        """Checkpoint `state` at `step` using the configured strategy.

        With ``async_drain`` (and/or ``async_redundancy``) enabled, returns
        after the foreground phase; the BeeOND→global flush rides the
        background executor and the returned record carries its
        :class:`DrainTicket`.  A full executor (``drain_depth`` checkpoints
        in flight) applies backpressure by blocking here.
        """
        # surface unobserved failures from earlier background work without
        # blocking (failures seen via a ticket don't fail healthy saves)
        errs = self._executor.pop_errors()
        if errs:
            raise IOError("async checkpoint background work failed") from errs[0]

        stream = serialize_state_stream(state, step=step, meta=meta)
        n_nodes = self.cluster.size
        # the fragment list is the only full-size materialization: fragments
        # are assembled from leaf-buffer slices, never via one joined blob
        frags = stream.fragments(n_nodes * self.procs_per_node)
        proc_bytes = len(frags[0])
        node_bytes = proc_bytes * self.procs_per_node

        # Phase 1 (critical path): every node writes its own data to NVM.
        fg = self._write_local(step, frags)

        # Phase 2: strategy-specific redundancy (optionally async).
        def redundancy() -> float:
            if self.strategy == Strategy.SINGLE:
                return 0.0
            if self.strategy == Strategy.PARTNER:
                return self._partner_redundancy(step, node_bytes)
            if self.strategy == Strategy.BUDDY:
                return self._buddy_redundancy(step, frags, node_bytes)
            if self.strategy == Strategy.XOR:
                return self._xor_redundancy(step, frags, node_bytes)
            if self.strategy == Strategy.NAM_XOR:
                return self._nam_xor_redundancy(step, frags, node_bytes)
            raise AssertionError(self.strategy)

        self._save_count += 1
        drain = self.flush_every > 0 and (self._save_count % self.flush_every == 0)

        # descriptor (tiny, durable, like SCR's index).  Async path: written
        # up front with drained=False, committed True only after the flush
        # lands.  Sync path: written once below, after the inline drain.
        desc = {
            "step": int(step),
            "strategy": self.strategy.value,
            "n_nodes": n_nodes,
            "procs_per_node": self.procs_per_node,
            "proc_bytes": proc_bytes,
            "node_frag_bytes": node_bytes,
            "drained": False,
            "manifest": stream.manifest,
        }

        redundancy_bg = self.async_redundancy and self.strategy != Strategy.SINGLE
        drain_bg = drain and (self.async_drain or self.async_redundancy)
        bg = 0.0
        ticket: Optional[DrainTicket] = None
        if not redundancy_bg:
            fg += redundancy()
        if redundancy_bg or drain_bg:
            with self._meta_lock:
                self.stack.put(_desc_key(step), json.dumps(desc).encode())
            def job(t: DrainTicket) -> float:
                try:
                    s = 0.0
                    if redundancy_bg:
                        s += redundancy()
                    flushed = False
                    if drain:
                        s += self._drain_to_global(step, frags)
                        flushed = self._commit_drained(step)
                    elif not self.stack.exists(_desc_key(step)):
                        # pruned while the redundancy job ran: sweep the
                        # buddy/partner/parity artifacts it just wrote
                        self._delete_step(step)
                except BaseException:
                    with self._meta_lock:
                        self.drain_stats["failed"] += 1
                    raise
                with self._meta_lock:
                    if flushed:
                        self.drain_stats["completed"] += 1
                    self.drain_stats["modelled_bg_s"] += s
                return s

            ticket = DrainTicket(step)
            with self._meta_lock:
                self._tickets[step] = ticket
            self._executor.submit(ticket, job)
        else:
            if drain:
                bg += self._drain_to_global(step, frags)
                desc["drained"] = True
            with self._meta_lock:
                self.stack.put(_desc_key(step), json.dumps(desc).encode())

        self._prune(step)
        return CheckpointRecord(
            step=step,
            strategy=self.strategy,
            total_bytes=stream.nbytes,
            node_frag_bytes=node_bytes,
            foreground_s=fg,
            background_s=bg,
            drained=drain and ticket is None,
            ticket=ticket,
        )

    # -- phase 1: local write ------------------------------------------- #

    def _write_local(self, step: int, frags: List[bytes]) -> float:
        """All nodes write concurrently; modelled time = max over nodes."""
        per_node = 0.0
        p = self.procs_per_node
        use_container = self.strategy in (Strategy.BUDDY, Strategy.NAM_XOR)
        for node in self.cluster.up_ranks():
            nvm = self._nvm(node)
            if use_container:
                # SIONlib path: all procs of the node share one container
                c = SionContainer()
                for j in range(p):
                    c.write_chunk(node * p + j, f"proc{j}", frags[node * p + j])
                t = c.store_stream(nvm, _container_key(step))
            else:
                t = 0.0
                for j in range(p):
                    t += nvm.put(_local_key(step, j), frags[node * p + j])
            per_node = max(per_node, t)
        return per_node

    def _read_own(self, step: int, node: int) -> bytes:
        """Read this node's fragment back from its NVM (if alive)."""
        nvm = self._nvm(node)
        if self.strategy in (Strategy.BUDDY, Strategy.NAM_XOR):
            c = SionContainer.open(nvm, _container_key(step))
            p = self.procs_per_node
            return b"".join(c.read_chunk(node * p + j, f"proc{j}") for j in range(p))
        return b"".join(
            nvm.get(_local_key(step, j)) for j in range(self.procs_per_node)
        )

    # -- strategy redundancy --------------------------------------------- #

    def _partner_redundancy(self, step: int, node_bytes: int) -> float:
        """Stock SCR_PARTNER: local re-read -> fabric -> partner writes p files."""
        p = self.procs_per_node
        per_node = 0.0
        for node in self.cluster.up_ranks():
            buddy = self.cluster.buddy_of(node)
            nvm = self._nvm(node)
            buddy_nvm = self._nvm(buddy)
            t = 0.0
            for j in range(p):
                data = nvm.get(_local_key(step, j))        # the re-read SCR does
                t += nvm.spec.read_time(len(data))
                t += self.fabric.time(len(data))
                t += buddy_nvm.put(_partner_key(step, node, j), data)
            per_node = max(per_node, t)
        return per_node

    def _buddy_redundancy(self, step: int, frags: List[bytes], node_bytes: int) -> float:
        """DEEP-ER Buddy: stream from memory (no re-read), one SION container."""
        p = self.procs_per_node
        per_node = 0.0
        for node in self.cluster.up_ranks():
            buddy = self.cluster.buddy_of(node)
            buddy_nvm = self._nvm(buddy)
            c = SionContainer()
            for j in range(p):
                c.write_chunk(node * p + j, f"proc{j}", frags[node * p + j])
            t = self.fabric.time(node_bytes)
            t += c.store_stream(buddy_nvm, _buddy_container_key(step, node))
            per_node = max(per_node, t)
        return per_node

    def _xor_redundancy(self, step: int, frags: List[bytes], node_bytes: int) -> float:
        """Stock SCR Distributed-XOR: RAID-5 parity blocks on each node's NVM.

        Like SCR_PARTNER, stock SCR computes parity from the checkpoint
        *files*: each node re-reads its fragment from NVM, reduce-scatters
        XOR over the fabric, and writes its parity block back to NVM.  The
        NVMe round-trip is the overhead the NAM offload removes (Fig 9).
        """
        per_node = 0.0
        for group in self.cluster.xor_groups:
            node_frags = [self._node_fragment(frags, n) for n in group]
            blocks = parity.encode_xor_group(node_frags)
            net_t = self.fabric.time(node_bytes)
            for local_idx, node in enumerate(group):
                nvm = self._nvm(node)
                t = nvm.spec.read_time(node_bytes)  # the SCR re-read
                t += net_t + nvm.put(_parity_key(step), blocks[local_idx])
                per_node = max(per_node, t)
        return per_node

    def _nam_xor_redundancy(self, step: int, frags: List[bytes], node_bytes: int) -> float:
        """DEEP-ER NAM-XOR: the NAM pulls fragments and computes parity.

        Routed through :meth:`TierStack.offload`: parity keys are homed
        on the stack's ``nam`` level by placement policy, pool pressure
        is handled by the stack's LRU eviction (oldest steps' regions
        go first), and a stack without a NAM level falls back to the
        byte-identical host computation."""
        busy = 0.0
        for gid, group in enumerate(self.cluster.xor_groups):
            region = _nam_region(step, gid)
            node_frags = [self._node_fragment(frags, n) for n in group]
            op = OffloadOp(
                kind="xor_parity",
                sources=[lambda f=f: f for f in node_frags],
                nbytes=node_bytes,
            )
            # protect this step's other regions: pool pressure must evict
            # older steps' parity, never degrade the checkpoint being taken
            busy = max(busy, self.stack.offload(
                region, op, protect_prefix=f"nam_parity/step{step:08d}"))
        # foreground cost on the nodes: just the trigger (the NAM pulls);
        # when synchronous, the caller waits for the NAM to finish.
        if self.async_redundancy:
            return self.fabric.latency_s
        return self.fabric.latency_s + busy

    # -- global drain (BeeOND async level) -------------------------------- #

    def _drain_to_global(self, step: int, frags: List[bytes]) -> float:
        """Flush every node fragment to global storage *through the BeeOND
        cache domain* (§III-C): per-proc pieces stream into the cache
        domain at local speed (no joined node blob), the domain's drain
        thread moves them to the global tier, and the closing ``flush()``
        is the durability barrier — only after it may the descriptor
        commit ``drained=True``.

        Drains *all* fragments, not just those of currently-up nodes: the
        data is staged in memory, so a node failing between save and drain
        must not lose its fragment's durable copy.
        """
        n_nodes = self.cluster.size
        p = self.procs_per_node
        streams = max(1, n_nodes)
        stage_t = 0.0
        drained_before = self.beeond.drained_modelled_s
        for node in range(n_nodes):
            pieces = frags[node * p : (node + 1) * p]
            # routed by the stack: FRAGMENT keys land on the beeond level;
            # the size hint lets admission control reroute an oversized
            # fragment without consuming the stream first
            stage_t = max(stage_t, self.stack.put_stream(
                _global_key(step, node), pieces, streams=streams,
                size_hint=len(pieces[0]) * len(pieces)))
        self.beeond.flush()
        return stage_t + (self.beeond.drained_modelled_s - drained_before)

    def _commit_drained(self, step: int) -> bool:
        """Mark `step` drained *after* its global copy landed.

        If the step was pruned while its drain was in flight, the commit
        is dropped and everything the in-flight job wrote after the
        deletion — global fragments, NVM redundancy copies, NAM parity —
        is swept instead.
        """
        with self._meta_lock:
            if self.stack.exists(_desc_key(step)):
                desc = json.loads(self.stack.get(_desc_key(step)).decode())
                desc["drained"] = True
                self.stack.put(_desc_key(step), json.dumps(desc).encode())
                return True
        self._delete_step(step)
        return False

    # ------------------------------------------------------------------ #
    # restore
    # ------------------------------------------------------------------ #

    def available_steps(self) -> List[int]:
        steps = []
        for key in self.stack.keys():
            if key.startswith("scr/desc/"):
                steps.append(int(key.split("step")[1].split(".")[0]))
        return sorted(steps)

    def _descriptor(self, step: int) -> Dict:
        raw = self.stack.get(_desc_key(step))
        return json.loads(raw.decode())

    def restore(
        self,
        like: Any,
        step: Optional[int] = None,
        rebuild: bool = True,
    ) -> Tuple[Any, int]:
        """Recover the newest (or given) checkpoint; reconstructs fragments
        lost to node failures via the strategy's redundancy data.

        Queued drains are cancelled first and in-flight drain failures are
        absorbed (see ``cancel_pending_drains``): after a failure we only
        trust descriptors whose ``drained`` flag was committed."""
        self.cancel_pending_drains()
        candidates = [step] if step is not None else list(reversed(self.available_steps()))
        last_err: Optional[BaseException] = None
        for s in candidates:
            try:
                return self._restore_step(like, s, rebuild), s
            except (KeyError, IOError, RuntimeError, NodeFailure) as e:
                last_err = e
                continue
        raise IOError("no recoverable checkpoint found") from last_err

    def _restore_step(self, like: Any, step: int, rebuild: bool) -> Any:
        desc = self._descriptor(step)
        n_nodes = desc["n_nodes"]
        strategy = Strategy(desc["strategy"])
        node_frags: Dict[int, bytes] = {}
        missing: List[int] = []
        for node in range(n_nodes):
            try:
                node_frags[node] = self._read_own_for(desc, step, node)
            except (KeyError, IOError, NodeFailure):
                missing.append(node)

        for node in missing:
            node_frags[node] = self._recover_fragment(desc, step, node, node_frags)
            if rebuild and self.cluster.node(node).is_up:
                self._rebuild_local(desc, step, node, node_frags[node])

        frag_list = [node_frags[n] for n in range(n_nodes)]
        data = join_fragments(frag_list, desc["manifest"]["total_bytes"])
        blob = StateBlob(data=data, manifest=desc["manifest"])
        return deserialize_state(blob, like)

    def _read_own_for(self, desc: Dict, step: int, node: int) -> bytes:
        nvm = self._nvm(node)  # raises NodeFailure if node down
        p = desc["procs_per_node"]
        if Strategy(desc["strategy"]) in (Strategy.BUDDY, Strategy.NAM_XOR):
            c = SionContainer.open(nvm, _container_key(step))
            return b"".join(c.read_chunk(node * p + j, f"proc{j}") for j in range(p))
        return b"".join(nvm.get(_local_key(step, j)) for j in range(p))

    def _recover_fragment(
        self, desc: Dict, step: int, node: int, have: Dict[int, bytes]
    ) -> bytes:
        strategy = Strategy(desc["strategy"])
        p = desc["procs_per_node"]
        node_bytes = desc["node_frag_bytes"]

        # 1) strategy-specific redundancy
        if strategy == Strategy.PARTNER:
            buddy = self.cluster.buddy_of(node)
            try:
                buddy_nvm = self._nvm(buddy)
                return b"".join(
                    buddy_nvm.get(_partner_key(step, node, j)) for j in range(p)
                )
            except (KeyError, NodeFailure):
                pass
        elif strategy == Strategy.BUDDY:
            buddy = self.cluster.buddy_of(node)
            try:
                buddy_nvm = self._nvm(buddy)
                c = SionContainer.open(buddy_nvm, _buddy_container_key(step, node))
                return b"".join(
                    c.read_chunk(node * p + j, f"proc{j}") for j in range(p)
                )
            except (KeyError, IOError, NodeFailure):
                pass
        elif strategy == Strategy.XOR:
            try:
                return self._recover_via_xor(desc, step, node, have)
            except (KeyError, RuntimeError, NodeFailure):
                pass
        elif strategy == Strategy.NAM_XOR:
            try:
                return self._recover_via_nam(desc, step, node, have)
            except (KeyError, RuntimeError, NodeFailure):
                pass

        # 2) the BeeOND-staged copy: save() staged every fragment in the
        #    cache domain, so within this process it is as good as NVM —
        #    valid even when the global flush has not committed yet
        key = _global_key(step, node)
        if self.beeond.cached(key):
            return self.beeond.get(key)
        # 3) last resort: the drained global copy, read *through the stack*
        #    so the hit promotes back into the cache domain (a restore that
        #    touches one fragment will likely touch its neighbours too)
        if desc.get("drained"):
            return self.stack.get(key)
        raise IOError(f"fragment of node {node} unrecoverable for step {step}")

    def _recover_via_xor(
        self, desc: Dict, step: int, node: int, have: Dict[int, bytes]
    ) -> bytes:
        group = self.cluster.xor_group_of(node)
        g = len(group)
        local_idx = group.index(node)
        frag_map: Dict[int, bytes] = {}
        parity_map: Dict[int, bytes] = {}
        for i, member in enumerate(group):
            if member == node:
                continue
            frag_map[i] = have.get(member) or self._read_own_for(desc, step, member)
            parity_map[i] = self._nvm(member).get(_parity_key(step))
        return parity.reconstruct_xor_group(
            local_idx, frag_map, parity_map, g, desc["node_frag_bytes"]
        )

    def _recover_via_nam(
        self, desc: Dict, step: int, node: int, have: Dict[int, bytes]
    ) -> bytes:
        assert self.nam is not None, "NAM_XOR restore requires the NAM device"
        group = self.cluster.xor_group_of(node)
        gid = self.cluster.xor_groups.index(group)
        local_idx = group.index(node)
        frag_map: Dict[int, bytes] = {}
        for i, member in enumerate(group):
            if member == node:
                continue
            frag_map[i] = have.get(member) or self._read_own_for(desc, step, member)
        # read through the stack: the parity key's home is the nam level,
        # but a host-fallback copy that spilled lower is found too
        nam_parity = self.stack.get(_nam_region(step, gid))
        return parity.reconstruct_from_nam(local_idx, frag_map, nam_parity, len(group))

    def _rebuild_local(self, desc: Dict, step: int, node: int, fragment: bytes) -> None:
        """Re-establish the recovered node's local copy (SCR rebuild)."""
        p = desc["procs_per_node"]
        piece = len(fragment) // p
        nvm = self._nvm(node)
        if Strategy(desc["strategy"]) in (Strategy.BUDDY, Strategy.NAM_XOR):
            c = SionContainer()
            for j in range(p):
                c.write_chunk(node * p + j, f"proc{j}", fragment[j * piece : (j + 1) * piece])
            c.store(nvm, _container_key(step))
        else:
            for j in range(p):
                nvm.put(_local_key(step, j), fragment[j * piece : (j + 1) * piece])

    # ------------------------------------------------------------------ #
    # retention
    # ------------------------------------------------------------------ #

    def _prune(self, newest_step: int) -> None:
        if self.keep <= 0:
            return
        steps = self.available_steps()
        # durability guard: never delete the newest *drained* checkpoint —
        # with an async drain in flight for newer steps it may be the only
        # durable copy until their commit lands.  The next prune after a
        # newer drain commits removes it.  Only worth the descriptor scan
        # while async work is actually outstanding.
        newest_drained: Optional[int] = None
        with self._meta_lock:
            scan = bool(self._tickets)
        if scan:
            for s in reversed(steps):
                try:
                    if self._descriptor(s).get("drained"):
                        newest_drained = s
                        break
                except (KeyError, IOError, ValueError):
                    continue
        for old in steps[: max(0, len(steps) - self.keep)]:
            if old == newest_drained:
                continue
            with self._meta_lock:
                ticket = self._tickets.get(old)
            if (ticket is not None and not ticket.done()
                    and scan and newest_drained is None):
                # nothing has drained yet: this step's in-flight drain may
                # become the ONLY durable copy — keep it until a newer
                # drain commits (the next prune after that removes it)
                continue
            if ticket is not None and ticket.try_cancel():
                self.drain_stats["cancelled"] += 1
            self._delete_step(old)

    def _delete_step(self, step: int) -> None:
        prefix = f"ckpt/step{step:08d}/"
        for node in self.cluster.up_ranks():
            try:
                nvm = self._nvm(node)
            except NodeFailure:
                continue
            for key in list(nvm.keys()):
                if key.startswith(prefix):
                    nvm.delete(key)
        nam_prefix = f"nam_parity/step{step:08d}"
        with self._meta_lock:
            self._tickets.pop(step, None)
            for key in list(self.stack.keys()):
                if (key.startswith(prefix) or key == _desc_key(step)
                        or key.startswith(nam_prefix)):
                    # routes through the stack: the beeond level cancels any
                    # pending drain of the key before deleting both copies,
                    # and a nam level frees the region (pool capacity back).
                    # The nam_prefix match also sweeps host-fallback parity
                    # copies that landed on lower levels.
                    self.stack.delete(key)
        if self.nam is not None:
            for key in list(self.nam.tier.keys()):
                if key.startswith(nam_prefix):
                    self.nam.free(key)   # NAM device not fronted by a level
