"""BeeOND-style cache file system (DEEP-ER §III-C).

BeeGFS-on-demand (BeeOND) builds a cache domain from the node-local NVM
devices in front of the global parallel file system.  Writes land on the
local tier at NVM speed; a *sync* cache also writes through to global
storage, an *async* cache drains in the background so the application is
decoupled from the global-storage bottleneck (the Fig 6 scaling argument:
local bandwidth is per-node constant, global bandwidth is shared).

``CacheFS`` wraps a (local_tier, global_tier) pair with exactly those two
modes plus the consistency operations checkpointing needs: ``flush`` (drain
barrier) and read-through ``get`` with best-effort cache fill.  It is a
full :class:`~repro.memory.store.BufferStore`, so a cache domain can sit
as a level inside a ``TierStack`` (memory/stack.py) — which is how the
SCR drain pipeline routes checkpoints through the BeeOND level.

Semantics worth pinning down:

* ``exists``/``get`` are *read-through* (the domain fronts global
  storage); ``keys``/``used_bytes`` describe the cache itself.
* ``delete`` first cancels any pending drain of the key and waits out an
  in-flight one, so a deleted key can neither be resurrected in global
  storage by a straggling drain nor fail the drain loop.
* ``evict`` drops only a *clean* local copy (drained or read-filled) —
  the router's capacity-pressure path — and refuses dirty keys.
* ``max_pending`` bounds the drain queue: ``put``/``put_stream`` block
  once that many keys are waiting (backpressure against a writer that
  outruns global storage).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

from repro_torch.memory.tiers import CapacityError, MemoryTier


class CacheFS:
    def __init__(
        self,
        local: MemoryTier,
        global_tier: MemoryTier,
        mode: str = "async",
        drain_streams: int = 1,
        max_pending: Optional[int] = None,
    ):
        if mode not in ("sync", "async", "local-only"):
            raise ValueError(mode)
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.local = local
        self.global_tier = global_tier
        self.mode = mode
        self.drain_streams = drain_streams
        self._q: "queue.Queue[Optional[str]]" = queue.Queue()
        self._pending: Dict[str, int] = {}     # key -> queued drain count
        self._failed: set = set()              # keys whose drain failed: dirty
        self._inflight_key: Optional[str] = None
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._slots = (threading.Semaphore(max_pending)
                       if (max_pending and mode == "async") else None)
        self._errors: List[BaseException] = []
        self.drained_modelled_s = 0.0          # modelled seconds of bg drains
        self._drainer: Optional[threading.Thread] = None
        if mode == "async":
            self._drainer = threading.Thread(target=self._drain_loop, daemon=True)
            self._drainer.start()

    # -- write path ------------------------------------------------------ #

    def _enqueue(self, key: str, write) -> float:
        """Async-mode write: register the pending drain *before* the local
        write lands so eviction can never race a not-yet-queued drain."""
        if self._slots is not None:
            self._slots.acquire()              # backpressure
        with self._lock:
            self._pending[key] = self._pending.get(key, 0) + 1
            self._failed.discard(key)          # the new write re-drains
        try:
            t = write()
        except BaseException:
            with self._lock:
                self._unregister(key)
            if self._slots is not None:
                self._slots.release()
            raise
        self._q.put(key)
        return t

    def _unregister(self, key: str) -> None:
        n = self._pending.get(key, 0) - 1
        if n > 0:
            self._pending[key] = n
        else:
            self._pending.pop(key, None)

    def put(self, key: str, data: bytes, streams: int = 1) -> float:
        """Write to the cache domain; returns modelled *foreground* seconds.

        sync  : local + global both on the critical path (write-through).
        async : local only; global write happens on the drain thread.
        """
        if self.mode == "async":
            return self._enqueue(key, lambda: self.local.put(key, data, streams=streams))
        t = self.local.put(key, data, streams=streams)
        if self.mode == "sync":
            t += self.global_tier.put(key, data, streams=streams)
        return t

    def put_stream(self, key: str, chunks, streams: int = 1) -> float:
        """Streamed write into the cache domain (see MemoryTier.put_stream).

        The chunk iterable is consumed exactly once, into the local tier;
        the write-through (sync) and drain (async) copies re-read from the
        local tier chunk by chunk — the same staging step a real BeeOND
        performs, with no full-value join.
        """
        if self.mode == "async":
            return self._enqueue(
                key, lambda: self.local.put_stream(key, chunks, streams=streams))
        t = self.local.put_stream(key, chunks, streams=streams)
        if self.mode == "sync":
            t += self.global_tier.put_stream(
                key, self.local.get_stream(key), streams=streams)
        return t

    def _drain_loop(self) -> None:
        while True:
            key = self._q.get()
            if key is None:
                self._q.task_done()
                return
            try:
                with self._lock:
                    live = key in self._pending
                    if live:
                        self._inflight_key = key
                if live:
                    try:
                        t = self.global_tier.put_stream(
                            key,
                            self.local.get_stream(key, streams=self.drain_streams),
                            streams=self.drain_streams,
                        )
                        with self._lock:
                            self.drained_modelled_s += t
                            self._failed.discard(key)   # this drain landed
                    except BaseException as e:  # surfaced at flush()
                        with self._lock:
                            self._errors.append(e)
                            self._failed.add(key)   # global copy never landed
            finally:
                with self._lock:
                    if self._inflight_key == key:
                        self._inflight_key = None
                    self._unregister(key)
                    self._cv.notify_all()
                if self._slots is not None:
                    self._slots.release()
                self._q.task_done()

    def flush(self) -> None:
        """Barrier: wait until every queued write reached global storage."""
        if self.mode == "async":
            self._q.join()
        with self._lock:
            if not self._errors:
                return
            err, self._errors = self._errors[0], []
        raise IOError("async drain failed") from err

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- read path ------------------------------------------------------- #

    def get(self, key: str, streams: int = 1, fill: bool = True) -> bytes:
        """Read-through: local hit, else global (optionally filling cache).

        The cache fill is best-effort: a full local tier serves the global
        copy instead of raising CapacityError.
        """
        if self.local.exists(key):
            return self.local.get(key, streams=streams)
        data = self.global_tier.get(key, streams=streams)
        if fill:
            try:
                self.local.put(key, data, streams=streams)
            except CapacityError:
                pass
        return data

    def fill(self, key: str, data: bytes) -> bool:
        """Establish a *clean* local copy of an already-durable value — a
        cache fill, not a write: no drain is enqueued (the global copy is
        the source).  Best-effort: a full local tier refuses (False).  The
        TierStack routes read-promotion through this instead of ``get``'s
        implicit fill so the fill obeys the same admission control as any
        other write into the level."""
        try:
            self.local.put(key, data)
            return True
        except CapacityError:
            return False

    def exists(self, key: str) -> bool:
        return self.local.exists(key) or self.global_tier.exists(key)

    def cached(self, key: str) -> bool:
        """True when the cache domain itself holds the key (a staged write
        or a read-fill), regardless of the global copy."""
        return self.local.exists(key)

    # -- delete / evict --------------------------------------------------- #

    def delete(self, key: str) -> None:
        """Delete from both tiers, never racing the async drain.

        Queued drains of the key are cancelled (the drain loop skips keys
        no longer pending); an *in-flight* drain is waited out so it can
        neither resurrect the key in global storage after the delete nor
        fail the drain loop reading a vanished local copy.
        """
        with self._lock:
            self._pending.pop(key, None)       # cancel queued drains
            self._failed.discard(key)
            while self._inflight_key == key:   # wait out an in-flight drain
                self._cv.wait(timeout=60)
        self.local.delete(key)
        self.global_tier.delete(key)

    def evict(self, key: str) -> bool:
        """Drop a *clean* local copy (capacity-pressure path).  Refuses keys
        whose drain has not landed — or failed — evicting those would lose
        the only copy.  The check and the delete happen under one lock so a
        concurrent ``put`` of the key cannot slip between them."""
        with self._lock:
            if (key in self._pending or key in self._failed
                    or self._inflight_key == key):
                return False
            if not self.local.exists(key):
                return False
            self.local.delete(key)
            return True

    # -- introspection (the cache itself, not the global level) ----------- #

    def keys(self) -> Iterator[str]:
        yield from self.local.keys()

    def used_bytes(self) -> int:
        return self.local.used_bytes()

    def capacity_bytes(self) -> int:
        return self.local.capacity_bytes()

    def close(self) -> None:
        if self.mode == "async" and self._drainer is not None:
            self.flush()
            self._q.put(None)
            self._drainer.join(timeout=10)
            self._drainer = None
