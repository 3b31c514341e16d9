"""Continuous batching of many decode streams over one paged KV pool.

Counterpart of ``repro/serve/scheduler.py``.  This slice ports the
scheduler core that :class:`PagedServeScheduler` inherits (submission,
the run queue, quantum round-robin, stream bookkeeping, stats) and
:class:`PagedServeScheduler` itself without a pager, a prefix cache or a
session: parked streams keep their pages in the pool, and a full pool
defers admission.  Scheduling decisions depend only on submission order,
``quantum`` and the slot count, never on clocks, so the port makes the
same decisions as the reference.

Waits for the resilient-serving slice of ROADMAP.md: ``save`` /
``restore``, the ``KVPager`` (spill and refill), the ``PrefixCache``, and
the contiguous ``ServeScheduler`` decode loop.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.memory.tiers import CapacityError
from repro_torch.models.registry import ModelApi
from repro_torch.obs.metrics import Registry, StatsView
from repro_torch.obs.trace import Tracer, default_tracer

PREFILL_BUCKET = 8  # prompt-suffix chunk size of the paged prefill

_WAITS = "waits for the resilient-serving slice of ROADMAP.md"


class StreamState(str, enum.Enum):
    WAITING = "waiting"   # submitted, never run
    ACTIVE = "active"     # owns a slot
    PARKED = "parked"     # off its slot; its pages stay in the pool
    DONE = "done"


@dataclasses.dataclass
class DecodeStream:
    """One decode request: prompt in, greedy continuation out.

    ``tokens`` is the full token history (prompt, then every emitted
    token); ``pos`` counts tokens consumed into the KV, so the next
    input is always ``tokens[pos]``.
    """

    sid: int
    tokens: List[int]            # prompt + emitted history
    plen: int                    # prompt length
    max_new: int
    submitted_step: int
    pos: int = 0
    state: StreamState = StreamState.WAITING
    slot: Optional[int] = None
    ran: int = 0                 # steps since last admit (quantum accounting)
    finished_step: Optional[int] = None
    quantum_weight: int = 1      # priority class: quantum multiplier

    @property
    def emitted(self) -> List[int]:
        return self.tokens[self.plen:]

    @property
    def n_emitted(self) -> int:
        return len(self.tokens) - self.plen

    def next_input(self) -> int:
        return self.tokens[self.pos]


class ServeScheduler:
    """The scheduler core over ``slots`` lanes: submission, run queue,
    stream table and stats.  Its contiguous decode loop (one lane cache
    per slot) waits for a later slice; :class:`PagedServeScheduler`
    supplies admission, parking and the decode step."""

    def __init__(
        self,
        cfg: ArchConfig,
        model: ModelApi,
        params: Any,
        slots: int,
        max_len: int,
        pager: Any = None,
        session: Any = None,
        quantum: int = 0,
        prefix: Any = None,
        registry: Optional[Registry] = None,
        tracer: Optional[Tracer] = None,
    ):
        for name, given in (("pager", pager), ("session", session),
                            ("prefix", prefix)):
            if given is not None:
                raise NotImplementedError(f"{name}= {_WAITS}")
        if slots < 1:
            raise ValueError("need at least one decode slot")
        if quantum < 0:
            raise ValueError("quantum must be >= 0")
        self.cfg = cfg
        self.model = model
        self.params = params
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.quantum = int(quantum)
        self.registry = registry if registry is not None else Registry()
        self.tracer = tracer if tracer is not None else default_tracer()
        # one lane's cache layout, shapes and dtypes only
        self._lane_template = model.init_cache(cfg, 1, max_len, device="meta")
        self._slot_sid: List[Optional[int]] = [None] * self.slots
        self.streams: Dict[int, DecodeStream] = {}
        self._runq: Deque[int] = deque()
        self._next_sid = 0
        self.step_count = 0
        self.stats = StatsView(self.registry, "sched", {
            "steps": 0, "joined": 0, "parked": 0, "resumed": 0,
            "finished": 0, "park_failures": 0, "max_resident": 0,
            "prefill_calls": 0, "prefill_tokens": 0,
            "prefix_hits": 0, "prefill_tokens_saved": 0,
        })

    # -- submission -------------------------------------------------------- #

    def submit(self, prompt: Sequence[int], max_new: int,
               quantum_weight: int = 1) -> int:
        """Queue one decode stream; it joins a slot at the next step
        boundary.  A weight-``w`` stream runs ``w * quantum`` consecutive
        steps before round-robin preemption parks it.  Returns the
        stream id."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_len:
            raise ValueError(f"prompt of {len(prompt)} tokens >= max_len "
                             f"{self.max_len}")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if quantum_weight < 1:
            raise ValueError("quantum_weight must be >= 1")
        sid = self._next_sid
        self._next_sid += 1
        self.streams[sid] = DecodeStream(
            sid=sid, tokens=list(prompt), plen=len(prompt), max_new=int(max_new),
            submitted_step=self.step_count,
            quantum_weight=int(quantum_weight))
        self._runq.append(sid)
        self.tracer.event("submit", tid=sid, prompt=len(prompt),
                          max_new=int(max_new))
        return sid

    # -- the decode loop ---------------------------------------------------- #

    def _finish(self, s: DecodeStream) -> None:
        assert s.slot is not None
        self._slot_sid[s.slot] = None
        s.state, s.slot = StreamState.DONE, None
        s.finished_step = self.step_count
        self.stats["finished"] += 1
        self.tracer.event("finish", tid=s.sid, emitted=s.n_emitted)

    def step(self) -> List[Tuple[int, int]]:
        raise NotImplementedError(f"the contiguous decode loop {_WAITS}")

    def unfinished(self) -> int:
        return sum(1 for s in self.streams.values()
                   if s.state is not StreamState.DONE)

    def run(self, max_steps: Optional[int] = None) -> int:
        """Step until every stream finishes (or ``max_steps``); returns
        the number of steps taken."""
        taken = 0
        while self.unfinished() and (max_steps is None or taken < max_steps):
            self.step()
            taken += 1
        return taken

    def output(self, sid: int) -> List[int]:
        """Tokens emitted so far for one stream."""
        return list(self.streams[sid].emitted)

    def close(self) -> None:
        pass


class PagedServeScheduler(ServeScheduler):
    """Continuous batching over one pool-resident paged KV buffer.

    Every stream's KV lives in one shared
    :class:`~repro_torch.serve.pagepool.DevicePagePool`, and each step
    hands ``model.paged_decode_step`` a page *table* per slot:

    * admit / park / resume move table entries, never KV bytes — a
      parked stream's pages stay where they are;
    * speculative multi-token decode: with ``spec_k`` > 0 each step feeds
      ``1 + spec_k`` tokens per stream — the committed next input plus
      ``spec_k`` candidates from an
      :class:`~repro_torch.serve.spec.NGramProposer` — verified in one
      call; the accepted prefix commits, and because every token runs the
      same per-token computation, the emitted sequence equals
      single-token greedy decode for any ``spec_k``.

    The parameters are cast once to the compute dtype where the decode
    path reads them in that dtype (``model.cast_params``).  Inactive
    slots point their whole table at the pool's trash page.  The pool
    lives on the parameters' device.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        model: ModelApi,
        params: Any,
        slots: int,
        max_len: int,
        pager: Any = None,
        session: Any = None,
        quantum: int = 0,
        prefix: Any = None,
        page_tokens: int = 8,
        pool_pages: Optional[int] = None,
        spec_k: int = 0,
        proposer: Optional[Any] = None,
        kv_codec: Optional[str] = None,
        registry: Optional[Registry] = None,
        tracer: Optional[Tracer] = None,
    ):
        super().__init__(cfg, model, params, slots, max_len, pager=pager,
                         session=session, quantum=quantum, prefix=prefix,
                         registry=registry, tracer=tracer)
        if model.paged_decode_step is None:
            raise ValueError(
                f"model family {model.family!r} has no paged_decode_step "
                "(snapshot-state families cannot decode through page tables)")
        if spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        from repro_torch.serve.pagepool import TRASH_PAGE, DevicePagePool
        from repro_torch.serve.spec import NGramProposer
        if kv_codec not in (None, "none", "zlib", "int8"):
            raise ValueError(
                f"unknown kv_codec {kv_codec!r} (want none|zlib|int8)")
        self.kv_codec = "none" if kv_codec is None else str(kv_codec)
        if model.cast_params is not None:
            self.params = model.cast_params(params, cfg)
        self.device = params["embed"].device
        if pool_pages is None:
            # enough for 2x oversubscription before anything spills
            pool_pages = 2 * self.slots * (self.max_len // page_tokens)
        self.pool = DevicePagePool(
            self._lane_template, model.cache_axes(cfg, 1, max_len),
            page_tokens, pool_pages, quantized=(self.kv_codec == "int8"),
            device=self.device)
        self.spec_k = int(spec_k)
        self.proposer = proposer if proposer is not None else NGramProposer()
        self._ptables: Dict[int, List[int]] = {}    # sid -> phys per page
        self._trash = TRASH_PAGE
        self._tables_arr = np.full(
            (self.slots, self.pool.pages_per_lane), self._trash, np.int32)
        self.stats.update({
            "kv_resume_bytes_moved": 0, "spec_proposed": 0,
            "spec_accepted": 0, "spilled": 0, "refilled": 0,
            "admit_deferred": 0, "prefix_pool_shared": 0,
            "prefix_pool_loads": 0, "pool_prefix_dropped": 0,
        })

    def _paged_fn(self, tables: np.ndarray, pos: np.ndarray,
                  toks: np.ndarray) -> np.ndarray:
        """One ``paged_decode_step`` on host arrays; updates the pool in
        place and returns the (B, T) argmax tokens on the host."""
        dev = self.device
        with torch.inference_mode():
            out, self.pool.leaves = self.model.paged_decode_step(
                self.params, self.pool.leaves,
                torch.as_tensor(tables, device=dev),
                torch.as_tensor(pos, device=dev),
                torch.as_tensor(toks, device=dev), self.cfg)
        return out.cpu().numpy()

    # -- admission ---------------------------------------------------------- #

    def _paged_prefill(self, table: List[int], tokens: List[int],
                       t0: int, t1: int) -> None:
        """Consume ``tokens[t0:t1]`` through the paged step in
        :data:`PREFILL_BUCKET`-token chunks.  Chunk padding writes garbage
        KV past ``t1`` — into this stream's own pages beyond its committed
        length, never attended and overwritten by later real writes."""
        tables = np.asarray(table, np.int32)[None]
        i = t0
        while i < t1:
            m = min(PREFILL_BUCKET, t1 - i)
            buf = np.zeros((1, PREFILL_BUCKET), np.int32)
            buf[0, :m] = tokens[i:i + m]
            self._paged_fn(tables, np.asarray([i], np.int32), buf)
            self.stats["prefill_calls"] += 1
            self.stats["prefill_tokens"] += m
            i += m

    def _admit_fresh(self, s: DecodeStream) -> List[int]:
        """A joining stream's page table: fresh pages for the whole lane
        (all-or-nothing), prompt prefilled in place."""
        target = s.plen - 1        # the last prompt token runs in the slot
        table = self.pool.alloc(self.pool.pages_per_lane)
        with self.tracer.span("prefill", tid=s.sid,
                              tokens=max(target, 0), saved=0):
            self._paged_prefill(table, s.tokens, 0, target)
        s.pos = max(target, 0)
        return table

    def _admit(self, sid: int, slot: int) -> None:
        s = self.streams[sid]
        if s.state is StreamState.PARKED:
            # pages never left the pool — resume moves 0 KV bytes
            self.stats["resumed"] += 1
        else:
            self._ptables[sid] = self._admit_fresh(s)
            self.stats["joined"] += 1
        s.state, s.slot, s.ran = StreamState.ACTIVE, slot, 0
        self._slot_sid[slot] = sid
        self._tables_arr[slot] = self._ptables[sid]

    def _try_admit(self, sid: int, slot: int) -> bool:
        """Admit, or defer while the pool is full (spilling parked
        streams through a pager waits for the resilient-serving slice)."""
        try:
            self._admit(sid, slot)
            return True
        except CapacityError:
            self.stats["admit_deferred"] += 1
            return False

    def _park(self, sid: int) -> bool:
        """Park = host bookkeeping: the stream's pages stay resident and
        referenced, only its slot's table row is pointed at the trash
        page."""
        s = self.streams[sid]
        assert s.state is StreamState.ACTIVE and s.slot is not None
        self._tables_arr[s.slot] = self._trash
        self._slot_sid[s.slot] = None
        s.state, s.slot = StreamState.PARKED, None
        self._runq.append(sid)
        self.stats["parked"] += 1
        self.tracer.event("park", tid=sid)
        return True

    def _schedule(self) -> None:
        for slot in range(self.slots):
            if self._slot_sid[slot] is None and self._runq:
                sid = self._runq.popleft()
                if not self._try_admit(sid, slot):
                    self._runq.appendleft(sid)
                    return
        if not self._runq or self.quantum <= 0:
            return
        for slot in range(self.slots):
            if not self._runq:
                return
            sid = self._slot_sid[slot]
            if (sid is None or self.streams[sid].ran
                    < self.quantum * self.streams[sid].quantum_weight):
                continue
            self._park(sid)
            nxt = self._runq.popleft()
            if not self._try_admit(nxt, slot):
                self._runq.appendleft(nxt)
                return

    def _finish(self, s: DecodeStream) -> None:
        slot = s.slot
        super()._finish(s)
        self._tables_arr[slot] = self._trash
        for phys in self._ptables.pop(s.sid, []):
            self.pool.deref(phys)

    def resident_streams(self) -> int:
        """Active lanes plus parked streams (every parked stream stays in
        the pool)."""
        return sum(1 for s in self.streams.values()
                   if s.state in (StreamState.ACTIVE, StreamState.PARKED))

    # -- the decode loop ---------------------------------------------------- #

    def step(self) -> List[Tuple[int, int]]:
        """One batched paged decode step.  With ``spec_k`` > 0 each active
        stream feeds its committed next input plus ``spec_k`` proposed
        candidates; the accepted prefix (argmax agreement) commits, the
        rest is discarded.  May emit several ``(sid, token)`` pairs per
        stream per step."""
        _sp = self.tracer.begin("step", tid=0)
        self._schedule()
        active = [(slot, self.streams[sid])
                  for slot, sid in enumerate(self._slot_sid)
                  if sid is not None]
        if not active:
            self.tracer.end(_sp, active=0)
            return []
        T = self.spec_k + 1
        feed = np.zeros((self.slots, T), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        known = {}
        for slot, s in active:
            pos[slot] = s.pos
            k = min(T, len(s.tokens) - s.pos)
            feed[slot, :k] = s.tokens[s.pos:s.pos + k]
            known[s.sid] = k
            # draft only what the commit loop can still accept
            want = max(0, min(T - k, s.max_new - s.n_emitted - 1,
                              self.max_len - s.pos - k))
            if want:
                feed[slot, k:k + want] = self.proposer.propose(
                    s.tokens, want)
                self.stats["spec_proposed"] += want
        out = self._paged_fn(self._tables_arr, pos, feed)
        emitted: List[Tuple[int, int]] = []
        for slot, s in active:
            s.ran += 1
            accepted = 0
            i = 0
            while True:
                s.pos += 1
                if s.pos >= len(s.tokens):
                    tok = int(out[slot, i])
                    s.tokens.append(tok)
                    emitted.append((s.sid, tok))
                if s.n_emitted >= s.max_new or s.pos >= self.max_len:
                    self._finish(s)
                    break
                i += 1
                if i >= T or feed[slot, i] != s.tokens[s.pos]:
                    break       # candidate rejected: discard the rest
                if i >= known[s.sid]:
                    accepted += 1
            self.stats["spec_accepted"] += accepted
        self.step_count += 1
        self.stats["steps"] += 1
        self.stats["max_resident"] = max(self.stats["max_resident"],
                                         self.resident_streams())
        self.tracer.end(_sp, active=len(active), emitted=len(emitted))
        return emitted
