"""ServeScheduler: continuous batching of many decode streams + paging.

Counterpart of ``repro/serve/scheduler.py``.  The scheduler runs a fixed
number of decode *slots* and moves streams through them with continuous
batching:

* streams join and leave at **step boundaries** (a freed slot is reused
  by the next queued stream the very next step);
* a joining stream's prompt is **prefilled** before it takes its slot
  (:func:`make_prefill_fn`), one ``model.decode_step`` per prompt token,
  so the lane cache equals token-by-token prefill;
* with a :class:`~repro_torch.serve.prefix.PrefixCache` attached, the
  shared part of the prompt is not computed at all: the scheduler
  fetches the cached prefix pages, prefills only the **non-shared
  suffix**, and registers the new pages for the next stream
  (``stats["prefill_tokens_saved"]``);
* with more live streams than slots, the scheduler round-robins: after
  ``quantum`` steps an active stream is *parked* — its lane cache paged
  through the :class:`~repro_torch.serve.kvpage.KVPager` into the tier
  stack as content-addressed pages.

The contiguous :class:`ServeScheduler` keeps one lane cache per slot on
the device and runs one batch-1 ``decode_step`` per slot per step
(:func:`make_slot_serve_step`), each at its own position, inactive slots
included (token 0 at position 0, as
the reference's vmapped step runs them), so its checkpoint's ``slots``
leaf has the reference's layout.  :class:`PagedServeScheduler` keeps
every stream's KV in one shared page pool.

The whole multi-stream state — lane caches or the pool, every stream's
token history and cursor, the run queue, the dedup'd page pool of every
parked stream's table, and the prefix-cache trie with its refcounts —
is checkpointed through one
:class:`~repro_torch.api.session.ResilienceSession` transaction in the
reference's layout (leaf names, dtype names, meta JSON), so a checkpoint
written by either package restores in the other.

Determinism contract: scheduling decisions depend only on (stream
submission order, quantum, slot count), never on wall clocks — so a
restored scheduler replays the exact same interleaving, and the port
makes the same decisions as the reference.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import math
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.api.session import ResilienceSession
from repro_torch.configs.base import ArchConfig
from repro_torch.io.serialization import serialize_state
from repro_torch.memory.codecs import CodecRule, make_codec
from repro_torch.memory.stack import KeyClass
from repro_torch.memory.tiers import CapacityError
from repro_torch.models.registry import ModelApi
from repro_torch.obs.metrics import Registry, StatsView
from repro_torch.obs.trace import Tracer, default_tracer
from repro_torch.serve.kvpage import KVPager
from repro_torch.serve.prefix import PrefixCache

PREFILL_BUCKET = 8  # prompt-suffix pad granularity / paged prefill chunk


class StreamState(str, enum.Enum):
    WAITING = "waiting"   # submitted, never run
    ACTIVE = "active"     # owns a slot
    PARKED = "parked"     # off its slot: KV parked in the pool or the pager
    DONE = "done"


_STATE_CODE = {s: i for i, s in enumerate(StreamState)}
_CODE_STATE = {i: s for s, i in _STATE_CODE.items()}


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


def _decode_into(cfg: ArchConfig, model: ModelApi, params: Any,
                 lane: Dict[str, torch.Tensor], token: torch.Tensor,
                 pos: int) -> torch.Tensor:
    """One batch-1 ``model.decode_step`` written into the device lane
    ``lane`` in place; returns the logits (1, vocab)."""
    logits, new = model.decode_step(params, lane, token, pos, cfg)
    for k, v in new.items():
        if v is not lane[k]:         # families that return fresh caches
            lane[k].copy_(v)
    return logits


def make_slot_serve_step(cfg: ArchConfig, model: ModelApi) -> Callable:
    """One greedy decode step over independent slots.

    Each slot's lane is a batch-1 ``model.decode_step`` at its *own*
    position, so the slot axis can hold streams at arbitrary, unequal
    offsets.  ``step(params, slots_cache, tokens (S, 1), pos (S,))``
    writes every lane in place and returns ``(next (S, 1) int32,
    slots_cache)``.
    """

    def step(params, slots_cache, tokens, pos):
        out = []
        with torch.inference_mode():
            for slot in range(tokens.shape[0]):
                lane = {k: v[slot] for k, v in slots_cache.items()}
                logits = _decode_into(cfg, model, params, lane, tokens[slot],
                                      int(pos[slot]))
                out.append(logits.argmax(dim=-1).to(torch.int32))
        return torch.stack(out), slots_cache

    return step


def make_prefill_fn(cfg: ArchConfig, model: ModelApi) -> Callable:
    """Prefill of one lane's prompt suffix.

    ``prefill(params, lane, tokens, start, n_valid)`` runs the same
    ``model.decode_step`` the serve loop uses for each of the first
    ``n_valid`` tokens of the padded buffer (so the lane cache equals
    token-by-token prefill); the reference's scan steps at or past
    ``n_valid`` leave the lane unchanged, so they are not run.  The lane
    is written in place and returned.
    """

    def prefill(params, lane, tokens, start, n_valid):
        dev = next(iter(lane.values())).device
        with torch.inference_mode():
            for i in range(int(n_valid)):
                tok = torch.tensor([int(tokens[i])], device=dev)
                _decode_into(cfg, model, params, lane, tok, int(start) + i)
        return lane

    return prefill


def _host(lane: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A host copy of a lane (or of a stack of lanes)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in lane.items()}


class ServeScheduler:
    """Continuous-batching decode scheduler over ``slots`` lanes.

    ``pager=None`` disables paging: oversubscribed streams simply wait
    for a slot to free up at stream completion.  With a pager,
    ``quantum`` > 0 enables round-robin preemption: an active stream
    that has run ``quantum`` consecutive steps while others queue is
    parked through the pager.  A park the tier stack cannot place (flat
    unpaged stack at capacity) leaves the stream running — counted in
    ``stats["park_failures"]``.

    ``prefix`` attaches a :class:`~repro_torch.serve.prefix.PrefixCache`
    (usually over the pager's own stack); prompts then skip their cached
    shared prefix entirely.  The lanes live on the parameters' device;
    the parameters are cast once to the compute dtype where the decode
    path reads them in that dtype (``model.cast_params``).
    """

    def __init__(
        self,
        cfg: ArchConfig,
        model: ModelApi,
        params: Any,
        slots: int,
        max_len: int,
        pager: Optional[KVPager] = None,
        session: Optional[ResilienceSession] = None,
        quantum: int = 0,
        prefix: Optional[PrefixCache] = None,
        registry: Optional[Registry] = None,
        tracer: Optional[Tracer] = None,
    ):
        if slots < 1:
            raise ValueError("need at least one decode slot")
        if quantum < 0:
            raise ValueError("quantum must be >= 0")
        self.cfg = cfg
        self.model = model
        self.params = (model.cast_params(params, cfg)
                       if model.cast_params is not None else params)
        self.device = params["embed"].device
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.pager = pager
        self.session = session
        self.quantum = int(quantum)
        self.prefix = prefix
        # one registry spans the serving stack: the pager's (the tier
        # stack's) unless the caller injects one
        self.registry = (registry if registry is not None
                         else pager.registry if pager is not None
                         else Registry())
        self.tracer = tracer if tracer is not None else default_tracer()
        # one lane's cache on the host: the zeros a fresh lane starts
        # from and the template the pager and checkpoints rebuild against
        self._lane_template = model.init_cache(cfg, 1, max_len, device="cpu")
        self.slots_cache = self._make_slots()
        self._step_fn = make_slot_serve_step(cfg, model)
        self._prefill_fn = make_prefill_fn(cfg, model)
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

    def _make_slots(self) -> Optional[Dict[str, torch.Tensor]]:
        """The stacked lane caches, (slots, *lane shape) per leaf."""
        return {k: torch.zeros((self.slots,) + tuple(v.shape), dtype=v.dtype,
                               device=self.device)
                for k, v in self._lane_template.items()}

    @functools.cached_property
    def _lane_manifest(self) -> Dict[str, Any]:
        """Every lane serializes to this layout (checkpoint restore
        re-parks raw lane bytes against it)."""
        return serialize_state(self._lane_template).manifest

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

    # -- slot management --------------------------------------------------- #

    def _lane(self, slot: int) -> Dict[str, torch.Tensor]:
        """Slot ``slot``'s lane cache as a host copy."""
        return _host({k: v[slot] for k, v in self.slots_cache.items()})

    def _set_lane(self, slot: int, lane: Dict[str, Any]) -> None:
        for k, v in self.slots_cache.items():
            v[slot].copy_(torch.as_tensor(lane[k]))

    # -- prefill ----------------------------------------------------------- #

    def _run_prefill(self, lane: Dict[str, torch.Tensor], tokens: List[int],
                     t0: int, t1: int) -> Dict[str, torch.Tensor]:
        """Consume ``tokens[t0:t1]`` into a device lane (padded to the
        bucket size, as the reference pads its scan)."""
        n = t1 - t0
        if n <= 0:
            return lane
        pad = ((n + PREFILL_BUCKET - 1) // PREFILL_BUCKET) * PREFILL_BUCKET
        buf = np.zeros((pad,), np.int32)
        buf[:n] = tokens[t0:t1]
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += n
        return self._prefill_fn(self.params, lane, buf, t0, n)

    def _prefilled_lane(self, s: DecodeStream) -> Dict[str, torch.Tensor]:
        """Build a joining stream's device lane: fetch the shared prompt
        prefix from the prefix cache (zero compute for those tokens),
        prefill the non-shared suffix, and register the prompt's new
        pages for the streams that come after."""
        target = s.plen - 1        # the last prompt token runs in the slot
        covered = 0
        host_lane = None
        if self.prefix is not None and target > 0:
            with self.tracer.span("prefix_match", tid=s.sid):
                _, path = self.prefix.match(s.tokens[:target])
            live: List[Any] = []
            if path:
                host_lane = self.prefix.layout.zero_lane()
                covered = self.prefix.fetch_into(path, host_lane)
                if covered:
                    live = path[:covered // self.prefix.page_tokens]
                    self.prefix.acquire(s.sid, live)
                    self.stats["prefix_hits"] += 1
                    self.stats["prefill_tokens_saved"] += covered
            if covered < target:
                # partial-page tail: reuse the last, partially-filled
                # page of a common prefix
                tail = self.prefix.match_tail(s.tokens[:target], covered, live)
                if tail is not None:
                    try:
                        part = self.prefix.read_node_part(tail)
                    except (KeyError, IOError):
                        self.prefix._drop_subtree(tail)
                    else:
                        if host_lane is None:
                            host_lane = self.prefix.layout.zero_lane()
                        self.prefix.layout.inject(host_lane, part,
                                                  covered, tail.end)
                        self.prefix.acquire(s.sid, [tail])
                        self.stats["prefill_tokens_saved"] += tail.end - covered
                        covered = tail.end
        src = host_lane if host_lane is not None else self._lane_template
        lane = {k: torch.as_tensor(v).to(self.device, copy=True)
                for k, v in src.items()}
        if self.prefix is not None and self.prefix.mode == "snapshot":
            # snapshot pages need the state *at* each boundary: prefill
            # page-by-page and register every full-page boundary
            pt = self.prefix.page_tokens
            j = covered
            while j + pt <= target:
                lane = self._run_prefill(lane, s.tokens, j, j + pt)
                j += pt
                self.prefix.extend(s.tokens[:j], j, _host(lane), sid=s.sid)
            lane = self._run_prefill(lane, s.tokens, j, target)
        else:
            lane = self._run_prefill(lane, s.tokens, covered, target)
            if self.prefix is not None and target > 0:
                pt = self.prefix.page_tokens
                upto = (target // pt) * pt
                if upto > covered or target > upto:
                    host = _host(lane)
                    if upto > covered:
                        self.prefix.extend(s.tokens[:upto], upto, host,
                                           sid=s.sid)
                    if target > upto:
                        self.prefix.register_tail(s.tokens[:target], target,
                                                  host, sid=s.sid)
        s.pos = max(target, 0)
        return lane

    # -- admit / park ------------------------------------------------------- #

    def _admit(self, sid: int, slot: int) -> None:
        s = self.streams[sid]
        if s.state is StreamState.PARKED:
            assert self.pager is not None
            # release=False retains the page table as the dirty-tracking
            # baseline: the next park re-puts only pages that changed
            with self.tracer.span("resume", tid=sid, slot=slot):
                self._set_lane(slot, self.pager.fetch(sid, self._lane_template,
                                                      release=False))
            self.stats["resumed"] += 1
        else:
            with self.tracer.span("prefill", tid=sid, slot=slot,
                                  plen=s.plen):
                self._set_lane(slot, self._prefilled_lane(s))
            self.stats["joined"] += 1
        s.state, s.slot, s.ran = StreamState.ACTIVE, slot, 0
        self._slot_sid[slot] = sid

    def _park(self, sid: int) -> bool:
        """Page an active stream's lane out; False when the stack refuses
        (unpaged baseline at capacity) — the stream keeps its slot."""
        s = self.streams[sid]
        assert s.state is StreamState.ACTIVE and s.slot is not None
        assert self.pager is not None
        try:
            with self.tracer.span("park", tid=sid):
                self.pager.park(sid, self._lane(s.slot))
        except CapacityError:
            self.stats["park_failures"] += 1
            s.ran = 0      # retry after another quantum, not every step
            return False
        self._slot_sid[s.slot] = None
        s.state, s.slot = StreamState.PARKED, None
        self._runq.append(sid)
        self.stats["parked"] += 1
        return True

    def _schedule(self) -> None:
        """Step-boundary scheduling: fill free slots from the run queue,
        then (queue still non-empty) park quantum-expired active streams
        and hand their slots to waiters — deterministic slot order."""
        for slot in range(self.slots):
            if self._slot_sid[slot] is None and self._runq:
                self._admit(self._runq.popleft(), slot)
        if not self._runq or self.pager is None or self.quantum <= 0:
            return
        for slot in range(self.slots):
            if not self._runq:
                return
            sid = self._slot_sid[slot]
            if sid is None:
                continue
            s = self.streams[sid]
            if (s.ran >= self.quantum * s.quantum_weight
                    and self._park(sid)):
                self._admit(self._runq.popleft(), slot)

    # -- the decode loop ---------------------------------------------------- #

    def _finish(self, s: DecodeStream) -> None:
        assert s.slot is not None
        self._slot_sid[s.slot] = None
        s.state, s.slot = StreamState.DONE, None
        s.finished_step = self.step_count
        self.stats["finished"] += 1
        self.tracer.event("finish", tid=s.sid, emitted=s.n_emitted)
        if self.prefix is not None:
            self.prefix.release_stream(s.sid)
        if self.pager is not None:
            self.pager.release(s.sid)   # retained baseline, if any

    def resident_streams(self) -> int:
        """Streams whose KV currently lives somewhere in the hierarchy:
        active lanes plus parked pages."""
        active = sum(1 for sid in self._slot_sid if sid is not None)
        parked = len(self.pager.parked_sids()) if self.pager is not None else 0
        return active + parked

    def step(self) -> List[Tuple[int, int]]:
        """One decode step over every slot (inactive ones at token 0,
        position 0) at a stream-join/evict boundary.  Returns the
        ``(sid, token)`` pairs emitted this step."""
        _sp = self.tracer.begin("step", tid=0)
        self._schedule()
        active = [(slot, self.streams[sid])
                  for slot, sid in enumerate(self._slot_sid) if sid is not None]
        if not active:
            self.tracer.end(_sp, active=0)
            return []
        tokens = np.zeros((self.slots, 1), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        for slot, s in active:
            tokens[slot, 0] = s.next_input()
            pos[slot] = s.pos
        nxt, self.slots_cache = self._step_fn(
            self.params, self.slots_cache,
            torch.as_tensor(tokens, device=self.device), pos)
        out = nxt.cpu().numpy()[:, 0]
        emitted: List[Tuple[int, int]] = []
        for slot, s in active:
            s.pos += 1
            s.ran += 1
            if s.pos >= s.plen:
                tok = int(out[slot])
                s.tokens.append(tok)
                emitted.append((s.sid, tok))
            if s.n_emitted >= s.max_new or s.pos >= self.max_len:
                self._finish(s)
        self.step_count += 1
        self.stats["steps"] += 1
        self.stats["max_resident"] = max(self.stats["max_resident"],
                                         self.resident_streams())
        self.tracer.end(_sp, active=len(active), emitted=len(emitted))
        return emitted

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

    def latency_steps(self, sid: int) -> Optional[int]:
        s = self.streams[sid]
        if s.finished_step is None:
            return None
        return s.finished_step - s.submitted_step

    def live_descriptors(self) -> List[Dict[str, Any]]:
        """Re-admission descriptors for every unfinished stream: the full
        token history plus the cursors a peer scheduler needs to continue
        the stream exactly (greedy decode is a pure function of token
        history, so prompt' = tokens and max_new' = remaining budget
        reproduce the uninterrupted continuation)."""
        out = []
        for sid in sorted(self.streams):
            s = self.streams[sid]
            if s.state is StreamState.DONE:
                continue
            out.append({
                "sid": sid,
                "tokens": list(s.tokens),
                "plen": s.plen,
                "emitted": list(s.emitted),
                "max_new": s.max_new - s.n_emitted,
                "weight": s.quantum_weight,
            })
        return out

    # -- checkpoint / restore ----------------------------------------------- #
    #
    # Fixed-shape state (the serializer cross-checks template shapes):
    #   slots        stacked lane caches, exactly as resident
    #   tokens       (S, cap) int32 token histories, zero-padded
    #   meta         (S, 10) int32 per-stream cursors (see _META_COLS)
    #   runq         (S,) int32 queue order, -1-padded
    #   slot_sid     (slots,) int32 slot ownership, -1 for free
    #   pages        (P, page_bytes) uint8: the DEDUP'D pool of every
    #                parked stream's pages — each unique page once, the
    #                per-stream tables (references) ride in meta
    #   prefix_pages (Q, max_nbytes) uint8: the prefix-cache payloads
    # Variable facts (S, cap, page tables, trie records, stream refs,
    # step counter) ride in the descriptor's JSON meta, which restore()
    # reads *before* building the template.

    _META_COLS = 10  # plen, ntok, pos, state, slot, max_new, ran, sub, fin, qw

    def _stream_state_arrays(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """The scheduler-core checkpoint pieces shared by the contiguous
        and paged schedulers: stream table, run queue, slot map."""
        sids = sorted(self.streams)
        cap = max((len(self.streams[s].tokens) for s in sids), default=1)
        tokens = np.zeros((len(sids), cap), np.int32)
        meta_arr = np.zeros((len(sids), self._META_COLS), np.int32)
        for row, sid in enumerate(sids):
            s = self.streams[sid]
            tokens[row, :len(s.tokens)] = s.tokens
            meta_arr[row] = [
                s.plen, len(s.tokens), s.pos, _STATE_CODE[s.state],
                -1 if s.slot is None else s.slot, s.max_new, s.ran,
                s.submitted_step,
                -1 if s.finished_step is None else s.finished_step,
                s.quantum_weight,
            ]
        runq = np.full((len(sids),), -1, np.int32)
        runq[:len(self._runq)] = list(self._runq)
        slot_sid = np.asarray(
            [-1 if sid is None else sid for sid in self._slot_sid], np.int32)
        state: Dict[str, Any] = {
            "tokens": tokens,
            "meta": meta_arr,
            "runq": runq,
            "slot_sid": slot_sid,
        }
        meta = {
            "serve": {
                "n_streams": len(sids),
                "cap": int(cap),
                "step_count": int(self.step_count),
                "next_sid": int(self._next_sid),
                "slots": self.slots,
                "max_len": self.max_len,
            }
        }
        return state, meta

    def _load_streams(self, state: Dict[str, Any], n: int) -> None:
        """Rebuild the stream table / run queue / slot map from restored
        checkpoint arrays (the inverse of :meth:`_stream_state_arrays`)."""
        self.streams = {}
        for row in range(n):
            plen, ntok, pos, code, slot, max_new, ran, sub, fin, qw = (
                int(v) for v in state["meta"][row])
            self.streams[row] = DecodeStream(
                sid=row, tokens=[int(t) for t in state["tokens"][row, :ntok]],
                plen=plen, max_new=max_new, submitted_step=sub, pos=pos,
                state=_CODE_STATE[code], slot=None if slot < 0 else slot,
                ran=ran, finished_step=None if fin < 0 else fin,
                quantum_weight=max(1, qw))
        self._runq = deque(int(s) for s in state["runq"] if s >= 0)
        self._slot_sid = [None if s < 0 else int(s)
                          for s in state["slot_sid"]]

    def _pager_state(self, state: Dict[str, Any],
                     meta: Dict[str, Any]) -> None:
        """Export the pager's parked streams: each unique page's bytes
        exactly once, plus the per-stream tables as digest indices.
        Restore re-parks every table and the pool counts recover
        exactly."""
        parked = self.pager.parked_sids() if self.pager is not None else []
        if not parked:
            return
        digests = sorted({d for sid in parked
                          for d in self.pager.page_table(sid)})
        index = {d: i for i, d in enumerate(digests)}
        payloads = [self.pager.page_payload(d) for d in digests]
        # pool-page blobs can exceed the pager's lane-slice page size
        width = max(self.pager.page_bytes, max(len(p) for p in payloads))
        state["pages"] = _pad_stack(payloads, width)
        meta["serve"]["pager"] = {
            "page_bytes": width,
            "page_lens": [len(p) for p in payloads],
            "tables": [[int(sid), int(self.pager.parked_nbytes(sid)),
                        [index[d] for d in self.pager.page_table(sid)],
                        self.pager.parked_kind(sid)]
                       for sid in parked],
        }

    def _prefix_state(self, state: Dict[str, Any],
                      meta: Dict[str, Any]) -> None:
        if self.prefix is None or not len(self.prefix):
            return
        records, payloads = self.prefix.export_nodes()
        state["prefix_pages"] = _pad_stack(
            payloads, max(len(p) for p in payloads))
        meta["serve"]["prefix"] = {
            "page_tokens": self.prefix.page_tokens,
            "mode": self.prefix.mode,
            "nodes": records,
            "page_lens": [len(p) for p in payloads],
            "stream_refs": {str(sid): digests for sid, digests
                            in self.prefix.stream_refs().items()},
        }

    def _serving_state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        state, meta = self._stream_state_arrays()
        state["slots"] = _host(self.slots_cache)
        self._pager_state(state, meta)
        self._prefix_state(state, meta)
        return state, meta

    def save(self, session: Optional[ResilienceSession] = None):
        """Checkpoint the full multi-stream serving state in one session
        transaction, keyed by the scheduler step counter.  Returns the
        :class:`CheckpointRecord`."""
        session = session or self.session
        assert session is not None, "no ResilienceSession attached"
        state, meta = self._serving_state()
        session.start_checkpoint(self.step_count)
        for name, part in state.items():
            session.route(name, part)
        return session.complete_checkpoint(meta=meta)

    def _checkpoint_meta(self, session: ResilienceSession,
                         step: Optional[int]) -> Tuple[int, Dict[str, Any]]:
        """The newest (or given) checkpoint step and its serving meta,
        checked against this scheduler's shape."""
        steps = session.available_steps()
        if not steps:
            raise RuntimeError("no checkpoint available to restore")
        step = max(steps) if step is None else step
        sm = session.checkpoint_meta(step).get("serve")
        if not sm:
            raise RuntimeError(f"checkpoint {step} carries no serving state")
        if sm["slots"] != self.slots or sm["max_len"] != self.max_len:
            raise ValueError(
                f"scheduler shape mismatch: checkpoint has slots={sm['slots']} "
                f"max_len={sm['max_len']}, this scheduler has slots={self.slots} "
                f"max_len={self.max_len}")
        return step, sm

    def _stream_template(self, sm: Dict[str, Any]) -> Dict[str, Any]:
        """The restore template's stream, pager and prefix parts."""
        n, cap = sm["n_streams"], sm["cap"]
        template: Dict[str, Any] = {
            "tokens": np.zeros((n, cap), np.int32),
            "meta": np.zeros((n, self._META_COLS), np.int32),
            "runq": np.zeros((n,), np.int32),
            "slot_sid": np.zeros((self.slots,), np.int32),
        }
        pager_meta, prefix_meta = sm.get("pager"), sm.get("prefix")
        if pager_meta:
            template["pages"] = np.zeros(
                (len(pager_meta["page_lens"]), pager_meta["page_bytes"]),
                np.uint8)
        if prefix_meta:
            template["prefix_pages"] = np.zeros(
                (len(prefix_meta["page_lens"]),
                 max(prefix_meta["page_lens"])), np.uint8)
        return template

    def restore(self, session: Optional[ResilienceSession] = None,
                step: Optional[int] = None) -> int:
        """Rebuild the entire scheduler — stream set, token histories, run
        queue, lane caches, parked page tables over the dedup'd pool, and
        the prefix-cache trie with its stream refcounts — from the newest
        (or given) checkpoint.  The scheduler only needs to be constructed
        with the same model, ``slots`` and ``max_len`` it was saved
        with."""
        session = session or self.session
        assert session is not None, "no ResilienceSession attached"
        step, sm = self._checkpoint_meta(session, step)
        if sm.get("paged"):
            raise RuntimeError(
                "checkpoint was written by the paged scheduler; restore it "
                "with PagedServeScheduler")
        template = self._stream_template(sm)
        template["slots"] = {k: torch.zeros((self.slots,) + tuple(v.shape),
                                            dtype=v.dtype)
                             for k, v in self._lane_template.items()}
        state, got = session.restore_latest(template, step=step)
        self.slots_cache = {k: torch.as_tensor(v).to(self.device)
                            for k, v in state["slots"].items()}
        self._load_streams(state, sm["n_streams"])
        self._restore_pager(state, sm.get("pager"))
        self._restore_prefix(state, sm.get("prefix"))
        self.step_count = int(sm["step_count"])
        self._next_sid = int(sm["next_sid"])
        return got

    def _restore_pager(self, state: Dict[str, Any],
                       pager_meta: Optional[Dict[str, Any]]) -> None:
        if self.pager is not None:
            for sid in self.pager.table_sids():   # parked + retained
                self.pager.release(sid)
        if not pager_meta:
            return
        assert self.pager is not None, \
            "checkpoint has parked streams but this scheduler has no pager"
        payloads = [state["pages"][i, :ln].tobytes()
                    for i, ln in enumerate(pager_meta["page_lens"])]
        for rec in pager_meta["tables"]:
            sid, nbytes, table = rec[0], rec[1], rec[2]
            kind = rec[3] if len(rec) > 3 else "lane"
            if kind == "pool_pages":
                # caller-cut pool pages: each digest payload is one blob
                self.pager.park_pages(int(sid), [payloads[i] for i in table])
            else:
                blob = b"".join(payloads[i] for i in table)[:nbytes]
                # content addressing re-dedups: each unique page is put
                # once, later tables only bump its refcount
                self.pager.park_bytes(int(sid), blob, self._lane_manifest)

    def _restore_prefix(self, state: Dict[str, Any],
                        prefix_meta: Optional[Dict[str, Any]]) -> None:
        if prefix_meta:
            assert self.prefix is not None, \
                "checkpoint has prefix pages but this scheduler has no prefix cache"
            payloads = [state["prefix_pages"][i, :ln].tobytes()
                        for i, ln in enumerate(prefix_meta["page_lens"])]
            self.prefix.restore_nodes(
                prefix_meta["nodes"], payloads,
                {int(sid): ds for sid, ds
                 in prefix_meta["stream_refs"].items()})
        elif self.prefix is not None:
            self.prefix.clear()

    # -- lifecycle ----------------------------------------------------------- #

    def close(self) -> None:
        if self.pager is not None:
            self.pager.close()


class PagedServeScheduler(ServeScheduler):
    """Continuous batching over one pool-resident paged KV buffer.

    Every stream's KV lives in one shared
    :class:`~repro_torch.serve.pagepool.DevicePagePool`, and each step
    hands ``model.paged_decode_step`` a page *table* per slot:

    * **admit / park / resume move table entries, never KV bytes** — a
      parked stream's pages stay where they are
      (``stats["kv_resume_bytes_moved"]`` stays 0);
    * KV bytes move only when pool pressure forces a *spill* through the
      :class:`~repro_torch.serve.kvpage.KVPager` (page-granular,
      content-addressed) and on the matching refill, the only path that
      counts resume bytes;
    * shared prompt prefixes are shared *physically*: a prefix page
      resident in the pool is referenced by every admitted stream's table
      at zero copy and zero compute, and newly prefilled prompt pages are
      registered back to the
      :class:`~repro_torch.serve.prefix.PrefixCache` with payloads cut
      from the pool;
    * speculative multi-token decode: with ``spec_k`` > 0 each step feeds
      ``1 + spec_k`` tokens per stream — the committed next input plus
      ``spec_k`` candidates from an
      :class:`~repro_torch.serve.spec.NGramProposer` — verified in one
      call; the accepted prefix commits, and because every token runs the
      same per-token computation, the emitted sequence equals
      single-token greedy decode for any ``spec_k``.

    Inactive slots point their whole table at the pool's trash page.  The
    pool lives on the parameters' device.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        model: ModelApi,
        params: Any,
        slots: int,
        max_len: int,
        pager: Optional[KVPager] = None,
        session: Optional[ResilienceSession] = None,
        quantum: int = 0,
        prefix: Optional[PrefixCache] = None,
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
        if prefix is not None:
            if prefix.mode != "slice":
                raise ValueError("paged decode needs a slice-mode prefix "
                                 "cache (every leaf with a kv_seq axis)")
            if prefix.page_tokens != page_tokens:
                raise ValueError(
                    f"prefix cache page_tokens {prefix.page_tokens} != pool "
                    f"page_tokens {page_tokens}: pool-resident sharing needs "
                    "one page geometry")
        from repro_torch.serve.pagepool import TRASH_PAGE, DevicePagePool
        from repro_torch.serve.spec import NGramProposer
        if kv_codec not in (None, "none", "zlib", "int8"):
            raise ValueError(
                f"unknown kv_codec {kv_codec!r} (want none|zlib|int8)")
        self.kv_codec = "none" if kv_codec is None else str(kv_codec)
        if pool_pages is None:
            # enough for 2x oversubscription before anything spills
            pool_pages = 2 * self.slots * (self.max_len // page_tokens)
        self.pool = DevicePagePool(
            self._lane_template, model.cache_axes(cfg, 1, max_len),
            page_tokens, pool_pages, quantized=(self.kv_codec == "int8"),
            device=self.device)
        if (self.kv_codec != "none" and pager is not None
                and pager.stack.codec_for(KeyClass.KV) is None):
            # the knob end to end: pool spill blobs encode on demotion
            # too.  Channel width = gcd of the leaves' last axes, so
            # quantization blocks never straddle a channel.
            dims = [int(l.shape[-1]) for l in self._lane_template.values()]
            pager.stack.set_codec(KeyClass.KV, CodecRule(make_codec(
                self.kv_codec, dtype=cfg.compute_dtype,
                block=math.gcd(*dims))))
        self.spec_k = int(spec_k)
        self.proposer = proposer if proposer is not None else NGramProposer()
        self._ptables: Dict[int, List[int]] = {}    # sid -> phys per page
        self._trash = TRASH_PAGE
        self._tables_arr = np.full(
            (self.slots, self.pool.pages_per_lane), self._trash, np.int32)
        if prefix is not None:
            prefix.on_evict = self.pool.drop_digest
        self.stats.update({
            "kv_resume_bytes_moved": 0, "spec_proposed": 0,
            "spec_accepted": 0, "spilled": 0, "refilled": 0,
            "admit_deferred": 0, "prefix_pool_shared": 0,
            "prefix_pool_loads": 0, "pool_prefix_dropped": 0,
        })

    def _make_slots(self) -> None:
        return None          # lanes live in the pool

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
        """Build a joining stream's page table: pool-resident shared
        prefix pages by *reference* (zero copy, zero compute), cached-
        but-not-resident prefix pages loaded from the stack, fresh pages
        for the rest, prompt suffix prefilled in place.  All-or-nothing:
        a CapacityError rolls every reference back."""
        pt = self.pool.page_tokens
        target = s.plen - 1        # the last prompt token runs in the slot
        table: List[int] = []
        covered = 0
        path: List[Any] = []
        if self.prefix is not None and target > 0:
            with self.tracer.span("prefix_match", tid=s.sid):
                _, path = self.prefix.match(s.tokens[:target])
        tail_node = tail_part = None
        try:
            for node in path:
                phys = self.pool.lookup_digest(node.digest)
                if phys is not None:
                    self.pool.ref(phys)
                    self.stats["prefix_pool_shared"] += 1
                else:
                    try:
                        part = self.prefix.read_node_part(node)
                    except (KeyError, IOError):
                        break   # payload lost under stack pressure
                    phys = self.pool.alloc(1)[0]
                    self.pool.write_token_slice(phys, part)
                    self.pool.bind_digest(node.digest, phys)
                    self.stats["prefix_pool_loads"] += 1
                table.append(phys)
                covered = node.end
            if covered:
                self.prefix.acquire(s.sid, path[:covered // pt])
                self.stats["prefix_hits"] += 1
                self.stats["prefill_tokens_saved"] += covered
            if self.prefix is not None and covered < target:
                tail_node = self.prefix.match_tail(
                    s.tokens[:target], covered, path[:covered // pt])
                if tail_node is not None:
                    try:
                        tail_part = self.prefix.read_node_part(tail_node)
                    except (KeyError, IOError):
                        self.prefix._drop_subtree(tail_node)
                        tail_node = None
            table.extend(self.pool.alloc(self.pool.pages_per_lane - len(table)))
        except CapacityError:
            for phys in table:
                self.pool.deref(phys)
            if self.prefix is not None:
                self.prefix.release_stream(s.sid)
            raise
        if tail_node is not None and tail_part is not None:
            # partial-page tail: copied into the stream's own fresh page
            # (the rest of that page is stream-private suffix KV, so
            # physical sharing is impossible — tails save compute only)
            m = tail_node.end - covered
            self.pool.write_token_range(table[covered // pt], tail_part, m)
            self.prefix.acquire(s.sid, [tail_node])
            self.stats["prefill_tokens_saved"] += m
            covered = tail_node.end
        with self.tracer.span("prefill", tid=s.sid,
                              tokens=max(target - covered, 0), saved=covered):
            self._paged_prefill(table, s.tokens, covered, target)
        if self.prefix is not None and target > 0:
            upto = (target // pt) * pt
            if upto > covered:
                new_path = self.prefix.extend(
                    s.tokens[:upto], upto, None, sid=s.sid,
                    payload_fn=lambda end:
                        self.pool.read_token_slice(table[end // pt - 1]))
                for node in new_path[covered // pt:]:
                    # pin the freshly prefilled page as the pool-resident
                    # copy; safe because the owner only ever writes at
                    # positions >= upto (pages past the registered range)
                    if self.pool.lookup_digest(node.digest) is None:
                        self.pool.bind_digest(
                            node.digest, table[node.end // pt - 1])
            if target > upto:
                self.prefix.register_tail(
                    s.tokens[:target], target, None, sid=s.sid,
                    payload_fn=lambda end: self.pool.read_token_range(
                        table[upto // pt], end - upto))
        s.pos = max(target, 0)
        return table

    def _admit(self, sid: int, slot: int) -> None:
        s = self.streams[sid]
        if s.state is StreamState.PARKED:
            if self.pager is not None and self.pager.is_parked(sid):
                # spilled: the only resume path that moves KV bytes
                _sp = self.tracer.begin("fetch", tid=sid)
                phys = self.pool.alloc(self.pool.pages_per_lane)
                try:
                    blobs = self.pager.fetch_pages(sid, release=True)
                except BaseException:
                    for p in phys:
                        self.pool.deref(p)
                    raise
                for p, b in zip(phys, blobs):
                    self.pool.write_blob(p, b)
                self._ptables[sid] = phys
                moved = sum(len(b) for b in blobs)
                self.tracer.end(_sp, bytes_moved=moved)
                self.stats["refilled"] += 1
                self.stats["kv_resume_bytes_moved"] += moved
            # else: pages never left the pool — resume moves 0 KV bytes
            self.stats["resumed"] += 1
        else:
            self._ptables[sid] = self._admit_fresh(s)
            self.stats["joined"] += 1
        s.state, s.slot, s.ran = StreamState.ACTIVE, slot, 0
        self._slot_sid[slot] = sid
        self._tables_arr[slot] = self._ptables[sid]

    def _drop_pool_prefix(self) -> bool:
        """Release one pool-resident prefix page held only by its digest
        binding (no live stream table) — the payload stays cached in the
        prefix stack, so this only costs the next admit a reload."""
        for digest, phys in self.pool.resident_digests().items():
            if self.pool.refcount(phys) == 1:
                self.pool.drop_digest(digest)
                self.stats["pool_prefix_dropped"] += 1
                return True
        return False

    def _spill_one(self, protect: int) -> bool:
        """Spill one pool-resident PARKED stream's pages through the
        pager (content-addressed blobs: shared/zero pages pool once).
        Victims run latest — the back of the run queue."""
        if self.pager is None:
            return False
        for sid in reversed(self._runq):
            if sid == protect or sid not in self._ptables:
                continue
            if self.streams[sid].state is not StreamState.PARKED:
                continue
            table = self._ptables.pop(sid)
            try:
                with self.tracer.span("spill", tid=sid, pages=len(table)):
                    self.pager.park_pages(
                        sid, [self.pool.page_blob(p) for p in table])
            except CapacityError:
                self._ptables[sid] = table
                return False        # the tier stack is full too
            for p in table:
                self.pool.deref(p)
            self.stats["spilled"] += 1
            return True
        return False

    def _try_admit(self, sid: int, slot: int) -> bool:
        while True:
            try:
                self._admit(sid, slot)
                return True
            except CapacityError:
                if self._drop_pool_prefix() or self._spill_one(protect=sid):
                    continue
                self.stats["admit_deferred"] += 1
                return False

    def _park(self, sid: int) -> bool:
        """Park = host bookkeeping: the stream's pages stay resident and
        referenced, only its slot's table row is pointed at the trash
        page.  Zero KV bytes move; spilling happens later, and only under
        pool pressure."""
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
        """Every parked stream stays resident — in the pool, or
        (spilled) in the pager's tier stack."""
        active = sum(1 for sid in self._slot_sid if sid is not None)
        parked = sum(1 for s in self.streams.values()
                     if s.state is StreamState.PARKED)
        return active + parked

    def export_live_pages(self) -> int:
        """Register every live stream's *complete* KV pages — decoded
        history included — into the prefix trie, keyed by the stream's
        token chain (KV at position ``i`` is a pure function of
        ``tokens[:i+1]``, so a full page is exactly a prefix page for the
        chain it covers).  Pool-resident streams read through their page
        tables; spilled streams reinterpret their parked pager blobs.
        Partial pages are skipped.  Returns the number of page
        registrations attempted."""
        if self.prefix is None:
            return 0
        pt = self.pool.page_tokens
        n = 0
        for sid in sorted(self.streams):
            s = self.streams[sid]
            if s.state is StreamState.DONE:
                continue
            upto = (min(s.pos, len(s.tokens)) // pt) * pt
            if upto <= 0:
                continue
            table = self._ptables.get(sid)
            if table is not None:
                self.prefix.extend(
                    s.tokens[:upto], upto, None, sid=sid,
                    payload_fn=lambda end, t=table:
                        self.pool.read_token_slice(t[end // pt - 1]))
            elif (self.pager is not None and self.pager.is_parked(sid)
                  and self.pager.parked_kind(sid) == "pool_pages"):
                digests = self.pager.page_table(sid)[:upto // pt]
                self.prefix.extend(
                    s.tokens[:upto], upto, None, sid=sid,
                    payload_fn=lambda end, d=digests:
                        self.pool.blob_to_token_slice(
                            self.pager.page_payload(d[end // pt - 1])))
            else:
                continue   # WAITING, never prefilled: descriptor-only
            n += upto // pt
        return n

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

    # -- checkpoint / restore ----------------------------------------------- #
    #
    # Paged-mode fixed-shape state replaces the per-slot "slots" caches:
    #   pool     every pool leaf, byte-identical (trash page and
    #            unallocated slots included)
    #   ptables  (R, pages_per_lane) int32 physical tables, -1-padded
    # The allocator (refcounts, free list, digest residency) and the
    # spilled streams' page-granular pager tables ride in meta.

    def _serving_state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        state, meta = self._stream_state_arrays()
        state["pool"] = self.pool.snapshot()
        sids = sorted(self._ptables)
        ptables = np.full((max(len(sids), 1), self.pool.pages_per_lane),
                          -1, np.int32)
        for row, sid in enumerate(sids):
            ptables[row, :len(self._ptables[sid])] = self._ptables[sid]
        state["ptables"] = ptables
        meta["serve"]["paged"] = {
            "page_tokens": self.pool.page_tokens,
            "pool_pages": self.pool.n_pages,
            "kv_codec": self.kv_codec,
            "spec_k": self.spec_k,
            "ptable_sids": [int(sid) for sid in sids],
            "refs": {str(p): int(r)
                     for p, r in self.pool.refcounts().items()},
            "digest_phys": self.pool.resident_digests(),
        }
        self._pager_state(state, meta)
        self._prefix_state(state, meta)
        return state, meta

    def restore(self, session: Optional[ResilienceSession] = None,
                step: Optional[int] = None) -> int:
        session = session or self.session
        assert session is not None, "no ResilienceSession attached"
        step, sm = self._checkpoint_meta(session, step)
        pm = sm.get("paged")
        if not pm:
            raise RuntimeError(
                "checkpoint was written by the contiguous scheduler; "
                "restore it with ServeScheduler")
        if (pm["page_tokens"] != self.pool.page_tokens
                or pm["pool_pages"] != self.pool.n_pages):
            raise ValueError(
                f"pool geometry mismatch: checkpoint has page_tokens="
                f"{pm['page_tokens']} pool_pages={pm['pool_pages']}, this "
                f"pool has page_tokens={self.pool.page_tokens} "
                f"pool_pages={self.pool.n_pages}")
        ck_codec = pm.get("kv_codec", "none")
        if ck_codec != self.kv_codec:
            raise ValueError(
                f"kv_codec mismatch: checkpoint was written with "
                f"{ck_codec!r}, this scheduler runs {self.kv_codec!r} — "
                "the pool snapshots are not layout-compatible")
        template = self._stream_template(sm)
        template["pool"] = {name: torch.zeros(l.shape, dtype=l.dtype)
                            for name, l in self.pool.leaves.items()}
        template["ptables"] = np.zeros(
            (max(len(pm["ptable_sids"]), 1), self.pool.pages_per_lane),
            np.int32)
        state, got = session.restore_latest(template, step=step)
        self._load_streams(state, sm["n_streams"])
        self.pool.load(state["pool"],
                       {int(p): int(r) for p, r in pm["refs"].items()},
                       pm["digest_phys"])
        self._ptables = {
            int(sid): [int(p) for p in state["ptables"][row] if p >= 0]
            for row, sid in enumerate(pm["ptable_sids"])}
        self._tables_arr = np.full(
            (self.slots, self.pool.pages_per_lane), self._trash, np.int32)
        for slot, sid in enumerate(self._slot_sid):
            if sid is not None:
                self._tables_arr[slot] = self._ptables[sid]
        self._restore_pager(state, sm.get("pager"))
        self._restore_prefix(state, sm.get("prefix"))
        if self.prefix is not None:
            self.prefix.on_evict = self.pool.drop_digest
        self.step_count = int(sm["step_count"])
        self._next_sid = int(sm["next_sid"])
        return got


def _pad_stack(payloads: List[bytes], width: int) -> np.ndarray:
    """Stack variable-length byte strings into a (N, width) uint8 array
    (checkpoint state must be fixed-shape; true lengths ride in meta)."""
    out = np.zeros((len(payloads), width), np.uint8)
    for i, p in enumerate(payloads):
        out[i, :len(p)] = np.frombuffer(p, np.uint8)
    return out
