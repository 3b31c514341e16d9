"""ServeEngine: the single-batch serving surface over the ServeScheduler.

Counterpart of ``repro/serve/engine.py``.  A thin wrapper that submits
one stream per batch row to a
:class:`~repro_torch.serve.scheduler.ServeScheduler` (slots == batch, no
paging) and keeps the lockstep prefill/decode/save/restore API.  The
scheduler is exposed as ``.scheduler`` for callers that want the
multi-stream surface, with the same checkpoint semantics (the full
serving state rides one
:class:`~repro_torch.api.session.ResilienceSession` transaction; a killed
decode resumes byte-identically).

Deprecated as a *construction* path: new code should declare a
:class:`~repro_torch.serve.api.ServeConfig` and call ``Serve.local``.
Constructing ``ServeEngine`` directly keeps working and warns once per
process.
"""

from __future__ import annotations

import warnings
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.session import ResilienceSession
from repro_torch.configs.base import ArchConfig
from repro_torch.core.scr import SCRManager
from repro_torch.models.registry import ModelApi
from repro_torch.serve.scheduler import (PagedServeScheduler, ServeScheduler,
                                         StreamState)

_WARNED_DEPRECATED = False


class ServeEngine:
    def __init__(self, cfg: ArchConfig, model: ModelApi, params: Any,
                 batch: int, max_len: int, scr=None, paged: bool = False,
                 spec_k: int = 0, page_tokens: int = 8,
                 pool_pages: Optional[int] = None,
                 kv_codec: Optional[str] = None):
        """``scr`` is a :class:`ResilienceSession` (the user API) or —
        compatibility shim — a raw :class:`SCRManager`, wrapped in an
        engine-owned session; ``None`` disables checkpointing.

        ``paged=True`` (or ``spec_k`` > 0, which implies it) serves
        through the :class:`~repro_torch.serve.scheduler.PagedServeScheduler`:
        KV lives in one pool-resident page buffer and — with ``spec_k``
        — each step verifies ``spec_k`` n-gram-proposed candidates, so a
        single scheduler step may emit several tokens per row.  The
        lockstep :meth:`decode` surface buffers those and still returns
        one ``(batch,)`` vector per emitted position.

        ``kv_codec`` (paged only) picks the KV representation policy:
        ``"zlib"`` keeps decode bit-exact and compresses spilled pages;
        ``"int8"`` additionally holds pool-resident KV as int8 +
        per-channel scales (tolerance-gated instead of bit-exact)."""
        global _WARNED_DEPRECATED
        if not _WARNED_DEPRECATED:
            _WARNED_DEPRECATED = True
            warnings.warn(
                "constructing ServeEngine directly is deprecated; build a "
                "repro_torch.serve.api.ServeConfig and use Serve.local(cfg)",
                DeprecationWarning, stacklevel=2)
        self.cfg = cfg
        self.model = model
        self.params = params
        self.batch = batch
        self.max_len = max_len
        if isinstance(scr, ResilienceSession):
            self.session: Optional[ResilienceSession] = scr
        elif scr is not None:
            self.session = ResilienceSession(scr, own_engine=False)
        else:
            self.session = None
        self.scr: Optional[SCRManager] = (
            self.session.scr if self.session is not None else None)
        if paged or spec_k:
            self.scheduler: ServeScheduler = PagedServeScheduler(
                cfg, model, params, slots=batch, max_len=max_len,
                session=self.session, page_tokens=page_tokens,
                pool_pages=pool_pages, spec_k=spec_k, kv_codec=kv_codec)
        else:
            if kv_codec not in (None, "none"):
                raise ValueError(
                    "kv_codec needs the paged scheduler (paged=True)")
            self.scheduler = ServeScheduler(
                cfg, model, params, slots=batch, max_len=max_len,
                session=self.session)
        self._engine_sids: List[int] = []
        self._pending: Dict[int, Deque[int]] = {}
        self.last: Optional[torch.Tensor] = None

    @classmethod
    def with_checkpointing(
        cls,
        cfg: ArchConfig,
        model: ModelApi,
        params: Any,
        batch: int,
        max_len: int,
        cluster,
        strategy=None,
        procs_per_node: int = 2,
        **scr_kw,
    ) -> "ServeEngine":
        """Serving engine whose checkpoint storage is composed via the
        TierStack router (BeeOND cache domain + optional NAM + global)
        instead of hand-wired tiers — see memory/stack.py.  The engine
        owns the resulting :class:`ResilienceSession`."""
        from repro_torch.core.scr import Strategy

        strategy = Strategy(strategy) if strategy is not None else Strategy.XOR
        session = ResilienceSession.for_cluster(
            cluster, strategy=strategy, procs_per_node=procs_per_node, **scr_kw)
        return cls(cfg, model, params, batch=batch, max_len=max_len, scr=session)

    # -- the lockstep single-batch surface -------------------------------- #
    #
    # The engine owns the `batch` streams it submitted in prefill();
    # callers may run additional streams through `.scheduler` without
    # breaking the lockstep view (decode only reads its own rows).

    def _engine_streams(self):
        return [self.scheduler.streams[sid] for sid in self._engine_sids]

    def prefill(self, prompt: Any) -> torch.Tensor:
        """Submit one stream per prompt row and run the prompts through
        the lanes.  The scheduler prefills each prompt at admit time, so
        a single step consumes the last prompt token and emits the first
        prediction per row."""
        prompt = np.asarray(prompt)
        assert prompt.ndim == 2 and prompt.shape[0] == self.batch, prompt.shape
        self._engine_sids = [
            # one stream per row, bounded only by the lane length
            self.scheduler.submit(prompt[row], max_new=self.max_len)
            for row in range(self.batch)]
        self.scheduler.step()
        streams = self._engine_streams()
        nxt = np.asarray([s.tokens[s.plen] for s in streams], np.int32)
        # speculative decode may commit extra tokens in the very first
        # step; they queue for decode() so no emission is ever dropped
        self._pending = {s.sid: deque(s.tokens[s.plen + 1:]) for s in streams}
        self.last = torch.as_tensor(nxt)
        return self.last

    def decode(self, n_tokens: int) -> List[np.ndarray]:
        """Greedy lockstep decode: one (batch,) token vector per emitted
        position, clipped when the lanes hit ``max_len``.  A speculative
        scheduler step can emit several tokens per row at once; the
        engine buffers them per stream and still hands them out one
        lockstep row at a time."""
        assert self._engine_sids, "prefill first"
        out: List[np.ndarray] = []
        while len(out) < n_tokens:
            empty = [sid for sid in self._engine_sids
                     if not self._pending[sid]]
            if empty:
                if all(self.scheduler.streams[sid].state is StreamState.DONE
                       for sid in empty):
                    break   # the engine's rows are done (others may continue)
                for sid, tok in self.scheduler.step():
                    if sid in self._pending:
                        self._pending[sid].append(tok)
                continue
            row = np.asarray([self._pending[sid].popleft()
                              for sid in self._engine_sids], np.int32)
            out.append(row)
            self.last = torch.as_tensor(row)
        return out

    # -- serving-state checkpoint/restore -------------------------------- #

    def save(self):
        """Checkpoint the full serving state through one session
        transaction; with an async-drain engine the decode loop continues
        while the flush rides the drain executor.  Returns the
        CheckpointRecord (its ``ticket`` is the drain future)."""
        assert self.session is not None
        return self.scheduler.save(self.session)

    def wait_drained(self, timeout=None) -> None:
        """Durability barrier over outstanding serving-state drains."""
        assert self.session is not None
        self.session.wait_drained(timeout=timeout)

    def restore(self) -> int:
        """Rebuild the serving state — stream set included — from the
        newest checkpoint; a fresh engine restores without re-prefilling."""
        assert self.session is not None
        step = self.scheduler.restore(self.session)
        # the engine's rows are the first `batch` streams of the
        # restored set (prefill submits them first, in row order)
        self._engine_sids = sorted(self.scheduler.streams)[:self.batch]
        # post-restore decode() emits only tokens committed after the
        # checkpoint; compare full histories via scheduler.output() when
        # speculative steps may have outrun the pre-kill decode() cursor
        self._pending = {sid: deque() for sid in self._engine_sids}
        live = [s for s in self._engine_streams()
                if s.state is not StreamState.DONE and s.pos > 0]
        if live:
            self.last = torch.tensor([s.tokens[s.pos] for s in live],
                                     dtype=torch.int32)
        return step

    def close(self) -> None:
        """Idempotent: close the engine-owned session (and its drain
        threads); a caller-provided engine is left running."""
        self.scheduler.close()
        if self.session is not None:
            self.session.close()
