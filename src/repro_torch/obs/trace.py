"""Span tracer: per-stream request timelines, Perfetto-exportable.

A :class:`Tracer` records *spans* (named intervals with a stream id and
free-form args) and *events* (instants) into a bounded ring of plain
dicts.  The taxonomy the serving stack emits:

======================  ======================================================
span / event            where
======================  ======================================================
``submit``              request enters the scheduler / frontend (event)
``prefix_match``        radix-tree lookup at admission
``prefill``             batched prompt prefill (args: tokens, saved)
``step``                one scheduler decode step (args: resident, emitted)
``park`` / ``spill``    stream KV leaves the pool / device
``fetch`` / ``resume``  parked stream re-admitted (args: bytes_moved)
``finish``              stream completes (event)
``ckpt_txn``            one ResilienceSession checkpoint transaction
``epoch_ckpt``          fleet worker's periodic epoch checkpoint
``recover_worker``      frontend recovery of a dead worker
``migrate``             one stream re-admitted on a survivor (event)
======================  ======================================================

Design constraints: recording must stay off the hot path — a span is
two ``time.perf_counter()`` calls, one small dict, and a bounded
``deque.append``; nothing touches a device buffer or forces a host
sync, and a disabled tracer short-circuits to a shared no-op context.
``perf_counter`` is ``CLOCK_MONOTONIC`` on Linux — one clock across
the fleet's processes on a host — so worker timelines interleave
correctly in one Perfetto view.

Export is the Chrome trace-event JSON format (``chrome://tracing`` /
`ui.perfetto.dev <https://ui.perfetto.dev>`_): complete events
(``ph="X"``) for spans, instants (``ph="i"``) for events, one process
per worker, one track (tid) per stream.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional


class _NullSpan:
    """Shared no-op context for disabled tracers."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "rec")

    def __init__(self, tracer: "Tracer", rec: Dict[str, Any]):
        self._tracer = tracer
        self.rec = rec

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> None:
        self._tracer.end(self)


class Tracer:
    """Bounded in-process span/event recorder.

    ``capacity`` bounds the ring (oldest records drop first);
    ``process`` names the worker in exports and flight-recorder
    flushes.  A ``sink`` callable (the flight recorder) receives every
    completed record.  Records are dicts::

        {"name": str, "ph": "X"|"i", "ts": s, "dur": s, "tid": int,
         "args": {...}}
    """

    def __init__(self, capacity: int = 4096, enabled: bool = True,
                 process: str = "", sink: Optional[Any] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = bool(enabled)
        self.process = process
        self.sink = sink
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=int(capacity))

    # -- recording --------------------------------------------------------- #

    def _emit(self, rec: Dict[str, Any]) -> None:
        self._ring.append(rec)
        if self.sink is not None:
            self.sink.record(rec)

    def begin(self, name: str, tid: int = 0,
              **args: Any) -> Optional[_Span]:
        """Open a span whose end is at a different call site (e.g. a
        stream's whole residency).  Returns a handle for :meth:`end`,
        or ``None`` when disabled (``end`` accepts it)."""
        if not self.enabled:
            return None
        rec: Dict[str, Any] = {"name": name, "ph": "X",
                               "ts": time.perf_counter(), "tid": int(tid)}
        if args:
            rec["args"] = args
        return _Span(self, rec)

    def end(self, span: Optional[_Span], **args: Any) -> None:
        if span is None or not self.enabled:
            return
        rec = span.rec
        rec["dur"] = time.perf_counter() - rec["ts"]
        if args:
            rec.setdefault("args", {}).update(args)
        self._emit(rec)

    def span(self, name: str, tid: int = 0, **args: Any):
        """Context manager form: ``with tracer.span("prefill", tid=sid):``."""
        if not self.enabled:
            return _NULL_SPAN
        return self.begin(name, tid=tid, **args)

    def event(self, name: str, tid: int = 0, **args: Any) -> None:
        if not self.enabled:
            return
        rec: Dict[str, Any] = {"name": name, "ph": "i",
                               "ts": time.perf_counter(), "tid": int(tid)}
        if args:
            rec["args"] = args
        self._emit(rec)

    # -- introspection / export --------------------------------------------- #

    def records(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        """Ring contents, oldest first (optionally filtered by name)."""
        if name is None:
            return list(self._ring)
        return [r for r in self._ring if r["name"] == name]

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)

    def chrome_trace(self, records: Optional[List[Dict[str, Any]]] = None,
                     ) -> Dict[str, Any]:
        """Render records (default: this ring) as a Chrome-trace /
        Perfetto ``traceEvents`` document.  Accepts foreign records too
        (e.g. a flight-recorder timeline read back from the shared
        tier), grouping by each record's ``proc`` tag when present."""
        recs = self._ring if records is None else records
        pids: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        for rec in recs:
            proc = rec.get("proc", self.process) or ""
            pid = pids.get(proc)
            if pid is None:
                pid = pids[proc] = len(pids) + 1
            ev: Dict[str, Any] = {
                "name": rec["name"], "ph": rec.get("ph", "i"),
                "ts": rec["ts"] * 1e6, "pid": pid,
                "tid": int(rec.get("tid", 0)),
                "args": dict(rec.get("args", {})),
            }
            if ev["ph"] == "X":
                ev["dur"] = rec.get("dur", 0.0) * 1e6
            else:
                ev["s"] = "t"
            events.append(ev)
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": proc or f"proc{pid}"}}
                for proc, pid in pids.items()]
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms"}

    def export(self, path, records: Optional[List[Dict[str, Any]]] = None,
               ) -> None:
        """Write the Perfetto JSON to ``path``."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(records), f)


_default: Optional[Tracer] = None


def default_tracer() -> Tracer:
    """The process-wide tracer components fall back to when none is
    injected.  Enabled by default — recording is off-hot-path cheap and
    the fig10 overhead gate holds it to <= 3% tokens/s."""
    global _default
    if _default is None:
        _default = Tracer(process=f"pid{os.getpid()}")
    return _default


def set_default_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Swap the process-default tracer (returns the previous one)."""
    global _default
    prev, _default = _default, tracer
    return prev
