"""Flight recorder: a worker's last seconds, post-mortem-readable.

Counterpart of ``repro/obs/recorder.py``: the journal's lines are the
reference's, byte for byte.

The elastic fleet already survives a SIGKILL'd worker (epoch
checkpoints + board markers recover its *streams*), but the worker's
telemetry died with it — exactly the seconds an operator needs to see.
The flight recorder is the observability analogue of the epoch marker:
a bounded buffer of the worker's most recent span/event records,
flushed **append-only** through the fleet's
:class:`~repro_torch.memory.shared.SharedTier` (``obs/flight/<worker>.jsonl``)
every heartbeat tick, so the frontend can reconstruct the dead worker's
last-N span timeline from the shared domain after the process is gone.

Crash-consistency follows the :class:`~repro_torch.serve.fleet.board.PrefixBoard`
journal idiom, inverted for the writer: appends go straight to the
backing file (``SharedTier.append`` — *not* rename-commit, a kill mid-
write may tear the final record), and the reader tolerates the torn
tail — a trailing partial line, or any line that fails to parse, is
counted and dropped, never propagated.  Every record before the torn
one is intact because lines are only appended, never rewritten.

The recorder is intentionally lossy under backpressure: between
flushes at most ``capacity`` records are held (oldest dropped first,
counted in ``dropped``) — a worker that cannot reach the shared domain
degrades its black box, never its serving loop.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

FLIGHT_DIR = "obs/flight"


def flight_key(worker: str) -> str:
    """The shared-tier key of one worker's flight journal."""
    return f"{FLIGHT_DIR}/{worker or 'w'}.jsonl"


class FlightRecorder:
    """Bounded pending buffer + append-only flush for one worker.

    Attach as a tracer sink (``Tracer(sink=recorder)``) so every
    completed span/event lands here; call :meth:`flush` periodically
    (the worker does it on its heartbeat cadence) to append the pending
    records to the shared journal."""

    def __init__(self, worker: str, capacity: int = 512):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.worker = worker or "w"
        self.capacity = int(capacity)
        self._pending: List[Dict[str, Any]] = []
        self.dropped = 0
        self.flushed = 0

    # -- tracer sink --------------------------------------------------------- #

    def record(self, rec: Dict[str, Any]) -> None:
        self._pending.append(rec)
        if len(self._pending) > self.capacity:
            del self._pending[0]
            self.dropped += 1

    def pending(self) -> int:
        return len(self._pending)

    # -- persistence --------------------------------------------------------- #

    def flush(self, shared) -> int:
        """Append pending records to the shared journal; returns how
        many were written.  Raises whatever ``shared.append`` raises
        (capacity, I/O) with the pending buffer intact — the caller
        decides whether a missed flush is fatal (the worker loop treats
        it as best-effort)."""
        if not self._pending:
            return 0
        lines = b"".join(
            json.dumps(dict(rec, proc=self.worker),
                       separators=(",", ":"), default=str).encode()
            + b"\n"
            for rec in self._pending)
        shared.append(flight_key(self.worker), lines)
        n = len(self._pending)
        self._pending.clear()
        self.flushed += n
        return n


def read_flight(shared, worker: str, last: Optional[int] = None,
                ) -> Tuple[List[Dict[str, Any]], int]:
    """Reconstruct a worker's flushed timeline from the shared domain.

    Returns ``(records, torn)`` — records oldest first (the last
    ``last`` of them when given), and the count of torn/unparsable
    lines dropped (a SIGKILL mid-append leaves at most one, at the
    tail).  A worker that never flushed yields ``([], 0)``."""
    try:
        raw = shared.get(flight_key(worker))
    except KeyError:
        return [], 0
    records: List[Dict[str, Any]] = []
    torn = 0
    for line in raw.split(b"\n"):
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            torn += 1
            continue
        if isinstance(rec, dict):
            records.append(rec)
        else:
            torn += 1
    if last is not None:
        records = records[-int(last):]
    return records, torn
