"""PrefixBoard: the fleet's publish/subscribe journal.

Counterpart of ``repro/serve/fleet/board.py``: the journal's lines are the
reference's, byte for byte.

An append-only JSONL file in the shared domain root.  Publishers append
records under the domain's advisory lock; subscribers poll by byte
offset — a reader consumes only whole lines up to the last newline, so a
concurrent append can never hand it a torn record.  The journal is
strictly ordered, and each publisher emits parents before children, so
``adopt_nodes`` on the consumer side never sees an orphan from a
complete feed.

Two record kinds share the journal, discriminated by ``"kind"``:

* ``"prefix"`` (the default when the field is absent — every pre-kind
  publisher wrote these): prefix-trie node records in the
  ``PrefixCache.export_records`` schema.  Payload bytes travel through
  the :class:`~repro_torch.memory.shared.SharedTier` under the ordinary
  ``kv/prefix/<digest>.bin`` key (see ``publish_nodes`` in worker.py).
* ``"epoch"``: a worker's liveness/checkpoint marker — worker name,
  pid, scheduler step, wall-clock stamp — published after each epoch
  checkpoint so the frontend (and the shared-tier GC) can reason about
  which publishers are current without touching their checkpoints.

Polling is *bounded*: ``poll(max_records=N)`` consumes at most N
records and leaves the cursor on the first unconsumed line, so a worker
joining a long-lived fleet adopts the backlog across several admission
cycles instead of stalling one submit for the whole journal.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.memory.shared import _DomainLock


def record_kind(rec: Dict[str, Any]) -> str:
    """A record's kind; records from pre-kind publishers are prefix
    nodes."""
    return rec.get("kind", "prefix")


class PrefixBoard:
    """One process's cursor over the shared journal."""

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.path = self.root / "prefix_board.jsonl"
        self._lock_path = self.root / ".board_lock"
        self._offset = 0
        self.published = 0
        self.adopt_seen = 0

    def publish(self, records: List[Dict[str, Any]]) -> int:
        """Append records atomically (one locked write).  Returns the
        number appended."""
        if not records:
            return 0
        data = "".join(
            json.dumps(rec, sort_keys=True) + "\n" for rec in records
        ).encode()
        with _DomainLock(self._lock_path):
            with open(self.path, "ab") as f:
                f.write(data)
        self.published += len(records)
        return len(records)

    def poll(self, max_records: Optional[int] = None) -> List[Dict[str, Any]]:
        """New records since this cursor's last poll (possibly its own —
        consumers dedup by digest).  Lock-free: reads only whole lines.

        ``max_records`` bounds the batch: the cursor advances exactly
        past the returned records, so the remainder is delivered by
        subsequent polls in journal order (the adoption throttle for
        large fleets)."""
        try:
            size = os.path.getsize(self.path)
        except FileNotFoundError:
            return []
        if size <= self._offset:
            return []
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            data = f.read()
        cut = data.rfind(b"\n")
        if cut < 0:
            return []       # partial line in flight; next poll gets it
        lines = [ln for ln in data[:cut + 1].split(b"\n") if ln]
        if max_records is not None and len(lines) > max_records:
            lines = lines[:max_records]
            # advance only past the consumed lines: sum of line lengths
            # plus one newline each
            consumed = sum(len(ln) + 1 for ln in lines)
            self._offset += consumed
        else:
            self._offset += cut + 1
        records = [json.loads(line) for line in lines]
        self.adopt_seen += len(records)
        return records
