"""N-gram speculative proposer (prompt-lookup decoding); a copy of the
reference's ``repro/serve/spec.py``.

Speculative multi-token decode needs candidate tokens that are cheap to
produce and right often enough to amortize the k-row verification step.
For serving, the cheapest useful draft model is the stream's *own
history*: greedy decode loops and prompts echo (code completion repeats
identifiers, chat repeats the user's phrasing), so the continuation of
the most recent earlier occurrence of the current n-gram suffix is a
strong proposal — "prompt lookup decoding", no draft network at all.

The proposer is a pure function of the token history, which is exactly
the state the scheduler already checkpoints — a restored scheduler
proposes the same candidates and replays the same accept/reject
sequence, preserving the kill/restore byte-identity guarantee.
"""

from __future__ import annotations

from typing import List, Sequence


class NGramProposer:
    """Propose ``k`` candidate tokens by suffix lookup over the history
    (prompt + generated tokens alike).

    Tries the longest suffix n-gram first (``max_n`` down to 1); on a
    match at position j, proposes ``history[j+n : j+n+k]``.  When a
    match lands near the end of the history and yields fewer than ``k``
    tokens, the shortfall is filled by *re-proposing* against the
    virtually extended history (history + tokens proposed so far) — a
    period-p loop then fills all ``k`` slots with the loop continuation
    instead of a repeated last token, which is what lifts the acceptance
    rate on repetitive decode.  Only when no n-gram matches at all does
    the proposal degrade to repeating the last token — the degenerate
    draft that wins exactly when greedy decode is emitting one token
    forever.  Pure function of the history: a restored scheduler replays
    identical proposals.
    """

    def __init__(self, max_n: int = 3, window: int = 256):
        if max_n < 1:
            raise ValueError("max_n must be >= 1")
        self.max_n = int(max_n)
        self.window = int(window)   # cap the scan for long histories

    def _lookup(self, hist: List[int], k: int) -> List[int]:
        """Longest-suffix match (``max_n`` down to 1), most recent
        earlier occurrence; up to ``k`` continuation tokens, [] on miss."""
        lo = max(0, len(hist) - self.window)
        for n in range(min(self.max_n, len(hist)), 0, -1):
            tail = hist[-n:]
            for j in range(len(hist) - n - 1, lo - 1, -1):
                if hist[j:j + n] == tail:
                    got = hist[j + n:j + n + k]
                    if got:
                        return got
                    break
        return []

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        if k <= 0:
            return []
        hist = [int(t) for t in history]
        if not hist:
            return [0] * k
        out: List[int] = []
        while len(out) < k:
            got = self._lookup(hist + out, k - len(out))
            if not got:
                last = out[-1] if out else hist[-1]
                out.extend([last] * (k - len(out)))
                break
            out.extend(got)
        return out[:k]
