"""Deterministic, checkpointable synthetic token pipeline.

Counter-based generation (Philox keyed by (seed, step)) makes the stream
a pure function of the step index: the pipeline's entire state is one
integer, it re-shards trivially under elastic restarts, and a restored
run reproduces the exact batches an uninterrupted run would have seen —
the property the trainer's bitwise recovery test asserts.

The synthetic distribution is a Zipf-like unigram mix with short repeated
motifs so losses actually decrease (quickstart's sanity signal) instead
of plateauing at log(V).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class TokenPipeline:
    def __init__(
        self,
        vocab_size: int,
        global_batch: int,
        seq_len: int,
        seed: int = 0,
        motif_len: int = 16,
        n_motifs: int = 64,
    ):
        self.vocab_size = int(vocab_size)
        self.global_batch = int(global_batch)
        self.seq_len = int(seq_len)
        self.seed = int(seed)
        self.step = 0
        self.motif_len = motif_len
        # fixed motif bank drawn once from the seed (not part of state)
        rng = np.random.Generator(np.random.Philox(key=self.seed))
        self._motifs = rng.integers(
            0, self.vocab_size, size=(n_motifs, motif_len), dtype=np.int32
        )

    # -- checkpointable state ------------------------------------------- #

    def state(self) -> Dict[str, int]:
        return {"seed": self.seed, "step": self.step}

    def load_state(self, state: Dict[str, int]) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError(
                f"pipeline seed mismatch: checkpoint {state['seed']} != {self.seed}"
            )
        self.step = int(state["step"])

    # -- batches ---------------------------------------------------------- #

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step): batch for that step index."""
        rng = np.random.Generator(
            np.random.Philox(key=self.seed, counter=np.uint64(step + 1))
        )
        b, t, ml = self.global_batch, self.seq_len, self.motif_len
        n_slots = (t + ml - 1) // ml
        motif_ids = rng.integers(0, len(self._motifs), size=(b, n_slots))
        tokens = self._motifs[motif_ids].reshape(b, n_slots * ml)[:, :t].copy()
        # sprinkle noise so the task is not trivially memorizable
        noise_mask = rng.random((b, t)) < 0.05
        noise = rng.integers(0, self.vocab_size, size=(b, t), dtype=np.int32)
        tokens[noise_mask] = noise[noise_mask]
        return {"tokens": tokens.astype(np.int32), "labels": tokens.astype(np.int32)}

    def next_batch(self) -> Dict[str, np.ndarray]:
        batch = self.batch_at(self.step)
        self.step += 1
        return batch
