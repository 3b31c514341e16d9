"""Assigned input-shape sets (LM-family: seq_len x global_batch)."""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES: List[ShapeSpec] = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]

# long_500k needs sub-quadratic sequence handling: only SSM/hybrid archs
# run it; pure full-attention archs skip it (recorded in DESIGN.md §4).
SUBQUADRATIC_FAMILIES = ("rwkv", "hybrid")


def shapes_for(family: str) -> List[ShapeSpec]:
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if family in SUBQUADRATIC_FAMILIES:
        out.append(LONG_500K)
    return out


def get_shape(name: str) -> ShapeSpec:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
