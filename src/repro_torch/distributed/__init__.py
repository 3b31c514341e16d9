"""Sharding rules and collectives on ``torch.distributed``."""

from repro_torch.distributed.sharding import (
    ShardingRules,
    TRAIN_RULES,
    DECODE_RULES,
    specs_from_axes,
    shardings_for,
)

__all__ = [
    "ShardingRules",
    "TRAIN_RULES",
    "DECODE_RULES",
    "specs_from_axes",
    "shardings_for",
]
