"""Memory layer: tiers, the BufferStore protocol, codecs, the tier stack
and the fleet's cross-process shared tier (``memory/shared.py``)."""

from repro_torch.memory.tiers import (
    TierKind,
    TierSpec,
    CapacityError,
    MemoryTier,
    MemoryHierarchy,
    WallClockThrottle,
    DEEPER_TIERS,
    TPU_V5E_TIERS,
)
from repro_torch.memory.store import BufferStore, NAMStore
from repro_torch.memory.codecs import (
    Codec,
    CodecRule,
    Int8Codec,
    ZlibCodec,
    int8_dequantize,
    int8_quantize,
    make_codec,
)
from repro_torch.memory.stack import (
    HitRatePromotion,
    KeyClass,
    PlacementRule,
    TierStack,
    classify_key,
)

__all__ = [
    "TierKind",
    "TierSpec",
    "CapacityError",
    "MemoryTier",
    "MemoryHierarchy",
    "WallClockThrottle",
    "DEEPER_TIERS",
    "TPU_V5E_TIERS",
    "BufferStore",
    "NAMStore",
    "Codec",
    "CodecRule",
    "Int8Codec",
    "ZlibCodec",
    "int8_dequantize",
    "int8_quantize",
    "make_codec",
    "HitRatePromotion",
    "KeyClass",
    "PlacementRule",
    "TierStack",
    "classify_key",
]
