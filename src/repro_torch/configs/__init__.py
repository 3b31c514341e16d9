"""Architecture registry: ``--arch <id>`` resolves here."""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchConfig, MLASpec, MoESpec
from repro_torch.configs.shapes import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ShapeSpec,
    get_shape,
    shapes_for,
)

from repro_torch.configs.minicpm3_4b import CONFIG as _minicpm3
from repro_torch.configs.starcoder2_7b import CONFIG as _sc2_7b
from repro_torch.configs.phi3_mini_3_8b import CONFIG as _phi3
from repro_torch.configs.starcoder2_15b import CONFIG as _sc2_15b
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6
from repro_torch.configs.whisper_tiny import CONFIG as _whisper
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.configs.deepseek_moe_16b import CONFIG as _dsmoe
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2moe
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c
    for c in [
        _minicpm3,
        _sc2_7b,
        _phi3,
        _sc2_15b,
        _rwkv6,
        _whisper,
        _paligemma,
        _dsmoe,
        _qwen2moe,
        _zamba2,
    ]
}


def get_config(arch: str) -> ArchConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch]


def arch_ids() -> List[str]:
    return sorted(REGISTRY)


__all__ = [
    "ArchConfig",
    "MLASpec",
    "MoESpec",
    "ShapeSpec",
    "REGISTRY",
    "get_config",
    "arch_ids",
    "get_shape",
    "shapes_for",
    "ALL_SHAPES",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
]
