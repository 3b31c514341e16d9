"""Family dispatch: ``get_model(cfg)`` returns a :class:`ModelApi`.

Counterpart of ``repro/models/registry.py``.  The port has the
``dense`` (MLA included), ``moe``, ``rwkv`` and ``hybrid`` families;
``encdec`` and ``vlm`` raise, naming the ROADMAP.md slice that ports
them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    family: str
    init: Callable
    param_axes: Callable
    param_shapes: Callable
    forward: Callable
    init_cache: Callable
    cache_axes: Callable
    cache_table: Callable
    decode_step: Callable
    # families whose cache has a kv_seq axis can decode straight on the
    # shared page pool (serve/pagepool.py); None for snapshot families
    paged_decode_step: Optional[Callable] = None
    # params -> the same tree with the leaves the decode path casts to
    # the compute dtype cast once, ahead of serving
    cast_params: Optional[Callable] = None


_WAITS = {
    "encdec": "whisper and paligemma",
    "vlm": "whisper and paligemma",
}


def get_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family == "dense":
        from repro_torch.models import transformer as m
    elif cfg.family == "moe":
        from repro_torch.models import moe as m
    elif cfg.family == "rwkv":
        from repro_torch.models import rwkv6 as m
    elif cfg.family == "hybrid":
        from repro_torch.models import mamba2 as m
    elif cfg.family in _WAITS:
        raise NotImplementedError(
            f"model family {cfg.family!r} waits for the "
            f"'{_WAITS[cfg.family]}' slice of ROADMAP.md")
    else:
        raise ValueError(cfg.family)
    return ModelApi(
        family=cfg.family,
        init=m.init,
        param_axes=m.param_axes,
        param_shapes=m.param_shapes,
        forward=m.forward,
        init_cache=m.init_cache,
        cache_axes=m.cache_axes,
        cache_table=m.cache_table,
        decode_step=m.decode_step,
        paged_decode_step=getattr(m, "paged_decode_step", None),
        cast_params=getattr(m, "cast_params", None),
    )
