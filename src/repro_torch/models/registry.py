"""Family dispatch: ``get_model(cfg)`` returns a :class:`ModelApi`, and
``input_specs`` / ``make_inputs`` the model inputs of a cell.

Counterpart of ``repro/models/registry.py``, for every family: ``dense``
(MLA included), ``moe``, ``rwkv``, ``hybrid``, ``encdec`` (whisper) and
``vlm`` (paligemma).  Input specs are ``(shape, torch dtype)`` pairs where
the reference has ``ShapeDtypeStruct`` stand-ins.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.layers import torch_dtype


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


def get_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family == "dense":
        from repro_torch.models import transformer as m
    elif cfg.family == "moe":
        from repro_torch.models import moe as m
    elif cfg.family == "rwkv":
        from repro_torch.models import rwkv6 as m
    elif cfg.family == "hybrid":
        from repro_torch.models import mamba2 as m
    elif cfg.family == "encdec":
        from repro_torch.models import whisper as m
    elif cfg.family == "vlm":
        from repro_torch.models import paligemma as m
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


# ---------------------------------------------------------------------- #
# input specs
# ---------------------------------------------------------------------- #


def input_specs(cfg: ArchConfig, shape: ShapeSpec
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Model inputs for one (arch x shape) cell, ``name -> (shape, dtype)``.

    train/prefill: full sequences (tokens+labels / tokens).
    decode: one new token per sequence (the KV cache is separate state).
    Modality frontends are stubs: whisper gets frame embeddings,
    paligemma gets patch embeddings; their text seq_len is reduced by the
    prefix length so the total positions match the assigned shape.
    """
    b, t = shape.global_batch, shape.seq_len
    i32 = torch.int32
    cd = torch_dtype(cfg.compute_dtype)
    if shape.kind == "decode":
        return {"tokens": ((b,), i32)}
    specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if cfg.family == "encdec":
        specs["enc_frames"] = ((b, cfg.enc_seq, cfg.d_model), cd)
        specs["tokens"] = ((b, t), i32)
    elif cfg.family == "vlm":
        specs["patches"] = ((b, cfg.n_prefix, cfg.d_model), cd)
        specs["tokens"] = ((b, t - cfg.n_prefix), i32)
    else:
        specs["tokens"] = ((b, t), i32)
    if shape.kind == "train":
        specs["labels"] = (specs["tokens"][0], i32)
    return specs


def make_inputs(cfg: ArchConfig, shape: ShapeSpec, gen: torch.Generator,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Concrete random inputs matching :func:`input_specs`, drawn from
    ``gen`` on ``device`` in sorted name order: token ids uniform in
    ``[0, vocab)``, embeddings standard normal cast to their dtype (the
    reference's kinds of draw, not its numbers)."""
    out = {}
    for name, (dims, dtype) in sorted(input_specs(cfg, shape).items()):
        if dtype.is_floating_point:
            x = torch.randn(dims, generator=gen, dtype=torch.float32,
                            device=device)
            out[name] = x.to(dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, dims, generator=gen,
                                      dtype=dtype, device=device)
    return out
