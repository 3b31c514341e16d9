"""PaliGemma-3B backbone: a gemma-style decoder over a SigLIP patch prefix.

Counterpart of ``repro/models/paligemma.py``.  The SigLIP vision tower is
a stub, as in the reference: the inputs carry precomputed patch
embeddings ``patches`` (B, n_prefix, D).  Attention is prefix-LM,
bidirectional over the image prefix and causal over the text, through
``transformer.forward(prefix_embeds=...)`` and the flash kernels'
``prefix_len``; the prefix rows' logits are dropped.  MQA (one kv head)
at head dim 256.  The parameters, the cache and the text decode are the
dense transformer's; there is no ``paged_decode_step`` (the reference has
none for this family), so it serves on the contiguous scheduler.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T

# param structure is the dense transformer's
param_table = T.param_table
init = T.init
param_axes = T.param_axes
param_shapes = T.param_shapes
cache_table = T.cache_table
init_cache = T.init_cache
cache_axes = T.cache_axes
cast_params = T.cast_params


def forward(params, batch, cfg: ArchConfig, remat: bool = True):
    """batch: tokens (B, T_text) + patches (B, n_prefix, D) -> the text
    rows' logits (B, T_text, V)."""
    return T.forward(params, batch, cfg, remat=remat,
                     prefix_embeds=batch["patches"])


def decode_step(params, cache, tokens, pos, cfg: ArchConfig):
    """Text decode after the prefix was prefilled into the cache."""
    return T.decode_step(params, cache, tokens, pos, cfg)
