"""Model zoo, PyTorch port: the dense, rwkv6 and zamba2 families.

Every family module exposes the reference's interface:

  init(seed, cfg, device)                 -> params (nested dict of tensors)
  param_axes(cfg)                         -> the same tree of logical axis tuples
  init_cache(cfg, batch, max_len, ...)    -> decode cache
  cache_axes(cfg)                         -> logical axes for the cache
  decode_step(params, cache, tokens, pos, cfg)       -> (logits, cache)
  paged_decode_step(params, pools, tables, pos, tokens, cfg) -> (tokens, pools)
"""

from repro_torch.models.registry import get_model

__all__ = ["get_model"]
