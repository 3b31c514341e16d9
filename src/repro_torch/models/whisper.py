"""Whisper-tiny: encoder-decoder with a stubbed conv/audio frontend.

Counterpart of ``repro/models/whisper.py`` with the same param and cache
tables and the same arithmetic.  The conv frontend is a stub, as in the
reference: the inputs carry precomputed frame embeddings ``enc_frames``
(B, enc_seq, D).  Encoder: non-causal self-attention layers over the
frames plus sinusoidal positions (no RoPE).  Decoder: causal
self-attention, non-causal cross-attention to the encoder output, and a
head tied to the embedding (``embed.T``, as the reference reads it
whatever ``tie_embeddings`` says).  Every training attention runs through
:func:`repro_torch.models.layers.flash_attention` (the CUDA kernels for
CUDA tensors); the per-layer loops take the place of the reference's
``lax.scan`` and ``vmap``, and ``remat`` recomputes each decoder layer in
the backward pass, the encoder's not, as the reference does.

Decode caches: the decoder's self-attention K/V (growing, a ``kv_seq``
axis) and the cross-attention K/V (filled once from the encoder output by
:func:`prime_cross_cache`; zeros until then, as the reference's serving
cell leaves them).  The cross leaves have no ``kv_seq`` axis, so serving
treats the lane as a snapshot; there is no ``paged_decode_step``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

# the serving tree: every leaf the decode path casts to the compute dtype
# cast once (the dense family's rule: norm scales stay float32)
cast_params = T.cast_params


def dec_layer_table(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ln1": L.norm_table(cfg),
        "self_attn": T.attention_table(cfg),
        "ln_cross": L.norm_table(cfg),
        "cross_attn": T.attention_table(cfg),
        "ln2": L.norm_table(cfg),
        "ffn": T.ffn_table(cfg),
    }


def param_table(cfg: ArchConfig) -> Dict[str, Any]:
    v = cfg.padded_vocab
    return {
        "embed": L.LeafSpec((v, cfg.d_model), ("vocab", "d_model"), "embed"),
        "enc_layers": L.stacked(T.layer_table(cfg), cfg.n_enc_layers),
        "ln_enc": L.norm_table(cfg),
        "dec_layers": L.stacked(dec_layer_table(cfg), cfg.n_layers),
        "ln_f": L.norm_table(cfg),
    }


def init(seed: int, cfg: ArchConfig, device="cuda", cast: bool = False):
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    (the reference's init kinds and scales, not its numbers); ``cast=True``
    stores each leaf as :func:`cast_params` leaves it."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return L.materialize(gen, param_table(cfg), L.torch_dtype(cfg.param_dtype),
                         device, leaf_dtype=T.cast_dtype(cfg) if cast else None)


def param_axes(cfg: ArchConfig):
    return L.axes_of(param_table(cfg))


def param_shapes(cfg: ArchConfig):
    return L.shapes_of(param_table(cfg), L.torch_dtype(cfg.param_dtype))


# ---------------------------------------------------------------------- #
# attention (no RoPE: sinusoidal positions are added to the inputs)
# ---------------------------------------------------------------------- #


def _attn(p, xq: torch.Tensor, xkv: torch.Tensor, cfg: ArchConfig,
          causal: bool) -> torch.Tensor:
    b, tq, _ = xq.shape
    cd = xq.dtype
    hq, hkv = cfg.padded_heads, cfg.padded_kv_heads
    dh = cfg.resolved_head_dim
    q = (xq @ p["wq"].to(cd)).reshape(b, tq, hq, dh)
    k = (xkv @ p["wk"].to(cd)).reshape(b, xkv.shape[1], hkv, dh)
    v = (xkv @ p["wv"].to(cd)).reshape(b, xkv.shape[1], hkv, dh)
    o = L.flash_attention(q, k, v, causal=causal)
    return (o.reshape(b, tq, hq * dh) @ p["wo"].to(cd)).to(xq.dtype)


def _positions(n: int, cfg: ArchConfig, like: torch.Tensor) -> torch.Tensor:
    return L.sinusoidal_positions(n, cfg.d_model).to(like.device, like.dtype)


def encode(params, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """frames: (B, enc_seq, D) stub embeddings -> encoder states."""
    cd = L.torch_dtype(cfg.compute_dtype)
    x = frames.to(cd)
    x = x + _positions(frames.shape[1], cfg, x)[None]
    for li in range(cfg.n_enc_layers):
        lp = L.index_tree(params["enc_layers"], li)
        xn = L.apply_norm(cfg, x, lp["ln1"])
        x = x + _attn(lp["attn"], xn, xn, cfg, causal=False)
        x = x + T.ffn_block(lp["ffn"], L.apply_norm(cfg, x, lp["ln2"]), cfg)
    return L.apply_norm(cfg, x, params["ln_enc"])


def _dec_layer(lp, h: torch.Tensor, enc: torch.Tensor, cfg: ArchConfig
               ) -> torch.Tensor:
    xn = L.apply_norm(cfg, h, lp["ln1"])
    h = h + _attn(lp["self_attn"], xn, xn, cfg, causal=True)
    h = h + _attn(lp["cross_attn"], L.apply_norm(cfg, h, lp["ln_cross"]),
                  enc, cfg, causal=False)
    return h + T.ffn_block(lp["ffn"], L.apply_norm(cfg, h, lp["ln2"]), cfg)


def forward(params, batch, cfg: ArchConfig, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B, T) decoder ids + enc_frames (B, enc_seq, D)."""
    tokens = batch["tokens"]
    cd = L.torch_dtype(cfg.compute_dtype)
    enc = encode(params, batch["enc_frames"], cfg)
    x = L.embed_tokens(params["embed"], tokens, cd)
    x = x + _positions(x.shape[1], cfg, x)[None]
    for li in range(cfg.n_layers):
        lp = L.index_tree(params["dec_layers"], li)
        if remat and torch.is_grad_enabled():
            x = checkpoint(_dec_layer, lp, x, enc, cfg, use_reentrant=False)
        else:
            x = _dec_layer(lp, x, enc, cfg)
    x = L.apply_norm(cfg, x, params["ln_f"])
    return L.lm_logits(x, params["embed"].T, cfg.vocab_size, cd), {}  # tied head


# ---------------------------------------------------------------------- #
# decode
# ---------------------------------------------------------------------- #


def cache_table(cfg: ArchConfig, batch: int, max_len: int) -> Dict[str, Any]:
    dh = cfg.resolved_head_dim
    lyr = cfg.n_layers
    hkv = cfg.padded_kv_heads
    return {
        "k": L.LeafSpec((lyr, batch, max_len, hkv, dh),
                        ("layers", "batch", "kv_seq", None, None), "zeros"),
        "v": L.LeafSpec((lyr, batch, max_len, hkv, dh),
                        ("layers", "batch", "kv_seq", None, None), "zeros"),
        "cross_k": L.LeafSpec((lyr, batch, cfg.enc_seq, hkv, dh),
                              ("layers", "batch", None, None, None), "zeros"),
        "cross_v": L.LeafSpec((lyr, batch, cfg.enc_seq, hkv, dh),
                              ("layers", "batch", None, None, None), "zeros"),
    }


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, device="cuda"):
    dtype = dtype or L.torch_dtype(cfg.compute_dtype)
    return L.materialize(None, cache_table(cfg, batch, max_len), dtype, device)


def cache_axes(cfg: ArchConfig, batch: int = 1, max_len: int = 1):
    return L.axes_of(cache_table(cfg, batch, max_len))


def prime_cross_cache(params, cache: Dict[str, torch.Tensor],
                      enc: torch.Tensor, cfg: ArchConfig
                      ) -> Dict[str, torch.Tensor]:
    """Fill the cross-attention K/V from encoder states (prefill).  The
    cache's cross leaves are written in place (the reference returns a new
    cache); the updated dict is returned."""
    cd = enc.dtype
    b, s, _ = enc.shape
    shape = (b, s, cfg.padded_kv_heads, cfg.resolved_head_dim)
    for li in range(cfg.n_layers):
        p = L.index_tree(params["dec_layers"], li)["cross_attn"]
        for name, w in (("cross_k", p["wk"]), ("cross_v", p["wv"])):
            cache[name][li] = (enc @ w.to(cd)).reshape(shape).to(cache[name].dtype)
    return dict(cache)


def decode_step(params, cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                pos: int, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step for the whole batch: self-attention over the growing
    cache (the new K/V row written in place at ``pos``), cross-attention
    over the fixed encoder cache, the tied head."""
    cd = L.torch_dtype(cfg.compute_dtype)
    x = L.embed_tokens(params["embed"], tokens, cd)
    b = x.shape[0]
    hq, hkv = cfg.padded_heads, cfg.padded_kv_heads
    dh = cfg.resolved_head_dim
    s = cache["k"].shape[2]
    wp = min(max(int(pos), 0), s - 1)   # jnp indexing and dynamic_update_slice clamp
    x = x + L.sinusoidal_positions(s, cfg.d_model)[wp].to(x.device, cd)
    lengths = torch.full((b,), int(pos) + 1, dtype=torch.int32, device=x.device)
    enc_len = torch.full((b,), cache["cross_k"].shape[2], dtype=torch.int32,
                         device=x.device)
    for li in range(cfg.n_layers):
        lp = L.index_tree(params["dec_layers"], li)
        p = lp["self_attn"]
        xin = L.apply_norm(cfg, x[:, None], lp["ln1"])[:, 0]
        q = (xin @ p["wq"].to(cd)).reshape(b, hq, dh)
        kc, vc = cache["k"][li], cache["v"][li]
        kc[:, wp] = (xin @ p["wk"].to(cd)).reshape(b, hkv, dh).to(kc.dtype)
        vc[:, wp] = (xin @ p["wv"].to(cd)).reshape(b, hkv, dh).to(vc.dtype)
        a = L.decode_attention(q, kc, vc, lengths).reshape(b, hq * dh)
        x = x + (a.to(cd) @ p["wo"].to(cd)).to(x.dtype)
        # cross attention over the (fixed) encoder cache
        pc = lp["cross_attn"]
        xin = L.apply_norm(cfg, x[:, None], lp["ln_cross"])[:, 0]
        qx = (xin @ pc["wq"].to(cd)).reshape(b, hq, dh)
        ax = L.decode_attention(qx, cache["cross_k"][li], cache["cross_v"][li],
                                enc_len).reshape(b, hq * dh)
        x = x + (ax.to(cd) @ pc["wo"].to(cd)).to(x.dtype)
        xff = L.apply_norm(cfg, x[:, None], lp["ln2"])[:, 0]
        x = x + T.ffn_block(lp["ffn"], xff[:, None], cfg)[:, 0]
    x = L.apply_norm(cfg, x[:, None], params["ln_f"])[:, 0]
    logits = L.lm_logits(x[:, None], params["embed"].T.to(cd), cfg.vocab_size,
                         cd)[:, 0]
    return logits, cache
