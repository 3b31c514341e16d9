"""RWKV6 "Finch" (rwkv6-3b): attention-free, data-dependent decay.

Counterpart of ``repro/models/rwkv6.py`` with the same param and cache
tables (layer-stacked ``(L, ...)`` leaves under the same key paths) and
the same arithmetic.  Time-mix block: token-shift ddlerp (LoRA-modulated
interpolation with the previous token), r/k/v/g projections,
data-dependent per-channel decay ``w = exp(-exp(w0 + lora(x)))``, the WKV
recurrence (:func:`repro_torch.kernels.ops.wkv6`: the hand-written CUDA
kernels for CUDA tensors, the chunked plain version for CPU tensors),
per-head group norm, silu(g) gating, output projection.  Channel-mix
block: token-shift lerp, squared-ReLU k projection, sigmoid receptance
gate.  ``remat=True`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, where the reference has ``jax.checkpoint``).

Heads (40 of size 64) are padded to the TP degree with inert heads (zero
output-projection rows).  Decode state is O(H * D^2) per layer.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

LORA_MIX = 32     # ddlerp LoRA rank (5 interpolations)
LORA_DECAY = 64   # decay LoRA rank
GROUP_NORM_EPS = 64e-5


def _dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    dh = cfg.ssm_state                      # RWKV head size (64)
    hp = cfg.padded_rwkv_heads              # padded head count
    return cfg.d_model, hp, dh


def time_mix_table(cfg: ArchConfig) -> Dict[str, Any]:
    d, hp, dh = _dims(cfg)
    dp = hp * dh  # padded inner width
    return {
        "mu_x": L.LeafSpec((d,), ("d_model",), "zeros"),
        "mu_rkvgw": L.LeafSpec((5, d), (None, "d_model"), "zeros"),
        "mix_w1": L.LeafSpec((d, 5 * LORA_MIX), ("d_model", None)),
        "mix_w2": L.LeafSpec((5, LORA_MIX, d), (None, None, "d_model")),
        "wr": L.LeafSpec((d, dp), ("d_model", "heads_dh")),
        "wk": L.LeafSpec((d, dp), ("d_model", "heads_dh")),
        "wv": L.LeafSpec((d, dp), ("d_model", "heads_dh")),
        "wg": L.LeafSpec((d, dp), ("d_model", "heads_dh")),
        "w0": L.LeafSpec((dp,), ("heads_dh",), "zeros"),
        "decay_w1": L.LeafSpec((d, LORA_DECAY), ("d_model", None)),
        "decay_w2": L.LeafSpec((LORA_DECAY, dp), (None, "heads_dh")),
        "u": L.LeafSpec((hp, dh), ("heads", None), "zeros"),
        "ln_x_g": L.LeafSpec((hp, dh), ("heads", None), "ones"),
        "ln_x_b": L.LeafSpec((hp, dh), ("heads", None), "zeros"),
        "wo": L.LeafSpec((dp, d), ("heads_dh", "d_model")),
    }


def channel_mix_table(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "mu_k": L.LeafSpec((d,), ("d_model",), "zeros"),
        "mu_r": L.LeafSpec((d,), ("d_model",), "zeros"),
        "wk": L.LeafSpec((d, cfg.d_ff), ("d_model", "d_ff")),
        "wv": L.LeafSpec((cfg.d_ff, d), ("d_ff", "d_model")),
        "wr": L.LeafSpec((d, d), ("d_model", "d_model2")),
    }


def layer_table(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ln1": L.norm_table(cfg),
        "time_mix": time_mix_table(cfg),
        "ln2": L.norm_table(cfg),
        "channel_mix": channel_mix_table(cfg),
    }


def param_table(cfg: ArchConfig) -> Dict[str, Any]:
    v = cfg.padded_vocab
    return {
        "embed": L.LeafSpec((v, cfg.d_model), ("vocab", "d_model"), "embed"),
        "ln_in": L.norm_table(cfg),
        "layers": L.stacked(layer_table(cfg), cfg.n_layers),
        "ln_f": L.norm_table(cfg),
        "lm_head": L.LeafSpec((cfg.d_model, v), ("d_model", "vocab")),
    }


def init(seed: int, cfg: ArchConfig, device="cuda"):
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    (the reference's init kinds and scales, not its numbers); padded
    heads get zero output-projection rows."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = L.materialize(gen, param_table(cfg), L.torch_dtype(cfg.param_dtype),
                           device)
    if cfg.padded_rwkv_heads != cfg.rwkv_heads:
        dp = cfg.padded_rwkv_heads * cfg.ssm_state
        wo = params["layers"]["time_mix"]["wo"]
        mask = torch.arange(dp, device=wo.device) < cfg.rwkv_heads * cfg.ssm_state
        params["layers"]["time_mix"]["wo"] = wo * mask[None, :, None].to(wo.dtype)
    return params


def param_axes(cfg: ArchConfig):
    return L.axes_of(param_table(cfg))


def param_shapes(cfg: ArchConfig):
    return L.shapes_of(param_table(cfg), L.torch_dtype(cfg.param_dtype))


# ---------------------------------------------------------------------- #
# blocks
# ---------------------------------------------------------------------- #


def _shift(x: torch.Tensor, last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token shift: previous position (zeros / supplied carry at t=0)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _ddlerp(p, x, dx):
    """RWKV6 data-dependent interpolation -> 5 mixed inputs (r,k,v,g,w)."""
    xx = x + dx * p["mu_x"]
    mix = torch.tanh(xx @ p["mix_w1"]).reshape(*x.shape[:-1], 5, LORA_MIX)
    delta = torch.einsum("btfr,frd->btfd", mix, p["mix_w2"])  # (B,T,5,D)
    mus = p["mu_rkvgw"][None, None] + delta
    return x[..., None, :] + dx[..., None, :] * mus           # (B,T,5,D)


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """``w = exp(-exp(w0 + lora(xw)))`` in f32 (float64 for float64
    inputs), exponent clipped to [-8, 1] (so w lies in [e^-e, 1))."""
    dec = torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]
    x = p["w0"] + dec
    return torch.exp(-torch.exp(x.to(L.acc_dtype(x.dtype)).clamp(-8.0, 1.0)))


def _group_norm(p, y: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """Per-head group norm in f32 (population variance, as ``jnp.var``);
    float64 stays float64."""
    y32 = y.to(L.acc_dtype(y.dtype))
    mu = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, correction=0)
    return ((y32 - mu) * torch.rsqrt(var + GROUP_NORM_EPS) * p["ln_x_g"]
            + p["ln_x_b"]).to(cd)


def time_mix(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                        # (B, T, D)
    cfg: ArchConfig,
    state: Optional[torch.Tensor] = None,   # (B, H, Dh, Dh) WKV state
    shift_last: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t, d = x.shape
    _, hp, dh = _dims(cfg)
    cd = x.dtype
    dx = _shift(x, shift_last) - x
    mixed = _ddlerp(p, x, dx)
    xr, xk, xv, xg, xw = (mixed[:, :, i] for i in range(5))
    r = (xr @ p["wr"]).reshape(b, t, hp, dh)
    k = (xk @ p["wk"]).reshape(b, t, hp, dh)
    v = (xv @ p["wv"]).reshape(b, t, hp, dh)
    g = xg @ p["wg"]
    w = _decay(p, xw).reshape(b, t, hp, dh)

    y, state = ops.wkv6(r, k, v, w, p["u"], state)
    y = _group_norm(p, y, cd)
    y = (y.reshape(b, t, hp * dh) * F.silu(g)) @ p["wo"]
    return y, state


def channel_mix(p, x, shift_last=None):
    dx = _shift(x, shift_last) - x
    xk = x + dx * p["mu_k"]
    xr = x + dx * p["mu_r"]
    k = torch.square(F.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])


# ---------------------------------------------------------------------- #
# forward / decode
# ---------------------------------------------------------------------- #


def _block(h: torch.Tensor, lp, cfg: ArchConfig) -> torch.Tensor:
    lp = L.cast_tree(lp, h.dtype)
    tm, _ = time_mix(lp["time_mix"], L.apply_norm(cfg, h, lp["ln1"]), cfg)
    h = h + tm
    return h + channel_mix(lp["channel_mix"], L.apply_norm(cfg, h, lp["ln2"]))


def forward(params, batch, cfg: ArchConfig, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    tokens = batch["tokens"]
    cd = L.torch_dtype(cfg.compute_dtype)
    x = L.embed_tokens(params["embed"], tokens, cd)
    x = L.apply_norm(cfg, x, params["ln_in"])
    for li in range(cfg.n_layers):
        lp = L.index_tree(params["layers"], li)
        if remat and torch.is_grad_enabled():
            x = checkpoint(_block, x, lp, cfg, use_reentrant=False)
        else:
            x = _block(x, lp, cfg)
    x = L.apply_norm(cfg, x, params["ln_f"])
    return L.lm_logits(x, params["lm_head"], cfg.vocab_size, cd), {}


def cache_table(cfg: ArchConfig, batch: int, max_len: int) -> Dict[str, Any]:
    d, hp, dh = _dims(cfg)
    lyr = cfg.n_layers
    return {
        "wkv_state": L.LeafSpec(
            (lyr, batch, hp, dh, dh), ("layers", "batch", "heads", None, None), "zeros"
        ),
        "shift_tm": L.LeafSpec((lyr, batch, d), ("layers", "batch", None), "zeros"),
        "shift_cm": L.LeafSpec((lyr, batch, d), ("layers", "batch", None), "zeros"),
    }


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, device="cuda"):
    # WKV state is fp32 (recurrence numerics; float64 for a float64
    # compute dtype); shifts follow compute dtype.
    cd = dtype or L.torch_dtype(cfg.compute_dtype)
    c = L.materialize(None, cache_table(cfg, batch, max_len),
                      L.acc_dtype(cd), device)
    c["shift_tm"] = c["shift_tm"].to(cd)
    c["shift_cm"] = c["shift_cm"].to(cd)
    return c


def cache_axes(cfg: ArchConfig, batch: int = 1, max_len: int = 1):
    return L.axes_of(cache_table(cfg, batch, max_len))


def decode_step(params, cache, tokens, pos, cfg: ArchConfig):
    """O(1)-state decode: WKV state + the two token-shift carries.  The
    new cache is returned as fresh tensors (the input cache is not
    written)."""
    del pos  # recurrent: position-free
    cd = L.torch_dtype(cfg.compute_dtype)
    x = L.embed_tokens(params["embed"], tokens, cd)          # (B, D)
    x = L.apply_norm(cfg, x[:, None], params["ln_in"])[:, 0]
    wkv_new, sh_tm_new, sh_cm_new = [], [], []
    for li in range(cfg.n_layers):
        lp = L.cast_tree(L.index_tree(params["layers"], li), cd)
        xin = L.apply_norm(cfg, x[:, None], lp["ln1"])[:, 0]
        tm_out, wkv_s = _time_mix_step(lp["time_mix"], xin, cfg,
                                       cache["wkv_state"][li],
                                       cache["shift_tm"][li])
        x = x + tm_out
        xcm = L.apply_norm(cfg, x[:, None], lp["ln2"])[:, 0]
        cm = lp["channel_mix"]
        dxc = cache["shift_cm"][li] - xcm
        kcm = torch.square(F.relu((xcm + dxc * cm["mu_k"]) @ cm["wk"]))
        rcm = torch.sigmoid((xcm + dxc * cm["mu_r"]) @ cm["wr"])
        x = x + rcm * (kcm @ cm["wv"])
        wkv_new.append(wkv_s)
        sh_tm_new.append(xin)
        sh_cm_new.append(xcm)
    new_cache = {"wkv_state": torch.stack(wkv_new),
                 "shift_tm": torch.stack(sh_tm_new),
                 "shift_cm": torch.stack(sh_cm_new)}
    x = L.apply_norm(cfg, x[:, None], params["ln_f"])[:, 0]
    logits = L.lm_logits(x[:, None], params["lm_head"].to(cd),
                         cfg.vocab_size, cd)[:, 0]
    return logits, new_cache


def _time_mix_step(p, x, cfg, state, shift_last):
    """Single-token time-mix: x (B, D), state (B, H, Dh, Dh)."""
    b, d = x.shape
    _, hp, dh = _dims(cfg)
    dx = shift_last - x
    xx = x + dx * p["mu_x"]
    mix = torch.tanh(xx @ p["mix_w1"]).reshape(b, 5, LORA_MIX)
    delta = torch.einsum("bfr,frd->bfd", mix, p["mix_w2"])
    mixed = x[:, None, :] + dx[:, None, :] * (p["mu_rkvgw"][None] + delta)
    xr, xk, xv, xg, xw = (mixed[:, i] for i in range(5))
    r = (xr @ p["wr"]).reshape(b, hp, dh)
    k = (xk @ p["wk"]).reshape(b, hp, dh)
    v = (xv @ p["wv"]).reshape(b, hp, dh)
    g = xg @ p["wg"]
    w = _decay(p, xw).reshape(b, hp, dh)
    y, state = ops.wkv6_decode_step(r, k, v, w, p["u"], state)
    y = _group_norm(p, y, x.dtype)
    y = (y.reshape(b, hp * dh) * F.silu(g)) @ p["wo"]
    return y, state
