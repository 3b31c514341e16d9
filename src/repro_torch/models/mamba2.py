"""Zamba2 (zamba2-2.7b): Mamba2 backbone + shared attention block.

Counterpart of ``repro/models/mamba2.py`` with the same param and cache
tables and the same arithmetic.  54 Mamba2 layers; after every 6th the
SHARED transformer block (attention + MLP, one set of parameters reused
for all 9 invocations; the per-invocation LoRA deltas are omitted, as in
the reference) is applied, as ``groups x (mamba x 6; shared block)``.

Mamba2 block: separate z/x/B/C/dt projections, depthwise causal conv on
(x, B, C), softplus dt, the SSD scan (:func:`repro_torch.kernels.ops.mamba2_ssd`:
the hand-written CUDA kernels for CUDA tensors, the chunked plain version
for CPU tensors), gated RMSNorm, out projection.  The shared block runs
:func:`repro_torch.models.transformer.decoder_layer`, whose attention is
the flash kernel (head dim 80 at full size).  ``remat=True`` recomputes
each Mamba layer in the backward pass (``torch.utils.checkpoint``); the
shared block is not recomputed, as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

CONV_W = 4


def _dims(cfg: ArchConfig):
    din = cfg.d_inner
    n = cfg.ssm_state
    p = cfg.ssm_state           # head dim == state dim (Mamba2 default)
    h = cfg.padded_ssm_heads
    return din, n, p, h


def mamba_table(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    din, n, p, h = _dims(cfg)
    dp = h * p  # padded inner
    return {
        "norm": L.norm_table(cfg),
        "wz": L.LeafSpec((d, dp), ("d_model", "heads_dh")),
        "wx": L.LeafSpec((d, dp), ("d_model", "heads_dh")),
        "wB": L.LeafSpec((d, n), ("d_model", None)),
        "wC": L.LeafSpec((d, n), ("d_model", None)),
        "wdt": L.LeafSpec((d, h), ("d_model", "heads")),
        "dt_bias": L.LeafSpec((h,), ("heads",), "zeros"),
        "A_log": L.LeafSpec((h,), ("heads",), "zeros"),
        "D_skip": L.LeafSpec((h,), ("heads",), "ones"),
        "conv_x": L.LeafSpec((CONV_W, dp), (None, "heads_dh"), "embed"),
        "conv_B": L.LeafSpec((CONV_W, n), (None, None), "embed"),
        "conv_C": L.LeafSpec((CONV_W, n), (None, None), "embed"),
        "gn": L.LeafSpec((dp,), ("heads_dh",), "ones"),
        "wo": L.LeafSpec((dp, d), ("heads_dh", "d_model")),
    }


def shared_block_table(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ln1": L.norm_table(cfg),
        "attn": T.attention_table(cfg),
        "ln2": L.norm_table(cfg),
        "ffn": T.ffn_table(cfg),
    }


def _group_shape(cfg: ArchConfig) -> Tuple[int, int]:
    per = max(1, cfg.attn_every)
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.n_layers} layers do not split into groups of "
                         f"{per}")
    return cfg.n_layers // per, per


def param_table(cfg: ArchConfig) -> Dict[str, Any]:
    v = cfg.padded_vocab
    groups, per = _group_shape(cfg)
    return {
        "embed": L.LeafSpec((v, cfg.d_model), ("vocab", "d_model"), "embed"),
        "groups": L.stacked(L.stacked(mamba_table(cfg), per), groups),
        "shared": shared_block_table(cfg),
        "ln_f": L.norm_table(cfg),
        "lm_head": L.LeafSpec((cfg.d_model, v), ("d_model", "vocab")),
    }


def init(seed: int, cfg: ArchConfig, device="cuda"):
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    (the reference's init kinds and scales, not its numbers).  As in the
    reference, ``A_log`` is re-drawn uniform in [0, 1) (decay rates
    A = -exp(A_log) in [-e, -1]) and padded heads get zero
    output-projection rows."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = L.materialize(gen, param_table(cfg), L.torch_dtype(cfg.param_dtype),
                           device)
    a_log = params["groups"]["A_log"]
    params["groups"]["A_log"] = torch.rand(
        a_log.shape, generator=gen, device=device).to(a_log.dtype)
    din, n, p, h = _dims(cfg)
    if h != cfg.ssm_heads:
        wo = params["groups"]["wo"]
        mask = torch.arange(h * p, device=wo.device) < cfg.ssm_heads * p
        params["groups"]["wo"] = wo * mask[None, None, :, None].to(wo.dtype)
    return params


def param_axes(cfg: ArchConfig):
    return L.axes_of(param_table(cfg))


def param_shapes(cfg: ArchConfig):
    return L.shapes_of(param_table(cfg), L.torch_dtype(cfg.param_dtype))


# ---------------------------------------------------------------------- #
# mamba2 block
# ---------------------------------------------------------------------- #


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 carry: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width CONV_W.  x (B, T, C), w (W, C).
    Returns (y, new_carry) where carry holds the last W-1 inputs.  The W
    shifted products are summed in the compute dtype in the reference's
    order (0 + w_0 x + w_1 x + ...), then silu."""
    b, t, c = x.shape
    if carry is None:
        carry = torch.zeros((b, CONV_W - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([carry, x], dim=1)
    y = sum(xp[:, i: i + t] * w[i][None, None] for i in range(CONV_W))
    return F.silu(y), xp[:, -(CONV_W - 1):]


def mamba_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                        # (B, T, D)
    cfg: ArchConfig,
    state: Optional[torch.Tensor] = None,
    conv_state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    b, t, d = x.shape
    din, n, pp, h = _dims(cfg)
    cd = x.dtype
    z = x @ p["wz"]
    xi = x @ p["wx"]
    Bm = x @ p["wB"]
    Cm = x @ p["wC"]
    dt = F.softplus((x @ p["wdt"]) + p["dt_bias"])
    cs = conv_state or {}
    xi, cs_x = _causal_conv(xi, p["conv_x"], cs.get("x"))
    Bm, cs_b = _causal_conv(Bm, p["conv_B"], cs.get("B"))
    Cm, cs_c = _causal_conv(Cm, p["conv_C"], cs.get("C"))
    A = -torch.exp(p["A_log"].float())
    xh = xi.reshape(b, t, h, pp)
    if t == 1:  # decode: O(1) recurrent step, no chunk padding
        if state is None:
            state = torch.zeros((b, h, pp, n), dtype=torch.float32,
                                device=x.device)
        y1, state = ops.mamba2_decode_step(xh[:, 0], dt[:, 0], A, Bm[:, 0],
                                           Cm[:, 0], state)
        y = y1[:, None]
    else:
        y, state = ops.mamba2_ssd(xh, dt, A, Bm, Cm, state)
    y = y + xh * p["D_skip"].to(cd)[None, None, :, None]
    y = y.reshape(b, t, h * pp)
    # gated RMSNorm (mamba2's norm before out projection)
    y = y * F.silu(z)
    y32 = y.float()
    rms = torch.rsqrt(torch.mean(y32 * y32, dim=-1, keepdim=True) + cfg.norm_eps)
    y = (y32 * rms * p["gn"].float()).to(cd)
    return y @ p["wo"], state, {"x": cs_x, "B": cs_b, "C": cs_c}


# ---------------------------------------------------------------------- #
# forward / decode
# ---------------------------------------------------------------------- #


def _mamba_body(h: torch.Tensor, lp, cfg: ArchConfig) -> torch.Tensor:
    lp = L.cast_tree(lp, h.dtype)
    y, _, _ = mamba_block(lp, L.apply_norm(cfg, h, lp["norm"]), cfg)
    return h + y


def forward(params, batch, cfg: ArchConfig, remat: bool = True):
    tokens = batch["tokens"]
    cd = L.torch_dtype(cfg.compute_dtype)
    x = L.embed_tokens(params["embed"], tokens, cd)
    t = x.shape[1]
    cos, sin = L.rope_freqs(cfg.rope_dim or cfg.resolved_head_dim,
                            cfg.rope_theta, torch.arange(t, device=x.device))
    shared = L.cast_tree(params["shared"], cd)
    groups, per = _group_shape(cfg)
    for g in range(groups):
        for li in range(per):
            lp = L.index_tree(params["groups"], g, li)
            if remat and torch.is_grad_enabled():
                x = checkpoint(_mamba_body, x, lp, cfg, use_reentrant=False)
            else:
                x = _mamba_body(x, lp, cfg)
        x = T.decoder_layer(shared, x, cfg, cos, sin)   # shared attn + MLP
    x = L.apply_norm(cfg, x, params["ln_f"])
    return L.lm_logits(x, params["lm_head"], cfg.vocab_size, cd), {}


def cache_table(cfg: ArchConfig, batch: int, max_len: int) -> Dict[str, Any]:
    din, n, p, h = _dims(cfg)
    groups, per = _group_shape(cfg)
    dh = cfg.resolved_head_dim
    return {
        "ssm_state": L.LeafSpec(
            (groups, per, batch, h, p, n),
            (None, "layers", "batch", "heads", None, None), "zeros",
        ),
        "conv_x": L.LeafSpec(
            (groups, per, batch, CONV_W - 1, h * p),
            (None, "layers", "batch", None, "heads_dh"), "zeros",
        ),
        "conv_B": L.LeafSpec(
            (groups, per, batch, CONV_W - 1, n),
            (None, "layers", "batch", None, None), "zeros",
        ),
        "conv_C": L.LeafSpec(
            (groups, per, batch, CONV_W - 1, n),
            (None, "layers", "batch", None, None), "zeros",
        ),
        # shared attention block KV cache -- one per invocation (group)
        "shared_k": L.LeafSpec(
            (groups, batch, max_len, cfg.padded_kv_heads, dh),
            (None, "batch", "kv_seq", None, None), "zeros",
        ),
        "shared_v": L.LeafSpec(
            (groups, batch, max_len, cfg.padded_kv_heads, dh),
            (None, "batch", "kv_seq", None, None), "zeros",
        ),
    }


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, device="cuda"):
    cd = dtype or L.torch_dtype(cfg.compute_dtype)
    c = L.materialize(None, cache_table(cfg, batch, max_len), cd, device)
    c["ssm_state"] = c["ssm_state"].float()
    return c


def cache_axes(cfg: ArchConfig, batch: int = 1, max_len: int = 1):
    return L.axes_of(cache_table(cfg, batch, max_len))


def decode_step(params, cache, tokens, pos, cfg: ArchConfig):
    """One decode step.  The new cache is returned as fresh tensors (the
    input cache is not written)."""
    cd = L.torch_dtype(cfg.compute_dtype)
    x = L.embed_tokens(params["embed"], tokens, cd)   # (B, D)
    b = x.shape[0]
    cos, sin = L.rope_freqs(cfg.rope_dim or cfg.resolved_head_dim,
                            cfg.rope_theta,
                            torch.tensor([int(pos)], device=x.device))
    shared = L.cast_tree(params["shared"], cd)
    hq = cfg.padded_heads
    dh = cfg.resolved_head_dim
    s = cache["shared_k"].shape[2]
    wp = min(max(int(pos), 0), s - 1)   # dynamic_update_slice clamps
    groups, per = _group_shape(cfg)
    new = {k: [] for k in cache}
    for g in range(groups):
        leaves = {k: [] for k in ("ssm_state", "conv_x", "conv_B", "conv_C")}
        for li in range(per):
            lp = L.cast_tree(L.index_tree(params["groups"], g, li), cd)
            xin = L.apply_norm(cfg, x[:, None], lp["norm"])   # (B, 1, D)
            y, sst, cs = mamba_block(
                lp, xin, cfg, state=cache["ssm_state"][g, li],
                conv_state={"x": cache["conv_x"][g, li],
                            "B": cache["conv_B"][g, li],
                            "C": cache["conv_C"][g, li]})
            x = x + y[:, 0]
            for k, val in (("ssm_state", sst), ("conv_x", cs["x"]),
                           ("conv_B", cs["B"]), ("conv_C", cs["C"])):
                leaves[k].append(val)
        for k, vals in leaves.items():
            new[k].append(torch.stack(vals))
        # shared attention block, single-token
        p = shared["attn"]
        xin = L.apply_norm(cfg, x[:, None], shared["ln1"])[:, 0]
        q = (xin @ p["wq"]).reshape(b, hq, dh)
        knew = (xin @ p["wk"]).reshape(b, cfg.padded_kv_heads, dh)
        vnew = (xin @ p["wv"]).reshape(b, cfg.padded_kv_heads, dh)
        if cfg.rope_theta > 0:
            q = L.apply_rope(q[:, None], cos, sin)[:, 0]
            knew = L.apply_rope(knew[:, None], cos, sin)[:, 0]
        kc = cache["shared_k"][g].clone()
        vc = cache["shared_v"][g].clone()
        kc[:, wp] = knew.to(kc.dtype)
        vc[:, wp] = vnew.to(vc.dtype)
        lengths = torch.full((b,), int(pos) + 1, dtype=torch.int32,
                             device=x.device)
        a = L.decode_attention(q, kc, vc, lengths).reshape(b, hq * dh)
        x = x + (a.to(cd) @ p["wo"]).to(x.dtype)
        xff = L.apply_norm(cfg, x[:, None], shared["ln2"])[:, 0]
        x = x + T.ffn_block(shared["ffn"], xff[:, None], cfg)[:, 0]
        new["shared_k"].append(kc)
        new["shared_v"].append(vc)
    new_cache = {k: torch.stack(v) for k, v in new.items()}
    x = L.apply_norm(cfg, x[:, None], params["ln_f"])[:, 0]
    logits = L.lm_logits(x[:, None], params["lm_head"].to(cd),
                         cfg.vocab_size, cd)[:, 0]
    return logits, new_cache
