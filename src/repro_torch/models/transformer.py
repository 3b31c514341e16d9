"""Dense transformer family: starcoder2 / phi3 / minicpm3 (MLA) / gemma-style.

Counterpart of ``repro/models/transformer.py`` with the same param and
cache tables (layer-stacked ``(L, ...)`` leaves under the same key
paths) and the same arithmetic.  ``forward`` (training) runs its
attention through :func:`repro_torch.models.layers.flash_attention`, and
``paged_decode_step`` through :func:`repro_torch.kernels.ops.paged_attention`
(or the int8 form): the hand-written CUDA kernels for CUDA tensors, the
plain versions for CPU tensors.  ``remat=True`` recomputes each layer in
the backward pass (``torch.utils.checkpoint``, where the reference has
``jax.checkpoint``).

Multi-head Latent Attention (MiniCPM3): training materializes per-head K
(qk width) and V (``v_head_dim``, narrower) and runs the flash kernel with
its own V width; decoding caches only the latent ``ckv`` and the shared
rope key and attends in latent space (the absorbed-matmul form), with
plain einsums as the reference does, on both the contiguous and the
paged path.

``forward(prefix_embeds=...)`` is the prefix-LM (paligemma): the prefix
rows go in front of the token embeddings, attention sees them from every
row (``prefix_len`` down to the flash kernel) and their logits are
dropped.

``forward(mesh=...)`` with ``cfg.seq_parallel`` is the reference's
Ulysses prefill (inference only), one rank of a
:class:`repro_torch.distributed.mesh.Mesh` in each process: the rank
takes its rows of the batch over (``pod``, ``data``) and its block of
the sequence over ``model``, and keeps activations sequence-sharded
through the layers.  Attention trades heads for tokens with two
all-to-alls over ``model`` (K/V, or MLA's latent stream, all-gathered)
and runs the rank's heads over the whole sequence through the flash
kernel; ``wo`` is replicated (no sum).  The FFN is tensor-parallel over
``model`` (all-gather the tokens, column/row blocks, reduce-scatter back
to the rank's tokens) unless ``cfg.replicate_ffn``.  The rank's FFN
blocks are views of whole weights, or the blocks themselves
(:func:`seqpar_params` keeps only those).  It returns the rank's block
of the logits, ``(B / data ranks, T / model ranks, V)``.  A mesh without
``cfg.seq_parallel`` runs the plain forward, as the reference does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.mesh import MODEL_AXIS
from repro_torch.kernels import ops
from repro_torch.memory.codecs import (SCALE_SUFFIX, int8_dequantize,
                                       int8_quantize)
from repro_torch.models import layers as L


# ---------------------------------------------------------------------- #
# param tables
# ---------------------------------------------------------------------- #


def attention_table(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    dh = cfg.resolved_head_dim
    hq = cfg.padded_heads
    hkv = cfg.padded_kv_heads
    if cfg.mla is not None:
        m = cfg.mla
        qk_dim = m.qk_nope_dim + m.qk_rope_dim
        return {
            "w_dq": L.LeafSpec((d, m.q_lora_rank), ("d_model", "q_lora")),
            "q_norm": L.LeafSpec((m.q_lora_rank,), ("q_lora",), "ones"),
            "w_uq": L.LeafSpec((m.q_lora_rank, hq * qk_dim), ("q_lora", "heads_dh")),
            "w_dkv": L.LeafSpec(
                (d, m.kv_lora_rank + m.qk_rope_dim), ("d_model", "kv_lora")
            ),
            "kv_norm": L.LeafSpec((m.kv_lora_rank,), ("kv_lora",), "ones"),
            "w_uk": L.LeafSpec(
                (m.kv_lora_rank, hq * m.qk_nope_dim), ("kv_lora", "heads_dh")
            ),
            "w_uv": L.LeafSpec(
                (m.kv_lora_rank, hq * m.v_head_dim), ("kv_lora", "heads_dh")
            ),
            "wo": L.LeafSpec((hq * m.v_head_dim, d), ("heads_dh", "d_model")),
        }
    kv_axis = "kv_heads_dh" if cfg.kv_sharded else "kv_heads_rep"
    return {
        "wq": L.LeafSpec((d, hq * dh), ("d_model", "heads_dh")),
        "wk": L.LeafSpec((d, hkv * dh), ("d_model", kv_axis)),
        "wv": L.LeafSpec((d, hkv * dh), ("d_model", kv_axis)),
        "wo": L.LeafSpec((hq * dh, d), ("heads_dh", "d_model")),
    }


def ffn_table(cfg: ArchConfig, d_ff: Optional[int] = None) -> Dict[str, Any]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {
            "wg": L.LeafSpec((d, f), ("d_model", "d_ff")),
            "wu": L.LeafSpec((d, f), ("d_model", "d_ff")),
            "wd": L.LeafSpec((f, d), ("d_ff", "d_model")),
        }
    return {
        "wi": L.LeafSpec((d, f), ("d_model", "d_ff")),
        "wd": L.LeafSpec((f, d), ("d_ff", "d_model")),
    }


def layer_table(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ln1": L.norm_table(cfg),
        "attn": attention_table(cfg),
        "ln2": L.norm_table(cfg),
        "ffn": ffn_table(cfg),
    }


def param_table(cfg: ArchConfig) -> Dict[str, Any]:
    v = cfg.padded_vocab
    t: Dict[str, Any] = {
        "embed": L.LeafSpec((v, cfg.d_model), ("vocab", "d_model"), "embed"),
        "layers": L.stacked(layer_table(cfg), cfg.n_layers),
        "ln_f": L.norm_table(cfg),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = L.LeafSpec((cfg.d_model, v), ("d_model", "vocab"))
    return t


def init(seed: int, cfg: ArchConfig, device="cuda", cast: bool = False):
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (same init kinds and scales as the reference;
    not the same numbers — its PRNG differs).  ``cast=True`` stores each
    leaf as :func:`cast_params` would leave it, cast as it is drawn (a
    serving tree, without the float32 tree held whole)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = L.materialize(gen, param_table(cfg), L.torch_dtype(cfg.param_dtype),
                           device, leaf_dtype=cast_dtype(cfg) if cast else None)
    return _zero_padded_heads(params, cfg)


def param_axes(cfg: ArchConfig):
    return L.axes_of(param_table(cfg))


def param_shapes(cfg: ArchConfig):
    return L.shapes_of(param_table(cfg), L.torch_dtype(cfg.param_dtype))


def _zero_padded_heads(params, cfg: ArchConfig):
    """Zero the wo rows of padded heads so they are mathematically inert."""
    extra = cfg.padded_heads - cfg.n_heads
    if extra == 0:
        return params
    dh = cfg.mla.v_head_dim if cfg.mla is not None else cfg.resolved_head_dim
    wo = params["layers"]["attn"]["wo"]
    mask = torch.arange(cfg.padded_heads * dh, device=wo.device) < cfg.n_heads * dh
    params["layers"]["attn"]["wo"] = wo * mask[None, :, None].to(wo.dtype)
    return params


# leaves the reference reads in fp32 (norm scales); every other leaf it
# casts to the compute dtype where it uses it
_FP32_LEAVES = ("gamma", "beta", "q_norm", "kv_norm")


def cast_dtype(cfg: ArchConfig):
    """The dtype :func:`cast_params` leaves a leaf in, by its "a/b/c"
    name."""
    pd, cd = L.torch_dtype(cfg.param_dtype), L.torch_dtype(cfg.compute_dtype)
    return lambda name: pd if name.rsplit("/", 1)[-1] in _FP32_LEAVES else cd


def cast_params(params, cfg: ArchConfig):
    """The parameters as the decode path reads them: every leaf that the
    reference casts to the compute dtype at each use (``.astype(cd)``),
    cast once here.  The cast is deterministic, so the values match."""
    cd = L.torch_dtype(cfg.compute_dtype)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else v if k in _FP32_LEAVES else v.to(cd)
                for k, v in tree.items()}

    return walk(params)


# ---------------------------------------------------------------------- #
# blocks
# ---------------------------------------------------------------------- #


def _rope_tables(cfg: ArchConfig, positions: torch.Tensor):
    if cfg.mla is not None:
        dim = cfg.mla.qk_rope_dim
    else:
        dim = cfg.rope_dim or cfg.resolved_head_dim
    return L.rope_freqs(dim, cfg.rope_theta, positions)


def attention_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,              # (B, T, D)
    cfg: ArchConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    prefix_len: int = 0,
    causal: bool = True,
) -> torch.Tensor:
    b, t, _ = x.shape
    cd = L.torch_dtype(cfg.compute_dtype)
    xc = x.to(cd)
    hq = cfg.padded_heads
    if cfg.mla is not None:
        m = cfg.mla
        qk_dim = m.qk_nope_dim + m.qk_rope_dim
        cq = L.rmsnorm(xc @ p["w_dq"].to(cd), p["q_norm"], cfg.norm_eps)
        q = (cq @ p["w_uq"].to(cd)).reshape(b, t, hq, qk_dim)
        q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
        dkv = xc @ p["w_dkv"].to(cd)
        ckv = L.rmsnorm(dkv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
        k_rope = dkv[..., m.kv_lora_rank:][:, :, None, :]     # (B, T, 1, rope)
        q_rope = L.apply_rope(q_rope, cos, sin)
        k_rope = L.apply_rope(k_rope, cos, sin)
        k_nope = (ckv @ p["w_uk"].to(cd)).reshape(b, t, hq, m.qk_nope_dim)
        v = (ckv @ p["w_uv"].to(cd)).reshape(b, t, hq, m.v_head_dim)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat(
            [k_nope, k_rope.expand(b, t, hq, m.qk_rope_dim)], dim=-1)
        # V keeps its own width: the kernel's output is (B, T, H, v_head_dim)
        out = L.flash_attention(q_full, k_full, v, causal=causal,
                                prefix_len=prefix_len, scale=qk_dim ** -0.5)
        return (out.reshape(b, t, hq * m.v_head_dim)
                @ p["wo"].to(cd)).to(x.dtype)
    dh = cfg.resolved_head_dim
    hkv = cfg.padded_kv_heads
    q = (xc @ p["wq"].to(cd)).reshape(b, t, hq, dh)
    k = (xc @ p["wk"].to(cd)).reshape(b, t, hkv, dh)
    v = (xc @ p["wv"].to(cd)).reshape(b, t, hkv, dh)
    if cfg.rope_theta > 0:
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    out = L.flash_attention(q, k, v, causal=causal, prefix_len=prefix_len)
    return (out.reshape(b, t, hq * dh) @ p["wo"].to(cd)).to(x.dtype)


def ffn_block(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig
              ) -> torch.Tensor:
    cd = L.torch_dtype(cfg.compute_dtype)
    xc = x.to(cd)
    act = L.act_fn(cfg.act)
    if cfg.act in ("swiglu", "geglu"):
        h = act(xc @ p["wg"].to(cd)) * (xc @ p["wu"].to(cd))
    else:
        h = act(xc @ p["wi"].to(cd))
    return (h @ p["wd"].to(cd)).to(x.dtype)


def decoder_layer(
    lp: Dict[str, Any],
    x: torch.Tensor,
    cfg: ArchConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    prefix_len: int = 0,
) -> torch.Tensor:
    x = x + attention_block(
        lp["attn"], L.apply_norm(cfg, x, lp["ln1"]), cfg, cos, sin, prefix_len
    )
    x = x + ffn_block(lp["ffn"], L.apply_norm(cfg, x, lp["ln2"]), cfg)
    return x


# ---------------------------------------------------------------------- #
# full-sequence forward (train / prefill)
# ---------------------------------------------------------------------- #


def forward(
    params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    remat: bool = True,
    prefix_embeds: Optional[torch.Tensor] = None,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token (+ optional prefix embedding) sequence -> next-token
    logits of the tokens.  With ``remat`` each layer's activations are
    recomputed in the backward pass."""
    if cfg.seq_parallel and mesh is not None:
        return _forward_seqpar(params, batch, cfg, mesh)
    tokens = batch["tokens"]
    cd = L.torch_dtype(cfg.compute_dtype)
    x = L.embed_tokens(params["embed"], tokens, cd)
    prefix_len = 0
    if prefix_embeds is not None:
        prefix_len = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(cd), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    cos, sin = _rope_tables(cfg, positions)
    for li in range(cfg.n_layers):
        lp = L.index_tree(params["layers"], li)
        if remat and torch.is_grad_enabled():
            x = checkpoint(decoder_layer, lp, x, cfg, cos, sin, prefix_len,
                           use_reentrant=False)
        else:
            x = decoder_layer(lp, x, cfg, cos, sin, prefix_len)
    x = L.apply_norm(cfg, x, params["ln_f"])
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = L.lm_logits(x, head, cfg.vocab_size, cd)
    if prefix_len:
        logits = logits[:, prefix_len:]
    return logits, {}


# ---------------------------------------------------------------------- #
# Ulysses sequence-parallel prefill (the reference's shard_map islands)
# ---------------------------------------------------------------------- #


def seqpar_params(params, cfg: ArchConfig, mesh):
    """This rank's parameters for :func:`forward` on ``mesh``: the FFN
    weights' blocks over ``model`` (copies), every other leaf as given
    (the reference's ``_seqpar_layer_specs``: the FFN tensor-parallel
    unless ``replicate_ffn``, the rest replicated)."""
    if cfg.replicate_ffn:
        return params
    out = dict(params)
    out["layers"] = mesh.local_tree(params["layers"],
                                    L.axes_of(L.stacked(layer_table(cfg),
                                                        cfg.n_layers)),
                                    ("d_ff",))
    return out


def _mla_attn_ulysses(p, x, cfg: ArchConfig, t_loc: int, group, ti: int,
                      tp: int):
    """One MLA attention block on a sequence block (the reference's
    ``_mla_attn_ulysses``)."""
    m = cfg.mla
    b = x.shape[0]
    hq = cfg.padded_heads
    h_loc = hq // tp
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    pos = ti * t_loc + torch.arange(t_loc, device=x.device)
    cos, sin = L.rope_freqs(m.qk_rope_dim, cfg.rope_theta, pos)

    cq = L.rmsnorm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(b, t_loc, hq, qk_dim)
    q = torch.cat([q[..., :m.qk_nope_dim],
                   L.apply_rope(q[..., m.qk_nope_dim:], cos, sin)], dim=-1)
    dkv = x @ p["w_dkv"]
    ckv = L.rmsnorm(dkv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = L.apply_rope(dkv[:, :, None, m.kv_lora_rank:], cos, sin)[:, :, 0]

    # q: (b, T, h_loc, qk); the latents to the whole sequence
    q = C.all_to_all(q, group, split_axis=2, concat_axis=1)
    ckv_full = C.all_gather(ckv, group, axis=1)
    krope_full = C.all_gather(k_rope, group, axis=1)

    # only this rank's heads are expanded from the latent stream
    heads = slice(ti * h_loc, (ti + 1) * h_loc)
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, hq, m.qk_nope_dim)[:, heads]
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, hq, m.v_head_dim)[:, heads]
    k_nope = torch.einsum("btr,rhn->bthn", ckv_full, w_uk)
    v = torch.einsum("btr,rhv->bthv", ckv_full, w_uv).contiguous()
    t_full = k_nope.shape[1]
    k = torch.cat([k_nope, krope_full[:, :, None, :].expand(
        b, t_full, h_loc, m.qk_rope_dim)], dim=-1)
    out = L.flash_attention(q, k, v, causal=True, scale=qk_dim ** -0.5)
    out = C.all_to_all(out, group, split_axis=1, concat_axis=2)
    return out.reshape(b, t_loc, hq * m.v_head_dim) @ p["wo"]


def _gqa_attn_ulysses(p, x, cfg: ArchConfig, t_loc: int, group, ti: int,
                      tp: int):
    """Ulysses attention for GQA (the reference's ``_gqa_attn_ulysses``):
    q all-to-all, the few kv heads all-gathered, each local q head mapped
    to its kv head as ``(ti * h_loc + h) // g``."""
    b = x.shape[0]
    hq = cfg.padded_heads
    hkv = cfg.padded_kv_heads
    h_loc = hq // tp
    dh = cfg.resolved_head_dim
    pos = ti * t_loc + torch.arange(t_loc, device=x.device)
    cos, sin = L.rope_freqs(cfg.rope_dim or dh, cfg.rope_theta, pos)
    q = (x @ p["wq"]).reshape(b, t_loc, hq, dh)
    k = (x @ p["wk"]).reshape(b, t_loc, hkv, dh)
    v = (x @ p["wv"]).reshape(b, t_loc, hkv, dh)
    if cfg.rope_theta > 0:
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    q = C.all_to_all(q, group, split_axis=2, concat_axis=1)
    k = C.all_gather(k, group, axis=1)                   # (b, T, hkv, dh)
    v = C.all_gather(v, group, axis=1)
    kv_ids = (ti * h_loc + torch.arange(h_loc, device=x.device)) // (hq // hkv)
    out = L.flash_attention(q, k.index_select(2, kv_ids),
                            v.index_select(2, kv_ids), causal=True)
    out = C.all_to_all(out, group, split_axis=1, concat_axis=2)
    return out.reshape(b, t_loc, hq * dh) @ p["wo"]


def _ffn_tp_island(p, x, cfg: ArchConfig, group, mesh):
    """Tensor-parallel FFN fed by a sequence block: all-gather the tokens,
    the rank's column / row blocks, reduce-scatter back to its tokens
    (the reference's ``_ffn_tp_island``; ``replicate_ffn``: whole weights,
    local rows only)."""
    act = L.act_fn(cfg.act)
    gated = cfg.act in ("swiglu", "geglu")
    if cfg.replicate_ffn:
        if gated:
            return (act(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
        return act(x @ p["wi"]) @ p["wd"]
    f = cfg.d_ff
    xf = C.all_gather(x, group, axis=1)                  # (b, T, D)
    if gated:
        h = act(xf @ mesh.block(p["wg"], 1, f)) * (xf @ mesh.block(p["wu"], 1, f))
    else:
        h = act(xf @ mesh.block(p["wi"], 1, f))
    part = h @ mesh.block(p["wd"], 0, f)                 # partial over F
    # the partials summed in float32 and rounded once, as one process's
    # matmul over all of F rounds its sum once
    return C.psum_scatter(part.float(), group, axis=1).to(x.dtype)


@torch.no_grad()
def _forward_seqpar(params, batch, cfg: ArchConfig, mesh):
    """The Ulysses prefill on one rank (the reference's
    ``_forward_gqa_seqpar`` / ``_forward_mla_seqpar``)."""
    cd = L.torch_dtype(cfg.compute_dtype)
    tp = mesh.axis_size(MODEL_AXIS)
    ti = mesh.index(MODEL_AXIS)
    group = mesh.group(MODEL_AXIS)
    tokens = mesh.shard_rows(batch["tokens"])
    tokens = mesh.shard_rows(tokens, MODEL_AXIS, dim=1)
    t_loc = tokens.shape[1]
    if cfg.padded_heads % tp:
        raise ValueError(f"{cfg.padded_heads} heads do not split over {tp} "
                         "ranks of 'model'")
    attn = _mla_attn_ulysses if cfg.mla is not None else _gqa_attn_ulysses
    x = L.embed_tokens(params["embed"], tokens, cd)
    for li in range(cfg.n_layers):
        # the reference casts every layer leaf to the compute dtype
        lp = L.cast_tree(L.index_tree(params["layers"], li), cd)
        x = x + attn(lp["attn"], L.apply_norm(cfg, x, lp["ln1"]), cfg, t_loc,
                     group, ti, tp)
        x = x + _ffn_tp_island(lp["ffn"], L.apply_norm(cfg, x, lp["ln2"]),
                               cfg, group, mesh)
    x = L.apply_norm(cfg, x, params["ln_f"])
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return L.lm_logits(x, head, cfg.vocab_size, cd), {}


# ---------------------------------------------------------------------- #
# decode (serve) path
# ---------------------------------------------------------------------- #


def cache_table(cfg: ArchConfig, batch: int, max_len: int) -> Dict[str, Any]:
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "ckv": L.LeafSpec(
                (cfg.n_layers, batch, max_len, m.kv_lora_rank),
                ("layers", "batch", "kv_seq", None),
                "zeros",
            ),
            "k_rope": L.LeafSpec(
                (cfg.n_layers, batch, max_len, m.qk_rope_dim),
                ("layers", "batch", "kv_seq", None),
                "zeros",
            ),
        }
    dh = cfg.resolved_head_dim
    return {
        "k": L.LeafSpec(
            (cfg.n_layers, batch, max_len, cfg.padded_kv_heads, dh),
            ("layers", "batch", "kv_seq", None, None),
            "zeros",
        ),
        "v": L.LeafSpec(
            (cfg.n_layers, batch, max_len, cfg.padded_kv_heads, dh),
            ("layers", "batch", "kv_seq", None, None),
            "zeros",
        ),
    }


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, device="cuda"):
    dtype = dtype or L.torch_dtype(cfg.compute_dtype)
    return L.materialize(None, cache_table(cfg, batch, max_len), dtype, device)


def cache_axes(cfg: ArchConfig, batch: int = 1, max_len: int = 1):
    return L.axes_of(cache_table(cfg, batch, max_len))


def _qkv(p, xin: torch.Tensor, cfg: ArchConfig, cos, sin):
    """Project one token per row to rotated q (B, Hq, D) and k, v
    (B, Hkv, D) in the compute dtype."""
    cd = L.torch_dtype(cfg.compute_dtype)
    b = xin.shape[0]
    dh = cfg.resolved_head_dim
    q = (xin @ p["wq"].to(cd)).reshape(b, cfg.padded_heads, dh)
    knew = (xin @ p["wk"].to(cd)).reshape(b, cfg.padded_kv_heads, dh)
    vnew = (xin @ p["wv"].to(cd)).reshape(b, cfg.padded_kv_heads, dh)
    if cfg.rope_theta > 0:
        q = L.apply_rope(q[:, None], cos, sin)[:, 0]
        knew = L.apply_rope(knew[:, None], cos, sin)[:, 0]
    return q, knew, vnew


def _mla_query(p, xin: torch.Tensor, cfg: ArchConfig, cos, sin):
    """One token per row: the rotated MLA query split ``(q_nope (B, H,
    nope), q_rope (B, H, rope))`` and the new latent row ``(ckv (B, r),
    k_rope (B, rope))``, in the compute dtype."""
    m = cfg.mla
    cd = xin.dtype
    b = xin.shape[0]
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    cq = L.rmsnorm(xin @ p["w_dq"].to(cd), p["q_norm"], cfg.norm_eps)
    q = (cq @ p["w_uq"].to(cd)).reshape(b, cfg.padded_heads, qk_dim)
    q_nope = q[..., :m.qk_nope_dim]
    q_rope = L.apply_rope(q[..., m.qk_nope_dim:][:, None], cos, sin)[:, 0]
    dkv = xin @ p["w_dkv"].to(cd)
    ckv_new = L.rmsnorm(dkv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    krope_new = L.apply_rope(dkv[:, None, None, m.kv_lora_rank:], cos,
                             sin)[:, 0, 0]
    return q_nope, q_rope, ckv_new, krope_new


def _mla_attend(p, q_nope, q_rope, ckv: torch.Tensor, krope: torch.Tensor,
                visible: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Absorbed-matmul MLA attention in latent space over the positions of
    ``ckv (B, S, r)`` and ``krope (B, S, rope)`` that ``visible`` (broadcast
    to (B, 1, S)) marks:

        scores_h = q_nope_h^T W_uk_h c_kv  +  q_rope_h^T k_rope
        out_h    = (probs . c_kv) W_uv_h

    The per-head K/V are never materialized.  Returns ``(B, D)`` after
    ``wo``, in the compute dtype."""
    m = cfg.mla
    cd = q_nope.dtype
    b, hq = q_nope.shape[:2]
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    w_uk = p["w_uk"].to(cd).reshape(m.kv_lora_rank, hq, m.qk_nope_dim)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope, w_uk)       # (B, H, r)
    s = torch.einsum("bhr,bsr->bhs", q_abs, ckv.to(cd))
    s = s + torch.einsum("bhp,bsp->bhs", q_rope, krope.to(cd))
    s = (s * (qk_dim ** -0.5)).float()
    s = torch.where(visible, s, L.MASK_VALUE)
    probs = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", probs.to(cd), ckv.to(cd))
    w_uv = p["w_uv"].to(cd).reshape(m.kv_lora_rank, hq, m.v_head_dim)
    out = torch.einsum("bhr,rhv->bhv", ctx, w_uv).reshape(b, hq * m.v_head_dim)
    return out @ p["wo"].to(cd)


def _logits(params, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    cd = L.torch_dtype(cfg.compute_dtype)
    x = L.apply_norm(cfg, h[:, None], params["ln_f"])[:, 0]
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return L.lm_logits(x[:, None], head, cfg.vocab_size, cd)[:, 0]


def decode_step(
    params: Dict[str, Any],
    cache: Dict[str, Any],
    tokens: torch.Tensor,     # (B,) current token ids
    pos: int,                 # current position in the cache
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step for the whole batch over a contiguous cache.

    The new K/V row is written into ``cache`` in place (the reference's
    ``dynamic_update_slice`` returns a new cache); the updated dict is
    returned as the reference returns its new cache.  MLA writes its
    latent row (``ckv``, ``k_rope``) and attends in latent space."""
    cd = L.torch_dtype(cfg.compute_dtype)
    x = L.embed_tokens(params["embed"], tokens, cd)
    b = x.shape[0]
    s = next(iter(cache.values())).shape[2]
    wp = min(max(int(pos), 0), s - 1)   # dynamic_update_slice clamps
    positions = torch.full((1,), int(pos), device=x.device)   # no host copy
    cos, sin = _rope_tables(cfg, positions)
    lengths = torch.full((b,), int(pos) + 1, dtype=torch.int32, device=x.device)
    visible = (torch.arange(s, device=x.device) <= int(pos))[None, None, :]
    for li in range(cfg.n_layers):
        lp = L.index_tree(params["layers"], li)
        xin = L.apply_norm(cfg, x[:, None], lp["ln1"])[:, 0]
        if cfg.mla is not None:
            q_nope, q_rope, ckv_new, krope_new = _mla_query(
                lp["attn"], xin, cfg, cos, sin)
            ckv, krope = cache["ckv"][li], cache["k_rope"][li]
            ckv[:, wp] = ckv_new.to(ckv.dtype)
            krope[:, wp] = krope_new.to(krope.dtype)
            attn = _mla_attend(lp["attn"], q_nope, q_rope, ckv, krope,
                               visible, cfg)
        else:
            q, knew, vnew = _qkv(lp["attn"], xin, cfg, cos, sin)
            kc, vc = cache["k"][li], cache["v"][li]
            kc[:, wp] = knew.to(kc.dtype)
            vc[:, wp] = vnew.to(vc.dtype)
            attn = L.decode_attention(q, kc, vc, lengths)
            attn = attn.reshape(b, -1).to(cd) @ lp["attn"]["wo"].to(cd)
        x = x + attn.to(x.dtype)
        xff = L.apply_norm(cfg, x[:, None], lp["ln2"])[:, 0]
        x = x + ffn_block(lp["ffn"], xff[:, None], cfg)[:, 0]
    return _logits(params, x, cfg), cache


# ---------------------------------------------------------------------- #
# paged decode (pool-resident page tables)
# ---------------------------------------------------------------------- #


def _pool_write(pools, name: str, li: int, row: torch.Tensor,
                phys: torch.Tensor, off: torch.Tensor, quantized: bool) -> None:
    """Write one decoded (B, *rest) row into layer ``li`` of ``pools[name]``
    at ``[phys, off]``, in place (quantized per channel in int8 pools)."""
    if quantized:
        qv, sv = int8_quantize(row, axis=-1)
        pools[name][li][phys, off] = qv
        pools[name + SCALE_SUFFIX][li][phys, off] = sv[..., 0]
    else:
        pools[name][li][phys, off] = row.to(pools[name].dtype)


def _pool_gather(pools, name: str, li: int, tables: torch.Tensor,
                 quantized: bool) -> torch.Tensor:
    """Layer ``li`` of ``pools[name]`` gathered through each row's table:
    ``(B, s_pad, *rest)`` (dequantized to float32 in int8 pools)."""
    buf = pools[name][li]
    idx = tables.clamp(0, buf.shape[0] - 1).long()
    out = buf[idx]
    if quantized:
        out = int8_dequantize(out, pools[name + SCALE_SUFFIX][li][idx][..., None])
    return out.reshape((tables.shape[0], -1) + tuple(out.shape[3:]))


def paged_decode_step(
    params: Dict[str, Any],
    pools: Dict[str, torch.Tensor],  # cache leaves as (L, 1+N, page_tokens, *rest)
    tables: torch.Tensor,            # (B, nP) int32: logical page -> pool slot
    pos: torch.Tensor,               # (B,) int32 per-lane write cursor
    tokens: torch.Tensor,            # (B, T) token ids to consume at pos..pos+T-1
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Multi-token decode straight on the shared page pool.

    The per-token loop of the reference: for each of the T inputs, every
    layer writes the new K/V row at ``[phys, off]`` of its pool slice and
    then attends over the row's table with ``lengths = p_t + 1``, so each
    token runs the same computation as :func:`decode_step` and the
    emitted tokens are the same for any T.  Positions clamp to the last
    slot of the table's span.  Pool writes are in place (``index_put_``
    into the layer's slice), where the reference's ``.at[].set`` returns
    new buffers.

    Quantized pools (``<leaf>__scale`` companions present) quantize each
    new row per channel on write and attend through the int8 kernel.

    MLA pools hold the latent leaves ``ckv (L, P, page, r)`` and ``k_rope
    (L, P, page, rope)``: each layer writes its latent row, gathers the
    row's pages through its table (dequantized in int8 pools) and attends
    in latent space as :func:`decode_step` does, with plain einsums as the
    reference; the calls and their shapes are the same for every token of
    every T.

    Returns ``(out (B, T) int32 argmax tokens, pools)``.
    """
    cd = L.torch_dtype(cfg.compute_dtype)
    b, t_total = tokens.shape
    quantized = any(k.endswith(SCALE_SUFFIX) for k in pools)
    page_tokens = next(iter(pools.values())).shape[2]
    s_pad = tables.shape[1] * page_tokens
    layers = [L.index_tree(params["layers"], li) for li in range(cfg.n_layers)]
    kname, vname = "k" + SCALE_SUFFIX, "v" + SCALE_SUFFIX

    outs = []
    for t in range(t_total):
        p_t = pos + t                                         # (B,)
        wp = torch.clamp(p_t, max=s_pad - 1).long()
        phys = tables.gather(1, (wp // page_tokens)[:, None])[:, 0].long()
        off = wp % page_tokens
        lengths = (p_t + 1).to(torch.int32)
        x = L.embed_tokens(params["embed"], tokens[:, t], cd)
        cos, sin = _rope_tables(cfg, p_t)
        if cfg.mla is not None:
            visible = (torch.arange(s_pad, device=tokens.device)[None, None, :]
                       <= p_t[:, None, None])
        for li, lp in enumerate(layers):
            xin = L.apply_norm(cfg, x[:, None], lp["ln1"])[:, 0]
            if cfg.mla is not None:
                q_nope, q_rope, ckv_new, krope_new = _mla_query(
                    lp["attn"], xin, cfg, cos[:, None], sin[:, None])
                _pool_write(pools, "ckv", li, ckv_new, phys, off, quantized)
                _pool_write(pools, "k_rope", li, krope_new, phys, off, quantized)
                attn = _mla_attend(
                    lp["attn"], q_nope, q_rope,
                    _pool_gather(pools, "ckv", li, tables, quantized),
                    _pool_gather(pools, "k_rope", li, tables, quantized),
                    visible, cfg)
            else:
                q, knew, vnew = _qkv(lp["attn"], xin, cfg, cos[:, None],
                                     sin[:, None])
                _pool_write(pools, "k", li, knew, phys, off, quantized)
                _pool_write(pools, "v", li, vnew, phys, off, quantized)
                if quantized:
                    attn = ops.paged_attention_quant(
                        q, pools["k"][li], pools[kname][li], pools["v"][li],
                        pools[vname][li], tables, lengths)
                else:
                    attn = ops.paged_attention(q, pools["k"][li],
                                               pools["v"][li], tables, lengths)
                attn = attn.reshape(b, -1).to(cd) @ lp["attn"]["wo"].to(cd)
            x = x + attn.to(x.dtype)
            xff = L.apply_norm(cfg, x[:, None], lp["ln2"])[:, 0]
            x = x + ffn_block(lp["ffn"], xff[:, None], cfg)[:, 0]
        outs.append(_logits(params, x, cfg).argmax(dim=-1).to(torch.int32))
    return torch.stack(outs, dim=1), pools
