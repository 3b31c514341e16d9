"""Dense transformer family: starcoder2 / phi3 / gemma-style.

Counterpart of ``repro/models/transformer.py`` with the same param and
cache tables (layer-stacked ``(L, ...)`` leaves under the same key
paths) and the same arithmetic.  ``forward`` (training) runs its
attention through :func:`repro_torch.models.layers.flash_attention`, and
``paged_decode_step`` through :func:`repro_torch.kernels.ops.paged_attention`
(or the int8 form): the hand-written CUDA kernels for CUDA tensors, the
plain versions for CPU tensors.  ``remat=True`` recomputes each layer in
the backward pass (``torch.utils.checkpoint``, where the reference has
``jax.checkpoint``).

Waits for later slices: the MLA branch (minicpm3), ``prefix_embeds``
(paligemma) and the sequence-parallel forwards, all listed in ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.memory.codecs import SCALE_SUFFIX, int8_quantize
from repro_torch.models import layers as L

_MLA_WAITS = ("MLA decode (minicpm3) waits for the 'MLA, MoE and the other "
              "families' slice of ROADMAP.md")


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


def init(seed: int, cfg: ArchConfig, device="cuda"):
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (same init kinds and scales as the reference;
    not the same numbers — its PRNG differs)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = L.materialize(gen, param_table(cfg), L.torch_dtype(cfg.param_dtype),
                           device)
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
    if cfg.mla is not None:
        raise NotImplementedError(_MLA_WAITS)
    b, t, _ = x.shape
    cd = L.torch_dtype(cfg.compute_dtype)
    xc = x.to(cd)
    hq = cfg.padded_heads
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
    """Token sequence -> next-token logits.  With ``remat`` each layer's
    activations are recomputed in the backward pass."""
    if prefix_embeds is not None or mesh is not None:
        raise NotImplementedError(
            "prefix_embeds (paligemma) and the sequence-parallel forwards "
            "wait for later slices of ROADMAP.md")
    tokens = batch["tokens"]
    cd = L.torch_dtype(cfg.compute_dtype)
    x = L.embed_tokens(params["embed"], tokens, cd)
    positions = torch.arange(x.shape[1], device=x.device)
    cos, sin = _rope_tables(cfg, positions)
    for li in range(cfg.n_layers):
        lp = _layer(params["layers"], li)
        if remat and torch.is_grad_enabled():
            x = checkpoint(decoder_layer, lp, x, cfg, cos, sin,
                           use_reentrant=False)
        else:
            x = decoder_layer(lp, x, cfg, cos, sin)
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


def _layer(stacked_tree, l: int):
    """Layer ``l``'s slice of the layer-stacked parameter tree."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in stacked_tree.items()}


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
    returned as the reference returns its new cache."""
    if cfg.mla is not None:
        raise NotImplementedError(_MLA_WAITS)
    cd = L.torch_dtype(cfg.compute_dtype)
    x = L.embed_tokens(params["embed"], tokens, cd)
    b = x.shape[0]
    s = cache["k"].shape[2]
    wp = min(max(int(pos), 0), s - 1)   # dynamic_update_slice clamps
    positions = torch.tensor([int(pos)], device=x.device)
    cos, sin = _rope_tables(cfg, positions)
    lengths = torch.full((b,), int(pos) + 1, dtype=torch.int32, device=x.device)
    for li in range(cfg.n_layers):
        lp = _layer(params["layers"], li)
        xin = L.apply_norm(cfg, x[:, None], lp["ln1"])[:, 0]
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

    Returns ``(out (B, T) int32 argmax tokens, pools)``.
    """
    if cfg.mla is not None:
        raise NotImplementedError(_MLA_WAITS)
    cd = L.torch_dtype(cfg.compute_dtype)
    b, t_total = tokens.shape
    quantized = any(k.endswith(SCALE_SUFFIX) for k in pools)
    page_tokens = pools["k"].shape[2]
    s_pad = tables.shape[1] * page_tokens
    layers = [_layer(params["layers"], li) for li in range(cfg.n_layers)]
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
        for li, lp in enumerate(layers):
            xin = L.apply_norm(cfg, x[:, None], lp["ln1"])[:, 0]
            q, knew, vnew = _qkv(lp["attn"], xin, cfg, cos[:, None],
                                 sin[:, None])
            if quantized:
                for name, row in (("k", knew), ("v", vnew)):
                    qv, sv = int8_quantize(row, axis=-1)
                    pools[name][li][phys, off] = qv
                    pools[name + SCALE_SUFFIX][li][phys, off] = sv[..., 0]
                attn = ops.paged_attention_quant(
                    q, pools["k"][li], pools[kname][li], pools["v"][li],
                    pools[vname][li], tables, lengths)
            else:
                pools["k"][li][phys, off] = knew.to(pools["k"].dtype)
                pools["v"][li][phys, off] = vnew.to(pools["v"].dtype)
                attn = ops.paged_attention(q, pools["k"][li], pools["v"][li],
                                           tables, lengths)
            attn = attn.reshape(b, -1).to(cd) @ lp["attn"]["wo"].to(cd)
            x = x + attn.to(x.dtype)
            xff = L.apply_norm(cfg, x[:, None], lp["ln2"])[:, 0]
            x = x + ffn_block(lp["ffn"], xff[:, None], cfg)[:, 0]
        outs.append(_logits(params, x, cfg).argmax(dim=-1).to(torch.int32))
    return torch.stack(outs, dim=1), pools
