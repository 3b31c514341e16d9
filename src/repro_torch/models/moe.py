"""MoE family: deepseek-moe-16b / qwen2-moe-a2.7b.

Counterpart of ``repro/models/moe.py`` with the same param and cache
tables and the same arithmetic: the capacity-buffer dispatch (each
sequence's T*k (token, choice) pairs scattered into an (E, C, D) buffer,
C = T*k/E * capacity_factor), the experts as batched matmuls over the
buffers, a weighted gather back, and the shared experts (gated for
qwen2) added.  Padded experts (qwen2: 60 -> 64) get -1e30 router logits:
unroutable, inert.  Decoding runs every expert on every token
(:func:`moe_ffn_dense_all`), as the reference does.

Attention is the dense family's (``transformer.attention_block``, whose
training path is the flash kernel).  The routing ties, the capacity
positions and the dropped pairs are the reference's: top-k selects by a
stable descending sort, so equal probabilities go to the lowest expert
index first, as ``jax.lax.top_k``; positions count in (token, choice)
order; a pair past its expert's capacity is dropped.  Every op of the
dispatch has a deterministic CUDA implementation, so training under
``torch.use_deterministic_algorithms(True)`` repeats bit for bit.

With a mesh (:class:`repro_torch.distributed.mesh.Mesh`, one rank in
each process) the reference's ``shard_map`` island runs on each rank:
the rank takes its rows of the batch over (``pod``, ``data``), holds its
block of every expert's hidden dim and of the shared experts' over
``model`` (whole weights are read through views, or
:func:`island_params` keeps only the blocks), and the routed and shared
outputs end in exactly one sum over ``model``.  The replicated inputs
that enter the island (the tokens, the routing weights, qwen2's shared
gate) go through :func:`repro_torch.distributed.collectives.copy_to_group`
and the partial output leaves through ``reduce_from_group``: Megatron's
pair, so the gradients of everything before the island see every rank's
experts.  The router's aux loss is not linear in the batch, so its
``density`` and mean probability are averaged over the data ranks
(``pmean``) before their product: every rank gets the whole batch's aux.
``forward(mesh=...)`` returns the rank's rows of the logits.  There is
no ``paged_decode_step``
(the reference has none for this family): MoE serves on the contiguous
scheduler.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.mesh import DATA_AXES, MODEL_AXIS
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


# ---------------------------------------------------------------------- #
# param tables
# ---------------------------------------------------------------------- #


def moe_ffn_table(cfg: ArchConfig) -> Dict[str, Any]:
    m = cfg.moe
    d = cfg.d_model
    e = cfg.padded_experts
    de = m.d_expert
    t: Dict[str, Any] = {
        "router": L.LeafSpec((d, e), ("d_model", "experts_router")),
        "wd": L.LeafSpec((e, de, d), ("experts", "d_expert", "d_model")),
    }
    if cfg.fused_gate_up:
        # gate and up stacked on a leading dim: one pass over the buffers
        t["w_in"] = L.LeafSpec((2, e, d, de),
                               (None, "experts", "d_model", "d_expert"))
    else:
        t["wg"] = L.LeafSpec((e, d, de), ("experts", "d_model", "d_expert"))
        t["wu"] = L.LeafSpec((e, d, de), ("experts", "d_model", "d_expert"))
    if m.n_shared:
        f = m.n_shared * de
        t["shared"] = {
            "wg": L.LeafSpec((d, f), ("d_model", "d_ff")),
            "wu": L.LeafSpec((d, f), ("d_model", "d_ff")),
            "wd": L.LeafSpec((f, d), ("d_ff", "d_model")),
        }
        if m.shared_gate:
            t["shared_gate"] = L.LeafSpec((d, 1), ("d_model", None))
    return t


def moe_layer_table(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ln1": L.norm_table(cfg),
        "attn": T.attention_table(cfg),
        "ln2": L.norm_table(cfg),
        "moe": moe_ffn_table(cfg),
    }


def param_table(cfg: ArchConfig) -> Dict[str, Any]:
    m = cfg.moe
    v = cfg.padded_vocab
    n_moe = cfg.n_layers - m.n_dense_layers
    t: Dict[str, Any] = {
        "embed": L.LeafSpec((v, cfg.d_model), ("vocab", "d_model"), "embed"),
        "moe_layers": L.stacked(moe_layer_table(cfg), n_moe),
        "ln_f": L.norm_table(cfg),
        "lm_head": L.LeafSpec((cfg.d_model, v), ("d_model", "vocab")),
    }
    if m.n_dense_layers:
        t["dense_layers"] = L.stacked(T.layer_table(cfg), m.n_dense_layers)
    return t


def init(seed: int, cfg: ArchConfig, device="cuda", cast: bool = False):
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (same init kinds and scales as the reference;
    not the same numbers).  ``cast=True`` stores each leaf as
    :func:`cast_params` would leave it, cast as it is drawn, so the
    float32 tree is never held whole (a serving tree of a 16-billion-
    parameter model)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return L.materialize(gen, param_table(cfg), L.torch_dtype(cfg.param_dtype),
                         device, leaf_dtype=T.cast_dtype(cfg) if cast else None)


def param_axes(cfg: ArchConfig):
    return L.axes_of(param_table(cfg))


def param_shapes(cfg: ArchConfig):
    return L.shapes_of(param_table(cfg), L.torch_dtype(cfg.param_dtype))


cast_params = T.cast_params


# ---------------------------------------------------------------------- #
# routing + capacity dispatch
# ---------------------------------------------------------------------- #


def _one_hot(ids: torch.Tensor, e: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a comparison against ``arange(e)`` (``F.one_hot``
    reads the largest id back to the host, a device sync in every MoE
    layer)."""
    return (ids[..., None] == torch.arange(e, device=ids.device)).to(dtype)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    the lowest index first among equal values (a stable sort; ``topk``
    promises no order among ties)."""
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], ids[..., :k]


def _route(cfg: ArchConfig, logits: torch.Tensor, data_group=None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: (B, T, E) logits -> top-k (ids, weights) + the switch-style
    load-balance aux loss (over the whole batch: with ``data_group`` its
    statistics are averaged over the data ranks first)."""
    m = cfg.moe
    e = cfg.padded_experts
    if e != m.n_routed:   # padded experts: unroutable
        col = torch.arange(e, device=logits.device)
        logits = logits.masked_fill(col[None, None, :] >= m.n_routed, -1e30)
    probs = torch.softmax(logits.float(), dim=-1)
    w, ids = _top_k(probs, m.top_k)                              # (B, T, k)
    # E * sum_e fraction_e * prob_e
    density = _one_hot(ids, e, torch.float32).sum(-2).mean(dim=(0, 1))
    prob_mean = probs.mean(dim=(0, 1))
    if data_group is not None:
        density = C.pmean(density, data_group)
        prob_mean = C.pmean(prob_mean, data_group)
    aux = m.n_routed * torch.sum(density / m.top_k * prob_mean)
    return ids, w.to(logits.dtype), aux


def _expert_ffn(buf: torch.Tensor, wg: torch.Tensor, wu: Optional[torch.Tensor],
                wd: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Every expert on its own rows: ``buf (E, R, D)`` -> ``(E, R, D)``,
    batched matmuls over the expert axis (``wg`` is ``w_in`` (2, E, D, de)
    when ``wu`` is None)."""
    act = L.act_fn(cfg.act)
    if wu is None:                       # fused gate+up: one pass
        hb = torch.matmul(buf[None], wg)                         # (2, E, R, de)
        h = act(hb[0]) * hb[1]
    else:
        h = act(torch.matmul(buf, wg)) * torch.matmul(buf, wu)
    return torch.matmul(h, wd)


def _capacity_slots(flat_ids: torch.Tensor, e: int, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T*k) expert ids -> ``(slot, keep)``: each pair's position in its
    expert's buffer, counted in (token, choice) order, is its slot while
    below ``capacity`` (``keep``); a dropped pair's slot is ``capacity``,
    the spare one."""
    oh = _one_hot(flat_ids, e, torch.int64)                      # (B, T*k, E)
    pos = (torch.cumsum(oh, dim=1) - 1).gather(2, flat_ids[..., None])[..., 0]
    keep = pos < capacity
    return torch.where(keep, pos, torch.full_like(pos, capacity)), keep


def _dispatch_compute_combine(
    x: torch.Tensor,       # (B, T, D)
    ids: torch.Tensor,     # (B, T, k)
    w: torch.Tensor,       # (B, T, k)
    wg: torch.Tensor,      # (E, D, de), or w_in (2, E, D, de)
    wu: Optional[torch.Tensor],
    wd: torch.Tensor,      # (E, de, D)
    cfg: ArchConfig,
    capacity: int,
) -> torch.Tensor:
    """Capacity-buffer expert compute (the reference's, per sequence).

    Each (token, choice) pair takes the next position in its expert's
    buffer, counted in (token, choice) order; pairs at or past
    ``capacity`` are dropped.  The reference scatters a dropped pair's
    zeroed row into slot C - 1 and gathers it back from there with weight
    0; here the buffer has one spare slot C that takes the dropped pairs
    instead, outside the experts' C rows, so every kept slot receives one
    row and nothing is summed into it (the same values, and a gather
    backward without colliding rows)."""
    b, t, d = x.shape
    e = cfg.padded_experts
    k = cfg.moe.top_k
    flat_ids = ids.reshape(b, t * k)
    flat_w = w.reshape(b, t * k)
    slot, keep = _capacity_slots(flat_ids, e, capacity)
    rows = (torch.arange(b, device=x.device)[:, None] * e + flat_ids) \
        * (capacity + 1) + slot                                  # (B, T*k)
    # each token once per choice; an expand, whose backward is a plain sum
    xk = x[:, :, None, :].expand(b, t, k, d).reshape(b, t * k, d)
    buffers = x.new_zeros((b * e * (capacity + 1), d))
    buffers = buffers.index_put((rows.reshape(-1),), xk.reshape(-1, d))
    buffers = buffers.reshape(b, e, capacity + 1, d)[:, :, :capacity]
    # (E, B*C, D): the experts' rows of every sequence in one batch
    h = buffers.transpose(0, 1).reshape(e, b * capacity, d)
    out = _expert_ffn(h, wg, wu, wd, cfg).reshape(e, b, capacity, d)
    out = F.pad(out.transpose(0, 1), (0, 0, 0, 1))               # (B, E, C+1, D)
    yk = out.reshape(-1, d)[rows.reshape(-1)].reshape(b, t * k, d)
    yk = yk * (flat_w * keep.to(flat_w.dtype))[..., None].to(yk.dtype)
    return yk.reshape(b, t, k, d).sum(dim=2)


def _shared_ffn(p: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig
                ) -> torch.Tensor:
    act = L.act_fn(cfg.act)
    h = act(x @ p["wg"]) * (x @ p["wu"])
    y = h @ p["wd"]
    if cfg.moe.shared_gate:
        return y * torch.sigmoid(x @ p["shared_gate_w"])
    return y


def _shared_params(p: Dict[str, Any], cfg: ArchConfig, cd: torch.dtype):
    sp = {"wg": p["shared"]["wg"].to(cd), "wu": p["shared"]["wu"].to(cd),
          "wd": p["shared"]["wd"].to(cd)}
    if cfg.moe.shared_gate:
        sp["shared_gate_w"] = p["shared_gate"].to(cd)
    return sp


def _expert_weights(p: Dict[str, Any], cfg: ArchConfig, cd: torch.dtype):
    if cfg.fused_gate_up:
        return p["w_in"].to(cd), None, p["wd"].to(cd)
    return p["wg"].to(cd), p["wu"].to(cd), p["wd"].to(cd)


def island_params(params, cfg: ArchConfig, mesh):
    """This rank's parameters for a mesh: the blocks over ``model`` of the
    experts' and shared experts' hidden dims (copies), every other leaf as
    given."""
    out = dict(params)
    layers = dict(params["moe_layers"])
    axes = L.axes_of(L.stacked(moe_ffn_table(cfg), cfg.n_layers
                               - cfg.moe.n_dense_layers))
    layers["moe"] = mesh.local_tree(params["moe_layers"]["moe"], axes,
                                    ("d_expert", "d_ff"))
    out["moe_layers"] = layers
    return out


def _island_weights(p: Dict[str, Any], cfg: ArchConfig, cd: torch.dtype,
                    mesh):
    """The rank's blocks of the expert weights (views of whole ones)."""
    de = cfg.moe.d_expert
    wg, wu, wd = _expert_weights(p, cfg, cd)
    wg = mesh.block(wg, wg.dim() - 1, de)
    wu = None if wu is None else mesh.block(wu, 2, de)
    return wg, wu, mesh.block(wd, 1, de)


def moe_ffn(p: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig, mesh=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed + shared expert FFN over (B, T, D).  Returns (y, aux_loss).
    With a mesh, ``x`` is the rank's rows and the island's one sum over
    ``model`` ends it."""
    cd = L.torch_dtype(cfg.compute_dtype)
    xc = x.to(cd)
    m = cfg.moe
    t = x.shape[1]
    capacity = max(1, int(t * m.top_k / m.n_routed * m.capacity_factor))
    logits = xc @ p["router"].to(cd)
    if mesh is None:
        ids, w, aux = _route(cfg, logits)
        wg, wu, wd = _expert_weights(p, cfg, cd)
        y = _dispatch_compute_combine(xc, ids, w, wg, wu, wd, cfg, capacity)
        if m.n_shared:
            y = y + _shared_ffn(_shared_params(p, cfg, cd), xc, cfg)
        return y.to(x.dtype), aux
    data = (mesh.group(DATA_AXES) if mesh.axis_size(DATA_AXES) > 1 else None)
    ids, w, aux = _route(cfg, logits, data)
    group = mesh.group(MODEL_AXIS)
    xi = C.copy_to_group(xc, group)
    y = _dispatch_compute_combine(xi, ids, C.copy_to_group(w, group),
                                  *_island_weights(p, cfg, cd, mesh), cfg,
                                  capacity)
    if m.n_shared:
        sp = _shared_params(p, cfg, cd)
        f = m.n_shared * m.d_expert
        sp = {"wg": mesh.block(sp["wg"], 1, f), "wu": mesh.block(sp["wu"], 1, f),
              "wd": mesh.block(sp["wd"], 0, f),
              **({"shared_gate_w": C.copy_to_group(sp["shared_gate_w"], group)}
                 if m.shared_gate else {})}
        y = y + _shared_ffn(sp, xi, cfg)
    # the partial outputs summed in float32 and rounded once, as one
    # process's matmuls over the whole hidden dims round their sums once
    return C.reduce_from_group(y.float(), group).to(x.dtype), aux


def moe_ffn_dense_all(p: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig
                      ) -> torch.Tensor:
    """Decode path: every expert on every token, masked-weighted combine
    (the reference's; for a serving batch below E it reads every expert's
    weights for each token).  x: (B, D)."""
    cd = L.torch_dtype(cfg.compute_dtype)
    xc = x.to(cd)
    logits = xc @ p["router"].to(cd)
    ids, w, _ = _route(cfg, logits[:, None, :])                  # (B, 1, k)
    e = cfg.padded_experts
    wexp = torch.zeros((x.shape[0], e), dtype=cd, device=x.device)
    wexp = wexp.scatter_add(1, ids[:, 0], w[:, 0].to(cd))
    wg, wu, wd = _expert_weights(p, cfg, cd)
    # (E, B, D) rows through batched matmuls: the weights are read as
    # stored, never permuted
    y_all = _expert_ffn(xc[None].expand(e, -1, -1), wg, wu, wd, cfg)
    y = torch.einsum("ebd,be->bd", y_all, wexp)
    if cfg.moe.n_shared:
        y = y + _shared_ffn(_shared_params(p, cfg, cd), xc[:, None], cfg)[:, 0]
    return y.to(x.dtype)


# ---------------------------------------------------------------------- #
# full model
# ---------------------------------------------------------------------- #


def _moe_layer(lp, h, cfg, cos, sin, mesh=None):
    h = h + T.attention_block(lp["attn"], L.apply_norm(cfg, h, lp["ln1"]),
                              cfg, cos, sin)
    y, aux = moe_ffn(lp["moe"], L.apply_norm(cfg, h, lp["ln2"]), cfg, mesh)
    return h + y, aux


def forward(
    params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    remat: bool = True,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token sequence -> next-token logits, and ``{"router_aux": the mean
    of the MoE layers' aux losses}``.  With a mesh: the rank's rows of the
    batch over the data axes, and of the logits."""
    tokens = batch["tokens"]
    if mesh is not None:
        tokens = mesh.shard_rows(tokens)
    cd = L.torch_dtype(cfg.compute_dtype)
    x = L.embed_tokens(params["embed"], tokens, cd)
    t = x.shape[1]
    cos, sin = L.rope_freqs(cfg.rope_dim or cfg.resolved_head_dim,
                            cfg.rope_theta, torch.arange(t, device=x.device))
    use_remat = remat and torch.is_grad_enabled()
    if "dense_layers" in params:
        for li in range(cfg.moe.n_dense_layers):
            lp = L.index_tree(params["dense_layers"], li)
            if use_remat:
                x = checkpoint(T.decoder_layer, lp, x, cfg, cos, sin,
                               use_reentrant=False)
            else:
                x = T.decoder_layer(lp, x, cfg, cos, sin)
    auxes = []
    for li in range(cfg.n_layers - cfg.moe.n_dense_layers):
        lp = L.index_tree(params["moe_layers"], li)
        if use_remat:
            x, aux = checkpoint(_moe_layer, lp, x, cfg, cos, sin, mesh,
                                use_reentrant=False)
        else:
            x, aux = _moe_layer(lp, x, cfg, cos, sin, mesh)
        auxes.append(aux)
    x = L.apply_norm(cfg, x, params["ln_f"])
    logits = L.lm_logits(x, params["lm_head"], cfg.vocab_size, cd)
    return logits, {"router_aux": torch.stack(auxes).mean()}


# ---------------------------------------------------------------------- #
# decode
# ---------------------------------------------------------------------- #


def cache_table(cfg: ArchConfig, batch: int, max_len: int) -> Dict[str, Any]:
    dh = cfg.resolved_head_dim
    m = cfg.moe
    n_moe = cfg.n_layers - m.n_dense_layers

    def kv(n):
        return L.LeafSpec((n, batch, max_len, cfg.padded_kv_heads, dh),
                          ("layers", "batch", "kv_seq", None, None), "zeros")

    t = {"moe_k": kv(n_moe), "moe_v": kv(n_moe)}
    if m.n_dense_layers:
        t["dense_k"] = kv(m.n_dense_layers)
        t["dense_v"] = kv(m.n_dense_layers)
    return t


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, device="cuda"):
    dtype = dtype or L.torch_dtype(cfg.compute_dtype)
    return L.materialize(None, cache_table(cfg, batch, max_len), dtype, device)


def cache_axes(cfg: ArchConfig, batch: int = 1, max_len: int = 1):
    return L.axes_of(cache_table(cfg, batch, max_len))


def _attn_decode(lp, h, kc, vc, wp, lengths, cfg, cos, sin):
    """One token per row of GQA decode attention; the new K/V row goes into
    the layer's cache ``kc``, ``vc`` at ``wp`` in place."""
    cd = L.torch_dtype(cfg.compute_dtype)
    b = h.shape[0]
    q, knew, vnew = T._qkv(lp, h, cfg, cos, sin)
    kc[:, wp] = knew.to(kc.dtype)
    vc[:, wp] = vnew.to(vc.dtype)
    out = L.decode_attention(q, kc, vc, lengths).reshape(b, -1)
    return out.to(cd) @ lp["wo"].to(cd)


def decode_step(
    params: Dict[str, Any],
    cache: Dict[str, Any],
    tokens: torch.Tensor,     # (B,) current token ids
    pos: int,                 # current position in the cache
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step for the whole batch over a contiguous cache, the
    MoE layers through :func:`moe_ffn_dense_all`.  K/V rows are written
    into ``cache`` in place; the updated dict is returned."""
    cd = L.torch_dtype(cfg.compute_dtype)
    x = L.embed_tokens(params["embed"], tokens, cd)
    b = x.shape[0]
    s = cache["moe_k"].shape[2]
    wp = min(max(int(pos), 0), s - 1)   # dynamic_update_slice clamps
    # a fill, not a copy from the host (which would wait for the card)
    cos, sin = L.rope_freqs(cfg.rope_dim or cfg.resolved_head_dim,
                            cfg.rope_theta,
                            torch.full((1,), int(pos), device=x.device))
    lengths = torch.full((b,), int(pos) + 1, dtype=torch.int32, device=x.device)
    if "dense_layers" in params:
        for li in range(cfg.moe.n_dense_layers):
            lp = L.index_tree(params["dense_layers"], li)
            a = _attn_decode(lp["attn"], L.apply_norm(cfg, x, lp["ln1"]),
                             cache["dense_k"][li], cache["dense_v"][li], wp,
                             lengths, cfg, cos, sin)
            x = x + a.to(x.dtype)
            f = T.ffn_block(lp["ffn"], L.apply_norm(cfg, x, lp["ln2"])[:, None],
                            cfg)[:, 0]
            x = x + f
    for li in range(cfg.n_layers - cfg.moe.n_dense_layers):
        lp = L.index_tree(params["moe_layers"], li)
        a = _attn_decode(lp["attn"], L.apply_norm(cfg, x, lp["ln1"]),
                         cache["moe_k"][li], cache["moe_v"][li], wp, lengths,
                         cfg, cos, sin)
        x = x + a.to(x.dtype)
        y = moe_ffn_dense_all(lp["moe"], L.apply_norm(cfg, x, lp["ln2"]), cfg)
        x = x + y.to(x.dtype)
    x = L.apply_norm(cfg, x, params["ln_f"])
    logits = L.lm_logits(x[:, None], params["lm_head"], cfg.vocab_size, cd)[:, 0]
    return logits, cache
