"""Shared building blocks of the dense decode path, in PyTorch.

Counterpart of ``repro/models/layers.py``: the same param tables
(``LeafSpec`` trees with logical axis names), the same init kinds and
scales, and the same norms, activations, rotary embeddings and decode
attention, with the same dtype handling.  :func:`flash_attention` is
the training attention: the hand-written CUDA kernel (forward and
backward) for CUDA tensors, its plain version for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name (``"float32"``, ``"bfloat16"``) as a torch dtype."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------- #
# param tables
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones | embed
    scale: Optional[float] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


ParamTable = Dict[str, Any]  # nested dict of LeafSpec


def _init_leaf(gen: torch.Generator, spec: LeafSpec, dtype: torch.dtype,
               device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    if spec.init == "embed":
        scale = spec.scale if spec.scale is not None else 0.02
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    # in place: a leaf of a large model is drawn with one copy in memory
    return x.mul_(scale).to(dtype)


def materialize(gen: torch.Generator, table: ParamTable,
                dtype: torch.dtype = torch.float32, device="cuda",
                leaf_dtype: Optional[Callable[[str], torch.dtype]] = None
                ) -> Any:
    """Instantiate a param table into a nested dict of tensors, drawing
    every normal leaf from ``gen`` in flattened-name order.  With
    ``leaf_dtype``, each leaf made in ``dtype`` is cast at once to
    ``leaf_dtype(its "a/b/c" name)`` (the same values as casting the whole
    tree afterwards, without holding it in ``dtype``)."""
    flat = _flatten_table(table)
    leaves = {}
    for name, spec in flat.items():
        leaf = _init_leaf(gen, spec, dtype, device)
        leaves[name] = leaf if leaf_dtype is None else leaf.to(leaf_dtype(name))
        del leaf    # the float32 copy goes before the next leaf is drawn
    return _unflatten_like(table, leaves)


def axes_of(table: ParamTable) -> Any:
    flat = _flatten_table(table)
    return _unflatten_like(table, {n: s.axes for n, s in flat.items()})


def shapes_of(table: ParamTable, dtype: torch.dtype = torch.float32) -> Any:
    """Meta-device tensors of every leaf's shape and dtype (no allocation)."""
    flat = _flatten_table(table)
    return _unflatten_like(table, {
        n: torch.empty(s.shape, dtype=dtype, device="meta")
        for n, s in flat.items()})


def _flatten_table(table: ParamTable, prefix: str = "") -> Dict[str, LeafSpec]:
    out: Dict[str, LeafSpec] = {}
    for k, v in table.items():
        name = f"{prefix}{k}"
        if isinstance(v, LeafSpec):
            out[name] = v
        else:
            out.update(_flatten_table(v, prefix=name + "/"))
    return out


def _unflatten_like(table: ParamTable, leaves: Dict[str, Any],
                    prefix: str = "") -> Any:
    out: Dict[str, Any] = {}
    for k, v in table.items():
        name = f"{prefix}{k}"
        if isinstance(v, LeafSpec):
            out[k] = leaves[name]
        else:
            out[k] = _unflatten_like(v, leaves, prefix=name + "/")
    return out


# ---------------------------------------------------------------------- #
# norms & activations
# ---------------------------------------------------------------------- #


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5,
            fast: bool = False) -> torch.Tensor:
    if fast:
        ms = torch.mean(x.square(), dim=-1, keepdim=True, dtype=torch.float32)
        return x * torch.rsqrt(ms + eps).to(x.dtype) * gamma.to(x.dtype)
    x32 = x.float()
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * rms * gamma.float()).to(x.dtype)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5, fast: bool = False) -> torch.Tensor:
    if fast:
        mu = torch.mean(x, dim=-1, keepdim=True, dtype=torch.float32)
        ms = torch.mean(x.square(), dim=-1, keepdim=True, dtype=torch.float32)
        inv = torch.rsqrt(ms - mu * mu + eps).to(x.dtype)
        return ((x - mu.to(x.dtype)) * inv * gamma.to(x.dtype)
                + beta.to(x.dtype))
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    fast = getattr(cfg, "fast_norms", False)
    if cfg.norm == "layernorm":
        return layernorm(x, p["gamma"], p["beta"], cfg.norm_eps, fast=fast)
    return rmsnorm(x, p["gamma"], cfg.norm_eps, fast=fast)


def norm_table(cfg) -> Dict[str, LeafSpec]:
    t = {"gamma": LeafSpec((cfg.d_model,), ("d_model",), "ones")}
    if cfg.norm == "layernorm":
        t["beta"] = LeafSpec((cfg.d_model,), ("d_model",), "zeros")
    return t


def stacked(table: Dict[str, Any], n: int) -> Dict[str, Any]:
    """Prepend a ("layers") dim to every leaf of a layer table."""
    out: Dict[str, Any] = {}
    for k, v in table.items():
        if isinstance(v, LeafSpec):
            out[k] = LeafSpec((n,) + v.shape, ("layers",) + v.axes, v.init,
                              v.scale)
        else:
            out[k] = stacked(v, n)
    return out


def index_tree(tree: Dict[str, Any], *idx) -> Dict[str, Any]:
    """The slice ``[idx]`` of every leaf of a stacked parameter tree (one
    layer of ``(L, ...)`` leaves, one group's layer of ``(G, L, ...)``)."""
    return {k: index_tree(v, *idx) if isinstance(v, dict) else v[idx]
            for k, v in tree.items()}


def cast_tree(tree: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """Every leaf of a parameter tree cast to ``dtype`` (the reference's
    ``tree_map(lambda a: a.astype(cd), ...)``)."""
    return {k: cast_tree(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name in ("swiglu",):
        return F.silu
    if name in ("geglu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


# ---------------------------------------------------------------------- #
# rotary embeddings (partial-dim aware)
# ---------------------------------------------------------------------- #


def rope_freqs(dim: int, theta: float, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: positions (T,) -> (T, dim/2)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., T, H, D) rotated on the leading ``2*cos.shape[-1]`` of D."""
    rot = 2 * cos.shape[-1]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = torch.chunk(xr, 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out, xp.to(out.dtype)], dim=-1).to(x.dtype)


@functools.lru_cache(maxsize=8)
def sinusoidal_positions(n: int, dim: int) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position table (n, dim), float32 on
    the host: the reference's numpy arithmetic (float64 angles), so the
    values are its values.  Cached: callers index it or copy it out."""
    pos = np.arange(n)[:, None]
    idx = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * idx / dim)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(table)


# ---------------------------------------------------------------------- #
# attention
# ---------------------------------------------------------------------- #


# the reference's mask value, a float32 scalar
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def flash_attention(
    q: torch.Tensor,          # (B, Tq, Hq, D)
    k: torch.Tensor,          # (B, Tk, Hkv, D)
    v: torch.Tensor,          # (B, Tk, Hkv, Dv)
    causal: bool = True,
    prefix_len: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact causal GQA attention, differentiable.  The reference's jnp
    version is the one whose TPU kernel is ``flash_attention_pallas``;
    here :func:`repro_torch.kernels.ops.flash_attention` picks the CUDA
    kernel or the plain version by device."""
    return ops.flash_attention(q, k, v, causal=causal, prefix_len=prefix_len,
                               scale=scale)


# calls of the plain functions a kernel path must avoid, for the checks that
# it does (a dict, so that a wrapper put in a function's place counts too)
plain_calls = {"decode_attention": 0}


def decode_attention(
    q: torch.Tensor,        # (B, Hq, D) one new token per sequence
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, Dv)
    length: torch.Tensor,   # (B,) valid cache lengths (including current token)
    scale: Optional[float] = None,
) -> torch.Tensor:
    plain_calls["decode_attention"] += 1
    b, s, hkv, d = k_cache.shape
    hq = q.shape[1]
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    qg = (q * scale).reshape(b, hkv, g, d)
    dt = torch.promote_types(qg.dtype, k_cache.dtype)
    logits = torch.einsum("bhgd,bshd->bhgs", qg.to(dt), k_cache.to(dt)).float()
    mask = (torch.arange(s, device=q.device)[None, None, None, :]
            < length[:, None, None, None])
    # a Python scalar: a tensor copied from the host would wait for the card
    logits = torch.where(mask, logits, MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    dt = torch.promote_types(probs.dtype, v_cache.dtype)
    out = torch.einsum("bhgs,bshd->bhgd", probs.to(dt), v_cache.to(dt))
    return out.reshape(b, hq, -1)


# ---------------------------------------------------------------------- #
# embedding / head with vocab padding mask
# ---------------------------------------------------------------------- #


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    return embedding.to(compute_dtype)[tokens.long()]


def lm_logits(x: torch.Tensor, head: torch.Tensor, logical_vocab: int,
              compute_dtype: torch.dtype) -> torch.Tensor:
    """Project to (padded) vocab and mask padded columns to -1e30."""
    logits = torch.einsum("btd,dv->btv", x.to(compute_dtype),
                          head.to(compute_dtype))
    padded_vocab = head.shape[-1]
    if padded_vocab != logical_vocab:
        col = torch.arange(padded_vocab, device=x.device)
        logits = logits.masked_fill(col[None, None, :] >= logical_vocab, -1e30)
    return logits
