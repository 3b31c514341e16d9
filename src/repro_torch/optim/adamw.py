"""AdamW with decoupled weight decay and global-norm clipping.

Counterpart of ``repro/optim/adamw.py``: the same schedule (linear
warmup), the same fp32 moments regardless of parameter dtype, the same
global-norm clip over every gradient leaf in JAX's leaf order (sorted
dict keys), and the same update arithmetic in float32.  Functional, as
the reference is: new parameter and moment tensors are returned.  Call
it under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


def tree_map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves of a nested dict in JAX's order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Any, leaves) -> Any:
    """Inverse of :func:`tree_leaves` over the structure of ``like``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def adamw_init(params: Any) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1).float() / max(1, cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


def adamw_update(
    cfg: AdamWConfig,
    params: Any,
    grads: Any,
    opt_state: Dict[str, Any],
    step: torch.Tensor,
) -> Tuple[Any, Dict[str, Any]]:
    # global-norm clip in fp32
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float() + 1.0
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)

    def upd(p, g, m, v):
        g32 = g.float() * scale
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * torch.square(g32)
        mh = m / bc1
        vh = v / bc2
        step_val = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * step_val).to(p.dtype), m, v

    new = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), leaves, tree_leaves(opt_state["m"]),
        tree_leaves(opt_state["v"]))]
    new_p = tree_unflatten(params, [n[0] for n in new])
    new_m = tree_unflatten(params, [n[1] for n in new])
    new_v = tree_unflatten(params, [n[2] for n in new])
    return new_p, {"m": new_m, "v": new_v}
