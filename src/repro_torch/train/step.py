"""train_step / prefill_step / serve_step builders for the trainer.

Counterpart of ``repro/train/step.py``.  TrainState is a plain dict
``{params, opt{m,v}, step}`` of tensors, so the whole thing flows through
serialization and SCR checkpointing without special casing.  There is no
``jit``: the step runs eagerly, gradients come from ``torch.autograd``
(through the flash-attention backward kernel on the card), and the AdamW
update runs under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.registry import ModelApi
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     tree_leaves, tree_map, tree_unflatten)

ROUTER_AUX_COEF = 0.001


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE; logits may be vocab-padded (cols masked -1e30)."""
    logits = logits.float()
    shifted = logits[:, :-1]
    targets = labels[:, 1:].long()
    lse = torch.logsumexp(shifted, dim=-1)
    # advanced indexing, not gather: its backward (index_put with
    # accumulate) has a deterministic CUDA implementation
    rows = torch.arange(targets.numel(), device=logits.device)
    ll = shifted.reshape(-1, shifted.shape[-1])[rows, targets.reshape(-1)]
    return torch.mean(lse - ll.reshape(targets.shape))


def _precast(params, cfg: ArchConfig):
    """Cast fp32 masters to the compute dtype once, ahead of the layers.
    The cast is differentiable, so gradients flow back to the fp32
    masters unchanged."""
    cd = L.torch_dtype(cfg.compute_dtype)
    return tree_map(lambda p: p.to(cd) if p.is_floating_point() else p, params)


def make_loss_fn(cfg: ArchConfig, model: ModelApi, mesh=None, remat: bool = True):
    if mesh is not None:
        raise NotImplementedError("meshes wait for the distributed slice of "
                                  "ROADMAP.md")

    def loss_fn(params, batch):
        if cfg.precast_params:
            params = _precast(params, cfg)
        logits, aux = model.forward(params, batch, cfg, remat=remat)
        loss = cross_entropy(logits, batch["labels"])
        if "router_aux" in aux:
            loss = loss + ROUTER_AUX_COEF * aux["router_aux"]
        return loss, aux

    return loss_fn


def init_train_state(seed: int, cfg: ArchConfig, model: ModelApi,
                     device="cuda") -> Dict[str, Any]:
    params = model.init(seed, cfg, device=device)
    return {
        "params": params,
        "opt": adamw_init(params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def train_state_axes(cfg: ArchConfig, model: ModelApi) -> Dict[str, Any]:
    """Logical axes tree matching init_train_state's structure."""
    p_axes = model.param_axes(cfg)
    return {
        "params": p_axes,
        "opt": {"m": p_axes, "v": p_axes},
        "step": (),
    }


def _value_and_grad(loss_fn, params, batch):
    """(loss, aux, grads): gradients of ``loss_fn`` with respect to every
    parameter leaf, in the parameter tree's structure."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), aux, tree_unflatten(params, grads)


def make_train_step(
    cfg: ArchConfig,
    model: ModelApi,
    opt_cfg: Optional[AdamWConfig] = None,
    mesh=None,
    remat: bool = True,
    micro_batches: int = 1,
) -> Callable:
    """One optimizer step; with micro_batches > 1 gradients are
    accumulated in float32 over the micro-batches, in order."""
    opt_cfg = opt_cfg or AdamWConfig()
    loss_fn = make_loss_fn(cfg, model, mesh=mesh, remat=remat)

    def train_step(state, batch):
        params = state["params"]
        if micro_batches == 1:
            loss, aux, grads = _value_and_grad(loss_fn, params, batch)
        else:
            def split(x):
                b = x.shape[0]
                if b % micro_batches:
                    raise ValueError(f"batch {b} does not split into "
                                     f"{micro_batches} micro-batches")
                return x.reshape(micro_batches, b // micro_batches, *x.shape[1:])

            micros = {k: split(v) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for i in range(micro_batches):
                mb = {k: v[i] for k, v in micros.items()}
                l, _aux, g = _value_and_grad(loss_fn, params, mb)
                grads = tree_unflatten(params, [
                    a + b_.float() for a, b_ in zip(tree_leaves(grads),
                                                    tree_leaves(g))])
                loss = loss + l
            grads = tree_map(lambda g: g / micro_batches, grads)
            loss = loss / micro_batches
            aux = {}
        with torch.no_grad():
            params, opt = adamw_update(opt_cfg, params, grads, state["opt"],
                                       state["step"])
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        metrics = {"loss": loss}
        if "router_aux" in aux:
            metrics["router_aux"] = aux["router_aux"]
        return new_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, model: ModelApi, mesh=None) -> Callable:
    if mesh is not None:
        raise NotImplementedError("meshes wait for the distributed slice of "
                                  "ROADMAP.md")

    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.precast_params:
            params = _precast(params, cfg)
        logits, _ = model.forward(params, batch, cfg, remat=False)
        return logits[:, -1].argmax(dim=-1).to(torch.int32)

    return prefill_step


def make_serve_step(cfg: ArchConfig, model: ModelApi) -> Callable:
    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        logits, cache = model.decode_step(params, cache, tokens, pos, cfg)
        nxt = logits.argmax(dim=-1).to(torch.int32)
        return nxt, cache

    return serve_step
