"""Carry parameters and train states between the reference and the port.

The reference's parameters come out of ``jax.device_get(params)`` as a
nested dict of numpy arrays; :func:`params_from_numpy` turns that tree
into the port's nested dict of tensors, key for key, dtype preserved
(bfloat16 arrays travel as their raw 16-bit patterns).
:func:`params_to_numpy` is the inverse.  :func:`train_state_from_numpy`
does the same for a whole train state ``{params, opt{m, v}, step}``, and
:func:`state_to_numpy` takes any state back to host numpy, so a reference
state and a port state are the same bytes.  None of them needs JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def tensor_from_numpy(arr: Any, device="cuda") -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # numpy names bfloat16 once ml_dtypes (a JAX dependency) is loaded
        return t.view(torch.uint16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def params_from_numpy(tree: Any, cfg: ArchConfig, device="cuda") -> Any:
    """A reference parameter tree (nested dict of numpy arrays) as the
    port's; ``cfg`` checks every leaf against the port's param table."""
    from repro_torch.models.registry import get_model

    shapes = get_model(cfg).param_shapes(cfg)

    def walk(src, want, path):
        if set(src) != set(want):
            raise KeyError(f"{path or '/'}: keys {sorted(src)} != "
                           f"{sorted(want)}")
        out = {}
        for k in want:
            if isinstance(want[k], dict):
                out[k] = walk(src[k], want[k], f"{path}/{k}")
                continue
            t = tensor_from_numpy(src[k], device)
            if tuple(t.shape) != tuple(want[k].shape):
                raise ValueError(f"{path}/{k}: shape {tuple(t.shape)} != "
                                 f"{tuple(want[k].shape)}")
            out[k] = t
        return out

    return walk(tree, shapes, "")


def params_to_numpy(params: Any) -> Any:
    """The inverse of :func:`params_from_numpy`."""
    return {k: params_to_numpy(v) if isinstance(v, dict) else tensor_to_numpy(v)
            for k, v in params.items()}


def state_to_numpy(tree: Any) -> Any:
    """A nested dict of tensors copied to host numpy arrays (the port's
    ``jax.device_get``); the inverse of :func:`train_state_from_numpy`."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    return tensor_to_numpy(tree)


def train_state_from_numpy(tree: Any, cfg: ArchConfig, device="cuda") -> Any:
    """A reference train state ``{params, opt{m, v}, step}`` (numpy
    leaves) as the port's; every leaf keeps its dtype and bytes."""
    if set(tree) != {"params", "opt", "step"} or set(tree["opt"]) != {"m", "v"}:
        raise KeyError(f"not a train state: keys {sorted(tree)}")
    step = np.asarray(tree["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"step must be an int32 scalar, got {step.dtype} "
                         f"{step.shape}")
    return {
        "params": params_from_numpy(tree["params"], cfg, device),
        "opt": {k: params_from_numpy(tree["opt"][k], cfg, device)
                for k in ("m", "v")},
        "step": tensor_from_numpy(step, device),
    }
