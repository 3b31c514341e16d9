"""Tiles of a scan head wider than its kernels: the slicing, the state
blocks and the fixed-order sums that :mod:`repro_torch.kernels.rwkv6_scan`
and :mod:`repro_torch.kernels.mamba2_ssd` share.

A tile is ``(start, n)``: ``n`` channels of a last axis from ``start``.
Tiles run on the float32 route, so :func:`cols` widens as it slices, and
every partial is float32 until :func:`fsum` casts the sum once.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tile = Tuple[int, int]


def cols(x: torch.Tensor, tile: Tile, width: Optional[int] = None,
         fill: float = 0.0) -> torch.Tensor:
    """The tile's channels of ``x``'s last axis in float32, padded with
    ``fill`` to ``width`` (None: the tile's own)."""
    start, n = tile
    part = x[..., start:start + n].to(torch.float32)
    if width is not None and n < width:
        return F.pad(part, (0, width - n), value=fill)
    return part.contiguous()


def block(s: Optional[torch.Tensor], ti: Tile, tj: Tile,
          width: Optional[int] = None) -> Optional[torch.Tensor]:
    """The (rows ti, columns tj) block of a (B, H, R, C) state, zero-padded
    to (width, width) (None: the tiles' own); None for no state."""
    if s is None:
        return None
    part = s[:, :, ti[0]:ti[0] + ti[1], tj[0]:tj[0] + tj[1]]
    if width is not None:
        part = F.pad(part, (0, width - tj[1], 0, width - ti[1]))
    return part.contiguous()


def put_block(dst: torch.Tensor, ti: Tile, tj: Tile,
              src: torch.Tensor) -> None:
    """Write a tile launch's state (padding dropped) into its block of
    ``dst``."""
    dst[:, :, ti[0]:ti[0] + ti[1], tj[0]:tj[0] + tj[1]] = \
        src[:, :, :ti[1], :tj[1]]


def fsum(parts: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """Partials added in float32 in list order, cast once."""
    acc = parts[0].to(torch.float32, copy=True)
    for part in parts[1:]:
        acc += part
    return acc.to(dtype)


def check_ckpts(ckpt, shapes: Sequence[Tuple[int, ...]], what: str) -> None:
    """Raise unless ``ckpt`` is the forward's chunk-start states: a tuple
    of one contiguous float32 tensor per launch, of the launch's shape."""
    if (not isinstance(ckpt, (tuple, list)) or len(ckpt) != len(shapes)
            or any(not isinstance(c, torch.Tensor) or tuple(c.shape) != s
                   or c.dtype != torch.float32 or not c.is_contiguous()
                   for c, s in zip(ckpt, shapes))):
        raise ValueError(f"ckpt must be the forward's chunk-start states "
                         f"for {what}: one float32 tensor per launch, of "
                         f"shapes {list(shapes)}")
