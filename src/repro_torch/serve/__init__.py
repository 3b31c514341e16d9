"""Paged speculative serving, PyTorch port."""

from repro_torch.serve.api import LocalServe, Serve, ServeConfig
from repro_torch.serve.scheduler import (DecodeStream, PagedServeScheduler,
                                         ServeScheduler, StreamState)

__all__ = [
    "DecodeStream",
    "LocalServe",
    "PagedServeScheduler",
    "Serve",
    "ServeConfig",
    "ServeScheduler",
    "StreamState",
]
