"""Serving, PyTorch port: continuous batching, KV paging, the shared-prefix
cache and checkpointed serving state."""

from repro_torch.serve.api import LocalServe, Serve, ServeConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvpage import KVPager, kv_page_key, page_digest
from repro_torch.serve.prefix import LaneLayout, PrefixCache, prefix_page_key
from repro_torch.serve.scheduler import (
    DecodeStream,
    PagedServeScheduler,
    ServeScheduler,
    StreamState,
    make_prefill_fn,
    make_slot_serve_step,
)

__all__ = [
    "DecodeStream",
    "LocalServe",
    "Serve",
    "ServeConfig",
    "KVPager",
    "LaneLayout",
    "PagedServeScheduler",
    "PrefixCache",
    "ServeEngine",
    "ServeScheduler",
    "StreamState",
    "kv_page_key",
    "make_prefill_fn",
    "make_slot_serve_step",
    "page_digest",
    "prefix_page_key",
]
