"""BufferStore: the one storage interface every tier-stack level speaks.

DEEP-ER's hierarchy (HBM/DDR → node-local NVMe → NAM → global PFS) only
composes because every level exposes the same operations to the layers
above: BeeOND cache domains and SCR's multi-level checkpoints are
*policies* over interchangeable byte stores (§II-B, §III-C).  This module
pins that contract down as a structural protocol so `MemoryTier`,
`CacheFS`, and the NAM all plug into the same `TierStack` router
(memory/stack.py) — one codepath serves burst-buffer, cache, and
checkpoint workloads.

The contract:

  put(key, data, streams=1) -> float      modelled write seconds
  put_stream(key, chunks, streams=1)      streamed write, no full join
  get(key, streams=1) -> bytes            KeyError when absent
  exists(key) -> bool
  delete(key) -> None                     idempotent
  keys() -> Iterator[str]                 sorted, this store's own content
  used_bytes() -> int
  capacity_bytes() -> int

Stores raise ``CapacityError`` (memory/tiers.py) when a write does not
fit; the router turns that into policy (LRU eviction, spill to the next
level) instead of a hot-path crash.  A store may additionally offer

* ``evict(key) -> bool`` — drop a *clean* cached copy without touching
  durable state — which the router prefers over ``delete`` under
  capacity pressure;
* ``offload(key, op) -> float`` — execute an :class:`OffloadOp` *at the
  level* (near-memory compute): the store pulls the op's sources and
  materializes the result under ``key`` without the data crossing the
  caller's storage path.  ``TierStack.offload`` routes an op to the
  first capable level of the key's placement chain and falls back to
  computing on the host for stacks without one — so the NAM-XOR parity
  path is placement policy, not special-cased plumbing.

``NAMStore`` adapts a :class:`~repro.core.nam.NAMDevice` to the protocol:
one region per key, allocated on demand, ring-buffer transfers underneath
— so a stack can place e.g. parity blocks on the NAM level off the node
failure domain.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Protocol, Sequence, runtime_checkable

from repro_torch.memory.tiers import CapacityError


@dataclasses.dataclass(frozen=True)
class OffloadOp:
    """A near-memory operation a capable store can run at its level.

    ``sources`` are zero-argument callables producing the input byte
    fragments (the "pull" side: the level fetches them itself, so the
    result never crosses the caller's storage path); ``nbytes`` is the
    size of each fragment and of the result region.  ``compute()`` is
    the host-side oracle — byte-identical to what a capable level
    produces — used by the router's fallback when no level can offload.
    """

    kind: str                                    # "xor_parity"
    sources: Sequence[Callable[[], bytes]]
    nbytes: int

    def compute(self) -> bytes:
        if self.kind == "xor_parity":
            from repro_torch.core import parity  # call-time import: core imports memory

            return parity.encode_nam_parity([src() for src in self.sources])
        raise ValueError(f"unknown offload op {self.kind!r}")


@runtime_checkable
class BufferStore(Protocol):
    """Structural protocol for one tier-stack level (see module docstring)."""

    def put(self, key: str, data: bytes, streams: int = 1) -> float: ...

    def put_stream(self, key: str, chunks, streams: int = 1) -> float: ...

    def get(self, key: str, streams: int = 1) -> bytes: ...

    def exists(self, key: str) -> bool: ...

    def delete(self, key: str) -> None: ...

    def keys(self) -> Iterator[str]: ...

    def used_bytes(self) -> int: ...

    def capacity_bytes(self) -> int: ...


class NAMStore:
    """BufferStore over a NAMDevice: one NAM region per key.

    Regions are allocated lazily on ``put`` (and reallocated when a key
    is rewritten with a different size); ``delete`` frees the region.
    Pool exhaustion surfaces as :class:`CapacityError` so the TierStack
    eviction machinery applies to the NAM level like any other.

    ``accepts_spill = False``: the pool is an in-memory map off the node
    failure domain but *volatile across restarts* — the router must never
    spill or demote data here on the way to durable storage (a fragment
    parked on the NAM would let a descriptor commit ``drained=True``
    while no byte ever reached the global tier).
    """

    accepts_spill = False

    def __init__(self, nam):
        self.nam = nam

    # -- write ----------------------------------------------------------- #

    def _ensure_region(self, key: str, nbytes: int) -> None:
        region = self.nam._regions.get(key)
        if region is not None and region.size != nbytes:
            self.nam.free(key)
            region = None
        if region is None:
            try:
                self.nam.alloc(key, nbytes)
            except MemoryError as e:
                raise CapacityError(f"NAM pool full for {key!r}") from e

    def put(self, key: str, data: bytes, streams: int = 1) -> float:
        self._ensure_region(key, len(data))
        return self.nam.put(key, data, concurrent=streams)

    def put_stream(self, key: str, chunks, streams: int = 1) -> float:
        # RMA puts are single transfers on the wire; join at the ring buffer
        return self.put(key, b"".join(bytes(c) for c in chunks), streams=streams)

    def offload(self, key: str, op: OffloadOp) -> float:
        """Run an offload op on the NAM's near-memory logic (the FPGA
        path of ``NAMDevice.offload_parity``): the NAM pulls the op's
        sources over the fabric and stores the result under ``key``.
        Pool exhaustion surfaces as :class:`CapacityError` so the router
        can evict and retry like any other write."""
        if op.kind != "xor_parity":
            raise ValueError(f"NAM cannot offload op {op.kind!r}")
        self._ensure_region(key, op.nbytes)
        try:
            return self.nam.offload_parity(key, op.sources, op.nbytes)
        except CapacityError:
            raise
        except MemoryError as e:
            raise CapacityError(f"NAM pool full for {key!r}") from e

    # -- read ------------------------------------------------------------ #

    def get(self, key: str, streams: int = 1) -> bytes:
        if not self.nam.exists(key):
            raise KeyError(key)
        return self.nam.get(key, concurrent=streams)

    def exists(self, key: str) -> bool:
        return self.nam.exists(key)

    def delete(self, key: str) -> None:
        self.nam.free(key)

    def evict(self, key: str) -> bool:
        """NAM regions are redundancy data, never the only copy: evictable."""
        if not self.nam.exists(key):
            return False
        self.nam.free(key)
        return True

    # -- introspection --------------------------------------------------- #

    def keys(self) -> Iterator[str]:
        yield from self.nam.tier.keys()

    def used_bytes(self) -> int:
        with self.nam._lock:
            return sum(r.size for r in self.nam._regions.values())

    def capacity_bytes(self) -> int:
        return self.nam.tier.spec.capacity_bytes
