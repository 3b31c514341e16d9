"""Serving fleet: multi-worker serving over one shared cache domain.

Counterpart of ``repro/serve/fleet/``; each worker serves on its
``WorkerSpec.device`` (on a card: its own process, CUDA context and copy
of the weights, its decode through the paged-attention kernels).

The single-process serving stack (PagedServeScheduler over DevicePagePool
+ KVPager + PrefixCache) scales out here the way DEEP-ER's hierarchy
scales out — through a *shared level*, not shared memory:

* :class:`~repro_torch.memory.shared.SharedTier` (memory/shared.py) is the
  cross-process store every worker mounts as the bottom level of its own
  TierStack (``KVPager.for_fleet``);
* :class:`PrefixBoard` (board.py) is the append-only journal through
  which workers publish/subscribe prefix-trie node records — chain
  digests are process-independent, so a record plus the payload in the
  shared tier is enough for any peer to adopt the node;
* :mod:`worker` runs one ``PagedServeScheduler`` per process behind a
  pipe protocol (submit / hb / tokens / done / stats / drain / stop);
  ``drain`` returns re-admissible stream descriptors, and with
  ``ckpt_every`` > 0 the worker periodically epoch-checkpoints the same
  descriptors (plus its live KV pages) through the shared tier;
* :class:`FleetFrontend` (frontend.py) is the traffic-facing admission
  router: per-tenant quotas, priority classes mapped onto the
  scheduler's weighted quanta, least-loaded routing, incremental token
  streaming back — and the fleet's failure detector: a dead worker's
  streams are re-admitted on survivors with their recovered token
  prefixes replayed, token-identical to an uninterrupted run.

The reference is measured by benchmarks/fig12_fleet_scaling.py
(scale-out) and benchmarks/fig13_elastic_fleet.py (kill-one-of-N
recovery); ``chip_smoke.py`` phase 17 runs both set-ups on the port.
"""

from repro_torch.memory.shared import SharedTier
from repro_torch.serve.fleet.board import PrefixBoard
from repro_torch.serve.fleet.frontend import FleetFrontend, PriorityClass, TenantQuota
from repro_torch.serve.fleet.worker import (WorkerHandle, WorkerSpec,
                                            load_epoch, worker_main)

__all__ = [
    "FleetFrontend",
    "PrefixBoard",
    "PriorityClass",
    "SharedTier",
    "TenantQuota",
    "WorkerHandle",
    "WorkerSpec",
    "load_epoch",
    "worker_main",
]
