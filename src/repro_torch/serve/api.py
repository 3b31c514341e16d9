"""The serving construction API: one config, two entry points.

Counterpart of ``repro/serve/api.py``.  :func:`Serve.local` builds one
in-process serving stack from a :class:`ServeConfig`: the model from the
config registry (``reduced()`` unless ``full_size``, random weights from
``seed``) on ``device``, the KV pager, the prefix cache, and the paged or
contiguous scheduler, with an optional session for save and restore.
:func:`Serve.fleet` spawns N workers, each built from the same config
(:meth:`ServeConfig.worker_spec`), behind a
:class:`~repro_torch.serve.fleet.frontend.FleetFrontend`.
"""

from __future__ import annotations

import math
import tempfile
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ServeConfig:
    """Everything needed to build a serving stack (the reference's
    fields, plus ``device``: where the weights, the lanes and the pool
    live).

    ``paged`` picks the page-pool decode loop over the contiguous lane
    path; ``spec_k`` > 0 adds speculative multi-token verification
    (implies paged); ``kv_codec`` is the KV representation policy.
    ``fast_bytes`` sizes the pager's fast tier (``None``: ``slots + 1``
    lanes); ``prefix`` enables the shared-prefix radix cache.

    Fleet side (ignored by :func:`Serve.local`): ``shared_capacity``
    bounds the cross-process domain, ``ckpt_every`` > 0 enables each
    worker's periodic epoch checkpoint, ``hb_interval_s`` /
    ``hb_timeout_s`` pace the failure detector, and ``adopt_batch`` > 0
    throttles per-admission board adoption."""

    arch: str = "phi3-mini-3.8b"
    seed: int = 0
    full_size: bool = False
    # scheduler
    paged: bool = True
    slots: int = 2
    max_len: int = 32
    quantum: int = 3
    page_tokens: int = 4
    pool_pages: Optional[int] = None
    spec_k: int = 0
    kv_codec: Optional[str] = None
    # memory
    fast_bytes: Optional[int] = None
    page_bytes: int = 8 * 1024
    prefix: bool = True
    # fleet / resilience
    shared_capacity: int = 1 << 30
    ckpt_every: int = 0
    hb_interval_s: float = 0.25
    hb_timeout_s: float = 2.0
    adopt_batch: int = 0
    # where the weights, the lanes and the page pool live
    device: str = "cuda"

    def worker_spec(self, shared_root: str, name: str = "") -> Any:
        """The per-worker spawn spec this config denotes (the reference's
        fields, plus ``device`` and ``full_size``)."""
        from repro_torch.serve.fleet.worker import WorkerSpec

        return WorkerSpec(
            shared_root=str(shared_root), arch=self.arch, slots=self.slots,
            max_len=self.max_len, page_tokens=self.page_tokens,
            quantum=self.quantum, pool_pages=self.pool_pages,
            spec_k=self.spec_k,
            fast_bytes=self.fast_bytes or 8 << 20,
            page_bytes=self.page_bytes, kv_codec=self.kv_codec,
            shared_capacity=self.shared_capacity, seed=self.seed,
            name=name, ckpt_every=self.ckpt_every,
            hb_interval_s=self.hb_interval_s, adopt_batch=self.adopt_batch,
            device=self.device, full_size=self.full_size)


def _build_model(cfg: ServeConfig) -> Tuple[Any, Any, Any]:
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model

    arch = get_config(cfg.arch)
    if not cfg.full_size:
        arch = arch.reduced()
    model = get_model(arch)
    if model.cast_params is not None:
        # the tree the decode path reads, each leaf cast as it is drawn:
        # a float32 tree beside its cast would not fit a 16-billion-
        # parameter model on one card
        params = model.init(cfg.seed, arch, device=cfg.device, cast=True)
    else:
        params = model.init(cfg.seed, arch, device=cfg.device)
    return arch, model, params


class LocalServe:
    """One in-process serving stack built from a :class:`ServeConfig`:
    the scheduler's continuous-batching surface (submit / step / run /
    output / save / restore) plus the wiring (:attr:`scheduler`,
    :attr:`pager`, :attr:`prefix_cache`).  Context manager: closing tears
    down the scheduler and its stack."""

    def __init__(self, cfg: ServeConfig, session: Any = None):
        from repro_torch.serve.kvpage import KVPager
        from repro_torch.serve.prefix import PrefixCache
        from repro_torch.serve.scheduler import (PagedServeScheduler,
                                                 ServeScheduler)

        self.cfg = cfg
        self.arch, self.model, self.params = _build_model(cfg)
        fast = cfg.fast_bytes
        if fast is None:
            lane = self.model.init_cache(self.arch, 1, cfg.max_len,
                                         device="meta")
            lane_bytes = sum(math.prod(v.shape) * v.element_size()
                             for v in lane.values())
            fast = (cfg.slots + 1) * lane_bytes
        self.pager = KVPager.for_capacity(fast_bytes=fast,
                                          page_bytes=cfg.page_bytes)
        self.prefix_cache = None
        if cfg.prefix:
            self.prefix_cache = PrefixCache.for_model(
                self.pager.stack, self.arch, self.model, cfg.max_len,
                page_tokens=cfg.page_tokens)
        if cfg.paged or cfg.spec_k > 0:
            self.scheduler = PagedServeScheduler(
                self.arch, self.model, self.params, slots=cfg.slots,
                max_len=cfg.max_len, pager=self.pager, session=session,
                quantum=cfg.quantum, prefix=self.prefix_cache,
                page_tokens=cfg.page_tokens, pool_pages=cfg.pool_pages,
                spec_k=cfg.spec_k, kv_codec=cfg.kv_codec)
        else:
            self.scheduler = ServeScheduler(
                self.arch, self.model, self.params, slots=cfg.slots,
                max_len=cfg.max_len, pager=self.pager, session=session,
                quantum=cfg.quantum, prefix=self.prefix_cache)

    # -- the scheduler surface, re-exported -------------------------------- #

    def submit(self, prompt: Sequence[int], max_new: int,
               weight: int = 1) -> int:
        return self.scheduler.submit(prompt, max_new, quantum_weight=weight)

    def step(self) -> List[Tuple[int, int]]:
        return self.scheduler.step()

    def run(self, max_steps: Optional[int] = None) -> int:
        return self.scheduler.run(max_steps=max_steps)

    def output(self, sid: int) -> List[int]:
        return self.scheduler.output(sid)

    def save(self, session: Any = None):
        return self.scheduler.save(session)

    def restore(self, session: Any = None, step: Optional[int] = None):
        return self.scheduler.restore(session, step=step)

    @property
    def stats(self) -> Dict[str, Any]:
        return self.scheduler.stats

    def close(self) -> None:
        self.scheduler.close()

    def __enter__(self) -> "LocalServe":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Serve:
    """The serving entry points (namespace class — no instances)."""

    @staticmethod
    def local(cfg: ServeConfig, session: Any = None) -> LocalServe:
        """One in-process scheduler wired from ``cfg``.  ``session`` is
        an optional :class:`~repro_torch.api.session.ResilienceSession`
        for checkpoint/restore through the scheduler's save/restore."""
        return LocalServe(cfg, session=session)

    @staticmethod
    def fleet(cfg: ServeConfig, workers: int = 2,
              shared_root: Optional[str] = None,
              quotas: Optional[Dict[str, Any]] = None,
              classes: Optional[Dict[str, Any]] = None,
              ready_timeout: float = 600.0, **frontend_kw) -> Any:
        """N spawned workers over one shared cache domain behind a
        :class:`~repro_torch.serve.fleet.frontend.FleetFrontend`.  The
        frontend's failure detector inherits ``cfg.hb_timeout_s``;
        workers inherit the epoch-checkpoint cadence, so a fleet built
        here is elastic out of the box when ``cfg.ckpt_every`` > 0.
        ``shared_root`` defaults to a fresh temp dir (use an explicit
        path to join an existing domain).  On a card, build the kernels
        first (``kernels._build.build_all``) so that the workers load them
        instead of each running ``nvcc``."""
        if workers < 1:
            raise ValueError("need at least one worker")
        if shared_root is None:
            shared_root = tempfile.mkdtemp(prefix="deeper_fleet_")
        from repro_torch.serve.fleet.frontend import FleetFrontend

        specs = [cfg.worker_spec(shared_root, name=f"w{i}")
                 for i in range(workers)]
        kw = dict(frontend_kw)
        kw.setdefault("hb_timeout_s", cfg.hb_timeout_s)
        if quotas is not None:
            kw["quotas"] = quotas
        if classes is not None:
            kw["classes"] = classes
        return FleetFrontend.launch(specs, ready_timeout=ready_timeout, **kw)

    @staticmethod
    def stats(handle: Any) -> Dict[str, Any]:
        """The unified observability view over either entry point's
        handle: ``{"merged": <registry snapshot>, "frontend"/"local":
        <snapshot>, "workers": {name: <snapshot>}}``.  For a fleet this
        is :meth:`FleetFrontend.fleet_stats` (worker snapshots merged
        sketch-wise); for a local stack the single registry is its own
        merge."""
        fleet_stats = getattr(handle, "fleet_stats", None)
        if callable(fleet_stats):
            return fleet_stats()
        snap = handle.scheduler.registry.snapshot()
        return {"merged": snap, "local": snap, "workers": {}}


__all__ = ["LocalServe", "Serve", "ServeConfig"]
