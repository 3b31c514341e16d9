"""The serving construction API: one config, one local entry point.

Counterpart of ``repro/serve/api.py``.  :func:`Serve.local` builds one
in-process paged scheduler from a :class:`ServeConfig` (the model from
the config registry, ``reduced()`` unless ``full_size``, with random
weights from ``seed``) on ``device``.  The pager, the prefix cache,
sessions and the contiguous scheduler wait for the resilient-serving
slice; ``Serve.fleet`` waits for the fleet slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

_WAITS = "waits for the resilient-serving slice of ROADMAP.md"


@dataclass(frozen=True)
class ServeConfig:
    """Everything needed to build a serving stack (the reference's
    fields, plus ``device``: where the weights and the pool live)."""

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
    # where the weights and the page pool live
    device: str = "cuda"


def _build_model(cfg: ServeConfig) -> Tuple[Any, Any, Any]:
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model

    arch = get_config(cfg.arch)
    if not cfg.full_size:
        arch = arch.reduced()
    model = get_model(arch)
    params = model.init(cfg.seed, arch, device=cfg.device)
    return arch, model, params


class LocalServe:
    """One in-process serving stack built from a :class:`ServeConfig`:
    the scheduler's continuous-batching surface (submit / step / run /
    output) and the :attr:`scheduler` itself.  Context manager."""

    def __init__(self, cfg: ServeConfig, session: Any = None):
        from repro_torch.serve.scheduler import PagedServeScheduler

        if session is not None:
            raise NotImplementedError(f"session= {_WAITS}")
        if cfg.prefix:
            raise NotImplementedError(
                f"the prefix cache {_WAITS}; pass prefix=False")
        if not (cfg.paged or cfg.spec_k > 0):
            raise NotImplementedError(f"paged=False {_WAITS}")
        self.cfg = cfg
        self.arch, self.model, self.params = _build_model(cfg)
        self.scheduler = PagedServeScheduler(
            self.arch, self.model, self.params, slots=cfg.slots,
            max_len=cfg.max_len, quantum=cfg.quantum,
            page_tokens=cfg.page_tokens, pool_pages=cfg.pool_pages,
            spec_k=cfg.spec_k, kv_codec=cfg.kv_codec)

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
    """The serving entry point (namespace class — no instances)."""

    @staticmethod
    def local(cfg: ServeConfig, session: Any = None) -> LocalServe:
        """One in-process paged scheduler wired from ``cfg``."""
        return LocalServe(cfg, session=session)


__all__ = ["LocalServe", "Serve", "ServeConfig"]
