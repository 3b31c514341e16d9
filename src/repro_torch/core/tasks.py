"""OmpSs-style task-based resiliency (DEEP-ER §III-D2).

Counterpart of ``repro/core/tasks.py``, with the reference's three
features:

* **Lightweight task checkpointing**: a task's inputs are snapshotted into
  host memory before launch; on a failure the task is re-executed from
  the snapshot; on success the snapshot is dropped.

* **Persistent task checkpointing**: results are journaled to a durable
  tier (``task_journal/<name>.pkl``); after a full application crash,
  re-running the graph *fast-forwards* over the tasks whose results are in
  the journal, resuming at the failure point with restored data.

* **Resilient offload**: a failed offloaded task is detected, isolated and
  restarted *without* rolling back work completed in parallel by other
  tasks.

JAX arrays are immutable and the reference hands every attempt the same
snapshot; a torch task may mutate its inputs in place.  So here:

* the snapshot copies every tensor leaf to the host (``copy=True``: a CPU
  tensor's ``.cpu()`` would be the tensor itself) and every numpy leaf
  (``torch.as_tensor`` would share its memory); other leaves pass through;
* every attempt gets fresh copies made from the snapshot, each tensor on
  the device it came from (a task whose inputs were on the card runs on
  the card; the runtime never moves a task), so a retry sees its inputs
  as they were at launch;
* the journal holds the result as numpy arrays (bfloat16, which numpy has
  no dtype for, is refused by name), so that a journal written by either
  package replays in the other; a replayed array comes back as a tensor
  on the device of the task's first tensor input (the CPU without one),
  where a fresh run would put it.
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.cluster.topology import NodeFailure, VirtualCluster
from repro_torch.memory.tiers import MemoryTier

__all__ = ["TaskError", "TaskRuntime", "TaskStats"]


class TaskError(RuntimeError):
    pass


@dataclasses.dataclass
class TaskStats:
    launched: int = 0
    completed: int = 0
    retried: int = 0
    replayed: int = 0      # skipped via journal fast-forward
    failed: int = 0
    wall_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class _Held:
    """A tensor leaf of a snapshot: its host copy and where it lived."""
    host: torch.Tensor
    device: torch.device
    requires_grad: bool


def _map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _hold(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return _Held(x.detach().to("cpu", copy=True), x.device, x.requires_grad)
    if isinstance(x, np.ndarray):
        return x.copy()
    return x


def _snapshot(tree: Any) -> Any:
    """Lightweight checkpoint of a task's inputs: host copies of every
    tensor and numpy leaf (device->host for card tensors)."""
    return _map(_hold, tree)


def _fresh(x: Any) -> Any:
    if isinstance(x, _Held):
        t = x.host.to(x.device, copy=True)
        return t.requires_grad_() if x.requires_grad else t
    if isinstance(x, np.ndarray):
        return x.copy()
    return x


def _attempt_inputs(snapshot: Any) -> Any:
    """One attempt's inputs: new copies of the snapshot, each tensor on
    the device it came from."""
    return _map(_fresh, snapshot)


def _to_numpy(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("the task journal holds numpy arrays, and numpy "
                            "has no bfloat16: cast a persistent task's "
                            "bfloat16 result first")
        return x.detach().cpu().numpy().copy()
    return x


class TaskRuntime:
    """Resilient task execution with host snapshots + a durable journal."""

    def __init__(
        self,
        cluster: Optional[VirtualCluster] = None,
        journal_tier: Optional[MemoryTier] = None,
        max_retries: int = 2,
    ):
        self.cluster = cluster
        self.journal_tier = journal_tier
        self.max_retries = max_retries
        self.stats = TaskStats()

    # -- persistent journal ---------------------------------------------- #

    def _journal_key(self, name: str) -> str:
        return f"task_journal/{name}.pkl"

    def _journal_lookup(self, name: str, device: torch.device) -> Optional[Any]:
        if self.journal_tier is None:
            return None
        key = self._journal_key(name)
        if self.journal_tier.exists(key):
            value = pickle.loads(self.journal_tier.get(key))
            return _map(lambda x: torch.from_numpy(np.array(x)).to(device)
                        if isinstance(x, np.ndarray) else x, value)
        return None

    def _journal_store(self, name: str, result: Any) -> None:
        if self.journal_tier is None:
            return
        self.journal_tier.put(self._journal_key(name),
                              pickle.dumps(_map(_to_numpy, result)))

    def clear_journal(self) -> None:
        if self.journal_tier is None:
            return
        for key in list(self.journal_tier.keys()):
            if key.startswith("task_journal/"):
                self.journal_tier.delete(key)

    # -- execution -------------------------------------------------------- #

    def run(
        self,
        name: str,
        fn: Callable[..., Any],
        *inputs: Any,
        rank: Optional[int] = None,
        persistent: bool = False,
    ) -> Any:
        """Run task ``fn(*inputs)`` with resiliency.

        ``rank``: the (virtual) node executing the task; armed failures on
        that rank fire inside the task and trigger a retry, re-running the
        task from fresh copies of its input snapshot (on the recovered
        node).  ``persistent``: journal the result; re-runs fast-forward
        over it.
        """
        t0 = time.monotonic()
        if persistent:
            first = next((x for x in _leaves(inputs)
                          if isinstance(x, torch.Tensor)), None)
            device = first.device if first is not None else torch.device("cpu")
            journaled = self._journal_lookup(name, device)
            if journaled is not None:
                self.stats.replayed += 1
                return journaled

        snapshot = _snapshot(inputs)  # lightweight checkpoint of dependencies
        attempts = 0
        while True:
            self.stats.launched += 1
            try:
                if rank is not None and self.cluster is not None:
                    self.cluster.maybe_fail(rank)  # injected failures fire here
                result = fn(*_attempt_inputs(snapshot))
                self.stats.completed += 1
                if persistent:
                    self._journal_store(name, result)
                self.stats.wall_s += time.monotonic() - t0
                return result  # snapshot dropped on return
            except NodeFailure as e:
                attempts += 1
                self.stats.retried += 1
                if attempts > self.max_retries:
                    self.stats.failed += 1
                    raise TaskError(f"task {name!r} failed after {attempts} "
                                    "attempts") from e
                # isolate + clean up the failed rank, restart on recovery
                if self.cluster is not None:
                    self.cluster.recover(e.rank)

    def offload_group(
        self,
        tasks: List[Tuple[str, Callable[..., Any], Tuple[Any, ...], int]],
        persistent: bool = False,
    ) -> List[Any]:
        """Run a group of offloaded tasks; one task's failure does not roll
        back the others (the paper's resilient-offload property)."""
        results: List[Any] = []
        for name, fn, inputs, rank in tasks:
            results.append(self.run(name, fn, *inputs, rank=rank,
                                    persistent=persistent))
        return results
