"""Metrics registry: counters, gauges, mergeable quantile sketches.

One :class:`Registry` per process (per serving stack, in practice)
holds every instrument.  Names are dotted (``"tier.hits_fast"``,
``"sched.steps"``) and instruments may carry labels
(``histogram("frontend.admission_latency_s", tenant="quiet")``), which
become one extra nesting level in the snapshot.  The design constraints,
in order:

* **Absorb, don't break.**  The stack's pre-existing ``stats()`` dicts
  (``TierStack``, ``KVPager``, the schedulers, ``FleetFrontend``) must
  keep every key and every access idiom (``stats["x"] += 1``,
  ``dict(stats)``, ``stats()``).  :class:`StatsView` is that shim: a
  mutable mapping whose entries live in registry counters, also
  callable for the legacy snapshot form.
* **Mergeable across processes.**  Fleet workers ship
  :meth:`Registry.snapshot` dicts over the pipe protocol and the
  frontend folds them with :func:`merge_snapshots`: counters and gauges
  sum, quantile sketches *merge* (bucket counts add) — a fleet p99 is
  computed over the union of observations, never an average of
  per-worker percentiles.
* **Bias-bounded quantiles.**  :class:`QuantileSketch` is a DDSketch-
  style log-bucketed histogram: any quantile estimate is within
  relative error ``alpha`` (default 1%) of an actual observed value at
  that rank, and two sketches merge into exactly the sketch of the
  concatenated observations.  :func:`quantile` is the one shared
  percentile definition the frontend and the figure benchmarks use.

Snapshots are plain JSON-able dicts (they ride pipes and land in
``BENCH_*.json`` artifacts):

.. code-block:: python

    {"counters":   {"tier": {"hits_hbm": 41, ...}, "sched": {...}},
     "gauges":     {"worker": {"cpu_s": 1.2}},
     "histograms": {"frontend": {"admission_latency_s":
                        {"tenant=quiet": {"kind": "qsketch", ...}}}}}
"""

from __future__ import annotations

import math
import threading
from collections.abc import MutableMapping
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

# observations with magnitude below this land in the sketch's zero
# bucket (bounds the bucket-index range; admission latencies are ~1e-5s,
# three orders of magnitude above)
_ZERO_EPS = 1e-9


class QuantileSketch:
    """Mergeable log-bucketed quantile sketch (DDSketch-style).

    Positive observations land in bucket ``ceil(log_gamma(x))`` with
    ``gamma = (1 + alpha) / (1 - alpha)``; a bucket's representative
    value ``2 * gamma^i / (gamma + 1)`` is within relative error
    ``alpha`` of every value the bucket covers, so ``quantile(q)`` is
    within ``alpha`` (relative) of an actual sample at that rank.
    Negative values mirror into their own bucket map, near-zeros count
    in a dedicated zero bucket.  Merging adds bucket counts — the merge
    of two sketches is exactly the sketch of the concatenated streams.
    """

    __slots__ = ("alpha", "_gamma", "_log_gamma", "count", "total",
                 "vmin", "vmax", "zero", "pos", "neg")

    def __init__(self, alpha: float = 0.01):
        if not 0.0 < alpha < 1.0:
            raise ValueError("alpha must be in (0, 1)")
        self.alpha = float(alpha)
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self._gamma)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.zero = 0
        self.pos: Dict[int, int] = {}
        self.neg: Dict[int, int] = {}

    # -- recording --------------------------------------------------------- #

    def _index(self, mag: float) -> int:
        return int(math.ceil(math.log(mag) / self._log_gamma))

    def observe(self, x: float, n: int = 1) -> None:
        x = float(x)
        self.count += n
        self.total += x * n
        if x < self.vmin:
            self.vmin = x
        if x > self.vmax:
            self.vmax = x
        if abs(x) < _ZERO_EPS:
            self.zero += n
        elif x > 0:
            i = self._index(x)
            self.pos[i] = self.pos.get(i, 0) + n
        else:
            i = self._index(-x)
            self.neg[i] = self.neg.get(i, 0) + n

    # -- querying ----------------------------------------------------------- #

    def _value(self, i: int) -> float:
        # midpoint of bucket (gamma^(i-1), gamma^i] minimizing the
        # worst-case relative error over the bucket
        return 2.0 * (self._gamma ** i) / (self._gamma + 1.0)

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]; 0.0 on an empty sketch."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        seen = 0
        # walk from the most negative magnitude upward
        for i in sorted(self.neg, reverse=True):
            seen += self.neg[i]
            if seen > rank:
                return max(self.vmin, min(self.vmax, -self._value(i)))
        seen += self.zero
        if seen > rank:
            return max(self.vmin, min(self.vmax, 0.0))
        for i in sorted(self.pos):
            seen += self.pos[i]
            if seen > rank:
                return max(self.vmin, min(self.vmax, self._value(i)))
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    # -- merge / serialization ---------------------------------------------- #

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"cannot merge sketches of different accuracy "
                f"({self.alpha} vs {other.alpha})")
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        self.zero += other.zero
        for i, n in other.pos.items():
            self.pos[i] = self.pos.get(i, 0) + n
        for i, n in other.neg.items():
            self.neg[i] = self.neg.get(i, 0) + n
        return self

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "kind": "qsketch", "alpha": self.alpha, "count": self.count,
            "sum": self.total,
            "p50": self.quantile(0.5), "p99": self.quantile(0.99),
        }
        if self.count:
            out["min"] = self.vmin
            out["max"] = self.vmax
        if self.zero:
            out["zero"] = self.zero
        if self.pos:
            out["pos"] = {str(i): n for i, n in sorted(self.pos.items())}
        if self.neg:
            out["neg"] = {str(i): n for i, n in sorted(self.neg.items())}
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "QuantileSketch":
        if d.get("kind") != "qsketch":
            raise ValueError(f"not a qsketch dict: {d!r}")
        sk = cls(alpha=float(d.get("alpha", 0.01)))
        sk.count = int(d.get("count", 0))
        sk.total = float(d.get("sum", 0.0))
        sk.vmin = float(d.get("min", math.inf))
        sk.vmax = float(d.get("max", -math.inf))
        sk.zero = int(d.get("zero", 0))
        sk.pos = {int(i): int(n) for i, n in d.get("pos", {}).items()}
        sk.neg = {int(i): int(n) for i, n in d.get("neg", {}).items()}
        return sk


def is_sketch_dict(node: Any) -> bool:
    return isinstance(node, dict) and node.get("kind") == "qsketch"


def quantile(values: Iterable[float], q: float,
             alpha: float = 0.01) -> float:
    """The one shared percentile definition: value at quantile ``q``
    (in [0, 1]) of ``values``, bias-bounded by the sketch's ``alpha``
    relative error; 0.0 on empty input.  Replaces the hand-rolled
    sort-and-index and ``np.percentile`` variants so the frontend, the
    figure benchmarks, and merged fleet snapshots all agree on what a
    p99 is."""
    sk = QuantileSketch(alpha=alpha)
    for v in values:
        sk.observe(v)
    return sk.quantile(q)


class Counter:
    """Monotonic-by-convention numeric cell (floats allowed: the tier
    codec ratio rides a counter for stats-key parity)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins numeric cell."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """A labeled quantile sketch registered in a :class:`Registry`."""

    __slots__ = ("sketch",)

    def __init__(self, alpha: float = 0.01):
        self.sketch = QuantileSketch(alpha=alpha)

    def observe(self, x: float, n: int = 1) -> None:
        self.sketch.observe(x, n)

    def quantile(self, q: float) -> float:
        return self.sketch.quantile(q)

    @property
    def count(self) -> int:
        return self.sketch.count


_LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _label_key(name: str, labels: Dict[str, Any]) -> _LabelKey:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_leaf(labels: Tuple[Tuple[str, str], ...]) -> str:
    return ",".join(f"{k}={v}" for k, v in labels)


class Registry:
    """One process's instrument namespace.

    ``counter`` / ``gauge`` / ``histogram`` are get-or-create (the same
    name + labels always returns the same cell), so components can
    resolve instruments eagerly at construction and pay only an
    attribute add on the hot path.  ``snapshot()`` renders everything
    into the nested JSON-able form the fleet pipes around and
    ``merge_snapshots`` folds."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[_LabelKey, Counter] = {}
        self._gauges: Dict[_LabelKey, Gauge] = {}
        self._histograms: Dict[_LabelKey, Histogram] = {}

    def counter(self, name: str, **labels: Any) -> Counter:
        key = _label_key(name, labels)
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter()
            return c

    def gauge(self, name: str, **labels: Any) -> Gauge:
        key = _label_key(name, labels)
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge()
            return g

    def histogram(self, name: str, alpha: float = 0.01,
                  **labels: Any) -> Histogram:
        key = _label_key(name, labels)
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram(alpha=alpha)
            return h

    def drop_counter(self, name: str, **labels: Any) -> None:
        with self._lock:
            self._counters.pop(_label_key(name, labels), None)

    # -- snapshots ---------------------------------------------------------- #

    @staticmethod
    def _insert(tree: Dict[str, Any], name: str,
                labels: Tuple[Tuple[str, str], ...], value: Any) -> None:
        parts = name.split(".")
        node = tree
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = node[p] = {}
            node = nxt
        if labels:
            leaf = node.setdefault(parts[-1], {})
            leaf[_label_leaf(labels)] = value
        else:
            node[parts[-1]] = value

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able nested view of every instrument (dotted names split
        into nesting, labels one extra level, histograms as sketch
        dicts)."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
        out: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}}
        for (name, labels), c in counters:
            self._insert(out["counters"], name, labels, c.value)
        for (name, labels), g in gauges:
            self._insert(out["gauges"], name, labels, g.value)
        for (name, labels), h in hists:
            self._insert(out["histograms"], name, labels,
                         h.sketch.to_dict())
        return out


def _merge_into(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        cur = dst.get(k)
        if is_sketch_dict(v):
            if cur is None:
                dst[k] = QuantileSketch.from_dict(v).to_dict()
            else:
                merged = QuantileSketch.from_dict(cur)
                merged.merge(QuantileSketch.from_dict(v))
                dst[k] = merged.to_dict()
        elif isinstance(v, dict):
            if not isinstance(cur, dict):
                cur = dst[k] = {}
            _merge_into(cur, v)
        else:
            dst[k] = (cur or 0) + v


def merge_snapshots(snapshots: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold per-process :meth:`Registry.snapshot` dicts into one
    fleet-wide view: counters and gauges sum (fleet gauges are additive
    by convention — used bytes, resident streams, CPU seconds),
    quantile sketches merge bucket-wise.  Percentiles of the merged
    view are therefore computed over the union of all workers'
    observations — never an average of per-worker percentiles."""
    out: Dict[str, Any] = {}
    for snap in snapshots:
        if snap:
            _merge_into(out, snap)
    return out


class StatsView(MutableMapping):
    """A legacy ``stats`` dict whose entries live in registry counters.

    The pre-obs components expose ``self.stats`` as a plain counter
    dict, mutated in place (``stats["hits_fast"] += 1``) and snapshotted
    as ``dict(stats)`` — ``TierStack`` additionally calls it
    (``stats()``).  This view keeps every one of those idioms while the
    numbers themselves live in ``registry`` counters under
    ``<prefix>.<key>``, so the same counters appear in
    :meth:`Registry.snapshot` and merge fleet-wide."""

    def __init__(self, registry: Registry, prefix: str,
                 initial: Optional[Dict[str, float]] = None):
        self._registry = registry
        self._prefix = prefix
        self._cells: Dict[str, Counter] = {}
        if initial:
            self.update(initial)

    def _cell(self, key: str) -> Counter:
        c = self._cells.get(key)
        if c is None:
            c = self._registry.counter(f"{self._prefix}.{key}")
            self._cells[key] = c
        return c

    def __getitem__(self, key: str) -> float:
        c = self._cells.get(key)
        if c is None:
            raise KeyError(key)
        v = c.value
        return int(v) if isinstance(v, float) and v.is_integer() else v

    def __setitem__(self, key: str, value: float) -> None:
        self._cell(key).value = value

    def __delitem__(self, key: str) -> None:
        self._cells.pop(key)
        self._registry.drop_counter(f"{self._prefix}.{key}")

    def __iter__(self) -> Iterator[str]:
        return iter(list(self._cells))

    def __len__(self) -> int:
        return len(self._cells)

    def __call__(self) -> Dict[str, float]:
        return {k: self[k] for k in self._cells}

    def __repr__(self) -> str:
        return f"StatsView({self._prefix!r}, {self()!r})"
