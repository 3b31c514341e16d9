"""TierStack: policy-driven router over BufferStore levels (DEEP-ER §II-B).

DEEP-ER's hierarchy only pays off because *placement* is policy, not
plumbing: the same tiers serve burst-buffer writes, BeeOND cache domains,
and SCR's multi-level checkpoints, differing only in where each class of
data lands and when it moves.  ``TierStack`` pins that down:

* an ordered list of named levels, fastest first, each a
  :class:`~repro.memory.store.BufferStore` (a raw ``MemoryTier``, a
  ``CacheFS`` cache domain, a ``NAMStore``, ...);
* a placement policy per *key class* (descriptor / fragment / container /
  parity — see :func:`classify_key`): which level is home, whether reads
  promote, whether the key may be evicted or spill downward;
* capacity pressure handled as policy: a full level evicts least-
  recently-used *clean* entries (or demotes dirty ones) and retries, then
  spills to the next level — instead of a hard ``CapacityError`` on the
  hot path;
* read-through with hit-rate-driven promotion: a get walks the levels
  from the key's home downward and re-establishes the value at its home
  level once it has earned >= k hits inside a sliding access window
  (:class:`HitRatePromotion`; k=1 keeps the classic promote-on-read) —
  with per-level hit/miss counters in :meth:`TierStack.stats`;
* admission control (``admission_fraction``): a value larger than that
  fraction of a level's capacity is never cached there — it routes
  straight to the next level of its chain, so one oversized stream
  cannot wipe a level's working set;
* near-memory offload: :meth:`TierStack.offload` routes an
  :class:`~repro.memory.store.OffloadOp` to the first capable level of
  the key's chain (the NAM level for parity keys — DEEP-ER's FPGA
  parity path), with a byte-identical host fallback for stacks without
  one.

The SCR manager (core/scr.py) routes its whole shared-storage path —
descriptors, BeeOND-staged checkpoint fragments, drained global copies —
through one ``TierStack``; serving and training construct their
hierarchies via :meth:`TierStack.for_cluster`.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.memory.codecs import CodecRule, decode_blob, is_encoded
from repro_torch.memory.store import BufferStore, NAMStore, OffloadOp
from repro_torch.memory.tiers import CapacityError, MemoryHierarchy
from repro_torch.obs.metrics import Registry, StatsView


class KeyClass(enum.Enum):
    DESCRIPTOR = "descriptor"   # tiny durable index records (SCR descriptors)
    FRAGMENT = "fragment"       # bulk checkpoint fragments
    CONTAINER = "container"     # SION aggregated containers
    PARITY = "parity"           # XOR / NAM parity blocks
    KV = "kv"                   # serving KV-cache pages (serve/kvpage.py)
    OTHER = "other"


def classify_key(key: str) -> KeyClass:
    """Map a storage key to its placement class (see core/scr.py key layout
    and serve/kvpage.py for the ``kv/`` namespace)."""
    if key.startswith("scr/desc/"):
        return KeyClass.DESCRIPTOR
    if key.startswith("kv/"):
        return KeyClass.KV
    base = key.rsplit("/", 1)[-1]
    if key.startswith("nam_parity/") or "parity" in base:
        return KeyClass.PARITY
    if key.endswith(".sion"):
        return KeyClass.CONTAINER
    if key.startswith("ckpt/"):
        return KeyClass.FRAGMENT
    return KeyClass.OTHER


@dataclasses.dataclass(frozen=True)
class PlacementRule:
    """Where one key class lives and how it moves between levels."""

    level: Optional[str] = None   # home level name; None = first (fastest)
    promote: bool = True          # re-establish at home on a lower-level hit
    evictable: bool = True        # may be evicted under capacity pressure
    spill: bool = True            # may land on a lower level when home is full


DEFAULT_POLICY: Dict[KeyClass, PlacementRule] = {
    # descriptors are the durability index: terminal level, never evicted
    KeyClass.DESCRIPTOR: PlacementRule(
        level="global", promote=False, evictable=False, spill=False),
    KeyClass.FRAGMENT: PlacementRule(),
    KeyClass.CONTAINER: PlacementRule(),
    # parity is redundancy data: prefers the NAM (off the failure domain)
    KeyClass.PARITY: PlacementRule(level="nam", promote=False),
    # serving KV pages: hot at the fastest level, cold pages spill down
    KeyClass.KV: PlacementRule(),
    KeyClass.OTHER: PlacementRule(),
}


@dataclasses.dataclass(frozen=True)
class HitRatePromotion:
    """Hit-rate-driven promotion: a below-home hit re-establishes the key
    at its home level only once the key has accumulated ``k`` hits within
    the last ``window`` stack accesses of the key's *class* (each
    :class:`KeyClass` has its own sliding-window clock, so kv page
    traffic cannot age a checkpoint fragment's window or vice versa).

    ``k=1`` promotes on the first hit — the classic read-promotion, and
    the default so checkpoint-restore reads (each fragment read exactly
    once) keep promoting.  The serving KV path installs ``k >= 2`` so
    one-shot resume reads never wipe the fast tier's working set: only
    keys with genuine reuse inside the window earn promotion (DEEP-ER
    §II-B as *policy*: placement follows the access pattern, not the
    last access).

    The same hit log drives eviction order: under capacity pressure,
    blocks with no hit inside the window (cold) are demoted before warm
    ones, regardless of raw LRU recency.
    """

    k: int = 1
    window: int = 64

    def __post_init__(self):
        if self.k < 1:
            raise ValueError("promotion threshold k must be >= 1")
        if self.window < 1:
            raise ValueError("promotion window must be >= 1")


class _ReplayableChunks:
    """Record a chunk iterable as it is consumed so a capacity-failed
    ``put_stream`` can be replayed after eviction or on the next level.

    Deliberate tradeoff: the recording holds one transient copy of the
    value for the duration of the write (freed when the call returns) —
    the price of never losing a stream to a CapacityError mid-consume.
    The underlying stores still never build a joined blob."""

    def __init__(self, chunks):
        self._source = iter(chunks)
        self._seen: List[bytes] = []
        self.total = 0

    def replay(self):
        for c in self._seen:
            yield c
        for c in self._source:
            c = bytes(c)
            self._seen.append(c)
            self.total += len(c)
            yield c


class TierStack:
    """Compose BufferStore levels under one placement policy.

    ``levels`` is an ordered ``[(name, store), ...]``, fastest first; the
    last level is terminal (durable).  ``policy`` overrides entries of
    :data:`DEFAULT_POLICY` per :class:`KeyClass`.  A rule naming a level
    absent from this stack falls back to the terminal level for
    ``"global"`` and to the first level otherwise.
    """

    def __init__(
        self,
        levels: Sequence[Tuple[str, BufferStore]],
        policy: Optional[Dict[KeyClass, PlacementRule]] = None,
        hierarchy: Optional[MemoryHierarchy] = None,
        admission_fraction: Optional[float] = None,
        promotion: Optional[HitRatePromotion] = None,
        codecs: Optional[Dict[KeyClass, CodecRule]] = None,
        registry: Optional[Registry] = None,
    ):
        if not levels:
            raise ValueError("TierStack needs at least one level")
        names = [n for n, _ in levels]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate level names: {names}")
        if admission_fraction is not None and not 0.0 < admission_fraction <= 1.0:
            raise ValueError("admission_fraction must be in (0, 1]")
        self.levels: List[Tuple[str, BufferStore]] = list(levels)
        self.policy = dict(DEFAULT_POLICY)
        self.policy.update(policy or {})
        self.hierarchy = hierarchy
        # admission control: a value larger than this fraction of a
        # level's capacity is not cached there — it routes straight to
        # the next level of its placement chain (the terminal level
        # always admits).  None disables the check.
        self.admission_fraction = admission_fraction
        # hit-rate-driven promotion: the default (k=1) promotes on the
        # first below-home hit; see :class:`HitRatePromotion`
        self.promotion = promotion if promotion is not None else HitRatePromotion()
        # per-key-class codec policy: values of a class with a
        # :class:`~repro.memory.codecs.CodecRule` encode when they land
        # on level index >= rule.fast_levels (spill/demotion writes) and
        # decode on every read — the fast level(s) stay plaintext.
        # Content addressing and manifests live ABOVE this layer, over
        # the decoded bytes (the DAOS stance: object identity is
        # independent of on-media encoding).
        self.codecs: Dict[KeyClass, CodecRule] = dict(codecs or {})
        self.beeond = None       # set by for_hierarchy when a cache domain exists
        self.nam_device = None   # set by for_hierarchy when a NAM level exists
        self._lock = threading.RLock()
        self._closed = False
        self._lru: Dict[str, "OrderedDict[str, int]"] = {n: OrderedDict() for n in names}
        # keys known identical to a lower-level copy (promoted reads);
        # a rewrite at this level clears the mark — eviction must never
        # treat a merely-existing lower copy as backing for newer data
        self._clean: Dict[str, set] = {n: set() for n in names}
        # sliding-window hit log: key -> ticks of recent read hits, one
        # tick per get(); drives promotion (>= k hits) and eviction order
        # (no hit in the window = cold, demoted first).  The clock is
        # PER KEY CLASS: a burst of kv page traffic must not age a
        # checkpoint fragment's window (and vice versa) — with one global
        # clock, whichever class is chattier starves the others of
        # promotion, skewing placement by traffic volume instead of
        # per-class reuse.
        self._ticks: Dict[KeyClass, int] = {c: 0 for c in KeyClass}
        self._hit_log: Dict[str, List[int]] = {}
        # counters live in an obs Registry (shared across a serving
        # stack's components so one snapshot covers tier + pager +
        # scheduler); ``stats`` keeps its historical shape — a mapping
        # of the same keys that is also callable for a snapshot
        self.registry = registry if registry is not None else Registry()
        self.stats = StatsView(self.registry, "tier", {
            "evictions": 0, "promotions": 0, "spills": 0,
            "admission_routed": 0, "offloads": 0, "direct_puts": 0,
            **{f"hits_{n}": 0 for n in names},
            **{f"misses_{n}": 0 for n in names},
            # codec traffic per encoded class: plaintext bytes through
            # encode, encoded output bytes, decoded bytes served, and the
            # running compression ratio (encoded / plaintext; 0.25 for
            # int8-over-float32) — these flow into the BENCH artifacts
            **{f"{c.value}_{s}": 0 for c in self.codecs
               for s in ("bytes_encoded", "bytes_encoded_out",
                         "bytes_decoded", "codec_ratio")},
        })

    # -- construction ---------------------------------------------------- #

    @classmethod
    def for_hierarchy(
        cls,
        hierarchy: MemoryHierarchy,
        nam=None,
        beeond_mode: str = "async",
        drain_streams: Optional[int] = None,
        max_pending: Optional[int] = None,
        policy: Optional[Dict[KeyClass, PlacementRule]] = None,
        admission_fraction: Optional[float] = None,
        promotion: Optional[HitRatePromotion] = None,
    ) -> "TierStack":
        """The canonical DEEP-ER stack over a MemoryHierarchy:

            beeond (CacheFS cache domain over the aggregated node NVMs,
                    draining to global)  >  [nam]  >  global

        The CacheFS captures ``hierarchy.global_tier`` *now*, so a caller
        that wrapped/replaced the global tier (throttling, fault
        injection) is routed through the wrapper.
        """
        from repro_torch.io.beeond import CacheFS  # local import: io imports memory

        size = max(1, hierarchy.cluster.size)
        beeond = CacheFS(
            hierarchy.beeond_tier,
            hierarchy.global_tier,
            mode=beeond_mode,
            drain_streams=drain_streams or size,
            max_pending=max_pending if max_pending is not None else 2 * size,
        )
        levels: List[Tuple[str, BufferStore]] = [("beeond", beeond)]
        if nam is not None:
            levels.append(("nam", NAMStore(nam)))
        levels.append(("global", hierarchy.global_tier))
        stack = cls(levels, policy=policy, hierarchy=hierarchy,
                    admission_fraction=admission_fraction, promotion=promotion)
        stack.beeond = beeond
        stack.nam_device = nam
        return stack

    @classmethod
    def for_cluster(cls, cluster, specs=None, with_nam: bool = False, **kw) -> "TierStack":
        """One-call construction: hierarchy + cache domain (+ NAM device
        and level when ``with_nam``) composed into the canonical stack."""
        hierarchy = MemoryHierarchy(cluster, specs)
        nam = None
        if with_nam:
            from repro_torch.core.nam import NAMDevice  # call-time import, no cycle
            nam = NAMDevice(hierarchy.nam_tier)
        return cls.for_hierarchy(hierarchy, nam=nam, **kw)

    # -- policy helpers --------------------------------------------------- #

    def rule_for(self, key: str) -> PlacementRule:
        return self.policy[classify_key(key)]

    def level(self, name: str) -> BufferStore:
        for n, store in self.levels:
            if n == name:
                return store
        raise KeyError(name)

    def _home_idx(self, rule: PlacementRule) -> int:
        if rule.level is not None:
            for i, (n, _) in enumerate(self.levels):
                if n == rule.level:
                    return i
            if rule.level == "global":
                return len(self.levels) - 1
        return 0

    def _spill_targets(self, start: int):
        """Level indices a write may land on: the home level, then lower
        levels that accept spilled data (a volatile level like the NAM
        opts out via ``accepts_spill = False``)."""
        yield start
        for i in range(start + 1, len(self.levels)):
            if getattr(self.levels[i][1], "accepts_spill", True):
                yield i

    def _admits(self, idx: int, nbytes: Optional[int]) -> bool:
        """Admission control: may a value of ``nbytes`` be cached at this
        level?  A value larger than ``admission_fraction`` of the level's
        capacity is refused — one oversized stream must not wipe a whole
        level's working set to make room (the terminal level is exempted
        by the callers: durable storage admits everything)."""
        if self.admission_fraction is None or nbytes is None:
            return True
        cap = self.levels[idx][1].capacity_bytes()
        return nbytes <= self.admission_fraction * cap

    # -- codec policy ------------------------------------------------------ #

    def _codec_rule(self, key: str) -> Optional[CodecRule]:
        if not self.codecs:
            return None
        return self.codecs.get(classify_key(key))

    def codec_for(self, cls: KeyClass) -> Optional[CodecRule]:
        """The codec rule (if any) governing one key class — callers that
        carry integrity metadata over plaintext (the KV pager's manifest
        CRCs) use this to know whether reads are decode-exact."""
        return self.codecs.get(cls)

    def set_codec(self, cls: KeyClass, rule: Optional[CodecRule]) -> None:
        """Install (or clear, ``rule=None``) one key class's codec rule
        after construction, registering its stats counters — the serving
        wiring installs the ``kv`` rule on an existing pager stack this
        way.  Only affects writes from here on; bytes already resident
        keep their current representation (frames are self-describing,
        so mixed levels decode fine)."""
        with self._lock:
            if rule is None:
                self.codecs.pop(cls, None)
                return
            self.codecs[cls] = rule
            for s in ("bytes_encoded", "bytes_encoded_out",
                      "bytes_decoded", "codec_ratio"):
                self.stats.setdefault(f"{cls.value}_{s}", 0)

    def _encode_for(self, idx: int, key: str, data: bytes) -> bytes:
        """Encode ``data`` for a landing at level ``idx`` per the key's
        codec rule; plaintext below the boundary, already-framed blobs
        (a demotion re-put of encoded bytes) pass through untouched."""
        rule = self._codec_rule(key)
        if rule is None or idx < rule.fast_levels or is_encoded(data):
            return data
        blob = rule.codec.encode(data)
        cls = classify_key(key).value
        with self._lock:
            self.stats[f"{cls}_bytes_encoded"] += len(data)
            self.stats[f"{cls}_bytes_encoded_out"] += len(blob)
            self.stats[f"{cls}_codec_ratio"] = round(
                self.stats[f"{cls}_bytes_encoded_out"]
                / max(1, self.stats[f"{cls}_bytes_encoded"]), 4)
        return blob

    def _decode_for(self, key: str, data: bytes) -> bytes:
        """Decode a framed blob read back from any level (plaintext
        passes through) — every external read returns decoded bytes."""
        if self.codecs and is_encoded(data) and self._codec_rule(key) is not None:
            out = decode_blob(data)
            with self._lock:
                self.stats[f"{classify_key(key).value}_bytes_decoded"] += len(out)
            return out
        return data

    # -- LRU bookkeeping -------------------------------------------------- #

    def _touch(self, idx: int, key: str, size: int) -> None:
        with self._lock:
            lru = self._lru[self.levels[idx][0]]
            lru[key] = size
            lru.move_to_end(key)

    def _forget(self, idx: int, key: str) -> None:
        with self._lock:
            name = self.levels[idx][0]
            self._lru[name].pop(key, None)
            self._clean[name].discard(key)

    # -- hit-rate bookkeeping ---------------------------------------------- #

    def _record_hit(self, key: str, tick: int) -> bool:
        """Log one read hit; True when the key is *hot* — at least
        ``promotion.k`` hits inside the sliding window — i.e. eligible for
        promotion back to its home level."""
        with self._lock:
            log = self._hit_log.setdefault(key, [])
            log.append(tick)
            cutoff = tick - self.promotion.window
            while log and log[0] <= cutoff:
                log.pop(0)
            return len(log) >= self.promotion.k

    def _window_hits(self, key: str) -> int:
        """Hits of ``key`` inside its class's sliding window (0 = cold)."""
        with self._lock:
            log = self._hit_log.get(key)
            if not log:
                return 0
            cutoff = self._ticks[classify_key(key)] - self.promotion.window
            return sum(1 for t in log if t > cutoff)

    # -- write path -------------------------------------------------------- #

    def put(self, key: str, data: bytes, streams: int = 1) -> float:
        """Route a write to the key's home level; refuse (admission
        control) or evict (capacity pressure) per policy, spilling
        downward when the rule allows.  Returns modelled seconds."""
        rule = self.rule_for(key)
        start = self._home_idx(rule)
        targets = list(self._spill_targets(start))
        last_exc: Optional[CapacityError] = None
        # encode once per put, lazily: admission control must judge the
        # bytes a level would actually hold (the encoded blob past the
        # codec boundary), and every candidate past the boundary reuses
        # the same encoding
        enc: Optional[bytes] = None
        crule = self._codec_rule(key)

        def payload(i: int) -> bytes:
            nonlocal enc
            if crule is None or i < crule.fast_levels:
                return data
            if enc is None:
                enc = self._encode_for(i, key, data)
            return enc

        for i in targets:
            p = payload(i)
            # admission control: route an oversized value straight to the
            # next level (the last candidate always admits)
            if i != targets[-1] and rule.spill and not self._admits(i, len(p)):
                with self._lock:
                    self.stats["admission_routed"] += 1
                continue
            try:
                t = self._put_at(i, key, p, streams)
            except CapacityError as e:
                last_exc = e
                if not rule.spill:
                    break
                continue
            if i > start:
                with self._lock:
                    self.stats["spills"] += 1
            return t
        assert last_exc is not None
        raise last_exc

    def _put_at(self, idx: int, key: str, data: bytes, streams: int = 1) -> float:
        name, store = self.levels[idx]
        data = self._encode_for(idx, key, data)
        while True:
            try:
                t = store.put(key, data, streams=streams)
                self._touch(idx, key, len(data))
                with self._lock:
                    self._clean[name].discard(key)   # rewrite: lower copies stale
                return t
            except CapacityError:
                if not self._evict_one(idx, protect=key):
                    raise

    def put_stream(self, key: str, chunks, streams: int = 1,
                   size_hint: Optional[int] = None) -> float:
        """Streamed ``put``: consumed chunks are recorded so eviction-retry
        and spill can replay them (overflow never loses the stream).

        ``size_hint`` (total bytes, when the caller knows it) lets
        admission control route an oversized stream past a level without
        consuming it first."""
        if self._codec_rule(key) is not None:
            # codec-classed keys take the blob path: encoding needs the
            # whole value, and _ReplayableChunks would hold a full
            # transient copy anyway — same memory profile, one code path
            return self.put(key, b"".join(bytes(c) for c in chunks),
                            streams=streams)
        rule = self.rule_for(key)
        start = self._home_idx(rule)
        targets = list(self._spill_targets(start))
        replay = _ReplayableChunks(chunks)
        last_exc: Optional[CapacityError] = None
        for i in targets:
            if (i != targets[-1] and rule.spill
                    and not self._admits(i, size_hint)):
                with self._lock:
                    self.stats["admission_routed"] += 1
                continue
            _, store = self.levels[i]
            while True:
                try:
                    t = store.put_stream(key, replay.replay(), streams=streams)
                    self._touch(i, key, replay.total)
                    with self._lock:
                        self._clean[self.levels[i][0]].discard(key)
                        if i > start:
                            self.stats["spills"] += 1
                    return t
                except CapacityError as e:
                    last_exc = e
                    if not self._evict_one(i, protect=key):
                        break
            if not rule.spill:
                break
        assert last_exc is not None
        raise last_exc

    def put_at(self, level_name: str, key: str, data: bytes,
               streams: int = 1) -> float:
        """Direct write at one named level, bypassing home-level routing —
        the serving fleet's *publish* path: a worker pushes a prefix page
        straight to the shared level so peer processes can read it
        immediately, instead of waiting for demotion to carry it there.
        Codec policy still applies (the write encodes iff the level sits
        past the codec boundary), so published bytes match what a
        demotion of the same key would have produced."""
        for i, (name, _) in enumerate(self.levels):
            if name == level_name:
                t = self._put_at(i, key, data, streams)
                with self._lock:
                    self.stats["direct_puts"] += 1
                return t
        raise KeyError(level_name)

    # -- eviction ----------------------------------------------------------- #

    def _evict_one(self, idx: int, protect: str,
                   protect_prefix: Optional[str] = None) -> bool:
        """Free space on one level: cold-first (no hit inside the
        promotion window), then LRU within equal hotness; clean entries
        dropped, dirty evictable entries demoted a level.  ``protect``
        (and every key under ``protect_prefix``) is never a candidate.
        True if anything was freed."""
        name, store = self.levels[idx]
        with self._lock:
            candidates = [k for k in self._lru[name] if k != protect]
        # cold blocks demote first: order by window hit count, the stable
        # sort keeping LRU order among equally-warm keys
        candidates.sort(key=self._window_hits)
        seen = set(candidates)
        # keys written around the stack (directly into the store) are
        # eviction candidates too, after everything the stack tracked
        candidates.extend(
            k for k in store.keys() if k != protect and k not in seen)
        for k in candidates:
            if protect_prefix is not None and k.startswith(protect_prefix):
                continue
            rule = self.rule_for(k)
            if not rule.evictable:
                continue
            evict = getattr(store, "evict", None)
            if evict is not None:
                # the store knows which of its entries are clean (CacheFS:
                # drained; NAMStore: redundancy data)
                if evict(k):
                    self._forget(idx, k)
                    with self._lock:
                        self.stats["evictions"] += 1
                    return True
                continue
            demote_to = next((j for j in self._spill_targets(idx) if j > idx), None)
            with self._lock:
                known_clean = k in self._clean[name]
            if known_clean and self._exists_below(idx, k):
                store.delete(k)        # promoted copy, identical to the lower one
            elif demote_to is not None and rule.spill:
                try:
                    data = store.get(k)
                    self._put_at(demote_to, k, data)  # demote, then drop
                except (KeyError, CapacityError):
                    continue
                store.delete(k)
            else:
                continue
            self._forget(idx, k)
            with self._lock:
                self.stats["evictions"] += 1
            return True
        return False

    def _exists_below(self, idx: int, key: str) -> bool:
        return any(store.exists(key) for _, store in self.levels[idx + 1:])

    # -- read path ---------------------------------------------------------- #

    def get(self, key: str, streams: int = 1, promote: Optional[bool] = None) -> bytes:
        """Read through the stack from the key's home level downward.

        A hit below home is promoted back to the home level when the
        placement rule allows it AND the key is *hot* per the
        :class:`HitRatePromotion` policy (>= k hits in the sliding
        window); an explicit ``promote=True`` forces promotion, bypassing
        the hit-rate gate.  Promotion is best-effort (no room = skipped,
        never an error) and always routed through the same admission
        check as any other write into the level — including the
        read-through fill of a cache-domain level, so one oversized cold
        value can never wipe a fast level's working set on a read.
        """
        rule = self.rule_for(key)
        start = self._home_idx(rule)
        do_promote = rule.promote if promote is None else promote
        # an explicit promote=False read is a pure observer (checkpoint /
        # drain traffic): it neither logs a hit nor ages the window.
        # The window clock advances per key class (see __init__).
        observer = promote is False
        cls = classify_key(key)
        with self._lock:
            if not observer:
                self._ticks[cls] += 1
            tick = self._ticks[cls]
        for i in range(start, len(self.levels)):
            name, store = self.levels[i]
            if not store.exists(key):
                with self._lock:
                    self.stats[f"misses_{name}"] += 1
                continue
            # a read-through level (CacheFS) answers exists() for content it
            # merely fronts; `cached` tells whether the level itself holds it
            held = store.cached(key) if hasattr(store, "cached") else True
            try:
                if hasattr(store, "cached"):
                    # fill decided below, through admission + hit-rate gates
                    data = store.get(key, streams=streams, fill=False)
                else:
                    data = store.get(key, streams=streams)
            except KeyError:
                with self._lock:
                    self.stats[f"misses_{name}"] += 1
                continue
            # reads always return decoded bytes: a demoted/spilled value
            # comes back through its class codec transparently
            data = self._decode_for(key, data)
            hot = False if observer else self._record_hit(key, tick)
            want = do_promote and (hot or promote is True)
            with self._lock:
                if held:
                    self.stats[f"hits_{name}"] += 1
                else:
                    # served through the level from the store it fronts
                    # (the terminal level in the canonical stack)
                    self.stats[f"misses_{name}"] += 1
                    self.stats[f"hits_{self.levels[-1][0]}"] += 1
            if held:
                self._touch(i, key, len(data))
            elif (want and self._admits(i, len(data))
                  and store.fill(key, self._encode_for(i, key, data))):
                # the read-through fill IS this level's promotion
                with self._lock:
                    self.stats["promotions"] += 1
                    self._clean[name].add(key)
                self._touch(i, key, len(data))
            if want and i > start and self._admits(start, len(data)):
                try:
                    self._put_at(start, key, data, streams)
                    with self._lock:
                        self.stats["promotions"] += 1
                        # the promoted copy IS the lower one: evictable clean
                        self._clean[self.levels[start][0]].add(key)
                except CapacityError:
                    pass
            return data
        raise KeyError(key)

    def exists(self, key: str) -> bool:
        return any(store.exists(key) for _, store in self.levels)

    # -- near-memory offload ------------------------------------------------ #

    def offload(self, key: str, op: OffloadOp,
                protect_prefix: Optional[str] = None) -> float:
        """Run an :class:`OffloadOp` at the first capable level of the
        key's placement chain (for parity keys: the ``nam`` level — the
        DEEP-ER near-memory compute path), evicting under capacity
        pressure like any write.  ``protect_prefix`` shields a key group
        from that eviction — a checkpoint's earlier parity regions must
        not be sacrificed to place its later ones; if the level cannot
        make room without touching protected keys the ``CapacityError``
        propagates (a loud failure beats committing a silently degraded
        checkpoint).  Stacks without a capable level fall back to
        computing the op on the host and routing the result through
        :meth:`put` — byte-identical, just without the offload's
        bandwidth advantage.  Returns modelled seconds."""
        rule = self.rule_for(key)
        start = self._home_idx(rule)
        for i in range(start, len(self.levels)):
            name, store = self.levels[i]
            run = getattr(store, "offload", None)
            if run is None:
                continue
            while True:
                try:
                    t = run(key, op)
                except CapacityError:
                    if self._evict_one(i, protect=key,
                                       protect_prefix=protect_prefix):
                        continue
                    raise
                self._touch(i, key, op.nbytes)
                with self._lock:
                    self._clean[name].discard(key)
                    self.stats["offloads"] += 1
                return t
        return self.put(key, op.compute())

    # -- namespace ops ------------------------------------------------------ #

    def delete(self, key: str) -> None:
        for i, (_, store) in enumerate(self.levels):
            store.delete(key)
            self._forget(i, key)
        with self._lock:
            self._hit_log.pop(key, None)

    def keys(self) -> Iterator[str]:
        seen = set()
        for _, store in self.levels:
            seen.update(store.keys())
        yield from sorted(seen)

    def used_bytes(self) -> int:
        return sum(store.used_bytes() for _, store in self.levels)

    def capacity_bytes(self) -> int:
        return sum(store.capacity_bytes() for _, store in self.levels)

    # -- lifecycle ---------------------------------------------------------- #

    def flush(self) -> None:
        """Barrier on every level that drains asynchronously (CacheFS)."""
        for _, store in self.levels:
            flush = getattr(store, "flush", None)
            if flush is not None:
                flush()

    def close(self) -> None:
        """Idempotent: stop every level that owns background threads."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for _, store in self.levels:
            close = getattr(store, "close", None)
            if close is not None:
                close()
