"""PrefixCache: shared-prefix KV pages, content-addressed through the stack.

Counterpart of ``repro/serve/prefix.py``.  Decode streams that share a
prompt prefix — the same system prompt, the same few-shot preamble —
fetch the *same* KV pages instead of recomputing (and re-storing) them
per stream.

Structure: a radix tree over token *pages* (``page_tokens`` tokens per
node).  Each node covers tokens ``[0, end)`` of some prompt, is
content-addressed by a chain digest (parent digest + this node's
tokens — equal prefixes collide into one node regardless of which
stream, process or package inserted them), and stores its KV payload
through a :class:`~repro_torch.memory.stack.TierStack` under the ``kv/``
key class:

    kv/prefix/<chain-digest>.bin

Payload modes, chosen by the lane-cache layout (:class:`LaneLayout`):

* **slice** — every cache leaf has a ``kv_seq`` axis (attention
  caches): a node stores only its own token-range slice, and a lookup
  reassembles the prefix from the node path;
* **snapshot** — recurrent or hybrid state (rwkv WKV state, mamba SSD
  state): a node stores the *whole* lane state at its boundary; a lookup
  restores the deepest matching node only.

Refcounting: a stream *acquires* every node on its matched/inserted
path at admit and *releases* at finish.  Eviction over the byte budget
is cost-aware — the victim is the zero-reference leaf maximizing
``age * bytes / recompute_cost`` (recompute cost proxied by
``node.end``) — with an optional ``ttl_ticks`` expiry; interior nodes and
nodes held by a live stream are never candidates.

Lanes and payloads are host pytrees of torch tensors or numpy arrays; a
payload is the serializer's blob of its pytree, the reference's layout.
"""

from __future__ import annotations

import dataclasses
import hashlib
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.io.serialization import (StateBlob, _flatten, _unflatten,
                                          deserialize_state, serialize_state)
from repro_torch.memory.stack import KeyClass, TierStack
from repro_torch.memory.tiers import CapacityError


def prefix_page_key(digest: str) -> str:
    """Stack key for one prefix node's payload (``kv`` key class)."""
    return f"kv/prefix/{digest}.bin"


def chain_digest(parent_digest: str, tokens: Sequence[int]) -> str:
    """Content address of a prefix node: hash of the parent's digest and
    this node's token chunk — equal token prefixes produce equal chains
    no matter which stream (or process) inserted them."""
    h = hashlib.sha256()
    h.update(parent_digest.encode())
    h.update(np.asarray(list(tokens), np.int64).tobytes())
    return h.hexdigest()[:24]


def _copy(leaf: Any) -> Any:
    return leaf.clone() if isinstance(leaf, torch.Tensor) else np.array(leaf)


def _assign(dst: Any, src: Any) -> None:
    """Write ``src`` into the mutable host leaf ``dst`` in place."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(torch.as_tensor(src))
    else:
        dst[...] = src


class LaneLayout:
    """Token-slicing view over one decode lane's cache pytree.

    Built from the model's cache template (host torch tensors or numpy
    arrays) and its logical axes (``model.cache_axes``): leaves whose
    axes name ``kv_seq`` can be sliced per token range; if *every* leaf
    can, the layout supports slice-mode prefix pages, otherwise snapshot
    mode.
    """

    def __init__(self, template: Any, axes: Any):
        pairs, _ = _flatten(template)
        self.template = template
        self.template_leaves = [leaf for _, leaf in pairs]
        axes_leaves = [_axes_at(axes, path) for path, _ in pairs]
        self.seq_axes: List[Optional[int]] = [
            ax.index("kv_seq") if "kv_seq" in ax else None for ax in axes_leaves]
        self.sliceable = all(a is not None for a in self.seq_axes)

    @classmethod
    def for_model(cls, cfg, model, max_len: int) -> "LaneLayout":
        template = model.init_cache(cfg, 1, max_len, device="cpu")
        return cls(template, model.cache_axes(cfg, 1, max_len))

    def unflatten(self, leaves: List[Any]) -> Any:
        return _unflatten(self.template, iter(leaves))

    def leaves(self, lane: Any) -> List[Any]:
        return [leaf for _, leaf in _flatten(lane)[0]]

    def zero_lane(self) -> Any:
        """A fresh host-side lane (mutable copies of the template)."""
        return self.unflatten([_copy(l) for l in self.template_leaves])

    def _index(self, leaf_i: int, t0: int, t1: int) -> Tuple:
        ax = self.seq_axes[leaf_i]
        idx = [slice(None)] * self.template_leaves[leaf_i].ndim
        idx[ax] = slice(t0, t1)
        return tuple(idx)

    def extract(self, lane: Any, t0: int, t1: int) -> Any:
        """The ``[t0, t1)`` token slice of every leaf (host copies)."""
        assert self.sliceable
        return self.unflatten([_copy(l[self._index(i, t0, t1)])
                               for i, l in enumerate(self.leaves(lane))])

    def inject(self, lane: Any, part: Any, t0: int, t1: int) -> None:
        """Write a token slice back into a mutable host lane in place."""
        assert self.sliceable
        for i, (l, p) in enumerate(zip(self.leaves(lane), self.leaves(part))):
            _assign(l[self._index(i, t0, t1)], p)


def _axes_at(axes: Any, path: Tuple) -> Tuple:
    """The axes tuple at one leaf's key path of an axes tree."""
    node = axes
    for _, k in path:
        node = node[k]
    return tuple(node)


@dataclasses.dataclass
class _Node:
    digest: str
    parent: Optional["_Node"]
    chunk: Tuple[int, ...]
    end: int                        # tokens [0, end) covered by this path
    nbytes: int
    crc32: int = 0                  # insert-time payload digest (integrity)
    refs: int = 0                   # live stream references
    last_used: int = 0              # cache clock, for LRU eviction
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict)


class PrefixCache:
    """Radix cache of shared-prefix KV pages over a TierStack.

    ``stack`` carries the payloads (typically the serving
    :class:`~repro_torch.serve.kvpage.KVPager`'s stack, so prefix pages and
    parked pages share one placement policy); ``layout`` describes the
    lane cache; ``page_tokens`` is the trie fan-out granularity;
    ``capacity_bytes`` bounds the cached payload bytes (``None`` =
    unbounded — the stack's own eviction still applies *placement*
    pressure, this budget bounds the *namespace*).
    """

    def __init__(self, stack: TierStack, layout: LaneLayout,
                 page_tokens: int = 8,
                 capacity_bytes: Optional[int] = None,
                 ttl_ticks: Optional[int] = None):
        if page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        if ttl_ticks is not None and ttl_ticks < 1:
            raise ValueError("ttl_ticks must be >= 1")
        self.stack = stack
        self.layout = layout
        self.page_tokens = int(page_tokens)
        self.capacity_bytes = capacity_bytes
        self.ttl_ticks = ttl_ticks
        self.mode = "slice" if layout.sliceable else "snapshot"
        self._root: Dict[Tuple[int, ...], _Node] = {}
        self._nodes: Dict[str, _Node] = {}
        self._stream_refs: Dict[int, List[str]] = {}
        self._clock = 0
        # notifier for pool-resident copies (serve/pagepool.py): called
        # with the digest whenever a node leaves the trie, so the device
        # page pool can release its pinned physical page
        self.on_evict: Optional[Any] = None
        self.stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "tokens_reused": 0, "pages_inserted": 0,
            "pages_evicted": 0, "insert_rejected": 0, "bytes_cached": 0,
            "tail_hits": 0, "tail_tokens_reused": 0, "tail_pages_inserted": 0,
            "nodes_adopted": 0,
        }
        if self.mode == "slice":
            part = layout.extract(layout.zero_lane(), 0, self.page_tokens)
            self._part_template = part
            self._part_manifest = serialize_state(part).manifest
        else:
            self._part_template = None
            self._part_manifest = serialize_state(layout.template).manifest
        # per-token-count (template, manifest) for partial-page tails
        self._tail_like: Dict[int, Tuple[Any, Dict[str, Any]]] = {}

    # default trie budget for for_model: enough for many distinct shared
    # prefixes, small enough that a long-running server cannot grow the
    # namespace (and the bottom tier) without bound — the trie-level LRU
    # eviction is live by default, not dead code behind an opt-in
    DEFAULT_CAPACITY_BYTES = 64 << 20

    @classmethod
    def for_model(cls, stack: TierStack, cfg, model, max_len: int,
                  page_tokens: int = 8,
                  capacity_bytes: Optional[int] = DEFAULT_CAPACITY_BYTES,
                  ttl_ticks: Optional[int] = None,
                  ) -> "PrefixCache":
        return cls(stack, LaneLayout.for_model(cfg, model, max_len),
                   page_tokens=page_tokens, capacity_bytes=capacity_bytes,
                   ttl_ticks=ttl_ticks)

    # -- lookup ------------------------------------------------------------ #

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[_Node]]:
        """Longest cached full-page prefix of ``tokens``: returns the
        covered token count and the node path (empty on a miss)."""
        tokens = [int(t) for t in tokens]
        pt = self.page_tokens
        path: List[_Node] = []
        level = self._root
        for j in range(len(tokens) // pt):
            chunk = tuple(tokens[j * pt:(j + 1) * pt])
            node = level.get(chunk)
            if node is None:
                break
            path.append(node)
            level = node.children
        self._clock += 1
        for node in path:
            node.last_used = self._clock
        if path:
            self.stats["hits"] += 1
        else:
            self.stats["misses"] += 1
        return (path[-1].end if path else 0), path

    def fetch_into(self, path: List[_Node], lane: Any) -> int:
        """Materialize a matched path into a mutable host lane: slice mode
        injects every node's token range, snapshot mode restores the
        deepest *fetchable* node's state (one read — the intermediate
        snapshots are never needed, and reading them would both waste a
        full lane's bytes per node and push never-used payloads toward
        promotion).  Reads go through the stack with default promotion —
        THIS is the reuse that lets hit-rate promotion earn fast-tier
        residency for shared pages.  Returns the tokens covered (may be
        shorter than the match if a payload vanished under extreme stack
        pressure — the path is then pruned and the remainder is simply
        recomputed by prefill)."""
        covered = 0
        if self.mode == "snapshot":
            for node in reversed(path):
                try:
                    data = self.stack.get(prefix_page_key(node.digest))
                except (KeyError, IOError):
                    self._drop_subtree(node)
                    continue
                part = self._deserialize(data, node)
                for dst, src in zip(self.layout.leaves(lane),
                                    self.layout.leaves(part)):
                    _assign(dst, src)
                covered = node.end
                break
        else:
            for node in path:
                try:
                    data = self.stack.get(prefix_page_key(node.digest))
                except (KeyError, IOError):
                    self._drop_subtree(node)
                    break
                self.layout.inject(lane, self._deserialize(data, node),
                                   node.end - len(node.chunk), node.end)
                covered = node.end
        self.stats["tokens_reused"] += covered
        return covered

    def _kv_lossy(self) -> bool:
        """True when the stack's ``kv`` codec changes bytes (e.g. int8):
        a payload demoted past the fast level then decodes to *different*
        bytes than were inserted, by design."""
        rule = self.stack.codec_for(KeyClass.KV)
        return rule is not None and not rule.codec.lossless

    def _deserialize(self, data: bytes, node: _Node) -> Any:
        # the manifest carries the INSERT-time crc, so the integrity
        # check inside deserialize_state actually detects a payload
        # corrupted between insert and fetch (recomputing it here from
        # the fetched bytes would make the check tautological).  Under a
        # LOSSY kv codec that check cannot hold: a demoted payload
        # legitimately decodes to different bytes, so — exactly as
        # KVPager.fetch re-anchors parked-page manifests — the crc is
        # recomputed over the fetched bytes and integrity is tolerance-
        # gated instead (without this, every demotion under an int8
        # codec silently dropped the subtree and sharing was lost)
        if self.mode == "slice" and len(node.chunk) != self.page_tokens:
            like, base_manifest = self._tail_template(len(node.chunk))
        elif self.mode == "slice":
            like, base_manifest = self._part_template, self._part_manifest
        else:
            like, base_manifest = self.layout.template, self._part_manifest
        manifest = dict(base_manifest)
        manifest["crc32"] = (zlib.crc32(data) & 0xFFFFFFFF
                             if self._kv_lossy() else node.crc32)
        return deserialize_state(StateBlob(data=data, manifest=manifest), like)

    def _tail_template(self, m: int) -> Tuple[Any, Dict[str, Any]]:
        """(template pytree, manifest) for an ``m``-token partial page."""
        cached = self._tail_like.get(m)
        if cached is None:
            part = self.layout.extract(self.layout.zero_lane(), 0, m)
            cached = (part, serialize_state(part).manifest)
            self._tail_like[m] = cached
        return cached

    # -- insertion --------------------------------------------------------- #

    def extend(self, tokens: Sequence[int], upto: int, lane: Any,
               sid: Optional[int] = None,
               payload_fn: Optional[Any] = None) -> List[_Node]:
        """Register pages covering ``tokens[:upto]`` (``upto`` a multiple
        of ``page_tokens``) from a lane holding KV for at least that
        range.  Existing path nodes are reused; missing ones are created
        with payloads cut from ``lane`` (slice mode) or — snapshot mode —
        only the *deepest* new boundary gets the lane snapshot (callers
        extend page-by-page during prefill so every boundary is captured
        with the state *at* that boundary).  ``sid`` acquires the whole
        path for that stream *before* the eviction sweep runs — a freshly
        inserted page must never be evicted out from under its inserter.
        ``payload_fn(end)`` — for callers whose KV never exists as a
        contiguous lane (the device page pool) — returns the slice-mode
        part pytree for the page ending at ``end`` instead of cutting it
        from ``lane``.  Returns the full node path."""
        tokens = [int(t) for t in tokens]
        pt = self.page_tokens
        assert upto % pt == 0 and upto <= len(tokens)
        path: List[_Node] = []
        level = self._root
        parent: Optional[_Node] = None
        self._clock += 1
        for j in range(upto // pt):
            chunk = tuple(tokens[j * pt:(j + 1) * pt])
            node = level.get(chunk)
            if node is None:
                end = (j + 1) * pt
                if self.mode == "snapshot" and end != upto:
                    # no state for an intermediate boundary in hand; the
                    # page-by-page extend during prefill fills these in
                    break
                if payload_fn is not None:
                    blob = serialize_state(payload_fn(end))
                    payload, crc = blob.data, int(blob.manifest["crc32"])
                else:
                    payload, crc = self._payload(lane, end)
                digest = chain_digest(parent.digest if parent else "", chunk)
                try:
                    self.stack.put(prefix_page_key(digest), payload)
                except CapacityError:
                    self.stats["insert_rejected"] += 1
                    break
                node = _Node(digest=digest, parent=parent, chunk=chunk,
                             end=end, nbytes=len(payload), crc32=crc)
                level[chunk] = node
                self._nodes[digest] = node
                self.stats["pages_inserted"] += 1
                self.stats["bytes_cached"] += node.nbytes
            node.last_used = self._clock
            path.append(node)
            parent, level = node, node.children
        if sid is not None:
            self.acquire(sid, path)
        self._maybe_evict()
        return path

    # -- partial-page tails -------------------------------------------------- #
    #
    # A prefix only dedups whole pages through `match`/`extend`, so two
    # prompts sharing (say) a 6-token system preamble under page_tokens=8
    # shared *nothing*.  Tail nodes fix that: the last, partially-filled
    # page of a prompt is registered as a node whose chunk is shorter
    # than page_tokens, living in the same children dict as full pages
    # (chunk length disambiguates — full chunks are exactly page_tokens).
    # Tails are slice-mode only (a snapshot at a non-boundary is a whole
    # lane per prompt length — not worth caching), are always leaves
    # (children attach only under full pages), and save *compute*, not
    # physical pages: the pool path copies a tail into the stream's own
    # fresh page, since the rest of that page is stream-private.

    def match_tail(self, tokens: Sequence[int], covered: int,
                   path: List[_Node]) -> Optional[_Node]:
        """Longest registered tail extending a full-page match: a tail
        under ``path[-1]`` (or the root) whose chunk is a prefix of
        ``tokens[covered:]``.  KV for positions ``[covered, tail.end)``
        depends only on ``tokens[:tail.end]``, so any stream agreeing on
        those tokens can reuse the slice — even with a longer prompt."""
        if self.mode != "slice":
            return None
        pt = self.page_tokens
        rest = [int(t) for t in tokens[covered:]]
        if not rest:
            return None
        level = path[-1].children if path else self._root
        best: Optional[_Node] = None
        for chunk, node in level.items():
            if len(chunk) >= pt or len(chunk) > len(rest):
                continue
            if chunk == tuple(rest[:len(chunk)]):
                if best is None or node.end > best.end:
                    best = node
        if best is not None:
            self._clock += 1
            best.last_used = self._clock
            self.stats["tail_hits"] += 1
            self.stats["tail_tokens_reused"] += len(best.chunk)
        return best

    def register_tail(self, tokens: Sequence[int], upto: int, lane: Any,
                      sid: Optional[int] = None,
                      payload_fn: Optional[Any] = None) -> Optional[_Node]:
        """Register the partially-filled last page of ``tokens[:upto]``
        (the ``upto % page_tokens`` remainder past the last full-page
        boundary) as a tail node.  Requires the full-page path up to
        that boundary to already exist (``extend`` runs first); returns
        the tail node, or None when there is no remainder, the ancestors
        are missing, or the mode is snapshot."""
        if self.mode != "slice":
            return None
        tokens = [int(t) for t in tokens]
        pt = self.page_tokens
        base = (upto // pt) * pt
        if upto - base == 0 or upto > len(tokens):
            return None
        path: List[_Node] = []
        level = self._root
        parent: Optional[_Node] = None
        for j in range(base // pt):
            node = level.get(tuple(tokens[j * pt:(j + 1) * pt]))
            if node is None:
                return None
            path.append(node)
            parent, level = node, node.children
        chunk = tuple(tokens[base:upto])
        self._clock += 1
        node = level.get(chunk)
        if node is None:
            if payload_fn is not None:
                blob = serialize_state(payload_fn(upto))
                payload, crc = blob.data, int(blob.manifest["crc32"])
            else:
                blob = serialize_state(self.layout.extract(lane, base, upto))
                payload, crc = blob.data, int(blob.manifest["crc32"])
            digest = chain_digest(parent.digest if parent else "", chunk)
            try:
                self.stack.put(prefix_page_key(digest), payload)
            except CapacityError:
                self.stats["insert_rejected"] += 1
                return None
            node = _Node(digest=digest, parent=parent, chunk=chunk,
                         end=upto, nbytes=len(payload), crc32=crc)
            level[chunk] = node
            self._nodes[digest] = node
            self.stats["tail_pages_inserted"] += 1
            self.stats["bytes_cached"] += node.nbytes
        node.last_used = self._clock
        if sid is not None:
            self.acquire(sid, [node])
        self._maybe_evict()
        return node

    def _payload(self, lane: Any, end: int) -> Tuple[bytes, int]:
        if self.mode == "slice":
            blob = serialize_state(
                self.layout.extract(lane, end - self.page_tokens, end))
        else:
            blob = serialize_state(lane)
        return blob.data, int(blob.manifest["crc32"])

    def read_node_part(self, node: _Node) -> Any:
        """One node's payload as its part pytree (slice mode) — the
        device page pool's load path when a prefix page lost pool
        residency.  Raises KeyError/IOError like the fetch path if the
        payload vanished under stack pressure; the caller prunes via
        :meth:`match` on its next lookup."""
        data = self.stack.get(prefix_page_key(node.digest))
        return self._deserialize(data, node)

    # -- stream references -------------------------------------------------- #

    def acquire(self, sid: int, path: List[_Node]) -> None:
        """A stream holds its prefix path from admit to finish: a page
        shared with a live stream is never an eviction candidate.
        Idempotent per (stream, node) — the page-by-page extend loop and
        the match+extend pair may both present the same node, and
        ``refs`` must stay 'number of live streams holding this page'."""
        held = self._stream_refs.setdefault(sid, [])
        for node in path:
            if node.digest in held:
                continue
            node.refs += 1
            held.append(node.digest)

    def release_stream(self, sid: int) -> None:
        """Drop one stream's references (idempotent).  The pages stay
        cached — that is the point — but become evictable once no live
        stream holds them."""
        for digest in self._stream_refs.pop(sid, []):
            node = self._nodes.get(digest)
            if node is not None:
                node.refs = max(0, node.refs - 1)

    def stream_refs(self) -> Dict[int, List[str]]:
        """Live stream -> held node digests (checkpoint meta)."""
        return {sid: list(ds) for sid, ds in self._stream_refs.items() if ds}

    # -- eviction ------------------------------------------------------------ #

    def _evict_score(self, node: _Node) -> float:
        """Cost-aware victim ranking (higher = evict sooner): stale,
        byte-heavy, cheap-to-recompute pages go first.  Recompute cost is
        proxied by ``node.end`` — the prefill tokens needed to rebuild
        this page's KV from an empty lane (every ancestor page must be
        recomputed before it)."""
        age = (self._clock - node.last_used) + 1
        return age * node.nbytes / max(node.end, 1)

    def _maybe_evict(self) -> None:
        if self.ttl_ticks is not None:
            expired = [n for n in self._nodes.values()
                       if not n.children and n.refs == 0
                       and self._clock - n.last_used > self.ttl_ticks]
            for node in expired:
                if node.digest in self._nodes:   # not dropped via a parent
                    self._drop_node(node)
        if self.capacity_bytes is None:
            return
        while self.stats["bytes_cached"] > self.capacity_bytes:
            victim = None
            best = -1.0
            for node in self._nodes.values():
                if node.children or node.refs > 0:
                    continue
                score = self._evict_score(node)
                if score > best:
                    best, victim = score, node
            if victim is None:
                return      # everything left is referenced or interior
            self._drop_node(victim)

    def _drop_node(self, node: _Node) -> None:
        assert not node.children
        self.stack.delete(prefix_page_key(node.digest))
        (node.parent.children if node.parent else self._root).pop(
            node.chunk, None)
        self._nodes.pop(node.digest, None)
        if node.refs:
            # force-dropped under live references (payload vanished):
            # purge the digest from every holder, or a later re-insert of
            # the same content — same chain digest — would absorb their
            # releases and become evictable under a live stream
            for held in self._stream_refs.values():
                if node.digest in held:
                    held.remove(node.digest)
        self.stats["bytes_cached"] -= node.nbytes
        self.stats["pages_evicted"] += 1
        if self.on_evict is not None:
            self.on_evict(node.digest)

    def _drop_subtree(self, node: _Node) -> None:
        for child in list(node.children.values()):
            self._drop_subtree(child)
        self._drop_node(node)

    # -- introspection ------------------------------------------------------- #

    def __len__(self) -> int:
        return len(self._nodes)

    def node(self, digest: str) -> Optional[_Node]:
        return self._nodes.get(digest)

    def cached_bytes(self) -> int:
        return self.stats["bytes_cached"]

    # -- publish / subscribe ------------------------------------------------ #

    def export_records(self) -> List[Dict[str, Any]]:
        """Node records only (no payload reads), parents before children —
        the publish half of cross-process trie sharing.  Chain digests are
        process-independent, so a record plus its payload bytes is enough
        for any peer to adopt the node."""
        return [{
            "digest": node.digest,
            "parent": node.parent.digest if node.parent else "",
            "chunk": list(node.chunk),
            "end": node.end,
            "nbytes": node.nbytes,
            "crc32": node.crc32,
        } for node in sorted(self._nodes.values(), key=lambda n: n.end)]

    def adopt_nodes(self, records: List[Dict[str, Any]]) -> int:
        """Merge peer-published node records into this trie WITHOUT
        putting payloads — the subscribe half.  The payload is expected
        to be readable through the stack (a shared level holds it); the
        first fetch read-through-promotes it into this process's fast
        tier.  Records whose parent is unknown here are skipped (the
        publisher emits parents first, so a full feed never orphans);
        records colliding with an existing chunk are skipped (same
        content ⇒ same chain digest ⇒ already present).  Returns the
        number of nodes adopted."""
        adopted = 0
        for rec in records:
            digest = rec["digest"]
            if digest in self._nodes:
                continue
            parent: Optional[_Node] = None
            if rec["parent"]:
                parent = self._nodes.get(rec["parent"])
                if parent is None:
                    continue
            chunk = tuple(int(t) for t in rec["chunk"])
            level = parent.children if parent else self._root
            if chunk in level:
                continue
            node = _Node(digest=digest, parent=parent, chunk=chunk,
                         end=int(rec["end"]), nbytes=int(rec["nbytes"]),
                         crc32=int(rec["crc32"]), last_used=self._clock)
            level[chunk] = node
            self._nodes[digest] = node
            self.stats["bytes_cached"] += node.nbytes
            self.stats["nodes_adopted"] += 1
            adopted += 1
        if adopted:
            self._maybe_evict()
        return adopted

    # -- checkpoint / restore ------------------------------------------------ #

    def export_nodes(self) -> Tuple[List[Dict[str, Any]], List[bytes]]:
        """The trie as (node records, payload bytes) — parents before
        children, payloads read as pure observers (the checkpoint path
        must not disturb placement or the hit windows).  A node whose
        payload vanished under extreme stack pressure is pruned, exactly
        as on the fetch path — a checkpoint must not fail because a
        cache entry did."""
        records: List[Dict[str, Any]] = []
        payloads: List[bytes] = []
        for node in sorted(self._nodes.values(), key=lambda n: n.end):
            if node.digest not in self._nodes:
                continue    # removed with an ancestor pruned below
            try:
                payload = self.stack.get(prefix_page_key(node.digest),
                                         promote=False)
            except (KeyError, IOError):
                self._drop_subtree(node)
                continue
            records.append({
                "digest": node.digest,
                "parent": node.parent.digest if node.parent else "",
                "chunk": list(node.chunk),
                "end": node.end,
                "nbytes": node.nbytes,
                "crc32": node.crc32,
            })
            payloads.append(payload)
        return records, payloads

    def restore_nodes(self, records: List[Dict[str, Any]],
                      payloads: List[bytes],
                      stream_refs: Dict[int, List[str]]) -> None:
        """Rebuild the trie (and re-put every payload through the stack)
        from a checkpoint export; stream references are re-acquired so
        the restored scheduler's refcounts match the saved ones."""
        self.clear()
        for rec, payload in zip(records, payloads):
            parent = self._nodes.get(rec["parent"]) if rec["parent"] else None
            chunk = tuple(int(t) for t in rec["chunk"])
            self.stack.put(prefix_page_key(rec["digest"]), payload)
            node = _Node(digest=rec["digest"], parent=parent, chunk=chunk,
                         end=int(rec["end"]), nbytes=int(rec["nbytes"]),
                         crc32=int(rec.get("crc32",
                                           zlib.crc32(payload) & 0xFFFFFFFF)))
            (parent.children if parent else self._root)[chunk] = node
            self._nodes[node.digest] = node
            self.stats["bytes_cached"] += node.nbytes
        for sid, digests in stream_refs.items():
            held = self._stream_refs.setdefault(int(sid), [])
            for digest in digests:
                node = self._nodes.get(digest)
                if node is not None:
                    node.refs += 1
                    held.append(digest)

    def clear(self) -> None:
        for digest in list(self._nodes):
            self.stack.delete(prefix_page_key(digest))
        self._root.clear()
        self._nodes.clear()
        self._stream_refs.clear()
        self.stats["bytes_cached"] = 0
