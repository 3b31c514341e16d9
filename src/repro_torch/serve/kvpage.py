"""KVPager: per-stream KV page *tables* over a content-addressed pool.

Counterpart of ``repro/serve/kvpage.py``.  A parked stream's lane cache
is serialized, split into fixed-size pages, and each page is
**content-addressed**: its stack key is the hash of its bytes —

    kv/page/<digest>.bin

— so a lane is represented by a *page table* (an ordered list of
digests), and parking/resuming moves page **references**, not bytes:

* two streams whose lanes share byte-identical pages (the zero tails of
  half-filled caches, prefix-shaped regions) share one pooled copy,
  refcounted across tables (``kv_page_dedup_hits``);
* re-parking a stream whose pages did not change since its last park
  skips the re-``put`` entirely — per-page dirty tracking by content
  hash (``kv_clean_page_skips``).  A resume keeps the table as a
  non-parked *retained baseline* (``fetch(release=False)``) so those
  clean pages are still pooled when the stream parks again;
* placement stays policy: pages route through a
  :class:`~repro_torch.memory.stack.TierStack` under the ``kv/`` key
  class (admission control, demotion under pressure, hit-rate
  promotion).

The pager stays pure byte plumbing: the scheduler hands it a lane cache
(torch tensors or numpy arrays on the host) and gets it back
byte-identically on :meth:`fetch`, bfloat16 included (the checkpoint
serializer writes its 16-bit patterns).  Within one package a page's
digest is stable; across packages float KV differs in the last bits, so
page digests are never compared across packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.io.serialization import StateBlob, deserialize_state, serialize_state
from repro_torch.memory.codecs import CodecRule, make_codec
from repro_torch.memory.stack import HitRatePromotion, KeyClass, TierStack
from repro_torch.memory.tiers import CapacityError, MemoryTier, TierKind, TierSpec
from repro_torch.obs.metrics import StatsView

KV_PAGE_BYTES = 64 * 1024  # default paging granularity


def page_digest(data: bytes) -> str:
    """Content address of one KV page (the dedup/dirty-tracking unit)."""
    return hashlib.sha256(data).hexdigest()[:24]


def kv_page_key(digest: str) -> str:
    """Stack key for one pooled KV page (``kv`` key class)."""
    return f"kv/page/{digest}.bin"


@dataclasses.dataclass
class _PoolPage:
    nbytes: int
    refs: int


@dataclasses.dataclass
class _TableEntry:
    nbytes: int
    digests: List[str]
    manifest: Dict[str, Any]
    parked: bool = True     # False: a resumed stream's retained baseline


class KVPager:
    """Page per-stream KV lane caches through a TierStack.

    ``stack`` carries the ``kv/`` keys; ``page_bytes`` is the paging
    granularity (a lane cache is split into ceil(nbytes / page_bytes)
    pages so tier placement — admission, spill, promotion, demotion —
    happens per block, not per whole stream).  ``own_stack`` controls
    whether :meth:`close` also closes the stack.
    """

    def __init__(self, stack: TierStack, page_bytes: int = KV_PAGE_BYTES,
                 own_stack: bool = True):
        if page_bytes < 1:
            raise ValueError("page_bytes must be >= 1")
        self.stack = stack
        self.page_bytes = int(page_bytes)
        self._own_stack = own_stack
        self._tables: Dict[int, _TableEntry] = {}
        self._pages: Dict[str, _PoolPage] = {}
        # pager counters share the stack's registry: one snapshot spans
        # the whole KV path (tier placement + page-pool behaviour)
        self.registry = stack.registry
        self._stats = StatsView(self.registry, "kv", {
            "kv_clean_page_skips": 0, "kv_page_dedup_hits": 0,
            "kv_pages_put": 0, "kv_resume_bytes_moved": 0,
        })

    # -- construction ----------------------------------------------------- #

    @classmethod
    def for_capacity(
        cls,
        fast_bytes: int,
        slow_bytes: int = 1 << 30,
        paged: bool = True,
        admission_fraction: Optional[float] = 0.5,
        promotion: Optional[HitRatePromotion] = None,
        page_bytes: int = KV_PAGE_BYTES,
        kv_codec: Optional[str] = None,
        codec_dtype: str = "float32",
        codec_block: int = 128,
        registry=None,
    ) -> "KVPager":
        """A serving KV stack sized by its fast tier.

        ``paged=True`` builds the hierarchy ``hbm > dram > global`` (cold
        pages spill down, hot ones promote back); ``paged=False`` builds
        the flat single-tier baseline — every resident stream's cache
        must fit in the fast tier or :meth:`park` raises
        :class:`CapacityError`.

        ``kv_codec`` installs a tier codec on the ``kv`` key class
        (``"zlib"`` lossless, ``"int8"`` per-channel quantization of
        ``codec_dtype`` elements in ``codec_block``-wide channels): pages
        demoted past the fast tier encode on the way down and decode on
        read.  Content addressing stays over decoded bytes; a lossy
        codec makes :meth:`fetch` tolerance-gated instead of bit-exact
        (the manifest integrity digests are recomputed over the decoded
        bytes — see :meth:`fetch`).
        """
        def tier(kind: TierKind, cap: int, bw: float, lat: float) -> MemoryTier:
            return MemoryTier(TierSpec(kind, cap, bw, bw, lat))

        levels: List[Tuple[str, MemoryTier]] = [
            ("hbm", tier(TierKind.HBM, fast_bytes, 450e9, 1e-7))]
        if paged:
            levels.append(("dram", tier(TierKind.DRAM, slow_bytes, 80e9, 1e-7)))
            levels.append(("global", tier(TierKind.GLOBAL, 16 * slow_bytes,
                                          5e9, 5e-4)))
        codec = make_codec(kv_codec, dtype=codec_dtype, block=codec_block)
        stack = TierStack(
            levels,
            admission_fraction=admission_fraction if paged else None,
            promotion=promotion if promotion is not None
            else HitRatePromotion(k=2, window=256),
            codecs={KeyClass.KV: CodecRule(codec)} if codec else None,
            registry=registry,
        )
        return cls(stack, page_bytes=page_bytes, own_stack=True)

    @classmethod
    def for_fleet(
        cls,
        shared,
        fast_bytes: int,
        admission_fraction: Optional[float] = 0.5,
        promotion: Optional[HitRatePromotion] = None,
        page_bytes: int = KV_PAGE_BYTES,
        kv_codec: Optional[str] = None,
        codec_dtype: str = "float32",
        codec_block: int = 128,
        registry=None,
    ) -> "KVPager":
        """A fleet worker's serving KV stack: a process-private fast tier
        over a cross-process :class:`~repro_torch.memory.shared.SharedTier`
        cache domain (``hbm > shared``).  Cold pages demote into the
        shared domain, published prefix pages land there directly
        (``TierStack.put_at``), and a read that misses the fast tier
        falls through to the domain — finding pages written by *any*
        worker — and read-through-promotes them locally.  Every worker of
        a fleet passes the *same* domain (or a ``SharedTier`` over the
        same root)."""
        levels: List[Tuple[str, Any]] = [
            ("hbm", MemoryTier(TierSpec(TierKind.HBM, fast_bytes,
                                        450e9, 450e9, 1e-7))),
            ("shared", shared),
        ]
        codec = make_codec(kv_codec, dtype=codec_dtype, block=codec_block)
        stack = TierStack(
            levels,
            admission_fraction=admission_fraction,
            promotion=promotion if promotion is not None
            else HitRatePromotion(k=2, window=256),
            codecs={KeyClass.KV: CodecRule(codec)} if codec else None,
            registry=registry,
        )
        return cls(stack, page_bytes=page_bytes, own_stack=True)

    # -- paging ----------------------------------------------------------- #

    def kv_lossy(self) -> bool:
        """True when the stack's ``kv`` codec rule is lossy (int8): page
        reads are then tolerance-gated, not bit-exact, and :meth:`fetch`
        re-anchors the manifest integrity digests to the decoded bytes."""
        rule = self.stack.codec_for(KeyClass.KV)
        return rule is not None and not rule.codec.lossless

    def _page_iter(self, data: bytes) -> Iterator[bytes]:
        view = memoryview(data)
        for off in range(0, len(data), self.page_bytes):
            yield bytes(view[off:off + self.page_bytes])

    def _deref(self, digest: str) -> None:
        page = self._pages[digest]
        page.refs -= 1
        if page.refs <= 0:
            del self._pages[digest]
            self.stack.delete(kv_page_key(digest))

    def _park_pages(self, sid: int, data: bytes, manifest: Dict[str, Any]) -> int:
        """All-or-nothing: acquire/put every page of the lane or leave the
        pool exactly as it was.  Pages already pooled — shared with
        another stream, or unchanged since this stream's last park (the
        retained baseline a resume leaves behind) — are reference bumps,
        not writes."""
        return self._park_page_list(
            sid, list(self._page_iter(data)), len(data), manifest)

    def _park_page_list(self, sid: int, pages: List[bytes], nbytes: int,
                        manifest: Dict[str, Any]) -> int:
        digests = [page_digest(p) for p in pages]
        old = self._tables.get(sid)
        old_digests = set(old.digests) if old is not None else set()
        acquired: List[str] = []
        # counters commit only on success: a rolled-back park must not
        # inflate the pool-activity stats
        delta = {"kv_clean_page_skips": 0, "kv_page_dedup_hits": 0,
                 "kv_pages_put": 0}
        try:
            for digest, page in zip(digests, pages):
                pooled = self._pages.get(digest)
                if pooled is not None:
                    pooled.refs += 1
                    if digest in old_digests:
                        delta["kv_clean_page_skips"] += 1
                    else:
                        delta["kv_page_dedup_hits"] += 1
                else:
                    self.stack.put(kv_page_key(digest), page)
                    self._pages[digest] = _PoolPage(nbytes=len(page), refs=1)
                    delta["kv_pages_put"] += 1
                acquired.append(digest)
        except CapacityError:
            for digest in acquired:
                self._deref(digest)
            raise
        for key, n in delta.items():
            self._stats[key] += n
        if old is not None:
            for digest in old.digests:
                self._deref(digest)
        self._tables[sid] = _TableEntry(
            nbytes=nbytes, digests=digests, manifest=manifest)
        return nbytes

    def park(self, sid: int, lane_cache: Any) -> int:
        """Serialize one stream's lane cache and route its pages through
        the stack.  All-or-nothing: if any new page cannot be placed
        anywhere (single-tier baseline at capacity), every reference
        taken so far is dropped and the CapacityError propagates — a
        stream is either fully resident or not resident at all.

        A park is *required* state; retained dirty-tracking baselines
        (other resumed streams') are optional — under capacity pressure
        they are dropped and the park retried once, so the optimization
        can never cost residency the pre-baseline pager had.  Returns
        bytes parked (logical, before dedup)."""
        blob = serialize_state(lane_cache)
        try:
            return self._park_pages(sid, blob.data, blob.manifest)
        except CapacityError:
            if not self._drop_retained(except_sid=sid):
                raise
        try:
            return self._park_pages(sid, blob.data, blob.manifest)
        except CapacityError:
            # last resort: give up this stream's own baseline (losing
            # only the dirty-skip win — exactly the pre-baseline state)
            if not self._drop_retained(except_sid=None):
                raise
            return self._park_pages(sid, blob.data, blob.manifest)

    def _drop_retained(self, except_sid: Optional[int]) -> bool:
        """Release every retained (non-parked) baseline except
        ``except_sid``'s own; True if anything was freed."""
        victims = [sid for sid, e in self._tables.items()
                   if not e.parked and sid != except_sid]
        for sid in victims:
            self.release(sid)
        return bool(victims)

    def park_bytes(self, sid: int, blob: bytes, layout_manifest: Dict[str, Any]) -> int:
        """Re-park a stream from its already-serialized bytes (the
        checkpoint-restore path: no deserialize/re-serialize round trip).
        ``layout_manifest`` describes the lane template's leaf layout —
        identical for every lane — and the integrity digests are
        recomputed over ``blob``."""
        if len(blob) != layout_manifest["total_bytes"]:
            raise ValueError(
                f"stream {sid}: blob of {len(blob)} bytes does not match the "
                f"lane layout ({layout_manifest['total_bytes']} bytes)")
        manifest = dict(layout_manifest)
        manifest["crc32"] = zlib.crc32(blob) & 0xFFFFFFFF
        manifest["sha256"] = hashlib.sha256(blob).hexdigest()
        return self._park_pages(sid, blob, manifest)

    # -- page-granular interchange (device page-pool spill/refill) -------- #

    def park_pages(self, sid: int, blobs: List[bytes]) -> int:
        """Park a stream as caller-cut pages (the device page pool's
        spill path: each blob is one pool page's bytes, NOT a
        ``page_bytes`` slice of a serialized lane).  Same all-or-nothing,
        content-addressed, refcounted semantics as :meth:`park` — two
        streams spilling a byte-identical page (a shared prefix page, a
        zero page) pool one copy."""
        if not blobs:
            raise ValueError("nothing to park")
        nbytes = sum(len(b) for b in blobs)
        manifest = {"kind": "pool_pages", "page_lens": [len(b) for b in blobs],
                    "total_bytes": nbytes}
        try:
            return self._park_page_list(sid, list(blobs), nbytes, manifest)
        except CapacityError:
            if not self._drop_retained(except_sid=sid):
                raise
            return self._park_page_list(sid, list(blobs), nbytes, manifest)

    def fetch_pages(self, sid: int, release: bool = True,
                    promote: Optional[bool] = None) -> List[bytes]:
        """Read back a stream parked with :meth:`park_pages`, one blob
        per page, counting the moved bytes (``kv_resume_bytes_moved``)."""
        entry = self._tables.get(sid)
        if entry is None or not entry.parked:
            raise KeyError(f"stream {sid} is not parked")
        if entry.manifest.get("kind") != "pool_pages":
            raise ValueError(f"stream {sid} was not parked page-granular")
        blobs = [self.stack.get(kv_page_key(d), promote=promote)
                 for d in entry.digests]
        got = sum(len(b) for b in blobs)
        if got != entry.nbytes:
            raise IOError(
                f"stream {sid}: paged bytes {got} != parked {entry.nbytes}")
        self._stats["kv_resume_bytes_moved"] += got
        if release:
            self.release(sid)
        else:
            entry.parked = False
        return blobs

    def fetch(self, sid: int, like: Any, release: bool = True,
              promote: Optional[bool] = None) -> Any:
        """Read a parked stream's pages back through the stack (hit-rate
        promotion applies per page unless ``promote=False`` — the
        checkpoint path reads without disturbing placement) and rebuild
        the lane cache against the ``like`` template.

        ``release=True`` drops the stream's page references afterwards;
        ``release=False`` *retains* the table as a non-parked baseline:
        the stream no longer counts as parked (it is resuming into a
        slot), but its pages stay pooled so the next park re-puts only
        the pages that actually changed — this is what makes per-page
        dirty tracking fire in the quantum round-robin cycle.  Pages
        referenced by other streams stay pooled either way."""
        entry = self._tables.get(sid)
        if entry is None or not entry.parked:
            raise KeyError(f"stream {sid} is not parked")
        parts = [self.stack.get(kv_page_key(d), promote=promote)
                 for d in entry.digests]
        data = b"".join(parts)
        if len(data) != entry.nbytes:
            raise IOError(
                f"stream {sid}: paged bytes {len(data)} != parked {entry.nbytes}")
        self._stats["kv_resume_bytes_moved"] += len(data)
        manifest = entry.manifest
        if self.kv_lossy():
            # a lossy kv codec returns decoded (not original) bytes for
            # any page that spilled past the fast tier, so the park-time
            # integrity digests no longer apply — lengths and layout are
            # still exact, only the values are tolerance-gated
            manifest = dict(manifest)
            manifest["crc32"] = zlib.crc32(data) & 0xFFFFFFFF
            manifest["sha256"] = hashlib.sha256(data).hexdigest()
        lane = deserialize_state(StateBlob(data=data, manifest=manifest), like)
        if release:
            self.release(sid)
        else:
            entry.parked = False
        return lane

    def release(self, sid: int) -> None:
        """Drop one stream's table and page references (idempotent); a
        page leaves the pool — and every tier — only when its last
        reference goes."""
        entry = self._tables.pop(sid, None)
        if entry is None:
            return
        for digest in entry.digests:
            self._deref(digest)

    # -- introspection ----------------------------------------------------- #

    def parked_sids(self) -> List[int]:
        return sorted(sid for sid, e in self._tables.items() if e.parked)

    def table_sids(self) -> List[int]:
        """Every stream holding pool references: parked streams plus
        resumed streams whose retained dirty-tracking baseline is live."""
        return sorted(self._tables)

    def is_parked(self, sid: int) -> bool:
        entry = self._tables.get(sid)
        return entry is not None and entry.parked

    def page_table(self, sid: int) -> List[str]:
        """A stream's ordered page digests (its page table)."""
        entry = self._tables.get(sid)
        if entry is None:
            raise KeyError(f"stream {sid} has no page table")
        return list(entry.digests)

    def parked_nbytes(self, sid: int) -> int:
        return self._tables[sid].nbytes

    def parked_kind(self, sid: int) -> str:
        """How this stream's table was cut: ``"lane"`` (page_bytes slices
        of one serialized lane) or ``"pool_pages"`` (caller-cut device
        pool pages) — checkpoints re-park through the matching path."""
        return self._tables[sid].manifest.get("kind", "lane")

    def page_payload(self, digest: str) -> bytes:
        """One pooled page's bytes, read as a pure observer."""
        if digest not in self._pages:
            raise KeyError(digest)
        return self.stack.get(kv_page_key(digest), promote=False)

    def parked_bytes(self) -> int:
        """Logical bytes parked (sum of parked lane sizes, before dedup)."""
        return sum(e.nbytes for e in self._tables.values() if e.parked)

    def pooled_bytes(self) -> int:
        """Physical bytes pooled after dedup — what the tiers actually
        hold; ``parked_bytes() - pooled_bytes()`` is the sharing win."""
        return sum(p.nbytes for p in self._pages.values())

    def pooled_pages(self) -> int:
        return len(self._pages)

    def stats(self) -> Dict[str, int]:
        """The stack's counter snapshot (hits/misses per level,
        promotions, evictions, admission routing) merged with the pager's
        own page-pool counters (dirty-skip, dedup, puts)."""
        out = dict(self.stack.stats())
        out.update(self._stats)
        out["kv_pages_pooled"] = len(self._pages)
        return out

    def level_used(self) -> Dict[str, int]:
        return {name: store.used_bytes() for name, store in self.stack.levels}

    # -- lifecycle ---------------------------------------------------------- #

    def close(self) -> None:
        if self._own_stack:
            self.stack.close()
