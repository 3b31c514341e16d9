"""The port's page I/O, KV pager and prefix cache against the reference.

The data here is written, not computed, so the bytes are comparable
across packages: the same numpy values go into both, and every page
blob, page digest, payload, CRC and chain digest must be equal.

* the page pool's I/O (page blobs, token slices and ranges, blob
  reinterpretation) at float32, bfloat16 and int8 residency;
* the sequence core of ``tests/test_pagepool_prop.py`` (its ``Harness``)
  driven against the port with its seeds, in lockstep with the
  reference's: allocator, pager and page bytes after every operation;
* the sequence core of ``tests/test_prefix_prop.py`` the same way;
* the pager tests of ``tests/test_serve_sched.py`` and the prefix-cache
  tests of ``tests/test_prefix_cache.py``, on the port.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.memory.stack import TierStack as JStack
from repro.memory.tiers import CapacityError as JCapacityError
from repro.memory.tiers import MemoryTier as JMemoryTier
from repro.memory.tiers import TierKind as JTierKind
from repro.memory.tiers import TierSpec as JTierSpec
from repro.serve import kvpage as jkv
from repro.serve import pagepool as jpp
from repro.serve import prefix as jpx
from repro_torch.io.serialization import serialize_state
from repro_torch.memory.stack import TierStack
from repro_torch.memory.tiers import CapacityError, MemoryTier, TierKind, TierSpec
from repro_torch.serve import kvpage as tkv
from repro_torch.serve import pagepool as tpp
from repro_torch.serve import prefix as tpx
from repro_torch.serve.kvpage import KVPager
from repro_torch.serve.pagepool import TRASH_PAGE
from repro_torch.serve.prefix import LaneLayout, PrefixCache, prefix_page_key


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tensors here are tiny, and the suite runs
    several workers on the same cores, where a spinning thread pool per
    worker made these tests ~50x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_torch(x):
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def raw(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    return np.asarray(x).tobytes()


def same_tree(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert raw(a[k]) == raw(b[k]), k


def test_digests_and_keys_match_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 4096):
        data = rng.bytes(n)
        assert tkv.page_digest(data) == jkv.page_digest(data)
        d = tkv.page_digest(data)
        assert tkv.kv_page_key(d) == jkv.kv_page_key(d)
        assert tpx.prefix_page_key(d) == jpx.prefix_page_key(d)
    for toks in ([], [1], [5, 9, 2, 7]):
        assert tpx.chain_digest("ab", toks) == jpx.chain_digest("ab", toks)


# ---------------------------------------------------------------------- #
# page pool I/O
# ---------------------------------------------------------------------- #


def pools(dtype, quantized, n_pages=5, pt=4, max_len=8):
    shape = (2, 1, max_len, 3, 8)
    axes = {n: ("layers", "batch", "kv_seq", "heads", "head_dim")
            for n in ("k", "v")}
    jt = {n: jnp.zeros(shape, dtype) for n in axes}
    tt = {n: to_torch(np.zeros(shape, dtype)) for n in axes}
    return (jpp.DevicePagePool(jt, axes, pt, n_pages, quantized=quantized),
            tpp.DevicePagePool(tt, axes, pt, n_pages, quantized=quantized,
                               device="cpu"))


@pytest.mark.parametrize("dtype,quantized", [
    (np.float32, False), (ml_dtypes.bfloat16, False), (np.float32, True)],
    ids=["f32", "bf16", "int8"])
def test_page_io_bytes_match_reference(dtype, quantized):
    jp, tp = pools(dtype, quantized)
    rng = np.random.default_rng(3)
    shape = (2, 4, 3, 8)
    for phys in (1, 3):
        page = {n: rng.standard_normal(shape).astype(dtype) for n in ("k", "v")}
        jp.write_page(phys, page)
        tp.write_page(phys, {n: to_torch(a) for n, a in page.items()})
        assert tp.page_blob(phys) == jp.page_blob(phys)
        same_tree(tp.read_page(phys), jp.read_page(phys))
    assert len(tp.page_blob(1)) == tp.page_nbytes == jp.page_nbytes
    assert tp.page_device_nbytes == jp.page_device_nbytes
    # a blob moved to another slot, and reinterpreted without the device
    blob = jp.page_blob(1)
    jp.write_blob(2, blob)
    tp.write_blob(2, blob)
    assert tp.page_blob(2) == jp.page_blob(2)
    same_tree(tp.blob_to_token_slice(blob), jp.blob_to_token_slice(blob))
    same_tree(tp.read_token_slice(3), jp.read_token_slice(3))
    # a partial-page tail: the first 3 tokens of slot 3 into slot 4
    jp.write_token_range(4, jp.read_token_range(3, 3), 3)
    tp.write_token_range(4, tp.read_token_range(3, 3), 3)
    same_tree(tp.read_token_range(4, 3), jp.read_token_range(4, 3))
    jp.write_token_slice(5, jp.read_token_slice(4))
    tp.write_token_slice(5, tp.read_token_slice(4))
    snap_j, snap_t = jp.snapshot(), tp.snapshot()
    same_tree(snap_t, snap_j)
    with pytest.raises(ValueError):
        tp.write_blob(1, blob[:-1])
    with pytest.raises(ValueError):
        tp.read_token_range(1, 0)


# ---------------------------------------------------------------------- #
# the page-pool property core (tests/test_pagepool_prop.py's Harness)
# ---------------------------------------------------------------------- #

N_PAGES, PAGE_TOKENS, MAX_LEN = 10, 2, 8
PAGES_PER_LANE = MAX_LEN // PAGE_TOKENS
DIGESTS = ["dA", "dB", "dC"]
LANE_SHAPE = (2, 1, MAX_LEN, 2, 3)


class PoolHarness:
    """The reference harness's operations over one package's pool and
    pager, with each new page filled with values drawn from the stream
    id, so page bytes are comparable across packages."""

    def __init__(self, jax_side):
        self.jax = jax_side
        self.pool = self._pool()
        self.pager = (jkv.KVPager if jax_side else KVPager).for_capacity(
            fast_bytes=10**8, page_bytes=256)
        self.err = JCapacityError if jax_side else CapacityError
        self.tables, self.spilled, self.bound, self.next_sid = {}, set(), {}, 0

    def _pool(self):
        axes = {n: ("layers", "batch", "kv_seq", "heads", "head_dim")
                for n in ("k", "v")}
        if self.jax:
            tmpl = {n: np.zeros(LANE_SHAPE, np.float32) for n in axes}
            return jpp.DevicePagePool(tmpl, axes, PAGE_TOKENS, N_PAGES)
        tmpl = {n: torch.zeros(LANE_SHAPE) for n in axes}
        return tpp.DevicePagePool(tmpl, axes, PAGE_TOKENS, N_PAGES,
                                  device="cpu")

    def _fill(self, phys, seed):
        rng = np.random.default_rng(seed)
        page = {n: rng.standard_normal((2, PAGE_TOKENS, 2, 3)).astype(np.float32)
                for n in ("k", "v")}
        self.pool.write_page(phys, page if self.jax else
                             {n: torch.from_numpy(a) for n, a in page.items()})

    def admit(self, share_digest):
        sid, self.next_sid = self.next_sid, self.next_sid + 1
        table = []
        try:
            if share_digest is not None and share_digest in self.bound:
                phys = self.bound[share_digest]
                self.pool.ref(phys)
                table.append(phys)
            fresh = self.pool.alloc(PAGES_PER_LANE - len(table))
        except self.err:
            for phys in table:
                self.pool.deref(phys)
            return
        for j, phys in enumerate(fresh):
            self._fill(phys, 1000 * sid + j)
        self.tables[sid] = table + fresh

    def bind(self, digest):
        if digest in self.bound:
            return
        try:
            phys = self.pool.alloc(1)[0]
        except self.err:
            return
        self._fill(phys, DIGESTS.index(digest))
        self.pool.bind_digest(digest, phys)
        self.pool.deref(phys)
        self.bound[digest] = phys

    def drop(self, digest):
        if digest in self.bound:
            self.pool.drop_digest(digest)
            del self.bound[digest]

    def spill(self, pick):
        if not self.tables:
            return
        sid = sorted(self.tables)[pick % len(self.tables)]
        table = self.tables.pop(sid)
        self.pager.park_pages(sid, [self.pool.page_blob(p) for p in table])
        for phys in table:
            self.pool.deref(phys)
        self.spilled.add(sid)

    def resume(self, pick):
        if not self.spilled:
            return
        sid = sorted(self.spilled)[pick % len(self.spilled)]
        try:
            phys = self.pool.alloc(PAGES_PER_LANE)
        except self.err:
            return
        blobs = self.pager.fetch_pages(sid, release=True)
        assert len(blobs) == PAGES_PER_LANE
        for p, b in zip(phys, blobs):
            self.pool.write_blob(p, b)
        self.spilled.remove(sid)
        self.tables[sid] = phys

    def finish(self, pick):
        if not self.tables:
            return
        sid = sorted(self.tables)[pick % len(self.tables)]
        for phys in self.tables.pop(sid):
            self.pool.deref(phys)

    def kill(self):
        arrays = self.pool.snapshot()
        refs = self.pool.refcounts()
        digests = self.pool.resident_digests()
        fresh = self._pool()
        fresh.load(arrays, refs, digests)
        assert fresh.refcounts() == refs
        assert fresh.resident_digests() == digests
        assert fresh.free_pages() == self.pool.free_pages()
        self.pool = fresh

    def check(self):
        pool = self.pool
        assert pool.free_pages() + pool.used_pages() == N_PAGES
        assert pool.refcount(TRASH_PAGE) == 0
        want = {}
        for table in self.tables.values():
            for phys in table:
                want[phys] = want.get(phys, 0) + 1
        for phys in self.bound.values():
            want[phys] = want.get(phys, 0) + 1
        assert pool.refcounts() == want
        assert self.pager.pooled_bytes() <= self.pager.parked_bytes()

    def drain(self):
        for _ in range(len(self.tables)):
            self.finish(0)
        for digest in list(self.bound):
            self.drop(digest)
        for sid in list(self.spilled):
            self.pager.release(sid)
            self.spilled.remove(sid)
        assert self.pool.used_pages() == 0
        assert self.pool.free_pages() == N_PAGES
        assert self.pager.pooled_bytes() == 0


def pool_state(h):
    return (h.pool.refcounts(), list(h.pool._free), h.pool.resident_digests(),
            h.tables, sorted(h.spilled), h.pager.parked_sids(),
            {sid: h.pager.page_table(sid) for sid in h.pager.parked_sids()},
            h.pager.pooled_bytes(), {s: [h.pool.page_blob(p) for p in t]
                                     for s, t in h.tables.items()})


def run_pool_sequence(ops):
    hs = [PoolHarness(jax_side=True), PoolHarness(jax_side=False)]
    for code, arg in ops:
        for h in hs:
            if code == 0:
                h.admit(share_digest=DIGESTS[arg % len(DIGESTS)]
                        if arg % 2 else None)
            elif code == 1:
                h.bind(DIGESTS[arg % len(DIGESTS)])
            elif code == 2:
                h.drop(DIGESTS[arg % len(DIGESTS)])
            elif code == 3:
                h.spill(arg)
            elif code == 4:
                h.resume(arg)
            elif code == 5:
                h.finish(arg)
            elif code == 6:
                h.kill()
            h.check()
        assert pool_state(hs[1]) == pool_state(hs[0])
    same_tree(hs[1].pool.snapshot(), hs[0].pool.snapshot())
    for h in hs:
        h.drain()


def test_pool_fixed_seed_random_sequences():
    """tests/test_pagepool_prop.py's fallback property run (40 random
    op sequences, its seed) against the port, in lockstep."""
    rng = np.random.default_rng(1234)
    for _ in range(40):
        n = int(rng.integers(5, 30))
        ops = [(int(rng.integers(0, 7)), int(rng.integers(0, 8)))
               for _ in range(n)]
        run_pool_sequence(ops)


def test_pool_directed_share_then_kill_then_drain():
    ops = ([(1, 0)] + [(0, 1)] * 4 + [(6, 0)] + [(3, 0), (3, 1)]
           + [(0, 3)] * 3 + [(4, 0), (6, 0), (2, 0)])
    run_pool_sequence(ops)


# ---------------------------------------------------------------------- #
# the prefix-cache property core (tests/test_prefix_prop.py)
# ---------------------------------------------------------------------- #

PREFIX_PT, PREFIX_LEN = 2, 8
PROMPTS = [[1, 2, 3, 4, 5, 6], [1, 2, 3, 4, 9, 9], [1, 2, 7, 7],
           [5, 5, 5, 5, 5, 5], [1, 2, 3, 4, 5, 6, 8, 8]]


class PrefixHarness:
    def __init__(self, jax_side):
        self.jax = jax_side
        self.mod = jpx if jax_side else tpx
        self.cache = self._cache()
        self.evicted = []
        self.cache.on_evict = self.evicted.append
        self.held = set()

    def _stack(self):
        if self.jax:
            return JStack([("mem", JMemoryTier(JTierSpec(
                JTierKind.DRAM, 10**9, 1e9, 1e9, 1e-6)))])
        return TierStack([("mem", MemoryTier(TierSpec(
            TierKind.DRAM, 10**9, 1e9, 1e9, 1e-6)))])

    def _layout(self):
        template = {"k": np.zeros((2, 1, PREFIX_LEN, 2, 2), np.float32)}
        axes = {"k": ("layers", "batch", "kv_seq", "heads", "head_dim")}
        return self.mod.LaneLayout(template, axes)

    def _cache(self):
        stack, layout = self._stack(), self._layout()
        probe = self.mod.PrefixCache(stack, layout, page_tokens=PREFIX_PT)
        node = probe.extend([1, 2], PREFIX_PT, filled_lane(layout, 0))[0]
        page_bytes = node.nbytes
        probe.clear()
        return self.mod.PrefixCache(stack, layout, page_tokens=PREFIX_PT,
                                    capacity_bytes=4 * page_bytes)

    def insert(self, pick, sid):
        prompt = PROMPTS[pick % len(PROMPTS)]
        upto = (len(prompt) // PREFIX_PT) * PREFIX_PT
        self.cache.extend(prompt, upto, filled_lane(self.cache.layout, pick),
                          sid=sid)
        self.held.add(sid)

    def match(self, pick):
        covered, path = self.cache.match(PROMPTS[pick % len(PROMPTS)])
        if path:
            lane = self.cache.layout.zero_lane()
            assert self.cache.fetch_into(path, lane) <= covered

    def release(self, sid):
        self.cache.release_stream(sid)
        self.held.discard(sid)

    def check(self):
        cache = self.cache
        live = {d: cache.node(d) for d in list(cache._nodes)}
        for node in live.values():
            assert cache.read_node_part(node)["k"].shape == (
                2, 1, PREFIX_PT, 2, 2)
        for digest in self.evicted:
            if digest not in live:
                with pytest.raises(KeyError):
                    cache.stack.get(self.mod.prefix_page_key(digest))
        refs = {d for ds in cache.stream_refs().values() for d in ds}
        for digest in self.evicted:
            assert digest not in refs or digest in live
        assert cache.stats["bytes_cached"] == sum(n.nbytes for n in live.values())

    def check_budget(self):
        if any(not n.children and n.refs == 0
               for n in self.cache._nodes.values()):
            assert self.cache.stats["bytes_cached"] <= self.cache.capacity_bytes

    def state(self):
        return (self.cache.export_records(), self.cache.stream_refs(),
                dict(self.cache.stats), list(self.evicted))


def filled_lane(layout, seed):
    lane = layout.zero_lane()
    lane["k"][...] = np.arange(lane["k"].size).reshape(lane["k"].shape) + seed
    return lane


def run_prefix_sequence(ops):
    hs = [PrefixHarness(jax_side=True), PrefixHarness(jax_side=False)]
    for code, arg in ops:
        for h in hs:
            if code == 0:
                h.insert(arg, sid=arg % 4)
                h.check_budget()
            elif code == 1:
                h.match(arg)
            elif code == 2:
                h.release(arg % 4)
            h.check()
        assert hs[1].state() == hs[0].state()
    for h in hs:
        for sid in list(h.held):
            h.release(sid)
        h.insert(0, sid=99)
        h.release(99)
        h.check()
    assert hs[1].state() == hs[0].state()


def test_prefix_fixed_seed_random_sequences():
    """tests/test_prefix_prop.py's fallback property run (its seed)
    against the port, in lockstep: same records, payload CRCs, stream
    references, counters and evictions."""
    rng = np.random.default_rng(4321)
    for _ in range(30):
        n = int(rng.integers(4, 25))
        ops = [(int(rng.integers(0, 3)), int(rng.integers(0, 10)))
               for _ in range(n)]
        run_prefix_sequence(ops)


def test_prefix_on_evict_fires_exactly_once_per_dropped_node():
    h = PrefixHarness(jax_side=False)
    h.insert(0, sid=0)
    digests = list(h.cache._nodes)
    h.release(0)
    h.cache.capacity_bytes = 0
    h.cache._maybe_evict()
    assert sorted(h.evicted) == sorted(digests)
    assert len(h.cache) == 0 and h.cache.stats["bytes_cached"] == 0


# ---------------------------------------------------------------------- #
# the pager (tests/test_serve_sched.py)
# ---------------------------------------------------------------------- #


def lane_like():
    return {
        "k": torch.arange(24, dtype=torch.float32).reshape(2, 3, 4),
        "v": torch.ones((2, 5), dtype=torch.bfloat16) * 1.5,
        "pos": np.int32(7),
    }


def jax_lane_like():
    return {
        "k": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
        "v": jnp.ones((2, 5), jnp.bfloat16) * 1.5,
        "pos": np.int32(7),
    }


def test_pager_park_fetch_roundtrip_bytes():
    pager = KVPager.for_capacity(fast_bytes=1 << 20, page_bytes=64)
    jpager = jkv.KVPager.for_capacity(fast_bytes=1 << 20, page_bytes=64)
    lane = lane_like()
    nbytes = pager.park(3, lane)
    assert nbytes == jpager.park(3, jax_lane_like())
    assert nbytes == serialize_state(lane).nbytes
    # the same bytes: the same page table
    assert pager.page_table(3) == jpager.page_table(3)
    assert pager.is_parked(3) and pager.parked_sids() == [3]
    got = pager.fetch(3, lane_like())
    for k in lane:
        assert raw(got[k]) == raw(lane[k])
        if isinstance(lane[k], torch.Tensor):
            assert got[k].dtype == lane[k].dtype
    assert not pager.is_parked(3)
    pager.close()
    jpager.close()


def test_pager_oversized_lane_routed_past_fast_tier():
    lane = lane_like()
    nbytes = serialize_state(lane).nbytes
    pager = KVPager.for_capacity(fast_bytes=2 * nbytes, page_bytes=4 * nbytes,
                                 admission_fraction=0.25)
    pager.park(0, lane)
    assert pager.stack.stats["admission_routed"] >= 1
    assert pager.level_used()["hbm"] == 0
    pager.close()


def test_pager_unpaged_park_is_all_or_nothing():
    lane = lane_like()
    nbytes = serialize_state(lane).nbytes
    pager = KVPager.for_capacity(fast_bytes=int(1.5 * nbytes), paged=False,
                                 page_bytes=max(1, nbytes // 4))
    pager.park(0, lane)
    other = lane_like()
    other["k"] = other["k"] + 1.0
    before = pager.pooled_pages()
    with pytest.raises(CapacityError):
        pager.park(1, other)
    assert pager.pooled_pages() == before
    assert pager.parked_sids() == [0]
    pager.close()


def test_pager_identical_content_parks_share_pages():
    lane = lane_like()
    nbytes = serialize_state(lane).nbytes
    pager = KVPager.for_capacity(fast_bytes=int(1.5 * nbytes), paged=False,
                                 page_bytes=max(1, nbytes // 4))
    pager.park(0, lane)
    put_before = pager.stats()["kv_pages_put"]
    pager.park(1, lane_like())
    assert pager.stats()["kv_pages_put"] == put_before
    assert pager.stats()["kv_page_dedup_hits"] > 0
    assert pager.pooled_bytes() < pager.parked_bytes()
    pager.release(0)
    got = pager.fetch(1, lane_like())
    for k in lane:
        assert raw(got[k]) == raw(lane[k])
    assert pager.pooled_pages() == 0
    pager.close()


def test_resume_retains_baseline_so_repark_skips_clean_pages():
    pager = KVPager.for_capacity(fast_bytes=1 << 20, page_bytes=64)
    pager.park(5, lane_like())
    got = pager.fetch(5, lane_like(), release=False)
    assert not pager.is_parked(5)
    assert pager.parked_sids() == [] and pager.table_sids() == [5]
    put_before = pager.stats()["kv_pages_put"]
    pager.park(5, got)
    st = pager.stats()
    assert st["kv_pages_put"] == put_before
    assert st["kv_clean_page_skips"] > 0
    assert pager.is_parked(5)
    pager.release(5)
    assert pager.pooled_pages() == 0
    pager.close()


def test_pager_repark_skips_clean_pages():
    pager = KVPager.for_capacity(fast_bytes=1 << 20, page_bytes=64)
    pager.park(5, lane_like())
    put_before = pager.stats()["kv_pages_put"]
    pager.park(5, lane_like())
    st = pager.stats()
    assert st["kv_pages_put"] == put_before
    assert st["kv_clean_page_skips"] > 0
    dirty = lane_like()
    dirty["pos"] = np.int32(9)
    pager.park(5, dirty)
    st2 = pager.stats()
    assert st2["kv_pages_put"] == put_before + 1
    pager.close()


@pytest.mark.parametrize("codec", ["zlib", "int8"])
def test_pool_pages_spill_through_a_codec_like_the_reference(codec):
    """Page-granular park / fetch through a demoting kv codec: the pool
    blobs come back as the reference's do (zlib exact, int8 decoded to
    the same bytes in both packages)."""
    rng = np.random.default_rng(9)
    blobs = [rng.standard_normal(256).astype(np.float32).tobytes()
             for _ in range(6)]
    got = []
    for mod in (jkv, tkv):
        pager = mod.KVPager.for_capacity(fast_bytes=2048, page_bytes=1024,
                                         kv_codec=codec, codec_block=8)
        pager.park_pages(0, blobs[:3])
        pager.park_pages(1, blobs[3:] + blobs[:1])     # one shared page
        assert pager.stats()["kv_page_dedup_hits"] == 1
        assert pager.kv_lossy() == (codec == "int8")
        got.append((pager.fetch_pages(0), pager.fetch_pages(1)))
        pager.close()
    assert got[1] == got[0]
    if codec == "zlib":
        assert list(got[1][0]) == blobs[:3]


# ---------------------------------------------------------------------- #
# the prefix cache (tests/test_prefix_cache.py)
# ---------------------------------------------------------------------- #


def toy_layout(max_len=16):
    template = {"k": torch.zeros((2, 1, max_len, 4)),
                "v": torch.zeros((2, 1, max_len, 4))}
    axes = {"k": ("layers", "batch", "kv_seq", None),
            "v": ("layers", "batch", "kv_seq", None)}
    return LaneLayout(template, axes)


def toy_stack(capacity=1 << 20):
    tier = MemoryTier(TierSpec(TierKind.DRAM, capacity, 1e9, 1e9, 1e-6))
    return TierStack([("fast", tier),
                      ("global", MemoryTier(
                          TierSpec(TierKind.GLOBAL, 1 << 30, 1e9, 1e9, 1e-4)))])


def toy_filled(layout, upto, base=1.0):
    lane = layout.zero_lane()
    lane["k"][:, :, :upto] = base
    lane["v"][:, :, :upto] = base * 2
    return lane


def test_match_and_fetch_roundtrip():
    layout = toy_layout()
    cache = PrefixCache(toy_stack(), layout, page_tokens=4)
    tokens = list(range(10))
    lane = toy_filled(layout, 10)
    path = cache.extend(tokens[:8], 8, lane)
    assert len(path) == 2 and path[-1].end == 8
    covered, hit = cache.match(tokens)
    assert covered == 8 and len(hit) == 2
    fresh = layout.zero_lane()
    assert cache.fetch_into(hit, fresh) == 8
    assert torch.equal(fresh["k"][:, :, :8], lane["k"][:, :, :8])
    assert torch.equal(fresh["v"][:, :, :8], lane["v"][:, :, :8])
    assert not fresh["k"][:, :, 8:].any()
    covered2, hit2 = cache.match(tokens[:4] + [99, 98, 97, 96])
    assert covered2 == 4 and len(hit2) == 1
    assert hit2[0].digest == hit[0].digest


def test_content_addressing_dedups_across_inserters():
    layout = toy_layout()
    cache = PrefixCache(toy_stack(), layout, page_tokens=4)
    lane = toy_filled(layout, 8)
    cache.extend(list(range(8)), 8, lane)
    n = len(cache)
    cache.extend(list(range(8)), 8, lane)
    assert len(cache) == n
    assert cache.stats["pages_inserted"] == n


def test_refcounted_shared_page_survives_stream_finish():
    layout = toy_layout()
    cache = PrefixCache(toy_stack(), layout, page_tokens=4, capacity_bytes=1)
    path = cache.extend(list(range(8)), 8, toy_filled(layout, 8), sid=101)
    assert len(cache) == 2
    cache.acquire(202, path)
    cache.release_stream(101)
    cache._maybe_evict()
    assert len(cache) == 2
    assert cache.stack.exists(prefix_page_key(path[0].digest))
    cache.release_stream(202)
    cache._maybe_evict()
    assert len(cache) == 0
    assert not cache.stack.exists(prefix_page_key(path[0].digest))


def test_eviction_is_leaf_first_and_lru():
    layout = toy_layout()
    cache = PrefixCache(toy_stack(), layout, page_tokens=4, capacity_bytes=None)
    cache.extend(list(range(12)), 12, toy_filled(layout, 12))
    assert len(cache) == 3
    cache.capacity_bytes = cache.stats["bytes_cached"] // 3
    cache._maybe_evict()
    assert len(cache) == 1
    covered, hit = cache.match(list(range(12)))
    assert covered == 4 and hit[0].end == 4


def test_release_stream_is_idempotent():
    layout = toy_layout()
    cache = PrefixCache(toy_stack(), layout, page_tokens=4)
    path = cache.extend(list(range(4)), 4, toy_filled(layout, 4))
    cache.acquire(7, path)
    cache.release_stream(7)
    cache.release_stream(7)
    assert cache.node(path[0].digest).refs == 0


def test_tails_exports_and_adoption_match_reference():
    """Tail registration and match, snapshot-mode nodes, export / restore
    and adoption of node records: the same records and payload bytes as
    the reference for the same lane values."""
    jt = {"k": np.zeros((2, 1, 16, 4), np.float32),
          "v": np.zeros((2, 1, 16, 4), np.float32)}
    axes = {"k": ("layers", "batch", "kv_seq", None),
            "v": ("layers", "batch", "kv_seq", None)}
    jstack = JStack([("m", JMemoryTier(JTierSpec(
        JTierKind.DRAM, 1 << 20, 1e9, 1e9, 1e-6)))])
    jc = jpx.PrefixCache(jstack, jpx.LaneLayout(jt, axes), page_tokens=4)
    tc = PrefixCache(toy_stack(), toy_layout(), page_tokens=4)
    for cache in (jc, tc):
        lane = toy_filled(cache.layout, 11, base=3.0)
        toks = list(range(20, 31))
        cache.extend(toks[:8], 8, lane, sid=1)
        assert cache.register_tail(toks, 11, lane, sid=1).end == 11
        covered, path = cache.match(toks[:10] + [5])
        assert covered == 8
        assert cache.match_tail(toks[:10] + [5], covered, path) is None
        assert cache.match_tail(toks + [5], covered, path).end == 11
    jrec, jpay = jc.export_nodes()
    trec, tpay = tc.export_nodes()
    assert trec == jrec and tpay == jpay
    assert tc.export_records() == jc.export_records()
    assert tc.stream_refs() == jc.stream_refs()
    fresh = PrefixCache(toy_stack(), toy_layout(), page_tokens=4)
    fresh.restore_nodes(trec, tpay, {1: [r["digest"] for r in trec]})
    assert fresh.export_nodes() == (trec, tpay)
    assert fresh.stream_refs() == {1: [r["digest"] for r in trec]}
    peer = PrefixCache(tc.stack, toy_layout(), page_tokens=4)
    assert peer.adopt_nodes(tc.export_records()) == len(trec)
    assert peer.export_records() == trec
    # snapshot mode: a layout with a leaf that has no kv_seq axis
    snap = LaneLayout({"s": torch.zeros((2, 1, 3))},
                      {"s": ("layers", "batch", None)})
    sc = PrefixCache(toy_stack(), snap, page_tokens=4)
    assert sc.mode == "snapshot"
    lane = snap.zero_lane()
    for end in (4, 8):          # page by page, as prefill registers them
        lane["s"] += 7.0
        sc.extend(list(range(end)), end, lane, sid=3)
    covered, path = sc.match(list(range(9)))
    out = snap.zero_lane()
    assert sc.fetch_into(path, out) == 8 and torch.equal(out["s"], lane["s"])
