"""The port's serving fleet (``repro_torch.serve.fleet``) against the
reference's: prefix publish/subscribe, tail sharing, admission.

Case for case the reference's ``tests/test_fleet.py`` on the port, layered
as it is: synthetic-layout tests for the trie mechanics (no model),
stub-worker tests for the front-end's admission logic, and end-to-end
tests spawning real port workers (``device="cpu"``) over one shared
domain.  The board and the stub scenarios also run through both packages
in lockstep (the same journal bytes; the same dispatches, throttling and
stats), and the port's fleet emits exactly the tokens of the port's own
``Serve.local`` on the same seed (which ``tests/test_torch_serve*.py``
hold against the reference).
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.memory.codecs import CodecRule, make_codec
from repro_torch.memory.shared import SharedTier
from repro_torch.memory.stack import HitRatePromotion, KeyClass, TierStack
from repro_torch.memory.tiers import MemoryTier, TierKind, TierSpec
from repro_torch.serve.fleet.board import PrefixBoard
from repro_torch.serve.prefix import LaneLayout, PrefixCache, prefix_page_key

MAX_LEN, PT = 16, 4


def template():
    return {"k": torch.zeros((2, 1, MAX_LEN, 2, 4)),
            "v": torch.zeros((2, 1, MAX_LEN, 2, 4))}


def make_layout():
    axes = {"k": ("layers", "batch", "kv_seq", "heads", "head_dim"),
            "v": ("layers", "batch", "kv_seq", "heads", "head_dim")}
    return LaneLayout(template(), axes)


def make_stack(shared=None, fast_bytes=1 << 20, codec=None):
    levels = [("hbm", MemoryTier(TierSpec(TierKind.HBM, fast_bytes,
                                          450e9, 450e9, 1e-7)))]
    if shared is not None:
        levels.append(("shared", shared))
    else:
        levels.append(("global", MemoryTier(TierSpec(
            TierKind.GLOBAL, 1 << 30, 5e9, 5e9, 5e-4))))
    return TierStack(levels, promotion=HitRatePromotion(k=2, window=64),
                     codecs={KeyClass.KV: CodecRule(codec)} if codec else None)


def rand_lane(layout, rng):
    return {k: torch.from_numpy(rng.normal(size=tuple(v.shape))
                                .astype(np.float32))
            for k, v in template().items()}


def assert_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------------- #
# publish / subscribe: export_records + adopt_nodes
# --------------------------------------------------------------------------- #

def publish(cache, stack_to, published):
    fresh = []
    for rec in cache.export_records():
        if rec["digest"] in published:
            continue
        payload = cache.stack.get(prefix_page_key(rec["digest"]),
                                  promote=False)
        stack_to.put_at("shared", prefix_page_key(rec["digest"]), payload)
        published.add(rec["digest"])
        fresh.append(rec)
    return fresh


def test_adopt_nodes_cross_cache(tmp_path):
    """B adopts A's records and reads the payloads through the shared
    level — the in-process model of two fleet workers."""
    layout, rng = make_layout(), np.random.default_rng(0)
    dom = SharedTier(tmp_path / "dom")
    a = PrefixCache(make_stack(shared=dom), layout, page_tokens=PT)
    b = PrefixCache(make_stack(shared=SharedTier(tmp_path / "dom")),
                    layout, page_tokens=PT)
    tokens = list(range(12))
    lane = rand_lane(layout, rng)
    a.extend(tokens, 8, lane)                      # two full pages
    recs = publish(a, a.stack, set())
    assert len(recs) == 2
    assert b.adopt_nodes(recs) == 2
    assert b.stats["nodes_adopted"] == 2
    covered, path = b.match(tokens)
    assert covered == 8 and len(path) == 2
    part = b.read_node_part(path[0])
    assert_equal(part["k"], layout.extract(lane, 0, PT)["k"])
    assert b.stack.stats()["hits_shared"] >= 1


def test_adopt_skips_duplicates_and_orphans(tmp_path):
    layout, rng = make_layout(), np.random.default_rng(1)
    a = PrefixCache(make_stack(), layout, page_tokens=PT)
    b = PrefixCache(make_stack(), layout, page_tokens=PT)
    a.extend(list(range(8)), 8, rand_lane(layout, rng))
    recs = a.export_records()
    assert b.adopt_nodes(recs) == 2
    assert b.adopt_nodes(recs) == 0               # idempotent
    orphan = dict(recs[1], digest="feedfacefeedfacefeedface",
                  parent="0" * 24, chunk=[99, 98, 97, 96])
    assert b.adopt_nodes([orphan]) == 0           # unknown parent skipped
    assert len(b) == 2


def test_adopted_nodes_count_toward_budget_and_evict(tmp_path):
    layout, rng = make_layout(), np.random.default_rng(2)
    a = PrefixCache(make_stack(), layout, page_tokens=PT)
    a.extend(list(range(8)), 8, rand_lane(layout, rng))
    recs = a.export_records()
    nbytes = sum(r["nbytes"] for r in recs)
    b = PrefixCache(make_stack(), layout, page_tokens=PT,
                    capacity_bytes=nbytes)        # exactly fits
    assert b.adopt_nodes(recs) == 2
    assert b.cached_bytes() == nbytes
    b.extend(list(range(100, 108)), 8, rand_lane(layout, rng))
    assert b.cached_bytes() <= nbytes
    assert b.stats["pages_evicted"] >= 1


def test_export_records_orders_parents_first():
    layout, rng = make_layout(), np.random.default_rng(3)
    a = PrefixCache(make_stack(), layout, page_tokens=PT)
    a.extend(list(range(12)), 12, rand_lane(layout, rng))
    recs = a.export_records()
    seen = set()
    for rec in recs:
        assert rec["parent"] == "" or rec["parent"] in seen
        seen.add(rec["digest"])


# --------------------------------------------------------------------------- #
# PrefixBoard
# --------------------------------------------------------------------------- #

def test_board_publish_poll_roundtrip(tmp_path):
    a, b = PrefixBoard(tmp_path), PrefixBoard(tmp_path)
    recs = [{"digest": "d1", "parent": "", "chunk": [1, 2], "end": 2,
             "nbytes": 10, "crc32": 7}]
    assert a.publish(recs) == 1
    assert b.poll() == recs
    assert b.poll() == []                         # cursor advanced
    a.publish([dict(recs[0], digest="d2", parent="d1")])
    got = b.poll()
    assert [r["digest"] for r in got] == ["d2"]
    assert [r["digest"] for r in a.poll()] == ["d1", "d2"]


def test_board_ignores_torn_tail(tmp_path):
    a, b = PrefixBoard(tmp_path), PrefixBoard(tmp_path)
    a.publish([{"digest": "d1", "parent": "", "chunk": [], "end": 0,
                "nbytes": 0, "crc32": 0}])
    with open(a.path, "ab") as f:
        f.write(b'{"digest": "partial')          # torn concurrent append
    got = b.poll()
    assert [r["digest"] for r in got] == ["d1"]  # whole lines only
    assert b.poll() == []


def test_board_empty_poll(tmp_path):
    assert PrefixBoard(tmp_path).poll() == []


BOARD_RECORDS = [
    [{"digest": "d1", "parent": "", "chunk": [1, 2, 3, 4], "end": 4,
      "nbytes": 10, "crc32": 7}],
    [{"kind": "epoch", "worker": "w0", "pid": 17, "step": 4, "t": 1.5}],
    [{"digest": f"d{i}", "parent": f"d{i - 1}", "chunk": [i], "end": 4 + i,
      "nbytes": 4, "crc32": 0} for i in range(2, 6)],
]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_board_journal_matches_reference(tmp_path, writer):
    """The same publishes through either package write the same journal
    bytes, and the other package's cursor reads them back, in whole and
    in bounded batches."""
    from repro.serve.fleet.board import PrefixBoard as JBoard

    w_cls, r_cls = (PrefixBoard, JBoard) if writer == "port" else (JBoard, PrefixBoard)
    w = w_cls(tmp_path / "dom")
    for recs in BOARD_RECORDS:
        w.publish(recs)
    other = (JBoard if writer == "port" else PrefixBoard)(tmp_path / "other")
    for recs in BOARD_RECORDS:
        other.publish(recs)
    assert w.path.read_bytes() == other.path.read_bytes()
    assert w.path.name == other.path.name
    assert w._lock_path.name == other._lock_path.name
    flat = [r for recs in BOARD_RECORDS for r in recs]
    r = r_cls(tmp_path / "dom")
    assert r.poll(2) + r.poll(3) + r.poll() == flat
    assert r.adopt_seen == len(flat) and w.published == len(flat)


# --------------------------------------------------------------------------- #
# partial-page tail sharing (synthetic layout)
# --------------------------------------------------------------------------- #

def test_register_and_match_tail():
    layout, rng = make_layout(), np.random.default_rng(4)
    cache = PrefixCache(make_stack(), layout, page_tokens=PT)
    tokens = list(range(10))                      # 2 pages + 2-token tail
    lane = rand_lane(layout, rng)
    cache.extend(tokens, 8, lane)
    node = cache.register_tail(tokens, 10, lane)
    assert node is not None and node.end == 10 and len(node.chunk) == 2
    assert cache.stats["tail_pages_inserted"] == 1
    req = tokens + [77, 78, 79]
    covered, path = cache.match(req)
    assert covered == 8
    tail = cache.match_tail(req, covered, path)
    assert tail is node
    part = cache.read_node_part(tail)
    assert_equal(part["k"], layout.extract(lane, 8, 10)["k"])
    assert cache.stats["tail_hits"] == 1
    assert cache.stats["tail_tokens_reused"] == 2


def test_tail_requires_full_page_ancestors():
    layout, rng = make_layout(), np.random.default_rng(5)
    cache = PrefixCache(make_stack(), layout, page_tokens=PT)
    lane = rand_lane(layout, rng)
    assert cache.register_tail(list(range(10)), 10, lane) is None
    cache.extend(list(range(8)), 8, lane)
    assert cache.register_tail(list(range(8)), 8, lane) is None  # no tail


def test_match_tail_prefers_longest():
    layout, rng = make_layout(), np.random.default_rng(6)
    cache = PrefixCache(make_stack(), layout, page_tokens=PT)
    tokens = list(range(8))
    lane = rand_lane(layout, rng)
    cache.extend(tokens, 8, lane)
    cache.register_tail(tokens + [50], 9, lane)
    cache.register_tail(tokens + [50, 51], 10, lane)
    tail = cache.match_tail(tokens + [50, 51, 52], 8,
                            cache.match(tokens)[1])
    assert tail.end == 10


def test_tail_mismatch_not_matched():
    layout, rng = make_layout(), np.random.default_rng(7)
    cache = PrefixCache(make_stack(), layout, page_tokens=PT)
    tokens = list(range(8))
    lane = rand_lane(layout, rng)
    cache.extend(tokens, 8, lane)
    cache.register_tail(tokens + [50, 51], 10, lane)
    assert cache.match_tail(tokens + [60, 61], 8,
                            cache.match(tokens)[1]) is None
    assert cache.match_tail(tokens + [50], 8, cache.match(tokens)[1]) is None


# --------------------------------------------------------------------------- #
# quantized prefix pages survive demotion
# --------------------------------------------------------------------------- #

def test_quantized_prefix_page_readable_after_demotion():
    layout, rng = make_layout(), np.random.default_rng(8)
    part_bytes = 2 * 2 * 1 * PT * 2 * 4 * 4
    stack = make_stack(fast_bytes=int(part_bytes * 1.5),
                       codec=make_codec("int8", dtype="float32", block=4))
    cache = PrefixCache(stack, layout, page_tokens=PT)
    lane = rand_lane(layout, rng)
    path = cache.extend(list(range(12)), 8, lane)
    cache.extend(list(range(100, 112)), 8, rand_lane(layout, rng))
    st = stack.stats()
    assert st["evictions"] >= 1
    assert 0 < st["kv_bytes_encoded_out"] < st["kv_bytes_encoded"]
    part = cache.read_node_part(path[0])
    np.testing.assert_allclose(
        np.asarray(part["k"]), np.asarray(layout.extract(lane, 0, PT)["k"]),
        rtol=0.1, atol=0.05)
    covered, p2 = cache.match(list(range(12)))
    fresh = layout.zero_lane()
    assert cache.fetch_into(p2, fresh) == 8
    assert len(cache) >= 2


def test_lossless_codec_keeps_strict_crc():
    layout, rng = make_layout(), np.random.default_rng(9)
    stack = make_stack(codec=make_codec("zlib"))
    cache = PrefixCache(stack, layout, page_tokens=PT)
    lane = rand_lane(layout, rng)
    path = cache.extend(list(range(8)), 8, lane)
    part = cache.read_node_part(path[0])
    assert_equal(part["k"], layout.extract(lane, 0, PT)["k"])


# --------------------------------------------------------------------------- #
# front-end admission logic (stub workers), through both packages
# --------------------------------------------------------------------------- #

class StubWorker:
    """Pipe-free WorkerHandle stand-in: finishes a request after
    ``delay_pumps`` message polls."""

    def __init__(self, delay_pumps=1):
        self.submitted = []
        self._pending = []
        self.delay = delay_pumps

    def submit(self, rid, prompt, max_new, weight=1):
        self.submitted.append({"rid": rid, "prompt": list(prompt),
                               "max_new": max_new, "weight": weight})
        self._pending.append([self.delay, rid, max_new])

    def messages(self):
        out = []
        for ent in list(self._pending):
            ent[0] -= 1
            if ent[0] <= 0:
                out.append({"op": "done", "rid": ent[1],
                            "tokens": [0] * ent[2]})
                self._pending.remove(ent)
        return out

    def stats(self):
        return {}

    def stop(self):
        pass


def frontends():
    """The front-end module of each package."""
    import repro.serve.fleet.frontend as jfe
    import repro_torch.serve.fleet.frontend as tfe

    return {"port": tfe, "ref": jfe}


def lockstep(scenario):
    """Run ``scenario(frontend_module)`` through both packages; its
    returned decisions must be equal."""
    got = {name: scenario(mod) for name, mod in frontends().items()}
    assert got["port"] == got["ref"]
    return got["port"]


def decisions(fe, workers):
    counters = {k: v for k, v in fe.stats.items()}
    return {"submitted": [w.submitted for w in workers], "stats": counters,
            "states": [fe.worker_state(i) for i in range(len(workers))]}


def test_quota_throttles_only_the_noisy_tenant():
    def scenario(m):
        w = StubWorker()
        fe = m.FleetFrontend([w], quotas={"noisy": m.TenantQuota(1)},
                             default_quota=m.TenantQuota(8))
        noisy = [fe.submit([1, 2], 3, tenant="noisy") for _ in range(4)]
        quiet = [fe.submit([1, 2], 3, tenant="quiet") for _ in range(2)]
        fe.pump()
        assert sum(1 for s in w.submitted if s["rid"] in noisy) == 1
        assert sum(1 for s in w.submitted if s["rid"] in quiet) == 2
        assert fe.stats["throttle_events"] >= 1
        fe.wait(noisy + quiet, timeout=10)
        assert fe.stats["completed"] == 6
        assert all(len(fe.result(r)) == 3 for r in noisy)
        return decisions(fe, [w])

    lockstep(scenario)


def test_priority_class_maps_to_quantum_weight():
    def scenario(m):
        w = StubWorker()
        fe = m.FleetFrontend([w], classes={"lo": m.PriorityClass("lo", 1),
                                           "hi": m.PriorityClass("hi", 3)})
        fe.submit([1], 2, prio="hi")
        fe.submit([1], 2, prio="lo")
        fe.pump()
        assert [s["weight"] for s in w.submitted] == [3, 1]
        with pytest.raises(ValueError):
            fe.submit([1], 2, prio="nope")
        return decisions(fe, [w])

    lockstep(scenario)


def test_least_loaded_routing():
    def scenario(m):
        workers = [StubWorker(delay_pumps=10), StubWorker(delay_pumps=10)]
        fe = m.FleetFrontend(workers)
        r1 = fe.submit([1] * 10, 10)                  # cost 20
        fe.pump()
        r2 = fe.submit([1], 1)                        # cost 2 -> other worker
        r3 = fe.submit([1], 1)
        fe.pump()
        first = 0 if workers[0].submitted and \
            workers[0].submitted[0]["rid"] == r1 else 1
        assert [s["rid"] for s in workers[first].submitted] == [r1]
        assert {s["rid"] for s in workers[1 - first].submitted} == {r2, r3}
        return decisions(fe, workers)

    lockstep(scenario)


def test_admission_latency_recorded():
    def scenario(m):
        w = StubWorker()
        fe = m.FleetFrontend([w])
        rid = fe.submit([1], 1, tenant="t")
        fe.wait([rid], timeout=10)
        assert fe.admission_latency_p99("t") >= 0.0
        assert fe.admission_latency_p99("never-dispatched") == 0.0
        snap = fe.registry.snapshot()
        return dict(decisions(fe, [w]), count=sorted(
            snap["histograms"]["frontend"]["admission_latency_s"]))

    lockstep(scenario)


def test_frontend_rejects_an_empty_fleet():
    for m in frontends().values():
        with pytest.raises(ValueError, match="at least one worker"):
            m.FleetFrontend([])


# --------------------------------------------------------------------------- #
# checkpoint sessions over the shared root
# --------------------------------------------------------------------------- #

def test_session_restore_across_instances(tmp_path):
    """A checkpoint committed through one session is restorable by a
    session constructed later over the same shared root — and by the
    reference's session over the same root."""
    from repro.api import ResilienceSession as JSession
    from repro_torch.api import ResilienceSession

    state = {"w": np.arange(32, dtype=np.float32),
             "b": np.ones(4, np.float32)}
    with ResilienceSession.for_shared_tier(tmp_path / "fleet") as s1:
        s1.save(3, state)
        s1.wait_drained()
    like = {"w": np.zeros(32, np.float32), "b": np.zeros(4, np.float32)}
    for cls in (ResilienceSession, JSession):
        with cls.for_shared_tier(tmp_path / "fleet") as s2:
            got, step = s2.restore_latest(dict(like))
        assert step == 3
        assert_equal(got["w"], state["w"])
        assert_equal(got["b"], state["b"])


# --------------------------------------------------------------------------- #
# real workers (on the CPU) over one shared domain
# --------------------------------------------------------------------------- #

def _run_one(w, rid, prompt, max_new=4, timeout=180.0):
    w.submit(rid, prompt, max_new=max_new)
    deadline = time.time() + timeout
    while time.time() < deadline:
        for m in w.messages():
            if m.get("op") == "done" and m["rid"] == rid:
                return m["tokens"]
        time.sleep(0.01)
    raise TimeoutError(f"request {rid} never finished")


# the reduced phi3's vocabulary is 512: the reference's tests draw tokens
# below 1000, which JAX's gather clamps into the table; torch's indexing
# refuses them, so the port's draws stay inside the vocabulary
VOCAB = 512


def test_cross_worker_prefix_reuse(tmp_path, monkeypatch):
    """Worker B admits a prompt whose prefix only worker A computed:
    B adopts the published trie nodes, reads the pages out of the shared
    tier, and skips the prefill."""
    from repro_torch.serve.fleet import WorkerHandle, WorkerSpec

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    mk = lambda: WorkerSpec(shared_root=str(tmp_path), slots=2, max_len=32,
                            page_tokens=4, quantum=3, device="cpu")
    a, b = WorkerHandle.launch(mk()), WorkerHandle.launch(mk())
    try:
        a.wait_ready()
        b.wait_ready()
        rng = np.random.default_rng(3)
        sysp = rng.integers(0, VOCAB, size=13).tolist()
        _run_one(a, "a1", sysp + rng.integers(0, VOCAB, size=4).tolist())
        _run_one(b, "b1", sysp + rng.integers(0, VOCAB, size=5).tolist())
        sb = b.stats()
        assert sb["scheduler"]["prefill_tokens_saved"] > 0
        assert sb["tier"]["hits_shared"] > 0
        assert sb["prefix"]["nodes_adopted"] > 0
        # the CPU tensors' decode runs the paged kernel's plain version:
        # no launch, and no call of the contiguous path's plain attention
        assert sb["kernels"] == {"paged_attention": 0,
                                 "paged_attention_quant": 0,
                                 "decode_attention": 0}
        assert b.drain() == []
    finally:
        a.stop()
        b.stop()


def test_worker_kernel_counts_read_and_reset(monkeypatch):
    """``kernel_counts`` reads the paged wrappers' launch counts and the
    plain ``layers.decode_attention`` calls, also through a wrapper put in
    its place (as a caller counting its own calls does); a worker zeroes
    them before ``ready``."""
    import torch

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import layers
    from repro_torch.serve.fleet import worker

    worker._reset_kernel_counts()
    q, kc = torch.zeros((1, 2, 8)), torch.zeros((1, 4, 1, 8))
    layers.decode_attention(q, kc, kc, torch.tensor([3]))
    plain = layers.decode_attention
    monkeypatch.setattr(layers, "decode_attention",
                        lambda *a, **k: plain(*a, **k))
    layers.decode_attention(q, kc, kc, torch.tensor([3]))
    pa.paged_attention.launches += 2       # as two kernel launches would
    assert worker.kernel_counts() == {"paged_attention": 2,
                                      "paged_attention_quant": 0,
                                      "decode_attention": 2}
    worker._reset_kernel_counts()
    assert set(worker.kernel_counts().values()) == {0}


def test_fleet_frontend_end_to_end(tmp_path, monkeypatch):
    """Two workers behind the front-end with a throttled tenant; every
    stream equals the port's in-process ``Serve.local`` on the same seed
    (the slot count and the page size are the workers')."""
    from repro_torch.serve import Serve, ServeConfig
    from repro_torch.serve.fleet import FleetFrontend, TenantQuota, WorkerSpec

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    specs = [WorkerSpec(shared_root=str(tmp_path), slots=2, max_len=32,
                        page_tokens=4, quantum=3, device="cpu")
             for _ in range(2)]
    rng = np.random.default_rng(7)
    sysp = rng.integers(0, VOCAB, size=9).tolist()
    prompts = [sysp + rng.integers(0, VOCAB, size=int(rng.integers(3, 6))).tolist()
               for _ in range(4)]
    with FleetFrontend.launch(specs,
                              quotas={"noisy": TenantQuota(1)}) as fe:
        rids = [fe.submit(p, max_new=4, tenant="noisy" if i % 2 else "quiet")
                for i, p in enumerate(prompts)]
        fe.wait(rids, timeout=300)
        outs = [fe.result(r) for r in rids]
        assert all(len(o) == 4 for o in outs)
        assert fe.stats["completed"] == 4
        assert fe.stats["throttle_events"] >= 1   # noisy went over quota
        assert [fe.workers[i].spec.name for i in range(2)] == ["w0", "w1"]
    cfg = ServeConfig(slots=2, max_len=32, page_tokens=4, quantum=3,
                      device="cpu")
    with Serve.local(cfg) as srv:
        sids = [srv.submit(p, max_new=4) for p in prompts]
        srv.run()
        assert [srv.output(s) for s in sids] == outs


def test_serve_fleet_builds_from_one_config(tmp_path, monkeypatch):
    """``Serve.fleet`` over a ``ServeConfig``: workers named ``w<i>`` over
    the given root, the detector's timeout inherited, and ``Serve.stats``
    merging every worker's registry with the front-end's."""
    from repro_torch.serve import Serve, ServeConfig

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = ServeConfig(slots=2, max_len=32, page_tokens=4, quantum=3,
                      hb_timeout_s=7.5, device="cpu")
    rng = np.random.default_rng(5)
    fe = Serve.fleet(cfg, workers=2, shared_root=str(tmp_path))
    try:
        assert fe.hb_timeout_s == 7.5
        assert [w.spec.name for w in fe.workers] == ["w0", "w1"]
        assert all(w.spec.device == "cpu" for w in fe.workers)
        rids = [fe.submit(rng.integers(0, VOCAB, size=6).tolist(), max_new=3)
                for _ in range(3)]
        fe.wait(rids, timeout=300)
        obs = Serve.stats(fe)
        assert sorted(obs["workers"]) == ["w0", "w1"]
        assert obs["merged"]["counters"]["sched"]["finished"] == 3
        assert obs["merged"]["counters"]["frontend"]["completed"] == 3
    finally:
        fe.stop()
