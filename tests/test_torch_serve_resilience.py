"""The port's resilient serving against the JAX reference.

Both packages serve the same numpy prompts — several sharing a system
prompt whose last page is a partial-page tail — from the same weights
(initialised by the reference, carried across) at float32 compute, each
with a KV pager and a prefix cache:

* the paged scheduler over a pool small enough to spill, for ``spec_k``
  0 and 3 and ``kv_codec`` none, zlib and int8, in lockstep: every step
  emits the same ``(sid, token)`` pairs and leaves the same pool
  refcounts, free list, pool-resident prefix digests and parked streams;
  at the end the scheduler's and the pager's counters are equal;
* the contiguous scheduler in lockstep: phi3 in slice mode, rwkv6 and
  zamba2 in snapshot mode (their lanes also within float32 noise of the
  reference's);
* kill and restore inside the port: the restored pool, allocator, pager
  tables and trie equal the saved ones, and the tokens equal an
  uninterrupted run's;
* a serving checkpoint written by either package restores in the other
  and finishes with the reader's uninterrupted tokens;
* ``ServeEngine``, and ``Serve.local`` on its defaults and through the
  ``examples/serve.py`` flow.

Page digests and pool bytes are never compared across packages: float32
KV differs in the last bits between them.
"""

import dataclasses
import hashlib
import types

import jax
import numpy as np
import pytest
import torch

from repro.api.session import ResilienceSession as JSession
from repro.cluster.topology import VirtualCluster as JCluster
from repro.configs import get_config as jget_config
from repro.core.scr import Strategy as JStrategy
from repro.models.registry import get_model as jget_model
from repro.serve import scheduler as jsched
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.kvpage import KVPager as JPager
from repro.serve.prefix import PrefixCache as JPrefix
from repro_torch.api.session import ResilienceSession as TSession
from repro_torch.cluster.topology import VirtualCluster as TCluster
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.scr import Strategy as TStrategy
from repro_torch.models.registry import get_model
from repro_torch.serve import Serve, ServeConfig
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.kvpage import KVPager as TPager
from repro_torch.serve.prefix import PrefixCache as TPrefix

MAX_LEN, PT, MAX_NEW = 32, 4, 6
# the fast tier holds about one reduced phi3 lane (32 KiB), so spilled
# pages and prefix payloads demote through the kv codec
FAST_BYTES = 40 * 1024
# the pager's own counters (the stack's codec byte counts differ across
# packages: zlib compresses bytes that differ in the last bits)
PAGER_COUNTERS = ("kv_clean_page_skips", "kv_page_dedup_hits",
                  "kv_pages_put", "kv_resume_bytes_moved", "kv_pages_pooled")
# lanes of the contiguous path: float32 KV and recurrent state computed
# in two frameworks (tests/test_torch_family_parity.py's logit tolerance)
LANE_TOL = dict(atol=5e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tensors here are tiny, and the suite runs
    several workers on the same cores, where a spinning thread pool per
    worker made these tests ~50x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

J = types.SimpleNamespace(Pager=JPager, Prefix=JPrefix,
                          Paged=jsched.PagedServeScheduler,
                          Contig=jsched.ServeScheduler, Session=JSession,
                          Cluster=JCluster, Strategy=JStrategy, Engine=JEngine)
T = types.SimpleNamespace(Pager=TPager, Prefix=TPrefix,
                          Paged=tsched.PagedServeScheduler,
                          Contig=tsched.ServeScheduler, Session=TSession,
                          Cluster=TCluster, Strategy=TStrategy, Engine=TEngine)


@pytest.fixture(scope="module")
def pairs():
    """arch -> (jax (cfg, model, params), torch (cfg, model, params)) at
    the reduced size and float32 compute, the weights carried across."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg, tcfg = (dataclasses.replace(g(arch).reduced(),
                                              compute_dtype="float32")
                          for g in (jget_config, get_config))
            jmodel, tmodel = jget_model(jcfg), get_model(tcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
            tparams = params_from_numpy(jax.device_get(jparams), tcfg,
                                        device="cpu")
            made[arch] = ((jcfg, jmodel, jparams), (tcfg, tmodel, tparams))
        return made[arch]

    return get


def shared_prompts(vocab, n=6, seed=7):
    """A 10-token system prompt (two full pages and a 2-token tail) that
    stream 0 ends one token after, so its tail page is registered and
    every later stream reuses it, then 3-7 tokens of each stream's own."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, size=10).tolist()
    out = [system + [int(rng.integers(0, vocab))]]
    out += [system + rng.integers(0, vocab, size=int(rng.integers(3, 8))).tolist()
            for _ in range(n - 1)]
    return out


def build(pkg, side, paged=True, session=None, prefix=True, pool_pages=20,
          spec_k=0, kv_codec=None, slots=2, quantum=3):
    cfg, model, params = side
    pager = pkg.Pager.for_capacity(fast_bytes=FAST_BYTES, page_bytes=1024)
    pc = (pkg.Prefix.for_model(pager.stack, cfg, model, MAX_LEN, page_tokens=PT)
          if prefix else None)
    if paged:
        return pkg.Paged(cfg, model, params, slots=slots, max_len=MAX_LEN,
                         pager=pager, session=session, quantum=quantum,
                         prefix=pc, page_tokens=PT, pool_pages=pool_pages,
                         spec_k=spec_k, kv_codec=kv_codec)
    return pkg.Contig(cfg, model, params, slots=slots, max_len=MAX_LEN,
                      pager=pager, session=session, quantum=quantum, prefix=pc)


def pager_counters(s):
    st = s.pager.stats()
    return {k: st[k] for k in PAGER_COUNTERS}


def lockstep(js, ts, prompts, paged):
    """Submit to both, step both; per step the emitted pairs and the
    allocator / pager bookkeeping must agree.  Returns the outputs."""
    jsids = [js.submit(p, max_new=MAX_NEW) for p in prompts]
    tsids = [ts.submit(p, max_new=MAX_NEW) for p in prompts]
    while js.unfinished() or ts.unfinished():
        assert ts.step() == js.step()
        assert ts.pager.parked_sids() == js.pager.parked_sids()
        if paged:
            assert ts.pool.refcounts() == js.pool.refcounts()
            assert ts.pool._free == js.pool._free
            assert ts.pool.resident_digests() == js.pool.resident_digests()
    outs = [ts.output(s) for s in tsids]
    assert outs == [js.output(s) for s in jsids]
    assert dict(ts.stats) == dict(js.stats)
    assert pager_counters(ts) == pager_counters(js)
    assert trie(ts) == trie(js)
    return outs


def trie(s):
    """The prefix trie's records without the payload CRCs (payload bytes
    differ across packages in the last bits)."""
    return [{k: v for k, v in r.items() if k != "crc32"}
            for r in s.prefix.export_records()]


# ---------------------------------------------------------------------- #
# the paged scheduler with a pager and a prefix cache
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("kv_codec", [None, "zlib", "int8"])
@pytest.mark.parametrize("spec_k", [0, 3])
def test_paged_scheduler_with_pager_and_prefix(pairs, spec_k, kv_codec):
    """Spill, refill, pool-shared prefix pages and a partial-page tail,
    in lockstep with the reference.  The int8 pool and int8 spills
    quantize the same float32 values with the same math in both
    packages, so at this size even its tokens agree exactly."""
    jside, tside = pairs("phi3-mini-3.8b")
    kw = dict(spec_k=spec_k, kv_codec=kv_codec)
    js, ts = build(J, jside, **kw), build(T, tside, **kw)
    lockstep(js, ts, shared_prompts(jside[0].vocab_size), paged=True)
    st = ts.stats
    assert st["spilled"] > 0 and st["refilled"] > 0
    assert st["prefix_hits"] > 0 and st["prefix_pool_shared"] > 0
    assert ts.prefix.stats["tail_hits"] > 0
    # what stays allocated is the pool-bound prefix pages alone
    assert ts.pool.used_pages() == len(ts.pool.resident_digests()) > 0
    assert ts.pager.pooled_pages() == 0
    # clean resumes move no KV bytes: only refills count
    assert st["kv_resume_bytes_moved"] == (
        st["refilled"] * ts.pool.pages_per_lane * ts.pool.page_nbytes)
    if kv_codec is not None:
        assert ts.pager.stack.stats["kv_bytes_encoded"] > 0
    js.close()
    ts.close()


# ---------------------------------------------------------------------- #
# the contiguous scheduler: slice mode and snapshot mode
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("arch,mode", [("phi3-mini-3.8b", "slice"),
                                       ("rwkv6-3b", "snapshot"),
                                       ("zamba2-2.7b", "snapshot")])
def test_contiguous_scheduler_with_pager_and_prefix(pairs, arch, mode):
    jside, tside = pairs(arch)
    js, ts = build(J, jside, paged=False), build(T, tside, paged=False)
    assert ts.prefix.mode == js.prefix.mode == mode
    prompts = shared_prompts(jside[0].vocab_size, n=5)
    # a live stream left in a slot: compare the lanes mid-run too
    lockstep(js, ts, prompts, paged=False)
    for name, lane in ts.slots_cache.items():
        np.testing.assert_allclose(lane.numpy(),
                                   np.asarray(js.slots_cache[name]),
                                   **LANE_TOL, err_msg=name)
    st = ts.stats
    assert st["parked"] > 0 and st["resumed"] > 0 and st["prefix_hits"] > 0
    js.close()
    ts.close()


def test_slot_step_and_prefill_match_reference(pairs):
    """The per-slot step (inactive slots at token 0, position 0) and the
    bucketed prefill against the reference's vmapped step and masked
    scan, on lanes at unequal positions."""
    (jcfg, jmodel, jparams), (tcfg, tmodel, tparams) = pairs("phi3-mini-3.8b")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, size=11).astype(np.int32)
    buf = np.zeros((16,), np.int32)
    buf[:11] = toks
    jlane = jsched.make_prefill_fn(jcfg, jmodel)(
        jparams, jax.device_get(jmodel.init_cache(jcfg, 1, MAX_LEN)),
        jax.numpy.asarray(buf), np.int32(2), np.int32(11))
    tlane = tsched.make_prefill_fn(tcfg, tmodel)(
        tparams, tmodel.init_cache(tcfg, 1, MAX_LEN, device="cpu"), buf, 2, 11)
    for k in tlane:
        np.testing.assert_allclose(tlane[k].numpy(), np.asarray(jlane[k]),
                                   **LANE_TOL)
    jslots = jax.tree_util.tree_map(lambda l: np.stack([l, l * 0, l]),
                                    jax.device_get(jlane))
    tslots = {k: torch.stack([v, v * 0, v]) for k, v in tlane.items()}
    tok = np.asarray([[5], [0], [9]], np.int32)
    pos = np.asarray([13, 0, 20], np.int32)
    jnext, jslots = jax.jit(jsched.make_slot_serve_step(jcfg, jmodel))(
        jparams, jslots, tok, pos)
    tnext, tslots = tsched.make_slot_serve_step(tcfg, tmodel)(
        tparams, tslots, torch.as_tensor(tok), pos)
    assert tnext.numpy().tolist() == np.asarray(jnext).tolist()
    for k in tslots:
        np.testing.assert_allclose(tslots[k].numpy(), np.asarray(jslots[k]),
                                   **LANE_TOL)


# ---------------------------------------------------------------------- #
# kill and restore
# ---------------------------------------------------------------------- #


def raw_bytes(t):
    t = t.contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def fingerprint(s):
    """What a restore must reproduce exactly: the pool's bytes (or the
    lanes'), the allocator, the parked pager tables and the trie."""
    out = {}
    if hasattr(s, "pool"):
        snap = s.pool.snapshot()
        out["pool"] = hashlib.sha256(
            b"".join(raw_bytes(snap[k]) for k in sorted(snap))).hexdigest()
        out["alloc"] = (s.pool.refcounts(), sorted(s.pool._free),
                        s.pool.resident_digests(), dict(sorted(s._ptables.items())))
    else:
        out["lanes"] = hashlib.sha256(b"".join(
            raw_bytes(s.slots_cache[k]) for k in sorted(s.slots_cache))).hexdigest()
    out["pager"] = {sid: (s.pager.page_table(sid), s.pager.parked_nbytes(sid),
                          s.pager.parked_kind(sid))
                    for sid in s.pager.parked_sids()}
    out["trie"] = (s.prefix.export_records(), s.prefix.stream_refs())
    out["streams"] = s.live_descriptors()
    return out


def run_until_checkpointable(s, paged):
    """Step until a stream sits parked off-slot (spilled, for the paged
    path) and a prefix page is bound in the pool."""
    for _ in range(200):
        s.step()
        if paged and s.stats["spilled"] and s.pool.resident_digests() \
                and s.pager.parked_sids():
            return
        if not paged and s.pager.parked_sids():
            return
    raise AssertionError("no spill / park to checkpoint")


def session(pkg, root):
    cluster = pkg.Cluster(4, 4, root=root)
    return cluster, pkg.Session.for_cluster(cluster, strategy=pkg.Strategy.XOR,
                                            procs_per_node=2)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_kill_and_restore_in_the_port_is_exact(pairs, tmp_path, paged):
    _, tside = pairs("phi3-mini-3.8b")
    prompts = shared_prompts(tside[0].vocab_size)
    ref = build(T, tside, paged=paged, spec_k=3 if paged else 0)
    sids = [ref.submit(p, max_new=MAX_NEW) for p in prompts]
    ref.run()
    want = [ref.output(s) for s in sids]
    ref.close()

    cluster, sess = session(T, tmp_path)
    s = build(T, tside, paged=paged, session=sess, spec_k=3 if paged else 0)
    for p in prompts:
        s.submit(p, max_new=MAX_NEW)
    run_until_checkpointable(s, paged)
    s.save()
    saved = fingerprint(s)
    s.close()
    cluster.fail(1)
    cluster.recover(1)
    sess.invalidate_node(1)
    s2 = build(T, tside, paged=paged, session=sess, spec_k=3 if paged else 0)
    s2.restore()
    assert fingerprint(s2) == saved
    s2.run()
    assert [s2.output(i) for i in sids] == want
    s2.close()
    sess.close()
    cluster.teardown()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_in_the_other_package(pairs, tmp_path, writer,
                                                  paged):
    """One package checkpoints mid-run (spilled / parked streams, prefix
    trie, pool-bound prefix pages) and loses a node; the other restores
    it and finishes with the tokens of its own uninterrupted run."""
    jside, tside = pairs("phi3-mini-3.8b")
    (wpkg, wside), (rpkg, rside) = (((J, jside), (T, tside)) if writer == "jax"
                                    else ((T, tside), (J, jside)))
    prompts = shared_prompts(jside[0].vocab_size)
    ref = build(rpkg, rside, paged=paged)
    sids = [ref.submit(p, max_new=MAX_NEW) for p in prompts]
    ref.run()
    want = [ref.output(s) for s in sids]
    ref.close()

    cluster, sess = session(wpkg, tmp_path / "run")
    w = build(wpkg, wside, paged=paged, session=sess)
    for p in prompts:
        w.submit(p, max_new=MAX_NEW)
    run_until_checkpointable(w, paged)
    w.save()
    sess.wait_drained()
    saved = w.live_descriptors()
    w.close()
    sess.close()

    cluster, sess = session(rpkg, tmp_path / "run")
    cluster.fail(1)
    cluster.recover(1)
    sess.invalidate_node(1)
    r = build(rpkg, rside, paged=paged, session=sess)
    r.restore()
    assert r.live_descriptors() == saved
    r.run()
    assert [r.output(s) for s in sids] == want
    r.close()
    sess.close()


# ---------------------------------------------------------------------- #
# ServeEngine and Serve.local
# ---------------------------------------------------------------------- #


def test_serve_engine_matches_reference(pairs, tmp_path):
    """prefill / decode / save / restore, the lockstep surface, in both
    packages; the restored engines continue as the uninterrupted ones."""
    jside, tside = pairs("phi3-mini-3.8b")
    prompt = np.random.default_rng(1).integers(
        0, jside[0].vocab_size, size=(2, 6)).astype(np.int32)
    got = {}
    for name, pkg, side in (("jax", J, jside), ("torch", T, tside)):
        cluster, sess = session(pkg, tmp_path / name)
        eng = pkg.Engine(*side, batch=2, max_len=MAX_LEN, scr=sess)
        first = np.asarray(eng.prefill(prompt)).tolist()
        head = [np.asarray(r).tolist() for r in eng.decode(5)]
        eng.save()
        tail = [np.asarray(r).tolist() for r in eng.decode(6)]
        eng2 = pkg.Engine(*side, batch=2, max_len=MAX_LEN, scr=sess)
        eng2.restore()
        again = [np.asarray(r).tolist() for r in eng2.decode(6)]
        assert again == tail
        got[name] = (first, head, tail)
        eng2.scheduler.close()
        sess.close()
        cluster.teardown()
    assert got["torch"] == got["jax"]


def test_serve_local_runs_on_its_defaults():
    """Prefix cache on, pager built, paged scheduler: the defaults."""
    with Serve.local(ServeConfig(device="cpu")) as srv:
        assert srv.pager is not None and srv.prefix_cache is not None
        assert isinstance(srv.scheduler, tsched.PagedServeScheduler)
        prompts = shared_prompts(srv.arch.vocab_size, n=4)
        sids = [srv.submit(p, max_new=MAX_NEW) for p in prompts]
        srv.run()
        assert all(len(srv.output(s)) == MAX_NEW for s in sids)
        assert srv.stats["prefix_hits"] > 0
        assert Serve.stats(srv)["merged"]["counters"]["sched"]["finished"] == 4
    for call in (lambda: ServeConfig().worker_spec("/x"),
                 lambda: Serve.fleet(ServeConfig())):
        with pytest.raises(NotImplementedError, match="1.4"):
            call()
    with pytest.raises(NotImplementedError, match="1.4"):
        TPager.for_fleet(None, fast_bytes=1)


def test_examples_serve_flow(tmp_path):
    """``examples/serve.py``'s local flow on the port with phi3: the
    contiguous path, decode partway, save through an XOR session, kill
    the scheduler and a node, restore in a fresh stack, finish
    byte-identically."""
    cfg = ServeConfig(arch="phi3-mini-3.8b", paged=False, slots=2, max_len=32,
                      page_tokens=4, quantum=3, device="cpu")
    rng = np.random.default_rng(7)
    srv = Serve.local(cfg)
    vocab = srv.arch.vocab_size
    system_prompt = rng.integers(0, vocab, size=9).tolist()
    prompts = [system_prompt
               + rng.integers(0, vocab, size=int(rng.integers(3, 8))).tolist()
               for _ in range(6)]
    for p in prompts:
        srv.submit(p, max_new=6)
    srv.run()
    ref = {sid: srv.output(sid) for sid in srv.scheduler.streams}
    ref_stats = dict(srv.stats)
    srv.close()

    cluster, sess = session(T, tmp_path)
    with sess:
        srv = Serve.local(cfg, session=sess)
        for p in prompts:
            srv.submit(p, max_new=6)
        srv.run(max_steps=8)
        srv.save()
        assert srv.pager.parked_sids()
        srv.close()
        cluster.fail(1)
        cluster.recover(1)
        sess.invalidate_node(1)
        srv2 = Serve.local(cfg, session=sess)
        srv2.restore()
        srv2.run()
        out = {sid: srv2.output(sid) for sid in srv2.scheduler.streams}
        srv2.close()
    assert out == ref
    assert ref_stats["parked"] > 0 and ref_stats["prefix_hits"] > 0
    assert ref_stats["prefill_tokens_saved"] > 0
    cluster.teardown()
