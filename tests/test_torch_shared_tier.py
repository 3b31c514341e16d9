"""The port's SharedTier (``repro_torch.memory.shared``) against the
reference's.

Case for case the reference's ``tests/test_shared_tier.py`` on the port:
the BufferStore contract, rename-commit (readers never see torn objects),
publisher-pid refcounted delete, the tier as a ``KVPager.for_fleet``
level, and real multi-process races (spawned children import the port's
tier only).  Then the two packages in lockstep: the same operations give
the same object bytes, manifests (but for the publish times) and
counters, and a domain written by either package is read, extended and
garbage-collected by the other.
"""

import json
import multiprocessing as mp
import os
import time
import zlib

import pytest

from repro_torch.memory.shared import SharedTier, _DomainLock
from repro_torch.memory.tiers import CapacityError


def _reference():
    """The reference's tier and capacity error, imported where a test
    needs them: the spawned children of the race tests import this module
    and need only the port."""
    from repro.memory.shared import SharedTier as JShared
    from repro.memory.tiers import CapacityError as JCapacityError

    return JShared, JCapacityError


def _blob(key: str, size: int = 512) -> bytes:
    # deterministic key -> content, verifiable from any process
    seed = zlib.crc32(key.encode()).to_bytes(4, "big")
    return (seed * (size // 4 + 1))[:size]


# --------------------------------------------------------------------------- #
# unit: BufferStore contract
# --------------------------------------------------------------------------- #

def test_put_get_roundtrip(tmp_path):
    st = SharedTier(tmp_path / "dom")
    st.put("kv/page/a.bin", b"hello")
    assert st.get("kv/page/a.bin") == b"hello"
    assert st.exists("kv/page/a.bin")
    assert list(st.keys()) == ["kv/page/a.bin"]
    assert st.used_bytes() == 5


def test_get_missing_raises_keyerror(tmp_path):
    st = SharedTier(tmp_path / "dom")
    with pytest.raises(KeyError):
        st.get("nope")
    assert not st.exists("nope")
    st.delete("nope")          # idempotent


def test_overwrite_replaces_and_accounts(tmp_path):
    st = SharedTier(tmp_path / "dom")
    st.put("k", b"x" * 100)
    st.put("k", b"y" * 40)
    assert st.get("k") == b"y" * 40
    assert st.used_bytes() == 40


def test_capacity_enforced(tmp_path):
    st = SharedTier(tmp_path / "dom", capacity_bytes=100)
    st.put("a", b"x" * 60)
    with pytest.raises(CapacityError):
        st.put("b", b"y" * 60)
    # overwrite frees the old size first
    st.put("a", b"z" * 90)
    assert st.get("a") == b"z" * 90


def test_put_stream_joins(tmp_path):
    st = SharedTier(tmp_path / "dom")
    st.put_stream("s", [b"ab", b"cd", b"ef"])
    assert st.get("s") == b"abcdef"


def test_key_sanitization(tmp_path):
    st = SharedTier(tmp_path / "dom")
    st.put("a/../b", b"x")     # traversal components dropped, not honored
    assert st.get("a/b") == b"x"
    with pytest.raises(KeyError):
        st.put("..", b"x")


def test_no_torn_reads_visible(tmp_path):
    # a .tmp left behind by a "crashed" writer is invisible to readers
    st = SharedTier(tmp_path / "dom")
    st.put("real", b"data")
    (st._objs / "ghost.123.0.tmp").write_bytes(b"partial")
    assert list(st.keys()) == ["real"]
    assert not st.exists("ghost")


def test_two_handles_same_root_share_objects(tmp_path):
    a = SharedTier(tmp_path / "dom")
    b = SharedTier(tmp_path / "dom")
    a.put("k", b"from-a")
    assert b.get("k") == b"from-a"
    assert b.used_bytes() == 6


def test_delete_refcounts_by_publisher(tmp_path):
    a = SharedTier(tmp_path / "dom")
    a.put("k", b"v")
    a.delete("k")
    assert not a.exists("k")
    assert a.manifest() == {}


def test_nonpublisher_delete_is_noop_on_object(tmp_path):
    a = SharedTier(tmp_path / "dom")
    a.put("k", b"v")
    b = SharedTier(tmp_path / "dom")
    b.delete("unrelated")
    assert a.get("k") == b"v"


def test_accepts_spill_flag(tmp_path):
    assert SharedTier(tmp_path / "dom").accepts_spill is True


def test_spec_is_shared_class(tmp_path):
    assert SharedTier(tmp_path / "dom").spec.shared is True


# --------------------------------------------------------------------------- #
# as a TierStack level
# --------------------------------------------------------------------------- #

def test_stack_reads_through_to_shared_level(tmp_path):
    from repro_torch.serve.kvpage import KVPager

    dom = tmp_path / "dom"
    a = KVPager.for_fleet(SharedTier(dom), fast_bytes=1 << 20)
    b = KVPager.for_fleet(SharedTier(dom), fast_bytes=1 << 20)
    a.stack.put_at("shared", "kv/prefix/x.bin", b"page-bytes")
    # b's fast tier misses, the shared level hits
    assert b.stack.get("kv/prefix/x.bin") == b"page-bytes"
    st = b.stack.stats()
    assert st["hits_shared"] == 1 and st["misses_hbm"] == 1
    assert a.stack.stats()["direct_puts"] == 1
    a.close()
    b.close()


def test_put_at_unknown_level_raises(tmp_path):
    from repro_torch.serve.kvpage import KVPager

    p = KVPager.for_fleet(SharedTier(tmp_path / "dom"), fast_bytes=1 << 20)
    with pytest.raises(KeyError):
        p.stack.put_at("nvme-of", "k", b"x")
    p.close()


def test_for_fleet_stack_matches_reference(tmp_path):
    """The port's fleet pager and the reference's: the same levels, the
    same reads through the shared level and the same counters."""
    from repro.serve.kvpage import KVPager as JPager
    from repro_torch.serve.kvpage import KVPager

    JShared, _ = _reference()
    stats = []
    for pager_cls, tier_cls, name in ((KVPager, SharedTier, "port"),
                                      (JPager, JShared, "ref")):
        dom = tmp_path / name
        a = pager_cls.for_fleet(tier_cls(dom), fast_bytes=1 << 20)
        b = pager_cls.for_fleet(tier_cls(dom), fast_bytes=1 << 20)
        assert [n for n, _ in a.stack.levels] == ["hbm", "shared"]
        for i in range(4):
            a.stack.put_at("shared", f"kv/prefix/p{i}.bin", _blob(str(i)))
        for i in (0, 1, 1, 2, 0):
            assert b.stack.get(f"kv/prefix/p{i}.bin") == _blob(str(i))
        stats.append((a.stack.stats(), b.stack.stats()))
        a.close()
        b.close()
    assert stats[0] == stats[1]


# --------------------------------------------------------------------------- #
# real multi-process races
# --------------------------------------------------------------------------- #

def _race_writer(root, worker, n_keys, barrier):
    st = SharedTier(root)
    barrier.wait()
    for r in range(3):
        for i in range(n_keys):
            key = f"kv/obj{i:03d}.bin"
            try:
                st.put(key, _blob(key))
            except CapacityError:
                pass
            if (i + worker + r) % 4 == 0:
                st.delete(key)


def _race_reader(root, n_keys, barrier, errq):
    st = SharedTier(root)
    barrier.wait()
    for _ in range(4):
        for i in range(n_keys):
            key = f"kv/obj{i:03d}.bin"
            try:
                data = st.get(key)
            except KeyError:
                continue              # deleted between exists and get: legal
            if data != _blob(key):
                errq.put(f"torn read on {key}: {len(data)} bytes")


@pytest.mark.parametrize("n_writers", [2, 3])
def test_concurrent_put_get_delete_across_processes(tmp_path, n_writers,
                                                    monkeypatch):
    """Writers race put/delete while readers verify every successful get
    returns the complete expected content — the rename-commit claim."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ctx = mp.get_context("spawn")
    root, n_keys = tmp_path / "dom", 24
    SharedTier(root)               # create the domain up front
    barrier = ctx.Barrier(n_writers + 1)
    errq = ctx.Queue()
    procs = [ctx.Process(target=_race_writer,
                         args=(root, w, n_keys, barrier))
             for w in range(n_writers)]
    procs.append(ctx.Process(target=_race_reader,
                             args=(root, n_keys, barrier, errq)))
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
        assert p.exitcode == 0
    assert errq.empty(), errq.get()
    # manifest consistent with the object directory after the dust settles
    st = SharedTier(root)
    manifest = st.manifest()
    assert sorted(manifest) == list(st.keys())
    for key, entry in manifest.items():
        assert entry["size"] == len(st.get(key))
    # and the reference reads the same domain the same way
    jst = _reference()[0](root)
    assert jst.manifest() == manifest
    assert all(jst.get(key) == st.get(key) for key in manifest)


def _pub_then_wait_delete(root, key, started, release):
    st = SharedTier(root)
    st.put(key, _blob(key))
    started.set()
    release.wait(60)
    st.delete(key)


def test_publisher_refcount_across_processes(tmp_path, monkeypatch):
    """A publishes, B publishes; A's delete must NOT unlink (B still
    holds it), B's delete must."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ctx = mp.get_context("spawn")
    root, key = tmp_path / "dom", "kv/sharedpage.bin"
    st = SharedTier(root)
    a_started, a_release = ctx.Event(), ctx.Event()
    pa = ctx.Process(target=_pub_then_wait_delete,
                     args=(root, key, a_started, a_release))
    pa.start()
    assert a_started.wait(60)
    st.put(key, _blob(key))        # this process is the second publisher
    assert len(st.manifest()[key]["pubs"]) == 2
    a_release.set()                # A deletes (unregisters itself)...
    pa.join(60)
    assert pa.exitcode == 0
    assert st.get(key) == _blob(key)   # ...object survives for us
    assert st.manifest()[key]["pubs"] == [os.getpid()]
    st.delete(key)                 # last publisher lets go
    assert not st.exists(key)
    assert key not in st.manifest()


# --------------------------------------------------------------------------- #
# the two packages in lockstep
# --------------------------------------------------------------------------- #

def _ops(tier, capacity_error):
    """One script of operations; returns what each returned or raised."""
    seen = []
    tier.put("kv/page/a.bin", b"alpha" * 20)
    tier.put_stream("kv/page/b.bin", [b"be", b"ta" * 30])
    tier.put("kv/prefix/c.bin", _blob("c", 300))
    seen.append(tier.append("obs/flight/w0.jsonl", b'{"a":1}\n'))
    seen.append(tier.append("obs/flight/w0.jsonl", b'{"b":2}\n'))
    try:
        tier.put("big", b"x" * 10_000)
    except capacity_error:
        seen.append("capacity")
    tier.put("kv/page/a.bin", b"omega" * 3)     # overwrite
    tier.delete("kv/page/b.bin")
    tier.delete("never")
    seen.append(list(tier.keys()))
    seen.append(tier.used_bytes())
    seen.append(tier.exists("kv/page/b.bin"))
    return seen


def _strip_times(manifest):
    return {k: {f: v for f, v in e.items() if f != "t"}
            for k, e in manifest.items()}


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if rel == "manifest.json":
                continue
            with open(path, "rb") as f:
                out[rel] = f.read()
    return out


def test_same_operations_give_the_same_domain(tmp_path):
    """The same script through both packages: equal return values, object
    files and lock files byte for byte, the same manifest but for the
    publish times, and the same GC results and counters."""
    JShared, JCapacityError = _reference()
    port = SharedTier(tmp_path / "port", capacity_bytes=4096)
    ref = JShared(tmp_path / "ref", capacity_bytes=4096)
    assert _ops(port, CapacityError) == _ops(ref, JCapacityError)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    mp_, mr = port.manifest(), ref.manifest()
    assert _strip_times(mp_) == _strip_times(mr)
    assert set(mp_) == set(mr)
    # the manifest file is the reference's JSON layout: sorted keys, the
    # same separators; equal once the times are equal
    raw_p = json.loads((tmp_path / "port" / "manifest.json").read_bytes())
    raw_r = json.loads((tmp_path / "ref" / "manifest.json").read_bytes())
    for k in raw_p:
        raw_p[k]["t"] = raw_r[k]["t"] = 0.0
    assert json.dumps(raw_p, sort_keys=True) == json.dumps(raw_r, sort_keys=True)
    now = time.time() + 3600
    for kw in (dict(ttl_s=0.0, now=now), dict(ttl_s=3600.0, pid_alive=lambda p: False),
               dict(ttl_s=1.0, pid_alive=lambda p: False, now=now)):
        assert port.gc(**kw) == ref.gc(**kw)
    assert dict(port.gc_stats) == dict(ref.gc_stats)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_domain_written_by_one_package_is_read_by_the_other(tmp_path, writer):
    """Objects, journals and manifests cross in both directions: the
    reader sees every object, extends a journal, unregisters itself only
    (refcounts by pid), and sweeps with the writer's records."""
    JShared, _ = _reference()
    w_cls, r_cls = (SharedTier, JShared) if writer == "port" else (JShared, SharedTier)
    w = w_cls(tmp_path / "dom")
    w.put("kv/prefix/x.bin", _blob("x"))
    w.append("obs/flight/w1.jsonl", b'{"n":1}\n')
    r = r_cls(tmp_path / "dom")
    assert r.get("kv/prefix/x.bin") == _blob("x")
    assert list(r.keys()) == ["kv/prefix/x.bin", "obs/flight/w1.jsonl"]
    assert r.append("obs/flight/w1.jsonl", b'{"n":2}\n') == 16
    assert w.get("obs/flight/w1.jsonl") == b'{"n":1}\n{"n":2}\n'
    assert r.used_bytes() == w.used_bytes() == 512 + 16
    r.put("kv/prefix/y.bin", b"y")
    assert w.manifest() == r.manifest()
    # both handles are this process: one publisher, one delete unlinks
    w.delete("kv/prefix/y.bin")
    assert not r.exists("kv/prefix/y.bin")
    res = r.gc(ttl_s=0.0, pid_alive=lambda p: False, now=time.time() + 60)
    assert res["gc_reclaimed"] == 2 and w.manifest() == {}


def test_lock_file_is_shared_across_packages(tmp_path, monkeypatch):
    """Both packages take the same advisory lock: one package holding it
    excludes the other's manifest update (a child process, since the lock
    is per open file description)."""
    JShared, _ = _reference()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    tier = SharedTier(tmp_path / "dom")
    assert tier._lock_path.name == JShared(tmp_path / "dom")._lock_path.name
    ctx = mp.get_context("spawn")
    done = ctx.Event()
    p = ctx.Process(target=_locked_put, args=(tmp_path / "dom", done))
    with _DomainLock(tier._lock_path):
        p.start()
        assert not done.wait(1.0)      # the reference's put waits on us
    assert done.wait(60)
    p.join(60)
    assert p.exitcode == 0
    assert tier.get("k") == b"ref"


def _locked_put(root, done):
    _reference()[0](root).put("k", b"ref")
    done.set()
