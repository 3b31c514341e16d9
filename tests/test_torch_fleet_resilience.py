"""The port's elastic fleet against the reference's: failure detection,
epoch checkpoints, stream migration, board batching, shared-domain GC.

Case for case the reference's ``tests/test_fleet_resilience.py`` on the
port: the board's record kinds and bounded batches, the shared tier's GC,
``save_epoch`` / ``load_epoch`` (also across the two packages, both ways),
the front-end's failure detector and recovery over stub workers (each
scenario through both packages' front-ends, with the same decisions), and
the construction surface of ``ServeConfig`` / ``Serve.fleet``.  Then a
real fleet on the CPU: one of two workers SIGKILLed after its first epoch
record, its streams finished on the survivor with exactly the tokens of
the in-process ``Serve.local`` run, and its flight records read back.
"""

import os
import time

import numpy as np
import pytest

from repro_torch.memory.shared import SharedTier
from repro_torch.serve.fleet.board import PrefixBoard, record_kind
from repro_torch.serve.fleet.worker import epoch_domain, load_epoch, save_epoch


def frontends():
    import repro.serve.fleet.frontend as jfe
    import repro_torch.serve.fleet.frontend as tfe

    return {"port": tfe, "ref": jfe}


def epoch_fns():
    import repro.api.session as jsess
    import repro.serve.fleet.worker as jw
    import repro_torch.api.session as tsess
    import repro_torch.serve.fleet.worker as tw

    return {"port": (tw.save_epoch, tw.load_epoch, tsess.ResilienceSession),
            "ref": (jw.save_epoch, jw.load_epoch, jsess.ResilienceSession)}


# --------------------------------------------------------------------------- #
# board: record kinds + bounded batches
# --------------------------------------------------------------------------- #

def _prec(i, **extra):
    return dict({"digest": f"d{i}", "parent": "", "chunk": [i], "end": 1,
                 "nbytes": 4, "crc32": 0}, **extra)


def test_record_kind_defaults_to_prefix():
    assert record_kind(_prec(0)) == "prefix"
    assert record_kind({"kind": "epoch", "worker": "w0"}) == "epoch"


def test_board_batched_poll_exact_cursor(tmp_path):
    a, b = PrefixBoard(tmp_path), PrefixBoard(tmp_path)
    a.publish([_prec(i) for i in range(5)])
    a.publish([{"kind": "epoch", "worker": "w0", "pid": 1, "step": 4,
                "t": 0.0}])
    a.publish([_prec(i) for i in range(5, 7)])
    got = b.poll(3)
    assert [r["digest"] for r in got] == ["d0", "d1", "d2"]
    got = b.poll(3)
    assert [r.get("digest") for r in got] == ["d3", "d4", None]
    assert record_kind(got[-1]) == "epoch"
    got = b.poll(3)                      # fewer remaining than the batch
    assert [r["digest"] for r in got] == ["d5", "d6"]
    assert b.poll(3) == []
    assert len(PrefixBoard(tmp_path).poll()) == 8


def test_board_batched_poll_with_torn_tail(tmp_path):
    a, b = PrefixBoard(tmp_path), PrefixBoard(tmp_path)
    a.publish([_prec(i) for i in range(3)])
    with open(a.path, "ab") as f:
        f.write(b'{"digest": "partial')
    assert [r["digest"] for r in b.poll(2)] == ["d0", "d1"]
    assert [r["digest"] for r in b.poll(2)] == ["d2"]
    assert b.poll(2) == []


# --------------------------------------------------------------------------- #
# shared tier: board-age GC
# --------------------------------------------------------------------------- #

def test_gc_reclaims_only_dead_and_old(tmp_path):
    tier = SharedTier(tmp_path / "dom")
    tier.put("a", b"x" * 10)
    tier.put("b", b"y" * 20)
    res = tier.gc(ttl_s=0.0, now=time.time() + 3600)
    assert res["gc_reclaimed"] == 0 and res["gc_pinned_live"] == 2
    res = tier.gc(ttl_s=3600.0, pid_alive=lambda p: False)
    assert res["gc_reclaimed"] == 0 and res["gc_pinned_young"] == 2
    res = tier.gc(ttl_s=1.0, pid_alive=lambda p: False,
                  now=time.time() + 3600)
    assert res["gc_reclaimed"] == 2
    assert res["gc_reclaimed_bytes"] == 30
    with pytest.raises(KeyError):
        tier.get("a")
    assert tier.used_bytes() == 0
    assert tier.gc_stats["gc_runs"] == 3
    assert tier.gc_stats["gc_reclaimed"] == 2


def test_gc_live_publisher_pins_shared_object(tmp_path):
    tier = SharedTier(tmp_path / "dom")
    tier.put("k", b"z" * 8)
    me = os.getpid()
    res = tier.gc(ttl_s=0.0, pid_alive=lambda p: p == me,
                  now=time.time() + 3600)
    assert res["gc_reclaimed"] == 0 and res["gc_pinned_live"] == 1
    assert tier.get("k") == b"z" * 8


def test_gc_missing_timestamp_counts_as_old(tmp_path):
    from repro_torch.memory.shared import _DomainLock

    tier = SharedTier(tmp_path / "dom")
    tier.put("k", b"q" * 4)
    with _DomainLock(tier._lock_path):
        m = tier._read_manifest()
        m["k"].pop("t")
        tier._write_manifest(m)
    res = tier.gc(ttl_s=10.0, pid_alive=lambda p: False)
    assert res["gc_reclaimed"] == 1


# --------------------------------------------------------------------------- #
# epoch checkpoints: save/load roundtrip through the shared tier
# --------------------------------------------------------------------------- #

class StubSched:
    def __init__(self, descs):
        self._descs = descs

    def live_descriptors(self):
        return list(self._descs)


DESCS = [
    {"sid": 0, "tokens": [1, 2, 3, 4, 5], "plen": 3,
     "emitted": [4, 5], "max_new": 4, "weight": 2},
    {"sid": 1, "tokens": [7, 8, 9], "plen": 3,
     "emitted": [], "max_new": 6, "weight": 1},
    {"sid": 2, "tokens": [6, 6], "plen": 2,
     "emitted": [], "max_new": 1, "weight": 1},
]


def test_epoch_roundtrip(tmp_path):
    from repro_torch.api.session import ResilienceSession

    sess = ResilienceSession.for_shared_tier(
        tmp_path, domain=epoch_domain("w7"))
    try:
        n = save_epoch(sess, StubSched(DESCS), {0: 101, 1: 102}, step=9)
        assert n == 2
    finally:
        sess.close()

    ep = load_epoch(tmp_path, "w7")
    assert set(ep) == {101, 102}
    assert ep[101]["prompt"] == [1, 2, 3]
    assert ep[101]["emitted"] == [4, 5]
    assert ep[101]["max_new_total"] == 6
    assert ep[101]["weight"] == 2 and ep[101]["step"] == 9
    assert ep[102]["prompt"] == [7, 8, 9] and ep[102]["emitted"] == []
    assert ep[102]["max_new_total"] == 6


def test_epoch_last_wins(tmp_path):
    from repro_torch.api.session import ResilienceSession

    sess = ResilienceSession.for_shared_tier(
        tmp_path, domain=epoch_domain("w0"))
    try:
        d = {"sid": 0, "tokens": [1, 2, 3], "plen": 2, "emitted": [3],
             "max_new": 5, "weight": 1}
        save_epoch(sess, StubSched([d]), {0: 42}, step=4)
        d2 = dict(d, tokens=[1, 2, 3, 9], emitted=[3, 9], max_new=4)
        save_epoch(sess, StubSched([d2]), {0: 42}, step=8)
    finally:
        sess.close()
    ep = load_epoch(tmp_path, "w0")
    assert ep[42]["emitted"] == [3, 9] and ep[42]["step"] == 8


def test_load_epoch_missing_is_empty(tmp_path):
    assert load_epoch(tmp_path, "never-started") == {}
    assert load_epoch(tmp_path / "absent", "w0") == {}


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_epoch_crosses_packages(tmp_path, writer):
    """An epoch saved by either package loads in the other to the same
    descriptors; the epoch domain's names match."""
    fns = epoch_fns()
    save, _, session = fns[writer]
    reader = fns["ref" if writer == "port" else "port"][1]
    import repro.serve.fleet.worker as jw

    assert jw.epoch_domain("w3") == epoch_domain("w3") == "scr-w3"
    sess = session.for_shared_tier(tmp_path, domain=epoch_domain("w3"))
    try:
        assert save(sess, StubSched(DESCS), {0: 7, 1: 8}, step=5) == 2
    finally:
        sess.close()
    assert reader(tmp_path, "w3") == fns[writer][1](tmp_path, "w3")
    assert set(reader(tmp_path, "w3")) == {7, 8}


# --------------------------------------------------------------------------- #
# failure detector + migration (stub workers), through both packages
# --------------------------------------------------------------------------- #

class DeadableWorker:
    """WorkerHandle stand-in with a controllable liveness surface: the
    test scripts heartbeats, token emissions, and process death."""

    def __init__(self):
        self.submitted = []
        self._out = []
        self.hb_age = 0.0
        self.is_alive = True

    def submit(self, rid, prompt, max_new, weight=1):
        self.submitted.append({"rid": rid, "prompt": list(prompt),
                               "max_new": int(max_new), "weight": weight})

    def emit(self, rid, tokens):
        self._out.append({"op": "tokens", "rid": rid,
                          "tokens": list(tokens)})

    def emit_done(self, rid, tokens):
        self._out.append({"op": "done", "rid": rid, "tokens": list(tokens)})

    def messages(self):
        out, self._out = self._out, []
        return out

    def heartbeat_age(self):
        return self.hb_age

    def alive(self):
        return self.is_alive

    def stats(self):
        return {}

    def stop(self):
        pass


def lockstep(scenario):
    got = {name: scenario(mod) for name, mod in frontends().items()}
    assert got["port"] == got["ref"]


def decisions(fe, workers):
    return {"submitted": [w.submitted for w in workers],
            "stats": dict(fe.stats.items()),
            "states": [fe.worker_state(i) for i in range(len(workers))],
            "live": fe.live_workers()}


def test_slow_but_alive_is_suspect_never_dead():
    def scenario(m):
        w0, w1 = DeadableWorker(), DeadableWorker()
        fe = m.FleetFrontend([w0, w1], hb_timeout_s=1.0)
        rid = fe.submit([1, 2, 3], 5)
        fe.pump()
        assert fe.assignment(rid) == 0
        w0.emit(rid, [10, 11])
        fe.pump()
        assert fe.progress(rid) == [10, 11]
        w0.hb_age = 1e9
        for _ in range(3):
            fe.pump()
        assert fe.worker_state(0) == "suspect"
        assert fe.stats["workers_failed"] == 0
        assert fe.assignment(rid) == 0
        assert not w1.submitted
        suspect = decisions(fe, [w0, w1])
        w0.hb_age = 0.0
        fe.pump()
        assert fe.worker_state(0) == "ok"
        return suspect, decisions(fe, [w0, w1])

    lockstep(scenario)


def test_dead_worker_streams_migrate_with_replay():
    def scenario(m):
        w0, w1 = DeadableWorker(), DeadableWorker()
        fe = m.FleetFrontend([w0, w1], hb_timeout_s=0.5)
        rid = fe.submit([1, 2, 3], 5)
        fe.pump()
        w0.emit(rid, [10, 11])
        fe.pump()
        w0.hb_age, w0.is_alive = 10.0, False
        fe.pump()
        assert fe.worker_state(0) == "dead"
        assert fe.stats["workers_failed"] == 1
        assert fe.stats["streams_migrated"] == 1
        assert fe.assignment(rid) == 1
        sub = w1.submitted[0]
        assert sub["prompt"] == [1, 2, 3, 10, 11]
        assert sub["max_new"] == 3
        w1.emit_done(rid, [12, 13, 14])
        fe.pump()
        assert fe.result(rid) == [10, 11, 12, 13, 14]
        assert fe.stats["completed"] == 1
        assert fe.live_workers() == [1]
        assert fe.worker_stats() == [{}]
        return decisions(fe, [w0, w1]), fe.result(rid)

    lockstep(scenario)


def test_recovery_completes_budget_spent_stream():
    def scenario(m):
        w0, w1 = DeadableWorker(), DeadableWorker()
        fe = m.FleetFrontend([w0, w1], hb_timeout_s=0.5)
        rid = fe.submit([4, 4], 2)
        fe.pump()
        w0.emit(rid, [5, 6])
        fe.pump()
        w0.hb_age, w0.is_alive = 10.0, False
        fe.pump()
        assert fe.result(rid) == [5, 6]
        assert fe.stats["streams_completed_on_recovery"] == 1
        assert not w1.submitted
        return decisions(fe, [w0, w1])

    lockstep(scenario)


@pytest.mark.parametrize("saver", ["port", "ref"])
def test_recovery_prefers_longer_epoch_prefix(tmp_path, saver):
    """The worker's last epoch may be ahead of what reached the front-end:
    recovery replays the longer prefix.  The epoch is saved by either
    package and both front-ends recover from it the same way."""
    from types import SimpleNamespace

    save, _, session = epoch_fns()[saver]

    def scenario(m):
        root = tmp_path / m.__name__.split(".")[0]
        w0, w1 = DeadableWorker(), DeadableWorker()
        w0.spec = SimpleNamespace(ckpt_every=4, shared_root=str(root),
                                  name="w0")
        fe = m.FleetFrontend([w0, w1], hb_timeout_s=0.5)
        rid = fe.submit([1, 2], 6)
        fe.pump()
        w0.emit(rid, [30])
        fe.pump()
        sess = session.for_shared_tier(root, domain=epoch_domain("w0"))
        try:
            save(sess, StubSched([
                {"sid": 0, "tokens": [1, 2, 30, 31, 32], "plen": 2,
                 "emitted": [30, 31, 32], "max_new": 3, "weight": 1}]),
                {0: rid}, step=4)
        finally:
            sess.close()
        w0.hb_age, w0.is_alive = 10.0, False
        fe.pump()
        sub = w1.submitted[0]
        assert sub["prompt"] == [1, 2, 30, 31, 32] and sub["max_new"] == 3
        w1.emit_done(rid, [33, 34, 35])
        fe.pump()
        assert fe.result(rid) == [30, 31, 32, 33, 34, 35]
        return decisions(fe, [w0, w1])

    lockstep(scenario)


def test_dispatch_with_all_workers_dead_raises():
    for m in frontends().values():
        w0 = DeadableWorker()
        fe = m.FleetFrontend([w0], hb_timeout_s=0.5)
        rid = fe.submit([1], 3)
        fe.pump()
        w0.emit(rid, [9])
        fe.pump()
        w0.hb_age, w0.is_alive = 10.0, False
        with pytest.raises(RuntimeError, match="no live workers"):
            fe.pump()


def test_stub_without_liveness_surface_is_trusted():
    class Plain:
        def __init__(self):
            self.submitted = []

        def submit(self, rid, prompt, max_new, weight=1):
            self.submitted.append(rid)

        def messages(self):
            return []

        def stop(self):
            pass

    def scenario(m):
        fe = m.FleetFrontend([Plain()], hb_timeout_s=0.0)
        fe.submit([1], 1)
        fe.pump()
        assert fe.worker_state(0) == "ok"
        assert fe.stats["workers_failed"] == 0
        return dict(fe.stats.items())

    lockstep(scenario)


# --------------------------------------------------------------------------- #
# unified serving API construction surface (no model build)
# --------------------------------------------------------------------------- #

def test_serve_config_worker_spec_carries_resilience_knobs(tmp_path):
    """The port's spec carries every field the reference's does, with the
    same values, plus ``device`` and ``full_size``."""
    from repro.serve import ServeConfig as JConfig
    from repro_torch.serve import ServeConfig

    kw = dict(arch="phi3-mini-3.8b", slots=3, max_len=64, page_tokens=8,
              ckpt_every=6, hb_interval_s=0.07, adopt_batch=32, seed=5)
    spec = ServeConfig(**kw, device="cpu", full_size=True).worker_spec(
        str(tmp_path), name="w9")
    assert spec.name == "w9" and spec.ckpt_every == 6
    assert spec.hb_interval_s == 0.07 and spec.adopt_batch == 32
    assert spec.slots == 3 and spec.max_len == 64
    assert spec.page_tokens == 8 and spec.seed == 5
    assert spec.shared_root == str(tmp_path)
    assert spec.device == "cpu" and spec.full_size is True
    jspec = JConfig(**kw).worker_spec(str(tmp_path), name="w9")
    fields = dict(vars(spec))
    assert fields.pop("device") == "cpu" and fields.pop("full_size") is True
    assert fields == vars(jspec)


def test_serve_fleet_rejects_zero_workers():
    from repro_torch.serve import Serve, ServeConfig

    with pytest.raises(ValueError):
        Serve.fleet(ServeConfig(), workers=0)


# --------------------------------------------------------------------------- #
# a real fleet on the CPU: kill one of two, recover, same tokens
# --------------------------------------------------------------------------- #

def test_killed_worker_streams_finish_token_identical(tmp_path, monkeypatch):
    """fig13's scenario at a reduced size: two workers epoch-checkpoint
    every 4 steps; worker 0 is SIGKILLed once its epoch record is on the
    board and each of its streams has emitted a token; the front-end
    declares it dead, re-admits its streams on worker 1, and every stream
    ends with the tokens of an uninterrupted in-process run.  The dead
    worker's flight records hold decode steps, and the shared domain's GC
    reclaims its objects."""
    from repro_torch.serve import Serve, ServeConfig

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = ServeConfig(slots=2, max_len=64, page_tokens=4, quantum=3,
                      ckpt_every=4, hb_interval_s=0.05, hb_timeout_s=0.3,
                      device="cpu")
    rng = np.random.default_rng(13)
    sysp = rng.integers(0, 512, size=8).tolist()
    prompts = [sysp + rng.integers(0, 512, size=int(rng.integers(3, 7))).tolist()
               for _ in range(4)]
    max_new = 24
    with Serve.local(cfg) as srv:
        sids = [srv.submit(p, max_new=max_new) for p in prompts]
        srv.run()
        want = [srv.output(s) for s in sids]
    fe = Serve.fleet(cfg, workers=2, shared_root=str(tmp_path))
    try:
        board = PrefixBoard(tmp_path)
        t_submit = time.time()
        rids = [fe.submit(p, max_new=max_new) for p in prompts]
        victims, killed, epoch_seen = [], None, False
        deadline = time.monotonic() + 300
        while not all(len(fe.progress(r)) >= max_new for r in rids):
            assert time.monotonic() < deadline, "the fleet stalled"
            fe.pump()
            if killed is None:
                victims = victims or [r for r in rids if fe.assignment(r) == 0]
                epoch_seen = epoch_seen or any(
                    record_kind(rec) == "epoch" and rec.get("worker") == "w0"
                    and rec.get("t", 0.0) >= t_submit for rec in board.poll())
                if (victims and epoch_seen and all(
                        1 <= len(fe.progress(r)) < max_new for r in victims)):
                    killed = list(victims)
                    fe.workers[0].kill()
            time.sleep(0.002)
        assert killed, "the kill never fired"
        # a stream's last tokens can reach the front-end a pump before
        # its "done"
        fe.wait(rids, timeout=300)
        outs = [fe.result(r) for r in rids]
        assert outs == want
        assert [fe.worker_state(i) for i in range(2)] == ["dead", "ok"]
        assert fe.stats["workers_failed"] == 1
        assert fe.stats["streams_migrated"] == len(killed)
        assert fe.stats["completed"] == len(prompts)
        post = fe.postmortem(0, last=64)
        assert post["worker"] == "w0" and "step" in {
            r["name"] for r in post["records"]}
        assert fe.gc_shared(ttl_s=0.0)["gc_reclaimed"] > 0
    finally:
        fe.stop()
