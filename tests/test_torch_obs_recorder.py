"""The port's flight recorder (``repro_torch.obs.recorder``) against the
reference's.

Case for case the recorder cases of the reference's ``tests/test_obs.py``
on the port: the bounded pending buffer, the append-only flush through the
shared tier, the torn-tail read, a failed flush keeping its records, and a
real worker (on the CPU) killed mid-decode whose timeline is read back by
the front-end.  Then both packages in lockstep: the same records give the
same journal bytes, and either package reads the other's journal.
"""

import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch.memory.shared import SharedTier
from repro_torch.obs import FlightRecorder, Tracer, flight_key, read_flight


def test_tracer_sink_receives_every_completed_record():
    rec = FlightRecorder("w0")
    tr = Tracer(sink=rec)
    with tr.span("step"):
        pass
    tr.event("finish")
    assert rec.pending() == 2


def test_recorder_rejects_zero_capacity():
    with pytest.raises(ValueError):
        FlightRecorder("w0", capacity=0)
    assert FlightRecorder("").worker == "w" and flight_key("") == "obs/flight/w.jsonl"


def test_recorder_bounded_pending_drops_oldest():
    rec = FlightRecorder("w0", capacity=3)
    for i in range(5):
        rec.record({"name": f"e{i}", "ph": "i", "ts": float(i)})
    assert rec.pending() == 3 and rec.dropped == 2


def test_recorder_flush_and_read_roundtrip(tmp_path):
    tier = SharedTier(tmp_path / "dom")
    rec = FlightRecorder("w3")
    rec.record({"name": "step", "ph": "X", "ts": 1.0, "dur": 0.1, "tid": 0})
    rec.record({"name": "finish", "ph": "i", "ts": 1.2, "tid": 4})
    assert rec.flush(tier) == 2
    assert rec.pending() == 0 and rec.flushed == 2
    assert rec.flush(tier) == 0              # nothing pending: no write
    rec.record({"name": "park", "ph": "i", "ts": 1.3, "tid": 4})
    rec.flush(tier)                          # second flush appends
    records, torn = read_flight(tier, "w3")
    assert torn == 0
    assert [r["name"] for r in records] == ["step", "finish", "park"]
    assert all(r["proc"] == "w3" for r in records)
    # last=N tails the timeline
    tail, _ = read_flight(tier, "w3", last=2)
    assert [r["name"] for r in tail] == ["finish", "park"]
    # a worker that never flushed reads as empty, not an error
    assert read_flight(tier, "never") == ([], 0)


def test_read_flight_tolerates_torn_tail(tmp_path):
    """A SIGKILL mid-append tears at most the final record; every line
    before it is intact because the journal is append-only."""
    tier = SharedTier(tmp_path / "dom")
    rec = FlightRecorder("w9")
    for i in range(3):
        rec.record({"name": f"e{i}", "ph": "i", "ts": float(i)})
    rec.flush(tier)
    # the kill: a half-written final record
    tier.append(flight_key("w9"), b'{"name":"e3","ph":"X","ts":3')
    records, torn = read_flight(tier, "w9")
    assert torn == 1
    assert [r["name"] for r in records] == ["e0", "e1", "e2"]


def test_recorder_failed_flush_keeps_pending():
    class Refusing:
        def append(self, key, data):
            raise OSError("shared domain unreachable")

    rec = FlightRecorder("w0")
    rec.record({"name": "step", "ph": "i", "ts": 0.0})
    with pytest.raises(OSError):
        rec.flush(Refusing())
    assert rec.pending() == 1                # buffer intact for retry


# --------------------------------------------------------------------------- #
# the two packages in lockstep
# --------------------------------------------------------------------------- #

RECORDS = [{"name": "step", "ph": "X", "ts": 1.0, "dur": 0.25, "tid": 0,
            "args": {"active": 2, "path": Path("/x")}},
           {"name": "finish", "ph": "i", "ts": 1.5, "tid": 4},
           {"name": "park", "ph": "i", "ts": 2.0, "tid": 4, "args": {}}]


def test_same_records_give_the_same_journal(tmp_path):
    """The same records (one not JSON-native) through both recorders and
    both tiers: the same journal bytes, counters and read-back, with the
    same torn-tail count once both are torn the same way."""
    from repro.memory.shared import SharedTier as JShared
    from repro.obs.recorder import FlightRecorder as JRecorder
    from repro.obs.recorder import read_flight as jread

    out = []
    for rec_cls, tier_cls, read, name in (
            (FlightRecorder, SharedTier, read_flight, "port"),
            (JRecorder, JShared, jread, "ref")):
        tier = tier_cls(tmp_path / name)
        rec = rec_cls("w1", capacity=2)
        for r in RECORDS:
            rec.record(r)
        flushed = rec.flush(tier)
        rec.record(RECORDS[0])
        rec.flush(tier)
        tier.append(flight_key("w1"), b'{"name":"st')
        out.append((tier.get(flight_key("w1")), flushed, rec.dropped,
                    rec.flushed, read(tier, "w1"), read(tier, "w1", last=1)))
    assert out[0] == out[1]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_journal_written_by_one_package_is_read_by_the_other(tmp_path, writer):
    from repro.memory.shared import SharedTier as JShared
    from repro.obs.recorder import FlightRecorder as JRecorder
    from repro.obs.recorder import read_flight as jread

    w_tier, w_rec, r_tier, r_read = (
        (SharedTier, FlightRecorder, JShared, jread) if writer == "port"
        else (JShared, JRecorder, SharedTier, read_flight))
    rec = w_rec("w2")
    for r in RECORDS:
        rec.record(r)
    rec.flush(w_tier(tmp_path / "dom"))
    records, torn = r_read(r_tier(tmp_path / "dom"), "w2")
    assert torn == 0 and [r["name"] for r in records] == ["step", "finish", "park"]
    assert records[0]["args"] == {"active": 2, "path": "/x"}
    assert all(r["proc"] == "w2" for r in records)


# --------------------------------------------------------------------------- #
# the black box survives a SIGKILL'd real worker (on the CPU)
# --------------------------------------------------------------------------- #

def test_flight_recorder_survives_worker_sigkill(tmp_path, monkeypatch):
    """Kill a real worker mid-decode; the frontend reconstructs its
    last-seconds span timeline from the shared-domain journal."""
    from repro_torch.serve.fleet import FleetFrontend, WorkerSpec
    from repro_torch.serve.fleet.worker import WorkerHandle

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    spec = WorkerSpec(shared_root=str(tmp_path), name="wkill", slots=2,
                      max_len=64, page_tokens=4, quantum=3,
                      hb_interval_s=0.05, device="cpu")
    w = WorkerHandle.launch(spec)
    try:
        w.wait_ready()
        rng = np.random.default_rng(11)
        w.submit("r1", rng.integers(0, 500, size=8).tolist(), max_new=40)
        # run until tokens stream back AND at least one heartbeat flush
        # has landed in the shared domain, then kill mid-decode
        tier = SharedTier(Path(str(tmp_path)) / "domain",
                          capacity_bytes=spec.shared_capacity)
        seen = 0
        deadline = time.time() + 180.0
        while time.time() < deadline:
            seen += sum(len(m.get("tokens", [])) for m in w.messages()
                        if m.get("op") == "tokens")
            if seen >= 4 and read_flight(tier, "wkill")[0]:
                break
            time.sleep(0.01)
        assert seen >= 4, "worker never started decoding"
        w.kill()
        assert not w.alive()

        fe = FleetFrontend([w])
        post = fe.postmortem(0, last=64)
        assert post["worker"] == "wkill"
        names = {r["name"] for r in post["records"]}
        assert "step" in names               # decode steps made it out
        assert names & {"submit", "prefill", "prefix_match"}
        assert all(r["proc"] == "wkill" for r in post["records"])
        # torn final record: the same read path tolerates a mid-append
        # kill — only the torn line drops, the timeline stays readable
        before = len(fe.postmortem(0)["records"])
        tier.append(flight_key("wkill"), b'{"name":"step","ph":"X","ts":9')
        post2 = fe.postmortem(0)
        assert post2["torn"] == post["torn"] + 1
        assert len(post2["records"]) == before
    finally:
        w.stop()
