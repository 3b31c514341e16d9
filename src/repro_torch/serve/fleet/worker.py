"""Fleet worker: one PagedServeScheduler per process behind a pipe.

Counterpart of ``repro/serve/fleet/worker.py``.  A worker serves on
``WorkerSpec.device``: on a CUDA card each worker is its own process with
its own CUDA context and its own copy of the weights, and its decode runs
the paged-attention kernels.  Workers are spawned, as CUDA requires: a
forked child cannot use the parent's CUDA state.  The parent builds the
kernel libraries first (``kernels._build.build_all``), so the workers
load them instead of each running ``nvcc``.

Each worker owns a full serving stack — model, params, DevicePagePool,
``KVPager.for_fleet`` TierStack whose bottom level is the fleet's
:class:`~repro_torch.memory.shared.SharedTier`, and a slice-mode PrefixCache.
Workers are spawned (never forked) from a picklable
:class:`WorkerSpec`; every worker initialises params from the
same seed, so the fleet serves one model and KV pages are
interchangeable across processes.

Protocol (dicts over a ``multiprocessing.Pipe``), parent -> worker::

    {"op": "submit", "rid", "prompt", "max_new", "weight"}
    {"op": "stats"}         -> one {"op": "stats", ...} reply
    {"op": "drain"}         -> {"op": "drained", "streams": [...]}
    {"op": "stop"}          -> worker exits its loop

worker -> parent::

    {"op": "ready", "pid"}                  once, after warm-up
    {"op": "hb", "pid", "step"}             liveness heartbeat (periodic)
    {"op": "tokens", "rid", "tokens"}       incremental decode output
    {"op": "done", "rid", "tokens"}         full output, stream finished
    {"op": "stats", "scheduler", "tier", "prefix", "shared", "kernels"}
    {"op": "drained", "streams"}            re-admissible descriptors

``kernels`` in the stats reply is :func:`kernel_counts`: this process's
paged-attention kernel launches and plain ``layers.decode_attention``
calls since ``ready`` (the warm-up decode's are not counted), so the
parent can hold each worker's decode to the kernel path.

``drain`` exists for elastic resilience: it returns, for every
unfinished stream, the descriptor a *surviving* worker needs to
re-admit it (prompt + tokens emitted so far + remaining budget +
weight).  The front-end does not use it on the happy path; it is the
designed seam for moving load off a worker being retired.

The *unplanned* counterpart is the periodic **epoch checkpoint**
(``WorkerSpec.ckpt_every`` scheduler steps): the worker registers its
live streams' complete KV pages into the prefix trie
(``export_live_pages``), publishes them through the shared tier like
any prefix node, then saves the same drain-shaped descriptors through
``ResilienceSession.for_shared_tier`` under its own checkpoint domain
(``scr-<name>``), and marks the epoch with a ``kind="epoch"`` board
record.  If the worker dies, the frontend's failure detector (heartbeat
staleness triggering a process-liveness probe) loads the last epoch via
:func:`load_epoch` and re-admits the streams on survivors — which adopt
the published pages from the board, so the replayed prefix's prefill is
mostly page reuse rather than recompute.

Prefix sharing is push/pull: after every scheduler step the worker
diffs ``PrefixCache.export_records()`` against what it has already
published, copies each fresh node's payload into the shared tier
(``TierStack.put_at("shared", ...)``) and appends the records to the
:class:`~repro_torch.serve.fleet.board.PrefixBoard`; before every admission
it polls the board and ``adopt_nodes``s what peers published.  Payload
reads on the consumer side go through the ordinary stack read path, so
a peer's page read-through-promotes into the local fast tier.
"""

from __future__ import annotations

import multiprocessing as mp
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Deque, Dict, List, Optional

from repro_torch.memory.tiers import CapacityError


@dataclass(frozen=True)
class WorkerSpec:
    """Everything a spawned worker needs to build its serving stack.

    Must stay picklable (crosses the spawn boundary).  ``seed`` is the
    params seed — all workers of one fleet must share it (token-identity
    across migration additionally rests on it: a survivor can only
    continue a dead peer's stream because both run the same params and
    greedy decode is a pure function of token history).

    ``name`` is the worker's fleet-unique identity (``FleetFrontend``
    assigns ``w<i>`` when empty); it namespaces the worker's epoch
    checkpoint domain.  ``ckpt_every`` > 0 enables the periodic epoch
    checkpoint (in scheduler steps — the recovery-stall bound is
    proportional to it); ``hb_interval_s`` paces heartbeats;
    ``adopt_batch`` > 0 bounds how many board records one admission
    adopts (the large-fleet throttle)."""

    shared_root: str
    arch: str = "phi3-mini-3.8b"
    slots: int = 2
    max_len: int = 32
    page_tokens: int = 4
    quantum: int = 3
    pool_pages: Optional[int] = None
    spec_k: int = 0
    fast_bytes: int = 8 << 20
    page_bytes: int = 8 * 1024
    kv_codec: Optional[str] = None
    shared_capacity: int = 1 << 30
    seed: int = 0
    name: str = ""
    ckpt_every: int = 0
    hb_interval_s: float = 0.25
    adopt_batch: int = 0
    # where the worker serves, and whether its model is built at published
    # width (False: ``.reduced()``, as the reference's workers always are)
    device: str = "cuda"
    full_size: bool = False


def epoch_domain(worker_name: str) -> str:
    """The per-worker checkpoint namespace under the shared root."""
    return f"scr-{worker_name or 'w'}"


def _build_scheduler(spec: WorkerSpec):
    # imports live here so the parent can import this module (for the
    # spawn target) without paying for model state
    from repro_torch.memory.shared import SharedTier
    from repro_torch.obs.metrics import Registry
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.api import ServeConfig, _build_model
    from repro_torch.serve.kvpage import KVPager
    from repro_torch.serve.prefix import PrefixCache
    from repro_torch.serve.scheduler import PagedServeScheduler

    cfg, model, params = _build_model(ServeConfig(
        arch=spec.arch, seed=spec.seed, full_size=spec.full_size,
        device=spec.device))
    # one registry spans the worker's whole stack (tier/kv/sched/shared
    # prefixes), so a single snapshot() covers everything the frontend
    # needs to merge fleet-wide
    registry = Registry()
    tracer = Tracer(process=spec.name or "w")
    shared = SharedTier(Path(spec.shared_root) / "domain",
                        capacity_bytes=spec.shared_capacity,
                        registry=registry)
    pager = KVPager.for_fleet(shared, fast_bytes=spec.fast_bytes,
                              page_bytes=spec.page_bytes, registry=registry)
    prefix = PrefixCache.for_model(pager.stack, cfg, model, spec.max_len,
                                   page_tokens=spec.page_tokens)
    sched = PagedServeScheduler(
        cfg, model, params, slots=spec.slots, max_len=spec.max_len,
        pager=pager, quantum=spec.quantum, prefix=prefix,
        page_tokens=spec.page_tokens, pool_pages=spec.pool_pages,
        spec_k=spec.spec_k, kv_codec=spec.kv_codec,
        registry=registry, tracer=tracer)
    return sched, pager, prefix, shared


def _warm(spec: WorkerSpec) -> None:
    """Bring up the worker's device before it builds its stack: on a card,
    TF32 off (the in-process decode runs without it, and token identity
    across workers rests on the same arithmetic), the CUDA context and the
    paged-attention library loaded (built by the parent)."""
    import torch

    if not spec.device.startswith("cuda"):
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    x = torch.ones((8, 8), device=spec.device)
    (x @ x).sum().item()
    _build.library("paged_attention")


def publish_nodes(sched, board, published: set) -> int:
    """Push this worker's fresh prefix nodes to the fleet: payload bytes
    into the shared tier, records onto the board.  ``published`` is the
    caller-owned set of digests already shipped (records seen via the
    board poll count — adopting a peer's node must not re-publish it).
    Best-effort by design: a payload already evicted, or a shared domain
    at capacity, skips the node — sharing degrades, correctness does not.
    """
    from repro_torch.serve.prefix import prefix_page_key

    prefix = sched.prefix
    stack = prefix.stack
    fresh: List[Dict[str, Any]] = []
    for rec in prefix.export_records():     # parents before children
        if rec["digest"] in published:
            continue
        key = prefix_page_key(rec["digest"])
        try:
            payload = stack.get(key, promote=False)
        except (KeyError, IOError):
            continue                        # evicted under us: skip
        try:
            stack.put_at("shared", key, payload)
        except CapacityError:
            continue                        # domain full: stop sharing
        published.add(rec["digest"])
        fresh.append(rec)
    if fresh:
        board.publish(fresh)
    return len(fresh)


EPOCH_META_COLS = 4     # plen, ntok, max_new_total, weight


def save_epoch(sess, sched, rid_of: Dict[int, Any], step: int) -> int:
    """Checkpoint the live stream set as fixed-shape arrays through the
    worker's epoch session.  The state is exactly the drain seam's
    descriptors — full token history + cursors — packed as ``tokens``
    (n, cap) / ``meta`` (n, EPOCH_META_COLS) int32 with the
    variable-size facts (rids, shapes) in the descriptor's JSON meta,
    so the frontend can restore with zero prior knowledge of the
    stream set.  Returns the number of streams checkpointed."""
    import os

    import numpy as np

    descs = [d for d in sched.live_descriptors()
             if rid_of.get(d["sid"]) is not None]
    if not descs:
        return 0
    cap = max(len(d["tokens"]) for d in descs)
    tokens = np.zeros((len(descs), cap), np.int32)
    meta = np.zeros((len(descs), EPOCH_META_COLS), np.int32)
    rids = []
    for i, d in enumerate(descs):
        tokens[i, :len(d["tokens"])] = d["tokens"]
        total = d["max_new"] + (len(d["tokens"]) - d["plen"])
        meta[i] = (d["plen"], len(d["tokens"]), total, d["weight"])
        rids.append(rid_of[d["sid"]])
    sess.save(step, {"tokens": tokens, "meta": meta},
              meta={"elastic": {"rids": rids, "n": len(descs),
                                "cap": int(cap), "pid": os.getpid(),
                                "step": int(step)}})
    return len(descs)


def load_epoch(shared_root, worker_name: str) -> Dict[Any, Dict[str, Any]]:
    """The recovery half of :func:`save_epoch`: open the dead worker's
    checkpoint domain from *this* process and return its last epoch as
    ``rid -> {"prompt", "emitted", "max_new_total", "weight", "step"}``.
    Best-effort by design — a worker that died before its first epoch
    (or was launched with ``ckpt_every=0``) yields ``{}``, and the
    caller falls back to the token prefixes it streamed itself."""
    import numpy as np

    from repro_torch.api.session import ResilienceSession

    try:
        sess = ResilienceSession.for_shared_tier(
            shared_root, domain=epoch_domain(worker_name))
    except Exception:
        return {}
    try:
        steps = sorted(sess.available_steps())
        if not steps:
            return {}
        step = steps[-1]
        em = sess.checkpoint_meta(step).get("elastic")
        if not em:
            return {}
        like = {"tokens": np.zeros((em["n"], em["cap"]), np.int32),
                "meta": np.zeros((em["n"], EPOCH_META_COLS), np.int32)}
        state, _ = sess.restore_latest(like, step=step)
        out: Dict[Any, Dict[str, Any]] = {}
        for i, rid in enumerate(em["rids"]):
            plen, ntok, total, weight = (int(x) for x in state["meta"][i])
            toks = [int(t) for t in state["tokens"][i, :ntok]]
            out[rid] = {"prompt": toks[:plen], "emitted": toks[plen:],
                        "max_new_total": total, "weight": weight,
                        "step": int(em.get("step", step))}
        return out
    except Exception:
        return {}
    finally:
        sess.close()


def kernel_counts() -> Dict[str, int]:
    """This process's decode-attention counts: the paged-attention
    kernels' launches (each wrapper counts its own) and the plain
    ``layers.decode_attention`` calls."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import layers

    return {"paged_attention": pa.paged_attention.launches,
            "paged_attention_quant": pa.paged_attention_quant.launches,
            "decode_attention": layers.plain_calls["decode_attention"]}


def _reset_kernel_counts() -> None:
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import layers

    pa.paged_attention.launches = 0
    pa.paged_attention_quant.launches = 0
    layers.plain_calls["decode_attention"] = 0


def worker_main(conn, spec: WorkerSpec) -> None:
    """Entry point of a spawned worker process."""
    import os
    import time

    from repro_torch.obs.recorder import FlightRecorder
    from repro_torch.serve.fleet.board import PrefixBoard, record_kind

    _warm(spec)
    sched, pager, prefix, shared = _build_scheduler(spec)
    if spec.device.startswith("cuda"):
        # one decode step of every slot into the trash page (no stream,
        # no counter moves): the first launches of the step's kernels and
        # cuBLAS calls happen before "ready", not under the heartbeat
        import numpy as np
        sched._paged_fn(sched._tables_arr.copy(),
                        np.zeros((sched.slots,), np.int32),
                        np.zeros((sched.slots, sched.spec_k + 1), np.int32))
    # black box: every completed span/event lands in the recorder; the
    # heartbeat tick flushes it append-only through the shared tier so
    # the frontend can read this worker's last seconds post-mortem
    recorder = FlightRecorder(spec.name or "w")
    sched.tracer.sink = recorder
    board = PrefixBoard(Path(spec.shared_root))
    published: set = set()
    rid_of: Dict[int, Any] = {}             # sid -> front-end request id
    emitted: Dict[int, int] = {}            # sid -> tokens already sent
    sess = None
    if spec.ckpt_every > 0:
        from repro_torch.api.session import ResilienceSession
        sess = ResilienceSession.for_shared_tier(
            spec.shared_root, domain=epoch_domain(spec.name))
        sess.tracer = sched.tracer      # ckpt_txn spans reach the black box
    pid = os.getpid()
    _reset_kernel_counts()
    conn.send({"op": "ready", "pid": pid})
    running = True
    last_hb = 0.0
    last_ckpt_step = 0
    try:
        while running:
            busy = bool(sched.unfinished())
            # heartbeat first — busy or idle, the frontend's failure
            # detector must keep seeing us
            now = time.monotonic()
            if now - last_hb >= spec.hb_interval_s:
                conn.send({"op": "hb", "pid": pid,
                           "step": sched.step_count})
                last_hb = now
                try:
                    recorder.flush(shared)
                except Exception:
                    pass    # black box degrades, serving does not
            # drain the pipe; block briefly when idle so we don't spin
            while conn.poll(0 if busy else 0.02):
                try:
                    msg = conn.recv()
                except EOFError:
                    running = False
                    break
                op = msg["op"]
                if op == "submit":
                    # adopt peers' prefixes *before* admission, so this
                    # prompt's prefill can hit pages computed elsewhere;
                    # bounded batches (adopt_batch) keep one admission
                    # from stalling on a journal backlog
                    recs = board.poll(spec.adopt_batch or None)
                    recs = [r for r in recs if record_kind(r) == "prefix"]
                    if recs:
                        prefix.adopt_nodes(recs)
                        published.update(r["digest"] for r in recs)
                    sid = sched.submit(msg["prompt"], msg["max_new"],
                                       quantum_weight=msg.get("weight", 1))
                    rid_of[sid] = msg["rid"]
                    emitted[sid] = 0
                elif op == "stats":
                    conn.send({
                        "op": "stats",
                        "scheduler": dict(sched.stats),
                        "tier": pager.stack.stats(),
                        "prefix": dict(prefix.stats),
                        # full registry snapshot: the frontend *merges*
                        # these across workers (sketches merge exactly,
                        # counters sum) into the fleet-wide view
                        "registry": sched.registry.snapshot(),
                        # this process's cumulative CPU seconds: the
                        # fleet benchmark takes deltas to compute the
                        # critical path (max over workers), i.e. the
                        # parallel wall on non-oversubscribed hardware
                        "cpu_s": time.process_time(),
                        "shared": {"used_bytes": shared.used_bytes(),
                                   "board_published": board.published,
                                   "board_seen": board.adopt_seen},
                        "kernels": kernel_counts(),
                    })
                elif op == "drain":
                    conn.send({"op": "drained", "streams": [
                        {"rid": rid_of.get(d["sid"]), "prompt":
                         d["tokens"][:d["plen"]], "emitted": d["emitted"],
                         "max_new": d["max_new"], "weight": d["weight"]}
                        for d in sched.live_descriptors()]})
                elif op == "stop":
                    running = False
                else:
                    raise ValueError(f"unknown op {op!r}")
            if not running:
                break
            if not sched.unfinished():
                continue
            for sid, tok in sched.step():
                emitted[sid] = emitted.get(sid, 0) + 1
                conn.send({"op": "tokens", "rid": rid_of.get(sid),
                           "tokens": [int(tok)]})
            # publish BEFORE reporting completions: a stream's prefix
            # nodes are inserted at admission, so by the time its "done"
            # reaches the front-end the pages are already on the board —
            # a peer admitting the next same-prefix request cannot race
            # the publish
            publish_nodes(sched, board, published)
            if (sess is not None
                    and sched.step_count - last_ckpt_step >= spec.ckpt_every):
                # epoch checkpoint: pages first (export + publish), then
                # descriptors, then the board marker — a marker is only
                # ever visible for a fully committed epoch
                try:
                    with sched.tracer.span("epoch_ckpt",
                                           step=sched.step_count):
                        sched.export_live_pages()
                        publish_nodes(sched, board, published)
                        if save_epoch(sess, sched, rid_of, sched.step_count):
                            board.publish([{
                                "kind": "epoch", "worker": spec.name,
                                "pid": pid, "step": sched.step_count,
                                "t": time.time()}])
                except CapacityError:
                    pass    # shared domain full: epoch skipped, not torn
                last_ckpt_step = sched.step_count
            for sid in [s for s, st in sched.streams.items()
                        if st.state.name == "DONE" and s in rid_of]:
                s = sched.streams[sid]
                conn.send({"op": "done", "rid": rid_of.pop(sid),
                           "tokens": [int(t) for t in s.tokens[s.plen:]]})
                emitted.pop(sid, None)
    finally:
        try:
            recorder.flush(shared)      # clean exit: ship the tail too
        except Exception:
            pass
        if sess is not None:
            try:
                sess.close()
            except Exception:
                pass
        try:
            sched.close()
        except Exception:
            pass
        conn.close()


class WorkerHandle:
    """Parent-side handle: spawned process + pipe + message inbox.

    ``request`` pattern: synchronous ops (stats/drain) read the pipe
    until the matching reply arrives, buffering unrelated messages
    (tokens/done) into ``inbox`` so the front-end's pump never loses
    them."""

    def __init__(self, proc, conn, spec: WorkerSpec):
        import time
        self.proc = proc
        self.conn = conn
        self.spec = spec
        self.inbox: Deque[Dict[str, Any]] = deque()
        self.ready = False
        # liveness: any received message refreshes this (heartbeats are
        # just the guaranteed minimum traffic)
        self.last_hb = time.monotonic()

    # -- liveness ---------------------------------------------------------- #

    def _saw_traffic(self) -> None:
        import time
        self.last_hb = time.monotonic()

    def alive(self) -> bool:
        """Process liveness (the authoritative half of the failure
        detector — heartbeat staleness only *triggers* this probe)."""
        return self.proc.is_alive()

    def heartbeat_age(self) -> float:
        import time
        return time.monotonic() - self.last_hb

    def kill(self) -> None:
        """SIGKILL the worker (failure injection — fig13's scenario)."""
        self.proc.kill()
        self.proc.join(5)

    @classmethod
    def launch(cls, spec: WorkerSpec) -> "WorkerHandle":
        ctx = mp.get_context("spawn")       # CUDA state must not fork
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=worker_main, args=(child, spec),
                           daemon=True)
        proc.start()
        child.close()
        return cls(proc, parent, spec)

    def wait_ready(self, timeout: float = 300.0) -> None:
        if self.ready:
            return
        if not self.conn.poll(timeout):
            raise TimeoutError("worker did not come up")
        try:
            msg = self.conn.recv()
        except EOFError:
            raise RuntimeError(
                f"worker died during startup (exitcode "
                f"{self.proc.exitcode})") from None
        if msg.get("op") != "ready":
            raise RuntimeError(f"expected ready, got {msg!r}")
        self.ready = True
        self._saw_traffic()

    def send(self, **msg: Any) -> None:
        self.conn.send(msg)

    def submit(self, rid: Any, prompt: List[int], max_new: int,
               weight: int = 1) -> None:
        self.send(op="submit", rid=rid, prompt=list(prompt),
                  max_new=int(max_new), weight=int(weight))

    def messages(self) -> List[Dict[str, Any]]:
        """Everything received so far (inbox first, then the pipe).
        Heartbeats are consumed here — they refresh :attr:`last_hb` and
        are filtered out of the returned list."""
        out = list(self.inbox)
        self.inbox.clear()
        try:
            while self.conn.poll(0):
                out.append(self.conn.recv())
        except (EOFError, OSError):
            pass
        if out:
            self._saw_traffic()
        return [m for m in out if m.get("op") != "hb"]

    def request(self, op: str, reply_op: str,
                timeout: float = 60.0) -> Dict[str, Any]:
        self.send(op=op)
        import time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not self.conn.poll(min(0.05, timeout)):
                continue
            msg = self.conn.recv()
            self._saw_traffic()
            if msg.get("op") == reply_op:
                return msg
            if msg.get("op") != "hb":
                self.inbox.append(msg)
        raise TimeoutError(f"no {reply_op!r} reply from worker")

    def stats(self) -> Dict[str, Any]:
        return self.request("stats", "stats")

    def drain(self) -> List[Dict[str, Any]]:
        return self.request("drain", "drained")["streams"]

    def stop(self, timeout: float = 30.0) -> None:
        try:
            self.send(op="stop")
        except (BrokenPipeError, OSError):
            pass
        self.proc.join(timeout)
        if self.proc.is_alive():            # pragma: no cover - hang path
            self.proc.terminate()
            self.proc.join(5)
        try:
            self.conn.close()
        except OSError:                     # pragma: no cover
            pass
