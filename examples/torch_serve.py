"""Multi-request serving on the PyTorch port: continuous batching +
tiered KV paging + shared-prefix page cache, built through the unified
serving API.

The counterpart of ``examples/serve.py`` on ``repro_torch``, with its
flow, its flags, its printed lines and its closing asserts.  Submits
more decode streams than there are decode slots — all opening with the
same "system prompt" — and lets the ServeScheduler round-robin them: the
first stream's prompt populates the PrefixCache, every later stream
fetches those shared pages instead of recomputing them (prefill tokens
saved), parked streams page their caches through the TierStack as
content-addressed page tables, the full multi-stream state — dedup'd
page pool and prefix trie included — is checkpointed through an
SCR-style session mid-decode, the scheduler AND a node are killed, and a
fresh scheduler restores everything and finishes byte-identically.
Recurrent families (rwkv6, zamba2) park and prefix-cache whole lane
snapshots.

All construction goes through ``ServeConfig`` + ``Serve.local`` /
``Serve.fleet`` (repro_torch/serve/api.py).  It serves on the card;
``--device cpu`` serves on the host instead, and without a card the
default raises.  ``--full-size`` serves the published configuration
(``ServeConfig.full_size``) instead of the reduced one, with the pager's
pages at 1 MiB (``ServeConfig.page_bytes``): a full-size recurrent lane
is tens of MB, thousands of the default 8 KiB pages.

  PYTHONPATH=src python examples/torch_serve.py [--arch minicpm3-4b] [--steps 8] [--device cpu]

With ``--workers N`` (N > 1) the same workload instead runs as a
serving *fleet*: N spawned worker processes over one shared cache
domain, an admission front-end with tenant quotas routing the streams,
and the shared system prompt computed once fleet-wide — workers that
never saw it pull its KV pages out of the shared tier:

  PYTHONPATH=src python examples/torch_serve.py --workers 2
"""

import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.api import ResilienceSession
from repro_torch.cluster.topology import VirtualCluster
from repro_torch.configs import get_config
from repro_torch.core.scr import Strategy
from repro_torch.serve import Serve, ServeConfig

# the pager's page size at full size: a rwkv6-3b lane is 21.3 MB and a
# zamba2-2.7b lane 75.4 MB, 2,600 and 9,207 pages of the default 8 KiB
FULL_SIZE_PAGE_BYTES = 1 << 20


def local_flow(arch="minicpm3-4b", steps=8, streams=6, slots=2, max_new=6,
               device="cuda", full_size=False) -> dict:
    """The local flow: an uninterrupted run, then the same streams
    decoded ``steps`` steps, saved, killed with a node and restored;
    returns the numbers ``main`` prints, both runs' tokens and the
    config served."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the whole stack from one config: contiguous lanes here (the paged
    # pool path is the fleet's default), a fast tier that holds only a
    # few lane caches so oversubscription forces parked streams down
    # the hierarchy (fast_bytes=None auto-sizes to slots + 1 lanes)
    cfg = ServeConfig(arch=arch, paged=False, slots=slots, max_len=32,
                      page_tokens=4, quantum=3, device=device,
                      full_size=full_size,
                      page_bytes=(FULL_SIZE_PAGE_BYTES if full_size
                                  else ServeConfig.page_bytes))

    rng = np.random.default_rng(7)
    srv = Serve.local(cfg)
    vocab = srv.arch.vocab_size
    system_prompt = rng.integers(0, vocab, size=9).tolist()
    prompts = [system_prompt
               + rng.integers(0, vocab,
                              size=int(rng.integers(3, 8))).tolist()
               for _ in range(streams)]

    # reference: the same workload decoded with no interruption
    for p in prompts:
        srv.submit(p, max_new=max_new)
    srv.run()
    ref = {sid: srv.output(sid) for sid in srv.scheduler.streams}
    ref_stats = dict(srv.stats)
    srv.close()
    del srv     # its weights go before the next stack draws its own

    root = Path(tempfile.mkdtemp(prefix="deeper_serve_"))
    cluster = VirtualCluster(4, 4, root=root)
    try:
        with ResilienceSession.for_cluster(cluster, strategy=Strategy.XOR,
                                           procs_per_node=2) as session:
            srv = Serve.local(cfg, session=session)
            for p in prompts:
                srv.submit(p, max_new=max_new)
            srv.run(max_steps=steps)        # decode partway...
            srv.save()                      # ...one transaction saves it all
            parked = len(srv.pager.parked_sids())
            srv.close()                     # the "kill": all state gone
            del srv

            # a node dies too; XOR reconstruction covers the lost fragments
            cluster.fail(1)
            cluster.recover(1)
            session.invalidate_node(1)

            srv2 = Serve.local(cfg, session=session)  # fresh process stand-in
            srv2.restore()                  # stream set comes from the ckpt
            srv2.run()
            out = {sid: srv2.output(sid) for sid in srv2.scheduler.streams}
            name = srv2.arch.name
            srv2.close()
            del srv2
    finally:
        cluster.teardown()
    return {"arch": name, "streams": streams, "slots": slots,
            "tokens": sum(len(v) for v in out.values()),
            "parked": ref_stats["parked"], "resumed": ref_stats["resumed"],
            "max_resident": ref_stats["max_resident"],
            "prefix_hits": ref_stats["prefix_hits"],
            "prefill_tokens_saved": ref_stats["prefill_tokens_saved"],
            "prefill_tokens": ref_stats["prefill_tokens"],
            "parked_at_save": parked, "out": out, "ref": ref, "cfg": cfg}


def fleet_flow(arch="minicpm3-4b", streams=6, slots=2, max_new=6, workers=2,
               device="cuda", full_size=False) -> dict:
    """--workers N: the same shared-prompt workload through the fleet
    (serve/fleet): spawned workers over one SharedTier domain, admission
    front-end with tenant quotas, cross-process prefix reuse — built by
    ``Serve.fleet`` from the same config shape as the local path.
    Returns the numbers ``main`` prints and every worker's stats."""
    from repro_torch.serve.fleet import TenantQuota

    cfg = ServeConfig(arch=arch, slots=slots, max_len=32, page_tokens=4,
                      quantum=3, device=device, full_size=full_size,
                      page_bytes=(FULL_SIZE_PAGE_BYTES if full_size
                                  else ServeConfig.page_bytes))
    rng = np.random.default_rng(7)
    # vocab size differs per arch; workers build the config themselves,
    # so sample from a safe floor every arch clears.  A reduced config's
    # vocabulary (512) is below the floor, and an embedding index past it
    # is an error here (JAX clamps it), so the floor is capped by the
    # vocabulary of the config the workers build
    arch_cfg = get_config(arch)
    if not full_size:
        arch_cfg = arch_cfg.reduced()
    floor = min(1000, arch_cfg.vocab_size)
    system_prompt = rng.integers(0, floor, size=9).tolist()
    prompts = [system_prompt
               + rng.integers(0, floor, size=int(rng.integers(3, 8))).tolist()
               for _ in range(streams)]

    with Serve.fleet(cfg, workers=workers,
                     quotas={"bulk": TenantQuota(2)}) as fe:
        rids = [fe.submit(p, max_new=max_new,
                          tenant="bulk" if i % 2 else "latency",
                          prio="batch" if i % 2 else "interactive")
                for i, p in enumerate(prompts)]
        fe.wait(rids, timeout=600)
        outs = {r: fe.result(r) for r in rids}
        stats = fe.worker_stats()
        throttled = fe.stats["throttle_events"]

    return {"workers": workers, "streams": streams, "max_new": max_new,
            "tokens": sum(len(v) for v in outs.values()),
            "throttle_events": throttled,
            "saved": sum(s["scheduler"]["prefill_tokens_saved"] for s in stats),
            "computed": sum(s["scheduler"]["prefill_tokens"] for s in stats),
            "adopted": sum(s["prefix"]["nodes_adopted"] for s in stats),
            "shared_hits": sum(s["tier"].get("hits_shared", 0) for s in stats),
            "outs": outs, "worker_stats": stats}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm3-4b")
    ap.add_argument("--steps", type=int, default=8,
                    help="decode steps before the mid-stream checkpoint/kill")
    ap.add_argument("--streams", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--workers", type=int, default=1,
                    help="run as a fleet of N worker processes over one "
                         "shared cache domain (N > 1)")
    ap.add_argument("--device", default="cuda",
                    help="where the weights and caches live (the card "
                         "unless 'cpu')")
    ap.add_argument("--full-size", action="store_true",
                    help="serve the published configuration, not the "
                         "reduced one (with 1 MiB pager pages)")
    args = ap.parse_args(argv)
    common = dict(arch=args.arch, streams=args.streams, slots=args.slots,
                  max_new=args.max_new, device=args.device,
                  full_size=args.full_size)

    if args.workers > 1:
        r = fleet_flow(workers=args.workers, **common)
        assert all(len(v) == args.max_new for v in r["outs"].values())
        print(f"fleet of {args.workers} workers decoded {r['tokens']} tokens "
              f"across {args.streams} streams ({r['throttle_events']} "
              f"throttle events on the quota'd tenant)")
        print(f"shared system prompt fleet-wide: {r['saved']} prefill tokens "
              f"never recomputed ({r['computed']} computed), {r['adopted']} "
              f"trie nodes adopted from peers, {r['shared_hits']} shared-tier "
              f"page hits")
        print("OK: cross-process prefix sharing through one cache domain.")
        return r

    r = local_flow(steps=args.steps, **common)
    assert r["out"] == r["ref"], "post-restore decode diverged"
    print(f"decoded {r['tokens']} tokens across {args.streams} streams on "
          f"{r['arch']} ({args.slots} slots, quantum 3): "
          f"{r['parked']} parks, {r['resumed']} resumes, "
          f"max {r['max_resident']} resident")
    print(f"shared system prompt: {r['prefix_hits']} prefix hits, "
          f"{r['prefill_tokens_saved']} prefill tokens never "
          f"recomputed ({r['prefill_tokens']} computed)")
    print(f"OK: killed mid-decode with {r['parked_at_save']} streams parked "
          f"+ a node loss; restored scheduler finished every stream "
          f"byte-identically.")
    return r


if __name__ == "__main__":
    main()
