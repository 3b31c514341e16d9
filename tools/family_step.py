#!/usr/bin/env python3
"""Time a recurrent family's full-depth prefill and training step on one
card, and split a profiled step's device time by kernel family.

    python3 tools/family_step.py [ROOT] [--arch zamba2-2.7b]

ROOT (default: this checkout) is the repository whose ``chip_smoke.py`` and
``src/`` are imported, so two checkouts (say a parent commit unpacked
under the git-ignored ``build/``) are compared on one card by running the
tool once for each, in turns (parent, change, change, parent).  At the
published width and ``chip_smoke``'s B 4 x T 512, bf16, seed 0:

* the full-depth ``make_prefill_step``, 7 calls (host clock, each ending
  in ``torch.cuda.synchronize()``; the first is reported apart);
* the depth ``chip_smoke`` trains (``FAMILY["layers"]``: zamba2 6, rwkv6
  2) trained 10 steps under deterministic algorithms (host clock around
  each step, ending in the loss's ``float()``);
* 2 more steps under ``torch.profiler`` (CUDA activities): device time per
  step by kernel family (``ssd``: the SSD kernels, ``wkv6``, ``flash``,
  ``other``: everything else), device activities per step and the wall
  time of those steps.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

FAMILIES = (("ssd", ("ssd_",)), ("wkv6", ("wkv6",)),
            ("flash", ("fwd_kernel", "dq_kernel", "dkdv_kernel", "flash")))


def family(kernel: str) -> str:
    name = kernel.lower()
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--arch", default="zamba2-2.7b")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("family_step: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    b, t = cs.FAMILY["batch"], cs.FAMILY["seq"]
    out = {"root": args.root, "arch": args.arch}

    cfg = cs.get_config(args.arch)
    model = cs.get_model(cfg)
    params = model.init(cs.SEED, cfg, device="cuda")
    prefill = cs.make_prefill_step(cfg, model)
    rng = np.random.default_rng(cs.SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, t),
                                           dtype=np.int32)).cuda()
    ms = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    out.update(prefill_layers=cfg.n_layers, prefill_first_ms=ms[0],
               prefill_ms=ms[1:])
    del params
    cs.release()

    layers = cs.FAMILY["layers"][args.arch]
    cfg = dataclasses.replace(cfg, n_layers=layers)
    model = cs.get_model(cfg)
    torch.use_deterministic_algorithms(True)
    state = cs.init_train_state(cs.SEED, cfg, model, device="cuda")
    pipe = cs.TokenPipeline(cfg.vocab_size, global_batch=b, seq_len=t, seed=cs.SEED)
    step = cs.make_train_step(cfg, model, cs.AdamWConfig(
        lr=cs.FAMILY["lr"], warmup_steps=cs.FAMILY["warmup"]))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in pipe.next_batch().items()}
               for _ in range(12)]
    walls = []
    for batch in batches[:10]:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        walls.append(1e3 * (time.perf_counter() - t0))
    out.update(train_layers=layers, step_first_ms=walls[0],
               step_ms=walls[1:])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[10:]:
            state, metrics = step(state, batch)
            float(metrics["loss"])
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / 2
    by_family = {fam: 0.0 for fam, _ in FAMILIES}
    by_family["other"] = 0.0
    for ev in prof.key_averages():
        if ev.device_time_total > 0:
            by_family[family(ev.key)] += ev.device_time_total / 2 / 1e3
    activities = sum(ev.device_type == torch.autograd.DeviceType.CUDA
                     for ev in prof.events()) / 2
    out.update(profiled_step_wall_ms=wall, device_ms_by_family=by_family,
               device_ms=sum(by_family.values()),
               device_activities_per_step=activities)
    torch.use_deterministic_algorithms(False)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
