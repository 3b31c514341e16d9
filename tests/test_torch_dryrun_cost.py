"""The dry run's cost, memory and collective analysis on the CPU.

* ``dryrun.collective_bytes`` equal to the reference's
  ``parse_collectives`` on HLO lines of the same kind, dtype, shape and
  group, for all five kinds at groups 1, 2, 4 and 16;
* whisper-tiny's prefill: the declared flash forward FLOPs against the
  reference's ``_analytic_corrections`` of the same cell (the encoder and
  the cross-attention, non-causal, equal its terms; the causal
  self-attention counts visible pairs, (t + 1) / 2t of its full term);
* a reduced phi3 train cell counted on meta against a closed form from
  the config: each matmul's 2 * in * out * tokens three times (the
  layers' once more but the last, remat's recompute), and flash's
  declared forward twice and backward once per layer; calls by kernel;
* with the plain flash and scan bodies patched to raise, the meta steps
  of phi3, rwkv6 and zamba2 still run (a meta tensor never reaches a
  plain body unless ``use_kernel=False``); every wrapper's shape rule
  gives the plain version's shapes and counts no launch;
* peak live bytes and operator bytes exact on a small sequence whose
  peak is known by hand, and a kernel call's operators not counted;
* two gloo CPU ranks run the reduced phi3 data-parallel step under the
  counter: their collectives, count and bytes per kind, equal the meta
  count on a (2, 1) dry mesh;
* ``run_cells`` resumes from its file and records an unknown arch as
  ``ok: false``; ``main`` without ``--out`` writes nothing;
* one formula per kernel: ``chip_smoke.py``'s bound helpers give what
  ``kernels/work.py`` gives at phase 1's and phase 6's shapes, and what
  their own former formulas gave, to the last digit; the closed form of
  the visible pairs equals its loop; the meta device's flash workspace
  rule and paged span length equal the CUDA source's.

Spawned ranks import this module, so the reference is imported only
inside the tests that need it.
"""

import dataclasses
import itertools
import json
import multiprocessing as mp
import os
import re
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.mesh import Mesh
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rwkv6_scan as wkv
from repro_torch.kernels import work
from repro_torch.kernels import xor_parity as xp
from repro_torch.launch import dryrun

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120
WORLD = 2
GLOO_SHAPE = ShapeSpec("gloo", 16, 8, "train")


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module; importing it sets ``XLA_FLAGS`` to
    512 host devices, which is put back so that later tests in this
    process see the flags they started with."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd


def reduced(arch, **kw):
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def meta_count(cfg, shape, mesh=None):
    """What ``lower_cell`` counts for ``cfg`` (its step and arguments on
    the meta device, from the first rank's view of ``mesh``)."""
    dry = None if mesh is None else mesh.dry_run()
    micro = dryrun.micro_batches_for(shape, dry)
    return dryrun.count_step(*dryrun.step_inputs(cfg, shape, dry, micro))


# ---------------------------------------------------------------------- #
# collectives
# ---------------------------------------------------------------------- #

HLO = {"all-reduce": "%r = {t} all-reduce(%x), replica_groups={g}, to_apply=%add",
       "all-gather": "%r = {t} all-gather(%x), replica_groups={g}, dimensions={{0}}",
       "reduce-scatter": "%r = {t} reduce-scatter(%x), replica_groups={g}, "
                         "dimensions={{0}}, to_apply=%add",
       "all-to-all": "%r = {t} all-to-all(%x), replica_groups={g}, dimensions={{0}}",
       "collective-permute": "%r = {t} collective-permute(%x), "
                             "source_target_pairs={{{{0,1}}}}"}
RESULTS = [("f32", (128, 64), 4), ("bf16", (256,), 2), ("s32", (16, 16), 4)]


@pytest.mark.parametrize("kind,group", list(itertools.product(
    dryrun.COLLECTIVE_KINDS, (1, 2, 4, 16))))
def test_collective_bytes_match_parse_collectives(jdry, kind, group):
    """The ring model's per-device bytes of one collective from its
    result's bytes and group size, as the reference parses them from an
    SPMD-partitioned HLO line (``replica_groups=[n, g]``)."""
    for dt, dims, elem in RESULTS:
        rtype = f"{dt}[{','.join(map(str, dims))}]{{0}}"
        line = HLO[kind].format(t=rtype, g=f"[{64 // group},{group}]<=[64]")
        got = jdry.parse_collectives(line)
        nbytes = int(np.prod(dims)) * elem
        assert got == {kind: {"count": 1, "bytes": pytest.approx(
            dryrun.collective_bytes(kind, nbytes, group), rel=1e-12)}}, line
    with pytest.raises(ValueError, match="unknown collective"):
        dryrun.collective_bytes("all-scatter", 4, 2)


# ---------------------------------------------------------------------- #
# declared kernel work against the reference's analytic corrections
# ---------------------------------------------------------------------- #


def test_whisper_prefill_flash_flops_hold_against_the_reference(jdry):
    """whisper-tiny's prefill on a (2, 1) mesh (tp 1: every rank holds
    every head, as the port's data-parallel path does, and the reference
    divides by tp): the port's declared flash forward FLOPs are the
    reference's encoder and cross-attention terms plus its decoder
    self-attention term at the causal share of visible pairs."""
    from repro.configs import get_config as jget_config
    from repro.configs.shapes import ShapeSpec as JShape

    t, batch = 448, 8
    mesh = Mesh((2, 1), ("data", "model"))
    rec = dryrun.lower_cell("whisper-tiny", ShapeSpec("p", t, batch, "prefill"),
                            mesh, tp=1)
    got = rec["kernels"]["flash_attention_fwd"]
    cfg = jget_config("whisper-tiny")
    assert got["calls"] == cfg.n_enc_layers + 2 * cfg.n_layers
    ref_flops, _ = jdry._analytic_corrections(
        cfg.with_tp(1), JShape("p", t, batch, "prefill"), 2, 1)
    b, h, dh = batch // 2, cfg.padded_heads, cfg.resolved_head_dim
    self_term = 2.0 * b * h * t * t * 2 * dh * cfg.n_layers
    want = ref_flops - self_term + self_term * (t + 1) / (2 * t)
    assert got["flops"] == pytest.approx(want, rel=1e-12)
    assert rec["ok"] and rec["micro_batches"] == 1


def closed_form_flops(cfg, rows: int, t: int, micro: int) -> int:
    """A dense GQA train step's FLOPs from the config: every matmul's
    2 * in * out * tokens three times (forward, input and weight
    gradients), the layers' once more but the FFN's down projection
    (remat's recompute: ``torch.utils.checkpoint`` stops once it has every
    tensor the backward saved, and nothing saves the last matmul's
    output), and flash's declared forward twice and backward once per
    layer (bf16)."""
    d, dh, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    hq, hkv, v = cfg.padded_heads, cfg.padded_kv_heads, cfg.padded_vocab
    tokens = rows * t
    down = 2 * tokens * f * d
    layer = 2 * tokens * (d * hq * dh + 2 * d * hkv * dh + hq * dh * d
                          + 2 * d * f) + down
    head = 2 * tokens * d * v
    fwd, _ = work.flash_fwd(rows, t, t, hq, hkv, dh, dh, 2)
    bwd, _ = work.flash_bwd(rows, t, t, hq, hkv, dh, dh, 2)
    per_micro = (cfg.n_layers * (3 * layer + (layer - down) + 2 * fwd + bwd)
                 + 3 * head)
    return micro * per_micro


@pytest.mark.parametrize("batch,micro", [(2, 1), (8, 4)])
def test_reduced_phi3_train_count_matches_closed_form(batch, micro):
    cfg = reduced("phi3-mini-3.8b").with_tp(1)
    shape = ShapeSpec("t", 32, batch, "train")
    rec = meta_count(cfg, shape)
    rows = batch // micro
    assert dryrun.micro_batches_for(shape, None) == micro
    assert rec["flops"] == closed_form_flops(cfg, rows, 32, micro)
    calls = micro * cfg.n_layers
    fwd = work.flash_fwd(rows, 32, 32, cfg.padded_heads, cfg.padded_kv_heads,
                         16, 16, 2)
    bwd = work.flash_bwd(rows, 32, 32, cfg.padded_heads, cfg.padded_kv_heads,
                         16, 16, 2)
    assert rec["kernels"] == {
        "flash_attention_bwd": {"calls": calls, "flops": calls * bwd[0],
                                "bytes": calls * bwd[1]},
        "flash_attention_fwd": {"calls": 2 * calls, "flops": 2 * calls * fwd[0],
                                "bytes": 2 * calls * fwd[1]}}
    assert rec["collectives"] == {}
    assert rec["bytes"] == sum(o["bytes"] for o in rec["ops"].values()) + sum(
        k["bytes"] for k in rec["kernels"].values())
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == dryrun.storage_bytes(
        dryrun.step_inputs(cfg, shape, None, micro)[1], "meta")
    assert 0 < mem["output_size_in_bytes"] <= mem["temp_size_in_bytes"]


# ---------------------------------------------------------------------- #
# the meta device never runs a plain body
# ---------------------------------------------------------------------- #


def _raise(*a, **kw):
    raise AssertionError("a plain body ran on the meta device")


@pytest.mark.parametrize("arch,kernels", [
    ("phi3-mini-3.8b", {"flash_attention_fwd", "flash_attention_bwd"}),
    ("rwkv6-3b", {"wkv6_fwd", "wkv6_bwd"}),
    ("zamba2-2.7b", {"mamba2_ssd_fwd", "mamba2_ssd_bwd",
                     "flash_attention_fwd", "flash_attention_bwd"})])
def test_meta_step_takes_no_plain_body(monkeypatch, arch, kernels):
    for mod, name in ((kref, "flash_attention"), (ops, "wkv6_chunked"),
                      (ops, "mamba2_chunked"), (kref, "paged_attention"),
                      (kref, "xor_reduce")):
        monkeypatch.setattr(mod, name, _raise)
    launches = (fa.flash_attention_fwd.launches, wkv.wkv6_fwd.launches,
                ssd.ssd_fwd.launches)
    cfg = reduced(arch, **({"n_layers": 6} if arch == "zamba2-2.7b" else {}))
    rec = meta_count(cfg.with_tp(1), ShapeSpec("t", 64, 2, "train"))
    assert set(rec["kernels"]) == kernels
    assert all(k["calls"] > 0 for k in rec["kernels"].values())
    assert (fa.flash_attention_fwd.launches, wkv.wkv6_fwd.launches,
            ssd.ssd_fwd.launches) == launches
    q = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(AssertionError, match="plain body"):
        ops.flash_attention(q, q, q, use_kernel=False)


def _shape_rule_call(name, a):
    """One call of each kernel function on the inputs ``a``."""
    q, k, v, pages, table, lengths = (a[n] for n in ("q", "k", "v", "pages",
                                                      "table", "lengths"))
    q1, q3 = q[:, 0].contiguous(), q[:, :3].contiguous()
    if name == "flash":
        return ops.flash_attention(q, k, v, causal=True, prefix_len=5)
    if name == "paged_attention":
        return ops.paged_attention(q1, pages, pages, table, lengths)
    if name == "paged_attention_multitok":
        return ops.paged_attention_multitok(q3, pages, pages, table,
                                            a["positions"])
    if name == "paged_attention_quant":
        return ops.paged_attention_quant(q1, a["kq"], a["ks"], a["kq"],
                                         a["ks"], table, lengths)
    if name == "paged_attention_quant_multitok":
        return ops.paged_attention_quant_multitok(
            q3, a["kq"], a["ks"], a["kq"], a["ks"], table, a["positions"])
    if name == "wkv6":
        r = a["r"]
        return ops.wkv6(r, r, r, a["w"], r[0, 0], None)
    if name == "ssd":
        return ops.mamba2_ssd(a["x"], a["dt"], a["A"], a["bm"], a["bm"], None)
    return ops.xor_reduce(a["words"])


SHAPE_RULE_CALLS = ("flash", "paged_attention", "paged_attention_multitok",
                    "paged_attention_quant", "paged_attention_quant_multitok",
                    "wkv6", "ssd", "xor_reduce")


@pytest.mark.parametrize("name", SHAPE_RULE_CALLS)
def test_shape_rule_gives_the_plain_shapes(name):
    """A wrapper on meta tensors gives the plain version's output shapes
    and dtypes on the same inputs on the CPU, launches nothing, and under
    a counter reports one call of its kernel function (flash and the
    scans: also the backward, once)."""
    gen = torch.Generator().manual_seed(0)

    def rnd(*s):
        return torch.randn(*s, generator=gen)

    pages = rnd(9, 4, 2, 72)
    kq, ks = pa.quantize_pages(pages)
    cpu = {"q": rnd(2, 24, 4, 72), "k": rnd(2, 40, 2, 72), "v": rnd(2, 40, 2, 48),
           "pages": pages, "kq": kq, "ks": ks,
           "table": torch.randint(0, 9, (2, 3), dtype=torch.int32),
           "lengths": torch.tensor([5, 12], dtype=torch.int32),
           "positions": torch.tensor([[2, 3, 4], [9, 10, 11]], dtype=torch.int32),
           "r": rnd(1, 70, 2, 80),
           "w": torch.rand(1, 70, 2, 80, generator=gen) * 0.5 + 0.4,
           "x": rnd(1, 70, 2, 72), "dt": torch.rand(1, 70, 2, generator=gen),
           "A": -torch.rand(2, generator=gen), "bm": rnd(1, 70, 24),
           "words": torch.randint(-2**31, 2**31 - 1, (3, 5, 128),
                                  dtype=torch.int32)}
    meta = {n: t.to("meta") for n, t in cpu.items()}
    fns = (fa.flash_attention_fwd, fa.flash_attention_bwd, wkv.wkv6_fwd,
           wkv.wkv6_bwd, ssd.ssd_fwd, ssd.ssd_bwd, pa.paged_attention,
           pa.paged_attention_quant, xp.xor_reduce)
    before = [f.launches for f in fns]
    want = _shape_rule_call(name, cpu)
    grad = name in ("flash", "wkv6", "ssd")
    if grad:
        for key in ("q", "k", "v", "r", "x", "bm"):
            meta[key].requires_grad_()
    with dryrun.CostCounter("meta") as counter:
        got = _shape_rule_call(name, meta)
        if grad:
            first = got if name == "flash" else got[0]
            first.sum().backward()
    for g, w in zip(_flat(got), _flat(want)):
        assert g.device.type == "meta" and g.shape == w.shape \
            and g.dtype == w.dtype, (g.shape, w.shape)
    assert [f.launches for f in fns] == before
    kernel = {"flash": "flash_attention", "wkv6": "wkv6",
              "ssd": "mamba2_ssd"}.get(name)
    want_kernels = ({f"{kernel}_fwd", f"{kernel}_bwd"} if grad else {name})
    assert set(counter.kernels) == want_kernels
    assert all(rec["calls"] == 1 for rec in counter.kernels.values())


def _flat(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


# ---------------------------------------------------------------------- #
# the counter's bytes and peak memory
# ---------------------------------------------------------------------- #


def test_peak_and_operator_bytes_exact_by_hand():
    """On meta, 1,000 f32 elements are 4,000 B: a (4,000) -> a * 2 (8,000
    live) -> a freed (4,000) -> b + 1 (8,000) -> cat (16,000, the peak) ->
    all freed; a view moves and allocates nothing; a kernel call's
    operators are not counted but its allocations are; storages held
    before the counter are not its."""
    held = torch.empty(10**6, device="meta")
    with dryrun.CostCounter("meta") as c:
        a = torch.empty(1000, device="meta")
        b = a * 2
        del a
        assert c.live == 4000 and c.peak == 8000
        d = b + 1
        e = torch.cat([b, d]).view(2, 1000)
        del b, d
        assert c.live == 8000 and c.peak == 16000
        with c.kernel("k", (7, 11)):
            f = torch.zeros(250, device="meta") + held[:250]
        assert c.live == 9000
        g = held.view(1000, 1000)
        del e, f
        assert c.live == 0
    assert c.peak == 16000 and g.shape == (1000, 1000)
    # mul 4,000 + 4,000, add 8,000, cat 8,000 + 8,000, the kernel's 11
    assert c.bytes == 32011 and c.flops == 7
    assert set(c.ops) == {"aten.mul", "aten.add", "aten.cat"}
    assert c.kernels == {"k": {"calls": 1, "flops": 7, "bytes": 11}}


def test_count_step_memory_keys():
    """``memory`` under the reference's keys: the arguments' distinct
    storages, the outputs not among them, and the peak of what the step
    made (two outputs and a temporary between them)."""
    x = torch.empty(256, device="meta")

    def step(t):
        y = t * 3          # 1,024 B, an output
        z = y + t          # 1,024 B, freed at the return
        return y, z * 2, t.view(16, 16)   # 1,024 B more; a view of t

    rec = dryrun.count_step(step, (x,))
    assert rec["memory"] == {"argument_size_in_bytes": 1024,
                             "output_size_in_bytes": 2048,
                             "temp_size_in_bytes": 3072}


# ---------------------------------------------------------------------- #
# collectives on two gloo ranks against the dry mesh
# ---------------------------------------------------------------------- #


def _rank_main(rank, store_path, out_dir):
    import torch.distributed as dist
    from repro_torch.models.registry import get_model, make_inputs
    from repro_torch.train.step import init_train_state, make_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        cfg = reduced("phi3-mini-3.8b").with_tp(1)
        model = get_model(cfg)
        mesh = Mesh((WORLD, 1), ("data", "model"))
        micro = dryrun.micro_batches_for(GLOO_SHAPE, mesh)
        step = make_train_step(cfg, model, mesh=mesh, remat=True,
                               micro_batches=micro)
        state = init_train_state(0, cfg, model, device="cpu")
        batch = make_inputs(cfg, GLOO_SHAPE, torch.Generator().manual_seed(1),
                            device="cpu")
        with dryrun.CostCounter("cpu") as counter:
            _, metrics = step(state, batch)
        out = {"collectives": counter.collectives, "micro": micro,
               "loss": float(metrics["loss"])}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"{rank}.json").write_text(json.dumps(out))


def test_gloo_ranks_collectives_equal_the_dry_mesh(tmp_path):
    """Two gloo CPU ranks run the reduced phi3 data-parallel step (B 8 x T
    16, 2 micro-batches a rank) under the counter: each rank's collectives
    (the gradient average, one all-reduce per leaf; the loss's mean)
    equal, count and bytes per kind, what the meta count records on the
    same (2, 1) mesh, dry."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    ranks = [json.loads((tmp_path / f"{r}.json").read_text())
             for r in range(WORLD)]
    cfg = reduced("phi3-mini-3.8b").with_tp(1)
    rec = meta_count(cfg, GLOO_SHAPE, Mesh((WORLD, 1), ("data", "model")))
    leaves = dryrun.tree_leaves(get_model_params(cfg))
    grad_bytes = sum(t.numel() * t.element_size() for t in leaves)
    assert rec["collectives"] == {"all-reduce": {
        "count": len(leaves) + 1,
        "bytes": pytest.approx(dryrun.collective_bytes(
            "all-reduce", grad_bytes, WORLD) + dryrun.collective_bytes(
            "all-reduce", 4, WORLD), rel=1e-12)}}
    for got in ranks:
        assert got["micro"] == 2
        assert got["collectives"] == rec["collectives"]


def get_model_params(cfg):
    from repro_torch.models.registry import get_model
    return get_model(cfg).param_shapes(cfg)


# ---------------------------------------------------------------------- #
# the sweep and the command line
# ---------------------------------------------------------------------- #


def test_run_cells_resumes_and_records_failures(tmp_path, capsys):
    out = tmp_path / "dry.json"
    cached = {"arch": "phi3-mini-3.8b", "shape": "train_4k", "mesh": "2x2",
              "ok": True, "variant": {}, "marker": "from the file"}
    out.write_text(json.dumps([cached]))
    cells = [("phi3-mini-3.8b", "train_4k"), ("no-such-arch", "train_4k"),
             ("whisper-tiny", "decode_32k")]
    got = dryrun.run_cells(cells, False, out, test_mesh=True, fast=True)
    assert got[0] == cached
    assert got[1]["ok"] is False and "no-such-arch" in got[1]["error"]
    assert "Traceback" in got[1]["traceback"]
    assert got[2]["ok"] is True and got[2]["mesh"] == "2x2"
    assert "kernels" not in got[2]            # --fast: meta_cell's fields
    saved = json.loads(out.read_text())
    assert [(r["arch"], r["ok"]) for r in saved] == [
        ("phi3-mini-3.8b", True), ("no-such-arch", False), ("whisper-tiny", True)]
    assert "[skip] phi3-mini-3.8b train_4k 2x2" in capsys.readouterr().err
    # a failed cell is tried again, an ok one is not
    again = dryrun.run_cells(cells[1:2], False, out, test_mesh=True, fast=True)
    assert again[0]["ok"] is False
    assert len(json.loads(out.read_text())) == 3


def test_main_writes_no_file_without_out(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    recs = dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                        "--test-mesh"])
    assert list(tmp_path.iterdir()) == []
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == recs and recs[0]["ok"]
    rec = recs[0]
    assert rec["mesh"] == "2x2" and rec["tp"] == 2 and rec["micro_batches"] == 1
    for key in ("flops", "bytes", "kernels", "collectives", "memory"):
        assert key in rec
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes", "temp_size_in_bytes"}


# ---------------------------------------------------------------------- #
# one formula per kernel
# ---------------------------------------------------------------------- #


def _old_visible_pairs(tq, tk, causal=True, prefix_len=0):
    if not causal:
        return tq * tk
    return sum(max(min(tk, i + 1 + tk - tq), min(prefix_len, tk))
               for i in range(tq))


@pytest.mark.parametrize("tq,tk", [(1, 1), (7, 7), (200, 200), (100, 300),
                                   (512, 512), (64, 32), (3, 1500)])
def test_visible_pairs_closed_form_equals_its_loop(tq, tk):
    for causal in (True, False):
        for prefix in (0, 1, 5, tq // 2, tk - 1, tk, tk + 9, 10**6):
            assert work.visible_pairs(tq, tk, causal, prefix) == \
                _old_visible_pairs(tq, tk, causal, prefix), (causal, prefix)


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke
    return chip_smoke


def _old_flash_bound(hbm, peak, b, tq, tk, hq, hkv, d, elem, backward,
                     dv=None, causal=True, prefix_len=0):
    """``chip_smoke.flash_bound_ms`` as it was before ``kernels/work.py``."""
    dv = d if dv is None else dv
    pairs = _old_visible_pairs(tq, tk, causal, prefix_len)
    q_bytes, k_bytes = b * tq * hq * d * elem, b * tk * hkv * d * elem
    o_bytes, v_bytes = b * tq * hq * dv * elem, b * tk * hkv * dv * elem
    lse = b * hq * tq * 4
    if backward:
        nbytes = (q_bytes + k_bytes + v_bytes + 2 * o_bytes + lse
                  + q_bytes + k_bytes + v_bytes)
        flops = 2 * b * hq * pairs * (3 * d + 2 * dv)
    else:
        nbytes = q_bytes + k_bytes + v_bytes + o_bytes + lse
        flops = 2 * b * hq * pairs * (d + dv)
    t_bytes = nbytes / hbm
    t_ops = flops / peak["bfloat16" if elem == 2 else "float32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _old_scan_bound(hbm, peak, kind, shape, elem, backward):
    """``chip_smoke.scan_bound_ms`` as it was."""
    if kind == "wkv6":
        b, t, h, d = shape
        act = b * t * h * d
        state = b * h * d * d * 4
        fwd_bytes = 3 * act * elem + act * 4 + h * d * 4 + act * elem + state
        bwd_bytes = (3 * act * elem + act * 4 + h * d * 4 + act * elem
                     + 3 * act * elem + act * 4 + h * d * 4)
        cells = b * t * h * d * d
    else:
        b, t, h, p, n = shape
        act = b * t * h * p
        bc = 2 * b * t * n * elem
        state = b * h * p * n * 4
        fwd_bytes = act * elem + b * t * h * 4 + h * 4 + bc + act * elem + state
        bwd_bytes = (act * elem + b * t * h * 4 + h * 4 + bc + act * elem
                     + act * elem + b * t * h * 4 + h * 4 + bc)
        cells = b * t * h * p * n
    nbytes = bwd_bytes if backward else fwd_bytes
    flops = (14 if backward else 5) * cells
    t_bytes = nbytes / hbm
    t_ops = flops / peak["bfloat16" if elem == 2 else "float32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _old_paged_bound(hbm, peak, q, k_pages, table, lengths, quant=False):
    """``chip_smoke.kernel_bound_ms`` as it was."""
    n, page, hkv, d = k_pages.shape
    t = table.clamp(0, n - 1).cpu().numpy()
    rows = set()
    for r, ln in enumerate(lengths.cpu().tolist()):
        for p in range(min(ln, t.shape[1] * page)):
            rows.add((int(t[r, p // page]), p % page))
    per_row = hkv * d * k_pages.element_size() + (hkv * 4 if quant else 0)
    nbytes = (2 * len(rows) * per_row + 2 * q.numel() * q.element_size()
              + table.numel() * 4 + lengths.numel() * 4)
    ops_n = 4 * q.shape[1] * d * int(lengths.clamp(0, t.shape[1] * page).sum())
    t_bytes = nbytes / hbm
    t_ops = ops_n / peak[str(q.dtype).split(".")[-1]]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# phase 6's training shapes (B 4 x T 512: phi3, zamba2's shared block,
# deepseek-moe-16b) and its other flash shapes, with phase 14's (96, 64)
FLASH_SHAPES = [(4, 512, 512, 32, 32, 96, None, True, 0),
                (4, 512, 512, 32, 32, 80, None, True, 0),
                (4, 512, 512, 16, 16, 128, None, True, 0),
                (4, 512, 512, 40, 40, 96, 64, True, 0),
                (2, 200, 200, 36, 4, 128, None, True, 77),
                (1, 100, 300, 8, 1, 96, None, True, 150),
                (4, 448, 1500, 6, 6, 64, None, False, 0)]
SCAN_SHAPES = [("wkv6", (4, 512, 40, 64)), ("wkv6", (1, 77, 3, 16)),
               ("ssd", (4, 512, 80, 64, 64)), ("ssd", (1, 77, 3, 16, 8))]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_bound_helper_is_work_py(smoke, shape):
    b, tq, tk, hq, hkv, d, dv, causal, prefix = shape
    for elem, backward in itertools.product((2, 4), (False, True)):
        got = smoke.flash_bound_ms(b, tq, tk, hq, hkv, d, elem, backward, dv,
                                   causal, prefix)
        assert got == _old_flash_bound(smoke.HBM_BYTES_PER_S, smoke.PEAK_OPS,
                                       b, tq, tk, hq, hkv, d, elem, backward,
                                       dv, causal, prefix)
        fn = work.flash_bwd if backward else work.flash_fwd
        assert got == smoke.bound_ms(fn(b, tq, tk, hq, hkv, d, dv or d, elem,
                                        causal, prefix),
                                     "bfloat16" if elem == 2 else "float32")


@pytest.mark.parametrize("kind,shape", SCAN_SHAPES)
def test_scan_bound_helper_is_work_py(smoke, kind, shape):
    for elem, backward in itertools.product((2, 4), (False, True)):
        got = smoke.scan_bound_ms(kind, shape, elem, backward)
        assert got == _old_scan_bound(smoke.HBM_BYTES_PER_S, smoke.PEAK_OPS,
                                      kind, shape, elem, backward)
        name = {"wkv6": "wkv6", "ssd": "mamba2_ssd"}[kind]
        fn = getattr(work, f"{name}_{'bwd' if backward else 'fwd'}")
        assert got == smoke.bound_ms(fn(*shape, elem),
                                     "bfloat16" if elem == 2 else "float32")


@pytest.mark.parametrize("label", ["phi3 (Hq=Hkv=32, D=96)", "phi3 long context",
                                   "starcoder2-7b long context",
                                   "Hq=28, Hkv=4, D=72, page 5",
                                   "wide D=576 long context"])
def test_paged_bound_helper_is_work_py(smoke, label):
    """Phase 1's shapes with ``make_case``'s table (shared prefix pages,
    entries clamped), q and the pools on meta (the helper reads their
    shapes and dtypes only)."""
    b, hq, hkv, d, page, n_p, lens = smoke.PAGED_SHAPES[label]
    gen = torch.Generator().manual_seed(0)
    n = 1 + 2 * b * n_p
    table = (torch.randperm(n - 1, generator=gen)[: b * n_p] + 1).reshape(
        b, n_p).to(torch.int32)
    table[1:, :2] = table[0, :2]
    lengths = torch.tensor(lens, dtype=torch.int32)
    for r in range(b):
        table[r, -(-lens[r] // page):] = -1
    table[2, 0] = -1
    q = torch.empty(b, hq, d, dtype=torch.bfloat16, device="meta")
    for pool, quant in ((torch.bfloat16, False), (torch.int8, True)):
        k_pages = torch.empty(n, page, hkv, d, dtype=pool, device="meta")
        got = smoke.kernel_bound_ms(q, k_pages, table, lengths, quant=quant)
        assert got == _old_paged_bound(smoke.HBM_BYTES_PER_S, smoke.PEAK_OPS,
                                       q, k_pages, table, lengths, quant)
    # without the table's values: every entry's page, every position
    flops, nbytes = work.paged(b, hq, hkv, d, 2, 2, n_p, page)
    assert flops == 4 * hq * d * b * n_p * page
    assert nbytes == (2 * b * n_p * page * hkv * d * 2 + 2 * b * hq * d * 2
                      + b * n_p * 4 + b * 4)


def test_xor_work():
    assert work.xor_reduce(4, 1000) == (3 * 1000 * 128, 5 * 1000 * 512)


@pytest.mark.parametrize("shape,groups", [
    ((2, 256, 8, 2, 576, 512), 4),
    ((1, 1024, 16, 1, 576, 512), 8),
    ((1, 16, 32768, 16384, 512, 512), 1),
    ((2, 256, 8, 8, 320, 320), 1),
    ((4, 4096, 8, 1, 264, 264), 1),
    ((1, 512, 12, 2, 264, 264), 6)])
def test_meta_flash_workspace_rule(shape, groups):
    """The shape rule's backward workspace at the cases the card's test
    holds the CUDA source's ``repro_flash_bwd_workspace`` to
    (``tests/test_torch_flash_wide_cuda.py``); none off the bf16 wide
    route."""
    b, tk, hq, hkv, d, dv = shape
    assert fa.bwd_workspace_bytes(torch.bfloat16, b, tk, hq, hkv, d, dv) == (
        0 if groups == 1 else 4 * groups * b * tk * hkv * (d + dv))
    assert fa.bwd_workspace_bytes(torch.float32, b, tk, hq, hkv, d, dv) == 0
    assert fa.bwd_workspace_bytes(torch.bfloat16, b, tk, hq, hkv, 256, 256) == 0


def test_meta_rules_read_the_cuda_sources_constants():
    csrc = REPO / "src" / "repro_torch" / "kernels" / "csrc"
    paged = (csrc / "paged_attention.cu").read_text()
    assert int(re.search(r"constexpr int kSplit = (\d+);", paged).group(1)) \
        == pa.SPLIT_TOKENS
    flash = (csrc / "flash_attention.cu").read_text()
    assert int(re.search(r"constexpr int kSmCount = (\d+);", flash).group(1)) \
        == fa._SM_COUNT
    assert int(re.search(r"constexpr int kSliceW = (\d+);", flash).group(1)) \
        == fa._SLICE_W
    hopper = flash[flash.index("namespace hopper"):]
    assert int(re.search(r"constexpr int kTile = (\d+);", hopper).group(1)) \
        == fa._KEY_TILE
    assert "4LL * kSmCount" in flash


# ---------------------------------------------------------------------- #
# repairs: memory that outlived its tree
# ---------------------------------------------------------------------- #


def test_tree_unflatten_holds_no_leaf_after_its_tree():
    """Fault found by the counter: ``tree_unflatten``'s recursive closure
    was a reference cycle holding the leaves' list, so a micro-batched
    step's summed gradients outlived their tree until the garbage
    collector ran (the peak then depended on when it ran).  With the
    collector off, dropping the tree frees every leaf."""
    import gc
    import weakref

    from repro_torch.optim.adamw import tree_unflatten

    like = {"a": {"x": 0, "y": 0}, "b": 0}
    leaves = [torch.zeros(3) for _ in range(3)]
    refs = [weakref.ref(t) for t in leaves]
    gc.disable()
    try:
        tree = tree_unflatten(like, leaves)
        assert tree["a"]["x"] is leaves[0] and tree["b"] is leaves[2]
        del leaves, tree
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_meta_peak_does_not_wait_for_the_collector():
    """The reduced phi3 step with 2 micro-batches has the same peak with
    the garbage collector off: nothing on the step's path frees its
    tensors only through a cycle."""
    import gc

    cfg = reduced("phi3-mini-3.8b").with_tp(1)
    shape = ShapeSpec("t", 32, 4, "train")
    on = meta_count(cfg, shape)["memory"]
    gc.disable()
    try:
        off = meta_count(cfg, shape)["memory"]
    finally:
        gc.enable()
    assert on == off
