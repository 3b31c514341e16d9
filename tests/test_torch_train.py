"""The port's training path against the JAX reference.

Weights and the initial train state are made by the reference and
carried across (``repro_torch.convert``); batches come from the data
pipeline (numpy, the same in both packages).  Reduced configs (2 layers)
at float32 compute, MHA (the reduced phi3) and GQA (2 kv heads).  On the
CPU the port's attention is the plain version of the flash kernel.

Tolerances, all float32:
* logits and loss: ``atol=1e-5`` — O(1) values whose matmuls sum in
  different orders in the two frameworks;
* gradients: ``atol=1e-6, rtol=1e-4`` — the same, on values of 1e-4..1e-1
  that pass through one more chain of reductions;
* ``opt.m``, ``opt.v`` after 1 and 3 AdamW steps: ``atol=1e-6,
  rtol=1e-4``, as the gradients;
* params after 1 and 3 steps: ``rtol=1e-4`` and ``atol`` of 1% of the
  learning rate per step — AdamW normalises each update to about ``lr``
  whatever the gradient's size, so for the smallest gradients, whose
  relative error in float32 reaches ~1e-3, the step's own error is a
  small fraction of ``lr`` (4e-6 seen, at lr 1e-3 over 3 steps);
* the trainer's kill / recover run against an uninterrupted one: exact.
"""

import dataclasses
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.registry import get_model as jget_model
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train import step as jstep
from repro_torch.api import IntervalPolicy, ResilienceSession
from repro_torch.cluster.topology import VirtualCluster
from repro_torch.configs import get_config
from repro_torch.convert import (params_from_numpy, state_to_numpy,
                                 train_state_from_numpy)
from repro_torch.core.scr import SCRManager, Strategy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.memory.stack import TierStack
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.train import step as tstep
from repro_torch.train.trainer import FailureEvent, Trainer

ARCH = "phi3-mini-3.8b"
LOGIT_TOL = dict(atol=1e-5, rtol=0)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
OPT = dict(lr=1e-3, warmup_steps=2)
MOMENT_TOL = dict(atol=1e-6, rtol=1e-4)


def param_tol(steps):
    return dict(atol=0.01 * OPT["lr"] * steps, rtol=1e-4)


def variant(gqa):
    out = []
    for get in (jget_config, get_config):
        cfg = dataclasses.replace(get(ARCH).reduced(), compute_dtype="float32")
        if gqa:
            cfg = dataclasses.replace(cfg, n_kv_heads=2)
        out.append(cfg)
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["mha", "gqa"])
def pair(request):
    jcfg, tcfg = variant(request.param)
    jmodel, tmodel = jget_model(jcfg), get_model(tcfg)
    jstate = jax.device_get(
        jstep.init_train_state(jax.random.PRNGKey(0), jcfg, jmodel))
    return jcfg, jmodel, jstate, tcfg, tmodel


def batches(cfg, n, batch=4, seq=24):
    pipe = TokenPipeline(cfg.vocab_size, global_batch=batch, seq_len=seq)
    return [pipe.batch_at(i) for i in range(n)]


def t_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **tol)


def test_train_state_carries_across_byte_identical(pair):
    """A reference train state and its port counterpart are the same
    bytes: leaf by leaf, and as one serialized checkpoint blob."""
    from repro.io import serialization as jser
    from repro_torch.io import serialization as tser

    jcfg, jmodel, jstate, tcfg, tmodel = pair
    tstate = train_state_from_numpy(jstate, tcfg, device="cpu")
    assert tstate["step"].dtype == torch.int32 and tstate["step"].shape == ()
    back = state_to_numpy(tstate)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jstate),
                            jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    want = jser.serialize_state(jstate, step=0)
    got = tser.serialize_state(tstate, step=0)
    assert got.manifest == want.manifest and got.data == want.data


def test_forward_logits_match_reference(pair):
    jcfg, jmodel, jstate, tcfg, tmodel = pair
    tparams = params_from_numpy(jstate["params"], tcfg, device="cpu")
    batch = batches(jcfg, 1)[0]
    want, _ = jmodel.forward(jstate["params"], batch, jcfg, remat=False)
    with torch.no_grad():
        got, _ = tmodel.forward(tparams, t_batch(batch), tcfg, remat=False)
    assert got.shape == want.shape and got.dtype == torch.float32
    close(got, want, LOGIT_TOL, "logits")


def test_loss_and_grads_match_reference(pair):
    jcfg, jmodel, jstate, tcfg, tmodel = pair
    batch = batches(jcfg, 1)[0]
    (jloss, _), jgrads = jax.value_and_grad(
        jstep.make_loss_fn(jcfg, jmodel), has_aux=True)(jstate["params"], batch)
    tparams = params_from_numpy(jstate["params"], tcfg, device="cpu")
    tloss, _, tgrads = tstep._value_and_grad(
        tstep.make_loss_fn(tcfg, tmodel), tparams, t_batch(batch))
    close(tloss, jloss, LOGIT_TOL, "loss")
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    tleaves = tree_leaves(tgrads)
    assert len(jleaves) == len(tleaves)
    for (path, want), got in zip(jleaves, tleaves):
        close(got, want, GRAD_TOL, jax.tree_util.keystr(path))


@pytest.mark.parametrize("micro", [1, 2])
def test_train_steps_match_reference(pair, micro):
    """Params, opt.m, opt.v, step and loss after 1 and after 3 steps."""
    jcfg, jmodel, jstate, tcfg, tmodel = pair
    jtrain = jax.jit(jstep.make_train_step(jcfg, jmodel, JAdamWConfig(**OPT),
                                           micro_batches=micro))
    ttrain = tstep.make_train_step(tcfg, tmodel, AdamWConfig(**OPT),
                                   micro_batches=micro)
    tstate = train_state_from_numpy(jstate, tcfg, device="cpu")
    js = jstate
    for steps, batch in enumerate(batches(jcfg, 3), start=1):
        js, jm = jtrain(js, batch)
        tstate, tm = ttrain(tstate, t_batch(batch))
        close(tm["loss"], jm["loss"], LOGIT_TOL, "loss")
        if steps not in (1, 3):
            continue
        host = jax.device_get(js)
        assert int(tstate["step"]) == int(host["step"]) == steps
        for tree in ("params", "m", "v"):
            want = host[tree] if tree == "params" else host["opt"][tree]
            got = tstate[tree] if tree == "params" else tstate["opt"][tree]
            for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                    tree_leaves(got)):
                tol = param_tol(steps) if tree == "params" else MOMENT_TOL
                close(g, w, tol, f"step {steps} {tree}"
                      + jax.tree_util.keystr(path))
    # the port's state converts back to the reference's layout and dtypes
    back = state_to_numpy(tstate)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(host)


def run_trainer(root, cfg, failure_schedule):
    cluster = VirtualCluster(n_cluster=4, n_booster=4, root=root)
    scr = SCRManager(cluster, TierStack.for_cluster(cluster),
                     strategy=Strategy.BUDDY, procs_per_node=2,
                     async_drain=True)
    pipeline = TokenPipeline(cfg.vocab_size, global_batch=4, seq_len=32)
    with ResilienceSession(scr, policy=IntervalPolicy(4)) as session:
        trainer = Trainer(cfg, get_model(cfg), pipeline, session,
                          opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=4),
                          failure_schedule=failure_schedule, device="cpu")
        report = trainer.run(total_steps=8)
        template = tstep.init_train_state(0, cfg, trainer.model, device="cpu")
        state, step = session.restore_latest(template)
    cluster.teardown()
    assert step == 8
    return report, state


def test_trainer_kill_and_recover_equals_uninterrupted_run():
    cfg = get_config(ARCH).reduced()
    with tempfile.TemporaryDirectory() as tmp:
        clean, want = run_trainer(Path(tmp) / "clean", cfg, None)
        faulty, got = run_trainer(Path(tmp) / "faulty", cfg,
                                  [FailureEvent(step=6, rank=3)])
    assert faulty.recoveries == 1 and faulty.restarts_from_step == [4]
    assert faulty.losses[-1] < faulty.losses[0]
    assert clean.losses == [faulty.losses[i] for i in (0, 1, 2, 3, 4, 5, 8, 9)]
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
