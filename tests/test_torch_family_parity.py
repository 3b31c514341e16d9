"""Shared checks of a port model family against the JAX reference, used by
``test_torch_rwkv6.py``, ``test_torch_mamba2.py``, ``test_torch_mla.py``,
``test_torch_moe.py`` and ``test_torch_whisper_paligemma.py``.  Its own
tests run the forward, loss-and-gradient and decode checks on reduced
starcoder2-7b, the one LayerNorm + non-gated GELU transformer.

Weights and the initial train state are made by the reference and carried
across (``repro_torch.convert``); batches come from the data pipeline
(numpy, the same in both packages), with the stub modality input of the
``encdec`` and ``vlm`` families added by :class:`ModalPipeline`;
everything runs at float32 compute on the CPU, where the port's scans are
their chunked plain versions.  Each check states its tolerance where it is
defined.
"""

import dataclasses
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.io import serialization as jser
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
from repro_torch.io import serialization as tser
from repro_torch.memory.stack import TierStack
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.train import step as tstep
from repro_torch.train.trainer import FailureEvent, Trainer

# logits, loss and decode logits: O(1) values whose matmuls, norms and
# scans sum in different orders in the two frameworks
LOGIT_TOL = dict(atol=5e-5, rtol=1e-4)
# gradients, opt.m and opt.v: the reference's scan tolerance -- every
# gradient passes back through the scans and the norms (rwkv6's per-head
# group norm has eps 64e-5), where float32 noise up to 2.3e-5 was seen on
# embedding gradients of magnitude ~10
GRAD_TOL = dict(atol=5e-5, rtol=1e-4)
OPT = dict(lr=1e-3, warmup_steps=2)


def param_tol(steps):
    """AdamW moves each parameter by about ``lr`` whatever its gradient's
    size, so a gradient that is tiny beside its float32 noise moves its
    parameter by a different fraction of ``lr`` in the two packages: params
    get ``atol`` of 10% of ``lr`` per step (5.2% seen in one rwkv6 step;
    the dense family's 1% in ``test_torch_train.py`` is for gradients 20x
    less noisy)."""
    return dict(atol=0.1 * OPT["lr"] * steps, rtol=1e-4)


def make_pair(arch):
    """(jcfg, jmodel, jstate, tcfg, tmodel): the reduced config at float32
    compute in both packages and the reference's initial train state."""
    jcfg, tcfg = (dataclasses.replace(get(arch).reduced(), compute_dtype="float32")
                  for get in (jget_config, get_config))
    jmodel, tmodel = jget_model(jcfg), get_model(tcfg)
    jstate = jax.device_get(
        jstep.init_train_state(jax.random.PRNGKey(0), jcfg, jmodel))
    return jcfg, jmodel, jstate, tcfg, tmodel


# the model checks' sequence length: rwkv6's crosses a WKV6 chunk boundary
# (32 tokens), so its state is carried between chunks forward and back;
# zamba2's stays inside one SSD chunk (64), because the reference's chunked
# SSD gradient is NaN where a chunk's decays overflow (its forward is
# finite: ``check_forward`` takes a longer ``seq`` there); whisper's and
# paligemma's are text tokens beside their frames or patches
SEQ = {"rwkv": 40, "hybrid": 24, "dense": 32, "moe": 32, "encdec": 24,
       "vlm": 24}


def modal_input(cfg):
    """The stub frontend's input of a family: ``(name, rows)`` of its
    (B, rows, d_model) embeddings, or ``None``."""
    if cfg.family == "encdec":
        return "enc_frames", cfg.enc_seq
    if cfg.family == "vlm":
        return "patches", cfg.n_prefix
    return None


class ModalPipeline(TokenPipeline):
    """The token pipeline plus, for ``encdec`` / ``vlm`` configs, the stub
    frontend's embeddings: standard normal float32 from a Philox stream
    keyed by (seed + 1, step), so a batch stays a pure function of its
    step (the trainer's bitwise recovery needs that)."""

    def __init__(self, cfg, global_batch, seq_len, seed=0):
        super().__init__(cfg.vocab_size, global_batch=global_batch,
                         seq_len=seq_len, seed=seed)
        self.modal = modal_input(cfg)
        self.d_model = cfg.d_model

    def batch_at(self, step):
        batch = super().batch_at(step)
        if self.modal is not None:
            name, rows = self.modal
            rng = np.random.Generator(np.random.Philox(
                key=self.seed + 1, counter=np.uint64(step + 1)))
            batch[name] = rng.standard_normal(
                (self.global_batch, rows, self.d_model), dtype=np.float32)
        return batch


def batches(cfg, n, batch=4, seq=None):
    seq = SEQ[cfg.family] if seq is None else seq
    pipe = ModalPipeline(cfg, global_batch=batch, seq_len=seq)
    return [pipe.batch_at(i) for i in range(n)]


def t_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               err_msg=what, **tol)


def check_forward(pair, seq=None):
    jcfg, jmodel, jstate, tcfg, tmodel = pair
    tparams = params_from_numpy(jstate["params"], tcfg, device="cpu")
    batch = batches(jcfg, 1, seq=seq)[0]
    want, _ = jmodel.forward(jstate["params"], batch, jcfg, remat=False)
    with torch.no_grad():
        got, _ = tmodel.forward(tparams, t_batch(batch), tcfg, remat=False)
    assert got.shape == want.shape and got.dtype == torch.float32
    close(got, want, LOGIT_TOL, "logits")


def check_loss_and_grads(pair):
    """Loss and every parameter's gradient (remat on, as in training)."""
    jcfg, jmodel, jstate, tcfg, tmodel = pair
    batch = batches(jcfg, 1)[0]
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jstep.make_loss_fn(jcfg, jmodel), has_aux=True))(jstate["params"], batch)
    tparams = params_from_numpy(jstate["params"], tcfg, device="cpu")
    tloss, _, tgrads = tstep._value_and_grad(
        tstep.make_loss_fn(tcfg, tmodel), tparams, t_batch(batch))
    close(tloss, jloss, LOGIT_TOL, "loss")
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    tleaves = tree_leaves(tgrads)
    assert len(jleaves) == len(tleaves)
    for (path, want), got in zip(jleaves, tleaves):
        assert np.isfinite(np.asarray(want)).all(), jax.tree_util.keystr(path)
        close(got, want, GRAD_TOL, jax.tree_util.keystr(path))


def check_train_steps(pair):
    """Params, opt.m, opt.v, step and loss after 1 and after 3 AdamW steps."""
    jcfg, jmodel, jstate, tcfg, tmodel = pair
    jtrain = jax.jit(jstep.make_train_step(jcfg, jmodel, JAdamWConfig(**OPT)))
    ttrain = tstep.make_train_step(tcfg, tmodel, AdamWConfig(**OPT))
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
                tol = param_tol(steps) if tree == "params" else GRAD_TOL
                close(g, w, tol, f"step {steps} {tree}"
                      + jax.tree_util.keystr(path))


def check_decode(pair, n_tokens=5, max_len=16):
    """``decode_step`` token by token: logits and every cache leaf."""
    jcfg, jmodel, jstate, tcfg, tmodel = pair
    tparams = params_from_numpy(jstate["params"], tcfg, device="cpu")
    jcache = jmodel.init_cache(jcfg, 2, max_len)
    tcache = tmodel.init_cache(tcfg, 2, max_len, device="cpu")
    toks = TokenPipeline(jcfg.vocab_size, global_batch=2,
                         seq_len=n_tokens).batch_at(0)["tokens"]
    step = jax.jit(jmodel.decode_step, static_argnums=4)
    for i in range(n_tokens):
        jl, jcache = step(jstate["params"], jcache, toks[:, i], jnp.int32(i), jcfg)
        with torch.no_grad():
            tl, tcache = tmodel.decode_step(tparams, tcache,
                                            torch.from_numpy(toks[:, i]), i, tcfg)
        close(tl, jl, LOGIT_TOL, f"decode logits at token {i}")
    jc = jax.device_get(jcache)
    assert set(jc) == set(tcache)
    for k in jc:
        assert tuple(tcache[k].shape) == jc[k].shape, k
        close(tcache[k], jc[k], LOGIT_TOL, f"cache {k}")


def check_init(arch):
    """Port init: the reference's shapes and dtypes, and each leaf's
    spread within 10% of the reference's plus three standard errors of a
    sample standard deviation (the two PRNGs draw different numbers)."""
    cfg = get_config(arch).reduced()
    jcfg = jget_config(arch).reduced()
    init = jax.jit(jget_model(jcfg).init, static_argnums=1)
    want = jax.device_get(init(jax.random.PRNGKey(0), jcfg))
    got = get_model(cfg).init(0, cfg, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(want)
    tleaves = tree_leaves(got)
    assert len(jleaves) == len(tleaves)
    for (path, w), g in zip(jleaves, tleaves):
        name = jax.tree_util.keystr(path)
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[1] == \
            w.dtype.name, name
        ws, gs = float(np.std(w)), float(g.float().std())
        tol = (0.1 + 3 / np.sqrt(2 * w.size)) * ws
        assert abs(gs - ws) <= tol + 1e-6, (name, gs, ws)


def _run_trainer(root, cfg, failure_schedule):
    cluster = VirtualCluster(n_cluster=4, n_booster=4, root=root)
    scr = SCRManager(cluster, TierStack.for_cluster(cluster),
                     strategy=Strategy.BUDDY, procs_per_node=2,
                     async_drain=True)
    pipeline = ModalPipeline(cfg, global_batch=4, seq_len=32)
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


def check_trainer_kill_and_recover(arch):
    """The trainer's kill / recover run ends bitwise equal to an
    uninterrupted one."""
    cfg = get_config(arch).reduced()
    with tempfile.TemporaryDirectory() as tmp:
        clean, want = _run_trainer(Path(tmp) / "clean", cfg, None)
        faulty, got = _run_trainer(Path(tmp) / "faulty", cfg,
                                   [FailureEvent(step=6, rank=3)])
    assert faulty.recoveries == 1 and faulty.restarts_from_step == [4]
    assert faulty.losses[-1] < faulty.losses[0]
    assert clean.losses == [faulty.losses[i] for i in (0, 1, 2, 3, 4, 5, 8, 9)]
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def check_checkpoint_bytes(pair):
    """A train state serialised by the port is the reference's file, byte
    for byte, and each package restores the other's."""
    jcfg, jmodel, jstate, tcfg, tmodel = pair
    tstate = train_state_from_numpy(jstate, tcfg, device="cpu")
    want = jser.serialize_state(jstate, step=3)
    got = tser.serialize_state(tstate, step=3)
    assert got.manifest == want.manifest and got.data == want.data
    template = tstep.init_train_state(1, tcfg, tmodel, device="cpu")
    back = tser.deserialize_state(want, template)
    for a, b in zip(tree_leaves(back), tree_leaves(tstate)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jback = jser.deserialize_state(got, jstate)
    for a, b in zip(jax.tree_util.tree_leaves(jback),
                    jax.tree_util.tree_leaves(state_to_numpy(tstate))):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


_STARCODER2 = {}
STARCODER2_CHECKS = ["forward", "loss_and_grads", "decode"]


@pytest.mark.parametrize("arch,check", [
    *(pytest.param("starcoder2-7b", c, id=c) for c in STARCODER2_CHECKS),
    *(pytest.param("starcoder2-15b", c, id=f"15b-{c}")
      for c in STARCODER2_CHECKS)])
def test_starcoder2_7b(arch, check):
    """Reduced starcoder2-7b and starcoder2-15b (LayerNorm with a bias,
    GELU MLP, RoPE theta 1e5; 4 heads over 4 kv heads at this size)
    against the reference, at the checks' tolerances."""
    if arch not in _STARCODER2:
        _STARCODER2[arch] = make_pair(arch)
    {"forward": check_forward, "loss_and_grads": check_loss_and_grads,
     "decode": check_decode}[check](_STARCODER2[arch])


@pytest.mark.parametrize("arch", ["starcoder2-7b", "starcoder2-15b"])
def test_starcoder2_published_configs_match_reference(arch):
    """The published configs of both packages, field by field (the
    reduced ones follow from them in each package's ``reduced``)."""
    want, got = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (dataclasses.asdict(got.reduced())
            == dataclasses.asdict(want.reduced()))
    assert got.param_count() == want.param_count()
