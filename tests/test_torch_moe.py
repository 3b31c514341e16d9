"""The port's MoE family (deepseek-moe-16b, qwen2-moe-a2.7b) against the
JAX reference.

The reduced configs (2 layers, d_model 64, 8 routed experts of 32, top-2;
deepseek: 2 shared experts and one dense layer first; qwen2: 2 gated
shared experts, no dense layer) at float32 compute, with the reference's
weights carried across.  Routing is held exactly (ids, and the same
pairs dropped past an expert's capacity, ties going to the lowest expert
as ``jax.lax.top_k`` sends them); values at the family checks'
tolerances (``tests/test_torch_family_parity.py``): ``atol=5e-5,
rtol=1e-4`` for outputs, logits, ``router_aux``, loss, gradients and
decode; params after AdamW steps at 10% of ``lr`` per step; tokens, the
trainer's kill / recover run and the checkpoint bytes exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_family_parity as fp
import test_torch_serve_resilience as sr
from repro.models import moe as jmoe
from repro.serve import Serve as JServe
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import get_model
from repro_torch.serve import Serve, ServeConfig

ARCHS = ["deepseek-moe-16b", "qwen2-moe-a2.7b"]
TOL = fp.LOGIT_TOL


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tensors are tiny and the suite runs
    several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PAIRS = {}


@pytest.fixture(params=ARCHS)
def pair(request):
    if request.param not in _PAIRS:
        _PAIRS[request.param] = fp.make_pair(request.param)
    return _PAIRS[request.param]


def layer0(tree):
    """The first MoE layer's ``moe`` leaves of a stacked parameter tree."""
    return jax.tree_util.tree_map(lambda a: a[0], tree["moe_layers"]["moe"])


def t(x):
    return torch.from_numpy(np.array(x))


def x_of(cfg, b=2, seq=16, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (b, seq, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------- #
# routing and dispatch
# ---------------------------------------------------------------------- #


def test_route_matches_reference_with_forced_ties(pair):
    """Ids, weights and the aux loss; rows whose top probabilities tie
    (equal logits) route to the lowest expert first, as ``top_k``."""
    jcfg, _, _, tcfg, _ = pair
    e = tcfg.padded_experts
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 6, e)).astype(np.float32)
    logits[0, 0, [5, 2, 6]] = 3.0          # a three-way tie for the top
    logits[0, 1, :] = 0.0                  # every expert equal
    logits[1, 2, [1, 7]] = logits[1, 2].max() + 1.0
    jids, jw, jaux = jmoe._route(jcfg, jnp.asarray(logits))
    tids, tw, taux = tmoe._route(tcfg, t(logits))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert tids[0, 0].tolist() == [2, 5] and tids[0, 1].tolist() == [0, 1]
    fp.close(tw, jw, TOL, "weights")
    fp.close(taux, jaux, TOL, "aux")


def reference_keep(ids, e, capacity):
    """The reference's kept (token, choice) pairs: position by cumsum in
    (token, choice) order, kept below capacity."""
    b = ids.shape[0]
    flat = ids.reshape(b, -1)
    oh = np.eye(e, dtype=np.int64)[flat]
    pos = np.take_along_axis(np.cumsum(oh, axis=1) - 1, flat[..., None],
                             axis=-1)[..., 0]
    return pos < capacity


@pytest.mark.parametrize("factor", [8.0, 0.5])
def test_moe_ffn_matches_reference_with_and_without_drops(pair, factor):
    """Capacity factor 8 (no pair dropped) and 0.5 (pairs dropped): the
    output and aux equal the reference's, and the dropped pairs are the
    ones the reference drops."""
    jcfg, _, jstate, tcfg, _ = pair
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=factor)) for c in (jcfg, tcfg))
    p = layer0(jstate["params"])
    x = x_of(tcfg)
    jy, jaux = jmoe.moe_ffn(p, jnp.asarray(x), jcfg)
    tp = params_to_torch(p)
    with torch.no_grad():
        ty, taux = tmoe.moe_ffn(tp, t(x), tcfg)
    fp.close(ty, jy, TOL, "y")
    fp.close(taux, jaux, TOL, "aux")
    seq, m = x.shape[1], tcfg.moe
    capacity = max(1, int(seq * m.top_k / m.n_routed * m.capacity_factor))
    logits = t(x) @ tp["router"]
    ids, _, _ = tmoe._route(tcfg, logits)
    jids, _, _ = jmoe._route(jcfg, jnp.asarray(x) @ p["router"])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    keep = reference_keep(np.asarray(jids), tcfg.padded_experts, capacity)
    _, tkeep = tmoe._capacity_slots(ids.reshape(2, -1), tcfg.padded_experts,
                                    capacity)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    assert keep.all() if factor == 8.0 else not keep.all()


def test_moe_ffn_dense_all_and_shared_gate_match_reference(pair):
    """The decode path (every expert on every token) and, for qwen2, the
    sigmoid-gated shared experts."""
    jcfg, _, jstate, tcfg, _ = pair
    p = layer0(jstate["params"])
    x = x_of(tcfg)[:, 0]
    want = jmoe.moe_ffn_dense_all(p, jnp.asarray(x), jcfg)
    tp = params_to_torch(p)
    with torch.no_grad():
        got = tmoe.moe_ffn_dense_all(tp, t(x), tcfg)
    fp.close(got, want, TOL, "dense_all")
    assert ("shared_gate" in tp) == tcfg.moe.shared_gate
    if tcfg.moe.shared_gate:
        sp = {"wg": tp["shared"]["wg"], "wu": tp["shared"]["wu"],
              "wd": tp["shared"]["wd"], "shared_gate_w": tp["shared_gate"]}
        jsp = {k: jnp.asarray(v.numpy()) for k, v in sp.items()}
        fp.close(tmoe._shared_ffn(sp, t(x), tcfg),
                 jmoe._shared_ffn(jsp, jnp.asarray(x), jcfg), TOL, "shared")


def params_to_torch(tree):
    return {k: params_to_torch(v) if isinstance(v, dict) else t(v)
            for k, v in tree.items()}


# ---------------------------------------------------------------------- #
# the model: forward, training, decode, checkpoints
# ---------------------------------------------------------------------- #


def test_moe_forward_logits_and_router_aux_match_reference(pair):
    jcfg, jmodel, jstate, tcfg, tmodel = pair
    fp.check_forward(pair)
    batch = fp.batches(jcfg, 1)[0]
    _, jaux = jmodel.forward(jstate["params"], batch, jcfg, remat=False)
    tparams = params_from_numpy(jstate["params"], tcfg, device="cpu")
    with torch.no_grad():
        _, taux = tmodel.forward(tparams, fp.t_batch(batch), tcfg, remat=False)
    assert set(taux) == set(jaux) == {"router_aux"}
    fp.close(taux["router_aux"], jaux["router_aux"], TOL, "router_aux")


def test_moe_loss_and_grads_match_reference(pair):
    fp.check_loss_and_grads(pair)


def test_moe_train_steps_and_router_aux_metric_match_reference(pair):
    fp.check_train_steps(pair)
    jcfg, jmodel, jstate, tcfg, tmodel = pair
    from repro.train import step as jstep
    from repro_torch.train import step as tstep
    from repro_torch.convert import train_state_from_numpy
    batch = fp.batches(jcfg, 1)[0]
    _, jm = jax.jit(jstep.make_train_step(jcfg, jmodel))(jstate, batch)
    _, tm = tstep.make_train_step(tcfg, tmodel)(
        train_state_from_numpy(jstate, tcfg, device="cpu"), fp.t_batch(batch))
    assert set(tm) == set(jm) == {"loss", "router_aux"}
    assert not tm["router_aux"].requires_grad
    fp.close(tm["router_aux"], jm["router_aux"], TOL, "router_aux metric")


def test_moe_decode_chain_matches_reference(pair):
    fp.check_decode(pair)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_matches_reference_shapes_and_spread(arch):
    fp.check_init(arch)


def test_moe_trainer_kill_and_recover_is_bitwise():
    fp.check_trainer_kill_and_recover(ARCHS[0])


def test_moe_checkpoint_bytes_match_reference(pair):
    fp.check_checkpoint_bytes(pair)


def test_convert_carries_moe_and_dense_layer_trees_key_for_key(pair):
    """``moe_layers`` and ``dense_layers`` cross both ways byte for byte."""
    _, _, jstate, tcfg, _ = pair
    tparams = params_from_numpy(jstate["params"], tcfg, device="cpu")
    assert ("dense_layers" in tparams) == bool(tcfg.moe.n_dense_layers)
    back = params_to_numpy(tparams)
    flat = jax.tree_util.tree_leaves_with_path(jstate["params"])
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, want in flat:
        got = back
        for key in path:
            got = got[key.key]
        assert np.asarray(want).tobytes() == got.tobytes(), path


# ---------------------------------------------------------------------- #
# serving: the contiguous scheduler; no paged decode
# ---------------------------------------------------------------------- #


def test_moe_contiguous_scheduler_with_pager_and_prefix(pair):
    """The contiguous scheduler in slice mode in lockstep with the
    reference: the same tokens, parks, resumes, trie and counters."""
    jcfg, jmodel, jstate, tcfg, tmodel = pair
    jparams = jax.tree_util.tree_map(jnp.asarray, jstate["params"])
    tparams = params_from_numpy(jstate["params"], tcfg, device="cpu")
    js = sr.build(sr.J, (jcfg, jmodel, jparams), paged=False)
    ts = sr.build(sr.T, (tcfg, tmodel, tparams), paged=False)
    assert ts.prefix.mode == js.prefix.mode == "slice"
    sr.lockstep(js, ts, sr.shared_prompts(jcfg.vocab_size, n=5), paged=False)
    st = ts.stats
    assert st["parked"] > 0 and st["resumed"] > 0 and st["prefix_hits"] > 0
    js.close()
    ts.close()


def test_serve_local_paged_raises_as_the_reference(pair):
    jcfg = pair[0]
    errors = []
    for serve, config in ((JServe, JServeConfig), (Serve, ServeConfig)):
        kw = dict(arch=jcfg.name, slots=1, max_len=16)
        if config is ServeConfig:
            kw["device"] = "cpu"
        with pytest.raises(ValueError) as err:
            serve.local(config(**kw))
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "paged_decode_step" in errors[1]


def test_registry_serves_moe_and_refuses_encdec_and_vlm():
    """MoE resolves without a paged decode, and so (since the whisper and
    paligemma slice) do ``encdec`` and ``vlm``: the registry serves every
    family."""
    for arch in ARCHS:
        assert get_model(get_config(arch)).family == "moe"
        assert get_model(get_config(arch)).paged_decode_step is None
    for arch, family in (("whisper-tiny", "encdec"), ("paligemma-3b", "vlm")):
        model = get_model(get_config(arch))
        assert model.family == family and model.paged_decode_step is None
