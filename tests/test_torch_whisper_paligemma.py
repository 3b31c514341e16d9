"""The port's encoder-decoder (whisper-tiny) and vision-language
(paligemma-3b) families against the JAX reference.

The reduced configs at float32 compute, with the reference's weights
carried across (``repro_torch.convert``): whisper 2 encoder + 2 decoder
layers over 16 stub frames, paligemma 2 layers over 8 stub patches, MQA
at head dim 16.  Batches add the stub frontend's embeddings
(``test_torch_family_parity.ModalPipeline``).  Values at the family
checks' tolerances (``tests/test_torch_family_parity.py``): ``atol=5e-5,
rtol=1e-4`` for encoder states, logits, loss, gradients, decode logits
and caches; params after AdamW steps at 10% of ``lr`` per step; tokens,
the trainer's kill / recover runs, checkpoint bytes and the converted
trees exact.  The reference's forwards reach its jnp flash attention
(the model path, whose prefix-LM mask its Pallas dispatch would drop).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_family_parity as fp
import test_torch_serve_resilience as sr
from repro.configs import ALL_SHAPES as J_SHAPES
from repro.configs import arch_ids as jarch_ids
from repro.configs import get_config as jget_config
from repro.models import registry as jregistry
from repro.models import whisper as jwhisper
from repro.serve import Serve as JServe
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import ALL_SHAPES, arch_ids, get_config
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 state_to_numpy, train_state_from_numpy)
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.models import whisper as twhisper
from repro_torch.serve import Serve, ServeConfig

ARCHS = ["whisper-tiny", "paligemma-3b"]
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


def get_pair(arch):
    if arch not in _PAIRS:
        _PAIRS[arch] = fp.make_pair(arch)
    return _PAIRS[arch]


@pytest.fixture(params=ARCHS)
def pair(request):
    return get_pair(request.param)


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------- #
# the shared family checks
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_shapes_and_spread(arch):
    fp.check_init(arch)


def test_forward_logits_match_reference(pair):
    """Logits of the text rows only: paligemma strips its patch rows."""
    fp.check_forward(pair)
    jcfg = pair[0]
    batch = fp.batches(jcfg, 1)[0]
    assert fp.modal_input(jcfg)[0] in batch
    tparams = params_from_numpy(pair[2]["params"], pair[3], device="cpu")
    with torch.no_grad():
        got, aux = pair[4].forward(tparams, fp.t_batch(batch), pair[3],
                                   remat=False)
    assert aux == {} and tuple(got.shape) == (
        *batch["tokens"].shape, pair[3].padded_vocab)


def test_loss_and_grads_match_reference(pair):
    fp.check_loss_and_grads(pair)


def test_train_steps_match_reference(pair):
    fp.check_train_steps(pair)


def test_decode_chain_matches_reference(pair):
    """Token-by-token decode (whisper over its zero cross cache, as the
    reference's serving cell leaves it): logits and every cache leaf."""
    fp.check_decode(pair)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_kill_and_recover_is_bitwise(arch):
    """The trainer with the stub inputs in its batches (paligemma at the
    2 layers its published-width chip run does not kill): one node killed
    at step 6 of 8, the recovered state equal to an uninterrupted run's."""
    fp.check_trainer_kill_and_recover(arch)


def test_checkpoint_bytes_match_reference(pair):
    fp.check_checkpoint_bytes(pair)


def test_convert_carries_the_trees_both_ways(pair):
    """whisper's ``enc_layers`` / ``ln_enc`` / ``dec_layers`` and
    paligemma's dense tree cross key for key and byte for byte, params
    and whole train states."""
    _, _, jstate, tcfg, _ = pair
    tparams = params_from_numpy(jstate["params"], tcfg, device="cpu")
    if tcfg.family == "encdec":
        assert set(tparams) == {"embed", "enc_layers", "ln_enc",
                                "dec_layers", "ln_f"}
        assert set(tparams["dec_layers"]) == {"ln1", "self_attn", "ln_cross",
                                              "cross_attn", "ln2", "ffn"}
    else:
        assert set(tparams) == {"embed", "layers", "ln_f"}
    for got_tree, want_tree in (
            (params_to_numpy(tparams), jstate["params"]),
            (state_to_numpy(train_state_from_numpy(jstate, tcfg, device="cpu")),
             jstate)):
        flat = jax.tree_util.tree_leaves_with_path(want_tree)
        assert len(flat) == len(jax.tree_util.tree_leaves(got_tree))
        for path, want in flat:
            got = got_tree
            for key in path:
                got = got[key.key]
            assert np.asarray(want).tobytes() == np.asarray(got).tobytes(), path


# ---------------------------------------------------------------------- #
# whisper: encoder, cross cache
# ---------------------------------------------------------------------- #


def frames(cfg, b=2, seed=5):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def test_whisper_encode_matches_reference():
    jcfg, _, jstate, tcfg, _ = get_pair("whisper-tiny")
    x = frames(jcfg)
    want = jwhisper.encode(jstate["params"], jnp.asarray(x), jcfg)
    tparams = params_from_numpy(jstate["params"], tcfg, device="cpu")
    with torch.no_grad():
        got = twhisper.encode(tparams, t(x), tcfg)
    fp.close(got, want, TOL, "encoder states")


def test_whisper_prime_cross_cache_then_decode_matches_reference():
    """The cross K/V filled from encoder states, then a decode chain over
    them: logits and every cache leaf."""
    jcfg, _, jstate, tcfg, _ = get_pair("whisper-tiny")
    x = frames(jcfg)
    jp = jstate["params"]
    tparams = params_from_numpy(jp, tcfg, device="cpu")
    jcache = jwhisper.prime_cross_cache(
        jp, jwhisper.init_cache(jcfg, 2, 12), jwhisper.encode(jp, x, jcfg), jcfg)
    with torch.no_grad():
        tcache = twhisper.prime_cross_cache(
            tparams, twhisper.init_cache(tcfg, 2, 12, device="cpu"),
            twhisper.encode(tparams, t(x), tcfg), tcfg)
    for name in ("cross_k", "cross_v"):
        fp.close(tcache[name], jcache[name], TOL, name)
        assert float(tcache[name].abs().max()) > 0
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 5),
                                             dtype=np.int32)
    step = jax.jit(jwhisper.decode_step, static_argnums=4)
    for i in range(toks.shape[1]):
        jl, jcache = step(jp, jcache, toks[:, i], jnp.int32(i), jcfg)
        with torch.no_grad():
            tl, tcache = twhisper.decode_step(tparams, tcache, t(toks[:, i]),
                                              i, tcfg)
        fp.close(tl, jl, TOL, f"decode logits at token {i}")
    for name, leaf in jax.device_get(jcache).items():
        fp.close(tcache[name], leaf, TOL, f"cache {name}")


def test_whisper_attention_calls_and_positions():
    """The encoder's and the cross-attention's flash calls are non-causal
    over the frames, the decoder's self-attention causal over the text;
    none carries a prefix.  The position table is the reference's."""
    jcfg, _, jstate, tcfg, tmodel = get_pair("whisper-tiny")
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    np.testing.assert_array_equal(tlayers.sinusoidal_positions(50, 64).numpy(),
                                  jlayers.sinusoidal_positions(50, 64))
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, causal=True, prefix_len=0, **kw):
        seen.append((q.shape[1], k.shape[1], causal, prefix_len))
        return real(q, k, v, causal=causal, prefix_len=prefix_len, **kw)

    ops.flash_attention = spy
    try:
        tparams = params_from_numpy(jstate["params"], tcfg, device="cpu")
        with torch.no_grad():
            tmodel.forward(tparams, fp.t_batch(fp.batches(jcfg, 1)[0]), tcfg,
                           remat=False)
    finally:
        ops.flash_attention = real
    enc, text = tcfg.enc_seq, fp.SEQ["encdec"]
    want = ([(enc, enc, False, 0)] * tcfg.n_enc_layers
            + [(text, text, True, 0), (text, enc, False, 0)] * tcfg.n_layers)
    assert seen == want


# ---------------------------------------------------------------------- #
# paligemma: the prefix-LM forward
# ---------------------------------------------------------------------- #


def test_paligemma_attends_with_the_prefix_lm_mask():
    """Every layer's flash call carries prefix_len = n_prefix over the
    patches and the text together; a change in the last patch reaches
    every text row (the prefix is bidirectional), a change in the last
    text token reaches no earlier text row (the text is causal)."""
    jcfg, _, jstate, tcfg, tmodel = get_pair("paligemma-3b")
    tparams = params_from_numpy(jstate["params"], tcfg, device="cpu")
    batch = fp.t_batch(fp.batches(jcfg, 1, batch=2)[0])
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, causal=True, prefix_len=0, **kw):
        seen.append((q.shape[1], causal, prefix_len))
        return real(q, k, v, causal=causal, prefix_len=prefix_len, **kw)

    ops.flash_attention = spy
    try:
        with torch.no_grad():
            base, _ = tmodel.forward(tparams, batch, tcfg, remat=False)
    finally:
        ops.flash_attention = real
    n_text = batch["tokens"].shape[1]
    assert seen == [(tcfg.n_prefix + n_text, True, tcfg.n_prefix)] * tcfg.n_layers
    moved = dict(batch, patches=batch["patches"].clone())
    moved["patches"][:, -1] += 1.0
    tokens = batch["tokens"].clone()
    tokens[:, -1] = (tokens[:, -1] + 1) % tcfg.vocab_size
    with torch.no_grad():
        by_patch, _ = tmodel.forward(tparams, moved, tcfg, remat=False)
        by_token, _ = tmodel.forward(tparams, dict(batch, tokens=tokens), tcfg,
                                     remat=False)
    assert (by_patch - base).abs().amax(dim=-1).min() > 0
    assert torch.equal(by_token[:, :-1], base[:, :-1])


# ---------------------------------------------------------------------- #
# registry: input specs and inputs
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("shape", [s.name for s in ALL_SHAPES])
def test_input_specs_match_reference_for_every_family(shape):
    """For every configuration: the same input names, shapes and dtypes as
    the reference's ``input_specs``, and ``make_inputs`` of those shapes
    and dtypes, drawn on the given device (ids within the vocabulary)."""
    assert arch_ids() == jarch_ids()
    tshape = next(s for s in ALL_SHAPES if s.name == shape)
    jshape = next(s for s in J_SHAPES if s.name == shape)
    for arch in arch_ids():
        cfg, jcfg = get_config(arch), jget_config(arch)
        want = jregistry.input_specs(jcfg, jshape)
        got = registry.input_specs(cfg, tshape)
        assert set(got) == set(want), arch
        for name, (dims, dtype) in got.items():
            assert dims == want[name].shape, (arch, name)
            assert str(dtype).split(".")[1] == want[name].dtype.name, (arch, name)
        small = dataclasses.replace(tshape, seq_len=min(tshape.seq_len, 300),
                                    global_batch=2)
        small_cfg = cfg.reduced()
        inputs = registry.make_inputs(small_cfg, small,
                                      torch.Generator().manual_seed(0), "cpu")
        specs = registry.input_specs(small_cfg, small)
        assert set(inputs) == set(specs)
        for name, x in inputs.items():
            assert (tuple(x.shape), x.dtype, x.device.type) == (
                *specs[name], "cpu"), (arch, name)
            if not x.dtype.is_floating_point:
                assert 0 <= int(x.min()) and int(x.max()) < small_cfg.vocab_size


# ---------------------------------------------------------------------- #
# serving: the contiguous scheduler, save and restore; no paged decode
# ---------------------------------------------------------------------- #


def sides(arch):
    jcfg, jmodel, jstate, tcfg, tmodel = get_pair(arch)
    jparams = jax.tree_util.tree_map(jnp.asarray, jstate["params"])
    tparams = params_from_numpy(jstate["params"], tcfg, device="cpu")
    return (jcfg, jmodel, jparams), (tcfg, tmodel, tparams)


@pytest.mark.parametrize("arch,mode", [("whisper-tiny", "snapshot"),
                                       ("paligemma-3b", "slice")])
def test_contiguous_scheduler_with_pager_and_prefix(arch, mode):
    """The contiguous scheduler in lockstep with the reference: the same
    tokens, parks, resumes, trie and counters.  whisper's cross leaves
    have no kv_seq axis, so its prefix cache keeps snapshots."""
    jside, tside = sides(arch)
    js, ts = sr.build(sr.J, jside, paged=False), sr.build(sr.T, tside, paged=False)
    assert ts.prefix.mode == js.prefix.mode == mode
    sr.lockstep(js, ts, sr.shared_prompts(jside[0].vocab_size, n=5), paged=False)
    for name, lane in ts.slots_cache.items():
        np.testing.assert_allclose(lane.numpy(), np.asarray(js.slots_cache[name]),
                                   **sr.LANE_TOL, err_msg=name)
    st = ts.stats
    assert st["parked"] > 0 and st["resumed"] > 0 and st["prefix_hits"] > 0
    js.close()
    ts.close()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_serving_checkpoint_restores_in_either_package(arch, writer, tmp_path):
    """A contiguous run checkpointed with a stream parked and a node lost
    is restored by the port (from the port's or the reference's files) and
    finishes with the uninterrupted run's tokens; a restore inside the
    port reproduces the saved lanes, pager tables and trie exactly."""
    jside, tside = sides(arch)
    prompts = sr.shared_prompts(jside[0].vocab_size)
    ref = sr.build(sr.T, tside, paged=False)
    sids = [ref.submit(p, max_new=sr.MAX_NEW) for p in prompts]
    ref.run()
    want = [ref.output(s) for s in sids]
    ref.close()

    wpkg, wside = (sr.T, tside) if writer == "torch" else (sr.J, jside)
    cluster, sess = sr.session(wpkg, tmp_path / "run")
    w = sr.build(wpkg, wside, paged=False, session=sess)
    for p in prompts:
        w.submit(p, max_new=sr.MAX_NEW)
    sr.run_until_checkpointable(w, False)
    w.save()
    sess.wait_drained()
    saved = w.live_descriptors()
    fingerprint = sr.fingerprint(w) if writer == "torch" else None
    w.close()
    sess.close()

    cluster, sess = sr.session(sr.T, tmp_path / "run")
    cluster.fail(1)
    cluster.recover(1)
    sess.invalidate_node(1)
    r = sr.build(sr.T, tside, paged=False, session=sess)
    r.restore()
    assert r.live_descriptors() == saved
    if fingerprint is not None:
        assert sr.fingerprint(r) == fingerprint
    r.run()
    assert [r.output(s) for s in sids] == want
    r.close()
    sess.close()
    cluster.teardown()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_local_contiguous_save_and_restore_and_paged_raises(arch,
                                                                  tmp_path):
    """``Serve.local(paged=False)`` (bf16 compute, its own random weights):
    decoded partway, saved through an XOR session, the stack closed and a
    node lost, restored into a fresh ``Serve.local``: the tokens of an
    uninterrupted run.  ``paged=True`` raises the reference's error, word
    for word."""
    cfg = ServeConfig(arch=arch, paged=False, slots=2, max_len=32,
                      page_tokens=4, quantum=3, device="cpu")
    prompts = sr.shared_prompts(get_config(arch).reduced().vocab_size, n=4)
    with Serve.local(cfg) as srv:
        sids = [srv.submit(p, max_new=5) for p in prompts]
        srv.run()
        want = [srv.output(s) for s in sids]
    assert all(len(o) == 5 for o in want)
    cluster, sess = sr.session(sr.T, tmp_path)
    with sess:
        srv = Serve.local(cfg, session=sess)
        for p in prompts:
            srv.submit(p, max_new=5)
        srv.run(max_steps=6)
        srv.save()
        assert srv.pager.parked_sids()
        srv.close()
        cluster.fail(1)
        cluster.recover(1)
        sess.invalidate_node(1)
        srv2 = Serve.local(cfg, session=sess)
        srv2.restore()
        srv2.run()
        assert [srv2.output(s) for s in sids] == want
        srv2.close()
    cluster.teardown()
    errors = []
    for serve, config in ((JServe, JServeConfig), (Serve, ServeConfig)):
        kw = dict(arch=arch, slots=1, max_len=16)
        if config is ServeConfig:
            kw["device"] = "cpu"
        with pytest.raises(ValueError) as err:
            serve.local(config(**kw))
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "paged_decode_step" in errors[1]
