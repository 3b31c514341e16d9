"""The port's Multi-head Latent Attention (minicpm3-4b) against the JAX
reference.

The reduced minicpm3-4b (2 layers, d_model 64, 4 heads; q_lora 32,
kv_lora 16, qk 16 + 8 rope, v 16) at float32 compute, with the
reference's weights carried across.  Training runs its attention through
``ops.flash_attention`` with V narrower than Q and K (qk 24, v 16): on
the CPU the plain version, whose Dv != D cases
``tests/test_torch_kernels.py`` holds against the Pallas kernel; on the
card the CUDA kernels.  Decoding caches the latent ``ckv`` and rope key
and attends in latent space on both the contiguous and the paged path.

Tolerances (``tests/test_torch_family_parity.py``): logits, loss, decode
logits and caches, pools, gradients, opt.m / opt.v ``atol=5e-5,
rtol=1e-4``; params after 1 and 3 AdamW steps ``rtol=1e-4`` and ``atol``
of 10% of ``lr`` per step; the int8 pool's dequantized values within the
reference's int8 gate (0.05, tests/test_codecs.py:238); tokens, the
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
from repro.memory.codecs import int8_dequantize as jdeq
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.memory.codecs import SCALE_SUFFIX

ARCH = "minicpm3-4b"
PT, NP = 4, 4                  # page tokens, pages per lane (s_pad 16)
QUANT_TOL = dict(atol=0.05, rtol=0.05)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tensors are tiny and the suite runs
    several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return fp.make_pair(ARCH)


def test_reduced_config_is_mla_with_a_narrower_v(pair):
    tcfg = pair[3]
    m = tcfg.mla
    assert m is not None and m.v_head_dim < m.qk_nope_dim + m.qk_rope_dim


def test_mla_forward_logits_match_reference(pair):
    fp.check_forward(pair)


def test_mla_forward_runs_flash_with_v_of_its_own_width(pair, monkeypatch):
    """Every layer's attention is one ``ops.flash_attention`` call with
    k (B, T, H, qk) and v (B, T, H, v_head_dim), scale qk ** -0.5."""
    _, _, jstate, tcfg, tmodel = pair
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                     kw.get("scale")))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    tparams = params_from_numpy(jstate["params"], tcfg, device="cpu")
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    with torch.no_grad():
        tmodel.forward(tparams, {"tokens": tokens}, tcfg, remat=False)
    m = tcfg.mla
    qk = m.qk_nope_dim + m.qk_rope_dim
    h = tcfg.padded_heads
    assert seen == [((2, 8, h, qk), (2, 8, h, qk), (2, 8, h, m.v_head_dim),
                     qk ** -0.5)] * tcfg.n_layers


def test_mla_loss_and_grads_match_reference(pair):
    fp.check_loss_and_grads(pair)


def test_mla_train_steps_match_reference(pair):
    fp.check_train_steps(pair)


def test_mla_decode_chain_matches_reference(pair):
    fp.check_decode(pair)


def test_mla_init_matches_reference_shapes_and_spread():
    fp.check_init(ARCH)


def test_mla_trainer_kill_and_recover_is_bitwise():
    fp.check_trainer_kill_and_recover(ARCH)


def test_mla_checkpoint_bytes_match_reference(pair):
    fp.check_checkpoint_bytes(pair)


# ---------------------------------------------------------------------- #
# paged decode over the latent pool
# ---------------------------------------------------------------------- #


def pools_for(tcfg, quantized):
    """Zeroed latent pools (L, 1 + 2 NP, PT, width) for two lanes, as
    numpy (and their int8 + scale pairs when ``quantized``)."""
    m = tcfg.mla
    n = 1 + 2 * NP
    out = {}
    for name, width in (("ckv", m.kv_lora_rank), ("k_rope", m.qk_rope_dim)):
        shape = (tcfg.n_layers, n, PT, width)
        if quantized:
            out[name] = np.zeros(shape, np.int8)
            out[name + SCALE_SUFFIX] = np.zeros(shape[:-1], np.float32)
        else:
            out[name] = np.zeros(shape, np.float32)
    return out


def run_paged(pair, t, quantized=False, n_tokens=12):
    """Both packages' ``paged_decode_step`` over two lanes' 12 tokens in
    calls of ``t``; returns (jax tokens, port tokens, jax pools, port
    pools, the inputs)."""
    jcfg, jmodel, jstate, tcfg, tmodel = pair
    tparams = params_from_numpy(jstate["params"], tcfg, device="cpu")
    tables = np.asarray([[1, 2, 3, 4], [8, 7, 6, 5]], np.int32)
    rng = np.random.default_rng(21)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, n_tokens)).astype(np.int32)
    jp = {k: jnp.asarray(v) for k, v in pools_for(tcfg, quantized).items()}
    tp = {k: torch.from_numpy(v) for k, v in pools_for(tcfg, quantized).items()}
    step = jax.jit(jmodel.paged_decode_step, static_argnums=5)
    jout, tout = [], []
    for i in range(0, n_tokens, t):
        pos = np.asarray([i, i], np.int32)
        chunk = toks[:, i:i + t]
        jo, jp = step(jstate["params"], jp, tables, pos, chunk, jcfg)
        with torch.no_grad():
            to, tp = tmodel.paged_decode_step(
                tparams, tp, torch.from_numpy(tables), torch.from_numpy(pos),
                torch.from_numpy(chunk), tcfg)
        jout.append(np.asarray(jo))
        tout.append(to.numpy())
    return (np.concatenate(jout, 1), np.concatenate(tout, 1),
            jax.device_get(jp), tp, (tparams, toks))


@pytest.mark.parametrize("t", [1, 3])
def test_mla_paged_decode_matches_reference_and_decode_step(pair, t):
    """Tokens equal the reference's and the port's own contiguous
    ``decode_step``'s for T 1 and 3; the latent pools match the
    reference's."""
    _, _, _, tcfg, tmodel = pair
    jtok, ttok, jpools, tpools, (tparams, toks) = run_paged(pair, t)
    np.testing.assert_array_equal(ttok, jtok)
    for k in jpools:
        fp.close(tpools[k], jpools[k], fp.LOGIT_TOL, f"pool {k}")
    cache = tmodel.init_cache(tcfg, 2, NP * PT, device="cpu")
    want = []
    with torch.no_grad():
        for i in range(toks.shape[1]):
            logits, cache = tmodel.decode_step(
                tparams, cache, torch.from_numpy(toks[:, i]), i, tcfg)
            want.append(logits.argmax(-1).numpy())
    np.testing.assert_array_equal(ttok, np.stack(want, 1))


def test_mla_int8_pool_close_to_reference(pair):
    """An int8 latent pool: the port quantizes each new row per channel
    with the reference's math; the dequantized pools agree within the
    reference's int8 gate and the tokens agree."""
    jtok, ttok, jpools, tpools, _ = run_paged(pair, 3, quantized=True)
    np.testing.assert_array_equal(ttok, jtok)
    for name in ("ckv", "k_rope"):
        s = name + SCALE_SUFFIX
        want = np.asarray(jdeq(jpools[name], jpools[s][..., None]))
        got = tpools[name].float() * tpools[s][..., None]
        fp.close(got, want, QUANT_TOL, f"dequantized pool {name}")
        assert tpools[name].dtype == torch.int8


@pytest.mark.parametrize("spec_k", [0, 3])
def test_mla_paged_scheduler_with_pager_and_prefix(pair, spec_k):
    """The paged scheduler over rank-4 latent pool leaves, with a pager, a
    prefix cache in slice mode and a pool that spills, in lockstep with
    the reference: the same tokens, allocator, parked streams, trie and
    counters."""
    jcfg, jmodel, jstate, tcfg, tmodel = pair
    tparams = params_from_numpy(jstate["params"], tcfg, device="cpu")
    jside = (jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, jstate["params"]))
    tside = (tcfg, tmodel, tparams)
    js = sr.build(sr.J, jside, spec_k=spec_k)
    ts = sr.build(sr.T, tside, spec_k=spec_k)
    assert ts.prefix.mode == js.prefix.mode == "slice"
    assert {k: v.dim() for k, v in ts.pool.leaves.items()} == {
        "ckv": 4, "k_rope": 4}
    sr.lockstep(js, ts, sr.shared_prompts(jcfg.vocab_size), paged=True)
    st = ts.stats
    assert st["spilled"] > 0 and st["refilled"] > 0 and st["prefix_hits"] > 0
    js.close()
    ts.close()
