"""The port's dense decode path against the JAX reference.

Weights are initialised by the reference and carried across with
``repro_torch.convert.params_from_numpy``; tokens and pools are made with
numpy and handed to both sides.  Configs are reduced (2 layers): the
reduced phi3 is MHA, so a GQA variant (2 kv heads) runs beside it.

Tolerances:
* float32 logits: ``atol=1e-5`` — the two frameworks' matmuls sum in
  different orders, so logits of O(1) differ by a few ulps;
* bfloat16 logits: ``atol=0.0625`` — four bf16 ulps at the logits'
  magnitude (|logit| < 4, ulp 2^-6): the two frameworks round bf16
  products at different points, and over two layers that adds up to a
  couple of ulps (two measured);
* greedy tokens: exact, at float32 (the gap between the top two logits is
  far above the float32 differences);
* int8 pools: ``atol=5e-4`` on float32 logits — the same quantized values,
  attended in float32 by both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.registry import get_model as jget_model
from repro.serve.pagepool import DevicePagePool as JPool
from repro_torch.configs import get_config
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 tensor_from_numpy)
from repro_torch.models.registry import get_model
from repro_torch.serve.pagepool import DevicePagePool

ARCH = "phi3-mini-3.8b"
MAX_LEN, PT = 16, 4


def variant(compute_dtype, gqa):
    """The same reduced config on both sides."""
    out = []
    for get in (jget_config, get_config):
        cfg = get(ARCH).reduced()
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
        if gqa:
            cfg = dataclasses.replace(cfg, n_kv_heads=2)
        out.append(cfg)
    return out


VARIANTS = [pytest.param(False, id="mha"), pytest.param(True, id="gqa")]


@pytest.fixture(scope="module", params=VARIANTS)
def fp32_pair(request):
    return build_pair("float32", request.param)


def build_pair(compute_dtype, gqa):
    jcfg, tcfg = variant(compute_dtype, gqa)
    jmodel, tmodel = jget_model(jcfg), get_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


def prompt_tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=n)


def run_decode(pair, n_steps, batch=2):
    """Contiguous decode on both sides from one numpy token stream;
    returns the per-step logits of each."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair
    toks = prompt_tokens(jcfg, n_steps * batch, seed=3).reshape(n_steps, batch)
    jcache = jmodel.init_cache(jcfg, batch, MAX_LEN)
    tcache = tmodel.init_cache(tcfg, batch, MAX_LEN, device="cpu")
    jstep = jax.jit(lambda p, c, tk, pos: jmodel.decode_step(p, c, tk, pos, jcfg))
    jl, tl = [], []
    for i in range(n_steps):
        lj, jcache = jstep(jparams, jcache, jnp.asarray(toks[i], jnp.int32),
                           jnp.int32(i))
        lt, tcache = tmodel.decode_step(tparams, tcache,
                                        torch.from_numpy(toks[i]), i, tcfg)
        jl.append(np.asarray(lj, np.float32))
        tl.append(lt.float().numpy())
    return jl, tl


def test_decode_step_logits_match_fp32(fp32_pair):
    jl, tl = run_decode(fp32_pair, n_steps=4)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


def test_decode_step_logits_close_bf16():
    jl, tl = run_decode(build_pair("bfloat16", gqa=True), n_steps=3)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, a, atol=0.0625, rtol=0)


def pools_pair(jcfg, jmodel, tcfg, tmodel, quantized=False, n_pages=8):
    jpool = JPool(jax.device_get(jmodel.init_cache(jcfg, 1, MAX_LEN)),
                  jmodel.cache_axes(jcfg, 1, MAX_LEN), PT, n_pages,
                  quantized=quantized)
    tpool = DevicePagePool(tmodel.init_cache(tcfg, 1, MAX_LEN, device="meta"),
                           tmodel.cache_axes(tcfg, 1, MAX_LEN), PT, n_pages,
                           quantized=quantized, device="cpu")
    assert sorted(jpool.leaves) == sorted(tpool.leaves)
    for name in jpool.leaves:
        assert tuple(jpool.leaves[name].shape) == tuple(tpool.leaves[name].shape)
    return jpool, tpool


def paged_run(pair, T, quantized=False, chunks=3):
    """``chunks`` paged steps of T tokens for two lanes at unequal
    positions on both sides; returns the emitted tokens and the final
    pools of each."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair
    jpool, tpool = pools_pair(jcfg, jmodel, tcfg, tmodel, quantized)
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    pos = np.asarray([0, 1], np.int32)
    toks = prompt_tokens(jcfg, chunks * 2 * T, seed=5).reshape(chunks, 2, T)
    jfn = jax.jit(lambda p, pl, tb, ps, tk:
                  jmodel.paged_decode_step(p, pl, tb, ps, tk, jcfg))
    jpools = jpool.leaves
    tpools = tpool.leaves
    jout, tout = [], []
    for c in range(chunks):
        oj, jpools = jfn(jparams, jpools, tables, pos + c * T, toks[c])
        ot, tpools = tmodel.paged_decode_step(
            tparams, tpools, torch.from_numpy(tables),
            torch.from_numpy(pos + c * T), torch.from_numpy(toks[c]), tcfg)
        jout.append(np.asarray(oj))
        tout.append(ot.numpy())
    return np.concatenate(jout, 1), np.concatenate(tout, 1), jpools, tpools


@pytest.mark.parametrize("T", [1, 4])
def test_paged_decode_tokens_equal_reference(fp32_pair, T):
    jout, tout, jpools, tpools = paged_run(fp32_pair, T)
    np.testing.assert_array_equal(tout, jout)
    for name in jpools:
        np.testing.assert_allclose(tpools[name].numpy(),
                                   np.asarray(jpools[name]), atol=1e-5)


def test_paged_decode_equals_port_decode_step(fp32_pair):
    """The port's own exactness contract: paged decode through page
    tables emits exactly the tokens of contiguous ``decode_step``, for
    T=1 and T=3."""
    *_, tcfg, tmodel, tparams = fp32_pair
    toks = prompt_tokens(tcfg, 2 * 6, seed=9).reshape(2, 6)
    cache = tmodel.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    want = []
    for i in range(6):
        logits, cache = tmodel.decode_step(tparams, cache,
                                           torch.from_numpy(toks[:, i]), i, tcfg)
        want.append(logits.argmax(-1).to(torch.int32))
    want = torch.stack(want, 1)
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    for T in (1, 3):
        pools = DevicePagePool(
            tmodel.init_cache(tcfg, 1, MAX_LEN, device="meta"),
            tmodel.cache_axes(tcfg, 1, MAX_LEN), PT, 8, device="cpu").leaves
        got = []
        for c in range(0, 6, T):
            out, pools = tmodel.paged_decode_step(
                tparams, pools, tables,
                torch.tensor([c, c], dtype=torch.int32),
                torch.from_numpy(toks[:, c:c + T]), tcfg)
            got.append(out)
        assert torch.equal(torch.cat(got, 1), want)


def test_int8_pool_step_close_to_reference(fp32_pair):
    jout, tout, jpools, tpools = paged_run(fp32_pair, T=2, quantized=True,
                                           chunks=2)
    np.testing.assert_array_equal(tout, jout)
    for name in jpools:
        got, want = tpools[name].numpy(), np.asarray(jpools[name])
        if got.dtype == np.int8:
            # a 1-step difference in round() at a .5 boundary is the most
            # the float32 differences upstream can cause
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)


def test_init_shapes_dtypes_and_scale():
    cfg = get_config(ARCH).reduced()
    model = get_model(cfg)
    params = model.init(0, cfg, device="cpu")
    shapes = model.param_shapes(cfg)
    jshapes = jax.tree_util.tree_map(
        lambda s: tuple(s.shape), jget_model(jget_config(ARCH).reduced())
        .param_shapes(jget_config(ARCH).reduced()))

    def check(p, s, js, path):
        for k in s:
            if isinstance(s[k], dict):
                check(p[k], s[k], js[k], f"{path}/{k}")
                continue
            assert p[k].shape == s[k].shape and tuple(p[k].shape) == js[k], path
            assert p[k].dtype == torch.float32 and p[k].device.type == "cpu"
    check(params, shapes, jshapes, "")
    wq = params["layers"]["attn"]["wq"]
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 0.02
    assert abs(params["embed"].std().item() - 0.02) < 0.002
    assert torch.equal(params["ln_f"]["gamma"], torch.ones(cfg.d_model))
    # carried weights survive the round trip bit for bit
    back = params_to_numpy(params)
    again = params_from_numpy(back, cfg, device="cpu")
    assert torch.equal(again["layers"]["ffn"]["wd"],
                       params["layers"]["ffn"]["wd"])
    bf = tensor_from_numpy(np.asarray(jnp.asarray([1.5, -2.0], jnp.bfloat16)),
                           device="cpu")
    assert bf.dtype == torch.bfloat16 and bf.tolist() == [1.5, -2.0]


@pytest.mark.parametrize("fast", [False, True])
def test_layers_match_reference(fast):
    """Norms (both forms), activations, partial rotary, the padded-vocab
    head and GQA decode attention, op for op against the reference's
    ``models/layers.py`` (float32: a few ulps apart at most)."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    tol = dict(atol=1e-6, rtol=1e-6)
    rng = np.random.default_rng(21)
    x, g, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 3, 16), (16,), (16,)))
    t = torch.from_numpy
    np.testing.assert_allclose(TL.rmsnorm(t(x), t(g), 1e-5, fast).numpy(),
                               JL.rmsnorm(x, g, 1e-5, fast), **tol)
    np.testing.assert_allclose(TL.layernorm(t(x), t(g), t(b), 1e-5, fast).numpy(),
                               JL.layernorm(x, g, b, 1e-5, fast), **tol)
    for name in ("swiglu", "gelu", "relu2"):
        np.testing.assert_allclose(TL.act_fn(name)(t(x)).numpy(),
                                   JL.act_fn(name)(x), **tol)
    pos = np.asarray([0, 3, 7, 250, 4095])
    cos, sin = TL.rope_freqs(8, 1e5, t(pos))
    jcos, jsin = JL.rope_freqs(8, 1e5, jnp.asarray(pos))
    np.testing.assert_allclose(cos.numpy(), jcos, **tol)
    xr = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(TL.apply_rope(t(xr), cos, sin).numpy(),
                               JL.apply_rope(xr, jcos, jsin), atol=1e-5)
    head = rng.standard_normal((16, 256)).astype(np.float32)
    got = TL.lm_logits(t(x[:, :1]), t(head), 250, torch.float32).numpy()
    want = np.asarray(JL.lm_logits(x[:, :1], head, 250, jnp.float32))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got[..., 250:] == -1e30).all()
    q = rng.standard_normal((2, 6, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
              for _ in range(2))
    lengths = np.asarray([9, 4], np.int32)
    np.testing.assert_allclose(
        TL.decode_attention(t(q), t(kc), t(vc), t(lengths)).numpy(),
        JL.decode_attention(q, kc, vc, lengths), atol=3e-6, rtol=1e-5)
