"""The port's paged-attention path against the JAX reference.

On the CPU the port's ``kernels.ops`` runs the plain PyTorch versions in
``repro_torch/kernels/ref.py``; they are held here against the Pallas
kernels in interpret mode and against the reference's jnp oracles, on
the same numpy inputs.  The CUDA kernel itself runs only on the card:
the ``cuda``-marked test holds it against the plain version there.

Tolerances:
* float32: ``atol=3e-6, rtol=1e-5``, the reference's own
  (tests/test_paged_attention.py) — the two sides sum in different
  orders;
* bfloat16: ``atol=rtol=2e-2`` — the port rounds bf16 products where the
  reference's einsum does, the Pallas kernel rounds only p, so the two
  differ by a few bf16 ulps of O(1) outputs;
* int8 values and scales: bit-equal (same float32 math, same rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.memory import codecs as tcodecs
from repro.memory import codecs as jcodecs

F32_TOL = dict(atol=3e-6, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)

CASES = [
    # b, hq, hkv, d, page, n_pages_per_row
    pytest.param((2, 4, 4, 16, 8, 4), id="mha"),
    pytest.param((3, 6, 2, 16, 4, 5), id="gqa3"),
    pytest.param((2, 9, 1, 8, 8, 3), id="gqa9"),
]


def make_pool(case, seed, dtype=np.float32):
    """A shared pool: row 1 shares row 0's first page, every row has a
    ragged length, and table entries past a row's valid pages are -1."""
    b, hq, hkv, d, page, n_p = case
    rng = np.random.default_rng(seed)
    n = b * n_p + 1
    q = rng.standard_normal((b, hq, d)).astype(dtype)
    k = rng.standard_normal((n, page, hkv, d)).astype(dtype)
    v = rng.standard_normal((n, page, hkv, d)).astype(dtype)
    table = (1 + np.arange(b * n_p, dtype=np.int32)).reshape(b, n_p)
    table[1, 0] = table[0, 0]                    # shared prefix page
    lengths = rng.integers(1, n_p * page + 1, size=b).astype(np.int32)
    lengths[0] = n_p * page - 3                  # ragged, not a page multiple
    for r in range(b):
        used = -(-int(lengths[r]) // page)
        table[r, used:] = -1                     # sentinels past the end
    return q, k, v, table, lengths


def t(x):
    return torch.from_numpy(np.array(x))


def tb(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def as_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.mark.parametrize("case", CASES)
def test_paged_plain_matches_pallas_and_jnp_f32(case):
    q, k, v, table, lengths = make_pool(case, seed=1)
    got = ops.paged_attention(t(q), t(k), t(v), t(table), t(lengths))
    pallas = jpa.paged_attention_pallas(q, k, v, table, lengths, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32_TOL)
    oracle = jpa.paged_attention(q, k, v, np.clip(table, 0, None), lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32_TOL)


@pytest.mark.parametrize("case", CASES[:2])
def test_paged_plain_matches_pallas_bf16(case):
    q, k, v, table, lengths = make_pool(case, seed=2)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    got = ops.paged_attention(tb(q), tb(k), tb(v), t(table), t(lengths))
    assert got.dtype == torch.bfloat16
    pallas = jpa.paged_attention_pallas(qb, kb, vb, table, lengths,
                                        interpret=True)
    np.testing.assert_allclose(as_np(got), as_np(pallas), **BF16_TOL)


def test_multitok_matches_pallas_fold_and_jnp():
    case = (2, 4, 2, 16, 4, 4)
    _, k, v, table, _ = make_pool(case, seed=3)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    positions = np.asarray([[4, 5, 6], [9, 10, 11]], np.int32)
    table = np.abs(table)                        # every page valid here
    got = ops.paged_attention_multitok(t(q), t(k), t(v), t(table),
                                       t(positions))
    pallas = jpa.paged_attention_pallas_multitok(q, k, v, table, positions,
                                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32_TOL)
    oracle = jpa.paged_attention_multitok(q, k, v, table, positions)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32_TOL)


def test_quantize_pages_and_int8_bit_equal_to_reference():
    rng = np.random.default_rng(4)
    pages = (rng.standard_normal((5, 8, 2, 16)) * 3).astype(np.float32)
    pages[1] = 0.0                               # zero page: EPS guard
    jq, js = jpa.quantize_pages(pages)
    tq, ts = tref.quantize_pages(t(pages))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for axis in (None, 0):
        jq, js = jcodecs.int8_quantize(pages, axis=axis)
        tq, ts = tcodecs.int8_quantize(t(pages), axis=axis)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tcodecs.int8_dequantize(tq, ts).numpy(),
            np.asarray(jcodecs.int8_dequantize(jq, js)))


@pytest.mark.parametrize("case", CASES[:2])
def test_quant_plain_matches_pallas_quant(case):
    q, k, v, table, lengths = make_pool(case, seed=5)
    kq, ks = jpa.quantize_pages(k)
    vq, vs = jpa.quantize_pages(v)
    args = [np.asarray(x) for x in (kq, ks, vq, vs)]
    got = ops.paged_attention_quant(t(q), *map(t, args), t(table), t(lengths))
    pallas = jpa.paged_attention_pallas_quant(q, *args, table, lengths,
                                              interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32_TOL)
    oracle = jpa.paged_attention_quant(q, *args, np.clip(table, 0, None),
                                       lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32_TOL)


def test_quant_multitok_matches_pallas_fold():
    case = (2, 4, 2, 16, 4, 4)
    _, k, v, table, _ = make_pool(case, seed=6)
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    positions = np.asarray([[2, 3, 4], [12, 13, 14]], np.int32)
    table = np.abs(table)
    args = [np.asarray(x) for x in (*jpa.quantize_pages(k),
                                    *jpa.quantize_pages(v))]
    got = ops.paged_attention_quant_multitok(t(q), *map(t, args), t(table),
                                             t(positions))
    pallas = jpa.paged_attention_pallas_quant_multitok(
        q, *args, table, positions, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32_TOL)


def test_kernel_refuses_cpu_tensors():
    q, k, v, table, lengths = make_pool((2, 4, 4, 16, 8, 4), seed=7)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_attention(t(q), t(k), t(v), t(table), t(lengths),
                            use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention(t(q), t(k), t(v), t(table), t(lengths))
    kq, ks = tref.quantize_pages(t(k))
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_attention_quant(t(q), kq, ks, kq, ks, t(table), t(lengths),
                                  use_kernel=True)
    # use_kernel=False on a CPU tensor is simply the plain version
    plain = ops.paged_attention(t(q), t(k), t(v), t(table), t(lengths),
                                use_kernel=False)
    assert torch.equal(plain, ops.paged_attention(t(q), t(k), t(v), t(table),
                                                  t(lengths)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for case in ((4, 32, 32, 96, 16, 8), (3, 36, 4, 128, 16, 5)):
        q, k, v, table, lengths = make_pool(case, seed=8)
        args = [t(x).to(dev) for x in (q, k, v, table, lengths)]
        args[:3] = [a.to(dtype) for a in args[:3]]
        got = ops.paged_attention(*args)
        want = ops.paged_attention(*args, use_kernel=False)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        kq, ks = tref.quantize_pages(args[1])
        vq, vs = tref.quantize_pages(args[2])
        got = ops.paged_attention_quant(args[0], kq, ks, vq, vs, *args[3:])
        want = ops.paged_attention_quant(args[0], kq, ks, vq, vs, *args[3:],
                                         use_kernel=False)
        torch.testing.assert_close(got.float(), want.float(), **tol)


def test_decode_attention_ref_matches_reference():
    from repro.kernels import ref as jref

    rng = np.random.default_rng(9)
    q = rng.standard_normal((3, 6, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
              for _ in range(2))
    lengths = np.asarray([10, 1, 6], np.int32)
    got = tref.decode_attention_ref(t(q), t(kc), t(vc), t(lengths))
    want = jref.decode_attention_ref(q, kc, vc, lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# ---------------------------------------------------------------------- #
# flash attention and the XOR reduce
# ---------------------------------------------------------------------- #

FLASH_CASES = [
    # b, tq, tk, hq, hkv, d, causal (the reference's tests/test_kernels.py)
    pytest.param((1, 16, 16, 2, 2, 8, True), id="mha"),
    pytest.param((2, 32, 32, 4, 2, 16, True), id="gqa"),
    pytest.param((1, 24, 40, 4, 1, 8, True), id="gqa-offset"),
    pytest.param((1, 16, 16, 2, 2, 8, False), id="full"),
    pytest.param((2, 33, 33, 3, 3, 8, True), id="ragged"),
]


def flash_inputs(case, seed):
    b, tq, tk, hq, hkv, d, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, tq, hq, d)).astype(np.float32),
            rng.standard_normal((b, tk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, tk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, tq, hq, d)).astype(np.float32))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas_and_jnp(case):
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.models import layers as jlayers

    q, k, v, _ = flash_inputs(case, seed=10)
    causal = case[-1]
    got = ops.flash_attention(t(q), t(k), t(v), causal=causal)
    pallas = flash_attention_pallas(q, k, v, causal=causal, block_q=8,
                                    block_k=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32_TOL)
    jnp_flash = jlayers.flash_attention(q, k, v, causal=causal, q_chunk=8,
                                        k_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp_flash), **F32_TOL)


def test_flash_plain_bf16_matches_pallas():
    from repro.kernels.flash_attention import flash_attention_pallas

    q, k, v, _ = flash_inputs((2, 16, 16, 4, 2, 8, True), seed=11)
    got = ops.flash_attention(tb(q), tb(k), tb(v))
    assert got.dtype == torch.bfloat16
    pallas = flash_attention_pallas(*(jnp.asarray(x, jnp.bfloat16)
                                      for x in (q, k, v)),
                                    block_q=8, block_k=8, interpret=True)
    np.testing.assert_allclose(as_np(got), as_np(pallas), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("case", [FLASH_CASES[1], FLASH_CASES[2],
                                  FLASH_CASES[4]])
def test_flash_plain_backward_matches_jax_grad(case):
    """dQ, dK, dV of the plain version (the backward kernel's plain
    version) against ``jax.grad`` of the reference's jnp flash attention;
    float32 at ``atol=1e-5, rtol=1e-5``: O(1) gradients summed over
    every query of a GQA group in different orders."""
    import jax
    from repro.models import layers as jlayers

    q, k, v, dout = flash_inputs(case, seed=12)
    causal = case[-1]

    def jloss(q, k, v):
        out = jlayers.flash_attention(q, k, v, causal=causal, q_chunk=8,
                                      k_chunk=8)
        return (out * dout).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq_, tk_, tv_ = (t(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq_, tk_, tv_, causal=causal)
    got = torch.autograd.grad(out, (tq_, tk_, tv_), t(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("r", [1, 2, 5])
def test_xor_plain_matches_pallas_exactly(r):
    from repro.kernels.xor_parity import xor_reduce_pallas

    rng = np.random.default_rng(r)
    x = rng.integers(-2**31, 2**31 - 1, size=(r, 37, 128), dtype=np.int32)
    got = ops.xor_reduce(t(x))
    want = xor_reduce_pallas(x, block_rows=8, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flash_kernel_path_refuses_what_it_has_no_semantics_for():
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import xor_parity as txp

    q, k, v, _ = flash_inputs((1, 16, 16, 2, 2, 8, True), seed=13)
    with pytest.raises(ValueError, match="prefix"):
        ops.flash_attention(t(q), t(k), t(v), prefix_len=4, use_kernel=True)
    # the plain version keeps the reference's prefix-LM mask
    plain = ops.flash_attention(t(q), t(k), t(v), prefix_len=4)
    assert torch.isfinite(plain).all()
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(t(q), t(k), t(v), use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(t(q), t(k), t(v))
    with pytest.raises(ValueError, match="CUDA"):
        txp.xor_reduce(torch.zeros((2, 1, 128), dtype=torch.int32))


@pytest.mark.cuda
def test_cuda_flash_and_xor_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for case in ((2, 200, 200, 32, 32, 96, True), (1, 100, 300, 36, 4, 128,
                                                   True)):
        q, k, v, dout = (t(x).to(dev) for x in flash_inputs(case, seed=14))
        grads = []
        for use_kernel in (None, False):
            qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
            out = ops.flash_attention(qs, ks, vs, use_kernel=use_kernel)
            grads.append((out,) + torch.autograd.grad(out, (qs, ks, vs), dout))
        torch.testing.assert_close(grads[0][0], grads[1][0], **F32_TOL)
        # gradients sum up to g * T products: chip_smoke.py's FLASH_BWD_F32_TOL
        for g, w in zip(grads[0][1:], grads[1][1:]):
            torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-5)
    x = torch.randint(-2**31, 2**31 - 1, (4, 1001, 128), dtype=torch.int32,
                      device=dev)
    assert torch.equal(ops.xor_reduce(x), ops.xor_reduce(x, use_kernel=False))
