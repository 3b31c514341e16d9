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
