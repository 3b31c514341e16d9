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

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro_torch.kernels import _build, ops
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


# The CUDA kernel's split-and-combine algorithm (kernels/ref.py
# ``paged_attention_split``) against the reference.  Page 4, 5 pages per
# row, 2 kv heads with 3 query heads each; the rows' lengths end on a span
# boundary, inside a span, at 0 (zeros), at nP*page and past it (clamped),
# and table entries of -1 and past the pool clamp as they are read.
SPLIT_PAGE, SPLIT_NP = 4, 5
SPLIT_LENGTHS = [8, 7, 0, SPLIT_PAGE * SPLIT_NP, SPLIT_PAGE * SPLIT_NP + 9, 1,
                 12, 13]


def split_pool(seed=11):
    b, hq, hkv, d = len(SPLIT_LENGTHS), 6, 2, 16
    rng = np.random.default_rng(seed)
    n = b * SPLIT_NP + 1
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((n, SPLIT_PAGE, hkv, d)).astype(np.float32)
    v = rng.standard_normal((n, SPLIT_PAGE, hkv, d)).astype(np.float32)
    table = (1 + np.arange(b * SPLIT_NP, dtype=np.int32)).reshape(b, SPLIT_NP)
    table[1, 0] = table[0, 0]                    # shared prefix page
    table[6, 1] = -1                             # clamps to page 0
    table[7, 2] = n + 3                          # clamps to page n-1
    lengths = np.asarray(SPLIT_LENGTHS, np.int32)
    for r in range(b):
        used = -(-min(int(lengths[r]), SPLIT_NP * SPLIT_PAGE) // SPLIT_PAGE)
        table[r, used:] = -1                     # sentinels past the end
    return q, k, v, table, lengths


_split_refs = {}


def split_reference(kind):
    """The inputs of ``kind`` and the Pallas kernel's output on them (in
    interpret mode), computed once per kind."""
    if kind not in _split_refs:
        q, k, v, table, lengths = split_pool()
        if kind == "int8":
            kq, ks = jpa.quantize_pages(k)
            vq, vs = jpa.quantize_pages(v)
            pools = [np.asarray(x) for x in (kq, ks, vq, vs)]
            pallas = jpa.paged_attention_pallas_quant(
                q, *pools, table, lengths, interpret=True)
        elif kind == "bf16":
            pools = [jnp.asarray(x, jnp.bfloat16) for x in (k, v)]
            pallas = jpa.paged_attention_pallas(
                jnp.asarray(q, jnp.bfloat16), *pools, table, lengths,
                interpret=True)
        else:
            pools = [k, v]
            pallas = jpa.paged_attention_pallas(q, k, v, table, lengths,
                                                interpret=True)
        _split_refs[kind] = (q, pools, table, lengths, pallas)
    return _split_refs[kind]


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("split", [1, SPLIT_PAGE - 1, SPLIT_PAGE,
                                   3 * SPLIT_PAGE])
def test_split_and_combine_matches_pallas_and_jnp(split, kind):
    q, pools, table, lengths, pallas = split_reference(kind)
    if kind == "int8":
        got = tref.paged_attention_quant_split(
            t(q), *map(t, pools), t(table), t(lengths), split)
    elif kind == "bf16":
        got = tref.paged_attention_split(tb(q), *map(tb, pools), t(table),
                                         t(lengths), split)
        assert got.dtype == torch.bfloat16
    else:
        got = tref.paged_attention_split(t(q), *map(t, pools), t(table),
                                         t(lengths), split)
    tol = BF16_TOL if kind == "bf16" else F32_TOL
    np.testing.assert_allclose(as_np(got), as_np(pallas), **tol)
    assert not as_np(got)[2].any()               # length 0: zeros
    if kind == "f32":
        # the jnp oracle (clamped table): every row of non-zero length
        n = pools[0].shape[0]
        oracle = np.asarray(jpa.paged_attention(
            q, *pools, np.clip(table, 0, n - 1), lengths))
        live = lengths > 0
        np.testing.assert_allclose(got.numpy()[live], oracle[live], **F32_TOL)


@pytest.mark.parametrize("n_p,page,split", [
    (16, 16, 64),         # phi3 serving: max_len 256 -> 4 spans
    (256, 16, 64),        # 4096 positions -> 64 spans
    (4, 16, 64),          # one span: no workspace, no combine launch
    (5, 4, 3),            # a span that is not a page
    (1, 1, 64),
])
def test_split_plan_arithmetic(n_p, page, split):
    b, hq, hkv, d = 3, 36, 4, 128
    plan = tpa.split_plan(b, hq, hkv, d, page, n_p, split)
    spans = -(-(n_p * page) // split)
    assert plan.max_splits == spans
    assert plan.blocks == b * hkv * spans
    several = spans > 1
    assert plan.workspace == (b * hq * spans * (d + 2) if several else 0)
    assert plan.cuda_launches == (2 if several else 1)
    # every row, whatever its length, fits its spans into the plan, and the
    # last partial and statistic of the last (row, head) lie inside it
    for length in range(-1, n_p * page + 3):
        used = max(1, -(-min(max(length, 0), n_p * page) // split))
        assert used <= plan.max_splits
    if several:
        last_part = ((b * hq - 1) * spans + spans - 1) * d + d - 1
        last_stat = b * hq * spans * d + ((b * hq - 1) * spans + spans - 1) * 2 + 1
        assert last_part < b * hq * spans * d and last_stat == plan.workspace - 1


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
    # one long row (at least 4 spans) beside short ones; each row alone
    # equals its row in the batch, bit for bit, on both kernels
    q, k, v, table, lengths = make_pool((3, 8, 2, 64, 16, 24), seed=9)
    lengths[:] = [24 * 16, 5, 0]
    args = [t(x).to(dev) for x in (q, k, v, table, lengths)]
    args[:3] = [a.to(dtype) for a in args[:3]]
    assert tpa.split_plan(3, 8, 2, 64, 16, 24,
                          tpa.split_tokens()).max_splits >= 4
    kq, ks = tref.quantize_pages(args[1])
    vq, vs = tref.quantize_pages(args[2])
    calls = {
        "plain pool": lambda x, tb_, ln: ops.paged_attention(
            x, args[1], args[2], tb_, ln),
        "int8 pool": lambda x, tb_, ln: ops.paged_attention_quant(
            x, kq, ks, vq, vs, tb_, ln)}
    for name, call in calls.items():
        full = call(args[0], args[3], args[4])
        for r in range(3):
            alone = call(args[0][r:r + 1], args[3][r:r + 1], args[4][r:r + 1])
            assert torch.equal(alone[0], full[r]), (name, r)
        assert not full[2].any(), name
    got = ops.paged_attention(*args)
    want = ops.paged_attention(*args, use_kernel=False)
    torch.testing.assert_close(got[:2].float(), want[:2].float(), **tol)


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
    # non-causal with more query rows than keys (cross-attention)
    pytest.param((1, 24, 16, 2, 2, 8, False), id="cross-tq-over-tk"),
]
# V with its own width Dv (MLA: minicpm3's qk 96, v 64):
# b, tq, tk, hq, hkv, d, dv, causal
DV_CASES = [
    pytest.param((2, 32, 32, 4, 2, 16, 8, True), id="dv-under-d-gqa"),
    pytest.param((1, 24, 40, 4, 1, 8, 16, True), id="dv-over-d-offset"),
    pytest.param((1, 16, 16, 2, 2, 24, 16, False), id="dv-under-d-full"),
    pytest.param((1, 24, 16, 2, 2, 8, 24, False), id="dv-over-d-cross"),
    pytest.param((2, 33, 33, 3, 3, 24, 16, True), id="dv-under-d-ragged"),
]


def flash_inputs(case, seed):
    """q, k, v, dO; ``case`` is (b, tq, tk, hq, hkv, d, causal) or, with
    V of its own width, (b, tq, tk, hq, hkv, d, dv, causal)."""
    b, tq, tk, hq, hkv, d = case[:6]
    dv = case[6] if len(case) == 8 else d
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, tq, hq, d)).astype(np.float32),
            rng.standard_normal((b, tk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, tk, hkv, dv)).astype(np.float32),
            rng.standard_normal((b, tq, hq, dv)).astype(np.float32))


@pytest.mark.parametrize("case", FLASH_CASES + DV_CASES)
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


@pytest.mark.parametrize("case", DV_CASES[:2])
def test_flash_plain_bf16_dv_matches_pallas(case):
    """bfloat16 with V of its own width: the output is (B, Tq, Hq, Dv)
    and within the bf16 tolerance of the Pallas kernel's."""
    from repro.kernels.flash_attention import flash_attention_pallas

    q, k, v, _ = flash_inputs(case, seed=17)
    got = ops.flash_attention(tb(q), tb(k), tb(v), causal=case[-1])
    assert got.dtype == torch.bfloat16 and got.shape[-1] == v.shape[-1]
    pallas = flash_attention_pallas(*(jnp.asarray(x, jnp.bfloat16)
                                      for x in (q, k, v)), causal=case[-1],
                                    block_q=8, block_k=8, interpret=True)
    np.testing.assert_allclose(as_np(got), as_np(pallas), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("case", [FLASH_CASES[1], FLASH_CASES[2],
                                  FLASH_CASES[4]] + DV_CASES)
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


# heads past 256 columns (the CUDA source's wide kernels) and off a
# multiple of 8: b, tq, tk, hq, hkv, d, dv, causal; (576, 512) is absorbed
# MLA decode's
WIDE_CASES = [
    pytest.param((1, 16, 16, 2, 1, 264, 264, True), id="wide-264"),
    pytest.param((1, 12, 20, 2, 2, 300, 300, False), id="wide-300-full"),
    pytest.param((1, 16, 16, 4, 2, 576, 512, True), id="wide-576-512"),
    pytest.param((1, 9, 9, 2, 2, 320, 100, True), id="wide-320-dv100"),
]


@pytest.mark.parametrize("case", WIDE_CASES)
def test_flash_plain_at_wide_heads_matches_jnp_and_jax_grad(case):
    """The plain version (the wide kernels' plain version) against the
    reference's jnp flash and the Pallas kernel (interpret mode), forward
    at ``atol=3e-6, rtol=1e-5``, and dQ, dK, dV against ``jax.grad`` of
    the jnp flash at ``atol=1e-5, rtol=1e-5`` (tests/test_kernels.py's
    tolerances)."""
    import jax
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.models import layers as jlayers

    q, k, v, dout = flash_inputs(case, seed=23)
    causal = case[-1]
    got = ops.flash_attention(t(q), t(k), t(v), causal=causal)
    jnp_flash = jlayers.flash_attention(q, k, v, causal=causal, q_chunk=8,
                                        k_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp_flash), **F32_TOL)
    pallas = flash_attention_pallas(q, k, v, causal=causal, block_q=8,
                                    block_k=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32_TOL)

    def jloss(q, k, v):
        out = jlayers.flash_attention(q, k, v, causal=causal, q_chunk=8,
                                      k_chunk=8)
        return (out * dout).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq_, tk_, tv_ = (t(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq_, tk_, tv_, causal=causal)
    grads = torch.autograd.grad(out, (tq_, tk_, tv_), t(dout))
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


# paged at every width: b, hq, hkv, d, page, n_pages_per_row
WIDE_PAGED = [
    pytest.param((2, 4, 2, 100, 8, 4), id="d100"),
    pytest.param((2, 4, 2, 320, 8, 4), id="d320"),
    pytest.param((2, 8, 1, 576, 8, 3), id="d576"),
    # paths of the wide kernel alone: a last box of 8 columns (D % 16 = 8),
    # a full tile of 16 query heads over 1, and two passes of 16
    pytest.param((2, 4, 2, 264, 8, 4), id="d264-tail-box"),
    pytest.param((2, 16, 1, 576, 8, 3), id="d576-g16"),
    pytest.param((2, 32, 1, 320, 8, 4), id="d320-g32-two-passes"),
]


@pytest.mark.parametrize("case", WIDE_PAGED)
def test_paged_plain_at_every_width_matches_jnp(case):
    """The plain paged versions (the kernels' plain versions at D 100, 320
    and 576, where the CUDA wrapper pads to a multiple of 8 and the source
    runs its boxed span kernel past 256) against the reference's jnp
    oracles: float32 and int8 pools at ``atol=3e-6, rtol=1e-5``; and the
    wrapper's zero padding (q and both pools to the next multiple of 8,
    the true width's scale) keeps the plain result in the kept columns."""
    q, k, v, table, lengths = make_pool(case, seed=24)
    got = ops.paged_attention(t(q), t(k), t(v), t(table), t(lengths))
    oracle = jpa.paged_attention(q, k, v, np.clip(table, 0, None), lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32_TOL)
    args = [np.asarray(x) for x in (*jpa.quantize_pages(k),
                                    *jpa.quantize_pages(v))]
    gotq = ops.paged_attention_quant(t(q), *map(t, args), t(table), t(lengths))
    oracleq = jpa.paged_attention_quant(q, *args, np.clip(table, 0, None),
                                        lengths)
    np.testing.assert_allclose(gotq.numpy(), np.asarray(oracleq), **F32_TOL)
    d = case[3]
    kd = tpa.padded_dims(d, d)[0]
    assert kd % 8 == 0 and 0 <= kd - d < 8
    padded = tref.paged_attention(
        *(tpa._pad(t(x), kd) for x in (q, k, v)),
        t(np.clip(table, 0, None)), t(lengths), d ** -0.5)
    torch.testing.assert_close(padded[..., :d], got, atol=1e-6, rtol=1e-6)


def test_paged_route_rule_and_counts_by_route():
    """The paged wrappers' route by the padded width: "narrow" up to 256
    columns, "wide" past them (D 250 pads to 256, D 257 to 264), the rule
    the CUDA source's ``launch`` applies; each wrapper counts its launches
    by route in ``.by_route``, one key per route."""
    assert [tpa.route(d) for d in (8, 96, 250, 256, 257, 264, 576)] == [
        "narrow"] * 4 + ["wide"] * 3
    assert tpa.ROUTES == ("narrow", "wide")
    for fn in (tpa.paged_attention, tpa.paged_attention_quant):
        assert set(fn.by_route) == set(tpa.ROUTES)
        assert all(isinstance(n, int) for n in fn.by_route.values())
    src = (Path(tpa.__file__).parent / "csrc" / "paged_attention.cu").read_text()
    assert f"if (a.d > {tpa.WIDE_ABOVE}) return launch_wide" in src


def test_paged_wide_call_reaches_the_cuda_only_refusal():
    """No width is refused by the paged wrappers' shape checks: D 100 and
    576 reach the device check (a CPU tensor)."""
    for d in (100, 576):
        q, k, v, table, lengths = make_pool((2, 2, 1, d, 4, 2), seed=25)
        with pytest.raises(ValueError, match="CUDA"):
            tpa.paged_attention(t(q), t(k), t(v), t(table), t(lengths))


# the prefix-LM mask: (b, tq, tk, hq, hkv, d) and the prefix lengths held;
# "tk" and "past-tk" stand for Tk and Tk + 5
PREFIX_SHAPES = [
    pytest.param((2, 16, 16, 4, 2, 8), id="tq-eq-tk"),
    pytest.param((1, 10, 16, 4, 1, 8), id="tq-under-tk"),
]
PREFIX_LENS = [0, 1, 7, "tk", "past-tk"]


def _prefix_len(p, tk):
    return {"tk": tk, "past-tk": tk + 5}.get(p, p)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("prefix", PREFIX_LENS)
@pytest.mark.parametrize("shape", PREFIX_SHAPES)
def test_flash_plain_prefix_lm_matches_jnp_and_jax_grad(shape, prefix, causal):
    """The plain version (the kernels' plain version) with ``prefix_len``
    against the reference's jnp ``layers.flash_attention`` -- the model
    path's prefix-LM mask, never its Pallas dispatch, which drops it --
    and its gradients against ``jax.grad``; float32 at ``F32_TOL`` for the
    output and ``atol=rtol=1e-5`` for the gradients (O(1) values summed
    in different orders).  Without ``causal`` the prefix changes nothing."""
    import jax
    from repro.models import layers as jlayers

    q, k, v, dout = flash_inputs(shape + (causal,), seed=21)
    pl = _prefix_len(prefix, shape[2])

    def jout(q, k, v):
        return jlayers.flash_attention(q, k, v, causal=causal, prefix_len=pl,
                                       q_chunk=8, k_chunk=8)

    want = jout(q, k, v)
    tq_, tk_, tv_ = (t(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq_, tk_, tv_, causal=causal, prefix_len=pl)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32_TOL)
    if not causal:
        bare = ops.flash_attention(t(q), t(k), t(v), causal=False)
        assert torch.equal(out.detach(), bare)
    got = torch.autograd.grad(out, (tq_, tk_, tv_), t(dout))
    grads = jax.grad(lambda *a: (jout(*a) * dout).sum(), argnums=(0, 1, 2))(
        q, k, v)
    for g, w in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_flash_plain_prefix_past_tk_is_non_causal():
    """A prefix that covers every key leaves nothing causal: the same
    output as the non-causal call."""
    q, k, v, _ = flash_inputs((1, 10, 16, 4, 1, 8, True), seed=22)
    full = ops.flash_attention(t(q), t(k), t(v), causal=False)
    for pl in (16, 21):
        got = ops.flash_attention(t(q), t(k), t(v), prefix_len=pl)
        np.testing.assert_allclose(got.numpy(), full.numpy(), **F32_TOL)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefix_call_reaches_the_cuda_only_refusal(dtype, which):
    """A kernel call with a prefix (f32 and bf16 at paligemma's head dim
    256, 8 query heads over 1, the reduced shape) gets past every check to
    the device check."""
    from repro_torch.kernels import flash_attention as tfa

    q, k, v, dout = (t(x).to(dtype) for x in flash_inputs(
        (1, 24, 24, 8, 1, 256, True), seed=23))
    lse = torch.zeros((1, 8, 24), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        if which == "fwd":
            tfa.flash_attention_fwd(q, k, v, prefix_len=8)
        else:
            tfa.flash_attention_bwd(q, k, v, q, lse, dout, prefix_len=8)


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
    # the prefix-LM mask is taken on both paths: a kernel-path call with a
    # prefix gets past every check to the CUDA-only refusal
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(t(q), t(k), t(v), prefix_len=4, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(t(q), t(k), t(v), prefix_len=4)
    with pytest.raises(ValueError, match="prefix_len=-1"):
        tfa.flash_attention_fwd(t(q), t(k), t(v), prefix_len=-1)
    # the plain version keeps the reference's prefix-LM mask
    plain = ops.flash_attention(t(q), t(k), t(v), prefix_len=4)
    assert torch.isfinite(plain).all()
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(t(q), t(k), t(v), use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(t(q), t(k), t(v))
    with pytest.raises(ValueError, match="CUDA"):
        txp.xor_reduce(torch.zeros((2, 1, 128), dtype=torch.int32))


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_flash_kernel_refuses_tq_over_tk_only_when_causal(which):
    """Tq > Tk has no causal offset, so only a causal call is refused for
    it; a non-causal one gets past the shape checks to the CUDA-only
    refusal (on the card it runs: chip_smoke.py phase 6)."""
    from repro_torch.kernels import flash_attention as tfa

    q, k, v, dout = (t(x) for x in flash_inputs((1, 32, 16, 2, 2, 8, False),
                                                 seed=16))
    lse = torch.zeros((1, 2, 32), dtype=torch.float32)
    call = ((lambda causal: tfa.flash_attention_fwd(q, k, v, causal))
            if which == "fwd" else
            (lambda causal: tfa.flash_attention_bwd(q, k, v, q, lse, dout,
                                                    causal)))
    with pytest.raises(ValueError, match=r"Tq=32 > Tk=16"):
        call(True)
    with pytest.raises(ValueError, match="CUDA"):
        call(False)


@pytest.mark.parametrize("d", [72, 192])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_flash_bf16_route_refuses_other_head_dims_before_launch(which, d):
    """The bfloat16 (tensor-core) kernels are instantiated for head dims 64,
    80, 96, 128 and 256; any other width runs at the next one (72 at 80,
    192 at 256: the CUDA source picks it, which the card-only
    ``test_cuda_flash_bf16_runs_a_pair_at_the_smallest_instantiation``
    holds), so the call gets past every shape check to the device check
    before any launch, unpadded (both widths are multiples of 8)."""
    from repro_torch.kernels import flash_attention as tfa

    assert tfa.padded_dims(d, d) == (d, d)
    q, k, v, dout = (t(x).to(torch.bfloat16)
                     for x in flash_inputs((1, 16, 16, 2, 2, d, True), seed=15))
    with pytest.raises(ValueError, match="CUDA"):
        if which == "fwd":
            tfa.flash_attention_fwd(q, k, v)
        else:
            lse = torch.zeros((1, 2, 16), dtype=torch.float32)
            tfa.flash_attention_bwd(q, k, v, q, lse, dout)


@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
def test_flash_bf16_route_takes_its_head_dims_on_cuda_only(d):
    """Forward and backward calls (with and without a prefix) at every
    instantiated head dim get past the shape checks to the device check."""
    from repro_torch.kernels import flash_attention as tfa

    q, k, v, dout = (t(x).to(torch.bfloat16)
                     for x in flash_inputs((1, 16, 16, 2, 2, d, True), seed=16))
    lse = torch.zeros((1, 2, 16), dtype=torch.float32)
    for prefix_len in (0, 5):
        with pytest.raises(ValueError, match="CUDA"):
            tfa.flash_attention_fwd(q, k, v, prefix_len=prefix_len)
        with pytest.raises(ValueError, match="CUDA"):
            tfa.flash_attention_bwd(q, k, v, q, lse, dout,
                                    prefix_len=prefix_len)


@pytest.mark.parametrize("dtype,d,dv", [(torch.bfloat16, 96, 64),
                                        (torch.float32, 96, 64),
                                        (torch.float32, 40, 136)])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_flash_dv_call_reaches_the_cuda_only_refusal(which, dtype, d, dv):
    """A V narrower or wider than Q and K is taken natively (bf16: the
    instantiated (96, 64) pair; f32: any multiple of 8 up to 256): the
    call gets past every shape check to the device check, with dO and O
    of V's width."""
    from repro_torch.kernels import flash_attention as tfa

    q, k, v, dout = (t(x).to(dtype) for x in flash_inputs(
        (1, 16, 16, 4, 2, d, dv, True), seed=18))
    with pytest.raises(ValueError, match="CUDA"):
        if which == "fwd":
            tfa.flash_attention_fwd(q, k, v)
        else:
            lse = torch.zeros((1, 4, 16), dtype=torch.float32)
            tfa.flash_attention_bwd(q, k, v, dout, lse, dout)


def test_flash_refuses_dv_pairs_and_shapes_it_has_no_kernel_for():
    """A bf16 pair without an instantiation of its own, (96, 32), runs at
    the next one, and a width that is not a multiple of 8 at the next
    multiple: both reach the device check.  So do widths above 256 (the
    wide kernels: bf16 on the tensor cores at the padded widths themselves,
    f32 on the CUDA cores), 264 and absorbed MLA's (576, 512), and a width
    below 1 is refused by name; V must share K's batch, length and heads;
    dO and O must be V's width."""
    from repro_torch.kernels import flash_attention as tfa

    q, k, v, dout = (t(x).to(torch.bfloat16) for x in flash_inputs(
        (1, 16, 16, 2, 2, 96, 32, True), seed=19))
    assert tfa.padded_dims(96, 32) == (96, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, k, v)
    q, k, v, dout = (t(x) for x in flash_inputs(
        (1, 16, 16, 2, 2, 96, 64, True), seed=19))
    with pytest.raises(ValueError, match="Dv"):
        tfa.flash_attention_fwd(q, k, v[:, :8])
    assert tfa.padded_dims(96, 12) == (96, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, k, v[..., :12])
    wide = torch.zeros((1, 16, 2, 264))
    assert tfa.is_wide(264, 64) and not tfa.is_wide(256, 256)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(wide, wide, v)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, k, wide)
    mla = torch.zeros((1, 16, 2, 576))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(mla, mla, torch.zeros((1, 16, 2, 512)))
    assert tfa.bf16_kernel_dims(576, 512) == (576, 512)
    assert tfa.bf16_kernel_dims(300, 20) == (304, 24)
    assert tfa.route(torch.bfloat16, 576, 512) == "bf16_wide"
    assert tfa.route(torch.float32, 576, 512) == "f32_wide"
    with pytest.raises(ValueError, match="v head dim 0 must be >= 1"):
        tfa.flash_attention_fwd(q, k, v[..., :0])
    lse = torch.zeros((1, 2, 16), dtype=torch.float32)
    with pytest.raises(ValueError, match=r"shape \(1, 16, 2, 64\)"):
        tfa.flash_attention_bwd(q, k, v, q, lse, dout)


@pytest.mark.parametrize("d,dv", [(72, 72), (112, 112), (160, 160),
                                  (100, 100), (96, 32), (20, 44),
                                  (264, 264), (300, 300), (320, 320),
                                  (512, 512), (576, 512), (264, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_new_widths_reach_the_cuda_only_refusal(d, dv, dtype):
    """Every head width gets past the shape checks, forward and backward,
    to the device check; the wrappers hand the kernels :func:`padded_dims`
    (the next multiple of 8, fewer than 8 columns more), the bf16 route
    runs those at the smallest instantiated pair that holds them, and past
    256 (either width) each dtype runs its wide kernels: bf16 the
    tensor-core ones, f32 the CUDA-core ones."""
    from repro_torch.kernels import flash_attention as tfa

    q, k, v, dout = (t(x).to(dtype) for x in flash_inputs(
        (1, 16, 16, 4, 2, d, dv, True), seed=21))
    kd, kdv = tfa.padded_dims(d, dv)
    assert 0 <= kd - d < 8 and 0 <= kdv - dv < 8 and kd % 8 == kdv % 8 == 0
    cores = "bf16" if dtype == torch.bfloat16 else "f32"
    assert tfa.route(dtype, d, dv) == (
        cores + "_wide" if max(kd, kdv) > tfa.WIDE_ABOVE else cores)
    lse = torch.zeros((1, 4, 16), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd(q, k, v, dout, lse, dout)


@pytest.mark.parametrize("dtype,d,dv,want", [
    (torch.bfloat16, 96, 64, "bf16"), (torch.bfloat16, 250, 250, "bf16"),
    (torch.bfloat16, 256, 256, "bf16"), (torch.bfloat16, 257, 64, "bf16_wide"),
    (torch.bfloat16, 264, 264, "bf16_wide"), (torch.bfloat16, 40, 296, "bf16_wide"),
    (torch.bfloat16, 576, 512, "bf16_wide"), (torch.float32, 1, 1, "f32"),
    (torch.float32, 256, 200, "f32"), (torch.float32, 264, 8, "f32_wide"),
    (torch.float32, 576, 512, "f32_wide")])
def test_flash_route_rule_by_dtype_and_width(dtype, d, dv, want):
    """The wrappers' static rule: the dtype picks the cores (bf16 the
    tensor cores; f32 the CUDA cores, exact, where tensor cores would round
    to TF32) and a padded width past ``WIDE_ABOVE`` (either of D and Dv)
    the wide kernels.  Each route's three kernels are ``__global__``
    functions of the CUDA source, and a dtype neither route takes is
    refused."""
    import re
    from pathlib import Path

    from repro_torch.kernels import flash_attention as tfa

    assert tfa.route(dtype, d, dv) == want
    assert set(tfa.ROUTE_KERNELS) == set(tfa.ROUTE_CODES)
    source = (Path(tfa.__file__).parent / "csrc" / "flash_attention.cu").read_text()
    for name in tfa.ROUTE_KERNELS[want]:
        assert re.search(rf"\n{name}\(", source), name
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.route(torch.float16, d, dv)


def _c_signatures(name: str) -> dict:
    """Each ``extern "C"`` entry point of ``csrc/<name>.cu``: its return
    type and its parameters' C types, mapped to ctypes."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    out = {}
    for m in re.finditer(r'extern "C" ([\w ]+?) (repro_\w+)\(([^)]*)\)', text):
        params = [p.strip() for p in m.group(3).split(",") if p.strip()]
        out[m.group(2)] = (kinds[m.group(1)], [
            ctypes.c_void_p if "*" in p else kinds[p.rsplit(" ", 1)[0]]
            for p in params])
    return out


@pytest.mark.parametrize("lib,fn", [
    (lib, fn) for lib, fns in _build.SIGNATURES.items() for fn in fns])
def test_kernel_library_signatures_match_their_sources(lib, fn):
    """The ctypes signatures the loader sets (``_build.SIGNATURES``, and
    ``RESTYPES`` where an entry point returns no C int) are the CUDA
    sources' own, parameter for parameter: a mismatch would pass garbage
    to a launch on the card, with no error here."""
    from repro_torch.kernels import _build

    declared = _c_signatures(lib)
    assert fn in declared, f"{fn} is not an extern \"C\" entry point of {lib}.cu"
    restype, argtypes = declared[fn]
    assert _build.RESTYPES.get(fn, ctypes.c_int) is restype
    assert _build.SIGNATURES[lib][fn] == argtypes


def test_flash_padding_keeps_the_plain_result():
    """Zero columns past the true widths, as the bf16 kernels' boxes read
    them past a head narrower than its instantiation (and as the wrapper
    pads a width that is not a multiple of 8): Q, K and V zero-padded to
    the kernel's widths, the softmax scale the true width's, give the true
    result in the kept columns (the plain version stands in for the
    kernel): at the wrapper's padded widths and at (128, 128), where the
    bf16 route runs (100, 36)."""
    from repro_torch.kernels import flash_attention as tfa

    q, k, v, _ = (t(x) for x in flash_inputs((2, 24, 24, 4, 2, 100, 36,
                                              True), seed=22))
    want = tref.flash_attention(q, k, v, causal=True)
    for kd, kdv in (tfa.padded_dims(100, 36), (128, 128)):
        padded = tref.flash_attention(tfa._pad(q, kd), tfa._pad(k, kd),
                                      tfa._pad(v, kdv), causal=True,
                                      scale=100 ** -0.5)
        assert padded.shape[-1] == kdv
        torch.testing.assert_close(tfa._unpad(padded, 36), want, atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.cuda
def test_cuda_flash_bf16_runs_a_pair_at_the_smallest_instantiation():
    """The CUDA source's picker (``with_head_dims``, read through
    ``bf16_kernel_dims``): every pair of widths up to 256 runs at the
    smallest pair of ``BF16_PAIRS`` that holds its padded widths, by D +
    Dv, then D; an instantiated pair runs at itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the picker lives in the built library")
    from repro_torch.kernels import flash_attention as tfa

    for d in range(4, 257, 12):
        for dv in (8, 32, 36, 64, 72, 96, 100, 128, 200, 256):
            d8, dv8 = tfa.padded_dims(d, dv)
            want = min((p for p in tfa.BF16_PAIRS
                        if p[0] >= d8 and p[1] >= dv8),
                       key=lambda p: (p[0] + p[1], p[0]))
            assert tfa.bf16_kernel_dims(d, dv) == want, (d, dv)
    for pair in tfa.BF16_PAIRS:
        assert tfa.bf16_kernel_dims(*pair) == pair
    assert {(72, 72): (80, 80), (96, 32): (96, 64), (192, 192): (256, 256),
            (100, 36): (128, 128)} == {
        p: tfa.bf16_kernel_dims(*p) for p in
        ((72, 72), (96, 32), (192, 192), (100, 36))}


@pytest.mark.cuda
def test_cuda_flash_and_xor_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    # float32 (CUDA-core route) and bfloat16 (tensor-core route), phi3's
    # head dim 96, starcoder2's 128 over GQA with Tq < Tk, zamba2's 80
    for case, dtype in (((2, 200, 200, 32, 32, 96, True), torch.float32),
                        ((1, 100, 300, 36, 4, 128, True), torch.float32),
                        ((2, 200, 200, 32, 32, 80, True), torch.float32),
                        ((2, 200, 200, 32, 32, 96, True), torch.bfloat16),
                        ((2, 200, 200, 32, 32, 80, True), torch.bfloat16)):
        q, k, v, dout = (t(x).to(dev, dtype)
                         for x in flash_inputs(case, seed=14))
        grads = []
        for use_kernel in (None, False):
            qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
            out = ops.flash_attention(qs, ks, vs, use_kernel=use_kernel)
            grads.append((out,) + torch.autograd.grad(out, (qs, ks, vs), dout))
        if dtype == torch.bfloat16:   # chip_smoke.py's FLASH_BF16_TOL
            for g, w in zip(grads[0], grads[1]):
                torch.testing.assert_close(g, w, atol=3e-2, rtol=3e-2)
            continue
        torch.testing.assert_close(grads[0][0], grads[1][0], **F32_TOL)
        # gradients sum up to g * T products: chip_smoke.py's FLASH_BWD_F32_TOL
        for g, w in zip(grads[0][1:], grads[1][1:]):
            torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-5)
    x = torch.randint(-2**31, 2**31 - 1, (4, 1001, 128), dtype=torch.int32,
                      device=dev)
    assert torch.equal(ops.xor_reduce(x), ops.xor_reduce(x, use_kernel=False))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_dv_kernels_match_plain_on_card(dtype):
    """The kernels with V of its own width (minicpm3's (96, 64) heads, GQA,
    ragged and Tq != Tk non-causal) against the plain version, at
    chip_smoke.py's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for case in ((2, 200, 200, 40, 40, 96, 64, True),
                 (2, 100, 77, 8, 2, 96, 64, False)):
        q, k, v, dout = (t(x).to(dev, dtype)
                         for x in flash_inputs(case, seed=20))
        grads = []
        for use_kernel in (None, False):
            qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
            out = ops.flash_attention(qs, ks, vs, causal=case[-1],
                                      use_kernel=use_kernel)
            grads.append((out,) + torch.autograd.grad(out, (qs, ks, vs), dout))
        assert grads[0][0].shape == (*q.shape[:3], 64)
        tols = ([dict(atol=3e-2, rtol=3e-2)] * 4 if dtype == torch.bfloat16
                else [F32_TOL] + [dict(atol=2e-5, rtol=1e-5)] * 3)
        for g, w, tol in zip(grads[0], grads[1], tols):
            torch.testing.assert_close(g, w, **tol)
