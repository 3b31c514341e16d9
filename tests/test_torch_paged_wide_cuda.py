"""On the card: the paged-attention kernels past 256 columns (the wide
route, ``paged_wide_kernel``) against their plain version.

This file imports no JAX: its tests run only where a CUDA card is, and
skip elsewhere.  Run them there with ``python -m pytest -m cuda
tests/test_torch_paged_wide_cuda.py``.  The shapes are
``tests/test_torch_kernels.py``'s wide cases whose paths only the wide
kernel has (D 264: a last box of 8 columns; D 576 with 16 query heads over
1: a full tensor-core tile; D 320 with 32 over 1: two passes of 16), here
with spans enough for the combine, two widths at which the source
recycles its ring's stages (D 640, D 1,088), and ``chip_smoke.py``'s four
wide timed shapes.  Both kernels (bf16 and int8 pools) and their multi-token folds
are held against the plain version at ``chip_smoke.py``'s tolerances:
float32 ``atol=3e-6, rtol=1e-5`` (sums in another order), bfloat16
``2e-2`` (p rounded to bf16 where it enters p V, the output rounded to
bf16).
"""

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa

# b, hq, hkv, d, page, nP, lengths
WIDE_CASES = {
    "d264": (3, 4, 2, 264, 16, 9, [130, 64, 1]),
    "d576-g16": (2, 16, 1, 576, 16, 8, [128, 77]),
    "d320-g32": (3, 32, 1, 320, 16, 8, [100, 128, 33]),
    # stages recycled: bf16 pools past D 576, int8 past D 1,024
    "d640-ring": (2, 8, 1, 640, 16, 8, [128, 70]),
    "d1088-ring": (2, 2, 1, 1088, 16, 5, [80, 33]),
    "wide_320": (4, 8, 2, 320, 16, 16, [1, 63, 130, 256]),
    "wide_576": (4, 16, 1, 576, 16, 16, [1, 63, 130, 256]),
    "wide_320_long": (4, 8, 2, 320, 16, 256, [4096, 3001, 1024, 200]),
    "wide_576_long": (4, 16, 1, 576, 16, 256, [4096, 3001, 1024, 200]),
}
TOL = {torch.float32: dict(atol=3e-6, rtol=1e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(name, dtype, dev):
    """A pool and a batch: rows share row 0's first page, entries past a
    row's pages are -1 (clamped to page 0), q, K and V from a seed."""
    b, hq, hkv, d, page, n_p, lens = WIDE_CASES[name]
    gen = torch.Generator(device=dev).manual_seed(25)
    n = 1 + b * n_p
    q = torch.randn(b, hq, d, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(n, page, hkv, d, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    table = (1 + torch.arange(b * n_p, device=dev, dtype=torch.int32)).reshape(b, n_p)
    table[1:, 0] = table[0, 0]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    for r, ln in enumerate(lens):
        table[r, -(-ln // page):] = -1
    return q, k, v, table, lengths


def _calls(k, v):
    """Both kernels' calls (x, table, lengths) and their plain versions."""
    kq, ks = ref.quantize_pages(k)
    vq, vs = ref.quantize_pages(v)
    return {
        "paged_attention": (
            lambda x, t, ln: pa.paged_attention(x, k, v, t, ln),
            lambda x, t, ln: ops.paged_attention(x, k, v, t, ln, use_kernel=False)),
        "paged_attention_quant": (
            lambda x, t, ln: pa.paged_attention_quant(x, kq, ks, vq, vs, t, ln),
            lambda x, t, ln: ops.paged_attention_quant(x, kq, ks, vq, vs, t, ln,
                                                       use_kernel=False)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_cuda_paged_wide_matches_plain(name, dtype):
    """Both kernels and their multi-token folds (4 candidate rows a lane)
    against the plain version, each call counted on the wide route."""
    dev = _card()
    q, k, v, table, lengths = _case(name, dtype, dev)
    b, hq, d = q.shape
    assert pa.route(d) == "wide"
    gen = torch.Generator(device=dev).manual_seed(26)
    qm = torch.randn(b, 4, hq, d, generator=gen, device=dev).to(dtype)
    positions = ((lengths.clamp(min=4) - 4)[:, None]
                 + torch.arange(4, device=dev)[None]).to(torch.int32)
    for fn_name, (kernel, plain) in _calls(k, v).items():
        fn = getattr(pa, fn_name)
        before = (fn.launches, fn.by_route["wide"], fn.by_route["narrow"])
        got = kernel(q, table, lengths)
        torch.testing.assert_close(got, plain(q, table, lengths), **TOL[dtype])
        assert got.shape == q.shape and got.dtype == dtype
        rows, tables, lens = pa._fold(qm, table, positions)
        fold = kernel(rows, tables, lens)
        torch.testing.assert_close(fold, plain(rows, tables, lens), **TOL[dtype])
        assert (fn.launches, fn.by_route["wide"], fn.by_route["narrow"]) == (
            before[0] + 2, before[1] + 2, before[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_cuda_paged_wide_bits_fixed(name, dtype):
    """Two launches bit-identical; each row alone (B = 1) equal to its row
    in the batch; the fold's rows equal to single-row calls; rows of
    length 0 give zeros."""
    dev = _card()
    q, k, v, table, lengths = _case(name, dtype, dev)
    b, hq, d = q.shape
    gen = torch.Generator(device=dev).manual_seed(27)
    qm = torch.randn(b, 2, hq, d, generator=gen, device=dev).to(dtype)
    positions = ((lengths.clamp(min=2) - 2)[:, None]
                 + torch.arange(2, device=dev)[None]).to(torch.int32)
    for fn_name, (kernel, _) in _calls(k, v).items():
        full = kernel(q, table, lengths)
        assert torch.equal(full, kernel(q, table, lengths)), fn_name
        for r in range(b):
            alone = kernel(q[r:r + 1], table[r:r + 1], lengths[r:r + 1])
            assert torch.equal(alone[0], full[r]), (fn_name, r)
        fold = kernel(*pa._fold(qm, table, positions)).reshape(qm.shape)
        for r in range(b):
            for j in range(2):
                one = kernel(qm[r, j][None].contiguous(), table[r:r + 1],
                             positions[r, j:j + 1] + 1)
                assert torch.equal(one[0], fold[r, j]), (fn_name, r, j)
        zero = kernel(q, table, torch.zeros_like(lengths))
        assert zero.abs().max() == 0, fn_name
