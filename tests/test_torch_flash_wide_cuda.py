"""On the card: the bfloat16 flash kernels past 256 columns (the wide
tensor-core kernels, ``route`` "bf16_wide") against their plain version.

This file imports no JAX: its tests run only where a CUDA card is, and
skip elsewhere.  Run them there with ``python -m pytest -m cuda
tests/test_torch_flash_wide_cuda.py``.  The shapes are
``tests/test_torch_kernels.py``'s ``WIDE_CASES`` (whose plain version is
held against the reference there), each with and without a prefix;
forward, dQ, dK and dV are held against the plain version at
``chip_smoke.py``'s ``FLASH_BF16_TOL`` (``atol=rtol=3e-2``: p and dS are
rounded to bf16 where they enter a product, and the outputs to bf16).
"""

import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa

# b, tq, tk, hq, hkv, d, dv, causal: test_torch_kernels.py's WIDE_CASES,
# D 832 (13 boxes of D, four slices of dQ and dK), and a grid large enough
# (512 blocks of 256-column slices) for the forward's 512-column slices
WIDE_CASES = {
    "wide-264": (1, 16, 16, 2, 1, 264, 264, True),
    "wide-300-full": (1, 12, 20, 2, 2, 300, 300, False),
    "wide-576-512": (1, 16, 16, 4, 2, 576, 512, True),
    "wide-320-dv100": (1, 9, 9, 2, 2, 320, 100, True),
    "wide-832": (1, 80, 80, 4, 1, 832, 64, True),
    "wide-576-512-large-grid": (2, 256, 256, 32, 8, 576, 512, True),
}
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _grads(q, k, v, dout, causal, prefix_len, use_kernel):
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(qs, ks, vs, causal=causal, prefix_len=prefix_len,
                              use_kernel=use_kernel)
    return (out.detach(),) + torch.autograd.grad(out, (qs, ks, vs), dout)


@pytest.mark.cuda
@pytest.mark.parametrize("prefix_len", [0, 5])
@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_cuda_flash_wide_bf16_matches_plain_bit_identically(case, prefix_len):
    dev = _card()
    b, tq, tk, hq, hkv, d, dv, causal = WIDE_CASES[case]
    assert fa.route(torch.bfloat16, d, dv) == "bf16_wide"
    gen = torch.Generator(device=dev).manual_seed(24)
    q, k, v, dout = (torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)
                     for s in ((b, tq, hq, d), (b, tk, hkv, d), (b, tk, hkv, dv),
                               (b, tq, hq, dv)))
    fwd, bwd = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    wide = (fa.flash_attention_fwd.by_route["bf16_wide"],
            fa.flash_attention_bwd.by_route["bf16_wide"])
    got = _grads(q, k, v, dout, causal, prefix_len, None)
    again = _grads(q, k, v, dout, causal, prefix_len, None)
    # delta, dQ, dK/dV and, where the dK/dV blocks split the query heads,
    # the sum of their partials: twice
    split = _build.library("flash_attention").repro_flash_bwd_workspace(
        1, b, tk, hq, hkv, *fa.padded_dims(d, dv)) > 0
    assert fa.flash_attention_fwd.launches == fwd + 2
    assert fa.flash_attention_bwd.launches == bwd + 2 * (3 + split)
    assert (fa.flash_attention_fwd.by_route["bf16_wide"],
            fa.flash_attention_bwd.by_route["bf16_wide"]) == (
                wide[0] + 2, wide[1] + 2 * (3 + split))
    want = _grads(q, k, v, dout, causal, prefix_len, False)
    assert got[0].shape == (b, tq, hq, dv)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BF16_TOL)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_cuda_flash_library_follows_the_route_rule():
    """The CUDA launchers' rule (``repro_flash_route``) is the wrapper's
    :func:`route` at every padded width from 8 to 1024, both dtypes; past
    256 the bf16 route reports the true widths, one shared-memory size for
    the backward's kernels and another for the forward where V is past
    256 (its 512-column slices), all within the 227 KB a block may take."""
    _card()
    lib = _build.library("flash_attention")
    for d in range(8, 1025, 8):
        for dv in (8, 64, 256, 264, 512, d):
            for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
                assert lib.repro_flash_route(code, d, dv) == fa.ROUTE_CODES[
                    fa.route(dtype, d, dv)], (dtype, d, dv)
            if fa.is_wide(d, dv):
                assert fa.bf16_kernel_dims(d, dv) == (d, dv)
                assert lib.repro_flash_bf16_dims(d, dv) == d * 65536 + dv
                fwd, dq, dkdv = (lib.repro_flash_bf16_smem(k, d, dv) for k in range(3))
                assert dq == dkdv and 0 < max(fwd, dq) <= 232448
                assert (fwd == dq) == (dv <= 256), (d, dv)
    assert lib.repro_flash_route(2, 64, 64) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [
    ((2, 256, 8, 2, 576, 512), 4),          # phase 10's wide shape: the whole group
    ((1, 1024, 16, 1, 576, 512), 8),        # absorbed MLA's MQA prefill
    ((1, 16, 32768, 16384, 512, 512), 1),   # 65,536 blocks already
    ((2, 256, 8, 8, 320, 320), 1),          # no group to split
    ((4, 4096, 8, 1, 264, 264), 1),         # 1,024 blocks already
    ((1, 512, 12, 2, 264, 264), 6)])        # 6 x 64 blocks: still short, the whole group
def test_cuda_flash_wide_kv_group_split(shape, groups):
    """The bf16 wide dK/dV kernel's split of each kv head's query heads,
    as the CUDA source sizes its workspace (``repro_flash_bwd_workspace``):
    the smallest divisor of the group size that brings the grid (64-key
    tiles x kv heads x 256-column slices of D and Dv x batch) to four
    waves of 132 SMs, or the whole group; no workspace without a split or
    off the bf16 wide route."""
    _card()
    lib = _build.library("flash_attention")
    b, tk, hq, hkv, d, dv = shape
    got = lib.repro_flash_bwd_workspace(1, b, tk, hq, hkv, d, dv)
    assert got == (0 if groups == 1 else 4 * groups * b * tk * hkv * (d + dv))
    assert lib.repro_flash_bwd_workspace(0, b, tk, hq, hkv, d, dv) == 0
    assert lib.repro_flash_bwd_workspace(1, b, tk, hq, hkv, 256, 256) == 0
    assert lib.repro_flash_bwd_workspace(1, b, tk, hq, hq + 1, d, dv) == -1
