"""On the card: the flash kernels with the prefix-LM mask and at head dim
256 (paligemma's MQA heads) against their plain version.

This file imports no JAX: its one test runs only where a CUDA card is,
and skips elsewhere.  Run it there with ``python -m pytest -m cuda
tests/test_torch_flash_prefix_cuda.py``.  Tolerances are
``chip_smoke.py``'s: float32 outputs ``atol=3e-6, rtol=1e-5`` and
gradients ``atol=2e-5, rtol=1e-5`` (sums of up to g * T products in two
orders), bfloat16 ``atol=rtol=3e-2``.
"""

import pytest
import torch

from repro_torch.kernels import ops

# b, tq, tk, hq, hkv, d, prefix_len, causal
CASES = [
    (2, 512, 512, 8, 1, 256, 256, True),     # paligemma: 256 patches + 256 text
    (2, 200, 200, 8, 1, 256, 77, True),      # ragged, a tile across the prefix
    (2, 77, 300, 8, 2, 96, 150, True),       # Tq < Tk with a prefix
    (2, 200, 200, 8, 2, 96, 77, True),
    (2, 100, 77, 8, 2, 256, 0, False),       # non-causal Tq > Tk at D 256
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_prefix_and_d256_kernels_match_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, tq, tk, hq, hkv, d, prefix_len, causal in CASES:
        q, k, v, dout = (torch.randn(*shape, generator=gen, device="cuda")
                         .to(dtype) for shape in ((b, tq, hq, d), (b, tk, hkv, d),
                                                  (b, tk, hkv, d), (b, tq, hq, d)))
        got = []
        for use_kernel in (None, False):
            qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
            out = ops.flash_attention(qs, ks, vs, causal=causal,
                                      prefix_len=prefix_len,
                                      use_kernel=use_kernel)
            got.append((out,) + torch.autograd.grad(out, (qs, ks, vs), dout))
        tols = ([dict(atol=3e-2, rtol=3e-2)] * 4 if dtype == torch.bfloat16
                else [dict(atol=3e-6, rtol=1e-5)] + [dict(atol=2e-5, rtol=1e-5)] * 3)
        for g, w, tol in zip(got[0], got[1], tols):
            torch.testing.assert_close(g, w, **tol)
