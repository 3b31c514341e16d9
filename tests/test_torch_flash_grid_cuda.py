"""On the card: flash attention past the 65,535 limit of grid dimensions
y and z, forward and backward, against the plain version.

Every flash launcher folds its blocks (row tiles, heads or column slices,
batch) into grid x, so a batch of 65,600 sequences and a wide call with
65,536 column slices of heads run as the reference's flash takes them.
The cases: B 65,600 x T 16 x 1 head of D 64 (float32 on the CUDA cores,
bfloat16 on the tensor cores), and Hq 32,768 over Hkv 16,384 at (D, Dv)
= (512, 512), B 1 x T 16 (the wide kernels: 2 slices of 256 columns a
head, so 65,536 forward and 65,536 dK/dV slice blocks).  bfloat16 is held
against the plain version at ``atol=rtol=3e-2``; float32, as
``chip_smoke.py`` holds the f32 route, against a float64 run: the
kernel's output and gradients no farther from it than the plain
version's, or 1e-5 (over 2^28 outputs of 512-term sums the plain
version's own rounding passes phase 6's ``atol=3e-6``).

This file imports no JAX; its tests skip where there is no CUDA card.
Run them there with ``python -m pytest -m cuda
tests/test_torch_flash_grid_cuda.py``.
"""

import pytest
import torch

from repro_torch.kernels import ops

CASES = {   # name -> (b, t, hq, hkv, d, dv)
    "batch_65600": (65600, 16, 1, 1, 64, 64),
    "wide_65536_slices": (1, 16, 32768, 16384, 512, 512),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_past_the_grid_limit_matches_plain(case, dtype):
    dev = _card()
    b, t, hq, hkv, d, dv = CASES[case]
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v, dout = (torch.randn(*s, generator=gen, device=dev).to(dtype)
                     for s in ((b, t, hq, d), (b, t, hkv, d), (b, t, hkv, dv),
                               (b, t, hq, dv)))
    runs = [(None, dtype), (False, dtype)]
    if dtype == torch.float32:
        runs.append((False, torch.float64))
    got = []
    for use_kernel, as_dtype in runs:
        qs, ks, vs = (x.detach().to(as_dtype).requires_grad_()
                      for x in (q, k, v))
        out = ops.flash_attention(qs, ks, vs, use_kernel=use_kernel)
        got.append((out,) + torch.autograd.grad(out, (qs, ks, vs),
                                                dout.to(as_dtype)))
        del qs, ks, vs, out
    if dtype == torch.bfloat16:
        for g, w in zip(got[0], got[1]):
            torch.testing.assert_close(g, w, atol=3e-2, rtol=3e-2)
        return
    for g, w, e in zip(*got):
        kern = (g.double() - e).abs().max().item()
        plain = (w.double() - e).abs().max().item()
        assert kern <= max(plain, 1e-5), (kern, plain)
