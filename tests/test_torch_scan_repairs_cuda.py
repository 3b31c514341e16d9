"""On the card: the scan kernels' gradient through the final state, the
scans past 64, and flash at head widths with no instantiation of their
own, each against its plain version and twice bit-identical.

This file imports no JAX: its tests run only where a CUDA card is, and
skip elsewhere.  Run them there with ``python -m pytest -m cuda
tests/test_torch_scan_repairs_cuda.py``.  Tolerances are
``chip_smoke.py``'s: the scans' float32 outputs ``atol=5e-5, rtol=1e-4``
and gradients within 1e-4 of their largest magnitude; flash float32
outputs ``atol=3e-6, rtol=1e-5`` and gradients ``atol=2e-5, rtol=1e-5``;
bfloat16 ``atol=rtol=3e-2``.
"""

import pytest
import torch

from repro_torch.kernels import ops

SCANS = [("wkv6", (2, 77, 2, 64)), ("wkv6", (1, 77, 2, 128)),
         ("ssd", (2, 77, 3, 64, 64)), ("ssd", (1, 77, 2, 64, 128)),
         ("ssd", (1, 77, 2, 128, 64))]
FLASH = [(72, 72), (112, 112), (160, 160), (100, 100), (96, 32)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _scan_inputs(kind, shape, dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    mk = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device=dev) * scale
    if kind == "wkv6":
        b, t, h, d = shape
        ins = [mk(b, t, h, d, scale=.5).to(dtype), mk(b, t, h, d, scale=.5).to(dtype),
               mk(b, t, h, d).to(dtype),
               torch.exp(-torch.exp(mk(b, t, h, d, scale=2.).clamp(-8., 1.))),
               mk(h, d, scale=.1), mk(b, h, d, d, scale=.5)]
        return ins, mk(b, t, h, d).to(dtype), mk(b, h, d, d)
    b, t, h, p, n = shape
    ins = [mk(b, t, h, p).to(dtype), torch.nn.functional.softplus(mk(b, t, h)),
           -torch.exp(torch.rand(h, generator=gen, device=dev)),
           mk(b, t, n, scale=.5).to(dtype), mk(b, t, n, scale=.5).to(dtype),
           mk(b, h, p, n, scale=.5)]
    return ins, mk(b, t, h, p).to(dtype), mk(b, h, p, n)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", SCANS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_scan_final_state_grad_and_wide_heads_match_plain(kind, shape,
                                                               dtype):
    dev = _card()
    fn = ops.wkv6 if kind == "wkv6" else ops.mamba2_ssd
    ins, dy, ds = _scan_inputs(kind, shape, dtype, dev)
    got = []
    for use_kernel in (None, False, None):
        leaves = [x.clone().requires_grad_() for x in ins]
        y, s = fn(*leaves, use_kernel=use_kernel)
        got.append((y, s) + torch.autograd.grad((y, s), leaves, (dy, ds)))
    assert all(torch.equal(a, b) for a, b in zip(got[0], got[2]))
    f32 = dtype == torch.float32
    tol = dict(atol=5e-5, rtol=1e-4) if f32 else dict(atol=3e-2, rtol=3e-2)
    for g, w in zip(got[0][:2], got[1][:2]):
        torch.testing.assert_close(g.float(), w.float(), **tol)
    rel = 1e-4 if f32 else 3e-2
    for g, w in zip(got[0][2:], got[1][2:]):
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", FLASH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_new_widths_match_plain(d, dv, dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v, dout = (torch.randn(*s, generator=gen, device=dev).to(dtype)
                     for s in ((2, 200, 8, d), (2, 200, 2, d), (2, 200, 2, dv),
                               (2, 200, 8, dv)))
    got = []
    for use_kernel in (None, False, None):
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
        out = ops.flash_attention(qs, ks, vs, use_kernel=use_kernel)
        got.append((out,) + torch.autograd.grad(out, (qs, ks, vs), dout))
    assert all(torch.equal(a, b) for a, b in zip(got[0], got[2]))
    tols = ([dict(atol=3e-2, rtol=3e-2)] * 4 if dtype == torch.bfloat16
            else [dict(atol=3e-6, rtol=1e-5)] + [dict(atol=2e-5, rtol=1e-5)] * 3)
    for g, w, tol in zip(got[0], got[1], tols):
        torch.testing.assert_close(g, w, **tol)
