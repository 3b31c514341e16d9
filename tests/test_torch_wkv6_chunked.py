"""The WKV6 kernels' chunk form (``kernels.ref.wkv6_chunked_form`` and its
hand-written backward ``wkv6_chunked_form_grads``) against the JAX
reference, and the Python arithmetic of the kernels' wrapper.

The CUDA kernels in ``csrc/wkv6.cu`` run only on the card; their
arithmetic (chunks of 64 tokens cut into sub-blocks of 16, the pairwise
decays re-centred per sub-block so that no factor exceeds 1 off the
diagonal, the diagonal sub-blocks factorised only where a channel's decay
over the sub-block stays above e^-60 and taken exactly elsewhere, the
per-token sums behind dw taken without cancelling two chunk totals) is
written plainly in ``kernels/ref.py`` so that it is held here, on the same
numpy inputs, against:

* forward: the reference's Pallas kernel in interpret mode (zero initial
  state: it asserts one), its chunked jnp version and its sequential
  oracle ``ref.rwkv6_ref``;
* backward: ``jax.grad`` of the reference's chunked version, and the
  port's own autograd through ``ops.wkv6_chunked``;
* below the model's decay clip (w down to 1e-20), where the reference's
  chunked version overflows: the sequential oracle and its ``jax.grad``.

Cases: the reference's WKV_CASES, plus T = 64 (one whole chunk), T = 65
(one token into a second) and T = 1, each with and without an initial
state.  Tolerances are ``tests/test_torch_rwkv6.py``'s, all float32:
outputs and states ``atol=5e-5, rtol=1e-4``, gradients ``atol=rtol=1e-4``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import wkv6_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as wkv
from test_torch_rwkv6 import SCAN_GRAD_TOL, SCAN_TOL, WKV_CASES, close, t, wkv_inputs

CASES = WKV_CASES + [(2, 64, 2, 16), (1, 65, 3, 8), (2, 1, 2, 16)]
GRAD_NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")
F64_REL = 1e-5   # chip_smoke.SCAN_F64_REL


def mirror(ins, dy):
    """The chunk form's forward and backward from numpy inputs."""
    r, k, v, w, u, s0 = map(t, ins)
    y, s, starts = tref.wkv6_chunked_form(r, k, v, w, u, s0)
    grads = tref.wkv6_chunked_form_grads(r, k, v, w, u, starts, t(dy))
    return y, s, starts, grads


def draw(case, seed, with_state):
    ins = wkv_inputs(case, seed=seed, with_state=with_state)
    dy = np.random.default_rng(seed + 100).standard_normal(case).astype(
        np.float32)
    return ins, dy


def jax_grads(fn, ins, dy):
    """jax.grad of sum(fn(...)[0] * dy) in r, k, v, w, u (and the state
    when one is given)."""
    args = tuple(range(6 if ins[5] is not None else 5))
    xs = ins if ins[5] is not None else ins[:5]
    return jax.grad(lambda *v: jnp.sum(fn(*v)[0] * dy), argnums=args)(*xs)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("case", CASES)
def test_chunk_form_forward_matches_reference(case, with_state):
    ins, dy = draw(case, seed=30, with_state=with_state)
    y, s, starts, _ = mirror(ins, dy)
    want = [("chunked", jops.wkv6_chunked(*ins, chunk=16, d_block=8)),
            ("ref", jref.rwkv6_ref(*ins))]
    if not with_state:
        want.append(("pallas", wkv6_pallas(*ins[:5], chunk=16, interpret=True)))
    for name, (wy, ws) in want:
        close(y, wy, SCAN_TOL, f"y vs {name}")
        close(s, ws, SCAN_TOL, f"state vs {name}")
    # the saved chunk-start states: one every 64 tokens, the first the
    # initial state
    b, T, h, d = case
    assert tuple(starts.shape) == (b, h, -(-T // wkv.CHUNK), d, d)
    s0 = np.zeros((b, h, d, d), np.float32) if ins[5] is None else ins[5]
    close(starts[:, :, 0], s0, SCAN_TOL, "first chunk-start state")


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("case", CASES)
def test_chunk_form_backward_matches_jax_grad_and_autograd(case, with_state):
    ins, dy = draw(case, seed=31, with_state=with_state)
    *_, grads = mirror(ins, dy)
    want = jax_grads(lambda *v: jops.wkv6_chunked(*v, chunk=16, d_block=8),
                     ins, dy)
    b, _, h, d = case
    leaves = [t(x).requires_grad_() for x in ins[:5]]
    leaves += [t(ins[5]).requires_grad_() if with_state
               else torch.zeros(b, h, d, d, requires_grad=True)]
    y, _ = ops.wkv6_chunked(*leaves, d_block=8)
    port = torch.autograd.grad(y, leaves, t(dy))
    for name, g, w, a in zip(GRAD_NAMES, grads, want + (None,), port):
        assert torch.isfinite(g).all(), name
        if w is not None:
            close(g, w, SCAN_GRAD_TOL, f"{name} vs jax.grad")
        close(g, a.numpy(), SCAN_GRAD_TOL, f"{name} vs autograd")


def below_clip_inputs(case, seed):
    """wkv_inputs with every other channel's decay drawn as e^{-46 U}, U
    uniform in [0, 1): down to 1e-20, far below the model's clip e^-e, so
    that those channels' sub-blocks decay past e^-60 and take the exact
    diagonal, beside channels that take the factorised one."""
    r, k, v, w, u, s0 = wkv_inputs(case, seed=seed, with_state=True)
    rng = np.random.default_rng(seed + 1)
    tiny = np.exp(-46.0 * rng.random(case)).astype(np.float32)
    w = w.copy()
    w[..., ::2] = tiny[..., ::2]
    return r, k, v, w, u, s0


def test_chunk_form_below_the_models_decay_clip():
    """w down to 1e-20: the reference's chunked version overflows (its
    pairwise decays are exponentiated before the causal mask), the chunk
    form stays finite and equal to the sequential oracle and its
    ``jax.grad``.  dw = (d/d log w) / w, whose rounding grows as 1/w, so w
    is held as w * dw, the gradient in log w, at the same tolerance."""
    case = (1, 77, 2, 16)
    ins = below_clip_inputs(case, seed=32)
    dy = np.random.default_rng(133).standard_normal(case).astype(np.float32)
    assert not np.isfinite(np.asarray(jops.wkv6_chunked(*ins, d_block=8)[0])).all()
    y, s, _, grads = mirror(ins, dy)
    wy, ws = jref.rwkv6_ref(*ins)
    close(y, wy, SCAN_TOL, "y vs ref")
    close(s, ws, SCAN_TOL, "state vs ref")
    want = list(jax_grads(jref.rwkv6_ref, ins, dy))
    w = ins[3]
    for name, g, wg in zip(GRAD_NAMES, grads, want):
        assert torch.isfinite(g).all(), name
        if name == "dw":
            g, wg = g * t(w), np.asarray(wg) * w
        close(g, wg, SCAN_GRAD_TOL, f"{name} vs jax.grad of the oracle")


def test_chunk_form_gradients_are_no_farther_from_float64_than_plain():
    """Phase 10's rule on the CPU: at float32, the chunk form's gradients
    lie no farther from a float64 run of the plain version than the plain
    version's own float32 autograd, or ``F64_REL``, relative to each
    gradient's largest magnitude; inputs as ``chip_smoke.scan_inputs``
    draws them (w = exp(-exp(.)) under the model's clip)."""
    b, T, h, d = 2, 130, 2, 32
    rng = np.random.default_rng(34)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    ins = [f(b, T, h, d) * 0.5, f(b, T, h, d) * 0.5, f(b, T, h, d),
           np.exp(-np.exp(np.clip(f(b, T, h, d) * 2, -8, 1))).astype(np.float32),
           f(h, d) * 0.1, f(b, h, d, d) * 0.5]
    dy = f(b, T, h, d)

    def plain(dtype):
        leaves = [t(x).to(dtype).requires_grad_() for x in ins]
        y, _ = ops.wkv6_chunked(*leaves)
        return torch.autograd.grad(y, leaves, t(dy).to(dtype))

    exact, p32 = plain(torch.float64), plain(torch.float32)
    *_, grads = mirror(ins, dy)
    for name, g, p, e in zip(GRAD_NAMES, grads, p32, exact):
        scale = e.abs().max()
        kd = ((g.double() - e).abs().max() / scale).item()
        pd = ((p.double() - e).abs().max() / scale).item()
        assert kd <= max(pd, F64_REL), (name, kd, pd)


@pytest.mark.parametrize("shape,chunks", [
    ((4, 512, 40, 64), 8), ((1, 64, 2, 64), 1), ((1, 65, 2, 64), 2),
    ((1, 1, 2, 64), 1), ((1, 77, 2, 16), 2), ((2, 130, 3, 40), 3),
    ((3, 128, 1, 8), 2)])
def test_plan_counts_blocks_and_chunks(shape, chunks):
    """One forward block per (batch row, head) whatever the head size, one
    backward chunk-kernel block per (batch row, head, chunk of 64)."""
    b, T, h, d = shape
    plan = wkv.plan(*shape)
    assert plan["chunks"] == chunks == -(-T // wkv.CHUNK)
    assert plan["fwd_blocks"] == b * h
    assert plan["bwd_blocks"] == b * h * chunks


def test_plan_at_the_training_shape():
    """rwkv6-3b's training shape: 8 chunks of 64, one forward block per
    (b, h); 1 CUDA launch forward, 4 backward (the state gradient's
    per-chunk parts, their chain over the chunks, the chunk kernel over all
    8 chunks at once, and du's sum over the batch and the chunks)."""
    plan = wkv.plan(4, 512, 40, 64)
    assert plan == {"fwd_blocks": 160, "chunks": 8, "bwd_blocks": 1280,
                    "launches": {"fwd": 1, "bwd": 4}}
    assert plan["launches"] == wkv.CUDA_LAUNCHES
    assert wkv.CHUNK == 64


def test_kernel_wrappers_take_cuda_tensors_only():
    """On CPU tensors the wrappers refuse before any launch (the plain
    version is ``ops.wkv6_chunked``)."""
    r, k, v, w, u, _ = map(t, wkv_inputs((1, 8, 2, 8), seed=35))
    with pytest.raises(ValueError, match="CUDA"):
        wkv.wkv6_fwd(r, k, v, w, u)
    ckpt = (torch.zeros((1, 2, 1, 8, 8)),)
    with pytest.raises(ValueError, match="CUDA"):
        wkv.wkv6_bwd(r, k, v, w, u, ckpt, r)
