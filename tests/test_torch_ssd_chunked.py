"""The SSD kernels' chunk form (``kernels.ref.mamba2_ssd_chunked`` and its
hand-written backward ``mamba2_ssd_chunked_grads``) against the JAX
reference, and the Python arithmetic of the kernels' wrapper.

The CUDA kernels in ``csrc/mamba2_ssd.cu`` run only on the card; their
arithmetic (chunks of 64 tokens, the decay matrix masked before its
exponent, the per-token sums behind dA taken without cancelling two
chunk totals) is written plainly in ``kernels/ref.py`` so that it is held
here, on the same numpy inputs, against:

* forward: the reference's Pallas kernel in interpret mode (zero initial
  state: it asserts one) and its chunked jnp version;
* backward: ``jax.grad`` of the reference's chunked version, and of its
  sequential oracle where a chunk's decays overflow the chunked gradient;
  and the port's own autograd through ``ops.mamba2_chunked``.

Cases: the reference's SSD_CASES, plus T = 64 (one whole chunk), T = 65
(one token into a second) and T = 1, each with and without an initial
state.  Tolerances are ``tests/test_torch_mamba2.py``'s, all float32:
outputs and states ``atol=5e-5, rtol=1e-4``, gradients ``atol=rtol=1e-4``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.mamba2_ssd import mamba2_pallas
from repro_torch.kernels import mamba2_ssd as tssd
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from test_torch_mamba2 import SCAN_GRAD_TOL, SCAN_TOL, SSD_CASES, close, ssd_inputs, t

CASES = SSD_CASES + [(2, 64, 2, 8, 8), (1, 65, 3, 8, 12), (2, 1, 2, 16, 8)]
GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dstate")


def mirror(ins, dy):
    """The chunk form's forward and backward from numpy inputs."""
    x, dt, A, Bm, Cm, s0 = map(t, ins)
    y, s, starts = tref.mamba2_ssd_chunked(x, dt, A, Bm, Cm, s0)
    grads = tref.mamba2_ssd_chunked_grads(x, dt, A, Bm, Cm, starts, t(dy))
    return y, s, starts, grads


def draw(case, seed, with_state, **kw):
    ins = ssd_inputs(case, seed=seed, with_state=with_state, **kw)
    dy = np.random.default_rng(seed + 100).standard_normal(case[:4]).astype(
        np.float32)
    return ins, dy


def jax_grads(fn, ins, dy):
    """jax.grad of sum(fn(...)[0] * dy) in x, dt, A, Bm, Cm (and the state
    when one is given)."""
    args = tuple(range(6 if ins[5] is not None else 5))
    xs = ins if ins[5] is not None else ins[:5]
    return jax.grad(lambda *v: jnp.sum(fn(*v)[0] * dy), argnums=args)(*xs)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("case", CASES)
def test_chunk_form_forward_matches_reference(case, with_state):
    ins, dy = draw(case, seed=20, with_state=with_state)
    y, s, starts, _ = mirror(ins, dy)
    want = [("chunked", jops.mamba2_chunked(*ins, chunk=16)),
            ("ref", jref.mamba2_ref(*ins))]
    if not with_state:
        want.append(("pallas", mamba2_pallas(*ins[:5], chunk=16, interpret=True)))
    for name, (wy, ws) in want:
        close(y, wy, SCAN_TOL, f"y vs {name}")
        close(s, ws, SCAN_TOL, f"state vs {name}")
    # the saved chunk-start states: one every 64 tokens, the first the
    # initial state
    b, T, h, p, n = case
    assert tuple(starts.shape) == (b, h, -(-T // tssd.CHUNK), p, n)
    s0 = np.zeros((b, h, p, n), np.float32) if ins[5] is None else ins[5]
    close(starts[:, :, 0], s0, SCAN_TOL, "first chunk-start state")


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("case", CASES)
def test_chunk_form_backward_matches_jax_grad_and_autograd(case, with_state):
    ins, dy = draw(case, seed=21, with_state=with_state)
    *_, grads = mirror(ins, dy)
    want = jax_grads(lambda *v: jops.mamba2_chunked(*v, chunk=16), ins, dy)
    leaves = [t(v).requires_grad_() for v in ins[:5]]
    leaves += [t(ins[5]).requires_grad_() if with_state
               else torch.zeros(case[0], case[2], case[3], case[4],
                                requires_grad=True)]
    y, _ = ops.mamba2_chunked(*leaves)
    port = torch.autograd.grad(y, leaves, t(dy))
    for name, g, w, a in zip(GRAD_NAMES, grads, want + (None,), port):
        assert torch.isfinite(g).all(), name
        if w is not None:
            close(g, w, SCAN_GRAD_TOL, f"{name} vs jax.grad")
        close(g, a.numpy(), SCAN_GRAD_TOL, f"{name} vs autograd")


def test_chunk_form_backward_where_the_chunked_reference_overflows():
    """dt = softplus(N + 1) over 100 tokens: a 64-token chunk's decays sum
    past 88, the reference's chunked gradient is NaN there, and the chunk
    form's stays finite and equal to ``jax.grad`` of the sequential
    oracle."""
    ins, dy = draw((1, 100, 2, 8, 8), seed=22, with_state=True, dt_shift=1.0,
                   dt_scale=1.0)
    chunked = jax_grads(jops.mamba2_chunked, ins, dy)
    assert any(np.isnan(np.asarray(g)).any() for g in chunked)
    want = jax_grads(jref.mamba2_ref, ins, dy)
    *_, grads = mirror(ins, dy)
    for name, g, w in zip(GRAD_NAMES, grads, want):
        assert torch.isfinite(g).all(), name
        close(g, w, SCAN_GRAD_TOL, f"{name} vs jax.grad of the oracle")


@pytest.mark.parametrize("heads, group", [(80, 8), (40, 8), (12, 4), (6, 2),
                                          (3, 1), (1, 1)])
def test_head_group_is_the_largest_power_of_two_dividing_the_heads(heads, group):
    assert tssd.head_group(heads) == group


def test_backward_plan_partials_and_launches():
    """zamba2-2.7b's training shape: clusters of 8 heads, dB / dC partials
    (B, T, H / 8, N), 8 chunks, 2 CUDA launches; the forward 1."""
    plan = tssd.bwd_plan(4, 512, 80, 64, 64)
    assert plan == {"group": 8, "partial_shape": (4, 512, 10, 64),
                    "chunks": 8, "launches": 2}
    assert tssd.bwd_plan(1, 77, 3, 16, 8)["partial_shape"] == (1, 77, 3, 8)
    assert tssd.bwd_plan(2, 65, 4, 8, 8)["chunks"] == 2
    assert tssd.CUDA_LAUNCHES == {"fwd": 1, "bwd": 2}
    assert tssd.CHUNK == 64


def test_kernel_wrappers_take_cuda_tensors_only():
    """On CPU tensors the wrappers refuse before any launch (the plain
    version is ``ops.mamba2_chunked``)."""
    x, dt, A, Bm, Cm, _ = map(t, ssd_inputs((1, 8, 2, 8, 8), seed=23))
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_fwd(x, dt, A, Bm, Cm)
    ckpt = (torch.zeros((1, 2, 1, 8, 8)),)
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_bwd(x, dt, A, Bm, Cm, ckpt, x)
