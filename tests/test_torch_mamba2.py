"""The port's zamba2 slice against the JAX reference: the Mamba2 SSD scan,
the zamba2 model, its training and its checkpoints.

On the CPU the port's ``kernels.ops.mamba2_ssd`` runs the chunked plain
version (``ops.mamba2_chunked``); it is held here against the reference's
chunked jnp version, its sequential oracle ``ref.mamba2_ref`` and its
Pallas kernel in interpret mode, on the same numpy inputs.  The CUDA
kernels run only on the card: the ``cuda``-marked test holds them against
the plain version there.  The model checks (``test_torch_family_parity.py``)
run the reduced zamba2-2.7b (4 Mamba layers in 2 groups, 8 SSD heads,
P = N = 16, the shared attention block at head dim 16) at float32
compute with the reference's weights.

The reference's chunked SSD has a NaN gradient wherever a chunk's decays
overflow above the diagonal (``exp(L_i - L_j)`` for j > i, then masked by a
``where``): :func:`test_mamba2_gradient_is_finite_where_the_reference_is_nan`
shows it and holds the port's gradient against ``jax.grad`` of the
reference's sequential oracle instead.  The model's gradient, training
and decode checks use 24-token sequences, where the reference's gradients
are finite; its forward logits are compared at 96 tokens, across a chunk
boundary.

Tolerances, all float32:
* scan outputs and states: ``atol=5e-5, rtol=1e-4``, the reference's own
  (tests/test_kernels.py:175-193);
* scan gradients: ``atol=1e-4, rtol=1e-4`` — sums over T tokens and
  P x N state cells of values up to ~10, in different orders;
* model logits, loss, decode logits and caches, gradients, opt.m and
  opt.v: ``atol=5e-5, rtol=1e-4``; params after 1 and 3 AdamW steps:
  ``rtol=1e-4`` and ``atol`` of 10% of ``lr`` per step (see
  ``test_torch_family_parity.py``);
* the trainer's kill / recover run and the checkpoint bytes: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_family_parity as fp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.mamba2_ssd import mamba2_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

ARCH = "zamba2-2.7b"
SCAN_TOL = dict(atol=5e-5, rtol=1e-4)
SCAN_GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
# the reference's SSD_CASES (tests/test_kernels.py:160): (B, T, H, P, N)
SSD_CASES = [(1, 16, 2, 8, 8), (2, 50, 3, 8, 12), (1, 33, 2, 16, 8),
             (1, 100, 1, 32, 16)]


def ssd_inputs(case, seed, with_state=False, dt_shift=0.0, dt_scale=0.5):
    """x, dt, A, Bm, Cm (and a state) as the reference's tests draw them:
    dt = softplus(N + dt_shift) * dt_scale, A = -exp(0.3 N)."""
    b, t, h, p, n = case
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(b, t, h, p)
    dt = (np.logaddexp(f(b, t, h) + dt_shift, 0.0) * dt_scale).astype(np.float32)
    A = -np.exp(f(h) * 0.3).astype(np.float32)
    Bm, Cm = f(b, t, n) * 0.5, f(b, t, n) * 0.5
    state = f(b, h, p, n) * 0.5 if with_state else None
    return x, dt, A, Bm, Cm, state


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **tol)


@pytest.mark.parametrize("case", SSD_CASES)
def test_mamba2_chunked_matches_reference_chunked_ref_and_pallas(case):
    x, dt, A, Bm, Cm, _ = ssd_inputs(case, seed=1)
    y, s = ops.mamba2_chunked(*map(t, (x, dt, A, Bm, Cm)), chunk=16)
    for name, (wy, ws) in (
            ("chunked", jops.mamba2_chunked(x, dt, A, Bm, Cm, chunk=16)),
            ("ref", jref.mamba2_ref(x, dt, A, Bm, Cm)),
            ("pallas", mamba2_pallas(x, dt, A, Bm, Cm, chunk=16,
                                     interpret=True))):
        close(y, wy, SCAN_TOL, f"y vs {name}")
        close(s, ws, SCAN_TOL, f"state vs {name}")


@pytest.mark.parametrize("case", SSD_CASES)
def test_mamba2_nonzero_initial_state(case):
    """With a carried state (the Pallas kernel refuses one): against the
    reference's chunked version and its sequential oracle, and the port's
    own oracle."""
    x, dt, A, Bm, Cm, s0 = ssd_inputs(case, seed=2, with_state=True)
    y, s = ops.mamba2_chunked(*map(t, (x, dt, A, Bm, Cm, s0)), chunk=16)
    for name, (wy, ws) in (
            ("chunked", jops.mamba2_chunked(x, dt, A, Bm, Cm, s0, chunk=16)),
            ("ref", jref.mamba2_ref(x, dt, A, Bm, Cm, s0)),
            ("port ref", tuple(v.numpy() for v in tref.mamba2_ref(
                *map(t, (x, dt, A, Bm, Cm, s0)))))):
        close(y, wy, SCAN_TOL, f"y vs {name}")
        close(s, ws, SCAN_TOL, f"state vs {name}")


def test_mamba2_dispatch_on_cpu_is_the_default_chunked_version():
    """``ops.mamba2_ssd`` on CPU tensors: the chunk-64 plain version,
    equal to the reference's ``ops.mamba2_ssd`` off the TPU;
    ``use_kernel=True`` on a CPU tensor raises."""
    x, dt, A, Bm, Cm, s0 = ssd_inputs((2, 150, 3, 16, 16), seed=3,
                                      with_state=True)
    y, s = ops.mamba2_ssd(*map(t, (x, dt, A, Bm, Cm, s0)))
    wy, ws = jops.mamba2_ssd(x, dt, A, Bm, Cm, s0)
    close(y, wy, SCAN_TOL)
    close(s, ws, SCAN_TOL)
    with pytest.raises(ValueError):
        ops.mamba2_ssd(*map(t, (x, dt, A, Bm, Cm)), use_kernel=True)


def test_mamba2_state_chaining_and_decode_chain():
    """Two chunked calls with the state carried equal one call; the
    decode step, token by token, equals the scan (and the reference's
    decode step)."""
    x, dt, A, Bm, Cm, _ = map(t, ssd_inputs((2, 40, 2, 8, 8), seed=12))
    full, fs = ops.mamba2_chunked(x, dt, A, Bm, Cm, chunk=16)
    h1, s1 = ops.mamba2_chunked(x[:, :20], dt[:, :20], A, Bm[:, :20],
                                Cm[:, :20], chunk=16)
    h2, s2 = ops.mamba2_chunked(x[:, 20:], dt[:, 20:], A, Bm[:, 20:],
                                Cm[:, 20:], state=s1, chunk=16)
    close(torch.cat([h1, h2], 1), full.numpy(), SCAN_TOL)
    close(s2, fs.numpy(), SCAN_TOL)
    state = torch.zeros(2, 2, 8, 8)
    jstate = jnp.zeros((2, 2, 8, 8))
    for i in range(40):
        y, state = ops.mamba2_decode_step(x[:, i], dt[:, i], A, Bm[:, i],
                                          Cm[:, i], state)
        jy, jstate = jops.mamba2_decode_step(
            x[:, i].numpy(), dt[:, i].numpy(), A.numpy(), Bm[:, i].numpy(),
            Cm[:, i].numpy(), jstate)
        close(y, jy, SCAN_TOL)
        close(y, full[:, i].numpy(), SCAN_TOL)
    close(state, fs.numpy(), SCAN_TOL)


def _port_grads(ins, dy, chunk):
    leaves = [t(v).requires_grad_() for v in ins]
    y, _ = ops.mamba2_chunked(*leaves, chunk=chunk)
    return torch.autograd.grad(y, leaves, t(dy))


@pytest.mark.parametrize("case", [(2, 50, 3, 8, 12), (1, 33, 2, 16, 8)])
def test_mamba2_plain_gradients_match_jax_grad(case):
    """Autograd through the port's chunked version against ``jax.grad`` of
    the reference's, for x, dt, A, Bm, Cm and the initial state."""
    ins = ssd_inputs(case, seed=5, with_state=True)
    dy = np.random.default_rng(6).standard_normal(case[:4]).astype(np.float32)

    def jloss(*xs):
        return jnp.sum(jops.mamba2_chunked(*xs, chunk=16)[0] * dy)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*ins)
    got = _port_grads(ins, dy, 16)
    for name, g, w_ in zip(("dx", "ddt", "dA", "dB", "dC", "dstate"), got, want):
        close(g, w_, SCAN_GRAD_TOL, name)


def test_mamba2_gradient_is_finite_where_the_reference_is_nan():
    """At the default chunk of 64, with decays whose sum over a chunk
    passes 88 (dt = softplus(N + 1)), ``exp(L_i - L_j)`` above the
    diagonal overflows: the reference's chunked gradient is NaN, the
    port's is finite and equals ``jax.grad`` of the reference's sequential
    oracle."""
    ins = ssd_inputs((1, 100, 2, 8, 8), seed=7, with_state=True, dt_shift=1.0,
                     dt_scale=1.0)
    dy = np.random.default_rng(8).standard_normal((1, 100, 2, 8)).astype(
        np.float32)
    args = tuple(range(6))
    chunked = jax.grad(lambda *xs: jnp.sum(jops.mamba2_chunked(*xs)[0] * dy),
                       argnums=args)(*ins)
    assert any(np.isnan(np.asarray(g)).any() for g in chunked)
    want = jax.grad(lambda *xs: jnp.sum(jref.mamba2_ref(*xs)[0] * dy),
                    argnums=args)(*ins)
    got = _port_grads(ins, dy, 64)
    for name, g, w_ in zip(("dx", "ddt", "dA", "dB", "dC", "dstate"), got, want):
        assert torch.isfinite(g).all(), name
        close(g, w_, SCAN_GRAD_TOL, name)


@pytest.fixture(scope="module")
def pair():
    return fp.make_pair(ARCH)


def test_init_shapes_dtypes_and_scale():
    fp.check_init(ARCH)


def test_forward_logits_match_reference(pair):
    """At 96 tokens: a full SSD chunk of 64 and a partial one, so the
    state crosses a chunk boundary."""
    fp.check_forward(pair, seq=96)


def test_loss_and_grads_match_reference(pair):
    fp.check_loss_and_grads(pair)


def test_train_steps_match_reference(pair):
    fp.check_train_steps(pair)


def test_decode_chain_matches_reference(pair):
    fp.check_decode(pair)


def test_trainer_kill_and_recover_equals_uninterrupted_run():
    fp.check_trainer_kill_and_recover(ARCH)


def test_train_state_checkpoint_bytes_cross_package(pair):
    fp.check_checkpoint_bytes(pair)


@pytest.mark.cuda
def test_cuda_ssd_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SSD kernels have no CPU mode")
    dev = torch.device("cuda")
    for case in ((2, 200, 4, 64, 64), (1, 77, 3, 16, 8)):
        ins = [v.to(dev) for v in map(t, ssd_inputs(case, seed=8,
                                                    with_state=True))]
        dy = torch.randn(case[:4], device=dev)
        out = []
        for use_kernel in (None, False):
            leaves = [v.clone().requires_grad_() for v in ins]
            y, s = ops.mamba2_ssd(*leaves, use_kernel=use_kernel)
            out.append((y, s) + torch.autograd.grad(y, leaves, dy))
        for g, w_ in zip(out[0][:2], out[1][:2]):
            torch.testing.assert_close(g, w_, **SCAN_TOL)
        for g, w_ in zip(out[0][2:], out[1][2:]):
            torch.testing.assert_close(g, w_, **SCAN_GRAD_TOL)
