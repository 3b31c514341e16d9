"""The port's rwkv6 slice against the JAX reference: the WKV6 scan, the
rwkv6 model, its training and its checkpoints.

On the CPU the port's ``kernels.ops.wkv6`` runs the chunked plain version
(``ops.wkv6_chunked``); it is held here against the reference's chunked
jnp version, its sequential oracle ``ref.rwkv6_ref`` and its Pallas
kernel in interpret mode, on the same numpy inputs.  The CUDA kernels run
only on the card: the ``cuda``-marked test holds them against the plain
version there.  The model checks (``test_torch_family_parity.py``) run the
reduced rwkv6-3b (2 layers, d_model 64, 4 heads of 16) at float32 compute
with the reference's weights, on 40-token sequences: more than one WKV6
chunk of 32, so the state crosses a chunk boundary forward and back.

Tolerances, all float32:
* scan outputs and states: ``atol=5e-5, rtol=1e-4``, the reference's own
  (tests/test_kernels.py:107-125);
* scan gradients: ``atol=1e-4, rtol=1e-4`` — sums over T tokens and D x D
  state cells of values up to ~10, in different orders;
* model logits, loss, decode logits and caches, gradients, opt.m and
  opt.v: ``atol=5e-5, rtol=1e-4`` (gradients pass back through the scans
  and the per-head group norm, eps 64e-5); params after 1 and 3
  AdamW steps: ``rtol=1e-4`` and ``atol`` of 10% of ``lr`` per step (see
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
from repro.kernels.rwkv6_scan import wkv6_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

ARCH = "rwkv6-3b"
SCAN_TOL = dict(atol=5e-5, rtol=1e-4)
SCAN_GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
# the reference's WKV_CASES (tests/test_kernels.py:92): (B, T, H, D)
WKV_CASES = [(1, 16, 2, 8), (2, 50, 3, 16), (1, 33, 2, 8), (1, 128, 1, 32)]


def wkv_inputs(case, seed, with_state=False):
    """r, k, v, w, u (and a state) as the reference's tests draw them:
    w in (0.45, 0.95)."""
    b, t, h, d = case
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = f(b, t, h, d) * 0.5, f(b, t, h, d) * 0.5, f(b, t, h, d)
    w = (1 / (1 + np.exp(-f(b, t, h, d))) * 0.5 + 0.45).astype(np.float32)
    u = f(h, d) * 0.1
    state = f(b, h, d, d) * 0.5 if with_state else None
    return r, k, v, w, u, state


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **tol)


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_chunked_matches_reference_chunked_ref_and_pallas(case):
    r, k, v, w, u, _ = wkv_inputs(case, seed=1)
    y, s = ops.wkv6_chunked(*map(t, (r, k, v, w, u)), chunk=16, d_block=8)
    for name, (wy, ws) in (
            ("chunked", jops.wkv6_chunked(r, k, v, w, u, chunk=16, d_block=8)),
            ("ref", jref.rwkv6_ref(r, k, v, w, u)),
            ("pallas", wkv6_pallas(r, k, v, w, u, chunk=16, interpret=True))):
        close(y, wy, SCAN_TOL, f"y vs {name}")
        close(s, ws, SCAN_TOL, f"state vs {name}")


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_nonzero_initial_state(case):
    """With a carried state (the Pallas kernel refuses one): against the
    reference's chunked version and its sequential oracle, and the port's
    own oracle."""
    r, k, v, w, u, s0 = wkv_inputs(case, seed=2, with_state=True)
    y, s = ops.wkv6_chunked(*map(t, (r, k, v, w, u, s0)), chunk=16, d_block=8)
    for name, (wy, ws) in (
            ("chunked", jops.wkv6_chunked(r, k, v, w, u, s0, chunk=16,
                                          d_block=8)),
            ("ref", jref.rwkv6_ref(r, k, v, w, u, s0)),
            ("port ref", tuple(x.numpy() for x in tref.rwkv6_ref(
                *map(t, (r, k, v, w, u, s0)))))):
        close(y, wy, SCAN_TOL, f"y vs {name}")
        close(s, ws, SCAN_TOL, f"state vs {name}")


def test_wkv6_dispatch_on_cpu_is_the_default_chunked_version():
    """``ops.wkv6`` on CPU tensors: the chunk-32, d_block-16 plain version,
    equal to the reference's ``ops.wkv6`` off the TPU; ``use_kernel=True``
    on a CPU tensor raises."""
    r, k, v, w, u, s0 = wkv_inputs((2, 70, 2, 16), seed=3, with_state=True)
    y, s = ops.wkv6(*map(t, (r, k, v, w, u, s0)))
    wy, ws = jops.wkv6(r, k, v, w, u, s0)
    close(y, wy, SCAN_TOL)
    close(s, ws, SCAN_TOL)
    with pytest.raises(ValueError):
        ops.wkv6(*map(t, (r, k, v, w, u)), use_kernel=True)


def test_wkv6_state_chaining_and_decode_chain():
    """Two chunked calls with the state carried equal one call; the
    decode step, token by token, equals the scan (and the reference's
    decode step)."""
    r, k, v, w, u, _ = map(t, wkv_inputs((1, 32, 2, 8), seed=11))
    full, fs = ops.wkv6_chunked(r, k, v, w, u, chunk=8, d_block=8)
    h1, s1 = ops.wkv6_chunked(r[:, :16], k[:, :16], v[:, :16], w[:, :16], u,
                              chunk=8, d_block=8)
    h2, s2 = ops.wkv6_chunked(r[:, 16:], k[:, 16:], v[:, 16:], w[:, 16:], u,
                              state=s1, chunk=8, d_block=8)
    close(torch.cat([h1, h2], 1), full.numpy(), SCAN_TOL)
    close(s2, fs.numpy(), SCAN_TOL)
    state = torch.zeros(1, 2, 8, 8)
    jstate = jnp.zeros((1, 2, 8, 8))
    for i in range(32):
        y, state = ops.wkv6_decode_step(r[:, i], k[:, i], v[:, i], w[:, i], u,
                                        state)
        jy, jstate = jops.wkv6_decode_step(*(x[:, i].numpy() for x in
                                             (r, k, v, w)), u.numpy(), jstate)
        close(y, jy, SCAN_TOL)
        close(y, full[:, i].numpy(), SCAN_TOL)
    close(state, fs.numpy(), SCAN_TOL)


@pytest.mark.parametrize("case", [(2, 50, 3, 16), (1, 33, 2, 8)])
def test_wkv6_plain_gradients_match_jax_grad(case):
    """Autograd through the port's chunked version against ``jax.grad`` of
    the reference's, for r, k, v, w, u and the initial state."""
    ins = wkv_inputs(case, seed=5, with_state=True)
    dy = np.random.default_rng(6).standard_normal(case).astype(np.float32)

    def jloss(*xs):
        return jnp.sum(jops.wkv6_chunked(*xs, chunk=16, d_block=8)[0] * dy)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*ins)
    leaves = [t(x).requires_grad_() for x in ins]
    y, _ = ops.wkv6_chunked(*leaves, chunk=16, d_block=8)
    got = torch.autograd.grad(y, leaves, t(dy))
    for name, g, w_ in zip(("dr", "dk", "dv", "dw", "du", "dstate"), got, want):
        close(g, w_, SCAN_GRAD_TOL, name)


@pytest.fixture(scope="module")
def pair():
    return fp.make_pair(ARCH)


def test_init_shapes_dtypes_and_scale():
    fp.check_init(ARCH)


def test_forward_logits_match_reference(pair):
    fp.check_forward(pair)


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
def test_cuda_wkv6_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the WKV6 kernels have no CPU mode")
    dev = torch.device("cuda")
    for case in ((2, 200, 4, 64), (1, 77, 3, 16)):
        ins = [x.to(dev) for x in map(t, wkv_inputs(case, seed=8,
                                                    with_state=True))]
        dy = torch.randn(case, device=dev)
        out = []
        for use_kernel in (None, False):
            leaves = [x.clone().requires_grad_() for x in ins]
            y, s = ops.wkv6(*leaves, use_kernel=use_kernel)
            out.append((y, s) + torch.autograd.grad(y, leaves, dy))
        for g, w_ in zip(out[0][:2], out[1][:2]):
            torch.testing.assert_close(g, w_, **SCAN_TOL)
        for g, w_ in zip(out[0][2:], out[1][2:]):
            torch.testing.assert_close(g, w_, **SCAN_GRAD_TOL)
