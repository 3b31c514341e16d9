"""Error-feedback int8 compression: the port against the reference.

The same numpy gradients (seeded) go through ``repro.optim.compression``
and ``repro_torch.optim.compression``.  The int8 grads and their scales
must agree byte for byte.  The residual ``g32 - q * scale`` may differ by
one ulp of ``scale`` (XLA may fuse the reference's into a multiply-add;
the port rounds the product first), so it is held within
``RESIDUAL_ULPS`` ulps of the leaf's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro_torch import optim as toptim
from repro_torch.optim import compression as tcomp

RESIDUAL_ULPS = 1


def ulp(x: np.ndarray) -> np.ndarray:
    return np.spacing(np.abs(np.float32(x)))


def both(tree_np):
    """The reference's and the port's (q, scale, residual) for one step
    from a zero residual."""
    jt = {k: jnp.asarray(v) for k, v in tree_np.items()}
    tt = {k: torch.from_numpy(v.copy()) for k, v in tree_np.items()}
    jq, js, jr = jcomp.compress_grads(jt, jcomp.init_residual(jt))
    tq, ts, tr = tcomp.compress_grads(tt, tcomp.init_residual(tt))
    return (jq, js, jr), (tq, ts, tr)


def assert_step_equal(j, t):
    (jq, js, jr), (tq, ts, tr) = j, t
    for k in jq:
        assert tq[k].dtype == torch.int8 and ts[k].dtype == torch.float32
        assert np.asarray(jq[k]).tobytes() == tq[k].numpy().tobytes(), k
        assert np.asarray(js[k]).tobytes() == ts[k].numpy().tobytes(), k
        tol = RESIDUAL_ULPS * ulp(np.asarray(js[k]))
        np.testing.assert_array_less(
            np.abs(np.asarray(jr[k]) - tr[k].numpy()), tol + np.float32(1e-45))


def test_exports_match_the_reference():
    from repro import optim as joptim
    assert set(toptim.__all__) == set(joptim.__all__)
    assert toptim.compress_grads is tcomp.compress_grads


def test_compression_roundtrip_small_error_both_packages():
    """The reference's ``test_compression_roundtrip_small_error`` on both
    packages: equal bytes, and the port's error within half a scale."""
    g = {"w": np.random.default_rng(0).normal(size=(256,)).astype(np.float32)}
    j, t = both(g)
    assert_step_equal(j, t)
    tq, ts, _ = t
    back = tcomp.decompress_grads(tq, ts)
    err = np.abs(back["w"].numpy() - g["w"]).max()
    assert err <= float(ts["w"]) / 2 + 1e-7
    jback = jcomp.decompress_grads(*j[:2])
    assert np.asarray(jback["w"]).tobytes() == back["w"].numpy().tobytes()


def test_error_feedback_is_unbiased_over_steps_both_packages():
    """The reference's 50-step case: each package's mean recovered grad
    within the reference's 1e-5 of the true grad, and the two totals
    together (the residuals stay within an ulp of scale of each other)."""
    rng = np.random.default_rng(1)
    g_np = (rng.normal(size=(64,)) * 1e-3).astype(np.float32)
    jg, tg = {"w": jnp.asarray(g_np)}, {"w": torch.from_numpy(g_np.copy())}
    jr, tr = jcomp.init_residual(jg), tcomp.init_residual(tg)
    jtot, ttot = np.zeros(64), np.zeros(64)
    steps = 50
    for _ in range(steps):
        jq, js, jr = jcomp.compress_grads(jg, jr)
        tq, ts, tr = tcomp.compress_grads(tg, tr)
        jtot += np.asarray(jcomp.decompress_grads(jq, js)["w"])
        ttot += tcomp.decompress_grads(tq, ts)["w"].numpy()
    np.testing.assert_allclose(ttot / steps, g_np, atol=1e-5)
    np.testing.assert_allclose(jtot / steps, g_np, atol=1e-5)
    np.testing.assert_allclose(ttot / steps, jtot / steps, atol=1e-5)


@pytest.mark.parametrize("seed", [2, 3])
def test_mixed_tree_matches_reference(seed):
    """A dict tree of mixed shapes (a scalar, vectors, matrices, an
    all-zero leaf): q and scale byte-equal, the residual within an ulp of
    scale, the dequantized error within half a scale."""
    rng = np.random.default_rng(seed)
    tree = {"a": rng.normal(size=(7, 33)).astype(np.float32) * 3.0,
            "b": rng.normal(size=(1,)).astype(np.float32),
            "c": rng.normal(size=(4, 5, 6)).astype(np.float32) * 1e-4,
            "z": np.zeros((3, 3), np.float32),
            "s": np.array(rng.normal(), np.float32)}
    j, t = both(tree)
    assert_step_equal(j, t)
    back = tcomp.decompress_grads(t[0], t[1])
    for k, v in tree.items():
        assert tuple(back[k].shape) == v.shape
        assert np.abs(back[k].numpy() - v).max() <= float(t[1][k]) / 2 + 1e-7


def test_nested_tree_keeps_structure_and_device():
    """Nested dicts keep their structure; the residual is float32 on the
    gradient's device, whatever the gradient's dtype."""
    rng = np.random.default_rng(4)
    g = {"layers": {"0": {"w": torch.from_numpy(rng.normal(size=(8, 8)).astype(
        np.float32)).to(torch.bfloat16)}, "1": {"w": torch.zeros(2)}},
         "head": torch.ones(3)}
    r = tcomp.init_residual(g)
    assert r["layers"]["0"]["w"].dtype == torch.float32
    assert r["layers"]["0"]["w"].device == g["layers"]["0"]["w"].device
    q, s, r2 = tcomp.compress_grads(g, r)
    assert q["layers"]["0"]["w"].dtype == torch.int8
    assert r2["head"].dtype == torch.float32
    back = tcomp.decompress_grads(q, s)
    assert back["layers"]["1"]["w"].abs().max() == 0
    assert set(back) == set(g) and set(back["layers"]) == {"0", "1"}
