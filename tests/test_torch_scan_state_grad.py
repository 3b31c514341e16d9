"""The scans' gradient through the final state, and heads past 64.

The WKV6 and SSD backward kernels seed their reverse state-gradient chain
with the gradient on the final state (``dstate``).  Their arithmetic,
written plainly (``kernels.ref.wkv6_chunked_form_grads`` and
``mamba2_ssd_chunked_grads``, which take the same ``dstate``), and the
plain chunked versions under autograd are held here against ``jax.grad``
of the reference's sequential oracles, with a loss on y and on the final
state, at 24 tokens (the reference's chunked SSD gradient is NaN where a
chunk's decays overflow; its sequential oracle is not).

Heads wider than the kernels' 64 run as tiles of the same kernels: the
tile plans are checked as pure functions, the tiled wrappers' partial
sums and state assembly against an untiled run (plain versions standing
in for the kernel launches), and every wide call reaches the CUDA-only
refusal on a CPU tensor, past every shape check.  The kernels themselves
are held against the plain versions on the card
(``tests/test_torch_scan_repairs_cuda.py``, ``chip_smoke.py`` phase 10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import mamba2_ssd as tssd
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as wkv

SCAN_GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def wkv_inputs(shape, seed):
    b, T, h, d = shape
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    w = (1 / (1 + np.exp(-f(b, T, h, d))) * 0.5 + 0.45).astype(np.float32)
    ins = (f(b, T, h, d) * 0.5, f(b, T, h, d) * 0.5, f(b, T, h, d), w,
           f(h, d) * 0.1, f(b, h, d, d) * 0.5)
    return ins, f(b, T, h, d), f(b, h, d, d)


def ssd_inputs(shape, seed):
    b, T, h, p, n = shape
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    dt = np.log1p(np.exp(f(b, T, h))).astype(np.float32)
    A = -np.exp(rng.uniform(0, 1, h)).astype(np.float32)
    ins = (f(b, T, h, p), dt, A, f(b, T, n) * 0.5, f(b, T, n) * 0.5,
           f(b, h, p, n) * 0.5)
    return ins, f(b, T, h, p), f(b, h, p, n)


def jax_grads(fn, ins, dy, ds):
    """``jax.grad`` of sum(y * dy) + sum(final state * ds) through a
    reference oracle, with respect to every input."""
    def loss(*xs):
        y, s = fn(*xs)
        return jnp.sum(y * dy) + jnp.sum(s * ds)

    return jax.grad(loss, argnums=tuple(range(len(ins))))(*ins)


def torch_grads(fn, ins, dy, ds):
    leaves = [t(x).requires_grad_() for x in ins]
    y, s = fn(*leaves)
    return torch.autograd.grad((y, s), leaves, (t(dy), t(ds)))


WKV_NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")
SSD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dstate")


def check(got, want, names):
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=name, **SCAN_GRAD_TOL)


@pytest.mark.parametrize("chunk", [64, 16])
def test_wkv6_final_state_gradient_matches_jax_grad(chunk):
    """The kernels' backward written plainly, seeded with dstate (one
    chunk of 64, or chunks of 16 with the chain between them), and the
    plain chunked version under autograd, against ``jax.grad`` of the
    reference's sequential oracle."""
    ins, dy, ds = wkv_inputs((2, 24, 2, 16), seed=41)
    want = jax_grads(jref.rwkv6_ref, ins, dy, ds)
    check(torch_grads(lambda *x: ops.wkv6_chunked(*x, chunk=8), ins, dy, ds),
          want, WKV_NAMES)
    r, k, v, w, u, s0 = map(t, ins)
    y, s, starts = tref.wkv6_chunked_form(r, k, v, w, u, s0, chunk=chunk)
    got = tref.wkv6_chunked_form_grads(r, k, v, w, u, starts, t(dy),
                                       chunk=chunk, dstate=t(ds))
    check(got, want, WKV_NAMES)
    # a zero dstate is the gradient of y alone
    zero = tref.wkv6_chunked_form_grads(r, k, v, w, u, starts, t(dy),
                                        chunk=chunk, dstate=torch.zeros_like(s))
    for a, b in zip(zero, tref.wkv6_chunked_form_grads(r, k, v, w, u, starts,
                                                       t(dy), chunk=chunk)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("chunk", [64, 8])
def test_ssd_final_state_gradient_matches_jax_grad(chunk):
    ins, dy, ds = ssd_inputs((2, 24, 3, 16, 8), seed=42)
    want = jax_grads(jref.mamba2_ref, ins, dy, ds)
    check(torch_grads(ops.mamba2_chunked, ins, dy, ds), want, SSD_NAMES)
    x, dt, A, Bm, Cm, s0 = map(t, ins)
    y, s, starts = tref.mamba2_ssd_chunked(x, dt, A, Bm, Cm, s0, chunk=chunk)
    got = tref.mamba2_ssd_chunked_grads(x, dt, A, Bm, Cm, starts, t(dy),
                                        chunk=chunk, dstate=t(ds))
    check(got, want, SSD_NAMES)
    zero = tref.mamba2_ssd_chunked_grads(x, dt, A, Bm, Cm, starts, t(dy),
                                         chunk=chunk, dstate=torch.zeros_like(s))
    for a, b in zip(zero, tref.mamba2_ssd_chunked_grads(x, dt, A, Bm, Cm,
                                                        starts, t(dy),
                                                        chunk=chunk)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# heads past 64: the tile plans and the tiled wrappers
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("d,width,tiles", [
    (16, 16, [(0, 16)]), (64, 64, [(0, 64)]), (80, 40, [(0, 40), (40, 40)]),
    (100, 50, [(0, 50), (50, 50)]), (128, 64, [(0, 64), (64, 64)]),
    (130, 44, [(0, 44), (44, 44), (88, 42)])])
def test_wkv6_tile_plan(d, width, tiles):
    """The fewest tiles of at most 64, cut evenly (the kernels take one
    width for keys and values; a short last tile is padded), launched key
    tile outermost."""
    plan = wkv.tile_plan(d)
    assert plan["width"] == width and plan["tiles"] == tiles
    n = len(tiles)
    assert plan["launches"] == [(i, j) for i in range(n) for j in range(n)]
    assert sum(c for _, c in tiles) == d and width <= wkv.MAX_HEAD


@pytest.mark.parametrize("p,n,pt,nt", [
    (64, 64, [(0, 64)], [(0, 64)]),
    (64, 128, [(0, 64)], [(0, 64), (64, 64)]),
    (128, 64, [(0, 64), (64, 64)], [(0, 64)]),
    (200, 8, [(0, 64), (64, 64), (128, 64), (192, 8)], [(0, 8)])])
def test_ssd_tile_plan(p, n, pt, nt):
    """P and N cut into tiles of at most 64 (the kernels take any P and N
    up to 64, each its own width), launched P tile outermost."""
    plan = tssd.tile_plan(p, n)
    assert plan["p_tiles"] == pt and plan["n_tiles"] == nt
    assert plan["launches"] == [(i, j) for i in range(len(pt))
                                for j in range(len(nt))]


def _wkv6_plain(*ins):
    """The plain chunked WKV6 at any head size (one channel slice of the
    whole head)."""
    return ops.wkv6_chunked(*ins, d_block=ins[0].shape[-1])


def _stand_ins(monkeypatch, mod, kind, partials=None):
    """Plain versions in place of the kernel launches (and no device
    check): a forward that saves its initial state as the first chunk
    start, a backward that recomputes from it under autograd (appending
    each gradient's largest magnitude to ``partials``)."""
    fn = _wkv6_plain if kind == "wkv6" else ops.mamba2_chunked
    fwd_counter = mod.wkv6_fwd if kind == "wkv6" else mod.ssd_fwd
    bwd_counter = mod.wkv6_bwd if kind == "wkv6" else mod.ssd_bwd

    def fwd1(*a):
        ins, save = a[:6], a[6]
        assert all(x.dtype == torch.float32 for x in ins if x is not None)
        y, s = fn(*ins)
        ck = None
        if save:
            b, T, h = ins[0].shape[:3]
            ck = torch.zeros((b, h, -(-T // 64)) + tuple(s.shape[2:]))
            if ins[5] is not None:
                ck[:, :, 0] = ins[5]
        fwd_counter.launches += 1
        return y, s, ck

    def bwd1(*a):
        ins5, ck, dy, ds = a[:5], a[5], a[6], a[7]
        with torch.enable_grad():
            leaves = [x.detach().clone().requires_grad_() for x in ins5]
            leaves.append(ck[:, :, 0].clone().requires_grad_())
            y, s = fn(*leaves)
            outs, gs = [y], [dy]
            if ds is not None:
                outs.append(s)
                gs.append(ds)
            g = torch.autograd.grad(outs, leaves, gs)
        bwd_counter.launches += 1
        if partials is not None:
            partials.append([x.abs().max().item() for x in g])
        return g

    monkeypatch.setattr(mod, "_check", lambda *a, **k: None)
    monkeypatch.setattr(mod, "_fwd1", fwd1)
    monkeypatch.setattr(mod, "_bwd1", bwd1)


@pytest.mark.parametrize("kind,shape", [("wkv6", (1, 40, 2, 100)),
                                        ("wkv6", (1, 40, 2, 128)),
                                        ("ssd", (1, 40, 2, 72, 130)),
                                        ("ssd", (1, 40, 2, 128, 64))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_wrappers_assemble_the_untiled_result(monkeypatch, kind, shape,
                                                    dtype):
    """The wide-head path of each wrapper, with the plain version standing
    in for every tile launch: y, the final state and every gradient (a
    loss on y and the final state) equal one untiled plain run; every tile
    runs in float32 (bfloat16 inputs widened) and the partials are summed
    once; a repeat gives the same bits."""
    mod = wkv if kind == "wkv6" else tssd
    partials = []
    _stand_ins(monkeypatch, mod, kind, partials)
    rng = np.random.default_rng(43)
    if kind == "wkv6":
        b, T, h, d = shape
        f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        ins = [f(b, T, h, d) * .5, f(b, T, h, d) * .5, f(b, T, h, d),
               torch.exp(-torch.exp(f(b, T, h, d).clamp(-8, 0))),
               f(h, d) * .1, f(b, h, d, d) * .5]
        plain = _wkv6_plain
        entry = wkv.wkv6
        tiles = len(wkv.tile_plan(d)["launches"])
    else:
        b, T, h, p, n = shape
        f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        ins = [f(b, T, h, p), torch.nn.functional.softplus(f(b, T, h)),
               -torch.exp(torch.from_numpy(rng.uniform(0, 1, h).astype(np.float32))),
               f(b, T, n) * .5, f(b, T, n) * .5, f(b, h, p, n) * .5]
        plain = ops.mamba2_chunked
        entry = tssd.mamba2_ssd
        tiles = len(tssd.tile_plan(p, n)["launches"])
    low = (0, 1, 2) if kind == "wkv6" else (0, 3, 4)   # r, k, v / x, B, C
    ins = [x.to(dtype) if i in low else x for i, x in enumerate(ins)]
    leaves = [x.float().clone().requires_grad_() for x in ins]
    y, s = plain(*leaves)
    # dy as the kernel path gets it (rounded to the inputs' dtype)
    dy, ds = torch.randn_like(y).to(dtype).float(), torch.randn_like(s)
    want = (y, s) + torch.autograd.grad((y, s), leaves, (dy, ds))
    results = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_() for x in ins]
        fwd0 = (wkv.wkv6_fwd if kind == "wkv6" else tssd.ssd_fwd).launches
        y2, s2 = entry(*leaves)
        assert (wkv.wkv6_fwd if kind == "wkv6" else tssd.ssd_fwd).launches \
            == fwd0 + tiles
        assert y2.dtype == dtype and s2.dtype == torch.float32
        results.append((y2, s2) + torch.autograd.grad(
            (y2, s2), leaves, (dy.to(dtype), ds)))
    f32 = dtype == torch.float32
    tol = dict(atol=1e-4, rtol=1e-4) if f32 else dict(atol=3e-2, rtol=3e-2)
    for g, w in zip(results[0][:2], want[:2]):
        torch.testing.assert_close(g.float(), w.float(), **tol)
    # a gradient summed over tiles carries float32 rounding of its largest
    # summand (a tile's part, which may dwarf a total that cancels), so
    # each is held relative to the larger of its own and its parts' scale
    rel = 1e-4 if f32 else 3e-2
    for i, (g, w) in enumerate(zip(results[0][2:], want[2:])):
        if not f32 and i in low:
            w = w.to(dtype)
        scale = max([w.abs().max().item()] + [p[i] for p in partials])
        assert (g.float() - w.float()).abs().max().item() <= rel * scale, i
    assert all(torch.equal(a, b) for a, b in zip(*results))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_scan_calls_reach_the_cuda_only_refusal(dtype):
    """WKV6 at head size 128 and 100, SSD at (P, N) = (64, 128), (128, 64)
    and (72, 130): forward, backward (with dstate) and the autograd entry
    points get past every shape check to the device check."""
    for d in (128, 100):
        (r, k, v, w, u, s0), dy, ds = (
            [t(x) for x in a] if isinstance(a, tuple) else t(a)
            for a in wkv_inputs((1, 8, 2, d), seed=44))
        r, k, v, u = (x.to(dtype) for x in (r, k, v, u))
        u = u.float()
        with pytest.raises(ValueError, match="CUDA"):
            wkv.wkv6_fwd(r, k, v, w, u, s0, save=True)
        ckpt = tuple(torch.zeros((1, 2, 1, 64, 64))
                     for _ in wkv.tile_plan(d)["launches"])
        with pytest.raises(ValueError, match="CUDA"):
            wkv.wkv6_bwd(r, k, v, w, u, ckpt, dy.to(dtype), ds)
        with pytest.raises(ValueError, match="CUDA"):
            wkv.wkv6(r, k, v, w, u, s0)
    for p, n in ((64, 128), (128, 64), (72, 130)):
        (x, dt, A, Bm, Cm, s0), dy, ds = (
            [t(z) for z in a] if isinstance(a, tuple) else t(a)
            for a in ssd_inputs((1, 8, 2, p, n), seed=45))
        x, Bm, Cm = (z.to(dtype) for z in (x, Bm, Cm))
        with pytest.raises(ValueError, match="CUDA"):
            tssd.ssd_fwd(x, dt, A, Bm, Cm, s0, save=True)
        ckpt = tuple(torch.zeros((1, 2, 1, 64, 64))
                     for _ in tssd.tile_plan(p, n)["launches"])
        with pytest.raises(ValueError, match="CUDA"):
            tssd.ssd_bwd(x, dt, A, Bm, Cm, ckpt, dy.to(dtype), ds)
        with pytest.raises(ValueError, match="CUDA"):
            tssd.mamba2_ssd(x, dt, A, Bm, Cm, s0)


def test_scan_wrappers_check_dstate_before_launch():
    """A dstate of the wrong shape is refused; on a CPU tensor the device
    check comes first."""
    (r, k, v, w, u, s0), dy, ds = (
        [t(x) for x in a] if isinstance(a, tuple) else t(a)
        for a in wkv_inputs((1, 8, 2, 16), seed=46))
    with pytest.raises(ValueError, match="CUDA"):
        wkv.wkv6_bwd(r, k, v, w, u, (torch.zeros((1, 2, 1, 16, 16)),), dy,
                     ds)
