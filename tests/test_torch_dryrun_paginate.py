"""The dry run's model FLOPs and variants, and ``paginate_cache``, against
the reference on the CPU.

* ``launch.dryrun.model_flops`` equal to the reference's for every cell
  of ``all_cells()`` (relative 1e-12);
* ``apply_variant``: each variant's config fields equal to the
  reference's (``capacity_factor`` on the MoE configs, ignored by the
  others), an unknown key refused by name by both; ``--set`` parsed as
  the reference parses it; ``main``'s records carry ``variant`` and
  ``model_flops``, and their parameter bytes and leaves follow the
  layout the variant builds (``fused_gate_up``), against the reference's
  ``param_shapes`` under the same variant;
* ``kernels.paged_attention.paginate_cache``: pools and tables bit for
  bit against the reference's, and the port's plain paged version over
  them against the reference's ``decode_attention_ref`` on the
  contiguous cache (f32, ``tests/test_paged_attention.py``'s tolerance).
"""

import contextlib
import dataclasses
import io
import json
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import get_shape
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import dryrun

PAGED_TOL = dict(atol=3e-6, rtol=1e-5)    # tests/test_paged_attention.py
VARIANT_ARCHS = ("phi3-mini-3.8b", "minicpm3-4b", "deepseek-moe-16b",
                 "qwen2-moe-a2.7b")
VARIANTS = [
    {},
    {"precast_params": True},
    {"seq_parallel": True},
    {"fused_gate_up": True},
    {"capacity_factor": 2.0},
    {"fused_gate_up": True, "capacity_factor": 0.5, "precast_params": False},
]
FUSED = ["--set", "fused_gate_up=1", "--set", "capacity_factor=2.0"]


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module; importing it sets ``XLA_FLAGS`` to
    512 host devices, which is put back so that later tests in this
    process see the flags they started with."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd


def test_all_cells_match_the_reference(jdry):
    assert dryrun.all_cells() == jdry.all_cells()


@pytest.mark.parametrize("cell", dryrun.all_cells(), ids="/".join)
def test_model_flops_match_the_reference(jdry, cell):
    from repro.configs import get_config as jget_config
    from repro.configs import get_shape as jget_shape

    arch, shape = cell
    want = jdry.model_flops(jget_config(arch), jget_shape(shape))
    got = dryrun.model_flops(get_config(arch), get_shape(shape))
    assert isinstance(got, float) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: json.dumps(v))
@pytest.mark.parametrize("arch", VARIANT_ARCHS)
def test_apply_variant_matches_the_reference(jdry, arch, variant):
    from repro.configs import get_config as jget_config

    got = dryrun.apply_variant(get_config(arch), variant)
    want = jdry.apply_variant(jget_config(arch), variant)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for key, value in variant.items():
        if key == "capacity_factor":
            if got.moe is not None:
                assert got.moe.capacity_factor == value
        else:
            assert getattr(got, key) is value


@pytest.mark.parametrize("variant", [{"no_such_flag": True},
                                     {"fused_gate_up": True, "tpx": 2}])
def test_unknown_variant_key_is_refused_by_name(jdry, variant):
    from repro.configs import get_config as jget_config

    bad = next(k for k in variant if k not in ("fused_gate_up",))
    for fn, cfg in ((dryrun.apply_variant, get_config("deepseek-moe-16b")),
                    (jdry.apply_variant, jget_config("deepseek-moe-16b"))):
        with pytest.raises(TypeError, match=bad):
            fn(cfg, variant)
    with pytest.raises(TypeError, match=bad):
        dryrun.main(["--arch", "phi3-mini-3.8b", "--shape", "train_4k"]
                    + [a for k in variant for a in ("--set", f"{k}=1")])


def test_set_flag_parses_as_the_reference():
    assert dryrun.parse_set(["capacity_factor=2", "fused_gate_up=1",
                             "precast_params=0", "seq_parallel=3"]) == {
        "capacity_factor": 2.0, "fused_gate_up": True,
        "precast_params": False, "seq_parallel": True}
    assert isinstance(dryrun.parse_set(["capacity_factor=2"])["capacity_factor"],
                      float)
    assert dryrun.parse_set([]) == {}


def _run_main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        records = dryrun.main(argv)
    printed = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert printed == records
    return records


@pytest.mark.parametrize("arch,shape", [("deepseek-moe-16b", "train_4k"),
                                        ("qwen2-moe-a2.7b", "decode_32k"),
                                        ("phi3-mini-3.8b", "prefill_32k")])
def test_main_records_follow_the_variant(jdry, arch, shape):
    import jax
    from repro.configs import get_config as jget_config
    from repro.configs import get_shape as jget_shape
    from repro.distributed import sharding as jsh
    from repro.models.registry import get_model as jget_model
    from test_torch_launch import _ref_device_bytes

    plain, = _run_main(["--arch", arch, "--shape", shape])
    fused, = _run_main(["--arch", arch, "--shape", shape] + FUSED)
    variant = {"fused_gate_up": True, "capacity_factor": 2.0}
    assert plain["variant"] == {} and fused["variant"] == variant
    mesh = dryrun.make_production_mesh()
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    fake = types.SimpleNamespace(axis_names=mesh.axis_names)
    rules = jsh.DECODE_RULES if get_shape(shape).kind == "decode" else jsh.TRAIN_RULES
    for rec, var in ((plain, {}), (fused, variant)):
        cfg = jdry.apply_variant(jget_config(arch), var)
        assert rec["model_flops"] == jdry.model_flops(cfg, jget_shape(shape))
        cfg = cfg.with_tp(sizes["model"])
        model = jget_model(cfg)
        shapes = model.param_shapes(cfg)
        leaves = jax.tree_util.tree_leaves(shapes)
        assert rec["param_leaves"] == len(leaves)
        assert rec["param_bytes_total"] == sum(
            int(np.prod(s.shape, dtype=np.int64)) * np.dtype(s.dtype).itemsize
            for s in leaves)
        specs = jsh.specs_from_axes(model.param_axes(cfg), rules, fake)
        assert rec["param_bytes_per_device"] == _ref_device_bytes(
            shapes, specs, sizes)
    # gate and up stacked into one leaf: one leaf fewer, the same elements
    moe = get_config(arch).moe is not None
    assert fused["param_leaves"] == plain["param_leaves"] - moe
    assert fused["param_bytes_total"] == plain["param_bytes_total"]


# b, s, hq, hkv, d, dv, page: tests/test_paged_attention.py's cases, and
# one stream of one token, a page of one token, Dv != D and S < page
PAGINATE_CASES = [
    (1, 16, 2, 2, 8, 8, 8),
    (2, 32, 4, 2, 16, 16, 8),
    (3, 24, 4, 1, 8, 8, 8),
    (2, 20, 2, 2, 8, 8, 8),
    (1, 8, 2, 2, 8, 8, 4),
    (4, 37, 8, 2, 12, 12, 16),
    (1, 1, 2, 1, 8, 8, 16),
    (2, 5, 2, 2, 8, 8, 1),
    (2, 13, 4, 2, 8, 6, 4),
    (3, 7, 2, 1, 4, 4, 16),
]


def _contiguous_case(case, seed=0):
    b, s, hq, hkv, d, dv, page = case
    rng = np.random.default_rng(seed + sum(case))
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kc = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, s, hkv, dv)).astype(np.float32)
    lengths = rng.integers(1, s + 1, size=b).astype(np.int32)
    lengths[0] = s
    return q, kc, vc, lengths


@pytest.mark.parametrize("case", PAGINATE_CASES, ids=str)
def test_paginate_cache_matches_the_reference_bit_for_bit(case):
    import jax.numpy as jnp
    from repro.kernels.paged_attention import paginate_cache as jpaginate

    page = case[-1]
    _, kc, vc, _ = _contiguous_case(case)
    got = pa.paginate_cache(torch.from_numpy(kc), torch.from_numpy(vc), page)
    want = jpaginate(jnp.asarray(kc), jnp.asarray(vc), page)
    assert got[2].dtype == torch.int32 and got[2].device == torch.device("cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n_p = got[2].shape[1]
    assert n_p * page - kc.shape[1] < page
    assert not got[0].reshape(case[0], n_p * page, *kc.shape[2:])[
        :, kc.shape[1]:].any()                  # the padding is zeros


@pytest.mark.parametrize("case", [c for c in PAGINATE_CASES if c[4] == c[5]],
                         ids=str)
def test_plain_paged_over_paginated_pools_matches_contiguous_reference(case):
    import jax.numpy as jnp
    from repro.kernels.ref import decode_attention_ref as jdecode

    q, kc, vc, lengths = _contiguous_case(case, seed=7)
    kp, vp, table = pa.paginate_cache(torch.from_numpy(kc),
                                      torch.from_numpy(vc), case[-1])
    qt, lt = torch.from_numpy(q), torch.from_numpy(lengths)
    got = ops.paged_attention(qt, kp, vp, table, lt)
    want = jdecode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                   jnp.asarray(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PAGED_TOL)
    # the port's own contiguous oracle agrees too
    from repro_torch.kernels.ref import decode_attention_ref
    np.testing.assert_allclose(
        got.numpy(), decode_attention_ref(qt, torch.from_numpy(kc),
                                          torch.from_numpy(vc), lt).numpy(),
        **PAGED_TOL)
