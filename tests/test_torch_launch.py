"""The launchers against the reference's.

* ``launch.mesh``: the four builders' shapes and axis names against the
  reference's ``jax.make_mesh`` meshes (a subprocess with 512 forced host
  devices); building the port's touches no process group.
* ``launch.train`` on the CPU (``--device cpu``; reduced phi3,
  ``--steps 6 --fail-at 3 --ckpt-every 2``) against the reference's
  launcher in a subprocess, both at float32 compute from the reference's
  initial train state (carried across with
  ``convert.train_state_from_numpy`` in place of the port trainer's own
  draw): the same JSON keys; steps_run, failures, recoveries,
  restarts_from_step and checkpoints equal; first and last loss within
  ``tests/test_torch_train.py``'s ``LOGIT_TOL`` (``atol=1e-5``).
* ``launch.dryrun`` on the meta device: for every config at the
  production mesh, per-device parameter bytes (``TRAIN_RULES`` for train
  and prefill, ``DECODE_RULES`` for decode) equal the reference's
  ``param_shapes`` + ``specs_from_axes`` arithmetic, computed here with
  numpy (no compile).
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
ARGS = ["--arch", "phi3-mini-3.8b", "--steps", "6", "--fail-at", "3",
        "--ckpt-every", "2"]
LOSS_TOL = dict(atol=1e-5, rtol=0)        # test_torch_train.LOGIT_TOL

MESHES = r"""
import json
import jax
from repro.launch.mesh import make_production_mesh, make_test_mesh
out = {}
for name, fn in (("production", make_production_mesh), ("test", make_test_mesh)):
    for mp in (False, True):
        m = fn(multi_pod=mp)
        out[f"{name}{int(mp)}"] = [list(m.devices.shape), list(m.axis_names)]
print(json.dumps(out))
"""


def test_launch_mesh_matches_the_reference():
    from repro_torch.launch import mesh as tm
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", MESHES], capture_output=True,
                         text=True, env=env, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    for name, fn in (("production", tm.make_production_mesh),
                     ("test", tm.make_test_mesh)):
        for mp in (False, True):
            m = fn(multi_pod=mp)
            assert [list(m.shape), list(m.axis_names)] == want[f"{name}{int(mp)}"]
            assert m.size == int(np.prod(m.shape))


REF_TRAIN = r"""
import dataclasses, sys
import jax, numpy as np
from repro.configs import get_config
from repro.launch import train as lt
from repro.models.registry import get_model
from repro.train import step as S
sys.path.insert(0, sys.argv[2])
from test_torch_seqpar import flatten
cfg = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(),
                          compute_dtype="float32")
state = jax.device_get(S.init_train_state(jax.random.PRNGKey(0), cfg,
                                          get_model(cfg)))
np.savez(sys.argv[1], step=np.asarray(state["step"]),
         **{"params/" + k: v for k, v in flatten(state["params"]).items()},
         **{"opt/m/" + k: v for k, v in flatten(state["opt"]["m"]).items()},
         **{"opt/v/" + k: v for k, v in flatten(state["opt"]["v"]).items()})
plain = lt.get_config
lt.get_config = lambda arch: dataclasses.replace(plain(arch),
                                                 compute_dtype="float32")
sys.argv = ["train"] + sys.argv[3:]
lt.main()
"""


def report(text):
    return json.loads(text[text.index("{"):])


@pytest.fixture(scope="module")
def reference_launch(tmp_path_factory):
    root = tmp_path_factory.mktemp("launch_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", REF_TRAIN, str(root / "state.npz"),
         str(Path(__file__).parent)] + ARGS + ["--run-dir", str(root / "run")],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return report(out.stdout), root / "state.npz"


def test_launch_train_matches_the_reference(reference_launch, tmp_path,
                                            monkeypatch):
    from test_torch_seqpar import unflatten
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.launch import train as lt
    from repro_torch.train import trainer as tr

    want, state_path = reference_launch
    flat = dict(np.load(state_path))
    state = unflatten({k: v for k, v in flat.items() if k != "step"})
    state["step"] = flat["step"]
    plain = lt.get_config
    monkeypatch.setattr(lt, "get_config", lambda arch: dataclasses.replace(
        plain(arch), compute_dtype="float32"))
    monkeypatch.setattr(tr, "init_train_state",
                        lambda seed, cfg, model, device: train_state_from_numpy(
                            state, cfg, device=device))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lt.main(ARGS + ["--device", "cpu", "--run-dir", str(tmp_path / "run")])
    got = report(buf.getvalue())
    assert list(got) == list(want)
    for key in ("arch", "steps_run", "failures", "recoveries",
                "restarts_from_step", "checkpoints"):
        assert got[key] == want[key], key
    assert got["failures"] == 1 and got["recoveries"] == 1
    for key in ("first_loss", "last_loss"):
        np.testing.assert_allclose(got[key], want[key], **LOSS_TOL, err_msg=key)


def _ref_device_bytes(shapes, specs, sizes):
    import jax
    total = 0
    for sds, spec in zip(jax.tree_util.tree_leaves(shapes),
                         jax.tree_util.tree_leaves(
                             specs, is_leaf=lambda x: isinstance(x, tuple))):
        dims = list(sds.shape)
        for i, entry in enumerate(tuple(spec)):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            n = int(np.prod([sizes[a] for a in names]))
            dims[i] = -(-dims[i] // n)
        total += int(np.prod(dims, dtype=np.int64)) * np.dtype(sds.dtype).itemsize
    return total


def test_meta_dryrun_param_bytes_match_the_reference_arithmetic():
    from repro.configs import REGISTRY as JREG
    from repro.configs import get_config as jget_config
    from repro.distributed import sharding as jsh
    from repro.models.registry import get_model as jget_model
    from repro_torch.configs.shapes import shapes_for
    from repro_torch.launch import dryrun

    mesh = dryrun.make_production_mesh()
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    fake = types.SimpleNamespace(axis_names=mesh.axis_names)
    records = {(r["arch"], r["shape"]): r
               for r in (dryrun.meta_cell(a, s, mesh)
                         for a, s in dryrun.all_cells())}
    assert len(records) == sum(len(shapes_for(c.family)) for c in JREG.values())
    for arch in sorted(JREG):
        cfg = jget_config(arch).with_tp(sizes["model"])
        model = jget_model(cfg)
        for shape in shapes_for(cfg.family):
            rules = jsh.DECODE_RULES if shape.kind == "decode" else jsh.TRAIN_RULES
            specs = jsh.specs_from_axes(model.param_axes(cfg), rules, fake)
            want = _ref_device_bytes(model.param_shapes(cfg), specs, sizes)
            rec = records[(arch, shape.name)]
            assert rec["param_bytes_per_device"] == want, (arch, shape.name)
            if shape.kind == "train":
                assert rec["opt_bytes_per_device"] == 2 * want
