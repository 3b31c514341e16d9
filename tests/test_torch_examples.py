"""The port's training and offload examples against the reference's.

``examples/torch_quickstart.py``, ``examples/torch_fault_tolerant_train.py``
and ``examples/torch_xpic_offload.py`` keep their counterparts' flows and
printed lines.  Each example is loaded by path (its ``main`` does not run
on import); the quickstart and xPic run in-process with ``--device cpu``
beside the reference examples, with their output captured, and the
fault-tolerant example is held by its configurations (its run by
``chip_smoke.py`` phase 22 (d)).  The two packages' weights and initial
positions come from different PRNGs, so losses and energies of whole
runs are compared within a package (they must fall, or agree with the
example's own asserts), and every printed count across packages.
"""

import contextlib
import dataclasses
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
# float32 sums of 4,160 squares and a scatter-add of 4,096 velocities in
# other orders (tests/test_torch_offload.py)
ENERGY_TOL = dict(rtol=1e-5, atol=0)


def load(name: str):
    """``examples/<name>.py`` as a module, without running its ``main``."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(mod, argv=None):
    """``mod.main`` with its standard output captured: (its return value,
    the printed lines).  The reference's ``main`` takes no arguments and
    reads ``sys.argv``.  torch runs on one thread meanwhile: the suite's
    workers share the host's cores."""
    import torch

    buf = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(buf):
            out = mod.main() if argv is None else mod.main(argv)
    finally:
        torch.set_num_threads(threads)
    return out, buf.getvalue().splitlines()


def without(lines, *prefixes):
    return [ln for ln in lines if not ln.startswith(prefixes)]


def losses_fall(lines):
    (line,) = [ln for ln in lines if ln.startswith("loss first -> last")]
    first, last = map(float, re.findall(r"-?\d+\.\d+", line))
    return last < first


def test_quickstart_prints_the_reference_counts(monkeypatch):
    """Steps run (37: 30 and the 7 replayed after the recovery), one
    failure, one recovery from step 10, three checkpoints all drained:
    the same lines from both packages, and both losses fall."""
    monkeypatch.setattr(sys, "argv", ["quickstart.py"])
    _, ref = run_main(load("quickstart"))
    got, port = run_main(load("torch_quickstart"), ["--device", "cpu"])
    assert without(port, "loss") == without(ref, "loss")
    assert "steps run           : 37" in port
    assert "recoveries          : 1 (restarted from step [10])" in port
    assert losses_fall(ref) and losses_fall(port)
    assert (got["recoveries"], got["checkpoints"], got["drains_completed"]) == (
        1, 3, 3)


@pytest.mark.parametrize("hundred_m", [False, True])
def test_fault_tolerant_build_cfg_matches_reference(hundred_m):
    """The example's two configurations, field by field.  Its 30-step run
    (40 steps of a 20M model) is held on the card by ``chip_smoke.py``
    phase 22 (d), against the reference's printout at those settings (2 /
    2 recoveries from steps [0, 20], 2 checkpoints): on the CPU it takes
    minutes of a test suite that shares the host's cores."""
    ref, port = load("fault_tolerant_train"), load("torch_fault_tolerant_train")
    a, b = ref.build_cfg(hundred_m), port.build_cfg(hundred_m)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.param_count() == b.param_count()
    assert (b.n_layers, b.d_model) == ((12, 768) if hundred_m else (6, 384))


def xpic_inputs():
    rng = np.random.default_rng(0)
    return (rng.uniform(size=4096).astype(np.float32),
            np.zeros(4096, np.float32),
            np.sin(np.linspace(0, 6.28, 64)).astype(np.float32),
            np.zeros(64, np.float32))


def test_xpic_solvers_match_reference():
    """``field_solve`` and ``particle_push`` of both examples on the same
    numpy inputs for 8 steps: energies within float32 tolerance, the
    particles in the same cells."""
    import jax.numpy as jnp
    import torch

    ref, port = load("xpic_offload"), load("torch_xpic_offload")
    assert (ref.GRID, ref.N_PART, ref.DT) == (port.GRID, port.N_PART, port.DT)
    jp, jv, je, jc = (jnp.asarray(a) for a in xpic_inputs())
    tp, tv, te, tc = (torch.from_numpy(a) for a in xpic_inputs())
    jen, ten = [], []
    for _ in range(8):
        je = ref.field_solve(je, jc)
        jp, jv, jc = ref.particle_push(jp, jv, je)
        te = port.field_solve(te, tc)
        tp, tv, tc = port.particle_push(tp, tv, te)
        jen.append(float(jnp.sum(jv ** 2) + jnp.sum(je ** 2)))
        ten.append(float((tv ** 2).sum() + (te ** 2).sum()))
    np.testing.assert_allclose(ten, jen, **ENERGY_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    cells = lambda p: (np.asarray(p) * 64).astype(np.int32) % 64
    assert (cells(tp.numpy()) == cells(jp)).mean() > 0.999


def test_xpic_task_counts_match_reference():
    """18 tasks launched, 2 retried (a transient Booster failure armed
    before the loop and one armed in step 3), 0 replayed, 0 failed; the
    fresh runtime replays the journaled field task: both OK lines."""
    _, ref = run_main(load("xpic_offload"))
    got, port = run_main(load("torch_xpic_offload"), ["--device", "cpu"])
    assert without(port, "field energy") == without(ref, "field energy")
    assert "tasks launched       : 18 (retried 2, replayed 0, failed 0)" in port
    assert (got["launched"], got["retried"], got["replayed"], got["failed"],
            got["replayed_after_crash"]) == (18, 2, 0, 0, 1)
    assert got["device"] == "cpu"
