"""OmpSs-style resilient tasks: the port against the reference.

Each case of ``tests/test_tasks.py`` runs on both packages with the same
armed failures: the outputs must be equal and the ``TaskStats`` equal
field for field (``wall_s`` aside).  Then what JAX hides: a task that
mutates its inputs in place is retried from its launch inputs, and the
snapshot is a copy.  A journal written by either package replays in the
other (float32 and int32 results).  Last, fig10's FWI proxy
(``benchmarks/fig10_task_resilience.py``, written here in torch): the
three scenarios' final sums against the jnp run at rtol 1e-5, and the
resilient run equal to the clean one bit for bit within the port.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.cluster.topology import NodeFailure as TNodeFailure
from repro_torch.cluster.topology import NodeState as TNodeState
from repro_torch.cluster.topology import VirtualCluster as TCluster
from repro_torch.core import TaskError as TTaskErrorExport
from repro_torch.core.tasks import TaskError as TTaskError
from repro_torch.core.tasks import TaskRuntime as TRuntime
from repro_torch.core.tasks import TaskStats as TStats
from repro_torch.memory.tiers import MemoryTier as TTier
from repro_torch.memory.tiers import TierKind as TKind
from repro_torch.memory.tiers import TierSpec as TSpec

FWI_RTOL = 1e-5
N_CYCLES, GRID = 8, 96


def _jax_pkg(root):
    from repro.cluster.topology import NodeState, VirtualCluster
    from repro.core.tasks import TaskError, TaskRuntime
    from repro.memory.tiers import MemoryTier, TierKind, TierSpec
    return types.SimpleNamespace(
        name="jax", cluster=VirtualCluster(n_cluster=4, n_booster=4,
                                           root=root / "jrun", xor_group_size=4),
        Runtime=TaskRuntime, TaskError=TaskError, NodeState=NodeState,
        tier=lambda d=None: MemoryTier(TierSpec(TierKind.GLOBAL, 10**9, 1e9,
                                                1e9, 0), backing_dir=d),
        ones=lambda n: jnp.ones((n,)), zeros=lambda n: jnp.zeros((n,)),
        arr=jnp.asarray)


def _torch_pkg(root):
    return types.SimpleNamespace(
        name="torch", cluster=TCluster(n_cluster=4, n_booster=4,
                                       root=root / "trun", xor_group_size=4),
        Runtime=TRuntime, TaskError=TTaskError, NodeState=TNodeState,
        tier=lambda d=None: TTier(TSpec(TKind.GLOBAL, 10**9, 1e9, 1e9, 0),
                                  backing_dir=d),
        ones=lambda n: torch.ones((n,)), zeros=lambda n: torch.zeros((n,)),
        arr=torch.as_tensor)


@pytest.fixture
def pkgs(tmp_path):
    """Both packages, each with its own ``tmp_cluster``-style cluster
    (4 + 4 nodes, XOR groups of 4)."""
    made = [_jax_pkg(tmp_path), _torch_pkg(tmp_path)]
    yield made
    for p in made:
        p.cluster.teardown()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return np.asarray(x)


def _stats(rt):
    d = dataclasses.asdict(rt.stats)
    d.pop("wall_s")
    return d


# the seven cases of tests/test_tasks.py, each written once for either package


def case_runs_and_returns(p):
    rt = p.Runtime(p.cluster)
    return rt.run("t", lambda x: x + 1, p.ones(3)), rt, {}


def case_retries_on_armed_failure(p):
    rt = p.Runtime(p.cluster, max_retries=2)
    p.cluster.arm_failure(5, p.NodeState.FAILED_TRANSIENT)
    out = rt.run("t", lambda x: x * 2, p.ones(2), rank=5)
    return out, rt, {"up": p.cluster.node(5).is_up}


def case_gives_up_after_budget(p):
    rt = p.Runtime(p.cluster, max_retries=1)

    def always_fail(x):
        p.cluster.arm_failure(3, p.NodeState.FAILED_TRANSIENT)
        p.cluster.maybe_fail(3)
        return x

    p.cluster.arm_failure(3, p.NodeState.FAILED_TRANSIENT)
    with pytest.raises(p.TaskError):
        rt.run("t", always_fail, p.ones(1), rank=3)
    return np.zeros(0), rt, {}


def case_snapshot_isolates_inputs(p):
    rt = p.Runtime(p.cluster)
    x = np.ones((4,))
    out = rt.run("t", lambda a: a.sum(), x)
    x[:] = 100.0
    return out, rt, {"x": float(x[0])}


def case_journal_fast_forward(p):
    tier = p.tier()
    rt = p.Runtime(p.cluster, journal_tier=tier)
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    out1 = rt.run("step0", fn, p.zeros(2), persistent=True)
    rt2 = p.Runtime(p.cluster, journal_tier=tier)
    out2 = rt2.run("step0", fn, p.zeros(2), persistent=True)
    assert np.array_equal(_np(out1), _np(out2))
    return out2, rt2, {"calls": len(calls), "first": _stats(rt)}


def case_offload_group_isolation(p):
    rt = p.Runtime(p.cluster, max_retries=2)
    p.cluster.arm_failure(6, p.NodeState.FAILED_TRANSIENT)
    results = rt.offload_group([
        ("a", lambda x: x + 1, (p.zeros(2),), 4),
        ("b", lambda x: x + 2, (p.zeros(2),), 6),
        ("c", lambda x: x + 3, (p.zeros(2),), 7),
    ])
    return results, rt, {"firsts": [float(r[0]) for r in results]}


def case_clear_journal(p):
    tier = p.tier()
    rt = p.Runtime(p.cluster, journal_tier=tier)
    rt.run("x", lambda: 1, persistent=True)
    before = list(tier.keys())
    rt.clear_journal()
    return np.zeros(0), rt, {"before": before, "after": list(tier.keys())}


CASES = [case_runs_and_returns, case_retries_on_armed_failure,
         case_gives_up_after_budget, case_snapshot_isolates_inputs,
         case_journal_fast_forward, case_offload_group_isolation,
         case_clear_journal]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_reference_cases_on_both_packages(case, pkgs):
    """Outputs equal, stats equal field for field (``wall_s`` aside), and
    what each case checks besides (nodes recovered, calls made, keys
    left) equal."""
    got = {p.name: case(p) for p in pkgs}
    (jo, jrt, jx), (to, trt, tx) = got["jax"], got["torch"]
    jo, to = _np(jo), _np(to)
    if isinstance(jo, list):
        assert len(jo) == len(to)
        for a, b in zip(jo, to):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(jo, to)
    assert _stats(jrt) == _stats(trt)
    assert jx == tx


def test_stats_fields_match_the_reference():
    from repro.core.tasks import TaskStats as JStats
    assert [f.name for f in dataclasses.fields(JStats)] == \
        [f.name for f in dataclasses.fields(TStats)]
    assert TTaskErrorExport is TTaskError


def test_in_place_task_is_retried_from_its_launch_inputs(tmp_path):
    """A task that mutates its inputs in place and then fails: the retry
    sees the inputs as they were at launch, and the caller's tensors are
    never touched."""
    cl = TCluster(n_cluster=4, n_booster=4, root=tmp_path / "run",
                  xor_group_size=4)
    rt = TRuntime(cl, max_retries=2)
    x = torch.arange(4, dtype=torch.float32)
    tree = {"a": torch.ones(2, dtype=torch.int32), "n": 3}
    seen = []

    def task(v, t):
        seen.append((v.clone(), t["a"].clone()))
        v.mul_(10)
        t["a"].add_(5)
        if len(seen) == 1:
            cl.arm_failure(2, TNodeState.FAILED_TRANSIENT)
            cl.maybe_fail(2)
        return v + t["n"], t["a"]

    out, a = rt.run("mut", task, x, tree)
    assert rt.stats.retried == 1 and rt.stats.completed == 1
    assert torch.equal(seen[0][0], seen[1][0]) and torch.equal(seen[0][1],
                                                               seen[1][1])
    assert torch.equal(x, torch.arange(4, dtype=torch.float32))
    assert torch.equal(tree["a"], torch.ones(2, dtype=torch.int32))
    assert torch.equal(out, torch.arange(4, dtype=torch.float32) * 10 + 3)
    assert torch.equal(a, torch.full((2,), 6, dtype=torch.int32))
    cl.teardown()


def test_snapshot_copies_tensors_and_numpy(tmp_path):
    """A CPU tensor's snapshot is a copy (``.cpu()`` would be the tensor
    itself) and so is a numpy leaf's (``torch.as_tensor`` would share its
    memory); other leaves pass through; ``requires_grad`` is kept."""
    from repro_torch.core import tasks

    t = torch.ones(3, requires_grad=True)
    a = np.ones(2)
    snap = tasks._snapshot((t, a, "tag", 7))
    held = snap[0]
    assert held.host.data_ptr() != t.data_ptr() and held.device == t.device
    assert snap[1] is not a and snap[2] == "tag" and snap[3] == 7
    with torch.no_grad():
        t.mul_(5)
    a[:] = 9
    fresh = tasks._attempt_inputs(snap)
    assert torch.equal(fresh[0], torch.ones(3)) and fresh[0].requires_grad
    assert np.array_equal(fresh[1], np.ones(2))
    again = tasks._attempt_inputs(snap)
    assert again[0].data_ptr() != fresh[0].data_ptr()


def test_journal_refuses_bfloat16_by_name(tmp_path):
    tier = TTier(TSpec(TKind.GLOBAL, 10**9, 1e9, 1e9, 0))
    rt = TRuntime(None, journal_tier=tier)
    with pytest.raises(TypeError, match="bfloat16"):
        rt.run("b", lambda x: x * 2, torch.ones(2, dtype=torch.bfloat16),
               persistent=True)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_replays_across_packages(writer, dtype, tmp_path):
    """A journal written by one package (a backing directory) fast-forwards
    a fresh runtime of the other: the task is not run, the value equal,
    in the replaying package's kind (a tensor for the port)."""
    from repro.core.tasks import TaskRuntime as JRuntime
    from repro.memory.tiers import MemoryTier as JTier
    from repro.memory.tiers import TierKind as JKind
    from repro.memory.tiers import TierSpec as JSpec

    rng = np.random.default_rng(7)
    x = (rng.normal(size=(3, 5)) * 100).astype(dtype)
    fn = lambda v: v * 3 + 1
    d = tmp_path / "journal"
    jt = JTier(JSpec(JKind.GLOBAL, 10**9, 1e9, 1e9, 0), backing_dir=d)
    tt = TTier(TSpec(TKind.GLOBAL, 10**9, 1e9, 1e9, 0), backing_dir=d)
    jx, tx = jnp.asarray(x), torch.from_numpy(x.copy())
    first = (JRuntime(None, journal_tier=jt).run("t", fn, jx, persistent=True)
             if writer == "jax" else
             TRuntime(None, journal_tier=tt).run("t", fn, tx, persistent=True))
    calls = []

    def never(v):
        calls.append(1)
        return v

    if writer == "jax":
        rt = TRuntime(None, journal_tier=tt)
        got = rt.run("t", never, tx, persistent=True)
        assert isinstance(got, torch.Tensor) and got.device == tx.device
        assert str(got.dtype) == f"torch.{dtype}"
    else:
        rt = JRuntime(None, journal_tier=jt)
        got = rt.run("t", never, jx, persistent=True)
        assert np.asarray(got).dtype == np.dtype(dtype)
    assert calls == [] and rt.stats.replayed == 1
    np.testing.assert_array_equal(_np(got), _np(first))
    np.testing.assert_array_equal(_np(got), fn(x))


# fig10's FWI proxy


@jax.jit
def _jfwi_cycle(model, freq):
    def body(m, _):
        lap = (jnp.roll(m, 1, 0) + jnp.roll(m, -1, 0)
               + jnp.roll(m, 1, 1) + jnp.roll(m, -1, 1) - 4 * m)
        return m + 0.2 * lap + 0.01 * jnp.sin(freq * m), None
    model, _ = jax.lax.scan(body, model, None, length=20)
    return model


def _tfwi_cycle(model, freq):
    """fig10's toy frequency sweep: 20 Jacobi smoothing passes."""
    m = model
    for _ in range(20):
        lap = (torch.roll(m, 1, 0) + torch.roll(m, -1, 0)
               + torch.roll(m, 1, 1) + torch.roll(m, -1, 1) - 4 * m)
        m = m + 0.2 * lap + 0.01 * torch.sin(freq * m)
    return m


def _scenario(p, cycle_fn, start, freq, fail_task, resilient):
    """fig10's ``run_scenario``: -> (final model, stats, restarts)."""
    rt = p.Runtime(p.cluster, max_retries=3 if resilient else 0)
    model, restarts, cycle = start(), 0, 0
    while cycle < N_CYCLES:
        try:
            if fail_task is not None and cycle == fail_task:
                p.cluster.arm_failure(5, p.NodeState.FAILED_TRANSIENT)
                fail_task = None
            model = rt.run(f"cycle{cycle}_{restarts}", cycle_fn, model,
                           freq(cycle + 1), rank=5)
            cycle += 1
        except Exception:
            p.cluster.recover(5)
            model, cycle = start(), 0
            restarts += 1
    return model, rt.stats, restarts


def test_fig10_scenarios_match_the_reference(pkgs):
    """Clean, resilient (a failure at the last cycle) and no resiliency
    (a full restart): the port's final sums within rtol 1e-5 of the jnp
    run's, the resilient model equal to the clean one bit for bit, one
    retry in the resilient run and one restart without resiliency."""
    jp, tp = pkgs
    jstart = lambda: jnp.ones((GRID, GRID)) * 0.5
    tstart = lambda: torch.ones((GRID, GRID)) * 0.5
    sums, models, retried = {}, {}, {}
    for label, fail, res in (("clean", None, True),
                             ("resilient", N_CYCLES - 1, True),
                             ("restart", N_CYCLES - 1, False)):
        jm, jst, jr = _scenario(jp, _jfwi_cycle, jstart, jnp.float32,
                                fail, res)
        tm, tst, tr = _scenario(tp, _tfwi_cycle, tstart,
                                lambda c: torch.tensor(c, dtype=torch.float32),
                                fail, res)
        assert dataclasses.asdict(jst) | {"wall_s": 0} == \
            dataclasses.asdict(tst) | {"wall_s": 0}
        assert jr == tr == (1 if label == "restart" else 0)
        sums[label] = (float(jnp.sum(jm)), float(tm.sum()))
        models[label], retried[label] = tm, tst.retried
        np.testing.assert_allclose(sums[label][1], sums[label][0],
                                   rtol=FWI_RTOL)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=FWI_RTOL,
                                   atol=1e-6)
    assert torch.equal(models["resilient"], models["clean"])
    assert torch.equal(models["restart"], models["clean"])
    assert retried == {"clean": 0, "resilient": 1, "restart": 1}


def test_only_node_failures_are_retried():
    """Only a ``NodeFailure`` is retried: any other exception leaves the
    runtime at once, counted as launched and not completed."""
    rt = TRuntime(None, max_retries=3)

    def boom(x):
        raise ValueError("not a node failure")

    with pytest.raises(ValueError):
        rt.run("v", boom, torch.ones(1))
    assert (rt.stats.launched, rt.stats.completed, rt.stats.retried) == (1, 0, 0)
    assert issubclass(TNodeFailure, RuntimeError)
