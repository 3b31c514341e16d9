"""The MoE island on a mesh, and the data-parallel train step, against the
reference.

Reduced qwen2-moe-a2.7b (gated shared experts) and deepseek-moe-16b (a
dense layer first) at ``tp=2`` and float32 compute, on a (data 2 x model
2) mesh.  The reference runs in a subprocess on forced host devices: its
weights (key 0), ``moe_ffn`` of the first MoE layer on a seeded
(4, 16, d_model) input with and without its ``shard_map`` island, and 2
AdamW steps on 4 x 16 token batches from the data pipeline, both on the
whole batch without a mesh and jitted with the mesh (without remat, to
compile less; the port's steps recompute each layer, so its collectives
run again inside the backward).  The port runs one
spawned gloo world of 4 CPU ranks with the same weights
(``convert.params_from_numpy``), each rank holding its block of the
experts' hidden dims (``moe.island_params``):

* ``moe_ffn`` with the mesh: each rank's rows against the reference's
  island and against the no-mesh call (``LOGIT_TOL``: the two blocks of
  each expert's hidden dim are summed over ``model``); the aux loss is
  the whole batch's on every rank;
* ``make_train_step`` with the mesh, 2 steps: loss and router aux per
  step against the reference's no-mesh steps on the whole batch
  (``LOGIT_TOL``; the aux from density and mean probability averaged over
  the data ranks before their product), the parameters (experts'
  blocks put back together) within ``param_tol(2)`` of the family checks
  and AdamW's first moment within ``MOMENT_TOL`` (the gradients clipped
  by their global norm over every rank's blocks);
* the gradients of the first batch, averaged over the data ranks,
  against ``jax.grad`` of the reference's loss without a mesh and through
  its jitted island (``GRAD_TOL``); the reference's mesh gradient equals
  its no-mesh gradient (no factor of ``tp``);
* against the reference's jitted mesh step: the same losses and aux;
* two mesh runs end on one SHA-256 of every rank's state.

Spawned ranks import this module, so the reference is imported only
inside the subprocess.
"""

import hashlib
import multiprocessing as mp
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120
WORLD = 4
ARCHS = ("qwen2-moe-a2.7b", "deepseek-moe-16b")
STEPS = 2
BATCH, SEQ = 4, 16
OPT = dict(lr=1e-3, warmup_steps=2)
LOGIT_TOL = dict(atol=5e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-5, rtol=1e-4)
PARAM_TOL = dict(atol=0.1 * OPT["lr"] * STEPS, rtol=1e-4)
# AdamW's first moment after 2 steps: (1 - b1) (b1 g1 + g2), the gradients'
# tolerance times ~0.2, each gradient scaled by the global-norm clip (the
# norm over every rank's blocks of the experts, not this rank's alone)
MOMENT_TOL = dict(atol=1e-5, rtol=1e-4)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def config(get_config, arch):
    import dataclasses
    return dataclasses.replace(get_config(arch).reduced(), tp=2,
                               compute_dtype="float32")


REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, sys.argv[2])
from test_torch_moe_mesh import ARCHS, BATCH, OPT, SEQ, STEPS, config, flatten
from repro.configs import get_config
from repro.data.pipeline import TokenPipeline
from repro.models import moe as M
from repro.models.registry import get_model
from repro.optim.adamw import AdamWConfig
from repro.train import step as S
from jax.sharding import Mesh
out = {}
# Auto axes, as the reference's jit shardings assume (jax.make_mesh's
# explicit axes refuse the head's batch-sharded contraction)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
for arch in ARCHS:
    cfg = config(get_config, arch)
    model = get_model(cfg)
    state = S.init_train_state(jax.random.PRNGKey(0), cfg, model)
    out.update({arch + ":p:" + k: v for k, v in flatten(state["params"]).items()})
    x = np.random.default_rng(1).normal(size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
    out[arch + ":x"] = x
    p0 = jax.tree_util.tree_map(lambda a: a[0], state["params"]["moe_layers"]["moe"])
    y, aux = M.moe_ffn(p0, x, cfg)
    out[arch + ":y"], out[arch + ":aux"] = np.asarray(y), np.asarray(aux)
    with mesh:
        y, aux = jax.jit(lambda p, x: M.moe_ffn(p, x, cfg, mesh=mesh))(p0, x)
    out[arch + ":y_mesh"], out[arch + ":aux_mesh"] = np.asarray(y), np.asarray(aux)
    pipe = TokenPipeline(cfg.vocab_size, BATCH, SEQ)
    batches = [pipe.batch_at(i) for i in range(STEPS)]
    for i, b in enumerate(batches):
        for k, v in b.items():
            out[f"{arch}:batch{i}:{k}"] = v
    for tag, m in (("nm", None), ("ms", mesh)):
        grad = jax.jit(jax.grad(lambda p, b: S.make_loss_fn(cfg, model, mesh=m, remat=False)(p, b)[0]))
        if m is None:
            g = grad(state["params"], batches[0])
        else:
            with m:
                g = grad(state["params"], batches[0])
        out.update({f"{arch}:{tag}:g:" + k: v
                    for k, v in flatten(jax.device_get(g)).items()})
        step = jax.jit(S.make_train_step(cfg, model, AdamWConfig(**OPT), mesh=m,
                                         remat=False))
        st = state
        for i, b in enumerate(batches):
            if m is None:
                st, met = step(st, b)
            else:
                with m:
                    st, met = step(st, b)
            out[f"{arch}:{tag}:loss{i}"] = np.asarray(met["loss"])
            out[f"{arch}:{tag}:aux{i}"] = np.asarray(met["router_aux"])
        out.update({f"{arch}:{tag}:p:" + k: v
                    for k, v in flatten(jax.device_get(st["params"])).items()})
        out.update({f"{arch}:{tag}:m:" + k: v
                    for k, v in flatten(jax.device_get(st["opt"]["m"])).items()})
np.savez(sys.argv[1], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_mesh_ref") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(path),
                          str(Path(__file__).parent)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


def state_sha(state) -> str:
    from repro_torch.optim.adamw import tree_leaves
    h = hashlib.sha256()
    for leaf in tree_leaves(state):
        h.update(leaf.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _rank_main(rank, ref_path, store_path, out_dir):
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train import step as S

    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=TIMEOUT_S))
    ref = dict(np.load(ref_path))
    out = {}
    try:
        mesh = make_test_mesh()
        for arch in ARCHS:
            cfg = config(get_config, arch)
            model = get_model(cfg)
            flat = {k.split(":", 2)[2]: v for k, v in ref.items()
                    if k.startswith(arch + ":p:")}
            params = M.island_params(
                params_from_numpy(unflatten(flat), cfg, device="cpu"), cfg, mesh)
            x = torch.from_numpy(ref[arch + ":x"])
            p0 = L.index_tree(params["moe_layers"]["moe"], 0)
            with torch.no_grad():
                y, aux = M.moe_ffn(p0, mesh.shard_rows(x), cfg, mesh=mesh)
            out[arch + ":y"], out[arch + ":aux"] = y.numpy(), aux.numpy()
            batches = [{k: torch.from_numpy(ref[f"{arch}:batch{i}:{k}"])
                        for k in ("tokens", "labels")} for i in range(STEPS)]
            loss_fn = S.make_loss_fn(cfg, model, mesh=mesh)
            _, _, grads = S._value_and_grad(loss_fn, params, batches[0])
            grads = C.average_gradients(grads, mesh.group("data"))
            out.update({f"{arch}:g:{k}": v for k, v in flatten(grads).items()})
            step = S.make_train_step(cfg, model, AdamWConfig(**OPT), mesh=mesh)
            shas = []
            for run in range(2):
                state = {"params": params, "opt": adamw_init(params),
                         "step": torch.zeros((), dtype=torch.int32)}
                for i, b in enumerate(batches):
                    state, met = step(state, b)
                    if run == 0:
                        out[f"{arch}:loss{i}"] = met["loss"].numpy()
                        out[f"{arch}:aux{i}"] = met["router_aux"].numpy()
                shas.append(state_sha(state))
            out[arch + ":sha"] = np.array(shas)
            out.update({f"{arch}:p:{k}": v
                        for k, v in flatten(state["params"]).items()})
            out.update({f"{arch}:m:{k}": v
                        for k, v in flatten(state["opt"]["m"]).items()})
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"{rank}.npz"), **out)


@pytest.fixture(scope="module")
def results(reference, tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_mesh_world")
    ref_path = root / "ref.npz"
    np.savez(ref_path, **reference)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(ref_path), str(root / "store"), str(root)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return {r: dict(np.load(root / f"{r}.npz")) for r in range(WORLD)}


def whole_params(results, arch, tag="p"):
    """The parameters put back together: each leaf sharded over ``model``
    (a ``d_expert`` or shared ``d_ff`` axis of the MoE layers) from the
    blocks of ranks (0, 0) and (0, 1), the others from rank 0."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    cfg = config(get_config, arch)
    axes = flatten_axes(get_model(cfg).param_axes(cfg))
    out = {}
    for key, names in axes.items():
        a, b = results[0][f"{arch}:{tag}:{key}"], results[1][f"{arch}:{tag}:{key}"]
        dims = [d for d, n in enumerate(names) if key.startswith("moe_layers/moe/")
                and n in ("d_expert", "d_ff")]
        out[key] = np.concatenate([a, b], axis=dims[0]) if dims else a
    return out


def flatten_axes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_axes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_island_matches_reference(arch, results, reference):
    """Each rank's rows of the island's output equal the reference's
    ``shard_map`` island and its no-mesh call; every rank holds the whole
    batch's aux."""
    for r in range(WORLD):
        d = r // 2
        rows = slice(d * BATCH // 2, (d + 1) * BATCH // 2)
        for key in ("y_mesh", "y"):
            np.testing.assert_allclose(results[r][arch + ":y"],
                                       reference[f"{arch}:{key}"][rows],
                                       **LOGIT_TOL, err_msg=f"{key} rank {r}")
        np.testing.assert_allclose(results[r][arch + ":aux"],
                                   reference[arch + ":aux"], **LOGIT_TOL)
        np.testing.assert_allclose(results[r][arch + ":aux"],
                                   reference[arch + ":aux_mesh"], **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_equals_one_step_on_the_whole_batch(arch, results,
                                                            reference):
    """Loss and router aux of each step on every rank, and the parameters
    after 2 steps, against the reference's no-mesh steps on the whole
    batch."""
    for i in range(STEPS):
        for r in range(WORLD):
            for key in ("loss", "aux"):
                np.testing.assert_allclose(
                    results[r][f"{arch}:{key}{i}"],
                    reference[f"{arch}:nm:{key}{i}"], **LOGIT_TOL,
                    err_msg=f"{key} step {i} rank {r}")
    got = whole_params(results, arch)
    for key, v in got.items():
        np.testing.assert_allclose(v, reference[f"{arch}:nm:p:{key}"],
                                   **PARAM_TOL, err_msg=key)
    for key, v in whole_params(results, arch, "m").items():
        np.testing.assert_allclose(v, reference[f"{arch}:nm:m:{key}"],
                                   **MOMENT_TOL, err_msg=f"m {key}")


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_the_reference_mesh_step(arch, results,
                                                         reference):
    """The reference's jitted mesh step reports the same loss and aux at
    each step."""
    for i in range(STEPS):
        for key in ("loss", "aux"):
            np.testing.assert_allclose(results[0][f"{arch}:{key}{i}"],
                                       reference[f"{arch}:ms:{key}{i}"],
                                       **LOGIT_TOL, err_msg=f"{key} step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_gradients_match_the_no_mesh_gradient(arch, results, reference):
    """The port's data-averaged gradients on the mesh (experts' blocks put
    back together) against ``jax.grad`` without a mesh and through the
    reference's jitted island (``GRAD_TOL``): Megatron's pair keeps the
    gradients before the island whole, and no factor of ``tp`` appears."""
    got = whole_params(results, arch, "g")
    for tag in ("nm", "ms"):
        for key, v in got.items():
            np.testing.assert_allclose(v, reference[f"{arch}:{tag}:g:{key}"],
                                       **GRAD_TOL, err_msg=f"{tag} {key}")


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_mesh_gradient_equals_its_no_mesh_gradient(arch, reference):
    """The reference's ``psum`` under ``shard_map(check_rep=False)`` gives
    its mesh step the no-mesh gradient (no factor of ``tp``), and its mesh
    step's parameters the no-mesh step's."""
    for key in reference:
        if key.startswith((f"{arch}:nm:g:", f"{arch}:nm:p:")):
            tol = GRAD_TOL if ":g:" in key else PARAM_TOL
            np.testing.assert_allclose(
                reference[key.replace(":nm:", ":ms:")], reference[key],
                **tol, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_mesh_runs_end_on_one_sha256(arch, results):
    for r in range(WORLD):
        a, b = results[r][arch + ":sha"]
        assert a == b, f"rank {r}"
