"""The Ulysses sequence-parallel prefill against the reference.

The reference's ``test_seq_parallel_matches_baseline`` case: reduced
minicpm3-4b (MLA) and starcoder2-7b (GQA, LayerNorm, GELU) at ``tp=2``
without tied embeddings, B 4 x T 16 tokens, a (data 2 x model 2) mesh,
float32 compute.  The reference runs in a subprocess on forced host
devices: its weights (``init`` with key 0), its no-mesh logits and its
jitted ``shard_map`` logits, with ``replicate_ffn`` off and on.  The
port runs the same weights (``convert.params_from_numpy``) in one spawned
gloo world of 4 CPU ranks: each rank's block of the logits (its batch
rows and its block of the sequence) against the reference's mesh logits
and against the port's own no-mesh logits, within ``LOGIT_TOL`` (float32
matmuls and norms summed in different orders; the mesh sums the FFN's
two column blocks).

Spawned ranks import this module, so the reference is imported only
inside the subprocess.
"""

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
ARCHS = ("minicpm3-4b", "starcoder2-7b")
VARIANTS = ("tp", "replicate_ffn")
LOGIT_TOL = dict(atol=5e-5, rtol=1e-4)


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


def configs(get_config, arch):
    import dataclasses
    cfg = dataclasses.replace(get_config(arch).reduced(), tp=2,
                              tie_embeddings=False, compute_dtype="float32")
    sp = dataclasses.replace(cfg, seq_parallel=True)
    return cfg, {"tp": sp,
                 "replicate_ffn": dataclasses.replace(sp, replicate_ffn=True)}


REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, sys.argv[2])
from test_torch_seqpar import ARCHS, configs, flatten
from repro.configs import get_config
from repro.models import transformer as T
out = {}
mesh = jax.make_mesh((2, 2), ("data", "model"))
for arch in ARCHS:
    cfg, sps = configs(get_config, arch)
    params = T.init(jax.random.PRNGKey(0), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                              cfg.vocab_size, jnp.int32)
    out[arch + ":tokens"] = np.asarray(toks)
    out.update({arch + ":p:" + k: v for k, v in flatten(params).items()})
    base, _ = T.forward(params, {"tokens": toks}, cfg, remat=False)
    out[arch + ":base"] = np.asarray(base)
    for name, sp_cfg in sps.items():
        with mesh:
            sp, _ = jax.jit(lambda p, b: T.forward(p, b, sp_cfg, remat=False,
                                                   mesh=mesh))(params, {"tokens": toks})
        out[arch + ":" + name] = np.asarray(sp)
np.savez(sys.argv[1], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("seqpar_ref") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(path),
                          str(Path(__file__).parent)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return path


def _rank_main(rank, ref_path, store_path, out_dir):
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as T

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=TIMEOUT_S))
    ref = dict(np.load(ref_path))
    out = {}
    try:
        mesh = make_test_mesh()
        for arch in ARCHS:
            cfg, sps = configs(get_config, arch)
            flat = {k.split(":", 2)[2]: v for k, v in ref.items()
                    if k.startswith(arch + ":p:")}
            params = params_from_numpy(unflatten(flat), cfg, device="cpu")
            tokens = torch.from_numpy(ref[arch + ":tokens"])
            with torch.no_grad():
                if rank == 0:
                    base, _ = T.forward(params, {"tokens": tokens}, cfg,
                                        remat=False)
                    out[arch + ":base"] = base.numpy()
                for name, sp_cfg in sps.items():
                    local = T.seqpar_params(params, sp_cfg, mesh)
                    got, _ = T.forward(local, {"tokens": tokens}, sp_cfg,
                                       remat=False, mesh=mesh)
                    out[arch + ":" + name] = got.numpy()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"{rank}.npz"), **out)


@pytest.fixture(scope="module")
def results(reference, tmp_path_factory):
    root = tmp_path_factory.mktemp("seqpar_world")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(reference), str(root / "store"), str(root)))
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


def rank_block(a, rank):
    """Rank (data d, model m)'s block of (B, T, V) logits: batch rows over
    data, sequence over model."""
    d, m = divmod(rank, 2)
    b, t = a.shape[0] // 2, a.shape[1] // 2
    return a[d * b:(d + 1) * b, m * t:(m + 1) * t]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_seqpar_logits_match_reference_mesh(arch, variant, results, reference):
    """Each rank's block of the logits is the reference's mesh logits'."""
    want = np.load(reference)[f"{arch}:{variant}"]
    for r in range(WORLD):
        got = results[r][f"{arch}:{variant}"]
        np.testing.assert_allclose(got, rank_block(want, r), **LOGIT_TOL,
                                   err_msg=f"{arch} {variant} rank {r}")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_seqpar_logits_match_the_ports_no_mesh_forward(arch, variant, results,
                                                       reference):
    """The mesh forward equals the port's own no-mesh forward, and that
    one the reference's."""
    base = results[0][f"{arch}:base"]
    np.testing.assert_allclose(base, np.load(reference)[f"{arch}:base"],
                               **LOGIT_TOL)
    for r in range(WORLD):
        np.testing.assert_allclose(results[r][f"{arch}:{variant}"],
                                   rank_block(base, r), **LOGIT_TOL,
                                   err_msg=f"{arch} {variant} rank {r}")
