"""The port's paged speculative scheduler against the JAX reference.

Both schedulers (no pager, no prefix cache) serve the same five numpy
prompts over two slots with round-robin parking, from the same weights
(initialised by the reference, carried across).  At float32 compute the
emitted tokens must be identical, and so must the pool allocator's state
after the run (refcounts, free list) and the scheduler's counters.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.registry import get_model as jget_model
from repro.serve.scheduler import PagedServeScheduler as JSched
from repro.serve.spec import NGramProposer as JProposer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.registry import get_model
from repro_torch.serve import Serve, ServeConfig
from repro_torch.serve.scheduler import PagedServeScheduler as TSched
from repro_torch.serve.spec import NGramProposer as TProposer

ARCH = "phi3-mini-3.8b"
MAX_LEN, MAX_NEW, PT = 24, 6, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tensors here are tiny, and the suite runs
    several workers on the same cores, where a spinning thread pool per
    worker made these tests ~50x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH).reduced(),
                               compute_dtype="float32")
    jmodel, tmodel = jget_model(jcfg), get_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


def prompts(vocab):
    rng = np.random.default_rng(11)
    out = [rng.integers(0, vocab, size=int(rng.integers(2, 10)))
           for _ in range(4)]
    out.append(np.asarray([7, 8, 9] * 3))     # periodic: proposals hit
    return out


@pytest.mark.parametrize("spec_k", [0, 3])
def test_paged_scheduler_matches_reference(pair, spec_k):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair
    kw = dict(slots=2, max_len=MAX_LEN, quantum=3, page_tokens=PT,
              spec_k=spec_k)
    js = JSched(jcfg, jmodel, jparams, **kw)
    ts = TSched(tcfg, tmodel, tparams, **kw)
    ps = prompts(jcfg.vocab_size)
    jsids = [js.submit(p, max_new=MAX_NEW) for p in ps]
    tsids = [ts.submit(p, max_new=MAX_NEW) for p in ps]
    # step in lockstep so the allocator can be compared mid-run too
    while js.unfinished() or ts.unfinished():
        assert js.step() == ts.step()
        assert ts.pool.refcounts() == js.pool.refcounts()
        assert ts.pool._free == js.pool._free
    for a, b in zip(jsids, tsids):
        assert ts.output(b) == js.output(a)
    assert ts.pool.refcounts() == js.pool.refcounts() == {}
    assert ts.pool._free == js.pool._free
    assert dict(ts.stats) == dict(js.stats)
    assert ts.stats["parked"] > 0 and ts.stats["resumed"] > 0
    if spec_k:
        assert ts.stats["spec_accepted"] > 0


def test_serve_local_runs_the_paged_path(tmp_path):
    """The user's entry point, on the CPU at the reduced size: the paged
    path without and with the prefix cache, the contiguous path, and a
    session that saves and restores."""
    from repro_torch.api.session import ResilienceSession
    from repro_torch.cluster.topology import VirtualCluster

    cfg = ServeConfig(prefix=False, device="cpu", slots=2, max_len=MAX_LEN,
                      page_tokens=PT, spec_k=2)
    outs = {}
    for name, over in (("paged", {}), ("prefix", dict(prefix=True)),
                       ("contiguous", dict(paged=False, spec_k=0))):
        with Serve.local(dataclasses.replace(cfg, **over)) as srv:
            sids = [srv.submit(p, max_new=MAX_NEW) for p in prompts(512)]
            srv.run()
            assert all(len(srv.output(s)) == MAX_NEW for s in sids)
            outs[name] = [srv.output(s) for s in sids]
            if name == "paged":
                assert srv.scheduler.pool.used_pages() == 0
    # greedy decode of the same weights: every path emits the same tokens
    assert outs["prefix"] == outs["paged"] == outs["contiguous"]
    cluster = VirtualCluster(4, 4, root=tmp_path)
    with ResilienceSession.for_cluster(cluster, procs_per_node=2) as session:
        with Serve.local(cfg, session=session) as srv:
            sids = [srv.submit(p, max_new=MAX_NEW) for p in prompts(512)]
            srv.run(max_steps=3)
            srv.save()
        with Serve.local(cfg, session=session) as srv:
            srv.restore()
            srv.run()
            assert [srv.output(s) for s in sids] == outs["paged"]
    cluster.teardown()


def test_ngram_proposer_copy_proposes_identically():
    rng = np.random.default_rng(5)
    jp, tp = JProposer(), TProposer()
    hists = [list(rng.integers(0, 6, size=int(n)))
             for n in rng.integers(0, 40, size=60)]
    hists += [[1, 2, 3] * 5, [4] * 9, [], [5]]
    for h in hists:
        for k in (1, 3, 5):
            assert tp.propose(h, k) == jp.propose(h, k)
