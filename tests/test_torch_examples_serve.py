"""The port's serve example against the reference's.

``examples/serve.py`` and ``examples/torch_serve.py --device cpu`` run
in-process (the examples loaded by path, their output captured) for the
default arch (minicpm3-4b, MLA) and the two recurrent families that park
and prefix-cache whole lane snapshots (rwkv6-3b, zamba2-2.7b).  Every
printed count must be equal: tokens decoded, parks, resumes, max
resident, prefix hits, saved and computed prefill tokens, and streams
parked at the save.  The two packages' weights come from different
PRNGs, so tokens are compared only within a package: the restored run's
against the uninterrupted one.
"""

import sys

import pytest

from test_torch_examples import load, run_main

# the lines both examples print, after the reference's run on the CPU
# (JAX 0.9.0) at every arch below: the counts follow from the schedule
# and the prompts, not from the widths or the weights
WANT = ("decoded 36 tokens across 6 streams on {arch} (2 slots, quantum 3): "
        "6 parks, 6 resumes, max 6 resident",
        "shared system prompt: 5 prefix hits, 40 prefill tokens never "
        "recomputed (43 computed)",
        "OK: killed mid-decode with 4 streams parked + a node loss; restored "
        "scheduler finished every stream byte-identically.")


@pytest.mark.parametrize("arch", ["minicpm3-4b", "rwkv6-3b", "zamba2-2.7b"])
def test_serve_example_counts_match_reference(arch, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve.py", "--arch", arch])
    _, ref = run_main(load("serve"))
    got, port = run_main(load("torch_serve"),
                         ["--arch", arch, "--device", "cpu"])
    assert port == ref
    assert tuple(port) == tuple(w.format(arch=arch) for w in WANT)
    assert got["out"] == got["ref"]
    assert (got["tokens"], got["parked"], got["resumed"], got["max_resident"],
            got["prefix_hits"], got["prefill_tokens_saved"],
            got["prefill_tokens"], got["parked_at_save"]) == (
        36, 6, 6, 6, 5, 40, 43, 4)
    assert all(len(v) == 6 for v in got["out"].values())


def test_serve_example_refuses_a_card_it_does_not_have():
    """The default device is the card: without one the example raises
    instead of serving on the host."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default serves on it")
    with pytest.raises((AssertionError, RuntimeError)):
        run_main(load("torch_serve"), ["--arch", "rwkv6-3b"])


def test_serve_example_fleet_runs_on_the_cpu(monkeypatch):
    """``--workers 2``: two spawned CPU workers over one shared cache
    domain, reduced phi3 (the paged path).  Every stream gets its 6
    tokens and the shared system prompt is computed once fleet-wide.
    The prompts are drawn below the reduced vocabulary (512), where the
    reference draws below 1,000 and JAX clamps the embedding index."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    got, lines = run_main(load("torch_serve"),
                          ["--workers", "2", "--arch", "phi3-mini-3.8b",
                           "--device", "cpu"])
    assert lines[0].startswith("fleet of 2 workers decoded 36 tokens across "
                               "6 streams")
    assert lines[-1] == ("OK: cross-process prefix sharing through one cache "
                         "domain.")
    assert got["tokens"] == 36 and len(got["worker_stats"]) == 2
    assert got["saved"] > 0 and got["computed"] > 0
    assert max(t for p in got["outs"].values() for t in p) < 512
