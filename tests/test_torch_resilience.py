"""The port's checkpoint stack against the reference, byte for byte.

The same train-state-shaped tree (float32, bfloat16 and int32 leaves,
unsorted dict keys, nested dicts) goes through the reference's and the
port's serialization and SCR managers.  Everything must be exact: the
manifest and blob, every file each strategy writes to node-local and
global storage, the XOR parity blocks and the NAM parity regions.  A
checkpoint written by either package restores in the other.
"""

import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.cluster.topology import NodeState, VirtualCluster as JCluster
from repro.core import parity as jparity
from repro.core.nam import NAMDevice as JNAM
from repro.core.scr import SCRManager as JSCR, Strategy as JStrategy
from repro.io import serialization as jser
from repro.kernels.xor_parity import xor_reduce_pallas
from repro.memory import codecs as jcodecs
from repro.memory.tiers import MemoryHierarchy as JHier
from repro_torch.cluster.topology import NodeState as TNodeState
from repro_torch.cluster.topology import VirtualCluster as TCluster
from repro_torch.core import parity as tparity
from repro_torch.core.nam import NAMDevice as TNAM
from repro_torch.core.scr import SCRManager as TSCR, Strategy as TStrategy
from repro_torch.io import serialization as tser
from repro_torch.memory import codecs as tcodecs
from repro_torch.memory.tiers import MemoryHierarchy as THier


def np_state(seed=0):
    """A train-state-shaped tree: keys deliberately out of sorted order."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((50, 80)).astype(np.float32)
    return {
        "params": {"wq": w, "embed": rng.standard_normal((33,)).astype(
            ml_dtypes.bfloat16), "b": np.arange(7, dtype=np.float32)},
        "opt": {"v": np.square(w), "m": -w},
        "step": np.int32(7),
    }


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def raw(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def leaves_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            leaves_equal(a[k], b[k])
        return
    assert raw(a) == raw(b)


# ---------------------------------------------------------------------- #
# serialization and codecs
# ---------------------------------------------------------------------- #


def test_serialization_manifest_and_blob_identical():
    state = np_state()
    want = jser.serialize_state(state, step=3, meta={"pipeline": {"step": 3}})
    got = tser.serialize_state(to_torch(state), step=3,
                               meta={"pipeline": {"step": 3}})
    assert got.manifest == want.manifest
    assert got.manifest_bytes() == want.manifest_bytes()
    assert got.data == want.data
    names = [e["name"] for e in got.manifest["leaves"]]
    assert names[0] == "['opt']['m']" and "['params']['embed']" in names
    # the streaming path yields the same fragments as the blob path
    stream = tser.serialize_state_stream(to_torch(state), step=3)
    for n in (1, 3, 8):
        assert stream.fragments(n) == jser.partition_blob(want.data, n)


@pytest.mark.parametrize("tree", [
    {"a": (np.float32(1.0),), "b": [None, np.zeros(3, np.int32)]},
    {"z": {}, "y": [np.ones(2, np.float32), np.ones(1, np.float32)]},
    {3: np.zeros(2, np.float32), 1: {"x": np.arange(3, dtype=np.int64)}},
], ids=["tuple-none", "empty-list", "int-keys"])
def test_serialization_treedef_strings_match(tree):
    want = jser.serialize_state(tree)
    got = tser.serialize_state(tree)
    assert got.manifest == want.manifest and got.data == want.data


def test_bf16_leaves_round_trip_both_ways():
    state = np_state(1)
    blob = jser.serialize_state(state)
    back = tser.deserialize_state(blob, to_torch(state))     # reference -> port
    assert back["params"]["embed"].dtype == torch.bfloat16
    leaves_equal(back, state)
    tblob = tser.serialize_state(to_torch(state))            # port -> reference
    leaves_equal(jser.deserialize_state(tblob, state), state)
    # a numpy template gives numpy leaves, as the reference does
    leaves_equal(tser.deserialize_state(blob, state), state)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_frames_identical(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(1000) * 3).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    data = x.tobytes() + b"\x07"                 # a ragged tail rides raw
    for jc, tc in ((jcodecs.Int8Codec(dtype, block=96),
                    tcodecs.Int8Codec(dtype, block=96)),
                   (jcodecs.ZlibCodec(), tcodecs.ZlibCodec())):
        frame = tc.encode(data)
        assert frame == jc.encode(data)
        assert tcodecs.is_encoded(frame)
        assert tcodecs.decode_blob(frame) == jcodecs.decode_blob(frame)
        assert tc.encode(frame) == frame         # re-encoding is a no-op


# ---------------------------------------------------------------------- #
# parity
# ---------------------------------------------------------------------- #


def fragments(seed, n, size):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            for _ in range(n)]


def test_parity_host_codes_identical():
    frags = fragments(3, 4, 1001)
    assert tparity.encode_xor_group(frags) == jparity.encode_xor_group(frags)
    assert tparity.encode_nam_parity(frags) == jparity.encode_nam_parity(frags)
    blocks = tparity.encode_xor_group(frags)
    have = {i: f for i, f in enumerate(frags) if i != 2}
    par = {i: b for i, b in enumerate(blocks) if i != 2}
    assert tparity.reconstruct_xor_group(2, have, par, 4, 1001) == frags[2]
    nam = tparity.encode_nam_parity(frags)
    assert tparity.reconstruct_from_nam(2, have, nam, 4) == frags[2]


def test_device_xor_path_matches_pallas_and_host_parity():
    frags = fragments(4, 5, 128 * 4 * 3 + 20)   # M not a block multiple
    stacked = tparity.pack_words(frags, device="cpu")
    assert stacked.shape == (5, 4, 128) and stacked.dtype == torch.int32
    np.testing.assert_array_equal(stacked.numpy(),
                                  np.asarray(jparity.pack_words(frags)))
    got = tparity.xor_reduce(stacked)
    want = xor_reduce_pallas(jnp.asarray(stacked.numpy()), block_rows=8,
                             interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tparity.unpack_words(got, len(frags[0])) == \
        jparity.encode_nam_parity(frags)


# ---------------------------------------------------------------------- #
# SCR: every strategy, byte for byte, and cross-package restore
# ---------------------------------------------------------------------- #


def make_scr(pkg, root, strategy, **kw):
    Cluster, Hier, NAM, SCR, Strategy = (
        (JCluster, JHier, JNAM, JSCR, JStrategy) if pkg == "jax"
        else (TCluster, THier, TNAM, TSCR, TStrategy))
    strategy = Strategy(strategy)
    cl = Cluster(4, 4, root=root, xor_group_size=4)
    hier = Hier(cl)
    nam = NAM(hier.nam_tier) if strategy == Strategy.NAM_XOR else None
    scr = SCR(cl, hier, nam=nam, strategy=strategy, procs_per_node=2, **kw)
    return cl, hier, scr


def files_under(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("strategy", [s.value for s in JStrategy])
def test_every_strategy_writes_identical_bytes(tmp_path, strategy):
    state = np_state(5)
    meta = {"pipeline": {"seed": 0, "step": 4}}
    jcl, jhier, jscr = make_scr("jax", tmp_path / "jax", strategy)
    tcl, thier, tscr = make_scr("torch", tmp_path / "torch", strategy)
    jscr.save(4, state, meta=meta)
    tscr.save(4, to_torch(state), meta=meta)
    jscr.wait()
    tscr.wait()
    want, got = files_under(tmp_path / "jax"), files_under(tmp_path / "torch")
    assert sorted(got) == sorted(want) and len(got) > 2
    for name in want:
        assert got[name] == want[name], name
    desc = json.loads(tscr.stack.get("scr/desc/step00000004.json").decode())
    assert desc["manifest"]["meta"] == meta
    # NAM parity regions live on the NAM (in memory): same keys, same bytes
    if strategy == JStrategy.NAM_XOR.value:
        jn, tn = jhier.nam_tier, thier.nam_tier
        assert sorted(tn.keys()) == sorted(jn.keys()) and list(tn.keys())
        for key in jn.keys():
            assert tn.get(key) == jn.get(key)
    jscr.close()
    tscr.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("strategy", ["buddy", "xor"])
def test_checkpoint_restores_in_the_other_package(tmp_path, writer, strategy):
    """One package writes and loses a node; the other reconstructs the
    lost fragment from the redundancy and restores the exact state."""
    state = np_state(6)
    reader = "torch" if writer == "jax" else "jax"
    wcl, _, wscr = make_scr(writer, tmp_path / "run", strategy,
                            flush_every=0)
    wscr.save(9, state if writer == "jax" else to_torch(state))
    wscr.wait()
    wscr.close()
    rcl, rhier, rscr = make_scr(reader, tmp_path / "run", strategy,
                                flush_every=0)
    rcl.fail(1, (NodeState if reader == "jax" else TNodeState).FAILED_NODE)
    rcl.recover(1)
    rhier.invalidate(1)
    template = state if reader == "jax" else to_torch(state)
    restored, step = rscr.restore(template)
    assert step == 9
    leaves_equal(restored, state)
    rscr.close()
