"""Virtual cluster topology for the DEEP-ER Cluster-Booster architecture.

The DEEP-ER prototype consists of two *modules* joined by one uniform
fabric: a Cluster of general-purpose nodes and a Booster of autonomous
accelerator nodes.  The resiliency and I/O stack in this framework operates
on *logical node ranks* (like SCR operates on MPI ranks), decoupled from
the physical JAX device count.  Each rank owns:

  * a slice of the global mesh (on a real fleet: one TPU host),
  * a node-local NVM tier directory (checkpoint buffering, BeeOND cache),
  * a buddy partner (for PARTNER/BUDDY checkpointing),
  * membership in an XOR parity group (for Distributed-XOR/NAM-XOR).

Failure injection wipes a rank's volatile state and (for *node* failures)
its NVM directory — exactly the failure classes the paper's strategy
lattice distinguishes (transient vs. node loss vs. group loss).
"""

from __future__ import annotations

import dataclasses
import enum
import shutil
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class Module(enum.Enum):
    """Compute module kind in the Cluster-Booster architecture."""

    CLUSTER = "cluster"   # general-purpose nodes (Xeon in the prototype)
    BOOSTER = "booster"   # autonomous accelerator nodes (KNL / TPU pod here)


class NodeState(enum.Enum):
    UP = "up"
    FAILED_TRANSIENT = "failed_transient"  # process crash; NVM survives
    FAILED_NODE = "failed_node"            # node loss; NVM content gone
    RECOVERING = "recovering"


class NodeFailure(RuntimeError):
    """Raised inside compute when an injected failure fires on a rank."""

    def __init__(self, rank: int, kind: NodeState, msg: str = ""):
        self.rank = rank
        self.kind = kind
        super().__init__(f"rank {rank} failed ({kind.value}) {msg}")


@dataclasses.dataclass
class Node:
    rank: int
    module: Module
    state: NodeState = NodeState.UP
    nvm_dir: Optional[Path] = None
    # bookkeeping for straggler mitigation / failure detection
    last_heartbeat: float = 0.0
    failures: int = 0

    @property
    def is_up(self) -> bool:
        return self.state == NodeState.UP


class VirtualCluster:
    """Logical Cluster-Booster topology with failure injection.

    Parameters
    ----------
    n_cluster, n_booster:
        node counts per module (DEEP-ER prototype: 16 + 8).
    root:
        filesystem root under which per-rank NVM directories and the
        global storage directory are created.
    xor_group_size:
        size of the XOR parity groups (SCR "set size").  Groups are laid
        out *within* a module so that parity traffic stays on the
        intra-module fabric, mirroring SCR's topology-aware sets.
    """

    def __init__(
        self,
        n_cluster: int = 16,
        n_booster: int = 8,
        root: Optional[Path] = None,
        xor_group_size: int = 4,
    ):
        if n_cluster < 0 or n_booster < 0 or n_cluster + n_booster < 1:
            raise ValueError("need at least one node")
        self.root = Path(root) if root is not None else Path(".deeper_run")
        self.root.mkdir(parents=True, exist_ok=True)
        self.nodes: List[Node] = []
        for i in range(n_cluster):
            self.nodes.append(Node(rank=i, module=Module.CLUSTER))
        for j in range(n_booster):
            self.nodes.append(Node(rank=n_cluster + j, module=Module.BOOSTER))
        for node in self.nodes:
            node.nvm_dir = self.root / "nvm" / f"node{node.rank:05d}"
            node.nvm_dir.mkdir(parents=True, exist_ok=True)
            node.last_heartbeat = time.monotonic()
        self.global_dir = self.root / "global_storage"
        self.global_dir.mkdir(parents=True, exist_ok=True)
        self.nam_dir = self.root / "nam"
        self.nam_dir.mkdir(parents=True, exist_ok=True)
        if xor_group_size < 2:
            raise ValueError("xor_group_size must be >= 2")
        self.xor_group_size = xor_group_size
        self._buddy: Dict[int, int] = self._pair_buddies()
        self._xor_groups: List[List[int]] = self._build_xor_groups()
        # injected failure schedule: rank -> (kind, fire_predicate already armed)
        self._armed: Dict[int, NodeState] = {}

    # ------------------------------------------------------------------ #
    # topology queries
    # ------------------------------------------------------------------ #

    @property
    def size(self) -> int:
        return len(self.nodes)

    def ranks(self, module: Optional[Module] = None) -> List[int]:
        return [n.rank for n in self.nodes if module is None or n.module == module]

    def up_ranks(self) -> List[int]:
        return [n.rank for n in self.nodes if n.is_up]

    def node(self, rank: int) -> Node:
        return self.nodes[rank]

    def buddy_of(self, rank: int) -> int:
        """Partner node for PARTNER/BUDDY checkpointing."""
        return self._buddy[rank]

    def xor_group_of(self, rank: int) -> List[int]:
        for group in self._xor_groups:
            if rank in group:
                return group
        raise KeyError(rank)

    @property
    def xor_groups(self) -> List[List[int]]:
        return [list(g) for g in self._xor_groups]

    def _pair_buddies(self) -> Dict[int, int]:
        """Pair each rank with a partner in the same module.

        SCR_PARTNER pairs neighbours; we pair rank 2k <-> 2k+1 inside each
        module, wrapping an odd tail onto the module head (a 3-cycle is
        avoided by pairing the last odd node with the first node, which
        then carries two partners' data — same convention SCR uses for
        odd set sizes).
        """
        pairs: Dict[int, int] = {}
        for module in (Module.CLUSTER, Module.BOOSTER):
            ranks = self.ranks(module)
            if not ranks:
                continue
            if len(ranks) == 1:
                pairs[ranks[0]] = ranks[0]
                continue
            for idx, r in enumerate(ranks):
                pairs[r] = ranks[(idx + 1) % len(ranks)]
        return pairs

    def _build_xor_groups(self) -> List[List[int]]:
        """Topology-aware XOR sets: contiguous ranks within one module."""
        groups: List[List[int]] = []
        for module in (Module.CLUSTER, Module.BOOSTER):
            ranks = self.ranks(module)
            g = self.xor_group_size
            for i in range(0, len(ranks), g):
                chunk = ranks[i : i + g]
                if len(chunk) == 1 and groups and groups[-1][0] in ranks:
                    groups[-1].extend(chunk)  # fold singleton tail into prior group
                elif chunk:
                    groups.append(chunk)
        return groups

    # ------------------------------------------------------------------ #
    # failure injection & detection
    # ------------------------------------------------------------------ #

    def arm_failure(self, rank: int, kind: NodeState = NodeState.FAILED_NODE) -> None:
        """Arm a failure on `rank`; it fires at the next `checkpoint_barrier`
        or explicit `maybe_fail` touchpoint."""
        if kind not in (NodeState.FAILED_TRANSIENT, NodeState.FAILED_NODE):
            raise ValueError(kind)
        self._armed[rank] = kind

    def maybe_fail(self, rank: int) -> None:
        """Touchpoint called from compute paths: raises if a failure is armed."""
        kind = self._armed.pop(rank, None)
        if kind is not None:
            self.fail(rank, kind)
            raise NodeFailure(rank, kind)

    def fail(self, rank: int, kind: NodeState = NodeState.FAILED_NODE) -> None:
        """Immediately transition a rank to failed state.

        FAILED_NODE wipes the node-local NVM directory — checkpoints cached
        there are *lost*, which is exactly what Buddy/XOR redundancy must
        survive.  FAILED_TRANSIENT keeps NVM intact (SCR_SINGLE suffices).
        """
        node = self.nodes[rank]
        node.state = kind
        node.failures += 1
        if kind == NodeState.FAILED_NODE and node.nvm_dir is not None:
            shutil.rmtree(node.nvm_dir, ignore_errors=True)

    def recover(self, rank: int) -> None:
        """Bring a failed rank back (replacement node / process restart)."""
        node = self.nodes[rank]
        node.state = NodeState.UP
        if node.nvm_dir is not None:
            node.nvm_dir.mkdir(parents=True, exist_ok=True)
        node.last_heartbeat = time.monotonic()
        self._armed.pop(rank, None)

    def heartbeat(self, rank: int) -> None:
        self.nodes[rank].last_heartbeat = time.monotonic()

    def detect_failures(self, timeout_s: float = 30.0) -> List[int]:
        """Heartbeat-based failure detector (driver side)."""
        now = time.monotonic()
        late = []
        for node in self.nodes:
            if node.is_up and now - node.last_heartbeat > timeout_s:
                late.append(node.rank)
        return late

    def detect_stragglers(self, factor: float = 3.0) -> List[int]:
        """Ranks whose heartbeat gap exceeds `factor` x median gap."""
        now = time.monotonic()
        gaps = sorted(now - n.last_heartbeat for n in self.nodes if n.is_up)
        if not gaps:
            return []
        median = gaps[len(gaps) // 2]
        floor = max(median, 1e-3)
        return [
            n.rank
            for n in self.nodes
            if n.is_up and (now - n.last_heartbeat) > factor * floor
        ]

    # ------------------------------------------------------------------ #
    # storage paths
    # ------------------------------------------------------------------ #

    def nvm_path(self, rank: int) -> Path:
        node = self.nodes[rank]
        if node.state == NodeState.FAILED_NODE:
            raise NodeFailure(rank, node.state, "NVM unavailable")
        assert node.nvm_dir is not None
        node.nvm_dir.mkdir(parents=True, exist_ok=True)
        return node.nvm_dir

    def resize(self, n_cluster: int, n_booster: int) -> "VirtualCluster":
        """Elastic re-provisioning: build a new topology over the same root.

        Checkpoint manifests carry *global* shapes, so a restore onto the
        resized cluster re-shards automatically (see io/serialization.py).
        """
        return VirtualCluster(
            n_cluster=n_cluster,
            n_booster=n_booster,
            root=self.root,
            xor_group_size=self.xor_group_size,
        )

    def teardown(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)
