from repro_torch.cluster.topology import (
    Module,
    NodeState,
    Node,
    VirtualCluster,
    NodeFailure,
)

__all__ = ["Module", "NodeState", "Node", "VirtualCluster", "NodeFailure"]
