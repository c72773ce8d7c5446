"""Legal node status transitions.

Parity: reference dlrover/python/master/node/status_flow.py (NodeStateFlow).
Expressed as an allowed-edge set instead of a flow table; semantics match:
once a node reaches an end state it can only be DELETED/RELEASED.

The port's copy of ``dlrover_tpu/master/node/status_flow.py``.
"""

from dlrover_tpu_torch.common.constants import NodeStatus

_ALLOWED = {
    (NodeStatus.INITIAL, NodeStatus.PENDING),
    (NodeStatus.INITIAL, NodeStatus.RUNNING),
    (NodeStatus.INITIAL, NodeStatus.FAILED),
    (NodeStatus.INITIAL, NodeStatus.DELETED),
    (NodeStatus.PENDING, NodeStatus.RUNNING),
    (NodeStatus.PENDING, NodeStatus.SUCCEEDED),
    (NodeStatus.PENDING, NodeStatus.FAILED),
    (NodeStatus.PENDING, NodeStatus.DELETED),
    (NodeStatus.PENDING, NodeStatus.BREAKDOWN),
    (NodeStatus.RUNNING, NodeStatus.SUCCEEDED),
    (NodeStatus.RUNNING, NodeStatus.FAILED),
    (NodeStatus.RUNNING, NodeStatus.DELETED),
    (NodeStatus.RUNNING, NodeStatus.BREAKDOWN),
    (NodeStatus.SUCCEEDED, NodeStatus.DELETED),
    (NodeStatus.FAILED, NodeStatus.DELETED),
    (NodeStatus.BREAKDOWN, NodeStatus.DELETED),
    (NodeStatus.UNKNOWN, NodeStatus.RUNNING),
    (NodeStatus.UNKNOWN, NodeStatus.FAILED),
    (NodeStatus.UNKNOWN, NodeStatus.DELETED),
}


class NodeStateFlow:
    @staticmethod
    def transition_allowed(from_status: str, to_status: str) -> bool:
        if from_status == to_status:
            return True
        if from_status == NodeStatus.UNKNOWN or to_status == NodeStatus.UNKNOWN:
            # Unknown observations never regress a definite state.
            return to_status != NodeStatus.UNKNOWN
        return (from_status, to_status) in _ALLOWED
