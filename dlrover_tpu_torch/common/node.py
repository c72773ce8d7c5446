"""Node domain model held by the job master.

Parity: reference dlrover/python/common/node.py:44-460 (Node, NodeResource,
NodeGroupResource, NodeEvent). A "node" here is one TPU host (one JAX
process slot) inside a slice, or a CPU worker in local mode.

The port's copy of ``dlrover_tpu/common/node.py``.
"""

import copy
import time
from dataclasses import dataclass, field
from typing import Optional

from dlrover_tpu_torch.common.constants import (
    RELAUNCH_BUDGET_FACTOR,
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
)


@dataclass
class NodeResource:
    """Requested/used resources of one node."""

    cpu: float = 0.0
    memory_mb: float = 0.0
    tpu_chips: int = 0
    tpu_type: str = ""  # e.g. "v5litepod"
    priority: str = ""

    def is_empty(self) -> bool:
        return (
            self.cpu <= 0
            and self.memory_mb <= 0
            and self.tpu_chips <= 0
            and not self.tpu_type
        )

    @classmethod
    def resource_str_to_node_resource(cls, resource: str) -> "NodeResource":
        """Parse "cpu=4,memory=8192Mi,tpu=4" style strings."""
        res = cls()
        if not resource:
            return res
        for kv in resource.split(","):
            if "=" not in kv:
                continue
            k, v = kv.split("=", 1)
            k = k.strip().lower()
            v = v.strip()
            if k == "cpu":
                res.cpu = float(v)
            elif k == "memory":
                res.memory_mb = float(v.rstrip("Mi").rstrip("mi"))
            elif k in ("tpu", "tpu_chips"):
                res.tpu_chips = int(v)
        return res


@dataclass
class NodeGroupResource:
    """Resource template for one role group (count x per-node resource)."""

    count: int = 0
    node_resource: NodeResource = field(default_factory=NodeResource)


class Node:
    """Mutable per-node record tracked by the master's job manager."""

    def __init__(
        self,
        node_type: str = NodeType.WORKER,
        node_id: int = 0,
        rank_index: Optional[int] = None,
        name: str = "",
        host_name: str = "",
        host_ip: str = "",
        status: str = NodeStatus.INITIAL,
        config_resource: Optional[NodeResource] = None,
        max_relaunch_count: int = 3,
    ):
        self.type = node_type
        self.id = node_id
        self.rank_index = rank_index if rank_index is not None else node_id
        self.name = name or f"{node_type}-{node_id}"
        self.host_name = host_name
        self.host_ip = host_ip
        self.status = status
        self.config_resource = config_resource or NodeResource()
        self.used_resource = NodeResource()
        self.max_relaunch_count = max_relaunch_count

        self.relaunch_count = 0
        self.relaunchable = True
        self.is_released = False
        self.exit_reason = ""
        # Every classified exit of this rank's lineage (survives
        # relaunches): drives the per-reason relaunch budgets
        # (master/node/exit_reason.py).
        self.exit_history: list = []
        # When the master asked the backend for this node; pending-timeout
        # is measured from here.
        self.create_time: Optional[float] = time.time()
        self.start_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.heartbeat_time: float = 0.0
        self.restart_training = False
        self.critical = False
        # TPU slice/block index (-1 = ungrouped); a hardware fault on
        # one member relaunches the whole block together (ICI needs the
        # full slice) while other blocks keep running.
        self.node_group = -1
        self.migrated = False
        self.paral_config_version = -1
        self.reported_status: str = ""
        # (ts, status) transitions — the dashboard's node-detail
        # timeline; bounded so a crash-looping node can't grow it.
        self.status_history: list = [(time.time(), status)]

    # ---- status transitions -------------------------------------------------

    def update_status(self, status: str) -> bool:
        from dlrover_tpu_torch.master.node.status_flow import NodeStateFlow

        allowed = NodeStateFlow.transition_allowed(self.status, status)
        if allowed:
            if (
                status == NodeStatus.RUNNING
                and self.status != NodeStatus.RUNNING
            ):
                self.start_time = time.time()
            if status in NodeStatus.end_states():
                self.finish_time = time.time()
            self.status = status
            self.status_history.append((time.time(), status))
            del self.status_history[:-50]
        return allowed

    def is_end(self) -> bool:
        return self.status in NodeStatus.end_states()

    def is_unrecoverable_failure(self) -> str:
        """Return a non-empty reason if this node must not be relaunched.

        With a classified exit history, each reason spends its own
        budget (RELAUNCH_BUDGET_FACTOR x max_relaunch_count): ten
        preemptions must not be blocked by the generic cap, while a
        crash loop exhausts its smaller budget quickly. Without history
        (legacy callers), the flat relaunch_count cap applies.
        """
        if not self.relaunchable:
            return "node not relaunchable"
        if self.exit_reason == NodeExitReason.FATAL_ERROR:
            return "fatal software error"
        if self.exit_history:
            reason = self.exit_reason or NodeExitReason.UNKNOWN
            budget = int(
                self.max_relaunch_count
                * RELAUNCH_BUDGET_FACTOR.get(reason, 1.0)
            )
            count = self.exit_count(reason)
            if count > budget:
                return (
                    f"{reason} exits {count} > budget {budget} "
                    f"(max_relaunch {self.max_relaunch_count})"
                )
            return ""
        if self.relaunch_count >= self.max_relaunch_count:
            return (
                f"relaunch count {self.relaunch_count} >= "
                f"max {self.max_relaunch_count}"
            )
        return ""

    def inc_relaunch_count(self):
        self.relaunch_count += 1

    def record_exit(self, reason: str):
        self.exit_history.append(reason)

    def exit_count(self, reason: str) -> int:
        return self.exit_history.count(reason)

    def update_from_resource_stats(self, cpu: float, memory_mb: float):
        self.used_resource.cpu = cpu
        self.used_resource.memory_mb = memory_mb

    def get_relaunch_node(self, new_id: int) -> "Node":
        """Build the replacement node record after a relaunch decision."""
        new_node = copy.copy(self)
        new_node.id = new_id
        new_node.name = f"{self.type}-{new_id}"
        new_node.status = NodeStatus.INITIAL
        new_node.create_time = time.time()
        new_node.start_time = None
        new_node.finish_time = None
        new_node.is_released = False
        new_node.exit_reason = ""
        new_node.relaunch_count = self.relaunch_count + 1
        # The lineage's exit history rides along (shared list: past
        # exits are immutable facts about the rank, not the pod).
        new_node.exit_history = self.exit_history
        # Fresh timeline: the POD's life starts now (copy.copy would
        # share the predecessor's list — appends from either object
        # would cross-pollute both dashboards' timelines).
        new_node.status_history = [(time.time(), NodeStatus.INITIAL)]
        new_node.used_resource = NodeResource()
        new_node.heartbeat_time = 0
        return new_node

    def __repr__(self):
        return (
            f"Node(type={self.type}, id={self.id}, rank={self.rank_index}, "
            f"status={self.status}, relaunches={self.relaunch_count})"
        )


@dataclass
class NodeEvent:
    """An observed change of a node, produced by watchers or the agent."""

    event_type: str = NodeEventType.MODIFIED
    node: Optional[Node] = None

    def is_node_check_failed(self) -> bool:
        return self.event_type == NodeEventType.NODE_CHECK_FAILED
