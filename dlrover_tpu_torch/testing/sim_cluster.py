"""Simulated cluster backend: multi-node master testing without a cluster.

Parity: reference dlrover/python/testing/ (sim_master_main.py:14-50,
sim_stubs.py SimScaler/SimNodeWatcher) — the pattern for exercising the
full DistributedJobMaster (scale plans, pod events, relaunch, chaos) on
one host. The simulator adds fault injection used by goodput tests:
``fail_node`` / ``preempt_node`` / ``break_node``.

A sim node moves Pending -> Running after ``schedule_delay_s`` unless a
scheduling blackout is configured (to exercise pending-timeout paths).

The port's copy of ``dlrover_tpu/testing/sim_cluster.py``.
"""

import itertools
import queue
import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import (
    NodeEventType,
    NodeExitReason,
    NodeStatus,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node, NodeEvent
from dlrover_tpu_torch.master.scaler.base_scaler import ScalePlan, Scaler
from dlrover_tpu_torch.master.watcher.base_watcher import NodeWatcher


class SimCluster:
    """In-memory "cloud": holds sim nodes, emits watch events."""

    def __init__(self, schedule_delay_s: float = 0.0):
        self._lock = threading.RLock()
        self._nodes: Dict[int, Node] = {}
        self._events: "queue.Queue[Optional[NodeEvent]]" = queue.Queue()
        self._id_iter = itertools.count(0)
        self.schedule_delay_s = schedule_delay_s
        self.schedulable = True  # False simulates a full cluster

    # ---- backend surface used by scaler/watcher ---------------------------

    def next_node_id(self) -> int:
        with self._lock:
            return next(self._id_iter)

    def create_node(self, node: Node):
        # Own a private copy: the caller (job manager) keeps its record and
        # must learn of changes only through watch events, like a real
        # cluster API.
        node = self._copy(node)
        with self._lock:
            node.status = NodeStatus.PENDING
            node.create_time = time.time()
            self._nodes[node.id] = node
        self._emit(NodeEventType.ADDED, node)
        if self.schedulable:
            if self.schedule_delay_s > 0:
                threading.Timer(
                    self.schedule_delay_s, self._schedule, args=(node.id,)
                ).start()
            else:
                self._schedule(node.id)

    def remove_node(self, node_id: int):
        with self._lock:
            node = self._nodes.pop(node_id, None)
        if node is not None:
            node.status = NodeStatus.DELETED
            self._emit(NodeEventType.DELETED, node)

    def list_nodes(self) -> List[Node]:
        with self._lock:
            return [self._copy(n) for n in self._nodes.values()]

    def events(self):
        return self._events

    def close(self):
        self._events.put(None)

    # ---- fault injection (chaos) ------------------------------------------

    def fail_node(self, node_id: int, exit_reason: str = NodeExitReason.KILLED):
        """Worker process crash (OOM, segfault, kill -9 ...)."""
        self._finish(node_id, NodeStatus.FAILED, exit_reason)

    def preempt_node(self, node_id: int):
        """Cloud preemption / spot reclaim of the host."""
        self._finish(node_id, NodeStatus.DELETED, NodeExitReason.PREEMPTED)

    def break_node(self, node_id: int):
        """Hardware fault: node must be replaced, not restarted."""
        self._finish(node_id, NodeStatus.FAILED, NodeExitReason.HARDWARE_ERROR)

    def succeed_node(self, node_id: int):
        self._finish(node_id, NodeStatus.SUCCEEDED, NodeExitReason.SUCCEEDED)

    # ---- internals ---------------------------------------------------------

    def _schedule(self, node_id: int):
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or node.status != NodeStatus.PENDING:
                return
            node.status = NodeStatus.RUNNING
            node.host_name = f"sim-host-{node_id}"
            node.host_ip = f"10.0.0.{node_id % 250 + 1}"
        self._emit(NodeEventType.MODIFIED, node)

    def _finish(self, node_id: int, status: str, exit_reason: str):
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return
            node.status = status
            node.exit_reason = exit_reason
        self._emit(NodeEventType.MODIFIED, node)

    def _copy(self, node: Node) -> Node:
        clone = Node(
            node_type=node.type,
            node_id=node.id,
            rank_index=node.rank_index,
            name=node.name,
            host_name=node.host_name,
            host_ip=node.host_ip,
            status=node.status,
            config_resource=node.config_resource,
        )
        clone.exit_reason = node.exit_reason
        clone.relaunch_count = node.relaunch_count
        return clone

    def _emit(self, event_type: str, node: Node):
        self._events.put(NodeEvent(event_type, self._copy(node)))


class SimScaler(Scaler):
    """Scaler over the in-memory cluster (reference sim_stubs.SimScaler)."""

    def __init__(self, job_name: str, cluster: SimCluster):
        super().__init__(job_name)
        self._cluster = cluster

    def scale(self, plan: ScalePlan):
        with self._lock:
            for group_name, group in plan.node_group_resources.items():
                self._scale_group(group_name, group)
            for node in plan.launch_nodes:
                self._cluster.create_node(node)
            for node in plan.remove_nodes:
                self._cluster.remove_node(node.id)

    def _scale_group(self, node_type: str, group):
        alive = [
            n
            for n in self._cluster.list_nodes()
            if n.type == node_type and n.status not in NodeStatus.end_states()
        ]
        delta = group.count - len(alive)
        if delta > 0:
            used_ranks = {n.rank_index for n in alive}
            rank = 0
            for _ in range(delta):
                while rank in used_ranks:
                    rank += 1
                used_ranks.add(rank)
                node_id = self._cluster.next_node_id()
                self._cluster.create_node(
                    Node(
                        node_type,
                        node_id,
                        rank_index=rank,
                        config_resource=group.node_resource,
                    )
                )
        elif delta < 0:
            for node in sorted(alive, key=lambda n: -n.rank_index)[:-delta]:
                logger.info("sim scale-down removes node %d", node.id)
                self._cluster.remove_node(node.id)


class SimNodeWatcher(NodeWatcher):
    """Watcher over the in-memory cluster (reference sim_stubs)."""

    def __init__(self, job_name: str, cluster: SimCluster):
        super().__init__(job_name)
        self._cluster = cluster
        self._stopped = False

    def watch(self):
        events = self._cluster.events()
        while not self._stopped:
            event = events.get()
            if event is None:
                return
            yield event

    def list(self) -> List[Node]:
        return self._cluster.list_nodes()

    def stop(self):
        self._stopped = True
        self._cluster.close()
