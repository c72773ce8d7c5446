"""Node event callbacks: hooks run on node lifecycle transitions.

Parity: reference dlrover/python/master/node/event_callback.py:43-340
(NodeEventCallback base, AllReduceNodeHandlingCallback,
TaskRescheduleCallback). Callbacks let orthogonal subsystems (rendezvous
membership, data-shard recovery, perf bookkeeping) react to node events
without coupling them into the job manager.

The port's copy of ``dlrover_tpu/master/node/event_callback.py``.
"""

import abc

from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.node import Node


class NodeEventCallback(abc.ABC):
    """Hooks fired by the job manager as nodes change state."""

    def on_node_started(self, node: Node):
        pass

    def on_node_succeeded(self, node: Node):
        pass

    def on_node_failed(self, node: Node):
        pass

    def on_node_deleted(self, node: Node):
        pass


class AllReduceNodeHandlingCallback(NodeEventCallback):
    """SPMD (allreduce/psum) strategy: keep rendezvous membership in sync
    and trip the failover counter (reference event_callback.py:252)."""

    def __init__(self, master):
        self._master = master

    def on_node_started(self, node: Node):
        if node.type == NodeType.WORKER:
            for mgr in self._master.rdzv_managers.values():
                mgr.add_alive_node(node.rank_index)

    def on_node_succeeded(self, node: Node):
        self._remove_from_rdzv(node)

    def on_node_failed(self, node: Node):
        self._remove_from_rdzv(node)
        self._master.perf_monitor.reset()

    def on_node_deleted(self, node: Node):
        self._remove_from_rdzv(node)

    def _remove_from_rdzv(self, node: Node):
        if node.type != NodeType.WORKER:
            return
        for mgr in self._master.rdzv_managers.values():
            mgr.remove_alive_node(node.rank_index)


class TaskRescheduleCallback(NodeEventCallback):
    """Dynamic-data-sharding: recover unfinished shards of a dead worker
    (reference event_callback.py TaskRescheduleCallback)."""

    def __init__(self, task_manager):
        self._task_manager = task_manager

    def on_node_failed(self, node: Node):
        if node.type == NodeType.WORKER:
            self._task_manager.recover_node_tasks(node.id)

    def on_node_deleted(self, node: Node):
        self.on_node_failed(node)
