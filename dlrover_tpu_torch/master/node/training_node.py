"""Per-role training node managers.

Parity: reference dlrover/python/master/node/training_node.py:181
(TrainingNodeManager) and worker.py:42-108 (WorkerManager). Each manager
owns the node records of one role group, produces relaunch/scale plans,
and answers liveness queries for the job manager.

The port's copy of ``dlrover_tpu/master/node/training_node.py``.
"""

import copy
import threading
import time
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node, NodeGroupResource
from dlrover_tpu_torch.master.scaler.base_scaler import ScalePlan


class TrainingNodeManager:
    def __init__(
        self,
        node_type: str,
        group_resource: NodeGroupResource,
        new_node_id_fn,
        max_relaunch_count: int = 3,
        node_group_size: int = 0,
    ):
        self._node_type = node_type
        self._group_resource = group_resource
        self._new_node_id_fn = new_node_id_fn
        self._max_relaunch_count = max_relaunch_count
        # Hosts per TPU slice block; >1 assigns node.node_group at init.
        self._node_group_size = node_group_size
        self._lock = threading.Lock()
        self._nodes: Dict[int, Node] = {}

    @property
    def nodes(self) -> Dict[int, Node]:
        with self._lock:
            return dict(self._nodes)

    @property
    def group_resource(self) -> NodeGroupResource:
        return self._group_resource

    def init_nodes(self) -> List[Node]:
        """Build the initial node records for the configured group size."""
        with self._lock:
            for rank in range(self._group_resource.count):
                node_id = self._new_node_id_fn()
                node = Node(
                    self._node_type,
                    node_id,
                    rank_index=rank,
                    config_resource=copy.copy(
                        self._group_resource.node_resource
                    ),
                    max_relaunch_count=self._max_relaunch_count,
                )
                if self._node_group_size > 1:
                    node.node_group = rank // self._node_group_size
                self._nodes[node_id] = node
            return list(self._nodes.values())

    def update_node(self, node: Node):
        with self._lock:
            self._nodes[node.id] = node

    def get_node(self, node_id: int) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(node_id)

    def remove_node(self, node_id: int):
        with self._lock:
            self._nodes.pop(node_id, None)

    def relaunch_node(self, node: Node) -> Tuple[Optional[Node], ScalePlan]:
        """Decide the replacement record + plan for a dead node."""
        plan = ScalePlan()
        reason = node.is_unrecoverable_failure()
        if reason:
            logger.warning(
                "node %s not relaunched: %s", node.name, reason
            )
            return None, plan
        with self._lock:
            new_id = self._new_node_id_fn()
            new_node = node.get_relaunch_node(new_id)
            # Replacement pods take the group's CURRENT resource template,
            # not the dead pod's copy: the optimizer may have bumped
            # memory after an OOM, and the relaunch must pick that up.
            new_node.config_resource = copy.copy(
                self._group_resource.node_resource
            )
            self._nodes[new_id] = new_node
        plan.launch_nodes.append(new_node)
        if not node.is_released:
            plan.remove_nodes.append(node)
        return new_node, plan

    # ---- liveness queries --------------------------------------------------

    def alive_nodes(self) -> List[Node]:
        with self._lock:
            return [
                n
                for n in self._nodes.values()
                if n.status in (NodeStatus.PENDING, NodeStatus.RUNNING)
            ]

    def running_nodes(self) -> List[Node]:
        with self._lock:
            return [
                n
                for n in self._nodes.values()
                if n.status == NodeStatus.RUNNING
            ]

    def pending_nodes(self) -> List[Node]:
        with self._lock:
            return [
                n
                for n in self._nodes.values()
                if n.status in (NodeStatus.INITIAL, NodeStatus.PENDING)
            ]

    def all_nodes_exited(self) -> bool:
        with self._lock:
            if not self._nodes:
                return False
            latest = self._latest_incarnations()
            return all(n.is_end() for n in latest)

    def all_nodes_succeeded(self) -> bool:
        with self._lock:
            if not self._nodes:
                return False
            latest = self._latest_incarnations()
            return all(n.status == NodeStatus.SUCCEEDED for n in latest)

    def _latest_incarnations(self) -> List[Node]:
        """One record per rank: the newest relaunch incarnation."""
        by_rank: Dict[int, Node] = {}
        for node in self._nodes.values():
            cur = by_rank.get(node.rank_index)
            if cur is None or node.id > cur.id:
                by_rank[node.rank_index] = node
        return list(by_rank.values())

    def latest_nodes(self) -> List[Node]:
        with self._lock:
            return self._latest_incarnations()

    def first_pending_since(self) -> float:
        """Earliest create_time among still-pending nodes (0 if none)."""
        pending = self.pending_nodes()
        times = [n.create_time for n in pending if n.create_time]
        return min(times) if times else 0.0


class WorkerManager(TrainingNodeManager):
    """Worker-role manager with elastic count adjustment.

    Parity: reference master/node/worker.py:42 (WorkerManager) —
    adds scale-out/in of the worker group used by the auto-scaler.
    """

    def __init__(
        self,
        group_resource: NodeGroupResource,
        new_node_id_fn,
        max_relaunch_count: int = 3,
        node_group_size: int = 0,
    ):
        super().__init__(
            NodeType.WORKER,
            group_resource,
            new_node_id_fn,
            max_relaunch_count,
            node_group_size,
        )

    def adjust_worker(self, target_count: int) -> ScalePlan:
        """Scale the worker group to target_count (reference
        worker.py WorkerManager.adjust_worker)."""
        plan = ScalePlan()
        # Every non-finished record occupies a rank: INITIAL covers the
        # window between a relaunch decision and the watcher seeing the
        # new pod — scaling in that window must not double-assign ranks.
        alive = [n for n in self.nodes.values() if not n.is_end()]
        delta = target_count - len(alive)
        if delta == 0:
            return plan
        self._group_resource.count = target_count
        if delta > 0:
            used_ranks = {n.rank_index for n in alive}
            rank = 0
            with self._lock:
                for _ in range(delta):
                    while rank in used_ranks:
                        rank += 1
                    used_ranks.add(rank)
                    node_id = self._new_node_id_fn()
                    node = Node(
                        self._node_type,
                        node_id,
                        rank_index=rank,
                        config_resource=copy.copy(
                            self._group_resource.node_resource
                        ),
                        max_relaunch_count=self._max_relaunch_count,
                    )
                    self._nodes[node_id] = node
                    plan.launch_nodes.append(node)
        else:
            # Remove the highest ranks first so the surviving world is a
            # contiguous [0, target) — required for legal mesh reshaping.
            for node in sorted(alive, key=lambda n: -n.rank_index)[:-delta]:
                node.relaunchable = False
                plan.remove_nodes.append(node)
        return plan

    def has_exited_worker(self) -> bool:
        return any(
            n.status in (NodeStatus.FAILED, NodeStatus.BREAKDOWN)
            for n in self.nodes.values()
        )

    def wait_worker_restart_window(self, node: Node, window_s: float) -> bool:
        """True if a failed node is still inside its restart window."""
        if node.finish_time is None:
            return False
        return (time.time() - node.finish_time) < window_s


class ChiefManager(TrainingNodeManager):
    """Chief-role manager (reference master/node/training_node.py chief
    handling): the coordinating host. Chief nodes are CRITICAL — they
    gate job success alongside workers, and the relaunch path treats
    their loss with the same urgency as a worker world re-formation
    (in JAX SPMD the rendezvous re-forms the world either way; the
    chief's criticality mainly drives reporting and success gating)."""

    def __init__(
        self,
        group_resource: NodeGroupResource,
        new_node_id_fn,
        max_relaunch_count: int = 3,
    ):
        super().__init__(
            NodeType.CHIEF,
            group_resource,
            new_node_id_fn,
            max_relaunch_count,
        )

    def init_nodes(self) -> List[Node]:
        nodes = super().init_nodes()
        for node in nodes:
            node.critical = True
        return nodes


class EvaluatorManager(TrainingNodeManager):
    """Evaluator-role manager (reference master/node/evaluator.py): a
    side group running evaluations off checkpoints. Evaluators relaunch
    like workers but do NOT gate job success — a finished training job
    with a still-running evaluator succeeds and the evaluator is torn
    down with the job."""

    def __init__(
        self,
        group_resource: NodeGroupResource,
        new_node_id_fn,
        max_relaunch_count: int = 3,
    ):
        super().__init__(
            NodeType.EVALUATOR,
            group_resource,
            new_node_id_fn,
            max_relaunch_count,
        )


def create_role_manager(
    node_type: str,
    group_resource: NodeGroupResource,
    new_node_id_fn,
    max_relaunch_count: int = 3,
    node_group_size: int = 0,
):
    if node_type == NodeType.WORKER:
        return WorkerManager(
            group_resource,
            new_node_id_fn,
            max_relaunch_count,
            node_group_size=node_group_size,
        )
    if node_type == NodeType.CHIEF:
        return ChiefManager(
            group_resource, new_node_id_fn, max_relaunch_count
        )
    if node_type == NodeType.EVALUATOR:
        return EvaluatorManager(
            group_resource, new_node_id_fn, max_relaunch_count
        )
    return TrainingNodeManager(
        node_type, group_resource, new_node_id_fn, max_relaunch_count
    )
