"""SimClusterScaler: a working, non-k8s ScalePlan backend.

The ``master/scaler`` package shipped with an ABC and two k8s-facing
scalers that no test could run; the simulator backend
(``testing/sim_cluster.py``) exists but needs the whole
cluster/watcher apparatus. This scaler is the missing middle: a
self-contained in-memory backend implementing the
:class:`~dlrover_tpu_torch.master.scaler.base_scaler.Scaler` contract —
idempotent convergence of ``node_group_resources``, explicit
``launch_nodes`` / ``remove_nodes``, capacity bounds, and an
``on_scale`` callback so a harness (the autoscale soak, the contract
tests) can observe every transition without polling.

It is the actuation substrate of the §30 closed-loop autoscaler's
sim-cluster validation: evict-and-replace plans, world resizes and the
bench's static/autoscaled A/B all land here through real ScalePlans.

The port's copy of ``dlrover_tpu/master/scaler/sim_scaler.py``.
"""

import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master.scaler.base_scaler import (
    ScalePlan,
    Scaler,
    new_node_id_iter,
)


class SimClusterScaler(Scaler):
    """In-memory Scaler: converges a node table to each ScalePlan.

    Semantics match the k8s scalers' contract:

    - ``node_group_resources[type].count`` is a declarative group size:
      missing seats are launched (lowest free rank first), surplus
      seats are removed (highest rank first) — applying the same plan
      twice is a no-op (idempotence is part of the ABC contract).
    - ``launch_nodes`` / ``remove_nodes`` are explicit singles (evict-
      and-replace, hot migration); launching an already-present node id
      or removing an absent one is a no-op, not an error.
    - ``capacity`` bounds the total node count (a sim "cluster full"):
      launches beyond it are dropped and counted, mirroring a cloud
      that stops scheduling — callers observe the shortfall through
      ``alive_nodes()``, exactly like a pending-timeout path would.
    """

    def __init__(
        self,
        job_name: str,
        capacity: int = 64,
        on_scale: Optional[Callable[[str, List[Node], List[Node]], None]]
        = None,
        clock: Callable[[], float] = time.time,
    ):
        super().__init__(job_name)
        self._capacity = max(int(capacity), 1)
        self._on_scale = on_scale
        self._clock = clock
        self._nodes: Dict[int, Node] = {}
        self._id_iter = new_node_id_iter(0)
        self.launches_dropped = 0
        self.plans_applied = 0

    # ---- backend surface ---------------------------------------------------

    def next_node_id(self) -> int:
        with self._lock:
            return next(self._id_iter)

    def alive_nodes(self, node_type: Optional[str] = None) -> List[Node]:
        with self._lock:
            nodes = [
                n for n in self._nodes.values()
                if n.status not in NodeStatus.end_states()
                and (node_type is None or n.type == node_type)
            ]
        return sorted(nodes, key=lambda n: (n.type, n.rank_index, n.id))

    def world_size(self, node_type: str = NodeType.WORKER) -> int:
        return len(self.alive_nodes(node_type))

    def find_rank(self, rank: int,
                  node_type: str = NodeType.WORKER) -> Optional[Node]:
        for node in self.alive_nodes(node_type):
            if node.rank_index == rank:
                return node
        return None

    # ---- the Scaler contract -----------------------------------------------

    def scale(self, plan: ScalePlan):
        launched: List[Node] = []
        removed: List[Node] = []
        with self._lock:
            for node in plan.remove_nodes:
                gone = self._remove_locked(node.id)
                if gone is not None:
                    removed.append(gone)
            for node in plan.launch_nodes:
                live = self._launch_locked(node)
                if live is not None:
                    launched.append(live)
            for group_name, group in plan.node_group_resources.items():
                up, down = self._converge_group_locked(group_name, group)
                launched.extend(up)
                removed.extend(down)
            self.plans_applied += 1
        if (launched or removed) and self._on_scale is not None:
            self._on_scale(self._job_name, launched, removed)

    # ---- internals ---------------------------------------------------------

    def _launch_locked(self, node: Node) -> Optional[Node]:
        if node.id in self._nodes:
            return None  # idempotent re-launch
        alive = sum(
            1 for n in self._nodes.values()
            if n.status not in NodeStatus.end_states()
        )
        if alive >= self._capacity:
            self.launches_dropped += 1
            logger.warning(
                "sim scaler: capacity %d full; dropping launch of "
                "node %d", self._capacity, node.id,
            )
            return None
        live = Node(
            node_type=node.type,
            node_id=node.id,
            rank_index=node.rank_index,
            name=node.name or f"{node.type}-{node.id}",
            status=NodeStatus.RUNNING,
            config_resource=node.config_resource,
        )
        live.create_time = self._clock()
        live.host_name = f"sim-host-{node.id}"
        self._nodes[live.id] = live
        return live

    def _remove_locked(self, node_id: int) -> Optional[Node]:
        node = self._nodes.pop(node_id, None)
        if node is None:
            return None
        node.status = NodeStatus.DELETED
        return node

    def _converge_group_locked(self, node_type: str, group):
        alive = sorted(
            (
                n for n in self._nodes.values()
                if n.type == node_type
                and n.status not in NodeStatus.end_states()
            ),
            key=lambda n: n.rank_index,
        )
        delta = group.count - len(alive)
        launched: List[Node] = []
        removed: List[Node] = []
        if delta > 0:
            used_ranks = {n.rank_index for n in alive}
            rank = 0
            for _ in range(delta):
                while rank in used_ranks:
                    rank += 1
                used_ranks.add(rank)
                live = self._launch_locked(Node(
                    node_type,
                    next(self._id_iter),
                    rank_index=rank,
                    config_resource=group.node_resource,
                ))
                if live is not None:
                    launched.append(live)
        elif delta < 0:
            for node in sorted(alive, key=lambda n: -n.rank_index)[:-delta]:
                gone = self._remove_locked(node.id)
                if gone is not None:
                    removed.append(gone)
        return launched, removed
