"""Scaler abstraction: apply a ScalePlan to the cluster backend.

Parity: reference dlrover/python/master/scaler/base_scaler.py (Scaler,
ScalePlan). A ScalePlan is the master's declarative "make the cluster look
like this" order: per-role group sizes plus explicit node launches/removals.
Backends: the in-memory simulator (testing/sim_cluster.py), the k8s Pod
scaler (pod_scaler.py, reference pod_scaler.py:84), and the GKE JobSet
flavor for TPU slices.

The port's copy of ``dlrover_tpu/master/scaler/base_scaler.py``, with
the same backends: ``sim_scaler.py``, ``pod_scaler.py`` and
``elasticjob_scaler.py``.
"""

import abc
import threading
from dataclasses import dataclass, field
from typing import Dict, List

from dlrover_tpu_torch.common.node import Node, NodeGroupResource


@dataclass
class ScalePlan:
    """Declarative scale order emitted by the job manager / auto-scaler.

    ``node_group_resources`` sets the target size+resource of each role
    group; ``launch_nodes`` / ``remove_nodes`` are explicit singles (used
    for relaunch and hot migration, reference base_scaler.py ScalePlan).
    """

    node_group_resources: Dict[str, NodeGroupResource] = field(
        default_factory=dict
    )
    launch_nodes: List[Node] = field(default_factory=list)
    remove_nodes: List[Node] = field(default_factory=list)
    ps_addrs: List[str] = field(default_factory=list)

    def empty(self) -> bool:
        return (
            not self.node_group_resources
            and not self.launch_nodes
            and not self.remove_nodes
        )

    def merge(self, other: "ScalePlan"):
        self.node_group_resources.update(other.node_group_resources)
        self.launch_nodes.extend(other.launch_nodes)
        self.remove_nodes.extend(other.remove_nodes)
        if other.ps_addrs:
            self.ps_addrs = other.ps_addrs


class Scaler(abc.ABC):
    """Applies ScalePlans to a concrete cluster backend."""

    def __init__(self, job_name: str):
        self._job_name = job_name
        self._lock = threading.Lock()

    def start(self):
        pass

    def stop(self):
        pass

    def set_master_addr(self, addr: str):
        """Late-bind the master's RPC address (known only once the server
        starts) into whatever the backend injects into workers. No-op for
        backends that don't launch agent processes."""

    @abc.abstractmethod
    def scale(self, plan: ScalePlan):
        """Make the backend converge to the plan. Must be idempotent."""


def new_node_id_iter(start: int = 0):
    """Monotonic node-id allocator shared by scalers."""
    next_id = start
    while True:
        yield next_id
        next_id += 1
