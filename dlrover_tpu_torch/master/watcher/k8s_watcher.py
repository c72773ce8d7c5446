"""Kubernetes Pod watcher: pod events -> NodeEvents.

Parity: reference dlrover/python/master/watcher/k8s_watcher.py:274
(PodWatcher) — maps pod phases and container termination details onto
the node status flow, including the exit reasons the relaunch policy
keys on (OOMKilled, preemption, TPU-host faults).

The port's copy of ``dlrover_tpu/master/watcher/k8s_watcher.py``.
"""

import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import (
    ExitCode,
    NodeExitReason,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node, NodeEvent, NodeResource
from dlrover_tpu_torch.master.scheduler.k8s_client import K8sApi, get_k8s_api
from dlrover_tpu_torch.master.watcher.base_watcher import NodeWatcher

_PHASE_TO_STATUS = {
    "Pending": NodeStatus.PENDING,
    "Running": NodeStatus.RUNNING,
    "Succeeded": NodeStatus.SUCCEEDED,
    "Failed": NodeStatus.FAILED,
    "Unknown": NodeStatus.UNKNOWN,
}


def _termination_exit_reason(pod: Dict) -> str:
    """Derive the relaunch-policy exit reason from container state +
    pod conditions (reference k8s_watcher _get_pod_exit_reason)."""
    status = pod.get("status", {})
    reason = status.get("reason", "")
    if reason in ("Preempted", "Evicted", "Shutdown"):
        return NodeExitReason.PREEMPTED
    for cs in status.get("containerStatuses", []) or []:
        term = (cs.get("state", {}) or {}).get("terminated")
        if not term:
            term = (cs.get("lastState", {}) or {}).get("terminated")
        if not term:
            continue
        if term.get("reason") == "OOMKilled":
            return NodeExitReason.OOM
        code = term.get("exitCode", 0)
        if code in (ExitCode.HARDWARE_ERROR, ExitCode.GPU_DRIVER_ERROR):
            return NodeExitReason.HARDWARE_ERROR
        if code == ExitCode.NODE_CHECK_FAILED:
            return NodeExitReason.HARDWARE_ERROR
        if code in (ExitCode.KILLED, ExitCode.TERMED):
            return NodeExitReason.KILLED
        if code != 0:
            return NodeExitReason.FATAL_ERROR
    return ""


def pod_to_node(pod: Dict) -> Optional[Node]:
    meta = pod.get("metadata", {})
    labels = meta.get("labels", {}) or {}
    if labels.get("app") != "dlrover-tpu":
        return None
    try:
        node_id = int(labels.get("node-id", "-1"))
        rank = int(labels.get("rank-index", node_id))
    except ValueError:
        return None
    if node_id < 0:
        return None
    status = pod.get("status", {})
    node = Node(
        node_type=labels.get("node-type", NodeType.WORKER),
        node_id=node_id,
        rank_index=rank,
        name=meta.get("name", ""),
        host_name=pod.get("spec", {}).get("nodeName", ""),
        host_ip=status.get("podIP", "") or status.get("hostIP", ""),
        status=_PHASE_TO_STATUS.get(
            status.get("phase", ""), NodeStatus.UNKNOWN
        ),
        config_resource=NodeResource(),
    )
    node.exit_reason = _termination_exit_reason(pod)
    return node


class PodWatcher(NodeWatcher):
    def __init__(
        self,
        job_name: str,
        namespace: str = "default",
        api: Optional[K8sApi] = None,
    ):
        super().__init__(job_name)
        self._namespace = namespace
        self._api = api or get_k8s_api()
        self._label_selector = f"app=dlrover-tpu,job-name={job_name}"
        self._stopped = False

    def watch(self):
        while not self._stopped:
            try:
                for raw in self._api.watch_pods(
                    self._namespace, self._label_selector
                ):
                    if self._stopped:
                        return
                    node = pod_to_node(raw.get("object", {}))
                    if node is None:
                        continue
                    yield NodeEvent(raw.get("type", "MODIFIED"), node)
            except GeneratorExit:
                raise
            except Exception:
                if self._stopped:
                    return
                logger.exception("pod watch stream broke; re-watching")
                time.sleep(2.0)  # don't hot-loop a broken API server

    def list(self) -> List[Node]:
        nodes = []
        for pod in self._api.list_pods(
            self._namespace, self._label_selector
        ):
            node = pod_to_node(pod)
            if node is not None:
                nodes.append(node)
        return nodes

    def stop(self):
        self._stopped = True
