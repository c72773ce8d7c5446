"""Job manager for local/standalone mode (one host, agent-managed restarts).

Parity: reference dlrover/python/master/node/local_job_manager.py:25.
The master only bookkeeps node state and emits diagnosis actions; actual
process restarts happen in the agent.

The port's copy of ``dlrover_tpu/master/node/local_job_manager.py``.
"""

import time
from typing import List, Optional

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import (
    JobStage,
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.diagnosis.actions import DiagnosisAction
from dlrover_tpu_torch.master.node.job_context import get_job_context


class LocalJobManager:
    def __init__(self, job_name: str = "local", max_relaunch_count: int = 3):
        self._job_name = job_name
        self._job_context = get_job_context()
        self._max_relaunch_count = max_relaunch_count

    def start(self):
        self._job_context.set_job_stage(JobStage.RUNNING)

    def stop(self):
        self._job_context.set_job_stage(JobStage.STOPPING)

    # ---- servicer surface --------------------------------------------------

    def handle_node_joined(self, node_id: int, node_rank: int):
        node = self._job_context.get_node(NodeType.WORKER, node_id)
        if node is None:
            node = Node(
                NodeType.WORKER,
                node_id,
                rank_index=node_rank,
                max_relaunch_count=self._max_relaunch_count,
            )
        elif node.is_end():
            # A re-join after failure is a new incarnation of the node;
            # keep relaunch bookkeeping but restart the status flow.
            node.status = NodeStatus.INITIAL
        node.update_status(NodeStatus.RUNNING)
        node.heartbeat_time = time.time()
        self._job_context.update_node(node)

    def collect_node_heartbeat(
        self, node_id: int, timestamp: float
    ) -> List[DiagnosisAction]:
        node = self._job_context.get_node(NodeType.WORKER, node_id)
        if node is None:
            node = Node(NodeType.WORKER, node_id)
            self._job_context.update_node(node)
        node.heartbeat_time = timestamp
        return self._job_context.drain_node_actions(node_id)

    def handle_node_failure(self, report: comm.NodeFailureReport):
        self._job_context.inc_failure_count()
        node = self._job_context.get_node(NodeType.WORKER, report.node_id)
        if node is None:
            return
        node.relaunch_count = max(node.relaunch_count, report.restart_count)
        if report.level == TrainingExceptionLevel.NODE_ERROR:
            node.update_status(NodeStatus.FAILED)
        self._job_context.update_node(node)

    def handle_node_succeeded(self, node_id: int):
        node = self._job_context.get_node(NodeType.WORKER, node_id)
        if node is not None:
            node.update_status(NodeStatus.SUCCEEDED)
            self._job_context.update_node(node)

    def handle_reported_node_event(self, report: comm.NodeEventReport):
        logger.info(
            "node %d event %s: %s %s",
            report.node_id,
            report.event_type,
            report.reason,
            report.message,
        )
        if report.event_type == NodeEventType.NODE_CHECK_FAILED:
            # Same semantics as the distributed manager: a node that
            # failed its health probes is broken hardware, evicted from
            # scheduling until relaunched.
            node = self._job_context.get_node(NodeType.WORKER, report.node_id)
            if node is not None:
                node.exit_reason = NodeExitReason.HARDWARE_ERROR
                node.update_status(NodeStatus.BREAKDOWN)
                self._job_context.update_node(node)

    def update_node_resource_usage(self, stats: comm.ResourceStats):
        node = self._job_context.get_node(NodeType.WORKER, stats.node_id)
        if node is not None:
            node.update_from_resource_stats(
                stats.cpu_percent, stats.memory_mb
            )

    def update_ckpt_step(self, node_id: int, step: int, committed: bool):
        self._job_context.update_ckpt_step(node_id, step, committed)

    def get_committed_ckpt_step(self) -> int:
        return self._job_context.committed_ckpt_step()

    def get_parallel_config(self) -> Optional[comm.ParallelConfig]:
        return None

    def get_job_detail(self) -> comm.JobDetailResponse:
        nodes = {}
        for node_id, node in self._job_context.get_nodes().items():
            nodes[node_id] = {
                "type": node.type,
                "rank": node.rank_index,
                "status": node.status,
                "relaunch_count": node.relaunch_count,
            }
        return comm.JobDetailResponse(
            job_name=self._job_name,
            stage=self._job_context.job_stage,
            nodes=nodes,
        )

    def restart_worker_processes(self, reason: str):
        """Queue an in-place restart for every still-running node."""
        from dlrover_tpu_torch.diagnosis.actions import NodeAction

        for node in self._job_context.get_nodes().values():
            if node.status == NodeStatus.RUNNING:
                self._job_context.enqueue_action(
                    NodeAction(
                        instance=node.id, node_id=node.id, reason=reason
                    )
                )

    # ---- queries used by the master run loop --------------------------------

    def all_workers_exited(self) -> bool:
        nodes = self._job_context.get_nodes()
        return bool(nodes) and all(n.is_end() for n in nodes.values())

    def all_workers_succeeded(self) -> bool:
        nodes = self._job_context.get_nodes()
        return bool(nodes) and all(
            n.status == NodeStatus.SUCCEEDED for n in nodes.values()
        )
