"""In-memory job state shared by master components.

Parity: reference dlrover/python/master/node/job_context.py:44 (JobContext
singleton: nodes, job stage, pending diagnosis action queue).

The port's copy of ``dlrover_tpu/master/node/job_context.py``.
"""

import threading
from collections import deque
from typing import Deque, Dict, Optional

from dlrover_tpu_torch.common.constants import JobStage, NodeType
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.diagnosis.actions import DiagnosisAction


class JobContext:
    _instance: Optional["JobContext"] = None
    _singleton_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.RLock()
        self._nodes: Dict[str, Dict[int, Node]] = {}
        self._job_stage = JobStage.INIT
        self._actions: Deque[DiagnosisAction] = deque()
        self._node_actions: Dict[int, Deque[DiagnosisAction]] = {}
        self._committed_ckpt_step = -1
        self._node_ckpt_steps: Dict[int, int] = {}
        self._failure_count = 0
        self._restart_count = 0

    @classmethod
    def singleton_instance(cls) -> "JobContext":
        if cls._instance is None:
            with cls._singleton_lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    @classmethod
    def reset_singleton(cls):
        with cls._singleton_lock:
            cls._instance = None

    # ---- nodes -------------------------------------------------------------

    def update_node(self, node: Node):
        with self._lock:
            self._nodes.setdefault(node.type, {})[node.id] = node

    def get_node(self, node_type: str, node_id: int) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(node_type, {}).get(node_id)

    def find_node_by_id(self, node_id: int) -> Optional[Node]:
        with self._lock:
            for nodes in self._nodes.values():
                if node_id in nodes:
                    return nodes[node_id]
            return None

    def get_nodes(self, node_type: str = NodeType.WORKER) -> Dict[int, Node]:
        with self._lock:
            return dict(self._nodes.get(node_type, {}))

    def remove_node(self, node_type: str, node_id: int):
        with self._lock:
            self._nodes.get(node_type, {}).pop(node_id, None)

    # ---- job stage ---------------------------------------------------------

    @property
    def job_stage(self) -> str:
        with self._lock:
            return self._job_stage

    def set_job_stage(self, stage: str):
        with self._lock:
            changed = stage != self._job_stage
            self._job_stage = stage
        if changed:
            from dlrover_tpu_torch.training_event import MasterEvents

            MasterEvents.job_stage(stage)

    # ---- diagnosis actions -------------------------------------------------

    def enqueue_action(self, action: DiagnosisAction):
        with self._lock:
            if action.instance >= 0:
                self._node_actions.setdefault(
                    action.instance, deque()
                ).append(action)
            else:
                self._actions.append(action)

    def next_master_action(self) -> Optional[DiagnosisAction]:
        with self._lock:
            while self._actions:
                action = self._actions.popleft()
                if not action.is_expired():
                    return action
            return None

    def drain_node_actions(self, node_id: int):
        with self._lock:
            q = self._node_actions.get(node_id)
            if not q:
                return []
            actions = [a for a in q if not a.is_expired()]
            q.clear()
            return actions

    # ---- checkpoint bookkeeping -------------------------------------------

    def update_ckpt_step(self, node_id: int, step: int, committed: bool):
        with self._lock:
            self._node_ckpt_steps[node_id] = step
            if committed:
                self._committed_ckpt_step = max(
                    self._committed_ckpt_step, step
                )

    def committed_ckpt_step(self) -> int:
        with self._lock:
            return self._committed_ckpt_step

    # ---- counters ----------------------------------------------------------

    def inc_failure_count(self):
        with self._lock:
            self._failure_count += 1

    @property
    def failure_count(self):
        with self._lock:
            return self._failure_count


def get_job_context() -> JobContext:
    return JobContext.singleton_instance()
