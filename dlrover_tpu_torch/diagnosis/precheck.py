"""Pre-check operators: gate training start on cluster health.

Parity: reference dlrover/python/master/diagnosis/precheck_operator.py
(PreCheckOperator base :91, SchedulingPreCheckOperator,
ConnectionPreCheckOperator :352). The DiagnosisMaster runs each operator
with retries before the servicer reports PASS to waiting agents
(reference trainer elastic_run.py:295 wait_pre_check).

The port's copy of ``dlrover_tpu/diagnosis/precheck.py``.
"""

import abc
import time
from dataclasses import dataclass, field
from typing import List

from dlrover_tpu_torch.common.constants import NodeStatus
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.node.job_context import get_job_context


@dataclass
class PreCheckResult:
    passed: bool = True
    reason: str = ""
    abnormal_nodes: List[int] = field(default_factory=list)


class PreCheckOperator(abc.ABC):
    """One pre-flight condition; retried until timeout."""

    retry_interval_s: float = 5.0
    timeout_s: float = 300.0

    @property
    def name(self) -> str:
        return type(self).__name__

    @abc.abstractmethod
    def check(self) -> PreCheckResult:
        ...

    def run_with_retries(self) -> PreCheckResult:
        deadline = time.time() + self.timeout_s
        result = self.check()
        while not result.passed and time.time() < deadline:
            logger.info(
                "pre-check %s not passing yet: %s", self.name, result.reason
            )
            time.sleep(self.retry_interval_s)
            result = self.check()
        return result


class SchedulingPreCheckOperator(PreCheckOperator):
    """All requested nodes left Pending (reference
    precheck_operator.py SchedulingPreCheckOperator): a cluster that can't
    schedule the job should fail fast, before agents wait on rendezvous."""

    def __init__(self, job_manager, timeout_s: float = 300.0):
        self._job_manager = job_manager
        self.timeout_s = timeout_s

    def check(self) -> PreCheckResult:
        pending = self._job_manager.worker_manager.pending_nodes()
        if pending:
            return PreCheckResult(
                passed=False,
                reason=f"{len(pending)} workers still pending",
                abnormal_nodes=[n.id for n in pending],
            )
        return PreCheckResult(passed=True)


class ConnectionPreCheckOperator(PreCheckOperator):
    """All scheduled nodes made at least one RPC to the master within the
    window (reference ConnectionPreCheckOperator :352). Any RPC counts —
    agents poll wait_pre_check before their first heartbeat, so requiring
    heartbeats here would deadlock the gate against the agents it gates.

    ``contact_provider`` returns {node_id: last_contact_wall_time}; wired
    to MasterServicer.node_last_contact.
    """

    def __init__(
        self,
        contact_provider,
        timeout_s: float = 300.0,
        window_s: float = 120.0,
    ):
        self._contact_provider = contact_provider
        self.timeout_s = timeout_s
        self._window_s = window_s

    def check(self) -> PreCheckResult:
        contacts = self._contact_provider() or {}
        silent = []
        now = time.time()
        for node in get_job_context().get_nodes().values():
            if node.status != NodeStatus.RUNNING:
                continue
            # Agents self-report node_id == their rank (run CLI), which
            # survives relaunches; master-internal record ids do not.
            last = contacts.get(node.rank_index, node.heartbeat_time)
            if last <= 0 or (now - last > self._window_s):
                silent.append(node.id)
        if silent:
            return PreCheckResult(
                passed=False,
                reason=f"nodes {silent} have not connected to the master",
                abnormal_nodes=silent,
            )
        return PreCheckResult(passed=True)
