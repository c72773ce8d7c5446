"""Diagnosis action hierarchy.

Parity: reference dlrover/python/diagnosis/common/diagnosis_action.py
(NoAction/EventAction/NodeAction/JobRestartAction/JobAbortionAction).
Actions are produced by diagnosticians on the master and piggy-backed on
heartbeat responses for the agent to execute (reference
servicer.py:_report_heartbeat, elastic_agent training.py:1489).

The port's copy of ``dlrover_tpu/diagnosis/actions.py``.
"""

import time
from dataclasses import dataclass, field
from typing import Dict

from dlrover_tpu_torch.common.constants import (
    DiagnosisActionType,
    DiagnosisConstant,
)
from dlrover_tpu_torch.common.serialize import PickleSerializable


@dataclass
class DiagnosisAction(PickleSerializable):
    action_type: str = DiagnosisActionType.NONE
    instance: int = DiagnosisConstant.MASTER_INSTANCE
    reason: str = ""
    timestamp: float = field(default_factory=time.time)
    expired_secs: float = DiagnosisConstant.ACTION_EXPIRED_SECS

    def is_expired(self) -> bool:
        return time.time() - self.timestamp > self.expired_secs

    def is_needed(self) -> bool:
        return (
            self.action_type != DiagnosisActionType.NONE
            and not self.is_expired()
        )


@dataclass
class NoAction(DiagnosisAction):
    action_type: str = DiagnosisActionType.NONE


@dataclass
class EventAction(DiagnosisAction):
    """Surface an observability event (no behavior change)."""

    action_type: str = DiagnosisActionType.EVENT
    event_type: str = "info"
    event_msg: str = ""
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class NodeAction(DiagnosisAction):
    """Restart worker processes in place, or relaunch the node."""

    action_type: str = DiagnosisActionType.RESTART_WORKER
    node_id: int = -1
    node_status: str = ""


@dataclass
class JobRestartAction(DiagnosisAction):
    action_type: str = DiagnosisActionType.JOB_RESTART


@dataclass
class JobAbortionAction(DiagnosisAction):
    action_type: str = DiagnosisActionType.JOB_ABORT
