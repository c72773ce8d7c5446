"""Exit-reason taxonomy: classify worker exits and budget relaunches
per reason.

Parity: reference dlrover/python/master/node/dist_job_manager.py:996
(_should_relaunch) + common/node.py exit-reason handling — the reference
differentiates OOMKilled / Fatal / preemption when deciding whether a
relaunch is worth a new pod. Here the classification runs from the
agent's failure report (exit code + reason hint mined from worker logs)
as well as from the k8s watcher's container status, and each reason
carries its own relaunch budget:

- PREEMPTED: infra-inflicted, effectively always relaunch (10x budget);
- KILLED (external kill / heartbeat-lost host): 2x budget — likely
  infra, but a kill loop must still terminate;
- OOM / HARDWARE / SOFTWARE / UNKNOWN: 1x budget (OOM additionally
  triggers the resource optimizer's host-memory bump and the
  hyperparam strategy's remat escalation);
- FATAL: zero — a poisoned program must fail fast.

The port's copy of ``dlrover_tpu/master/node/exit_reason.py``.
"""

import re
from typing import Optional

from dlrover_tpu_torch.common.constants import (
    HARDWARE_LOG_MARKERS,
    OOM_LOG_MARKERS,
    RELAUNCH_BUDGET_FACTOR,
    ExitCode,
    NodeExitReason,
)

_OOM_RE = re.compile("|".join(OOM_LOG_MARKERS), re.IGNORECASE)
_HARDWARE_RE = re.compile("|".join(HARDWARE_LOG_MARKERS), re.IGNORECASE)
_REASON_HINT_RE = re.compile(r"reason=([A-Za-z]+)")

_HINTABLE = {
    NodeExitReason.OOM,
    NodeExitReason.HARDWARE_ERROR,
    NodeExitReason.SOFTWARE_ERROR,
    NodeExitReason.PREEMPTED,
    NodeExitReason.KILLED,
    NodeExitReason.FATAL_ERROR,
}


def classify_exit(exit_code: int, message: str = "") -> Optional[str]:
    """Map a worker exit (code + evidence string) to a NodeExitReason.

    ``message`` is the agent's error_data — it may carry an explicit
    ``reason=X`` hint (agent-side log diagnosis) which wins over the
    code, since e.g. an HBM OOM and a segfault can share exit code 1.
    Returns None for a clean exit.
    """
    if exit_code == ExitCode.SUCCESS and not message:
        return None
    hint = _REASON_HINT_RE.search(message or "")
    if hint and hint.group(1) in _HINTABLE:
        return hint.group(1)
    if message:
        if _OOM_RE.search(message):
            return NodeExitReason.OOM
        if _HARDWARE_RE.search(message):
            return NodeExitReason.HARDWARE_ERROR
    if exit_code == ExitCode.KILLED:
        return NodeExitReason.KILLED
    if exit_code == ExitCode.TERMED:
        return NodeExitReason.PREEMPTED
    if exit_code in (ExitCode.HARDWARE_ERROR, ExitCode.GPU_DRIVER_ERROR,
                     ExitCode.NODE_CHECK_FAILED):
        return NodeExitReason.HARDWARE_ERROR
    if exit_code != ExitCode.SUCCESS:
        return NodeExitReason.SOFTWARE_ERROR
    return NodeExitReason.UNKNOWN


def relaunch_budget(reason: str, max_relaunch_count: int) -> int:
    factor = RELAUNCH_BUDGET_FACTOR.get(
        reason or NodeExitReason.UNKNOWN, 1.0
    )
    return int(max_relaunch_count * factor)
