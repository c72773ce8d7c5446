"""Node-failure diagnosticians.

Parity: reference dlrover/python/diagnosis/diagnostician/node_failure.py:79
(repeated failures -> abort) and node_inconsistency.py:105 (nodes whose
reported state disagrees with the master record).

The port's copy of ``dlrover_tpu/diagnosis/diagnosticians/node_failure.py``.
"""

from dlrover_tpu_torch.common.constants import NodeStatus
from dlrover_tpu_torch.diagnosis.actions import (
    DiagnosisAction,
    EventAction,
    JobAbortionAction,
)
from dlrover_tpu_torch.diagnosis.diagnostician import Diagnostician, Observation
from dlrover_tpu_torch.master.node.job_context import get_job_context


class NodeFailureDiagnostician(Diagnostician):
    """Aborts the job when the cluster keeps killing whatever we launch —
    the failure budget is global, not per-node."""

    observe_interval_s = 30.0

    def __init__(self, max_total_failures: int = 20):
        self._max_total_failures = max_total_failures

    def observe(self, **kwargs) -> Observation:
        count = get_job_context().failure_count
        if count >= self._max_total_failures:
            return Observation(
                observation="excessive-node-failures",
                extra={"failures": str(count)},
            )
        return Observation()

    def resolve(self, ob: Observation, **kwargs) -> DiagnosisAction:
        return JobAbortionAction(
            reason=(
                f"{ob.extra.get('failures')} node failures exceed the "
                f"budget of {self._max_total_failures}"
            )
        )


class NodeInconsistencyDiagnostician(Diagnostician):
    """Flags nodes the master believes RUNNING that reported SUCCEEDED
    (reference node_inconsistency.py): usually a missed watch event."""

    observe_interval_s = 60.0

    def observe(self, **kwargs) -> Observation:
        stale = []
        for node in get_job_context().get_nodes().values():
            if (
                node.status == NodeStatus.RUNNING
                and node.reported_status == NodeStatus.SUCCEEDED
            ):
                stale.append(node.name)
        if stale:
            return Observation(
                observation="node-state-inconsistency",
                extra={"nodes": ",".join(stale)},
            )
        return Observation()

    def resolve(self, ob: Observation, **kwargs) -> DiagnosisAction:
        return EventAction(
            event_type="warning",
            event_msg=f"inconsistent node states: {ob.extra.get('nodes')}",
            reason=ob.observation,
        )
