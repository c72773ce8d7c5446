"""Job auto-scaler: periodically apply optimizer resource plans.

Parity: reference dlrover/python/master/node/job_auto_scaler.py:71-375
(AllreduceTrainingAutoScaler) — a loop that asks the resource optimizer
for a plan and converges the worker group to it through the scaler. For
TPU SPMD jobs, changing the worker count triggers a rendezvous round
(the agents detect waiting-node changes and re-mesh), so the scaler only
has to adjust the group; elasticity is handled by the normal
membership-change path.

The port's copy of ``dlrover_tpu/master/node/job_auto_scaler.py``.
"""

import threading

from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.resource.optimizer import (
    ResourceOptimizer,
    ResourcePlan,
)


class AllreduceTrainingAutoScaler:
    def __init__(
        self,
        job_manager,
        scaler,
        optimizer: ResourceOptimizer,
        interval_s: float = 60.0,
        rdzv_managers=None,
    ):
        self._job_manager = job_manager
        self._scaler = scaler
        self._optimizer = optimizer
        self._interval_s = interval_s
        self._rdzv_managers = rdzv_managers or {}
        self._stopped = threading.Event()
        self._thread = None

    def start(self):
        self._stopped.clear()
        self._thread = threading.Thread(
            target=self._loop, name="job-auto-scaler", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def scale_once(self):
        if hasattr(self._optimizer, "record_speed"):
            self._optimizer.record_speed()
        plan = self._optimizer.generate_plan()
        if plan.empty():
            return
        self.execute_plan(plan)

    def execute_plan(self, plan: ResourcePlan):
        group = plan.node_group_resources.get(NodeType.WORKER)
        if group is None:
            return
        worker_manager = self._job_manager.worker_manager
        current = len(worker_manager.alive_nodes())
        logger.info(
            "auto-scaler plan: workers %d -> %d (%s)",
            current,
            group.count,
            plan.comment,
        )
        from dlrover_tpu_torch.training_event import MasterEvents

        MasterEvents.scale_plan(plan.comment, group.count)
        # Adopt the (possibly resource-bumped) template so relaunches and
        # new nodes use it even when the count is unchanged. Count-only
        # plans carry an empty template and must not wipe the live one.
        if not group.node_resource.is_empty():
            worker_manager.group_resource.node_resource = (
                group.node_resource
            )
        scale_plan = worker_manager.adjust_worker(group.count)
        if not scale_plan.empty():
            self._scaler.scale(scale_plan)
        # A new target count must also move the rendezvous window, or the
        # next round keeps completing at the old world size and freshly
        # launched workers wait forever (reference job_auto_scaler
        # updates rdzv params alongside the plan).
        for mgr in self._rdzv_managers.values():
            mgr.update_rdzv_params(
                min_nodes=group.count, max_nodes=group.count
            )

    def _loop(self):
        while not self._stopped.wait(self._interval_s):
            try:
                self.scale_once()
            except Exception:
                logger.exception("auto-scale round failed")
