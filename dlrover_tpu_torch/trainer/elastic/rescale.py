"""Worker-side live-rescale client (docs/DESIGN.md §27).

Drives a worker through the coordinator's versioned plans without the
process ever exiting:

- :meth:`RescaleClient.poll_plan` — cheap pull of a plan newer than the
  one the worker is running under (the plan "broadcast");
- :meth:`RescaleClient.ack` / :meth:`RescaleClient.wait_barrier` — the
  three phase barriers ("barrier" → "restored" → "resumed"), each a
  bounded wait that resolves to ``ready``, ``superseded`` (a newer plan
  exists; pivot to it) or ``expired`` (the coordinator re-planned around
  dead ranks; re-poll).

Fault sites: every barrier poll passes ``rescale.barrier.wait`` (a
``crash`` rule there is a SIGKILL mid-barrier), and
:meth:`mark_resumed` passes ``rescale.resume.first_step`` AFTER acking
the resume — the kill window between restore and the first post-rescale
step the chaos matrix exercises.

The port's copy of ``dlrover_tpu/trainer/elastic/rescale.py``.
"""

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.fault import fault_point

BARRIER_READY = "ready"
BARRIER_EXPIRED = "expired"
BARRIER_SUPERSEDED = "superseded"


@dataclass
class PlanView:
    """Worker-side view of one rescale plan."""

    plan_id: int
    world: Dict[int, int]
    rank_order: List[int]
    restore_step: int
    reason: str
    created_at: float
    barrier_timeout_s: float

    @property
    def world_size(self) -> int:
        return len(self.world)

    def includes(self, rank: int) -> bool:
        return rank in self.world

    def new_rank_index(self, rank: int) -> int:
        """This rank's position in the NEW world's rank order — the
        value fed to ``sampler.rescale(rank, world)`` and used to pick
        the new addressable byte ranges."""
        return self.rank_order.index(rank)

    @classmethod
    def from_response(cls, resp) -> "PlanView":
        return cls(
            plan_id=resp.plan_id,
            world=dict(resp.world),
            rank_order=list(resp.rank_order),
            restore_step=resp.restore_step,
            reason=resp.reason,
            created_at=resp.created_at,
            barrier_timeout_s=resp.barrier_timeout_s,
        )


class RescaleClient:
    def __init__(self, master_client, node_rank: int,
                 poll_interval_s: float = 0.05):
        self._client = master_client
        self._rank = node_rank
        self._poll_s = poll_interval_s

    def join(self, local_world_size: int = 1, node_group: int = -1):
        """``node_group`` is this host's TPU slice/block index (from
        rendezvous); carrying it lets the coordinator keep plan worlds
        slice-complete."""
        self._client.rescale_join(
            self._rank, local_world_size, node_group=node_group
        )

    def poll_plan(self, current_plan_id: int = -1) -> Optional[PlanView]:
        resp = self._client.get_rescale_plan(self._rank, current_plan_id)
        if resp is None:
            return None
        return PlanView.from_response(resp)

    def wait_for_plan(
        self, current_plan_id: int = -1, timeout_s: float = 60.0
    ) -> Optional[PlanView]:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            plan = self.poll_plan(current_plan_id)
            if plan is not None:
                return plan
            time.sleep(self._poll_s)
        return None

    def ack(self, plan_id: int, phase: str):
        self._client.report_rescale_ack(self._rank, plan_id, phase)

    def wait_barrier(
        self, plan_id: int, phase: str, timeout_s: float = 60.0
    ) -> str:
        """Poll a plan's phase barrier; one of BARRIER_READY /
        BARRIER_SUPERSEDED / BARRIER_EXPIRED. The local timeout is a
        backstop only — the coordinator's bounded wait normally expires
        first and re-plans, which surfaces here as expired/superseded."""
        deadline = time.monotonic() + timeout_s
        while True:
            fault_point(
                "rescale.barrier.wait", plan_id=plan_id, phase=phase
            )
            ready, expired, superseded, missing = (
                self._client.get_rescale_barrier(self._rank, plan_id, phase)
            )
            if superseded:
                return BARRIER_SUPERSEDED
            if ready:
                return BARRIER_READY
            if expired:
                return BARRIER_EXPIRED
            if time.monotonic() > deadline:
                logger.warning(
                    "rescale plan %d phase %r: local barrier timeout "
                    "(missing %s)", plan_id, phase, missing
                )
                return BARRIER_EXPIRED
            time.sleep(self._poll_s)

    def mark_resumed(self, plan_id: int):
        """Ack the resume phase and pass the restore-to-first-step kill
        window. Call IMMEDIATELY before the first post-rescale step."""
        self.ack(plan_id, "resumed")
        fault_point("rescale.resume.first_step", plan_id=plan_id)
