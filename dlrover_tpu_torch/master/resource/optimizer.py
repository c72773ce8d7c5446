"""Resource plans and optimizers.

Parity: reference dlrover/python/master/resource/job.py (PS/Allreduce
JobResourceOptimizer:569), local_optimizer.py (PSLocalOptimizer:66) and
brain_optimizer.py — re-scoped for TPU SPMD jobs: the tunable is the
worker (host) count within *legal mesh shapes*, plus host-memory bumps
after OOM kills. The Brain-service flavor is a stub hook: single-job
local heuristics cover the standalone deployment; a cluster brain can
implement ResourceOptimizer and be dropped in.

The port's copy of ``dlrover_tpu/master/resource/optimizer.py``.
"""

import abc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import NodeExitReason, NodeType
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import NodeGroupResource


@dataclass
class ResourcePlan:
    """What the job's role groups should look like."""

    node_group_resources: Dict[str, NodeGroupResource] = field(
        default_factory=dict
    )
    comment: str = ""

    def empty(self) -> bool:
        return not self.node_group_resources


class ResourceOptimizer(abc.ABC):
    @abc.abstractmethod
    def generate_plan(self) -> ResourcePlan:
        """Return the desired resource plan; empty plan = no change."""


@dataclass
class _SpeedSample:
    worker_count: int
    speed: float  # steps/s observed at that count
    at: float


class AllreduceLocalOptimizer(ResourceOptimizer):
    """Throughput-aware worker-count tuner for SPMD (psum) training.

    Heuristics (mirroring the reference's local optimizer intent, TPU
    legality added):
    - only suggest counts from ``legal_counts`` (mesh-shape legality:
      e.g. powers of two, multiples of node_unit);
    - grow while marginal scaling efficiency stays above
      ``min_scaling_efficiency`` (measured from recorded speed samples);
    - after an OOM exit, bump host memory 50% instead of scaling;
    - never change the count twice within ``cooldown_s``.
    """

    def __init__(
        self,
        job_manager,
        perf_monitor,
        legal_counts: Optional[List[int]] = None,
        min_scaling_efficiency: float = 0.7,
        cooldown_s: float = 300.0,
    ):
        self._job_manager = job_manager
        self._perf_monitor = perf_monitor
        self._legal_counts = sorted(legal_counts) if legal_counts else None
        self._min_eff = min_scaling_efficiency
        self._cooldown_s = cooldown_s
        self._samples: List[_SpeedSample] = []
        self._last_change = 0.0
        # Node ids whose OOM has already been answered with a memory
        # bump: dead records keep exit_reason forever, and one OOM must
        # not compound the bump every round.
        self._oom_handled: set = set()

    # ---- observations -------------------------------------------------------

    def record_speed(self):
        speed = self._perf_monitor.running_speed()
        # Only RUNNING nodes train; PENDING nodes mid-scale-up would
        # book the old world's speed under the new count.
        count = len(self._job_manager.worker_manager.running_nodes())
        if speed > 0 and count > 0:
            self._samples.append(_SpeedSample(count, speed, time.time()))
            del self._samples[:-64]

    def _speed_at(self, count: int) -> float:
        speeds = [s.speed for s in self._samples if s.worker_count == count]
        return sum(speeds) / len(speeds) if speeds else 0.0

    # ---- plan ---------------------------------------------------------------

    def generate_plan(self) -> ResourcePlan:
        plan = ResourcePlan()
        now = time.time()
        if now - self._last_change < self._cooldown_s:
            return plan
        worker_manager = self._job_manager.worker_manager
        group = worker_manager.group_resource
        current = group.count

        oom_plan = self._oom_memory_plan(group)
        if oom_plan is not None:
            self._last_change = now
            return oom_plan

        target = self._next_count(current)
        if target == current:
            return plan
        new_group = NodeGroupResource(
            count=target, node_resource=group.node_resource
        )
        plan.node_group_resources[NodeType.WORKER] = new_group
        plan.comment = f"scale {current} -> {target}"
        self._last_change = now
        return plan

    def _oom_memory_plan(self, group) -> Optional[ResourcePlan]:
        ooms = [
            n
            for n in self._job_manager.worker_manager.nodes.values()
            if n.exit_reason == NodeExitReason.OOM
            and n.id not in self._oom_handled
        ]
        if not ooms:
            return None
        self._oom_handled.update(n.id for n in ooms)
        old = group.node_resource.memory_mb
        if old <= 0:
            return None  # unlimited/unspecified: nothing to bump
        group.node_resource.memory_mb = old * 1.5
        logger.info(
            "OOM observed on %d nodes: host memory %.0f -> %.0f MB",
            len(ooms),
            old,
            group.node_resource.memory_mb,
        )
        plan = ResourcePlan(comment="oom-memory-bump")
        plan.node_group_resources[NodeType.WORKER] = group
        return plan

    def _next_count(self, current: int) -> int:
        if not self._legal_counts:
            # Without an explicit legal-shape list there is no safe upper
            # bound to grow toward (TPU mesh shapes are physical): leave
            # the count alone; only OOM memory bumps apply.
            return current
        candidates = self._legal_counts
        cur_speed = self._speed_at(current)
        if cur_speed <= 0:
            return current  # no evidence yet

        # Retreat first: if we grew here and the measured efficiency vs
        # the next smaller legal count is poor, step back down.
        smaller = [c for c in candidates if c < current]
        if smaller:
            prev = max(smaller)
            prev_speed = self._speed_at(prev)
            if prev_speed > 0:
                eff = (cur_speed / prev_speed) / (current / prev)
                if eff < self._min_eff:
                    return prev
        bigger = [c for c in candidates if c > current]
        if not bigger:
            return current
        target = min(bigger)
        seen_target = self._speed_at(target)
        if seen_target > 0:
            # Already tried the bigger size: grow again only if it was
            # efficient back then.
            eff = (seen_target / cur_speed) / (target / current)
            if eff < self._min_eff:
                return current
        return target
