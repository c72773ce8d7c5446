"""Actuator layer: bind ScaleDecisions to the subsystems that move.

Three concrete actuators cover the decision taxonomy:

- :class:`TrainWorldActuator` — training-world changes through the
  :class:`~dlrover_tpu_torch.master.scaler.base_scaler.Scaler` ABC
  (``ScalePlan`` launch/remove, group resize) and, when wired, the §27
  rescale coordinator (``evict_worker`` cuts the scale-down plan that
  rolls the surviving world forward without a restart).
- :class:`FleetActuator` — serving-fleet sizing through the §28
  :class:`FleetRouter` (``add_replica`` / ``drain_replica``), replicas
  built by a caller-supplied factory.
- :class:`CadenceController` — the flash-ckpt cadence knob: a
  thread-safe holder the training loop polls (``interval_s()``) and
  the SET_CKPT_INTERVAL decision writes. Also a SignalBus source so
  the policy sees the cadence it is steering (``as_source``).

Each actuator is a plain object with decision-shaped methods; the
:class:`~dlrover_tpu_torch.autoscaler.loop.AutoScaler` binds them by action
name. An unbound action is *advisory* — recorded in the ledger, acted
on by nobody — which is exactly how a master publishes a cadence
recommendation it has no channel to push.

The port's copy of ``dlrover_tpu/autoscaler/actuator.py``.
"""

import threading
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.autoscaler.policy import (
    EVICT_STRAGGLER,
    GROW_FLEET,
    GROW_WORLD,
    SEED_WORLD,
    SET_CKPT_INTERVAL,
    SHRINK_FLEET,
    SHRINK_WORLD,
    ScaleDecision,
)
from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node, NodeGroupResource
from dlrover_tpu_torch.master.scaler.base_scaler import ScalePlan


class CadenceController:
    """The checkpoint-cadence knob, shared between the autoscaler (the
    writer) and whatever paces saves (the reader): the soak harness's
    sim trainer, or a real training loop polling ``interval_s()``
    between steps. Tracks the measured per-save blocking cost so the
    policy's Young/Daly math uses live numbers."""

    def __init__(self, interval_s: float,
                 save_block_s: float = 0.01,
                 drain_s: float = 0.0):
        self._lock = threading.Lock()
        self._interval_s = float(interval_s)
        self._save_block_s = float(save_block_s)
        self._drain_s = float(drain_s)
        self._retunes = 0

    def interval_s(self) -> float:
        with self._lock:
            return self._interval_s

    def set_interval_s(self, value: float):
        with self._lock:
            self._interval_s = max(float(value), 1e-4)
            self._retunes += 1

    def record_save_block(self, seconds: float):
        with self._lock:
            self._save_block_s = float(seconds)

    def record_drain(self, seconds: float):
        with self._lock:
            self._drain_s = float(seconds)

    @property
    def retunes(self) -> int:
        with self._lock:
            return self._retunes

    def as_source(self) -> Callable[[], Dict[str, object]]:
        def fn() -> Dict[str, object]:
            with self._lock:
                return {
                    "interval_s": self._interval_s,
                    "save_block_s": self._save_block_s,
                    "drain_s": self._drain_s,
                }
        return fn

    def apply(self, decision: ScaleDecision):
        self.set_interval_s(float(decision.target))


class TrainWorldActuator:
    """Training-world moves through a ``Scaler`` backend.

    ``nodes_fn`` returns the live worker :class:`Node` list (the sim
    scaler's ``alive_nodes``, or a job manager's);``node_id_fn``
    allocates fresh node ids. ``coordinator`` (optional) is the §27
    rescale coordinator: evictions tell it first so the surviving
    world re-plans instead of waiting out a barrier on a rank the
    scaler already removed.
    """

    def __init__(
        self,
        scaler,
        nodes_fn: Callable[[], List[Node]],
        node_id_fn: Callable[[], int],
        coordinator=None,
        node_type: str = NodeType.WORKER,
        on_evicted: Optional[Callable[[int], None]] = None,
    ):
        self._scaler = scaler
        self._nodes_fn = nodes_fn
        self._node_id_fn = node_id_fn
        self._coordinator = coordinator
        self._node_type = node_type
        # Typically PerfMonitor.reset_rank: the seat's next occupant
        # must not inherit the evictee's slow step-time EWMA.
        self._on_evicted = on_evicted

    @classmethod
    def for_sim(cls, sim_scaler, coordinator=None,
                on_evicted: Optional[Callable[[int], None]] = None
                ) -> "TrainWorldActuator":
        return cls(
            sim_scaler,
            nodes_fn=sim_scaler.alive_nodes,
            node_id_fn=sim_scaler.next_node_id,
            coordinator=coordinator,
            on_evicted=on_evicted,
        )

    def world_size(self) -> int:
        return len(self._nodes_fn())

    def as_source(self) -> Callable[[], Dict[str, object]]:
        def fn() -> Dict[str, object]:
            return {"size": self.world_size()}
        return fn

    def evict(self, decision: ScaleDecision):
        """Evict-and-replace: remove the flagged rank's node, launch a
        fresh one in the same seat count (world size is preserved; the
        *host* is what the decision condemns)."""
        rank = int(decision.target)
        victims = [
            n for n in self._nodes_fn()
            if n.rank_index == rank and n.type == self._node_type
        ]
        if not victims:
            raise ValueError(f"no live {self._node_type} with rank {rank}")
        victim = victims[0]
        if self._coordinator is not None:
            self._coordinator.evict_worker(rank, reason="straggler_evict")
        replacement = Node(
            self._node_type,
            self._node_id_fn(),
            rank_index=rank,
            config_resource=victim.config_resource,
        )
        plan = ScalePlan(
            launch_nodes=[replacement], remove_nodes=[victim]
        )
        self._scaler.scale(plan)
        if self._on_evicted is not None:
            self._on_evicted(rank)
        logger.info(
            "autoscaler evicted straggler rank %d (node %d -> node %d)",
            rank, victim.id, replacement.id,
        )

    def set_world(self, decision: ScaleDecision):
        target = int(decision.target)
        plan = ScalePlan()
        plan.node_group_resources[self._node_type] = NodeGroupResource(
            count=target
        )
        self._scaler.scale(plan)
        logger.info("autoscaler set %s world -> %d",
                    self._node_type, target)

    def bindings(self) -> Dict[str, Callable[[ScaleDecision], None]]:
        return {
            EVICT_STRAGGLER: self.evict,
            GROW_WORLD: self.set_world,
            SHRINK_WORLD: self.set_world,
            SEED_WORLD: self.set_world,
        }


class FleetActuator:
    """Serving-fleet sizing through the FleetRouter.

    ``replica_factory(replica_id) -> replica`` builds whatever replica
    flavor the deployment runs (thread, subprocess). Draining is
    last-added-first over the replicas THIS actuator added (a
    grow/shrink pair is a no-op fleet and the original replicas are
    never touched while an added one remains); with none of its own
    left it falls back to the router's lexicographically-last id.
    ``drain_replica`` live-migrates in-flight decodes off the victim
    (§36) before anything requeues from zero, so a shrink decision
    costs each in-flight request a migration pause, not a re-prefill."""

    def __init__(self, router, replica_factory: Callable[[str], object],
                 id_prefix: str = "as"):
        self._router = router
        self._factory = replica_factory
        self._prefix = id_prefix
        self._next = 0
        self._added: List[str] = []   # LIFO of ids this actuator grew

    def grow(self, decision: ScaleDecision):
        rid = f"{self._prefix}{self._next}"
        self._next += 1
        replica = self._factory(rid)
        self._router.add_replica(replica)
        self._added.append(rid)
        logger.info("autoscaler added fleet replica %s", rid)

    def shrink(self, decision: ScaleDecision):
        ids = self._router.replica_ids()
        if len(ids) <= 1:
            raise ValueError("refusing to drain the last fleet replica")
        present = set(ids)
        rid = None
        while self._added:
            candidate = self._added.pop()
            if candidate in present:   # router may have dropped it
                rid = candidate
                break
        if rid is None:
            rid = ids[-1]
        self._router.drain_replica(rid)
        logger.info("autoscaler drained fleet replica %s", rid)

    def bindings(self) -> Dict[str, Callable[[ScaleDecision], None]]:
        return {GROW_FLEET: self.grow, SHRINK_FLEET: self.shrink}
