"""Master-side rescale control loop: versioned plans + bounded barriers.

The live-rescale protocol (docs/DESIGN.md §27) closes the loop between
the subsystems the repo already has — rendezvous legality, shard-lease
recovery, committed-checkpoint tracking, the fault plane — into an
N→M world change that never tears the job down:

1. **Detect.** A node death (agent ``NodeFailureReport`` routed here by
   the servicer, or the process supervisor calling
   :meth:`RescaleCoordinator.note_worker_lost`) or a scale-up join
   (``RescaleJoinReport``) changes the live set.
2. **Plan.** The coordinator picks the largest *legal* world that fits
   the live set (``legal_counts_fn`` — wired to the trainer's batch
   config so ``global_batch % (micro * dp) == 0`` always holds) and
   broadcasts a versioned :class:`RescalePlan`: monotonically increasing
   ``plan_id``, the new world map, and ``restore_step`` = the newest
   checkpoint step reported committed. Plans are pulled by workers
   (``RescalePlanRequest``), so a dropped broadcast costs one poll.
3. **Barrier.** Survivors ack phases ("barrier" → "restored" →
   "resumed"); each phase barrier is a bounded wait. A rank that dies
   mid-barrier makes the barrier EXPIRE, at which point the missing
   ranks are treated as lost and a superseding plan is cut — the
   protocol is self-healing, never wedged.

Every transition lands in the metrics registry, so /metrics shows
plans cut, barrier waits, expirations, and the live worker count.

The port's copy of
``dlrover_tpu/master/elastic_training/rescale_coordinator.py``: the same
plans, barriers, legality and metric names, on the port's registry.
"""

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from dlrover_tpu_torch.common.log import logger

def wire_batch_legality(
    rdzv_managers, coordinator, batch_config, local_world_size: int = 1
):
    """Single source of truth for batch-config legality: install the
    same ``legal_counts_fn`` on the training rendezvous AND the rescale
    coordinator, so neither can ever form a world whose dp size doesn't
    divide the global batch."""
    from dlrover_tpu_torch.common.constants import RendezvousName

    legal_fn = batch_config.legal_node_counts_fn(
        local_world_size=local_world_size
    )
    mgr = (rdzv_managers or {}).get(RendezvousName.TRAINING)
    if mgr is not None:
        mgr.set_legal_counts_fn(legal_fn)
    if coordinator is not None:
        coordinator.set_legal_counts_fn(legal_fn)


# Worker phases, in protocol order.
PHASE_BARRIER = "barrier"
PHASE_RESTORED = "restored"
PHASE_RESUMED = "resumed"
PHASES = (PHASE_BARRIER, PHASE_RESTORED, PHASE_RESUMED)


def _metrics():
    from dlrover_tpu_torch.observability.registry import default_registry

    reg = default_registry()
    return {
        "plans": reg.counter(
            "rescale_plans_total",
            "rescale plans cut, by trigger",
            labelnames=("reason",),
        ),
        "live": reg.gauge(
            "rescale_live_workers",
            "workers currently registered with the rescale plane",
        ),
        "barrier_wait": reg.histogram(
            "rescale_barrier_wait_seconds",
            "plan creation to all-acked, per phase",
            labelnames=("phase",),
        ),
        "barrier_expired": reg.counter(
            "rescale_barrier_expired_total",
            "rescale barriers that hit their bounded wait",
        ),
        "evicted": reg.counter(
            "rescale_workers_evicted_total",
            "live workers left out of a plan's world (illegal count)",
        ),
    }


@dataclass
class RescalePlan:
    plan_id: int
    world: Dict[int, int]              # node_rank -> local_world_size
    rank_order: List[int]
    restore_step: int
    reason: str
    created_at: float
    barrier_timeout_s: float
    acks: Dict[str, Set[int]] = field(
        default_factory=lambda: {p: set() for p in PHASES}
    )
    expired: bool = False
    # membership-event sequence at cut time: a rank whose join is newer
    # than this never receives the plan (it is a held-back waiter, not
    # an evictee — absence from ``world`` is only an eviction notice to
    # ranks the plan actually considered)
    cut_seq: int = 0
    # wall time each phase barrier completed (metrics / bench)
    completed_at: Dict[str, float] = field(default_factory=dict)


class RescaleCoordinator:
    """Owns the live worker set and the current plan.

    ``legal_counts_fn(max_nodes, node_unit) -> List[int]`` decides which
    world sizes may form (same contract as
    ``RendezvousManager.set_legal_counts_fn``); ``restore_step_fn`` may
    override the internally tracked committed step (e.g. to read the job
    manager's tracker).
    """

    def __init__(
        self,
        legal_counts_fn: Optional[Callable[[int, int], List[int]]] = None,
        restore_step_fn: Optional[Callable[[], int]] = None,
        barrier_timeout_s: float = 30.0,
        node_unit: int = 1,
        bootstrap_min: int = 1,
        clock: Callable[[], float] = time.time,
    ):
        self._lock = threading.RLock()
        self._legal_counts_fn = legal_counts_fn
        self._restore_step_fn = restore_step_fn
        self._barrier_timeout_s = barrier_timeout_s
        self._node_unit = max(node_unit, 1)
        # No plan is cut before this many workers have joined — keeps a
        # staggered bootstrap from cutting one plan per arriving worker.
        self._bootstrap_min = max(bootstrap_min, 1)
        self._clock = clock
        self._live: Dict[int, int] = {}    # rank -> local_world_size
        self._rank_group: Dict[int, int] = {}  # rank -> TPU slice/block
        self._seq = 0                      # membership-event counter
        self._join_seq: Dict[int, int] = {}  # rank -> seq at (re)join
        self._plan: Optional[RescalePlan] = None
        self._plan_seq = 0
        self._committed_step = -1
        # Master-journal hook (DESIGN.md §37): called with each freshly
        # cut plan so plan_id monotonicity survives a master crash.
        # Invoked under self._lock — the hook must not call back in.
        self.on_plan_cut: Optional[Callable[[RescalePlan], None]] = None
        self._m = _metrics()

    def restore_journal_state(self, plan_seq: int, committed_step: int):
        """Master-journal rehydration: floor the plan_id sequence so a
        restarted master can never re-issue a stale plan_id, and
        re-learn the newest committed checkpoint step."""
        with self._lock:
            self._plan_seq = max(self._plan_seq, int(plan_seq))
            self._committed_step = max(
                self._committed_step, int(committed_step)
            )

    # ---- configuration -----------------------------------------------------

    def set_legal_counts_fn(self, fn: Callable[[int, int], List[int]]):
        with self._lock:
            self._legal_counts_fn = fn

    # ---- membership events -------------------------------------------------

    def note_worker_joined(
        self, rank: int, local_world_size: int = 1, node_group: int = -1
    ):
        """A worker announced itself (bootstrap, scale-up join, or a
        restarted incarnation re-joining)."""
        with self._lock:
            self._seq += 1
            if rank not in self._live:
                self._join_seq[rank] = self._seq
            self._live[rank] = local_world_size
            if node_group >= 0:
                self._rank_group[rank] = node_group
            self._m["live"].set(len(self._live))
            plan = self._plan
            if plan is None:
                # The bootstrap gate ONLY defers the first plan (a
                # staggered start must not cut one plan per arrival).
                # Once any plan exists, a join is a scale-up signal no
                # matter how far below the original node count the live
                # set is — a replacement for a half-dead world must be
                # folded in, not silently evicted.
                if len(self._live) >= self._bootstrap_min:
                    self._make_plan_locked("bootstrap")
                return
            if rank not in plan.world:
                if not plan.expired and len(
                    self._select_world_locked()
                ) <= len(plan.rank_order):
                    # The join adds no capacity — the joiner's slice
                    # block is still incomplete, or the world is already
                    # at the largest legal size (a same-size selection
                    # is a seat SWAP: it would evict a healthy running
                    # rank for zero gain). Cutting a plan here would
                    # roll every healthy survivor back to restore_step
                    # for a no-op membership change (and a relaunch loop
                    # would livelock training). Hold the joiner back as
                    # a WAITER instead: it stays in the live set but
                    # receives no plan (get_plan) until a membership
                    # change cuts one that considers it.
                    logger.info(
                        "rescale: rank %d held as waiter (world "
                        "stays: %s)", rank, plan.rank_order,
                    )
                    return
                # Mid-run join: scale UP. The new plan includes the
                # joiner if the enlarged world is legal.
                self._make_plan_locked("scale_up_join")
            elif plan.expired:
                # The plan wedged on expiry with no legal replacement
                # world at the time — this join may make one legal
                # again; "never wedged" requires re-planning here.
                self._make_plan_locked("rejoin")
            elif rank in plan.acks.get(PHASE_RESTORED, set()) or (
                rank in plan.acks.get(PHASE_RESUMED, set())
            ):
                # This rank already acked 'restored' (or beyond) on the
                # current plan, so the join must be a new incarnation
                # (crashed + restarted in place without a node-loss
                # report) — and because its old ack still counts toward
                # the 'restored' barrier, peers may have passed it and
                # trained ahead. Silently handing it the plan back would
                # let it roll back alone — and, if designated, rewind
                # the live shard cursor — double-consuming shards. A
                # fresh plan rolls the whole world back together. (A
                # rank that had only acked 'barrier' re-adopts safely:
                # the 'restored' barrier cannot complete without its new
                # incarnation, so no peer can be past it.)
                self._make_plan_locked("rejoin")

    def note_worker_lost(self, rank: int):
        """A worker died (agent failure report or supervisor observation).
        Cuts a scale-down plan when the dead rank was part of the active
        world; idempotent for ranks already gone."""
        with self._lock:
            if rank not in self._live:
                return
            del self._live[rank]
            self._rank_group.pop(rank, None)
            self._join_seq.pop(rank, None)
            self._m["live"].set(len(self._live))
            if self._plan is not None and rank in self._plan.world:
                self._make_plan_locked("node_lost")

    def evict_worker(self, rank: int, reason: str = "straggler_evict"
                     ) -> bool:
        """Deliberate eviction (the §30 autoscaler condemning a flagged
        straggler): unlike :meth:`note_worker_lost` the rank is still
        ALIVE — it is removed from the live set and, when it sat in the
        current plan's world, a superseding plan is cut under
        ``reason`` so the survivors re-mesh without it. The evictee
        learns of its eviction from the plan itself (absence from
        ``world`` is the eviction notice) and exits cleanly; its
        replacement re-joins through the normal scale-up path."""
        with self._lock:
            if rank not in self._live:
                return False
            del self._live[rank]
            self._rank_group.pop(rank, None)
            self._join_seq.pop(rank, None)
            self._m["live"].set(len(self._live))
            self._m["evicted"].inc()
            if self._plan is not None and rank in self._plan.world:
                self._make_plan_locked(reason)
            logger.info(
                "rescale: rank %d evicted (%s); %d live workers remain",
                rank, reason, len(self._live),
            )
            return True

    def note_ckpt_step(self, step: int, committed: bool):
        if committed:
            with self._lock:
                self._committed_step = max(self._committed_step, step)

    def committed_step(self) -> int:
        with self._lock:
            if self._restore_step_fn is not None:
                try:
                    step = self._restore_step_fn()
                    if step is not None and step >= 0:
                        return max(step, self._committed_step)
                except Exception:
                    logger.warning(
                        "restore_step_fn failed; using reported steps",
                        exc_info=True,
                    )
            return self._committed_step

    # ---- planning ----------------------------------------------------------

    def _legal_world_size(self, n_live: int) -> int:
        if self._legal_counts_fn is None:
            return n_live
        counts = [
            c
            for c in self._legal_counts_fn(n_live, self._node_unit)
            if c <= n_live
        ]
        return max(counts) if counts else 0

    def _complete_groups_locked(self) -> Optional[List[List[int]]]:
        """Live ranks bucketed into COMPLETE slice blocks, lowest-rank
        block first, or None when grouping doesn't apply. Same rule as
        ``RendezvousManager._select_waiters``: an ICI slice cannot run
        collectives with a missing host, so a plan's world must never
        straddle a broken block."""
        unit = self._node_unit
        if unit <= 1 or not any(
            self._rank_group.get(r, -1) >= 0 for r in self._live
        ):
            return None
        by_group: Dict[int, List[int]] = {}
        for r in sorted(self._live):
            by_group.setdefault(self._rank_group.get(r, -1), []).append(r)
        groups = [m[:unit] for m in by_group.values() if len(m) >= unit]
        groups.sort(key=lambda g: g[0])
        return groups

    def _select_world_locked(self) -> List[int]:
        """The world the next plan would carry: the largest legal rank
        set, built from complete slice blocks when grouping applies."""
        groups = self._complete_groups_locked()
        if groups is None:
            size = self._legal_world_size(len(self._live))
            return sorted(self._live)[:max(size, 0)]
        # legal_counts_fn only emits multiples of node_unit, so a
        # legal size is always fillable with whole blocks.
        eligible = [r for g in groups for r in g]
        size = self._legal_world_size(len(eligible))
        return sorted(eligible[:max(size, 0)])

    def _make_plan_locked(self, reason: str):
        ranks = self._select_world_locked()
        if not ranks:
            logger.warning(
                "rescale: no legal world size fits %d live workers; "
                "holding the previous plan until membership changes",
                len(self._live),
            )
            return
        evicted = [r for r in sorted(self._live) if r not in set(ranks)]
        if evicted:
            # Evicted workers exit cleanly (code 0) when they see the
            # plan, so no failure report will ever remove them — fold
            # them out of the live set NOW or later plans would
            # re-include dead ranks and stall a full barrier timeout.
            self._m["evicted"].inc(len(evicted))
            for rank in evicted:
                del self._live[rank]
                self._rank_group.pop(rank, None)
                self._join_seq.pop(rank, None)
            self._m["live"].set(len(self._live))
        self._plan_seq += 1
        self._plan = RescalePlan(
            plan_id=self._plan_seq,
            world={r: self._live[r] for r in ranks},
            rank_order=list(ranks),
            restore_step=self.committed_step(),
            reason=reason,
            created_at=self._clock(),
            barrier_timeout_s=self._barrier_timeout_s,
            cut_seq=self._seq,
        )
        self._m["plans"].inc(reason=reason)
        if self.on_plan_cut is not None:
            try:
                self.on_plan_cut(self._plan)
            except Exception:
                logger.exception("on_plan_cut hook failed")
        logger.info(
            "rescale plan %d cut (%s): world=%s restore_step=%d",
            self._plan.plan_id,
            reason,
            self._plan.rank_order,
            self._plan.restore_step,
        )

    # ---- worker-facing surface --------------------------------------------

    def get_plan(
        self, node_rank: int, current_plan_id: int = -1
    ) -> Optional[RescalePlan]:
        """The latest plan if newer than ``current_plan_id``, else None.
        Evicted ranks still receive the plan (absence from ``world`` IS
        the eviction notice) — but a HELD-BACK waiter, whose join the
        plan never considered, gets None and keeps waiting: handing it
        the older plan would read as an eviction and make it exit."""
        with self._lock:
            plan = self._plan
            if plan is None or plan.plan_id <= current_plan_id:
                return None
            if (
                node_rank not in plan.world
                and node_rank in self._live
                and self._join_seq.get(node_rank, 0) > plan.cut_seq
            ):
                return None
            return plan

    def current_plan(self) -> Optional[RescalePlan]:
        with self._lock:
            return self._plan

    def ack(self, plan_id: int, node_rank: int, phase: str) -> bool:
        """Record a worker's phase ack. Stale-plan acks are dropped
        (False); re-acks are idempotent."""
        with self._lock:
            plan = self._plan
            if plan is None or plan.plan_id != plan_id:
                return False
            if phase not in plan.acks or node_rank not in plan.world:
                return False
            plan.acks[phase].add(node_rank)
            if (
                plan.acks[phase] >= set(plan.world)
                and phase not in plan.completed_at
            ):
                now = self._clock()
                plan.completed_at[phase] = now
                self._m["barrier_wait"].observe(
                    max(now - plan.created_at, 0.0), phase=phase
                )
                logger.info(
                    "rescale plan %d: phase %r barrier complete (%.2fs)",
                    plan_id,
                    phase,
                    now - plan.created_at,
                )
            return True

    def barrier_state(self, plan_id: int, phase: str):
        """(ready, expired, superseded, missing) for a plan's phase.

        Expiry is evaluated here (the waiters drive the clock): once the
        bounded wait runs out with ranks missing, those ranks are treated
        as lost and a superseding plan is cut — the surviving waiters see
        ``superseded`` on their next poll and pivot to the new plan.

        Each phase's budget restarts at the PREVIOUS phase's completion
        (plan creation for the first): a restore that legitimately takes
        longer than one budget must not eat the 'restored' barrier's
        allowance and evict healthy-but-slow ranks."""
        with self._lock:
            plan = self._plan
            if plan is None:
                return False, False, False, []
            if plan.plan_id != plan_id:
                return False, False, plan.plan_id > plan_id, []
            missing = sorted(set(plan.world) - plan.acks.get(phase, set()))
            if not missing:
                return True, False, False, []
            anchor = plan.created_at
            if phase in PHASES and PHASES.index(phase) > 0:
                prev = PHASES[PHASES.index(phase) - 1]
                anchor = plan.completed_at.get(prev, plan.created_at)
            if self._clock() - anchor > plan.barrier_timeout_s:
                if not plan.expired:
                    plan.expired = True
                    self._m["barrier_expired"].inc()
                    logger.warning(
                        "rescale plan %d: phase %r barrier expired; "
                        "ranks %s treated as lost",
                        plan_id,
                        phase,
                        missing,
                    )
                    for rank in missing:
                        self._live.pop(rank, None)
                        self._rank_group.pop(rank, None)
                        self._join_seq.pop(rank, None)
                    self._m["live"].set(len(self._live))
                    self._make_plan_locked("barrier_expired")
                return False, True, False, missing
            return False, False, False, missing
