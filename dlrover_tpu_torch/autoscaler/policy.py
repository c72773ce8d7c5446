"""Deterministic rule policy: signal snapshots -> typed ScaleDecisions.

Deliberately simple and explainable (docs/DESIGN.md §30): no learned
models, just rules an SRE can read back from the decision ledger —

- **straggler eviction**: a rank the §29 straggler report flags
  (step-time EWMA ≥ ``straggler_score`` × fleet median) for
  ``straggler_confirm_ticks`` consecutive snapshots is evicted and
  replaced. Confirmation ticks are the hysteresis: one slow step (GC
  pause, page-in) must not cost a worker.
- **ckpt cadence**: once the fault plane has an *observed* MTBF, the
  Young/Daly interval (:func:`optimal_save_interval_s`) replaces the
  configured cadence — but only when it moves more than
  ``ckpt_retune_frac`` from the current value (dead band against
  cadence flapping as the MTBF estimate wanders).
- **training world**: shard backlog per worker above/below a band
  grows/shrinks the world within ``[min_world, max_world]``
  (``max_world == 0`` pins the world: world moves are opt-in because
  a rescale is never free).
- **serving fleet**: slot/queue utilization above ``fleet_util_grow``
  for ``fleet_confirm_ticks`` snapshots adds a replica; below
  ``fleet_util_shrink`` drains one. The gap between the two thresholds
  is the hysteresis band; a utilization that lives inside it changes
  nothing.

Every action kind has its own cooldown, measured against SNAPSHOT
timestamps (not wall reads), so the policy is clockless and replayable:
the same snapshot sequence always yields the same decision sequence —
which is what makes dry-run mode's ledger bit-comparable to a live
run's.

The port's copy of ``dlrover_tpu/autoscaler/policy.py``: one snapshot
stream gives the reference's ledger, action for action.
"""

import threading
from collections import deque
from dataclasses import asdict, dataclass, field, fields
from typing import Deque, Dict, List, Optional

from dlrover_tpu_torch.autoscaler.signals import SignalSnapshot
from dlrover_tpu_torch.flash_ckpt.autotune import optimal_save_interval_s

# Decision kinds (the typed actions the actuator layer binds).
EVICT_STRAGGLER = "evict_straggler"
GROW_WORLD = "grow_world"
SHRINK_WORLD = "shrink_world"
GROW_FLEET = "grow_fleet"
SHRINK_FLEET = "shrink_fleet"
SET_CKPT_INTERVAL = "set_ckpt_interval"
SEED_WORLD = "seed_world"          # brain prior at job start

ACTIONS = (
    EVICT_STRAGGLER,
    GROW_WORLD,
    SHRINK_WORLD,
    GROW_FLEET,
    SHRINK_FLEET,
    SET_CKPT_INTERVAL,
    SEED_WORLD,
)


@dataclass
class ScaleDecision:
    """One typed decision plus the evidence that triggered it.

    ``signals`` is a copy of the triggering snapshot's values — the
    ledger's no-unexplained-actions contract. ``outcome`` records what
    the loop did with it: ``"actuated"``, ``"dry_run"``, ``"advisory"``
    (no actuator bound — e.g. ckpt cadence on a master that only
    publishes the recommendation), or ``"error:<msg>"``.

    ``mono`` mirrors the triggering snapshot's monotonic stamp (replay
    ordering); ``realized`` is the outcome-attribution backfill the
    loop writes once the decision's attribution window closes — the
    measured effect (goodput delta, straggler-score drop, backlog
    drain, avoided-replay estimate), not the intent.
    """

    action: str
    target: object
    reason: str
    signals: Dict[str, object] = field(default_factory=dict)
    ts: float = 0.0
    seq: int = 0
    outcome: str = ""
    mono: float = 0.0
    realized: Optional[Dict[str, object]] = None

    def to_dict(self, include_signals: bool = True) -> Dict[str, object]:
        """``include_signals=False`` is the dashboard's compact mode:
        the triggering snapshot (potentially thousands of per-rank
        values) is replaced by its key count, never copied."""
        out = {
            "seq": self.seq,
            "ts": self.ts,
            "mono": self.mono,
            "action": self.action,
            "target": self.target,
            "reason": self.reason,
            "outcome": self.outcome,
        }
        if include_signals:
            out["signals"] = dict(self.signals)
        else:
            out["signals"] = {}
            out["signals_truncated"] = True
            out["signal_keys"] = len(self.signals)
        if self.realized is not None:
            out["realized"] = dict(self.realized)
        return out


class DecisionLedger:
    """Bounded, thread-safe record of every decision the loop took."""

    def __init__(self, maxlen: int = 512):
        self._lock = threading.Lock()
        self._entries: Deque[ScaleDecision] = deque(maxlen=max(maxlen, 1))
        self._seq = 0
        self._total = 0
        self._actuated = 0
        self._outcomes = 0
        self._outcome_misses = 0

    def append(self, decision: ScaleDecision) -> ScaleDecision:
        with self._lock:
            self._seq += 1
            decision.seq = self._seq
            self._entries.append(decision)
            self._total += 1
            if decision.outcome == "actuated":
                self._actuated += 1
        return decision

    def attach_outcome(self, seq: int, realized: Dict) -> bool:
        """Backfill the realized effect onto the ledger entry with this
        seq. An entry already evicted by the bound is a COUNTED no-op
        (False), never a KeyError — a long attribution window on a
        small ledger must not crash the loop."""
        with self._lock:
            for d in reversed(self._entries):
                if d.seq == seq:
                    d.realized = dict(realized)
                    self._outcomes += 1
                    return True
                if d.seq < seq:
                    break  # entries are seq-ascending; it's gone
            self._outcome_misses += 1
            return False

    def entries(self, last: Optional[int] = None,
                offset: int = 0) -> List[ScaleDecision]:
        """The newest ``last`` entries (all when falsy), after skipping
        the ``offset`` newest — the /api/autoscaler pagination window
        (offset pages BACKWARD through history)."""
        with self._lock:
            items = list(self._entries)
        if offset > 0:
            items = items[:-offset] if offset < len(items) else []
        return items[-last:] if last else items

    @property
    def decisions_total(self) -> int:
        with self._lock:
            return self._total

    @property
    def actuations_total(self) -> int:
        with self._lock:
            return self._actuated

    @property
    def outcomes_total(self) -> int:
        with self._lock:
            return self._outcomes

    @property
    def outcome_misses_total(self) -> int:
        with self._lock:
            return self._outcome_misses


@dataclass
class PolicyConfig:
    # straggler eviction
    straggler_score: float = 1.5
    straggler_confirm_ticks: int = 2
    evict_cooldown_s: float = 10.0
    # ckpt cadence (Young/Daly from observed MTBF)
    ckpt_retune_frac: float = 0.2
    ckpt_min_interval_s: float = 0.05
    ckpt_max_interval_s: float = 600.0
    ckpt_cooldown_s: float = 5.0
    default_save_block_s: float = 0.01
    # training world (pinned unless max_world > 0)
    min_world: int = 1
    max_world: int = 0
    # Legal mesh shapes: when given, grow/shrink target the NEXT legal
    # count instead of size±1 — the policy must never order a world
    # the rendezvous would refuse to form.
    legal_world_counts: Optional[List[int]] = None
    backlog_grow_per_worker: float = 256.0
    backlog_shrink_per_worker: float = 16.0
    world_cooldown_s: float = 60.0
    # serving fleet (pinned unless max_replicas > 0)
    min_replicas: int = 1
    max_replicas: int = 0
    fleet_util_grow: float = 0.85
    fleet_util_shrink: float = 0.30
    fleet_confirm_ticks: int = 2
    fleet_cooldown_s: float = 10.0

    def to_dict(self) -> Dict[str, object]:
        return asdict(self)

    @classmethod
    def from_dict(cls, data: Dict) -> "PolicyConfig":
        """Tolerant load for recordings: unknown keys (a newer writer's
        fields) are dropped so an old reader can still replay."""
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in (data or {}).items()
                      if k in known})


class RulePolicy:
    """See module docstring. Stateful only in confirmation counters and
    per-action cooldown timestamps; all time math uses snapshot
    timestamps, so replaying snapshots replays decisions."""

    def __init__(self, config: Optional[PolicyConfig] = None):
        self.config = config or PolicyConfig()
        self._last_action_ts: Dict[str, float] = {}
        self._straggler_streak: Dict[int, int] = {}
        self._fleet_hi_streak = 0
        self._fleet_lo_streak = 0

    # ---- helpers -----------------------------------------------------------

    def _cooled(self, snap: SignalSnapshot, action: str,
                cooldown_s: float) -> bool:
        last = self._last_action_ts.get(action)
        return last is None or snap.ts - last >= cooldown_s

    def _fire(self, snap: SignalSnapshot, action: str, target, reason: str,
              out: List[ScaleDecision]):
        self._last_action_ts[action] = snap.ts
        out.append(ScaleDecision(
            action=action, target=target, reason=reason,
            signals=dict(snap.values), ts=snap.ts, mono=snap.mono,
        ))

    # ---- the rules ---------------------------------------------------------

    def decide(self, snap: SignalSnapshot) -> List[ScaleDecision]:
        out: List[ScaleDecision] = []
        self._straggler_rule(snap, out)
        self._ckpt_rule(snap, out)
        self._world_rule(snap, out)
        self._fleet_rule(snap, out)
        return out

    def _straggler_rule(self, snap: SignalSnapshot,
                        out: List[ScaleDecision]):
        scores = snap.get("perf.straggler_scores") or {}

        def score_of(rank):
            return float(scores.get(rank, scores.get(str(rank), 0.0)))

        # The monitor's report flags at ITS threshold (min-reports
        # gating included); this config's straggler_score re-filters on
        # top, so raising the bar here really raises it. (A bar BELOW
        # the monitor's default needs perf_source(threshold=...) too —
        # the monitor never reports ranks under its own threshold.)
        flagged = [
            int(r) for r in (snap.get("perf.straggler_ranks") or [])
            if score_of(r) >= self.config.straggler_score
        ]
        # Streaks survive only for ranks flagged THIS snapshot.
        self._straggler_streak = {
            r: self._straggler_streak.get(r, 0) + 1 for r in flagged
        }
        if not flagged:
            return
        # Worst offender first; one eviction per cooldown window.
        rank = max(flagged, key=score_of)
        streak = self._straggler_streak.get(rank, 0)
        if streak < self.config.straggler_confirm_ticks:
            return
        if not self._cooled(snap, EVICT_STRAGGLER,
                            self.config.evict_cooldown_s):
            return
        score = score_of(rank)
        self._fire(
            snap, EVICT_STRAGGLER, rank,
            f"rank {rank} step-time score {score:.2f} >= "
            f"{self.config.straggler_score} for {streak} consecutive "
            f"snapshots (median {snap.get('perf.median_step_s')}s)",
            out,
        )
        # The seat's next occupant starts with a clean streak: without
        # this, a replacement still flagged by a stale EWMA would be
        # evicted the moment the cooldown expires.
        self._straggler_streak.pop(rank, None)

    def _ckpt_rule(self, snap: SignalSnapshot, out: List[ScaleDecision]):
        mtbf = snap.get("fault.mtbf_s")
        current = snap.get("ckpt.interval_s")
        if mtbf is None or current is None or current <= 0:
            return
        save_block = snap.get(
            "ckpt.save_block_s", self.config.default_save_block_s
        )
        drain = snap.get("ckpt.drain_s", 0.0)
        target = optimal_save_interval_s(
            save_block, drain_s=drain, mtbf_s=mtbf,
            min_interval_s=self.config.ckpt_min_interval_s,
            max_interval_s=self.config.ckpt_max_interval_s,
        )
        # Dead band: MTBF estimates wander; cadence must not flap.
        if abs(target - current) / current <= self.config.ckpt_retune_frac:
            return
        if not self._cooled(snap, SET_CKPT_INTERVAL,
                            self.config.ckpt_cooldown_s):
            return
        self._fire(
            snap, SET_CKPT_INTERVAL, round(target, 4),
            f"observed MTBF {mtbf:.2f}s + save block {save_block:.4f}s "
            f"-> Young/Daly interval {target:.2f}s (was {current:.2f}s)",
            out,
        )

    def _next_world(self, size: int, up: bool) -> Optional[int]:
        """size±1, or the next LEGAL count in that direction when a
        mesh-shape list is configured; None = no legal move."""
        counts = self.config.legal_world_counts
        if not counts:
            target = size + 1 if up else size - 1
        else:
            ordered = sorted(set(counts))
            if up:
                bigger = [
                    c for c in ordered
                    if size < c <= self.config.max_world
                ]
                target = bigger[0] if bigger else None
            else:
                smaller = [
                    c for c in ordered
                    if self.config.min_world <= c < size
                ]
                target = smaller[-1] if smaller else None
        if target is None:
            return None
        if not self.config.min_world <= target <= self.config.max_world:
            return None
        return target

    def _world_rule(self, snap: SignalSnapshot, out: List[ScaleDecision]):
        if self.config.max_world <= 0:
            return  # world pinned: rescales are opt-in
        size = snap.get("world.size")
        todo = snap.get("data.todo")
        if not size or todo is None:
            return
        if not self._cooled(snap, GROW_WORLD, self.config.world_cooldown_s):
            return
        per_worker = todo / max(size, 1)
        if (per_worker > self.config.backlog_grow_per_worker
                and size < self.config.max_world
                and self._next_world(size, up=True) is not None):
            # One cooldown clock for both directions — a grow must not
            # be immediately answered by a shrink.
            self._last_action_ts[SHRINK_WORLD] = snap.ts
            self._fire(
                snap, GROW_WORLD, self._next_world(size, up=True),
                f"shard backlog {todo} = {per_worker:.0f}/worker > "
                f"{self.config.backlog_grow_per_worker:.0f} at world "
                f"{size}",
                out,
            )
        elif (per_worker < self.config.backlog_shrink_per_worker
                and size > self.config.min_world and todo > 0
                and self._next_world(size, up=False) is not None):
            self._last_action_ts[GROW_WORLD] = snap.ts
            self._fire(
                snap, SHRINK_WORLD, self._next_world(size, up=False),
                f"shard backlog {todo} = {per_worker:.1f}/worker < "
                f"{self.config.backlog_shrink_per_worker:.0f} at world "
                f"{size}",
                out,
            )

    def _fleet_rule(self, snap: SignalSnapshot, out: List[ScaleDecision]):
        if self.config.max_replicas <= 0:
            return  # fleet pinned
        replicas = snap.get("fleet.replicas")
        util = snap.get("fleet.slot_util")
        if replicas is None or util is None:
            return
        if util >= self.config.fleet_util_grow:
            self._fleet_hi_streak += 1
            self._fleet_lo_streak = 0
        elif util <= self.config.fleet_util_shrink:
            self._fleet_lo_streak += 1
            self._fleet_hi_streak = 0
        else:
            # Inside the hysteresis band: nothing changes.
            self._fleet_hi_streak = 0
            self._fleet_lo_streak = 0
            return
        confirm = self.config.fleet_confirm_ticks
        if (self._fleet_hi_streak >= confirm
                and replicas < self.config.max_replicas
                and self._cooled(snap, GROW_FLEET,
                                 self.config.fleet_cooldown_s)):
            self._last_action_ts[SHRINK_FLEET] = snap.ts
            self._fire(
                snap, GROW_FLEET, int(replicas) + 1,
                f"fleet utilization {util:.2f} >= "
                f"{self.config.fleet_util_grow} for "
                f"{self._fleet_hi_streak} snapshots at {replicas} "
                f"replicas (queue {snap.get('fleet.queue_depth')})",
                out,
            )
        elif (self._fleet_lo_streak >= confirm
                and replicas > self.config.min_replicas
                and self._cooled(snap, SHRINK_FLEET,
                                 self.config.fleet_cooldown_s)):
            self._last_action_ts[GROW_FLEET] = snap.ts
            self._fire(
                snap, SHRINK_FLEET, int(replicas) - 1,
                f"fleet utilization {util:.2f} <= "
                f"{self.config.fleet_util_shrink} for "
                f"{self._fleet_lo_streak} snapshots at {replicas} "
                f"replicas",
                out,
            )
