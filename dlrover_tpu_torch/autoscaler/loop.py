"""AutoScaler: the observe -> decide -> act loop, with a ledger.

One tick = sample the SignalBus, run the policy, actuate (or record
without acting in dry-run / advisory cases), append every decision to
the ledger with its triggering snapshot. The loop can run as a daemon
thread on a cadence (the masters do this) or be ticked synchronously
(tests and the soak harness, which want deterministic pacing).

Decisions emit ``autoscaler_*`` metrics and — when tracing is armed —
one ``autoscaler.decision`` span each, carrying action/target/outcome,
so a scale action shows up in the same trace plane as the RPCs and
training steps it perturbs (§29).

The optional :class:`BrainPrior` wires the §-brain cross-job optimizer
in as a *prior*: at start the autoscaler may seed its initial
world-size target from ``/optimize`` (a SEED_WORLD decision, through
the same ledger/actuation path as everything else), and at stop it
reports the achieved goodput back to ``/persist_metrics`` so the next
job of this name starts smarter.

The port's copy of ``dlrover_tpu/autoscaler/loop.py``. The brain
service's client is not ported (ROADMAP §A item 8b), so
:class:`BrainPrior` raises ``NotImplementedError`` naming that item
instead of reading as an unreachable brain.
"""

import threading
import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.autoscaler.policy import (
    DecisionLedger,
    EVICT_STRAGGLER,
    GROW_FLEET,
    GROW_WORLD,
    RulePolicy,
    ScaleDecision,
    SEED_WORLD,
    SET_CKPT_INTERVAL,
    SHRINK_FLEET,
    SHRINK_WORLD,
)
from dlrover_tpu_torch.autoscaler.recorder import (
    SignalRecorder,
    recorder_from_env,
)
from dlrover_tpu_torch.autoscaler.signals import SignalBus, SignalSnapshot
from dlrover_tpu_torch.common.log import logger


def _metrics(registry=None):
    from dlrover_tpu_torch.observability.registry import default_registry

    reg = registry or default_registry()
    return {
        "ticks": reg.counter(
            "autoscaler_ticks_total",
            "autoscaler observe/decide/act iterations",
        ),
        "decisions": reg.counter(
            "autoscaler_decisions_total",
            "scale decisions emitted, by action",
            labelnames=("action",),
        ),
        "actuations": reg.counter(
            "autoscaler_actuations_total",
            "decisions actually actuated, by action",
            labelnames=("action",),
        ),
        "errors": reg.counter(
            "autoscaler_actuation_errors_total",
            "actuations that raised, by action",
            labelnames=("action",),
        ),
        "dry_run": reg.gauge(
            "autoscaler_dry_run",
            "1 when the loop is advisory-only (no actuations)",
        ),
        "ckpt_interval": reg.gauge(
            "autoscaler_ckpt_interval_s",
            "checkpoint cadence the autoscaler currently recommends",
        ),
        # Outcome-attribution families: realized effects backfilled
        # onto ledger entries after each decision's attribution window.
        "outcome_total": reg.counter(
            "autoscaler_decision_outcome_total",
            "decision outcomes attributed, by action and verdict",
            labelnames=("action", "verdict"),
        ),
        "outcome_goodput_delta": reg.gauge(
            "autoscaler_decision_outcome_goodput_delta",
            "goodput change over the newest attributed window, by action",
            labelnames=("action",),
        ),
        "outcome_effect": reg.gauge(
            "autoscaler_decision_outcome_effect",
            "action-specific primary effect of the newest attributed "
            "decision (score drop, backlog drain/s, net saved s/h)",
            labelnames=("action",),
        ),
        "outcome_missed": reg.counter(
            "autoscaler_decision_outcome_missed_total",
            "outcome backfills whose ledger entry was already evicted",
        ),
        "outcome_pending": reg.gauge(
            "autoscaler_decision_outcome_pending",
            "actuated decisions still inside their attribution window",
        ),
    }


class AutoScaler:
    """The resource brain's control loop (docs/DESIGN.md §30)."""

    def __init__(
        self,
        bus: SignalBus,
        policy: Optional[RulePolicy] = None,
        actuators: Optional[
            Dict[str, Callable[[ScaleDecision], None]]
        ] = None,
        interval_s: float = 5.0,
        dry_run: bool = False,
        ledger_size: int = 512,
        clock: Callable[[], float] = time.time,
        registry=None,
        brain_prior: Optional["BrainPrior"] = None,
        job_name: str = "",
        recorder: Optional[SignalRecorder] = None,
        attribution_window_s: Optional[float] = None,
    ):
        self.bus = bus
        self.policy = policy or RulePolicy()
        self._actuators = dict(actuators or {})
        self.interval_s = interval_s
        self.dry_run = dry_run
        self.ledger = DecisionLedger(ledger_size)
        self._clock = clock
        self._m = _metrics(registry)
        self._m["dry_run"].set(1.0 if dry_run else 0.0)
        self._brain = brain_prior
        self._job_name = job_name
        # Durable signal recording (§34): explicit recorder, or armed
        # from DLROVER_TPU_AUTOSCALE_RECORD the way subprocess workers
        # arm the fault plane. The policy config is recorded up front —
        # the replay identity invariant replays exactly this config.
        self.recorder = recorder if recorder is not None \
            else recorder_from_env()
        if self.recorder is not None:
            self.recorder.record_policy(self.policy.config.to_dict())
        # Outcome attribution: after an actuated decision the loop
        # watches this many seconds of SNAPSHOT time (clockless — same
        # timestamps the policy rules use) and backfills the realized
        # effect onto the ledger entry. Default: three decision
        # intervals, enough for the actuation to show in the signals.
        self.attribution_window_s = (
            attribution_window_s if attribution_window_s is not None
            else max(3.0 * interval_s, 1e-6)
        )
        self._pending_outcomes: List[ScaleDecision] = []
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seeded = False
        self._completion_reported = False

    # ---- wiring ------------------------------------------------------------

    def bind(self, action: str, fn: Callable[[ScaleDecision], None]):
        self._actuators[action] = fn
        return self

    def bind_all(self, bindings: Dict[str, Callable[[ScaleDecision], None]]):
        self._actuators.update(bindings)
        return self

    # ---- one iteration -----------------------------------------------------

    def tick(self) -> List[ScaleDecision]:
        """Sample -> decide -> actuate/record. Synchronous drivers (the
        soak harness, tests) call this directly; the daemon thread calls
        it on the cadence."""
        self._m["ticks"].inc()
        snap = self.bus.sample()
        if self.recorder is not None:
            self.recorder.record_snapshot(snap)
        # Outcomes first: an attribution window that closes THIS tick
        # is measured against this snapshot, before any new decision
        # perturbs the signals again.
        self._resolve_outcomes(snap)
        if not self._seeded:
            self._seeded = True
            self._seed_from_brain(snap)
        decisions = self.policy.decide(snap)
        for decision in decisions:
            self._handle(decision)
        return decisions

    def _handle(self, decision: ScaleDecision):
        self._m["decisions"].inc(action=decision.action)
        actuator = self._actuators.get(decision.action)
        span = None
        from dlrover_tpu_torch.observability import tracing

        tracer = tracing.active_tracer()
        if tracer is not None:
            span = tracer.start_span(
                "autoscaler.decision",
                attrs={
                    "action": decision.action,
                    "target": str(decision.target),
                    "dry_run": self.dry_run,
                },
            )
        if self.dry_run:
            decision.outcome = "dry_run"
        elif actuator is None:
            decision.outcome = "advisory"
        else:
            try:
                actuator(decision)
                decision.outcome = "actuated"
                self._m["actuations"].inc(action=decision.action)
            except Exception as e:  # noqa: BLE001 — a failed actuation
                # must not kill the loop; the ledger records the miss.
                decision.outcome = f"error:{type(e).__name__}: {e}"[:200]
                self._m["errors"].inc(action=decision.action)
                logger.warning(
                    "autoscaler actuation failed (%s -> %r): %s",
                    decision.action, decision.target, e,
                )
        if decision.action == "set_ckpt_interval":
            # Published even in dry-run/advisory mode: the gauge IS the
            # recommendation channel for deployments with no push path.
            self._m["ckpt_interval"].set(float(decision.target))
        self.ledger.append(decision)
        if self.recorder is not None:
            # After actuation, so the record carries the result.
            self.recorder.record_decision(decision)
        if decision.outcome == "actuated":
            self._pending_outcomes.append(decision)
            self._m["outcome_pending"].set(
                float(len(self._pending_outcomes))
            )
        if span is not None:
            span.set_attr("outcome", decision.outcome)
            span.set_attr("reason", decision.reason[:200])
            span.end(
                status="ok"
                if not decision.outcome.startswith("error") else "error"
            )
        logger.info(
            "autoscaler decision #%d: %s -> %r (%s) [%s]",
            decision.seq, decision.action, decision.target,
            decision.reason, decision.outcome,
        )

    # ---- outcome attribution (§34) -----------------------------------------

    def _resolve_outcomes(self, snap: SignalSnapshot,
                          force: bool = False):
        """Close every attribution window that has elapsed by SNAPSHOT
        time and backfill the realized effect onto the ledger entry
        (plus the recorder and the outcome metric families). ``force``
        closes everything — the stop() path, where a truncated window
        beats an unannotated decision."""
        still_open: List[ScaleDecision] = []
        for decision in self._pending_outcomes:
            window = self._window_s(decision, snap)
            if not force and window < self.attribution_window_s:
                still_open.append(decision)
                continue
            realized = self._realized_effect(decision, snap)
            if force and window < self.attribution_window_s:
                realized["window_truncated"] = True
            if not self.ledger.attach_outcome(decision.seq, realized):
                self._m["outcome_missed"].inc()
            if self.recorder is not None:
                self.recorder.record_outcome(decision.seq, realized)
            verdict = str(realized.get("verdict", "neutral"))
            self._m["outcome_total"].inc(
                action=decision.action, verdict=verdict
            )
            if realized.get("goodput_delta") is not None:
                self._m["outcome_goodput_delta"].set(
                    float(realized["goodput_delta"]),
                    action=decision.action,
                )
            if realized.get("effect") is not None:
                self._m["outcome_effect"].set(
                    float(realized["effect"]), action=decision.action
                )
        self._pending_outcomes = still_open
        self._m["outcome_pending"].set(float(len(still_open)))

    @staticmethod
    def _window_s(decision: ScaleDecision,
                  snap: SignalSnapshot) -> float:
        """Elapsed snapshot time since the decision — on the MONOTONIC
        stamp pair when both carry one (a wall-clock step mid-window
        must not close it early or hold it open), wall otherwise."""
        if decision.mono and snap.mono:
            return snap.mono - decision.mono
        return snap.ts - decision.ts

    def _realized_effect(self, decision: ScaleDecision,
                         snap: SignalSnapshot) -> Dict[str, object]:
        """Measure what actually happened across the window: the
        decision's own triggering snapshot is the before, ``snap`` the
        after. ``effect`` is the action-specific primary number the
        verdict is read from (positive = the decision helped)."""
        before = decision.signals
        after = snap.values

        def b(key, default=None):
            return before.get(key, default)

        def a(key, default=None):
            return after.get(key, default)

        window = max(self._window_s(decision, snap), 1e-9)
        out: Dict[str, object] = {
            "window_s": round(window, 6),
            "measured_at_seq": snap.seq,
        }
        gp_b, gp_a = b("perf.goodput"), a("perf.goodput")
        if gp_b is not None and gp_a is not None:
            out["goodput_before"] = round(float(gp_b), 6)
            out["goodput_after"] = round(float(gp_a), 6)
            out["goodput_delta"] = round(float(gp_a) - float(gp_b), 6)
        effect: Optional[float] = None
        if decision.action == EVICT_STRAGGLER:
            rank = decision.target

            def score_in(values):
                scores = values.get("perf.straggler_scores") or {}
                return float(scores.get(
                    rank, scores.get(str(rank), 1.0)
                ))

            sb, sa = score_in(before), score_in(after)
            out["straggler_score_before"] = round(sb, 4)
            out["straggler_score_after"] = round(sa, 4)
            flagged_after = [
                int(r) for r in (a("perf.straggler_ranks") or [])
            ]
            out["straggler_cleared"] = int(rank) not in flagged_after
            effect = sb - sa
        elif decision.action in (GROW_FLEET, SHRINK_FLEET):
            qb = float(b("fleet.queue_depth", 0.0) or 0.0)
            qa = float(a("fleet.queue_depth", 0.0) or 0.0)
            out["queue_before"] = round(qb, 2)
            out["queue_after"] = round(qa, 2)
            # Positive drain = backlog shrank over the window; a shrink
            # that makes the queue grow reads as a regression too.
            out["backlog_drain_per_s"] = round((qb - qa) / window, 4)
            ub, ua = b("fleet.slot_util"), a("fleet.slot_util")
            if ub is not None and ua is not None:
                out["util_before"] = round(float(ub), 4)
                out["util_after"] = round(float(ua), 4)
            effect = (qb - qa) / window if (qb or qa) else None
        elif decision.action in (GROW_WORLD, SHRINK_WORLD, SEED_WORLD):
            size_b = float(b("world.size", 0) or 0)
            size_a = float(a("world.size", 0) or 0)
            todo_b = b("data.todo")
            todo_a = a("data.todo")
            out["world_before"] = int(size_b)
            out["world_after"] = int(size_a)
            out["world_converged"] = (
                int(size_a) == int(decision.target)
            )
            if todo_b is not None and todo_a is not None:
                pb = float(todo_b) / max(size_b, 1.0)
                pa = float(todo_a) / max(size_a, 1.0)
                out["backlog_per_worker_before"] = round(pb, 2)
                out["backlog_per_worker_after"] = round(pa, 2)
                effect = pb - pa
        elif decision.action == SET_CKPT_INTERVAL:
            old = b("ckpt.interval_s")
            new = float(decision.target)
            mtbf = a("fault.mtbf_s", b("fault.mtbf_s"))
            save_block = float(b("ckpt.save_block_s", 0.0) or 0.0)
            if old and mtbf:
                old, mtbf = float(old), float(mtbf)
                # Young/Daly accounting, per hour of runtime: expected
                # replay per failure is interval/2, failures arrive at
                # 3600/MTBF per hour; the retune also changes the save
                # overhead (3600/interval saves × blocking cost).
                failures_per_h = 3600.0 / mtbf
                avoided = (old - new) / 2.0 * failures_per_h
                extra_saves = save_block * 3600.0 * (
                    1.0 / max(new, 1e-9) - 1.0 / max(old, 1e-9)
                )
                out["avoided_replay_s_per_hour"] = round(avoided, 4)
                out["extra_save_s_per_hour"] = round(extra_saves, 4)
                effect = avoided - extra_saves
                out["est_net_saved_s_per_hour"] = round(effect, 4)
        if effect is None and out.get("goodput_delta") is not None:
            effect = float(out["goodput_delta"])
        if effect is not None:
            out["effect"] = round(effect, 6)
            eps = 1e-6
            out["verdict"] = (
                "improved" if effect > eps
                else "regressed" if effect < -eps else "neutral"
            )
        else:
            out["verdict"] = "neutral"
        return out

    def _seed_from_brain(self, snap: SignalSnapshot):
        if self._brain is None:
            return
        suggestion = self._brain.initial_world()
        if not suggestion:
            return
        count = int(suggestion.get("worker_count", 0))
        current = snap.get("world.size")
        if count <= 0 or current is None:
            return
        # The prior's suggestion obeys the same legality as every other
        # world move: snap DOWN to the nearest legal mesh shape and
        # clamp to the configured bounds — a brain trained on another
        # cluster must not order a world this rendezvous refuses.
        cfg = self.policy.config
        if cfg.legal_world_counts:
            legal = [
                c for c in sorted(set(cfg.legal_world_counts))
                if c <= count
            ]
            if not legal:
                return
            count = legal[-1]
        if cfg.max_world > 0:
            count = min(count, cfg.max_world)
        count = max(count, cfg.min_world)
        if count == current:
            return
        self._handle(ScaleDecision(
            action=SEED_WORLD,
            target=count,
            reason=(
                f"brain prior: {suggestion.get('optimizer', '?')} "
                f"optimizer suggests {count} workers from "
                f"{suggestion.get('evidence_samples', 0)} past samples "
                f"(current {current})"
            ),
            signals=dict(snap.values),
            ts=snap.ts,
            mono=snap.mono,
        ))

    # ---- lifecycle ---------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return
        self._stopped.clear()
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True
        )
        self._thread.start()
        logger.info(
            "autoscaler loop started (interval %.1fs%s)",
            self.interval_s, ", DRY RUN" if self.dry_run else "",
        )

    def _loop(self):
        while not self._stopped.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("autoscaler tick failed")

    def stop(self, success: bool = True):
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        # A decision whose window hasn't elapsed still gets its outcome
        # measured against the last snapshot (marked truncated): an
        # annotation gap at shutdown would read as "effect unknown".
        if self._pending_outcomes:
            snap = self.bus.latest()
            if snap is not None:
                self._resolve_outcomes(snap, force=True)
        self._report_completion(success)
        if self.recorder is not None:
            self.recorder.close()

    def _report_completion(self, success: bool):
        if self._brain is None or self._completion_reported:
            return
        self._completion_reported = True
        snap = self.bus.latest()
        self._brain.report_outcome(
            goodput=float((snap.get("perf.goodput") if snap else 0.0)
                          or 0.0),
            worker_count=int((snap.get("world.size") if snap else 0)
                             or 0),
            speed=float((snap.get("perf.speed") if snap else 0.0) or 0.0),
            success=success,
        )

    # ---- dashboard surface -------------------------------------------------

    def api_state(self, last: int = 50, offset: int = 0,
                  compact: bool = False) -> Dict[str, object]:
        """The ``/api/autoscaler`` payload: live signals, the recent
        ledger, and the dry-run diff (decisions the loop took vs
        actuations it performed — in dry-run the gap IS the diff).

        ``last``/``offset`` page backward through the ledger and
        ``compact`` drops the per-decision triggering snapshots
        (``signals_truncated``) — a 512-entry ledger over a large
        world serializes to multi-MB otherwise."""
        snap = self.bus.latest()
        decision_dicts = [
            d.to_dict(include_signals=not compact)
            for d in self.ledger.entries(last=last, offset=offset)
        ]
        return {
            "enabled": True,
            "dry_run": self.dry_run,
            "interval_s": self.interval_s,
            "sources": self.bus.source_names(),
            "signals": (
                {"seq": snap.seq, "ts": snap.ts, "values": snap.values}
                if snap is not None else None
            ),
            "decisions": decision_dicts,
            "decisions_total": self.ledger.decisions_total,
            "actuations_total": self.ledger.actuations_total,
            "ledger_window": {
                "last": last,
                "offset": offset,
                "returned": len(decision_dicts),
                "compact": compact,
            },
            "outcomes": {
                "attached": self.ledger.outcomes_total,
                "missed": self.ledger.outcome_misses_total,
                "pending": len(self._pending_outcomes),
                "window_s": self.attribution_window_s,
            },
            "recording": (
                self.recorder.stats()
                if self.recorder is not None else None
            ),
            "dry_run_diff": {
                "decisions_total": self.ledger.decisions_total,
                "actuations_total": self.ledger.actuations_total,
                "suppressed": (
                    self.ledger.decisions_total
                    - self.ledger.actuations_total
                ),
            },
        }


class BrainPrior:
    """Cross-job prior over the brain service (§-brain): ask
    ``/optimize`` for a starting world size, report the achieved
    goodput back on completion. Every failure degrades to None/no-op —
    an unreachable brain must never gate a job."""

    def __init__(self, brain_addr: str, job_name: str,
                 timeout_s: float = 5.0):
        self._addr = brain_addr
        self._job_name = job_name
        self._timeout = timeout_s

    def _post(self, path: str, payload: Dict) -> Optional[Dict]:
        # The brain's client (``brain/client.py``) is not ported yet:
        # refused rather than read as an unreachable brain.
        raise NotImplementedError(
            "the brain prior needs the brain service's client "
            "(brain/client.py), not ported yet: ROADMAP §A item 8b"
        )

    def initial_world(self) -> Optional[Dict]:
        try:
            result = self._post(
                "/optimize", {"job_name": self._job_name}
            )
        except NotImplementedError:
            raise
        except Exception:  # noqa: BLE001 — prior only, never gate
            logger.warning("brain prior unreachable; no seed")
            return None
        plan = (result or {}).get("plan")
        if not isinstance(plan, dict) or not plan.get("worker_count"):
            return None
        return plan

    def report_outcome(self, goodput: float, worker_count: int,
                       speed: float = 0.0, success: bool = True):
        """Achieved-goodput report-back: a runtime sample (so the
        optimizer's per-count evidence grows) plus a completion record."""
        try:
            self._post("/persist_metrics", {
                "kind": "runtime",
                "record": {
                    "job_name": self._job_name,
                    "speed": speed,
                    "goodput": goodput,
                    "worker_count": worker_count,
                },
            })
            self._post("/persist_metrics", {
                "kind": "completion",
                "record": {
                    "job_name": self._job_name,
                    "success": success,
                    "goodput": goodput,
                    "worker_count": worker_count,
                },
            })
        except NotImplementedError:
            raise
        except Exception:  # noqa: BLE001
            logger.warning("brain outcome report failed")
