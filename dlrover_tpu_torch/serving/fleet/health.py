"""Per-replica health: a deterministic, clock-injectable circuit
breaker (the port's own copy of ``dlrover_tpu/serving/fleet/health.py``).

The router must keep dispatching while replicas die, stall, or flap —
so each replica gets one small state machine, advanced ONLY by explicit
inputs (successes, failures, heartbeats, liveness) and an injectable
clock, never by wall-time side effects. That is what makes the FSM
unit-testable without sleeps (the `TrainingHangDiagnostician` pattern
from the fault plane) and its transitions reproducible in chaos soaks.

States::

    HEALTHY ──consecutive failures >= suspect_after──▶ SUSPECT
    SUSPECT ──one success──▶ HEALTHY
    SUSPECT ──consecutive failures >= broken_after──▶ BROKEN
    any     ──mark_dead() (process exit, poison)──▶ BROKEN
    BROKEN  ──probe_cooldown_s elapsed + dispatch wanted──▶ HALF_OPEN
    HALF_OPEN ──probe_successes successes──▶ HEALTHY
    HALF_OPEN ──any failure──▶ BROKEN (cooldown restarts)

SUSPECT still takes traffic (it is a *warning* state — deprioritized by
the router's least-loaded choice, not fenced), BROKEN takes none,
HALF_OPEN takes a bounded number of in-flight probe requests (real
traffic used as canaries). Missed heartbeats count as failures: one
strike per elapsed ``heartbeat_timeout_s`` window, so a stalled-but-
alive replica walks HEALTHY → SUSPECT → BROKEN on the same path an
erroring one does.
"""

import time
from dataclasses import dataclass
from typing import Callable, Optional

HEALTHY = "healthy"
SUSPECT = "suspect"
BROKEN = "broken"
HALF_OPEN = "half_open"

# Gauge encoding for the per-replica state metric family.
STATE_CODE = {HEALTHY: 0, SUSPECT: 1, BROKEN: 2, HALF_OPEN: 3}


@dataclass
class HealthPolicy:
    """Thresholds; all deterministic counters/durations."""

    suspect_after: int = 2        # consecutive failures HEALTHY->SUSPECT
    broken_after: int = 4         # consecutive failures ->BROKEN
    heartbeat_timeout_s: float = 2.0
    probe_cooldown_s: float = 1.0  # BROKEN quarantine before HALF_OPEN
    probe_successes: int = 2      # HALF_OPEN successes to re-admit
    max_probes_inflight: int = 1  # concurrent canaries while HALF_OPEN

    def __post_init__(self):
        if self.suspect_after < 1 or self.broken_after < self.suspect_after:
            raise ValueError(
                "need 1 <= suspect_after <= broken_after, got "
                f"{self.suspect_after}/{self.broken_after}"
            )


class ReplicaHealth:
    """One replica's breaker. Not thread-safe by design — the router's
    single pump thread owns every transition."""

    def __init__(
        self,
        replica_id: str,
        policy: Optional[HealthPolicy] = None,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str], None]] = None,
    ):
        self.replica_id = str(replica_id)
        self.policy = policy or HealthPolicy()
        self._clock = clock
        self._on_transition = on_transition
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.last_failure_reason = ""
        self._broken_since: Optional[float] = None
        self._probe_successes = 0
        self.probes_inflight = 0
        now = clock()
        self._last_heartbeat = now
        # Next time a stale heartbeat earns a strike; re-armed by every
        # real heartbeat, advanced by every strike so one long stall
        # escalates once per timeout window, not once per check() call.
        self._next_hb_strike = now + self.policy.heartbeat_timeout_s

    # ---- inputs ------------------------------------------------------------

    def observe_heartbeat(self, t: Optional[float] = None) -> None:
        t = self._clock() if t is None else t
        if t > self._last_heartbeat:
            self._last_heartbeat = t
            self._next_hb_strike = t + self.policy.heartbeat_timeout_s

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state == HALF_OPEN:
            self._probe_successes += 1
            if self._probe_successes >= self.policy.probe_successes:
                self._transition(HEALTHY)
        elif self.state == SUSPECT:
            self._transition(HEALTHY)

    def record_failure(self, reason: str = "error") -> None:
        self.last_failure_reason = reason
        if self.state == HALF_OPEN:
            # A failed canary slams the breaker shut; cooldown restarts.
            self._break()
            return
        if self.state == BROKEN:
            return
        self.consecutive_failures += 1
        if self.consecutive_failures >= self.policy.broken_after:
            self._break()
        elif (
            self.state == HEALTHY
            and self.consecutive_failures >= self.policy.suspect_after
        ):
            self._transition(SUSPECT)

    def mark_dead(self, reason: str = "dead") -> None:
        """Hard evidence (process exited, thread gone): straight to
        BROKEN, no strike accumulation."""
        self.last_failure_reason = reason
        if self.state != BROKEN:
            self._break()

    def check(self, now: Optional[float] = None) -> None:
        """Advance time-driven transitions: missed-heartbeat strikes.
        Call once per router pump iteration."""
        now = self._clock() if now is None else now
        if self.state == BROKEN:
            return
        while now >= self._next_hb_strike:
            self._next_hb_strike += self.policy.heartbeat_timeout_s
            self.record_failure("heartbeat")
            if self.state == BROKEN:
                return

    # ---- dispatch gate -----------------------------------------------------

    def dispatchable(self, now: Optional[float] = None) -> bool:
        """May the router hand this replica a request right now? A
        BROKEN breaker whose cooldown elapsed flips to HALF_OPEN here —
        the transition is demand-driven, so quarantine costs nothing
        when no traffic wants the replica."""
        now = self._clock() if now is None else now
        if self.state in (HEALTHY, SUSPECT):
            return True
        if self.state == BROKEN:
            if (
                self._broken_since is not None
                and now - self._broken_since >= self.policy.probe_cooldown_s
            ):
                self._transition(HALF_OPEN)
                self._probe_successes = 0
                self.probes_inflight = 0
            else:
                return False
        return self.probes_inflight < self.policy.max_probes_inflight

    def is_probe_dispatch(self) -> bool:
        return self.state == HALF_OPEN

    def begin_probe(self) -> None:
        self.probes_inflight += 1

    def end_probe(self) -> None:
        self.probes_inflight = max(0, self.probes_inflight - 1)

    def heartbeat_age(self, now: Optional[float] = None) -> float:
        """Seconds since the last observed heartbeat — the router's
        wedge detector (BROKEN + stale heartbeat = hung, not erroring)."""
        now = self._clock() if now is None else now
        return now - self._last_heartbeat

    def cooldown_elapsed(self, now: Optional[float] = None) -> bool:
        now = self._clock() if now is None else now
        return (
            self.state == BROKEN
            and self._broken_since is not None
            and now - self._broken_since >= self.policy.probe_cooldown_s
        )

    # ---- internals ---------------------------------------------------------

    def _break(self) -> None:
        self._broken_since = self._clock()
        self._probe_successes = 0
        self.probes_inflight = 0
        self._transition(BROKEN)

    def _transition(self, new: str) -> None:
        old, self.state = self.state, new
        if new == HEALTHY:
            self.consecutive_failures = 0
            self._broken_since = None
        if new in (HEALTHY, HALF_OPEN):
            # A fresh start (or a probe window after a long BROKEN
            # quarantine) gets a fresh heartbeat grace window — the
            # stale strikes accumulated while fenced must not instantly
            # re-break the breaker before the first probe lands.
            self._next_hb_strike = (
                self._clock() + self.policy.heartbeat_timeout_s
            )
        if old != new and self._on_transition is not None:
            self._on_transition(old, new)
