"""Master overload accounting and graceful degradation (DESIGN.md §32).

When the control plane saturates — inflight RPC depth climbing, handler
latency EWMA past its band — the master must degrade in a *lawful*
order rather than slow down uniformly:

    **diagnostics before data, data never before leases.**

Concretely, three shed classes:

- ``diagnostic`` — span pushes and diagnosis reports
  (``DiagnosisDataReport``) and resource stats (``ResourceStats``).
  First to go: losing them costs observability detail, never
  correctness.
- ``telemetry`` — step/goodput progress reports (``GlobalStepReport``,
  ``GoodputPhaseReport``). Shed only above the second watermark:
  goodput accounting degrades, training does not.
- ``critical`` — everything else: task leases, rendezvous, KV/sync
  barriers, checkpoint coordination, rescale plans, heartbeats.
  **Never shed.** A master that drops a lease verb under load converts
  an overload into a training stall; the admission governor is
  structurally incapable of it (``admit`` returns before any shed
  logic for critical verbs).

The governor is a small hysteresis state machine over two signals the
servicer feeds it — per-request handler seconds (EWMA'd here) and the
current inflight depth — with injectable clock for tests. Escalation
is immediate (an overloaded master must not debounce its own relief);
de-escalation requires ``calm_hold_s`` of both signals under the low
watermarks (a flapping governor would turn diagnostics into a strobe).

Every shed ticks ``master_load_shed_total{class}``; the servicer
additionally ticks ``master_rpc_dropped_total{verb}``. Live state —
level, EWMA, watermarks, per-class shed totals — is served at
``/api/control_plane`` next to every bounded buffer's occupancy/drop
counters, so "is the master shedding and what is it costing" is one
dashboard fetch.

The port's copy of ``dlrover_tpu/master/overload.py``.
"""

import threading
import time
from typing import Callable, Dict, Optional

from dlrover_tpu_torch.observability.registry import default_registry

CLASS_DIAGNOSTIC = "diagnostic"
CLASS_TELEMETRY = "telemetry"
CLASS_CRITICAL = "critical"

# Request-type names (the servicer's verb strings) per shed class.
# Anything unlisted is critical — new verbs are protected by default
# and must opt INTO sheddability.
DIAGNOSTIC_VERBS = frozenset({
    "DiagnosisDataReport",
    "ResourceStats",
})
TELEMETRY_VERBS = frozenset({
    "GlobalStepReport",
    "GoodputPhaseReport",
})

# Shed levels: 0 admits everything, 1 sheds diagnostic, 2 sheds
# diagnostic + telemetry. There is deliberately no level 3.
LEVEL_CLASSES = {
    0: frozenset(),
    1: frozenset({CLASS_DIAGNOSTIC}),
    2: frozenset({CLASS_DIAGNOSTIC, CLASS_TELEMETRY}),
}


def classify(verb: str) -> str:
    if verb in DIAGNOSTIC_VERBS:
        return CLASS_DIAGNOSTIC
    if verb in TELEMETRY_VERBS:
        return CLASS_TELEMETRY
    return CLASS_CRITICAL


class OverloadGovernor:
    """Admission governor: watches inflight depth + handler-latency
    EWMA, sheds diagnostic traffic first, never touches critical verbs.

    ``latency_high_s``/``inflight_high`` define the level-1 watermark;
    level 2 engages at ``level2_factor`` times either watermark. Both
    signals must sit under ``low_frac`` of the level-1 watermark for
    ``calm_hold_s`` before the level steps back down (one step per
    calm period).
    """

    def __init__(
        self,
        latency_high_s: float = 0.25,
        inflight_high: int = 64,
        level2_factor: float = 2.0,
        low_frac: float = 0.5,
        calm_hold_s: float = 2.0,
        ewma_alpha: float = 0.2,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._lock = threading.Lock()
        self._clock = clock
        self._latency_high_s = float(latency_high_s)
        self._inflight_high = int(inflight_high)
        self._level2_factor = float(level2_factor)
        self._low_frac = float(low_frac)
        self._calm_hold_s = float(calm_hold_s)
        self._alpha = float(ewma_alpha)
        self._ewma_s: Optional[float] = None
        self._inflight = 0
        self._level = 0
        self._calm_since: Optional[float] = None
        self._last_observe: Optional[float] = None
        self._level_changes = 0
        self._shed_counts: Dict[str, int] = {
            CLASS_DIAGNOSTIC: 0, CLASS_TELEMETRY: 0,
        }
        self._shed_counter = default_registry().counter(
            "master_load_shed_total",
            "RPCs shed by the overload governor per traffic class",
            labelnames=("cls",),
        )

    # ---- operator/harness knobs -------------------------------------------

    def set_thresholds(
        self,
        latency_high_s: Optional[float] = None,
        inflight_high: Optional[int] = None,
    ):
        """Retune watermarks live (dashboard/ops hook; the load harness
        drops them to force the shed path deterministically)."""
        with self._lock:
            if latency_high_s is not None:
                self._latency_high_s = float(latency_high_s)
            if inflight_high is not None:
                self._inflight_high = int(inflight_high)

    # ---- signal feed -------------------------------------------------------

    def observe(self, handler_s: float, inflight: int):
        """Called by the servicer after every dispatched handler."""
        now = self._clock()
        with self._lock:
            self._last_observe = now
            self._inflight = max(int(inflight), 0)
            if self._ewma_s is None:
                self._ewma_s = max(handler_s, 0.0)
            else:
                self._ewma_s = (
                    self._alpha * max(handler_s, 0.0)
                    + (1.0 - self._alpha) * self._ewma_s
                )
            self._step_level(now)

    def _load_factor(self) -> float:
        """max of the two signals, each normalized to its level-1
        watermark: >=1 means level 1 territory, >=level2_factor means
        level 2."""
        lat = (
            (self._ewma_s / self._latency_high_s)
            if (self._ewma_s is not None and self._latency_high_s > 0)
            else 0.0
        )
        depth = (
            self._inflight / self._inflight_high
            if self._inflight_high > 0 else 0.0
        )
        return max(lat, depth)

    def _step_level(self, now: float):
        factor = self._load_factor()
        target = (
            2 if factor >= self._level2_factor
            else 1 if factor >= 1.0
            else 0
        )
        if target > self._level:
            # Escalate immediately — relief must not debounce.
            self._level = target
            self._level_changes += 1
            self._calm_since = None
            return
        if self._level == 0:
            self._calm_since = None
            return
        if factor < self._low_frac:
            if self._calm_since is None:
                self._calm_since = now
            elif now - self._calm_since >= self._calm_hold_s:
                self._level -= 1
                self._level_changes += 1
                self._calm_since = None
        else:
            self._calm_since = None

    def _relax_if_idle_locked(self, now: float):
        """De-escalation must not depend on handled traffic arriving:
        observe() only runs when a handler executes, so a master whose
        remaining traffic is ALL being shed (or none at all) would
        latch its level forever. An idle signal feed is a calm one —
        step down one level per ``calm_hold_s`` of silence."""
        if self._level == 0 or self._last_observe is None:
            return
        idle = now - self._last_observe
        steps = int(idle / self._calm_hold_s) if self._calm_hold_s > 0 \
            else (1 if idle > 0 else 0)
        if steps <= 0:
            return
        new_level = max(self._level - steps, 0)
        if new_level != self._level:
            self._level = new_level
            self._level_changes += 1
            self._calm_since = None
        # Consume the idle time spent stepping so the NEXT step needs
        # another full hold of silence.
        self._last_observe = now

    # ---- admission ---------------------------------------------------------

    def admit(self, verb: str) -> Optional[str]:
        """None = admitted. Otherwise the shed class name — the caller
        answers without running the handler. Critical verbs return
        before any shed logic: the ordering law is structural."""
        cls = classify(verb)
        if cls == CLASS_CRITICAL:
            return None
        with self._lock:
            self._relax_if_idle_locked(self._clock())
            if cls not in LEVEL_CLASSES[self._level]:
                return None
            self._shed_counts[cls] += 1
        self._shed_counter.inc(cls=cls)
        return cls

    # ---- read side ---------------------------------------------------------

    @property
    def level(self) -> int:
        with self._lock:
            self._relax_if_idle_locked(self._clock())
            return self._level

    def state(self) -> Dict:
        with self._lock:
            self._relax_if_idle_locked(self._clock())
            return {
                "level": self._level,
                "level_changes": self._level_changes,
                "handler_ewma_s": (
                    round(self._ewma_s, 6)
                    if self._ewma_s is not None else None
                ),
                "inflight": self._inflight,
                "load_factor": round(self._load_factor(), 4),
                "latency_high_s": self._latency_high_s,
                "inflight_high": self._inflight_high,
                "level2_factor": self._level2_factor,
                "calm_hold_s": self._calm_hold_s,
                "shed_total": dict(self._shed_counts),
                "shed_classes_now": sorted(LEVEL_CLASSES[self._level]),
                "ordering_law": "diagnostics before data, "
                                "data never before leases",
            }
