"""Training-hang diagnostician.

Parity: reference dlrover/python/diagnosis/diagnostician/training_hang.py
:61-339 (TrainingHangDiagnostician) — detects a hung job from global-step
stagnation while all nodes still heartbeat (the XLA-collective-deadlock
signature: processes alive, no step progress), escalating from an
observability event to a job-level restart.

TPU note: without per-kernel NCCL introspection the primary hang signal
is step stagnation from the PerfMonitor plus (when the native profiler is
running) a frozen executable-launch counter from tpu_timer metrics.
The port's one divergence: in-band steps that rose between two
observations within the hang window veto a hang that only flat
out-of-band counters claim.

The port's copy of ``dlrover_tpu/diagnosis/diagnosticians/training_hang.py``.
"""

import time

from dlrover_tpu_torch.diagnosis.actions import (
    DiagnosisAction,
    EventAction,
    JobRestartAction,
)
from dlrover_tpu_torch.diagnosis.diagnostician import Diagnostician, Observation

_HANG_OBSERVATION = "training-hang"


class TrainingHangDiagnostician(Diagnostician):
    observe_interval_s = 30.0

    def __init__(
        self,
        perf_monitor,
        job_manager=None,
        hang_timeout_s: float = 600.0,
        restart_after_s: float = 1800.0,
        metric_context=None,
        clock=time.time,
        stack_dump_provider=None,
    ):
        self._perf_monitor = perf_monitor
        self._job_manager = job_manager
        self._hang_timeout_s = hang_timeout_s
        self._restart_after_s = restart_after_s
        self._hang_since = 0.0
        # Callable returning recent worker stack dumps (the
        # hang_watchdog's sys._current_frames() captures, reported as
        # "stack_dump" diagnosis data): lets the escalation name the
        # blocked frame instead of just "no step progress".
        self._stack_dump_provider = stack_dump_provider
        # Injectable clock: escalation thresholds are minutes-scale in
        # production, and the tests must drive stagnation -> EventAction
        # -> JobRestartAction without real sleeps.
        self._clock = clock
        # Optional out-of-band corroboration (common/metric.py): the
        # native daemons' step counters come from a C++ thread, so a
        # worker wedged inside libtpu still reports — a frozen counter
        # there is independent evidence the in-band RPC path can't give
        # (and an advancing one vetoes a false hang from lost reports).
        self._metric_context = metric_context
        # The in-band global step at the last observation, and the clock
        # time this diagnostician last saw it rise (None: never).
        self._seen_step = None
        self._advanced_at = None

    def _note_in_band_step(self):
        step = self._perf_monitor.global_step
        if self._seen_step is not None and step > self._seen_step:
            self._advanced_at = self._clock()
        self._seen_step = step

    def _in_band_advancing(self) -> bool:
        """True while the in-band global step rose between two of this
        diagnostician's observations within the hang window."""
        return (
            self._advanced_at is not None
            and self._clock() - self._advanced_at <= self._hang_timeout_s
        )

    def observe(self, **kwargs) -> Observation:
        self._note_in_band_step()
        started = self._perf_monitor.global_step > 0
        stagnated = started and self._perf_monitor.step_stagnated(
            self._hang_timeout_s
        )
        if started and self._metric_context is not None:
            from dlrover_tpu_torch.common.metric import STEP_COUNTER

            def advancing(node):
                window = self._metric_context.window(
                    node, STEP_COUNTER, self._hang_timeout_s
                )
                values = [v for _, v in window]
                return len(values) >= 2 and max(values) > min(values)

            oob_frozen = self._metric_context.steps_frozen(
                self._hang_timeout_s
            )
            if stagnated and not oob_frozen and any(
                advancing(n) for n in self._metric_context.nodes()
            ):
                # In-band reports stalled but a native counter is
                # demonstrably ADVANCING: the reporting path is the
                # problem, not the training. (Mere sample existence is
                # not evidence — daemons that answered once then died
                # must not veto a real hang.)
                stagnated = False
            elif not stagnated and oob_frozen and not self._in_band_advancing():
                # Every native counter is flat and the in-band reports
                # show no new step either. In-band steps that advance
                # veto this: flat out-of-band counters alone (a stale
                # daemon, a loop that does not tick the counter) do not
                # mark a training job hung (the reference's do).
                stagnated = True
        nodes_alive = True
        if self._job_manager is not None and hasattr(
            self._job_manager, "all_running_node_hanged"
        ):
            # If nodes stopped heartbeating this is a failure, not a hang;
            # the heartbeat monitor handles it.
            nodes_alive = not self._job_manager.all_running_node_hanged()
        if stagnated and nodes_alive:
            if self._hang_since == 0.0:
                self._hang_since = self._clock()
            return Observation(
                observation=_HANG_OBSERVATION,
                extra={
                    "step": str(self._perf_monitor.global_step),
                    "hang_for_s": f"{self._clock() - self._hang_since:.0f}",
                },
            )
        self._hang_since = 0.0
        return Observation()

    def _stack_evidence(self) -> str:
        """Blocked-frame summary from worker stack dumps, '' when none:
        "rank 3 blocked in psum_wait (foo.py:42)". The provider is the
        worker-side hang watchdog's capture, relayed over the diagnosis
        verb — evidence, not a trigger, so failures stay silent."""
        if self._stack_dump_provider is None:
            return ""
        try:
            dumps = self._stack_dump_provider() or []
        except Exception:  # noqa: BLE001 — evidence is best-effort
            return ""
        parts = []
        for dump in dumps[:4]:
            if not isinstance(dump, dict):
                continue
            meta = dump.get("meta", {})
            rank = meta.get("node_rank", dump.get("node_rank", "?"))
            stacks = dump.get("stacks", {})
            # The innermost frame of the main thread (or any thread
            # when unnamed) is where the worker actually sits.
            frames = (
                stacks.get(next(
                    (k for k in stacks if k.startswith("MainThread")),
                    "",
                )) or next(iter(stacks.values()), [])
            )
            if frames:
                top = frames[-1]
                parts.append(f"rank {rank} blocked in {top}")
        return "; ".join(parts)

    def resolve(self, ob: Observation, **kwargs) -> DiagnosisAction:
        hang_for = self._clock() - self._hang_since
        evidence = self._stack_evidence()
        suffix = f" ({evidence})" if evidence else ""
        if hang_for >= self._restart_after_s:
            self._hang_since = 0.0
            return JobRestartAction(
                reason=(
                    f"no step progress for {hang_for:.0f}s at step "
                    f"{ob.extra.get('step')}{suffix}"
                )
            )
        return EventAction(
            event_type="warning",
            event_msg=(
                f"training hang suspected: step {ob.extra.get('step')} "
                f"stalled for {ob.extra.get('hang_for_s')}s{suffix}"
            ),
            reason=_HANG_OBSERVATION,
        )
