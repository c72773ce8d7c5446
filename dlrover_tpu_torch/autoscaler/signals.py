"""SignalBus: the autoscaler's read side of the observability plane.

One bus holds named *sources* — zero-arg callables returning a flat
``{key: value}`` dict — and :meth:`SignalBus.sample` merges them into a
:class:`SignalSnapshot` under ``"<source>.<key>"`` names. Everything the
last eight PRs built to *observe* the job plugs in here as a source:

- :func:`perf_source` — goodput fraction, running speed, global step,
  and the per-rank step-time straggler report (PerfMonitor, §29);
- :func:`data_source` — shard-queue depths (TaskManager, §24);
- :func:`fleet_source` — serving queue depth / in-flight / dispatchable
  replicas / TTFT p99 from the fleet metric families (§28);
- :func:`fault_source` — failure count + observed MTBF from a
  :class:`FaultHistory` fed by node-failure events (§26).

A source that raises does not poison the snapshot: its error lands
under ``"<source>.error"`` and the other sources still sample — the
brain must keep seeing with one eye shut.

Snapshots are immutable evidence: the policy engine copies the
triggering snapshot into every decision it emits, so the ledger never
contains an unexplained action.

The port's copy of ``dlrover_tpu/autoscaler/signals.py``: the same
sources over the port's registry families, perf monitor, task manager,
paged engine and servicer.
"""

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.flash_ckpt.autotune import MtbfTracker


@dataclass
class SignalSnapshot:
    """One sampled view of the job. ``values`` maps flat
    ``"<source>.<key>"`` names to scalars (or small lists/dicts for
    e.g. straggler scores).

    ``ts`` is the wall clock (what the clockless policy rules consume
    and what humans read in the ledger); ``mono`` is its monotonic
    twin, stamped at the same instant — the recorder persists the pair
    and the replay reader ORDERS by ``mono``, so an NTP step mid-run
    cannot reorder a recording."""

    seq: int
    ts: float
    values: Dict[str, object] = field(default_factory=dict)
    mono: float = 0.0

    def get(self, key: str, default=None):
        return self.values.get(key, default)


class SignalBus:
    """Named signal sources merged into timestamped snapshots.

    ``clock`` is injectable (tests and the soak harness drive it); a
    bounded history ring keeps the last ``history`` snapshots for the
    dashboard's sparkline-style views.
    """

    def __init__(self, clock: Callable[[], float] = time.time,
                 history: int = 128,
                 mono_clock: Optional[Callable[[], float]] = None):
        self._lock = threading.Lock()
        self._clock = clock
        # Every snapshot stamps a (wall, mono) PAIR. With the real wall
        # clock the monotonic twin is time.monotonic; an injected fake
        # clock drives both (tests advance one clock, both stamps move
        # together — and replay ordering stays coherent).
        if mono_clock is None:
            mono_clock = time.monotonic if clock is time.time else clock
        self._mono_clock = mono_clock
        self._sources: Dict[str, Callable[[], Dict[str, object]]] = {}
        self._history: Deque[SignalSnapshot] = deque(maxlen=max(history, 1))
        self._seq = 0

    def add_source(self, name: str,
                   fn: Callable[[], Dict[str, object]]) -> "SignalBus":
        with self._lock:
            self._sources[name] = fn
        return self

    def remove_source(self, name: str):
        with self._lock:
            self._sources.pop(name, None)

    def source_names(self) -> List[str]:
        with self._lock:
            return sorted(self._sources)

    def sample(self) -> SignalSnapshot:
        with self._lock:
            sources = list(self._sources.items())
            self._seq += 1
            seq = self._seq
        values: Dict[str, object] = {}
        for name, fn in sources:
            try:
                for key, value in (fn() or {}).items():
                    values[f"{name}.{key}"] = value
            except Exception as e:  # noqa: BLE001 — one eye shut, keep seeing
                values[f"{name}.error"] = f"{type(e).__name__}: {e}"[:160]
                logger.warning("signal source %r failed: %s", name, e)
        snap = SignalSnapshot(
            seq=seq, ts=self._clock(), mono=self._mono_clock(),
            values=values,
        )
        with self._lock:
            self._history.append(snap)
        return snap

    def latest(self) -> Optional[SignalSnapshot]:
        with self._lock:
            return self._history[-1] if self._history else None

    def history(self) -> List[SignalSnapshot]:
        with self._lock:
            return list(self._history)


# ---------------------------------------------------------------------------
# Fault history: failure arrivals -> observed MTBF
# ---------------------------------------------------------------------------


class FaultHistory:
    """Observed failure arrivals, the ckpt-cadence rule's input.

    Fed by the master's node-failure path (``record_failure``) or by a
    soak harness; exposes failures_total, the age of the newest failure
    and — once ``min_failures`` arrivals are in the window — the
    observed mean time between failures (:class:`MtbfTracker`).

    The default clock is MONOTONIC (audit satellite): every consumer
    here is a time *difference* (inter-arrival gaps, failure age), and
    a wall-clock step between two failures would corrupt the observed
    MTBF the ckpt-cadence rule retunes from. Injected fake clocks
    behave as before.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 window: int = 32, min_failures: int = 2):
        self._lock = threading.Lock()
        self._clock = clock
        self._tracker = MtbfTracker(window=window,
                                    min_failures=min_failures)
        self._total = 0
        self._last_ts: Optional[float] = None

    def record_failure(self, ts: Optional[float] = None):
        ts = self._clock() if ts is None else float(ts)
        with self._lock:
            self._total += 1
            self._last_ts = ts
            self._tracker.record_failure(ts)

    @property
    def failures_total(self) -> int:
        with self._lock:
            return self._total

    def observed_mtbf_s(self) -> Optional[float]:
        with self._lock:
            return self._tracker.observed_mtbf_s()

    def last_failure_age_s(self) -> Optional[float]:
        with self._lock:
            if self._last_ts is None:
                return None
            return max(self._clock() - self._last_ts, 0.0)


# ---------------------------------------------------------------------------
# Built-in sources over the existing observability plane
# ---------------------------------------------------------------------------


def perf_source(
    perf_monitor, threshold: Optional[float] = None
) -> Callable[[], Dict[str, object]]:
    """Goodput/speed/step + the §29 straggler report from a
    :class:`~dlrover_tpu_torch.master.monitor.perf_monitor.PerfMonitor`.
    ``threshold`` overrides the monitor's flagging bar — pass the
    policy's ``straggler_score`` when it is BELOW the monitor default
    (the policy re-filters upward on its own, but cannot see ranks the
    monitor never reports)."""

    def fn() -> Dict[str, object]:
        report = perf_monitor.straggler_report(threshold=threshold)
        return {
            "goodput": perf_monitor.goodput(),
            "speed": perf_monitor.running_speed(),
            "global_step": perf_monitor.global_step,
            "straggler_ranks": list(report["stragglers"]),
            "straggler_scores": {
                rank: info["score"]
                for rank, info in report["ranks"].items()
            },
            "median_step_s": report["median_step_time_s"],
        }

    return fn


def data_source(task_manager) -> Callable[[], Dict[str, object]]:
    """Aggregate shard-queue depths across every dataset the
    TaskManager owns (todo = undispatched backlog, doing = leased)."""

    def fn() -> Dict[str, object]:
        todo = doing = 0
        with task_manager._lock:  # noqa: SLF001 — read-only depth view
            datasets = dict(task_manager._datasets)  # noqa: SLF001
        for mgr in datasets.values():
            todo += len(mgr.todo)
            doing += len(mgr.doing)
        return {"todo": todo, "doing": doing}

    return fn


def fleet_source(registry=None) -> Callable[[], Dict[str, object]]:
    """Serving-fleet load from the §28 metric families: router queue
    depth, in-flight attempts, breaker-admitted replica count, TTFT
    p99. Families absent (no router in this process) read as empty."""

    def fn() -> Dict[str, object]:
        from dlrover_tpu_torch.observability.registry import default_registry

        reg = registry or default_registry()
        out: Dict[str, object] = {}
        for key, family in (
            ("queue_depth", "fleet_queue_depth"),
            ("inflight", "fleet_inflight"),
            ("replicas", "fleet_replicas_dispatchable"),
        ):
            fam = reg.get(family)
            if fam is not None:
                out[key] = fam.value()
        ttft = reg.get("fleet_ttft_seconds")
        if ttft is not None:
            p99 = ttft.quantile(0.99)
            if p99 is not None:
                out["ttft_p99_s"] = round(p99, 6)
        slots = reg.get("serving_slots_total")
        active = reg.get("serving_active_slots")
        if slots is not None and active is not None:
            total = slots.value()
            if total > 0:
                out["slot_util"] = round(active.value() / total, 4)
        return out

    return fn


def kvpool_source(engine) -> Callable[[], Dict[str, object]]:
    """Paged-KV memory pressure + SLO-class queue depths from a
    :class:`~dlrover_tpu_torch.serving.kvpool.PagedServingEngine` (§31).
    The autoscaler's memory eye: ``blocks_free_frac`` falling while
    per-class queues grow says the fleet is BLOCK-bound, not
    replica-bound — grow capacity (or shed batch-class admission)
    before TTFT collapses."""

    def fn() -> Dict[str, object]:
        stats = engine.kv_stats()
        total = max(stats.get("total", 0), 1)
        out: Dict[str, object] = {
            "blocks_total": stats.get("total", 0),
            "blocks_free": stats.get("free", 0),
            "blocks_used": stats.get("used", 0),
            "blocks_cached": stats.get("cached", 0),
            "blocks_free_frac": round(
                stats.get("free", 0) / total, 4
            ),
            "bytes_in_use": stats.get("bytes_in_use", 0),
            "prefix_hit_rate": stats.get("prefix_hit_rate", 0.0),
        }
        for name, depth in (
            engine.scheduler.queue_depth_by_class().items()
        ):
            out[f"queue_depth.{name}"] = depth
        return out

    return fn


def control_plane_source(state_fn) -> Callable[[], Dict[str, object]]:
    """The master's own saturation (§32) as an autoscaler signal:
    ``state_fn`` is the servicer's ``control_plane_state``. A policy
    watching ``shed_level``/``inflight`` rising with world size can
    stop admitting scale-up before the control plane — not the
    accelerators — becomes the binding constraint."""

    def fn() -> Dict[str, object]:
        state = state_fn()
        overload = state.get("overload", {})
        rpc = state.get("rpc", {})
        out: Dict[str, object] = {
            "shed_level": overload.get("level", 0),
            "handler_ewma_s": overload.get("handler_ewma_s") or 0.0,
            "load_factor": overload.get("load_factor", 0.0),
            "inflight": rpc.get("inflight", 0),
            "inflight_high_water": rpc.get("inflight_high_water", 0),
            "rpcs_total": rpc.get("rpcs_total", 0),
            "cpu_seconds_total": rpc.get("cpu_seconds_total", 0.0),
        }
        for cls, count in (overload.get("shed_total") or {}).items():
            out[f"shed_total.{cls}"] = count
        return out

    return fn


def fault_source(history: FaultHistory) -> Callable[[], Dict[str, object]]:
    """Failure count + observed MTBF (omitted until measurable)."""

    def fn() -> Dict[str, object]:
        out: Dict[str, object] = {
            "failures_total": history.failures_total,
        }
        mtbf = history.observed_mtbf_s()
        if mtbf is not None:
            out["mtbf_s"] = round(mtbf, 4)
        age = history.last_failure_age_s()
        if age is not None:
            out["last_failure_age_s"] = round(age, 4)
        return out

    return fn
