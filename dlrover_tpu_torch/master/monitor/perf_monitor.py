"""Job-level performance monitor: step throughput and goodput accounting.

Parity: reference dlrover/python/master/monitor/perf_monitor.py:45
(PerfMonitor: global step speed, straggler-ish stats). Extended with an
explicit goodput ledger — wall time attributed to train/ckpt/restart/
rendezvous phases — because goodput-under-faults is this framework's
north-star metric.

The port's copy of ``dlrover_tpu/master/monitor/perf_monitor.py``.
"""

import threading
import time
from collections import defaultdict, deque
from typing import Deque, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import GoodputPhase
from dlrover_tpu_torch.observability.registry import default_registry


class PerfMonitor:
    # §34 lost-time cause taxonomy: every non-train wall second is
    # attributed to the decision/fault that cost it, or lands in the
    # single residual bucket "unattributed". The /api/goodput view and
    # the soak's ≥90%-attribution invariant read these names verbatim.
    CAUSES = ("ckpt", "rescale", "straggler", "hang", "shed")
    UNATTRIBUTED = "unattributed"
    # Phases whose cause is implied when the reporter passes none.
    _PHASE_CAUSE = {
        GoodputPhase.CKPT: "ckpt",
        GoodputPhase.RESTART: "rescale",
        GoodputPhase.RENDEZVOUS: "rescale",
    }

    def __init__(self, speed_window: int = 30, max_phase_records: int = 4096):
        self._lock = threading.Lock()
        self._start_time = time.time()
        self._global_step = 0
        self._last_step_report: Optional[Tuple[int, float]] = None
        self._speed_records: Deque[float] = deque(maxlen=speed_window)
        self._total_train_secs = 0.0
        # phase -> node_id -> seconds; goodput is averaged per node so a
        # multi-node job cannot saturate the metric at 1.0.
        self._phase_secs: Dict[str, Dict[int, float]] = defaultdict(
            lambda: defaultdict(float)
        )
        # cause -> node_id -> lost seconds (non-train intervals only).
        self._cause_secs: Dict[str, Dict[int, float]] = defaultdict(
            lambda: defaultdict(float)
        )
        # Raw (node, phase, start, end) intervals, bounded: the timeline
        # merger needs the intervals themselves, not just the sums.
        # Evictions are counted — after one, the records can no longer
        # reproduce goodput() exactly and consumers must know.
        self._phase_records: Deque[Dict] = deque(maxlen=max_phase_records)
        self._phase_records_dropped = 0
        self._max_phase_end = 0.0
        self._init_time = time.time()
        # Per-rank step-time EWMAs -> the straggler score (§29): skew of
        # one rank's step wall time against the fleet median. Fed by the
        # step_time_s piggyback on GlobalStepReport.
        self._rank_step_ewma: Dict[int, float] = {}
        self._rank_step_reports: Dict[int, int] = {}
        # §32: the gauge path is O(1) per report. A running median
        # ESTIMATOR (sign-step with a multiplicative delta, FAME-style)
        # tracks the fleet median incrementally; only the reporting
        # rank's gauge is refreshed per report; an exact resync runs
        # every ~R reports so estimator drift is bounded (amortized
        # O(log R) per report). straggler_report() stays an exact
        # recompute — its output is the contract.
        self._median_est = 0.0
        self._median_delta = 0.0
        self._reports_since_sync = 0
        registry = default_registry()
        self._phase_secs_counter = registry.counter(
            "dlrover_goodput_phase_seconds_total",
            "wall seconds attributed to each goodput phase",
            labelnames=("name",),
        )
        self._step_reports_counter = registry.counter(
            "dlrover_step_reports_total",
            "global-step reports received by the master",
        )
        self._straggler_gauge = registry.gauge(
            "dlrover_straggler_score",
            "per-rank step-time skew vs the fleet median (1.0 = median)",
            labelnames=("rank",),
        )
        self._lost_secs_counter = registry.counter(
            "dlrover_goodput_lost_seconds_total",
            "non-train wall seconds by attributed cause (§34 taxonomy)",
            labelnames=("cause",),
        )

    # ---- step speed --------------------------------------------------------

    def collect_global_step(
        self,
        step: int,
        timestamp: float,
        elapsed_train_secs: float = 0.0,
        node_id: int = -1,
        step_time_s: float = 0.0,
    ):
        with self._lock:
            if self._last_step_report is not None:
                prev_step, prev_ts = self._last_step_report
                dt = timestamp - prev_ts
                dstep = step - prev_step
                if dt > 0 and dstep > 0:
                    self._speed_records.append(dstep / dt)
            self._last_step_report = (step, timestamp)
            self._global_step = max(self._global_step, step)
            if elapsed_train_secs > 0:
                self._total_train_secs += elapsed_train_secs
            if node_id >= 0 and step_time_s > 0:
                prev = self._rank_step_ewma.get(node_id)
                ewma = (
                    step_time_s if prev is None
                    else 0.3 * step_time_s + 0.7 * prev
                )
                self._rank_step_ewma[node_id] = ewma
                self._rank_step_reports[node_id] = (
                    self._rank_step_reports.get(node_id, 0) + 1
                )
                gauge_score, resync = self._incremental_median_locked(ewma)
        self._step_reports_counter.inc()
        if node_id >= 0 and step_time_s > 0:
            # O(1) per report: only THIS rank's gauge moves, scored
            # against the running median estimate — the old path
            # recomputed the full O(R log R) report per gauge window.
            self._straggler_gauge.set(gauge_score, rank=str(node_id))
            if resync:
                # Amortized exact resync (~every R reports): bounds
                # estimator drift at O(log R) amortized per report.
                self._update_straggler_gauges()

    def _incremental_median_locked(self, ewma: float):
        """FAME-style running median: step the estimate toward each new
        observation by a delta that halves when the observation lands
        within delta of the estimate. O(1); called under ``_lock``.
        Returns (score-for-this-rank, exact-resync-due)."""
        if self._median_est <= 0.0:
            self._median_est = ewma
            self._median_delta = max(ewma / 2.0, 1e-9)
        else:
            if ewma > self._median_est:
                self._median_est += self._median_delta
            elif ewma < self._median_est:
                self._median_est -= self._median_delta
            if abs(ewma - self._median_est) < self._median_delta:
                self._median_delta = max(
                    self._median_delta / 2.0, self._median_est * 1e-3
                )
        self._reports_since_sync += 1
        resync = self._reports_since_sync >= max(
            len(self._rank_step_ewma), 32
        )
        if resync:
            self._reports_since_sync = 0
        return ewma / max(self._median_est, 1e-9), resync

    # ---- straggler score ---------------------------------------------------

    STRAGGLER_THRESHOLD = 1.5
    STRAGGLER_MIN_REPORTS = 3

    def straggler_report(
        self,
        threshold: Optional[float] = None,
        min_reports: Optional[int] = None,
    ) -> Dict:
        """Per-rank step-time skew: ``score = rank EWMA / fleet
        median``; a rank is flagged once its score clears ``threshold``
        over at least ``min_reports`` reports (one slow step must not
        page anyone). Live view behind ``/api/stragglers`` and the
        ``dlrover_straggler_score`` gauge."""
        threshold = (
            threshold if threshold is not None else self.STRAGGLER_THRESHOLD
        )
        min_reports = (
            min_reports if min_reports is not None
            else self.STRAGGLER_MIN_REPORTS
        )
        with self._lock:
            ewmas = dict(self._rank_step_ewma)
            reports = dict(self._rank_step_reports)
        if not ewmas:
            return {
                "ranks": {}, "stragglers": [],
                "median_step_time_s": 0.0, "threshold": threshold,
            }
        ordered = sorted(ewmas.values())
        mid = len(ordered) // 2
        median = (
            ordered[mid] if len(ordered) % 2
            else 0.5 * (ordered[mid - 1] + ordered[mid])
        )
        ranks = {}
        stragglers = []
        for rank, ewma in sorted(ewmas.items()):
            score = ewma / max(median, 1e-9)
            flagged = (
                len(ewmas) >= 2
                and score >= threshold
                and reports.get(rank, 0) >= min_reports
            )
            ranks[rank] = {
                "step_time_ewma_s": round(ewma, 6),
                "score": round(score, 4),
                "reports": reports.get(rank, 0),
                "flagged": flagged,
            }
            if flagged:
                stragglers.append(rank)
        return {
            "ranks": ranks,
            "stragglers": stragglers,
            "median_step_time_s": round(median, 6),
            "threshold": threshold,
        }

    def _update_straggler_gauges(self):
        """Exact gauge resync from a full straggler_report() — no
        longer on the per-report hot path (§32 replaced the old
        throttled full recompute with the O(1) incremental estimator);
        runs amortized every ~R reports, on explicit demand, and keeps
        the estimator honest by re-anchoring it to the true median."""
        report = self.straggler_report()
        for rank, info in report["ranks"].items():
            self._straggler_gauge.set(info["score"], rank=str(rank))
        median = report["median_step_time_s"]
        if median > 0:
            with self._lock:
                self._median_est = median
                self._median_delta = max(
                    self._median_delta, median * 1e-3
                )

    def reset_rank(self, rank: int):
        """Forget one rank's step-time history — called when the seat's
        OCCUPANT changes (straggler evicted, node replaced): the
        replacement must not inherit its predecessor's slow EWMA and
        report count, or a 3x-median ghost score re-flags a healthy
        worker for several reports (an evict loop at real step
        times)."""
        with self._lock:
            self._rank_step_ewma.pop(rank, None)
            self._rank_step_reports.pop(rank, None)
        self._straggler_gauge.set(0.0, rank=str(rank))

    @property
    def global_step(self) -> int:
        with self._lock:
            return self._global_step

    def running_speed(self) -> float:
        """Steps/sec over the sliding window."""
        with self._lock:
            if not self._speed_records:
                return 0.0
            return sum(self._speed_records) / len(self._speed_records)

    def step_stagnated(self, timeout_secs: float) -> bool:
        """True if no step progress has been reported for timeout_secs —
        the cheap hang signal used by the hang diagnostician."""
        with self._lock:
            if self._last_step_report is None:
                return False
            return (time.time() - self._last_step_report[1]) > timeout_secs

    # ---- goodput ledger ----------------------------------------------------

    def collect_phase(self, node_id: int, phase: str, start: float,
                      end: float, cause: Optional[str] = None):
        """Attribute one wall interval. Non-train intervals also carry
        a lost-time ``cause`` from the §34 taxonomy (:attr:`CAUSES`):
        explicit when the reporter knows who to blame (the autoscaler's
        eviction pause is ``straggler``, an overload shed is ``shed``),
        implied from the phase otherwise (ckpt→ckpt, restart→rescale),
        and ``unattributed`` as the only residual bucket."""
        if end <= start:
            return
        record = {
            "node_id": node_id,
            "phase": phase,
            "start": start,
            "end": end,
        }
        if phase == GoodputPhase.TRAIN:
            cause = None
        else:
            cause = cause or self._PHASE_CAUSE.get(
                phase, self.UNATTRIBUTED
            )
            if cause not in self.CAUSES:
                cause = self.UNATTRIBUTED
            record["cause"] = cause
        with self._lock:
            self._phase_secs[phase][node_id] += end - start
            if cause is not None:
                self._cause_secs[cause][node_id] += end - start
            if len(self._phase_records) == self._phase_records.maxlen:
                self._phase_records_dropped += 1
            self._phase_records.append(record)
            self._max_phase_end = max(self._max_phase_end, end)
        self._phase_secs_counter.inc(end - start, name=phase)
        if cause is not None:
            self._lost_secs_counter.inc(end - start, cause=cause)

    def goodput(self) -> float:
        """Fraction of wall time spent in productive training, averaged
        over reporting nodes."""
        with self._lock:
            wall = max(self._max_phase_end - self._init_time, 1e-9)
            per_node = self._phase_secs.get(GoodputPhase.TRAIN, {})
            if not per_node:
                return 0.0
            ratios = [min(t / wall, 1.0) for t in per_node.values()]
            return sum(ratios) / len(ratios)

    def goodput_basis(self) -> Dict:
        """How :meth:`goodput` is computed — previously only a code
        comment. Consumers (dashboards, the autoscaler, SREs reading
        /api/perf) need the averaging mode and node count to interpret
        the number: a 1-node 0.9 and a 64-node 0.9 are different
        claims."""
        with self._lock:
            per_node = self._phase_secs.get(GoodputPhase.TRAIN, {})
            return {
                "averaging": "per_node_train_fraction_mean",
                "nodes_reporting": len(per_node),
                "wall_s": round(
                    max(self._max_phase_end - self._init_time, 0.0), 6
                ),
                "wall_origin": "init_time_to_max_phase_end",
                "records_dropped": self._phase_records_dropped,
            }

    def goodput_attribution(self) -> Dict:
        """Per-cause accounting of the non-train wall time (§34): for
        the same node set and wall basis as :meth:`goodput`, how many
        lost seconds each cause explains, and what fraction of the
        lost time is attributed at all. ``unattributed`` is the only
        residual bucket — it covers both intervals reported without a
        cause and wall time nobody reported a phase for."""
        with self._lock:
            wall = max(self._max_phase_end - self._init_time, 1e-9)
            train_nodes = self._phase_secs.get(GoodputPhase.TRAIN, {})
            nodes = set(train_nodes)
            for per_node in self._cause_secs.values():
                nodes.update(per_node)
            if not nodes:
                return {
                    "wall_s": 0.0, "train_frac": 0.0, "lost_frac": 0.0,
                    "causes": {}, "unattributed_frac": 0.0,
                    "attributed_frac": 0.0, "nodes": 0,
                }
            n = len(nodes)
            train_frac = sum(
                min(train_nodes.get(node, 0.0) / wall, 1.0)
                for node in nodes
            ) / n
            causes: Dict[str, Dict[str, float]] = {}
            explained = 0.0
            for cause in (*self.CAUSES, self.UNATTRIBUTED):
                per_node = self._cause_secs.get(cause, {})
                secs = sum(per_node.get(node, 0.0) for node in nodes) / n
                frac = min(secs / wall, 1.0)
                causes[cause] = {
                    "seconds": round(secs, 6),
                    "frac": round(frac, 6),
                }
                if cause != self.UNATTRIBUTED:
                    explained += frac
        lost_frac = max(1.0 - train_frac, 0.0)
        explained = min(explained, lost_frac)
        # The residual bucket covers BOTH cause-less reports and
        # never-reported wall time; rewrite seconds and frac together
        # so the two fields of the dict cannot disagree (the reported
        # cause-less seconds alone would understate the residual).
        residual_frac = max(lost_frac - explained, 0.0)
        causes[self.UNATTRIBUTED] = {
            "seconds": round(residual_frac * wall, 6),
            "frac": round(residual_frac, 6),
        }
        return {
            "wall_s": round(wall, 6),
            "train_frac": round(train_frac, 6),
            "lost_frac": round(lost_frac, 6),
            "causes": causes,
            "unattributed_frac": causes[self.UNATTRIBUTED]["frac"],
            "attributed_frac": round(
                explained / lost_frac if lost_frac > 1e-9 else 1.0, 6
            ),
            "nodes": n,
        }

    def phase_breakdown(self, as_fractions: bool = False) -> Dict[str, float]:
        with self._lock:
            totals = {
                phase: sum(nodes.values())
                for phase, nodes in self._phase_secs.items()
            }
        if not as_fractions:
            return totals
        grand = sum(totals.values())
        if grand <= 0:
            return {phase: 0.0 for phase in totals}
        return {phase: secs / grand for phase, secs in totals.items()}

    def buffer_stats(self) -> Dict:
        """§32 bounded-buffer accounting for /api/control_plane: the
        phase-record ring's occupancy + drops without copying the
        records themselves (phase_records() copies; this is the cheap
        saturation view)."""
        with self._lock:
            return {
                "occupancy": len(self._phase_records),
                "capacity": self._phase_records.maxlen,
                "drops": self._phase_records_dropped,
                "ranks_tracked": len(self._rank_step_ewma),
            }

    def phase_records(self) -> Dict:
        """The raw goodput ledger for the timeline merger: the recorded
        (node, phase, start, end) intervals plus the accounting origin,
        so ``trace_merge.reconstruct_goodput`` can reproduce
        :meth:`goodput` exactly — as long as ``records_dropped`` is 0;
        past the ring bound the reconstruction is partial and the merge
        tool downgrades its goodput cross-check to a warning."""
        with self._lock:
            return {
                "init_time": self._init_time,
                "max_phase_end": self._max_phase_end,
                "records_dropped": self._phase_records_dropped,
                "records": [dict(r) for r in self._phase_records],
            }

    def reset(self):
        with self._lock:
            self._global_step = 0
            self._last_step_report = None
            self._speed_records.clear()
            self._phase_secs.clear()
            self._cause_secs.clear()
            self._phase_records.clear()
            self._phase_records_dropped = 0
            self._init_time = time.time()
            self._max_phase_end = 0.0
            self._rank_step_ewma.clear()
            self._rank_step_reports.clear()
            self._median_est = 0.0
            self._median_delta = 0.0
            self._reports_since_sync = 0
