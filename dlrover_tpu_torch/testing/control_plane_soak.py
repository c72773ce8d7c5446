"""Control-plane saturation harness: 1k sim workers vs one master (§32).

The paper's headline — goodput on *thousands* of GPUs — rests on a
master whose own limits this repo had never measured. This harness
turns "max sustainable world size" into a tracked bench number by
driving hundreds to thousands of **lightweight in-process worker
clients** (the ``sim_cluster``/``soak_worker`` pattern: an in-process
master served over the real HTTP transport, real :class:`MasterClient`
verbs on the wire) through three phases:

1. **Ramp** — closed-loop concurrency doubling over a production-mix
   verb schedule (lease fetch + batched done-reports + step/goodput
   telemetry + KV + resource stats + span pushes). Each stage reports
   achieved RPCs/s and client-side p99; the knee — p99 through the
   ceiling or throughput gains flattening — defines
   ``max_sustainable_rps``. Master CPU per 1k RPCs comes from the §32
   ``master_rpc_cpu_seconds_total`` thread-CPU counter, so the number
   is master-side even though the clients share the process.
2. **Quorum** — rendezvous time-to-quorum at world sizes
   {8, 64, 256, 1024}: a fresh rendezvous per world, every rank joined
   over the wire, wall time from first join to the full world forming.
3. **Shed** — the overload governor's watermarks are dropped so load
   shedding engages deterministically, then lease + rendezvous +
   diagnostic traffic runs concurrently.

Invariants (raise :class:`ControlPlaneInvariantError`):

- **Shed ordering law** — diagnostic classes were shed (counted), and
  ZERO task-lease / rendezvous / any-other-critical verb was ever
  dropped: ``master_rpc_dropped_total`` is 0 for every verb outside
  the diagnostic/telemetry classes, and lease responses stayed
  well-formed throughout the shed window.
- **Buffer accounting** — every bounded buffer on
  ``/api/control_plane`` reports ``occupancy`` and ``drops``.
- **Metric/span agreement** — for every verb where the per-verb
  histogram and the ``master.<verb>`` server spans saw the same
  population, mean latencies agree within 15% (both are supposed to
  measure the SAME dispatch window; drift means one of them lies).

The port's copy of ``dlrover_tpu/testing/control_plane_soak.py``.
"""

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.elastic_training.kv_store import KVStoreService
from dlrover_tpu_torch.master.elastic_training.rdzv_manager import (
    ElasticTrainingRendezvousManager,
)
from dlrover_tpu_torch.master.elastic_training.sync_service import SyncService
from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor
from dlrover_tpu_torch.master.overload import (
    DIAGNOSTIC_VERBS,
    TELEMETRY_VERBS,
    OverloadGovernor,
)
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.rpc.transport import HttpMasterServer


class ControlPlaneInvariantError(AssertionError):
    pass


@dataclass
class ControlPlaneSoakConfig:
    workers: int = 64              # logical worker clients (node ids)
    driver_threads: int = 8        # OS threads multiplexing them
    stage_duration_s: float = 1.0  # per ramp stage
    max_stages: int = 5            # concurrency 1,2,4,... x driver_threads
    knee_p99_s: float = 0.10       # p99 past this = saturated
    knee_gain_frac: float = 0.05   # <5% RPS gain = flat = saturated
    quorum_worlds: Tuple[int, ...] = (8, 64)
    shed_duration_s: float = 0.8
    dataset_size: int = 1 << 16
    shard_size: int = 4
    num_epochs: int = 1 << 16      # todo refills for the whole run
    agree_tolerance: float = 0.15
    agree_min_count: int = 50
    lease_batch: int = 2


@dataclass
class _SpanAgg:
    """on_finish aggregation of ``master.<verb>`` server spans — an
    O(1) fold per span so a 100k-RPC run costs no memory."""

    lock: threading.Lock = field(default_factory=threading.Lock)
    count: Dict[str, int] = field(default_factory=dict)
    total_s: Dict[str, float] = field(default_factory=dict)

    def __call__(self, record: Dict):
        name = record.get("name", "")
        if not name.startswith("master.") or record.get("dur_s") is None:
            return
        verb = name[len("master."):]
        with self.lock:
            self.count[verb] = self.count.get(verb, 0) + 1
            self.total_s[verb] = (
                self.total_s.get(verb, 0.0) + record["dur_s"]
            )

    def means(self) -> Dict[str, Tuple[int, float]]:
        with self.lock:
            return {
                verb: (n, self.total_s[verb] / n)
                for verb, n in self.count.items()
                if n > 0
            }


def _seconds_snapshot(seconds) -> Dict[str, Tuple[float, float]]:
    """{verb: (count, sum)} of the global master_rpc_seconds family at
    a point in time — the agreement check's subtraction baseline."""
    out: Dict[str, List[float]] = {}
    for name, labels, value in seconds.samples():
        verb = labels.get("verb")
        if verb is None:
            continue
        entry = out.setdefault(verb, [0.0, 0.0])
        if name.endswith("_count"):
            entry[0] = value
        elif name.endswith("_sum"):
            entry[1] = value
    return {verb: (c, s) for verb, (c, s) in out.items()}


class SimMaster:
    """In-process master over the real HTTP transport (the soak
    pattern), with the §32 governor injected so the harness can move
    its watermarks."""

    def __init__(self, cfg: ControlPlaneSoakConfig):
        self.cfg = cfg
        # Pure construction first — nothing below this block mutates
        # process-global state, so a failure here leaks nothing.
        self.perf_monitor = PerfMonitor()
        self.task_manager = TaskManager(
            task_timeout=3600.0, perf_monitor=self.perf_monitor
        )
        self.rdzv_managers = {
            RendezvousName.TRAINING: ElasticTrainingRendezvousManager(),
        }
        self.kv_store = KVStoreService()
        self.sync_service = SyncService()
        self.trace_aggregator = tracing.TraceAggregator()
        self.governor = OverloadGovernor()
        self.servicer = MasterServicer(
            rdzv_managers=self.rdzv_managers,
            task_manager=self.task_manager,
            perf_monitor=self.perf_monitor,
            sync_service=self.sync_service,
            kv_store=self.kv_store,
            trace_aggregator=self.trace_aggregator,
            overload_governor=self.governor,
        )
        self.span_agg = _SpanAgg()
        # The metric families are process-global and cumulative;
        # snapshot this servicer's per-verb baseline so the
        # metric-vs-span agreement check compares DELTAS against the
        # per-run span aggregator (earlier phases/tests in the same
        # process would otherwise desynchronize the populations).
        self.seconds_baseline = _seconds_snapshot(
            self.servicer.telemetry.seconds
        )
        # Global mutations LAST, rolled back on any failure (the
        # fleet_soak bug class: a constructor that dies half-armed
        # poisons every later phase in the process).
        import logging

        self._prev_log_level = logger.level
        self._prev_tracer = tracing.active_tracer()
        self._server = None
        try:
            # 1024 joins x 4 worlds = thousands of INFO lines; the
            # harness is the one caller where per-join logging is pure
            # noise.
            logger.setLevel(logging.WARNING)
            self._tracer = tracing.arm(tracing.Tracer(service="cp-master"))
            self._tracer.set_on_finish(self.span_agg)
            self._server = HttpMasterServer(0, self.servicer)
            self._server.start()
            self.addr = f"localhost:{self._server.port}"
            self.task_manager.new_dataset(comm.DatasetShardParams(
                dataset_name="cp",
                dataset_size=cfg.dataset_size,
                shard_size=cfg.shard_size,
                num_epochs=cfg.num_epochs,
                task_type="training",
                storage_type="text",
                shuffle=False,
            ))
        except Exception:
            self.close()
            raise

    def fresh_rdzv(self, world: int) -> ElasticTrainingRendezvousManager:
        """A clean rendezvous per quorum measurement (the servicer sees
        the swap — it holds the same dict object)."""
        mgr = ElasticTrainingRendezvousManager()
        mgr.update_rdzv_params(
            min_nodes=world, max_nodes=world, waiting_timeout=1.0
        )
        self.rdzv_managers[RendezvousName.TRAINING] = mgr
        return mgr

    def close(self):
        try:
            if self._server is not None:
                self._server.stop()
        finally:
            self.task_manager.stop()
            if self._prev_tracer is not None:
                tracing.arm(self._prev_tracer)
            else:
                tracing.disarm()
            logger.setLevel(self._prev_log_level)


class _SimWorkerPool:
    """``workers`` logical clients multiplexed over
    ``driver_threads`` OS threads. Each thread owns ONE keep-alive
    HTTP stub (one TCP connection) and stamps the logical worker's
    node id onto the envelope per call — 1024 workers cost 8-32
    connections, not 1024 server threads."""

    def __init__(self, addr: str, cfg: ControlPlaneSoakConfig):
        from dlrover_tpu_torch.agent.master_client import MasterClient

        self.cfg = cfg
        self._clients = [
            MasterClient(addr, node_id=0, kind="http", timeout=30.0)
            for _ in range(cfg.driver_threads)
        ]
        # thread index -> disjoint slice of logical worker ids.
        per = max(cfg.workers // cfg.driver_threads, 1)
        self._slices = [
            list(range(i * per, min((i + 1) * per, cfg.workers)))
            or [i % max(cfg.workers, 1)]
            for i in range(cfg.driver_threads)
        ]

    def close(self):
        for c in self._clients:
            c.close()

    # ---- the production verb mix ------------------------------------------

    def _one_cycle(self, client, worker_id: int, seq: int,
                   lat: List[float], errors: List[str],
                   lease_ok: List[int]):
        """One mixed-verb burst for one logical worker: lease fetch +
        done report + telemetry + kv + diagnostics, deterministic mix
        by sequence number."""
        client._node_id = worker_id  # noqa: SLF001 — same-thread stamp
        t0 = time.monotonic()
        try:
            mix = seq % 8
            if mix <= 2:
                tasks, _wait = client.get_tasks(
                    "cp", count=self.cfg.lease_batch
                )
                lease_ok.append(1)
                done = [t.task_id for t in tasks if t.task_id >= 0]
                if done:
                    lat.append(time.monotonic() - t0)
                    t0 = time.monotonic()
                    client.report_tasks_done_batch("cp", done)
                    lease_ok.append(1)
            elif mix == 3:
                client.report_global_step(
                    step=seq, elapsed_train_secs=0.01,
                    step_time_s=0.01,
                )
            elif mix == 4:
                client.kv_store_set(
                    f"cp/{worker_id}", str(seq).encode()
                )
            elif mix == 5:
                client.kv_store_get(f"cp/{worker_id}")
            elif mix == 6:
                client.report_used_resource(50.0, 1024.0)
            else:
                client.report_diagnosis_data(
                    "trace_spans", {"spans": []}
                )
            lat.append(time.monotonic() - t0)
        except Exception as e:  # noqa: BLE001 — count, keep driving
            errors.append(f"{type(e).__name__}: {e}"[:120])

    def drive(self, duration_s: float, threads: Optional[int] = None):
        """Closed-loop load for ``duration_s`` from ``threads`` driver
        threads (default: all). Returns (rpc_latencies, errors,
        lease_ok_count, wall_s)."""
        n = min(threads or len(self._clients), len(self._clients))
        stop_at = time.monotonic() + duration_s
        lats: List[List[float]] = [[] for _ in range(n)]
        errs: List[List[str]] = [[] for _ in range(n)]
        leases: List[List[int]] = [[] for _ in range(n)]

        def loop(i: int):
            client = self._clients[i]
            my_workers = self._slices[i]
            seq = 0
            while time.monotonic() < stop_at:
                worker = my_workers[seq % len(my_workers)]
                self._one_cycle(
                    client, worker, seq, lats[i], errs[i], leases[i]
                )
                seq += 1

        t_start = time.monotonic()
        ts = [
            threading.Thread(target=loop, args=(i,), daemon=True)
            for i in range(n)
        ]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.monotonic() - t_start
        flat = [x for part in lats for x in part]
        flat_err = [x for part in errs for x in part]
        lease_count = sum(len(part) for part in leases)
        return flat, flat_err, lease_count, wall


def _percentile(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(int(q * len(ordered)), len(ordered) - 1)
    return ordered[idx]


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def _ramp_phase(master: SimMaster, pool: _SimWorkerPool,
                cfg: ControlPlaneSoakConfig) -> Dict:
    """Concurrency-doubling closed loop; the knee defines max
    sustainable RPCs/s."""
    tm = master.servicer.telemetry
    stages = []
    best_rps = 0.0
    prev_rps = 0.0
    concurrency = 1
    for _stage in range(cfg.max_stages):
        n_threads = min(concurrency, cfg.driver_threads)
        rpcs_before = tm.rpcs_total()
        cpu_before = tm.cpu_seconds_total()
        lat, errors, _leases, wall = pool.drive(
            cfg.stage_duration_s, threads=n_threads
        )
        rpcs = tm.rpcs_total() - rpcs_before
        cpu = tm.cpu_seconds_total() - cpu_before
        rps = rpcs / max(wall, 1e-9)
        p99 = _percentile(lat, 0.99)
        stage = {
            "threads": n_threads,
            "rpcs": rpcs,
            "rps": round(rps, 1),
            "client_p50_s": round(_percentile(lat, 0.5), 6),
            "client_p99_s": round(p99, 6),
            "errors": len(errors),
            "cpu_s_per_1k_rpcs": round(cpu / max(rpcs / 1000.0, 1e-9), 4),
        }
        stages.append(stage)
        saturated = p99 > cfg.knee_p99_s or (
            prev_rps > 0
            and rps < prev_rps * (1.0 + cfg.knee_gain_frac)
        )
        if p99 <= cfg.knee_p99_s:
            best_rps = max(best_rps, rps)
        prev_rps = rps
        if saturated or n_threads >= cfg.driver_threads:
            break
        concurrency *= 2
    if best_rps <= 0 and stages:
        # Every stage was past the p99 knee (slow shared box): the
        # best achieved closed-loop throughput is still the honest
        # capacity number — 0 would read as a broken master.
        best_rps = max(s["rps"] for s in stages)
    total_rpcs = tm.rpcs_total()
    total_cpu = tm.cpu_seconds_total()
    return {
        "stages": stages,
        "max_sustainable_rps": round(best_rps, 1),
        "cpu_s_per_1k_rpcs": round(
            total_cpu / max(total_rpcs / 1000.0, 1e-9), 4
        ),
        "inflight_high_water": tm.high_water(),
    }


def _quorum_phase(master: SimMaster, pool: _SimWorkerPool,
                  cfg: ControlPlaneSoakConfig) -> Dict:
    """Time-to-quorum per world size: every rank joins over the wire,
    then one ``get_comm_world`` completes the round."""
    out = {}
    for world in cfg.quorum_worlds:
        mgr = master.fresh_rdzv(world)
        clients = pool._clients  # noqa: SLF001 — same harness
        n = len(clients)
        quorum_hist = mgr._metrics["quorum"]  # noqa: SLF001
        sum_before = quorum_hist.sum(rdzv=RendezvousName.TRAINING)
        t0 = time.monotonic()

        def join_range(i: int):
            client = clients[i]
            for rank in range(i, world, n):  # noqa: B023 — joined below
                client._node_id = rank  # noqa: SLF001
                client.join_rendezvous(
                    rank, 1, RendezvousName.TRAINING
                )

        ts = [
            threading.Thread(target=join_range, args=(i,), daemon=True)
            for i in range(n)
        ]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        # One get completes the round (the manager forms the world on
        # query once all ranks wait) — poll bounded for robustness.
        formed = {}
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            clients[0]._node_id = 0  # noqa: SLF001
            _round, _group, formed, _order, _groups = (
                clients[0].get_comm_world(RendezvousName.TRAINING, 0)
            )
            if len(formed) >= world:
                break
            time.sleep(0.01)
        wall = time.monotonic() - t0
        if len(formed) != world:
            raise ControlPlaneInvariantError(
                f"world {world}: quorum never formed "
                f"({len(formed)}/{world})"
            )
        # The family is registry-global and cumulative across rounds;
        # ONE round landed for this world, so the sum delta is its
        # exact server-side first-join -> completion time.
        server_s = (
            quorum_hist.sum(rdzv=RendezvousName.TRAINING) - sum_before
        )
        out[str(world)] = {
            "time_to_quorum_s": round(server_s, 4),
            "wall_with_client_s": round(wall, 4),
        }
        logger.info(
            "control_plane quorum world=%d: server %.3fs wall %.3fs",
            world, server_s, wall,
        )
    return out


def _shed_phase(master: SimMaster, pool: _SimWorkerPool,
                cfg: ControlPlaneSoakConfig) -> Dict:
    """Force the governor into shedding and drive lease + rendezvous +
    diagnostic traffic concurrently; the ordering law is asserted by
    ``_check_shed_correctness`` afterwards."""
    state_before = master.servicer.control_plane_state()
    shed_before = dict(state_before["overload"]["shed_total"])
    prev_latency_high = state_before["overload"]["latency_high_s"]
    # Watermark at zero latency: the very next observe() escalates to
    # level 2 (load factor = ewma/1e-9 >> level2_factor), so both
    # diagnostic AND telemetry classes shed while every critical verb
    # keeps flowing — the deterministic worst case.
    master.governor.set_thresholds(latency_high_s=1e-9)
    try:
        _lat, errors, lease_count, _wall = pool.drive(
            cfg.shed_duration_s
        )
    finally:
        master.governor.set_thresholds(
            latency_high_s=prev_latency_high
        )
    state = master.servicer.control_plane_state()
    shed_after = state["overload"]["shed_total"]
    return {
        "level_reached": state["overload"]["level"],
        "shed_diagnostic": (
            shed_after["diagnostic"] - shed_before["diagnostic"]
        ),
        "shed_telemetry": (
            shed_after["telemetry"] - shed_before["telemetry"]
        ),
        "lease_rpcs_during_shed": lease_count,
        "client_errors": len(errors),
    }


# ---------------------------------------------------------------------------
# Invariants
# ---------------------------------------------------------------------------


def _check_shed_correctness(master: SimMaster, shed_report: Dict):
    if shed_report["shed_diagnostic"] <= 0:
        raise ControlPlaneInvariantError(
            "shed stage shed zero diagnostic RPCs — governor never "
            "engaged"
        )
    if shed_report["lease_rpcs_during_shed"] <= 0:
        raise ControlPlaneInvariantError(
            "no lease RPCs completed during the shed window"
        )
    if shed_report["client_errors"] > 0:
        raise ControlPlaneInvariantError(
            f"{shed_report['client_errors']} client errors during "
            "shed — critical verbs must keep succeeding"
        )
    sheddable = DIAGNOSTIC_VERBS | TELEMETRY_VERBS
    dropped = master.servicer.telemetry.dropped
    for _name, labels, value in dropped.samples():
        verb = labels.get("verb", "")
        if value > 0 and verb not in sheddable:
            raise ControlPlaneInvariantError(
                f"critical verb {verb!r} was shed {value:.0f}x — "
                "the ordering law (diagnostics before data, data "
                "never before leases) is broken"
            )


def _check_buffers(master: SimMaster) -> Dict:
    buffers = master.servicer.control_plane_state()["buffers"]
    if not buffers:
        raise ControlPlaneInvariantError("no bounded buffers reported")
    for name, stats in buffers.items():
        if "occupancy" not in stats or "drops" not in stats:
            raise ControlPlaneInvariantError(
                f"buffer {name!r} does not report occupancy + drops: "
                f"{sorted(stats)}"
            )
    return {
        name: {"occupancy": s["occupancy"], "drops": s["drops"]}
        for name, s in buffers.items()
    }


def _check_metric_span_agreement(
    master: SimMaster, cfg: ControlPlaneSoakConfig
) -> Dict:
    """Per-verb mean latency: histogram vs ``master.<verb>`` server
    spans, same run. The metric family is process-global, so counts
    and sums are DELTAS against the baseline snapshotted at SimMaster
    construction; only verbs whose populations then match the per-run
    span aggregator are comparable (a handler error is counted by
    both; a no-handler request opens no span). Server spans finish on
    the tracer's finisher thread: flush them first."""
    tracing.flush()
    span_means = master.span_agg.means()
    seconds = master.servicer.telemetry.seconds
    checked = {}
    worst = 0.0
    for verb, (span_n, span_mean) in span_means.items():
        base_n, base_sum = master.seconds_baseline.get(verb, (0.0, 0.0))
        metric_n = int(seconds.count(verb=verb) - base_n)
        if metric_n != span_n or metric_n < cfg.agree_min_count:
            continue
        metric_mean = (seconds.sum(verb=verb) - base_sum) / metric_n
        rel = abs(metric_mean - span_mean) / max(span_mean, 1e-12)
        worst = max(worst, rel)
        checked[verb] = {
            "count": metric_n,
            "metric_mean_s": round(metric_mean, 7),
            "span_mean_s": round(span_mean, 7),
            "rel_diff": round(rel, 4),
        }
        if rel > cfg.agree_tolerance:
            raise ControlPlaneInvariantError(
                f"verb {verb}: metric mean {metric_mean:.6f}s vs span "
                f"mean {span_mean:.6f}s differ {rel:.1%} "
                f"(> {cfg.agree_tolerance:.0%})"
            )
    if not checked:
        raise ControlPlaneInvariantError(
            "metric/span agreement had nothing to compare — tracing "
            "was not armed or every verb was below the count floor"
        )
    return {"verbs_checked": len(checked), "worst_rel_diff":
            round(worst, 4), "detail": checked}


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def run_control_plane_soak(
    cfg: Optional[ControlPlaneSoakConfig] = None,
) -> Dict:
    cfg = cfg or ControlPlaneSoakConfig()
    master = SimMaster(cfg)
    pool = None
    t0 = time.monotonic()
    try:
        # Inside the try: SimMaster already armed a global tracer and
        # muted the logger — a pool-construction failure must not leak
        # them into the rest of the process (the fleet_soak bug class).
        pool = _SimWorkerPool(master.addr, cfg)
        ramp = _ramp_phase(master, pool, cfg)
        quorum = _quorum_phase(master, pool, cfg)
        shed = _shed_phase(master, pool, cfg)

        _check_shed_correctness(master, shed)
        buffers = _check_buffers(master)
        agreement = _check_metric_span_agreement(master, cfg)

        state = master.servicer.control_plane_state()
        report = {
            "workers": cfg.workers,
            "driver_threads": cfg.driver_threads,
            "max_sustainable_rps": ramp["max_sustainable_rps"],
            "cpu_s_per_1k_rpcs": ramp["cpu_s_per_1k_rpcs"],
            "inflight_high_water": ramp["inflight_high_water"],
            "stages": ramp["stages"],
            "quorum": quorum,
            "shed": shed,
            "buffers": buffers,
            "metric_span_agreement": agreement,
            "rpcs_total": state["rpc"]["rpcs_total"],
            "dispatch_p99_s": (
                state["buffers"]
                .get("task_queues", {})
                .get("dispatch_p99_s")
            ),
            "elapsed_s": round(time.monotonic() - t0, 2),
            "invariants": "pass",
        }
        return report
    finally:
        if pool is not None:
            pool.close()
        master.close()
