"""Standalone (single-host) job master.

Parity: reference dlrover/python/master/local_master.py:41 (LocalJobMaster)
— spawned by the run CLI in standalone mode so the full master protocol
(rendezvous, KV store, data sharding, diagnosis) is available without a
cluster.

The port's copy of ``dlrover_tpu/master/local_master.py``. It builds
what the reference's builds by default, the rescale coordinator
included, and serves over HTTP by default. A batch config restricts the
rendezvous and the rescale plans to the worlds it can train at
(``wire_batch_legality``, dp = nodes x ``devices_per_node``). With
``journal_path`` or ``DLROVER_TPU_MASTER_JOURNAL`` set it keeps the
durable journal (``master/journal.py``): it rehydrates the kv, sync,
task, rendezvous, rescale and job state from the journal before the
servicer exists, journals every plan cut, and closes the journal with a
clean-shutdown record on stop. With ``autoscale_loop`` it runs the
closed-loop autoscaler (``autoscaler/``) over the perf, data, fleet,
fault, ckpt and control-plane signals: a straggler is evicted through
the rescale coordinator, the checkpoint cadence is retuned, and world
resizes stay advisory (the local master has no cluster scaler).
"""

import threading
import time

from dlrover_tpu_torch.common.constants import JobConstant
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.elastic_training.rdzv_manager import (
    create_rdzv_managers,
)
from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor
from dlrover_tpu_torch.master.node.job_context import get_job_context
from dlrover_tpu_torch.master.node.local_job_manager import LocalJobManager
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from dlrover_tpu_torch.rpc.transport import create_master_server


class LocalJobMaster:
    def __init__(
        self,
        port: int = 0,
        job_name: str = "local-job",
        node_num: int = 1,
        max_relaunch_count: int = 3,
        transport: str = "http",
        batch_config=None,
        devices_per_node: int = 1,
        autoscale_loop: bool = False,
        autoscale_dry_run: bool = False,
        autoscale_interval_s: float = 5.0,
        autoscale_record: str = "",
        journal_path: str = "",
    ):
        self.job_name = job_name
        self._job_context = get_job_context()
        self.job_manager = LocalJobManager(job_name, max_relaunch_count)
        self.rdzv_managers = create_rdzv_managers()
        self.perf_monitor = PerfMonitor()
        self.task_manager = TaskManager(perf_monitor=self.perf_monitor)
        self.diagnosis_master = self._build_diagnosis_master()
        from dlrover_tpu_torch.master.elastic_training.rescale_coordinator import (
            RescaleCoordinator,
            wire_batch_legality,
        )

        self.rescale_coordinator = RescaleCoordinator(
            bootstrap_min=node_num
        )
        from dlrover_tpu_torch.master.elastic_training.kv_store import (
            KVStoreService,
        )
        from dlrover_tpu_torch.master.elastic_training.sync_service import (
            SyncService,
        )

        # Durable control-plane journal (DESIGN.md §37). Restore order
        # matters: kv/sync/task state is rehydrated BEFORE the servicer
        # is constructed so its replica-token seed check sees the
        # restored token instead of journaling a fresh (wrong) one.
        from dlrover_tpu_torch.master.journal import (
            MasterJournal,
            journal_path_from_env,
            restore_master_state,
        )

        self.kv_store = KVStoreService()
        self.sync_service = SyncService()
        self.journal = None
        jpath = journal_path or journal_path_from_env()
        if jpath:
            self.journal = MasterJournal(jpath)
            restore_master_state(
                self.journal.recovered,
                task_manager=self.task_manager,
                kv_store=self.kv_store,
                rescale_coordinator=self.rescale_coordinator,
                sync_service=self.sync_service,
                rdzv_managers=self.rdzv_managers,
                job_manager=self.job_manager,
            )
            # Plan cuts are journaled as they happen so a restarted
            # master never re-issues a stale plan_id.
            self.rescale_coordinator.on_plan_cut = (
                lambda plan: self.journal.append(
                    "plan_cut", plan_id=plan.plan_id
                )
            )
        if batch_config is not None:
            # Rendezvous and rescale plans only form worlds the trainer's
            # batch config can actually train at (global_batch divisible
            # by micro * dp) — a 3-of-4-survivors world must be truncated,
            # not crash grad_accum_for().
            # Legality must use the REAL dp = nodes * devices_per_node;
            # defaulting to 1 here would admit worlds whose actual dp
            # fails grad_accum_for() on arrival.
            wire_batch_legality(
                self.rdzv_managers,
                self.rescale_coordinator,
                batch_config,
                local_world_size=devices_per_node,
            )
        from dlrover_tpu_torch.observability import tracing as tracing_lib

        self.trace_aggregator = tracing_lib.TraceAggregator()
        _tracer = (
            tracing_lib.active_tracer()
            or tracing_lib.arm_from_env(service="master")
        )
        if _tracer is not None:
            # Master's own server spans feed /api/traces directly.
            _tracer.set_on_finish(self.trace_aggregator.ingest_one)
        self.servicer = MasterServicer(
            rdzv_managers=self.rdzv_managers,
            task_manager=self.task_manager,
            job_manager=self.job_manager,
            diagnosis_master=self.diagnosis_master,
            perf_monitor=self.perf_monitor,
            sync_service=self.sync_service,
            kv_store=self.kv_store,
            rescale_coordinator=self.rescale_coordinator,
            trace_aggregator=self.trace_aggregator,
            journal=self.journal,
        )
        self._server = create_master_server(port, self.servicer, transport)
        if self.journal is not None and hasattr(
            self._server, "add_shutdown_hook"
        ):
            self._server.add_shutdown_hook(self.journal.close)
        self.port = self._server.port
        self._node_num = node_num
        self._stopped = threading.Event()
        # §30 autoscaler, standalone flavor: full signal plane
        # (straggler scores, shard queues, fleet load, fault history)
        # + the rescale coordinator's eviction actuation. The local
        # master has no cluster scaler, so world-resize decisions stay
        # advisory — visible in the ledger and metrics, acted on by
        # the operator.
        self.autoscaler = None
        self.fault_history = None
        self.ckpt_cadence = None
        if autoscale_loop:
            from dlrover_tpu_torch.autoscaler import (
                AutoScaler,
                CadenceController,
                EVICT_STRAGGLER,
                FaultHistory,
                SET_CKPT_INTERVAL,
                SignalBus,
                SignalRecorder,
                control_plane_source,
                data_source,
                fault_source,
                fleet_source,
                perf_source,
            )

            self.fault_history = FaultHistory()
            # The cadence knob: the "ckpt" source makes the Young/Daly
            # rule live once an MTBF is observed; a standalone trainer
            # polls master.ckpt_cadence.interval_s() (or the gauge).
            self.ckpt_cadence = CadenceController(60.0)
            bus = (
                SignalBus()
                .add_source("perf", perf_source(self.perf_monitor))
                .add_source("data", data_source(self.task_manager))
                .add_source("fleet", fleet_source())
                .add_source("fault", fault_source(self.fault_history))
                .add_source("ckpt", self.ckpt_cadence.as_source())
                # §32 master saturation signal.
                .add_source("control_plane", control_plane_source(
                    self.servicer.control_plane_state
                ))
            )

            def evict(decision):
                rank = int(decision.target)
                if not self.rescale_coordinator.evict_worker(rank):
                    raise ValueError(
                        f"rank {decision.target} not in the live set"
                    )
                # Fresh EWMA for the seat's next occupant.
                self.perf_monitor.reset_rank(rank)

            self.autoscaler = AutoScaler(
                bus,
                actuators={
                    EVICT_STRAGGLER: evict,
                    SET_CKPT_INTERVAL: self.ckpt_cadence.apply,
                },
                interval_s=autoscale_interval_s,
                dry_run=autoscale_dry_run,
                job_name=job_name,
                # §34: durable signal/decision/outcome recording for
                # offline what-if replay (env arming still applies when
                # the flag is unset — AutoScaler falls back to it).
                recorder=(
                    SignalRecorder(autoscale_record)
                    if autoscale_record else None
                ),
            )

    def _build_diagnosis_master(self):
        from dlrover_tpu_torch.diagnosis.diagnosis_manager import DiagnosisManager
        from dlrover_tpu_torch.diagnosis.diagnosticians.training_hang import (
            TrainingHangDiagnostician,
        )
        from dlrover_tpu_torch.master.diagnosis.diagnosis_master import (
            DiagnosisMaster,
        )

        from dlrover_tpu_torch.diagnosis.diagnosticians.node_failure import (
            NodeFailureDiagnostician,
        )

        manager = DiagnosisManager()
        dm = DiagnosisMaster(manager=manager)
        from dlrover_tpu_torch.diagnosis.diagnosis_data import DiagnosisDataType

        manager.register(TrainingHangDiagnostician(
            self.perf_monitor,
            # Late-bound: workers' relayed stack dumps let the hang
            # escalation name the blocked frame.
            stack_dump_provider=lambda: dm.recent_data(
                DiagnosisDataType.STACK_DUMP
            ),
        ))
        manager.register(NodeFailureDiagnostician())
        return dm

    def prepare(self):
        for mgr in self.rdzv_managers.values():
            mgr.update_rdzv_params(
                min_nodes=self._node_num,
                max_nodes=self._node_num,
                waiting_timeout=5.0,
            )
        self._server.start()
        self.job_manager.start()
        self.task_manager.start()
        if self.autoscaler is not None:
            self.autoscaler.start()
        self.diagnosis_master.start_observing()
        logger.info(
            "local master [%s] serving on port %d", self.job_name, self.port
        )

    def run(self) -> int:
        """Supervision loop; returns exit code."""
        try:
            while not self._stopped.is_set():
                time.sleep(JobConstant.MASTER_RUN_LOOP_INTERVAL)
                if self.job_manager.all_workers_exited():
                    if self.job_manager.all_workers_succeeded():
                        logger.info("all workers succeeded; master exiting")
                        return 0
                    logger.error("workers failed; master exiting")
                    return 1
                rc = self._execute_master_actions()
                if rc is not None:
                    return rc
            return 0
        finally:
            self.stop()

    def _execute_master_actions(self):
        """Consume job-level diagnosis actions (hang -> restart/abort),
        mirroring DistributedJobMaster._diagnose_loop for standalone."""
        from dlrover_tpu_torch.common.constants import DiagnosisActionType

        while True:
            action = self._job_context.next_master_action()
            if action is None:
                return None
            if action.action_type == DiagnosisActionType.JOB_RESTART:
                logger.warning(
                    "diagnosis: restarting workers (%s)", action.reason
                )
                self.job_manager.restart_worker_processes(action.reason)
            elif action.action_type == DiagnosisActionType.JOB_ABORT:
                logger.error("diagnosis: aborting job (%s)", action.reason)
                return 1

    def stop(self):
        self._stopped.set()
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.diagnosis_master.stop_observing()
        self.task_manager.stop()
        self.job_manager.stop()
        # Prefer the draining stop: finish in-flight RPCs, run shutdown
        # hooks (journal flush+fsync+close record), sever keep-alives.
        graceful = getattr(self._server, "graceful_stop", None)
        if graceful is not None:
            graceful()
        else:
            self._server.stop()
        if self.journal is not None and not self.journal.closed:
            self.journal.close()

    def request_stop(self):
        self._stopped.set()
