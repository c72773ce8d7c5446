"""Distributed job master: one per job, owns all managers.

Parity: reference dlrover/python/master/dist_master.py:101-457
(DistributedJobMaster.prepare/run/pre_check) — the supervision loop ticks
every few seconds checking: workers all exited, training hang, pending
timeout; a parallel diagnose thread executes job-level DiagnosisActions
(JobRestartAction/JobAbortionAction/NodeAction, reference :236-263).

The port's copy of ``dlrover_tpu/master/dist_master.py``. Three things
it reaches only behind a flag are not ported (ROADMAP §A item 8b), and
each raises ``NotImplementedError`` before the master binds its port:
the dashboard (``dashboard_port >= 0``), the brain service's client
(``brain_addr``) and the pod scaler and watcher of the ``k8s`` and
``gke_tpu`` platforms (the reference's ``SystemExit`` for a missing
kubernetes client becomes that error too).
"""

import threading
import time
from typing import Optional

from dlrover_tpu_torch.common.constants import (
    DiagnosisActionType,
    JobConstant,
    JobExitReason,
    NodeType,
    RendezvousName,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource
from dlrover_tpu_torch.master.elastic_training.rdzv_manager import (
    create_rdzv_managers,
)
from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor
from dlrover_tpu_torch.master.node.dist_job_manager import DistributedJobManager
from dlrover_tpu_torch.master.node.event_callback import (
    AllReduceNodeHandlingCallback,
    TaskRescheduleCallback,
)
from dlrover_tpu_torch.master.node.job_context import get_job_context
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from dlrover_tpu_torch.rpc.transport import create_master_server


def _parse_metric_endpoints(raw: str):
    """"0=host:port,1=host:port" -> {0: "host:port", ...} (CLI form of
    the metric monitor's endpoint map; programmatic callers pass a dict
    or a callable instead). Malformed input fails with a message that
    names the flag, not a bare traceback during master startup."""
    if not raw:
        return None
    out = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            node, addr = part.split("=", 1)
            out[int(node)] = addr
        except ValueError:
            raise SystemExit(
                f"--metric_endpoints: bad entry {part!r} "
                "(expected 'node_id=host:port,...')"
            )
    return out or None


def _not_ported(what: str, module: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs {module}, not ported yet: ROADMAP §A item 8b"
    )


class DistributedJobMaster:
    def __init__(
        self,
        port: int,
        job_name: str,
        node_num: int,
        scaler,
        watcher,
        max_relaunch_count: int = 3,
        transport: str = "grpc",
        node_resource: Optional[NodeResource] = None,
        diagnosis_master=None,
        heartbeat_timeout_s: float = 600.0,
        pending_timeout_s: float = 900.0,
        with_diagnosis: bool = True,
        pre_check: bool = False,
        auto_scale: bool = False,
        legal_worker_counts=None,
        dashboard_port: int = -1,
        global_batch_size: int = 0,
        micro_batch_per_device: int = 0,
        devices_per_node: int = 4,
        brain_addr: str = "",
        topology_aware: bool = False,
        node_group_size: int = 0,
        metric_endpoints=None,
        autoscale_loop: bool = False,
        autoscale_dry_run: bool = False,
        autoscale_interval_s: float = 5.0,
        autoscale_max_world: int = 0,
        autoscale_ckpt_interval_s: float = 60.0,
        autoscale_record: str = "",
        journal_path: str = "",
    ):
        if dashboard_port >= 0:
            raise _not_ported("the dashboard", "master/dashboard.py")
        if brain_addr:
            raise _not_ported("the brain service", "brain/client.py")
        self.job_name = job_name
        self._job_context = get_job_context()
        self.perf_monitor = PerfMonitor()
        self.task_manager = TaskManager(perf_monitor=self.perf_monitor)
        self.rdzv_managers = create_rdzv_managers()
        node_groups = {
            NodeType.WORKER: NodeGroupResource(
                count=node_num,
                node_resource=node_resource or NodeResource(),
            )
        }
        self.job_manager = DistributedJobManager(
            job_name=job_name,
            node_groups=node_groups,
            scaler=scaler,
            watcher=watcher,
            max_relaunch_count=max_relaunch_count,
            heartbeat_timeout_s=heartbeat_timeout_s,
            pending_timeout_s=pending_timeout_s,
            node_group_size=node_group_size,
        )
        self.job_manager.add_node_event_callback(
            AllReduceNodeHandlingCallback(self)
        )
        self.job_manager.add_node_event_callback(
            TaskRescheduleCallback(self.task_manager)
        )
        # Out-of-band cluster metric monitor (common/metric.py): scrape
        # the per-node tpu_timer daemons (or any Prometheus exporter)
        # into a windowed context the hang diagnostician corroborates
        # against. ``metric_endpoints``: {node_id: "host:port"} or a
        # zero-arg callable re-resolving them (elastic clusters).
        self.metric_monitor = None
        if metric_endpoints:
            from dlrover_tpu_torch.common.metric import JobMetricMonitor

            self.metric_monitor = JobMetricMonitor(metric_endpoints)
        if diagnosis_master is None and with_diagnosis:
            diagnosis_master = self._build_diagnosis_master(pre_check)
        self.diagnosis_master = diagnosis_master
        from dlrover_tpu_torch.master.hyperparams.simple_strategy_generator import (
            SimpleStrategyGenerator,
        )

        self.job_manager.set_strategy_generator(
            SimpleStrategyGenerator(
                self.job_manager,
                global_batch_size=global_batch_size,
                devices_per_node=devices_per_node,
            )
        )
        from dlrover_tpu_torch.master.elastic_training.rescale_coordinator import (
            RescaleCoordinator,
            wire_batch_legality,
        )

        self.rescale_coordinator = RescaleCoordinator(
            node_unit=max(node_group_size, 1),
            bootstrap_min=node_num,
        )
        if global_batch_size > 0 and micro_batch_per_device > 0:
            # Rendezvous and rescale plans only form worlds whose dp
            # size divides the global batch — otherwise a partial-
            # survivor world would crash grad_accum_for() on arrival.
            from dlrover_tpu_torch.trainer.elastic.trainer import (
                ElasticBatchConfig,
            )

            wire_batch_legality(
                self.rdzv_managers,
                self.rescale_coordinator,
                ElasticBatchConfig(
                    global_batch_size=global_batch_size,
                    micro_batch_per_device=micro_batch_per_device,
                ),
                local_world_size=devices_per_node,
            )
        # Recent trace trees (workers push span summaries over the
        # diagnosis-data verb; /api/traces serves them).
        from dlrover_tpu_torch.observability import tracing as tracing_lib

        self.trace_aggregator = tracing_lib.TraceAggregator()
        # Master-side spans (servicer server spans) reach /api/traces
        # too when the master traces — armed explicitly or via the
        # DLROVER_TPU_TRACE_FILE env rigging.
        _tracer = (
            tracing_lib.active_tracer()
            or tracing_lib.arm_from_env(service="master")
        )
        if _tracer is not None:
            _tracer.set_on_finish(self.trace_aggregator.ingest_one)
        # Durable control-plane journal (DESIGN.md §37). Rehydrate
        # BEFORE the servicer is built: the servicer's replica-token
        # seed check must see the restored token, not mint a new one.
        from dlrover_tpu_torch.master.elastic_training.kv_store import (
            KVStoreService,
        )
        from dlrover_tpu_torch.master.elastic_training.sync_service import (
            SyncService,
        )
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
            self.rescale_coordinator.on_plan_cut = (
                lambda plan: self.journal.append(
                    "plan_cut", plan_id=plan.plan_id
                )
            )
        self.servicer = MasterServicer(
            rdzv_managers=self.rdzv_managers,
            task_manager=self.task_manager,
            job_manager=self.job_manager,
            diagnosis_master=diagnosis_master,
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
        self.exit_reason = ""

        if topology_aware:
            from dlrover_tpu_torch.master.elastic_training.net_topology import (
                DpTopologySorter,
            )

            training_rdzv = self.rdzv_managers.get(RendezvousName.TRAINING)
            if training_rdzv is not None and hasattr(
                training_rdzv, "set_topology_sorter"
            ):
                training_rdzv.set_topology_sorter(DpTopologySorter())

        from dlrover_tpu_torch.master.stats.job_collector import JobMetricCollector

        self.metric_collector = JobMetricCollector(
            job_name, self.job_manager, self.perf_monitor
        )
        # §30 closed-loop autoscaler (self.autoscaler — distinct from
        # the legacy throughput-driven self.auto_scaler below): observe
        # the live signal plane, decide through deterministic rules,
        # actuate world changes via the proven execute_plan path +
        # rescale-coordinator evictions.
        self.autoscaler = None
        self.fault_history = None
        if (auto_scale and autoscale_loop and autoscale_max_world > 0):
            # Two independent world controllers issuing conflicting
            # targets would oscillate the rendezvous window; refuse the
            # combination instead of racing.
            raise ValueError(
                "--auto_scale and --autoscale_loop with "
                "--autoscale_max_world both drive the worker count; "
                "pick one world controller"
            )
        if autoscale_loop:
            self._build_autoscaler(
                scaler, autoscale_dry_run, autoscale_interval_s,
                brain_addr,
                max_world=autoscale_max_world,
                legal_worker_counts=legal_worker_counts,
                ckpt_interval_s=autoscale_ckpt_interval_s,
                record_path=autoscale_record,
            )
        self.dashboard = None
        self.auto_scaler = None
        if auto_scale:
            from dlrover_tpu_torch.master.node.job_auto_scaler import (
                AllreduceTrainingAutoScaler,
            )

            from dlrover_tpu_torch.master.resource.optimizer import (
                AllreduceLocalOptimizer,
            )

            optimizer = AllreduceLocalOptimizer(
                self.job_manager,
                self.perf_monitor,
                legal_counts=legal_worker_counts,
            )
            self.auto_scaler = AllreduceTrainingAutoScaler(
                self.job_manager,
                scaler,
                optimizer,
                rdzv_managers=self.rdzv_managers,
            )

    def _build_autoscaler(self, scaler, dry_run: bool, interval_s: float,
                          brain_addr: str, max_world: int = 0,
                          legal_worker_counts=None,
                          ckpt_interval_s: float = 60.0,
                          record_path: str = ""):
        from dlrover_tpu_torch.autoscaler import (
            AutoScaler,
            BrainPrior,
            CadenceController,
            EVICT_STRAGGLER,
            FaultHistory,
            GROW_WORLD,
            PolicyConfig,
            RulePolicy,
            SEED_WORLD,
            SET_CKPT_INTERVAL,
            SHRINK_WORLD,
            SignalBus,
            SignalRecorder,
            control_plane_source,
            data_source,
            fault_source,
            fleet_source,
            perf_source,
        )
        from dlrover_tpu_torch.master.node.event_callback import (
            NodeEventCallback,
        )
        from dlrover_tpu_torch.master.node.job_auto_scaler import (
            AllreduceTrainingAutoScaler,
        )
        from dlrover_tpu_torch.master.resource.optimizer import ResourcePlan

        self.fault_history = FaultHistory()
        history = self.fault_history

        class _FaultFeed(NodeEventCallback):
            """Node deaths feed the observed-MTBF tracker."""

            def on_node_started(self, node):
                pass

            def on_node_succeeded(self, node):
                pass

            def on_node_deleted(self, node):
                pass

            def on_node_failed(self, node):
                history.record_failure()

        self.job_manager.add_node_event_callback(_FaultFeed())
        # The cadence knob: SET_CKPT_INTERVAL actuates it, the "ckpt"
        # source feeds the policy the interval it is steering (without
        # the source the Young/Daly rule can never fire), and trainers
        # poll it as self.ckpt_cadence.interval_s().
        self.ckpt_cadence = CadenceController(ckpt_interval_s)
        bus = (
            SignalBus()
            .add_source("perf", perf_source(self.perf_monitor))
            .add_source("data", data_source(self.task_manager))
            .add_source("fleet", fleet_source())
            .add_source("fault", fault_source(history))
            .add_source("ckpt", self.ckpt_cadence.as_source())
            # §32: the master's own saturation — a policy can refuse
            # scale-up when the control plane, not the accelerators,
            # is the binding constraint.
            .add_source("control_plane", control_plane_source(
                self.servicer.control_plane_state
            ))
            .add_source("world", lambda: {
                "size": len(
                    self.job_manager.worker_manager.alive_nodes()
                ),
            })
        )
        # World moves are opt-in (max_world > 0 unpins the backlog
        # rules). With a legal-counts list the cap is clamped to the
        # largest legal shape AND every grow/shrink targets the next
        # legal count (policy._next_world) — the loop can never order
        # a world the rendezvous would refuse to form.
        if max_world > 0 and legal_worker_counts:
            legal_caps = [
                c for c in legal_worker_counts if c <= max_world
            ]
            max_world = max(legal_caps) if legal_caps else 0
        policy = RulePolicy(PolicyConfig(
            max_world=max_world,
            legal_world_counts=(
                list(legal_worker_counts) if legal_worker_counts
                else None
            ),
        ))
        # World moves reuse the proven execute_plan path (group resize
        # through the scaler + rendezvous window update); its optimizer
        # is never consulted — the §30 policy IS the optimizer here.
        executor = AllreduceTrainingAutoScaler(
            self.job_manager, scaler, optimizer=None,
            rdzv_managers=self.rdzv_managers,
        )

        def set_world(decision):
            plan = ResourcePlan(comment=decision.reason[:120])
            plan.node_group_resources[NodeType.WORKER] = (
                NodeGroupResource(count=int(decision.target))
            )
            executor.execute_plan(plan)

        def evict(decision):
            # The coordinator cuts the scale-down plan; the job
            # manager's normal relaunch machinery replaces the seat.
            rank = int(decision.target)
            if not self.rescale_coordinator.evict_worker(rank):
                raise ValueError(
                    f"rank {decision.target} not in the live set"
                )
            # The replacement must not inherit the evictee's slow
            # step-time EWMA (an evict loop on a healthy worker).
            self.perf_monitor.reset_rank(rank)

        self.autoscaler = AutoScaler(
            bus,
            policy=policy,
            actuators={
                EVICT_STRAGGLER: evict,
                GROW_WORLD: set_world,
                SHRINK_WORLD: set_world,
                SEED_WORLD: set_world,
                # The cadence lands on the controller; workers with no
                # push channel read the recommendation off the
                # autoscaler_ckpt_interval_s gauge + /api/autoscaler.
                SET_CKPT_INTERVAL: self.ckpt_cadence.apply,
            },
            interval_s=interval_s,
            dry_run=dry_run,
            brain_prior=(
                BrainPrior(brain_addr, self.job_name)
                if brain_addr else None
            ),
            job_name=self.job_name,
            # §34: durable signal/decision/outcome recording for
            # offline what-if replay; env arming still applies when
            # the flag is unset.
            recorder=(
                SignalRecorder(record_path) if record_path else None
            ),
        )

    def _build_diagnosis_master(self, pre_check: bool):
        from dlrover_tpu_torch.diagnosis.diagnosis_manager import DiagnosisManager
        from dlrover_tpu_torch.diagnosis.diagnosticians.node_failure import (
            NodeFailureDiagnostician,
            NodeInconsistencyDiagnostician,
        )
        from dlrover_tpu_torch.diagnosis.diagnosticians.training_hang import (
            TrainingHangDiagnostician,
        )
        from dlrover_tpu_torch.diagnosis.precheck import (
            ConnectionPreCheckOperator,
            SchedulingPreCheckOperator,
        )
        from dlrover_tpu_torch.master.diagnosis.diagnosis_master import (
            DiagnosisMaster,
        )

        manager = DiagnosisManager()
        operators = []
        if pre_check:
            operators = [
                SchedulingPreCheckOperator(self.job_manager),
                # Lazy: the servicer exists by the time pre_check() runs.
                ConnectionPreCheckOperator(
                    lambda: self.servicer.node_last_contact()
                ),
            ]
        dm = DiagnosisMaster(
            pre_check_operators=operators, manager=manager
        )
        from dlrover_tpu_torch.diagnosis.diagnosis_data import DiagnosisDataType

        manager.register(
            TrainingHangDiagnostician(
                self.perf_monitor,
                self.job_manager,
                metric_context=(
                    self.metric_monitor.context
                    if self.metric_monitor is not None
                    else None
                ),
                # Late-bound: workers' relayed stack dumps let the hang
                # escalation name the blocked frame.
                stack_dump_provider=lambda: dm.recent_data(
                    DiagnosisDataType.STACK_DUMP
                ),
            )
        )
        manager.register(NodeFailureDiagnostician())
        manager.register(NodeInconsistencyDiagnostician())
        return dm

    @classmethod
    def from_args(cls, args) -> "DistributedJobMaster":
        """Build the master for a CLI platform choice (reference
        master/main.py + scheduler/factory.py new_job_args)."""
        if args.platform == "sim":
            from dlrover_tpu_torch.testing.sim_cluster import (
                SimCluster,
                SimNodeWatcher,
                SimScaler,
            )

            cluster = SimCluster()
            scaler = SimScaler(args.job_name, cluster)
            watcher = SimNodeWatcher(args.job_name, cluster)
        elif args.platform in ("k8s", "gke_tpu"):
            raise _not_ported(
                f"platform {args.platform!r}",
                "master/scaler/pod_scaler.py and "
                "master/watcher/k8s_watcher.py",
            )
        else:
            raise ValueError(f"unknown platform {args.platform!r}")
        legal_counts = None
        raw_counts = getattr(args, "legal_worker_counts", "")
        if raw_counts:
            legal_counts = [int(c) for c in raw_counts.split(",") if c]
        return cls(
            port=args.port,
            job_name=args.job_name,
            node_num=args.node_num,
            scaler=scaler,
            watcher=watcher,
            max_relaunch_count=args.max_relaunch_count,
            transport=args.transport,
            pre_check=getattr(args, "pre_check", False),
            auto_scale=getattr(args, "auto_scale", False),
            legal_worker_counts=legal_counts,
            dashboard_port=getattr(args, "dashboard_port", -1),
            global_batch_size=getattr(args, "global_batch_size", 0),
            micro_batch_per_device=getattr(
                args, "micro_batch_per_device", 0
            ),
            devices_per_node=getattr(args, "devices_per_node", 4),
            brain_addr=getattr(args, "brain_addr", ""),
            metric_endpoints=_parse_metric_endpoints(
                getattr(args, "metric_endpoints", "")
            ),
            node_group_size=getattr(args, "node_unit", 0),
            topology_aware=getattr(args, "topology_aware", False),
            autoscale_loop=getattr(args, "autoscale_loop", False),
            autoscale_dry_run=getattr(args, "autoscale_dry_run", False),
            autoscale_interval_s=getattr(
                args, "autoscale_interval_s", 5.0
            ),
            autoscale_max_world=getattr(
                args, "autoscale_max_world", 0
            ),
            autoscale_ckpt_interval_s=getattr(
                args, "autoscale_ckpt_interval_s", 60.0
            ),
            autoscale_record=getattr(args, "autoscale_record", ""),
        )

    # ---- lifecycle ---------------------------------------------------------

    def prepare(self):
        for mgr in self.rdzv_managers.values():
            mgr.update_rdzv_params(
                min_nodes=self._node_num,
                max_nodes=self._node_num,
                waiting_timeout=30.0,
            )
        self._server.start()
        # Late-bind the master address into worker env injection: the RPC
        # port is only known after the server starts.
        from dlrover_tpu_torch.common.env_utils import get_hostname_ip

        self.job_manager.set_master_addr(
            f"{get_hostname_ip()[1]}:{self.port}"
        )
        self.job_manager.start()
        self.task_manager.start()
        self.metric_collector.start()
        if self.metric_monitor is not None:
            self.metric_monitor.start()
        if self.dashboard is not None:
            self.dashboard.start()
        if self.auto_scaler is not None:
            self.auto_scaler.start()
        if self.autoscaler is not None:
            self.autoscaler.start()
        if self.diagnosis_master is not None:
            self.diagnosis_master.start_observing()
        logger.info(
            "distributed master [%s] serving on port %d (%d workers)",
            self.job_name,
            self.port,
            self._node_num,
        )

    def pre_check(self) -> bool:
        if self.diagnosis_master is None:
            return True
        return self.diagnosis_master.pre_check()

    def run(self) -> int:
        diag_thread = threading.Thread(
            target=self._diagnose_loop, name="master-diagnose", daemon=True
        )
        diag_thread.start()
        try:
            while not self._stopped.is_set():
                time.sleep(JobConstant.MASTER_RUN_LOOP_INTERVAL)
                if self.job_manager.all_workers_exited():
                    if self.job_manager.all_workers_succeeded():
                        self.exit_reason = JobExitReason.SUCCEEDED
                        logger.info("all workers succeeded; master exiting")
                        return 0
                    self.exit_reason = JobExitReason.WORKER_ERROR
                    logger.error("workers failed; master exiting")
                    return 1
                if self.job_manager.pending_timed_out():
                    self.exit_reason = JobExitReason.UNKNOWN
                    logger.error("workers pending too long; aborting job")
                    return 1
                if self.task_manager.finished():
                    logger.info("all data shards consumed; job finishing")
                    self.exit_reason = JobExitReason.SUCCEEDED
                    return 0
            return 0 if self.exit_reason == JobExitReason.SUCCEEDED else 1
        finally:
            self.stop()

    def _diagnose_loop(self):
        """Execute master-level diagnosis actions (reference
        dist_master.py:236 _diagnose_job)."""
        while not self._stopped.is_set():
            time.sleep(1.0)
            action = self._job_context.next_master_action()
            if action is None:
                continue
            from dlrover_tpu_torch.training_event import MasterEvents

            MasterEvents.diagnosis_action(action.action_type, action.reason)
            if action.action_type == DiagnosisActionType.JOB_RESTART:
                logger.warning("diagnosis: restarting workers (%s)",
                               action.reason)
                self.job_manager.restart_worker_processes(action.reason)
            elif action.action_type == DiagnosisActionType.JOB_ABORT:
                logger.error("diagnosis: aborting job (%s)", action.reason)
                self.exit_reason = JobExitReason.HANG_ERROR
                self._stopped.set()

    def stop(self):
        self._stopped.set()
        self.metric_collector.report_completion(
            success=self.exit_reason == JobExitReason.SUCCEEDED,
            exit_reason=self.exit_reason,
            failure_count=self._job_context.failure_count,
        )
        self.metric_collector.stop()
        if self.metric_monitor is not None:
            self.metric_monitor.stop()
        if self.dashboard is not None:
            self.dashboard.stop()
        if self.auto_scaler is not None:
            self.auto_scaler.stop()
        if self.autoscaler is not None:
            # Reports the achieved goodput back to the brain (the §30
            # prior's learning half) before the loop goes down.
            self.autoscaler.stop(
                success=self.exit_reason == JobExitReason.SUCCEEDED
            )
        if self.diagnosis_master is not None:
            self.diagnosis_master.stop_observing()
        self.task_manager.stop()
        self.job_manager.stop()
        graceful = getattr(self._server, "graceful_stop", None)
        if graceful is not None:
            graceful()
        else:
            self._server.stop()
        if self.journal is not None and not self.journal.closed:
            self.journal.close()

    def request_stop(self):
        self._stopped.set()
