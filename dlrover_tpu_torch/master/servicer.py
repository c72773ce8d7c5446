"""Master RPC servicer: dispatches the get/report protocol to managers.

Parity: reference dlrover/python/master/servicer.py (MasterServicer:89,
dispatch by message type :152-208/:438-500). Dispatch here is an explicit
type->handler table instead of method-name reflection, so the full RPC
surface is greppable.

The port's copy of ``dlrover_tpu/master/servicer.py``.
"""

import base64
import time
from typing import Dict, Optional

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.comm import Message
from dlrover_tpu_torch.common.constants import (
    PreCheckStatus,
    RendezvousName,
    TaskType,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.elastic_training.elastic_ps import ClusterVersionService
from dlrover_tpu_torch.master.elastic_training.kv_store import KVStoreService
from dlrover_tpu_torch.master.elastic_training.rdzv_manager import (
    NetworkCheckRendezvousManager,
    RendezvousManager,
)
from dlrover_tpu_torch.master.elastic_training.sync_service import SyncService
from dlrover_tpu_torch.fault import fault_point
from dlrover_tpu_torch.master.overload import OverloadGovernor
from dlrover_tpu_torch.master.rpc_metrics import RpcTelemetry, clocks
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.rpc.transport import MasterService


class MasterServicer(MasterService):
    def __init__(
        self,
        rdzv_managers: Dict[str, RendezvousManager],
        task_manager=None,
        job_manager=None,
        diagnosis_master=None,
        perf_monitor=None,
        sync_service: Optional[SyncService] = None,
        kv_store: Optional[KVStoreService] = None,
        job_metric_collector=None,
        elastic_ps_service: Optional[ClusterVersionService] = None,
        rescale_coordinator=None,
        trace_aggregator=None,
        overload_governor: Optional[OverloadGovernor] = None,
        journal=None,
    ):
        # Durable master journal (docs/DESIGN.md §37): when present,
        # every state transition that must survive a master crash is
        # appended BEFORE the reply leaves, and its master_epoch is
        # stamped into every response for worker-side fencing.
        self._journal = journal
        self._master_epoch = (
            journal.master_epoch if journal is not None else -1
        )
        self._dataset_params: Dict[str, dict] = {}
        self._journal_rdzv: Dict[str, dict] = {}
        if journal is not None and journal.recovered is not None:
            for name, replay in journal.recovered.datasets.items():
                self._dataset_params[name] = dict(replay.params)
            self._journal_rdzv = {
                name: dict(committed)
                for name, committed in journal.recovered.rdzv.items()
            }
            if getattr(journal, "_snapshot_fn", None) is None:
                journal._snapshot_fn = self.journal_snapshot
        self._rescale_coordinator = rescale_coordinator
        # Recent trace trees served at /api/traces: fed by workers
        # pushing drained spans over DiagnosisDataReport and by the
        # master's own armed tracer (the master wires its tracer's
        # on_finish to the aggregator at construction).
        self._trace_aggregator = trace_aggregator
        self._rdzv_managers = rdzv_managers
        self._task_manager = task_manager
        self._job_manager = job_manager
        self._diagnosis_master = diagnosis_master
        self._perf_monitor = perf_monitor
        self._sync_service = sync_service or SyncService()
        self._kv_store = kv_store or KVStoreService()
        # Per-job random secret for the agents' checkpoint-replica HTTP
        # exchange (flash_ckpt/replica.py): not derivable from job
        # metadata, though anyone who can reach the master's (itself
        # unauthenticated) KV RPC can still read it — operators wanting a
        # secret outside that trust domain set DLROVER_TPU_REPLICA_TOKEN.
        from dlrover_tpu_torch.common.constants import CheckpointConstant

        if not self._kv_store.get(CheckpointConstant.REPLICA_TOKEN_KEY):
            import secrets

            token = secrets.token_hex(16).encode()
            self._kv_store.set(
                CheckpointConstant.REPLICA_TOKEN_KEY, token
            )
            # Journal the seed so the token survives a master restart —
            # agents that cached it mid-job must keep matching.
            self._journal_kv_set(CheckpointConstant.REPLICA_TOKEN_KEY, token)
        self._job_metric_collector = job_metric_collector
        self._elastic_ps_service = elastic_ps_service or ClusterVersionService()
        self._pre_check_status = PreCheckStatus.PASS
        self._elastic_run_config: Dict[str, str] = {}
        self._start_time = time.time()
        # node_id -> wall time of its last RPC; the connection pre-check
        # uses "has talked to the master at all" as the liveness signal
        # (agents poll wait_pre_check before their first heartbeat).
        self._node_last_contact: Dict[int, float] = {}

        self._get_handlers = {
            comm.CommWorldRequest: self._get_comm_world,
            comm.NumNodesWaitingRequest: self._num_nodes_waiting,
            comm.FaultNodeRequest: self._get_fault_nodes,
            comm.StragglerRequest: self._get_stragglers,
            comm.KVStoreGetRequest: self._kv_get,
            comm.KVStoreMultiGetRequest: self._kv_multi_get,
            comm.KVStoreAddRequest: self._kv_add,
            comm.SyncQueryRequest: self._sync_query,
            comm.TaskRequest: self._get_task,
            comm.MultiTaskRequest: self._get_tasks,
            comm.ShardCheckpointRequest: self._get_shard_checkpoint,
            comm.CkptLatestStepRequest: self._get_ckpt_latest_step,
            comm.PreCheckRequest: self._get_pre_check_result,
            comm.ParallelConfigRequest: self._get_parallel_config,
            comm.ElasticRunConfigRequest: self._get_elastic_run_config,
            comm.JobDetailRequest: self._get_job_detail,
            comm.ClusterVersionRequest: self._get_cluster_version,
            comm.RescalePlanRequest: self._get_rescale_plan,
            comm.RescaleBarrierRequest: self._get_rescale_barrier,
        }
        self._report_handlers = {
            comm.JoinRendezvousRequest: self._join_rendezvous,
            comm.NetworkReadyRequest: self._network_ready,
            comm.NetworkCheckResultReport: self._report_network_check,
            comm.HeartbeatReport: self._report_heartbeat,
            comm.NodeFailureReport: self._report_node_failure,
            comm.SucceededRequest: self._report_succeeded,
            comm.NodeEventReport: self._report_node_event,
            comm.ResourceStats: self._report_resource_stats,
            comm.GlobalStepReport: self._report_global_step,
            comm.GoodputPhaseReport: self._report_goodput_phase,
            comm.KVStoreSetRequest: self._kv_set,
            comm.SyncJoinRequest: self._sync_join,
            comm.SyncFinishRequest: self._sync_finish,
            comm.DatasetShardParams: self._report_dataset_params,
            comm.TaskDoneReport: self._report_task_done,
            comm.TaskDoneBatchReport: self._report_tasks_done_batch,
            comm.ShardCheckpointRestoreRequest: self._restore_shard_checkpoint,
            comm.CkptStepReport: self._report_ckpt_step,
            comm.DiagnosisDataReport: self._report_diagnosis_data,
            comm.ClusterVersionReport: self._report_cluster_version,
            comm.RescaleJoinReport: self._report_rescale_join,
            comm.RescaleAckReport: self._report_rescale_ack,
        }
        # §32 per-verb telemetry + overload accounting. The verb label
        # set is exactly the registered handler types (+ the "other"
        # collapse bucket), so exposition cardinality is bounded by
        # construction no matter what arrives on the wire.
        self._telemetry = RpcTelemetry(
            t.__name__
            for t in (
                list(self._get_handlers) + list(self._report_handlers)
            )
        )
        self._overload = overload_governor or OverloadGovernor()

    # ---- transport entry points -------------------------------------------

    def node_last_contact(self) -> Dict[int, float]:
        return dict(self._node_last_contact)

    @property
    def telemetry(self) -> RpcTelemetry:
        return self._telemetry

    @property
    def overload_governor(self) -> OverloadGovernor:
        return self._overload

    def get(self, message: Message) -> Message:
        reply, name = self._dispatch(message, self._get_handlers, "get")
        # AFTER the handler: any state mutation (lease moved to doing,
        # kv value read) already happened — dropping the reply here is
        # the "response lost on the wire" fault the client-side retry
        # and the master's timeout recovery must absorb.
        fault_point("rpc.get.drop_reply", request=name)
        return reply

    def report(self, message: Message) -> Message:
        reply, name = self._dispatch(
            message, self._report_handlers, "report"
        )
        # State already applied; a dropped reply makes the client
        # re-send — report handlers must stay safe to re-apply
        # (at-most-once effect), which the chaos soak asserts.
        fault_point("rpc.report.drop_reply", request=name)
        return reply

    def _dispatch(
        self, message: Message, handlers, kind: str
    ) -> "tuple":
        """One instrumented dispatch: deserialize → admission → handler
        → serialize, with the §32 split timed so lock contention shows
        up as handler time, and the server span covering the SAME
        window as ``master_rpc_seconds`` (the soak asserts they agree
        within 15%). Returns ``(reply, request_type_name)`` — the
        caller fires its drop_reply fault point (a literal site the
        taxonomy test greps for) before handing the reply to the
        transport."""
        self._node_last_contact[message.node_id] = time.time()
        wall0 = time.time()
        t0, cpu0 = clocks()
        request = (
            comm.BaseRequest.deserialize(message.data)
            if message.data
            else comm.BaseRequest()
        )
        t_deser = time.monotonic()
        name = type(request).__name__
        tm = self._telemetry
        verb = tm.verb(name)
        tm.begin(verb)
        error_kind = None
        dropped = False
        handler_s = None  # stays None when the handler never runs
        serialize_s = 0.0
        try:
            handler = handlers.get(type(request))
            shed_class = (
                self._overload.admit(name) if handler is not None else None
            )
            if handler is not None and shed_class is None:
                # Server span parented to the caller's envelope
                # context: the worker's client RPC span and this
                # handler span share one trace. Disarmed: one global
                # check, a no-op object. Back-dated to the
                # pre-deserialize clock and exited after serialize, so
                # span duration == master_rpc_seconds duration (the
                # soak's 15%-agreement invariant).
                span = tracing.server_span(
                    f"master.{name}",
                    getattr(message, "trace", None),
                    start_mono=t0,
                    start_wall=wall0,
                    node_id=message.node_id,
                )
            else:
                span = tracing.NOOP_SPAN
            with span:
                if handler is None:
                    error_kind = "no_handler"
                    response = comm.BaseResponse(
                        success=False,
                        reason=f"no {kind} handler for {type(request)}",
                    )
                elif shed_class is not None:
                    # Graceful degradation: answered, not handled. Only
                    # diagnostic/telemetry classes can reach here — the
                    # governor admits critical verbs unconditionally.
                    dropped = True
                    response = comm.BaseResponse(
                        success=False,
                        reason=f"overload: shed {shed_class} traffic",
                    )
                else:
                    th0 = time.monotonic()
                    try:
                        response = handler(message, request)
                    except Exception as e:
                        error_kind = type(e).__name__
                        raise
                    finally:
                        handler_s = time.monotonic() - th0
                        self._overload.observe(
                            handler_s, tm.inflight_now()
                        )
                ts0 = time.monotonic()
                if self._master_epoch >= 0:
                    # Epoch fencing (§37): every response carries the
                    # journal's monotone master_epoch so a worker can
                    # tell a restarted master from the one it knew.
                    try:
                        response.master_epoch = self._master_epoch
                    except (AttributeError, TypeError):
                        pass
                reply = Message(
                    node_id=message.node_id, data=response.serialize()
                )
                serialize_s = time.monotonic() - ts0
        finally:
            t_end, cpu_end = clocks()
            tm.end(
                verb,
                total_s=t_end - t0,
                deserialize_s=t_deser - t0,
                handler_s=handler_s,
                serialize_s=serialize_s,
                cpu_s=max(cpu_end - cpu0, 0.0),
                error_kind=error_kind,
                dropped=dropped,
            )
        return reply, name

    def control_plane_state(self) -> Dict:
        """The §32 saturation view behind ``/api/control_plane``:
        overload governor state, per-verb RPC telemetry, and every
        bounded buffer's occupancy + drop counters."""
        buffers: Dict[str, Dict] = {}
        if self._trace_aggregator is not None:
            buffers["trace_aggregator"] = self._trace_aggregator.stats()
        if self._perf_monitor is not None:
            stats = getattr(self._perf_monitor, "buffer_stats", None)
            if callable(stats):
                buffers["perf_phase_records"] = stats()
        if self._task_manager is not None:
            stats = getattr(self._task_manager, "queue_stats", None)
            if callable(stats):
                buffers["task_queues"] = stats()
        size = getattr(self._kv_store, "size", None)
        if callable(size):
            buffers["kv_store"] = {
                "occupancy": size(),
                "drops": 0,  # unbounded dict today; 0 by definition
            }
        if self._journal is not None:
            buffers["journal"] = self._journal.stats()
        return {
            "overload": self._overload.state(),
            "rpc": self._telemetry.summary(),
            "buffers": buffers,
            "nodes_seen": len(self._node_last_contact),
            "uptime_s": round(time.time() - self._start_time, 3),
        }

    # ---- journal hooks (docs/DESIGN.md §37) -------------------------------

    @property
    def master_epoch(self) -> int:
        return self._master_epoch

    def _journal_kv_set(self, key: str, value: bytes):
        if self._journal is not None:
            self._journal.append(
                "kv_set",
                key=key,
                val=base64.b64encode(value).decode("ascii"),
            )

    def _journal_dispatch(self, node_id: int, tasks):
        """One group commit covering every real lease in the batch; the
        WAL order is mutate → journal → reply, so both crash windows
        keep exactly-once (pre-journal: the worker never got the reply
        and the shard is regenerated; post-journal: the lease replays
        into ``doing`` and either the rider's done-report pops it or
        timeout recovery re-queues it)."""
        if self._journal is None:
            return
        recs = [
            {
                "kind": "dispatch",
                "ds": t.dataset_name,
                "tid": t.task_id,
                "node": node_id,
                "epoch": t.epoch,
                "start": t.start,
                "end": t.end,
                "idx": t.record_indices,
                "part": t.partition,
            }
            for t in tasks
            if t.task_id >= 0
        ]
        if recs:
            self._journal.append_many(recs)

    def journal_snapshot(self) -> dict:
        """Lease-preserving full-state snapshot for journal compaction
        (original task ids survive, so compaction never breaks the
        exactly-once law). Reads each component under its own lock; the
        coordinator counters are read lock-free (monotone ints)."""
        snap: Dict[str, object] = {
            "datasets": {},
            "kv": {},
            "ckpt_step": -1,
            "plan_seq": 0,
            "rdzv": {
                name: {
                    "round": committed.get("round", 0),
                    "world": {
                        str(r): n
                        for r, n in (committed.get("world") or {}).items()
                    },
                }
                for name, committed in self._journal_rdzv.items()
            },
            "sync": {},
        }
        if self._task_manager is not None:
            snapshots = getattr(
                self._task_manager, "journal_snapshots", None
            )
            if callable(snapshots):
                for name, per in snapshots().items():
                    entry = dict(per)
                    entry["params"] = self._dataset_params.get(name, {})
                    snap["datasets"][name] = entry
        dump = getattr(self._kv_store, "dump", None)
        if callable(dump):
            snap["kv"] = {
                k: base64.b64encode(v).decode("ascii")
                for k, v in dump().items()
            }
        coord = self._rescale_coordinator
        if coord is not None:
            snap["plan_seq"] = int(getattr(coord, "_plan_seq", 0))
            snap["ckpt_step"] = int(getattr(coord, "_committed_step", -1))
        sync_snap = getattr(self._sync_service, "journal_snapshot", None)
        if callable(sync_snap):
            snap["sync"] = sync_snap()
        return snap

    # ---- rendezvous --------------------------------------------------------

    def _join_rendezvous(self, msg, req: comm.JoinRendezvousRequest):
        mgr = self._rdzv_managers.get(req.rdzv_name)
        if mgr is None:
            return comm.BaseResponse(False, f"unknown rdzv {req.rdzv_name}")
        mgr.set_node_unit(req.node_unit)
        rdzv_round = mgr.join_rendezvous(
            req.node_id,
            req.node_rank,
            req.local_world_size,
            req.node_ip,
            req.node_group,
        )
        if self._job_manager is not None:
            self._job_manager.handle_node_joined(req.node_id, req.node_rank)
        return comm.JoinRendezvousResponse(round=rdzv_round)

    def _get_comm_world(self, msg, req: comm.CommWorldRequest):
        mgr = self._rdzv_managers.get(req.rdzv_name)
        if mgr is None:
            return comm.BaseResponse(False, f"unknown rdzv {req.rdzv_name}")
        atomic = getattr(mgr, "get_comm_world_and_groups", None)
        if atomic is not None:
            rdzv_round, group, world, node_groups = atomic(req.node_id)
        else:
            rdzv_round, group, world = mgr.get_comm_world(req.node_id)
            node_groups = {}
        rank_order = list(world)
        if self._journal is not None and world:
            last = self._journal_rdzv.get(req.rdzv_name, {})
            if last.get("round") != rdzv_round:
                committed = {"round": rdzv_round, "world": dict(world)}
                self._journal_rdzv[req.rdzv_name] = committed
                self._journal.append(
                    "rdzv",
                    name=req.rdzv_name,
                    round=rdzv_round,
                    world={str(r): n for r, n in world.items()},
                )
        return comm.CommWorld(
            round=rdzv_round,
            group=group,
            world=world,
            coordinator_rank=rank_order[0] if rank_order else -1,
            rank_order=rank_order,
            node_groups=node_groups,
        )

    def _num_nodes_waiting(self, msg, req: comm.NumNodesWaitingRequest):
        mgr = self._rdzv_managers.get(req.rdzv_name)
        waiting = mgr.num_nodes_waiting() if mgr else 0
        return comm.NumNodesWaitingResponse(waiting_num=waiting)

    # ---- live rescale ------------------------------------------------------

    def _report_rescale_join(self, msg, req: comm.RescaleJoinReport):
        if self._rescale_coordinator is None:
            return comm.BaseResponse(False, "no rescale coordinator")
        self._rescale_coordinator.note_worker_joined(
            req.node_rank,
            req.local_world_size,
            node_group=getattr(req, "node_group", -1),
        )
        return comm.BaseResponse(True)

    def _get_rescale_plan(self, msg, req: comm.RescalePlanRequest):
        if self._rescale_coordinator is None:
            return comm.RescalePlanResponse()
        plan = self._rescale_coordinator.get_plan(
            req.node_rank, req.current_plan_id
        )
        if plan is None:
            return comm.RescalePlanResponse()
        # Chaos site: the plan broadcast to THIS worker is dropped on
        # the wire (raise -> transport error client-side). The pull
        # protocol absorbs it: the worker's next poll re-fetches the
        # same versioned plan.
        fault_point(
            "rescale.plan.broadcast",
            plan_id=plan.plan_id,
            rank=req.node_rank,
        )
        return comm.RescalePlanResponse(
            plan_id=plan.plan_id,
            world=dict(plan.world),
            rank_order=list(plan.rank_order),
            restore_step=plan.restore_step,
            reason=plan.reason,
            created_at=plan.created_at,
            barrier_timeout_s=plan.barrier_timeout_s,
        )

    def _report_rescale_ack(self, msg, req: comm.RescaleAckReport):
        if self._rescale_coordinator is None:
            return comm.BaseResponse(False, "no rescale coordinator")
        ok = self._rescale_coordinator.ack(
            req.plan_id, req.node_rank, req.phase
        )
        return comm.BaseResponse(
            ok, "" if ok else "stale plan or unknown rank/phase"
        )

    def _get_rescale_barrier(self, msg, req: comm.RescaleBarrierRequest):
        if self._rescale_coordinator is None:
            return comm.RescaleBarrierResponse()
        ready, expired, superseded, missing = (
            self._rescale_coordinator.barrier_state(req.plan_id, req.phase)
        )
        return comm.RescaleBarrierResponse(
            ready=ready,
            expired=expired,
            superseded=superseded,
            missing=missing,
        )

    # ---- network check -----------------------------------------------------

    def _network_ready(self, msg, req):
        return comm.BaseResponse(True)

    def _report_network_check(self, msg, req: comm.NetworkCheckResultReport):
        mgr = self._rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        if isinstance(mgr, NetworkCheckRendezvousManager):
            mgr.report_network_check_result(
                req.node_rank, req.succeeded, req.result
            )
        return comm.BaseResponse(True)

    def _get_fault_nodes(self, msg, req):
        mgr = self._rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        if isinstance(mgr, NetworkCheckRendezvousManager):
            nodes, evaluated_round, needs_round2 = mgr.check_fault_node()
            return comm.FaultNodeResponse(
                fault_nodes=nodes,
                evaluated_round=evaluated_round,
                needs_round2=needs_round2,
            )
        return comm.FaultNodeResponse()

    def _get_stragglers(self, msg, req):
        mgr = self._rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        if isinstance(mgr, NetworkCheckRendezvousManager):
            return comm.StragglerResponse(stragglers=mgr.check_straggler())
        return comm.StragglerResponse()

    # ---- heartbeat / diagnosis --------------------------------------------

    def _report_heartbeat(self, msg, req: comm.HeartbeatReport):
        actions = []
        if self._job_manager is not None:
            actions = self._job_manager.collect_node_heartbeat(
                req.node_id, req.timestamp
            )
        return comm.HeartbeatResponse(actions=actions or [])

    def _report_node_failure(self, msg, req: comm.NodeFailureReport):
        logger.warning(
            "node %d (rank %d) reported failure: %s exit=%d",
            req.node_id,
            req.node_rank,
            req.error_data,
            req.exit_code,
        )
        if self._job_manager is not None:
            self._job_manager.handle_node_failure(req)
        if (
            self._rescale_coordinator is not None
            and req.level == TrainingExceptionLevel.NODE_ERROR
        ):
            # A node-level failure means the rank is gone for good: fold
            # it out of the live set so the next plan excludes it.
            self._rescale_coordinator.note_worker_lost(req.node_rank)
        return comm.BaseResponse(True)

    def _report_succeeded(self, msg, req: comm.SucceededRequest):
        if self._job_manager is not None:
            self._job_manager.handle_node_succeeded(req.node_id)
        return comm.BaseResponse(True)

    def _report_node_event(self, msg, req: comm.NodeEventReport):
        if self._job_manager is not None:
            self._job_manager.handle_reported_node_event(req)
        return comm.BaseResponse(True)

    def _report_diagnosis_data(self, msg, req: comm.DiagnosisDataReport):
        from dlrover_tpu_torch.diagnosis.diagnosis_data import DiagnosisDataType

        if (
            req.data_type == DiagnosisDataType.TRACE_SPANS
            and self._trace_aggregator is not None
        ):
            # Worker span push (piggybacked on this existing verb):
            # feed /api/traces directly; the generic diagnosis store
            # still records the report below.
            self._trace_aggregator.ingest(req.payload.get("spans", ()))
        if self._diagnosis_master is not None:
            self._diagnosis_master.collect_diagnosis_data(req)
        return comm.BaseResponse(True)

    # ---- perf / resources --------------------------------------------------

    def _report_resource_stats(self, msg, req: comm.ResourceStats):
        if self._job_manager is not None:
            self._job_manager.update_node_resource_usage(req)
        return comm.BaseResponse(True)

    def _report_global_step(self, msg, req: comm.GlobalStepReport):
        if self._perf_monitor is not None:
            self._perf_monitor.collect_global_step(
                req.step,
                req.timestamp,
                req.elapsed_train_secs,
                node_id=req.node_id,
                step_time_s=getattr(req, "step_time_s", 0.0),
            )
        return comm.BaseResponse(True)

    def _report_goodput_phase(self, msg, req: comm.GoodputPhaseReport):
        if self._perf_monitor is not None:
            self._perf_monitor.collect_phase(
                req.node_id, req.phase, req.start, req.end
            )
        return comm.BaseResponse(True)

    # ---- kv store ----------------------------------------------------------

    def _kv_set(self, msg, req: comm.KVStoreSetRequest):
        # Journal BEFORE apply: a crash in between replays the set and
        # the client's retry re-applies it idempotently.
        self._journal_kv_set(req.key, req.value)
        self._kv_store.set(req.key, req.value)
        return comm.BaseResponse(True)

    def _kv_get(self, msg, req: comm.KVStoreGetRequest):
        return comm.KVStoreGetResponse(value=self._kv_store.get(req.key))

    def _kv_add(self, msg, req: comm.KVStoreAddRequest):
        # Apply-then-journal the RESULT (not the delta): kv_add is the
        # one deliberately unretried verb, so replaying the final value
        # can never double-count an increment (§37: a crash before the
        # journal write loses the add, and the client sees the error).
        value = self._kv_store.add(req.key, req.delta)
        self._journal_kv_set(req.key, str(value).encode())
        return comm.KVStoreAddResponse(value=value)

    def _kv_multi_get(self, msg, req: comm.KVStoreMultiGetRequest):
        return comm.KVStoreMultiGetResponse(
            values=self._kv_store.multi_get(req.keys)
        )

    # ---- sync --------------------------------------------------------------

    def _sync_join(self, msg, req: comm.SyncJoinRequest):
        if self._journal is not None:
            self._journal.append(
                "sync", name=req.sync_name, op="join", rank=req.node_rank
            )
        self._sync_service.join_sync(req.sync_name, req.node_rank)
        return comm.BaseResponse(True)

    def _sync_finish(self, msg, req: comm.SyncFinishRequest):
        if self._journal is not None:
            self._journal.append("sync", name=req.sync_name, op="finish")
        self._sync_service.sync_finished(req.sync_name)
        return comm.BaseResponse(True)

    def _sync_query(self, msg, req: comm.SyncQueryRequest):
        return comm.SyncQueryResponse(done=self._sync_service.query(req.sync_name))

    # ---- data sharding -----------------------------------------------------

    def _report_dataset_params(self, msg, req: comm.DatasetShardParams):
        if self._task_manager is not None:
            params = {
                f: getattr(req, f)
                for f in comm.DatasetShardParams.__dataclass_fields__
            }
            self._dataset_params[req.dataset_name] = params
            if (
                self._journal is not None
                and self._task_manager.get_dataset(req.dataset_name) is None
            ):
                self._journal.append("dataset", params=params)
            self._task_manager.new_dataset(req)
        return comm.BaseResponse(True)

    def _get_task(self, msg, req: comm.TaskRequest):
        if self._task_manager is None:
            return comm.ShardTask()
        task = self._task_manager.get_task(req.node_id, req.dataset_name)
        self._journal_dispatch(req.node_id, [task])
        return task

    def _get_tasks(self, msg, req: comm.MultiTaskRequest):
        if self._task_manager is None:
            return comm.MultiTaskResponse()
        tasks = self._task_manager.get_tasks(
            req.node_id, req.dataset_name, req.count
        )
        self._journal_dispatch(req.node_id, tasks)
        wait = bool(tasks) and tasks[0].task_type == TaskType.WAIT
        return comm.MultiTaskResponse(
            tasks=[] if wait else [t for t in tasks if t.task_id >= 0],
            wait=wait,
        )

    def _report_task_done(self, msg, req: comm.TaskDoneReport):
        if self._task_manager is not None:
            # Journal-first: losing an applied-but-unjournaled done
            # would re-queue a consumed shard on restart (double read);
            # replaying a journaled-but-unapplied done is idempotent.
            if self._journal is not None and req.task_id >= 0:
                self._journal.append(
                    "done",
                    ds=req.dataset_name,
                    node=req.node_id,
                    ok=[req.task_id] if req.success else [],
                    fail=[] if req.success else [req.task_id],
                )
            self._task_manager.report_task_done(
                req.dataset_name, req.task_id, req.node_id, req.success
            )
        return comm.BaseResponse(True)

    def _report_tasks_done_batch(self, msg, req: comm.TaskDoneBatchReport):
        if self._task_manager is not None:
            if self._journal is not None and (
                req.done_ids or req.failed_ids
            ):
                self._journal.append(
                    "done",
                    ds=req.dataset_name,
                    node=req.node_id,
                    ok=list(req.done_ids),
                    fail=list(req.failed_ids or []),
                )
            self._task_manager.report_tasks_done(
                req.dataset_name, req.node_id, req.done_ids, req.failed_ids
            )
        return comm.BaseResponse(True)

    def _get_shard_checkpoint(self, msg, req: comm.ShardCheckpointRequest):
        if self._task_manager is None:
            return comm.ShardCheckpointResponse(checkpoint="")
        ckpt = self._task_manager.get_shard_checkpoint(req.dataset_name)
        return comm.ShardCheckpointResponse(checkpoint=ckpt)

    def _restore_shard_checkpoint(
        self, msg, req: comm.ShardCheckpointRestoreRequest
    ):
        if self._task_manager is not None:
            if self._journal is not None and req.checkpoint:
                self._journal.append(
                    "shard_ckpt", ds=req.dataset_name, ckpt=req.checkpoint
                )
            self._task_manager.restore_shard_checkpoint(
                req.dataset_name, req.checkpoint
            )
        return comm.BaseResponse(True)

    # ---- checkpoint coordination ------------------------------------------

    def _report_ckpt_step(self, msg, req: comm.CkptStepReport):
        if self._job_manager is not None:
            self._job_manager.update_ckpt_step(req.node_id, req.step, req.committed)
        if self._rescale_coordinator is not None:
            # The coordinator tracks the committed frontier itself so a
            # rescale plan's restore_step works without a job manager
            # (soak harness, standalone masters).
            self._rescale_coordinator.note_ckpt_step(req.step, req.committed)
        if self._journal is not None and req.committed:
            # Only committed steps matter to a restarted master (the
            # monotone frontier a rescale plan's restore_step obeys).
            self._journal.append("ckpt_step", step=req.step)
        return comm.BaseResponse(True)

    def _get_ckpt_latest_step(self, msg, req):
        step = -1
        if self._job_manager is not None:
            step = self._job_manager.get_committed_ckpt_step()
        return comm.CkptLatestStepResponse(step=step)

    # ---- pre-check / config / detail --------------------------------------

    def set_pre_check_status(self, status: str):
        self._pre_check_status = status

    def _get_pre_check_result(self, msg, req):
        if self._diagnosis_master is not None:
            status = self._diagnosis_master.get_pre_check_status()
        else:
            status = self._pre_check_status
        return comm.PreCheckResponse(status=status)

    def set_elastic_run_config(self, config: Dict[str, str]):
        self._elastic_run_config = dict(config)

    def _get_elastic_run_config(self, msg, req):
        return comm.ElasticRunConfigResponse(configs=self._elastic_run_config)

    def _get_parallel_config(self, msg, req):
        if self._job_manager is not None:
            cfg = self._job_manager.get_parallel_config()
            if cfg is not None:
                return cfg
        return comm.ParallelConfig()

    def _get_job_detail(self, msg, req):
        if self._job_manager is not None:
            return self._job_manager.get_job_detail()
        return comm.JobDetailResponse()

    # ---- cluster version (PS parity) --------------------------------------

    def _get_cluster_version(self, msg, req: comm.ClusterVersionRequest):
        if req.version_type == ClusterVersionService.GLOBAL:
            v = self._elastic_ps_service.get_global_version()
        else:
            v = self._elastic_ps_service.get_node_version(
                req.task_type, req.task_id, req.version_type
            )
        return comm.ClusterVersionResponse(version=v)

    def _report_cluster_version(self, msg, req: comm.ClusterVersionReport):
        self._elastic_ps_service.update_node_version(
            req.task_type, req.task_id, req.version_type, req.version
        )
        return comm.BaseResponse(True)
