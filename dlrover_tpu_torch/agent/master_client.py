"""Typed client of the master's get/report protocol.

Parity: reference dlrover/python/elastic_agent/master_client.py:51-778
(MasterClient with gRPC/HTTP transports, retry wrapper, singleton). The
port's copy of ``dlrover_tpu/agent/master_client.py``; its transport
defaults to HTTP (``rpc/transport.py``).
"""

import http.client
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.comm import Message
from dlrover_tpu_torch.common.constants import JobConstant, NodeEnv
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.fault import fault_point
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.rpc.transport import DEFAULT_KIND, build_master_stub

# Bounded master-outage ride-through window (seconds). When > 0, a verb
# whose per-call retry budget exhausts on a connection-class error keeps
# re-trying under long jittered sleeps for up to this long — the window
# a restarting master (journal replay, scheduler reschedule) needs, kept
# deliberately distinct from retry_rpc's per-call budget.
OUTAGE_ENV = "DLROVER_TPU_MASTER_OUTAGE_S"
# Env ceiling for the per-call retry budget (overrides the default for
# every wrapped verb; an explicit retry= kwarg still wins).
MAX_RETRIES_ENV = "DLROVER_TPU_RPC_MAX_RETRIES"

# "Master unreachable", as opposed to "master answered with an error":
# socket/timeout failures are OSError subclasses, half-closed keep-alive
# connections surface as http.client exceptions. An HTTP-level error
# reply (RuntimeError from the stub) means the master is alive — outage
# mode must not mask it.
_OUTAGE_ERRORS = (OSError, http.client.HTTPException)


class RpcRetriesExhausted(RuntimeError):
    """Every retry attempt of one RPC verb failed (named in message)."""

    def __init__(self, verb: str, attempts: int, last_error: Exception):
        super().__init__(
            f"RPC {verb} failed after {attempts} attempts "
            f"(last error: {type(last_error).__name__}: {last_error})"
        )
        self.verb = verb
        self.attempts = attempts
        self.last_error = last_error


def _exhausted_counter():
    from dlrover_tpu_torch.observability.registry import default_registry

    return default_registry().counter(
        "client_rpc_retries_exhausted_total",
        "client RPCs that failed every retry attempt, by verb",
        labelnames=("verb",),
    )


def _default_retries() -> int:
    env = os.getenv(MAX_RETRIES_ENV, "")
    if env:
        try:
            return max(int(env), 1)
        except ValueError:
            pass
    return JobConstant.MASTER_CLIENT_DEFAULT_RETRY


def _outage_window_s() -> float:
    try:
        return float(os.getenv(OUTAGE_ENV, "0") or 0.0)
    except ValueError:
        return 0.0


def retry_rpc(func):
    """Bounded, jittered exponential retry for idempotent control verbs.

    Applied only to verbs that are safe to re-send: gets, and reports
    whose master-side apply is a no-op the second time (done-reports pop
    the lease from ``doing``; a re-apply finds nothing — at-most-once
    effect). Non-idempotent mutations (``kv_store_add``) are deliberately
    NOT wrapped. The ±30% jitter keeps a fleet of workers whose RPCs all
    failed together (master restart) from re-synchronizing into retry
    stampedes.

    Exhaustion contract: the per-call budget (default
    ``MASTER_CLIENT_DEFAULT_RETRY``, env-tunable via
    ``DLROVER_TPU_RPC_MAX_RETRIES``, explicit ``retry=`` kwarg wins)
    raises :class:`RpcRetriesExhausted` naming the verb and ticks
    ``client_rpc_retries_exhausted_total{verb}`` — unless the failure is
    connection-class and ``DLROVER_TPU_MASTER_OUTAGE_S`` is set, in
    which case the client enters bounded outage mode: long jittered
    reconnect attempts until the window expires (master crash-restart
    ride-through, docs/DESIGN.md §37).

    Tracing: ONE client span covers every attempt — a retried RPC is
    the same logical operation re-sent, so the span's ``retry`` attr
    increments instead of minting sibling spans, and the server spans
    of all attempts parent to it (the at-most-once story stays visible
    as one wire operation).
    """

    def wrapper(self, *args, **kwargs):
        retry = max(kwargs.pop("retry", _default_retries()), 1)
        err = None
        with tracing.span(f"rpc.{func.__name__}", kind="client") as sp:
            for i in range(retry):
                if i > 0:
                    sp.inc_attr("retry")
                    backoff = min(2 ** (i - 1), 8)
                    time.sleep(backoff * (1.0 + random.uniform(-0.3, 0.3)))
                try:
                    return func(self, *args, **kwargs)
                except Exception as e:  # noqa: BLE001 — transports vary
                    err = e
            outage_s = _outage_window_s()
            if outage_s > 0 and isinstance(err, _OUTAGE_ERRORS):
                deadline = time.monotonic() + outage_s
                self._outage_begin(func.__name__, err)
                try:
                    while time.monotonic() < deadline:
                        sp.inc_attr("outage_retry")
                        remaining = deadline - time.monotonic()
                        time.sleep(
                            min(
                                1.0 + random.uniform(0.0, 2.0),
                                max(remaining, 0.05),
                            )
                        )
                        try:
                            result = func(self, *args, **kwargs)
                            self._outage_end(recovered=True)
                            return result
                        except _OUTAGE_ERRORS as e:
                            err = e
                        except Exception as e:  # noqa: BLE001
                            # Master is back but the verb itself errors:
                            # surface that, don't spin the window out.
                            err = e
                            break
                finally:
                    self._outage_end(recovered=False)
            sp.set_attr("error", type(err).__name__)
            # The raise happens OUTSIDE the with block, so __exit__
            # would close this span "ok" — end it as the failure it is
            # (end() is idempotent; __exit__'s end becomes a no-op).
            sp.end(status="error")
        _exhausted_counter().inc(verb=func.__name__)
        logger.warning(
            "RPC %s failed after %d tries: %s", func.__name__, retry, err
        )
        raise RpcRetriesExhausted(func.__name__, retry, err) from err

    return wrapper


class MasterClient:
    _instance: Optional["MasterClient"] = None
    _lock = threading.Lock()

    def __init__(
        self,
        master_addr: str,
        node_id: int = 0,
        node_type: str = "worker",
        kind: str = DEFAULT_KIND,
        timeout: float = JobConstant.MASTER_CLIENT_TIMEOUT_DEFAULT,
    ):
        self._addr = master_addr
        self._node_id = node_id
        self._node_type = node_type
        self._stub = build_master_stub(master_addr, kind=kind, timeout=timeout)
        # Epoch fencing (DESIGN.md §37): last master incarnation observed
        # in a response; -1 until a journal-backed master answers.
        self._epoch_lock = threading.Lock()
        self._master_epoch = -1
        self._epoch_listeners: List[Callable[[int, int], None]] = []
        self._in_outage = False

    # ---- plumbing ----------------------------------------------------------

    def _get(self, request: comm.BaseRequest, timeout: Optional[float] = None):
        fault_point("rpc.client.get", request=type(request).__name__)
        msg = Message(
            node_id=self._node_id,
            node_type=self._node_type,
            data=request.serialize(),
            # Active span's context (the retry_rpc span, or any caller
            # span) rides the envelope; None when tracing is disarmed.
            trace=tracing.current_carrier(),
        )
        resp = self._stub.get(msg, timeout=timeout)
        out = comm.BaseResponse.deserialize(resp.data)
        self._observe_epoch(out)
        return out

    def _report(self, request: comm.BaseRequest, timeout: Optional[float] = None):
        fault_point("rpc.client.report", request=type(request).__name__)
        msg = Message(
            node_id=self._node_id,
            node_type=self._node_type,
            data=request.serialize(),
            trace=tracing.current_carrier(),
        )
        resp = self._stub.report(msg, timeout=timeout)
        out = comm.BaseResponse.deserialize(resp.data)
        self._observe_epoch(out)
        return out

    # ---- epoch fencing & outage ride-through (DESIGN.md §37) ---------------

    @property
    def master_epoch(self) -> int:
        return self._master_epoch

    @property
    def in_outage(self) -> bool:
        return self._in_outage

    def add_epoch_listener(self, fn: Callable[[int, int], None]):
        """Register ``fn(old_epoch, new_epoch)`` — fired (on the RPC
        thread that noticed) when a response carries a master_epoch
        different from the last one observed. The FIRST observation only
        records the epoch: a fresh worker joining an old master is not a
        restart."""
        with self._epoch_lock:
            self._epoch_listeners.append(fn)

    def _observe_epoch(self, resp):
        epoch = getattr(resp, "master_epoch", -1)
        if not isinstance(epoch, int) or epoch < 0:
            return
        listeners = []
        with self._epoch_lock:
            prev = self._master_epoch
            if epoch != prev:
                self._master_epoch = epoch
                if prev >= 0:
                    listeners = list(self._epoch_listeners)
        for fn in listeners:
            # Listener RPCs (re-register, flush) re-enter _observe_epoch
            # with an unchanged epoch — no recursion.
            try:
                fn(prev, epoch)
            except Exception:  # noqa: BLE001 — listener bugs must not kill RPCs
                logger.warning(
                    "master-epoch listener %s failed", fn, exc_info=True
                )

    def _outage_begin(self, verb: str, err: Exception):
        if not self._in_outage:
            self._in_outage = True
            logger.warning(
                "master unreachable on %s (%s: %s); entering outage "
                "ride-through for up to %ss",
                verb,
                type(err).__name__,
                err,
                _outage_window_s(),
            )

    def _outage_end(self, recovered: bool):
        if self._in_outage:
            self._in_outage = False
            if recovered:
                logger.info("master reachable again; outage mode exited")

    def wait_master_ready(self, timeout: float = 120.0) -> bool:
        return self._stub.wait_ready(timeout)

    def close(self):
        self._stub.close()

    # ---- rendezvous --------------------------------------------------------

    @retry_rpc
    def join_rendezvous(
        self,
        node_rank: int,
        local_world_size: int,
        rdzv_name: str,
        node_unit: int = 1,
        node_ip: str = "",
        node_group: int = -1,
    ) -> int:
        resp = self._report(
            comm.JoinRendezvousRequest(
                node_id=self._node_id,
                node_rank=node_rank,
                local_world_size=local_world_size,
                rdzv_name=rdzv_name,
                node_unit=node_unit,
                node_ip=node_ip,
                node_group=node_group,
            )
        )
        return getattr(resp, "round", 0)

    @retry_rpc
    def get_comm_world(self, rdzv_name: str, node_rank: int):
        resp = self._get(
            comm.CommWorldRequest(node_id=node_rank, rdzv_name=rdzv_name)
        )
        rank_order = getattr(resp, "rank_order", None) or list(resp.world)
        node_groups = getattr(resp, "node_groups", None) or {}
        return resp.round, resp.group, resp.world, rank_order, node_groups

    @retry_rpc
    def num_nodes_waiting(self, rdzv_name: str) -> int:
        resp = self._get(comm.NumNodesWaitingRequest(rdzv_name=rdzv_name))
        return resp.waiting_num

    # ---- network check -----------------------------------------------------

    @retry_rpc
    def report_network_check_result(
        self, node_rank: int, succeeded: bool, elapsed: float
    ):
        return self._report(
            comm.NetworkCheckResultReport(
                node_id=self._node_id,
                node_rank=node_rank,
                succeeded=succeeded,
                result=elapsed,
            )
        )

    @retry_rpc
    def check_fault_node(self):
        """Returns (fault_nodes, evaluated_round, needs_round2)."""
        resp = self._get(comm.FaultNodeRequest())
        return resp.fault_nodes, resp.evaluated_round, resp.needs_round2

    @retry_rpc
    def check_straggler(self) -> List[int]:
        resp = self._get(comm.StragglerRequest())
        return resp.stragglers

    # ---- live rescale ------------------------------------------------------

    @retry_rpc
    def rescale_join(
        self,
        node_rank: int,
        local_world_size: int = 1,
        node_group: int = -1,
    ):
        """Announce this worker to the rescale plane (idempotent)."""
        return self._report(
            comm.RescaleJoinReport(
                node_id=self._node_id,
                node_rank=node_rank,
                local_world_size=local_world_size,
                node_group=node_group,
            )
        )

    @retry_rpc
    def get_rescale_plan(self, node_rank: int, current_plan_id: int = -1):
        """Latest rescale plan newer than ``current_plan_id``, or None.
        Returns the raw RescalePlanResponse (plan_id == -1 -> no plan)."""
        resp = self._get(
            comm.RescalePlanRequest(
                node_id=self._node_id,
                node_rank=node_rank,
                current_plan_id=current_plan_id,
            )
        )
        if getattr(resp, "plan_id", -1) < 0:
            return None
        return resp

    @retry_rpc
    def report_rescale_ack(
        self, node_rank: int, plan_id: int, phase: str
    ):
        # Idempotent master-side (set add), so the retry wrapper is safe.
        return self._report(
            comm.RescaleAckReport(
                node_id=self._node_id,
                node_rank=node_rank,
                plan_id=plan_id,
                phase=phase,
            )
        )

    @retry_rpc
    def get_rescale_barrier(
        self, node_rank: int, plan_id: int, phase: str
    ):
        """(ready, expired, superseded, missing) of a plan's phase."""
        resp = self._get(
            comm.RescaleBarrierRequest(
                node_id=self._node_id,
                node_rank=node_rank,
                plan_id=plan_id,
                phase=phase,
            )
        )
        return (
            getattr(resp, "ready", False),
            getattr(resp, "expired", False),
            getattr(resp, "superseded", False),
            getattr(resp, "missing", []),
        )

    # ---- heartbeat / events ------------------------------------------------

    def report_heartbeat(self, timestamp: Optional[float] = None):
        resp = self._report(
            comm.HeartbeatReport(
                node_id=self._node_id, timestamp=timestamp or time.time()
            ),
        )
        return getattr(resp, "actions", [])

    @retry_rpc
    def report_failure(
        self,
        error_data: str,
        node_rank: int = 0,
        restart_count: int = 0,
        exit_code: int = 0,
        level: str = "process",
    ):
        return self._report(
            comm.NodeFailureReport(
                node_id=self._node_id,
                node_rank=node_rank,
                error_data=error_data,
                restart_count=restart_count,
                exit_code=exit_code,
                level=level,
            )
        )

    @retry_rpc
    def report_succeeded(self):
        return self._report(
            comm.SucceededRequest(
                node_id=self._node_id, node_type=self._node_type
            )
        )

    @retry_rpc
    def report_node_event(self, event_type: str, reason: str = "", message: str = ""):
        return self._report(
            comm.NodeEventReport(
                node_id=self._node_id,
                event_type=event_type,
                reason=reason,
                message=message,
            )
        )

    def report_diagnosis_data(self, data_type: str, payload: Dict):
        try:
            return self._report(
                comm.DiagnosisDataReport(
                    node_id=self._node_id,
                    data_type=data_type,
                    payload=payload,
                    timestamp=time.time(),
                )
            )
        except Exception:
            logger.debug("diagnosis data report failed", exc_info=True)

    # ---- perf / resources --------------------------------------------------

    def report_used_resource(
        self, cpu_percent: float, memory_mb: float, tpu_duty: float = 0.0,
        hbm_used_mb: float = 0.0,
    ):
        try:
            return self._report(
                comm.ResourceStats(
                    node_id=self._node_id,
                    cpu_percent=cpu_percent,
                    memory_mb=memory_mb,
                    tpu_duty_cycle=tpu_duty,
                    hbm_used_mb=hbm_used_mb,
                )
            )
        except Exception:
            logger.debug("resource report failed", exc_info=True)

    def report_global_step(
        self,
        step: int,
        elapsed_train_secs: float = 0.0,
        step_time_s: float = 0.0,
    ):
        try:
            return self._report(
                comm.GlobalStepReport(
                    node_id=self._node_id,
                    step=step,
                    timestamp=time.time(),
                    elapsed_train_secs=elapsed_train_secs,
                    step_time_s=step_time_s,
                )
            )
        except Exception:
            logger.debug("global step report failed", exc_info=True)

    def report_trace_spans(self, max_n: int = 256):
        """Push this process's finished spans to the master's trace
        aggregator, piggybacked on the existing diagnosis-data verb.
        Best-effort and disarmed-free: one tracer check, nothing else."""
        tracer = tracing.active_tracer()
        if tracer is None:
            return
        spans = tracer.drain_exports(max_n)
        if not spans:
            return
        from dlrover_tpu_torch.diagnosis.diagnosis_data import DiagnosisDataType

        self.report_diagnosis_data(
            DiagnosisDataType.TRACE_SPANS, {"spans": spans}
        )

    def report_goodput_phase(self, phase: str, start: float, end: float):
        try:
            return self._report(
                comm.GoodputPhaseReport(
                    node_id=self._node_id, phase=phase, start=start, end=end
                )
            )
        except Exception:
            logger.debug("goodput phase report failed", exc_info=True)

    # ---- kv store ----------------------------------------------------------

    @retry_rpc
    def kv_store_set(self, key: str, value: bytes):
        return self._report(comm.KVStoreSetRequest(key=key, value=value))

    @retry_rpc
    def kv_store_get(self, key: str) -> bytes:
        resp = self._get(comm.KVStoreGetRequest(key=key))
        return resp.value

    def kv_store_add(self, key: str, delta: int = 1) -> int:
        # Deliberately NOT retried: add is a non-idempotent mutation and a
        # lost response must not double-apply the increment. Callers that
        # need at-least-once semantics should use kv_store_set with a
        # caller-chosen unique key instead.
        resp = self._get(comm.KVStoreAddRequest(key=key, delta=delta))
        return resp.value

    @retry_rpc
    def kv_store_multi_get(self, keys: List[str]) -> Dict[str, bytes]:
        resp = self._get(comm.KVStoreMultiGetRequest(keys=keys))
        return resp.values

    # ---- sync --------------------------------------------------------------

    @retry_rpc
    def join_sync(self, sync_name: str, node_rank: int):
        return self._report(
            comm.SyncJoinRequest(
                sync_name=sync_name, node_id=self._node_id, node_rank=node_rank
            )
        )

    @retry_rpc
    def sync_finished(self, sync_name: str):
        return self._report(comm.SyncFinishRequest(sync_name=sync_name))

    @retry_rpc
    def sync_barrier(self, sync_name: str) -> bool:
        resp = self._get(comm.SyncQueryRequest(sync_name=sync_name))
        return resp.done

    # ---- data sharding -----------------------------------------------------

    @retry_rpc
    def report_dataset_shard_params(self, params: comm.DatasetShardParams):
        return self._report(params)

    @retry_rpc
    def get_task(self, dataset_name: str) -> comm.ShardTask:
        return self._get(
            comm.TaskRequest(dataset_name=dataset_name, node_id=self._node_id)
        )

    @retry_rpc
    def get_tasks(self, dataset_name: str, count: int = 1):
        """Batched lease fetch: (tasks, wait). ``wait`` means peers hold
        the remaining shards in flight — poll again later. Falls back to
        a single :meth:`get_task` against masters that predate the
        batched verb (their servicer answers with a failed
        BaseResponse, not a MultiTaskResponse)."""
        resp = self._get(
            comm.MultiTaskRequest(
                dataset_name=dataset_name,
                node_id=self._node_id,
                count=count,
            )
        )
        tasks = getattr(resp, "tasks", None)
        if tasks is None:
            task = self.get_task(dataset_name)
            if task.task_id < 0:
                from dlrover_tpu_torch.common.constants import TaskType

                return [], task.task_type == TaskType.WAIT
            return [task], False
        return tasks, bool(getattr(resp, "wait", False))

    @retry_rpc
    def report_task_done(
        self, dataset_name: str, task_id: int, success: bool = True
    ):
        return self._report(
            comm.TaskDoneReport(
                dataset_name=dataset_name,
                task_id=task_id,
                node_id=self._node_id,
                success=success,
            )
        )

    @retry_rpc
    def report_tasks_done_batch(
        self,
        dataset_name: str,
        done_ids: List[int],
        failed_ids: Optional[List[int]] = None,
    ):
        resp = self._report(
            comm.TaskDoneBatchReport(
                dataset_name=dataset_name,
                node_id=self._node_id,
                done_ids=list(done_ids),
                failed_ids=list(failed_ids or []),
            )
        )
        if not resp.success:
            # Master predates the batched verb: replay serially so no
            # done-report is silently dropped.
            for tid in done_ids:
                self.report_task_done(dataset_name, tid, True)
            for tid in failed_ids or []:
                self.report_task_done(dataset_name, tid, False)
        return resp

    @retry_rpc
    def get_shard_checkpoint(self, dataset_name: str) -> str:
        resp = self._get(comm.ShardCheckpointRequest(dataset_name=dataset_name))
        return resp.checkpoint

    @retry_rpc
    def restore_shard_checkpoint(self, dataset_name: str, checkpoint: str):
        return self._report(
            comm.ShardCheckpointRestoreRequest(
                dataset_name=dataset_name, checkpoint=checkpoint
            )
        )

    # ---- checkpoint --------------------------------------------------------

    @retry_rpc
    def report_ckpt_step(self, step: int, committed: bool = False):
        return self._report(
            comm.CkptStepReport(
                node_id=self._node_id, step=step, committed=committed
            )
        )

    @retry_rpc
    def get_ckpt_latest_step(self) -> int:
        resp = self._get(comm.CkptLatestStepRequest())
        return resp.step

    # ---- pre-check / config ------------------------------------------------

    @retry_rpc
    def get_pre_check_result(self) -> str:
        resp = self._get(comm.PreCheckRequest(node_id=self._node_id))
        return resp.status

    @retry_rpc
    def get_elastic_run_config(self) -> Dict[str, str]:
        resp = self._get(comm.ElasticRunConfigRequest())
        return resp.configs

    @retry_rpc
    def get_parallel_config(self) -> comm.ParallelConfig:
        return self._get(comm.ParallelConfigRequest(node_id=self._node_id))

    @retry_rpc
    def get_job_detail(self) -> comm.JobDetailResponse:
        return self._get(comm.JobDetailRequest())

    # ---- cluster version (PS parity) ---------------------------------------

    @retry_rpc
    def get_cluster_version(self, version_type: str, task_type: str, task_id: int):
        resp = self._get(
            comm.ClusterVersionRequest(
                task_type=task_type, task_id=task_id, version_type=version_type
            )
        )
        return resp.version

    @retry_rpc
    def update_cluster_version(
        self, version_type: str, version: int, task_type: str, task_id: int
    ):
        return self._report(
            comm.ClusterVersionReport(
                task_type=task_type,
                task_id=task_id,
                version_type=version_type,
                version=version,
            )
        )

    # ---- singleton ---------------------------------------------------------

    @classmethod
    def singleton_instance(cls, *args, **kwargs) -> "MasterClient":
        with cls._lock:
            if cls._instance is None:
                if not args and "master_addr" not in kwargs:
                    addr = os.getenv(NodeEnv.MASTER_ADDR, "")
                    if not addr:
                        raise RuntimeError(
                            f"{NodeEnv.MASTER_ADDR} unset and no addr given"
                        )
                    node_id = int(os.getenv(NodeEnv.NODE_ID, 0))
                    cls._instance = cls(addr, node_id=node_id)
                else:
                    cls._instance = cls(*args, **kwargs)
            return cls._instance

    @classmethod
    def reset_singleton(cls):
        with cls._lock:
            cls._instance = None
