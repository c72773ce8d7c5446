"""Control-plane message vocabulary.

The master<->agent protocol is two RPCs — ``get(request) -> response`` and
``report(request) -> ack`` — carrying typed dataclasses (reference:
dlrover/python/proto/elastic_training.proto:26-29 and
dlrover/python/common/comm.py:105-560). Dataclasses here are re-designed
around JAX's coordination model: rendezvous produces the
(coordinator_address, num_processes, process_id) triple plus a mesh-shape
hint instead of a torch process-group world.

The port's copy of ``dlrover_tpu/common/comm.py``.
"""

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.common.serialize import PickleSerializable


@dataclass
class Message(PickleSerializable):
    """Envelope for both directions of the get/report protocol."""

    node_id: int = -1
    node_type: str = ""
    data: bytes = b""
    # Distributed-trace context ({"trace_id", "span_id"}) stamped by the
    # client when tracing is armed, so the servicer's server span joins
    # the caller's tree (docs/DESIGN.md §29). None when disarmed — and
    # readers use getattr(): envelopes pickled by older builds carry no
    # attribute at all.
    trace: Optional[Dict[str, str]] = None


@dataclass
class BaseRequest(PickleSerializable):
    pass


@dataclass
class BaseResponse(PickleSerializable):
    success: bool = True
    reason: str = ""
    # Monotone incarnation of the master that produced this response,
    # stamped by the servicer when a durable journal is armed (-1 = no
    # journal / pre-journal build). Workers fence on a CHANGE in this
    # value to detect a restarted master and re-register/flush
    # (docs/DESIGN.md §37). Readers use getattr(): responses pickled by
    # older builds carry no attribute at all.
    master_epoch: int = -1


# --------------------------------------------------------------------------
# Rendezvous
# --------------------------------------------------------------------------


@dataclass
class JoinRendezvousRequest(BaseRequest):
    node_id: int = 0
    node_rank: int = 0
    local_world_size: int = 1  # JAX processes per host (usually 1 on TPU)
    rdzv_name: str = ""
    node_unit: int = 1  # hosts per slice: node count must be a multiple
    node_ip: str = ""
    # TPU slice/block index of this host (-1 = ungrouped). Drives
    # complete-group rendezvous, group-aware network check phases, and
    # group-level relaunch.
    node_group: int = -1


@dataclass
class JoinRendezvousResponse(BaseResponse):
    round: int = 0


@dataclass
class CommWorldRequest(BaseRequest):
    node_id: int = 0
    rdzv_name: str = ""


@dataclass
class CommWorld(BaseResponse):
    """A completed rendezvous round.

    ``world`` maps node_rank -> local_world_size for every participant;
    ``group`` partitions nodes during network check (reference
    rdzv_manager.py:_get_comm_world). The agent derives
    ``jax.distributed.initialize`` args from it.
    """

    round: int = 0
    group: int = 0
    world: Dict[int, int] = field(default_factory=dict)
    coordinator_rank: int = -1  # node chosen to host the JAX coordinator
    # Explicit rank ordering (master's topology-aware choice). Process-id
    # assignment MUST follow this list, not the world dict's insertion
    # order — dict order surviving the transport is an artifact of the
    # pickle wire format, and a future proto/JSON transport would
    # silently desynchronize ranks across nodes without this field.
    rank_order: List[int] = field(default_factory=list)
    # node_rank -> slice/node-group id (-1 = ungrouped). Lets workers
    # size the dcn mesh axis even when groups came from explicit
    # DLROVER_TPU_NODE_GROUP env rather than node_unit arithmetic.
    node_groups: Dict[int, int] = field(default_factory=dict)


@dataclass
class RendezvousState(BaseResponse):
    waiting_num: int = 0
    completed: bool = False
    round: int = 0


@dataclass
class NumNodesWaitingRequest(BaseRequest):
    rdzv_name: str = ""


@dataclass
class NumNodesWaitingResponse(BaseResponse):
    waiting_num: int = 0


# --------------------------------------------------------------------------
# Node / network check
# --------------------------------------------------------------------------


@dataclass
class NetworkReadyRequest(BaseRequest):
    pass


@dataclass
class NetworkCheckResultReport(BaseRequest):
    node_id: int = 0
    node_rank: int = 0
    result: float = 0.0  # elapsed seconds of the probe; inf on failure
    succeeded: bool = True


@dataclass
class FaultNodeRequest(BaseRequest):
    pass


@dataclass
class FaultNodeResponse(BaseResponse):
    # Verdict of the last fully-reported check round; -1 while none has
    # concluded (an empty fault list is only meaningful when
    # evaluated_round >= 0). needs_round2 tells agents a suspect-bisection
    # round is pending and they should rejoin the check rendezvous.
    fault_nodes: List[int] = field(default_factory=list)
    evaluated_round: int = -1
    needs_round2: bool = False


@dataclass
class StragglerRequest(BaseRequest):
    pass


@dataclass
class StragglerResponse(BaseResponse):
    stragglers: List[int] = field(default_factory=list)


# --------------------------------------------------------------------------
# Heartbeat & diagnosis
# --------------------------------------------------------------------------


@dataclass
class HeartbeatReport(BaseRequest):
    node_id: int = 0
    timestamp: float = 0.0


@dataclass
class HeartbeatResponse(BaseResponse):
    # Serialized DiagnosisAction instances for the agent to execute.
    actions: List[Any] = field(default_factory=list)


@dataclass
class DiagnosisDataReport(BaseRequest):
    """Generic diagnosis payload (metrics scrape, log tail, chip events)."""

    node_id: int = 0
    data_type: str = ""
    payload: Dict[str, Any] = field(default_factory=dict)
    timestamp: float = 0.0


@dataclass
class NodeFailureReport(BaseRequest):
    node_id: int = 0
    node_rank: int = 0
    error_data: str = ""
    level: str = ""
    restart_count: int = 0
    exit_code: int = 0


@dataclass
class SucceededRequest(BaseRequest):
    node_id: int = 0
    node_type: str = ""


@dataclass
class NodeEventReport(BaseRequest):
    node_id: int = 0
    event_type: str = ""
    reason: str = ""
    message: str = ""


# --------------------------------------------------------------------------
# Resources & performance
# --------------------------------------------------------------------------


@dataclass
class ResourceStats(BaseRequest):
    node_id: int = 0
    cpu_percent: float = 0.0
    memory_mb: float = 0.0
    tpu_duty_cycle: float = 0.0  # chip busy-%
    hbm_used_mb: float = 0.0


@dataclass
class GlobalStepReport(BaseRequest):
    node_id: int = 0
    step: int = 0
    timestamp: float = 0.0
    elapsed_train_secs: float = 0.0  # productive train time since last report
    # This rank's recent per-step wall seconds (0 = not measured): the
    # master's straggler score is per-rank step-time skew, and this
    # piggyback keeps it one existing RPC, not a new verb.
    step_time_s: float = 0.0


@dataclass
class GoodputPhaseReport(BaseRequest):
    """Attributes a span of wall time to a goodput phase (train/ckpt/
    restart/rendezvous), the basis of the goodput metric."""

    node_id: int = 0
    phase: str = ""
    start: float = 0.0
    end: float = 0.0


# --------------------------------------------------------------------------
# KV-store (rendezvous store / barriers for workers)
# --------------------------------------------------------------------------


@dataclass
class KVStoreSetRequest(BaseRequest):
    key: str = ""
    value: bytes = b""


@dataclass
class KVStoreGetRequest(BaseRequest):
    key: str = ""


@dataclass
class KVStoreGetResponse(BaseResponse):
    value: bytes = b""


@dataclass
class KVStoreAddRequest(BaseRequest):
    key: str = ""
    delta: int = 1


@dataclass
class KVStoreAddResponse(BaseResponse):
    value: int = 0


@dataclass
class KVStoreMultiGetRequest(BaseRequest):
    keys: List[str] = field(default_factory=list)


@dataclass
class KVStoreMultiGetResponse(BaseResponse):
    values: Dict[str, bytes] = field(default_factory=dict)


# --------------------------------------------------------------------------
# Sync service (named barriers)
# --------------------------------------------------------------------------


@dataclass
class SyncJoinRequest(BaseRequest):
    sync_name: str = ""
    node_id: int = 0
    node_rank: int = 0


@dataclass
class SyncFinishRequest(BaseRequest):
    sync_name: str = ""


@dataclass
class SyncQueryRequest(BaseRequest):
    sync_name: str = ""


@dataclass
class SyncQueryResponse(BaseResponse):
    done: bool = False


# --------------------------------------------------------------------------
# Dynamic data sharding
# --------------------------------------------------------------------------


@dataclass
class DatasetShardParams(BaseRequest):
    dataset_name: str = ""
    dataset_size: int = 0  # -1 with a streaming storage_type = unbounded
    shard_size: int = 0  # records per task/shard
    num_epochs: int = 1
    shuffle: bool = False
    storage_type: str = "text"  # "table" | "text" | "stream"
    task_type: str = "training"
    # Streaming sources (message queues / log stores) are partitioned;
    # shards carry the partition they were carved from.
    num_partitions: int = 1


@dataclass
class TaskRequest(BaseRequest):
    dataset_name: str = ""
    node_id: int = 0


@dataclass
class ShardTask(BaseResponse):
    task_id: int = -1
    task_type: str = "none"
    dataset_name: str = ""
    start: int = 0
    end: int = 0
    epoch: int = 0
    # Explicit (possibly shuffled) record indices for text datasets; None
    # means the contiguous [start, end) range.
    record_indices: Optional[List[int]] = None
    # Source partition of a streaming shard ([start, end) offsets are
    # per-partition for message-queue/log-store datasets).
    partition: int = 0


@dataclass
class TaskDoneReport(BaseRequest):
    dataset_name: str = ""
    task_id: int = -1
    node_id: int = 0
    # False re-queues the shard (streaming sources retry a failed shard
    # up to its retry budget before dropping it).
    success: bool = True


@dataclass
class MultiTaskRequest(BaseRequest):
    """Batched lease request: up to ``count`` shards in one round trip.

    The prefetcher's verb — a worker keeping N shards in flight pays one
    RPC per batch instead of one per shard boundary."""

    dataset_name: str = ""
    node_id: int = 0
    count: int = 1


@dataclass
class MultiTaskResponse(BaseResponse):
    """``tasks`` holds real shard leases only. An empty list with
    ``wait=True`` means peers hold the remaining shards in flight (the
    single-task WAIT sentinel, batched); empty with ``wait=False`` means
    the dataset is exhausted."""

    tasks: List["ShardTask"] = field(default_factory=list)
    wait: bool = False


@dataclass
class TaskDoneBatchReport(BaseRequest):
    """Coalesced done-reports: every shard id in ``done_ids`` completed
    successfully, every id in ``failed_ids`` must be re-queued."""

    dataset_name: str = ""
    node_id: int = 0
    done_ids: List[int] = field(default_factory=list)
    failed_ids: List[int] = field(default_factory=list)


@dataclass
class ShardCheckpointRequest(BaseRequest):
    dataset_name: str = ""


@dataclass
class ShardCheckpointResponse(BaseResponse):
    checkpoint: str = ""  # JSON blob of undone shards


@dataclass
class ShardCheckpointRestoreRequest(BaseRequest):
    dataset_name: str = ""
    checkpoint: str = ""


# --------------------------------------------------------------------------
# Live elastic rescale (plan broadcast + barrier; docs/DESIGN.md §27)
# --------------------------------------------------------------------------


@dataclass
class RescaleJoinReport(BaseRequest):
    """A worker announcing itself to the rescale plane — at process start
    (bootstrap / scale-up join) the coordinator folds it into the live
    set and, mid-run, a join triggers a scale-up plan."""

    node_id: int = 0
    node_rank: int = 0
    local_world_size: int = 1
    # TPU slice/block index (-1 = ungrouped) — lets the coordinator form
    # worlds from complete blocks only, like rendezvous does.
    node_group: int = -1


@dataclass
class RescalePlanRequest(BaseRequest):
    """Poll for a rescale plan newer than ``current_plan_id`` (-1 = any).
    Pull-based broadcast: the versioned plan is fetched, not pushed, so a
    dropped reply costs one poll interval, never a lost plan."""

    node_id: int = 0
    node_rank: int = 0
    current_plan_id: int = -1


@dataclass
class RescalePlanResponse(BaseResponse):
    """A versioned rescale plan. ``plan_id`` is -1 when no newer plan
    exists. ``world`` maps node_rank -> local_world_size for the NEW
    world; a polling rank absent from ``world`` has been evicted.
    ``restore_step`` is the last committed checkpoint step every
    survivor must restore (-1 = fresh/bootstrap)."""

    plan_id: int = -1
    world: Dict[int, int] = field(default_factory=dict)
    rank_order: List[int] = field(default_factory=list)
    restore_step: int = -1
    reason: str = ""
    created_at: float = 0.0
    barrier_timeout_s: float = 30.0


@dataclass
class RescaleAckReport(BaseRequest):
    """Worker progress through a plan's phases ("barrier": data path
    torn down, done-reports flushed; "restored": state + shard cursor
    restored at the plan step; "resumed": first post-rescale step about
    to run). Idempotent — safe under RPC retry."""

    node_id: int = 0
    node_rank: int = 0
    plan_id: int = -1
    phase: str = "barrier"


@dataclass
class RescaleBarrierRequest(BaseRequest):
    node_id: int = 0
    node_rank: int = 0
    plan_id: int = -1
    phase: str = "barrier"


@dataclass
class RescaleBarrierResponse(BaseResponse):
    """``ready``: every rank of the plan's world acked ``phase``.
    ``superseded``: a newer plan exists — abandon this barrier and poll
    the plan verb again. ``expired``: the bounded wait ran out; the
    coordinator has already re-planned around the missing ranks."""

    ready: bool = False
    expired: bool = False
    superseded: bool = False
    missing: List[int] = field(default_factory=list)


# --------------------------------------------------------------------------
# Checkpoint coordination
# --------------------------------------------------------------------------


@dataclass
class CkptStepReport(BaseRequest):
    node_id: int = 0
    step: int = 0
    committed: bool = False


@dataclass
class CkptLatestStepRequest(BaseRequest):
    pass


@dataclass
class CkptLatestStepResponse(BaseResponse):
    step: int = -1


# --------------------------------------------------------------------------
# Pre-check, config, job control
# --------------------------------------------------------------------------


@dataclass
class PreCheckRequest(BaseRequest):
    node_id: int = 0


@dataclass
class PreCheckResponse(BaseResponse):
    status: str = "PASS"


@dataclass
class ParallelConfigRequest(BaseRequest):
    node_id: int = 0


@dataclass
class ParallelConfig(BaseResponse):
    """Master-suggested runtime knobs (reference ParallelConfig /
    hyperparams/simple_strategy_generator.py), re-pointed at JAX knobs."""

    micro_batch_size: int = 0
    grad_accum_steps: int = 0
    remat_policy: str = ""
    mesh_shape: Dict[str, int] = field(default_factory=dict)
    version: int = 0


@dataclass
class ElasticRunConfigRequest(BaseRequest):
    pass


@dataclass
class ElasticRunConfigResponse(BaseResponse):
    configs: Dict[str, str] = field(default_factory=dict)


@dataclass
class JobDetailRequest(BaseRequest):
    pass


@dataclass
class JobDetailResponse(BaseResponse):
    job_name: str = ""
    stage: str = ""
    nodes: Dict[int, Dict[str, Any]] = field(default_factory=dict)


# --------------------------------------------------------------------------
# Cluster version tracking (PS-style elasticity parity; reference
# master/elastic_training/elastic_ps.py)
# --------------------------------------------------------------------------


@dataclass
class ClusterVersionRequest(BaseRequest):
    task_type: str = ""
    task_id: int = 0
    version_type: str = ""


@dataclass
class ClusterVersionResponse(BaseResponse):
    version: int = 0


@dataclass
class ClusterVersionReport(BaseRequest):
    task_type: str = ""
    task_id: int = 0
    version_type: str = ""
    version: int = 0


def now() -> float:
    return time.time()
