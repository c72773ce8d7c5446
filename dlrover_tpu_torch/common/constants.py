"""Shared constants of the control plane and the worker path (the
port's copy of ``dlrover_tpu/common/constants.py``). The names and
values are the reference's, so an agent that drives the JAX package's
workers drives the port's the same way, and the two packages' masters
answer in the same vocabulary."""


class NodeType:
    """Roles a node (one TPU host / one process group member) can play."""

    WORKER = "worker"
    MASTER = "master"
    # Parameter-server era roles kept for API parity with PS-style jobs
    # (reference common/constants.py NodeType); unused in pure SPMD jobs.
    PS = "ps"
    CHIEF = "chief"
    EVALUATOR = "evaluator"


class NodeStatus:
    """Lifecycle states of a supervised node.

    Mirrors the legal-transition vocabulary of the reference
    (master/node/status_flow.py) with k8s Pod phases generalized to
    "scheduled process units".
    """

    INITIAL = "Initial"
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    DELETED = "Deleted"
    BREAKDOWN = "Breakdown"  # machine-level fault (node check failed)
    UNKNOWN = "Unknown"

    @classmethod
    def end_states(cls):
        return {cls.SUCCEEDED, cls.FAILED, cls.DELETED, cls.BREAKDOWN}


class NodeEventType:
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"
    # Health-related event types surfaced by diagnosis.
    NODE_CHECK_FAILED = "NODE_CHECK_FAILED"
    STRAGGLER = "STRAGGLER"


class NodeExitReason:
    """Why a worker process/pod exited; drives relaunch policy
    (reference master/node/dist_job_manager.py:_should_relaunch)."""

    SUCCEEDED = "Succeeded"
    KILLED = "Killed"
    OOM = "OOMKilled"
    FATAL_ERROR = "FatalError"  # unrecoverable: never relaunch
    SOFTWARE_ERROR = "SoftwareError"  # app crash: bounded relaunch
    HARDWARE_ERROR = "HardwareError"  # relaunch on a new machine
    PREEMPTED = "Preempted"  # cloud preemption: always relaunch
    UNKNOWN = "Unknown"


# Relaunch budget per exit reason, as a multiple of a node's
# max_relaunch_count (reference dist_job_manager.py:996 differentiates
# reasons when deciding relaunch; the factors bound each failure mode
# separately so a preemption storm can't be starved by one OOM and a
# crash loop can't relaunch forever).
# Worker-log markers shared by the agent's failure diagnosis and the
# master's exit classifier — one source so the two sides never disagree.
# OOM covers host RAM (MemoryError, oom-killer) and device HBM (XLA
# RESOURCE_EXHAUSTED); hardware covers TPU/runtime init faults.
OOM_LOG_MARKERS = (
    r"resource_exhausted",
    r"out of memory",
    r"memoryerror",
    r"oom[- _]?kill",
    r"hbm.*exceed",
)
HARDWARE_LOG_MARKERS = (
    r"tpu.*(unavailable|unhealthy|not found)",
    r"libtpu.*(fail|error)",
    r"pjrt.*init.*fail",
    r"device or resource busy",
    r"uncorrectable ecc",
)

RELAUNCH_BUDGET_FACTOR = {
    NodeExitReason.PREEMPTED: 10.0,
    NodeExitReason.KILLED: 2.0,
    NodeExitReason.OOM: 1.0,
    NodeExitReason.HARDWARE_ERROR: 1.0,
    NodeExitReason.SOFTWARE_ERROR: 1.0,
    NodeExitReason.UNKNOWN: 1.0,
    NodeExitReason.FATAL_ERROR: 0.0,
}


class ExitCode:
    """Process exit codes with special relaunch semantics."""

    SUCCESS = 0
    KILLED = 137  # 128 + SIGKILL
    TERMED = 143  # 128 + SIGTERM
    FATAL = 1
    SCRIPT_ERROR = 2
    # Agent-chosen codes:
    NODE_CHECK_FAILED = 3
    GPU_DRIVER_ERROR = 201
    HARDWARE_ERROR = 202


class JobStage:
    INIT = "INIT"
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUSPENDED = "SUSPENDED"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPING = "STOPPING"


class JobExitReason:
    SUCCEEDED = "Succeeded"
    CODE_ERROR = "CodeError"
    WORKER_OOM = "WorkerOOM"
    WORKER_ERROR = "WorkerError"
    HANG_ERROR = "HangError"
    UNKNOWN = "Unknown"


class RendezvousName:
    """The two rendezvous domains (reference
    master/elastic_training/rdzv_manager.py)."""

    TRAINING = "training"
    NETWORK_CHECK = "network-check"


class RendezvousConstant:
    MAX_WAIT_SECS = 600
    PEND_TIMEOUT_SECS = 600
    JOIN_TIMEOUT_SECS = 600


class TrainingExceptionLevel:
    PROCESS_ERROR = "process"
    NODE_ERROR = "node"
    RDZV_ERROR = "rdzv"
    WARNING = "warning"
    INFO = "info"


class PlatformType:
    LOCAL = "local"
    KUBERNETES = "k8s"
    RAY = "ray"
    GKE_TPU = "gke_tpu"


class CommunicationType:
    COMM_SERVICE_GRPC = "grpc"
    COMM_SERVICE_HTTP = "http"


class NodeEnv:
    """Environment variables of the control-plane protocol between master,
    agent and worker processes (reference common/constants.py NodeEnv)."""

    MASTER_ADDR = "DLROVER_TPU_MASTER_ADDR"
    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    NODE_ID = "DLROVER_TPU_NODE_ID"
    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    NODE_NUM = "DLROVER_TPU_NODE_NUM"
    JOB_UUID = "DLROVER_TPU_JOB_UUID"
    # Flag telling the worker process which UDS root dir the agent shared
    # objects (queues/locks/shm metadata) live under.
    SHARED_DIR = "DLROVER_TPU_SHARED_DIR"
    # Restart bookkeeping
    RESTART_COUNT = "DLROVER_TPU_RESTART_COUNT"
    # Monitoring switch
    MONITOR_ENABLED = "DLROVER_TPU_MONITOR_ENABLED"
    AUTO_CKPT = "DLROVER_TPU_AUTO_CKPT"


class WorkerEnv:
    """Env vars injected into each JAX worker process by the agent.

    These replace torchrun's WORLD_SIZE/RANK vocabulary with the triple
    ``jax.distributed.initialize`` needs, plus local process coords.
    """

    COORDINATOR_ADDRESS = "DLROVER_TPU_COORDINATOR"
    NUM_PROCESSES = "DLROVER_TPU_NUM_PROCESSES"
    PROCESS_ID = "DLROVER_TPU_PROCESS_ID"
    LOCAL_RANK = "DLROVER_TPU_LOCAL_RANK"
    LOCAL_WORLD_SIZE = "DLROVER_TPU_LOCAL_WORLD_SIZE"
    RESTART_COUNT = "DLROVER_TPU_RESTART_COUNT"
    RDZV_ROUND = "DLROVER_TPU_RDZV_ROUND"
    # Comma-separated node ranks of the current world (commit protocol
    # needs the ACTUAL membership, not arithmetic over process counts).
    NODE_RANKS = "DLROVER_TPU_NODE_RANKS"
    # Node groups (TPU slices) in the world: with the group-major rank
    # order, a dcn mesh axis of this size maps one group per slice row —
    # what a worker needs to build a multi-slice mesh.
    NUM_SLICES = "DLROVER_TPU_NUM_SLICES"


class JobConstant:
    RDZV_JOIN_TIMEOUT_DEFAULT = 600
    MASTER_CLIENT_TIMEOUT_DEFAULT = 10
    MASTER_CLIENT_DEFAULT_RETRY = 3
    TRAINING_AGENT_LOOP_INTERVAL = 2
    MASTER_RUN_LOOP_INTERVAL = 5
    NODE_HEARTBEAT_INTERVAL = 15
    HEARTBEAT_TIMEOUT_SECS = 600
    # Interval the perf monitor uses to compute throughput
    PERF_SAMPLE_INTERVAL = 10


class CheckpointConstant:
    """Flash checkpoint naming (reference
    dlrover/python/common/constants.py CheckpointConstant)."""

    TRACKER_FILE = "latest_checkpointed_iteration.txt"
    STEP_DIR_PREFIX = "checkpoint-"
    DONE_DIR = "._dlrover_ckpt_done"
    STAGE_DIR = "._dlrover_ckpt_stage"
    MODEL_STATES_NAME = "model_states"
    SAVE_TIMEOUT = 600
    # KV-store key under which the master publishes the per-job replica
    # auth token (seeded in servicer, consumed by flash_ckpt/replica.py).
    REPLICA_TOKEN_KEY = "ckpt-replica/token"


class NetworkCheckConstant:
    MATMUL_SIZE = 1024  # per-chip MXU probe GEMM dimension
    MATMUL_ROUNDS = 30
    ALLREDUCE_MB = 64
    STRAGGLER_RATIO = 2.0  # slower than 2x median => straggler
    CHECK_TIMEOUT = 300


class PreCheckStatus:
    CHECKING = "CHECKING"
    PASS = "PASS"
    FAIL = "FAIL"
    DISABLED = "DISABLED"


class DiagnosisConstant:
    MASTER_INSTANCE = -1
    ANY_INSTANCE = -2
    ACTION_EXPIRED_SECS = 600
    MASTER_OBSERVE_INTERVAL = 60
    AGENT_PERIODICAL_REPORT_INTERVAL = 60


class DiagnosisActionType:
    NONE = "no_action"
    EVENT = "event"
    RESTART_WORKER = "restart_worker"  # soft: restart processes in place
    RELAUNCH_WORKER = "relaunch_worker"  # hard: replace the node
    JOB_RESTART = "job_restart"
    JOB_ABORT = "job_abort"


class TaskType:
    """Dynamic data sharding task types (reference master/shard)."""

    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"
    WAIT = "wait"
    NONE = "none"


class DatasetType:
    TEXT = "text"
    TABLE = "table"


class GoodputPhase:
    """Phases used by the perf monitor to attribute wall time."""

    INIT = "init"
    TRAIN = "train"
    CKPT = "ckpt"
    RESTART = "restart"
    RENDEZVOUS = "rendezvous"


class EventReportConstants:
    TYPE_INFO = "info"
    TYPE_WARN = "warn"
    TYPE_ERROR = "error"
    ACTION_STOP = "stop"
    ACTION_START = "start"
