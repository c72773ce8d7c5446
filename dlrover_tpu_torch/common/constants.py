"""The environment names and checkpoint layout names the port reads (a
copy of the part of ``dlrover_tpu/common/constants.py`` the worker path
needs). The names are the reference's, so an agent that drives the JAX
package's workers drives the port's the same way."""


class NodeEnv:
    """Node-level variables the agent sets for its workers."""

    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    # The directory of the agent's UDS servers (queues, locks).
    SHARED_DIR = "DLROVER_TPU_SHARED_DIR"


class WorkerEnv:
    """Per-process variables the agent injects into each worker: the
    coordinator address, the world and this process's place in it."""

    COORDINATOR_ADDRESS = "DLROVER_TPU_COORDINATOR"
    NUM_PROCESSES = "DLROVER_TPU_NUM_PROCESSES"
    PROCESS_ID = "DLROVER_TPU_PROCESS_ID"
    LOCAL_RANK = "DLROVER_TPU_LOCAL_RANK"
    LOCAL_WORLD_SIZE = "DLROVER_TPU_LOCAL_WORLD_SIZE"
    RESTART_COUNT = "DLROVER_TPU_RESTART_COUNT"
    RDZV_ROUND = "DLROVER_TPU_RDZV_ROUND"
    # Comma-separated node ranks of the current world (the commit
    # protocol needs the actual membership).
    NODE_RANKS = "DLROVER_TPU_NODE_RANKS"
    NUM_SLICES = "DLROVER_TPU_NUM_SLICES"


class CheckpointConstant:
    """Flash checkpoint naming on storage."""

    TRACKER_FILE = "latest_checkpointed_iteration.txt"
    STEP_DIR_PREFIX = "checkpoint-"
    DONE_DIR = "._dlrover_ckpt_done"
