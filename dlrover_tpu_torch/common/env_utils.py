"""Environment-variable helpers for the master/agent/worker protocol
(the port's copy of ``dlrover_tpu/common/env_utils.py``)."""

import os
import socket

from dlrover_tpu_torch.common.constants import NodeEnv, WorkerEnv


def get_env_int(name: str, default: int = 0) -> int:
    try:
        return int(os.getenv(name, default))
    except (TypeError, ValueError):
        return default


TRUTHY = ("1", "true", "yes", "on")


def env_bool(mapping, name: str, default: bool = False) -> bool:
    """Truthy test over any mapping (os.environ or a merged env dict) —
    the ONE definition of the vocabulary; hand-rolled tuples drift."""
    value = mapping.get(name, "")
    if not value:
        return default
    return value.strip().lower() in TRUTHY


def get_env_bool(name: str, default: bool = False) -> bool:
    return env_bool(os.environ, name, default)


_WARNED_CHOICES: set = set()


def resolve_env_choice(name: str, allowed, default: str) -> str:
    """Env knob constrained to ``allowed`` values, warning ONCE per
    unrecognized value and falling back to ``default`` — a typo in a
    kernel A/B knob must be LOUD, or the experiment silently measures
    the wrong path. The one definition of the pattern (kv dtype, MoE
    dispatch, decode attention all use it)."""
    raw = os.environ.get(name, default).lower()
    if raw in allowed:
        return raw
    if (name, raw) not in _WARNED_CHOICES:
        _WARNED_CHOICES.add((name, raw))
        from dlrover_tpu_torch.common.log import logger

        logger.warning(
            "%s=%r is not one of %s; falling back to %r",
            name, raw, tuple(allowed), default,
        )
    return default


def get_env_str(name: str, default: str = "") -> str:
    return os.getenv(name, default)


def get_node_id() -> int:
    return get_env_int(NodeEnv.NODE_ID, 0)


def get_node_rank() -> int:
    return get_env_int(NodeEnv.NODE_RANK, get_node_id())


def get_node_num() -> int:
    return get_env_int(NodeEnv.NODE_NUM, 1)


def get_master_addr() -> str:
    return get_env_str(NodeEnv.MASTER_ADDR, "")


def get_hostname_ip():
    hostname = socket.gethostname()
    try:
        ip = socket.gethostbyname(hostname)
    except socket.gaierror:
        ip = "127.0.0.1"
    return hostname, ip


def find_free_port(start: int = 0) -> int:
    """Ask the OS for a free TCP port (bind to 0) or probe from ``start``."""
    if start == 0:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("", 0))
            return s.getsockname()[1]
    for port in range(start, start + 1000):
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("", port))
                return port
            except OSError:
                continue
    raise RuntimeError("no free port found")


def worker_env(
    coordinator: str,
    num_processes: int,
    process_id: int,
    local_rank: int = 0,
    local_world_size: int = 1,
    restart_count: int = 0,
    rdzv_round: int = 0,
    node_ranks=None,
    num_slices: int = 1,
) -> dict:
    """Build the env block the agent injects into each worker."""
    env = {
        WorkerEnv.COORDINATOR_ADDRESS: coordinator,
        WorkerEnv.NUM_PROCESSES: str(num_processes),
        WorkerEnv.PROCESS_ID: str(process_id),
        WorkerEnv.LOCAL_RANK: str(local_rank),
        WorkerEnv.LOCAL_WORLD_SIZE: str(local_world_size),
        WorkerEnv.RESTART_COUNT: str(restart_count),
        WorkerEnv.RDZV_ROUND: str(rdzv_round),
        WorkerEnv.NUM_SLICES: str(num_slices),
    }
    if node_ranks:
        env[WorkerEnv.NODE_RANKS] = ",".join(str(r) for r in node_ranks)
    return env
