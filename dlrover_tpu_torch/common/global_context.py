"""Master-wide configuration singleton.

Parity: reference dlrover/python/common/global_context.py:89 (Context).

The port's copy of ``dlrover_tpu/common/global_context.py``, kept for
parity only: no module of the port reads this context, so its values and
the environment settings ``from_env`` reads change nothing the master
does.
"""

import os
import threading
from typing import Optional


class Context:
    _instance: Optional["Context"] = None
    _lock = threading.Lock()

    def __init__(self):
        # master loop / supervision
        self.master_port: int = 0
        self.job_name: str = "dlrover-tpu-job"
        self.master_run_interval: int = 5
        self.seconds_to_wait_failed_node: int = 120
        self.hb_timeout_secs: int = 600
        self.relaunch_always: bool = False
        self.max_relaunch_count: int = 3
        # rendezvous
        self.rdzv_join_timeout: int = 600
        self.rdzv_pend_timeout: int = 600
        self.min_nodes: int = 1
        self.max_nodes: int = 1
        self.node_unit: int = 1
        # network check
        self.network_check_enabled: bool = False
        self.straggler_ratio: float = 2.0
        # pre-check
        self.pre_check_enabled: bool = True
        self.pre_check_ops: list = []
        # diagnosis
        self.hang_detect_enabled: bool = True
        self.hang_downtime_secs: int = 1800
        # data sharding
        self.task_process_timeout: int = 1800
        # auto scaling
        self.auto_scaling_enabled: bool = False
        # reporting
        self.dashboard_enabled: bool = False

    @classmethod
    def singleton_instance(cls) -> "Context":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    def from_env(self):
        self.hang_downtime_secs = int(
            os.getenv("DLROVER_TPU_HANG_DOWNTIME", self.hang_downtime_secs)
        )
        self.network_check_enabled = os.getenv(
            "DLROVER_TPU_NETWORK_CHECK", ""
        ).lower() in ("1", "true")
        return self


def get_context() -> Context:
    return Context.singleton_instance()
