"""Cluster version tracking for PS-style elasticity.

Parity: reference master/elastic_training/elastic_ps.py (ElasticPsService).
On TPU this tracks "mesh generation" versions: each re-mesh bumps the global
version so stale workers can detect they belong to an old world.

The port's copy of ``dlrover_tpu/master/elastic_training/elastic_ps.py``.
"""

import threading
from typing import Dict


class ClusterVersionService:
    LOCAL = "local"
    GLOBAL = "global"
    RESTORED = "restored"

    def __init__(self):
        self._lock = threading.Lock()
        self._global_version = 0
        self._node_versions: Dict[str, Dict[int, Dict[str, int]]] = {}

    def get_global_version(self) -> int:
        with self._lock:
            return self._global_version

    def inc_global_version(self) -> int:
        with self._lock:
            self._global_version += 1
            return self._global_version

    def update_node_version(
        self, task_type: str, task_id: int, version_type: str, version: int
    ):
        with self._lock:
            self._node_versions.setdefault(task_type, {}).setdefault(
                task_id, {}
            )[version_type] = version

    def get_node_version(
        self, task_type: str, task_id: int, version_type: str
    ) -> int:
        with self._lock:
            return (
                self._node_versions.get(task_type, {})
                .get(task_id, {})
                .get(version_type, 0)
            )
