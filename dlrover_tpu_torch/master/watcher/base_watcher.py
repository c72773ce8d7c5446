"""Node watcher abstraction: observe the cluster backend as NodeEvents.

Parity: reference dlrover/python/master/watcher/base_watcher.py — the job
manager consumes ``watch()`` as a (blocking) event stream and calls
``list()`` on startup to reconcile pre-existing nodes.

The port's copy of ``dlrover_tpu/master/watcher/base_watcher.py``.
"""

import abc
from typing import Iterator, List

from dlrover_tpu_torch.common.node import Node, NodeEvent


class NodeWatcher(abc.ABC):
    def __init__(self, job_name: str):
        self._job_name = job_name

    @abc.abstractmethod
    def watch(self) -> Iterator[NodeEvent]:
        """Blocking stream of node change events; returns on stop()."""

    @abc.abstractmethod
    def list(self) -> List[Node]:
        """Snapshot of currently existing nodes of this job."""

    def stop(self):
        pass
