"""Periodic diagnostician scheduler.

Parity: reference dlrover/python/diagnosis/common/diagnosis_manager.py:226
— registers diagnosticians, runs each at its own cadence on one thread,
and enqueues non-trivial actions into the JobContext for the master
diagnose loop / agent heartbeats to consume.

The port's copy of ``dlrover_tpu/diagnosis/diagnosis_manager.py``.
"""

import threading
import time
from typing import Dict, List

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.diagnosis.diagnostician import Diagnostician
from dlrover_tpu_torch.master.node.job_context import get_job_context


class DiagnosisManager:
    def __init__(self, tick_s: float = 1.0):
        self._diagnosticians: List[Diagnostician] = []
        self._next_run: Dict[str, float] = {}
        self._tick_s = tick_s
        self._stopped = threading.Event()
        self._thread = None

    def register(self, diagnostician: Diagnostician):
        self._diagnosticians.append(diagnostician)
        self._next_run[diagnostician.name] = 0.0

    def start(self):
        self._stopped.clear()
        self._thread = threading.Thread(
            target=self._run, name="diagnosis-manager", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def diagnose_once(self):
        """Run every diagnostician immediately (testing / pre-stop sweep)."""
        for d in self._diagnosticians:
            self._dispatch(d)

    def _run(self):
        while not self._stopped.is_set():
            time.sleep(self._tick_s)
            now = time.time()
            for d in self._diagnosticians:
                if now >= self._next_run[d.name]:
                    self._next_run[d.name] = now + d.observe_interval_s
                    self._dispatch(d)

    def _dispatch(self, diagnostician: Diagnostician):
        action = diagnostician.diagnose()
        if action.is_needed():
            logger.info(
                "diagnosis action from %s: %s (%s)",
                diagnostician.name,
                action.action_type,
                action.reason,
            )
            get_job_context().enqueue_action(action)
