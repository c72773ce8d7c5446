"""Master-side diagnosis orchestration.

Parity: reference dlrover/python/master/diagnosis/diagnosis_master.py:326
(DiagnosisMaster) — runs configured PreCheckOperators before training
(gating agents via the pre-check RPC), then observes the running job via
the DiagnosisManager's registered diagnosticians, and stores per-node
diagnosis data reported by agents.

The port's copy of ``dlrover_tpu/master/diagnosis/diagnosis_master.py``.
"""

import threading
from collections import defaultdict, deque
from typing import Deque, Dict, List, Optional

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import PreCheckStatus
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.diagnosis.diagnosis_data import (
    DiagnosisData,
    DiagnosisDataType,
    build_diagnosis_data,
)
from dlrover_tpu_torch.diagnosis.diagnosis_manager import DiagnosisManager
from dlrover_tpu_torch.diagnosis.precheck import PreCheckOperator

_DATA_WINDOW = 256  # per-node ring of recent diagnosis reports


class DiagnosisMaster:
    def __init__(
        self,
        pre_check_operators: Optional[List[PreCheckOperator]] = None,
        manager: Optional[DiagnosisManager] = None,
    ):
        self._pre_check_operators = pre_check_operators or []
        self._manager = manager or DiagnosisManager()
        self._pre_check_status = (
            PreCheckStatus.CHECKING
            if self._pre_check_operators
            else PreCheckStatus.PASS
        )
        self._lock = threading.Lock()
        self._node_data: Dict[int, Deque[DiagnosisData]] = defaultdict(
            lambda: deque(maxlen=_DATA_WINDOW)
        )

    @property
    def manager(self) -> DiagnosisManager:
        return self._manager

    # ---- pre-check ---------------------------------------------------------

    def pre_check(self) -> bool:
        """Run all operators (each with its own retry loop); sets the
        status agents poll through the servicer."""
        for op in self._pre_check_operators:
            result = op.run_with_retries()
            if not result.passed:
                logger.error(
                    "pre-check %s failed: %s (nodes %s)",
                    op.name,
                    result.reason,
                    result.abnormal_nodes,
                )
                with self._lock:
                    self._pre_check_status = PreCheckStatus.FAIL
                return False
            logger.info("pre-check %s passed", op.name)
        with self._lock:
            self._pre_check_status = PreCheckStatus.PASS
        return True

    def get_pre_check_status(self) -> str:
        with self._lock:
            return self._pre_check_status

    # ---- runtime observation -----------------------------------------------

    def start_observing(self):
        self._manager.start()

    def stop_observing(self):
        self._manager.stop()

    # ---- agent-reported data ----------------------------------------------

    def collect_diagnosis_data(self, report: comm.DiagnosisDataReport):
        data = build_diagnosis_data(
            report.data_type,
            report.node_id,
            report.payload,
            report.timestamp,
        )
        if data is None:
            logger.warning(
                "unknown diagnosis data type %r dropped", report.data_type
            )
            return
        with self._lock:
            self._node_data[data.node_id].append(data)
        if data.data_type in (DiagnosisDataType.STACK_DUMP,
                              DiagnosisDataType.FLIGHT_RECORDER):
            # A dead or wedged worker's post-mortem: one line each, so
            # the master's log shows what reached it.
            payload = report.payload or {}
            logger.info(
                "received %s diagnosis data from node %d (pid %s, dumped "
                "at %s, reason %r, %d steps)", data.data_type,
                data.node_id, payload.get("pid"), payload.get("dumped_at"),
                payload.get("reason", ""), len(payload.get("steps", [])))
        elif data.data_type == DiagnosisDataType.XPU_TIMER_METRIC:
            # A tpu_timer collector's scrape (one a collector interval).
            metrics = (report.payload or {}).get("metrics") or {}
            logger.info(
                "received %s diagnosis data from node %d (%d metrics, "
                "xla_capture_events %s, hang_spans %s)", data.data_type,
                data.node_id, len(metrics),
                metrics.get("tpu_timer_gauge/xla_capture_events"),
                metrics.get("tpu_timer_hang_spans"))

    def node_data(self, node_id: int) -> List[DiagnosisData]:
        with self._lock:
            return list(self._node_data.get(node_id, ()))

    def recent_data(self, data_type: str, limit: int = 8) -> List[Dict]:
        """Newest-first reports of one type across all nodes, as plain
        dicts — the hang diagnostician's stack_dump_provider reads the
        relayed worker stack captures through this."""
        out: List[Dict] = []
        with self._lock:
            for node_id, ring in self._node_data.items():
                for data in ring:
                    if data.data_type == data_type:
                        record = dict(vars(data))
                        record["node_id"] = node_id
                        out.append(record)
        out.sort(key=lambda r: r.get("timestamp", 0.0), reverse=True)
        return out[:limit]
