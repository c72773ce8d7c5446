"""Node-side diagnosis: decide restart-vs-relaunch, report evidence.

Parity: reference dlrover/python/elastic_agent/diagnosis/
diagnosis_agent.py:67-303 (DiagnosisAgent.diagnose_training_failure,
periodic data reporting). The ElasticAgent consults this after a worker
failure: a software crash inside the restart budget restarts processes in
place (cheap, keeps the TPU host); hardware/driver faults or an exhausted
budget escalate to node relaunch; repeated identical crash signatures
short-circuit to relaunch early.

The port's copy of ``dlrover_tpu/agent/diagnosis_agent.py``.
"""

import os
import re
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import (
    HARDWARE_LOG_MARKERS,
    OOM_LOG_MARKERS,
    ExitCode,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.diagnosis.diagnosis_data import DiagnosisDataType

# Log lines that indicate the TPU host itself is unhealthy; these make a
# same-host restart pointless (reference uses exit codes + log inference).
_HARDWARE_PATTERNS = [
    re.compile(p, re.IGNORECASE) for p in HARDWARE_LOG_MARKERS
]

# Evidence filter: generic error-ish lines PLUS the OOM/hardware
# markers — "RESOURCE_EXHAUSTED" or "uncorrectable ecc" must survive
# the filter even without the word "error" on the line.
_ERROR_LINE = re.compile(
    "|".join(
        (r"error|exception|traceback|fatal|abort",)
        + OOM_LOG_MARKERS
        + HARDWARE_LOG_MARKERS
    ),
    re.IGNORECASE,
)

# OOM signatures (shared with the master's classifier via
# common/constants.py): an in-place restart with the same config just
# OOMs again, so these escalate to relaunch and carry a reason hint the
# master turns into an OOM record for the optimizer's memory bump.
_OOM_PATTERNS = [
    re.compile(p, re.IGNORECASE) for p in OOM_LOG_MARKERS
]


class WorkerAction:
    RESTART_WORKER = "restart"
    RELAUNCH_NODE = "relaunch"
    FAIL_JOB = "fail"


@dataclass
class FailureContext:
    exit_codes: Dict[int, int]
    restart_count: int
    max_restarts: int
    log_tail: Optional[List[str]] = None


class DiagnosisAgent:
    def __init__(
        self,
        master_client=None,
        node_id: int = 0,
        log_path: str = "",
        report_interval_s: float = 60.0,
    ):
        self._client = master_client
        self._node_id = node_id
        self._log_path = log_path
        self._report_interval_s = report_interval_s
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_signature = ""
        self._same_signature_count = 0
        # Byte offset of log content already examined for hardware-fault
        # signatures; logs are appended across restarts, and a stale
        # hardware-ish line must not taint later software crashes.
        self._fault_scan_offset = 0

    # ---- failure diagnosis --------------------------------------------------

    def diagnose_training_failure(self, ctx: FailureContext) -> str:
        """Pick the recovery level for a worker failure."""
        if self._is_hardware_fault(ctx):
            logger.warning("hardware fault signature: relaunching node")
            return WorkerAction.RELAUNCH_NODE
        if ctx.restart_count >= ctx.max_restarts:
            # The budget is the hard stop: a deterministic crash must fail
            # the job, not churn through node relaunches.
            return WorkerAction.FAIL_JOB
        signature = str(sorted(ctx.exit_codes.items()))
        if signature == self._last_signature:
            self._same_signature_count += 1
        else:
            self._last_signature = signature
            self._same_signature_count = 1
        if self._same_signature_count >= 3:
            # Crashing identically 3x in a row on this host: stop burning
            # the restart budget here and try a fresh host.
            logger.warning(
                "repeated identical failure %s; relaunching node", signature
            )
            return WorkerAction.RELAUNCH_NODE
        return WorkerAction.RESTART_WORKER

    def consume_failure_evidence(self) -> List[str]:
        """Error lines appended since the last failure — read ONCE per
        failure and passed via FailureContext.log_tail so diagnosis and
        classification see the same evidence (a second read would find
        nothing: the scan offset advances)."""
        return self._consume_new_error_logs()

    def failure_reason(self, ctx: FailureContext) -> str:
        """Classify the failure for the master's exit-reason taxonomy.

        Returns a NodeExitReason value mined from exit codes and the
        worker log tail; the agent sends it as a ``reason=X`` hint in
        the failure report's error_data. Stale log lines from previous
        incarnations must not leak in — callers pass the offset-tracked
        lines from ``consume_failure_evidence``.
        """
        from dlrover_tpu_torch.common.constants import ExitCode, NodeExitReason

        lines = (
            ctx.log_tail
            if ctx.log_tail is not None
            else self._consume_new_error_logs()
        )
        if any(p.search(ln) for ln in lines for p in _OOM_PATTERNS):
            return NodeExitReason.OOM
        if self._is_hardware_fault(ctx):
            return NodeExitReason.HARDWARE_ERROR
        codes = set(ctx.exit_codes.values())
        if ExitCode.KILLED in codes:
            return NodeExitReason.KILLED
        if ExitCode.TERMED in codes:
            return NodeExitReason.PREEMPTED
        return NodeExitReason.SOFTWARE_ERROR

    def _is_hardware_fault(self, ctx: FailureContext) -> bool:
        if any(
            c in (ExitCode.HARDWARE_ERROR, ExitCode.GPU_DRIVER_ERROR)
            for c in ctx.exit_codes.values()
        ):
            return True
        if ctx.log_tail is not None:
            lines = ctx.log_tail
        else:
            lines = self._consume_new_error_logs()
        return any(
            p.search(line) for line in lines for p in _HARDWARE_PATTERNS
        )

    def _consume_new_error_logs(self) -> List[str]:
        """Error lines appended since the previous failure diagnosis."""
        if not self._log_path or not os.path.exists(self._log_path):
            return []
        try:
            with open(self._log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                start = max(self._fault_scan_offset, size - 256 * 1024)
                self._fault_scan_offset = size
                if start >= size:
                    return []
                f.seek(start)
                text = f.read().decode("utf-8", errors="replace")
        except OSError:
            return []
        return [ln for ln in text.splitlines() if _ERROR_LINE.search(ln)]

    # ---- evidence collection ------------------------------------------------

    def collect_error_logs(self, max_lines: int = 64) -> List[str]:
        """Tail the worker log for error-ish lines (reference
        training_log_collector)."""
        if not self._log_path or not os.path.exists(self._log_path):
            return []
        try:
            with open(self._log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - 256 * 1024))
                text = f.read().decode("utf-8", errors="replace")
        except OSError:
            return []
        lines = [ln for ln in text.splitlines() if _ERROR_LINE.search(ln)]
        return lines[-max_lines:]

    # ---- periodic reporting -------------------------------------------------

    def start(self):
        if self._client is None:
            return
        self._stopped.clear()
        self._thread = threading.Thread(
            target=self._report_loop, name="diagnosis-agent", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _report_loop(self):
        while not self._stopped.is_set():
            if self._stopped.wait(self._report_interval_s):
                return
            try:
                logs = self.collect_error_logs()
                if logs:
                    self._client.report_diagnosis_data(
                        DiagnosisDataType.TRAINING_LOG,
                        {"logs": logs, "node_rank": self._node_id},
                    )
            except Exception:
                logger.warning("diagnosis report failed", exc_info=True)
