"""Diagnosis data reported from agents to the master.

Parity: reference dlrover/python/diagnosis/common/diagnosis_data.py
(DiagnosisData base, WorkerTrainingMetric, TrainingLog). Carried inside
``comm.DiagnosisDataReport`` and stored per-node by the DiagnosisMaster.

The port's copy of ``dlrover_tpu/diagnosis/diagnosis_data.py``.
"""

import time
from dataclasses import dataclass, field
from typing import Dict, List

from dlrover_tpu_torch.common.serialize import PickleSerializable


class DiagnosisDataType:
    TRAINING_LOG = "training_log"
    TRAINING_METRIC = "training_metric"
    RESOURCE = "resource"
    XPU_TIMER_METRIC = "xpu_timer_metric"
    FLIGHT_RECORDER = "flight_recorder"
    # All-thread sys._current_frames() captures from the worker-side
    # hang watchdog / SIGUSR1 on-demand dump (observability §29).
    STACK_DUMP = "stack_dump"
    # Finished distributed-trace spans pushed by workers, routed to the
    # master's TraceAggregator behind /api/traces.
    TRACE_SPANS = "trace_spans"


@dataclass
class DiagnosisData(PickleSerializable):
    data_type: str = ""
    node_id: int = -1
    node_rank: int = -1
    timestamp: float = field(default_factory=time.time)


@dataclass
class TrainingLog(DiagnosisData):
    """Tail of the worker log, pre-filtered to error-ish lines."""

    data_type: str = DiagnosisDataType.TRAINING_LOG
    logs: List[str] = field(default_factory=list)


@dataclass
class WorkerTrainingMetric(DiagnosisData):
    """Step progress as seen by one worker."""

    data_type: str = DiagnosisDataType.TRAINING_METRIC
    global_step: int = 0
    step_time_s: float = 0.0
    throughput: float = 0.0


@dataclass
class NodeResourceData(DiagnosisData):
    data_type: str = DiagnosisDataType.RESOURCE
    cpu_percent: float = 0.0
    memory_mb: float = 0.0
    tpu_duty_cycle: float = 0.0


@dataclass
class XpuTimerMetric(DiagnosisData):
    """Scraped gauges from the native profiler daemon (tpu_timer)."""

    data_type: str = DiagnosisDataType.XPU_TIMER_METRIC
    metrics: Dict[str, float] = field(default_factory=dict)


@dataclass
class FlightRecord(DiagnosisData):
    """The last N step records of a dead worker, fetched by the agent
    from the flight recorder's crash dump."""

    data_type: str = DiagnosisDataType.FLIGHT_RECORDER
    local_rank: int = -1
    steps: List[Dict] = field(default_factory=list)


@dataclass
class StackDump(DiagnosisData):
    """All-thread sys._current_frames() capture from a worker's hang
    watchdog / SIGUSR1 dump, relayed by the agent — the evidence the
    hang diagnostician folds into its escalation."""

    data_type: str = DiagnosisDataType.STACK_DUMP
    reason: str = ""
    meta: Dict = field(default_factory=dict)
    stacks: Dict[str, List[str]] = field(default_factory=dict)
    hang_for_s: float = 0.0


@dataclass
class TraceSpans(DiagnosisData):
    """A batch of finished distributed-trace spans pushed by a worker
    (the /api/traces feed; the servicer ALSO routes these straight to
    its TraceAggregator — this record keeps the generic per-node
    diagnosis ring consistent)."""

    data_type: str = DiagnosisDataType.TRACE_SPANS
    spans: List[Dict] = field(default_factory=list)


def build_diagnosis_data(data_type, node_id, payload, timestamp=0.0):
    """Reconstruct a DiagnosisData from the generic RPC report
    (comm.DiagnosisDataReport: data_type + free-form payload dict)."""
    classes = {
        DiagnosisDataType.TRAINING_LOG: TrainingLog,
        DiagnosisDataType.TRAINING_METRIC: WorkerTrainingMetric,
        DiagnosisDataType.RESOURCE: NodeResourceData,
        DiagnosisDataType.XPU_TIMER_METRIC: XpuTimerMetric,
        DiagnosisDataType.FLIGHT_RECORDER: FlightRecord,
        DiagnosisDataType.STACK_DUMP: StackDump,
        DiagnosisDataType.TRACE_SPANS: TraceSpans,
    }
    cls = classes.get(data_type)
    if cls is None:
        return None
    fields = set(cls.__dataclass_fields__) - {
        "node_id",
        "data_type",
        "timestamp",
    }
    kwargs = {k: v for k, v in (payload or {}).items() if k in fields}
    data = cls(node_id=node_id, **kwargs)
    if timestamp:
        data.timestamp = timestamp
    return data
