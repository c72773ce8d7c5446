"""Job runtime stats collection and reporting.

Parity: reference dlrover/python/master/stats/ (JobMetricCollector,
reporter.py:233, training_metrics.py) — samples node resource usage,
training throughput, and goodput into typed records and hands them to a
pluggable reporter (in-memory locally; a cluster brain service can
implement StatsReporter to receive them instead).

The port's copy of ``dlrover_tpu/master/stats/job_collector.py``.
"""

import abc
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List

from dlrover_tpu_torch.common.log import logger


@dataclass
class RuntimeMetricSample:
    timestamp: float
    global_step: int
    speed: float  # steps/s
    goodput: float  # percent
    worker_count: int
    node_usage: Dict[int, Dict[str, float]] = field(default_factory=dict)


@dataclass
class JobCompletionRecord:
    job_name: str
    success: bool
    exit_reason: str
    duration_s: float
    failure_count: int


class StatsReporter(abc.ABC):
    @abc.abstractmethod
    def report_runtime_sample(self, sample: RuntimeMetricSample):
        ...

    @abc.abstractmethod
    def report_job_completion(self, record: JobCompletionRecord):
        ...


class LocalStatsReporter(StatsReporter):
    """Keeps a bounded in-memory history (the standalone 'brain')."""

    def __init__(self, max_samples: int = 2048):
        self._max = max_samples
        self.samples: List[RuntimeMetricSample] = []
        self.completions: List[JobCompletionRecord] = []

    def report_runtime_sample(self, sample: RuntimeMetricSample):
        self.samples.append(sample)
        del self.samples[: -self._max]

    def report_job_completion(self, record: JobCompletionRecord):
        self.completions.append(record)


class JobMetricCollector:
    def __init__(
        self,
        job_name: str,
        job_manager,
        perf_monitor,
        reporter: StatsReporter = None,
        interval_s: float = 30.0,
    ):
        self._job_name = job_name
        self._job_manager = job_manager
        self._perf_monitor = perf_monitor
        self.reporter = reporter or LocalStatsReporter()
        self._interval_s = interval_s
        self._started_at = time.time()
        self._stopped = threading.Event()
        self._thread = None

    def collect_once(self) -> RuntimeMetricSample:
        usage = {}
        for node in self._job_manager.worker_manager.nodes.values():
            usage[node.id] = {
                "cpu": node.used_resource.cpu,
                "memory_mb": node.used_resource.memory_mb,
            }
        sample = RuntimeMetricSample(
            timestamp=time.time(),
            global_step=self._perf_monitor.global_step,
            speed=self._perf_monitor.running_speed(),
            goodput=self._perf_monitor.goodput(),
            worker_count=len(self._job_manager.worker_manager.alive_nodes()),
            node_usage=usage,
        )
        self.reporter.report_runtime_sample(sample)
        return sample

    def report_completion(self, success: bool, exit_reason: str,
                          failure_count: int):
        self.reporter.report_job_completion(
            JobCompletionRecord(
                job_name=self._job_name,
                success=success,
                exit_reason=exit_reason,
                duration_s=time.time() - self._started_at,
                failure_count=failure_count,
            )
        )

    def start(self):
        self._stopped.clear()
        self._thread = threading.Thread(
            target=self._loop, name="job-metric-collector", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _loop(self):
        while not self._stopped.wait(self._interval_s):
            try:
                self.collect_once()
            except Exception:
                logger.exception("job metric collection failed")
