"""Master-side brain integration.

Parity: reference master/resource/brain_optimizer.py
(BrainResoureOptimizer) + master/stats BrainReporter — a StatsReporter
that forwards samples to the brain service, and a ResourceOptimizer that
asks it for cross-job-informed worker counts (falling back to an empty
plan when the brain is unreachable).

The port's copy of ``dlrover_tpu/brain/client.py``.
"""

import http.client
import json
from typing import Dict

from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import NodeGroupResource
from dlrover_tpu_torch.master.resource.optimizer import (
    ResourceOptimizer,
    ResourcePlan,
)
from dlrover_tpu_torch.master.stats.job_collector import (
    JobCompletionRecord,
    RuntimeMetricSample,
    StatsReporter,
)


def _post(addr: str, path: str, payload: Dict, timeout: float = 5.0):
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        body = json.dumps(payload)
        conn.request(
            "POST",
            path,
            body=body,
            headers={"Content-Type": "application/json"},
        )
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            return None
        return json.loads(data)
    finally:
        conn.close()


class BrainStatsReporter(StatsReporter):
    def __init__(self, brain_addr: str, job_name: str):
        self._addr = brain_addr
        self._job_name = job_name

    def report_runtime_sample(self, sample: RuntimeMetricSample):
        try:
            _post(
                self._addr,
                "/persist_metrics",
                {
                    "kind": "runtime",
                    "record": {
                        "job_name": self._job_name,
                        "global_step": sample.global_step,
                        "speed": sample.speed,
                        "goodput": sample.goodput,
                        "worker_count": sample.worker_count,
                    },
                },
            )
        except Exception:
            logger.warning("brain runtime report failed")

    def report_job_completion(self, record: JobCompletionRecord):
        try:
            _post(
                self._addr,
                "/persist_metrics",
                {
                    "kind": "completion",
                    "record": {
                        "job_name": record.job_name,
                        "success": record.success,
                        "exit_reason": record.exit_reason,
                        "duration_s": record.duration_s,
                        "failure_count": record.failure_count,
                    },
                },
            )
        except Exception:
            logger.warning("brain completion report failed")


class BrainResourceOptimizer(ResourceOptimizer):
    def __init__(self, brain_addr: str, job_name: str):
        self._addr = brain_addr
        self._job_name = job_name

    def generate_plan(self) -> ResourcePlan:
        plan = ResourcePlan()
        try:
            result = _post(
                self._addr, "/optimize", {"job_name": self._job_name}
            )
            suggestion = (result or {}).get("plan")
            if not isinstance(suggestion, dict):
                return plan
            count = int(suggestion.get("worker_count", 0))
        except Exception:
            # Unreachable brain or malformed response: degrade to no-op.
            logger.warning("brain optimize failed; no plan", exc_info=True)
            return plan
        if count > 0:
            plan.node_group_resources[NodeType.WORKER] = NodeGroupResource(
                count=count
            )
            plan.comment = (
                f"brain: {count} workers "
                f"({suggestion.get('evidence_samples')} samples)"
            )
        return plan
