"""Continuous-batching serving engine of the port (slot-pooled KV
cache, ragged per-slot decode through the decode-attention kernel,
iteration-level scheduling)."""

from dlrover_tpu_torch.serving.engine import ServingEngine
from dlrover_tpu_torch.serving.metrics import serving_metrics
from dlrover_tpu_torch.serving.scheduler import (
    DECODE,
    DONE,
    PREFILL,
    QUEUED,
    Request,
    Scheduler,
    SloClass,
)

__all__ = [
    "ServingEngine",
    "Scheduler",
    "Request",
    "SloClass",
    "QUEUED",
    "PREFILL",
    "DECODE",
    "DONE",
    "serving_metrics",
]
