"""Continuous-batching serving engine of the port (slot-pooled KV
cache, ragged per-slot decode through the decode-attention kernel,
iteration-level scheduling); ``serving/kvpool`` is the paged
block-table variant with cross-request prefix reuse."""

from dlrover_tpu_torch.serving.engine import ServingEngine
from dlrover_tpu_torch.serving.kvpool import (
    SENTINEL_BLOCK,
    BlockAllocator,
    BlockPoolExhausted,
    PagedServingEngine,
    PrefixCache,
)
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
    "PagedServingEngine",
    "BlockAllocator",
    "BlockPoolExhausted",
    "PrefixCache",
    "SENTINEL_BLOCK",
    "Scheduler",
    "Request",
    "SloClass",
    "QUEUED",
    "PREFILL",
    "DECODE",
    "DONE",
    "serving_metrics",
]
