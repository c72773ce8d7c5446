"""Self-healing serving fleet of the port (its own copy of
``dlrover_tpu/serving/fleet``): a health-gated router over N engine
replicas — deadlines, bounded retries, hedging, load shedding, crash
re-routing, disaggregated prefill/decode through KV block migration,
and live drain. See router.py for the contract."""

from dlrover_tpu_torch.serving.fleet.health import (
    BROKEN,
    HALF_OPEN,
    HEALTHY,
    SUSPECT,
    HealthPolicy,
    ReplicaHealth,
)
from dlrover_tpu_torch.serving.fleet.metrics import fleet_metrics
from dlrover_tpu_torch.serving.fleet.replica import (
    ReplicaDeadError,
    SubprocessReplica,
    ThreadReplica,
    WorkItem,
)
from dlrover_tpu_torch.serving.fleet.router import (
    FleetRequest,
    FleetResult,
    FleetRouter,
    RouterConfig,
)

__all__ = [
    "FleetRouter",
    "RouterConfig",
    "FleetRequest",
    "FleetResult",
    "ThreadReplica",
    "SubprocessReplica",
    "WorkItem",
    "ReplicaDeadError",
    "ReplicaHealth",
    "HealthPolicy",
    "HEALTHY",
    "SUSPECT",
    "BROKEN",
    "HALF_OPEN",
    "fleet_metrics",
]
