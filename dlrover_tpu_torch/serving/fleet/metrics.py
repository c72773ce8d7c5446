"""Fleet metric families of the port: the router's health, retry,
hedge, shed and migration ledger in the port's process registry
(``observability/registry.py``). Registration is idempotent; one
process's routers share families the way engines share serving_*
families. The names are the reference's.
"""

from typing import Optional

from dlrover_tpu_torch.observability.registry import default_registry

_TTFT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)
_LATENCY_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, 30.0, 60.0,
)
_QUEUE_WAIT_BUCKETS = (
    0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0,
)
_MIGRATION_PAUSE_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 5.0,
)


class FleetMetrics:
    """Handle bundle over the router's registry families."""

    def __init__(self, registry=None):
        reg = registry or default_registry()
        self.replica_state = reg.gauge(
            "fleet_replica_state",
            "per-replica breaker state "
            "(0 healthy, 1 suspect, 2 broken, 3 half_open)",
            labelnames=("replica",),
        )
        self.health_transitions = reg.counter(
            "fleet_health_transitions_total",
            "breaker transitions per replica, by destination state",
            labelnames=("replica", "to"),
        )
        self.requests = reg.counter(
            "fleet_requests_total",
            "router requests by terminal outcome "
            "(accepted, completed, failed, shed)",
            labelnames=("outcome",),
        )
        self.failures = reg.counter(
            "fleet_requests_failed_total",
            "terminally failed requests by machine-readable reason",
            labelnames=("reason",),
        )
        self.dispatches = reg.counter(
            "fleet_dispatches_total",
            "work handed to replicas, by kind "
            "(primary, retry, hedge)",
            labelnames=("kind",),
        )
        self.retries = reg.counter(
            "fleet_retries_total",
            "re-dispatches after a failed attempt (different replica)",
        )
        self.hedges = reg.counter(
            "fleet_hedges_total",
            "speculative duplicate dispatches for slow short requests",
        )
        self.sheds = reg.counter(
            "fleet_sheds_total",
            "requests refused/dropped without dispatch, by reason "
            "(overload, deadline)",
            labelnames=("reason",),
        )
        self.reroutes = reg.counter(
            "fleet_reroutes_total",
            "in-flight attempts reclaimed from a broken replica and "
            "re-queued",
        )
        self.duplicates = reg.counter(
            "fleet_duplicate_completions_total",
            "completions dropped because the request already has a "
            "recorded result (hedges, reclaimed-but-alive attempts)",
        )
        self.stale_completions = reg.counter(
            "fleet_stale_completions_total",
            "completions for an attempt the router already reclaimed, "
            "arriving while the request is still live elsewhere — "
            "dropped, but NOT duplicates: no result existed yet",
        )
        self.restarts = reg.counter(
            "fleet_replica_restarts_total",
            "replica process/thread restarts issued by the router",
        )
        self.affinity_dispatches = reg.counter(
            "fleet_affinity_dispatches_total",
            "dispatches routed by prefix affinity: the request "
            "went to the replica holding its prompt prefix's warm KV "
            "blocks instead of the least-loaded choice",
        )
        self.migrations = reg.counter(
            "fleet_migrations_total",
            "KV-block migrations completed: export on the "
            "source, import acked by the destination, source released",
        )
        self.migration_failures = reg.counter(
            "fleet_migration_failures_total",
            "migrations that fell back, by reason (no_destination, "
            "import_send, refused/import error class, timeout) — the "
            "request still completes exactly once: on the source or "
            "via one from-scratch re-prefill",
            labelnames=("reason",),
        )
        self.queue_depth = reg.gauge(
            "fleet_queue_depth",
            "router requests waiting for a dispatchable replica",
        )
        self.inflight = reg.gauge(
            "fleet_inflight",
            "attempts currently running on replicas",
        )
        self.replicas_dispatchable = reg.gauge(
            "fleet_replicas_dispatchable",
            "replicas the breaker currently admits traffic to",
        )
        self.ttft = reg.histogram(
            "fleet_ttft_seconds",
            "router-submit to first token (queue + dispatch + replica "
            "TTFT)",
            buckets=_TTFT_BUCKETS,
        )
        self.latency = reg.histogram(
            "fleet_request_latency_seconds",
            "router-submit to recorded completion",
            buckets=_LATENCY_BUCKETS,
        )
        self.queue_wait = reg.histogram(
            "fleet_queue_wait_seconds",
            "router-submit to first dispatch",
            buckets=_QUEUE_WAIT_BUCKETS,
        )
        self.migration_pause = reg.histogram(
            "fleet_migration_pause_seconds",
            "export receipt to import ack on the router clock — the "
            "window a migrating request makes no decode progress",
            buckets=_MIGRATION_PAUSE_BUCKETS,
        )


_metrics: Optional[FleetMetrics] = None


def fleet_metrics(registry=None) -> FleetMetrics:
    """Process-wide handle (or a private one for a passed registry)."""
    global _metrics
    if registry is not None:
        return FleetMetrics(registry)
    if _metrics is None:
        _metrics = FleetMetrics()
    return _metrics


def reset_fleet_metrics():
    """Tests only: forget the cached handle."""
    global _metrics
    _metrics = None
