"""Serving metrics: the engine's families in the port's registry (port
of ``dlrover_tpu/serving/metrics.py``).

Registration is idempotent (the registry returns existing families), so
several engines in one process share counters; gauges describe the last
engine to update them. The paged-pool and speculative-decoding families
arrive with those engines.
"""

from dlrover_tpu_torch.observability.registry import default_registry

# Sub-second buckets: decode iterations are milliseconds.
_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0,
)
_TTFT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)


class ServingMetrics:
    """Handle bundle over the registry families the engine updates."""

    def __init__(self, registry=None):
        reg = registry or default_registry()
        self.queue_depth = reg.gauge(
            "serving_queue_depth", "requests waiting for a slot"
        )
        self.active_slots = reg.gauge(
            "serving_active_slots", "slots holding a live request"
        )
        self.slots_total = reg.gauge(
            "serving_slots_total", "slot-pool size of the engine"
        )
        self.requests = reg.counter(
            "serving_requests_total",
            "requests by lifecycle outcome",
            labelnames=("outcome",),
        )
        self.tokens = reg.counter(
            "serving_tokens_total",
            "tokens processed, prefill (prompt) vs decode (generated)",
            labelnames=("kind",),
        )
        self.tokens_wasted = reg.counter(
            "serving_tokens_wasted_total",
            "computed tokens thrown away by progress resets (step-error "
            "requeues)",
            labelnames=("kind",),
        )
        self.iterations = reg.counter(
            "serving_iterations_total", "engine scheduler iterations"
        )
        self.step_errors = reg.counter(
            "serving_step_errors_total",
            "engine iterations that raised and re-queued their in-flight "
            "requests",
        )
        self.shed = reg.counter(
            "serving_requests_shed_total",
            "queued requests dropped before admission, by reason "
            '(reason="deadline": past their TTL, never prefilled) '
            "and SLO class",
            labelnames=("reason", "slo_class"),
        )
        self.class_queue_depth = reg.gauge(
            "serving_class_queue_depth",
            "requests waiting for a slot, per SLO class",
            labelnames=("slo_class",),
        )
        self.failures = reg.counter(
            "serving_requests_failed_total",
            "terminally failed requests by machine-readable reason "
            "(requeue_budget, deadline, ...)",
            labelnames=("reason",),
        )
        self.ttft = reg.histogram(
            "serving_ttft_seconds",
            "submit-to-first-token latency",
            buckets=_TTFT_BUCKETS,
        )
        self.token_latency = reg.histogram(
            "serving_token_latency_seconds",
            "per-decoded-token latency (iteration wall time)",
            buckets=_LATENCY_BUCKETS,
        )


def serving_metrics(registry=None) -> ServingMetrics:
    """Handle over ``registry`` (the process default when None);
    registration is idempotent, so handles share families."""
    return ServingMetrics(registry)
