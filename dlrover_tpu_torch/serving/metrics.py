"""Serving metrics: the engine's families in the port's registry (port
of ``dlrover_tpu/serving/metrics.py``).

Registration is idempotent (the registry returns existing families), so
several engines in one process share counters; gauges describe the last
engine to update them. The flight-recorder annotations arrive with the
fleet.
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
            "requeues, pool preemptions)",
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
        # ---- paged KV pool (serving/kvpool) -----------------------------
        self.kv_blocks = reg.gauge(
            "serving_kv_blocks",
            "paged KV pool blocks by state (free | used: referenced by "
            "a live slot's block table | cached: held warm by the "
            "prefix cache only); states sum to the managed pool size",
            labelnames=("state",),
        )
        self.kv_blocks_total = reg.gauge(
            "serving_kv_blocks_total",
            "managed (allocatable) blocks in the paged KV pool",
        )
        self.kv_bytes_in_use = reg.gauge(
            "serving_kv_bytes_in_use",
            "bytes of KV pool HBM referenced by live slots or the "
            "prefix cache (allocated blocks x block bytes, K+V)",
        )
        self.prefix_lookups = reg.counter(
            "serving_prefix_lookups_total",
            "prefix-cache lookups at admission, by outcome",
            labelnames=("outcome",),
        )
        self.prefix_hit_blocks = reg.counter(
            "serving_prefix_hit_blocks_total",
            "warm blocks handed to admitted requests by the prefix "
            "cache (each skips block_size tokens of prefill)",
        )
        self.kv_cow_copies = reg.counter(
            "serving_kv_cow_copies_total",
            "copy-on-write block privatizations (a shared block was "
            "about to be rewritten)",
        )
        self.kv_preemptions = reg.counter(
            "serving_kv_preemptions_total",
            "requests preempted (re-queued, progress reset) to free "
            "blocks for an older request under pool pressure",
        )
        # ---- speculative decoding (serving/spec_decode) ----------------
        self.spec_tokens = reg.counter(
            "serving_spec_tokens_total",
            "speculative-decoding tokens by fate (drafted: proposed by "
            "the drafter and verified; accepted: survived verification "
            "and committed; rejected: rolled back by the fill rewind)",
            labelnames=("kind",),
        )
        self.spec_tokens_per_step = reg.gauge(
            "serving_spec_accepted_tokens_per_step",
            "running mean of tokens committed per verify step across "
            "decoding slots (accepted drafts + the correction/bonus "
            "token; 1.0 = no speculation win, K+1 = every draft lands)",
        )
        self.spec_accept_rate = reg.histogram(
            "serving_spec_accept_rate",
            "per-slot fraction of drafted tokens accepted by one "
            "verify step (observed only for slots that drafted)",
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
        )


def serving_metrics(registry=None) -> ServingMetrics:
    """Handle over ``registry`` (the process default when None);
    registration is idempotent, so handles share families."""
    return ServingMetrics(registry)
