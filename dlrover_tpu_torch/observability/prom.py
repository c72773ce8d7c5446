"""Prometheus text exposition for the observability hub.

Renders the process registry plus the master's live job-level views
(PerfMonitor goodput/phase ledger, JobMetricContext aggregates) into one
text/plain body, served by ``DashboardServer`` at ``/metrics``. The
output round-trips through the in-repo scraper
(:func:`dlrover_tpu_torch.diagnosis.collectors.parse_prometheus_text`), so the
master can scrape itself with the same code path it uses for the
tpu_timer daemons — one scrape covers the whole job.

The port's copy of ``dlrover_tpu/observability/prom.py``.
"""

from typing import Dict, List, Optional

from dlrover_tpu_torch.observability.registry import (
    Histogram,
    MetricsRegistry,
    default_registry,
)

# Precomputed per-histogram quantile gauges: (suffix, q). Consumers
# (dashboard panels, the autoscaler's latency checks) read a gauge
# instead of re-deriving quantiles from cumulative buckets client-side.
_QUANTILE_GAUGES = (("p50", 0.5), ("p95", 0.95), ("p99", 0.99))


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _format_sample(name: str, labels: Dict[str, str], value: float) -> str:
    if labels:
        body = ",".join(
            f'{k}="{_escape_label(v)}"' for k, v in labels.items()
        )
        return f"{name}{{{body}}} {value:.10g}"
    return f"{name} {value:.10g}"


def render_registry(registry: Optional[MetricsRegistry] = None) -> str:
    """Exposition for every family in the registry (# HELP/# TYPE)."""
    registry = registry or default_registry()
    lines: List[str] = []
    for family in sorted(registry.families(), key=lambda f: f.name):
        if family.help:
            lines.append(f"# HELP {family.name} {family.help}")
        lines.append(f"# TYPE {family.name} {family.kind}")
        for name, labels, value in family.samples():
            lines.append(_format_sample(name, labels, value))
        if isinstance(family, Histogram):
            lines.extend(_quantile_lines(family))
    return "\n".join(lines) + ("\n" if lines else "")


def _quantile_lines(family: Histogram) -> List[str]:
    """``<name>_p50/_p95/_p99`` gauges per labelled child, computed at
    scrape time from the cumulative buckets."""
    children = sorted(
        {
            tuple(sorted(labels.items()))
            for name, labels, _v in family.samples()
            if name == f"{family.name}_count"
        }
    )
    lines: List[str] = []
    for suffix, q in _QUANTILE_GAUGES:
        emitted_type = False
        for child in children:
            labels = dict(child)
            value = family.quantile(q, **labels)
            if value is None:
                continue
            if not emitted_type:
                lines.append(f"# TYPE {family.name}_{suffix} gauge")
                emitted_type = True
            lines.append(
                _format_sample(f"{family.name}_{suffix}", labels, value)
            )
    return lines


def render_perf(perf_monitor) -> str:
    """Live job-level metrics computed at scrape time: goodput changes
    with the wall clock even without new reports, so these are rendered
    fresh rather than cached in the registry."""
    lines = [
        "# TYPE dlrover_global_step gauge",
        _format_sample(
            "dlrover_global_step", {}, float(perf_monitor.global_step)
        ),
        "# TYPE dlrover_running_speed_steps_per_s gauge",
        _format_sample(
            "dlrover_running_speed_steps_per_s",
            {},
            perf_monitor.running_speed(),
        ),
        "# TYPE dlrover_goodput gauge",
        _format_sample("dlrover_goodput", {}, perf_monitor.goodput()),
        "# TYPE dlrover_goodput_phase_seconds gauge",
    ]
    for phase, secs in sorted(perf_monitor.phase_breakdown().items()):
        lines.append(
            _format_sample(
                "dlrover_goodput_phase_seconds", {"name": phase}, secs
            )
        )
    return "\n".join(lines) + "\n"


def render_job_context(context) -> str:
    """JobMetricContext job-level aggregates: the latest value per
    (node, metric) plus per-metric means over reporting nodes."""
    if context is None:
        return ""
    summary = context.summary()
    if not summary:
        return ""
    lines = [
        "# TYPE dlrover_job_node_metric gauge",
    ]
    keys = set()
    for node_id, metrics in sorted(summary.items()):
        for key, value in sorted(metrics.items()):
            if key != "unreachable_scrapes":
                keys.add(key)
            lines.append(
                _format_sample(
                    "dlrover_job_node_metric",
                    {"name": f"{node_id}:{key}"},
                    value,
                )
            )
    lines.append("# TYPE dlrover_job_metric_mean gauge")
    for key in sorted(keys):
        mean = context.job_gauge_mean(key)
        if mean is not None:
            lines.append(
                _format_sample(
                    "dlrover_job_metric_mean", {"name": key}, mean
                )
            )
    return "\n".join(lines) + "\n"


def master_metrics_text(
    perf_monitor=None,
    metric_context=None,
    registry: Optional[MetricsRegistry] = None,
) -> str:
    """The full master /metrics body: registry + live perf + job
    aggregates."""
    parts = [render_registry(registry)]
    if perf_monitor is not None:
        parts.append(render_perf(perf_monitor))
    if metric_context is not None:
        parts.append(render_job_context(metric_context))
    return "".join(p for p in parts if p)
