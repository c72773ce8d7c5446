"""The port's cluster metric monitor (``common/metric.py``) and the hang
diagnostician that reads it, against the JAX package's: the same
per-node series (made from a seed with numpy) give the same verdicts —
frozen step counters, window contents, latest values, job means,
summaries — and the same hang observations with and without the
out-of-band counters; the monitor scrapes the port's real daemon and
counts unreachable nodes."""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import time

import numpy as np
import pytest

from dlrover_tpu.common import metric as ref
from dlrover_tpu_torch.common import metric
from dlrover_tpu_torch.common.metric import (
    STEP_COUNTER,
    JobMetricContext,
    JobMetricMonitor,
)


def _series(seed, now):
    """(node, metrics, ts) samples: some nodes' step counters advance,
    some freeze, some samples fall outside a 60 s window."""
    rs = np.random.RandomState(seed)
    out = []
    for node in range(3):
        frozen = rs.rand() < 0.5
        step = float(rs.randint(0, 100))
        t = now - float(rs.choice([5.0, 120.0]))
        for _ in range(int(rs.randint(1, 5))):
            if not frozen:
                step += float(rs.randint(1, 4))
            out.append((node, {STEP_COUNTER: step,
                               "tpu_timer_gauge/goodput": float(rs.rand())},
                        t))
            t += 1.0
    return out


@pytest.mark.parametrize("seed", range(8))
def test_context_verdicts_match_the_reference(seed):
    now = time.time()
    contexts = (JobMetricContext(), ref.JobMetricContext())
    for ctx in contexts:
        for node, values, ts in _series(seed, now):
            ctx.record(node, values, ts=ts)
        ctx.record_unreachable(7)
    port, want = contexts
    for span in (30.0, 60.0, 600.0):
        assert port.steps_frozen(span) == want.steps_frozen(span)
        for node in range(3):
            assert port.window(node, STEP_COUNTER, span) == \
                want.window(node, STEP_COUNTER, span)
    assert port.nodes() == want.nodes() == [0, 1, 2, 7]
    assert port.summary() == want.summary()
    assert port.job_gauge_mean("tpu_timer_gauge/goodput") == \
        want.job_gauge_mean("tpu_timer_gauge/goodput")
    assert port.unreachable_count(7) == want.unreachable_count(7) == 1
    assert port.latest(0, STEP_COUNTER) == want.latest(0, STEP_COUNTER)


def test_monitor_scrapes_the_ports_daemon_and_counts_unreachable():
    from dlrover_tpu_torch.tpu_timer import get_timer

    timer = get_timer()
    if not timer.port:
        timer.start_server(0)
    timer.counter_add("steps", 7)
    timer.set_gauge("goodput", 92.5)
    monitor = JobMetricMonitor({0: f"127.0.0.1:{timer.port}",
                                3: "127.0.0.1:1"})
    assert monitor.scrape_once() == 1
    ctx = monitor.context
    assert ctx.latest(0, "tpu_timer_gauge/goodput") == 92.5
    assert ctx.latest(0, STEP_COUNTER) >= 7
    assert ctx.unreachable_count(3) == 1
    assert ctx.summary()[3]["unreachable_scrapes"] == 1


def test_monitor_loop_follows_elastic_endpoints():
    calls = []

    def endpoints():
        return {0: "a:1", 1: "b:2"} if not calls else {0: "a:1"}

    def fetch(addr, timeout):
        calls.append(addr)
        return 'tpu_timer_counter{name="steps"} 5\n'

    monitor = JobMetricMonitor(endpoints, fetch=fetch, interval_s=0.01)
    assert monitor.scrape_once() == 2
    assert monitor.scrape_once() == 1
    monitor.start()
    deadline = time.time() + 10
    while len(calls) < 6 and time.time() < deadline:
        time.sleep(0.01)
    monitor.stop()
    assert len(calls) >= 6 and monitor.context.latest(1, STEP_COUNTER) == 5


def _diagnostician(mod_hang, mod_perf, ctx, stale_s, now):
    perf = mod_perf.PerfMonitor()
    perf.collect_global_step(100, now - stale_s)
    return mod_hang.TrainingHangDiagnostician(
        perf, hang_timeout_s=60.0, metric_context=ctx,
        clock=lambda: now)


@pytest.mark.parametrize("stale_s, steps, hang", [
    (500.0, [100, 105, 110], False),  # in-band stalled, native advancing
    (500.0, [110, 110, 110], True),   # both frozen
    (1.0, [110, 110, 110], True),     # in-band fresh, native frozen
    (1.0, [100, 101, 102], False),    # healthy
    (500.0, [100], True),             # one sample is no evidence
])
def test_hang_diagnostician_with_metric_context_matches_the_reference(
        stale_s, steps, hang):
    from dlrover_tpu.diagnosis.diagnosticians import (
        training_hang as ref_hang,
    )
    from dlrover_tpu.master.monitor import perf_monitor as ref_perf
    from dlrover_tpu_torch.diagnosis.diagnosticians import training_hang
    from dlrover_tpu_torch.master.monitor import perf_monitor

    now = time.time()
    seen = []
    for mod_metric, mod_hang, mod_perf in (
            (metric, training_hang, perf_monitor),
            (ref, ref_hang, ref_perf)):
        ctx = mod_metric.JobMetricContext()
        for i, s in enumerate(steps):
            ctx.record(0, {mod_metric.STEP_COUNTER: float(s)},
                       ts=now - 3 + i)
        d = _diagnostician(mod_hang, mod_perf, ctx, stale_s, now)
        ob = d.observe()
        seen.append((ob.observation, dict(ob.extra)))
    assert seen[0] == seen[1]
    assert (seen[0][0] == "training-hang") == hang
