"""Master-side cluster accelerator-metric monitor (the port's copy of
``dlrover_tpu/common/metric.py``).

Parity: reference dlrover/python/common/metric/monitor.py:43-503 +
metric_context.py — a job-level monitor that scrapes an EXTERNAL
GPU/NPU metrics API on an interval into a windowed per-node metric
context, which diagnosis then consults (frozen step counters, idle
accelerators) independently of the workers' own reporting path.

The external source is the per-node tpu_timer daemons' Prometheus
endpoints (the native runtime every worker already carries, serving
/metrics), so the master needs no third-party metrics stack, and any
other Prometheus exporter (DCGM's exporter, node-exporter) works
through the same scraper. Two layers:

- :class:`JobMetricContext` — bounded, windowed history per
  (node, metric) with job-level aggregate queries. Pure data; the
  diagnosis masters read it.
- :class:`JobMetricMonitor` — the scrape loop over ``{node_id:
  "host:port"}`` endpoints, with per-node unreachable accounting (a
  node whose daemon stops answering is itself a diagnosis signal —
  the reference treats scrape failure the same way).

The out-of-band property is the point: these metrics come from the
NATIVE daemon thread, so a worker wedged inside the CUDA driver or
NCCL (Python frozen, heartbeats possibly still flowing from other
threads) shows a frozen ``tpu_timer_counter/steps`` here even though it
answers nothing else. ``steps_frozen`` is therefore hang corroboration
that needs no cooperation from the training loop.
"""

import collections
import http.client
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import logger

# Metric keys as the tpu_timer daemon exposes them
# (diagnosis/collectors.parse_prometheus_text flattening).
STEP_COUNTER = "tpu_timer_counter/steps"


class JobMetricContext:
    """Windowed per-(node, metric) samples + job-level queries."""

    def __init__(self, max_samples_per_series: int = 360):
        self._max = max_samples_per_series
        self._lock = threading.Lock()
        self._series: Dict[
            Tuple[int, str], "collections.deque[Tuple[float, float]]"
        ] = {}
        self._last_scrape: Dict[int, float] = {}
        self._unreachable: Dict[int, int] = collections.Counter()

    def record(
        self, node_id: int, metrics: Dict[str, float],
        ts: Optional[float] = None,
    ):
        ts = time.time() if ts is None else ts
        with self._lock:
            self._last_scrape[node_id] = ts
            self._unreachable.pop(node_id, None)
            for key, value in metrics.items():
                series = self._series.setdefault(
                    (node_id, key),
                    collections.deque(maxlen=self._max),
                )
                series.append((ts, float(value)))

    def record_unreachable(self, node_id: int):
        with self._lock:
            self._unreachable[node_id] += 1

    def unreachable_count(self, node_id: int) -> int:
        with self._lock:
            return self._unreachable.get(node_id, 0)

    def latest(self, node_id: int, key: str) -> Optional[float]:
        with self._lock:
            series = self._series.get((node_id, key))
            return series[-1][1] if series else None

    def window(
        self, node_id: int, key: str, span_s: float
    ) -> List[Tuple[float, float]]:
        """(ts, value) samples within the last ``span_s`` seconds."""
        cutoff = time.time() - span_s
        with self._lock:
            series = self._series.get((node_id, key)) or ()
            return [(ts, v) for ts, v in series if ts >= cutoff]

    def nodes(self) -> List[int]:
        with self._lock:
            return sorted(
                {n for n, _ in self._series} | set(self._unreachable)
            )

    def job_gauge_mean(self, key: str) -> Optional[float]:
        vals = [
            v for n in self.nodes()
            for v in [self.latest(n, key)] if v is not None
        ]
        return sum(vals) / len(vals) if vals else None

    def steps_frozen(
        self, span_s: float, min_samples: int = 2
    ) -> bool:
        """True when EVERY reporting node's native step counter is flat
        across the window — the out-of-band hang corroboration (one
        healthy node advancing means the job is not globally hung, it
        is waiting on a straggler; per-node attribution then comes from
        the per-node windows)."""
        nodes = self.nodes()
        if not nodes:
            return False
        saw_series = False
        for node in nodes:
            window = self.window(node, STEP_COUNTER, span_s)
            if len(window) < min_samples:
                continue
            saw_series = True
            values = [v for _, v in window]
            if max(values) > min(values):
                return False
        return saw_series

    def summary(self) -> Dict:
        """Dashboard/admin view: latest value per (node, metric)."""
        with self._lock:
            out: Dict[int, Dict[str, float]] = {}
            for (node, key), series in self._series.items():
                if series:
                    out.setdefault(node, {})[key] = series[-1][1]
            for node, count in self._unreachable.items():
                out.setdefault(node, {})["unreachable_scrapes"] = count
            return out


def _default_fetch(addr: str, timeout: float) -> str:
    import http.client

    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        if resp.status != 200:
            raise OSError(f"GET /metrics -> {resp.status}")
        return resp.read().decode()
    finally:
        conn.close()


class JobMetricMonitor:
    """Scrape loop over the job's metric endpoints into a context.

    ``endpoints`` maps node_id -> "host:port" (static clusters) or is a
    zero-arg callable returning that mapping (elastic clusters: the
    master re-resolves live nodes each round). ``fetch`` is injectable
    for tests/alternative transports."""

    def __init__(
        self,
        endpoints,
        context: Optional[JobMetricContext] = None,
        interval_s: float = 15.0,
        timeout_s: float = 5.0,
        fetch: Callable[[str, float], str] = _default_fetch,
    ):
        self._endpoints = (
            endpoints if callable(endpoints) else (lambda: endpoints)
        )
        self.context = context or JobMetricContext()
        self._interval_s = interval_s
        self._timeout_s = timeout_s
        self._fetch = fetch
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def scrape_once(self) -> int:
        """One scrape round; returns how many nodes answered."""
        from dlrover_tpu_torch.diagnosis.collectors import (
            parse_prometheus_text,
        )

        ok = 0
        for node_id, addr in dict(self._endpoints()).items():
            try:
                text = self._fetch(addr, self._timeout_s)
                self.context.record(
                    node_id, parse_prometheus_text(text)
                )
                ok += 1
            except (OSError, http.client.HTTPException, ValueError) as e:
                # One endpoint's bad status line, cut body or undecodable
                # bytes marks that node unreachable; the round goes on
                # (the reference catches OSError only, and one such
                # endpoint aborts its whole round).
                self.context.record_unreachable(node_id)
                logger.debug(
                    "metric scrape %s (%s) failed: %s", node_id, addr, e
                )
        return ok

    def start(self):
        if self._thread is not None:
            return
        self._stopped.clear()
        self._thread = threading.Thread(
            target=self._loop, name="job-metric-monitor", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=self._timeout_s + 1.0)
            self._thread = None

    def _loop(self):
        while not self._stopped.wait(self._interval_s):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 - monitor must survive
                logger.exception("metric scrape round failed")
