"""Agent-side diagnosis data collectors (the port's copy of
``dlrover_tpu/diagnosis/collectors.py``).

Parity: reference dlrover/python/diagnosis/datacollector/
xpu_timer_metric_collector.py:28-75 (Prometheus scrape -> master) and
training_log_collector.py. The tpu_timer collector scrapes the native
daemon's /metrics endpoint and forwards the parsed gauges to the master's
DiagnosisMaster, where the hang diagnostician can see a frozen step
counter even if the Python worker is wedged.
"""

import http.client
import re
import threading
from typing import Dict, Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.diagnosis.diagnosis_data import DiagnosisDataType

# The labels group admits '}' INSIDE quoted values (kernel names are
# arbitrary strings): any run of non-quote/non-brace chars or a full
# quoted string, repeated.
_METRIC_LINE = re.compile(
    r'^(?P<metric>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>(?:[^"{}]|"(?:[^"\\]|\\.)*")*)\})?'
    r'\s+(?P<value>[-+0-9.eE]+|NaN|[+-]?Inf)\s*$'
)
_LABEL_PAIR = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Flatten Prometheus exposition into {metric[/labels]: value}.

    A bare metric keeps its name; the single-label ``{name="X"}``
    convention every in-repo exporter uses (tpu_timer daemon, the
    master's /metrics) flattens to ``metric/X`` — unchanged from the
    original parser; any other label set flattens to
    ``metric/k1=v1,k2=v2`` in exposition order (histogram ``le``
    buckets and multi-label families survive the round trip).
    """
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _METRIC_LINE.match(line)
        if not m:
            continue
        key = m.group("metric")
        raw_labels = m.group("labels")
        if raw_labels:
            pairs = [
                (k, v.replace('\\"', '"').replace("\\\\", "\\"))
                for k, v in _LABEL_PAIR.findall(raw_labels)
            ]
            if len(pairs) == 1 and pairs[0][0] == "name":
                key = f"{key}/{pairs[0][1]}"
            elif pairs:
                flat = ",".join(f"{k}={v}" for k, v in pairs)
                key = f"{key}/{flat}"
        try:
            out[key] = float(m.group("value"))
        except ValueError:
            continue
    return out


class TpuTimerMetricCollector:
    """Scrapes the local tpu_timer daemon and reports to the master."""

    def __init__(
        self,
        master_client=None,
        node_id: int = 0,
        port: int = 0,
        port_file: str = "",
        interval_s: float = 30.0,
    ):
        """``port_file``, when given, is re-read before each scrape: the
        worker publishes its actually-bound daemon port there (the fixed
        base port can be taken by a stale process)."""
        self._client = master_client
        self._node_id = node_id
        self.port = port
        self._port_file = port_file
        self.interval_s = interval_s
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _resolve_port(self) -> int:
        if self._port_file:
            try:
                with open(self._port_file) as f:
                    return int(f.read().strip())
            except (OSError, ValueError):
                pass
        return self.port

    def scrape(self) -> Optional[Dict[str, float]]:
        port = self._resolve_port()
        if not port:
            return None
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            text = resp.read().decode() if resp.status == 200 else ""
            conn.close()
        except Exception:
            # Daemon restarting / truncated response: skip this round,
            # never kill the collector thread.
            return None
        if not text:
            return None
        return parse_prometheus_text(text)

    def collect_once(self) -> bool:
        metrics = self.scrape()
        if not metrics or self._client is None:
            return False
        try:
            self._client.report_diagnosis_data(
                DiagnosisDataType.XPU_TIMER_METRIC,
                {"metrics": metrics, "node_rank": self._node_id},
            )
            return True
        except Exception:
            logger.warning("tpu_timer metric report failed", exc_info=True)
            return False

    def start(self):
        self._stopped.clear()
        self._thread = threading.Thread(
            target=self._loop, name="tpu-timer-collector", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _loop(self):
        while not self._stopped.wait(self.interval_s):
            try:
                self.collect_once()
            except Exception:
                logger.warning("metric collection failed", exc_info=True)
