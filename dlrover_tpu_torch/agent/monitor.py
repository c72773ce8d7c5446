"""Agent-side node resource monitor (the port's copy of
``dlrover_tpu/agent/monitor.py``).

Parity: reference elastic_agent/monitor/resource.py (ResourceMonitor —
psutil/pynvml sampling -> report_used_resource). The JAX package samples
through ``psutil``; the port reads the same two quantities from
``/proc`` (``/proc/stat`` for the host's CPU share since the previous
sample, ``/proc/meminfo`` for the memory in use, total less available),
so the port needs no ``psutil``.
"""

import threading
from typing import Optional, Tuple

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.log import logger


def _cpu_times() -> Tuple[int, int]:
    """(busy, total) jiffies of all CPUs from the ``cpu`` line of
    ``/proc/stat``; idle and iowait count as not busy, as psutil's
    ``cpu_percent`` counts them."""
    with open("/proc/stat") as f:
        fields = f.readline().split()
    values = [int(v) for v in fields[1:]]
    # user nice system idle iowait irq softirq steal guest guest_nice;
    # guest time is already inside user and nice.
    total = sum(values[:8])
    idle = values[3] + (values[4] if len(values) > 4 else 0)
    return total - idle, total


def _memory_used_mb() -> float:
    """MemTotal less MemAvailable, in MiB (psutil's ``total -
    available``)."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, rest = line.partition(":")
            info[key] = int(rest.split()[0])  # kB
    return (info["MemTotal"] - info["MemAvailable"]) / 1024.0


class CpuSampler:
    """The host's CPU busy share, in percent, between two calls of
    :meth:`sample` (the first call primes it and returns 0.0)."""

    def __init__(self):
        self._last: Optional[Tuple[int, int]] = None

    def sample(self) -> float:
        busy, total = _cpu_times()
        last, self._last = self._last, (busy, total)
        if last is None or total <= last[1]:
            return 0.0
        return 100.0 * (busy - last[0]) / (total - last[1])


class ResourceMonitor:
    def __init__(
        self,
        client: MasterClient,
        interval: float = 15.0,
    ):
        self._client = client
        self._interval = interval
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cpu = CpuSampler()

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="resource-monitor"
            )
            self._thread.start()

    def stop(self):
        self._stopped.set()

    def _sample(self):
        return self._cpu.sample(), _memory_used_mb()

    def _run(self):
        self._cpu.sample()  # prime the sampler
        while not self._stopped.wait(self._interval):
            try:
                cpu, mem_mb = self._sample()
                self._client.report_used_resource(cpu, mem_mb)
            except Exception:
                logger.debug("resource sample failed", exc_info=True)
