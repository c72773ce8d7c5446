"""Master-hosted KV store used by workers as a rendezvous store / barrier.

Parity: reference master KV store served via servicer kv_store RPCs and
consumed by elastic_agent/torch/master_kv_store.py. JAX side consumes it
for exit barriers and cross-host handshakes that must not ride collectives.

The port's copy of ``dlrover_tpu/master/elastic_training/kv_store.py``.
"""

import threading
import time
from typing import Dict, List

# Blocking-wait audit (ISSUE 5 satellite): ``wait`` is the only
# blocking surface; its default is bounded and every expiry ticks
# ``kv_wait_expired_total`` so a key that never arrives is a metric,
# not a silent hang.
DEFAULT_WAIT_TIMEOUT_S = 300.0


def _kv_metrics():
    from dlrover_tpu_torch.observability.registry import default_registry

    reg = default_registry()
    return (
        reg.counter(
            "kv_wait_expired_total",
            "bounded KV-store waits that expired before all keys arrived",
        ),
        # §32 wait-depth gauge: servicer threads parked inside wait()
        # RIGHT NOW — at fleet scale a stuck producer shows up here
        # before it shows up as thread-pool exhaustion.
        reg.gauge(
            "kv_wait_depth",
            "threads currently blocked in a KV-store wait",
        ),
    )


class KVStoreService:
    def __init__(self):
        self._store: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._wait_expired, self._wait_depth = _kv_metrics()

    def set(self, key: str, value: bytes):
        with self._cond:
            self._store[key] = value
            self._cond.notify_all()

    def get(self, key: str) -> bytes:
        with self._lock:
            return self._store.get(key, b"")

    def add(self, key: str, delta: int) -> int:
        with self._cond:
            current = int(self._store.get(key, b"0") or b"0")
            current += delta
            self._store[key] = str(current).encode()
            self._cond.notify_all()
            return current

    def multi_get(self, keys: List[str]) -> Dict[str, bytes]:
        with self._lock:
            return {k: self._store[k] for k in keys if k in self._store}

    def wait(
        self, keys: List[str], timeout: float = DEFAULT_WAIT_TIMEOUT_S
    ) -> bool:
        deadline = time.time() + max(timeout, 0.0)
        self._wait_depth.inc()
        try:
            with self._cond:
                while not all(k in self._store for k in keys):
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        self._wait_expired.inc()
                        return False
                    self._cond.wait(remaining)
                return True
        finally:
            self._wait_depth.dec()

    def size(self) -> int:
        with self._lock:
            return len(self._store)

    def dump(self) -> Dict[str, bytes]:
        """Full copy for journal snapshot compaction (DESIGN.md §37)."""
        with self._lock:
            return dict(self._store)

    def delete(self, key: str):
        with self._lock:
            self._store.pop(key, None)

    def clear(self):
        with self._lock:
            self._store.clear()
