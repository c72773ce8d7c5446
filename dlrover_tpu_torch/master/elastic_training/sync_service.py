"""Named barriers across workers.

Parity: reference master/elastic_training/sync_service.py:25 (SyncService).

Blocking-wait audit (ISSUE 5 satellite): the only blocking surface here
is :meth:`wait_finished`; it is bounded by ``DEFAULT_WAIT_TIMEOUT_S``
(overridable per call, never infinite) and every expiry increments
``sync_wait_expired_total`` so a barrier that silently never completes
is visible on /metrics instead of hanging its callers.

The port's copy of ``dlrover_tpu/master/elastic_training/sync_service.py``.
"""

import threading
import time
from typing import Dict, Set

from dlrover_tpu_torch.fault import fault_point

DEFAULT_WAIT_TIMEOUT_S = 300.0


def _sync_metrics():
    from dlrover_tpu_torch.observability.registry import default_registry

    reg = default_registry()
    return (
        reg.counter(
            "sync_wait_expired_total",
            "bounded sync-barrier waits that expired before completion",
        ),
        # §32 wait-depth gauge, same rationale as kv_wait_depth.
        reg.gauge(
            "sync_wait_depth",
            "threads currently blocked in a sync-barrier wait",
        ),
    )


class SyncService:
    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._syncs: Dict[str, Set[int]] = {}
        self._finished: Set[str] = set()
        self._wait_expired, self._wait_depth = _sync_metrics()

    def join_sync(self, sync_name: str, node_rank: int) -> bool:
        with self._cond:
            self._syncs.setdefault(sync_name, set()).add(node_rank)
            return True

    def sync_finished(self, sync_name: str) -> bool:
        with self._cond:
            self._finished.add(sync_name)
            self._cond.notify_all()
            return True

    def query(self, sync_name: str) -> bool:
        with self._lock:
            return sync_name in self._finished

    def wait_finished(
        self, sync_name: str, timeout: float = DEFAULT_WAIT_TIMEOUT_S
    ) -> bool:
        """Block until ``sync_name`` finishes, at most ``timeout``
        seconds. False (plus a metric tick) on expiry — callers degrade
        gracefully (re-poll, proceed degraded, or surface the stall)
        instead of hanging a servicer thread forever."""
        # AFTER the deadline is fixed, so a delay action eats into the
        # wait budget and can push the barrier into its timeout path.
        deadline = time.time() + max(timeout, 0.0)
        fault_point("sync.wait", sync=sync_name)
        self._wait_depth.inc()
        try:
            with self._cond:
                while sync_name not in self._finished:
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        self._wait_expired.inc()
                        return False
                    self._cond.wait(remaining)
                return True
        finally:
            self._wait_depth.dec()

    def journal_snapshot(self) -> dict:
        """Barrier membership/finish state for journal compaction
        (DESIGN.md §37)."""
        with self._lock:
            return {
                "joins": {
                    name: sorted(ranks)
                    for name, ranks in self._syncs.items()
                },
                "finished": sorted(self._finished),
            }

    def restore_journal_state(self, joins, finished):
        """Rehydrate after a master restart: riders re-polling
        ``wait_finished`` on an already-finished barrier must not hang
        on the new incarnation."""
        with self._cond:
            for name, ranks in (joins or {}).items():
                self._syncs.setdefault(name, set()).update(ranks)
            self._finished.update(finished or ())
            self._cond.notify_all()

    def members(self, sync_name: str) -> Set[int]:
        with self._lock:
            return set(self._syncs.get(sync_name, set()))

    def notify_finished_if_all(self, sync_name: str, world: Set[int]) -> bool:
        with self._cond:
            if self._syncs.get(sync_name, set()) >= world:
                self._finished.add(sync_name)
                self._cond.notify_all()
                return True
            return False
