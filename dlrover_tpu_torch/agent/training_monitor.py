"""Metrics-file training monitor: zero-code-change step reporting.

Parity: reference elastic_agent/monitor/training.py:75
(TorchTrainingMonitor) — a training loop that does NOT use this repo's
trainer library (and therefore never talks RPC) can still feed the
master's perf/goodput accounting by appending JSON lines to a metrics
file; the AGENT tails the file and reports global steps upstream.

Worker side (any framework, no imports from this repo required):

    with open(os.environ["DLROVER_TPU_METRICS_FILE"], "a") as f:
        f.write(json.dumps({"step": step, "ts": time.time()}) + "\\n")

or use the helper ``report_step`` below. Agent side: ``run.py`` starts
a TrainingMonitor when DLROVER_TPU_METRICS_FILE is set.

The port's copy of ``dlrover_tpu/agent/training_monitor.py``.
"""

import json
import os
import threading
import time
from typing import Optional

from dlrover_tpu_torch.common.log import logger

METRICS_FILE_ENV = "DLROVER_TPU_METRICS_FILE"


def report_step(step: int, **extra):
    """Worker-side helper: append a step record to the metrics file
    (no-op when the env is absent, so library code can always call)."""
    path = os.getenv(METRICS_FILE_ENV, "")
    if not path:
        return
    record = {"step": int(step), "ts": time.time()}
    record.update(extra)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


class TrainingMonitor:
    """Agent-resident tail loop over the metrics file; reports the
    newest global step to the master on an interval."""

    def __init__(
        self,
        client,
        metrics_path: str,
        interval: float = 15.0,
    ):
        self._client = client
        self._path = metrics_path
        self._interval = interval
        self._offset = 0  # BYTE offset (the file is read in binary)
        self._inode: Optional[int] = None
        self._last_reported = -1
        self._start_ts: Optional[float] = None
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # poll_once is called from the tail thread AND from shutdown
        # flushes; the offset bookkeeping must never run concurrently.
        self._poll_lock = threading.Lock()
        from dlrover_tpu_torch.observability.registry import default_registry

        self._resets_counter = default_registry().counter(
            "training_monitor_tail_resets_total",
            "metrics-file truncations/rotations the tail loop recovered "
            "from",
        )

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="training-monitor"
            )
            self._thread.start()
            logger.info("training monitor tailing %s", self._path)

    def stop(self):
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=self._interval + 5)

    def _reset_tail(self):
        """Back to the top of the (new) file; a restarted worker may
        REPLAY earlier steps (resumed from its checkpoint) — the step
        watermark must reset with the offset or the master sees a
        frozen global step for the whole replayed range."""
        self._offset = 0
        self._last_reported = -1
        self._start_ts = None
        self._resets_counter.inc()

    def _read_new_records(self):
        try:
            stat = os.stat(self._path)
        except OSError:
            return []
        size = stat.st_size
        if self._inode is None:
            self._inode = stat.st_ino
        elif stat.st_ino != self._inode:
            # Rotated (rename + recreate): the new file can be LARGER
            # than the old offset, so a size check alone would silently
            # read from the middle of it forever.
            self._inode = stat.st_ino
            self._reset_tail()
        if size < self._offset:
            # Truncated in place.
            self._reset_tail()
        if size == self._offset:
            return []
        # Binary read: offsets are byte positions, immune to non-ASCII
        # JSON from third-party writers.
        with open(self._path, "rb") as f:
            f.seek(self._offset)
            chunk = f.read()
            # Only consume complete lines; a mid-write tail stays for
            # the next poll.
            last_nl = chunk.rfind(b"\n")
            if last_nl < 0:
                return []
            self._offset += last_nl + 1
            chunk = chunk[: last_nl + 1]
        records = []
        for line in chunk.decode("utf-8", errors="replace").splitlines():
            try:
                records.append(json.loads(line))
            except ValueError:
                continue
        return records

    def poll_once(self) -> Optional[int]:
        """Read new records and report the newest step; returns it."""
        with self._poll_lock:
            return self._poll_locked()

    def _poll_locked(self) -> Optional[int]:
        records = self._read_new_records()
        steps = [
            r["step"]
            for r in records
            if isinstance(r.get("step"), int)
        ]
        if not records:
            return None
        if self._start_ts is None:
            self._start_ts = records[0].get("ts", time.time())
        if not steps:
            return None
        newest = max(steps)
        if newest > self._last_reported:
            self._last_reported = newest
            elapsed = max(
                records[-1].get("ts", time.time()) - self._start_ts, 0.0
            )
            try:
                self._client.report_global_step(newest, elapsed)
            except Exception:
                logger.warning("step report failed", exc_info=True)
        return newest

    def _run(self):
        while not self._stopped.wait(self._interval):
            try:
                self.poll_once()
            except Exception:
                logger.warning("training monitor poll failed", exc_info=True)
