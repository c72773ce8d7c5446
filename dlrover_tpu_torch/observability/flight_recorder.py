"""Flight recorder of the port: a bounded ring of host-side step and
event records (the part of ``dlrover_tpu/observability/flight_recorder.py``
the serving engine and the elastic trainer use; the reference's crash
dump to disk is not ported).

The serving engine drops markers here (admissions, finishes, sheds,
migrations) through ``ServingMetrics.annotate``, and ``ElasticTrainer``
records each step, only when a recorder is installed (the worker
runtime installs one); neither creates one. Recording is a deque append
under a lock, off the device path.
"""

import threading
import time
from collections import deque
from typing import Dict, List, Optional


class FlightRecorder:
    """Bounded ring of event records."""

    def __init__(self, capacity: int = 512, meta: Optional[Dict] = None):
        self._lock = threading.Lock()
        self._ring: "deque[Dict]" = deque(maxlen=capacity)
        self.meta = dict(meta or {})

    def record_step(self, step: int, step_time_s: float = 0.0,
                    data_wait_s: float = 0.0, ckpt_block_s: float = 0.0,
                    **extras):
        """Append one step record (the reference's fields)."""
        record = {"step": int(step), "ts": time.time(),
                  "step_time_s": float(step_time_s),
                  "data_wait_s": float(data_wait_s),
                  "ckpt_block_s": float(ckpt_block_s)}
        record.update(extras)
        with self._lock:
            self._ring.append(record)

    def annotate(self, event: str, **fields):
        """Append one event record ``{"event", "ts", **fields}``."""
        record = {"event": str(event), "ts": time.time()}
        record.update(fields)
        with self._lock:
            self._ring.append(record)

    def records(self, last_n: Optional[int] = None) -> List[Dict]:
        with self._lock:
            out = list(self._ring)
        return out[-last_n:] if last_n is not None else out


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def install_recorder(capacity: int = 512,
                     meta: Optional[Dict] = None) -> FlightRecorder:
    """Create the process recorder; idempotent."""
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder(capacity=capacity, meta=meta)
        return _recorder


def active_recorder() -> Optional[FlightRecorder]:
    """The process recorder IF one was installed, else None."""
    return _recorder


def reset_recorder():
    """Tests only."""
    global _recorder
    with _recorder_lock:
        _recorder = None
