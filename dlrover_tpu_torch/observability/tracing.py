"""Cross-process distributed tracing: spans, context propagation, sinks
(the port's own copy of the span layer of
``dlrover_tpu/observability/tracing.py``: explicit and retrospective
spans, carriers, the ring and the JSONL sink).

A stdlib-only span layer — ``trace_id``/``span_id``/``parent_id``,
monotonic + wall timestamps, free-form attrs — whose carrier rides the
fleet's work items so one serving request yields ONE tree across
processes:

    fleet.request → fleet.attempt (retry/hedge siblings)
      → serving.request → serving.queue_wait / prefill / migrate / decode

- **Disarmed is free.** Every span site starts with one read of the
  module-level ``_tracer`` global (:func:`active_tracer`); when None
  (the default) the site does nothing else.
- **Armed is cheap.** A finished span is one dict append into a bounded
  ring plus (when a sink is configured) one buffered JSONL line.
- **Hot loops emit retrospectively.** The engine never opens spans
  inside its step loop — it records the timestamps it needs
  (submit/admit/first-token/finish) and emits the whole phase tree in
  one :meth:`Tracer.record_span` burst at completion.

Cross-process arming mirrors the fault plane: ``DLROVER_TPU_TRACE_FILE``
names the JSONL sink; a subprocess calls :func:`arm_from_env` early in
main (fleet replica workers do). Records have the reference's schema,
so span files from either package merge.
"""

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

TRACE_FILE_ENV = "DLROVER_TPU_TRACE_FILE"
SCHEMA_VERSION = 1

# Carrier keys (the wire format of a trace context). Deliberately a
# plain dict of two short strings so it pickles/JSONs through every
# transport this repo has (Message envelopes, WorkItem JSONL).
_CARRIER_TRACE = "trace_id"
_CARRIER_SPAN = "span_id"


def _new_trace_id() -> str:
    return os.urandom(12).hex()


def _new_span_id() -> str:
    return os.urandom(6).hex()


class Span:
    """One timed operation: started by :meth:`Tracer.start_span`,
    finished by :meth:`end` (idempotent), or recorded whole by
    :meth:`Tracer.record_span`."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "kind",
        "start_wall", "start_mono", "end_mono", "attrs", "status",
        "_tracer",
    )

    def __init__(self, tracer, name, kind, trace_id, parent_id,
                 attrs=None, start_mono=None, start_wall=None):
        self._tracer = tracer
        self.name = str(name)
        self.kind = str(kind)
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.start_mono = (
            start_mono if start_mono is not None else time.monotonic()
        )
        self.start_wall = (
            start_wall if start_wall is not None
            else time.time() - (time.monotonic() - self.start_mono)
        )
        self.end_mono: Optional[float] = None
        self.attrs: Dict = dict(attrs) if attrs else {}
        self.status = "ok"

    def set_attr(self, key: str, value) -> "Span":
        self.attrs[str(key)] = value
        return self

    def carrier(self) -> Dict[str, str]:
        """The propagation dict a child process/peer parents to."""
        return {_CARRIER_TRACE: self.trace_id, _CARRIER_SPAN: self.span_id}

    def end(self, status: Optional[str] = None,
            end_mono: Optional[float] = None):
        if self.end_mono is not None:
            return  # idempotent: crash paths may race a normal end
        if status is not None:
            self.status = status
        self.end_mono = (
            end_mono if end_mono is not None else time.monotonic()
        )
        self._tracer._finish(self)

    def to_dict(self) -> Dict:
        dur = (
            (self.end_mono - self.start_mono)
            if self.end_mono is not None else None
        )
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "kind": self.kind,
            "ts": self.start_wall,
            "mono": self.start_mono,
            "dur_s": dur,
            "status": self.status,
            "attrs": dict(self.attrs),
        }


class Tracer:
    """Process-wide span factory, ring, and JSONL sink. Span objects
    belong to their creating thread; the ring and the sink file are
    shared and locked."""

    def __init__(
        self,
        service: str = "",
        sink_path: Optional[str] = None,
        ring_capacity: int = 4096,
    ):
        self.service = str(service)
        self._sink_path = sink_path
        self._sink_file = None
        self._lock = threading.Lock()
        # Finished spans, newest last.
        self._ring: "deque[Dict]" = deque(maxlen=ring_capacity)

    def start_span(
        self,
        name: str,
        kind: str = "internal",
        parent=None,
        attrs: Optional[Dict] = None,
    ) -> Span:
        """A live span. ``parent`` may be a :class:`Span`, a carrier
        dict from another process, or None (a fresh trace)."""
        trace_id, parent_id = _resolve_parent(parent)
        return Span(self, name, kind, trace_id, parent_id, attrs)

    def record_span(
        self,
        name: str,
        start_mono: float,
        end_mono: float,
        kind: str = "internal",
        parent=None,
        attrs: Optional[Dict] = None,
        status: str = "ok",
    ) -> Span:
        """Retrospective span from already-recorded monotonic
        timestamps — the hot-loop pattern: the engine keeps plain
        floats during the loop and emits the whole phase tree in one
        burst at completion. Returns the finished span so children can
        parent to it."""
        trace_id, parent_id = _resolve_parent(parent)
        now_mono = time.monotonic()
        start_wall = time.time() - (now_mono - start_mono)
        sp = Span(
            self, name, kind, trace_id, parent_id, attrs,
            start_mono=start_mono, start_wall=start_wall,
        )
        sp.status = status
        sp.end(end_mono=max(end_mono, start_mono))
        return sp

    def _finish(self, span: Span):
        record = span.to_dict()
        if self.service:
            record["service"] = self.service
        record["pid"] = os.getpid()
        with self._lock:
            self._ring.append(record)
            self._write_locked(record)

    def _write_locked(self, record: Dict):
        if not self._sink_path:
            return
        try:
            if self._sink_file is None:
                os.makedirs(
                    os.path.dirname(self._sink_path) or ".", exist_ok=True
                )
                self._sink_file = open(self._sink_path, "a")
            self._sink_file.write(json.dumps(record) + "\n")
            self._sink_file.flush()
        except OSError:
            # A full/vanished disk must not take down the traced job.
            self._sink_path = None
            self._sink_file = None

    def finished(self, last_n: Optional[int] = None) -> List[Dict]:
        with self._lock:
            out = list(self._ring)
        return out[-last_n:] if last_n is not None else out

    def close(self):
        with self._lock:
            if self._sink_file is not None:
                try:
                    self._sink_file.close()
                except OSError:
                    pass
                self._sink_file = None


def _resolve_parent(parent):
    if isinstance(parent, Span):
        return parent.trace_id, parent.span_id
    if isinstance(parent, dict) and parent.get(_CARRIER_TRACE):
        span_id = parent.get(_CARRIER_SPAN)
        return (
            str(parent[_CARRIER_TRACE]),
            str(span_id) if span_id else None,
        )
    return _new_trace_id(), None


# ---------------------------------------------------------------------------
# Process-wide arming (fault_point discipline: disarmed = one global read)
# ---------------------------------------------------------------------------

_tracer: Optional[Tracer] = None
_arm_lock = threading.Lock()


def arm(tracer: Tracer) -> Tracer:
    global _tracer
    with _arm_lock:
        _tracer = tracer
    return tracer


def disarm():
    global _tracer
    with _arm_lock:
        if _tracer is not None:
            _tracer.close()
        _tracer = None


def active_tracer() -> Optional[Tracer]:
    """THE armed-check every span site performs first. None = disarmed
    (the default): the site must do nothing else."""
    return _tracer


def arm_from_env(service: str = "") -> Optional[Tracer]:
    """Arm from ``DLROVER_TPU_TRACE_FILE`` (subprocess rigging, the
    fault plane's ``arm_from_env`` pattern). No-op when unset."""
    path = os.getenv(TRACE_FILE_ENV, "")
    if not path:
        return None
    return arm(Tracer(service=service, sink_path=path))
