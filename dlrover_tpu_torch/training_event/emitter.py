"""Structured training-event SDK: instants and duration spans.

Parity: reference dlrover/python/training_event/ (emitter.py, events as
begin/end pairs with a shared event_id; design
docs/design/training-event.md). Every control-plane state change —
rendezvous rounds, restarts, checkpoint commits, job phases — emits a
structured event so offline tooling can reconstruct exactly where a
job's time went (the input to goodput accounting).

The port's copy of ``dlrover_tpu/training_event/emitter.py``.
"""

import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from dlrover_tpu_torch.training_event.exporter import (
    EventExporter,
    build_default_exporter,
)


class EventType:
    INSTANT = "instant"
    BEGIN = "begin"
    END = "end"


@dataclass
class Event:
    name: str
    event_type: str = EventType.INSTANT
    target: str = ""  # emitting component: master|agent|trainer/...
    event_id: str = ""
    timestamp: float = field(default_factory=time.time)
    pid: int = field(default_factory=os.getpid)
    content: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(
            {
                "name": self.name,
                "type": self.event_type,
                "target": self.target,
                "event_id": self.event_id,
                "ts": round(self.timestamp, 6),
                "pid": self.pid,
                "content": self.content,
            },
            default=str,
        )


class DurationSpan:
    """begin()/end() pair sharing an event_id; usable as a context
    manager (exceptions mark the span failed)."""

    def __init__(self, emitter: "EventEmitter", name: str,
                 content: Optional[Dict] = None):
        self._emitter = emitter
        self.name = name
        self.content = dict(content or {})
        self.event_id = f"{os.getpid()}-{next(_span_counter)}"
        self._began = 0.0

    def begin(self) -> "DurationSpan":
        self._began = time.time()
        self._emitter.emit(
            Event(
                name=self.name,
                event_type=EventType.BEGIN,
                target=self._emitter.target,
                event_id=self.event_id,
                # Copy: callers may mutate span.content before end(),
                # and the async exporter serializes on another thread.
                content=dict(self.content),
            )
        )
        return self

    def end(self, success: bool = True, **extra):
        content = dict(self.content)
        content.update(extra)
        content["success"] = success
        if self._began:
            content["duration_s"] = round(time.time() - self._began, 6)
        self._emitter.emit(
            Event(
                name=self.name,
                event_type=EventType.END,
                target=self._emitter.target,
                event_id=self.event_id,
                content=content,
            )
        )

    def fail(self, error: str = ""):
        self.end(success=False, error=error)

    def __enter__(self):
        return self.begin()

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.end()
        else:
            self.fail(str(exc))
        return False


_span_counter = itertools.count(0)


class EventEmitter:
    def __init__(self, target: str, exporter: Optional[EventExporter] = None):
        self.target = target
        self._exporter = exporter or build_default_exporter()

    def emit(self, event: Event):
        try:
            self._exporter.export(event)
        except Exception:
            pass  # observability must never break the job

    def instant(self, name: str, content: Optional[Dict] = None):
        self.emit(
            Event(
                name=name,
                event_type=EventType.INSTANT,
                target=self.target,
                content=dict(content or {}),
            )
        )

    def duration(self, name: str, content: Optional[Dict] = None) -> DurationSpan:
        return DurationSpan(self, name, content)


_emitters: Dict[str, EventEmitter] = {}
_emitters_lock = threading.Lock()


def get_emitter(target: str) -> EventEmitter:
    with _emitters_lock:
        if target not in _emitters:
            _emitters[target] = EventEmitter(target)
        return _emitters[target]
