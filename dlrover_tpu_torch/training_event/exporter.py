"""Event exporters: where structured events go.

Parity: reference dlrover/python/training_event/exporter.py — an async
file exporter (JSON lines, one file per process per day) and a console
exporter, selected by env:

- DLROVER_TPU_EVENT_EXPORTER = file|console|off   (default: file)
- DLROVER_TPU_EVENT_DIR      = directory for event files
                               (default: <tempdir>/dlrover_tpu_events;
                               the reference's is /tmp/...)

Loss accounting: the async exporter must never block the training or
control path, so it drops on a full queue — but a silent drop poisons
every downstream consumer (the timeline merger reconstructs goodput
from these files). Drops and write failures are therefore counted in
the observability registry (scraped via the master's /metrics) and
surfaced with a rate-limited warning, and ``close()`` drains whatever
the writer thread did not get to (registered via ``atexit``).

The port's copy of ``dlrover_tpu/training_event/exporter.py``.
"""

import abc
import atexit
import os
import queue
import tempfile
import threading
import time

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability.registry import default_registry

_WARN_INTERVAL_S = 30.0


def _drop_counter():
    return default_registry().counter(
        "training_event_dropped_total",
        "training events dropped on a full exporter queue",
    )


def _write_failure_counter():
    return default_registry().counter(
        "training_event_write_failures_total",
        "training event writes that raised",
    )


def _exported_counter():
    return default_registry().counter(
        "training_event_exported_total",
        "training events successfully written",
    )


class EventExporter(abc.ABC):
    @abc.abstractmethod
    def export(self, event):
        ...

    def close(self):
        pass


class ConsoleExporter(EventExporter):
    def export(self, event):
        logger.info("[event] %s", event.to_json())


class NullExporter(EventExporter):
    def export(self, event):
        pass


class AsyncFileExporter(EventExporter):
    """JSON-lines file writer on a daemon thread; drops events rather
    than ever blocking the training/control path — but counts what it
    drops and flushes its queue on close."""

    def __init__(self, directory: str, max_queue: int = 4096):
        self._dir = directory
        os.makedirs(directory, exist_ok=True)
        # Bind (and thereby pre-register) the loss counters once: a
        # /metrics scrape shows them at 0 from the first scrape
        # (absence != zero drops), and the per-event paths skip the
        # registry lock.
        self._dropped = _drop_counter()
        self._write_failures = _write_failure_counter()
        self._exported = _exported_counter()
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._file = None
        self._file_day = ""
        self._stopped = threading.Event()
        self._closed = False
        self._last_drop_warn = 0.0
        self._last_write_warn = 0.0
        self._thread = threading.Thread(
            target=self._loop, name="event-exporter", daemon=True
        )
        self._thread.start()
        # The interpreter exits through atexit before daemon threads are
        # killed: whatever is still queued gets one last synchronous
        # drain instead of vanishing.
        atexit.register(self.close)

    def export(self, event):
        try:
            self._queue.put_nowait(event)
        except queue.Full:
            self._dropped.inc()
            now = time.monotonic()
            if now - self._last_drop_warn > _WARN_INTERVAL_S:
                self._last_drop_warn = now
                logger.warning(
                    "event exporter queue full; dropping (total dropped: "
                    "%d)",
                    int(self._dropped.value()),
                )

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._stopped.set()
        self._thread.join(timeout=2)
        # The writer thread may have died mid-drain: flush the remainder
        # synchronously so close() means "on disk". Skipped if the
        # thread is somehow still alive (wedged in a write) — two
        # writers interleaving the same line-buffered file is worse
        # than a delayed flush.
        if not self._thread.is_alive():
            while True:
                try:
                    event = self._queue.get_nowait()
                except queue.Empty:
                    break
                self._write(event)
            if self._file:
                self._file.close()
                self._file = None
        # Writer still draining after the join timeout: leave the file
        # to it — closing under a live writer would turn the remaining
        # events into spurious write failures (it's line-buffered, so
        # everything written so far is already on disk).

    def _ensure_file(self):
        day = time.strftime("%Y%m%d")
        if self._file is None or day != self._file_day:
            if self._file:
                self._file.close()
            path = os.path.join(
                self._dir, f"events_{day}_{os.getpid()}.jsonl"
            )
            self._file = open(path, "a", buffering=1)
            self._file_day = day

    def _write(self, event):
        try:
            self._ensure_file()
            self._file.write(event.to_json() + "\n")
            self._exported.inc()
        except Exception:
            self._write_failures.inc()
            now = time.monotonic()
            if now - self._last_write_warn > _WARN_INTERVAL_S:
                self._last_write_warn = now
                logger.warning(
                    "event write failed (total failures: %d)",
                    int(self._write_failures.value()),
                    exc_info=True,
                )

    def _loop(self):
        while not self._stopped.is_set() or not self._queue.empty():
            try:
                event = self._queue.get(timeout=0.5)
            except queue.Empty:
                continue
            self._write(event)


def build_default_exporter() -> EventExporter:
    kind = os.getenv("DLROVER_TPU_EVENT_EXPORTER", "file").lower()
    if kind == "off":
        return NullExporter()
    if kind == "console":
        return ConsoleExporter()
    directory = os.getenv(
        "DLROVER_TPU_EVENT_DIR",
        os.path.join(tempfile.gettempdir(), "dlrover_tpu_events"),
    )
    try:
        return AsyncFileExporter(directory)
    except OSError:
        return ConsoleExporter()
