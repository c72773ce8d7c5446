"""Cross-process distributed tracing: spans, context propagation, sinks
(the port's copy of ``dlrover_tpu/observability/tracing.py``).

A stdlib-only span layer — ``trace_id``/``span_id``/``parent_id``,
monotonic + wall timestamps, free-form attrs — whose carrier rides the
fleet's work items and the control plane's RPC envelopes
(``common.comm.Message.trace``), so one serving request or one
control-plane call yields ONE tree across processes:

    fleet.request → fleet.attempt (retry/hedge siblings)
      → serving.request → serving.queue_wait / prefill / migrate / decode
    rpc.<Request> (client, retries as attrs) → master.<Request> (server)

- **Disarmed is free.** Every span site starts with one read of the
  module-level ``_tracer`` global (:func:`active_tracer`); when None
  (the default) the site returns the shared :data:`NOOP_SPAN`.
- **Armed is cheap.** A finished span is one dict append into a bounded
  ring plus (when a sink is configured) one buffered JSONL line. A
  server span costs its RPC thread less: one append to a pending queue,
  which a finisher thread turns into its record (:func:`flush`).
- **Hot loops emit retrospectively.** The engine never opens spans
  inside its step loop — it records the timestamps it needs
  (submit/admit/first-token/finish) and emits the whole phase tree in
  one :meth:`Tracer.record_span` burst at completion.
- **Nested ``with span(...)`` blocks form a tree** through the
  per-thread active-span stack; the master's :class:`TraceAggregator`
  keeps recent trees of its own server spans and the spans workers
  push.

Cross-process arming mirrors the fault plane: ``DLROVER_TPU_TRACE_FILE``
names the JSONL sink; a subprocess calls :func:`arm_from_env` early in
main (fleet replica workers and the master do). Records have the
reference's schema, so span files from either package merge.
"""

import atexit
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional

from dlrover_tpu_torch.common.log import logger

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
    """One timed operation. Context-manager friendly::

        with tracing.span("rpc.get", request="TaskRequest") as sp:
            sp.set_attr("bytes", n)

    ``end()`` is idempotent; an exception inside the ``with`` marks the
    span ``status="error"`` and records the exception type.
    """

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "kind",
        "start_wall", "start_mono", "end_mono", "attrs", "status",
        "_tracer", "_token", "_defer",
    )

    def __init__(self, tracer, name, kind, trace_id, parent_id,
                 attrs=None, start_mono=None, start_wall=None):
        self._tracer = tracer
        self._token = None
        self._defer = False  # server_span: record on the finisher thread
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

    # ---- mutation ----------------------------------------------------------

    def set_attr(self, key: str, value) -> "Span":
        self.attrs[str(key)] = value
        return self

    def inc_attr(self, key: str, amount: int = 1) -> int:
        """Counter-style attr: the retried-RPC contract (the SAME span
        carries ``retry: n``, not n sibling spans — at-most-once stays
        visible as one wire operation that was re-sent)."""
        value = int(self.attrs.get(key, 0)) + amount
        self.attrs[str(key)] = value
        return value

    # ---- lifecycle ---------------------------------------------------------

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

    def __enter__(self) -> "Span":
        self._token = self._tracer._activate(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._deactivate(self._token)
        if exc_type is not None and self.status == "ok":
            self.status = "error"
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()
        return False

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


class _NoopSpan:
    """The disarmed return of every span site: same surface as
    :class:`Span`, all no-ops. One shared instance — a disarmed span
    site allocates nothing."""

    __slots__ = ()
    trace_id = span_id = parent_id = None
    status = "noop"

    def set_attr(self, key, value):
        return self

    def inc_attr(self, key, amount=1):
        return 0

    def carrier(self):
        return None

    def end(self, status=None, end_mono=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Process-wide span factory, ring, and JSONL sink.

    Thread model: span *objects* belong to their creating thread (no
    internal locking — the owning site starts and ends them); the ring,
    the export buffer, and the sink file are shared and locked. The
    per-thread *active* span stack drives implicit parenting so nested
    ``with span(...)`` blocks form a tree without plumbing."""

    def __init__(
        self,
        service: str = "",
        sink_path: Optional[str] = None,
        ring_capacity: int = 4096,
        export_capacity: int = 1024,
        on_finish: Optional[Callable[[Dict], None]] = None,
    ):
        self.service = str(service)
        self._sink_path = sink_path
        self._sink_file = None
        self._lock = threading.Lock()
        self._local = threading.local()
        # Finished spans, newest last: the master serves /api/traces
        # from its own ring; workers drain ``exports`` to piggyback
        # span summaries on report RPCs.
        self._ring: "deque[Dict]" = deque(maxlen=ring_capacity)
        self._exports: "deque[Dict]" = deque(maxlen=export_capacity)
        self._dropped = 0
        self._on_finish = on_finish

    # ---- span creation -----------------------------------------------------

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def current(self) -> Optional[Span]:
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def current_carrier(self) -> Optional[Dict[str, str]]:
        sp = self.current()
        return sp.carrier() if sp is not None else None

    def start_span(
        self,
        name: str,
        kind: str = "internal",
        parent=None,
        attrs: Optional[Dict] = None,
        start_mono: Optional[float] = None,
        start_wall: Optional[float] = None,
    ) -> Span:
        """A live span. ``parent`` may be a :class:`Span`, a carrier
        dict from another process, or None — None parents to this
        thread's active span, or starts a fresh trace.

        ``start_mono``/``start_wall`` back-date the span to timestamps
        taken before it could be named (the servicer clocks dispatch
        BEFORE deserializing the request that names the span — §32's
        metric-vs-span agreement depends on both covering the same
        window)."""
        trace_id, parent_id = self._resolve_parent(parent)
        return Span(
            self, name, kind, trace_id, parent_id, attrs,
            start_mono=start_mono, start_wall=start_wall,
        )

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
        timestamps — the hot-loop pattern: the engine/trainer keeps
        plain floats during the loop and emits the whole phase tree in
        one burst at completion. Returns the finished span so children
        can parent to it."""
        trace_id, parent_id = self._resolve_parent(parent)
        now_mono = time.monotonic()
        start_wall = time.time() - (now_mono - start_mono)
        sp = Span(
            self, name, kind, trace_id, parent_id, attrs,
            start_mono=start_mono, start_wall=start_wall,
        )
        sp.status = status
        sp.end(end_mono=max(end_mono, start_mono))
        return sp

    def _resolve_parent(self, parent):
        if parent is None:
            parent = self.current()
        if isinstance(parent, Span):
            return parent.trace_id, parent.span_id
        if isinstance(parent, dict) and parent.get(_CARRIER_TRACE):
            span_id = parent.get(_CARRIER_SPAN)
            return (
                str(parent[_CARRIER_TRACE]),
                str(span_id) if span_id else None,
            )
        return _new_trace_id(), None

    # ---- activation (implicit parenting) -----------------------------------

    def _activate(self, span: Span) -> int:
        stack = self._stack()
        stack.append(span)
        return len(stack) - 1

    def _deactivate(self, token: int):
        stack = self._stack()
        # Defensive truncation, not pop: an abandoned child (site that
        # never exited its ``with``) must not leave the stack lying.
        del stack[token:]

    # ---- finish path -------------------------------------------------------

    def _finish(self, span: Span):
        if span._defer:
            _defer(span)
        else:
            self._record(span)

    def _record(self, span: Span):
        record = span.to_dict()
        if self.service:
            record["service"] = self.service
        record["pid"] = os.getpid()
        with self._lock:
            if len(self._exports) == self._exports.maxlen:
                self._dropped += 1
            self._ring.append(record)
            self._exports.append(record)
            self._write_locked(record)
        if self._on_finish is not None:
            try:
                self._on_finish(record)
            except Exception:  # noqa: BLE001 — observer must not break sites
                logger.debug("trace on_finish hook failed", exc_info=True)

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

    # ---- consumption -------------------------------------------------------

    def finished(self, last_n: Optional[int] = None) -> List[Dict]:
        flush()
        with self._lock:
            out = list(self._ring)
        return out[-last_n:] if last_n is not None else out

    def set_on_finish(self, callback: Optional[Callable[[Dict], None]]):
        """Install (or clear) the finished-span observer — the master
        hooks its TraceAggregator here so its own server spans reach
        /api/traces without a sink round-trip."""
        self._on_finish = callback

    def drain_exports(self, max_n: int = 256) -> List[Dict]:
        """Pop up to ``max_n`` finished spans for piggybacking on a
        report RPC (worker -> master push). Dropped-by-overflow count
        rides along as telemetry honesty."""
        flush()
        out: List[Dict] = []
        with self._lock:
            while self._exports and len(out) < max_n:
                out.append(self._exports.popleft())
        return out

    def close(self):
        flush()
        with self._lock:
            if self._sink_file is not None:
                try:
                    self._sink_file.close()
                except OSError:
                    pass
                self._sink_file = None


# ---------------------------------------------------------------------------
# Deferred finishing: a server span's RPC thread pays one deque append;
# its record, ring and export entries, sink line and on_finish hook are
# made by one finisher thread every _FINISH_POLL_S, or sooner by any read
# (Tracer.finished/drain_exports/close, the aggregator's reads, flush()).
# ---------------------------------------------------------------------------

_FINISH_POLL_S = 0.005
_pending: "deque[Span]" = deque()
_drain_lock = threading.RLock()
_finisher: Optional[threading.Thread] = None
_finisher_lock = threading.Lock()


def flush():
    """Record every deferred span ended so far, of every tracer, in the
    order they ended."""
    with _drain_lock:
        while _pending:
            span = _pending.popleft()
            span._tracer._record(span)


def _finisher_loop():
    while True:
        time.sleep(_FINISH_POLL_S)
        if _pending:
            flush()


def _defer(span: Span):
    _pending.append(span)
    if _finisher is None:
        _start_finisher()


def _start_finisher():
    global _finisher
    with _finisher_lock:
        if _finisher is None:
            thread = threading.Thread(
                target=_finisher_loop, name="trace-finisher", daemon=True
            )
            thread.start()
            _finisher = thread


def _reset_after_fork():
    # The child has no finisher thread, and its parent's pending spans
    # are the parent's to record.
    global _finisher, _drain_lock, _finisher_lock
    _pending.clear()
    _finisher = None
    _drain_lock = threading.RLock()
    _finisher_lock = threading.Lock()


os.register_at_fork(after_in_child=_reset_after_fork)
atexit.register(flush)


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
    (the production default): the site must do nothing else."""
    return _tracer


def arm_from_env(service: str = "") -> Optional[Tracer]:
    """Arm from ``DLROVER_TPU_TRACE_FILE`` (subprocess rigging, the
    fault plane's ``arm_from_env`` pattern). No-op when unset."""
    path = os.getenv(TRACE_FILE_ENV, "")
    if not path:
        return None
    return arm(Tracer(service=service, sink_path=path))


def span(name: str, kind: str = "internal", parent=None, **attrs):
    """Context-managed span site. Disarmed: one global check, returns
    the shared no-op span."""
    tracer = _tracer
    if tracer is None:
        return NOOP_SPAN
    return tracer.start_span(name, kind=kind, parent=parent,
                             attrs=attrs or None)


def server_span(name: str, carrier, start_mono=None, start_wall=None,
                **attrs):
    """A server-side span parented to a remote carrier (or a fresh
    trace when the caller sent none). ``start_mono``/``start_wall``
    optionally back-date it to pre-deserialize dispatch clocks. Its
    finish path (the tracer's lock, the on_finish hook) runs on the
    finisher thread, not in the RPC's window."""
    tracer = _tracer
    if tracer is None:
        return NOOP_SPAN
    parent = carrier if isinstance(carrier, dict) else None
    sp = tracer.start_span(name, kind="server", parent=parent,
                           attrs=attrs or None,
                           start_mono=start_mono, start_wall=start_wall)
    sp._defer = True
    return sp


def current_carrier() -> Optional[Dict[str, str]]:
    """The active span's propagation dict, for stamping onto outbound
    RPC envelopes. Disarmed (or no active span): None."""
    tracer = _tracer
    if tracer is None:
        return None
    return tracer.current_carrier()


def bump_current(key: str, amount: int = 1):
    """Increment a counter attr on the active span (transport retry
    accounting deep inside the stub, where the span object is not in
    scope). Disarmed or spanless: no-op."""
    tracer = _tracer
    if tracer is None:
        return
    sp = tracer.current()
    if sp is not None:
        sp.inc_attr(key, amount)


def record_span(name, start_mono, end_mono, kind="internal", parent=None,
                attrs=None, status="ok"):
    """Module-level retrospective emission; disarmed: one check, None."""
    tracer = _tracer
    if tracer is None:
        return None
    return tracer.record_span(
        name, start_mono, end_mono, kind=kind, parent=parent,
        attrs=attrs, status=status,
    )


# ---------------------------------------------------------------------------
# Master-side aggregation: recent trace trees + file loading
# ---------------------------------------------------------------------------


class TraceAggregator:
    """Bounded store of finished span records keyed by trace, fed by
    the master's own tracer (``on_finish`` hook) and by workers pushing
    drained spans over the existing DiagnosisDataReport verb. Serves
    ``/api/traces``."""

    def __init__(self, max_traces: int = 256, max_spans_per_trace: int = 512):
        self._lock = threading.Lock()
        self._max_traces = max_traces
        self._max_spans = max_spans_per_trace
        # trace_id -> list of span records, insertion-ordered dict as an
        # LRU-by-arrival of traces.
        self._traces: "Dict[str, List[Dict]]" = {}
        # Cap overflows are BOUNDED behavior, not silent behavior: every
        # span lost to trace eviction or a full per-trace bucket is
        # counted, locally and on /metrics (§32 buffer-accounting law).
        self._dropped = {"trace_cap": 0, "span_cap": 0}
        from dlrover_tpu_torch.observability.registry import default_registry

        self._dropped_counter = default_registry().counter(
            "trace_ingest_dropped_total",
            "spans lost at the master's trace aggregator caps",
            labelnames=("reason",),
        )

    def ingest(self, spans: Iterable[Dict]):
        with self._lock:
            for record in spans or ():
                if not isinstance(record, dict):
                    continue
                trace_id = record.get("trace_id")
                if not trace_id:
                    continue
                bucket = self._traces.get(trace_id)
                if bucket is None:
                    bucket = self._traces[trace_id] = []
                    while len(self._traces) > self._max_traces:
                        evicted = self._traces.pop(
                            next(iter(self._traces))
                        )
                        if evicted:
                            self._dropped["trace_cap"] += len(evicted)
                            self._dropped_counter.inc(
                                len(evicted), reason="trace_cap"
                            )
                if len(bucket) < self._max_spans:
                    bucket.append(dict(record))
                else:
                    self._dropped["span_cap"] += 1
                    self._dropped_counter.inc(reason="span_cap")

    def ingest_one(self, record: Dict):
        self.ingest((record,))

    def stats(self) -> Dict:
        """Occupancy + drop accounting for /api/traces and
        /api/control_plane: a bounded buffer that cannot report its
        occupancy and drops is indistinguishable from a lossless one."""
        flush()
        with self._lock:
            spans = sum(len(b) for b in self._traces.values())
            return {
                # Normalized occupancy/drops keys: every bounded
                # buffer on /api/control_plane speaks the same schema.
                "occupancy": spans,
                "drops": sum(self._dropped.values()),
                "traces": len(self._traces),
                "spans": spans,
                "max_traces": self._max_traces,
                "max_spans_per_trace": self._max_spans,
                "dropped": dict(self._dropped),
            }

    def trace_ids(self) -> List[str]:
        flush()
        with self._lock:
            return list(self._traces)

    def spans(self, trace_id: str) -> List[Dict]:
        flush()
        with self._lock:
            return [dict(r) for r in self._traces.get(trace_id, ())]

    def tree(self, trace_id: str) -> List[Dict]:
        """Root-level spans of a trace with nested ``children`` lists
        (a span whose parent never arrived is promoted to root — trees
        must render even when one process's spans were lost)."""
        return build_trees(self.spans(trace_id))

    def recent(self, limit: int = 20) -> List[Dict]:
        """Newest-trace-first summaries for the dashboard list view."""
        flush()
        with self._lock:
            items = list(self._traces.items())[-limit:]
        out = []
        for trace_id, spans in reversed(items):
            roots = [s for s in spans if not s.get("parent_id")]
            root = roots[0] if roots else (spans[0] if spans else {})
            out.append({
                "trace_id": trace_id,
                "root": root.get("name", ""),
                "service": root.get("service", ""),
                "status": root.get("status", ""),
                "dur_s": root.get("dur_s"),
                "spans": len(spans),
            })
        return out


def build_trees(spans: List[Dict]) -> List[Dict]:
    """Nest a flat span list into parent->children trees (shared by the
    aggregator, the query CLI, and the soak's trace invariant)."""
    by_id = {}
    for record in spans:
        node = dict(record)
        node["children"] = []
        by_id[node.get("span_id")] = node
    roots = []
    for node in by_id.values():
        parent = by_id.get(node.get("parent_id"))
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in by_id.values():
        node["children"].sort(key=lambda c: c.get("mono") or 0.0)
    roots.sort(key=lambda c: c.get("mono") or 0.0)
    return roots


def load_spans(paths: Iterable[str]) -> List[Dict]:
    """Read span JSONL files (tolerant of torn tails — a SIGKILLed
    process's last line may be partial)."""
    out: List[Dict] = []
    for path in paths:
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        record = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(record, dict):
                        out.append(record)
        except OSError:
            continue
    return out
