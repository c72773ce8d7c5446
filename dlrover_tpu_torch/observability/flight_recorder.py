"""Per-step flight recorder: the last N steps of every worker survive it
(the port's copy of ``dlrover_tpu/observability/flight_recorder.py``:
the same dump paths and JSON schema, so either package's agent reads
the other's dumps).

A fixed-size ring of per-step timing records — data-wait, step wall
time, checkpoint-blocked time, the rendezvous round — kept entirely on
the host side of the training loop (plain Python floats; recording is a
deque append under a lock, nothing on the device path). On crash,
SIGTERM, or interpreter exit the ring is dumped as JSON to a per-worker
path the agent knows how to find, so diagnosis can read exactly what
the dead worker's last steps looked like (was it data-starved or
checkpoint-blocked just before it died?). SIGUSR1 dumps the ring and
every thread's stack to a sibling path and the worker keeps running.

The serving engine drops markers here (admissions, finishes, sheds,
migrations) through ``ServingMetrics.annotate``, and ``ElasticTrainer``
records each step, only when a recorder is installed; neither creates
one.

Worker side (wired by ``trainer/runtime.init_distributed``)::

    rec = flight_recorder.active_recorder()
    rec.record_step(step, step_time_s=dt, data_wait_s=w)

Agent side (``agent/training.py`` on worker death)::

    dumps = flight_recorder.collect_dumps(node_rank, range(nproc))
"""

import json
import os
import signal
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

from dlrover_tpu_torch.common.log import logger

FLIGHT_DIR_ENV = "DLROVER_TPU_FLIGHT_DIR"
SCHEMA_VERSION = 1


def flight_dir() -> str:
    return os.getenv(
        FLIGHT_DIR_ENV,
        os.path.join(tempfile.gettempdir(), "dlrover_tpu_flight"),
    )


def dump_path(node_rank: int, local_rank: int) -> str:
    """The agent reconstructs this same path to fetch a dead worker's
    ring — keep it a pure function of (node_rank, local_rank)."""
    return os.path.join(
        flight_dir(), f"flight_node{node_rank}_rank{local_rank}.json"
    )


class FlightRecorder:
    """Bounded ring of step records + crash-dump plumbing."""

    def __init__(
        self,
        capacity: int = 512,
        meta: Optional[Dict] = None,
        registry=None,
    ):
        self._lock = threading.Lock()
        self._ring: "deque[Dict]" = deque(maxlen=capacity)
        self.meta = dict(meta or {})
        self._dump_target: Optional[str] = None
        self._installed_signals: Dict[int, object] = {}
        if registry is None:
            from dlrover_tpu_torch.observability.registry import (
                default_registry,
            )

            registry = default_registry()
        self._step_hist = registry.histogram(
            "flight_step_seconds",
            "per-step wall time recorded by the flight recorder",
        )
        self._steps_total = registry.counter(
            "flight_steps_recorded_total",
            "steps recorded by the flight recorder",
        )

    # ---- recording (hot path: host Python between steps) ------------------

    def record_step(
        self,
        step: int,
        step_time_s: float = 0.0,
        data_wait_s: float = 0.0,
        ckpt_block_s: float = 0.0,
        rdzv_round: int = -1,
        **extras,
    ):
        record = {
            "step": int(step),
            "ts": time.time(),
            "step_time_s": float(step_time_s),
            "data_wait_s": float(data_wait_s),
            "ckpt_block_s": float(ckpt_block_s),
            "rdzv_round": int(rdzv_round),
        }
        if extras:
            record.update(extras)
        with self._lock:
            self._ring.append(record)
        self._step_hist.observe(record["step_time_s"])
        self._steps_total.inc()

    def annotate(self, event: str, **fields):
        """Append a non-step event record (checkpoint restore, re-mesh,
        ...) to the ring. It rides the same crash dump / timeline merge
        as step records but touches no step metrics."""
        record = {"event": str(event), "ts": time.time()}
        record.update(fields)
        with self._lock:
            self._ring.append(record)

    def records(self, last_n: Optional[int] = None) -> List[Dict]:
        """The ring's records, oldest first (the last ``last_n``)."""
        with self._lock:
            out = list(self._ring)
        return out[-last_n:] if last_n is not None else out

    # ---- snapshots / dumps -------------------------------------------------

    def snapshot(self, last_n: Optional[int] = None) -> Dict:
        # Bounded acquire: dump() runs inside signal handlers on the
        # MAIN thread, which may have interrupted record_step while it
        # held this (non-reentrant) lock — a blocking acquire would
        # deadlock the dying worker. On timeout the interrupted frame
        # is frozen until we return, so reading without the lock is
        # safe from it; other threads racing an append at worst cost
        # one retry of the list copy.
        acquired = self._lock.acquire(timeout=1.0)
        try:
            for _ in range(3):
                try:
                    steps = list(self._ring)
                    break
                except RuntimeError:  # deque mutated during iteration
                    continue
            else:
                steps = []
        finally:
            if acquired:
                self._lock.release()
        if last_n is not None:
            steps = steps[-last_n:]
        return {
            "schema": SCHEMA_VERSION,
            "meta": dict(self.meta),
            "dumped_at": time.time(),
            "pid": os.getpid(),
            "steps": steps,
        }

    def dump(self, path: Optional[str] = None,
             with_stacks: bool = False) -> Optional[str]:
        """Atomic JSON dump (tmp + rename: the agent may read while the
        worker is dying). Returns the path, or None on failure — the
        dump runs on crash paths and must never raise.

        ``with_stacks`` adds every thread's current frames (the
        on-demand SIGUSR1 diagnostics payload)."""
        path = path or self._dump_target
        if not path:
            return None
        try:
            snapshot = self.snapshot()
            if with_stacks:
                from dlrover_tpu_torch.observability.hang_watchdog import (
                    dump_all_stacks,
                )

                snapshot["stacks"] = dump_all_stacks()
                snapshot["on_demand"] = True
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(snapshot, f)
            os.replace(tmp, path)
            return path
        except Exception:  # noqa: BLE001 - crash path
            return None

    # ---- crash hooks -------------------------------------------------------

    def install_crash_dump(
        self,
        path: str,
        signals: Iterable[int] = (signal.SIGTERM,),
    ):
        """Dump the ring when the process dies abnormally: on the given
        signals (chaining any previous handler), on an unhandled
        exception, and at interpreter exit (covers clean exits too —
        a fresh dump file is never wrong)."""
        import atexit

        self._dump_target = path

        for signum in signals:
            try:
                prev = signal.signal(signum, self._make_handler(signum))
                self._installed_signals[signum] = prev
            except (ValueError, OSError):  # non-main thread / weird env
                pass

        prev_hook = sys.excepthook

        def hook(exc_type, exc, tb):
            self.dump()
            prev_hook(exc_type, exc, tb)

        sys.excepthook = hook
        atexit.register(self.dump)

    def on_demand_path(self) -> Optional[str]:
        """Sibling of the crash-dump path: the exit/crash dump must not
        clobber an operator's on-demand capture (atexit re-dumps the
        ring on every clean exit)."""
        if not self._dump_target:
            return None
        base, ext = os.path.splitext(self._dump_target)
        return f"{base}.ondemand{ext or '.json'}"

    def install_on_demand_dump(self, signum: Optional[int] = None):
        """SIGUSR1 = live diagnostics: dump the ring PLUS all-thread
        stacks to an agent-collectable sibling path and KEEP RUNNING —
        an operator (or the agent, suspecting a wedge) can interrogate
        a worker without killing it. Previous crash/SIGTERM behavior
        is untouched; the handler never re-raises the signal."""
        if signum is None:
            signum = getattr(signal, "SIGUSR1", None)
            if signum is None:  # platform without SIGUSR1
                return

        def handler(sig, frame):
            # No logging in the handler: the signal may have interrupted
            # a frame holding the logging module's non-reentrant handler
            # lock — logger.info here would deadlock the very process
            # this dump is meant to leave running. The dump path is a
            # pure function of (node_rank, local_rank); operators know
            # where to look.
            self.dump(path=self.on_demand_path(), with_stacks=True)

        try:
            signal.signal(signum, handler)
        except (ValueError, OSError):  # non-main thread / weird env
            pass

    def _make_handler(self, signum):
        def handler(sig, frame):
            self.dump()
            prev = self._installed_signals.get(signum)
            if callable(prev):
                prev(sig, frame)
                return
            if prev == signal.SIG_IGN:
                # The process had deliberately ignored this signal
                # (e.g. a supervisor-managed drain); keep ignoring it.
                return
            # Default disposition: re-deliver so the exit code still
            # says "killed by signal" (the agent's monitor reads it).
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

        return handler


# ---------------------------------------------------------------------------
# Process-wide recorder (wired by trainer/runtime.init_distributed)
# ---------------------------------------------------------------------------

_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def install_recorder(
    node_rank: Optional[int] = None,
    local_rank: Optional[int] = None,
    capacity: int = 512,
    meta: Optional[Dict] = None,
) -> FlightRecorder:
    """Create the process recorder and arm its crash dump; idempotent.
    Without ``node_rank`` and ``local_rank`` (an in-process engine or a
    test) the ring is kept with no dump armed: no signal handler, hook
    or exit dump is installed."""
    global _recorder
    with _recorder_lock:
        if _recorder is not None:
            return _recorder
        if node_rank is None or local_rank is None:
            _recorder = FlightRecorder(capacity=capacity, meta=meta)
            return _recorder
        full_meta = {"node_rank": node_rank, "local_rank": local_rank}
        full_meta.update(meta or {})
        rec = FlightRecorder(capacity=capacity, meta=full_meta)
        rec.install_crash_dump(dump_path(node_rank, local_rank))
        rec.install_on_demand_dump()
        _recorder = rec
        logger.info(
            "flight recorder armed -> %s",
            dump_path(node_rank, local_rank),
        )
        return rec


def active_recorder() -> Optional[FlightRecorder]:
    """The process recorder IF one was installed, else None — callers on
    the training path must not create one as a side effect."""
    return _recorder


def reset_recorder():
    """Tests only."""
    global _recorder
    with _recorder_lock:
        _recorder = None


# ---------------------------------------------------------------------------
# Agent-side retrieval
# ---------------------------------------------------------------------------


def load_dump(path: str) -> Optional[Dict]:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(data, dict) or "steps" not in data:
        return None
    return data


def collect_dumps(
    node_rank: int,
    local_ranks: Iterable[int],
    max_age_s: Optional[float] = None,
    last_n: Optional[int] = None,
) -> Dict[int, Dict]:
    """The agent's fetch after worker death: {local_rank: dump}. Stale
    files from a previous incarnation are skipped via ``max_age_s``."""
    out: Dict[int, Dict] = {}
    now = time.time()
    for lr in local_ranks:
        path = dump_path(node_rank, lr)
        if max_age_s is not None:
            try:
                if now - os.path.getmtime(path) > max_age_s:
                    continue
            except OSError:
                continue
        dump = load_dump(path)
        if dump is None:
            continue
        if last_n is not None:
            dump = dict(dump)
            dump["steps"] = dump["steps"][-last_n:]
        out[lr] = dump
    return out


def last_steps(dump: Dict, n: int = 16) -> List[Dict]:
    return list(dump.get("steps", []))[-n:]
