"""Worker-side hang watchdog: rolling deadlines + all-thread stack dumps
(the port's copy of ``dlrover_tpu/observability/hang_watchdog.py``: the
same dump path, JSON schema and deadline rule, so either package's
agent reads the other's dumps).

The master's :class:`TrainingHangDiagnostician` can only see that steps
STOPPED (global-step stagnation); it cannot see WHERE a live-but-wedged
worker is stuck. This module closes that gap from inside the worker:

- :func:`dump_all_stacks` snapshots every Python thread's frames via
  ``sys._current_frames()`` — the evidence that names the blocked frame
  (a collective wait, a lock, a storage read). It touches no CUDA state,
  so a worker stuck in a device synchronize is still dumped.
- :class:`HangWatchdog` tracks a progress beacon (``beat()`` after every
  step / request completion) and a ROLLING deadline — a multiple of the
  EWMA of recent beat intervals, floored — so a job whose steps take 2s
  and a job whose steps take 90s both get a meaningful "too long". On
  expiry it writes a flight-recorder-style JSON dump (ring-adjacent
  path, atomic rename) the agent collects, and fires at most once per
  hang (re-arming on the next beat).

The agent reports the dump to the master (``agent/training.py``) as
``stack_dump`` diagnosis data.
"""

import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability import flight_recorder

SCHEMA_VERSION = 1


def dump_all_stacks() -> Dict[str, List[str]]:
    """{thread label: [frame strings, innermost last]} for every live
    Python thread. Pure introspection — safe to call from signal
    handlers and watchdog threads; never raises."""
    try:
        frames = sys._current_frames()
    except Exception:  # noqa: BLE001 — diagnosis must not throw
        return {}
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for ident, frame in frames.items():
        label = f"{names.get(ident, 'unknown')}-{ident}"
        try:
            stack = [
                f"{fs.filename}:{fs.lineno} {fs.name}"
                for fs in traceback.extract_stack(frame)
            ]
        except Exception:  # noqa: BLE001
            stack = ["<unreadable>"]
        out[label] = stack
    return out


def hang_dump_path(node_rank: int, local_rank: int) -> str:
    """Same pure-function contract as ``flight_recorder.dump_path`` so
    the agent can reconstruct it for a worker it did not spawn."""
    return os.path.join(
        flight_recorder.flight_dir(),
        f"hang_node{node_rank}_rank{local_rank}.json",
    )


def write_stack_dump(
    path: str,
    reason: str = "",
    meta: Optional[Dict] = None,
    extra: Optional[Dict] = None,
) -> Optional[str]:
    """Atomic all-thread stack dump (tmp + rename, the flight-recorder
    dump discipline). Returns the path, or None on failure — runs on
    watchdog/signal paths and must never raise."""
    try:
        record = {
            "schema": SCHEMA_VERSION,
            "kind": "stack_dump",
            "reason": reason,
            "dumped_at": time.time(),
            "pid": os.getpid(),
            "meta": dict(meta or {}),
            "stacks": dump_all_stacks(),
        }
        if extra:
            record.update(extra)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, path)
        return path
    except Exception:  # noqa: BLE001 — crash-adjacent path
        return None


class HangWatchdog:
    """Rolling-deadline hang detector around a progress beacon.

    ``beat()`` after every unit of progress (a training step, a served
    request). ``check()`` — called by the background thread, or directly
    by tests with a fake clock — compares silence against the rolling
    deadline ``max(min_deadline_s, deadline_factor x EWMA(beat gap))``
    and dumps all-thread stacks once per hang episode."""

    def __init__(
        self,
        name: str = "train",
        dump_path: Optional[str] = None,
        deadline_factor: float = 8.0,
        min_deadline_s: float = 30.0,
        poll_interval_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        on_hang: Optional[Callable[[Dict], None]] = None,
        meta: Optional[Dict] = None,
    ):
        self.name = str(name)
        self._dump_path = dump_path
        self._factor = float(deadline_factor)
        self._min_deadline_s = float(min_deadline_s)
        self._poll_interval_s = float(poll_interval_s)
        self._clock = clock
        self._on_hang = on_hang
        self._meta = dict(meta or {})
        self._lock = threading.Lock()
        self._last_beat: Optional[float] = None
        self._gap_ewma: Optional[float] = None
        self._beats = 0
        self._fired_this_hang = False
        self.dumps = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        from dlrover_tpu_torch.observability.registry import default_registry

        self._dump_counter = default_registry().counter(
            "hang_watchdog_dumps_total",
            "stack dumps captured by the hang watchdog",
        )

    # ---- beacon ------------------------------------------------------------

    def beat(self, now: Optional[float] = None):
        now = now if now is not None else self._clock()
        with self._lock:
            # A beat that ENDS a detected hang does not feed the EWMA:
            # the pathological gap is exactly what the rolling deadline
            # must not normalize toward.
            if self._last_beat is not None and not self._fired_this_hang:
                gap = max(now - self._last_beat, 0.0)
                self._gap_ewma = (
                    gap if self._gap_ewma is None
                    else 0.3 * gap + 0.7 * self._gap_ewma
                )
            self._last_beat = now
            self._beats += 1
            self._fired_this_hang = False

    def deadline_s(self) -> float:
        with self._lock:
            ewma = self._gap_ewma or 0.0
        return max(self._min_deadline_s, self._factor * ewma)

    # ---- detection ---------------------------------------------------------

    def check(self, now: Optional[float] = None) -> Optional[str]:
        """One watchdog evaluation; returns the dump path when this call
        captured a hang, else None."""
        now = now if now is not None else self._clock()
        with self._lock:
            if self._last_beat is None or self._fired_this_hang:
                return None
            silence = now - self._last_beat
        deadline = self.deadline_s()
        if silence <= deadline:
            return None
        with self._lock:
            if self._fired_this_hang:
                return None
            self._fired_this_hang = True
        self.dumps += 1
        self._dump_counter.inc()
        info = {
            "name": self.name,
            "hang_for_s": round(silence, 3),
            "deadline_s": round(deadline, 3),
            "beats": self._beats,
        }
        logger.warning(
            "hang watchdog %s: no progress for %.1fs (deadline %.1fs); "
            "dumping all-thread stacks",
            self.name, silence, deadline,
        )
        path = None
        if self._dump_path:
            path = write_stack_dump(
                self._dump_path,
                reason=f"hang:{self.name}",
                meta=self._meta,
                extra=info,
            )
        if self._on_hang is not None:
            try:
                report = dict(info)
                report["stacks"] = dump_all_stacks()
                self._on_hang(report)
            except Exception:  # noqa: BLE001 — diagnosis best-effort
                logger.debug("hang watchdog hook failed", exc_info=True)
        # Truthy even when no dump path is configured (in-process hooks
        # only): callers distinguish "fired" from "still fine".
        return path or "captured"

    # ---- background thread -------------------------------------------------

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"hang-watchdog-{self.name}",
            daemon=True,
        )
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _run(self):
        while not self._stop.wait(self._poll_interval_s):
            try:
                self.check()
            except Exception:  # noqa: BLE001 — the watchdog never dies
                logger.debug("hang watchdog check failed", exc_info=True)


# ---------------------------------------------------------------------------
# Process-wide watchdog (flight-recorder discipline)
# ---------------------------------------------------------------------------

_watchdog: Optional[HangWatchdog] = None
_watchdog_lock = threading.Lock()


def install_watchdog(
    node_rank: int = 0,
    local_rank: int = 0,
    **kwargs,
) -> HangWatchdog:
    """Create + start the process watchdog (idempotent), dumping to the
    agent-collectable ``hang_dump_path``."""
    global _watchdog
    with _watchdog_lock:
        if _watchdog is not None:
            return _watchdog
        kwargs.setdefault(
            "dump_path", hang_dump_path(node_rank, local_rank)
        )
        meta = kwargs.pop("meta", {})
        meta.setdefault("node_rank", node_rank)
        meta.setdefault("local_rank", local_rank)
        wd = HangWatchdog(meta=meta, **kwargs)
        wd.start()
        _watchdog = wd
        return wd


def active_watchdog() -> Optional[HangWatchdog]:
    return _watchdog


def reset_watchdog():
    """Tests only."""
    global _watchdog
    with _watchdog_lock:
        if _watchdog is not None:
            _watchdog.stop()
        _watchdog = None


def collect_hang_dumps(node_rank: int, local_ranks,
                       max_age_s: Optional[float] = None) -> Dict[int, Dict]:
    """Agent-side fetch, mirroring ``flight_recorder.collect_dumps``."""
    out: Dict[int, Dict] = {}
    now = time.time()
    for lr in local_ranks:
        path = hang_dump_path(node_rank, lr)
        try:
            if max_age_s is not None and (
                now - os.path.getmtime(path) > max_age_s
            ):
                continue
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(data, dict) and data.get("kind") == "stack_dump":
            out[lr] = data
    return out
