"""Python-side tracing: GC pauses, arbitrary functions, stack dumps.

The port's copy of ``dlrover_tpu/tpu_timer/py_tracing.py``. Parity:
reference xpu_timer/python/py_tracing_*.cc (dynamic injection tracing
of Python functions — GC, dataloader) and the hang→stack-dump daemon
flow (server/hosting_service). CPython exposes what the reference
needed dlopen tricks for: ``gc.callbacks`` for collector pauses,
decorators for targeted functions, and ``faulthandler`` for all-thread
stack dumps on signal — which is how a wedged worker gets
post-mortemed: the agent sends SIGUSR2 before restarting it, and the
traceback of every thread (including the one stuck in a collective)
lands in the worker log.
"""

import faulthandler
import functools
import gc
import signal
import sys
from typing import Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.tpu_timer.bridge import SpanKind, active_timer

_gc_start_ns = 0
_gc_installed = False


def _gc_callback(phase, info):
    global _gc_start_ns
    timer = active_timer()
    if timer is None:
        return
    if phase == "start":
        _gc_start_ns = timer.now_ns()
    elif phase == "stop" and _gc_start_ns:
        timer.record(
            f"py_gc_gen{info.get('generation', '?')}",
            SpanKind.CUSTOM,
            _gc_start_ns,
            timer.now_ns() - _gc_start_ns,
        )
        _gc_start_ns = 0


def trace_gc():
    """Record every collector pause as a span (GC stalls show up in the
    step-time tail; the reference traces them for the same reason)."""
    global _gc_installed
    if not _gc_installed:
        gc.callbacks.append(_gc_callback)
        _gc_installed = True


def untrace_gc():
    global _gc_installed
    if _gc_callback in gc.callbacks:
        gc.callbacks.remove(_gc_callback)
    _gc_installed = False


def traced(name: Optional[str] = None, kind: int = SpanKind.DATA):
    """Decorator: record every call of ``fn`` as a span (dataloader
    fetches, tokenization, host-side preprocessing...)."""

    def wrap(fn):
        span_name = name or f"py_{fn.__qualname__}"

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            timer = active_timer()
            if timer is None:
                # Profiler not running: zero-cost pass-through (never
                # trigger the native build from a hot data path).
                return fn(*args, **kwargs)
            start = timer.now_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                timer.record(
                    span_name, kind, start, timer.now_ns() - start
                )

        return inner

    return wrap


# ---------------------------------------------------------------------------
# Stack dumps (hang post-mortem)
# ---------------------------------------------------------------------------

STACK_DUMP_SIGNAL = signal.SIGUSR2


def install_stack_dump_handler(fileobj=None):
    """Dump all-thread tracebacks on SIGUSR2 (to stderr by default —
    which the agent redirects into the worker log)."""
    try:
        faulthandler.register(
            STACK_DUMP_SIGNAL, file=fileobj or sys.stderr, all_threads=True
        )
    except (AttributeError, ValueError, OSError):
        logger.warning("stack dump handler not installed", exc_info=True)


def dump_stacks(fileobj=None):
    """Immediate all-thread dump (in-process watchdogs).

    CPython's faulthandler silently caps the dump at 100 threads — in
    a process with many daemon threads (servers, agents, pools) the
    CALLING thread can be among the omitted, which defeats the usual
    "where am I stuck" question. Emit the current stack explicitly
    first in faulthandler-compatible format (the stacks analysis tool
    parses it) once the count EXCEEDS the cap — below it every thread
    is included and a copy would double-count the caller in the stack
    histograms. (Threads spawned between the check and the dump can
    still race past the cap; the guard trades that sliver for
    duplicate-free histograms in the common case.)"""
    f = fileobj or sys.stderr
    if len(sys._current_frames()) > 100:
        # Only when the cap actually binds: below it faulthandler
        # includes every thread and an explicit copy would double-count
        # the caller in the stack histograms. Over the cap, a possible
        # duplicate beats a possible omission. Header matches the
        # analysis tool's thread regex (hex id required) so the
        # explicit stack is parsed, not dropped.
        import threading

        f.write(
            f"Current thread 0x{threading.get_ident():x} "
            "(most recent call first):\n"
        )
        frame = sys._getframe(1)
        while frame is not None:
            code = frame.f_code
            f.write(
                f'  File "{code.co_filename}", line {frame.f_lineno} '
                f"in {code.co_name}\n"
            )
            frame = frame.f_back
        f.write("\n")
        f.flush()
    faulthandler.dump_traceback(file=f, all_threads=True)
