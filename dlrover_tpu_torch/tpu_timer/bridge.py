"""ctypes bridge to the native tpu_timer runtime (``libtpu_timer``).

The port's copy of ``dlrover_tpu/tpu_timer/bridge.py``. Parity:
reference xpu_timer's py side (py_xpu_timer) + the LD_PRELOAD hook
layer (nvidia/hook.cc). Spans are fed explicitly from Python at the
natural sync points (train steps, checkpoint phases, GC pauses) and the
device kernels arrive from ``torch.profiler`` windows
(``xla_capture``), while everything that must survive a wedged Python
runtime — trace ring, aggregation, Prometheus daemon, hang watchdog —
is native.

The library is built at first use with one ``g++`` call (no
third-party dependencies) into ``build/torch_native/`` at the
repository root, named by a hash of the sources and the flags, under a
file lock: concurrent first uses in sibling workers build it once, and
nobody loads a half-written file. The source tree is never written.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Optional, Sequence

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import logger

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native" / "tpu_timer"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
LIB_SOURCES = ("tpu_timer.cc", "tpu_timer.h")
LIB_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")


class SpanKind:
    STEP = 0
    COMPILE = 1
    CHECKPOINT = 2
    COLLECTIVE = 3
    DATA = 4
    CUSTOM = 9


def port_file_path(local_rank: int) -> str:
    """Where a worker publishes its daemon's actually-bound port (the
    launcher-side collector re-reads it before each scrape)."""
    job = os.getenv(NodeEnv.JOB_NAME, "job")
    return os.path.join(
        tempfile.gettempdir(), f"dlrover_tpu_timer_{job}_{local_rank}.port"
    )


def publish_port(local_rank: int, port: int):
    path = port_file_path(local_rank)
    tmp = f"{path}.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(str(port))
    os.rename(tmp, path)


def native_build(name: str, sources: Sequence[str], flags: Sequence[str],
                 libs: Sequence[str] = (), timeout: float = 120.0) -> str:
    """Build ``name`` from ``sources`` (under ``NATIVE_DIR``; the first
    is compiled) with ``g++ flags`` into ``BUILD_DIR``, once: the file
    carries a hash of the sources and the flags, so an edited source
    builds anew. Bounded: a lock held past ``timeout`` raises
    ``TimeoutError``, a failed compile ``CalledProcessError``."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update((NATIVE_DIR / src).read_bytes())
    digest.update(" ".join(list(flags) + list(libs)).encode())
    stem, dot, ext = name.partition(".")
    out = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}{dot}{ext}"
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    deadline = time.monotonic() + timeout
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        while True:
            try:
                fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"build lock in {BUILD_DIR} held past {timeout}s")
                time.sleep(0.1)
        try:
            if not out.exists():
                logger.info("building %s (first use)", out.name)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", *flags, str(NATIVE_DIR / sources[0]), "-o",
                     str(tmp), *libs],
                    check=True, capture_output=True,
                    timeout=max(deadline - time.monotonic(), 10.0))
                os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return str(out)


def library_path() -> str:
    """``libtpu_timer``, built first if needed."""
    return native_build("libtpu_timer.so", LIB_SOURCES, LIB_FLAGS,
                        ("-pthread",))


def _load_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(library_path())
    lib.tt_init.argtypes = [ctypes.c_int64]
    lib.tt_start_server.argtypes = [ctypes.c_int]
    lib.tt_start_server.restype = ctypes.c_int
    lib.tt_begin.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.tt_begin.restype = ctypes.c_int64
    lib.tt_end.argtypes = [ctypes.c_int64, ctypes.c_double]
    lib.tt_record.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_double,
    ]
    lib.tt_set_gauge.argtypes = [ctypes.c_char_p, ctypes.c_double]
    lib.tt_counter_add.argtypes = [ctypes.c_char_p, ctypes.c_double]
    lib.tt_hang_count.restype = ctypes.c_int
    lib.tt_now_ns.restype = ctypes.c_int64
    lib.tt_dump_timeline.argtypes = [ctypes.c_char_p]
    lib.tt_metrics_text.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.tt_metrics_text.restype = ctypes.c_int
    return lib


class TpuTimer:
    """Process-wide profiler handle (native singleton underneath)."""

    _instance: Optional["TpuTimer"] = None
    _lock = threading.Lock()

    def __init__(self, hang_timeout_s: float = 600.0):
        self._lib = _load_lib()
        self._lib.tt_init(int(hang_timeout_s * 1000))
        self.port = 0

    @classmethod
    def get(cls) -> "TpuTimer":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    # ---- daemon -------------------------------------------------------------

    def start_server(self, port: int = 0) -> int:
        """Start the metrics/timeline HTTP daemon; returns the bound port
        (reference xpu_timer daemon :18889)."""
        self.port = self._lib.tt_start_server(port)
        if self.port:
            logger.info("tpu_timer daemon on port %d", self.port)
        return self.port

    # ---- spans --------------------------------------------------------------

    @contextmanager
    def span(self, name: str, kind: int = SpanKind.CUSTOM, flops: float = 0.0):
        sid = self._lib.tt_begin(name.encode(), kind)
        try:
            yield
        finally:
            self._lib.tt_end(sid, flops)

    def record(
        self,
        name: str,
        kind: int,
        start_ns: int,
        dur_ns: int,
        flops: float = 0.0,
    ):
        self._lib.tt_record(name.encode(), kind, start_ns, dur_ns, flops)

    def timed_step(self, step_fn, name: str = "train_step",
                   flops_per_step: float = 0.0):
        """Wrap a train step: the span waits for the card (the CUDA
        counterpart of the reference's ``jax.block_until_ready``), so it
        covers device execution."""

        def wrapped(*args, **kwargs):
            sid = self._lib.tt_begin(name.encode(), SpanKind.STEP)
            try:
                out = step_fn(*args, **kwargs)
                _synchronize_cuda()
                return out
            finally:
                self._lib.tt_end(sid, flops_per_step)

        return wrapped

    # ---- metrics ------------------------------------------------------------

    def set_gauge(self, name: str, value: float):
        self._lib.tt_set_gauge(name.encode(), value)

    def counter_add(self, name: str, delta: float = 1.0):
        self._lib.tt_counter_add(name.encode(), delta)

    def hang_count(self) -> int:
        return self._lib.tt_hang_count()

    def now_ns(self) -> int:
        return self._lib.tt_now_ns()

    def metrics_text(self) -> str:
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.tt_metrics_text(buf, cap)
            if n >= 0:
                return buf.value.decode()
            cap = -n + 1

    def dump_timeline(self, path: str) -> bool:
        return self._lib.tt_dump_timeline(path.encode()) == 0


def _synchronize_cuda():
    """Wait for the card if this process has a CUDA context (a CPU step
    has nothing in flight)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def get_timer() -> TpuTimer:
    return TpuTimer.get()


def active_timer() -> Optional[TpuTimer]:
    """The timer IF something already initialized it, else None — for
    callers (tracing decorators, GC hooks) that must never trigger the
    first-use native build as a side effect."""
    return TpuTimer._instance
