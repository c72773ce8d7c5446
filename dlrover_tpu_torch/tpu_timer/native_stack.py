"""Out-of-process NATIVE stack capture for hung workers.

The port's copy of ``dlrover_tpu/tpu_timer/native_stack.py``. Parity:
reference xpu_timer's per-node daemon orchestrates gdb/py-spy dumps of
arbitrary training processes
(xpu_timer/server/hosting_service_server_client.cc; RPC surface
xpu_timer/protos/hosting_service.proto:14-250). The capability is
native: ``stack_sampler`` (built from native/tpu_timer/stack_sampler.cc
at first use, like libtpu_timer) ptrace-attaches to every thread of the
target and unwinds its user-space stack, with libunwind-ptrace where it
is installed and otherwise by its own stack scan over the target's
mapped ELF symbols. That shows the C/C++ frames a faulthandler dump
cannot: a worker wedged inside the CUDA driver or NCCL shows one opaque
Python line, and the diagnosis lives in the native frames.

The agent calls :func:`sample_native_stacks` on a worker it is about to
post-mortem-restart (agent/training._stop_workers) and on a live worker
whose hang watchdog reported a hang, and appends the output to the
worker's log, next to the SIGUSR2 faulthandler dump; ``analysis.py
stacks`` folds both into one histogram.
"""

import re
import subprocess
from typing import List, Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.tpu_timer.bridge import native_build

SAMPLER_SOURCES = ("stack_sampler.cc",)
SAMPLER_FLAGS = ("-O2", "-std=c++17", "-Wall")


def ensure_built(timeout: float = 120.0) -> str:
    """Build stack_sampler at first use (one g++ call) into the build
    directory, under the same build lock as the timer runtime.

    Everything here is BOUNDED: this runs on the agent's hang-recovery
    path, where an unbounded lock wait or compile would let the hang
    diagnostic hang the recovery itself. A lock held past the deadline
    or a wedged compiler raises (TimeoutError / CalledProcessError /
    TimeoutExpired) and the caller degrades to the Python-only dump."""
    return native_build("stack_sampler", SAMPLER_SOURCES, SAMPLER_FLAGS,
                        ("-ldl",), timeout=timeout)


def sample_native_stacks(
    pid: int, max_frames: int = 64, timeout: float = 20.0
) -> Optional[str]:
    """Native stacks of every thread of ``pid``, or None.

    The target is seized, interrupted, walked and detached per thread
    (a few ms stop each — the py-spy disturbance model); nothing is
    queued on it, so a sampler killed at its timeout leaves it running. Returns the sampler's text
    ("Native thread <tid> (most recent call first): / #N 0x... sym+off"
    blocks), or None when the tool can't run (no ptrace permission,
    target gone, build failure) — hang handling must degrade to the
    Python-only dump, never raise."""
    try:
        tool = ensure_built()
    except (
        OSError,
        subprocess.CalledProcessError,
        subprocess.TimeoutExpired,
    ) as e:
        logger.warning("stack_sampler unavailable: %s", e)
        return None
    try:
        out = subprocess.run(
            [tool, str(pid), str(max_frames)],
            capture_output=True,
            text=True,
            timeout=timeout,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.warning("stack_sampler failed for pid %s: %s", pid, e)
        return None
    if out.returncode != 0 or not out.stdout.strip():
        logger.warning(
            "stack_sampler pid %s rc=%s stderr=%s",
            pid, out.returncode, out.stderr[-400:],
        )
        return None
    return out.stdout


_NATIVE_THREAD_RE = re.compile(r"^Native thread (\d+)")
_NATIVE_FRAME_RE = re.compile(
    r"^\s+#\d+ 0x[0-9a-f]+ (?P<sym>.+?)(\+0x[0-9a-f]+)?$"
)


def parse_native_dumps(text: str) -> List[List[str]]:
    """Per-thread native stacks (outermost-first symbol lists) from
    sampler output embedded in log text — the native twin of
    ``analysis.parse_faulthandler_dumps``."""
    stacks: List[List[str]] = []
    current: List[str] = []
    in_stack = False
    for line in text.splitlines():
        if _NATIVE_THREAD_RE.match(line.strip()):
            if current:
                stacks.append(current)
            current = []
            in_stack = True
            continue
        m = _NATIVE_FRAME_RE.match(line)
        if m and in_stack:
            current.append(m.group("sym"))
        elif in_stack and not line.strip():
            if current:
                stacks.append(current)
                current = []
            in_stack = False
    if current:
        stacks.append(current)
    # Sampler prints innermost-first; flamegraph wants outermost-first.
    return [list(reversed(s)) for s in stacks]


def main(argv=None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        description="native stack capture (ptrace + stack unwinding)"
    )
    ap.add_argument("pid", type=int)
    ap.add_argument("--max-frames", type=int, default=64)
    ns = ap.parse_args(argv)
    text = sample_native_stacks(ns.pid, max_frames=ns.max_frames)
    if text is None:
        print("native stack capture failed", file=sys.stderr)
        return 1
    sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
