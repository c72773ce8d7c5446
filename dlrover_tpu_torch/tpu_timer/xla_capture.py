"""Device-trace acquisition over ``torch.profiler`` feeding the native
tpu_timer ring (the port's ``dlrover_tpu/tpu_timer/xla_capture.py``;
the module keeps the reference's name, its functions and its env vars).

Parity: reference xpu_timer/nvidia/hook.cc:53-580 (dlsym interception of
CUDA kernel launches + NCCL collectives) + common/manager.h:106-195
(event poller). Here the kernel-level source of truth is kineto (CUPTI
behind ``torch.profiler``): the listener periodically (or on agent
request via a trigger file) opens a short window, parses the chrome
trace kineto writes, and records every device event — kernels, copies,
memsets (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``) — into the
native ring: per-kernel visibility with NO cooperation from the training
script beyond runtime init (``_maybe_start_tpu_timer``) or the
``_inject`` sitecustomize, the same contract as LD_PRELOADing the
reference's hook library.

CUPTI records the kernels of every thread of the process, so the
listener's own thread sees the training loop's kernels. The host side
(ops and ``record_function`` ranges) is recorded only on the thread that
opened the window: ``capture_op_profile`` therefore takes its window on
the calling thread, around the work it is given.

Scope attribution (``parse_op_profile``): a kernel's scope is the path
of ``record_function`` ranges enclosing the host op that launched it
(its runtime call, matched by the correlation id) — the counterpart of
the jax name stack ``tf_op``. A backward kernel is launched under an
``autograd::engine::evaluate_function`` op outside the forward's
ranges; it takes the scope of the forward op with the node's sequence
number, so forward and backward land in one bucket as JAX's transposes
do. A window without device events (a CPU run) yields the host's ops
instead, with the same attribution.

Only one profiler session can run in a process: every window here takes
one lock. A window records CUDA activity whenever the process holds a
CUDA context, and never creates one: in a process that has not
initialised CUDA the window records the host only. The listener waits
for its process to start work before its first window: an automatic
window comes only after the process's first optimizer step (a global
``torch.optim`` post-hook, so the training script needs no change), and
a trigger is taken once the process has stepped or holds a CUDA
context. A waiting warm standby therefore opens no window and leaves the
trigger to the worker, and no window pays the profiler's start-up while
a worker starts. A process that never steps an optimizer (an inference
script) gets trigger windows only.
Sub-step hang detection rides the native watchdog: each listener
capture runs inside a native ``xla_capture`` span, and a capture that
stalls exceeds the hang timeout so the C++ watchdog fires even though
Python never returned.
"""

import bisect
import collections
import gzip
import json
import os
import re
import shutil
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.tpu_timer.bridge import SpanKind, get_timer

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Host-side runtime calls worth recording beside the device events.
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
_COLLECTIVE_RE = re.compile(
    r"all[-_]?reduce|all[-_]?gather|reduce[-_]?scatter"
    r"|all[-_]?to[-_]?all|collective|ppermute|nccl",
    re.IGNORECASE,
)
_BACKWARD_OP = "autograd::engine::evaluate_function:"

# One profiler session per process (a second one fails).
_SESSION_LOCK = threading.Lock()
# Set by the process's first optimizer step (``_arm_step_hook``).
_stepped = threading.Event()
_step_hook = None
# The last window on the native clock (CLOCK_MONOTONIC ns): ``opened``
# before the profiler starts (the anchor of its events' epoch times),
# ``started`` once it records, ``closed`` once it stopped.
last_window: Dict[str, int] = {}


def trigger_path(local_rank: int) -> str:
    """Touch this file to request an immediate capture (the agent-side
    knob; no signal or RPC into the training process needed)."""
    job = os.getenv(NodeEnv.JOB_NAME, "job")
    return os.path.join(
        tempfile.gettempdir(),
        f"dlrover_tpu_timer_{job}_{local_rank}.capture",
    )


def request_xla_capture(local_rank: int = 0):
    with open(trigger_path(local_rank), "w") as f:
        f.write(str(time.time()))


def _load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _epoch_us(trace: dict) -> float:
    """Kineto's ``ts`` are microseconds after ``baseTimeNanoseconds``
    (epoch); this returns that base in epoch microseconds."""
    return float(trace.get("baseTimeNanoseconds", 0)) / 1e3


def parse_chrome_trace(
    path: str, since_epoch_us: Optional[float] = None
) -> List[Tuple[str, bool, float, float]]:
    """(name, is_device, start_us, dur_us) for the complete events of a
    kineto chrome trace: device events, host runtime calls and host
    collectives. ``start_us`` is relative to ``since_epoch_us`` (epoch
    microseconds) when given, else kineto's own ``ts``."""
    trace = _load_trace(path)
    shift = (0.0 if since_epoch_us is None
             else _epoch_us(trace) - since_epoch_us)
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", ""))
        name = str(e.get("name", ""))
        is_device = cat in DEVICE_CATS
        if not (is_device or cat in _RUNTIME_CATS or (
                cat == "cpu_op" and _COLLECTIVE_RE.search(name))):
            continue  # host ops and python frames: py_tracing covers those
        out.append((name, is_device, float(e.get("ts", 0)) + shift,
                    float(e.get("dur", 0))))
    return out


def _arm_step_hook():
    """Register, once, a post-hook on every optimizer's ``step`` that
    marks this process as stepped. Called once torch is imported."""
    global _step_hook
    if _step_hook is None:
        from torch.optim.optimizer import register_optimizer_step_post_hook

        _step_hook = register_optimizer_step_post_hook(
            lambda *args: _stepped.set())


def cuda_context() -> bool:
    """Whether this process holds a CUDA context (torch's lazy init
    ran). Imports nothing that creates one."""
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_available()
                and torch.cuda.is_initialized())


def _capture_trace(parse_fn, capture_s: float,
                   fn: Optional[Callable[[], object]] = None):
    """Open a torch.profiler window for ``capture_s`` (or around
    ``fn()`` on this thread), close it ON ANY EXIT, and apply
    ``parse_fn(path, window_epoch_us, cuda)`` to its chrome trace. The
    single home of the session invariants for every capture."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tmpdir = tempfile.mkdtemp(prefix="dlrover_tpu_torch_cap_")
    try:
        with _SESSION_LOCK:
            cuda = cuda_context()
            activities = [ProfilerActivity.CPU]
            if cuda:
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            start_epoch_us = time.time_ns() / 1e3
            opened = time.monotonic_ns()
            prof.start()
            started = time.monotonic_ns()
            try:
                if fn is None:
                    time.sleep(capture_s)
                else:
                    fn()
                    if cuda:
                        torch.cuda.synchronize()
            finally:
                prof.stop()
                last_window.update(opened=opened, started=started,
                                   closed=time.monotonic_ns())
            path = os.path.join(tmpdir, "trace.json")
            prof.export_chrome_trace(path)
        return parse_fn(path, start_epoch_us, cuda)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def capture_device_events(
    capture_s: float = 1.0, keep_host_runtime: bool = True
) -> List[Tuple[str, bool, float, float]]:
    """Capture a trace window and return its device events (and host
    runtime calls), ``start_us`` relative to the window's opening.

    CUPTI records whatever the process runs on the card during the
    window — this thread only opens and closes the session."""

    def parse(path, start_epoch_us, cuda):
        events = parse_chrome_trace(path, since_epoch_us=start_epoch_us)
        if keep_host_runtime:
            return events
        return [ev for ev in events if ev[1]]

    return _capture_trace(parse, capture_s)


# ---------------------------------------------------------------------------
# Per-op profile with scopes
# ---------------------------------------------------------------------------


class _HostOps:
    """The host events of a kineto trace, nested per thread, with the
    scope of each (see the module doc)."""

    def __init__(self, events: List[dict]):
        self.events = [e for e in events if e.get("ph") == "X" and e.get(
            "cat") in ("cpu_op", "user_annotation")]
        self.parent: Dict[int, Optional[int]] = {}
        # Summed duration of each event's direct children.
        self.child_us: Dict[int, float] = {}
        by_thread: Dict[tuple, List[int]] = {}
        for i, e in enumerate(self.events):
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(i)
        self._starts: Dict[tuple, List[float]] = {}
        self._order: Dict[tuple, List[int]] = {}
        for key, idx in by_thread.items():
            idx.sort(key=lambda i: (float(self.events[i]["ts"]),
                                    -float(self.events[i].get("dur", 0))))
            stack: List[int] = []
            for i in idx:
                ts = float(self.events[i]["ts"])
                while stack and self._end(stack[-1]) < ts:
                    stack.pop()
                self.parent[i] = stack[-1] if stack else None
                if stack:
                    self.child_us[stack[-1]] = self.child_us.get(
                        stack[-1], 0.0) + float(
                            self.events[i].get("dur", 0))
                stack.append(i)
            self._order[key] = idx
            self._starts[key] = [float(self.events[i]["ts"]) for i in idx]
        self._by_ext = {}
        self._forward: Dict[int, List[int]] = {}
        for i, e in enumerate(self.events):
            args = e.get("args") or {}
            if "External id" in args:
                self._by_ext.setdefault(args["External id"], i)
            seq = args.get("Sequence number", -1)
            if (seq is not None and seq >= 0 and not args.get(
                    "Fwd thread id") and e["cat"] == "cpu_op"):
                self._forward.setdefault(seq, []).append(i)
        for idx in self._forward.values():
            idx.sort(key=lambda i: float(self.events[i]["ts"]))
        self._fwd_tid: Dict[int, tuple] = self._learn_forward_threads()
        self._scope: Dict[int, str] = {}

    def _end(self, i: int) -> float:
        e = self.events[i]
        return float(e["ts"]) + float(e.get("dur", 0))

    def _thread(self, i: int) -> tuple:
        e = self.events[i]
        return (e.get("pid"), e.get("tid"))

    def _backward_node(self, i: int) -> Optional[Tuple[int, int]]:
        e = self.events[i]
        if not str(e.get("name", "")).startswith(_BACKWARD_OP):
            return None
        args = e.get("args") or {}
        seq = args.get("Sequence number", -1)
        if seq is None or seq < 0:
            return None
        return seq, int(args.get("Fwd thread id", 0) or 0)

    def _learn_forward_threads(self) -> Dict[int, tuple]:
        """Kineto names a backward node's forward thread by profiler
        thread id, not by the ``tid`` the events carry: map one onto the
        other by the nodes whose sequence number only one thread's
        forward ops carry."""
        votes = collections.defaultdict(collections.Counter)
        for i in range(len(self.events)):
            node = self._backward_node(i)
            if node is None:
                continue
            seq, fwd = node
            threads = {self._thread(j) for j in self._forward.get(seq, ())}
            if len(threads) == 1:
                votes[fwd][threads.pop()] += 1
        return {fwd: c.most_common(1)[0][0] for fwd, c in votes.items()}

    def _forward_op(self, i: int, seq: int, fwd: int) -> Optional[int]:
        cands = self._forward.get(seq, [])
        thread = self._fwd_tid.get(fwd)
        if thread is not None:
            cands = [j for j in cands if self._thread(j) == thread]
        ts = float(self.events[i]["ts"])
        before = [j for j in cands if float(self.events[j]["ts"]) <= ts]
        return before[-1] if before else None

    def scope(self, i: Optional[int]) -> str:
        """'/'-joined ``record_function`` ranges (outermost first) over
        host event ``i``, through the forward op for backward work."""
        if i is None:
            return ""
        if i in self._scope:
            return self._scope[i]
        names: List[str] = []
        j: Optional[int] = i
        result = None
        while j is not None:
            e = self.events[j]
            if e["cat"] == "user_annotation":
                names.append(str(e.get("name", "")))
            else:
                node = self._backward_node(j)
                if node is not None:
                    # Ranges inside a backward node (a checkpointed
                    # forward recomputing) are the scope; else the node's
                    # forward op has it.
                    if not names:
                        result = self.scope(self._forward_op(j, *node))
                    break
            j = self.parent.get(j)
        if result is None:
            result = "/".join(reversed(names))
        self._scope[i] = result
        return result

    def enclosing(self, pid, tid, ts: float) -> Optional[int]:
        """The innermost host event of thread (pid, tid) whose span holds
        ``ts``."""
        key = (pid, tid)
        starts = self._starts.get(key)
        if not starts:
            return None
        k = bisect.bisect_right(starts, ts) - 1
        if k < 0:
            return None
        j: Optional[int] = self._order[key][k]
        while j is not None and self._end(j) < ts:
            j = self.parent.get(j)
        return j

    def by_external_id(self, ext) -> Optional[int]:
        return self._by_ext.get(ext)

    def exclusive_ops(self) -> List[Tuple[int, float]]:
        """(op, microseconds in the op itself, its children's excluded)
        for every host op with time of its own."""
        out = []
        for i, e in enumerate(self.events):
            if e["cat"] != "cpu_op":
                continue
            own = float(e.get("dur", 0)) - self.child_us.get(i, 0.0)
            if own > 0:
                out.append((i, own))
        return out


def parse_op_profile(path: str) -> List[Dict]:
    """Per-op events with their scope, for attribution.

    Each device event of the trace becomes ``{name, scope, category
    (kernel / gpu_memcpy / gpu_memset), dur_us, flops, bytes}`` (kineto
    gives no per-kernel flops or bytes: 0.0). ``scope`` is the
    ``record_function`` path over the launching host op (see the module
    doc). A trace without device events (a CPU window) yields its host
    ops instead (``category`` ``cpu_op``), each with the time spent in
    the op itself (its child ops' excluded, so nothing counts twice)."""
    trace = _load_trace(path)
    events = trace.get("traceEvents", [])
    host = _HostOps(events)
    launches = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _RUNTIME_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        args = e.get("args") or {}
        call = launches.get(args.get("correlation"))
        op = None
        if call is not None:
            op = host.enclosing(call.get("pid"), call.get("tid"),
                                float(call["ts"]))
        if op is None:
            op = host.by_external_id(args.get("External id"))
        out.append({
            "name": str(e.get("name", ""))[:120],
            "scope": host.scope(op),
            "category": str(e.get("cat")),
            "dur_us": float(e.get("dur", 0)),
            "flops": 0.0,
            "bytes": 0.0,
        })
    if out:
        return out
    return [{
        "name": str(host.events[i].get("name", ""))[:120],
        "scope": host.scope(i),
        "category": "cpu_op",
        "dur_us": own,
        "flops": 0.0,
        "bytes": 0.0,
    } for i, own in host.exclusive_ops()]


def capture_op_profile(capture_s: float = 1.0,
                       fn: Optional[Callable[[], object]] = None
                       ) -> List[Dict]:
    """The per-op profile (``parse_op_profile`` rows) of a window: around
    ``fn()`` on this thread (its ops and ranges are recorded, so every
    row gets its scope; the window waits for the card before it
    closes), or ``capture_s`` of whatever ran meanwhile. A window
    around ``fn`` in a process with a CUDA context that recorded no
    device event raises."""

    def parse(path, start_epoch_us, cuda):
        rows = parse_op_profile(path)
        if fn is not None and cuda and not any(
                r["category"] in DEVICE_CATS for r in rows):
            raise RuntimeError(
                "the profiler window recorded no device activity")
        return rows

    return _capture_trace(parse, capture_s, fn)


def bucket_by_scope(
    ops: List[Dict], buckets: Dict[str, Tuple[str, ...]]
) -> Dict[str, float]:
    """Share of device-busy time per scope bucket.

    ``buckets`` maps bucket name -> substrings matched (first hit wins,
    in dict order) against each op's scope path; unmatched time lands in
    "other". Returns fractional shares summing to ~1.0 (empty input:
    {}).
    """
    totals = {name: 0.0 for name in buckets}
    totals["other"] = 0.0
    for op in ops:
        scope = op.get("scope", "") or op.get("name", "")
        for name, keys in buckets.items():
            if any(k in scope for k in keys):
                totals[name] += op["dur_us"]
                break
        else:
            totals["other"] += op["dur_us"]
    grand = sum(totals.values())
    if grand <= 0:
        return {}
    return {k: v / grand for k, v in totals.items()}


def base_name(name: str) -> str:
    """``void (anonymous namespace)::flash_fwd_kernel<128>(CUtensorMap_st,
    ...)`` -> ``flash_fwd_kernel``: the demangled kernel without return
    type, anonymous namespace, template arguments and parameters —
    aggregate across launches."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    return "".join(out).strip()[:120]


def record_events(
    events: List[Tuple[str, bool, float, float]],
    capture_start_ns: int,
    min_dur_us: float = 1.0,
    max_events: int = 4096,
) -> int:
    """Feed captured events into the native ring/histograms, device
    events first (a truncated capture drops host calls before kernels),
    each in time order. Event timestamps are µs relative to the
    capture's opening; they are mapped onto the native clock via the
    capture-start anchor."""
    timer = get_timer()
    recorded = 0
    events = sorted(events, key=lambda ev: (not ev[1], ev[2]))
    for name, is_device, ts_us, dur_us in events:
        if dur_us < min_dur_us:
            continue
        if recorded >= max_events:
            logger.info(
                "xla capture truncated at %d events (of %d)",
                max_events,
                len(events),
            )
            break
        kind = (
            SpanKind.COLLECTIVE
            if _COLLECTIVE_RE.search(name)
            else SpanKind.CUSTOM
        )
        prefix = "xla/" if is_device else "xla_host/"
        timer.record(
            prefix + base_name(name),
            kind,
            capture_start_ns + int(ts_us * 1000),
            int(dur_us * 1000),
        )
        recorded += 1
    timer.set_gauge("xla_capture_events", float(recorded))
    return recorded


class XlaCaptureListener:
    """Background acquisition thread living inside the worker process
    (installed by runtime init or the ``_inject`` sitecustomize when
    DLROVER_TPU_TIMER_XLA=1)."""

    def __init__(
        self,
        local_rank: int = 0,
        interval_s: float = 60.0,
        capture_s: float = 1.0,
    ):
        self._trigger = trigger_path(local_rank)
        self._interval_s = interval_s
        self._capture_s = capture_s
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.captures = 0

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="xla-capture", daemon=True
        )
        self._thread.start()
        # A capture in flight while the interpreter tears down can abort
        # the process from C++: drain cleanly at exit.
        import atexit

        atexit.register(self.stop)

    def stop(self):
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=self._capture_s + 30)

    def capture_once(self):
        timer = get_timer()
        start_ns = timer.now_ns()
        last_window.clear()
        # The native watchdog turns a stalled capture (wedged device)
        # into a hang report even though Python never returns.
        with timer.span("xla_capture", SpanKind.CUSTOM):
            events = capture_device_events(self._capture_s)
        window = dict(last_window)
        n = record_events(events, window.get("opened", start_ns))
        window_s = startup_s = 0.0
        if window:
            # The window itself (profiler recording), inside the span.
            timer.record("xla_capture_window", SpanKind.CUSTOM,
                         window["started"],
                         window["closed"] - window["started"])
            window_s = (window["closed"] - window["started"]) / 1e9
            startup_s = (window["started"] - window["opened"]) / 1e9
        self.captures += 1
        device = sum(1 for ev in events if ev[1])
        logger.info(
            "xla capture #%d (pid %d): %d runtime events recorded (%d "
            "device events%s) in a %.3f s window after %.3f s start-up",
            self.captures,
            os.getpid(),
            n,
            device,
            "" if cuda_context() else "; no CUDA context: host only",
            window_s,
            startup_s,
        )

    def _loop(self):
        next_auto = time.time() + self._interval_s
        while not self._stopped.is_set():
            torch = sys.modules.get("torch")
            if torch is None or getattr(torch.__spec__, "_initializing",
                                        False):
                # Nothing to record before this process has imported
                # torch (a helper interpreter the injection also reached,
                # such as a resource tracker), and no import of it from
                # this thread while another imports it: the trigger is
                # left for the worker.
                self._stopped.wait(0.5)
                continue
            _arm_step_hook()
            stepped = _stepped.is_set()
            # A process that has not started work (a waiting standby)
            # leaves the trigger to the worker.
            triggered = (stepped or cuda_context()) and os.path.exists(
                self._trigger)
            if triggered or (stepped and time.time() >= next_auto):
                if triggered:
                    try:
                        os.unlink(self._trigger)
                    except OSError:
                        pass
                try:
                    self.capture_once()
                except Exception:
                    logger.warning("xla capture failed", exc_info=True)
                next_auto = time.time() + self._interval_s
            self._stopped.wait(0.5)


_started_listener: Optional[XlaCaptureListener] = None


def maybe_start_listener(local_rank: int = 0) -> Optional[XlaCaptureListener]:
    """Idempotent per process: an instrumented script under the agent's
    sitecustomize injection would otherwise arm TWO listeners (startup +
    runtime init) whose windows would collide."""
    global _started_listener
    from dlrover_tpu_torch.common.env_utils import get_env_bool

    if not get_env_bool("DLROVER_TPU_TIMER_XLA"):
        return None
    if _started_listener is not None:
        return _started_listener
    interval = float(os.getenv("DLROVER_TPU_TIMER_XLA_INTERVAL", "60"))
    window = float(os.getenv("DLROVER_TPU_TIMER_XLA_WINDOW", "1.0"))
    listener = XlaCaptureListener(local_rank, interval, window)
    _started_listener = listener
    listener.start()
    logger.info(
        "xla capture listener on in pid %d (every %.0fs, %.1fs windows)",
        os.getpid(),
        interval,
        window,
    )
    return listener
