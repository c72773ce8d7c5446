"""Replica handles: a ServingEngine behind a mailbox with heartbeats
(the port's own copy of ``dlrover_tpu/serving/fleet/replica.py``; a
subprocess replica runs the port's worker on the card or the CPU).

The router never touches an engine directly — it talks to a
:class:`ReplicaHandle`: ``submit()`` drops work into the replica's
mailbox, ``poll()`` drains completion events, ``last_heartbeat()`` /
``alive()`` feed the health breaker. Two implementations share that
surface:

- :class:`ThreadReplica` — the engine runs on an in-process thread.
  The kernels are built once per process and shared by every replica;
  on one card the replicas' threads share its default stream.
  ``kill()`` poisons the loop (it exits without draining — in-flight
  work is lost and heartbeats stop), which is the thread-mode analogue
  of a crash; an injected ``fleet.replica.step`` raise does the same.
- :class:`SubprocessReplica` — the engine runs in a child process
  (:mod:`dlrover_tpu_torch.serving.fleet.replica_worker`): JSONL
  commands down stdin, JSONL events (completions + heartbeats) up
  stdout, fault schedules armed via the standard env rigging. ``kill()``
  is a real SIGKILL. ``restart()`` respawns a fresh generation.

Completion events are plain dicts (the wire format IS the in-process
format, so the router cannot care which mode a replica runs in)::

    {"kind": "done", "request_id": ..., "attempt": ..., "ok": bool,
     "tokens": [...], "truncated": bool, "failure_reason": "",
     "ttft_s": float|None}

Every event carries the replica's ``generation`` — a completion from a
pre-restart generation for an attempt the router already re-routed is
recognizably stale (the at-most-once key still wins; generations make
the logs honest).

Disaggregated serving extends the protocol with three control
ops (``send()``) and two upstream events, shared by both modes:

- down: ``{"op": "import", "request_id", "attempt", "payload"}``
  (base64 migration bytes — admit mid-stream via the paged engine's
  DECODE-entry path), ``{"op": "export", ...}`` (flag an in-flight
  request for export at its next DECODE boundary — the live-drain
  trigger), ``{"op": "release", ...}`` (importer acked: drop the
  source copy, recycle slot + blocks);
- up: ``{"kind": "exported", "request_id", "attempt", "payload"}``
  and ``{"kind": "imported", "request_id", "attempt", "ok", ...}``.

A replica whose engine cannot migrate (the flat slot pool) answers an
import with ``ok: false`` and simply never emits ``exported`` — the
router falls back to source-side completion, never an error.
"""

import base64
import json
import os
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Set

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.fault import fault_point
from dlrover_tpu_torch.fault.registry import SCHEDULE_ENV, TRACE_ENV


class ReplicaDeadError(RuntimeError):
    """submit() on a replica that cannot take work (process exited,
    thread gone, pipe closed). The router turns this into a re-route."""


@dataclass
class WorkItem:
    """One dispatch: a (request, attempt) pair bound for one replica.
    ``deadline_s`` is REMAINING seconds at dispatch (never an absolute
    timestamp — subprocess replicas have their own monotonic clock)."""

    request_id: str
    attempt: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    deadline_s: Optional[float] = None
    # Named SLO class: forwarded into the engine scheduler's
    # weighted-fair admission; None = the engine's default class.
    slo_class: Optional[str] = None
    # Trace carrier of the router's attempt span ({"trace_id",
    # "span_id"} or None): the replica engine parents its phase spans
    # to it, so a rerouted request is one tree across processes.
    trace: Optional[dict] = None
    # Two-phase dispatch: export this request's KV blocks as
    # soon as prefill completes (first token sampled) — the replica
    # emits an ``exported`` event and KEEPS the request live until the
    # router's ``release`` op (the importer's ack).
    migrate_after_prefill: bool = False

    def to_wire(self) -> dict:
        return {
            "op": "submit",
            "request_id": self.request_id,
            "attempt": self.attempt,
            "prompt": list(self.prompt),
            "max_new_tokens": self.max_new_tokens,
            "temperature": self.temperature,
            "deadline_s": self.deadline_s,
            "slo_class": self.slo_class,
            "trace": self.trace,
            "migrate_after_prefill": self.migrate_after_prefill,
        }


def _completion(item_key, ok, tokens, truncated, failure_reason,
                ttft_s, generation=None) -> dict:
    request_id, attempt = item_key
    out = {
        "kind": "done",
        "request_id": request_id,
        "attempt": attempt,
        "ok": bool(ok),
        "tokens": list(tokens),
        "truncated": bool(truncated),
        "failure_reason": failure_reason,
        "ttft_s": ttft_s,
    }
    # generation=None (subprocess worker): omitted so the parent can
    # stamp its own at receipt (_read_events setdefault) — a worker
    # cannot know which respawn it is.
    if generation is not None:
        out["generation"] = generation
    return out


def serve_submit(engine, by_rid, emit, request_id, attempt, prompt,
                 max_new_tokens, temperature, deadline_s,
                 trace=None, slo_class=None):
    """One work item into the engine — shared by both replica modes so
    the wire behavior cannot drift. A scheduler rejection (prompt too
    long, bad deadline, unknown SLO class) is an EXPLICIT failed
    completion, never a crash: crashing here would cascade the poison
    request through the fleet. Returns the engine request (None on
    rejection) so callers can flag it for post-prefill export."""
    try:
        req = engine.submit(
            prompt, max_new_tokens,
            temperature=temperature, deadline_s=deadline_s,
            trace=trace, slo_class=slo_class,
        )
    except Exception:  # noqa: BLE001 — any rejection is the same event
        emit(_completion(
            (request_id, attempt),
            ok=False, tokens=(), truncated=False,
            failure_reason="rejected", ttft_s=None,
        ))
        return None
    by_rid[req.rid] = (request_id, attempt)
    return req


def serve_step(engine, by_rid, emit) -> None:
    """One engine iteration -> one completion event per finished
    request — shared by both replica modes."""
    for req in engine.step():
        key = by_rid.pop(req.rid, None)
        if key is None:
            continue  # engine-internal request (warmup etc.)
        emit(_completion(
            key,
            ok=not req.failed,
            tokens=req.tokens,
            truncated=req.truncated,
            failure_reason=req.failure_reason,
            ttft_s=req.ttft_s,
        ))


def serve_exports(engine, by_rid, emit, migrate_rids: Set[int]) -> None:
    """Export every flagged request that has reached DECODE (first
    token sampled): emit an ``exported`` event with the base64
    migration payload and KEEP the request live — the router decides
    between a destination import (followed by ``release``) and
    source-side completion. Shared by both replica modes. A flat
    engine (no block plane) simply unflags: the fallback is serving
    the decode locally, never an error."""
    if not migrate_rids:
        return
    for rid in list(migrate_rids):
        if rid not in by_rid:
            migrate_rids.discard(rid)  # finished before export fired
    if not migrate_rids:
        return
    from dlrover_tpu_torch.serving.kvpool.migrate import export_request
    from dlrover_tpu_torch.serving.scheduler import DECODE
    for req in list(getattr(engine.scheduler, "by_slot", ())):
        if req is None or req.rid not in migrate_rids:
            continue
        if req.state != DECODE or not req.tokens:
            continue  # still prefilling; try again next iteration
        migrate_rids.discard(req.rid)
        key = by_rid.get(req.rid)
        if key is None:
            continue
        try:
            payload = export_request(engine, req)
        except Exception as e:  # noqa: BLE001 — flat engine / torn
            # state: the local decode continues; the explicit error
            # event lets a draining router stop waiting for this key.
            logger.debug("export of rid %d failed", req.rid,
                         exc_info=True)
            emit({
                "kind": "exported",
                "request_id": key[0],
                "attempt": key[1],
                "error": type(e).__name__,
            })
            continue
        emit({
            "kind": "exported",
            "request_id": key[0],
            "attempt": key[1],
            "payload": base64.b64encode(payload).decode("ascii"),
        })


def serve_import(engine, by_rid, emit, cmd: dict) -> None:
    """Admit a migrated payload mid-stream (DECODE entry). Any failure
    — full destination, flat engine, malformed bytes — is an explicit
    ``ok: false`` ack, never a crash: the source still owns the
    request and completes it locally."""
    request_id = cmd["request_id"]
    attempt = cmd.get("attempt", 0)
    try:
        from dlrover_tpu_torch.serving.kvpool.migrate import import_request

        payload = base64.b64decode(cmd["payload"])
        req = import_request(engine, payload, trace=cmd.get("trace"))
    except Exception as e:  # noqa: BLE001 — refusal IS the protocol
        emit({
            "kind": "imported", "request_id": request_id,
            "attempt": attempt, "ok": False,
            "reason": type(e).__name__,
        })
        return
    by_rid[req.rid] = (request_id, attempt)
    emit({
        "kind": "imported", "request_id": request_id,
        "attempt": attempt, "ok": True,
    })


def serve_release(engine, by_rid, cmd: dict) -> None:
    """The importer acked: drop the source copy (slot + blocks
    recycled, ``migrated`` outcome). A request that already finished
    locally (the source won the race) is a no-op — its completion is
    the router's at-most-once duplicate."""
    key = (cmd["request_id"], cmd.get("attempt", 0))
    rid = next((r for r, k in by_rid.items() if k == key), None)
    if rid is None:
        return
    by_rid.pop(rid, None)
    req = next(
        (q for q in getattr(engine.scheduler, "by_slot", ())
         if q is not None and q.rid == rid),
        None,
    )
    if req is not None:
        from dlrover_tpu_torch.serving.kvpool.migrate import (
            release_exported,
        )

        release_exported(engine, req)


def serve_control(engine, by_rid, emit, migrate_rids: Set[int],
                  cmd: dict) -> None:
    """Dispatch one control op — shared by both replica modes."""
    op = cmd.get("op")
    if op == "import":
        serve_import(engine, by_rid, emit, cmd)
    elif op == "release":
        serve_release(engine, by_rid, cmd)
    elif op == "export":
        # Live drain: flag an in-flight request; serve_exports fires
        # at its next DECODE boundary (or immediately if already
        # decoding). Unknown key = already finished: nothing to do.
        key = (cmd["request_id"], cmd.get("attempt", 0))
        rid = next(
            (r for r, k in by_rid.items() if k == key), None
        )
        if rid is not None:
            migrate_rids.add(rid)


class ThreadReplica:
    """In-process replica: one serve-loop thread driving one engine.

    ``engine_factory`` is called ON the loop thread (first start pays
    any kernel build and warmup there, not on the router); each
    ``restart()`` builds a fresh engine — after a poisoned loop the old
    engine's host/device state is untrusted, exactly like the engine's
    own step-error recovery.
    """

    mode = "thread"

    def __init__(
        self,
        replica_id: str,
        engine_factory: Callable[[], object],
        clock: Callable[[], float] = time.monotonic,
        idle_sleep_s: float = 0.001,
        role: str = "mixed",
    ):
        self.replica_id = str(replica_id)
        self.role = role  # "prefill" | "decode" | "mixed"
        self._engine_factory = engine_factory
        self._clock = clock
        self._idle_sleep_s = idle_sleep_s
        self._inbox: Deque[WorkItem] = deque()
        self._outbox: Deque[dict] = deque()
        self._lock = threading.Lock()
        self._hb = 0.0
        self._stop = threading.Event()
        self._poison = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self.generation = 0

    # ---- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._poison.clear()
        self._ready.clear()
        self._thread = threading.Thread(
            target=self._run,
            name=f"fleet-replica-{self.replica_id}",
            daemon=True,
        )
        self._thread.start()

    def wait_ready(self, timeout: float = 60.0) -> bool:
        return self._ready.wait(timeout)

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def kill(self) -> None:
        """Simulated crash: the loop exits at its next iteration WITHOUT
        draining — in-flight work is lost, heartbeats stop."""
        self._poison.set()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def restart(self) -> None:
        self.stop()
        if self._thread is not None and self._thread.is_alive():
            # Wedged loop that would not join: abandon it. The
            # generation guard in _run makes it exit at its next
            # iteration boundary, and any events it still emits carry
            # its old generation.
            self._thread = None
        with self._lock:
            self._inbox.clear()
        self.generation += 1
        self.start()

    # ---- router surface ----------------------------------------------------

    def submit(self, item: WorkItem) -> None:
        if not self.alive():
            raise ReplicaDeadError(
                f"replica {self.replica_id} is not running"
            )
        with self._lock:
            self._inbox.append(item)

    def send(self, payload: dict) -> None:
        """A control op (import / export / release) into the
        mailbox — the in-process twin of the subprocess JSONL line."""
        if not self.alive():
            raise ReplicaDeadError(
                f"replica {self.replica_id} is not running"
            )
        with self._lock:
            self._inbox.append(dict(payload))

    def poll(self) -> List[dict]:
        out = []
        while True:
            try:
                out.append(self._outbox.popleft())
            except IndexError:
                return out

    def last_heartbeat(self) -> float:
        return self._hb

    # ---- serve loop --------------------------------------------------------

    def _run(self) -> None:
        generation = self.generation
        try:
            engine = self._engine_factory()
        except Exception:
            logger.exception(
                "replica %s engine build failed", self.replica_id
            )
            return
        self._ready.set()
        self._hb = self._clock()
        by_rid: Dict[int, tuple] = {}   # engine rid -> (request_id, attempt)
        migrate_rids: Set[int] = set()  # flagged for post-prefill export

        def emit(event: dict) -> None:
            event["generation"] = generation
            self._outbox.append(event)
        while not self._stop.is_set():
            if self.generation != generation:
                return  # abandoned by a restart while wedged
            if self._poison.is_set():
                return  # crash: no drain, no farewell, heartbeats stop
            try:
                fault_point("fleet.replica.step", replica=self.replica_id)
            except Exception:
                # Injected step fault = the loop dies silently, the way
                # a wedged device thread would. Detection is the
                # router's job (heartbeats + alive()).
                return
            try:
                fault_point(
                    "fleet.health.heartbeat", replica=self.replica_id
                )
                self._hb = self._clock()
            except Exception:
                pass  # dropped heartbeat: the breaker strikes accrue
            moved = False
            while True:
                with self._lock:
                    item = (
                        self._inbox.popleft() if self._inbox else None
                    )
                if item is None:
                    break
                if isinstance(item, WorkItem):
                    req = serve_submit(
                        engine, by_rid, emit,
                        item.request_id, item.attempt, item.prompt,
                        item.max_new_tokens, item.temperature,
                        item.deadline_s, trace=item.trace,
                        slo_class=item.slo_class,
                    )
                    if req is not None and item.migrate_after_prefill:
                        migrate_rids.add(req.rid)
                else:
                    serve_control(
                        engine, by_rid, emit, migrate_rids, item
                    )
                moved = True
            if engine.pending():
                serve_step(engine, by_rid, emit)
                moved = True
            serve_exports(engine, by_rid, emit, migrate_rids)
            if not moved:
                time.sleep(self._idle_sleep_s)


class SubprocessReplica:
    """Out-of-process replica over stdin/stdout JSONL: env-armed fault
    schedules, fsynced fault traces, per-generation log files.
    ``device`` ("cuda" by default, or "cpu") and ``config`` ("tiny", or
    "flagship") pick where the worker's engine runs and which model it
    serves; a worker asked for the card that finds none exits."""

    mode = "subprocess"

    def __init__(
        self,
        replica_id: str,
        work_dir: str,
        slots: int = 2,
        max_len: int = 64,
        prefill_chunk: int = 8,
        heartbeat_s: float = 0.2,
        schedule_path="",
        clock: Callable[[], float] = time.monotonic,
        paged: bool = False,
        block_size: int = 8,
        num_blocks: Optional[int] = None,
        role: str = "mixed",
        device: str = "cuda",
        config: str = "tiny",
    ):
        # ``schedule_path``: a str arms the same fault schedule on every
        # generation; a sequence indexes by generation ("" past the end)
        # — so a replica SIGKILLed by its gen-0 schedule comes back
        # CLEAN and can actually recover instead of deterministically
        # re-dying at the same hit count forever.
        self.replica_id = str(replica_id)
        self.role = role  # "prefill" | "decode" | "mixed"
        self._work_dir = work_dir
        self._slots = slots
        self._max_len = max_len
        self._prefill_chunk = prefill_chunk
        self._heartbeat_s = heartbeat_s
        self._schedule_path = schedule_path
        self._clock = clock
        self._paged = paged
        self._block_size = block_size
        self._num_blocks = num_blocks
        self._device = device
        self._config = config
        # Latest paged-KV allocator stats the worker piggybacked on a
        # heartbeat ({} until the first one); survives the process so
        # a caller can assert block conservation even after a SIGKILL.
        # ``kv_violation`` records the first heartbeat whose
        # stats broke conservation (checked at receipt — a violation
        # mid-run must not be masked by a clean final state).
        self.last_kv: Dict = {}
        self.kv_violation: Optional[str] = None
        # One entry a generation: its ready line (pid, device) and the
        # seconds from spawn to it; and each generation's decode-kernel
        # launches as its last heartbeat counted them.
        self.starts: List[Dict] = []
        self.launches: Dict[int, Dict[str, int]] = {}
        self._spawned = 0.0
        self._proc: Optional[subprocess.Popen] = None
        self._reader: Optional[threading.Thread] = None
        self._outbox: Deque[dict] = deque()
        self._hb = 0.0
        self._ready = threading.Event()
        self._stdin_lock = threading.Lock()
        self.generation = 0
        os.makedirs(work_dir, exist_ok=True)

    # ---- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            return
        # The directory that holds this package (the repo root).
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        )))
        env = dict(os.environ)
        env.update({
            "PYTHONPATH": repo_root + os.pathsep + env.get(
                "PYTHONPATH", ""
            ),
            TRACE_ENV: os.path.join(
                self._work_dir,
                f"trace_replica{self.replica_id}.jsonl",
            ),
        })
        from dlrover_tpu_torch.observability import tracing as tracing_lib

        if tracing_lib.active_tracer() is not None:
            # Parent traces -> children trace too, each into its own
            # JSONL (a SIGKILLed replica's finished spans survive).
            # Disarmed parents rig nothing.
            env[tracing_lib.TRACE_FILE_ENV] = os.path.join(
                self._work_dir,
                f"spans_replica{self.replica_id}.jsonl",
            )
        else:
            env.pop(tracing_lib.TRACE_FILE_ENV, None)
        sched = self._schedule_path
        if not isinstance(sched, str):
            sched = (
                sched[self.generation]
                if self.generation < len(sched) else ""
            )
        if sched:
            env[SCHEDULE_ENV] = sched
        else:
            env.pop(SCHEDULE_ENV, None)
        args = [
            sys.executable, "-m",
            "dlrover_tpu_torch.serving.fleet.replica_worker",
            "--replica-id", self.replica_id,
            "--slots", str(self._slots),
            "--max-len", str(self._max_len),
            "--prefill-chunk", str(self._prefill_chunk),
            "--heartbeat-s", str(self._heartbeat_s),
            "--device", self._device,
            "--config", self._config,
        ]
        if self._paged:
            args += ["--paged", "--block-size", str(self._block_size)]
            if self._num_blocks is not None:
                args += ["--num-blocks", str(self._num_blocks)]
        log_path = os.path.join(
            self._work_dir,
            f"replica{self.replica_id}_gen{self.generation}.log",
        )
        self._ready.clear()
        self._spawned = time.monotonic()
        with open(log_path, "w") as log:
            # The child duplicates the fd; closing the parent handle
            # keeps long fleets from accumulating fds.
            self._proc = subprocess.Popen(
                args, env=env, cwd=repo_root,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=log, text=True, bufsize=1,
            )
        self._reader = threading.Thread(
            target=self._read_events,
            args=(self._proc, self.generation),
            name=f"fleet-replica-{self.replica_id}-reader",
            daemon=True,
        )
        self._reader.start()

    def wait_ready(self, timeout: float = 60.0) -> bool:
        return self._ready.wait(timeout)

    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def kill(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait(timeout=5)

    def stop(self) -> None:
        if self._proc is None:
            return
        if self._proc.poll() is None:
            try:
                self._send({"op": "stop"})
                self._proc.wait(timeout=5)
            except (ReplicaDeadError, subprocess.TimeoutExpired):
                self._proc.kill()
                try:
                    self._proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
        if self._reader is not None:
            self._reader.join(timeout=2)

    def restart(self) -> None:
        self.stop()
        self.generation += 1
        self.start()

    # ---- router surface ----------------------------------------------------

    def submit(self, item: WorkItem) -> None:
        self._send(item.to_wire())

    def send(self, payload: dict) -> None:
        """A control op as a JSONL line (the ThreadReplica twin)."""
        self._send(payload)

    def poll(self) -> List[dict]:
        out = []
        while True:
            try:
                out.append(self._outbox.popleft())
            except IndexError:
                return out

    def last_heartbeat(self) -> float:
        return self._hb

    # ---- internals ---------------------------------------------------------

    def _send(self, payload: dict) -> None:
        if not self.alive():
            raise ReplicaDeadError(
                f"replica {self.replica_id} process is not running"
            )
        line = json.dumps(payload) + "\n"
        try:
            with self._stdin_lock:
                self._proc.stdin.write(line)
                self._proc.stdin.flush()
        except (BrokenPipeError, OSError, ValueError) as e:
            raise ReplicaDeadError(
                f"replica {self.replica_id} pipe closed: {e}"
            ) from e

    def _read_events(self, proc: subprocess.Popen, generation: int):
        """Drain the child's stdout until EOF (exit/SIGKILL). Heartbeats
        update the timestamp in place; completions queue for poll().
        The heartbeat is stamped with the PARENT clock at receipt — the
        breaker compares against the router's clock, and a dead child's
        last self-reported time would lie about when it was last seen."""
        try:
            for line in proc.stdout:
                line = line.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line)
                except ValueError:
                    continue  # torn line from a SIGKILL mid-write
                kind = event.get("kind")
                if kind == "heartbeat":
                    self._hb = self._clock()
                    if "launches" in event:
                        self.launches[generation] = event["launches"]
                    kv = event.get("kv")
                    if kv:
                        self.last_kv = kv
                        self._check_kv(kv)
                elif kind == "ready":
                    self._hb = self._clock()
                    self.starts.append(dict(
                        event, generation=generation,
                        start_s=time.monotonic() - self._spawned))
                    self._ready.set()
                elif kind in ("done", "exported", "imported"):
                    event.setdefault("generation", generation)
                    self._hb = self._clock()
                    self._outbox.append(event)
        except (OSError, ValueError):
            pass

    def _check_kv(self, kv: dict) -> None:
        """Block conservation, checked at heartbeat RECEIPT: free +
        used + cached must sum to the managed pool and no refcount may
        go negative. The first violation is pinned for the caller to
        read after the run."""
        if self.kv_violation is not None:
            return
        try:
            total = kv["free"] + kv["used"] + kv["cached"]
            if total != kv["total"]:
                self.kv_violation = (
                    f"replica {self.replica_id}: free {kv['free']} + "
                    f"used {kv['used']} + cached {kv['cached']} = "
                    f"{total} != total {kv['total']}"
                )
            elif kv.get("negative_refs", 0):
                self.kv_violation = (
                    f"replica {self.replica_id}: "
                    f"{kv['negative_refs']} negative refcount(s)"
                )
        except (KeyError, TypeError) as e:
            self.kv_violation = (
                f"replica {self.replica_id}: malformed kv stats "
                f"{kv!r}: {e}"
            )
