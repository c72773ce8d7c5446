"""Fault-point registry + seeded fault schedules (the port's own copy of
``dlrover_tpu/fault/registry.py``: the same rule grammar, environment
names and trace records, so one schedule file arms either package the
same way).

- A **fault point** is a named call site on a production code path:
  ``fault_point("fleet.replica.import", replica=...)``. Disarmed (the
  default) the call is one global read and a return.
- A **FaultSchedule** arms the process: a list of :class:`FaultRule`\\ s,
  each binding a point (exact name or ``fnmatch`` glob) to an action.
  Triggers are deterministic: a rule fires on the Nth matching hit
  (per-rule counter), optionally once.
- **Actions**: ``raise`` (``FaultInjected``), ``delay`` (sleep
  ``delay_s``), ``crash`` (SIGKILL the process), ``truncate`` (returned
  to the caller as a directive).
- Every *fired* injection is appended to the schedule's trace — and,
  when ``DLROVER_TPU_FAULT_TRACE`` names a file, appended there with an
  fsync BEFORE the action executes, so even a ``crash`` action's entry
  survives the SIGKILL.

Cross-process arming: ``DLROVER_TPU_FAULT_SCHEDULE`` points at a JSON
file (:meth:`FaultSchedule.to_json` format); a subprocess calls
:func:`arm_from_env` early in main (the fleet's replica worker does).
"""

import fnmatch
import json
import os
import signal
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import logger

SCHEDULE_ENV = "DLROVER_TPU_FAULT_SCHEDULE"
TRACE_ENV = "DLROVER_TPU_FAULT_TRACE"


class FaultInjected(RuntimeError):
    """Raised by an armed fault point with action ``raise``."""

    def __init__(self, point: str, rule_id: str = ""):
        super().__init__(f"injected fault at {point}" +
                         (f" (rule {rule_id})" if rule_id else ""))
        self.point = point
        self.rule_id = rule_id


class FaultAction:
    RAISE = "raise"
    DELAY = "delay"
    CRASH = "crash"
    TRUNCATE = "truncate"

    ALL = (RAISE, DELAY, CRASH, TRUNCATE)


# The instrumented sites of the port, greppable in one place (the
# reference's names for the same sites; the control plane's points
# are its master, client, task manager and sync service).
KNOWN_POINTS: Dict[str, str] = {
    "rpc.get.drop_reply": (
        "master servicer: after a get handler ran (state mutated), drop "
        "the reply — the client sees a transport error, leases/values "
        "already moved master-side (ctx: request=<request class name>)"
    ),
    "rpc.report.drop_reply": (
        "master servicer: after a report handler ran, drop the reply — "
        "exercises at-most-once re-apply of done-reports etc."
    ),
    "rpc.client.get": (
        "master client: before a get RPC leaves the worker "
        "(ctx: request) — delay simulates a slow master, raise a "
        "dead one"
    ),
    "rpc.client.report": (
        "master client: before a report RPC leaves the worker"
    ),
    "shard.dispatch": (
        "task manager: entry of the batched lease dispatch — delay "
        "starves the prefetch pipeline"
    ),
    "sync.wait": (
        "sync service: a bounded barrier wait is starting — delay "
        "pushes it into its timeout path"
    ),
    "data.prefetch.fetch": (
        "sharding client: prefetcher about to fetch leases — raise "
        "drives the transport-failure retry/backoff path"
    ),
    "rescale.plan.broadcast": (
        "master servicer: a rescale plan is about to be returned to a "
        "polling worker — raise drops the broadcast on the wire; the "
        "pull protocol must re-deliver it on the next poll "
        "(ctx: plan_id, rank)"
    ),
    "rescale.barrier.wait": (
        "rescale client: one poll of a plan's phase barrier — crash is "
        "a worker SIGKILL mid-barrier; the coordinator's bounded wait "
        "must expire and re-plan around it (ctx: plan_id, phase)"
    ),
    "rescale.resume.first_step": (
        "rescale client: state restored, resume acked, first "
        "post-rescale step about to run — crash kills the worker in "
        "the restore-to-first-step window (ctx: plan_id)"
    ),
    "master.journal.write": (
        "master journal: a record group just became durable (fsynced) "
        "but the RPC reply has NOT been sent (ctx: kind) — crash on "
        "kind=dispatch is the canonical master_kill window: the lease "
        "is journaled, the worker never saw it, and the restarted "
        "master must requeue it exactly once"
    ),
    "master.restart": (
        "master journal: restore_master_state is replaying a recovered "
        "journal into a fresh master (ctx: epoch) — delay stretches the "
        "recovery window workers must ride through, raise fails the "
        "rehydration"
    ),
    "ckpt.persist.torn_write": (
        "checkpoint storage: a proc shard file just landed — truncate "
        "tears its tail (torn write at crash), the reader must reject "
        "it (ctx: path)"
    ),
    "ckpt.persist.proc_file": (
        "checkpoint storage: before a proc shard file is written — "
        "crash kills the persister mid-step-dir (uncommitted dir), "
        "raise fails the persist"
    ),
    "ckpt.restore.memory": (
        "checkpoint engine: about to read the shm image — raise "
        "simulates the host (and its shm) being replaced, forcing the "
        "storage restore path"
    ),
    "agent.worker.crash": (
        "elastic trainer: a training step just completed — crash is a "
        "worker SIGKILL mid-step (ctx: step)"
    ),
    "serving.step.error": (
        "serving engine: an iteration is about to run its device steps "
        "— raise simulates a device error mid-decode"
    ),
    "fleet.router.dispatch": (
        "fleet router: a request is about to be handed to a chosen "
        "replica (ctx: replica, request) — raise drives the bounded "
        "retry / re-dispatch-to-a-different-replica path"
    ),
    "fleet.router.migrate": (
        "fleet router: an exported payload is about to be sent to its "
        "import destination (ctx: src, dst, request) — raise is a "
        "failed send; the source keeps the request"
    ),
    "fleet.replica.step": (
        "fleet replica serve loop: one iteration is about to run "
        "(ctx: replica) — raise kills a thread replica's loop (the "
        "router must detect the silent death via heartbeats), crash "
        "SIGKILLs a subprocess replica mid-decode"
    ),
    "fleet.replica.import": (
        "fleet replica worker: an import command arrived, no ack sent "
        "yet (ctx: replica) — crash SIGKILLs the destination holding "
        "the migrated bytes; the never-released source completes"
    ),
    "fleet.health.heartbeat": (
        "fleet replica: a heartbeat is about to be recorded/emitted "
        "(ctx: replica) — raise drops it (missed-heartbeat strikes), "
        "delay simulates a stalled replica"
    ),
}


@dataclass
class FaultRule:
    """One (point, trigger, action) binding.

    ``nth``: fire on the Nth matching hit (1-based) of this rule's
    counter; ``every``: after the first firing, fire again every
    ``every`` hits (0 = governed by ``once``). ``once``: disarm after
    the first firing. ``match``: equality filter on the fault point's
    ctx kwargs (a hit only counts when every key matches).
    """

    point: str
    action: str = FaultAction.RAISE
    nth: int = 1
    once: bool = True
    every: int = 0
    delay_s: float = 0.0
    truncate_bytes: int = 0
    match: Optional[Dict[str, str]] = None
    rule_id: str = ""
    # runtime state (not part of the wire format)
    hits: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.action not in FaultAction.ALL:
            raise ValueError(f"unknown fault action {self.action!r}")
        if self.nth < 1:
            raise ValueError("nth is 1-based; use nth=1 for 'first hit'")
        if self.every > 0:
            # A recurring rule that disarms after one firing would
            # silently contradict its own ``every``.
            self.once = False
        if not self.rule_id:
            self.rule_id = f"{self.point}:{self.action}:n{self.nth}"

    def matches(self, name: str, ctx: Dict) -> bool:
        if not fnmatch.fnmatchcase(name, self.point):
            return False
        if self.match:
            for key, want in self.match.items():
                if str(ctx.get(key)) != str(want):
                    return False
        return True

    def should_fire(self) -> bool:
        """Call with the schedule lock held, after incrementing hits."""
        if self.once and self.fired:
            return False
        if self.hits == self.nth:
            return True
        if self.every > 0 and self.hits > self.nth:
            return (self.hits - self.nth) % self.every == 0
        return False

    def to_dict(self) -> dict:
        d = asdict(self)
        d.pop("hits")
        d.pop("fired")
        return d


# A delay sleeps in slices of at most this long. CPython runs a signal's
# handler only on its main thread, and a signal that the kernel hands to
# another thread wakes no sleep of the main thread. The kernel does so
# whenever the main thread is stopped, as while a tracer (the native
# stack sampler) holds it: one long sleep would hold a SIGUSR1's
# on-demand dump for the whole delay.
DELAY_SLICE_S = 0.05


def _sleep_in_slices(seconds: float):
    end = time.monotonic() + seconds
    while (left := end - time.monotonic()) > 0:
        time.sleep(min(left, DELAY_SLICE_S))


class FaultSchedule:
    """A seeded set of rules + the trace of everything that fired.

    The ``seed`` is carried for provenance/repro (the soak derives rule
    parameters from it); triggering itself is deterministic counters.
    """

    def __init__(self, rules: List[FaultRule], seed: int = 0,
                 label: str = ""):
        self.rules = list(rules)
        self.seed = seed
        self.label = label
        self.trace: List[Dict] = []
        self._lock = threading.Lock()
        self._seq = 0
        self._trace_path = os.getenv(TRACE_ENV, "")

    # ---- hit path ----------------------------------------------------------

    def hit(self, name: str, ctx: Dict) -> Optional[Dict]:
        """Evaluate one fault-point hit. Returns a directive dict for
        caller-applied actions (truncate), None otherwise. May raise
        FaultInjected, sleep, or SIGKILL the process."""
        fired_rule = None
        with self._lock:
            for rule in self.rules:
                if not rule.matches(name, ctx):
                    continue
                rule.hits += 1
                if rule.should_fire():
                    rule.fired += 1
                    fired_rule = rule
                    # Entry built UNDER the lock: a concurrent hit on
                    # the same rule must not bump ``hits`` between the
                    # firing decision and its record, and seq order
                    # must match append order in the in-memory trace.
                    self._seq += 1
                    entry = {
                        "seq": self._seq,
                        "point": name,
                        "action": rule.action,
                        "rule_id": rule.rule_id,
                        "hit": rule.hits,
                        "pid": os.getpid(),
                    }
                    self.trace.append(entry)
                    break  # first matching rule wins this hit
        if fired_rule is None:
            return None
        self._record(entry)
        return self._execute(fired_rule, name, entry)

    def _record(self, entry: Dict):
        logger.warning(
            "fault injected: %s action=%s rule=%s hit=%d",
            entry["point"], entry["action"], entry["rule_id"], entry["hit"],
        )
        # Persist BEFORE acting: a crash action must not lose its entry.
        if self._trace_path:
            try:
                with open(self._trace_path, "a") as f:
                    f.write(json.dumps(entry) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
            except OSError:
                pass

    def _execute(self, rule: FaultRule, name: str, entry: Dict):
        if rule.action == FaultAction.DELAY:
            _sleep_in_slices(rule.delay_s)
            return None
        if rule.action == FaultAction.RAISE:
            raise FaultInjected(name, rule.rule_id)
        if rule.action == FaultAction.CRASH:
            os.kill(os.getpid(), signal.SIGKILL)
            # Unreachable except in exotic test rigs that block SIGKILL
            # delivery semantics; fall through to a hard exit.
            os._exit(137)
        if rule.action == FaultAction.TRUNCATE:
            return {
                "action": FaultAction.TRUNCATE,
                "truncate_bytes": rule.truncate_bytes,
                "rule_id": rule.rule_id,
            }
        return None

    # ---- wire format -------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "label": self.label,
            "rules": [r.to_dict() for r in self.rules],
        }, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        data = json.loads(text)
        rules = [FaultRule(**r) for r in data.get("rules", [])]
        return cls(rules, seed=data.get("seed", 0),
                   label=data.get("label", ""))


# ---------------------------------------------------------------------------
# Process-wide arming
# ---------------------------------------------------------------------------

_armed: Optional[FaultSchedule] = None
_arm_lock = threading.Lock()


def fault_point(name: str, **ctx) -> Optional[Dict]:
    """THE injection site call. Disarmed: one global read, return None.

    Armed: may raise :class:`FaultInjected`, sleep, SIGKILL the process,
    or return a directive dict (``truncate``) the caller applies.
    """
    sched = _armed
    if sched is None:
        return None
    return sched.hit(name, ctx)


def arm(schedule: FaultSchedule) -> FaultSchedule:
    global _armed
    with _arm_lock:
        _armed = schedule
    logger.warning(
        "fault schedule armed: seed=%d label=%s rules=%d",
        schedule.seed, schedule.label, len(schedule.rules),
    )
    return schedule


def disarm():
    global _armed
    with _arm_lock:
        _armed = None


def active_schedule() -> Optional[FaultSchedule]:
    return _armed


def arm_from_env() -> Optional[FaultSchedule]:
    """Arm from the JSON file named by ``DLROVER_TPU_FAULT_SCHEDULE``
    (subprocess rigging). No-op when unset/unreadable — a worker must
    never die because its chaos rigging file vanished."""
    path = os.getenv(SCHEDULE_ENV, "")
    if not path:
        return None
    try:
        with open(path) as f:
            schedule = FaultSchedule.from_json(f.read())
    except (OSError, ValueError, TypeError) as e:
        logger.warning("fault schedule %s unusable: %s", path, e)
        return None
    return arm(schedule)
