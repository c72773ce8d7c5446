"""Health-gated request router over N serving replicas (the port's own
copy of ``dlrover_tpu/serving/fleet/router.py``; plain Python, the same
policies, results and metrics).

The fleet front door: requests enter here, replicas die/stall/overload
behind it, and the contract to the caller stays simple — **every
accepted request completes or is explicitly failed exactly once**. The pieces:

- **Health-gated least-loaded dispatch.** Each replica sits behind a
  :class:`~dlrover_tpu_torch.serving.fleet.health.ReplicaHealth` breaker;
  dispatch picks the least-loaded replica the breaker admits (HEALTHY
  before SUSPECT before HALF_OPEN probes). One seeded RNG drives all
  jitter, so a router run is as reproducible as a fault schedule.
- **Deadlines.** A per-request TTL is checked at admission, at every
  pump, and at dispatch; the REMAINING budget is propagated into the
  replica's scheduler (satellite: `Scheduler.shed_expired`), so a dead
  client's request cannot occupy a slot anywhere in the fleet.
- **Bounded jittered retries.** A failed attempt (replica error,
  dispatch fault, replica death) re-dispatches to a *different* replica
  after an exponential jittered backoff, at most ``max_retries`` times;
  exhaustion is an explicit terminal failure carrying the last
  machine-readable reason.
- **At-most-once completion.** The stable ``request_id`` keys a result
  table; the first completion wins and every later one (hedge twin,
  reclaimed-but-alive attempt, replayed wire event) is dropped and
  counted in ``fleet_duplicate_completions_total``.
- **Hedging.** A short request (``max_new <= hedge_max_new_tokens``)
  whose sole attempt has been out longer than the observed service-
  latency percentile gets a speculative duplicate on a different
  replica — tail latency protection that the at-most-once table makes
  safe.
- **Load shedding.** Admission beyond ``max_queue`` returns an explicit
  overload result immediately — the router never queues unboundedly.
- **Crash re-routing.** A replica whose breaker enters BROKEN (process
  exit, poisoned thread, missed heartbeats) has its in-flight ledger
  reclaimed — `Scheduler.requeue_active` semantics lifted to the fleet:
  victims re-queue at the FRONT in submit order and re-dispatch
  elsewhere. The router restarts dead replicas after the breaker's
  cooldown and re-admits them through half-open probes.
- **Disaggregated prefill/decode.** Replica handles carry a
  ``role`` (``prefill`` | ``decode`` | ``mixed``; all-mixed = the
  co-located baseline, byte-for-byte unchanged). Fresh work lands on
  prefill-capable replicas; a request dispatched to a ``prefill``
  replica is flagged ``migrate_after_prefill`` — when its first token
  lands, the replica exports the KV blocks, the router hands them to
  the least-loaded decode-capable replica, and on the import ack moves
  the in-flight ledger entry and releases the source. Every failure
  mode falls back without breaking exactly-once: a refused/failed
  import means the source (still live — it keeps decoding until the
  release ack) completes the request; a destination that dies after
  the ack is the ordinary crash-re-route, one from-scratch re-prefill.
  ``drain_replica`` uses the same machinery to move in-flight decodes
  OFF a shrinking replica instead of requeueing them from zero.

The router is pump-driven by design: every structure is owned by the
pump (``step()``), driven by the caller or by ``serve_forever``-style
loops; replicas do their work on their own threads/processes and
communicate only through their mailboxes. A router-wide RLock
serializes the public surface (``step``/``submit``/``results`` and the
live-sizing verbs ``add_replica``/``drain_replica``) so an
autoscaler thread can resize the fleet against a pumping router;
uncontended, the lock is one acquire per pump. With an injected clock
and fake replicas the whole policy surface is unit-testable without
sleeps.
"""

import random
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.fault import fault_point
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.serving.fleet import health as health_lib
from dlrover_tpu_torch.serving.fleet.metrics import fleet_metrics
from dlrover_tpu_torch.serving.fleet.replica import (
    ReplicaDeadError,
    WorkItem,
)


@dataclass
class RouterConfig:
    max_queue: int = 256            # admission bound (queued + waiting)
    max_retries: int = 2            # re-dispatches after failed attempts
    retry_backoff_s: float = 0.05
    retry_backoff_max_s: float = 2.0
    retry_jitter_frac: float = 0.3
    hedge_enabled: bool = False     # optional speculative duplicates
    hedge_max_new_tokens: int = 16  # only short requests hedge
    hedge_after_s: Optional[float] = None   # None = adaptive percentile
    hedge_percentile: float = 95.0
    hedge_min_after_s: float = 0.25
    hedge_min_samples: int = 8      # latencies before adaptive hedging
    default_deadline_s: Optional[float] = None
    max_done_retained: int = 4096   # terminal requests kept for results()
    auto_restart: bool = True       # respawn dead replicas post-cooldown
    # A freshly restarted replica is silent while it boots (a
    # subprocess's interpreter start, CUDA context, model init and
    # warmup take seconds): give it this long before heartbeat silence
    # reads as "wedged, restart again" — or a slow boot becomes an
    # infinite restart loop.
    restart_boot_grace_s: float = 30.0
    seed: int = 0
    # Prefix-affinity dispatch: requests whose leading tokens
    # match a recently dispatched prefix prefer the replica holding
    # the warm KV blocks — health gating and at-most-once semantics
    # UNCHANGED (affinity only picks among already-dispatchable
    # candidates, after probe canarying, and never a replica the
    # request already tried).
    prefix_affinity: bool = True
    # Leading tokens hashed as the affinity key: requests sharing at
    # LEAST this many leading tokens route together. Two cache blocks
    # at the default block size — shorter than typical system prompts
    # (keying on more tokens than the shared prefix would fold the
    # divergent tail into the hash and group nothing).
    affinity_prefix_tokens: int = 16
    affinity_max_entries: int = 2048    # bounded LRU prefix -> replica map
    # Affinity yields to load balance when the warm replica is this
    # many in-flight items busier than the least-loaded candidate.
    affinity_max_load_gap: int = 4
    # An exported payload whose import ack never arrives
    # (destination SIGKILLed mid-migration) is forgotten after this
    # long — the source, still live, completes the request.
    migration_timeout_s: float = 30.0
    # Live drain: how long drain_replica pumps for in-flight
    # decodes to migrate off before falling back to requeue-from-zero.
    drain_migrate_timeout_s: float = 10.0
    health: health_lib.HealthPolicy = field(
        default_factory=health_lib.HealthPolicy
    )


@dataclass
class FleetResult:
    request_id: str
    ok: bool
    tokens: List[int] = field(default_factory=list)
    truncated: bool = False
    failure_reason: str = ""
    replica_id: str = ""
    attempts: int = 0
    retries: int = 0
    hedged: bool = False
    ttft_s: Optional[float] = None
    latency_s: Optional[float] = None


@dataclass
class FleetRequest:
    """Router-side request state. ``request_id`` is stable across every
    retry/hedge — it IS the at-most-once key."""

    request_id: str
    seq: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    slo_class: Optional[str] = None       # named SLO class
    prefix_key: Optional[int] = None      # affinity hash of the prompt head
    deadline: Optional[float] = None      # absolute, router clock
    submit_t: float = 0.0
    accepted: bool = True
    attempt_seq: int = 0                  # next attempt number
    failed_attempts: int = 0
    hedged: bool = False
    first_dispatch_t: Optional[float] = None
    # attempt -> (replica_id, dispatch_t, is_probe)
    live_attempts: Dict[int, Tuple[str, float, bool]] = field(
        default_factory=dict
    )
    tried_replicas: set = field(default_factory=set)
    result: Optional[FleetResult] = None
    # Tracing (None when disarmed): one root span per request, one
    # child span per dispatch attempt — retries and hedges are SIBLING
    # spans under the root, so a rerouted request's tree shows the
    # failed attempt next to the one that won.
    span: Optional[object] = None
    attempt_spans: Dict[int, object] = field(default_factory=dict)

    @property
    def done(self) -> bool:
        return self.result is not None


@dataclass
class _Migration:
    """One in-flight migration: export received from ``src``,
    import sent to ``dst``, awaiting the ack. The source keeps the
    request live the whole time — a lost ack costs nothing but the
    wasted wire bytes."""

    req: FleetRequest
    attempt: int
    src: str
    dst: str
    export_t: float
    span: Optional[object] = None


class FleetRouter:
    """See module docstring. One pump thread drives ``step()``; the
    live-sizing surface (``add_replica``/``drain_replica``, an
    autoscaler's actuation path) and ``submit`` may be called from
    OTHER threads — a router-wide RLock serializes them against the
    pump, so a drain can never yank ``_replicas``/``_ledger`` out from
    under a step iteration."""

    def __init__(
        self,
        replicas: List,
        config: Optional[RouterConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        registry=None,
    ):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self._lock = threading.RLock()
        self.config = config or RouterConfig()
        self._clock = clock
        self.metrics = fleet_metrics(registry)
        self._replicas = {r.replica_id: r for r in replicas}
        if len(self._replicas) != len(replicas):
            raise ValueError("duplicate replica_id in fleet")
        self._health: Dict[str, health_lib.ReplicaHealth] = {}
        for rid in self._replicas:
            self._health[rid] = health_lib.ReplicaHealth(
                rid,
                policy=self.config.health,
                clock=clock,
                on_transition=self._make_transition_hook(rid),
            )
            self.metrics.replica_state.set(0, replica=rid)
        self._queue: Deque[FleetRequest] = deque()
        self._waiting: List[Tuple[float, FleetRequest]] = []
        # replica_id -> {(request_id, attempt) -> FleetRequest}
        self._ledger: Dict[str, Dict[Tuple[str, int], FleetRequest]] = {
            rid: {} for rid in self._replicas
        }
        self._requests: Dict[str, FleetRequest] = {}
        # Terminal requests in completion order; bounds _requests so a
        # long-lived router does not grow RSS with every request ever
        # served (callers keep their own FleetRequest handles).
        self._done_order: Deque[str] = deque()
        # Requests that went terminal OUTSIDE a step() (a drain's
        # reclaim can terminal-fail deadline/budget-exhausted victims):
        # delivered by the NEXT step so run_until_idle's "returns every
        # request that went terminal" contract holds.
        self._orphan_done: List[FleetRequest] = []
        self._live_accepted = 0   # accepted, no terminal result yet
        # prefix hash -> replica_id holding that prefix's warm blocks
        # (bounded LRU; entries for gone replicas lapse on validation).
        self._affinity: "OrderedDict[int, str]" = OrderedDict()
        self._last_restart: Dict[str, float] = {}
        self._service_lat: Deque[float] = deque(maxlen=256)
        # (request_id, attempt) -> in-flight migration awaiting
        # its import ack; replicas being drained (no new dispatches,
        # no migration destinations, no auto-restart).
        self._migrations: Dict[Tuple[str, int], _Migration] = {}
        self._draining: set = set()
        # Keys whose live-drain export failed (flat engine): the drain
        # loop stops waiting on them and falls back to requeue.
        self._export_failed: set = set()
        self._rng = random.Random(self.config.seed)
        self._seq = 0

    # ---- lifecycle ---------------------------------------------------------

    def start(self, wait_ready: bool = True,
              timeout_s: float = 120.0) -> None:
        for replica in self._replicas.values():
            replica.start()
        if wait_ready:
            deadline = self._clock() + timeout_s
            for replica in self._replicas.values():
                left = max(0.1, deadline - self._clock())
                if not replica.wait_ready(left):
                    logger.warning(
                        "replica %s not ready within %.0fs",
                        replica.replica_id, timeout_s,
                    )
        now = self._clock()
        for h in self._health.values():
            h.observe_heartbeat(now)

    def stop(self) -> None:
        # Snapshot under the lock (an autoscaler thread may be
        # resizing), stop outside it (subprocess teardown can block).
        with self._lock:
            replicas = list(self._replicas.values())
        for replica in replicas:
            try:
                replica.stop()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass

    # ---- live fleet sizing (the autoscaler's actuation surface) --------

    def replica_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def add_replica(self, replica, start: bool = True,
                    wait_ready: bool = False,
                    timeout_s: float = 120.0) -> None:
        """Grow the fleet live: register (and by default start) a new
        replica. It enters HEALTHY with a fresh heartbeat — the boot
        grace the breaker's missed-heartbeat strikes then cover, the
        same contract a restart gets."""
        rid = replica.replica_id
        with self._lock:
            if rid in self._replicas:
                raise ValueError(f"duplicate replica_id {rid!r}")
        # Boot OUTSIDE the router lock: a subprocess replica's start is
        # seconds of interpreter/CUDA init — holding the lock would
        # freeze the pump (and every in-flight request) for the whole
        # boot, exactly during the overload a GROW decision answers.
        if start:
            replica.start()
            if wait_ready and not replica.wait_ready(timeout_s):
                # The caller asked to block until serving: a boot
                # timeout must surface, not register a mute replica
                # as HEALTHY.
                try:
                    replica.stop()
                except Exception:  # noqa: BLE001 — best-effort
                    pass
                raise TimeoutError(
                    f"replica {rid} not ready within {timeout_s:.0f}s"
                )
        with self._lock:
            if rid in self._replicas:
                # Lost a register race while booting: this instance is
                # surplus, not fleet state.
                if start:
                    try:
                        replica.stop()
                    except Exception:  # noqa: BLE001 — best-effort
                        pass
                raise ValueError(f"duplicate replica_id {rid!r}")
            self._replicas[rid] = replica
            self._ledger[rid] = {}
            self._health[rid] = health_lib.ReplicaHealth(
                rid,
                policy=self.config.health,
                clock=self._clock,
                on_transition=self._make_transition_hook(rid),
            )
            self.metrics.replica_state.set(0, replica=rid)
            self._health[rid].observe_heartbeat(self._clock())
            logger.info("fleet replica %s added (%d replicas)",
                        rid, len(self._replicas))

    def drain_replica(self, replica_id, stop: bool = True,
                      migrate: bool = True) -> bool:
        """Shrink the fleet live. With ``migrate`` (the default)
        in-flight decodes are first MIGRATED off — each one keeps its
        sampled tokens and filled blocks instead of re-prefilling from
        zero; whatever cannot migrate within
        ``drain_migrate_timeout_s`` (mid-prefill, flat engine, no
        destination) falls back to the crash-re-route path, so nothing
        is lost or duplicated either way. The replica is fenced from
        new dispatches and destinations for the whole drain. Refuses
        to drain the last replica — a fleet of zero is an outage, not
        a scale decision."""
        rid = str(replica_id)
        migrating = False
        with self._lock:
            if rid not in self._replicas:
                return False
            if len(self._replicas) <= 1:
                raise ValueError(
                    "refusing to drain the last fleet replica"
                )
            self._draining.add(rid)
            replica = self._replicas[rid]
            if migrate and self._ledger[rid] and replica.alive():
                for request_id, attempt in list(self._ledger[rid]):
                    try:
                        replica.send({
                            "op": "export",
                            "request_id": request_id,
                            "attempt": attempt,
                        })
                        migrating = True
                    except Exception:  # noqa: BLE001 — no send()
                        # surface / dead pipe: requeue-from-zero below.
                        break
        if migrating:
            # Pump OUTSIDE the lock until every in-flight key either
            # migrated away (ledger entry moved to its destination),
            # finished, or declared itself unexportable.
            deadline = (
                time.monotonic() + self.config.drain_migrate_timeout_s
            )
            while time.monotonic() < deadline:
                self.step()
                with self._lock:
                    waiting = any(
                        k not in self._export_failed
                        for k in self._ledger.get(rid, {})
                    ) or any(
                        m.src == rid
                        for m in self._migrations.values()
                    )
                if not waiting:
                    break
                time.sleep(0.002)
        with self._lock:
            self._export_failed.clear()
            self._draining.discard(rid)
            if rid not in self._replicas:
                return False  # lost a drain race
            now = self._clock()
            newly_done: List[FleetRequest] = []
            # Whatever still sits on the replica re-queues from zero —
            # the crash-re-route path.
            self._reclaim(rid, now, newly_done)
            # Terminal results produced by the reclaim surface from the
            # next step(), not silently only in results().
            self._orphan_done.extend(newly_done)
            replica = self._replicas.pop(rid)
            self._health.pop(rid, None)
            self._ledger.pop(rid, None)
            self._last_restart.pop(rid, None)
            self._purge_affinity(rid)
            remaining = len(self._replicas)
        if stop:
            try:
                replica.stop()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
        logger.info("fleet replica %s drained (%d replicas remain)",
                    rid, remaining)
        return True

    # ---- submission --------------------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        temperature: float = 0.0,
        deadline_s: Optional[float] = None,
        request_id: Optional[str] = None,
        slo_class: Optional[str] = None,
    ) -> FleetRequest:
        with self._lock:
            return self._submit_locked(
                prompt, max_new_tokens, temperature, deadline_s,
                request_id, slo_class,
            )

    def _submit_locked(
        self,
        prompt,
        max_new_tokens: int,
        temperature: float,
        deadline_s: Optional[float],
        request_id: Optional[str],
        slo_class: Optional[str] = None,
    ) -> FleetRequest:
        now = self._clock()
        self._seq += 1
        if request_id is None:
            request_id = f"req-{self._seq}"
        if request_id in self._requests:
            raise ValueError(f"duplicate request_id {request_id!r}")
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        if deadline_s is not None and deadline_s <= 0:
            # Same contract as Scheduler.submit: 0 must not silently
            # mean "no deadline" — that is the opposite of the intent.
            raise ValueError("deadline_s must be positive")
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        prefix_key = None
        if self.config.prefix_affinity:
            prefix_key = hash(
                tuple(prompt[:self.config.affinity_prefix_tokens])
            )
        req = FleetRequest(
            request_id=request_id,
            seq=self._seq,
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature),
            slo_class=slo_class,
            prefix_key=prefix_key,
            deadline=(
                now + deadline_s if deadline_s is not None else None
            ),
            submit_t=now,
        )
        self._requests[request_id] = req
        if len(self._queue) + len(self._waiting) >= self.config.max_queue:
            # Explicit overload result, never an unbounded queue: the
            # caller can back off / balance, a dead queue cannot.
            req.accepted = False
            req.result = FleetResult(
                request_id=request_id, ok=False,
                failure_reason="overload",
            )
            self.metrics.sheds.inc(reason="overload")
            self.metrics.requests.inc(outcome="shed")
            self.metrics.failures.inc(reason="overload")
            self._retain_done(request_id)
            return req
        self.metrics.requests.inc(outcome="accepted")
        self._live_accepted += 1
        tracer = tracing.active_tracer()
        if tracer is not None:
            req.span = tracer.start_span(
                "fleet.request", kind="server",
                attrs={
                    "request_id": request_id,
                    "max_new_tokens": req.max_new_tokens,
                    "prompt_len": len(prompt),
                },
            )
        self._queue.append(req)
        self.metrics.queue_depth.set(
            len(self._queue) + len(self._waiting)
        )
        return req

    # ---- the pump ----------------------------------------------------------

    def step(self) -> List[FleetRequest]:
        """One router iteration: drain replica mailboxes, advance
        health, reclaim/re-route, shed expired, dispatch, hedge.
        Returns requests that became terminal THIS call."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> List[FleetRequest]:
        now = self._clock()
        newly_done: List[FleetRequest] = list(self._orphan_done)
        self._orphan_done.clear()
        self._drain_replicas(now, newly_done)
        self._check_replicas(now, newly_done)
        # restart() above can block for seconds (subprocess teardown):
        # deadline math below must not run on a stale clock or expired
        # requests dispatch with phantom budget.
        now = self._clock()
        self._promote_waiting(now)
        self._shed_expired(now, newly_done)
        self._prune_migrations(now)
        self._dispatch_queued(now, newly_done)
        if self.config.hedge_enabled:
            self._hedge_sweep(now, newly_done)
        self.metrics.queue_depth.set(
            len(self._queue) + len(self._waiting)
        )
        self.metrics.inflight.set(
            sum(len(led) for led in self._ledger.values())
        )
        # State reads only — dispatchable(now) would flip a cooled-down
        # BROKEN breaker to HALF_OPEN as a side effect.
        self.metrics.replicas_dispatchable.set(sum(
            1 for rid, replica in self._replicas.items()
            if replica.alive()
            and self._health[rid].state != health_lib.BROKEN
        ))
        return newly_done

    def pending(self) -> int:
        """Accepted requests without a terminal result. O(1): this is
        polled every pump by run_until_idle and the soak/bench loops,
        and _requests retains up to max_done_retained terminal entries."""
        return self._live_accepted

    def run_until_idle(self, timeout_s: float = 120.0,
                       idle_sleep_s: float = 0.002) -> List[FleetRequest]:
        """Pump until nothing is pending (or timeout); returns every
        request that went terminal during the run."""
        done: List[FleetRequest] = []
        deadline = time.monotonic() + timeout_s
        while self.pending():
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"fleet did not drain within {timeout_s}s: "
                    f"{self.pending()} pending"
                )
            got = self.step()
            done.extend(got)
            if not got:
                time.sleep(idle_sleep_s)
        return done

    def results(self) -> Dict[str, FleetResult]:
        with self._lock:
            return {
                rid: r.result
                for rid, r in self._requests.items()
                if r.result is not None
            }

    def health_state(self, replica_id: str) -> str:
        with self._lock:
            return self._health[str(replica_id)].state

    # ---- completions -------------------------------------------------------

    def _drain_replicas(self, now: float, newly_done: List[FleetRequest]):
        for rid, replica in list(self._replicas.items()):
            self._health[rid].observe_heartbeat(replica.last_heartbeat())
            for event in replica.poll():
                kind = event.get("kind")
                if kind == "done":
                    self._handle_completion(rid, event, now, newly_done)
                elif kind == "exported":
                    self._handle_exported(rid, event, now)
                elif kind == "imported":
                    self._handle_imported(rid, event, now)

    def _handle_completion(self, rid: str, event: dict, now: float,
                           newly_done: List[FleetRequest]):
        request_id = event.get("request_id")
        attempt = event.get("attempt", 0)
        req = self._requests.get(request_id)
        key = (request_id, attempt)
        entry = self._ledger[rid].pop(key, None)
        if req is None or req.done:
            # At-most-once: the result table already holds this
            # request's terminal outcome (hedge twin finished first, or
            # the attempt was reclaimed and re-run elsewhere).
            self.metrics.duplicates.inc()
            return
        live = req.live_attempts.pop(attempt, None)
        aspan = req.attempt_spans.pop(attempt, None)
        if live is not None and live[2]:
            self._health[rid].end_probe()
        if entry is None and live is None:
            # Attempt already reclaimed (the replica broke, its ledger
            # was re-routed) but the request is still live elsewhere:
            # stale evidence, not a completion — and not a duplicate,
            # since no result has been recorded yet.
            self.metrics.stale_completions.inc()
            return
        dispatch_t = live[1] if live is not None else req.submit_t
        if aspan is not None:
            if not event.get("ok"):
                aspan.set_attr(
                    "failure_reason",
                    event.get("failure_reason") or "replica_error",
                )
            aspan.end(
                status="ok" if event.get("ok") else "error"
            )
        if event.get("ok"):
            self._service_lat.append(max(0.0, now - dispatch_t))
            self._health[rid].record_success()
            self._record_result(req, FleetResult(
                request_id=request_id,
                ok=True,
                tokens=list(event.get("tokens", ())),
                truncated=bool(event.get("truncated")),
                replica_id=rid,
                attempts=req.attempt_seq,
                retries=req.failed_attempts,
                hedged=req.hedged,
                ttft_s=(
                    (dispatch_t - req.submit_t) + event["ttft_s"]
                    if event.get("ttft_s") is not None else None
                ),
                latency_s=now - req.submit_t,
            ), newly_done)
        else:
            reason = event.get("failure_reason") or "replica_error"
            if reason == "rejected":
                # The engine's scheduler refused the request (prompt too
                # long, no decode room): deterministic — every replica
                # would reject it identically, so fail it now instead of
                # burning retries, and strike nobody's breaker.
                self._terminal_failure(req, reason, now, newly_done)
                return
            if reason != "deadline":
                # A replica shedding an expired request is the replica
                # WORKING (client-side condition) — only real errors
                # strike its breaker.
                self._health[rid].record_failure(reason)
            self._attempt_failed(req, reason, now, newly_done)

    def _record_result(self, req: FleetRequest, result: FleetResult,
                       newly_done: List[FleetRequest]):
        req.result = result
        if req.accepted:
            self._live_accepted -= 1
        if result.ok:
            self.metrics.requests.inc(outcome="completed")
            if result.ttft_s is not None:
                self.metrics.ttft.observe(result.ttft_s)
            if result.latency_s is not None:
                self.metrics.latency.observe(result.latency_s)
        # Forget every other live attempt (hedge twin still computing
        # somewhere): its eventual completion is a counted duplicate.
        for attempt, (rid, _t, is_probe) in list(req.live_attempts.items()):
            self._ledger[rid].pop((req.request_id, attempt), None)
            if is_probe:
                self._health[rid].end_probe()
        req.live_attempts.clear()
        for aspan in req.attempt_spans.values():
            aspan.set_attr("abandoned", True)
            aspan.end(status="error")
        req.attempt_spans.clear()
        if req.span is not None:
            req.span.set_attr("retries", result.retries)
            req.span.set_attr("hedged", result.hedged)
            if result.replica_id:
                req.span.set_attr("replica", result.replica_id)
            if not result.ok:
                req.span.set_attr(
                    "failure_reason", result.failure_reason
                )
            req.span.end(status="ok" if result.ok else "error")
            req.span = None
        newly_done.append(req)
        self._retain_done(req.request_id)

    def _retain_done(self, request_id: str) -> None:
        self._done_order.append(request_id)
        while len(self._done_order) > self.config.max_done_retained:
            self._requests.pop(self._done_order.popleft(), None)

    # ---- migration (two-phase dispatch / live drain) -------------------

    def _role(self, rid: str) -> str:
        replica = self._replicas.get(rid)
        return getattr(replica, "role", "mixed") if replica else "mixed"

    def _send_release(self, rid: str, key: Tuple[str, int]) -> None:
        """Ack the source: drop its copy. Best-effort — a dead source
        frees everything at exit anyway."""
        replica = self._replicas.get(rid)
        if replica is None:
            return
        try:
            replica.send({
                "op": "release",
                "request_id": key[0], "attempt": key[1],
            })
        except Exception:  # noqa: BLE001 — dead pipe = moot release
            pass

    def _pick_decode_replica(self, now: float,
                             exclude=()) -> Optional[str]:
        """Least-loaded decode-capable destination for a migration:
        ``decode`` before ``mixed`` (a dedicated decode replica is the
        point of the topology), HEALTHY before SUSPECT before
        HALF_OPEN, then load. Never the source, never a draining
        replica."""
        rank = {
            health_lib.HEALTHY: 0,
            health_lib.SUSPECT: 1,
            health_lib.HALF_OPEN: 2,
        }
        cands = []
        for rid, replica in self._replicas.items():
            if rid in exclude or rid in self._draining:
                continue
            if self._role(rid) not in ("decode", "mixed"):
                continue
            if not replica.alive() or not replica.wait_ready(0.0):
                continue
            h = self._health[rid]
            if not h.dispatchable(now):
                continue
            cands.append((
                0 if self._role(rid) == "decode" else 1,
                rank[h.state], len(self._ledger[rid]), rid,
            ))
        if not cands:
            return None
        cands.sort()
        return cands[0][3]

    def _handle_exported(self, src: str, event: dict, now: float):
        """A source replica exported a flagged request's KV blocks:
        pick a decode destination and forward the payload. No viable
        destination (or a dead pipe) is a FALLBACK, not a failure —
        the source still owns the request and completes it."""
        key = (event.get("request_id"), event.get("attempt", 0))
        req = self._requests.get(key[0])
        if not event.get("payload"):
            # The source could not serialize (flat engine, torn
            # state): it keeps decoding; a drain stops waiting.
            self._export_failed.add(key)
            self.metrics.migration_failures.inc(reason="export_failed")
            return
        if req is None or req.done:
            # Finished/expired while the export was in flight: the
            # source copy is surplus.
            self._send_release(src, key)
            return
        if key in self._migrations:
            return  # duplicate export event (restarted source replays)
        dst = self._pick_decode_replica(now, exclude={src})
        if dst is None:
            self.metrics.migration_failures.inc(reason="no_destination")
            return
        mspan = None
        tracer = tracing.active_tracer()
        if tracer is not None and req.span is not None:
            mspan = tracer.start_span(
                "fleet.migrate", kind="client", parent=req.span,
                attrs={"src": src, "dst": dst},
            )
        try:
            fault_point(
                "fleet.router.migrate",
                src=src, dst=dst, request=key[0],
            )
            self._replicas[dst].send({
                "op": "import",
                "request_id": key[0], "attempt": key[1],
                "payload": event["payload"],
            })
        except Exception as e:  # noqa: BLE001 — dead pipe / injected
            if mspan is not None:
                mspan.set_attr("failure_reason", "import_send")
                mspan.end(status="error")
            self._health[dst].record_failure(
                f"migrate_send:{type(e).__name__}"
            )
            self.metrics.migration_failures.inc(reason="import_send")
            return
        self._migrations[key] = _Migration(
            req=req, attempt=key[1], src=src, dst=dst,
            export_t=now, span=mspan,
        )

    def _handle_imported(self, dst: str, event: dict, now: float):
        """The destination acked an import. ok: move the in-flight
        ledger entry src -> dst, release the source, count the pause.
        not-ok (full destination, flat engine, torn payload): the
        source keeps the request — completion still happens exactly
        once, just co-located."""
        key = (event.get("request_id"), event.get("attempt", 0))
        mig = self._migrations.pop(key, None)
        if mig is None or mig.dst != dst:
            return  # timed-out / already-resolved migration: stale ack
        req = mig.req
        if not event.get("ok"):
            reason = event.get("reason") or "import_failed"
            self.metrics.migration_failures.inc(reason=reason)
            if mig.span is not None:
                mig.span.set_attr("failure_reason", reason)
                mig.span.end(status="error")
            # A refusal is the destination WORKING (it is full, or not
            # paged) — no breaker strike; the source decodes on.
            return
        pause = max(0.0, now - mig.export_t)
        self.metrics.migrations.inc()
        self.metrics.migration_pause.observe(pause)
        self._health[dst].record_success()
        if mig.span is not None:
            mig.span.set_attr("pause_s", round(pause, 6))
            mig.span.end()
        if req.done:
            # The source finished (or the deadline fired) during the
            # handshake: the destination's copy will complete as a
            # counted duplicate; nothing to move.
            self._send_release(mig.src, key)
            return
        entry = self._ledger.get(mig.src, {}).pop(key, None)
        if entry is not None and dst in self._ledger:
            self._ledger[dst][key] = req
            live = req.live_attempts.get(mig.attempt)
            if live is not None:
                if live[2]:
                    # The probe resolved: the source survived an
                    # end-to-end prefill + export.
                    self._health[mig.src].end_probe()
                    self._health[mig.src].record_success()
                req.live_attempts[mig.attempt] = (dst, live[1], False)
            aspan = req.attempt_spans.get(mig.attempt)
            if aspan is not None:
                aspan.set_attr("migrated_to", dst)
        self._send_release(mig.src, key)

    def _prune_migrations(self, now: float):
        """Forget migrations whose ack never came (destination died
        between export and import-ack — the chaos episode). The source
        never released, so the request completes there; zero blocks
        are lost on either end."""
        if not self._migrations:
            return
        expired = [
            k for k, m in self._migrations.items()
            if now - m.export_t > self.config.migration_timeout_s
            or m.req.done
        ]
        for k in expired:
            mig = self._migrations.pop(k)
            reason = "abandoned" if mig.req.done else "timeout"
            if not mig.req.done:
                self.metrics.migration_failures.inc(reason="timeout")
            if mig.span is not None:
                mig.span.set_attr("failure_reason", reason)
                mig.span.end(status="error")

    # ---- failure / retry ---------------------------------------------------

    def _attempt_failed(self, req: FleetRequest, reason: str, now: float,
                        newly_done: List[FleetRequest],
                        immediate: bool = False):
        """One attempt of ``req`` is gone (error, dispatch fault, or
        replica death). Decide: wait for a live twin, retry elsewhere,
        or terminal-fail with the machine-readable reason."""
        req.failed_attempts += 1
        if req.live_attempts:
            return  # a hedge twin is still running; it may yet win
        if req.deadline is not None and now > req.deadline:
            self._terminal_failure(req, "deadline", now, newly_done)
            return
        if req.failed_attempts > self.config.max_retries:
            self._terminal_failure(req, reason, now, newly_done)
            return
        self.metrics.retries.inc()
        if immediate:
            # Crash re-route: no backoff (the failure was the replica,
            # not the request) — FRONT of the queue, oldest first, the
            # fleet analogue of Scheduler.requeue_active.
            self._queue.appendleft(req)
        else:
            backoff = min(
                self.config.retry_backoff_s
                * (2 ** (req.failed_attempts - 1)),
                self.config.retry_backoff_max_s,
            )
            jitter = self.config.retry_jitter_frac
            backoff *= self._rng.uniform(1.0 - jitter, 1.0 + jitter)
            self._waiting.append((now + backoff, req))

    def _terminal_failure(self, req: FleetRequest, reason: str,
                          now: float, newly_done: List[FleetRequest]):
        self._record_result(req, FleetResult(
            request_id=req.request_id,
            ok=False,
            failure_reason=reason,
            attempts=req.attempt_seq,
            retries=req.failed_attempts,
            hedged=req.hedged,
            latency_s=now - req.submit_t,
        ), newly_done)
        self.metrics.requests.inc(outcome="failed")
        self.metrics.failures.inc(reason=reason)

    # ---- health / reclaim --------------------------------------------------

    def _purge_affinity(self, rid: str) -> None:
        """Drop every affinity entry pointing at ``rid`` — its warm
        blocks are gone (drained, crashed, restarted into a cold
        cache). Lazy lapse-on-lookup alone leaves a bounded-LRU slot
        wasted per stale entry AND, worse, keeps steering same-prefix
        requests through a pointless miss path; the eager purge keeps
        the map honest at the moment the blocks die."""
        stale = [k for k, v in self._affinity.items() if v == rid]
        for k in stale:
            self._affinity.pop(k, None)

    def _make_transition_hook(self, rid: str):
        def hook(old: str, new: str):
            self.metrics.replica_state.set(
                health_lib.STATE_CODE[new], replica=rid
            )
            self.metrics.health_transitions.inc(replica=rid, to=new)
            logger.info(
                "fleet replica %s health: %s -> %s", rid, old, new
            )
        return hook

    def _check_replicas(self, now: float,
                        newly_done: List[FleetRequest]):
        for rid, replica in self._replicas.items():
            h = self._health[rid]
            if not replica.alive() and h.state != health_lib.BROKEN:
                h.mark_dead(
                    "process_exit" if replica.mode == "subprocess"
                    else "thread_exit"
                )
            else:
                h.check(now)
            if h.state == health_lib.BROKEN and self._ledger[rid]:
                self._reclaim(rid, now, newly_done)
            # A BROKEN replica with stale heartbeats is WEDGED (hung in
            # a step, not erroring): probes would only oscillate it
            # BROKEN<->HALF_OPEN forever, so it gets the dead-replica
            # remedy. A BROKEN-but-heartbeating replica recovers via
            # probes instead.
            wedged = (
                h.state == health_lib.BROKEN
                and h.heartbeat_age(now)
                > self.config.health.heartbeat_timeout_s
                and now - self._last_restart.get(rid, float("-inf"))
                > self.config.restart_boot_grace_s
            )
            if (
                self.config.auto_restart
                and rid not in self._draining
                and (not replica.alive() or wedged)
                and h.cooldown_elapsed(now)
                # BROKEN keeps its original _broken_since across a
                # failed restart, so cooldown_elapsed stays true; pace
                # respawns explicitly or a crash-on-start replica is
                # forked on every pump.
                and now - self._last_restart.get(rid, float("-inf"))
                >= self.config.health.probe_cooldown_s
            ):
                logger.warning(
                    "fleet replica %s %s past cooldown; restarting",
                    rid, "wedged" if replica.alive() else "dead",
                )
                replica.restart()
                self._last_restart[rid] = now
                self.metrics.restarts.inc()
                # The respawn boots with a cold block cache: affinity
                # entries naming it steer nothing warm anymore.
                self._purge_affinity(rid)
                # Grace: strikes resume from the restart, and the
                # HALF_OPEN flip happens at the next dispatch attempt.
                h.observe_heartbeat(now)

    def _reclaim(self, rid: str, now: float,
                 newly_done: List[FleetRequest]):
        """The fleet's `requeue_active`: pull every in-flight attempt
        off a broken replica and re-route, front-of-queue, in submit
        order."""
        entries = list(self._ledger[rid].items())
        self._ledger[rid].clear()
        self._purge_affinity(rid)
        victims: List[FleetRequest] = []
        for (request_id, attempt), req in entries:
            if req.done:
                continue
            live = req.live_attempts.pop(attempt, None)
            if live is not None and live[2]:
                self._health[rid].end_probe()
            aspan = req.attempt_spans.pop(attempt, None)
            if aspan is not None:
                # The failed attempt stays in the trace as an error
                # sibling of whatever retry eventually wins.
                aspan.set_attr("failure_reason", "replica_death")
                aspan.end(status="error")
            victims.append(req)
            self.metrics.reroutes.inc()
        # Reversed submit order + appendleft = oldest ends up first;
        # _attempt_failed(immediate=True) does the appendleft.
        for req in sorted(victims, key=lambda r: r.seq, reverse=True):
            self._attempt_failed(
                req, "replica_death", now, newly_done, immediate=True
            )

    # ---- dispatch ----------------------------------------------------------

    def _promote_waiting(self, now: float):
        if not self._waiting:
            return
        still = []
        ready = []
        for not_before, req in self._waiting:
            if req.done:
                continue
            (ready if now >= not_before else still).append(
                (not_before, req)
            )
        self._waiting = still
        for _t, req in sorted(ready, key=lambda e: e[1].seq):
            self._queue.append(req)

    def _shed_expired(self, now: float,
                      newly_done: List[FleetRequest]):
        for pool in (
            list(self._queue),
            [r for _t, r in self._waiting],
        ):
            expired = [
                r for r in pool
                if r.deadline is not None and now > r.deadline
                and not r.done
            ]
            if not expired:
                continue
            for req in expired:
                self.metrics.sheds.inc(reason="deadline")
                self._terminal_failure(req, "deadline", now, newly_done)
        if any(r.done for r in self._queue):
            self._queue = deque(
                r for r in self._queue if not r.done
            )
        if any(r.done for _t, r in self._waiting):
            self._waiting = [
                (t, r) for t, r in self._waiting if not r.done
            ]

    def _pick_replica(self, now: float, exclude=(),
                      strict_exclude: bool = False) -> Optional[str]:
        """Least-loaded among breaker-admitted replicas, preferring
        HEALTHY over SUSPECT over HALF_OPEN, and replicas the request
        has not tried. Returns None when nothing is dispatchable."""
        rank = {
            health_lib.HEALTHY: 0,
            health_lib.SUSPECT: 1,
            health_lib.HALF_OPEN: 2,
        }

        def candidates(excluded, allow_decode_role=False):
            cands = []
            for rid in self._replicas:
                if rid in excluded or rid in self._draining:
                    continue
                if (
                    not allow_decode_role
                    and self._role(rid) == "decode"
                ):
                    # Dedicated decode replicas take work only
                    # through migration imports — a fresh prompt there
                    # would burn their decode slots on prefill.
                    continue
                if not self._replicas[rid].alive():
                    # Checked BEFORE dispatchable(): a cooled-down dead
                    # replica must neither flip to HALF_OPEN here nor
                    # mask the fall-back to an already-tried live one.
                    continue
                if not self._replicas[rid].wait_ready(0.0):
                    continue  # respawned, still booting
                h = self._health[rid]
                if not h.dispatchable(now):
                    continue
                cands.append(
                    (rank[h.state], len(self._ledger[rid]), rid)
                )
            return cands

        cands = candidates(set(exclude))
        if not cands and exclude and not strict_exclude:
            # Every untried replica is fenced; a retry on a previously
            # tried one beats stalling forever.
            cands = candidates(set())
        if not cands:
            # Availability beats role purity: a fleet whose every
            # prefill-capable replica is down still serves from the
            # decode pool rather than stalling the queue.
            cands = candidates(
                set() if not strict_exclude else set(exclude),
                allow_decode_role=True,
            )
        if not cands:
            return None
        cands.sort()
        return cands[0][2]

    def _pick_probe_replica(self, now: float) -> Optional[str]:
        """A HALF_OPEN (or cooled-down BROKEN) replica with a free
        probe slot. Probes must be actively FED: least-loaded choice
        alone would starve a recovering replica forever while any
        healthy peer exists, so fresh requests canary it explicitly."""
        for rid, replica in self._replicas.items():
            h = self._health[rid]
            if h.state not in (health_lib.BROKEN, health_lib.HALF_OPEN):
                continue
            if rid in self._draining or self._role(rid) == "decode":
                # Decode-role replicas are probed by migration traffic
                # (the import ack records their success), not by fresh
                # prompts.
                continue
            if not replica.alive():
                continue
            if not replica.wait_ready(0.0):
                # Respawned but still booting (CUDA init + warmup): a
                # probe now would just sit out the boot while healthy
                # peers idle. Readiness is per-generation, so this
                # self-clears once the replica announces ready.
                continue
            if h.dispatchable(now) and h.is_probe_dispatch():
                return rid
        return None

    def _pick_affinity_replica(self, req: FleetRequest,
                               now: float) -> Optional[str]:
        """The replica that last served this prompt prefix, if it is
        still a LEGITIMATE candidate: alive, ready, breaker-admitted,
        untried by this request, and not more than
        ``affinity_max_load_gap`` in-flight items busier than the
        least-loaded dispatchable peer. Health gating is unchanged —
        affinity only biases the choice among admitted replicas."""
        key = req.prefix_key
        if key is None:
            return None
        rid = self._affinity.get(key)
        if rid is None:
            return None
        replica = self._replicas.get(rid)
        if replica is None:
            self._affinity.pop(key, None)   # drained/removed replica
            return None
        if (
            rid in req.tried_replicas
            or rid in self._draining
            or self._role(rid) == "decode"
            or not replica.alive()
            or not replica.wait_ready(0.0)
            or not self._health[rid].dispatchable(now)
            or self._health[rid].state == health_lib.BROKEN
        ):
            return None
        loads = [
            len(self._ledger[r]) for r in self._replicas
            if self._replicas[r].alive()
            and self._health[r].state != health_lib.BROKEN
        ]
        if loads and (
            len(self._ledger[rid]) - min(loads)
            > self.config.affinity_max_load_gap
        ):
            return None   # warm blocks are not worth a hot spot
        return rid

    def _dispatch_queued(self, now: float,
                         newly_done: List[FleetRequest]):
        stalled: List[FleetRequest] = []
        while self._queue:
            req = self._queue.popleft()
            if req.done:
                continue
            rid = None
            if not req.failed_attempts:
                # Only fresh requests canary a recovering replica —
                # a retried request has already paid a failed attempt
                # and goes to the best-known replica.
                rid = self._pick_probe_replica(now)
            affine = False
            if rid is None and self.config.prefix_affinity:
                rid = self._pick_affinity_replica(req, now)
                affine = rid is not None
            if rid is None:
                rid = self._pick_replica(
                    now, exclude=req.tried_replicas
                )
            if rid is None:
                stalled.append(req)
                break
            kind = "retry" if req.failed_attempts else "primary"
            if self._dispatch(req, rid, kind, now, newly_done) and affine:
                self.metrics.affinity_dispatches.inc()
        # Preserve order for everything not dispatched this pump.
        for req in reversed(stalled):
            self._queue.appendleft(req)

    def _dispatch(self, req: FleetRequest, rid: str, kind: str,
                  now: float, newly_done: List[FleetRequest]) -> bool:
        h = self._health[rid]
        is_probe = h.is_probe_dispatch()
        attempt = req.attempt_seq
        deadline_s = None
        if req.deadline is not None:
            deadline_s = max(0.001, req.deadline - now)
        aspan = None
        tracer = tracing.active_tracer()
        if tracer is not None and req.span is not None:
            aspan = tracer.start_span(
                "fleet.attempt", kind="client", parent=req.span,
                attrs={"replica": rid, "kind": kind,
                       "attempt": attempt},
            )
        # Work landing on a dedicated prefill replica is flagged
        # for post-prefill export — provided a decode-capable peer
        # exists to receive it (re-checked at export time; a vanished
        # peer just means the prefill replica decodes this one itself).
        migrate = self._role(rid) == "prefill" and any(
            r != rid and r not in self._draining
            and self._role(r) in ("decode", "mixed")
            and self._replicas[r].alive()
            for r in self._replicas
        )
        item = WorkItem(
            request_id=req.request_id,
            attempt=attempt,
            prompt=req.prompt,
            max_new_tokens=req.max_new_tokens,
            temperature=req.temperature,
            deadline_s=deadline_s,
            slo_class=req.slo_class,
            trace=aspan.carrier() if aspan is not None else None,
            migrate_after_prefill=migrate,
        )
        try:
            fault_point(
                "fleet.router.dispatch",
                replica=rid, request=req.request_id,
            )
            self._replicas[rid].submit(item)
        except Exception as e:  # noqa: BLE001 — ReplicaDeadError,
            # injected dispatch faults, broken pipes: all one path.
            if aspan is not None:
                aspan.set_attr("failure_reason", "dispatch_error")
                aspan.end(status="error")
            h.record_failure(f"dispatch:{type(e).__name__}")
            # The replica was tried and failed us — without this the
            # retry's least-loaded sort can deterministically pick the
            # SAME replica again (rank/load ties break on rid).
            req.tried_replicas.add(rid)
            if kind == "hedge":
                # The primary attempt is live and untouched: a hedge
                # that never dispatched cancels itself without charging
                # the request's retry budget.
                return False
            self._attempt_failed(
                req, "dispatch_error", now, newly_done
            )
            return False
        req.attempt_seq += 1
        req.tried_replicas.add(rid)
        if req.prefix_key is not None:
            # This replica now holds (or is prefilling) the prefix's
            # blocks: later same-prefix requests prefer it.
            self._affinity[req.prefix_key] = rid
            self._affinity.move_to_end(req.prefix_key)
            while len(self._affinity) > self.config.affinity_max_entries:
                self._affinity.popitem(last=False)
        if aspan is not None:
            req.attempt_spans[attempt] = aspan
        if req.first_dispatch_t is None:
            req.first_dispatch_t = now
            self.metrics.queue_wait.observe(now - req.submit_t)
        if is_probe:
            h.begin_probe()
        req.live_attempts[attempt] = (rid, now, is_probe)
        self._ledger[rid][(req.request_id, attempt)] = req
        self.metrics.dispatches.inc(kind=kind)
        return True

    # ---- hedging -----------------------------------------------------------

    def _hedge_threshold(self) -> Optional[float]:
        if self.config.hedge_after_s is not None:
            return self.config.hedge_after_s
        if len(self._service_lat) < self.config.hedge_min_samples:
            return None
        pct = float(np.percentile(
            np.asarray(self._service_lat), self.config.hedge_percentile
        ))
        return max(self.config.hedge_min_after_s, pct)

    def _hedge_sweep(self, now: float, newly_done: List[FleetRequest]):
        threshold = self._hedge_threshold()
        if threshold is None:
            return
        # Snapshot: dispatching mutates ledgers.
        inflight = {
            req.request_id: req
            for led in self._ledger.values()
            for req in led.values()
        }
        for req in inflight.values():
            if (
                req.done
                or req.hedged
                or len(req.live_attempts) != 1
                or req.max_new_tokens > self.config.hedge_max_new_tokens
            ):
                continue
            (rid, dispatch_t, _probe) = next(
                iter(req.live_attempts.values())
            )
            if now - dispatch_t <= threshold:
                continue
            other = self._pick_replica(
                now, exclude={rid}, strict_exclude=True
            )
            if other is None:
                continue
            if self._dispatch(req, other, "hedge", now, newly_done):
                req.hedged = True
                self.metrics.hedges.inc()
