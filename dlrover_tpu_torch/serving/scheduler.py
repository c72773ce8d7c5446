"""Request state machine + iteration-level scheduler for the engine
(the port's own copy of ``dlrover_tpu/serving/scheduler.py``, with the
paged pool's hooks — the admission gate and pool-pressure preemption —
and the speculative-decoding fields; without the migration fields,
which arrive with that engine).

Orca-style continuous batching, host side: requests move QUEUED →
PREFILL → DECODE → DONE; a slot is the unit of admission (one request
owns one row of the engine's [slots, max_len] KV pool) and is recycled
the moment its request finishes. Stale KV left in a recycled slot is
harmless: rows >= the fill length are never read, and every row is
rewritten before the fill passes it.

Per-iteration token budget: one tick runs at most one prefill CHUNK
(``prefill_chunk`` prompt tokens) beside the decode step's
``decode_tokens_per_slot`` tokens per active slot (1, or 1 + spec_k
under speculative decoding: every drafted token is verified through the
model whether or not it is accepted), and the chunk only runs when
``decoding * decode_tokens_per_slot + prefill_chunk <= token_budget``
(or nothing is decoding). The default budget (prefill_chunk + slots *
decode_tokens_per_slot) never blocks a chunk.

SLO classes: free slots are granted by weighted-fair deficit
round-robin over the classes with queued work, FCFS within a class (one
class is exact FCFS, the default). A request whose deadline lapsed
while it waited is shed, at the engine's sweep or at admission.

Pure host bookkeeping: no torch, unit-testable on its own.
"""

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

# Request lifecycle states.
QUEUED = "queued"
PREFILL = "prefill"
DECODE = "decode"
DONE = "done"


@dataclass(frozen=True)
class SloClass:
    """One named service class. ``weight`` is the admission share under
    weighted-fair deficit round-robin (interactive traffic typically
    outweighs batch); ``default_deadline_s`` applies when a submission
    names no deadline of its own (None = no TTL)."""

    name: str
    weight: float = 1.0
    default_deadline_s: Optional[float] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("SloClass needs a name")
        if self.weight <= 0:
            raise ValueError(
                f"SloClass {self.name!r} weight must be > 0"
            )


@dataclass
class Request:
    """One generation request and its accumulated result."""

    rid: int
    prompt: np.ndarray                 # [prompt_len] int32
    max_new_tokens: int
    temperature: float = 0.0
    state: str = QUEUED
    slot: int = -1
    prefill_pos: int = 0               # prompt rows already in the cache
    tokens: List[int] = field(default_factory=list)
    truncated: bool = False            # hit max_len before max_new_tokens
    failed: bool = False               # explicitly failed (requeue budget)
    # Machine-readable terminal failure reason ("" while not failed):
    # "requeue_budget" (step-error restarts exhausted), "deadline"
    # (shed from the queue past its TTL), or a caller-supplied reason.
    failure_reason: str = ""
    requeues: int = 0                  # step-error restarts of this request
    preemptions: int = 0               # pool-pressure evictions
    submit_ts: float = 0.0
    # Absolute deadline on the submit clock; a QUEUED request past it is
    # shed (never admitted to prefill) — a dead client's request must
    # not occupy a slot. None = no TTL.
    deadline: Optional[float] = None
    first_token_ts: Optional[float] = None
    finish_ts: Optional[float] = None
    admit_ts: Optional[float] = None   # slot-admission time (monotonic)
    # Named SLO class this request was admitted under; "default" on
    # single-class schedulers.
    slo_class: str = "default"
    # Paged engines (serving/kvpool): warm prefix-cache blocks this
    # request's block table started from — 0 on a miss or a flat engine.
    prefix_hit_blocks: int = 0
    # Speculative decoding (serving/spec_decode): drafted / accepted
    # token counts and the wall time attributed to the draft and verify
    # phases (the engine splits each iteration's cost evenly across its
    # decoding slots).
    spec_drafted: int = 0
    spec_accepted: int = 0
    draft_s: float = 0.0
    verify_s: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.submit_ts


class Scheduler:
    """Slot bookkeeping + admission policy (see module docstring)."""

    def __init__(
        self,
        slots: int,
        max_len: int,
        prefill_chunk: int,
        token_budget: Optional[int] = None,
        drain_mode: bool = False,
        slo_classes: Optional[Sequence[SloClass]] = None,
        decode_tokens_per_slot: int = 1,
    ):
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if decode_tokens_per_slot < 1:
            raise ValueError("decode_tokens_per_slot must be >= 1")
        self.slots = slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        # Worst-case tokens one decoding slot runs per iteration: 1 for
        # plain decode, 1 + spec_k under speculative decoding.
        self.decode_tokens_per_slot = decode_tokens_per_slot
        self.token_budget = (
            token_budget if token_budget is not None
            else prefill_chunk + slots * decode_tokens_per_slot
        )
        # drain_mode is the naive static baseline: admit a full batch, run it to completion, only then
        # refill — no slot is recycled while any peer still decodes.
        self.drain_mode = drain_mode
        classes = tuple(slo_classes) if slo_classes else (
            SloClass("default"),
        )
        self.slo_classes: Dict[str, SloClass] = {}
        for cls in classes:
            if cls.name in self.slo_classes:
                raise ValueError(f"duplicate SLO class {cls.name!r}")
            self.slo_classes[cls.name] = cls
        self._default_class = classes[0].name
        # Deficit round-robin credits; replenished by weight whenever
        # every class with queued work is out of credit.
        self._credits: Dict[str, float] = {
            name: 0.0 for name in self.slo_classes
        }
        self.queue: Deque[Request] = deque()
        # Requests shed at admission time (deadline lapsed while
        # waiting for a slot); the engine drains and reports them with
        # the same metrics as pump-time sheds.
        self._admission_shed: List[Request] = []
        # Optional engine veto on the next admission (the paged
        # engine's block watermark: admitting a request the pool
        # cannot hold would only thrash preemptions). Returning False
        # stops THIS admission round; the request keeps its place.
        self.admission_gate = None
        self.by_slot: List[Optional[Request]] = [None] * slots
        self._free: Deque[int] = deque(range(slots))
        self._rid = itertools.count()

    # ---- submission / admission -------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        temperature: float = 0.0,
        now: Optional[float] = None,
        deadline_s: Optional[float] = None,
        slo_class: Optional[str] = None,
    ) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.shape[0] >= self.max_len:
            raise ValueError(
                f"prompt_len {prompt.shape[0]} leaves no decode room in "
                f"max_len {self.max_len}"
            )
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        cls_name = slo_class if slo_class is not None else (
            self._default_class
        )
        cls = self.slo_classes.get(cls_name)
        if cls is None:
            raise ValueError(
                f"unknown SLO class {cls_name!r}; configured: "
                f"{sorted(self.slo_classes)}"
            )
        if deadline_s is None:
            deadline_s = cls.default_deadline_s
        submit_ts = now if now is not None else time.monotonic()
        req = Request(
            rid=next(self._rid),
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            temperature=float(temperature),
            submit_ts=submit_ts,
            deadline=(
                submit_ts + deadline_s if deadline_s is not None else None
            ),
            slo_class=cls_name,
        )
        self.queue.append(req)
        return req

    def queue_depth_by_class(self) -> Dict[str, int]:
        depths = {name: 0 for name in self.slo_classes}
        for req in self.queue:
            depths[req.slo_class] = depths.get(req.slo_class, 0) + 1
        return depths

    def shed_expired(self, now: Optional[float] = None) -> List[Request]:
        """Drop QUEUED requests past their deadline — they are never
        admitted to prefill, so a dead client's request cannot occupy a
        slot. In-slot requests are untouched: their KV investment is
        sunk and they finish on their own. Shed requests land in DONE
        with ``failed=True`` / ``failure_reason="deadline"`` so callers
        see an explicit terminal outcome, never silence."""
        if now is None:
            now = time.monotonic()
        shed: List[Request] = []
        kept: Deque[Request] = deque()
        for req in self.queue:
            if req.deadline is not None and now > req.deadline:
                req.state = DONE
                req.failed = True
                req.failure_reason = "deadline"
                req.finish_ts = now
                shed.append(req)
            else:
                kept.append(req)
        if shed:
            self.queue = kept
        return shed

    def admit(self, now: Optional[float] = None) -> List[Request]:
        """Bind queued requests to free slots — weighted-fair deficit
        round-robin across SLO classes, FCFS within a class (one class
        = exact FCFS). A request whose deadline lapsed while it waited
        is shed HERE, the moment it would have won a slot, and surfaces
        through :meth:`drain_admission_shed`. Under drain_mode, admits
        only when EVERY slot is free — the drain-and-refill baseline."""
        if self.drain_mode and len(self._free) < self.slots:
            return []
        if now is None:
            now = time.monotonic()
        admitted = []
        while self.queue and self._free:
            req = self._next_admission(now)
            if req is None:
                break
            req.slot = self._free.popleft()
            req.state = PREFILL
            req.admit_ts = now
            self.by_slot[req.slot] = req
            admitted.append(req)
        return admitted

    def _next_admission(self, now: float) -> Optional[Request]:
        """The weighted-fair winner among per-class queue heads;
        expired candidates are shed on the way (admission-time TTL).
        DRR credit is charged only for an admission that actually
        happens: sheds and admission-gate vetoes are free, so pool
        pressure cannot invert the configured class weights. The
        single-class path is O(1) (queue head); the multi-class head
        scan stops once every class has a head, and ``deque.remove``
        of a head is near-front."""
        while True:
            if not self.queue:
                return None
            charge = False
            if len(self.slo_classes) == 1:
                req = self.queue[0]
                if (
                    not self._expired(req, now)
                    and self._gate_vetoes(req)
                ):
                    return None
                self.queue.popleft()
            else:
                heads: Dict[str, Request] = {}
                for queued in self.queue:
                    if queued.slo_class not in heads:
                        heads[queued.slo_class] = queued
                        if len(heads) == len(self.slo_classes):
                            break
                if len(heads) == 1:
                    name = next(iter(heads))
                    charge = False
                else:
                    cands = {n: self._credits[n] for n in heads}
                    if max(cands.values()) <= 0:
                        # Replenish the classes with queued work; idle
                        # classes reset — credit hoarded while idle
                        # would let a burst starve everyone else later.
                        for n, cls in self.slo_classes.items():
                            self._credits[n] = (
                                self._credits[n] + cls.weight
                                if n in heads else 0.0
                            )
                        cands = {n: self._credits[n] for n in heads}
                    # Deterministic tie-break: declaration order.
                    name = max(
                        heads,
                        key=lambda n: (
                            cands[n],
                            -list(self.slo_classes).index(n),
                        ),
                    )
                    charge = True
                req = heads[name]
                if (
                    not self._expired(req, now)
                    and self._gate_vetoes(req)
                ):
                    # Veto before any charge or removal: the request
                    # keeps its place AND its class keeps its credit.
                    return None
                if charge:
                    self._credits[name] -= 1.0
                self.queue.remove(req)
            if self._expired(req, now):
                # Lapsed while waiting for a slot: shed instead of
                # burning prefill on a dead client (single-head paths
                # charged nothing; a charged multi-class credit is
                # refunded — sheds must not tilt the DRR ratio).
                if charge:
                    self._credits[req.slo_class] += 1.0
                req.state = DONE
                req.failed = True
                req.failure_reason = "deadline"
                req.finish_ts = now
                self._admission_shed.append(req)
                continue
            return req

    def _expired(self, req: Request, now: float) -> bool:
        return req.deadline is not None and now > req.deadline

    def _gate_vetoes(self, req: Request) -> bool:
        return (
            self.admission_gate is not None
            and not self.admission_gate(req)
        )

    def drain_admission_shed(self) -> List[Request]:
        """Requests shed by :meth:`admit`'s deadline check; the engine
        reports them exactly like pump-time sheds."""
        out, self._admission_shed = self._admission_shed, []
        return out

    # ---- per-iteration work selection -------------------------------------

    def decoding(self) -> List[Request]:
        return [r for r in self.by_slot if r is not None and r.state == DECODE]

    def active(self) -> List[Request]:
        return [r for r in self.by_slot if r is not None]

    def pick_prefill(self) -> Optional[Request]:
        """The prefill chunk to run this iteration, or None. FCFS among
        PREFILL slots (lowest rid = longest waiting); gated by the
        token budget so a prompt burst cannot starve decode."""
        cands = [
            r for r in self.by_slot
            if r is not None and r.state == PREFILL
        ]
        if not cands:
            return None
        n_decoding = len(self.decoding()) * self.decode_tokens_per_slot
        if n_decoding and n_decoding + self.prefill_chunk > self.token_budget:
            return None
        return min(cands, key=lambda r: r.rid)

    # ---- completion --------------------------------------------------------

    def finish(self, req: Request, now: Optional[float] = None) -> None:
        """DONE + recycle the slot. The stale KV stays in place: rows
        >= the next occupant's fill are invisible and every row is
        overwritten before its fill cursor passes it."""
        req.state = DONE
        req.finish_ts = now if now is not None else time.monotonic()
        if req.slot >= 0:
            self.by_slot[req.slot] = None
            self._free.append(req.slot)
            req.slot = -1

    def evict(self, req: Request, now: Optional[float] = None) -> None:
        """Drop a live request (cancellation). Identical bookkeeping to
        finish(); split so callers/metrics can tell outcomes apart."""
        self.finish(req, now)

    def preempt(self, req: Request) -> None:
        """Pool-pressure preemption (paged engine): return ONE in-slot
        request to the FRONT of the queue with its progress reset,
        freeing its slot (and, at the engine, its blocks) for an older
        request. Unlike a step-error requeue this does NOT count
        against the request's requeue budget — being the youngest when
        the pool runs dry is scheduling, not failure."""
        if req.slot >= 0:
            self.by_slot[req.slot] = None
            self._free.append(req.slot)
            req.slot = -1
        req.state = QUEUED
        req.prefill_pos = 0
        req.tokens = []
        req.truncated = False
        req.first_token_ts = None
        req.admit_ts = None
        req.prefix_hit_blocks = 0
        self._reset_spec_progress(req)
        req.preemptions += 1
        self.queue.appendleft(req)

    @staticmethod
    def _reset_spec_progress(req: Request) -> None:
        """Progress resets (preemption, step-error requeue) restart a
        request from scratch; its speculative accounting restarts with
        it, or replayed drafts would count twice."""
        req.spec_drafted = 0
        req.spec_accepted = 0
        req.draft_s = 0.0
        req.verify_s = 0.0

    # ---- failure recovery --------------------------------------------------

    def requeue_active(self) -> List[Request]:
        """Return every in-slot request to the FRONT of the queue with
        its progress reset — the engine calls this when a step raises
        and the KV pool can no longer be trusted (donated buffers may be
        left half-written by the failed call). Requests restart from scratch:
        their sampled tokens depended on cache state that is gone.
        Queue order preserves rid order (oldest first) so recovery does
        not reorder service. Returns the re-queued requests."""
        victims = sorted(self.active(), key=lambda r: r.rid)
        for req in reversed(victims):
            if req.slot >= 0:
                self.by_slot[req.slot] = None
                self._free.append(req.slot)
                req.slot = -1
            req.state = QUEUED
            req.prefill_pos = 0
            req.tokens = []
            req.truncated = False
            req.first_token_ts = None
            req.admit_ts = None
            req.prefix_hit_blocks = 0
            self._reset_spec_progress(req)
            req.requeues += 1
            self.queue.appendleft(req)
        return victims
