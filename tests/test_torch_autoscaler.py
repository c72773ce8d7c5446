"""The port's closed-loop autoscaler (``dlrover_tpu_torch/autoscaler/``),
from the reference's ``tests/test_autoscaler.py``: the signal bus, the
rule policy, the loop, the actuators over the sim scaler, the router's
live sizing and the rescale coordinator's eviction, on injectable
clocks. The reference's two dashboard tests wait for the dashboard
(ROADMAP §A item 8), and its brain-service tests become one: the port's
``BrainPrior`` raises naming that item. The wall-clock
static-vs-autoscaled episode runs in the slow lane
(``test_autoscale_soak_episode``) and, through the soak's dispatch, in
``tests/test_torch_soak.py``.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import pytest

from dlrover_tpu_torch.autoscaler import (
    EVICT_STRAGGLER,
    GROW_FLEET,
    GROW_WORLD,
    SEED_WORLD,
    SET_CKPT_INTERVAL,
    SHRINK_FLEET,
    SHRINK_WORLD,
    AutoScaler,
    CadenceController,
    FaultHistory,
    FleetActuator,
    PolicyConfig,
    RulePolicy,
    SignalBus,
    SignalSnapshot,
    TrainWorldActuator,
)
from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.node import NodeGroupResource
from dlrover_tpu_torch.flash_ckpt.autotune import MtbfTracker
from dlrover_tpu_torch.master.scaler.base_scaler import ScalePlan
from dlrover_tpu_torch.master.scaler.sim_scaler import SimClusterScaler

pytestmark = pytest.mark.autoscale


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


class _fake:
    """The reference's mailbox double (``tests/test_fleet.py``): no
    ``send``, so a drain re-routes from zero at once instead of waiting
    out a migration; tests emit completions with ``complete``."""

    mode = "fake"

    def __init__(self, replica_id, clock):
        self.replica_id = str(replica_id)
        self._clock = clock
        self.inbox, self.outbox = [], []
        self.generation = 0
        self.is_alive = self.beating = True

    def start(self):
        self.is_alive = True

    def wait_ready(self, timeout=0.0):
        return True

    def alive(self):
        return self.is_alive

    def kill(self):
        self.is_alive = self.beating = False

    def stop(self):
        self.is_alive = False

    def restart(self):
        self.generation += 1
        self.inbox = []
        self.is_alive = self.beating = True

    def submit(self, item):
        from dlrover_tpu_torch.serving.fleet import ReplicaDeadError

        if not self.is_alive:
            raise ReplicaDeadError(f"fake {self.replica_id} dead")
        self.inbox.append(item)

    def poll(self):
        out, self.outbox = self.outbox, []
        return out

    def last_heartbeat(self):
        return self._clock() if self.beating else 0.0

    def take(self):
        assert self.inbox, f"replica {self.replica_id} has no work"
        return self.inbox.pop(0)

    def complete(self, item, tokens=(1, 2), ttft_s=0.001):
        self.outbox.append({
            "kind": "done", "request_id": item.request_id,
            "attempt": item.attempt, "ok": True,
            "tokens": list(tokens), "truncated": False,
            "failure_reason": "", "ttft_s": ttft_s,
            "generation": self.generation,
        })


def snap(ts, seq=1, **values) -> SignalSnapshot:
    return SignalSnapshot(seq=seq, ts=ts, values=values)


# ---------------------------------------------------------------------------
# SignalBus
# ---------------------------------------------------------------------------


def test_signal_bus_merges_sources_and_survives_a_broken_one():
    clock = FakeClock()
    bus = SignalBus(clock=clock)
    bus.add_source("a", lambda: {"x": 1, "y": 2})
    bus.add_source("b", lambda: {"x": 9})

    def broken():
        raise RuntimeError("sensor down")

    bus.add_source("c", broken)
    s = bus.sample()
    assert s.values["a.x"] == 1 and s.values["a.y"] == 2
    assert s.values["b.x"] == 9
    assert "RuntimeError" in s.values["c.error"]
    assert s.ts == clock.t
    assert bus.latest() is s
    assert bus.source_names() == ["a", "b", "c"]


def test_signal_bus_history_is_bounded_and_sequenced():
    bus = SignalBus(clock=FakeClock(), history=3)
    bus.add_source("a", lambda: {"x": 1})
    seqs = [bus.sample().seq for _ in range(5)]
    assert seqs == [1, 2, 3, 4, 5]
    assert [s.seq for s in bus.history()] == [3, 4, 5]


def test_fault_history_observed_mtbf():
    clock = FakeClock(0.0)
    h = FaultHistory(clock=clock)
    assert h.observed_mtbf_s() is None
    h.record_failure()
    assert h.observed_mtbf_s() is None  # one failure is an anecdote
    clock.advance(10.0)
    h.record_failure()
    clock.advance(20.0)
    h.record_failure()
    assert h.failures_total == 3
    assert h.observed_mtbf_s() == pytest.approx(15.0)
    clock.advance(5.0)
    assert h.last_failure_age_s() == pytest.approx(5.0)


def test_mtbf_tracker_windowing():
    t = MtbfTracker(window=3, min_failures=2)
    for ts in (0.0, 10.0, 20.0, 100.0):
        t.record_failure(ts)
    # Window keeps the newest 3 arrivals: gaps 10 and 80.
    assert t.observed_mtbf_s() == pytest.approx(45.0)
    assert t.failures_seen == 3


# ---------------------------------------------------------------------------
# RulePolicy: hysteresis, confirmation, cooldowns
# ---------------------------------------------------------------------------


def _flagged(ts, rank=3, score=2.4, **extra):
    return snap(
        ts,
        **{
            "perf.straggler_ranks": [rank],
            "perf.straggler_scores": {rank: score},
            "perf.median_step_s": 0.01,
            **extra,
        },
    )


def test_straggler_rule_needs_confirmation_then_cools_down():
    p = RulePolicy(PolicyConfig(
        straggler_confirm_ticks=2, evict_cooldown_s=10.0
    ))
    assert p.decide(_flagged(0.0)) == []          # 1st flag: not yet
    d = p.decide(_flagged(1.0))                   # 2nd consecutive: evict
    assert [x.action for x in d] == [EVICT_STRAGGLER]
    assert d[0].target == 3
    assert "score 2.40" in d[0].reason
    assert d[0].signals["perf.straggler_ranks"] == [3]
    # Still flagged but inside the cooldown: no second eviction.
    assert p.decide(_flagged(2.0)) == []
    # A clean snapshot resets the streak…
    assert p.decide(snap(12.0)) == []
    # …so one flag after the cooldown is not enough again.
    assert p.decide(_flagged(13.0)) == []
    d = p.decide(_flagged(14.0))
    assert [x.action for x in d] == [EVICT_STRAGGLER]


def test_straggler_score_knob_raises_the_bar():
    """config.straggler_score re-filters the monitor's flags: a rank
    the monitor flagged at 1.6 is NOT evicted under a 3.0 bar."""
    p = RulePolicy(PolicyConfig(
        straggler_score=3.0, straggler_confirm_ticks=2,
    ))
    mild = {
        "perf.straggler_ranks": [3],
        "perf.straggler_scores": {3: 1.6},
    }
    assert p.decide(snap(0.0, **mild)) == []
    assert p.decide(snap(1.0, **mild)) == []
    assert p.decide(snap(2.0, **mild)) == []
    severe = {
        "perf.straggler_ranks": [3],
        "perf.straggler_scores": {3: 3.4},
    }
    assert p.decide(snap(3.0, **severe)) == []   # streak restarts
    d = p.decide(snap(4.0, **severe))
    assert [x.action for x in d] == [EVICT_STRAGGLER]
    assert "score 3.40 >= 3.0" in d[0].reason


def test_ckpt_rule_retunes_from_observed_mtbf_with_dead_band():
    p = RulePolicy(PolicyConfig(
        ckpt_min_interval_s=0.05, ckpt_cooldown_s=0.0,
        ckpt_retune_frac=0.2,
    ))
    # No MTBF observed: no decision, whatever the cadence.
    assert p.decide(snap(0.0, **{"ckpt.interval_s": 60.0})) == []
    values = {
        "fault.mtbf_s": 100.0,
        "ckpt.interval_s": 60.0,
        "ckpt.save_block_s": 0.02,
    }
    d = p.decide(snap(1.0, **values))
    assert [x.action for x in d] == [SET_CKPT_INTERVAL]
    # Young/Daly: sqrt(2 * 0.02 * 100) = 2.0
    assert d[0].target == pytest.approx(2.0, rel=1e-3)
    assert "MTBF 100.00s" in d[0].reason
    # At (or near) the optimum the dead band holds: no flapping.
    values["ckpt.interval_s"] = 2.0
    assert p.decide(snap(2.0, **values)) == []
    values["ckpt.interval_s"] = 2.3   # within 20% of 2.0
    assert p.decide(snap(3.0, **values)) == []


def test_world_rule_backlog_bands_and_pinning():
    grown = {
        "world.size": 2, "data.todo": 1000,
        "perf.goodput": 0.9,
    }
    # Pinned world (max_world=0): never moves.
    assert RulePolicy(PolicyConfig(max_world=0)).decide(
        snap(0.0, **grown)
    ) == []
    p = RulePolicy(PolicyConfig(
        max_world=4, min_world=1, world_cooldown_s=30.0,
        backlog_grow_per_worker=256.0, backlog_shrink_per_worker=16.0,
    ))
    d = p.decide(snap(0.0, **grown))
    assert [(x.action, x.target) for x in d] == [(GROW_WORLD, 3)]
    # Cooldown covers the opposite direction too.
    assert p.decide(
        snap(1.0, **{"world.size": 3, "data.todo": 10})
    ) == []
    d = p.decide(snap(40.0, **{"world.size": 3, "data.todo": 10}))
    assert [(x.action, x.target) for x in d] == [(SHRINK_WORLD, 2)]
    # Inside the band: nothing.
    assert p.decide(
        snap(80.0, **{"world.size": 2, "data.todo": 100})
    ) == []


def test_world_rule_snaps_targets_to_legal_mesh_shapes():
    """With a legal-counts list, grow/shrink never target a world the
    rendezvous would refuse: 4 grows to 8 (not 5), shrinks to 2."""
    p = RulePolicy(PolicyConfig(
        max_world=8, min_world=1, legal_world_counts=[2, 4, 8],
        world_cooldown_s=10.0,
        backlog_grow_per_worker=256.0, backlog_shrink_per_worker=16.0,
    ))
    d = p.decide(snap(0.0, **{"world.size": 4, "data.todo": 4096}))
    assert [(x.action, x.target) for x in d] == [(GROW_WORLD, 8)]
    d = p.decide(snap(20.0, **{"world.size": 4, "data.todo": 10}))
    assert [(x.action, x.target) for x in d] == [(SHRINK_WORLD, 2)]
    # At the largest legal size there is no legal grow: no decision.
    assert p.decide(
        snap(40.0, **{"world.size": 8, "data.todo": 99999})
    ) == []
    # At the smallest legal size there is no legal shrink.
    assert p.decide(
        snap(60.0, **{"world.size": 2, "data.todo": 5})
    ) == []


def test_fleet_rule_hysteresis_band_and_bounds():
    p = RulePolicy(PolicyConfig(
        max_replicas=4, min_replicas=1,
        fleet_util_grow=0.85, fleet_util_shrink=0.30,
        fleet_confirm_ticks=2, fleet_cooldown_s=0.0,
    ))
    hot = {"fleet.replicas": 2, "fleet.slot_util": 1.0,
           "fleet.queue_depth": 40}
    assert p.decide(snap(0.0, **hot)) == []       # 1st hot tick
    d = p.decide(snap(1.0, **hot))                # confirmed
    assert [(x.action, x.target) for x in d] == [(GROW_FLEET, 3)]
    # A tick inside the band resets both streaks.
    mid = {"fleet.replicas": 3, "fleet.slot_util": 0.6}
    assert p.decide(snap(2.0, **mid)) == []
    cold = {"fleet.replicas": 3, "fleet.slot_util": 0.1}
    assert p.decide(snap(3.0, **cold)) == []
    d = p.decide(snap(4.0, **cold))
    assert [(x.action, x.target) for x in d] == [(SHRINK_FLEET, 2)]
    # Bounds: at min_replicas a cold fleet stays put.
    floor = {"fleet.replicas": 1, "fleet.slot_util": 0.0}
    p.decide(snap(5.0, **floor))
    assert p.decide(snap(6.0, **floor)) == []


# ---------------------------------------------------------------------------
# AutoScaler loop: ledger, dry-run parity, outcomes
# ---------------------------------------------------------------------------


def _policy():
    return RulePolicy(PolicyConfig(straggler_confirm_ticks=2))


def test_dry_run_produces_the_same_ledger_with_zero_actuations():
    """The acceptance contract: identical snapshots -> identical
    decision sequence; dry-run actuates nothing."""
    script = [
        {"straggler_ranks": [2], "straggler_scores": {2: 3.0}},
        {"straggler_ranks": [2], "straggler_scores": {2: 3.0}},
        {"straggler_ranks": []},
    ]
    # NB: the scripted source is named "perf" so the policy sees
    # "perf.straggler_ranks".
    acted = []
    live_bus = SignalBus(clock=FakeClock())
    feed_a = [dict(s) for s in script]
    live_bus.add_source("perf", lambda: feed_a.pop(0))
    live = AutoScaler(
        live_bus, policy=_policy(),
        actuators={EVICT_STRAGGLER: lambda d: acted.append(d.target)},
    )
    dry_bus = SignalBus(clock=FakeClock())
    feed_b = [dict(s) for s in script]
    dry_bus.add_source("perf", lambda: feed_b.pop(0))

    def must_not_run(decision):
        raise AssertionError("dry-run actuated")

    dry = AutoScaler(
        dry_bus, policy=_policy(),
        actuators={EVICT_STRAGGLER: must_not_run}, dry_run=True,
    )
    for _ in script:
        live.tick()
        dry.tick()
    live_led = [(d.action, d.target) for d in live.ledger.entries()]
    dry_led = [(d.action, d.target) for d in dry.ledger.entries()]
    assert live_led == dry_led == [(EVICT_STRAGGLER, 2)]
    assert acted == [2]
    assert live.ledger.actuations_total == 1
    assert dry.ledger.actuations_total == 0
    assert [d.outcome for d in live.ledger.entries()] == ["actuated"]
    assert [d.outcome for d in dry.ledger.entries()] == ["dry_run"]
    # Every decision carries its triggering snapshot.
    for d in live.ledger.entries() + dry.ledger.entries():
        assert d.signals["perf.straggler_ranks"] == [2]


def test_unbound_action_is_advisory_and_errors_are_recorded():
    clock = FakeClock()
    feed = [
        {"straggler_ranks": [1], "straggler_scores": {1: 9.0}},
        {"straggler_ranks": [1], "straggler_scores": {1: 9.0}},
        {"straggler_ranks": [1], "straggler_scores": {1: 9.0}},
        {"straggler_ranks": [1], "straggler_scores": {1: 9.0}},
    ]
    bus = SignalBus(clock=clock)
    bus.add_source("perf", lambda: feed.pop(0))
    a = AutoScaler(
        bus,
        policy=RulePolicy(PolicyConfig(
            straggler_confirm_ticks=1, evict_cooldown_s=5.0
        )),
        actuators={},  # nothing bound
    )
    a.tick()
    assert [d.outcome for d in a.ledger.entries()] == ["advisory"]

    def boom(decision):
        raise RuntimeError("backend down")

    a.bind(EVICT_STRAGGLER, boom)
    clock.advance(10.0)
    a.tick()
    outcomes = [d.outcome for d in a.ledger.entries()]
    assert outcomes[0] == "advisory"
    assert outcomes[1].startswith("error:RuntimeError")
    # The loop survived the failed actuation.
    clock.advance(10.0)
    a.tick()
    assert a.ledger.decisions_total == 3


def test_cadence_controller_apply_and_source():
    c = CadenceController(3.0, save_block_s=0.01)
    src = c.as_source()
    assert src() == {
        "interval_s": 3.0, "save_block_s": 0.01, "drain_s": 0.0
    }
    from dlrover_tpu_torch.autoscaler.policy import ScaleDecision

    c.apply(ScaleDecision(
        action=SET_CKPT_INTERVAL, target=0.25, reason="t"
    ))
    assert c.interval_s() == 0.25
    assert c.retunes == 1
    c.record_save_block(0.02)
    c.record_drain(0.005)
    assert src()["save_block_s"] == 0.02
    assert src()["drain_s"] == 0.005


# ---------------------------------------------------------------------------
# Actuators against real backends
# ---------------------------------------------------------------------------


def test_train_world_actuator_evicts_through_a_real_scale_plan():
    s = SimClusterScaler("t", capacity=8)
    plan = ScalePlan()
    plan.node_group_resources[NodeType.WORKER] = NodeGroupResource(3)
    s.scale(plan)
    act = TrainWorldActuator.for_sim(s)
    assert act.world_size() == 3
    victim = s.find_rank(1)
    from dlrover_tpu_torch.autoscaler.policy import ScaleDecision

    act.evict(ScaleDecision(
        action=EVICT_STRAGGLER, target=1, reason="t"
    ))
    assert act.world_size() == 3               # replaced, not shrunk
    assert s.find_rank(1).id != victim.id
    with pytest.raises(ValueError):
        act.evict(ScaleDecision(
            action=EVICT_STRAGGLER, target=99, reason="t"
        ))
    act.set_world(ScaleDecision(
        action=SHRINK_WORLD, target=2, reason="t"
    ))
    assert act.world_size() == 2


def test_rescale_coordinator_evict_worker_cuts_a_plan():
    from dlrover_tpu_torch.master.elastic_training.rescale_coordinator import (
        RescaleCoordinator,
    )

    clock = FakeClock()
    c = RescaleCoordinator(bootstrap_min=3, clock=clock)
    for rank in range(3):
        c.note_worker_joined(rank)
    boot = c.current_plan()
    assert boot is not None and boot.rank_order == [0, 1, 2]
    assert c.evict_worker(1, reason="straggler_evict")
    plan = c.current_plan()
    assert plan.plan_id == boot.plan_id + 1
    assert plan.rank_order == [0, 2]
    assert plan.reason == "straggler_evict"
    # Idempotent: an already-gone rank is not an error.
    assert not c.evict_worker(1)
    # The replacement re-joins through the normal scale-up path.
    c.note_worker_joined(3)
    assert c.current_plan().rank_order == [0, 2, 3]


# ---------------------------------------------------------------------------
# FleetRouter live sizing (add/drain) + FleetActuator
# ---------------------------------------------------------------------------


@pytest.mark.fleet
def test_fleet_router_add_and_drain_replicas():
    from dlrover_tpu_torch.observability.registry import MetricsRegistry
    from dlrover_tpu_torch.serving.fleet import FleetRouter, RouterConfig

    clock = FakeClock()
    r0, r1 = _fake("0", clock), _fake("1", clock)
    router = FleetRouter(
        [r0, r1], RouterConfig(max_retries=3),
        clock=clock, registry=MetricsRegistry(),
    )
    router.start(wait_ready=False)
    assert router.replica_ids() == ["0", "1"]
    r2 = _fake("2", clock)
    router.add_replica(r2)
    assert router.replica_ids() == ["0", "1", "2"]
    with pytest.raises(ValueError):
        router.add_replica(_fake("2", clock))
    # Work lands on the new replica set and completes.
    req = router.submit([1, 2, 3], 4)
    router.step()
    holder = next(
        rep for rep in (r0, r1, r2) if rep.inbox
    )
    # Drain the replica holding the in-flight attempt: the attempt is
    # reclaimed and re-routed, not lost.
    router.drain_replica(holder.replica_id)
    assert holder.replica_id not in router.replica_ids()
    assert not holder.is_alive
    clock.advance(0.01)
    router.step()
    new_holder = next(rep for rep in (r0, r1, r2)
                      if rep.inbox and rep is not holder)
    new_holder.complete(new_holder.take())
    clock.advance(0.01)
    router.step()
    assert req.result is not None and req.result.ok
    # A drain that terminal-fails a victim (retry budget exhausted)
    # surfaces that result from the NEXT step, preserving the
    # run_until_idle contract.
    req2 = router.submit([4, 5], 2)
    router.step()
    holder2 = next(rep for rep in (r0, r1, r2)
                   if rep.is_alive and rep.inbox)
    req2.failed_attempts = router.config.max_retries  # budget spent
    router.drain_replica(holder2.replica_id)
    assert req2.result is not None and not req2.result.ok
    got = router.step()
    assert req2 in got
    # Draining an unknown id is a no-op; draining down to zero refuses
    # (two drains above left exactly one replica standing).
    assert not router.drain_replica("nope")
    assert len(router.replica_ids()) == 1
    with pytest.raises(ValueError):
        router.drain_replica(router.replica_ids()[0])


@pytest.mark.fleet
def test_fleet_actuator_grow_and_shrink():
    from dlrover_tpu_torch.observability.registry import MetricsRegistry
    from dlrover_tpu_torch.serving.fleet import FleetRouter, RouterConfig

    clock = FakeClock()
    router = FleetRouter(
        [_fake("0", clock)], RouterConfig(),
        clock=clock, registry=MetricsRegistry(),
    )
    act = FleetActuator(
        router, replica_factory=lambda rid: _fake(rid, clock)
    )
    from dlrover_tpu_torch.autoscaler.policy import ScaleDecision

    act.grow(ScaleDecision(action=GROW_FLEET, target=2, reason="t"))
    assert router.replica_ids() == ["0", "as0"]
    act.grow(ScaleDecision(action=GROW_FLEET, target=3, reason="t"))
    assert router.replica_ids() == ["0", "as0", "as1"]
    act.shrink(ScaleDecision(action=SHRINK_FLEET, target=2, reason="t"))
    assert router.replica_ids() == ["0", "as0"]
    # LIFO over the actuator's OWN additions: the original replica
    # ("0") is never the drain victim while an added one remains —
    # even when it sorts lexicographically last.
    act.shrink(ScaleDecision(action=SHRINK_FLEET, target=1, reason="t"))
    assert router.replica_ids() == ["0"]


@pytest.mark.fleet
def test_router_survives_concurrent_sizing_from_another_thread():
    """The §30 actuation contract: an autoscaler thread may add/drain
    replicas while the pump thread steps — the router lock keeps the
    iteration structures consistent (no dict-changed-size crashes)."""
    import threading

    from dlrover_tpu_torch.observability.registry import MetricsRegistry
    from dlrover_tpu_torch.serving.fleet import FleetRouter, RouterConfig

    clock = FakeClock()
    router = FleetRouter(
        [_fake("a", clock), _fake("b", clock)],
        RouterConfig(), clock=clock, registry=MetricsRegistry(),
    )
    router.start(wait_ready=False)
    errors = []
    stop = threading.Event()

    def pump():
        try:
            while not stop.is_set():
                router.step()
        except Exception as e:  # noqa: BLE001 — the failure under test
            errors.append(e)

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    act = FleetActuator(
        router, replica_factory=lambda rid: _fake(rid, clock)
    )
    from dlrover_tpu_torch.autoscaler.policy import ScaleDecision

    for _ in range(50):
        act.grow(ScaleDecision(action=GROW_FLEET, target=3, reason="t"))
        act.shrink(ScaleDecision(
            action=SHRINK_FLEET, target=2, reason="t"
        ))
    stop.set()
    t.join(timeout=5.0)
    assert not errors, errors
    assert router.replica_ids() == ["a", "b"]


# ---------------------------------------------------------------------------
# Brain prior: refused until the brain service is ported
# ---------------------------------------------------------------------------


def test_brain_prior_post_raises_naming_its_roadmap_item():
    """The brain service's client is not ported: the prior refuses
    rather than reading as an unreachable brain (the reference degrades
    an unreachable one to no seed)."""
    from dlrover_tpu_torch.autoscaler import BrainPrior

    prior = BrainPrior("localhost:1", "nope", timeout_s=0.2)
    for call in (lambda: prior._post("/optimize", {}),
                 prior.initial_world,
                 lambda: prior.report_outcome(0.5, 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP §A item 8"):
            call()
    bus = SignalBus(clock=FakeClock())
    bus.add_source("world", lambda: {"size": 4})
    with pytest.raises(NotImplementedError, match="item 8"):
        AutoScaler(bus, brain_prior=prior).tick()


def test_brain_seed_snaps_to_legal_world_counts():
    """The prior's suggestion obeys the same mesh legality as every
    other world move: 3 snaps down to legal 2; a suggestion below the
    smallest legal shape is dropped."""

    class FakePrior:
        def __init__(self, count):
            self.count = count

        def initial_world(self):
            return {"worker_count": self.count, "optimizer": "fake",
                    "evidence_samples": 1}

        def report_outcome(self, **kw):
            pass

    def scaler_with(count):
        sets = []
        bus = SignalBus(clock=FakeClock())
        bus.add_source("world", lambda: {"size": 4})
        a = AutoScaler(
            bus,
            policy=RulePolicy(PolicyConfig(
                max_world=8, min_world=2,
                legal_world_counts=[2, 4, 8],
            )),
            actuators={SEED_WORLD: lambda d: sets.append(d.target)},
            brain_prior=FakePrior(count),
        )
        a.tick()
        return sets

    assert scaler_with(3) == [2]      # snapped down to legal
    assert scaler_with(8) == [8]      # already legal
    assert scaler_with(1) == []       # below every legal shape: no seed
    assert scaler_with(4) == []       # equals current world: no seed


# ---------------------------------------------------------------------------
# The autoscale soak episode
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_autoscale_episode_plan_is_deterministic():
    from dlrover_tpu_torch.testing.autoscale_soak import build_autoscale_plan
    from dlrover_tpu_torch.testing.soak import EPISODE_KINDS

    assert EPISODE_KINDS[5] == "straggler_evict"
    a = build_autoscale_plan(0, 5)
    b = build_autoscale_plan(0, 5)
    assert a.straggler_rank == b.straggler_rank
    assert a.straggler_onset_step == b.straggler_onset_step
    assert a.crash_steps == b.crash_steps
    assert [r.to_dict() for r in a.schedule.rules] == [
        r.to_dict() for r in b.schedule.rules
    ]
    # The satellite fault: a persistent per-node delay at the step
    # fault point.
    delay = [r for r in a.schedule.rules if r.action == "delay"]
    assert len(delay) == 1
    assert delay[0].point == "agent.worker.crash"
    assert delay[0].every == 1
    # Plus seeded worker deaths for the observed-MTBF cadence rule.
    assert sum(1 for r in a.schedule.rules if r.action == "raise") == 3


@pytest.mark.slow
@pytest.mark.soak
@pytest.mark.chaos
@pytest.mark.whatif
def test_autoscale_soak_episode(tmp_path):
    """The §30 acceptance run: static vs dry-run vs autoscaled under
    one seeded fault+traffic schedule, plus the §34 leg (record →
    replay identity → perturbed counterfactual, outcome coverage,
    ≥90% cause attribution). The harness itself asserts the
    invariants; this test pins the report shape the bench keeps."""
    from dlrover_tpu_torch.testing.autoscale_soak import (
        AutoscaleSoakConfig,
        run_autoscale_episode,
    )

    cfg = AutoscaleSoakConfig(steps=160, watchdog_s=90.0)
    rep = run_autoscale_episode(0, cfg=cfg, record_dir=str(tmp_path))
    assert rep["invariants"] == "pass"
    assert rep["autoscale_goodput_frac"] > rep["static_goodput_frac"]
    assert rep["autoscale_time_to_mitigate_s"] is not None
    assert rep["autoscale_mitigate_windows"] <= cfg.mitigate_window_bound
    assert rep["autoscale_decisions_total"] >= 3
    assert rep["dry_run_actuations_total"] == 0
    assert rep["autoscale_ckpt_retunes"] >= 1
    assert rep["autoscale_fleet_grow_events"] >= 1
    assert rep["deaths"] == 3
    # §34: replay identity held, the perturbed policy decided
    # differently and both counterfactuals were scored; every actuated
    # decision carries a realized outcome; ≥90% of non-train wall time
    # is attributed to an explicit cause.
    assert rep["whatif_identity_ok"] is True
    assert rep["whatif_recorded_decisions"] >= 3
    assert (rep["whatif_perturbed_decisions"]
            != rep["whatif_recorded_decisions"])
    assert 0.0 <= rep["whatif_recorded_est_goodput"] <= 1.0
    assert rep["whatif_replay_snapshots_per_s"] > 0
    assert rep["autoscale_outcomes_attached"] >= (
        rep["autoscale_actuations_total"]
    )
    assert rep["autoscale_outcome_misses"] == 0
    assert rep["goodput_attributed_frac"] >= 0.9


def test_lockstep_bookkeeping_under_load_stays_attributed(monkeypatch):
    """Episode 5's autoscaled run with every lease fetch and done report
    stretched by 1 ms (a loaded host): the lockstep loop's bookkeeping
    is the healthy step's own time, so the attribution keeps its 90%.
    With the step reported as its compute sleep alone, the stretch fell
    into the unattributed residual (0.880 on a loaded card host)."""
    import time

    from dlrover_tpu_torch.master.shard.task_manager import TaskManager
    from dlrover_tpu_torch.testing.autoscale_soak import run_sim_job

    for name in ("get_task", "report_task_done"):
        orig = getattr(TaskManager, name)

        def slow(self, *args, _orig=orig, **kwargs):
            time.sleep(0.001)
            return _orig(self, *args, **kwargs)

        monkeypatch.setattr(TaskManager, name, slow)
    rep = run_sim_job("auto", seed=0, episode=5)
    att = rep["goodput_attribution"]
    assert rep["deaths"] == 3
    assert att["attributed_frac"] >= 0.9, att["causes"]
