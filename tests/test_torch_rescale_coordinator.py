"""The port's rescale coordinator against the JAX package's.

A seeded script of membership events (joins with node groups, losses,
evictions, checkpoint-step reports, acks, clock advances past the
barrier timeout) drives the reference's ``RescaleCoordinator`` and the
port's side by side on one fake clock: after every event every plan
field, every ``get_plan`` and every ``barrier_state`` answer must be
equal, with and without a batch config's legality and with slice
blocks. Then the reference's own tests (``tests/test_rescale_coordinator
.py``: plan versioning, legality wiring to the trainer's batch config,
bounded barrier expiry with self-healing re-plans, and the servicer
round trip including the plan-broadcast fault point) run on the port's
coordinator, servicer and local master."""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import numpy as np
import pytest

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.comm import Message
from dlrover_tpu_torch.fault import FaultRule, FaultSchedule, arm, disarm
from dlrover_tpu_torch.master.elastic_training.rescale_coordinator import (
    RescaleCoordinator,
)
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.trainer.elastic.trainer import ElasticBatchConfig
from tests.torch_event_guard import events_off


@pytest.fixture(autouse=True)
def _no_event_files(monkeypatch):
    events_off(monkeypatch)


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.mark.rescale
class TestCoordinator:
    def test_bootstrap_plan_waits_for_min_workers(self):
        c = RescaleCoordinator(bootstrap_min=2)
        c.note_worker_joined(0)
        assert c.current_plan() is None
        c.note_worker_joined(1)
        plan = c.current_plan()
        assert plan is not None
        assert plan.plan_id == 1
        assert plan.rank_order == [0, 1]
        assert plan.reason == "bootstrap"
        assert plan.restore_step == -1

    def test_node_loss_cuts_versioned_scale_down_plan(self):
        c = RescaleCoordinator(bootstrap_min=2)
        c.note_worker_joined(0)
        c.note_worker_joined(1)
        c.note_ckpt_step(4, committed=True)
        c.note_ckpt_step(6, committed=True)
        c.note_ckpt_step(5, committed=True)  # stale report: ignored
        c.note_worker_lost(1)
        plan = c.current_plan()
        assert plan.plan_id == 2
        assert plan.rank_order == [0]
        assert plan.reason == "node_lost"
        assert plan.restore_step == 6
        # idempotent: the same loss reported again cuts no new plan
        c.note_worker_lost(1)
        assert c.current_plan().plan_id == 2

    def test_replacement_join_below_bootstrap_min_still_scales_up(self):
        """The bootstrap gate only defers the FIRST plan: a replacement
        worker joining a half-dead world (live < original node count)
        must trigger a scale-up plan, not be silently evicted."""
        c = RescaleCoordinator(bootstrap_min=4)
        for r in range(4):
            c.note_worker_joined(r)
        c.note_worker_lost(2)
        c.note_worker_lost(3)
        assert c.current_plan().rank_order == [0, 1]
        c.note_worker_joined(4)  # live = 3 < bootstrap_min = 4
        plan = c.current_plan()
        assert plan.reason == "scale_up_join"
        assert plan.rank_order == [0, 1, 4]

    def test_join_mid_run_cuts_scale_up_plan(self):
        c = RescaleCoordinator(bootstrap_min=1)
        c.note_worker_joined(0)
        assert c.current_plan().plan_id == 1
        c.note_worker_joined(3)
        plan = c.current_plan()
        assert plan.plan_id == 2
        assert plan.reason == "scale_up_join"
        assert plan.rank_order == [0, 3]

    def test_legal_counts_from_batch_config(self):
        """3-of-4 survivors with global_batch=8, micro=1 must form a
        world of 2 — not a world of 3 whose grad_accum_for raises."""
        bc = ElasticBatchConfig(global_batch_size=8,
                                micro_batch_per_device=1)
        assert bc.legal_dp_sizes(8) == [1, 2, 4, 8]
        c = RescaleCoordinator(
            legal_counts_fn=bc.legal_node_counts_fn(), bootstrap_min=4
        )
        for r in range(4):
            c.note_worker_joined(r)
        assert len(c.current_plan().world) == 4
        c.note_worker_lost(3)
        plan = c.current_plan()
        assert plan.rank_order == [0, 1]  # 3 would crash grad_accum_for
        for rank in plan.rank_order:
            bc.grad_accum_for(len(plan.world))  # must not raise

    def test_get_plan_versioning(self):
        c = RescaleCoordinator(bootstrap_min=1)
        c.note_worker_joined(0)
        plan = c.get_plan(0, current_plan_id=-1)
        assert plan.plan_id == 1
        assert c.get_plan(0, current_plan_id=1) is None
        c.note_worker_joined(1)
        assert c.get_plan(0, current_plan_id=1).plan_id == 2

    def test_barrier_acks_and_completion(self):
        clk = FakeClock()
        c = RescaleCoordinator(bootstrap_min=2, clock=clk)
        c.note_worker_joined(0)
        c.note_worker_joined(1)
        pid = c.current_plan().plan_id
        ready, expired, superseded, missing = c.barrier_state(
            pid, "barrier"
        )
        assert (ready, expired, superseded) == (False, False, False)
        assert missing == [0, 1]
        assert c.ack(pid, 0, "barrier")
        assert c.ack(pid, 0, "barrier")  # idempotent re-ack
        assert c.ack(pid, 1, "barrier")
        ready, *_ = c.barrier_state(pid, "barrier")
        assert ready
        # stale-plan and unknown-phase acks are refused
        assert not c.ack(pid - 1, 0, "barrier")
        assert not c.ack(pid, 0, "no-such-phase")

    def test_barrier_expiry_replans_around_dead_rank(self):
        clk = FakeClock()
        c = RescaleCoordinator(
            bootstrap_min=2, barrier_timeout_s=5.0, clock=clk
        )
        c.note_worker_joined(0)
        c.note_worker_joined(1)
        pid = c.current_plan().plan_id
        c.ack(pid, 0, "barrier")
        clk.t += 10.0  # rank 1 died mid-barrier; bounded wait runs out
        ready, expired, superseded, missing = c.barrier_state(
            pid, "barrier"
        )
        assert expired and not ready
        assert missing == [1]
        new_plan = c.current_plan()
        assert new_plan.plan_id == pid + 1
        assert new_plan.reason == "barrier_expired"
        assert new_plan.rank_order == [0]
        # the old plan's waiters now see superseded and pivot
        _, _, superseded, _ = c.barrier_state(pid, "barrier")
        assert superseded

    def test_barrier_budget_restarts_per_phase(self):
        """A restore longer than one barrier budget must not eat the
        'restored' barrier's allowance: each phase's bounded wait is
        anchored at the previous phase's completion, not plan
        creation."""
        clk = FakeClock()
        c = RescaleCoordinator(
            bootstrap_min=2, barrier_timeout_s=5.0, clock=clk
        )
        c.note_worker_joined(0)
        c.note_worker_joined(1)
        pid = c.current_plan().plan_id
        clk.t += 4.0  # barrier phase completes just inside its budget
        c.ack(pid, 0, "barrier")
        c.ack(pid, 1, "barrier")
        clk.t += 4.0  # slow restore: 8s past plan creation now
        c.ack(pid, 0, "restored")
        ready, expired, superseded, missing = c.barrier_state(
            pid, "restored"
        )
        assert not expired and not superseded
        assert missing == [1]  # rank 1 still restoring, NOT evicted
        clk.t += 2.0  # ...but the per-phase budget still bounds it
        _, expired, _, _ = c.barrier_state(pid, "restored")
        assert expired
        assert c.current_plan().rank_order == [0]

    def test_plan_eviction_removes_rank_from_live_set(self):
        """A rank evicted by an illegal world size exits cleanly and
        never reports failure — the coordinator must drop it from the
        live set itself, or later plans would stall a barrier timeout
        waiting on a dead rank."""
        bc = ElasticBatchConfig(global_batch_size=4,
                                micro_batch_per_device=1)
        c = RescaleCoordinator(
            legal_counts_fn=bc.legal_node_counts_fn(), bootstrap_min=3
        )
        for r in range(3):
            c.note_worker_joined(r)
        plan = c.current_plan()
        assert plan.rank_order == [0, 1]  # dp=3 illegal, rank 2 evicted
        c.note_worker_lost(1)
        assert c.current_plan().rank_order == [0]  # 2 must not reappear

    def test_rejoin_after_completed_plan_cuts_fresh_plan(self):
        """A crashed worker restarted in place (no node-loss report ever
        routed) rejoins while its rank is still in the CURRENT plan's
        fully-acked world. Handing it the finished plan back would let
        it roll back alone — and, if designated, rewind the live shard
        cursor — while peers run ahead; the coordinator must cut a fresh
        plan that rolls the whole world back together."""
        c = RescaleCoordinator(bootstrap_min=2)
        c.note_worker_joined(0)
        c.note_worker_joined(1)
        pid = c.current_plan().plan_id
        for phase in ("barrier", "restored", "resumed"):
            c.ack(pid, 0, phase)
            c.ack(pid, 1, phase)
        c.note_worker_joined(1)  # new incarnation, same rank
        plan = c.current_plan()
        assert plan.plan_id == pid + 1
        assert plan.reason == "rejoin"
        assert plan.rank_order == [0, 1]
        # mid-plan re-join of a rank that has only acked 'barrier' is a
        # safe re-adoption (the 'restored' barrier cannot complete
        # without its new incarnation): idempotent announce, no plan
        c.ack(plan.plan_id, 0, "barrier")
        c.note_worker_joined(0)
        assert c.current_plan().plan_id == plan.plan_id
        # ...but once it acked 'restored', peers may have passed that
        # barrier and trained ahead — a rejoin must cut a fresh plan
        pid2 = c.current_plan().plan_id
        c.ack(pid2, 0, "restored")
        c.note_worker_joined(0)
        plan = c.current_plan()
        assert plan.plan_id == pid2 + 1
        assert plan.reason == "rejoin"

    def test_expired_plan_unwedges_when_rejoin_restores_legality(self):
        """Barrier expiry with NO legal replacement world leaves the
        expired plan current; a later rejoin that makes a legal world
        available again must re-plan — 'self-healing, never wedged'."""
        clk = FakeClock()
        c = RescaleCoordinator(
            legal_counts_fn=lambda n, unit: [2],
            bootstrap_min=2,
            barrier_timeout_s=5.0,
            clock=clk,
        )
        c.note_worker_joined(0)
        c.note_worker_joined(1)
        pid = c.current_plan().plan_id
        c.ack(pid, 0, "barrier")
        clk.t += 10.0  # rank 1 dies mid-barrier; only world size 2 legal
        _, expired, _, _ = c.barrier_state(pid, "barrier")
        assert expired
        assert c.current_plan().plan_id == pid  # no legal 1-node world
        assert c.current_plan().expired
        c.note_worker_joined(1)  # replacement arrives
        plan = c.current_plan()
        assert plan.plan_id == pid + 1
        assert plan.reason == "rejoin"
        assert plan.rank_order == [0, 1]

    def test_noop_join_is_held_as_waiter_not_replanned(self):
        """A join that cannot change the world (already at the largest
        legal size) must NOT cut a plan — that would roll every healthy
        survivor back to restore_step for a no-op membership change —
        and must NOT hand the joiner the current plan (absence from its
        world reads as eviction and the worker exits): the joiner waits."""
        c = RescaleCoordinator(
            legal_counts_fn=lambda n, unit: [1, 2], bootstrap_min=2
        )
        c.note_worker_joined(0)
        c.note_worker_joined(1)
        pid = c.current_plan().plan_id
        c.note_worker_joined(2)  # world {0,1} is already maximal-legal
        assert c.current_plan().plan_id == pid  # survivors undisturbed
        assert c.get_plan(2, current_plan_id=-1) is None  # waiter
        assert c.get_plan(0, current_plan_id=-1).plan_id == pid
        c.note_worker_lost(1)  # now the waiter gets its seat
        plan = c.current_plan()
        assert plan.rank_order == [0, 2]
        assert c.get_plan(2, current_plan_id=-1).plan_id == plan.plan_id

    def test_lower_rank_joiner_never_swaps_out_a_running_member(self):
        """A joiner that sorts BELOW the active members must not defeat
        the no-op-join hold: a same-size world is a seat swap that
        evicts a healthy running rank for zero capacity gain."""
        c = RescaleCoordinator(
            legal_counts_fn=lambda n, unit: [1, 2], bootstrap_min=2
        )
        c.note_worker_joined(1)
        c.note_worker_joined(2)
        pid = c.current_plan().plan_id
        c.note_worker_joined(0)  # sorts first, but adds no capacity
        plan = c.current_plan()
        assert plan.plan_id == pid
        assert plan.rank_order == [1, 2]  # rank 2 keeps its seat
        assert c.get_plan(0, current_plan_id=-1) is None  # waiter
        c.note_worker_lost(2)
        assert c.current_plan().rank_order == [0, 1]

    def test_relaunched_block_members_wait_until_block_completes(self):
        """Relaunched members of a broken slice block accumulate as
        waiters (no plan cut, no eviction) until the block is whole,
        then one scale-up plan folds the entire block back in."""
        c = RescaleCoordinator(node_unit=2, bootstrap_min=4)
        for r in range(4):
            c.note_worker_joined(r, node_group=r // 2)
        c.note_worker_lost(1)  # block 0 broken
        pid = c.current_plan().plan_id
        assert c.current_plan().rank_order == [2, 3]
        c.note_worker_joined(0, node_group=0)  # alone: block incomplete
        assert c.current_plan().plan_id == pid
        assert c.get_plan(0, current_plan_id=-1) is None  # waiter
        c.note_worker_joined(1, node_group=0)  # block 0 whole again
        plan = c.current_plan()
        assert plan.reason == "scale_up_join"
        assert plan.rank_order == [0, 1, 2, 3]
        assert c.get_plan(0, current_plan_id=-1).plan_id == plan.plan_id

    def test_world_never_straddles_broken_slice_block(self):
        """With node groups (TPU slices, node_unit hosts each), a plan's
        world must be built from COMPLETE blocks only — the same rule
        rendezvous enforces, because an ICI slice cannot run collectives
        with a missing host."""
        c = RescaleCoordinator(node_unit=4, bootstrap_min=8)
        for r in range(8):
            c.note_worker_joined(r, node_group=r // 4)
        assert c.current_plan().rank_order == list(range(8))
        c.note_worker_lost(3)  # block 0 now incomplete
        plan = c.current_plan()
        assert plan.rank_order == [4, 5, 6, 7]  # NOT [0, 1, 2, 4]

    def test_barrier_expiry_metric(self):
        from dlrover_tpu_torch.observability.registry import default_registry

        clk = FakeClock()
        c = RescaleCoordinator(
            bootstrap_min=1, barrier_timeout_s=1.0, clock=clk
        )
        counter = default_registry().counter(
            "rescale_barrier_expired_total"
        )
        before = counter.value()
        c.note_worker_joined(0)
        clk.t += 5.0
        c.barrier_state(c.current_plan().plan_id, "barrier")
        assert counter.value() == before + 1


@pytest.mark.rescale
def test_rendezvous_respects_batch_config_legality():
    """The rendezvous wired to the trainer's batch config truncates a
    3-survivor waiting set to a 2-node world instead of forming a world
    that would crash grad_accum_for()."""
    from dlrover_tpu_torch.master.elastic_training.rdzv_manager import (
        ElasticTrainingRendezvousManager,
    )

    bc = ElasticBatchConfig(global_batch_size=8, micro_batch_per_device=1)
    mgr = ElasticTrainingRendezvousManager()
    mgr.update_rdzv_params(min_nodes=1, max_nodes=4, waiting_timeout=0.0)
    mgr.set_legal_counts_fn(bc.legal_node_counts_fn())
    for r in range(3):
        mgr.join_rendezvous(r, r, 1)
    _, _, world = mgr.get_comm_world(0)
    assert len(world) == 2
    bc.grad_accum_for(len(world))  # must not raise


@pytest.mark.rescale
def test_local_master_legality_uses_devices_per_node():
    """The local master's batch-legality wiring must compute dp at the
    real nodes * devices_per_node (regression: it defaulted to 1, so a
    world judged legal at dp=n crashed grad_accum_for at dp=4n)."""
    from dlrover_tpu_torch.master.local_master import LocalJobMaster
    from dlrover_tpu_torch.master.node.job_context import JobContext

    JobContext.reset_singleton()
    bc = ElasticBatchConfig(global_batch_size=8, micro_batch_per_device=1)
    m = LocalJobMaster(
        port=0, node_num=2, transport="http",
        batch_config=bc, devices_per_node=4,
    )
    m.prepare()
    try:
        fn = m.rescale_coordinator._legal_counts_fn
        # dp = n*4: 8 % (1 * n * 4) == 0 only for 1- and 2-node worlds
        assert fn(4, 1) == [1, 2]
    finally:
        m.stop()


def _servicer_with_coordinator():
    c = RescaleCoordinator(bootstrap_min=1)
    s = MasterServicer(rdzv_managers={}, rescale_coordinator=c)
    return s, c


def _get(servicer, request, node_id=0):
    msg = Message(node_id=node_id, data=request.serialize())
    return comm.BaseResponse.deserialize(servicer.get(msg).data)


def _report(servicer, request, node_id=0):
    msg = Message(node_id=node_id, data=request.serialize())
    return comm.BaseResponse.deserialize(servicer.report(msg).data)


@pytest.mark.rescale
class TestServicerRoundTrip:
    def test_join_plan_ack_barrier_roundtrip(self):
        s, c = _servicer_with_coordinator()
        _report(s, comm.RescaleJoinReport(node_id=0, node_rank=0))
        resp = _get(s, comm.RescalePlanRequest(node_rank=0,
                                               current_plan_id=-1))
        assert resp.plan_id == 1
        assert resp.world == {0: 1}
        assert resp.rank_order == [0]
        # no newer plan
        resp = _get(s, comm.RescalePlanRequest(node_rank=0,
                                               current_plan_id=1))
        assert resp.plan_id == -1
        _report(s, comm.RescaleAckReport(node_rank=0, plan_id=1,
                                         phase="barrier"))
        resp = _get(s, comm.RescaleBarrierRequest(node_rank=0, plan_id=1,
                                                  phase="barrier"))
        assert resp.ready and not resp.expired and not resp.superseded

    def test_plan_broadcast_drop_fault_point(self):
        """An armed rescale.plan.broadcast raise drops exactly one plan
        delivery; the next poll (the client retry) gets the same
        versioned plan."""
        s, _ = _servicer_with_coordinator()
        _report(s, comm.RescaleJoinReport(node_id=0, node_rank=0))
        sched = FaultSchedule([
            FaultRule("rescale.plan.broadcast", action="raise", nth=1,
                      rule_id="drop-plan"),
        ], seed=0, label="t")
        arm(sched)
        try:
            with pytest.raises(Exception):
                _get(s, comm.RescalePlanRequest(node_rank=0,
                                                current_plan_id=-1))
            resp = _get(s, comm.RescalePlanRequest(node_rank=0,
                                                   current_plan_id=-1))
            assert resp.plan_id == 1
            assert [t["rule_id"] for t in sched.trace] == ["drop-plan"]
        finally:
            disarm()

    def test_node_failure_report_feeds_coordinator(self):
        s, c = _servicer_with_coordinator()
        _report(s, comm.RescaleJoinReport(node_id=0, node_rank=0))
        _report(s, comm.RescaleJoinReport(node_id=1, node_rank=1))
        assert len(c.current_plan().world) == 2
        _report(s, comm.NodeFailureReport(node_id=1, node_rank=1,
                                          level="node"))
        plan = c.current_plan()
        assert plan.rank_order == [0]
        assert plan.reason == "node_lost"

    def test_ckpt_step_report_sets_restore_step(self):
        s, c = _servicer_with_coordinator()
        _report(s, comm.CkptStepReport(node_id=0, step=8, committed=True))
        _report(s, comm.CkptStepReport(node_id=0, step=9, committed=False))
        _report(s, comm.RescaleJoinReport(node_id=0, node_rank=0))
        assert c.current_plan().restore_step == 8


# ---- the differential script ----------------------------------------------

PLAN_FIELDS = ("plan_id", "world", "rank_order", "restore_step", "reason",
               "cut_seq", "expired")
UNIVERSE = 8  # worker ranks the script draws from
PHASE_NAMES = ("barrier", "restored", "resumed")


def _plan_fields(plan):
    if plan is None:
        return None
    return {f: getattr(plan, f) for f in PLAN_FIELDS}


def _answers(c):
    """Every observable answer of a coordinator, in a fixed order."""
    out = {"current": _plan_fields(c.current_plan())}
    cur = c.current_plan()
    cur_id = cur.plan_id if cur is not None else 0
    for rank in range(UNIVERSE):
        for have in (-1, cur_id - 1, cur_id):
            out[f"get/{rank}/{have}"] = _plan_fields(c.get_plan(rank, have))
    for pid in (cur_id - 1, cur_id, cur_id + 1):
        for phase in PHASE_NAMES:
            out[f"barrier/{pid}/{phase}"] = tuple(
                tuple(x) if isinstance(x, list) else x
                for x in c.barrier_state(pid, phase))
    out["committed"] = c.committed_step()
    return out


def _script(seed: int, n_events: int):
    """A seeded list of (op, args) events over ``UNIVERSE`` ranks."""
    rng = np.random.default_rng(seed)
    ops = ("join", "join", "join", "lost", "lost", "evict", "ckpt",
           "ack", "ack", "ack", "ack", "advance", "advance_past")
    events = []
    for _ in range(n_events):
        op = ops[int(rng.integers(len(ops)))]
        rank = int(rng.integers(UNIVERSE))
        if op == "join":
            events.append((op, rank, int(rng.integers(1, 3)),
                           int(rng.integers(-1, 3))))
        elif op in ("lost", "evict"):
            events.append((op, rank))
        elif op == "ckpt":
            events.append((op, int(rng.integers(0, 50)),
                           bool(rng.integers(0, 4))))
        elif op == "ack":
            events.append((op, rank, PHASE_NAMES[int(rng.integers(3))],
                           int(rng.integers(-1, 2))))
        elif op == "advance":
            events.append((op, float(rng.uniform(0.0, 3.0))))
        else:
            events.append((op,))
    return events


def _apply(c, clock, event, timeout_s):
    op = event[0]
    if op == "join":
        _, rank, lws, group = event
        c.note_worker_joined(rank, lws, node_group=group)
    elif op == "lost":
        c.note_worker_lost(event[1])
    elif op == "evict":
        return c.evict_worker(event[1])
    elif op == "ckpt":
        c.note_ckpt_step(event[1], event[2])
    elif op == "ack":
        _, rank, phase, delta = event
        plan = c.current_plan()
        pid = (plan.plan_id if plan is not None else 0) + delta
        return c.ack(pid, rank, phase)
    elif op == "advance":
        clock.t += event[1]
    else:
        clock.t += timeout_s + 1.0
    return None


def _legality(pkg_trainer, kind):
    if kind == "batch":
        bc = pkg_trainer.ElasticBatchConfig(global_batch_size=12,
                                            micro_batch_per_device=1)
        return bc.legal_node_counts_fn(local_world_size=2)
    if kind == "even":
        return lambda n, unit: [c for c in range(2, n + 1, 2)]
    return None


@pytest.mark.rescale
@pytest.mark.parametrize("seed, legality, node_unit", [
    (0, None, 1), (1, "batch", 1), (2, "even", 1), (3, None, 2),
    (4, "batch", 2),
])
def test_port_coordinator_answers_as_the_reference(seed, legality,
                                                   node_unit):
    import importlib

    timeout_s = 5.0
    clock = FakeClock()
    coords = []
    for pkg in ("dlrover_tpu", "dlrover_tpu_torch"):
        mod = importlib.import_module(
            f"{pkg}.master.elastic_training.rescale_coordinator")
        trainer = importlib.import_module(f"{pkg}.trainer.elastic.trainer")
        coords.append(mod.RescaleCoordinator(
            legal_counts_fn=_legality(trainer, legality),
            barrier_timeout_s=timeout_s,
            node_unit=node_unit,
            bootstrap_min=3,
            clock=clock,
        ))
    ref, port = coords
    events = _script(seed, 240)
    assert len(events) >= 200
    plans_seen = set()
    for i, event in enumerate(events):
        got = [_apply(c, clock, event, timeout_s) for c in coords]
        assert got[0] == got[1], (i, event)
        want = _answers(ref)
        assert _answers(port) == want, (i, event)
        if ref.current_plan() is not None:
            plans_seen.add((ref.current_plan().plan_id,
                            ref.current_plan().reason))
    # The script reached the interesting transitions.
    reasons = {r for _, r in plans_seen}
    assert len(plans_seen) >= 10, plans_seen
    assert {"bootstrap", "node_lost"} <= reasons, reasons


@pytest.mark.rescale
def test_local_master_hands_the_servicer_a_coordinator():
    from dlrover_tpu_torch.master.local_master import LocalJobMaster
    from dlrover_tpu_torch.master.node.job_context import JobContext

    JobContext.reset_singleton()
    m = LocalJobMaster(port=0, node_num=2)
    m.prepare()
    try:
        assert isinstance(m.rescale_coordinator, RescaleCoordinator)
        assert m.servicer._rescale_coordinator is m.rescale_coordinator
        s = m.servicer
        _report(s, comm.RescaleJoinReport(node_id=0, node_rank=0))
        assert m.rescale_coordinator.current_plan() is None  # 2 to boot
        _report(s, comm.RescaleJoinReport(node_id=1, node_rank=1))
        resp = _get(s, comm.RescalePlanRequest(node_rank=1,
                                               current_plan_id=-1))
        assert resp.plan_id == 1 and resp.rank_order == [0, 1]
    finally:
        m.stop()
