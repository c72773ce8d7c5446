"""The port's autoscaler plane against the JAX package's, on the CPU.

- one seeded stream of ``SignalSnapshot``s (straggler scores, observed
  MTBF, shard backlog, fleet utilisation) through both packages'
  ``RulePolicy`` gives the same ledger: action, target, reason and ts of
  every decision, and the rest of its record;
- ``score_ledger`` and ``rank_policies`` give equal results over one
  recording;
- a recording that either package's ``AutoScaler`` writes through its
  ``SignalRecorder`` loads in the other and passes its
  ``assert_replay_identity``;
- ``SimClusterScaler`` gives equal node tables after one ``ScalePlan``
  sequence;
- ``build_autoscale_plan``, ``build_fleet_schedules`` and
  ``build_migration_schedules`` are equal for seeds 0-4;
- ``kvpool_source`` over the port's paged engine reads its pool and
  its SLO-class queues (the reference's ``test_kvpool_signal_source``).
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import os
import random

import numpy as np
import pytest
import torch

from dlrover_tpu import autoscaler as ref
from dlrover_tpu.common.constants import NodeType as RefNodeType
from dlrover_tpu.common.node import Node as RefNode
from dlrover_tpu.common.node import NodeGroupResource as RefGroup
from dlrover_tpu.master.scaler.base_scaler import ScalePlan as RefPlan
from dlrover_tpu.master.scaler.sim_scaler import SimClusterScaler as RefSim
from dlrover_tpu.observability.registry import (
    MetricsRegistry as RefRegistry,
)
from dlrover_tpu.testing import autoscale_soak as ref_asoak
from dlrover_tpu.testing import fleet_soak as ref_fsoak
from dlrover_tpu_torch import autoscaler as port
from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.node import Node, NodeGroupResource
from dlrover_tpu_torch.master.scaler.base_scaler import ScalePlan
from dlrover_tpu_torch.master.scaler.sim_scaler import SimClusterScaler
from dlrover_tpu_torch.observability.registry import MetricsRegistry
from dlrover_tpu_torch.testing import autoscale_soak, fleet_soak

SEEDS = range(5)


def _config(pkg):
    """One config that arms all four rules: straggler eviction, the
    Young/Daly cadence, world bands over legal counts, fleet bands."""
    return pkg.PolicyConfig(
        straggler_confirm_ticks=2, evict_cooldown_s=4.0,
        ckpt_cooldown_s=2.0, ckpt_min_interval_s=0.05,
        min_world=1, max_world=8, legal_world_counts=[1, 2, 4, 8],
        backlog_grow_per_worker=64.0, backlog_shrink_per_worker=8.0,
        world_cooldown_s=6.0,
        min_replicas=1, max_replicas=6, fleet_confirm_ticks=2,
        fleet_cooldown_s=3.0,
    )


def snapshot_stream(seed, n=240):
    """Seeded values with persistence (each signal holds its state for
    a run of snapshots), stamped on an irregular clock."""
    rng = random.Random(seed)
    ts, mono = 1000.0 + seed, 50.0 + seed
    straggler, score = None, 1.0
    world, todo, replicas, util = 4, 200.0, 2, 0.5
    failures, mtbf, interval = 0, None, 60.0
    out = []
    for seq in range(1, n + 1):
        if rng.random() < 0.15:
            straggler = rng.choice([None, None, 1, 2, 3])
            score = round(rng.uniform(1.2, 3.5), 3)
        if rng.random() < 0.1:
            todo = float(rng.choice([0, 10, 200, 800, 2000]))
        if rng.random() < 0.12:
            util = round(rng.choice([0.1, 0.2, 0.5, 0.9, 0.97]), 2)
        if rng.random() < 0.06:
            failures += 1
            if failures >= 2:
                mtbf = round(rng.uniform(5.0, 400.0), 3)
        values = {
            "perf.goodput": round(rng.uniform(0.5, 0.95), 4),
            "perf.straggler_ranks": [] if straggler is None
            else [straggler],
            "perf.straggler_scores": {} if straggler is None
            else {straggler: score, 0: 1.0},
            "perf.median_step_s": 0.01,
            "data.todo": todo,
            "world.size": world,
            "fleet.replicas": replicas,
            "fleet.slot_util": util,
            "fleet.queue_depth": 40 if util > 0.9 else 0,
            "fault.failures_total": failures,
            "ckpt.interval_s": interval,
            "ckpt.save_block_s": 0.02,
        }
        if mtbf is not None:
            values["fault.mtbf_s"] = mtbf
        out.append((seq, ts, mono, values))
        step = round(rng.uniform(0.3, 2.0), 3)
        ts += step
        mono += step
        # The world and fleet follow whatever the policy would do only
        # in the loop; here a slow drift keeps every band reachable.
        if rng.random() < 0.05:
            world = rng.choice([1, 2, 4, 8])
        if rng.random() < 0.05:
            replicas = rng.randint(1, 6)
        if rng.random() < 0.05:
            interval = round(rng.uniform(1.0, 120.0), 3)
    return out


def _ledger(pkg, stream):
    policy = pkg.RulePolicy(_config(pkg))
    decisions = []
    for seq, ts, mono, values in stream:
        decisions += policy.decide(pkg.SignalSnapshot(
            seq=seq, ts=ts, mono=mono, values=dict(values)))
    return decisions


@pytest.mark.parametrize("seed", SEEDS)
def test_rule_policy_ledgers_are_identical(seed):
    stream = snapshot_stream(seed)
    got = _ledger(port, stream)
    want = _ledger(ref, stream)
    assert len(got) == len(want)
    assert [(d.action, d.target, d.reason, d.ts) for d in got] == [
        (d.action, d.target, d.reason, d.ts) for d in want]
    assert [d.to_dict() for d in got] == [d.to_dict() for d in want]
    # The stream exercises every rule family.
    actions = {d.action for d in want}
    assert {ref.EVICT_STRAGGLER, ref.SET_CKPT_INTERVAL} <= actions
    assert actions & {ref.GROW_WORLD, ref.SHRINK_WORLD}
    assert actions & {ref.GROW_FLEET, ref.SHRINK_FLEET}


def _record(pkg, registry_cls, path, seed, snapshots=80):
    """A live AutoScaler of ``pkg`` on a fake clock over the seeded
    stream's values, recording to ``path``; returns its ledger."""
    stream = snapshot_stream(seed, snapshots)
    t = {"now": stream[0][1], "i": 0}

    def source(prefix):
        def fn():
            values = stream[min(t["i"], len(stream) - 1)][3]
            return {k.split(".", 1)[1]: v for k, v in values.items()
                    if k.startswith(prefix + ".")}
        return fn

    bus = pkg.SignalBus(clock=lambda: t["now"])
    for name in ("perf", "data", "world", "fleet", "fault", "ckpt"):
        bus.add_source(name, source(name))
    scaler = pkg.AutoScaler(
        bus, policy=pkg.RulePolicy(_config(pkg)),
        actuators={a: (lambda d: None) for a in (
            pkg.EVICT_STRAGGLER, pkg.SET_CKPT_INTERVAL, pkg.GROW_FLEET,
            pkg.SHRINK_FLEET)},
        clock=lambda: t["now"], registry=registry_cls(),
        recorder=pkg.SignalRecorder(path, fsync=False),
        attribution_window_s=1.0,
    )
    for _ in range(snapshots):
        scaler.tick()
        t["i"] += 1
        t["now"] += 0.5
    scaler.stop()
    return scaler.ledger.entries()


@pytest.mark.parametrize("writer, reader", [("port", "ref"),
                                            ("ref", "port")])
def test_recordings_cross_load_and_replay(tmp_path, writer, reader):
    pkgs = {"port": (port, MetricsRegistry), "ref": (ref, RefRegistry)}
    path = os.path.join(str(tmp_path), "signals.jsonl")
    live = _record(*pkgs[writer], path, seed=3)
    rpkg = pkgs[reader][0]
    recording = rpkg.load_recording(path)
    assert len(recording.snapshots) == 80
    assert len(recording.decisions) == len(live) >= 3
    assert recording.outcomes
    diff = rpkg.assert_replay_identity(recording)
    assert diff["identical"]
    # A perturbed config decides differently over the same stream.
    perturbed = rpkg.replay_policy(recording.snapshots, rpkg.PolicyConfig(
        **{**_config(rpkg).to_dict(), "straggler_confirm_ticks": 10_000}))
    assert not rpkg.diff_ledgers(recording.decisions, perturbed)[
        "identical"]


def test_score_ledger_and_rank_policies_agree(tmp_path):
    path = os.path.join(str(tmp_path), "signals.jsonl")
    _record(ref, RefRegistry, path, seed=1, snapshots=120)
    got_rec = port.load_recording(path)
    want_rec = ref.load_recording(path)
    cost_kw = dict(rescale_to_first_step_s=0.7, save_block_s=0.03)
    got = port.score_ledger(got_rec.snapshots, got_rec.decisions,
                            port.CostModel(**cost_kw))
    want = ref.score_ledger(want_rec.snapshots, want_rec.decisions,
                            ref.CostModel(**cost_kw))
    assert got == want
    assert got["decisions_total"] >= 3

    def candidates(pkg):
        base = pkg.PolicyConfig.from_dict(got_rec.policy_config)
        return [("eager", pkg.PolicyConfig(**{
                    **base.to_dict(), "straggler_confirm_ticks": 1})),
                ("never-evict", pkg.PolicyConfig(**{
                    **base.to_dict(), "straggler_confirm_ticks": 10_000})),
                ("fleet-frozen", pkg.PolicyConfig(**{
                    **base.to_dict(), "fleet_util_grow": 1.01,
                    "fleet_util_shrink": -1.0}))]

    got = port.rank_policies(got_rec, candidates(port),
                             port.CostModel(**cost_kw), with_decisions=True)
    want = ref.rank_policies(want_rec, candidates(ref),
                             ref.CostModel(**cost_kw), with_decisions=True)
    for result in (got, want):
        result.pop("replay_snapshots_per_s")
        result.pop("replay_s", None)
    assert got == want


def _scale_sequence(plan_cls, group_cls, node_cls, worker):
    """Boot 4, evict-and-replace rank 2, grow to 6, a mixed plan (remove
    rank 0 and shrink to 3), an idempotent repeat, a launch over
    capacity."""
    def group(n):
        plan = plan_cls()
        plan.node_group_resources[worker] = group_cls(count=n)
        return plan

    yield group(4)
    yield "evict", 2
    yield group(6)
    yield "mixed", 0
    yield group(3)
    yield group(3)
    yield plan_cls(launch_nodes=[node_cls(worker, 100 + i, rank_index=10 + i)
                                 for i in range(8)])


def _run_scaler(sim_cls, plan_cls, group_cls, node_cls, worker):
    events = []
    sim = sim_cls("parity", capacity=7, clock=lambda: 5.0,
                  on_scale=lambda job, up, down: events.append(
                      ([n.id for n in up], [n.id for n in down])))
    for step in _scale_sequence(plan_cls, group_cls, node_cls, worker):
        if isinstance(step, tuple):
            kind, rank = step
            victim = sim.find_rank(rank)
            plan = plan_cls(remove_nodes=[victim])
            if kind == "evict":
                plan.launch_nodes.append(node_cls(
                    worker, sim.next_node_id(), rank_index=rank))
            else:
                plan.node_group_resources[worker] = group_cls(count=3)
            sim.scale(plan)
        else:
            sim.scale(step)
    nodes = [(n.type, n.id, n.rank_index, n.name, n.status, n.host_name,
              n.create_time) for n in sim.alive_nodes()]
    return nodes, events, sim.launches_dropped, sim.plans_applied


def test_sim_scalers_converge_to_equal_node_sets():
    got = _run_scaler(SimClusterScaler, ScalePlan, NodeGroupResource, Node,
                      NodeType.WORKER)
    want = _run_scaler(RefSim, RefPlan, RefGroup, RefNode,
                       RefNodeType.WORKER)
    assert got == want
    assert got[2] > 0  # the over-capacity launches were dropped


def _rules(schedule):
    return (schedule.seed, schedule.label,
            [r.to_dict() for r in schedule.rules])


@pytest.mark.parametrize("seed", SEEDS)
def test_soak_plans_and_schedules_are_the_references(seed):
    got = autoscale_soak.build_autoscale_plan(seed, 5)
    want = ref_asoak.build_autoscale_plan(seed, 5)
    assert (got.straggler_rank, got.straggler_onset_step,
            got.straggler_delay_s, got.crash_steps) == (
        want.straggler_rank, want.straggler_onset_step,
        want.straggler_delay_s, want.crash_steps)
    assert _rules(got.schedule) == _rules(want.schedule)
    for build in ("build_fleet_schedules", "build_migration_schedules"):
        for episode in (4, 6):
            got = getattr(fleet_soak, build)(seed, episode)
            want = getattr(ref_fsoak, build)(seed, episode)
            assert {k: _rules(s) for k, s in got.items()} == {
                k: _rules(s) for k, s in want.items()}


def test_kvpool_signal_source_reads_the_paged_engine():
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.serving import SloClass
    from dlrover_tpu_torch.serving.kvpool import PagedServingEngine

    cfg = llama.tiny_config()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    eng = PagedServingEngine(
        cfg, params, slots=2, max_len=32, prefill_chunk=8, block_size=8,
        slo_classes=(SloClass("interactive"), SloClass("batch")),
        registry=MetricsRegistry(), device="cpu",
    )
    eng.warmup()
    prompt = np.random.RandomState(11).randint(
        0, cfg.vocab_size, size=9).astype(np.int32)
    eng.submit(prompt, 3, slo_class="interactive")
    eng.run_until_idle()
    bus = port.SignalBus().add_source("kv", port.kvpool_source(eng))
    snap = bus.sample()
    assert snap.get("kv.blocks_total") == eng.num_blocks - 1
    assert snap.get("kv.blocks_free_frac") is not None
    assert snap.get("kv.queue_depth.interactive") == 0
    assert snap.get("kv.queue_depth.batch") == 0
    assert "kv.error" not in snap.values
    stats = eng.kv_stats()
    assert snap.get("kv.blocks_free") + snap.get("kv.blocks_used") + \
        snap.get("kv.blocks_cached") == stats["total"]
