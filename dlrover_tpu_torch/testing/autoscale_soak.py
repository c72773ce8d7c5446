"""Autoscaler chaos episode: static vs closed-loop under one schedule.

The ``straggler_evict`` episode kind (chaos soak episode 5) validates
the §30 closed-loop autoscaler the way the ROADMAP demands: the SAME
seeded fault + traffic schedule is run through a deterministic
sim-cluster training job three ways —

- **static**: fixed world, fixed serving fleet, fixed ckpt cadence
  (the baseline every resource brain is judged against);
- **dry_run**: the autoscaler watches and ledgers but actuates
  nothing (must behave exactly like static, with a populated ledger);
- **autoscaled**: the full loop — evict-and-replace the delayed
  straggler via a real ``ScalePlan`` against
  :class:`SimClusterScaler`, retune the flash-ckpt cadence from the
  OBSERVED MTBF (Young/Daly), grow/shrink the serving fleet through
  hysteresis bands as the traffic spike arrives and passes.

The sim job is a lockstep SPMD model over the REAL control plane: real
:class:`TaskManager` shard leases (crash recovery requeues them), real
:class:`PerfMonitor` per-rank step-time EWMAs feeding the §29
straggler report, the real fault plane (a persistent per-rank
``delay`` rule at the ``agent.worker.crash`` step fault point IS the
straggler; ``raise`` rules there are worker deaths), and the real
policy/ledger/actuator code paths. Wall time is real (sleeps), so the
goodput fractions are measured, not computed.

Invariants (docs/DESIGN.md §30):

1. the autoscaled run's goodput fraction STRICTLY beats the static
   run's;
2. the straggler is flagged, evicted and replaced within a bounded
   number of decision windows (time-to-mitigate reported);
3. every ledger decision carries the triggering signal snapshot and an
   explained outcome (no unexplained actions);
4. dry-run mode emits the same leading decision with ZERO actuations;
5. both runs drain the dataset exactly once (TaskManager accounting).

The §34 record→replay→perturb leg extends the episode: the autoscaled
run's signal stream is durably recorded (SignalRecorder), replayed
offline through the SAME PolicyConfig (must reproduce the live ledger
decision-for-decision — the replay identity invariant), and through a
PERTURBED config (must produce a differing, scored counterfactual
ledger). Two more invariants ride along: every actuated decision
carries a realized-outcome annotation, and the per-cause goodput
attribution explains ≥90% of the non-train wall time.

The port's copy of ``dlrover_tpu/testing/autoscale_soak.py``: its
plans equal the reference's for every seed. Like the reference's, it
simulates its cluster on the host and launches nothing on the card.
"""

import os
import random
import shutil
import tempfile
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

from dlrover_tpu_torch.autoscaler import (
    AutoScaler,
    CadenceController,
    CostModel,
    FaultHistory,
    PolicyConfig,
    ReplayMismatch,
    RulePolicy,
    SignalBus,
    SignalRecorder,
    TrainWorldActuator,
    assert_replay_identity,
    data_source,
    diff_ledgers,
    fault_source,
    load_recording,
    perf_source,
    replay_recording,
    score_ledger,
)
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import GoodputPhase, NodeType
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.fault import FaultInjected, FaultRule, FaultSchedule
from dlrover_tpu_torch.fault.registry import arm, disarm, fault_point
from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor
from dlrover_tpu_torch.master.scaler.base_scaler import ScalePlan
from dlrover_tpu_torch.master.scaler.sim_scaler import SimClusterScaler
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from dlrover_tpu_torch.testing.soak import SoakInvariantError

DATASET = "autoscale-train"


@dataclass
class AutoscaleSoakConfig:
    world: int = 4
    capacity: int = 8
    steps: int = 220                  # successful lockstep steps
    base_step_s: float = 0.012        # healthy per-step wall
    restart_s: float = 0.3            # worker replacement / evict pause
    save_block_s: float = 0.008      # blocking cost per ckpt save
    static_ckpt_every_s: float = 3.0  # the fixed baseline cadence
    decision_interval_s: float = 0.08
    mitigate_window_bound: int = 30   # decision windows to evict within
    watchdog_s: float = 75.0
    # serving traffic model (requests per lockstep step)
    serve_replicas: int = 2
    serve_max_replicas: int = 6
    serve_rate_per_replica: float = 3.0
    traffic_base: float = 2.0
    traffic_spike: float = 14.0
    spike_start_frac: float = 0.40
    spike_end_frac: float = 0.65


@dataclass
class AutoscalePlan:
    """Deterministic (seed, episode) -> who lags, who dies, when."""

    straggler_rank: int
    straggler_onset_step: int
    straggler_delay_s: float
    crash_steps: Dict[int, int] = field(default_factory=dict)  # rank->nth
    schedule: Optional[FaultSchedule] = None


def build_autoscale_plan(
    seed: int, episode: int, cfg: Optional[AutoscaleSoakConfig] = None
) -> AutoscalePlan:
    """Randomness in GENERATION, deterministic hit-counter triggers —
    the PR-5 contract. Rules match on the NODE id (stable per
    incarnation), so an evicted straggler's replacement runs clean and
    a dead rank's relaunch is not re-killed. Initial node ids equal
    ranks (the scaler's first group launch allocates 0..world-1)."""
    cfg = cfg or AutoscaleSoakConfig()
    ep_seed = seed * 10007 + episode
    rng = random.Random(ep_seed ^ 0xA5CA1E)
    straggler = rng.randrange(1, cfg.world)
    onset = rng.randint(15, 25)
    delay_s = cfg.base_step_s * rng.uniform(2.4, 3.2)
    others = [r for r in range(cfg.world) if r != straggler]
    rng.shuffle(others)
    lo = cfg.steps
    crash_steps = {
        others[0]: rng.randint(int(lo * 0.25), int(lo * 0.35)),
        others[1 % len(others)]: rng.randint(
            int(lo * 0.50), int(lo * 0.60)
        ),
        others[2 % len(others)]: rng.randint(
            int(lo * 0.80), int(lo * 0.90)
        ),
    }
    rules = [
        # THE satellite fault: a persistent per-node delay at the step
        # fault point — every step of this node is slow from ``onset``
        # until someone does something about it.
        FaultRule(
            "agent.worker.crash", action="delay", delay_s=round(delay_s, 4),
            nth=onset, every=1, match={"node": straggler},
            rule_id="straggler-delay",
        ),
    ]
    for rank, nth in sorted(crash_steps.items()):
        rules.append(FaultRule(
            "agent.worker.crash", action="raise", nth=nth,
            match={"node": rank}, rule_id=f"worker-crash-n{rank}",
        ))
    return AutoscalePlan(
        straggler_rank=straggler,
        straggler_onset_step=onset,
        straggler_delay_s=delay_s,
        crash_steps=crash_steps,
        schedule=FaultSchedule(rules, seed=ep_seed,
                               label=f"autoscale-ep{episode}"),
    )


class SimServingLoad:
    """Deterministic request stream against a replica pool: arrivals
    are a pure function of the step index (identical across the
    static/dry/auto runs), capacity is ``replicas × rate``. Utilization
    saturates at 1.0 while a backlog exists — the signal the fleet
    hysteresis band watches."""

    def __init__(self, cfg: AutoscaleSoakConfig):
        self._cfg = cfg
        self.replicas = cfg.serve_replicas
        self.queue = 0.0
        self.util = 0.0
        self.arrived_total = 0.0
        self.served_total = 0.0
        self.queue_peak = 0.0
        self.grow_events = 0
        self.shrink_events = 0
        self._spike = (
            int(cfg.steps * cfg.spike_start_frac),
            int(cfg.steps * cfg.spike_end_frac),
        )

    def arrivals(self, step: int) -> float:
        lo, hi = self._spike
        return (
            self._cfg.traffic_spike if lo <= step < hi
            else self._cfg.traffic_base
        )

    def tick(self, step: int):
        a = self.arrivals(step)
        self.queue += a
        self.arrived_total += a
        cap = max(self.replicas * self._cfg.serve_rate_per_replica, 1e-9)
        served = min(self.queue, cap)
        self.queue -= served
        self.served_total += served
        self.queue_peak = max(self.queue_peak, self.queue)
        self.util = 1.0 if self.queue > 1e-9 else served / cap

    def as_source(self):
        def fn() -> Dict[str, object]:
            return {
                "replicas": self.replicas,
                "slot_util": round(self.util, 4),
                "queue_depth": round(self.queue, 1),
            }
        return fn

    def grow(self, decision):
        self.replicas = min(
            int(decision.target), self._cfg.serve_max_replicas
        )
        self.grow_events += 1

    def shrink(self, decision):
        self.replicas = max(int(decision.target), 1)
        self.shrink_events += 1


def _policy_config(cfg: AutoscaleSoakConfig) -> PolicyConfig:
    return PolicyConfig(
        straggler_confirm_ticks=2,
        evict_cooldown_s=1.0,
        ckpt_retune_frac=0.2,
        ckpt_min_interval_s=0.05,
        ckpt_cooldown_s=0.5,
        default_save_block_s=cfg.save_block_s,
        max_world=0,                    # world pinned in this scenario
        min_replicas=1,
        max_replicas=cfg.serve_max_replicas,
        fleet_util_grow=0.85,
        fleet_util_shrink=0.30,
        fleet_confirm_ticks=2,
        fleet_cooldown_s=0.3,
    )


def run_sim_job(mode: str, seed: int, episode: int,
                cfg: Optional[AutoscaleSoakConfig] = None,
                record_path: Optional[str] = None) -> Dict:
    """One run of the sim job under (seed, episode)'s fault schedule.
    ``mode``: "static" | "dry_run" | "auto". ``record_path`` arms a
    SignalRecorder on the autoscaler (the §34 replay leg's input).
    Returns the run report."""
    assert mode in ("static", "dry_run", "auto"), mode
    cfg = cfg or AutoscaleSoakConfig()
    plan = build_autoscale_plan(seed, episode, cfg)

    scaler = SimClusterScaler(f"as-s{seed}-e{episode}",
                              capacity=cfg.capacity)
    boot = ScalePlan()
    from dlrover_tpu_torch.common.node import NodeGroupResource

    boot.node_group_resources[NodeType.WORKER] = NodeGroupResource(
        count=cfg.world
    )
    scaler.scale(boot)

    task_manager = TaskManager(task_timeout=30.0)
    task_manager.new_dataset(comm.DatasetShardParams(
        dataset_name=DATASET,
        dataset_size=cfg.steps * cfg.world,
        shard_size=1,
        task_type="training",
    ))
    perf = PerfMonitor()
    cadence = CadenceController(cfg.static_ckpt_every_s,
                                save_block_s=cfg.save_block_s)
    history = FaultHistory()
    serving = SimServingLoad(cfg)
    world_actuator = TrainWorldActuator.for_sim(
        scaler, on_evicted=perf.reset_rank
    )

    autoscaler = None
    if mode in ("dry_run", "auto"):
        from dlrover_tpu_torch.autoscaler import (
            EVICT_STRAGGLER,
            GROW_FLEET,
            SET_CKPT_INTERVAL,
            SHRINK_FLEET,
        )

        bus = (
            SignalBus()
            .add_source("perf", perf_source(perf))
            .add_source("data", data_source(task_manager))
            .add_source("fault", fault_source(history))
            .add_source("fleet", serving.as_source())
            .add_source("world", world_actuator.as_source())
            .add_source("ckpt", cadence.as_source())
        )
        recorder = (
            SignalRecorder(record_path)
            if record_path else None
        )
        autoscaler = AutoScaler(
            bus,
            policy=RulePolicy(_policy_config(cfg)),
            actuators={
                EVICT_STRAGGLER: world_actuator.evict,
                SET_CKPT_INTERVAL: cadence.apply,
                GROW_FLEET: serving.grow,
                SHRINK_FLEET: serving.shrink,
            },
            interval_s=cfg.decision_interval_s,
            dry_run=(mode == "dry_run"),
            recorder=recorder,
            # Realized effects must show within a few decision windows:
            # the eviction's score drop, the fleet grow's backlog drain.
            attribution_window_s=4.0 * cfg.decision_interval_s,
        )

    # ---- the lockstep sim loop --------------------------------------------
    arm(plan.schedule)
    t0 = time.time()
    deadline = t0 + cfg.watchdog_s
    productive_s = stall_s = replay_s = restart_pause_s = save_s = 0.0
    wasted_s = 0.0
    step = 0
    iterations = 0
    deaths = 0
    saves = 0
    last_save_step = 0
    last_save_wall = t0
    last_tick_wall = t0
    ticks = 0
    onset_wall: Optional[float] = None
    onset_tick: Optional[int] = None
    mitigated_wall: Optional[float] = None
    mitigated_tick: Optional[int] = None
    straggler_node = plan.straggler_rank  # node id == rank at boot
    failure: Optional[str] = None
    try:
        while not task_manager.finished():
            if time.time() > deadline:
                failure = f"watchdog: {mode} run exceeded its deadline"
                break
            t_lease = time.time()
            nodes = scaler.alive_nodes(NodeType.WORKER)
            leases = {}
            for node in nodes:
                task = task_manager.get_task(node.id, DATASET)
                if task.task_id >= 0:
                    leases[node.id] = task
            if not leases:
                time.sleep(0.002)  # leases draining back after a crash
                continue
            iterations += 1
            stepping = [n for n in nodes if n.id in leases]
            t_step = time.time()
            crashed: List[Node] = []
            rank_fault: Dict[int, float] = {}
            for node in stepping:
                f0 = time.time()
                try:
                    fault_point(
                        "agent.worker.crash",
                        step=step, rank=node.rank_index, node=node.id,
                    )
                    rank_fault[node.id] = time.time() - f0
                except FaultInjected:
                    rank_fault[node.id] = time.time() - f0
                    crashed.append(node)
            t_fault_end = time.time()
            if (onset_wall is None
                    and rank_fault.get(straggler_node, 0.0)
                    > cfg.base_step_s):
                onset_wall = time.time()
                onset_tick = ticks
            # §34 attribution: the fault section IS the straggler's
            # stall in this lockstep sim (every rank waits out the
            # delayed one); measured intervals, so sleep overshoot on a
            # loaded box stays attributed too.
            if t_fault_end - t_step > 1e-4 and not crashed:
                for node in stepping:
                    perf.collect_phase(
                        node.rank_index, "stall", t_step, t_fault_end,
                        cause="straggler",
                    )
            t_compute = time.time()
            time.sleep(cfg.base_step_s)  # the world's lockstep compute
            stall = max(rank_fault.values()) if rank_fault else 0.0
            stall_s += stall
            if crashed:
                # The step dies with the worker: nothing is reported
                # done (the leases requeue — exactly-once), the world
                # restarts the seat and replays from the last save.
                wasted_s += cfg.base_step_s
                deaths += len(crashed)
                for node in stepping:
                    task_manager.recover_node_tasks(node.id)
                for node in crashed:
                    history.record_failure()
                    scaler.scale(ScalePlan(
                        remove_nodes=[node],
                        launch_nodes=[Node(
                            NodeType.WORKER, scaler.next_node_id(),
                            rank_index=node.rank_index,
                        )],
                    ))
                time.sleep(cfg.restart_s)
                restart_pause_s += cfg.restart_s
                replay = (step - last_save_step) * cfg.base_step_s
                time.sleep(replay)
                replay_s += replay
                # The dead step (its leases too) + restart + replay is
                # all rescale machinery time, for every lockstep
                # participant.
                t_recovered = time.time()
                for node in stepping:
                    perf.collect_phase(
                        node.rank_index, GoodputPhase.RESTART,
                        t_lease, t_recovered, cause="rescale",
                    )
                continue
            now = time.time()
            for node in stepping:
                task_manager.report_task_done(
                    DATASET, leases[node.id].task_id, node.id
                )
                perf.collect_global_step(
                    step + 1, now, node_id=node.rank_index,
                    step_time_s=cfg.base_step_s
                    + rank_fault.get(node.id, 0.0),
                )
            # A healthy step is its leases, its compute and its reports:
            # all of it is the step's (the lockstep loop does the
            # world's lease fetches and done reports on this thread, and
            # under host load they stretched into the unattributed
            # residual). The fault section between is the stall's.
            t_reported = time.time()
            for node in stepping:
                perf.collect_phase(
                    node.rank_index, GoodputPhase.TRAIN,
                    t_lease, t_step,
                )
                perf.collect_phase(
                    node.rank_index, GoodputPhase.TRAIN,
                    t_fault_end, t_reported,
                )
            productive_s += cfg.base_step_s
            step += 1
            serving.tick(step)
            if now - last_save_wall >= cadence.interval_s():
                time.sleep(cfg.save_block_s)
                save_s += cfg.save_block_s
                saves += 1
                t_saved = time.time()
                for node in stepping:
                    perf.collect_phase(
                        node.rank_index, GoodputPhase.CKPT,
                        t_reported, t_saved, cause="ckpt",
                    )
                last_save_wall = t_saved
                last_save_step = step
            if (autoscaler is not None
                    and now - last_tick_wall >= cfg.decision_interval_s):
                before_ids = {n.id for n in scaler.alive_nodes()}
                t_tick = time.time()
                autoscaler.tick()
                ticks += 1
                last_tick_wall = time.time()
                after_ids = {n.id for n in scaler.alive_nodes()}
                if after_ids != before_ids:
                    # An actuated membership change (the eviction):
                    # the surviving world pays one rescale pause —
                    # attributed to the straggler that forced it.
                    time.sleep(cfg.restart_s)
                    restart_pause_s += cfg.restart_s
                    t_evicted = time.time()
                    for node in stepping:
                        perf.collect_phase(
                            node.rank_index, GoodputPhase.RESTART,
                            t_tick, t_evicted, cause="straggler",
                        )
                    if (straggler_node not in after_ids
                            and mitigated_wall is None):
                        mitigated_wall = time.time()
                        mitigated_tick = ticks
    finally:
        disarm()
        task_manager.stop()
        if autoscaler is not None:
            # Resolves still-open attribution windows against the last
            # snapshot (truncated) and closes the recorder — the ledger
            # read below must carry every realized outcome.
            autoscaler.stop()
    wall = time.time() - t0
    # MEASURED shard accounting (shard_size=1: shards == records) —
    # the exactly-once invariant reads this, not the config constant.
    mgr = task_manager.get_dataset(DATASET)
    records_done = int(mgr.checkpoint().get("completed", 0))
    fires: Dict[str, int] = {}
    for entry in plan.schedule.trace:
        fires[entry["rule_id"]] = fires.get(entry["rule_id"], 0) + 1
    report: Dict = {
        "mode": mode,
        "failure": failure,
        "wall_s": round(wall, 3),
        "productive_step_s": round(productive_s, 3),
        "goodput_frac": round(productive_s / max(wall, 1e-9), 4),
        "stall_s": round(stall_s, 3),
        "replay_s": round(replay_s, 3),
        "restart_pause_s": round(restart_pause_s, 3),
        "save_s": round(save_s, 3),
        "wasted_s": round(wasted_s, 3),
        "steps": step,
        "iterations": iterations,
        "deaths": deaths,
        "saves": saves,
        "ckpt_interval_final_s": round(cadence.interval_s(), 4),
        "ckpt_retunes": cadence.retunes,
        "fault_fires": fires,
        "serve_replicas_final": serving.replicas,
        "serve_queue_peak": round(serving.queue_peak, 1),
        "serve_backlog_end": round(serving.queue, 1),
        "serve_grow_events": serving.grow_events,
        "serve_shrink_events": serving.shrink_events,
        "records_done": records_done,
        "records_expected": cfg.steps * cfg.world,
        "decision_ticks": ticks,
    }
    if onset_wall is not None:
        report["straggler_onset_s"] = round(onset_wall - t0, 3)
    if mitigated_wall is not None and onset_wall is not None:
        report["time_to_mitigate_s"] = round(
            mitigated_wall - onset_wall, 3
        )
        report["mitigate_windows"] = mitigated_tick - (onset_tick or 0)
    report["goodput_attribution"] = perf.goodput_attribution()
    if autoscaler is not None:
        report["decisions"] = [
            d.to_dict() for d in autoscaler.ledger.entries()
        ]
        report["decisions_total"] = autoscaler.ledger.decisions_total
        report["actuations_total"] = autoscaler.ledger.actuations_total
        report["outcomes_attached"] = autoscaler.ledger.outcomes_total
        report["outcome_misses"] = (
            autoscaler.ledger.outcome_misses_total
        )
        if record_path:
            report["record_path"] = record_path
    if failure:
        raise SoakInvariantError(failure)
    return report


def _check_invariants(static: Dict, auto: Dict,
                      plan: AutoscalePlan, cfg: AutoscaleSoakConfig,
                      dry: Optional[Dict] = None):
    """Invariants 1/2/3/5 need only the static+auto pair and always
    run; the dry-run contract (4) is checked when a dry run exists."""
    # Invariant 5: every run drained the dataset exactly once — the
    # MEASURED shard completions equal the dataset size (crash requeues
    # must neither lose nor double-count leases).
    for run in filter(None, (static, dry, auto)):
        if run["records_done"] != run["records_expected"]:
            raise SoakInvariantError(
                f"{run['mode']} run: exactly-once violated — "
                f"{run['records_done']} shard completions vs "
                f"{run['records_expected']} expected"
            )
    if auto["goodput_frac"] <= static["goodput_frac"]:
        raise SoakInvariantError(
            f"closed loop did not pay: autoscaled goodput "
            f"{auto['goodput_frac']} <= static "
            f"{static['goodput_frac']}"
        )
    if "time_to_mitigate_s" not in auto:
        raise SoakInvariantError(
            f"straggler rank {plan.straggler_rank} was never evicted "
            f"(decisions: {[d['action'] for d in auto['decisions']]})"
        )
    if auto["mitigate_windows"] > cfg.mitigate_window_bound:
        raise SoakInvariantError(
            f"straggler mitigation took {auto['mitigate_windows']} "
            f"decision windows (> {cfg.mitigate_window_bound})"
        )
    evicts = [
        d for d in auto["decisions"] if d["action"] == "evict_straggler"
    ]
    if not evicts or evicts[0]["target"] != plan.straggler_rank:
        raise SoakInvariantError(
            f"eviction targeted {evicts and evicts[0]['target']}, "
            f"expected straggler rank {plan.straggler_rank}"
        )
    for run in filter(None, (dry, auto)):
        for d in run["decisions"]:
            if not d["signals"]:
                raise SoakInvariantError(
                    f"unexplained action: decision #{d['seq']} "
                    f"({d['action']}) carries no signal snapshot"
                )
            if d["outcome"].startswith("error"):
                raise SoakInvariantError(
                    f"actuation error in ledger: {d}"
                )
    if not auto["decisions"]:
        raise SoakInvariantError("autoscaled run took no decisions")
    if any(d["outcome"] != "actuated" for d in auto["decisions"]):
        raise SoakInvariantError(
            "autoscaled run recorded non-actuated decisions: "
            f"{[d['outcome'] for d in auto['decisions']]}"
        )
    # §34 outcome coverage: every actuated decision in the autoscaled
    # run carries a realized-outcome annotation (its attribution window
    # resolved in-run, or force-resolved, truncated, at stop).
    unannotated = [
        d["seq"] for d in auto["decisions"]
        if d["outcome"] == "actuated" and "realized" not in d
    ]
    if unannotated:
        raise SoakInvariantError(
            f"actuated decisions without realized outcomes: "
            f"{unannotated}"
        )
    # §34 attribution coverage: ≥90% of the non-train wall time is
    # explained by a taxonomy cause; unattributed is the only residual.
    attribution = auto.get("goodput_attribution") or {}
    attributed = attribution.get("attributed_frac", 0.0)
    if attributed < 0.9:
        raise SoakInvariantError(
            f"goodput attribution too coarse: {attributed:.3f} of "
            f"non-train wall attributed (< 0.9): "
            f"{attribution.get('causes')}"
        )
    # Dry-run contract: same brain, zero hands — a populated ledger
    # whose leading decision matches the live run's, and NO actuations.
    if dry is None:
        return
    if dry["actuations_total"] != 0:
        raise SoakInvariantError(
            f"dry-run actuated {dry['actuations_total']} times"
        )
    if not dry["decisions"]:
        raise SoakInvariantError("dry-run ledger is empty")
    if any(d["outcome"] != "dry_run" for d in dry["decisions"]):
        raise SoakInvariantError(
            "dry-run ledger carries non-dry outcomes: "
            f"{[d['outcome'] for d in dry['decisions']]}"
        )
    d0, a0 = dry["decisions"][0], auto["decisions"][0]
    if (d0["action"], d0["target"]) != (a0["action"], a0["target"]):
        raise SoakInvariantError(
            f"dry-run and live runs diverge on the first decision: "
            f"{(d0['action'], d0['target'])} vs "
            f"{(a0['action'], a0['target'])}"
        )
    # The straggler's delay rule must stop firing once the node is
    # evicted: the live run sees strictly fewer delay injections.
    if (auto["fault_fires"].get("straggler-delay", 0)
            >= static["fault_fires"].get("straggler-delay", 1)):
        raise SoakInvariantError(
            "eviction did not silence the straggler: delay fired "
            f"{auto['fault_fires'].get('straggler-delay')}x live vs "
            f"{static['fault_fires'].get('straggler-delay')}x static"
        )


def perturbed_config(cfg: AutoscaleSoakConfig) -> PolicyConfig:
    """A deliberately passive candidate for the perturb leg: eviction
    needs an unreachable confirmation streak and the fleet band never
    triggers — given the same stream it must decide DIFFERENTLY from
    the live policy (which provably evicted and grew)."""
    return replace(
        _policy_config(cfg),
        straggler_confirm_ticks=10_000,
        fleet_util_grow=1.01,       # util saturates at 1.0: never grows
        fleet_util_shrink=-1.0,     # and never shrinks
        ckpt_retune_frac=10.0,      # dead band swallows every retune
    )


def run_whatif_leg(auto: Dict, cfg: AutoscaleSoakConfig) -> Dict:
    """The §34 record→replay→perturb leg over the autoscaled run's
    recording. Asserts:

    - **identity**: the recorded policy replayed over the recorded
      snapshots reproduces the live decision ledger exactly;
    - **perturbation**: a different PolicyConfig produces a DIFFERENT
      counterfactual ledger, and both score under the goodput model
      (calibrated from this episode's measured actuation costs).
    """
    record_path = auto.get("record_path")
    if not record_path or not os.path.exists(record_path):
        raise SoakInvariantError("autoscaled run produced no recording")
    recording = load_recording(record_path)
    if not recording.snapshots:
        raise SoakInvariantError("recording carries no snapshots")
    if recording.corrupt_lines:
        raise SoakInvariantError(
            f"recording has {recording.corrupt_lines} corrupt lines "
            f"in a run that was never killed"
        )
    try:
        identity = assert_replay_identity(recording)
    except ReplayMismatch as e:
        raise SoakInvariantError(f"replay identity violated: {e}")
    t0 = time.monotonic()
    perturbed = replay_recording(recording, perturbed_config(cfg))
    replay_elapsed = max(time.monotonic() - t0, 1e-9)
    diff = diff_ledgers(recording.decisions, perturbed)
    if diff["identical"]:
        raise SoakInvariantError(
            "perturbed policy replayed IDENTICALLY to the live one — "
            "the counterfactual engine is not counterfactual"
        )
    cost = CostModel(
        rescale_to_first_step_s=cfg.restart_s,
        evict_pause_s=cfg.restart_s,
        save_block_s=cfg.save_block_s,
    )
    recorded_score = score_ledger(
        recording.snapshots, recording.decisions, cost
    )
    perturbed_score = score_ledger(
        recording.snapshots, perturbed, cost
    )
    for name, score in (("recorded", recorded_score),
                        ("perturbed", perturbed_score)):
        frac = score.get("est_goodput_frac")
        if frac is None or not (0.0 <= frac <= 1.0):
            raise SoakInvariantError(
                f"{name} counterfactual ledger not scored: {score}"
            )
    return {
        "whatif_identity_ok": True,
        "whatif_snapshots": len(recording.snapshots),
        "whatif_replay_snapshots_per_s": round(
            len(recording.snapshots) / replay_elapsed, 1
        ),
        "whatif_recorded_decisions": identity["recorded_total"],
        "whatif_perturbed_decisions": diff["replayed_total"],
        "whatif_first_divergence": diff["first_divergence"],
        "whatif_recorded_est_goodput": recorded_score[
            "est_goodput_frac"
        ],
        "whatif_perturbed_est_goodput": perturbed_score[
            "est_goodput_frac"
        ],
    }


def run_autoscale_episode(
    seed: int,
    episode: int = 5,
    cfg: Optional[AutoscaleSoakConfig] = None,
    include_dry_run: bool = True,
    record_dir: Optional[str] = None,
) -> Dict:
    """The full A/B(/C): static, dry-run, autoscaled under one seeded
    schedule; asserts the §30 invariants; then the §34 leg: record the
    autoscaled run, replay it (identity), perturb it (counterfactual).
    Returns a soak-shaped report with the autoscale extras the bench
    keeps."""
    cfg = cfg or AutoscaleSoakConfig()
    plan = build_autoscale_plan(seed, episode, cfg)
    logger.info(
        "autoscale episode s%d e%d: straggler rank %d (onset step %d, "
        "+%.0fms/step), crashes %s",
        seed, episode, plan.straggler_rank, plan.straggler_onset_step,
        plan.straggler_delay_s * 1e3, plan.crash_steps,
    )
    static = run_sim_job("static", seed, episode, cfg)
    dry = (
        run_sim_job("dry_run", seed, episode, cfg)
        if include_dry_run else None
    )
    owned_record_dir = record_dir is None
    if owned_record_dir:
        record_dir = tempfile.mkdtemp(prefix="autoscale-rec-")
    record_path = os.path.join(
        record_dir, f"signals-s{seed}-e{episode}.jsonl"
    )
    try:
        auto = run_sim_job("auto", seed, episode, cfg,
                           record_path=record_path)
        _check_invariants(static, auto, plan, cfg, dry=dry)
        whatif = run_whatif_leg(auto, cfg)
    finally:
        if owned_record_dir:
            # Caller gave us nowhere durable to put it: the replay leg
            # has consumed the recording, don't leak ~MBs per episode.
            shutil.rmtree(record_dir, ignore_errors=True)
    report: Dict = {
        "episode": episode,
        "seed": seed,
        "kind": "straggler_evict",
        # soak report schema (run_soak aggregates these): wall/productive
        # describe the AUTOSCALED run — the static and dry-run halves of
        # the A/B are reference runs, not the episode's goodput story.
        "wall_s": auto["wall_s"],
        "ab_wall_s": round(static["wall_s"] + auto["wall_s"]
                           + (dry["wall_s"] if dry else 0.0), 3),
        "productive_step_s": auto["productive_step_s"],
        "goodput_frac": auto["goodput_frac"],
        "deaths": auto["deaths"],
        "recovery_s": [],
        "steps_unique": auto["steps"],
        "steps_executed": auto["iterations"],
        "generations": 1,
        "faults": [
            {"origin": "sim", "rule_id": rid, "fires": n,
             "point": "agent.worker.crash",
             "action": ("delay" if rid == "straggler-delay"
                        else "raise"),
             "hit": n}
            for rid, n in sorted(auto["fault_fires"].items())
        ],
        # the autoscale A/B headline
        "autoscale_goodput_frac": auto["goodput_frac"],
        "static_goodput_frac": static["goodput_frac"],
        "autoscale_decisions_total": auto["decisions_total"],
        "autoscale_actuations_total": auto["actuations_total"],
        "autoscale_time_to_mitigate_s": auto.get("time_to_mitigate_s"),
        "autoscale_mitigate_windows": auto.get("mitigate_windows"),
        "autoscale_ckpt_interval_s": auto["ckpt_interval_final_s"],
        "autoscale_ckpt_retunes": auto["ckpt_retunes"],
        "autoscale_stall_s": auto["stall_s"],
        "static_stall_s": static["stall_s"],
        "autoscale_replay_s": auto["replay_s"],
        "static_replay_s": static["replay_s"],
        "autoscale_serve_backlog_end": auto["serve_backlog_end"],
        "static_serve_backlog_end": static["serve_backlog_end"],
        "autoscale_serve_replicas_final": auto["serve_replicas_final"],
        "autoscale_fleet_grow_events": auto["serve_grow_events"],
        "autoscale_fleet_shrink_events": auto["serve_shrink_events"],
        # §34: outcome coverage + per-cause attribution + what-if leg
        "autoscale_outcomes_attached": auto["outcomes_attached"],
        "autoscale_outcome_misses": auto["outcome_misses"],
        "goodput_attributed_frac": auto["goodput_attribution"][
            "attributed_frac"
        ],
        "goodput_causes": {
            c: v["frac"]
            for c, v in auto["goodput_attribution"]["causes"].items()
        },
        **whatif,
        "invariants": "pass",
    }
    if dry is not None:
        report["dry_run_decisions_total"] = dry["decisions_total"]
        report["dry_run_actuations_total"] = dry["actuations_total"]
    return report
