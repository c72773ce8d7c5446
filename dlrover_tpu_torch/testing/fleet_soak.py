"""Fleet chaos episode: replica SIGKILL mid-decode, re-route, recover.

The ``replica_kill_reroute`` episode kind (chaos soak episode 4): a
:class:`~dlrover_tpu_torch.serving.fleet.router.FleetRouter` over N
subprocess replicas serves a seeded Poisson-ish request stream while a
deterministic fault schedule SIGKILLs one replica between engine
iterations with requests live in its slots (``fleet.replica.step``
crash rule, armed through the standard env rigging so the fault trace
survives the kill). After the stream drains, the **fleet invariant** is
asserted:

    every accepted request completes or is explicitly failed exactly
    once — zero duplicate completions, zero silently lost — and the
    router's health FSM marked the killed replica BROKEN then re-
    admitted it after half-open probes succeeded.

Randomness lives in plan generation (`random.Random(seed, episode)`),
kill timing in the deterministic hit counter — one seed reproduces one
episode, the PR-5 contract.

The port's copy of ``dlrover_tpu/testing/fleet_soak.py``: its schedules
equal the reference's for every seed. ``FleetSoakConfig`` gains
``device`` (``cuda`` by default, or ``cpu``) and ``config`` (``tiny``,
the reference's model, or ``flagship``), which every
``SubprocessReplica`` of an episode takes, so the replicas decode
through the paged kernel on the card. Each report also carries every
replica generation's start (its ready line: pid, device, seconds to
ready), the decode-kernel launches the replicas' heartbeats counted,
and the seconds from the victim's breaker opening to its re-admission
(``replica_starts``, ``launches``, ``victim_recovery_s``).
"""

import os
import random
import shutil
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.fault import FaultRule, FaultSchedule, arm, disarm
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.serving.fleet import (
    BROKEN,
    HALF_OPEN,
    HEALTHY,
    FleetRouter,
    HealthPolicy,
    RouterConfig,
    SubprocessReplica,
)
from dlrover_tpu_torch.testing.soak import SoakInvariantError, _read_trace


@dataclass
class FleetSoakConfig:
    replicas: int = 2
    requests: int = 12
    new_tokens_short: int = 4
    new_tokens_long: int = 10
    slots: int = 2
    max_len: int = 64
    prefill_chunk: int = 8
    watchdog_s: float = 180.0
    keep_artifacts_on_success: bool = False
    # Paged-KV replicas (§31): heartbeats then carry allocator stats
    # and the episode asserts the BLOCK-RECLAIM invariant — after the
    # mid-run kill and reroute, free+used+cached blocks still sum to
    # the managed pool on every replica and no refcount went negative
    # (a block leak under crash is a regression from day one).
    paged: bool = True
    block_size: int = 8
    # Where every replica's engine runs ("cuda" or "cpu") and the model
    # it serves ("tiny" or "flagship"): SubprocessReplica's own.
    device: str = "cuda"
    config: str = "tiny"


def build_fleet_schedules(
    seed: int, episode: int, cfg: Optional[FleetSoakConfig] = None
) -> Dict[str, FaultSchedule]:
    """Deterministic per-replica schedules for (seed, episode): the
    victim replica is SIGKILLed on its Nth serve-loop iteration WITH
    work pending (the fault point sits inside the ``engine.pending()``
    branch, so hit N always lands mid-decode)."""
    cfg = cfg or FleetSoakConfig()
    ep_seed = seed * 10007 + episode
    rng = random.Random(ep_seed ^ 0xF1EE7)
    victim = str(rng.randrange(cfg.replicas))
    # Late enough that requests are decoding, early enough that the
    # kill always fires before the stream drains.
    kill_nth = rng.randint(4, 10)
    schedules = {
        victim: FaultSchedule([
            FaultRule("fleet.replica.step", action="crash",
                      nth=kill_nth, rule_id="replica-sigkill"),
        ], seed=ep_seed, label=f"replica{victim}"),
    }
    return schedules


def build_migration_schedules(
    seed: int, episode: int, cfg: Optional[FleetSoakConfig] = None
) -> Dict[str, FaultSchedule]:
    """Deterministic schedule for ``kill_during_migration`` (seed,
    episode): the DESTINATION decode replica (always replica 1 in the
    two-replica prefill+decode topology) is SIGKILLed at the
    ``fleet.replica.import`` fault point — after the source exported
    the KV payload, before the import ack is emitted. The nth import
    it dies on is the seeded part."""
    cfg = cfg or FleetSoakConfig()
    ep_seed = seed * 10007 + episode
    rng = random.Random(ep_seed ^ 0x3160)
    victim = "1"  # the decode tier of the 2-replica split topology
    kill_nth = rng.randint(1, 3)
    return {
        victim: FaultSchedule([
            FaultRule("fleet.replica.import", action="crash",
                      nth=kill_nth, rule_id="dst-sigkill-mid-import"),
        ], seed=ep_seed, label=f"replica{victim}"),
    }


def run_fleet_episode(
    seed: int,
    episode: int = 4,
    cfg: Optional[FleetSoakConfig] = None,
    work_dir: Optional[str] = None,
    artifact_dir: Optional[str] = None,
    runner_schedule: Optional[FaultSchedule] = None,
) -> Dict:
    """One replica_kill_reroute episode; returns a soak-shaped report.
    Raises SoakInvariantError (artifacts kept) on violation."""
    import tempfile

    cfg = cfg or FleetSoakConfig()
    work_dir = work_dir or tempfile.mkdtemp(prefix="dlrover_fleet_")
    artifact_dir = artifact_dir or os.path.join(work_dir, "artifacts")
    ep_dir = os.path.join(work_dir, f"fleet-s{seed}-e{episode}")
    shutil.rmtree(ep_dir, ignore_errors=True)
    os.makedirs(ep_dir, exist_ok=True)
    ep_seed = seed * 10007 + episode
    rng = random.Random(ep_seed ^ 0x5EED)
    schedules = build_fleet_schedules(seed, episode, cfg)
    victim = next(iter(schedules))

    schedule_paths: Dict[str, str] = {}
    for rid, sched in schedules.items():
        path = os.path.join(ep_dir, f"schedule_replica{rid}.json")
        with open(path, "w") as f:
            f.write(sched.to_json())
        schedule_paths[rid] = path

    from dlrover_tpu_torch.observability.registry import MetricsRegistry

    registry = MetricsRegistry()
    # Tracing is part of the episode's proof surface (§29): the router
    # traces into its own sink, each replica subprocess into its own
    # (rigged through the env by SubprocessReplica.start), and the
    # trace invariant below reads the merged files.
    prev_tracer = tracing.active_tracer()
    router_sink = os.path.join(ep_dir, "spans_router.jsonl")
    tracing.arm(tracing.Tracer(service="router", sink_path=router_sink))

    def _restore_tracer():
        tracing.disarm()
        if prev_tracer is not None:
            tracing.arm(prev_tracer)

    try:
        replicas = [
            SubprocessReplica(
                str(i), ep_dir,
                slots=cfg.slots, max_len=cfg.max_len,
                prefill_chunk=cfg.prefill_chunk,
                paged=cfg.paged, block_size=cfg.block_size,
                device=cfg.device, config=cfg.config,
                # Per-generation: the victim's SIGKILL schedule arms
                # only generation 0 — its post-restart generations run
                # clean, so the half-open probes can actually succeed.
                schedule_path=(
                    [schedule_paths[str(i)]]
                    if str(i) in schedule_paths else ""
                ),
            )
            for i in range(cfg.replicas)
        ]
        router = FleetRouter(
            replicas,
            RouterConfig(
                max_retries=3,
                seed=ep_seed,
                health=HealthPolicy(
                    heartbeat_timeout_s=2.0,
                    probe_cooldown_s=0.5,
                    probe_successes=2,
                ),
            ),
            registry=registry,
        )
    except BaseException:
        # Construction failed before the run's own finally could take
        # over: the episode tracer must not stay armed process-wide.
        _restore_tracer()
        raise
    if runner_schedule is not None:
        arm(runner_schedule)

    health_seen = {rid: set() for rid in router._replicas}  # noqa: SLF001

    victim_marks: Dict[str, float] = {}

    def note_health():
        for rid in health_seen:
            health_seen[rid].add(router.health_state(rid))
        _mark_victim(router.health_state(victim), victim_marks)

    t_start = time.time()
    deadline = t_start + cfg.watchdog_s
    accepted: List = []
    failure: Optional[str] = None
    vocab_hi = 100  # tiny llama vocab is larger; any id >= 1 works
    try:
        router.start(timeout_s=min(120.0, cfg.watchdog_s))
        to_submit = [
            (
                [rng.randint(1, vocab_hi) for _ in
                 range(rng.randint(4, 10))],
                cfg.new_tokens_long if rng.random() < 0.5
                else cfg.new_tokens_short,
            )
            for _ in range(cfg.requests)
        ]
        while to_submit or router.pending():
            if time.time() > deadline:
                failure = "watchdog: fleet episode deadline exceeded"
                break
            if to_submit:
                prompt, new = to_submit.pop(0)
                accepted.append(router.submit(prompt, new))
            router.step()
            note_health()
            time.sleep(0.005)
        # Recovery half: keep trickling traffic until the victim's
        # breaker walks BROKEN -> HALF_OPEN -> HEALTHY again.
        while not failure and router.health_state(victim) != HEALTHY:
            if time.time() > deadline:
                failure = (
                    f"watchdog: victim replica {victim} never "
                    f"re-admitted (stuck {router.health_state(victim)})"
                )
                break
            if router.pending() == 0:
                accepted.append(router.submit(
                    [rng.randint(1, vocab_hi) for _ in range(5)],
                    cfg.new_tokens_short,
                ))
            router.step()
            note_health()
            time.sleep(0.005)
        if not failure:
            try:
                router.run_until_idle(
                    timeout_s=max(1.0, deadline - time.time())
                )
            except TimeoutError as e:
                failure = f"watchdog: {e}"
    finally:
        if runner_schedule is not None:
            disarm()
        router.stop()
        _restore_tracer()

    wall = time.time() - t_start
    report: Dict = {
        "episode": episode,
        "seed": seed,
        "kind": "replica_kill_reroute",
        "wall_s": round(wall, 3),
        "victim": victim,
        "requests": len(accepted),
    }
    import glob as glob_lib

    episode_spans = tracing.load_spans(
        [router_sink]
        + sorted(glob_lib.glob(os.path.join(ep_dir, "spans_replica*.jsonl")))
    )
    try:
        if failure:
            raise SoakInvariantError(failure)
        _check_fleet_invariant(
            accepted, router, registry, victim, health_seen
        )
        if cfg.paged:
            kv_final = _check_block_reclaim(replicas, victim)
            report["kv_blocks"] = kv_final
        trace_stats = _check_trace_invariant(
            episode_spans,
            require_reroute=registry.get(
                "fleet_reroutes_total"
            ).value() >= 1,
        )
    except SoakInvariantError as e:
        dest = _dump_artifacts(
            ep_dir, artifact_dir, schedules, seed, episode, str(e)
        )
        logger.error(
            "FLEET EPISODE FAILED: %s\n  artifacts: %s", e, dest
        )
        raise
    # ---- goodput-shaped accounting (soak report schema) ---------------
    results = [r.result for r in accepted if r.result is not None]
    completed = [r for r in results if r.ok]
    report.update({
        "productive_step_s": round(sum(
            r.latency_s or 0.0 for r in completed
        ), 3),
        "goodput_frac": round(
            len(completed) / max(len(results), 1), 4
        ),
        "completed": len(completed),
        "failed": len(results) - len(completed),
        "reroutes": int(
            registry.get("fleet_reroutes_total").value()
        ),
        "retries": int(registry.get("fleet_retries_total").value()),
        "duplicates": int(
            registry.get("fleet_duplicate_completions_total").value()
        ),
        "stale": int(
            registry.get("fleet_stale_completions_total").value()
        ),
        "restarts": int(
            registry.get("fleet_replica_restarts_total").value()
        ),
        "deaths": 1,
        "recovery_s": [],
        **_replica_report(replicas, victim_marks),
        "steps_unique": len(completed),
        "steps_executed": len(results),
        "trace_spans": len(episode_spans),
        "trace_rerouted_trees": trace_stats["rerouted_trees"],
        "trace_phase_sum_checked": trace_stats["phase_sum_checked"],
        "faults": [
            t
            for rid in schedules
            for t in _read_trace(
                os.path.join(ep_dir, f"trace_replica{rid}.jsonl"),
                f"replica{rid}",
            )
        ],
    })
    if not cfg.keep_artifacts_on_success:
        shutil.rmtree(ep_dir, ignore_errors=True)
    return report


def run_migration_episode(
    seed: int,
    episode: int = 6,
    cfg: Optional[FleetSoakConfig] = None,
    work_dir: Optional[str] = None,
    artifact_dir: Optional[str] = None,
    runner_schedule: Optional[FaultSchedule] = None,
) -> Dict:
    """One ``kill_during_migration`` episode (§36): a prefill+decode
    split fleet serves a seeded stream, and the DESTINATION replica is
    SIGKILLed between the source's export and the import ack — the
    moment a migrating request's KV payload exists on the wire but
    nowhere durable. Asserted afterwards:

    - **exactly-once**: every accepted request completes or fails
      exactly once — the killed import's request finishes on its
      never-released SOURCE (option-B fallback), no duplicates;
    - **zero lost blocks**: block conservation holds on every replica
      at every heartbeat, across the victim's kill and restart;
    - **the window actually fired** (fault trace) and the fleet
      healed: victim walked BROKEN -> HALF_OPEN -> HEALTHY, and at
      least one migration SUCCEEDED after the restart (decode-role
      breakers are probed by migration traffic, so the success IS the
      probe).

    Raises SoakInvariantError (artifacts kept) on violation."""
    import tempfile

    cfg = cfg or FleetSoakConfig()
    work_dir = work_dir or tempfile.mkdtemp(prefix="dlrover_migsoak_")
    artifact_dir = artifact_dir or os.path.join(work_dir, "artifacts")
    ep_dir = os.path.join(work_dir, f"mig-s{seed}-e{episode}")
    shutil.rmtree(ep_dir, ignore_errors=True)
    os.makedirs(ep_dir, exist_ok=True)
    ep_seed = seed * 10007 + episode
    rng = random.Random(ep_seed ^ 0x5EED)
    schedules = build_migration_schedules(seed, episode, cfg)
    victim = next(iter(schedules))

    schedule_paths: Dict[str, str] = {}
    for rid, sched in schedules.items():
        path = os.path.join(ep_dir, f"schedule_replica{rid}.json")
        with open(path, "w") as f:
            f.write(sched.to_json())
        schedule_paths[rid] = path

    from dlrover_tpu_torch.observability.registry import MetricsRegistry

    registry = MetricsRegistry()
    prev_tracer = tracing.active_tracer()
    router_sink = os.path.join(ep_dir, "spans_router.jsonl")
    tracing.arm(tracing.Tracer(service="router", sink_path=router_sink))

    def _restore_tracer():
        tracing.disarm()
        if prev_tracer is not None:
            tracing.arm(prev_tracer)

    try:
        replicas = [
            SubprocessReplica(
                str(i), ep_dir,
                slots=cfg.slots, max_len=cfg.max_len,
                prefill_chunk=cfg.prefill_chunk,
                paged=True, block_size=cfg.block_size,
                device=cfg.device, config=cfg.config,
                role="prefill" if i == 0 else "decode",
                # Generation 0 only: post-restart generations run
                # clean so re-admission probes can succeed.
                schedule_path=(
                    [schedule_paths[str(i)]]
                    if str(i) in schedule_paths else ""
                ),
            )
            for i in range(2)
        ]
        router = FleetRouter(
            replicas,
            RouterConfig(
                max_retries=3,
                seed=ep_seed,
                # Short enough that the killed import's pending entry
                # is pruned (reason="timeout") within the episode.
                migration_timeout_s=2.0,
                health=HealthPolicy(
                    heartbeat_timeout_s=2.0,
                    probe_cooldown_s=0.5,
                    probe_successes=2,
                ),
            ),
            registry=registry,
        )
    except BaseException:
        _restore_tracer()
        raise
    if runner_schedule is not None:
        arm(runner_schedule)

    health_seen = {rid: set() for rid in router._replicas}  # noqa: SLF001

    victim_marks: Dict[str, float] = {}

    def note_health():
        for rid in health_seen:
            health_seen[rid].add(router.health_state(rid))
        _mark_victim(router.health_state(victim), victim_marks)

    def migrations_ok() -> int:
        return int(registry.get("fleet_migrations_total").value())

    t_start = time.time()
    deadline = t_start + cfg.watchdog_s
    accepted: List = []
    failure: Optional[str] = None
    vocab_hi = 100
    try:
        router.start(timeout_s=min(120.0, cfg.watchdog_s))
        to_submit = [
            (
                [rng.randint(1, vocab_hi) for _ in
                 range(rng.randint(4, 10))],
                cfg.new_tokens_long if rng.random() < 0.5
                else cfg.new_tokens_short,
            )
            for _ in range(cfg.requests)
        ]
        while to_submit or router.pending():
            if time.time() > deadline:
                failure = "watchdog: migration episode deadline exceeded"
                break
            if to_submit:
                prompt, new = to_submit.pop(0)
                accepted.append(router.submit(prompt, new))
            router.step()
            note_health()
            time.sleep(0.005)
        # Recovery half: keep feeding prompts (they prefill on replica
        # 0 and try to migrate) until the victim's breaker closes AND
        # a post-kill migration has actually succeeded — migration
        # traffic is the decode tier's probe path.
        while not failure and (
            router.health_state(victim) != HEALTHY or migrations_ok() < 1
        ):
            if time.time() > deadline:
                failure = (
                    f"watchdog: victim {victim} never re-admitted via "
                    f"migration probes (state "
                    f"{router.health_state(victim)}, "
                    f"migrations_ok={migrations_ok()})"
                )
                break
            if router.pending() == 0:
                accepted.append(router.submit(
                    [rng.randint(1, vocab_hi) for _ in range(5)],
                    cfg.new_tokens_short,
                ))
            router.step()
            note_health()
            time.sleep(0.005)
        if not failure:
            try:
                router.run_until_idle(
                    timeout_s=max(1.0, deadline - time.time())
                )
            except TimeoutError as e:
                failure = f"watchdog: {e}"
    finally:
        if runner_schedule is not None:
            disarm()
        router.stop()
        _restore_tracer()

    wall = time.time() - t_start
    report: Dict = {
        "episode": episode,
        "seed": seed,
        "kind": "kill_during_migration",
        "wall_s": round(wall, 3),
        "victim": victim,
        "requests": len(accepted),
    }
    import glob as glob_lib

    episode_spans = tracing.load_spans(
        [router_sink]
        + sorted(glob_lib.glob(
            os.path.join(ep_dir, "spans_replica*.jsonl")
        ))
    )
    try:
        if failure:
            raise SoakInvariantError(failure)
        _check_fleet_invariant(
            accepted, router, registry, victim, health_seen
        )
        kv_final = _check_block_reclaim(replicas, victim)
        report["kv_blocks"] = kv_final
        # §36 phase-sum law on REAL migrated requests: queue + prefill
        # + migrate + decode ≈ e2e, and at least one verified tree
        # must actually carry the migrate phase — this episode is the
        # one place migrations are guaranteed to have happened.
        report["trace"] = _check_trace_invariant(
            episode_spans,
            require_reroute=registry.get(
                "fleet_reroutes_total"
            ).value() >= 1,
            require_migrate=True,
        )
        # Migration-specific law: the kill window fired (the victim's
        # fault trace says so), the orphaned import was accounted as a
        # failure (timeout or send-error — never a silent loss), and a
        # migration completed end-to-end afterwards.
        fault_trace = _read_trace(
            os.path.join(ep_dir, f"trace_replica{victim}.jsonl"),
            f"replica{victim}",
        )
        fired = [
            t for t in fault_trace
            if t.get("point") == "fleet.replica.import"
            and t.get("action") == "crash"
        ]
        if not fired:
            raise SoakInvariantError(
                "kill_during_migration: the import-window SIGKILL "
                "never fired — the episode tested nothing"
            )
        fails = sum(
            v for _n, _l, v in registry.get(
                "fleet_migration_failures_total"
            ).samples()
        )
        if fails < 1:
            raise SoakInvariantError(
                "destination died holding an unacked import but no "
                "migration failure was recorded"
            )
        if migrations_ok() < 1:
            raise SoakInvariantError(
                "no migration succeeded after the victim's restart"
            )
    except SoakInvariantError as e:
        dest = _dump_artifacts(
            ep_dir, artifact_dir, schedules, seed, episode, str(e)
        )
        logger.error(
            "MIGRATION EPISODE FAILED: %s\n  artifacts: %s", e, dest
        )
        raise
    results = [r.result for r in accepted if r.result is not None]
    completed = [r for r in results if r.ok]
    report.update({
        "productive_step_s": round(sum(
            r.latency_s or 0.0 for r in completed
        ), 3),
        "goodput_frac": round(
            len(completed) / max(len(results), 1), 4
        ),
        "completed": len(completed),
        "failed": len(results) - len(completed),
        "migrations": migrations_ok(),
        "migration_failures": int(sum(
            v for _n, _l, v in registry.get(
                "fleet_migration_failures_total"
            ).samples()
        )),
        "restarts": int(
            registry.get("fleet_replica_restarts_total").value()
        ),
        "duplicates": int(
            registry.get("fleet_duplicate_completions_total").value()
        ),
        "deaths": 1,
        "recovery_s": [],
        **_replica_report(replicas, victim_marks),
        "steps_unique": len(completed),
        "steps_executed": len(results),
        "faults": [
            t
            for rid in schedules
            for t in _read_trace(
                os.path.join(ep_dir, f"trace_replica{rid}.jsonl"),
                f"replica{rid}",
            )
        ],
    })
    if not cfg.keep_artifacts_on_success:
        shutil.rmtree(ep_dir, ignore_errors=True)
    return report


def _mark_victim(state, marks: Dict[str, float]):
    """The victim's first BROKEN and its first HEALTHY after it."""
    if state == BROKEN:
        marks.setdefault("broken", time.monotonic())
    elif state == HEALTHY and "broken" in marks:
        marks.setdefault("healthy", time.monotonic())


def _replica_report(replicas, victim_marks: Dict[str, float]) -> Dict:
    """What the port's report adds to the reference's: each replica's
    generations as their ready lines gave them (pid, device, seconds
    from spawn to ready), the decode-kernel launches their last
    heartbeats counted, summed over replicas and generations, and the
    seconds from the victim's breaker opening to its re-admission."""
    launches: Dict[str, int] = {}
    for replica in replicas:
        for counts in replica.launches.values():
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + int(n)
    recovery = None
    if "healthy" in victim_marks:
        recovery = round(victim_marks["healthy"] - victim_marks["broken"], 3)
    return {
        "replica_starts": {r.replica_id: list(r.starts) for r in replicas},
        "launches": launches,
        "victim_recovery_s": recovery,
    }


def _check_trace_invariant(spans, require_reroute: bool,
                           require_migrate: bool = False) -> Dict:
    """The §29 trace proof: (a) a rerouted request's tree shows the
    failed attempt and the retry as SIBLING spans under one
    fleet.request root; (b) the lifecycle child spans — queue-wait +
    prefill (+ migrate, when the fleet moved the request's KV between
    tiers, §36) + decode — sum to the serving.request e2e duration
    within 10%: the phases TILE the request, so the migrate row in
    ``trace_query.py --serving`` is an honest share of request time,
    not an overlap artifact. With ``require_migrate`` at least one
    phase-sum-verified tree must carry a ``serving.migrate`` child."""
    rerouted = 0
    migrate_checked = 0
    for tree in tracing.build_trees(spans):
        if tree.get("name") != "fleet.request":
            continue
        attempts = [
            c for c in tree["children"] if c.get("name") == "fleet.attempt"
        ]
        failed = [a for a in attempts if a.get("status") == "error"]
        won = [a for a in attempts if a.get("status") == "ok"]
        if len(attempts) >= 2 and failed and won:
            rerouted += 1
    if require_reroute and rerouted == 0:
        raise SoakInvariantError(
            "requests were rerouted but no trace tree shows a failed "
            "attempt and a retry as sibling spans"
        )
    checked = 0
    for record in spans:
        if record.get("name") != "serving.request":
            continue
        if record.get("status") != "ok" or not record.get("dur_s"):
            continue
        children = [
            s for s in spans
            if s.get("parent_id") == record.get("span_id")
            and s.get("dur_s") is not None
        ]
        if len(children) < 3:
            continue  # shed/failed partial trees don't carry all phases
        phase_sum = sum(s["dur_s"] for s in children)
        e2e = record["dur_s"]
        if abs(phase_sum - e2e) > max(0.1 * e2e, 0.005):
            raise SoakInvariantError(
                f"trace {record.get('trace_id')}: queue-wait + prefill "
                f"(+ migrate) + decode sum {phase_sum:.4f}s vs e2e "
                f"{e2e:.4f}s — phases no longer partition the request"
            )
        checked += 1
        if any(s.get("name") == "serving.migrate" for s in children):
            migrate_checked += 1
    if checked == 0:
        raise SoakInvariantError(
            "no completed serving.request span carried its full "
            "queue-wait/prefill/decode phase tree"
        )
    if require_migrate and migrate_checked == 0:
        raise SoakInvariantError(
            "migrations ran but no phase-sum-verified serving.request "
            "tree carries a serving.migrate child span"
        )
    return {
        "rerouted_trees": rerouted,
        "phase_sum_checked": checked,
        "migrate_phase_checked": migrate_checked,
    }


def _check_block_reclaim(replicas, victim) -> Dict:
    """The §31 block-reclaim invariant: every paged replica reported
    allocator stats, none EVER violated conservation (free+used+cached
    == managed pool, checked at each heartbeat's receipt) or went
    refcount-negative — including the victim across its SIGKILL and
    restart, whose post-restart generations must report again."""
    final: Dict = {}
    for replica in replicas:
        rid = replica.replica_id
        if replica.kv_violation is not None:
            raise SoakInvariantError(
                f"block-reclaim invariant violated: "
                f"{replica.kv_violation}"
            )
        kv = replica.last_kv
        if not kv:
            raise SoakInvariantError(
                f"paged replica {rid} never reported allocator stats "
                f"on its heartbeats"
            )
        final[rid] = {
            k: kv.get(k) for k in ("total", "free", "used", "cached")
        }
        if kv["free"] + kv["used"] + kv["cached"] != kv["total"]:
            raise SoakInvariantError(
                f"replica {rid} final block accounting broken: {kv}"
            )
    # The victim respawned at least once: its reporting generation is
    # post-kill, so a leak across the crash would have surfaced either
    # as a survivor's violation (rerouted work) or a missing report.
    if victim not in final:
        raise SoakInvariantError(
            f"victim replica {victim} has no final allocator stats"
        )
    return final


def _check_fleet_invariant(accepted, router, registry, victim,
                           health_seen):
    """Every accepted request: exactly one terminal result; victim
    walked BROKEN -> HALF_OPEN -> HEALTHY; the fault actually fired."""
    silent = [
        r.request_id for r in accepted
        if r.accepted and r.result is None
    ]
    if silent:
        raise SoakInvariantError(
            f"fleet requests neither completed nor explicitly failed: "
            f"{silent}"
        )
    # Exactly-once is structural (one result slot per request_id); what
    # can drift is a completion recorded twice into metrics. Cross-check
    # the counters: completed + failed == terminal results.
    results = [r.result for r in accepted if r.result is not None]
    ok = sum(1 for r in results if r.ok)
    failed = sum(1 for r in results if not r.ok)
    m_completed = registry.get("fleet_requests_total").value(
        outcome="completed"
    )
    m_failed = registry.get("fleet_requests_total").value(
        outcome="failed"
    )
    m_shed = registry.get("fleet_requests_total").value(outcome="shed")
    if m_completed != ok or m_failed + m_shed != failed:
        raise SoakInvariantError(
            f"completion accounting drift: results ok={ok} "
            f"failed={failed} vs metrics completed={m_completed} "
            f"failed={m_failed} shed={m_shed} — a duplicate or lost "
            f"record"
        )
    for r in results:
        if not r.ok and not r.failure_reason:
            raise SoakInvariantError(
                f"request {r.request_id} failed without a "
                f"machine-readable reason"
            )
    seen = health_seen[victim]
    if BROKEN not in seen:
        raise SoakInvariantError(
            f"victim replica {victim} was never marked broken "
            f"(states seen: {sorted(seen)})"
        )
    if HALF_OPEN not in seen:
        raise SoakInvariantError(
            f"victim replica {victim} never reached half_open probes "
            f"(states seen: {sorted(seen)})"
        )
    if router.health_state(victim) != HEALTHY:
        raise SoakInvariantError(
            f"victim replica {victim} not re-admitted: "
            f"{router.health_state(victim)}"
        )
    if registry.get("fleet_replica_restarts_total").value() < 1:
        raise SoakInvariantError("victim replica was never restarted")


def _dump_artifacts(ep_dir, artifact_dir, schedules, seed, episode,
                    reason) -> str:
    import glob
    import json

    os.makedirs(artifact_dir, exist_ok=True)
    dest = os.path.join(artifact_dir, f"fleet_seed{seed}_ep{episode}")
    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(dest, exist_ok=True)
    for src in glob.glob(os.path.join(ep_dir, "replica*_gen*.log")):
        shutil.copy(src, dest)
    for src in glob.glob(os.path.join(ep_dir, "trace_replica*.jsonl")):
        shutil.copy(src, dest)
    for src in glob.glob(os.path.join(ep_dir, "spans_*.jsonl")):
        shutil.copy(src, dest)
    for rid, sched in schedules.items():
        with open(
            os.path.join(dest, f"schedule_replica{rid}.json"), "w"
        ) as f:
            f.write(sched.to_json())
    with open(os.path.join(dest, "failure.json"), "w") as f:
        json.dump({
            "seed": seed, "episode": episode,
            "kind": "replica_kill_reroute", "reason": reason,
        }, f, indent=2)
    return dest
