"""Live-rescale soak runner: N workers, seeded faults, rescale invariants.

One episode = an in-process master carrying the full rescale plane
(:class:`RescaleCoordinator` + task manager + KV store + servicer over
HTTP) and N :mod:`rescale_worker` subprocesses. Scenarios:

- ``live`` — train at world N, SIGKILL one worker, assert the survivors
  rescale to N-1 **in-process** (no respawn), then spawn a fresh worker
  that joins mid-run and scales the world back to N. The acceptance
  test for the "no job restart" claim.
- ``kill_during_rescale`` — a worker dies mid-step (plan #2 is cut),
  and a second worker is SIGKILLed inside the restore-to-first-step
  window of that plan (the ``rescale.resume.first_step`` fault site);
  the coordinator must re-plan around it and the respawned generation
  must finish the dataset. Runs as chaos-soak episode kind 4.

Invariants asserted after every episode (docs/DESIGN.md §26, with a
fifth for the rescale):

1. **Exactly-once** — every finishing worker's final state equals the
   whole-dataset reference (no shard lost or double-consumed), and all
   replicas are bit-identical.
2. **Reference-replay bit-exactness** — for every checkpoint save, the
   state CRC equals a single-host replay over exactly the shards the
   save's shard snapshot marks consumed; every restore's CRC equals the
   corresponding save's.
3. **Live process tree** — in the ``live`` scenario the surviving
   ranks' processes never restart (one generation each).
4. **Watchdog** — the episode is wall-clock bounded.

The port's copy of ``dlrover_tpu/testing/rescale_soak.py``. The workers
hold their state on ``RescaleSoakConfig.device`` (``cuda`` unless asked
for ``cpu``); the report also carries the merged ledger (``events``) and
each plan the coordinator cut with its phase barriers' waits
(``plans_cut``). A respawned worker is a pre-spawned warm standby
(``agent/standby.py``) when one is alive (``adopted``): the reference
respawns cold, which on a card host (seconds of ``import torch``) lets
the scaled-down survivor finish the epoch before the joiner arrives. The
kill-during-rescale schedules come from the caller (``rank_schedules``,
``runner_schedule``): the seeded soak (``testing/soak.py``, episode 3)
builds them.
"""

import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.fault import FaultRule, FaultSchedule, arm, disarm
from dlrover_tpu_torch.fault.registry import SCHEDULE_ENV, TRACE_ENV
from dlrover_tpu_torch.testing import rescale_worker as rw
from dlrover_tpu_torch.testing.soak import (
    SoakInvariantError,
    _read_events,
    _read_trace,
    _repo_root,
    episode_job_name,
    reclaim_shm_segments,
)


@dataclass
class RescaleSoakConfig:
    world: int = 2
    dataset_size: int = 192
    shard_size: int = 16
    ckpt_every: int = 2
    vec_len: int = 64
    step_ms: float = 0.0
    watchdog_s: float = 150.0
    barrier_timeout_s: float = 20.0
    task_timeout_s: float = 60.0
    keep_artifacts_on_success: bool = False
    device: str = "cuda"


@dataclass
class _Runner:
    """Master-side state for one episode."""

    server: object
    coordinator: object
    task_manager: object
    port: int
    ep_dir: str
    cfg: RescaleSoakConfig
    procs: Dict[int, subprocess.Popen] = field(default_factory=dict)
    generations: Dict[int, int] = field(default_factory=dict)
    deaths: List[Dict] = field(default_factory=list)
    plans: List[object] = field(default_factory=list)
    standby: Optional[subprocess.Popen] = None
    adopted: List[Dict] = field(default_factory=list)


def expected_ranges(dataset_size: int, shard_size: int):
    return [
        (s, min(s + shard_size, dataset_size))
        for s in range(0, dataset_size, shard_size)
    ]


def _events_path(ep_dir: str, rank: int) -> str:
    return os.path.join(ep_dir, f"events_r{rank}.jsonl")


_WORKER_MODULE = "dlrover_tpu_torch.testing.rescale_worker"


def _worker_env(r: _Runner) -> Dict[str, str]:
    """The environment every worker (and standby) of the episode gets."""
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "1")
    env.update({
        # A kill landing while this worker is the commit leader must
        # cost a short wait, not 30s of blindness to the rescale plan.
        "DLROVER_TPU_CKPT_COMMIT_TIMEOUT_S": "5",
        "DLROVER_TPU_JOB_NAME": episode_job_name(r.ep_dir),
        "DLROVER_TPU_FLIGHT_DIR": os.path.join(r.ep_dir, "flight"),
        "PYTHONPATH": _repo_root() + os.pathsep + env.get("PYTHONPATH", ""),
    })
    env.pop(SCHEDULE_ENV, None)
    return env


def _spawn_standby(r: _Runner) -> None:
    """Pre-spawn the next worker's interpreter (``agent/standby.py``:
    python and ``import torch`` paid, no CUDA context) for the next
    respawn to adopt: a joiner then boots in the time of the worker's
    own start, not of the interpreter and torch as well, which on a card
    host outlast the survivor's whole scaled-down epoch."""
    log = open(os.path.join(r.ep_dir, f"standby{len(r.adopted)}.log"), "w")
    with log:
        r.standby = subprocess.Popen(
            [sys.executable, "-m", "dlrover_tpu_torch.agent.standby"],
            env=_worker_env(r), stdin=subprocess.PIPE, stdout=log,
            stderr=subprocess.STDOUT, cwd=_repo_root(),
        )


def _adopt_standby(r: _Runner, env: Dict[str, str],
                   argv: List[str]) -> Optional[subprocess.Popen]:
    """Hand a live standby the worker's env and argv; None when there
    is no standby or it died (the caller spawns cold)."""
    standby, r.standby = r.standby, None
    if standby is None or standby.poll() is not None:
        return None
    try:
        standby.stdin.write(json.dumps(
            {"env": env, "argv": argv, "module": _WORKER_MODULE}
        ).encode() + b"\n")
        standby.stdin.close()
    except (OSError, ValueError):
        standby.kill()
        standby.wait(timeout=5)
        return None
    return standby


def _spawn_worker(r: _Runner, rank: int, schedule_path: str = "") -> None:
    cfg = r.cfg
    generation = r.generations.get(rank, -1) + 1
    r.generations[rank] = generation
    env = _worker_env(r)
    env[TRACE_ENV] = os.path.join(r.ep_dir, f"trace_r{rank}.jsonl")
    if schedule_path:
        env[SCHEDULE_ENV] = schedule_path
    args = [
        sys.executable, "-m", _WORKER_MODULE,
        "--master-addr", f"localhost:{r.port}",
        "--rank", str(rank),
        "--world", str(cfg.world),
        "--dataset-size", str(cfg.dataset_size),
        "--shard-size", str(cfg.shard_size),
        "--ckpt-dir", os.path.join(r.ep_dir, "ckpt"),
        "--ckpt-every", str(cfg.ckpt_every),
        "--events", _events_path(r.ep_dir, rank),
        "--generation", str(generation),
        "--vec-len", str(cfg.vec_len),
        "--step-ms", str(cfg.step_ms),
        "--deadline-s", str(cfg.watchdog_s),
        "--device", cfg.device,
    ]
    if generation > 0:
        proc = _adopt_standby(r, env, args[2:])
        if proc is not None:
            r.adopted.append({"rank": rank, "generation": generation,
                              "pid": proc.pid})
            r.procs[rank] = proc
            return
    log = open(
        os.path.join(r.ep_dir, f"worker_r{rank}_g{generation}.log"), "w"
    )
    with log:
        r.procs[rank] = subprocess.Popen(
            args, env=env, stdout=log, stderr=subprocess.STDOUT,
            cwd=_repo_root(),
        )


def _build_master(cfg: RescaleSoakConfig, ep_dir: str) -> _Runner:
    from dlrover_tpu_torch.master.elastic_training.rescale_coordinator import (
        RescaleCoordinator,
    )
    from dlrover_tpu_torch.master.servicer import MasterServicer
    from dlrover_tpu_torch.master.shard.task_manager import TaskManager
    from dlrover_tpu_torch.rpc.transport import HttpMasterServer
    from dlrover_tpu_torch.trainer.elastic.trainer import ElasticBatchConfig

    batch_config = ElasticBatchConfig(
        # Must mirror the worker's config: lcm(1..world) keeps every
        # scale-down world size legal.
        global_batch_size=cfg.shard_size * rw.world_lcm(cfg.world),
        micro_batch_per_device=cfg.shard_size,
    )
    coordinator = RescaleCoordinator(
        legal_counts_fn=batch_config.legal_node_counts_fn(),
        barrier_timeout_s=cfg.barrier_timeout_s,
        bootstrap_min=cfg.world,
    )
    task_manager = TaskManager(task_timeout=cfg.task_timeout_s)
    servicer = MasterServicer(
        rdzv_managers={},
        task_manager=task_manager,
        rescale_coordinator=coordinator,
    )
    server = HttpMasterServer(0, servicer)
    server.start()
    runner = _Runner(
        server=server,
        coordinator=coordinator,
        task_manager=task_manager,
        port=server.port,
        ep_dir=ep_dir,
        cfg=cfg,
    )
    # Every plan cut, kept for its phase barriers' completion times.
    coordinator.on_plan_cut = runner.plans.append
    return runner


def _poll_deaths(r: _Runner) -> List[int]:
    """Reap dead workers; route deaths into the rescale plane exactly
    like the agent's node-failure report would."""
    died = []
    for rank, proc in list(r.procs.items()):
        rc = proc.poll()
        if rc is None or rc == rw.EXIT_OK:
            continue
        del r.procs[rank]
        died.append(rank)
        r.deaths.append({
            "t": time.time(), "rank": rank, "rc": rc,
            "generation": r.generations[rank],
            "signal": -rc if rc < 0 else None,
        })
        r.coordinator.note_worker_lost(rank)
        r.task_manager.recover_node_tasks(rank)
    return died


def _all_events(r: _Runner) -> List[Dict]:
    events = []
    for rank in r.generations:
        for e in _read_events(_events_path(r.ep_dir, rank)):
            e["rank"] = e.get("rank", rank)
            events.append(e)
    events.sort(key=lambda e: e.get("t", 0.0))
    return events


def _wait_for(r: _Runner, predicate, deadline: float, what: str):
    while time.time() < deadline:
        if predicate(_all_events(r)):
            return
        _poll_deaths(r)
        time.sleep(0.1)
    raise SoakInvariantError(f"watchdog: timed out waiting for {what}")


# ---------------------------------------------------------------------------
# Invariants
# ---------------------------------------------------------------------------


def _plan_row(plan) -> Dict:
    """One cut plan: its world, reason and each phase barrier's wait
    from the plan's creation (None: never completed)."""
    return {
        "plan": plan.plan_id,
        "reason": plan.reason,
        "world": len(plan.world),
        "restore_step": plan.restore_step,
        "expired": plan.expired,
        "barrier_wait_s": {
            phase: (round(plan.completed_at[phase] - plan.created_at, 4)
                    if phase in plan.completed_at else None)
            for phase in ("barrier", "restored", "resumed")
        },
    }


def check_rescale_invariants(events: List[Dict], cfg: RescaleSoakConfig):
    """Invariants 1 and 2 over the merged per-rank ledgers."""
    from dlrover_tpu_torch.testing.soak_worker import state_crc

    ref_crcs: Dict[frozenset, int] = {}

    def ref_crc(consumed) -> int:
        key = frozenset(consumed)
        if key not in ref_crcs:
            ref_crcs[key] = state_crc(rw.reference_state(
                cfg.dataset_size, sorted(key), cfg.vec_len))
        return ref_crcs[key]

    dones = [e for e in events if e.get("kind") == "done"]
    if not dones:
        raise SoakInvariantError("no worker reported completion")
    ref_full = rw.reference_state(cfg.dataset_size, expected_ranges(
        cfg.dataset_size, cfg.shard_size
    ), cfg.vec_len)
    want_crc = state_crc(ref_full)
    for d in dones:
        if d["sum"] != int(ref_full["sum"]):
            raise SoakInvariantError(
                f"exactly-once violated: rank {d['rank']} final sum "
                f"{d['sum']} != {int(ref_full['sum'])}"
            )
        if d["hist"] != ref_full["hist"].tolist():
            raise SoakInvariantError(
                f"exactly-once violated: rank {d['rank']} per-bucket "
                "record counts diverge"
            )
        if d["crc"] != want_crc:
            raise SoakInvariantError(
                f"rank {d['rank']} final state not bit-identical to the "
                f"single-host reference (crc {d['crc']} != {want_crc})"
            )
    # Reference replay: each save's state must be bit-identical to a
    # single-host run over exactly the shards its snapshot marks
    # consumed; lockstep replicas must agree per (plan, step) — step
    # numbers alone recur across plans because a rescale rolls the
    # counter back to the restore step.
    all_shards = expected_ranges(cfg.dataset_size, cfg.shard_size)
    saves_by_plan_step: Dict[tuple, int] = {}
    save_history: List[tuple] = []  # (t, step, crc) in ledger order
    for e in events:
        if e.get("kind") != "save":
            continue
        step, crc = e["step"], e["crc"]
        key = (e.get("plan"), step)
        if saves_by_plan_step.setdefault(key, crc) != crc:
            raise SoakInvariantError(
                f"replicas diverged: plan {key[0]} step {step} saved "
                f"with different CRCs across ranks"
            )
        save_history.append((e.get("t", 0.0), step, crc))
        snap = e.get("snapshot", "")
        if not snap:
            consumed = []
        else:
            snap_d = json.loads(snap)
            if snap_d.get("epoch", 0) == 0:
                consumed = []  # pre-split snapshot: nothing consumed
            else:
                undone = {
                    (u[0], u[1]) for u in snap_d.get("undone_shards", [])
                }
                consumed = [s for s in all_shards if s not in undone]
        if ref_crc(consumed) != crc:
            raise SoakInvariantError(
                f"save at step {step} not bit-identical to the "
                f"single-host reference over its consumed shard set "
                f"({len(consumed)} shards)"
            )
    for e in events:
        if e.get("kind") == "restore":
            step = e["step"]
            # The save this restore read is the newest COMMITTED save of
            # that step before the restore happened.
            prior = [
                crc for (t, s, crc) in save_history
                if s == step and t <= e.get("t", 0.0)
            ]
            if not prior:
                raise SoakInvariantError(
                    f"restored step {step} was never saved"
                )
            if e["crc"] != prior[-1]:
                raise SoakInvariantError(
                    f"restore of step {step} is not bit-identical to its "
                    f"save (crc {e['crc']} != {prior[-1]})"
                )
        elif e.get("kind") == "restore_crc_mismatch":
            raise SoakInvariantError(
                f"restore failed integrity at step {e.get('step')}"
            )


def rescale_timings(events: List[Dict]) -> List[Dict]:
    """Per-(rank, plan) rescale latencies incl. plan→first-step."""
    out = []
    steps = [e for e in events if e.get("kind") == "step"]
    for e in events:
        if e.get("kind") != "rescale":
            continue
        first_step = next(
            (
                s for s in steps
                if s.get("plan") == e["plan"]
                and s.get("rank") == e.get("rank")
                and s.get("t", 0) >= e.get("t", 0)
            ),
            None,
        )
        entry = {
            "rank": e.get("rank"),
            "plan": e["plan"],
            "reason": e.get("reason"),
            "world": len(e.get("world", [])),
            "barrier_s": e.get("barrier_s"),
            "restore_s": e.get("restore_s"),
            "rescale_s": e.get("total_s"),
        }
        if first_step is not None and e.get("plan_created_at"):
            entry["plan_to_first_step_s"] = round(
                first_step["t"] - e["plan_created_at"], 4
            )
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# Episode execution
# ---------------------------------------------------------------------------


def _terminate_workers(r: _Runner):
    """SIGTERM first (the flight recorder dumps its ring on SIGTERM),
    escalate to SIGKILL. Idempotent. A standby never adopted is killed."""
    standby, r.standby = r.standby, None
    if standby is not None and standby.poll() is None:
        standby.kill()
        standby.wait(timeout=5)
    for proc in r.procs.values():
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)


def _cleanup(r: _Runner):
    _terminate_workers(r)
    disarm()
    r.server.stop()
    r.task_manager.stop()
    reclaim_shm_segments(r.ep_dir, r.generations)


def _dump_artifacts(r: _Runner, artifact_dir: str, seed: int,
                    scenario: str, reason: str,
                    runner_schedule: Optional[FaultSchedule] = None) -> str:
    os.makedirs(artifact_dir, exist_ok=True)
    dest = os.path.join(artifact_dir, f"rescale_seed{seed}_{scenario}")
    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(dest, exist_ok=True)
    for pattern in ("events_r*.jsonl", "trace_r*.jsonl", "worker_r*.log",
                    "schedule_*.json"):
        for src in glob.glob(os.path.join(r.ep_dir, pattern)):
            shutil.copy(src, dest)
    # The §26 artifact contract: the flight rings the SIGTERMed workers
    # dumped, plus EVERY armed schedule — the in-process runner one has
    # no on-disk copy unless serialized here.
    flight_src = os.path.join(r.ep_dir, "flight")
    if os.path.isdir(flight_src):
        shutil.copytree(
            flight_src, os.path.join(dest, "flight"), dirs_exist_ok=True
        )
    if runner_schedule is not None:
        with open(os.path.join(dest, "schedule_runner.json"), "w") as f:
            f.write(runner_schedule.to_json())
    with open(os.path.join(dest, "failure.json"), "w") as f:
        json.dump({"seed": seed, "scenario": scenario, "reason": reason},
                  f, indent=2)
    return dest


def run_rescale_episode(
    seed: int,
    cfg: Optional[RescaleSoakConfig] = None,
    scenario: str = "live",
    work_dir: Optional[str] = None,
    artifact_dir: Optional[str] = None,
    runner_schedule: Optional[FaultSchedule] = None,
    rank_schedules: Optional[Dict[int, FaultSchedule]] = None,
) -> Dict:
    """Run one live-rescale episode; returns a soak-style report dict.
    Raises :class:`SoakInvariantError` (after dumping artifacts) on any
    invariant breach."""
    cfg = cfg or RescaleSoakConfig()
    if scenario == "live" and cfg.step_ms <= 0:
        # Unpaced steps are sub-millisecond: the N-1 survivor drains the
        # whole dataset during the joiner's ~2s process bootstrap, the
        # scale-up barrier expires against an exited worker, and the
        # watchdog fires without ever exercising scale-up. Pace the run
        # so a world change can actually land mid-epoch (the integration
        # test uses step_ms=80 over a 960-record dataset).
        raise ValueError(
            "scenario='live' needs cfg.step_ms > 0 so the survivor "
            "cannot finish the epoch before the scale-up joiner boots"
        )
    work_dir = work_dir or tempfile.mkdtemp(prefix="dlrover_rescale_")
    artifact_dir = artifact_dir or os.path.join(work_dir, "artifacts")
    ep_dir = os.path.join(work_dir, f"rescale-s{seed}-{scenario}")
    shutil.rmtree(ep_dir, ignore_errors=True)
    os.makedirs(os.path.join(ep_dir, "flight"), exist_ok=True)
    os.makedirs(os.path.join(ep_dir, "ckpt"), exist_ok=True)

    schedule_paths: Dict[int, str] = {}
    for rank, sched in (rank_schedules or {}).items():
        path = os.path.join(ep_dir, f"schedule_r{rank}.json")
        with open(path, "w") as f:
            f.write(sched.to_json())
        schedule_paths[rank] = path

    r = _build_master(cfg, ep_dir)
    if runner_schedule is not None:
        arm(runner_schedule)
    t_start = time.time()
    deadline = t_start + cfg.watchdog_s
    report: Dict = {"seed": seed, "scenario": scenario,
                    "world": cfg.world}
    try:
        for rank in range(cfg.world):
            _spawn_worker(r, rank, schedule_paths.get(rank, ""))
        _spawn_standby(r)
        if scenario == "live":
            _run_live_scenario(r, deadline)
        elif scenario == "kill_during_rescale":
            _run_kill_during_rescale(r, deadline)
        else:
            raise ValueError(f"unknown scenario {scenario!r}")
        # Wait for every remaining worker to finish the dataset.
        while r.procs and time.time() < deadline:
            for rank, proc in list(r.procs.items()):
                rc = proc.poll()
                if rc == rw.EXIT_OK:
                    del r.procs[rank]
            if _poll_deaths(r):
                continue
            time.sleep(0.1)
        if r.procs:
            raise SoakInvariantError(
                f"watchdog: workers {sorted(r.procs)} never finished"
            )
        events = _all_events(r)
        check_rescale_invariants(events, cfg)
        if scenario == "live":
            _check_live_process_tree(r, events)
    except SoakInvariantError as e:
        # Workers go down (SIGTERM → flight rings dump) BEFORE the
        # artifact copy, so the bundle actually contains the rings.
        _terminate_workers(r)
        dest = _dump_artifacts(
            r, artifact_dir, seed, scenario, str(e),
            runner_schedule=runner_schedule,
        )
        print(
            f"RESCALE EPISODE FAILED: {e}\n  artifacts: {dest}",
            file=sys.stderr, flush=True,
        )
        raise
    finally:
        _cleanup(r)

    wall = time.time() - t_start
    events = _all_events(r)
    step_events = [e for e in events if e.get("kind") == "step"]
    # Keyed by STEP, not (rank, step): lockstep ranks execute the same
    # global step in parallel, and rolled-back replays count once (the
    # last execution wins) — the same productive-time semantics as the
    # single-worker soak, so aggregate goodput stays comparable.
    last_dur: Dict[int, float] = {}
    for e in step_events:
        last_dur[e["step"]] = e.get("dur", 0.0)
    productive_s = sum(last_dur.values())
    recoveries = []
    for death in r.deaths:
        after = [e for e in step_events if e["t"] > death["t"]]
        if after:
            recoveries.append(after[0]["t"] - death["t"])
    trace = []
    for rank in r.generations:
        trace += _read_trace(
            os.path.join(ep_dir, f"trace_r{rank}.jsonl"), f"rank{rank}"
        )
    if runner_schedule is not None:
        trace += [
            {
                "origin": "runner", "point": t["point"],
                "action": t["action"], "rule_id": t["rule_id"],
                "hit": t["hit"],
            }
            for t in runner_schedule.trace
        ]
    trace.sort(key=lambda t: (t["origin"], str(t["rule_id"])))
    timings = rescale_timings(events)
    report.update({
        "wall_s": round(wall, 3),
        "productive_step_s": round(productive_s, 3),
        "goodput_frac": round(
            min(productive_s / max(wall, 1e-9), 1.0), 4
        ),
        "faults": trace,
        "deaths": len(r.deaths),
        "recovery_s": [round(x, 3) for x in recoveries],
        "rescales": timings,
        "plans": max(
            (e.get("plan", 0) for e in events if e.get("kind") == "rescale"),
            default=0,
        ),
        "steps_executed": len(step_events),
        "steps_unique": len(last_dur),
        "generations": dict(r.generations),
        "plans_cut": [_plan_row(p) for p in r.plans],
        "adopted": list(r.adopted),
        "events": events,
    })
    if not cfg.keep_artifacts_on_success:
        shutil.rmtree(ep_dir, ignore_errors=True)
    return report


def _crash_ready_step(cfg: RescaleSoakConfig) -> int:
    """A step by which at least two checkpoint intervals committed."""
    return 2 * max(cfg.ckpt_every, 1) + 1


def _run_live_scenario(r: _Runner, deadline: float):
    cfg = r.cfg
    victim = cfg.world - 1
    ready = _crash_ready_step(cfg)

    def trained(events):
        per_rank = {}
        for e in events:
            if e.get("kind") == "step":
                per_rank[e["rank"]] = max(
                    per_rank.get(e["rank"], 0), e["step"]
                )
        return len(per_rank) >= cfg.world and min(
            per_rank.values()
        ) >= ready

    _wait_for(r, trained, deadline, f"world={cfg.world} to reach "
              f"step {ready}")
    os.kill(r.procs[victim].pid, signal.SIGKILL)
    _poll_deaths_until(r, victim, deadline)

    def rescaled_down(events):
        return any(
            e.get("kind") == "rescale"
            and len(e.get("world", [])) == cfg.world - 1
            and e.get("rank") != victim
            for e in events
        )

    _wait_for(r, rescaled_down, deadline,
              f"live rescale to world={cfg.world - 1}")
    # Scale back UP: a fresh worker joins mid-run and steals leases.
    # Spawned immediately after the scale-down completes — the joiner's
    # ~2s process bootstrap is exactly the window in which the survivor
    # proves it trains at world N-1 (asserted post-hoc from the ledger).
    _spawn_worker(r, victim, "")

    def rescaled_up(events):
        return any(
            e.get("kind") == "rescale"
            and len(e.get("world", [])) == cfg.world
            and e.get("generation", 0) >= 1
            for e in events
        )

    _wait_for(r, rescaled_up, deadline,
              f"scale-up back to world={cfg.world}")


def _poll_deaths_until(r: _Runner, rank: int, deadline: float):
    while time.time() < deadline:
        if rank in [d["rank"] for d in r.deaths]:
            return
        _poll_deaths(r)
        time.sleep(0.05)
    raise SoakInvariantError(f"watchdog: rank {rank} death never observed")


def _run_kill_during_rescale(r: _Runner, deadline: float):
    """The armed schedules do the killing: rank 1 crashes mid-step
    (cutting the scale-down plan), rank 0 is SIGKILLed inside that
    plan's restore-to-first-step window (``rescale.resume.first_step``).
    The runner respawns only rank 0 — the fresh generation joins the
    rescale plane and must finish the dataset alone. Returns once both
    planned kills landed and the respawn is up; the caller's drain loop
    handles the rest."""
    while time.time() < deadline:
        died = _poll_deaths(r)
        for rank in died:
            if rank == 0:
                # The mid-rescale victim comes back as a fresh
                # generation joining the rescale plane.
                _spawn_worker(r, rank, "")
        if len(r.deaths) >= 2 and 0 in r.procs:
            return
        time.sleep(0.05)
    raise SoakInvariantError(
        "watchdog: kill_during_rescale kills never completed "
        f"(deaths={len(r.deaths)})"
    )


def _check_live_process_tree(r: _Runner, events: List[Dict]):
    """Survivors must have exactly ONE generation (never restarted) and
    the victim exactly two (the scale-up join)."""
    cfg = r.cfg
    victim = cfg.world - 1
    for rank, gen in r.generations.items():
        if rank == victim:
            if gen != 1:
                raise SoakInvariantError(
                    f"victim rank {rank} expected 1 respawn, got {gen}"
                )
        elif gen != 0:
            raise SoakInvariantError(
                f"survivor rank {rank} restarted ({gen} respawns) — the "
                "job process tree must survive a live rescale"
            )
    starts = [
        e for e in events if e.get("kind") == "worker_start"
    ]
    by_rank: Dict[int, int] = {}
    for e in starts:
        by_rank[e["rank"]] = by_rank.get(e["rank"], 0) + 1
    for rank, count in by_rank.items():
        want = 2 if rank == victim else 1
        if count != want:
            raise SoakInvariantError(
                f"rank {rank} recorded {count} process starts, want {want}"
            )
    if not any(
        e.get("kind") == "step" and e.get("world") == cfg.world - 1
        for e in events
    ):
        raise SoakInvariantError(
            f"no training step recorded at world={cfg.world - 1}: the "
            "job never actually trained in the scaled-down world"
        )
