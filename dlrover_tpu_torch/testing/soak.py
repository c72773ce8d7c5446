"""Seeded chaos-soak harness: whole-stack fault episodes with invariants.

One episode = an in-process master (task manager + servicer + HTTP
transport), a crash-restartable training worker subprocess
(:mod:`dlrover_tpu_torch.testing.soak_worker`), and a continuous-batching
serving engine — all driven through a seeded, deterministic
:class:`~dlrover_tpu_torch.fault.FaultSchedule`. After every episode the four
system invariants are asserted (docs/DESIGN.md §26):

1. **Exactly-once shard accounting** — the worker's order-independent
   integer state equals the exactly-once expectation over the whole
   dataset, and the master's shard ledger is complete.
2. **Checkpoint integrity** — every restore's content CRC matches the
   corresponding save's; torn/truncated raw shards are rejected and the
   previous committed step restored; saves advance monotonically.
3. **Serving completeness** — every admitted request reaches DONE (or
   an explicit failure); an engine step that raises re-queues its
   in-flight requests instead of losing them.
4. **No deadlock** — a watchdog bounds the episode; on breach the
   worker is SIGTERMed (flight ring dumps) and the episode fails.

Fault randomness is in schedule GENERATION (parameters drawn from
``random.Random(seed, episode)``); triggers are deterministic hit
counters, so one seed reproduces one fault trace exactly.

On failure the episode's evidence — fault schedules, merged trace,
worker ledger, flight-recorder dumps — is copied to an artifact dir and
a one-line repro command is printed.

The port's copy of ``dlrover_tpu/testing/soak.py``. Its plans are the
reference's for every seed and episode. The worker holds its state on
``SoakConfig.device`` (``cuda`` unless the config asks for ``cpu``), and
the serving scenario runs the port's ``ServingEngine`` there: the
reference's ``tiny_config()`` unless ``SoakConfig.serving_model`` names
another model config (``chip_smoke.py`` passes the flagship's width).
Each report of a serving episode also carries the engine's
``call_counts`` (``serving``). The fleet kinds (``replica_kill_reroute``,
``kill_during_migration``) run ``testing/fleet_soak.py``, whose
subprocess replicas take ``SoakConfig.device`` and serve
``SoakConfig.fleet_config`` (``tiny`` unless it names ``flagship``);
``straggler_evict`` runs ``testing/autoscale_soak.py``, which simulates
its cluster on the host.
"""

import glob
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.fault import FaultRule, FaultSchedule, arm, disarm
from dlrover_tpu_torch.fault.registry import SCHEDULE_ENV, TRACE_ENV
from dlrover_tpu_torch.testing import soak_worker as sw

EPISODE_KINDS = (
    "crash_drop",
    "torn_ckpt",
    "serving_report",
    # Episode 3 of every seed: a live N→M rescale is SIGKILLed between
    # the plan ack and the first post-rescale step (delegated to
    # testing/rescale_soak.py). Appended last so episodes
    # 0-2 keep their historical (seed, episode) -> plan identity.
    "kill_during_rescale",
    # Episode 4: a serving-fleet replica is SIGKILLed mid-decode; the
    # router must re-route its in-flight ledger (at-most-once), mark it
    # broken, restart it, and re-admit it through half-open probes
    # (delegated to testing/fleet_soak.py). Appended so
    # episodes 0-3 keep their (seed, episode) -> plan identity.
    "replica_kill_reroute",
    # Episode 5: the §30 closed-loop autoscaler under a persistent
    # per-rank delay at the step fault point plus worker deaths and a
    # serving-traffic spike — the autoscaled run must flag/evict/
    # replace the straggler within bounded decision windows and
    # strictly beat the static run's goodput fraction (delegated to
    # testing/autoscale_soak.py). Appended so episodes 0-4
    # keep their (seed, episode) -> plan identity.
    "straggler_evict",
    # Episode 6: a prefill+decode split fleet (§36) has its DESTINATION
    # replica SIGKILLed between the source's KV export and the import
    # ack — the payload exists on the wire but nowhere durable. The
    # never-released source must complete the request exactly once,
    # block conservation must hold on both ends across the kill, and a
    # migration must succeed again after the breaker-gated restart
    # (delegated to testing/fleet_soak.py). Appended so
    # episodes 0-5 keep their (seed, episode) -> plan identity.
    "kill_during_migration",
    # Episode 7: the MASTER is SIGKILLed between a journaled shard
    # dispatch and its reply (the master.journal.write fault point,
    # kind=dispatch), restarted from its durable journal, and the
    # never-restarted worker must ride the outage out and finish with
    # exactly-once accounting (delegated to
    # testing/master_kill_soak.py). Appended so episodes
    # 0-6 keep their (seed, episode) -> plan identity.
    "master_kill",
)


class SoakInvariantError(AssertionError):
    pass


@dataclass
class SoakConfig:
    dataset_size: int = 512
    shard_size: int = 16
    ckpt_every: int = 2
    step_ms: float = 0.0           # simulated compute per worker step
    task_timeout_s: float = 2.0
    watchdog_s: float = 180.0
    max_generations: int = 5
    serve: bool = True
    serving_requests: int = 4
    serving_new_tokens: int = 4
    keep_artifacts_on_success: bool = False
    device: str = "cuda"
    # A TpuLMConfig for the serving scenario; None is tiny_config().
    serving_model: Optional[object] = None
    # The model the fleet episodes' subprocess replicas serve: "tiny"
    # or "flagship" (SubprocessReplica's config names).
    fleet_config: str = "tiny"


@dataclass
class EpisodePlan:
    kind: str
    crash_step: int = 0            # 0 = no crash planned
    torn_persist_nth: int = 0      # 0 = no torn write planned
    fallback_step: int = 0         # expected restore step after torn
    worker_schedules: List[FaultSchedule] = field(default_factory=list)
    runner_schedule: Optional[FaultSchedule] = None
    # kill_during_rescale only: per-RANK schedules for the multi-worker
    # rescale episode (worker_schedules stays per-generation for the
    # single-worker kinds).
    rank_schedules: Dict[int, FaultSchedule] = field(default_factory=dict)
    # master_kill only: SIGKILL the master on the Nth journaled
    # dispatch record (the master.journal.write fault point).
    master_kill_nth: int = 0


def build_episode_plan(
    seed: int, episode: int, cfg: Optional[SoakConfig] = None
) -> EpisodePlan:
    """Deterministic plan for (seed, episode): which faults, where.

    The three base kinds rotate so ``--episodes 3`` covers every
    required fault class (worker SIGKILL, dropped get_task reply, torn
    shard write, serving step error); the rng fills in parameters.
    Torn-write positions are derived from ``cfg.ckpt_every`` (the
    worker persists at step 0 and then every ``ckpt_every`` steps)."""
    cfg = cfg or SoakConfig()
    every = max(cfg.ckpt_every, 1)
    total_steps = cfg.dataset_size // max(cfg.shard_size, 1)
    if total_steps <= 2 * every + 1:
        raise ValueError(
            f"dataset too small for a chaos episode: {total_steps} steps "
            f"cannot fit a crash after two checkpoint intervals of "
            f"{every} steps"
        )

    def pick_crash_step() -> int:
        # After at least two persisted intervals (so a torn newest step
        # still has a real fallback), but strictly inside the episode —
        # a crash planned past the last step would never fire.
        return min(
            2 * every + 1 + every * rng.randint(0, 2), total_steps - 1
        )

    ep_seed = seed * 10007 + episode
    rng = random.Random(ep_seed)
    kind = EPISODE_KINDS[episode % len(EPISODE_KINDS)]
    plan = EpisodePlan(kind=kind)
    runner_rules: List[FaultRule] = []

    if kind == "crash_drop":
        plan.crash_step = pick_crash_step()
        plan.worker_schedules = [
            FaultSchedule([
                FaultRule("agent.worker.crash", action="crash",
                          nth=plan.crash_step, rule_id="worker-sigkill"),
            ], seed=ep_seed, label="gen0"),
            FaultSchedule([], seed=ep_seed, label="gen1"),
        ]
        runner_rules.append(FaultRule(
            "rpc.get.drop_reply", action="raise",
            nth=rng.randint(2, 4),
            match={"request": "MultiTaskRequest"},
            rule_id="drop-get-task-reply",
        ))
    elif kind == "torn_ckpt":
        # Crash mid-interval; the persist immediately before the crash
        # is torn, so the *newest committed* step is unrestorable from
        # disk and the shm image is declared lost on restart — the
        # restore must reject the torn step and fall back one interval.
        # Persists land at steps 0, every, 2*every, ... (the j-th, 1-
        # based, at step (j-1)*every); crash_step > 2*every keeps the
        # fallback step a real (non-initial, non-negative) checkpoint.
        plan.crash_step = pick_crash_step()
        last_persist_step = ((plan.crash_step - 1) // every) * every
        plan.torn_persist_nth = last_persist_step // every + 1
        plan.fallback_step = last_persist_step - every
        plan.worker_schedules = [
            FaultSchedule([
                # At least one full page: the raw writer pads the file
                # tail to page alignment, so a sub-page tear may only
                # eat padding and legitimately still restore.
                FaultRule("ckpt.persist.torn_write", action="truncate",
                          nth=plan.torn_persist_nth,
                          truncate_bytes=4096 + rng.randint(0, 2048),
                          rule_id="torn-shard-write"),
                FaultRule("agent.worker.crash", action="crash",
                          nth=plan.crash_step, rule_id="worker-sigkill"),
            ], seed=ep_seed, label="gen0"),
            FaultSchedule([
                FaultRule("ckpt.restore.memory", action="raise",
                          nth=1, rule_id="shm-image-lost"),
            ], seed=ep_seed, label="gen1"),
        ]
    elif kind == "straggler_evict":
        # The sim-job fault schedule (persistent per-node delay at the
        # step fault point + seeded worker deaths) is derived in
        # autoscale_soak.build_autoscale_plan from the same ep_seed;
        # the runner itself injects nothing extra.
        pass
    elif kind == "replica_kill_reroute":
        # The per-replica SIGKILL schedule is derived in
        # fleet_soak.build_fleet_schedules (same ep_seed); the runner
        # additionally drops one router dispatch on the wire so the
        # bounded-retry path fires in the same episode.
        runner_rules.append(FaultRule(
            "fleet.router.dispatch", action="raise",
            nth=rng.randint(2, 6),
            rule_id="drop-router-dispatch",
        ))
    elif kind == "kill_during_migration":
        # The destination-replica SIGKILL schedule (crash at the
        # fleet.replica.import fault point, between export and
        # import-ack) is derived in
        # fleet_soak.build_migration_schedules from the same ep_seed;
        # the runner itself injects nothing extra — the episode's
        # whole point is that ONE kill in that window already
        # exercises timeout-prune, source fallback and the
        # migration-probed breaker walk.
        pass
    elif kind == "master_kill":
        # The master dies on its Nth journaled dispatch — deep enough
        # in that the worker holds live leases and at least one
        # checkpoint interval has persisted, low enough that the 32ish
        # dispatches of the default dataset still reach it even before
        # any timeout-requeue redispatches.
        plan.master_kill_nth = rng.randint(
            2 * every + 2, max(2 * every + 2, (2 * total_steps) // 3)
        )
    elif kind == "kill_during_rescale":
        # Rank 1 dies mid-step (cuts the scale-down plan); rank 0 is
        # SIGKILLed in the restore-to-first-step window of THAT plan
        # (resume hit 1 is the bootstrap plan, hit 2 the scale-down),
        # and one plan broadcast is dropped on the wire for good
        # measure — the pull protocol must redeliver it.
        plan.crash_step = pick_crash_step()
        plan.rank_schedules = {
            1: FaultSchedule([
                FaultRule("agent.worker.crash", action="crash",
                          nth=plan.crash_step, rule_id="worker-sigkill"),
            ], seed=ep_seed, label="rank1"),
            0: FaultSchedule([
                FaultRule("rescale.resume.first_step", action="crash",
                          nth=2, rule_id="kill-mid-rescale"),
            ], seed=ep_seed, label="rank0"),
        }
        runner_rules.append(FaultRule(
            "rescale.plan.broadcast", action="raise",
            nth=rng.randint(1, 3),
            rule_id="drop-plan-broadcast",
        ))
    else:  # serving_report
        plan.worker_schedules = [
            FaultSchedule([
                FaultRule("data.prefetch.fetch", action="raise",
                          nth=rng.randint(1, 2),
                          rule_id="prefetch-fetch-fails"),
            ], seed=ep_seed, label="gen0"),
        ]
        runner_rules.append(FaultRule(
            "rpc.report.drop_reply", action="raise",
            nth=rng.randint(1, 3),
            match={"request": "TaskDoneBatchReport"},
            rule_id="drop-done-report-reply",
        ))
        runner_rules.append(FaultRule(
            "serving.step.error", action="raise",
            nth=rng.randint(2, 5),
            rule_id="serving-step-raises",
        ))

    plan.runner_schedule = FaultSchedule(
        runner_rules, seed=ep_seed, label=f"runner-ep{episode}"
    )
    return plan


# ---------------------------------------------------------------------------
# Episode execution
# ---------------------------------------------------------------------------


def _repo_root() -> str:
    import dlrover_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(
        dlrover_tpu_torch.__file__
    )))


def episode_job_name(ep_dir: str) -> str:
    """The job name an episode's workers run under. It names their shm
    checkpoint segments, and ``/dev/shm`` is shared by every run on the
    host, so it carries this runner's pid and a hash of the episode
    directory: two runs of one seed and episode, at once or after a
    killed run left its segment, never overwrite, restore or unlink
    each other's image."""
    path = os.path.abspath(ep_dir)
    crc = zlib.crc32(path.encode())
    return f"{os.path.basename(path)}-{os.getpid()}-{crc:08x}"


def reclaim_shm_segments(ep_dir: str, ranks=(0,)) -> None:
    """Unlink the episode's shm checkpoint segments. A dead worker's
    segment outlives it (that is the flash-ckpt feature); reclaim it
    once the episode is over."""
    from multiprocessing import shared_memory

    job = episode_job_name(ep_dir)
    for rank in ranks:
        try:
            seg = shared_memory.SharedMemory(
                name=f"dlrover_tpu_ckpt_{job}_n{rank}_0"
            )
            seg.close()
            seg.unlink()
        except Exception:  # noqa: BLE001 — cleanup is best-effort
            pass


def _spawn_worker(plan, cfg, ep_dir, master_port, generation,
                  schedule_path) -> subprocess.Popen:
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "1")
    env.update({
        "DLROVER_TPU_JOB_NAME": episode_job_name(ep_dir),
        "DLROVER_TPU_FLIGHT_DIR": os.path.join(ep_dir, "flight"),
        TRACE_ENV: os.path.join(ep_dir, "trace_worker.jsonl"),
        "PYTHONPATH": _repo_root() + os.pathsep + env.get("PYTHONPATH", ""),
    })
    if schedule_path:
        env[SCHEDULE_ENV] = schedule_path
    else:
        env.pop(SCHEDULE_ENV, None)
    args = [
        sys.executable, "-m", "dlrover_tpu_torch.testing.soak_worker",
        "--master-addr", f"localhost:{master_port}",
        "--node-id", "0",
        "--dataset-size", str(cfg.dataset_size),
        "--shard-size", str(cfg.shard_size),
        "--ckpt-dir", os.path.join(ep_dir, "ckpt"),
        "--ckpt-every", str(cfg.ckpt_every),
        "--events", os.path.join(ep_dir, "events.jsonl"),
        "--progress", os.path.join(ep_dir, "progress"),
        "--generation", str(generation),
        "--step-ms", str(cfg.step_ms),
        "--device", cfg.device,
    ]
    with open(
        os.path.join(ep_dir, f"worker_gen{generation}.log"), "w"
    ) as log:
        # The child holds its own duplicate of the fd; closing the
        # parent's handle here keeps long soaks from accumulating fds.
        return subprocess.Popen(
            args, env=env, stdout=log, stderr=subprocess.STDOUT,
            cwd=_repo_root(),
        )


class _ServingScenario:
    """Tiny continuous-batching engine driven alongside the worker (the
    port's ``ServingEngine`` on ``cfg.device``; ``cfg.serving_model``
    replaces the tiny config)."""

    def __init__(self, cfg: SoakConfig, rng: random.Random):
        import torch

        from dlrover_tpu_torch.models import llama
        from dlrover_tpu_torch.serving.engine import ServingEngine

        model_cfg = cfg.serving_model or llama.tiny_config()
        params = llama.init_params(
            model_cfg, torch.Generator(cfg.device).manual_seed(0),
            device=cfg.device,
        )
        self.engine = ServingEngine(
            model_cfg, params, slots=2, max_len=64, prefill_chunk=8,
            device=cfg.device,
        )
        self.engine.warmup()
        self.requests = []
        self._to_submit = [
            (
                [rng.randint(1, model_cfg.vocab_size - 1)
                 for _ in range(rng.randint(4, 10))],
                cfg.serving_new_tokens,
            )
            for _ in range(cfg.serving_requests)
        ]

    def tick(self):
        if self._to_submit:
            prompt, new = self._to_submit.pop(0)
            self.requests.append(self.engine.submit(prompt, new))
        if self.engine.pending():
            self.engine.step()

    def pending(self) -> int:
        return len(self._to_submit) + self.engine.pending()

    def drain(self, deadline: float):
        while self.pending() and time.time() < deadline:
            self.tick()

    def summary(self) -> Dict:
        return {
            "call_counts": dict(self.engine.call_counts),
            "requests": len(self.requests),
            "tokens": sum(len(r.tokens) for r in self.requests),
        }

    def check_invariant(self):
        from dlrover_tpu_torch.serving import scheduler as sched_lib

        # The engine's only explicit-failure surface is cancel(), which
        # also lands requests in DONE — so "completes or is explicitly
        # failed" reduces to: every submitted request reached DONE.
        stuck = [
            r.rid for r in self.requests if r.state != sched_lib.DONE
        ]
        if stuck:
            raise SoakInvariantError(
                f"serving requests neither completed nor explicitly "
                f"failed: rids {stuck}"
            )
        for r in self.requests:
            if r.state == sched_lib.DONE and not r.truncated:
                if len(r.tokens) != r.max_new_tokens:
                    raise SoakInvariantError(
                        f"request {r.rid} finished with "
                        f"{len(r.tokens)}/{r.max_new_tokens} tokens"
                    )


def _read_events(path: str) -> List[Dict]:
    events = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except ValueError:
                    pass  # torn tail line from a SIGKILL mid-write
    except OSError:
        pass
    return events


def _read_trace(path: str, origin: str) -> List[Dict]:
    out = []
    for entry in _read_events(path):
        out.append({
            "origin": origin,
            "point": entry.get("point"),
            "action": entry.get("action"),
            "rule_id": entry.get("rule_id"),
            "hit": entry.get("hit"),
        })
    return out


def _check_ledger_invariants(events: List[Dict], plan: EpisodePlan,
                             cfg: SoakConfig):
    """Invariants 1 and 2, from the worker's crash-surviving ledger."""
    dones = [e for e in events if e.get("kind") == "done"]
    if not dones:
        raise SoakInvariantError("worker never reported completion")
    final = dones[-1]
    want_sum = sw.expected_sum(cfg.dataset_size)
    if final["sum"] != want_sum:
        raise SoakInvariantError(
            f"exactly-once violated: final sum {final['sum']} != "
            f"expected {want_sum} (records lost or replayed)"
        )
    if final["hist"] != sw.expected_hist(cfg.dataset_size).tolist():
        raise SoakInvariantError(
            "exactly-once violated: per-bucket record counts diverge"
        )
    # Checkpoint integrity: every restore's CRC matches the newest
    # prior save of that step; saves advance within a generation.
    saves_by_step: Dict[int, int] = {}
    last_save_step = {"gen": -1, "step": -1}
    max_save_step = -1
    for e in events:
        if e.get("kind") == "save":
            saves_by_step[e["step"]] = e["crc"]
            max_save_step = max(max_save_step, e["step"])
            if last_save_step["step"] >= e["step"] and (
                last_save_step["gen"] == e.get("generation", -2)
            ):
                raise SoakInvariantError(
                    f"saves not monotonic within a generation: "
                    f"{last_save_step['step']} then {e['step']}"
                )
            last_save_step = {
                "gen": e.get("generation", -2), "step": e["step"]
            }
        elif e.get("kind") == "restore":
            step = e["step"]
            if step > max_save_step:
                raise SoakInvariantError(
                    f"restored step {step} was never saved"
                )
            if step in saves_by_step and e["crc"] != saves_by_step[step]:
                raise SoakInvariantError(
                    f"restore of step {step} is not bit-identical to "
                    f"its save (crc {e['crc']} != {saves_by_step[step]})"
                )
        elif e.get("kind") == "restore_crc_mismatch" and (
            e.get("source") == "storage"
        ):
            raise SoakInvariantError(
                f"storage restore failed integrity at step {e.get('step')}"
            )
    if plan.kind == "torn_ckpt":
        restores = [
            e for e in events
            if e.get("kind") == "restore" and e.get("generation", 0) >= 1
        ]
        if not restores:
            raise SoakInvariantError(
                "torn episode: post-crash generation never restored"
            )
        got = restores[0]["step"]
        if got != plan.fallback_step:
            raise SoakInvariantError(
                f"torn shard not rejected: post-crash restore got step "
                f"{got}, expected fallback step {plan.fallback_step}"
            )


def _dump_artifacts(ep_dir: str, artifact_dir: str, plan: EpisodePlan,
                    seed: int, episode: int, reason: str) -> str:
    os.makedirs(artifact_dir, exist_ok=True)
    dest = os.path.join(artifact_dir, f"soak_seed{seed}_ep{episode}")
    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(dest, exist_ok=True)
    for name in ("events.jsonl", "trace_worker.jsonl", "progress"):
        src = os.path.join(ep_dir, name)
        if os.path.exists(src):
            shutil.copy(src, dest)
    for src in glob.glob(os.path.join(ep_dir, "worker_gen*.log")):
        shutil.copy(src, dest)
    flight_src = os.path.join(ep_dir, "flight")
    if os.path.isdir(flight_src):
        shutil.copytree(
            flight_src, os.path.join(dest, "flight"), dirs_exist_ok=True
        )
    for g, sched in enumerate(plan.worker_schedules):
        with open(os.path.join(dest, f"schedule_gen{g}.json"), "w") as f:
            f.write(sched.to_json())
    if plan.runner_schedule is not None:
        with open(os.path.join(dest, "schedule_runner.json"), "w") as f:
            f.write(plan.runner_schedule.to_json())
    with open(os.path.join(dest, "failure.json"), "w") as f:
        json.dump({
            "seed": seed, "episode": episode, "kind": plan.kind,
            "reason": reason,
        }, f, indent=2)
    return dest


def run_episode(seed: int, episode: int, cfg: SoakConfig,
                work_dir: str, artifact_dir: str) -> Dict:
    """Run one episode; returns its report dict. Raises
    SoakInvariantError (after dumping artifacts) on failure."""
    from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor
    from dlrover_tpu_torch.master.servicer import MasterServicer
    from dlrover_tpu_torch.master.shard.task_manager import TaskManager
    from dlrover_tpu_torch.rpc.transport import HttpMasterServer

    ep_seed = seed * 10007 + episode
    rng = random.Random(ep_seed ^ 0x5EED)
    plan = build_episode_plan(seed, episode, cfg)
    if plan.kind == "kill_during_rescale":
        return _run_rescale_kind(
            seed, episode, plan, cfg, work_dir, artifact_dir
        )
    if plan.kind == "replica_kill_reroute":
        return _run_fleet_kind(
            seed, episode, plan, cfg, work_dir, artifact_dir
        )
    if plan.kind == "kill_during_migration":
        return _run_migration_kind(
            seed, episode, plan, cfg, work_dir, artifact_dir
        )
    if plan.kind == "straggler_evict":
        return _run_autoscale_kind(seed, episode, cfg)
    if plan.kind == "master_kill":
        return _run_master_kill_kind(
            seed, episode, plan, cfg, work_dir, artifact_dir
        )
    ep_dir = os.path.join(work_dir, f"soak-s{seed}-e{episode}")
    shutil.rmtree(ep_dir, ignore_errors=True)
    os.makedirs(os.path.join(ep_dir, "flight"), exist_ok=True)
    os.makedirs(os.path.join(ep_dir, "ckpt"), exist_ok=True)

    schedule_paths = []
    for g, sched in enumerate(plan.worker_schedules):
        path = os.path.join(ep_dir, f"schedule_gen{g}.json")
        with open(path, "w") as f:
            f.write(sched.to_json())
        schedule_paths.append(path)

    task_manager = TaskManager(task_timeout=cfg.task_timeout_s)
    perf_monitor = PerfMonitor()
    servicer = MasterServicer(
        rdzv_managers={},
        task_manager=task_manager,
        perf_monitor=perf_monitor,
    )
    server = HttpMasterServer(0, servicer)
    server.start()
    arm(plan.runner_schedule)

    serving = _ServingScenario(cfg, rng) if cfg.serve else None
    deaths: List[Dict] = []
    report: Dict = {
        "episode": episode, "seed": seed, "kind": plan.kind,
        "generations": 0,
    }
    t_start = time.time()
    deadline = t_start + cfg.watchdog_s
    failure: Optional[str] = None
    proc: Optional[subprocess.Popen] = None
    try:
        generation = 0
        while True:
            sched_path = (
                schedule_paths[generation]
                if generation < len(schedule_paths) else ""
            )
            proc = _spawn_worker(
                plan, cfg, ep_dir, server.port, generation, sched_path
            )
            report["generations"] = generation + 1
            last_recover = 0.0
            while proc.poll() is None:
                now = time.time()
                if now > deadline:
                    failure = "watchdog: episode deadline exceeded"
                    break
                if now - last_recover > 0.5:
                    last_recover = now
                    for mgr in list(
                        task_manager._datasets.values()  # noqa: SLF001
                    ):
                        mgr.recover_timeout_tasks(cfg.task_timeout_s)
                if serving is not None and serving.pending():
                    serving.tick()
                else:
                    time.sleep(0.02)
            if failure:
                break
            rc = proc.returncode
            if rc == sw.EXIT_OK:
                break
            death_t = time.time()
            deaths.append({
                "t": death_t, "rc": rc, "generation": generation,
                "signal": -rc if rc < 0 else None,
            })
            # The master's node-failure path: re-queue the dead
            # worker's in-flight leases.
            task_manager.recover_node_tasks(0)
            generation += 1
            if generation >= cfg.max_generations:
                failure = (
                    f"worker did not complete within "
                    f"{cfg.max_generations} generations (last rc={rc})"
                )
                break
        if not failure and serving is not None:
            serving.drain(deadline)
            if serving.pending():
                failure = "watchdog: serving did not drain"
    finally:
        if proc is not None and proc.poll() is None:
            # SIGTERM first: the worker's flight recorder dumps its ring
            # on SIGTERM, which is exactly the evidence we want.
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
        disarm()
        server.stop()
        task_manager.stop()
        reclaim_shm_segments(ep_dir)

    wall = time.time() - t_start
    events = _read_events(os.path.join(ep_dir, "events.jsonl"))
    try:
        if failure:
            raise SoakInvariantError(failure)
        _check_ledger_invariants(events, plan, cfg)
        if serving is not None:
            serving.check_invariant()
    except SoakInvariantError as e:
        dest = _dump_artifacts(
            ep_dir, artifact_dir, plan, seed, episode, str(e)
        )
        print(
            f"SOAK EPISODE FAILED: {e}\n"
            f"  artifacts: {dest}\n"
            f"  repro: python tools/torch_chaos_soak.py --seed {seed} "
            f"--episode {episode}",
            file=sys.stderr, flush=True,
        )
        raise

    # ---- goodput / MTTR accounting ------------------------------------
    step_events = [e for e in events if e.get("kind") == "step"]
    last_dur: Dict[int, float] = {}
    for e in step_events:
        last_dur[e["step"]] = e.get("dur", 0.0)
    productive_s = sum(last_dur.values())
    recoveries = []
    for death in deaths:
        after = [e for e in step_events if e["t"] > death["t"]]
        if after:
            recoveries.append(after[0]["t"] - death["t"])
    trace = (
        _read_trace(os.path.join(ep_dir, "trace_worker.jsonl"), "worker")
        + [
            {
                "origin": "runner",
                "point": t["point"],
                "action": t["action"],
                "rule_id": t["rule_id"],
                "hit": t["hit"],
            }
            for t in plan.runner_schedule.trace
        ]
    )
    trace.sort(key=lambda t: (t["origin"], str(t["rule_id"])))
    report.update({
        "wall_s": round(wall, 3),
        "productive_step_s": round(productive_s, 3),
        "goodput_frac": round(min(productive_s / max(wall, 1e-9), 1.0), 4),
        "faults": trace,
        "deaths": len(deaths),
        "recovery_s": [round(r, 3) for r in recoveries],
        "steps_unique": len(last_dur),
        "steps_executed": len(step_events),
    })
    if serving is not None:
        report["serving"] = serving.summary()
    if not cfg.keep_artifacts_on_success:
        shutil.rmtree(ep_dir, ignore_errors=True)
    return report


def _run_rescale_kind(seed, episode, plan, cfg, work_dir, artifact_dir):
    """Episode kind 4: delegate to the multi-worker live-rescale
    harness and reshape its report to the soak report schema."""
    from dlrover_tpu_torch.testing.rescale_soak import (
        RescaleSoakConfig,
        run_rescale_episode,
    )

    rcfg = RescaleSoakConfig(
        world=2,
        dataset_size=cfg.dataset_size,
        shard_size=cfg.shard_size,
        ckpt_every=cfg.ckpt_every,
        step_ms=cfg.step_ms,
        watchdog_s=cfg.watchdog_s,
        keep_artifacts_on_success=cfg.keep_artifacts_on_success,
        device=cfg.device,
    )
    try:
        report = run_rescale_episode(
            seed,
            cfg=rcfg,
            scenario="kill_during_rescale",
            work_dir=work_dir,
            artifact_dir=artifact_dir,
            runner_schedule=plan.runner_schedule,
            rank_schedules=plan.rank_schedules,
        )
    except SoakInvariantError:
        print(
            f"  repro: python tools/torch_chaos_soak.py --seed {seed} "
            f"--episode {episode}",
            file=sys.stderr, flush=True,
        )
        raise
    gens = report.pop("generations", {})
    report.update({
        "episode": episode,
        "kind": plan.kind,
        "generations": sum(g + 1 for g in gens.values()),
    })
    return report


def _fleet_soak_config(cfg):
    from dlrover_tpu_torch.testing.fleet_soak import FleetSoakConfig

    return FleetSoakConfig(
        watchdog_s=cfg.watchdog_s,
        keep_artifacts_on_success=cfg.keep_artifacts_on_success,
        device=cfg.device,
        config=cfg.fleet_config,
    )


def _run_fleet_kind(seed, episode, plan, cfg, work_dir, artifact_dir):
    """Episode kind replica_kill_reroute: delegate to the serving-fleet
    harness — a subprocess replica is SIGKILLed mid-decode, the router
    re-routes its in-flight ledger and walks the victim's breaker back
    to HEALTHY through half-open probes. The report is already
    soak-shaped."""
    from dlrover_tpu_torch.testing.fleet_soak import run_fleet_episode

    try:
        return run_fleet_episode(
            seed,
            episode=episode,
            cfg=_fleet_soak_config(cfg),
            work_dir=work_dir,
            artifact_dir=artifact_dir,
            runner_schedule=plan.runner_schedule,
        )
    except SoakInvariantError:
        print(
            f"  repro: python tools/torch_chaos_soak.py --seed {seed} "
            f"--episode {episode}",
            file=sys.stderr, flush=True,
        )
        raise


def _run_migration_kind(seed, episode, plan, cfg, work_dir,
                        artifact_dir):
    """Episode kind 6 (kill_during_migration): delegate to the fleet
    harness's §36 scenario — a prefill+decode split fleet whose
    destination replica is SIGKILLed between KV export and import ack.
    The report is already soak-shaped."""
    from dlrover_tpu_torch.testing.fleet_soak import run_migration_episode

    try:
        return run_migration_episode(
            seed,
            episode=episode,
            cfg=_fleet_soak_config(cfg),
            work_dir=work_dir,
            artifact_dir=artifact_dir,
            runner_schedule=plan.runner_schedule,
        )
    except SoakInvariantError:
        print(
            f"  repro: python tools/torch_chaos_soak.py --seed {seed} "
            f"--episode {episode}",
            file=sys.stderr, flush=True,
        )
        raise


def _run_master_kill_kind(seed, episode, plan, cfg, work_dir,
                          artifact_dir):
    """Episode kind 7 (master_kill): delegate to the control-plane
    crash-recovery harness — the master subprocess is SIGKILLed between
    a journaled dispatch and its reply, restarted from the journal, and
    the never-restarted worker must finish with exactly-once accounting
    (docs/DESIGN.md §37). The report is already soak-shaped."""
    from dlrover_tpu_torch.testing.master_kill_soak import (
        run_master_kill_episode,
    )

    return run_master_kill_episode(
        seed, episode, plan, cfg, work_dir, artifact_dir
    )


def _run_autoscale_kind(seed, episode, cfg):
    """Episode kind 5 (straggler_evict): delegate to the closed-loop
    autoscaler harness
    — the same seeded fault+traffic schedule run static, dry-run and
    autoscaled; the autoscaled run must evict the delayed straggler
    within bounded decision windows and strictly beat the static
    goodput fraction. The report is already soak-shaped."""
    from dlrover_tpu_torch.testing.autoscale_soak import (
        AutoscaleSoakConfig,
        run_autoscale_episode,
    )

    acfg = AutoscaleSoakConfig(
        watchdog_s=min(cfg.watchdog_s, 120.0),
    )
    try:
        return run_autoscale_episode(seed, episode=episode, cfg=acfg)
    except SoakInvariantError:
        print(
            f"  repro: python tools/torch_chaos_soak.py --seed {seed} "
            f"--episode {episode}",
            file=sys.stderr, flush=True,
        )
        raise


def run_soak(seed: int = 0, episodes: int = 3,
             cfg: Optional[SoakConfig] = None,
             episode: Optional[int] = None,
             work_dir: Optional[str] = None,
             artifact_dir: Optional[str] = None) -> Dict:
    """Run ``episodes`` chaos episodes (or just ``episode``); returns a
    summary with per-episode reports and aggregate goodput/MTTR."""
    cfg = cfg or SoakConfig()
    work_dir = work_dir or tempfile.mkdtemp(prefix="dlrover_soak_")
    artifact_dir = artifact_dir or os.path.join(work_dir, "artifacts")
    targets = [episode] if episode is not None else list(range(episodes))
    reports = []
    for k in targets:
        logger.info("chaos soak: seed=%d episode=%d starting", seed, k)
        reports.append(
            run_episode(seed, k, cfg, work_dir, artifact_dir)
        )
    all_recoveries = [r for rep in reports for r in rep["recovery_s"]]
    walls = sum(r["wall_s"] for r in reports)
    productive = sum(r["productive_step_s"] for r in reports)
    return {
        "seed": seed,
        "episodes": len(reports),
        "reports": reports,
        "goodput_frac": round(productive / max(walls, 1e-9), 4),
        "mttr_mean_s": round(
            sum(all_recoveries) / len(all_recoveries), 3
        ) if all_recoveries else 0.0,
        "mttr_max_s": round(max(all_recoveries), 3)
        if all_recoveries else 0.0,
        "faults_injected": sum(len(r["faults"]) for r in reports),
        "invariants": "pass",
    }
