"""master_kill chaos episode: SIGKILL the control plane, not a worker.

Episode kind 7 of the chaos soak (docs/DESIGN.md §37). The master runs
as its own subprocess (:mod:`dlrover_tpu_torch.testing.soak_master`) with a
durable journal; a seeded fault rule crashes it at the
``master.journal.write`` point with ``kind=dispatch`` — AFTER a shard
lease became durable, BEFORE the reply reached the worker, the
nastiest window for exactly-once accounting. The harness restarts the
master (generation 1, same journal, same port, no faults) and the
training worker — which was given a ``DLROVER_TPU_MASTER_OUTAGE_S``
ride-through window and is NEVER restarted — must finish the dataset.

Asserted invariants:

1. **Exactly-once across the master crash** — the worker's
   order-independent integer state equals the full-dataset expectation
   (the journaled-but-undelivered lease is timeout-requeued exactly
   once, delivered done-reports are never re-dispatched).
2. **Zero worker restarts** — one generation, zero deaths: the outage
   mode + epoch fencing rode the crash out entirely client-side.
3. **Epoch fencing** — generation 1 answers with master_epoch ==
   generation 0's + 1 (the restart is visible, monotone, and fenced).
4. **Bounded recovery** — first post-kill worker step lands within
   ``recovery_bound_s``; the master's clean SIGTERM shutdown leaves a
   ``clean_shutdown`` journal (graceful drain flushed it).
5. **Deterministic trace** — the master's fault trace contains exactly
   the planned crash at the planned hit count (same seed, same trace).

The port's copy of ``dlrover_tpu/testing/master_kill_soak.py``. The
worker holds its state on ``cfg.device`` (``cuda`` unless the config
asks for ``cpu``); the master processes import no ``torch``. Each
master generation writes its journal's ``stats()`` when it stops
(``--stats-file``), and the report carries them with the final
journal's replay (``journal``).
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.fault import FaultRule, FaultSchedule
from dlrover_tpu_torch.fault.registry import SCHEDULE_ENV, TRACE_ENV
from dlrover_tpu_torch.testing.soak import (
    _repo_root,
    episode_job_name,
    reclaim_shm_segments,
)

MASTER_READY_TIMEOUT_S = 30.0
RECOVERY_BOUND_S = 60.0
WORKER_OUTAGE_S = 45.0


def build_master_schedule(ep_seed: int, nth: int) -> FaultSchedule:
    return FaultSchedule([
        FaultRule(
            "master.journal.write", action="crash", nth=nth,
            match={"kind": "dispatch"}, rule_id="master-sigkill",
        ),
    ], seed=ep_seed, label="master-gen0")


def _spawn_master(ep_dir: str, journal: str, ready_file: str, port: int,
                  generation: int, schedule_path: str,
                  task_timeout_s: float) -> subprocess.Popen:
    env = dict(os.environ)
    env.update({
        TRACE_ENV: os.path.join(ep_dir, f"trace_master_gen{generation}.jsonl"),
        "PYTHONPATH": _repo_root() + os.pathsep + env.get("PYTHONPATH", ""),
    })
    if schedule_path:
        env[SCHEDULE_ENV] = schedule_path
    else:
        env.pop(SCHEDULE_ENV, None)
    args = [
        sys.executable, "-m", "dlrover_tpu_torch.testing.soak_master",
        "--port", str(port),
        "--journal", journal,
        "--ready-file", ready_file,
        "--task-timeout", str(task_timeout_s),
        "--stats-file", _stats_path(ep_dir, generation),
    ]
    with open(
        os.path.join(ep_dir, f"master_gen{generation}.log"), "w"
    ) as log:
        return subprocess.Popen(
            args, env=env, stdout=log, stderr=subprocess.STDOUT,
            cwd=_repo_root(),
        )


def _stats_path(ep_dir: str, generation: int) -> str:
    return os.path.join(ep_dir, f"journal_stats_gen{generation}.json")


def _wait_ready(ready_file: str, proc: subprocess.Popen,
                timeout: float = MASTER_READY_TIMEOUT_S) -> dict:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(ready_file):
            try:
                with open(ready_file) as f:
                    return json.load(f)
            except (OSError, ValueError):
                pass  # mid-replace; retry
        if proc.poll() is not None:
            raise RuntimeError(
                f"soak master exited rc={proc.returncode} before ready"
            )
        time.sleep(0.05)
    raise RuntimeError("soak master never became ready")


def _spawn_worker(cfg, ep_dir: str, master_port: int) -> subprocess.Popen:
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "1")
    env.update({
        "DLROVER_TPU_JOB_NAME": episode_job_name(ep_dir),
        "DLROVER_TPU_FLIGHT_DIR": os.path.join(ep_dir, "flight"),
        TRACE_ENV: os.path.join(ep_dir, "trace_worker.jsonl"),
        "PYTHONPATH": _repo_root() + os.pathsep + env.get("PYTHONPATH", ""),
        # The whole point: the worker rides the master crash out in
        # outage mode instead of dying on exhausted retries.
        "DLROVER_TPU_MASTER_OUTAGE_S": str(WORKER_OUTAGE_S),
    })
    env.pop(SCHEDULE_ENV, None)  # no worker-side faults this episode
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
        "--generation", "0",
        "--step-ms", str(cfg.step_ms),
        "--device", cfg.device,
    ]
    with open(os.path.join(ep_dir, "worker_gen0.log"), "w") as log:
        return subprocess.Popen(
            args, env=env, stdout=log, stderr=subprocess.STDOUT,
            cwd=_repo_root(),
        )


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None  # a SIGKILLed generation writes none


def _filesystem_of(path: str) -> Dict[str, str]:
    """The mount ``path`` lies on, from ``/proc/mounts`` (longest
    mount-point prefix): its mount point, type and device."""
    real = os.path.realpath(path)
    best = {"mount": "", "type": "unknown", "device": ""}
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                mnt = parts[1].replace("\\040", " ")
                inside = real == mnt or real.startswith(
                    mnt.rstrip("/") + "/")
                if inside and len(mnt) >= len(best["mount"]):
                    best = {"mount": mnt, "type": parts[2],
                            "device": parts[0]}
    except OSError:
        pass
    return best


def _dump_artifacts(ep_dir: str, artifact_dir: str, seed: int,
                    episode: int, reason: str) -> str:
    os.makedirs(artifact_dir, exist_ok=True)
    dest = os.path.join(artifact_dir, f"soak_seed{seed}_ep{episode}")
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ep_dir, dest, dirs_exist_ok=True)
    with open(os.path.join(dest, "failure.json"), "w") as f:
        json.dump({
            "seed": seed, "episode": episode, "kind": "master_kill",
            "reason": reason,
        }, f, indent=2)
    return dest


def run_master_kill_episode(seed: int, episode: int, plan, cfg,
                            work_dir: str, artifact_dir: str) -> Dict:
    """Run the master_kill episode; returns a soak-shaped report dict.
    Raises SoakInvariantError (after dumping artifacts) on failure."""
    from dlrover_tpu_torch.master.journal import load_journal
    from dlrover_tpu_torch.testing.soak import (
        SoakInvariantError,
        _check_ledger_invariants,
        _read_events,
        _read_trace,
    )

    ep_seed = seed * 10007 + episode
    ep_dir = os.path.join(work_dir, f"soak-s{seed}-e{episode}")
    shutil.rmtree(ep_dir, ignore_errors=True)
    os.makedirs(os.path.join(ep_dir, "flight"), exist_ok=True)
    os.makedirs(os.path.join(ep_dir, "ckpt"), exist_ok=True)
    journal = os.path.join(ep_dir, "master.journal")
    nth = plan.master_kill_nth

    master_schedule = build_master_schedule(ep_seed, nth)
    schedule_path = os.path.join(ep_dir, "schedule_master_gen0.json")
    with open(schedule_path, "w") as f:
        f.write(master_schedule.to_json())

    report: Dict = {
        "episode": episode, "seed": seed, "kind": "master_kill",
        "generations": 1,
    }
    t_start = time.time()
    deadline = t_start + cfg.watchdog_s
    failure: Optional[str] = None
    worker: Optional[subprocess.Popen] = None
    master: Optional[subprocess.Popen] = None
    epochs: List[int] = []
    t_kill = 0.0
    master_restart_s = 0.0
    try:
        ready0 = os.path.join(ep_dir, "master_ready_gen0.json")
        master = _spawn_master(
            ep_dir, journal, ready0, 0, 0, schedule_path,
            cfg.task_timeout_s,
        )
        info0 = _wait_ready(ready0, master)
        epochs.append(info0["epoch"])
        port = info0["port"]

        worker = _spawn_worker(cfg, ep_dir, port)

        # Phase 1: the seeded crash SIGKILLs the master mid-episode.
        while master.poll() is None:
            if time.time() > deadline:
                failure = "watchdog: master crash never fired"
                break
            if worker.poll() is not None:
                failure = (
                    f"worker exited rc={worker.returncode} before the "
                    f"master crash fired (nth={nth} too high?)"
                )
                break
            time.sleep(0.02)
        if not failure:
            t_kill = time.time()
            if master.returncode != -signal.SIGKILL:
                failure = (
                    f"master gen0 exited rc={master.returncode}, "
                    f"expected SIGKILL from the fault schedule"
                )
        # Phase 2: restart from the journal — same port, no faults.
        if not failure:
            ready1 = os.path.join(ep_dir, "master_ready_gen1.json")
            master = _spawn_master(
                ep_dir, journal, ready1, port, 1, "",
                cfg.task_timeout_s,
            )
            info1 = _wait_ready(ready1, master)
            epochs.append(info1["epoch"])
            master_restart_s = time.time() - t_kill
        # Phase 3: the never-restarted worker must finish the dataset.
        if not failure:
            while worker.poll() is None:
                if time.time() > deadline:
                    failure = "watchdog: worker never finished after restart"
                    break
                if master.poll() is not None:
                    failure = (
                        f"master gen1 died rc={master.returncode}"
                    )
                    break
                time.sleep(0.05)
        if not failure and worker.returncode != 0:
            failure = f"worker exited rc={worker.returncode} (expected 0)"
        # Phase 4: graceful SIGTERM shutdown must drain + close the
        # journal (clean_shutdown asserted below).
        if not failure and master.poll() is None:
            master.terminate()
            try:
                master.wait(timeout=15)
            except subprocess.TimeoutExpired:
                master.kill()
                failure = "master gen1 did not exit on SIGTERM"
    finally:
        for proc in (worker, master):
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=5)
        reclaim_shm_segments(ep_dir)

    wall = time.time() - t_start
    events = _read_events(os.path.join(ep_dir, "events.jsonl"))
    master_trace = _read_events(
        os.path.join(ep_dir, "trace_master_gen0.jsonl")
    )
    try:
        if failure:
            raise SoakInvariantError(failure)
        # (1) exactly-once + checkpoint integrity, from the worker
        # ledger — identical invariant to the worker-kill kinds.
        _check_ledger_invariants(events, plan, cfg)
        # (2) zero worker restarts: one generation, one worker_start.
        starts = [e for e in events if e.get("kind") == "worker_start"]
        if len(starts) != 1:
            raise SoakInvariantError(
                f"worker restarted: {len(starts)} worker_start events "
                f"(outage ride-through failed)"
            )
        # (3) epoch fencing: restart bumped the incarnation by one.
        if epochs != [1, 2]:
            raise SoakInvariantError(
                f"master epochs {epochs}, expected [1, 2] "
                f"(journal epoch not monotone across restart)"
            )
        # (4) bounded recovery.
        post = [
            e for e in events
            if e.get("kind") == "step" and e.get("t", 0.0) > t_kill
        ]
        if not post:
            raise SoakInvariantError(
                "no worker step after the master kill"
            )
        recovery = post[0]["t"] - t_kill
        if recovery > RECOVERY_BOUND_S:
            raise SoakInvariantError(
                f"recovery {recovery:.1f}s exceeds bound "
                f"{RECOVERY_BOUND_S}s"
            )
        final = load_journal(journal)
        if not final.clean_shutdown:
            raise SoakInvariantError(
                "graceful SIGTERM shutdown did not close the journal"
            )
        # (5) deterministic fault trace: exactly the planned crash,
        # at exactly the planned hit count.
        crashes = [
            t for t in master_trace
            if t.get("rule_id") == "master-sigkill"
            and t.get("action") == "crash"
        ]
        if len(crashes) != 1 or crashes[0].get("hit") != nth:
            raise SoakInvariantError(
                f"master fault trace diverged from plan: {crashes} "
                f"(expected one crash at hit {nth})"
            )
    except SoakInvariantError as e:
        dest = _dump_artifacts(ep_dir, artifact_dir, seed, episode, str(e))
        print(
            f"SOAK EPISODE FAILED: {e}\n"
            f"  artifacts: {dest}\n"
            f"  repro: python tools/torch_chaos_soak.py --seed {seed} "
            f"--episode {episode}",
            file=sys.stderr, flush=True,
        )
        raise

    final_journal = load_journal(journal)
    journal_report = {
        "records": final_journal.records,
        "kinds": dict(final_journal.kinds),
        "corrupt_lines": final_journal.corrupt_lines,
        "clean_shutdown": final_journal.clean_shutdown,
        "segment_bytes": os.path.getsize(journal),
        "fs": _filesystem_of(journal),
        "stats": [_read_json(_stats_path(ep_dir, g)) for g in (0, 1)],
    }
    step_events = [e for e in events if e.get("kind") == "step"]
    last_dur: Dict[int, float] = {}
    for e in step_events:
        last_dur[e["step"]] = e.get("dur", 0.0)
    productive_s = sum(last_dur.values())
    post = [e for e in step_events if e.get("t", 0.0) > t_kill]
    recovery = post[0]["t"] - t_kill if post else 0.0
    trace = _read_trace(
        os.path.join(ep_dir, "trace_master_gen0.jsonl"), "master"
    ) + _read_trace(os.path.join(ep_dir, "trace_worker.jsonl"), "worker")
    trace.sort(key=lambda t: (t["origin"], str(t["rule_id"])))
    report.update({
        "wall_s": round(wall, 3),
        "productive_step_s": round(productive_s, 3),
        "goodput_frac": round(min(productive_s / max(wall, 1e-9), 1.0), 4),
        "faults": trace,
        "deaths": 0,              # zero WORKER deaths — the invariant
        "master_kills": 1,
        "master_restart_s": round(master_restart_s, 3),
        "recovery_s": [round(recovery, 3)],
        "master_epochs": epochs,
        "journal": journal_report,
        "steps_unique": len(last_dur),
        "steps_executed": len(step_events),
    })
    if not cfg.keep_artifacts_on_success:
        shutil.rmtree(ep_dir, ignore_errors=True)
    return report
