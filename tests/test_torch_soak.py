"""The port's seeded chaos soak against the JAX package's
(``tests/test_chaos_soak.py`` and the harness itself).

- ``build_episode_plan`` gives the reference's plan, rule for rule, for
  seeds 0–3 and every episode kind (0–7);
- ``_check_ledger_invariants`` gives the reference's verdict on crafted
  worker ledgers, passing and failing;
- ``soak_worker.apply_shard`` gives the reference's integer leaves
  exactly and its float leaf within 1e-12 (``index_add_`` sums in
  another order than ``np.add.at``);
- episode 0 (worker SIGKILL and a dropped ``get_task`` reply) and the
  ``master_kill`` episode (the master SIGKILLed at a journaled dispatch,
  restarted from its journal, the worker never restarted) run end to
  end on the CPU at a small dataset, each under a 90 s watchdog; the
  serving episode runs through ``tools/torch_chaos_soak.py``, and the
  rescale episode through the soak's dispatch; two copies of episode 0
  run at once, and one runs beside the other's shm checkpoint image,
  without either restoring the other's;
- episodes 4-6 go to their harnesses (``testing/fleet_soak``,
  ``testing/autoscale_soak``) with the soak's seed, schedules, device
  and fleet model; end to end on the CPU they are slow, as the
  reference's are;
- the chaos harness's pod deletion raises naming its ROADMAP item; its
  local kill finds a job's worker by its environment.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dlrover_tpu.testing import soak as ref_soak
from dlrover_tpu.testing import soak_worker as ref_worker
from dlrover_tpu_torch.testing import soak, soak_worker
from tests.torch_event_guard import events_off

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_event_files(monkeypatch):
    events_off(monkeypatch)


def _plan_dict(plan):
    def sched(s):
        if s is None:
            return None
        return {"seed": s.seed, "label": s.label,
                "rules": [r.to_dict() for r in s.rules]}

    return {
        "kind": plan.kind,
        "crash_step": plan.crash_step,
        "torn_persist_nth": plan.torn_persist_nth,
        "fallback_step": plan.fallback_step,
        "master_kill_nth": plan.master_kill_nth,
        "worker": [sched(s) for s in plan.worker_schedules],
        "runner": sched(plan.runner_schedule),
        "ranks": {r: sched(s) for r, s in plan.rank_schedules.items()},
    }


@pytest.mark.parametrize("episode", range(8))
@pytest.mark.parametrize("seed", range(4))
def test_episode_plans_match_the_reference(seed, episode):
    ours = _plan_dict(soak.build_episode_plan(seed, episode))
    assert ours == _plan_dict(ref_soak.build_episode_plan(seed, episode))
    assert ours["kind"] == soak.EPISODE_KINDS[episode]
    # A smaller dataset moves the steps the plan draws: still equal.
    cfg = soak.SoakConfig(dataset_size=256, ckpt_every=3)
    ref_cfg = ref_soak.SoakConfig(dataset_size=256, ckpt_every=3)
    assert _plan_dict(soak.build_episode_plan(seed, episode, cfg)) == \
        _plan_dict(ref_soak.build_episode_plan(seed, episode, ref_cfg))


def test_plans_cover_core_faults_and_refuse_small_datasets():
    """The reference's coverage test: the first three episodes hold the
    four required fault classes; a dataset too small for two checkpoint
    intervals is refused."""
    plans = [soak.build_episode_plan(0, k) for k in range(3)]
    points = {
        r.point
        for p in plans
        for s in p.worker_schedules + [p.runner_schedule]
        for r in s.rules
    }
    assert {"agent.worker.crash", "rpc.get.drop_reply",
            "ckpt.persist.torn_write", "serving.step.error"} <= points
    with pytest.raises(ValueError, match="dataset too small"):
        soak.build_episode_plan(0, 0, soak.SoakConfig(dataset_size=64))


def _ledger(n=64, shard=16, every=2, mutate=None):
    """A passing worker ledger: a crash after step 3, a restore of step
    2, then the rest to the done line."""
    steps = n // shard
    events = [{"kind": "worker_start", "generation": 0},
              {"kind": "save", "step": 0, "crc": 100, "generation": 0}]
    for s in range(1, 4):
        events.append({"kind": "step", "step": s, "generation": 0})
        if s % every == 0:
            events.append({"kind": "save", "step": s, "crc": 100 + s,
                           "generation": 0})
    events.append({"kind": "worker_start", "generation": 1})
    events.append({"kind": "restore", "step": 2, "crc": 102,
                   "source": "storage", "generation": 1})
    for s in range(3, steps + 1):
        events.append({"kind": "step", "step": s, "generation": 1})
        if s % every == 0:
            events.append({"kind": "save", "step": s, "crc": 100 + s,
                           "generation": 1})
    events.append({"kind": "done", "sum": n * (n - 1) // 2,
                   "hist": ref_worker.expected_hist(n).tolist(),
                   "generation": 1})
    if mutate:
        mutate(events)
    return events


def _set(kind, key, value, nth=0):
    def mutate(events):
        [e for e in events if e["kind"] == kind][nth][key] = value
    return mutate


def _drop(kind):
    def mutate(events):
        events[:] = [e for e in events if e["kind"] != kind]
    return mutate


def _append(entry):
    def mutate(events):
        events.insert(-1, entry)
    return mutate


LEDGERS = {
    "passes": (None, "crash_drop"),
    "torn_fallback_holds": (None, "torn_ckpt"),
    "no_done": (_drop("done"), "crash_drop"),
    "sum_off": (_set("done", "sum", 1), "crash_drop"),
    "hist_off": (_set("done", "hist", [0] * 64), "crash_drop"),
    "restore_crc": (_set("restore", "crc", 7), "crash_drop"),
    "restore_unsaved": (_set("restore", "step", 9), "crash_drop"),
    "saves_backwards": (_append({"kind": "save", "step": 1, "crc": 1,
                                 "generation": 1}), "crash_drop"),
    "storage_crc_mismatch": (_append({"kind": "restore_crc_mismatch",
                                      "step": 2, "source": "storage"}),
                             "crash_drop"),
    "memory_crc_mismatch": (_append({"kind": "restore_crc_mismatch",
                                     "step": 2}), "crash_drop"),
    "torn_wrong_fallback": (_set("restore", "step", 0), "torn_ckpt"),
    "torn_never_restored": (_drop("restore"), "torn_ckpt"),
}


def _verdict(mod, events, kind):
    plan = mod.EpisodePlan(kind=kind, fallback_step=2)
    cfg = mod.SoakConfig(dataset_size=64, shard_size=16)
    try:
        mod._check_ledger_invariants(json.loads(json.dumps(events)), plan,
                                     cfg)
    except AssertionError as e:
        return type(e).__name__, str(e)
    return "pass", ""


@pytest.mark.parametrize("name", sorted(LEDGERS))
def test_ledger_invariants_match_the_reference(name):
    mutate, kind = LEDGERS[name]
    events = _ledger(mutate=mutate)
    ours = _verdict(soak, events, kind)
    assert ours == _verdict(ref_soak, events, kind)
    assert (ours[0] == "pass") == (name in (
        "passes", "torn_fallback_holds", "memory_crc_mismatch"))


@pytest.mark.parametrize("start, end", [(0, 16), (5, 300), (250, 251),
                                        (1000, 1517)])
def test_apply_shard_matches_the_reference(start, end):
    ours = soak_worker.fresh_state("cpu")
    ref = ref_worker.fresh_state()
    for s, e in ((start, end), (end, end + 37)):
        soak_worker.apply_shard(ours, s, e)
        ref_worker.apply_shard(ref, s, e)
    assert int(ours["sum"]) == int(ref["sum"])
    np.testing.assert_array_equal(ours["hist"].numpy(), ref["hist"])
    np.testing.assert_allclose(ours["vec"].numpy(), ref["vec"], rtol=1e-12)
    assert {k: v.dtype for k, v in ours.items()} == {
        "sum": torch.int64, "hist": torch.int64, "vec": torch.float64}
    # The checksum hashes the numpy dtype names, as the reference's does.
    ints = {k: ours[k] for k in ("sum", "hist")}
    assert soak_worker.state_crc(ints) == ref_worker.state_crc(
        {k: ref[k] for k in ("sum", "hist")})
    whole = soak_worker.fresh_state("cpu")
    soak_worker.apply_shard(whole, 0, 512)
    assert int(whole["sum"]) == soak_worker.expected_sum(512)
    np.testing.assert_array_equal(whole["hist"].numpy(),
                                  soak_worker.expected_hist(512))


def _cpu_cfg(**kw):
    args = dict(dataset_size=256, shard_size=16, serve=False,
                watchdog_s=90.0, device="cpu")
    args.update(kw)
    return soak.SoakConfig(**args)


def test_soak_episode_crash_and_dropped_reply(tmp_path):
    """Episode 0 at seed 0 on the CPU: the worker is SIGKILLed mid-step
    and a get_task reply is dropped; after the restart and the
    checkpoint and shard-checkpoint restore the invariants hold."""
    summary = soak.run_soak(seed=0, episode=0, cfg=_cpu_cfg(),
                            work_dir=str(tmp_path))
    assert summary["invariants"] == "pass"
    report = summary["reports"][0]
    assert report["kind"] == "crash_drop"
    assert report["deaths"] == 1
    assert report["generations"] == 2
    fired = {f["rule_id"] for f in report["faults"]}
    assert fired == {"worker-sigkill", "drop-get-task-reply"}
    assert summary["mttr_mean_s"] > 0


def test_master_kill_episode(tmp_path):
    """Episode 7 at seed 0 on the CPU: the master dies at its planned
    journaled dispatch, comes back from the journal on the same port
    with the next epoch, and the never-restarted worker finishes with
    exactly-once accounting; the journal ends clean."""
    cfg = _cpu_cfg()
    plan = soak.build_episode_plan(0, 7, cfg)
    summary = soak.run_soak(seed=0, episode=7, cfg=cfg,
                            work_dir=str(tmp_path))
    report = summary["reports"][0]
    assert report["kind"] == "master_kill"
    assert report["deaths"] == 0 and report["generations"] == 1
    assert report["master_epochs"] == [1, 2]
    assert [(f["rule_id"], f["hit"]) for f in report["faults"]] == [
        ("master-sigkill", plan.master_kill_nth)]
    journal = report["journal"]
    assert journal["clean_shutdown"]
    assert journal["kinds"]["header"] == 2
    assert journal["kinds"]["dispatch"] >= plan.master_kill_nth
    assert journal["stats"][0] is None  # the killed generation wrote none
    assert journal["stats"][1]["master_epoch"] == 2
    assert journal["fs"]["type"]
    assert report["recovery_s"][0] < 60.0


def test_episode_job_names_are_unique_to_the_run(tmp_path):
    """The job name names the workers' shm checkpoint segments, which
    every run on the host shares: it is stable within one runner and
    episode directory, and differs for the same seed and episode in
    another directory."""
    a = str(tmp_path / "a" / "soak-s0-e7")
    b = str(tmp_path / "b" / "soak-s0-e7")
    assert soak.episode_job_name(a) == soak.episode_job_name(a)
    assert soak.episode_job_name(a) != soak.episode_job_name(b)
    assert soak.episode_job_name(a).startswith(
        f"soak-s0-e7-{os.getpid()}-")


def test_two_copies_of_one_episode_run_at_once(tmp_path):
    """Episode 0 at seed 0 twice at once, in two processes: each
    restarted worker restores its own run's shm image, never the other
    copy's, and both copies hold every invariant."""
    tool = os.path.join(REPO, "tools", "torch_chaos_soak.py")
    procs = []
    for name in ("a", "b"):
        d = tmp_path / name
        d.mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, tool, "--episode", "0", "--dataset-size",
             "256", "--watchdog-s", "90", "--device", "cpu",
             "--no-serving", "--artifact-dir", str(d / "art")],
            env=dict(os.environ, TMPDIR=str(d)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
        summary = json.loads(out.strip().splitlines()[-1])
        assert summary["invariants"] == "pass"
        assert summary["reports"][0]["generations"] == 2


def test_another_copys_shm_image_is_left_alone(tmp_path, monkeypatch):
    """A copy of episode 0 at seed 0 in another work dir (running at
    once, or killed before its clean-up) has its shm image on the host.
    This run's workers save, restore and reclaim only their own
    segment: every invariant holds, and the other copy still restores
    its image afterwards, bit for bit."""
    from dlrover_tpu_torch.flash_ckpt.engine import CheckpointEngine

    other = soak.episode_job_name(str(tmp_path / "other" / "soak-s0-e0"))
    assert other != soak.episode_job_name(
        str(tmp_path / "mine" / "soak-s0-e0"))
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", other)
    state = soak_worker.fresh_state()
    soak_worker.apply_shard(state, 0, 64)
    crc = soak_worker.state_crc(state)
    engine = CheckpointEngine(str(tmp_path / "other_ckpt"), standalone=True)
    engine.save_to_memory(999, state, user_meta={"state_crc": crc,
                                                 "shard_ckpt": ""})
    monkeypatch.delenv("DLROVER_TPU_JOB_NAME")
    try:
        summary = soak.run_soak(seed=0, episode=0, cfg=_cpu_cfg(),
                                work_dir=str(tmp_path / "mine"))
        assert summary["invariants"] == "pass"
        assert summary["reports"][0]["generations"] == 2
        step, restored, meta = engine.load()
        assert step == 999 and engine.last_restore_source == "memory"
        assert soak_worker.state_crc(restored) == meta["state_crc"] == crc
    finally:
        engine.close()
        soak.reclaim_shm_segments(str(tmp_path / "other" / "soak-s0-e0"))


def test_serving_episode_through_the_tool(tmp_path, capsys):
    """Episode 2 (a failed prefetch fetch, a dropped done-report reply, a
    serving step that raises) through ``tools/torch_chaos_soak.py`` on
    the CPU, with the tiny serving engine: every request completes."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_chaos_soak", os.path.join(REPO, "tools",
                                         "torch_chaos_soak.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--episode", "2", "--dataset-size", "256",
                      "--watchdog-s", "90", "--device", "cpu",
                      "--artifact-dir", str(tmp_path / "art")]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    report = summary["reports"][0]
    assert report["kind"] == "serving_report"
    assert {f["rule_id"] for f in report["faults"]} == {
        "prefetch-fetch-fails", "drop-done-report-reply",
        "serving-step-raises"}
    assert report["serving"]["requests"] == 4
    assert report["serving"]["tokens"] == 16
    assert report["serving"]["call_counts"]["decode"] > 0


def test_rescale_episode_through_the_soak(tmp_path):
    """Episode 3 (``kill_during_rescale``) through the soak's dispatch to
    the ported live-rescale harness: rank 1 dies mid-step, rank 0 in the
    restore-to-first-step window, a plan broadcast is dropped; the
    rescale invariants hold and the report is soak-shaped."""
    summary = soak.run_soak(seed=0, episode=3, cfg=_cpu_cfg(
        dataset_size=512, watchdog_s=120.0), work_dir=str(tmp_path))
    report = summary["reports"][0]
    assert report["kind"] == "kill_during_rescale"
    assert report["episode"] == 3 and report["generations"] >= 3
    assert {f["rule_id"] for f in report["faults"]} == {
        "worker-sigkill", "kill-mid-rescale", "drop-plan-broadcast"}


@pytest.mark.parametrize("episode, module, harness, kind", [
    (4, "fleet_soak", "run_fleet_episode", "replica_kill_reroute"),
    (5, "autoscale_soak", "run_autoscale_episode", "straggler_evict"),
    (6, "fleet_soak", "run_migration_episode", "kill_during_migration"),
])
def test_harness_kinds_dispatch_to_their_harnesses(
        monkeypatch, tmp_path, episode, module, harness, kind):
    """The soak hands episodes 4 and 6 to ``testing/fleet_soak`` with
    their seed, the plan's runner schedule and the directories, their
    replicas on ``SoakConfig``'s device serving its fleet model, and
    episode 5 to ``testing/autoscale_soak`` under the soak's watchdog
    (at most 120 s)."""
    import importlib

    mod = importlib.import_module(f"dlrover_tpu_torch.testing.{module}")
    seen = {}

    def harness_fn(seed, episode, cfg, **kw):
        seen.update(seed=seed, episode=episode, cfg=cfg, **kw)
        return {"episode": episode, "kind": kind}

    monkeypatch.setattr(mod, harness, harness_fn)
    cfg = _cpu_cfg(device="cuda", fleet_config="flagship", watchdog_s=177.0)
    report = soak.run_episode(2, episode, cfg, str(tmp_path),
                              str(tmp_path / "art"))
    assert report == {"episode": episode, "kind": kind}
    plan = soak.build_episode_plan(2, episode, cfg)
    assert plan.kind == kind
    assert (seen["seed"], seen["episode"]) == (2, episode)
    if module == "autoscale_soak":
        assert seen["cfg"].watchdog_s == 120.0
        assert set(seen) == {"seed", "episode", "cfg"}
        return
    assert (seen["cfg"].device, seen["cfg"].config) == ("cuda", "flagship")
    assert seen["cfg"].watchdog_s == 177.0
    assert [r.to_dict() for r in seen["runner_schedule"].rules] == [
        r.to_dict() for r in plan.runner_schedule.rules]
    assert (seen["work_dir"], seen["artifact_dir"]) == (
        str(tmp_path), str(tmp_path / "art"))
    assert soak.SoakConfig().fleet_config == "tiny"


@pytest.mark.slow
def test_straggler_evict_episode_through_the_soak(tmp_path):
    """Episode 5 (``straggler_evict``) at seed 0 through the soak's
    dispatch to the autoscale harness: static, dry-run and autoscaled
    runs of one schedule; the harness's invariants hold (it raises
    otherwise), the autoscaled run beats the static goodput, the
    straggler is evicted within the bound, the dry run actuates nothing
    and the recording replays to the live ledger. Slow, as the
    reference's episode: its wall-clock attribution invariant (90% of
    the non-train time) sits at its edge inside pytest, for the
    reference's harness as for this one."""
    summary = soak.run_soak(seed=0, episode=5, cfg=_cpu_cfg(),
                            work_dir=str(tmp_path))
    rep = summary["reports"][0]
    assert rep["kind"] == "straggler_evict" and rep["invariants"] == "pass"
    assert rep["autoscale_goodput_frac"] > rep["static_goodput_frac"]
    assert rep["autoscale_mitigate_windows"] <= 30
    assert rep["dry_run_actuations_total"] == 0
    assert rep["whatif_identity_ok"] is True
    assert rep["whatif_perturbed_decisions"] != rep[
        "whatif_recorded_decisions"]
    assert rep["deaths"] == 3


@pytest.mark.slow
@pytest.mark.parametrize("episode", [4, 6])
def test_fleet_episodes_through_the_soak(tmp_path, episode):
    """Episodes 4 (``replica_kill_reroute``) and 6
    (``kill_during_migration``) end to end on the CPU: tiny paged
    subprocess replicas, one SIGKILLed mid-decode or holding an unacked
    import; every request completes or fails once, the victim restarts,
    the planned crash fired and every pool conserves its blocks."""
    summary = soak.run_soak(seed=0, episode=episode, cfg=_cpu_cfg(
        watchdog_s=150.0), work_dir=str(tmp_path))
    report = summary["reports"][0]
    assert report["completed"] + report["failed"] == report["requests"]
    assert report["restarts"] >= 1
    point = {4: "fleet.replica.step", 6: "fleet.replica.import"}[episode]
    assert any(f["point"] == point and f["action"] == "crash"
               for f in report["faults"])
    if episode == 6:
        assert report["migrations"] >= 1
        assert report["migration_failures"] >= 1
    for stats in report["kv_blocks"].values():
        assert stats["used"] + stats["free"] + stats["cached"] == (
            stats["total"])


def test_chaos_kills_a_local_worker_and_refuses_pods():
    """``run_chaos`` SIGKILLs the job's local worker and spares another
    job's process; ``delete_one_pod`` deletes a running worker pod of
    the job and refuses the rest (a pending worker, the master's pod)."""
    from dlrover_tpu_torch.testing import chaos

    job = f"chaos{os.getpid()}"
    env = dict(os.environ, DLROVER_TPU_JOB_NAME=job,
               DLROVER_TPU_PROCESS_ID="3")
    victim = subprocess.Popen([sys.executable, "-c",
                               "import time; time.sleep(60)"], env=env)
    bystander = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)"],
        env=dict(env, DLROVER_TPU_JOB_NAME=job + "x"))
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if chaos.find_local_workers(job):
                break
            time.sleep(0.05)
        assert chaos.find_local_workers(job) == [(victim.pid, 3)]
        chaos.run_chaos(job, rounds=1, seed=0)
        assert victim.wait(timeout=10) == -signal.SIGKILL
        assert bystander.poll() is None
    finally:
        for p in (victim, bystander):
            if p.poll() is None:
                p.kill()
                p.wait()
    # The k8s surface: one running worker pod of the job goes, never
    # the master's pod nor a pending one.
    from tests.test_torch_k8s_backend import FakeK8sApi

    api = FakeK8sApi(auto_run=False)
    for name, labels, phase in (
            (f"{job}-worker-0", {"job-name": job}, "Pending"),
            (f"{job}-worker-1", {"job-name": job}, "Running"),
            (f"{job}-dlrover-master",
             {"job-name": job, "role": "dlrover-master"}, "Running")):
        api.create_pod("default", {"metadata": {"name": name,
                                                "labels": labels}})
        api.set_phase(name, phase)
    assert chaos.delete_one_pod(job, api=api) == f"{job}-worker-1"
    assert api.deleted == [f"{job}-worker-1"]
    assert chaos.delete_one_pod(job, api=api) is None
