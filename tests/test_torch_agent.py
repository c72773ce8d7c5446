"""The port's elastic agent end to end: real worker subprocesses under an
in-process port master, the scenarios of the reference's
``tests/test_elastic_agent.py`` with the reference's assertions.

The workers are ``tests/workers/torch_simple_train.py``, the torch twin
of the reference's ``simple_train.py`` (the same argv and progress-file
format) on the port's ``Checkpointer``: runs to success; a self-crash at
step 3 resumes at step 4 from memory; an external SIGKILL resumes from
memory; ``max_restarts 0`` gives up; and two agents of a two-node world
leave together through the exit barrier. The crash scenario also runs
through the JAX package's master, saver, agent and worker, and gives the
same run result and progress lines. With ``warm_standby`` the relaunch
is the pre-spawned standby (which imported torch and left CUDA alone),
and a dead standby falls back to a cold spawn. The node check
(``agent/node_check.run_network_check`` over the port's probe on gloo
CPU worlds, the reference's ``tests/test_node_check.py``): two healthy
nodes, a rigged node isolated and marked broken, a straggler flagged.
The capture switch (``DLROVER_TPU_TIMER_XLA``) puts the injection
first on the workers' PYTHONPATH; the master's switches not ported yet
raise; a journaled local master comes back from its journal; the hang
diagnostician takes the out-of-band metric context. A worker held past
its hang deadline, then SIGTERMed: the agent reports its hang
watchdog's stack dump and its flight recorder's crash dump to the master,
for that incarnation only, and appends its native stacks to its log once
it sees the hang dump; the post-mortem stop appends every live worker's.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import json
import os
import signal
import threading
import time

import pytest

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.training import (
    ElasticAgent,
    RunResult,
    WorkerSpec,
)
from dlrover_tpu_torch.flash_ckpt.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.master.local_master import LocalJobMaster
from tests.torch_event_guard import events_off

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(__file__), "workers",
                      "torch_simple_train.py")


@pytest.fixture(autouse=True)
def _no_event_files(monkeypatch):
    events_off(monkeypatch)


@pytest.fixture()
def env_isolation(monkeypatch, tmp_path):
    job = f"tagent_t{time.time_ns() % 1000000}"
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", job)
    monkeypatch.setenv("DLROVER_TPU_SHARED_DIR", str(tmp_path / "uds"))
    monkeypatch.setenv("DLROVER_TPU_NODE_RANK", "0")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield tmp_path
    for seg in os.listdir("/dev/shm"):
        if job in seg:
            os.unlink(os.path.join("/dev/shm", seg))


def _master(node_num):
    from dlrover_tpu_torch.master.node.job_context import JobContext

    JobContext.reset_singleton()
    m = LocalJobMaster(port=0, node_num=node_num)
    m.prepare()
    return m


@pytest.fixture()
def master(env_isolation):
    m = _master(1)
    yield m
    m.stop()


@pytest.fixture()
def saver_client(master):
    client = MasterClient(f"localhost:{master.port}", node_id=0)
    AsyncCheckpointSaver.reset()
    saver = AsyncCheckpointSaver.start_async_saving_ckpt(client=client)
    yield client, saver
    saver.unlink_all(2)
    AsyncCheckpointSaver.reset()
    client.close()


def _spec(tmp_path, total=10, crash_at=-1, max_restarts=2, **kw):
    out = str(tmp_path / "progress.txt")
    ckpt_dir = str(tmp_path / "ckpt")
    return (
        WorkerSpec(
            entrypoint=WORKER,
            args=[str(total), out, ckpt_dir, str(crash_at)],
            nproc_per_node=1,
            max_restarts=max_restarts,
            node_rank=0,
            monitor_interval=0.2,
            **kw,
        ),
        out,
    )


def _read_progress(out):
    if not os.path.exists(out):
        return []
    lines = []
    for line in open(out):
        pid, step, restart, w0 = line.split()
        lines.append((int(pid), int(step), int(restart.split("=")[1]),
                      float(w0.split("=")[1])))
    return lines


def _run_in_thread(agent):
    box = {}

    def run():
        box["result"] = agent.run()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _wait_progress(out, n, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if len(_read_progress(out)) >= n:
            return
        time.sleep(0.1)
    raise AssertionError(f"no {n} steps of progress in {timeout} s")


def test_agent_runs_to_success(master, saver_client, tmp_path):
    client, saver = saver_client
    spec, out = _spec(tmp_path, total=5)
    agent = ElasticAgent(spec, client, ckpt_saver=saver)
    assert agent.run() == RunResult.SUCCEEDED
    progress = _read_progress(out)
    assert [p[1] for p in progress] == [1, 2, 3, 4, 5]


def test_agent_restarts_crashed_worker_and_resumes(
    master, saver_client, tmp_path
):
    """Worker self-crashes at step 3; agent restarts; training resumes
    from the flash checkpoint (not from zero) and completes."""
    client, saver = saver_client
    spec, out = _spec(tmp_path, total=8, crash_at=3)
    agent = ElasticAgent(spec, client, ckpt_saver=saver)
    assert agent.run() == RunResult.SUCCEEDED
    progress = _read_progress(out)
    steps = [p[1] for p in progress]
    assert steps[:3] == [1, 2, 3]
    assert steps[3] == 4, f"resume did not continue from ckpt: {steps}"
    assert steps[-1] == 8
    for _, step, _, w0 in progress:
        assert w0 == float(step)
    assert any(r == 1 for _, _, r, _ in progress)


def test_agent_sigkill_recovery(master, saver_client, tmp_path):
    """External SIGKILL (preemption-style) mid-run; recovery via shm."""
    client, saver = saver_client
    spec, out = _spec(tmp_path, total=20)
    agent = ElasticAgent(spec, client, ckpt_saver=saver)
    t, box = _run_in_thread(agent)
    _wait_progress(out, 3)
    assert agent._workers, "worker never started"
    os.kill(agent._workers[0].process.pid, signal.SIGKILL)
    t.join(timeout=120)
    assert box.get("result") == RunResult.SUCCEEDED
    progress = _read_progress(out)
    steps = [p[1] for p in progress]
    assert steps[-1] == 20
    restarted_steps = [s for _, s, r, _ in progress if r >= 1]
    assert restarted_steps, f"no restarted incarnation in {progress}"
    assert min(restarted_steps) > 1, "worker restarted from zero"
    for _, step, _, w0 in progress:
        assert w0 == float(step)


def test_agent_gives_up_after_max_restarts(master, saver_client, tmp_path):
    client, saver = saver_client
    spec, out = _spec(tmp_path, total=3, crash_at=1, max_restarts=0)
    agent = ElasticAgent(spec, client, ckpt_saver=saver)
    assert agent.run() == RunResult.FAILED
    detail = client.get_job_detail()
    assert 0 in detail.nodes


def test_exit_barrier_holds_the_early_node(env_isolation):
    """Two agents of a two-node world (one worker each, a gloo world of
    two): the node whose worker finishes first leaves its agent only
    once the other node's worker is done, through the exit barrier's
    keys in the master's KV store."""
    tmp_path = env_isolation
    m = _master(2)
    try:
        agents, outs = [], []
        for rank, total in ((0, 2), (1, 12)):
            client = MasterClient(f"localhost:{m.port}", node_id=rank)
            out = str(tmp_path / f"progress{rank}.txt")
            spec = WorkerSpec(
                entrypoint=WORKER,
                args=[str(total), out, str(tmp_path / f"ckpt{rank}")],
                nproc_per_node=1, max_restarts=0, node_rank=rank,
                monitor_interval=0.2,
                env={"DLROVER_TPU_NODE_RANK": str(rank)})
            agents.append(ElasticAgent(spec, client))
            outs.append(out)
        runs = [_run_in_thread(a) for a in agents]
        done = []
        for t, box in runs:
            t.join(timeout=180)
            done.append(time.time())
        assert [box.get("result") for _, box in runs] == [
            RunResult.SUCCEEDED] * 2
        progress = [_read_progress(o) for o in outs]
        assert [p[1] for p in progress[0]] == [1, 2]
        assert [p[1] for p in progress[1]] == list(range(1, 13))
        assert {p[0] for p in progress[0]} == {0}
        assert {p[0] for p in progress[1]} == {1}
        # Node 0's agent left no earlier than node 1's last step.
        last1 = os.path.getmtime(outs[1])
        assert done[0] >= last1
        rnd = agents[0]._current_outcome.round
        keys = [f"exit-barrier/{rnd}/{r}" for r in (0, 1)]
        client = MasterClient(f"localhost:{m.port}", node_id=9)
        assert client.kv_store_multi_get(keys) == {k: b"1" for k in keys}
        client.close()
    finally:
        m.stop()


def _standby_lines(log_dir):
    """The ``standby_ready`` lines the standbys wrote to the worker log."""
    path = log_dir / "worker-0-0.log"
    if not path.exists():
        return []
    out = []
    for line in path.read_text(errors="replace").splitlines():
        if line.startswith('{"event": "standby_ready"'):
            out.append(json.loads(line))
    return out


def _wait_standby_spawned(agent, out, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if len(_read_progress(out)) >= 3 and agent._standby is not None:
            return agent._standby
        time.sleep(0.05)
    raise AssertionError("no warm standby spawned with 3 steps done")


def test_warm_standby_adopted_on_restart(master, saver_client, tmp_path):
    """With warm_standby, the restarted incarnation IS the pre-spawned
    standby process (no cold python start on the restart path), and the
    job still resumes from the checkpoint. The waiting standby has
    imported torch and not initialised CUDA."""
    client, saver = saver_client
    spec, out = _spec(tmp_path, total=30)
    spec.warm_standby = True
    spec.redirect_output = str(tmp_path / "logs")
    agent = ElasticAgent(spec, client, ckpt_saver=saver)
    t, box = _run_in_thread(agent)
    standby = _wait_standby_spawned(agent, out)
    standby_pid = standby.pid
    worker_pid = agent._workers[0].process.pid
    assert standby_pid != worker_pid
    os.kill(worker_pid, signal.SIGKILL)
    t.join(timeout=120)
    assert box.get("result") == RunResult.SUCCEEDED
    progress = _read_progress(out)
    steps = [p[1] for p in progress]
    assert steps[-1] == 30
    restarted_steps = [s for _, s, r, _ in progress if r >= 1]
    assert restarted_steps and min(restarted_steps) > 1
    # the new incarnation is the adopted standby, and a fresh standby
    # replaced it (until run() closed it on success)
    adopted = [w for w in agent._workers if w.process.pid == standby_pid]
    assert adopted, "restart did not adopt the warm standby"
    assert agent._standby is None, "standby not closed after run()"
    ready = _standby_lines(tmp_path / "logs")
    assert standby_pid in {r["pid"] for r in ready}
    assert all(r["cuda_initialized"] is False for r in ready), ready


def test_dead_standby_falls_back_to_cold_spawn(
    master, saver_client, tmp_path
):
    """A standby that died before adoption must not break restarts —
    the agent falls back to a cold spawn and respawns a standby."""
    client, saver = saver_client
    spec, out = _spec(tmp_path, total=30)
    spec.warm_standby = True
    spec.redirect_output = str(tmp_path / "logs")
    agent = ElasticAgent(spec, client, ckpt_saver=saver)
    t, box = _run_in_thread(agent)
    standby = _wait_standby_spawned(agent, out)
    # Kill the STANDBY first, then the worker: adoption must detect the
    # dead standby and cold-spawn.
    standby.kill()
    standby.wait(timeout=10)
    os.kill(agent._workers[0].process.pid, signal.SIGKILL)
    t.join(timeout=180)  # generous: full-suite load slows subprocesses
    assert box.get("result") == RunResult.SUCCEEDED
    steps = [p[1] for p in _read_progress(out)]
    assert steps[-1] == 30
    assert all(w.process.pid != standby.pid for w in agent._workers)


def test_xla_capture_switch_injects_the_listener(master, saver_client,
                                                tmp_path):
    """``DLROVER_TPU_TIMER_XLA`` in the spec's env puts the port's
    ``_inject`` directory first on the workers' PYTHONPATH, and the
    workers train to success under it."""
    client, saver = saver_client
    spec, out = _spec(tmp_path, total=2)
    spec.env["DLROVER_TPU_TIMER_XLA"] = "1"
    spec.env["DLROVER_TPU_TIMER_XLA_INTERVAL"] = "3600"
    agent = ElasticAgent(spec, client, ckpt_saver=saver)
    path = agent._base_worker_env(spec)["PYTHONPATH"].split(os.pathsep)
    assert path[0] == os.path.join(REPO, "dlrover_tpu_torch", "tpu_timer",
                                   "_inject")
    assert agent.run() == RunResult.SUCCEEDED
    assert [p[1] for p in _read_progress(out)] == [1, 2]
    spec.env.pop("DLROVER_TPU_TIMER_XLA")
    plain = agent._base_worker_env(spec)["PYTHONPATH"].split(os.pathsep)
    assert not any(p.endswith("_inject") for p in plain)


def test_local_master_autoscale_loop_evicts_a_flagged_rank(tmp_path):
    """``LocalJobMaster(autoscale_loop=True)`` runs the autoscaler on
    its own thread: a rank whose step times run 3x the median is
    evicted through the rescale coordinator (a plan without it, reason
    ``straggler_evict``) and its perf history reset; the recording
    replays to the live ledger; ``stop()`` leaves no loop thread."""
    from dlrover_tpu_torch.autoscaler import (
        EVICT_STRAGGLER,
        assert_replay_identity,
        load_recording,
    )

    record = str(tmp_path / "autoscale" / "signals.jsonl")
    master = LocalJobMaster(port=0, node_num=3, autoscale_loop=True,
                            autoscale_interval_s=0.05,
                            autoscale_record=record)
    coordinator = master.rescale_coordinator
    try:
        master.prepare()
        for rank in range(3):
            coordinator.note_worker_joined(rank)
        assert coordinator.current_plan().rank_order == [0, 1, 2]
        now = time.time()
        for step in range(1, 5):
            for rank in range(3):
                master.perf_monitor.collect_global_step(
                    step, now + step, node_id=rank,
                    step_time_s=0.3 if rank == 2 else 0.1)
        deadline = time.monotonic() + 20
        while (coordinator.current_plan().rank_order != [0, 1]
               and time.monotonic() < deadline):
            time.sleep(0.02)
        plan = coordinator.current_plan()
        assert plan.rank_order == [0, 1]
        assert plan.reason == "straggler_evict"
        evictions = [d for d in master.autoscaler.ledger.entries()
                     if d.action == EVICT_STRAGGLER]
        assert [(d.target, d.outcome) for d in evictions][:1] == [
            (2, "actuated")]
        assert 2 not in master.perf_monitor.straggler_report()["ranks"]
    finally:
        master.stop()
    assert not any(t.name == "autoscaler" for t in threading.enumerate())
    recording = load_recording(record)
    assert recording.snapshots and recording.decisions
    assert set(recording.snapshots[0].values) >= {
        "perf.global_step", "data.todo", "fault.failures_total",
        "ckpt.interval_s", "control_plane.shed_level"}
    assert assert_replay_identity(recording)["identical"]


def test_local_master_autoscale_loop_retunes_the_cadence_from_its_faults(
        tmp_path):
    """Two failures fed to the local master's fault history give its
    loop an observed MTBF: the Young/Daly rule retunes the checkpoint
    cadence (``SET_CKPT_INTERVAL`` actuated on the master's
    ``CadenceController``, 60 s before), once, and the recording replays
    to the live ledger."""
    from dlrover_tpu_torch.autoscaler import (
        SET_CKPT_INTERVAL,
        assert_replay_identity,
        load_recording,
    )
    from dlrover_tpu_torch.flash_ckpt.autotune import optimal_save_interval_s

    record = str(tmp_path / "signals.jsonl")
    master = LocalJobMaster(port=0, node_num=1, autoscale_loop=True,
                            autoscale_interval_s=0.05,
                            autoscale_record=record)
    try:
        master.prepare()
        assert master.ckpt_cadence.interval_s() == 60.0
        now = time.monotonic()
        master.fault_history.record_failure(now - 8.0)
        master.fault_history.record_failure(now)
        deadline = time.monotonic() + 20
        while (master.ckpt_cadence.interval_s() == 60.0
               and time.monotonic() < deadline):
            time.sleep(0.02)
        time.sleep(0.3)  # a few more ticks: the dead band holds
    finally:
        master.stop()
    want = optimal_save_interval_s(0.01, mtbf_s=8.0, min_interval_s=0.05)
    retunes = [d for d in master.autoscaler.ledger.entries()
               if d.action == SET_CKPT_INTERVAL]
    assert [d.outcome for d in retunes] == ["actuated"]
    assert retunes[0].target == pytest.approx(want, abs=1e-4)
    assert master.ckpt_cadence.interval_s() == float(retunes[0].target)
    recording = load_recording(record)
    assert recording.decisions
    assert assert_replay_identity(recording)["identical"]


@pytest.mark.parametrize("switch", ["journal_path",
                                    "DLROVER_TPU_MASTER_JOURNAL"])
def test_journaled_local_master_comes_back_with_its_leases(
        monkeypatch, tmp_path, switch):
    """A journaled ``LocalJobMaster`` (the keyword or the launcher's
    env var) is stopped holding a lease; the next one on the same journal
    has the next epoch, the lease under its task id, the done shard
    counted, the kv write and the committed step, and takes the lease's
    done-report."""
    from dlrover_tpu_torch.common import comm
    from dlrover_tpu_torch.master.journal import load_journal
    from dlrover_tpu_torch.master.node.job_context import JobContext

    path = str(tmp_path / "master.journal")
    kwargs = {}
    if switch == "journal_path":
        kwargs["journal_path"] = path
    else:
        monkeypatch.setenv(switch, path)

    def start():
        JobContext.reset_singleton()
        m = LocalJobMaster(port=0, **kwargs)
        m.prepare()
        return m, MasterClient(f"localhost:{m.port}", node_id=0)

    m1, client = start()
    try:
        client.report_dataset_shard_params(comm.DatasetShardParams(
            dataset_name="ds", dataset_size=64, shard_size=16,
            num_epochs=1, shuffle=False, task_type="training"))
        tasks, _ = client.get_tasks("ds", 2)
        client.report_tasks_done_batch("ds", [tasks[0].task_id], [])
        client.kv_store_set("k", b"v")
        client.report_ckpt_step(40, committed=True)
        assert client.master_epoch == 1
    finally:
        client.close()
        m1.stop()
    assert load_journal(path).clean_shutdown

    m2, client = start()
    try:
        assert m2.journal.master_epoch == 2
        mgr = m2.task_manager.get_dataset("ds")
        assert sorted(mgr.doing) == [tasks[1].task_id]
        assert mgr._completed_count == 1  # noqa: SLF001
        assert m2.kv_store.get("k") == b"v"
        assert client.get_ckpt_latest_step() == 40
        client.report_tasks_done_batch("ds", [tasks[1].task_id], [])
        assert not mgr.doing and mgr._completed_count == 2  # noqa: SLF001
        assert client.master_epoch == 2
    finally:
        client.close()
        m2.stop()


def test_training_hang_takes_a_metric_context():
    """A stalled in-band step with the native step counter advancing
    is no hang; frozen, it is."""
    from dlrover_tpu_torch.common.metric import (
        STEP_COUNTER,
        JobMetricContext,
    )
    from dlrover_tpu_torch.diagnosis.diagnosticians.training_hang import (
        TrainingHangDiagnostician,
    )
    from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor

    now = time.time()
    perf = PerfMonitor()
    perf.collect_global_step(100, now - 500)
    verdicts = []
    for steps in ([100, 105, 110], [110, 110, 110]):
        ctx = JobMetricContext()
        for i, s in enumerate(steps):
            ctx.record(0, {STEP_COUNTER: float(s)}, ts=now - 3 + i)
        d = TrainingHangDiagnostician(perf, hang_timeout_s=60.0,
                                      metric_context=ctx)
        verdicts.append(d.observe().observation)
    assert verdicts == ["", "training-hang"]


def test_worker_dumps_stacks_on_sigusr2(tmp_path):
    """The agent's post-mortem stop sends SIGUSR2 before SIGTERM: the
    port's worker runtime dumps its Python stacks and lives on."""
    import subprocess
    import sys

    code = (
        "import time\n"
        "from dlrover_tpu_torch.trainer.runtime import init_distributed\n"
        "init_distributed(device='cpu')\n"
        "print('up', flush=True)\n"
        "time.sleep(60)\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=repo,
                            env=dict(os.environ, PYTHONPATH=repo),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        import select

        ready, _, _ = select.select([proc.stdout], [], [], 120)
        assert ready, "the worker never came up"
        assert proc.stdout.readline().strip() == "up"
        proc.send_signal(signal.SIGUSR2)
        time.sleep(1.0)
        assert proc.poll() is None, "SIGUSR2 killed the worker"
    finally:
        proc.kill()
        _, err = proc.communicate(timeout=30)
    assert "Current thread" in err or "Thread 0x" in err


HANG_WORKER = os.path.join(os.path.dirname(__file__), "workers",
                           "torch_hang_worker.py")


def test_hung_worker_post_mortem_reaches_the_master_once(
        master, saver_client, tmp_path, monkeypatch):
    """A worker held past a 1 s hang deadline writes its hang watchdog's
    stack dump; SIGTERMed, it writes its flight recorder's crash dump.
    The agent reports both to the master (``STACK_DUMP`` and
    ``FLIGHT_RECORDER``) on that failure; the next incarnation dies
    without a dump, and the agent reports nothing for it (the earlier
    incarnation's files predate its start); the third exits 0."""
    from dlrover_tpu_torch.diagnosis.diagnosis_data import DiagnosisDataType
    from dlrover_tpu_torch.observability import hang_watchdog

    monkeypatch.setenv("DLROVER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("DLROVER_TPU_HANG_DEADLINE_S", "1")
    client, saver = saver_client
    out = str(tmp_path / "up.txt")
    spec = WorkerSpec(entrypoint=HANG_WORKER, args=[out], nproc_per_node=1,
                      max_restarts=3, node_rank=0, monitor_interval=0.2)
    agent = ElasticAgent(spec, client, ckpt_saver=saver)
    t, box = _run_in_thread(agent)
    deadline = time.time() + 120
    while not os.path.exists(out):
        assert time.time() < deadline, "the worker never came up"
        time.sleep(0.05)
    pid = int(open(out).read().split()[0])
    hang_path = hang_watchdog.hang_dump_path(0, 0)
    while True:
        try:
            with open(hang_path) as f:
                dump = json.load(f)
        except (OSError, ValueError):
            dump = {}
        if dump.get("pid") == pid:
            break
        assert time.time() < deadline, "no hang dump of the held worker"
        time.sleep(0.05)
    os.kill(pid, signal.SIGTERM)
    t.join(timeout=120)
    assert box.get("result") == RunResult.SUCCEEDED
    ups = [line.split() for line in open(out)]
    assert [int(r) for _, r in ups] == [0, 1, 2]
    data = master.diagnosis_master.node_data(0)
    stacks = [d for d in data if d.data_type == DiagnosisDataType.STACK_DUMP]
    flights = [d for d in data
               if d.data_type == DiagnosisDataType.FLIGHT_RECORDER]
    assert len(stacks) == 1 and len(flights) == 1, data
    assert stacks[0].reason == "hang:train" and stacks[0].hang_for_s > 1.0
    assert stacks[0].meta == {"process_id": 0, "node_rank": 0,
                              "local_rank": 0}
    main = [s for k, s in stacks[0].stacks.items()
            if k.startswith("MainThread")][0]
    assert any("torch_hang_worker.py" in fr and fr.endswith(" main")
               for fr in main)
    assert flights[0].local_rank == 0
    assert [r["step"] for r in flights[0].steps] == [1, 2, 3]


def test_hung_worker_gets_its_native_stacks_in_its_log(
        master, saver_client, tmp_path, monkeypatch):
    """Once the held worker's hang watchdog writes its dump, the agent
    appends the worker's native stacks (the out-of-process sampler) to
    the worker's log, without stopping it."""
    monkeypatch.setenv("DLROVER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("DLROVER_TPU_HANG_DEADLINE_S", "1")
    client, saver = saver_client
    out = str(tmp_path / "up.txt")
    logs = tmp_path / "logs"
    spec = WorkerSpec(entrypoint=HANG_WORKER, args=[out], nproc_per_node=1,
                      max_restarts=3, node_rank=0, monitor_interval=0.2,
                      redirect_output=str(logs))
    agent = ElasticAgent(spec, client, ckpt_saver=saver)
    t, box = _run_in_thread(agent)
    deadline = time.time() + 120
    while not os.path.exists(out):
        assert time.time() < deadline, "the worker never came up"
        time.sleep(0.05)
    pid = int(open(out).read().split()[0])
    log = logs / "worker-0-0.log"
    header = f"Native thread {pid} (most recent call first):"
    while header not in log.read_text(errors="replace"):
        assert time.time() < deadline, "no native stacks in the log"
        time.sleep(0.05)
    assert os.kill(pid, 0) is None  # still running
    os.kill(pid, signal.SIGTERM)
    t.join(timeout=120)
    assert box.get("result") == RunResult.SUCCEEDED
    from dlrover_tpu_torch.tpu_timer.native_stack import parse_native_dumps

    assert parse_native_dumps(log.read_text(errors="replace"))


def test_post_mortem_stop_appends_native_stacks(master, saver_client,
                                                tmp_path):
    """The post-mortem stop (SIGUSR2, then the native sampler, then
    SIGTERM) leaves both the Python and the native stacks of a live
    worker in its log."""
    client, saver = saver_client
    spec, out = _spec(tmp_path, total=10_000,
                      redirect_output=str(tmp_path / "logs"))
    agent = ElasticAgent(spec, client, ckpt_saver=saver)
    agent._initialize_workers()
    try:
        _wait_progress(out, 1)
        pid = agent._workers[0].process.pid
        agent._stop_workers(post_mortem=True)
    finally:
        agent._stop_workers()
    text = (tmp_path / "logs" / "worker-0-0.log").read_text(
        errors="replace")
    assert f"Native thread {pid} (most recent call first):" in text
    assert "most recent call first" in text.split("Native thread")[0]


def test_breakpoint_save_and_saver_loop_persist_one_at_a_time(
        env_isolation, monkeypatch):
    """The agent's breakpoint save runs in its own thread while the
    saver loop may be persisting a worker's request: both read the shm
    image through one kept buffer, so the saver runs one persist at a
    time, and a request whose image a persist already committed is not
    persisted again."""
    import numpy as np

    from dlrover_tpu_torch.flash_ckpt import saver as saver_mod
    from dlrover_tpu_torch.flash_ckpt.engine import SaveEvent

    inside, most, calls = [0], [0], []
    image = {"step": 7}
    lock = threading.Lock()

    def fake_persist(ckpt_dir, step, *a, **kw):
        with lock:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        time.sleep(0.2)
        calls.append(image["step"])
        with lock:
            inside[0] -= 1
        return True

    monkeypatch.setattr(saver_mod, "persist_shm_to_storage", fake_persist)
    monkeypatch.setattr(saver_mod.AsyncCheckpointSaver, "_image_step",
                        staticmethod(lambda n: image["step"]))
    monkeypatch.setattr(saver_mod.ckpt_storage, "read_tracker",
                        lambda d: -1 if not calls else image["step"])
    monkeypatch.setattr(saver_mod.ckpt_storage, "step_dir",
                        lambda d, s: str(env_isolation))
    AsyncCheckpointSaver.reset()
    saver = AsyncCheckpointSaver(local_world_size=1)
    try:
        event = SaveEvent(kind=SaveEvent.SAVE_DISK, step=6,
                          checkpoint_dir=str(env_isolation),
                          local_world_size=1)
        saver._latest_mem_event = event
        t = threading.Thread(target=saver.save_shm_on_failure)
        t.start()
        saver._handle_event(event)
        t.join(timeout=30)
        assert not t.is_alive()
        assert most[0] == 1, "two persists ran at once"
        # The image (step 7) was committed by whichever ran first.
        assert calls == [7] and saver.last_persisted_step == 7
        np.testing.assert_equal(len(saver.persist_records), 1)
    finally:
        saver.stop(timeout=30)


def test_resource_monitor_samples_what_psutil_reports():
    """The port's monitor reads ``/proc`` where the reference's calls
    psutil: memory in use (total less available) agrees with psutil's
    within 5% of total (the host keeps allocating between the reads),
    and the CPU share between two samples lies in [0, 100]."""
    import psutil
    from dlrover_tpu_torch.agent import monitor

    vm = psutil.virtual_memory()
    used = monitor._memory_used_mb()
    ref = (vm.total - vm.available) / (1024 * 1024)
    assert abs(used - ref) <= 0.05 * vm.total / (1024 * 1024)
    sampler = monitor.CpuSampler()
    assert sampler.sample() == 0.0
    sum(i * i for i in range(200000))
    share = sampler.sample()
    assert 0.0 <= share <= 100.0


def _agent_transcript(pkg, worker, tmp_path, monkeypatch, total, crash_at):
    """One agent of ``pkg`` under its own local master and saver, over
    ``worker``'s crash scenario: the progress lines, pids dropped."""
    import importlib

    mods = {m: importlib.import_module(f"{pkg}.{m}") for m in (
        "agent.master_client", "agent.training", "flash_ckpt.saver",
        "master.local_master", "master.node.job_context")}
    job = f"{pkg[-5:]}x{time.time_ns() % 1000000}"
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", job)
    monkeypatch.setenv("DLROVER_TPU_SHARED_DIR", str(tmp_path / job))
    mods["master.node.job_context"].JobContext.reset_singleton()
    master = mods["master.local_master"].LocalJobMaster(
        port=0, node_num=1, transport="http")
    master.prepare()
    saver_cls = mods["flash_ckpt.saver"].AsyncCheckpointSaver
    saver_cls.reset()
    client = mods["agent.master_client"].MasterClient(
        f"localhost:{master.port}", node_id=0, kind="http")
    saver = saver_cls.start_async_saving_ckpt(client=client)
    out = tmp_path / f"{job}.txt"
    training = mods["agent.training"]
    try:
        spec = training.WorkerSpec(
            entrypoint=worker,
            args=[str(total), str(out), str(tmp_path / f"{job}_ckpt"),
                  str(crash_at)],
            nproc_per_node=1, max_restarts=2, node_rank=0,
            monitor_interval=0.2)
        result = training.ElasticAgent(spec, client, ckpt_saver=saver).run()
    finally:
        saver.unlink_all(1)
        saver_cls.reset()
        client.close()
        master.stop()
    return result.value, [p[1:] for p in _read_progress(str(out))]


def test_crash_and_resume_as_the_jax_agent(env_isolation, monkeypatch):
    """The crash-at-step-3 scenario through both packages' launch stack
    (master, saver, agent, their simple worker): the same run result and
    the same progress lines (step, restart count, restored state)."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    ref_worker = os.path.join(os.path.dirname(__file__), "workers",
                              "simple_train.py")
    ref = _agent_transcript("dlrover_tpu", ref_worker, env_isolation,
                            monkeypatch, total=6, crash_at=3)
    port = _agent_transcript("dlrover_tpu_torch", WORKER, env_isolation,
                             monkeypatch, total=6, crash_at=3)
    assert ref == ("succeeded", [(1, 0, 1.0), (2, 0, 2.0), (3, 0, 3.0),
                                 (4, 1, 4.0), (5, 1, 5.0), (6, 1, 6.0)])
    assert port == ref


# ---- the node check (the reference's tests/test_node_check.py) -------------


@pytest.fixture()
def check_master(env_isolation, monkeypatch):
    """Masters of n nodes, and the port's probe on the CPU at small
    sizes (a gloo world per probe group)."""
    from dlrover_tpu_torch.common.constants import NetworkCheckConstant

    monkeypatch.setattr(NetworkCheckConstant, "MATMUL_SIZE", 64)
    monkeypatch.setattr(NetworkCheckConstant, "MATMUL_ROUNDS", 16)
    monkeypatch.setenv("DLROVER_TPU_CHECK_DEVICE", "cpu")
    created = []

    def build(node_num):
        created.append(_master(node_num))
        return created[-1]

    yield build
    for m in created:
        m.stop()


def _run_check_agents(master, ranks, timeout=240):
    from dlrover_tpu_torch.agent.node_check import run_network_check

    results = {}

    def check(rank):
        client = MasterClient(f"localhost:{master.port}", node_id=rank)
        results[rank] = run_network_check(
            client, node_rank=rank, nproc_per_node=1, timeout=timeout
        )

    threads = [
        threading.Thread(target=check, args=(r,), daemon=True)
        for r in ranks
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 120)
    return results


def test_two_node_check_all_healthy(check_master):
    master = check_master(2)
    assert _run_check_agents(master, (0, 1)) == {0: True, 1: True}
    client = MasterClient(f"localhost:{master.port}", node_id=0)
    faults, evaluated_round, needs_more = client.check_fault_node()
    assert faults == [] and evaluated_round >= 0 and not needs_more


def test_rigged_node_isolated_and_evicted(check_master, monkeypatch):
    """Four real agents; node 1's probe is rigged to fail every round.
    Round 0 marks it suspect, the bisection round pairs it with a
    healthy node, and the verdict isolates EXACTLY node 1 — which gets
    marked broken (BREAKDOWN) for eviction+relaunch while its round-0
    partner is cleared."""
    from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
    from dlrover_tpu_torch.master.node.job_context import get_job_context

    monkeypatch.setenv("DLROVER_TPU_CHAOS_CHECK_FAIL_RANKS", "1")
    master = check_master(4)
    results = _run_check_agents(master, (0, 1, 2, 3))
    assert results == {0: True, 1: False, 2: True, 3: True}
    client = MasterClient(f"localhost:{master.port}", node_id=0)
    faults, _, needs_more = client.check_fault_node()
    assert faults == [1]
    assert not needs_more
    node = get_job_context().get_node(NodeType.WORKER, 1)
    assert node is not None and node.status == NodeStatus.BREAKDOWN


def test_straggler_detected_e2e(check_master, monkeypatch):
    """Node 1 completes its probes but far slower than the median: the
    check passes (no eviction) and the master flags it a straggler."""
    monkeypatch.setenv("DLROVER_TPU_CHAOS_CHECK_SLOW_RANKS", "1")
    monkeypatch.setenv("DLROVER_TPU_CHAOS_CHECK_SLOW_SECS", "8")
    master = check_master(4)
    results = _run_check_agents(master, (0, 1, 2, 3))
    assert results == {0: True, 1: True, 2: True, 3: True}
    client = MasterClient(f"localhost:{master.port}", node_id=0)
    assert 1 in client.check_straggler()
