"""The port's launcher end to end on the CPU:

    python -m dlrover_tpu_torch.run --standalone --nproc_per_node 2 \\
        -m dlrover_tpu_torch.examples.train_llama --device cpu --config tiny

starts the port's local master over HTTP, its agent and a gloo world of
two elastic workers. An unkilled run and a run whose rank 1 is SIGKILLed
mid-training (both ranks held one step past the kill step by a fault
schedule, so the kill lands there) both exit 0: the agent restarts both
ranks, each restores the kill step from memory, and every replayed loss
equals the unkilled run's bit for bit, as do the final digests. Also:
the agent's env reads back through the worker's ``read_worker_env``;
``--network-check`` probes the node before the worker trains, and a
failed probe starts no worker; the master CLI wires a batch config; with
``DLROVER_TPU_MASTER_JOURNAL`` set the launcher's master journals the
job; under ``DLROVER_TPU_TIMER`` the worker serves the profiler daemon
and the launcher forwards its metrics to the master. Two
launchers of one two-node world with ``--ckpt_replica_group 2``
(``chip_smoke.phase_replica_restore`` at the tiny config): node 1, lost
with its segment, restores from node 0's replica of it (from memory,
the same bytes), and with node 0's replica port unreachable it restores
from storage.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
STEPS, KILL_STEP = 6, 3
TIMEOUT_S = 240.0


class _Launcher:
    """One ``python -m dlrover_tpu_torch.run`` process; a thread reads the
    workers' JSON lines off its stdout."""

    def __init__(self, tmp_path, label, schedule=None, extra_env=None):
        self.job = f"trun{uuid.uuid4().hex[:8]}{label}"
        root = tmp_path / label
        root.mkdir()
        self.err_path = root / "launcher.err"
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   DLROVER_TPU_JOB_NAME=self.job,
                   DLROVER_TPU_SHARED_DIR=str(root / "sock"),
                   DLROVER_TPU_EVENT_DIR=str(root / "events"))
        env.pop("DLROVER_TPU_FAULT_SCHEDULE", None)
        if schedule is not None:
            env["DLROVER_TPU_FAULT_SCHEDULE"] = str(schedule)
        env.update(extra_env or {})
        self.sock_dir = root / "sock"
        self.events = []
        self._cond = threading.Condition()
        with open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "dlrover_tpu_torch.run",
                 "--standalone", "--nnodes", "1", "--nproc_per_node", "2",
                 "--max_restarts", "2", "--monitor_interval", "0.2",
                 "-m", "dlrover_tpu_torch.examples.train_llama",
                 "--device", "cpu", "--config", "tiny", "--layers", "2",
                 "--steps", str(STEPS), "--global-batch", "4",
                 "--micro-batch", "2", "--seq", "16",
                 "--persist-every", "2", "--ckpt-dir", str(root / "ckpt")],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err,
                text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            if line.startswith("{"):
                with self._cond:
                    self.events.append(json.loads(line))
                    self._cond.notify_all()

    def wait_for(self, pred, what):
        deadline = time.monotonic() + TIMEOUT_S
        with self._cond:
            while not pred(self.events):
                left = deadline - time.monotonic()
                assert left > 0 and self.proc.poll() is None, (
                    f"no {what}: rc {self.proc.poll()}, "
                    f"{self.err_path.read_text()[-3000:]}")
                self._cond.wait(min(left, 1.0))

    def finish(self):
        try:
            rc = self.proc.wait(timeout=TIMEOUT_S)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
            self._reader.join(timeout=30)
            for seg in os.listdir("/dev/shm"):
                if self.job in seg:
                    os.unlink(os.path.join("/dev/shm", seg))
        return rc

    def by_rank(self, kind):
        out = {}
        for e in self.events:
            if e["event"] == kind:
                out.setdefault(e["rank"], []).append(e)
        return out


def _losses(launcher):
    """{rank: {step: loss}} over every incarnation's step lines."""
    out = {}
    for rank, steps in launcher.by_rank("step").items():
        for e in steps:
            out.setdefault(rank, []).append((e["step"], e["loss"]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("run")
    from dlrover_tpu_torch.fault import FaultRule, FaultSchedule

    schedule = tmp_path / "hold.json"
    schedule.write_text(FaultSchedule([FaultRule(
        "agent.worker.crash", action="delay", delay_s=TIMEOUT_S,
        match={"step": KILL_STEP + 1})]).to_json())
    a = _Launcher(tmp_path, "A", extra_env={
        "DLROVER_TPU_FAILOVER_EXT":
            "dlrover_tpu_torch.agent.diagnosis_agent:DiagnosisAgent"})
    b = _Launcher(tmp_path, "B", schedule=schedule)
    # Both ranks of B hold at KILL_STEP + 1, their KILL_STEP in shm.
    b.wait_for(lambda ev: {e["rank"] for e in ev if e["event"] == "shm"
                           and e["step"] == KILL_STEP} == {0, 1},
               "step in shm on both ranks")
    # The relaunch must not hold: the agent gives it the same env.
    schedule.write_text(FaultSchedule([]).to_json())
    victim = b.by_rank("ready")[1][0]["pid"]
    os.kill(victim, signal.SIGKILL)
    rc_a, rc_b = a.finish(), b.finish()
    return {"A": a, "B": b, "rc": (rc_a, rc_b), "victim": victim}


def test_standalone_launcher_runs_a_two_rank_world(runs):
    a = runs["A"]
    assert runs["rc"][0] == 0, a.err_path.read_text()[-3000:]
    readies = a.by_rank("ready")
    assert sorted(readies) == [0, 1]
    assert all(r[0]["restart_count"] == 0 and r[0]["restored_step"] == 0
               for r in readies.values())
    done = a.by_rank("done")
    assert sorted(done) == [0, 1]
    assert {int(k) for k in done[0][0]["losses"]} == set(range(1, STEPS + 1))
    err = a.err_path.read_text()
    assert "serving at 127.0.0.1:" in err
    assert "loaded failover extension" in err
    assert "all workers succeeded" in err
    # The launcher took its saver's sockets down on the way out.
    assert not a.sock_dir.exists() or os.listdir(a.sock_dir) == []


def test_killed_rank_restarts_both_ranks_from_memory(runs):
    b = runs["B"]
    assert runs["rc"][1] == 0, b.err_path.read_text()[-3000:]
    readies = b.by_rank("ready")
    for rank in (0, 1):
        got = [(r["restart_count"], r["restored_from"], r["restored_step"])
               for r in readies[rank]]
        assert got == [(0, None, 0), (1, "memory", KILL_STEP)], got
        assert readies[rank][1]["restore_read"]["shm_step"] == KILL_STEP
    # The agent, not the test, started every incarnation.
    err = b.err_path.read_text()
    started = {int(p) for p in re.findall(
        r"started worker local_rank=\d pid=(\d+)", err)}
    assert {r["pid"] for rs in readies.values() for r in rs} == started
    assert runs["victim"] in started and len(started) == 4


def test_replayed_losses_equal_the_unkilled_run_bitwise(runs):
    losses_a, losses_b = _losses(runs["A"]), _losses(runs["B"])
    for rank in (0, 1):
        ref = dict(losses_a[rank])
        replayed = losses_b[rank]
        assert [s for s, _ in replayed if s > KILL_STEP] == list(
            range(KILL_STEP + 1, STEPS + 1))
        assert all(loss == ref[step] for step, loss in replayed), (
            rank, replayed, ref)
    digests = {k: {r: d[0]["digest"] for r, d in runs[k].by_rank(
        "done").items()} for k in ("A", "B")}
    assert digests["A"] == digests["B"]


def test_worker_env_round_trips_through_read_worker_env(monkeypatch):
    from dlrover_tpu_torch.common.constants import WorkerEnv
    from dlrover_tpu_torch.common.env_utils import worker_env
    from dlrover_tpu_torch.trainer import runtime

    env = worker_env("10.0.0.1:1234", 8, 5, local_rank=1,
                     local_world_size=4, restart_count=2, rdzv_round=3,
                     node_ranks=[0, 1], num_slices=2)
    assert set(env) == {v for k, v in vars(WorkerEnv).items()
                        if not k.startswith("_")}
    for k in list(os.environ):
        if k.startswith("DLROVER_TPU_"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ctx = runtime.read_worker_env()
    assert (ctx.coordinator_address, ctx.num_processes, ctx.process_id,
            ctx.local_rank, ctx.local_world_size, ctx.restart_count,
            ctx.rdzv_round, ctx.node_ranks, ctx.num_slices) == (
        "10.0.0.1:1234", 8, 5, 1, 4, 2, 3, (0, 1), 2)


def test_launcher_parses_module_entrypoints():
    from dlrover_tpu_torch import run

    args = run.build_parser().parse_args(
        ["--standalone", "-m", "pkg.train", "--steps", "3"])
    assert args.module and args.training_script == "pkg.train"
    assert args.training_script_args == ["--steps", "3"]
    args = run.build_parser().parse_args(["train.py", "-x"])
    assert not args.module and args.training_script_args == ["-x"]


def test_distributed_master_platform_is_refused():
    from dlrover_tpu_torch.master import main

    with pytest.raises(NotImplementedError, match="ROADMAP §A item 8b"):
        main.main(["--platform", "k8s"])


def test_master_cli_runs_the_autoscale_loop(tmp_path):
    """``python -m dlrover_tpu_torch.master.main --platform local
    --autoscale_loop --autoscale_dry_run --autoscale_interval_s 0.1
    --autoscale_record R``: the master serves, its loop records
    snapshots of every source to R (the dry-run policy config first),
    and SIGTERM stops it with exit code 0."""
    from dlrover_tpu_torch.autoscaler import load_recording
    from dlrover_tpu_torch.master.args import parse_master_args

    record = tmp_path / "rec" / "signals.jsonl"
    argv = ["--platform", "local", "--autoscale_loop", "--autoscale_dry_run",
            "--autoscale_interval_s", "0.1",
            "--autoscale_record", str(record)]
    args = parse_master_args(argv)
    assert (args.autoscale_loop, args.autoscale_dry_run,
            args.autoscale_interval_s, args.autoscale_record) == (
        True, True, 0.1, str(record))
    port_file = tmp_path / "port"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.master.main", *argv,
         "--port_file", str(port_file)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 60
        snapshots = []
        while time.monotonic() < deadline and len(snapshots) < 3:
            time.sleep(0.2)
            assert proc.poll() is None, proc.communicate()[1][-2000:]
            if port_file.exists() and record.exists():
                snapshots = load_recording(str(record)).snapshots
        assert len(snapshots) >= 3
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    assert "autoscaler loop started (interval 0.1s, DRY RUN)" in err
    recording = load_recording(str(record))
    assert recording.policy_config["max_world"] == 0
    assert {k.split(".")[0] for k in recording.snapshots[-1].values} >= {
        "perf", "data", "fault", "ckpt", "control_plane"}


def _dist_flag_probe(master, flag):
    """What each distributed-master flag changed in the built master."""
    return {
        "--namespace": lambda: True,
        "--network_check": lambda: True,
        "--metric_endpoints": lambda: master.metric_monitor is not None,
        "--topology_aware": lambda: (
            master.rdzv_managers["training"]._topology_sorter is not None),
        "--node_unit": lambda: master.job_manager._node_group_size == 2,
        "--auto_scale": lambda: master.auto_scaler is not None,
        "--autoscale_max_world": lambda: master.autoscaler is not None,
        "--autoscale_ckpt_interval_s": lambda: (
            master.ckpt_cadence.interval_s() == 7.0),
        "--legal_worker_counts": lambda: master.auto_scaler is not None,
    }[flag]()


@pytest.mark.parametrize("parser, flag", [
    ("master", "--namespace"), ("master", "--network_check"),
    ("master", "--dashboard_port"), ("master", "--brain_addr"),
    ("master", "--metric_endpoints"), ("master", "--topology_aware"),
    ("master", "--node_unit"), ("master", "--auto_scale"),
    ("master", "--autoscale_max_world"),
    ("master", "--autoscale_ckpt_interval_s"),
    ("master", "--legal_worker_counts"),
])
def test_distributed_master_flags_are_not_taken(parser, flag):
    """Flags only the distributed master reads are not parsed and then
    ignored there: each reaches ``DistributedJobMaster.from_args`` on the
    simulated platform and changes what it builds, or, where it needs a
    module of ROADMAP §A item 8b (the dashboard, the brain), raises
    ``NotImplementedError`` naming it."""
    from dlrover_tpu_torch.master.args import parse_master_args
    from dlrover_tpu_torch.master.dist_master import DistributedJobMaster
    from dlrover_tpu_torch.master.node.job_context import JobContext

    values = {"--namespace": ["ns"], "--dashboard_port": ["0"],
              "--brain_addr": ["localhost:1"],
              "--metric_endpoints": ["0=127.0.0.1:1"],
              "--node_unit": ["2"], "--autoscale_max_world": ["4"],
              "--autoscale_ckpt_interval_s": ["7"],
              "--legal_worker_counts": ["1,2"]}
    extra = {"--autoscale_max_world": ["--autoscale_loop"],
             "--autoscale_ckpt_interval_s": ["--autoscale_loop"],
             "--legal_worker_counts": ["--auto_scale"]}
    args = parse_master_args(
        ["--platform", "sim", "--node_num", "2",
         flag, *values.get(flag, []), *extra.get(flag, [])])
    assert getattr(args, flag[2:]) == {
        "--namespace": "ns", "--dashboard_port": 0,
        "--brain_addr": "localhost:1",
        "--metric_endpoints": "0=127.0.0.1:1", "--node_unit": 2,
        "--autoscale_max_world": 4, "--autoscale_ckpt_interval_s": 7.0,
        "--legal_worker_counts": "1,2"}.get(flag, True)
    JobContext.reset_singleton()
    if flag in ("--dashboard_port", "--brain_addr"):
        with pytest.raises(NotImplementedError, match="ROADMAP §A item 8b"):
            DistributedJobMaster.from_args(args)
        return
    master = DistributedJobMaster.from_args(args)
    try:
        assert _dist_flag_probe(master, flag)
    finally:
        master._server.start()
        master._server.stop()
        JobContext.reset_singleton()


def test_master_cli_wires_a_batch_config(monkeypatch):
    """``--global_batch_size`` with ``--micro_batch_per_device`` gives
    the local master a batch config, and ``--devices_per_node`` its dp
    per node, as the reference's CLI does."""
    from dlrover_tpu_torch.master import local_master, main

    seen = {}

    class Stop(Exception):
        pass

    def fake_master(**kwargs):
        seen.update(kwargs)
        raise Stop

    monkeypatch.setattr(local_master, "LocalJobMaster", fake_master)
    with pytest.raises(Stop):
        main.main(["--platform", "local", "--global_batch_size", "8",
                   "--micro_batch_per_device", "1",
                   "--devices_per_node", "2"])
    bc = seen["batch_config"]
    assert (bc.global_batch_size, bc.micro_batch_per_device) == (8, 1)
    assert seen["devices_per_node"] == 2
    assert bc.legal_node_counts_fn(2)(4, 1) == [1, 2, 4]


def _network_check_run(tmp_path, extra_env):
    job = f"tnc{uuid.uuid4().hex[:8]}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               DLROVER_TPU_JOB_NAME=job,
               DLROVER_TPU_SHARED_DIR=str(tmp_path / "sock"),
               DLROVER_TPU_EVENT_DIR=str(tmp_path / "events"),
               DLROVER_TPU_CHECK_DEVICE="cpu", **extra_env)
    env.pop("DLROVER_TPU_FAULT_SCHEDULE", None)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "dlrover_tpu_torch.run", "--standalone",
             "--network-check", "--nproc_per_node", "1",
             "--monitor_interval", "0.2",
             "-m", "dlrover_tpu_torch.examples.train_llama",
             "--device", "cpu", "--config", "tiny", "--layers", "1",
             "--steps", "2", "--global-batch", "2", "--micro-batch", "2",
             "--seq", "8", "--persist-every", "2",
             "--ckpt-dir", str(tmp_path / "ckpt")],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=TIMEOUT_S)
    finally:
        for seg in os.listdir("/dev/shm"):
            if job in seg:
                os.unlink(os.path.join("/dev/shm", seg))
    events = [json.loads(ln) for ln in proc.stdout.splitlines()
              if ln.startswith("{")]
    probes = [json.loads(ln) for ln in proc.stderr.splitlines()
              if ln.startswith('{"event": "node_check_probe"')]
    return proc, events, probes


def test_launcher_network_check_then_trains(tmp_path):
    """``python -m dlrover_tpu_torch.run --standalone --network-check``
    probes the node (the port's probe, here on the CPU), the master
    records it healthy, then the worker trains."""
    proc, events, probes = _network_check_run(tmp_path, {})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert [p["device"] for p in probes] == ["cpu"]
    assert probes[0]["node_rank"] == 0 and probes[0]["elapsed"] > 0
    assert "the master's fault nodes [] after round 0" in proc.stderr
    assert [e["step"] for e in events if e["event"] == "step"] == [1, 2]
    assert events[-1]["event"] == "done"


def test_launcher_runs_the_timer_daemon_and_forwards_its_metrics(
        tmp_path, monkeypatch):
    """Under ``DLROVER_TPU_TIMER=1`` the worker serves the tpu_timer
    daemon and publishes its port, the launcher starts its collector at
    the reference's 30 s cadence, and the run trains as without it. The
    launcher's collectors (``run._start_timer_collectors``, here beside
    an in-process master and daemon, one scrape) forward the parsed
    gauges to the master's diagnosis store."""
    import tempfile

    from dlrover_tpu_torch import run
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.diagnosis.diagnosis_data import DiagnosisDataType
    from dlrover_tpu_torch.master.local_master import LocalJobMaster
    from dlrover_tpu_torch.master.node.job_context import JobContext
    from dlrover_tpu_torch.tpu_timer.bridge import get_timer, publish_port

    proc, events, probes = _network_check_run(tmp_path, {
        "DLROVER_TPU_TIMER": "1", "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert [e["step"] for e in events if e["event"] == "step"] == [1, 2]
    assert "tpu_timer daemon on port" in proc.stderr
    assert "tpu_timer collector of local rank 0 every 30 s" in proc.stderr
    assert list(tmp_path.glob("dlrover_tpu_timer_*_0.port"))

    fwd = tmp_path / "fwd"
    fwd.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(fwd))
    monkeypatch.setenv("DLROVER_TPU_TIMER", "1")
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"fwd{uuid.uuid4().hex[:8]}")
    timer = get_timer()
    publish_port(0, timer.port or timer.start_server(0))
    JobContext.reset_singleton()
    master = LocalJobMaster(port=0, node_num=1)
    master.prepare()
    client = MasterClient(f"localhost:{master.port}", node_id=0)
    try:
        collectors = run._start_timer_collectors(client, 0, 1)
        try:
            assert [c.interval_s for c in collectors] == [30.0]
            assert collectors[0].collect_once()
        finally:
            for c in collectors:
                c.stop()
        got = [d for d in master.diagnosis_master.node_data(0)
               if d.data_type == DiagnosisDataType.XPU_TIMER_METRIC]
        assert len(got) == 1 and "tpu_timer_hang_spans" in got[0].metrics
    finally:
        client.close()
        master.stop()
        JobContext.reset_singleton()


def test_launcher_network_check_failure_starts_no_worker(tmp_path):
    """A node that fails its probe exits non-zero before any training
    worker starts, and takes its local master down with it."""
    proc, events, probes = _network_check_run(
        tmp_path, {"DLROVER_TPU_CHAOS_CHECK_FAIL_RANKS": "0"})
    assert proc.returncode == 3, proc.stderr[-3000:]
    assert probes == [] and events == []
    assert "node failed network check" in proc.stderr
    assert "started worker" not in proc.stderr


def test_launcher_runs_a_journaled_master(tmp_path):
    """With ``DLROVER_TPU_MASTER_JOURNAL`` in its environment the
    launcher's local master journals the job (its rendezvous commits and
    the agent's kv writes) and closes the journal clean; a second job on
    the same journal gets the next master epoch."""
    from dlrover_tpu_torch.master.journal import load_journal

    journal = tmp_path / "master.journal"
    epochs = []
    for run in range(2):
        job = f"tjr{uuid.uuid4().hex[:8]}"
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   DLROVER_TPU_JOB_NAME=job,
                   DLROVER_TPU_SHARED_DIR=str(tmp_path / f"sock{run}"),
                   DLROVER_TPU_EVENT_DIR=str(tmp_path / "events"),
                   DLROVER_TPU_MASTER_JOURNAL=str(journal))
        env.pop("DLROVER_TPU_FAULT_SCHEDULE", None)
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "dlrover_tpu_torch.run",
                 "--standalone", "--nproc_per_node", "1",
                 "--monitor_interval", "0.2",
                 "-m", "dlrover_tpu_torch.examples.train_llama",
                 "--device", "cpu", "--config", "tiny", "--layers", "1",
                 "--steps", "2", "--global-batch", "2",
                 "--micro-batch", "2", "--seq", "8", "--persist-every", "2",
                 "--ckpt-dir", str(tmp_path / f"ckpt{run}")],
                cwd=REPO, env=env, capture_output=True, text=True,
                timeout=TIMEOUT_S)
        finally:
            for seg in os.listdir("/dev/shm"):
                if job in seg:
                    os.unlink(os.path.join("/dev/shm", seg))
        assert proc.returncode == 0, proc.stderr[-3000:]
        state = load_journal(str(journal))
        assert state.clean_shutdown and state.corrupt_lines == 0
        assert state.kinds["rdzv"] >= 1 and state.kinds["kv_set"] >= 1
        epochs.append(state.master_epoch)
    assert epochs == [1, 2]


def test_lost_node_restores_from_its_peers_replica(monkeypatch):
    """``python -m dlrover_tpu_torch.run --nnodes 2 --ckpt_replica_group
    2`` on the CPU: the card phase at the tiny config, every gate of it
    (the pulled segment's bytes are the lost one's, the relaunch restores
    the kill step from memory bit for bit, the control falls back to
    storage and says so, both launchers exit 0, nothing is left)."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    launches = chip_smoke.phase_replica_restore(device="cpu",
                                                config="tiny")
    assert launches == {"flash_forward": 0, "flash_backward_dq": 0,
                        "flash_backward_dkv": 0}


def test_dist_master_relaunches_a_lost_host_under_two_launchers(
        monkeypatch):
    """The distributed master on the simulated cluster with two
    ``python -m dlrover_tpu_torch.run --master`` launchers on the CPU:
    the card phase at the tiny config, every gate of it (``run()``
    returns 0 after the pre-check, rank 1 has two incarnations, the
    first preempted, the relaunch restores the committed step from
    storage, each step runs once a rank, both ranks end on one model,
    nothing is left)."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    launches = chip_smoke.phase_dist_master(device="cpu", config="tiny")
    assert launches == {"flash_forward": 0, "flash_backward_dq": 0,
                        "flash_backward_dkv": 0}
