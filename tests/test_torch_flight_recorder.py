"""The port's flight recorder (``dlrover_tpu_torch/observability/
flight_recorder.py``) against the JAX package's: each package's
``load_dump``, ``collect_dumps`` (with ``max_age_s`` and ``last_n``) and
``last_steps`` read the other's dump, exactly. In a child process the
port's crash dump lands on SIGTERM (the process still dies by the
signal) and on an unhandled exception; SIGUSR1 writes the on-demand dump
with every stack beside the crash dump's path, leaves that path alone
and the process running, also in a worker held in a delay fault while a
tracer holds its main thread; the worker runtime arms it with the
incarnation's meta. A recorder installed without ranks arms nothing.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from dlrover_tpu.observability import flight_recorder as ref_fr
from dlrover_tpu_torch.observability import flight_recorder as port_fr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def flight_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    return tmp_path / "flight"


def _ring(mod, node, steps=20):
    rec = mod.FlightRecorder(capacity=8, meta={"node_rank": node,
                                               "local_rank": 0})
    for s in range(1, steps + 1):
        rec.record_step(s, step_time_s=0.25 * s, data_wait_s=0.01,
                        ckpt_block_s=0.002, rdzv_round=3)
    rec.annotate("ckpt_restore", step=4, source="memory")
    path = rec.dump(path=mod.dump_path(node, 0))
    assert path == mod.dump_path(node, 0)
    return path


def test_each_package_reads_the_others_dump(flight_dir):
    assert port_fr.dump_path(1, 0) == ref_fr.dump_path(1, 0)
    _ring(port_fr, 1)
    _ring(ref_fr, 2)
    for node in (1, 2):
        port = port_fr.load_dump(port_fr.dump_path(node, 0))
        ref = ref_fr.load_dump(ref_fr.dump_path(node, 0))
        assert port == ref and sorted(port) == [
            "dumped_at", "meta", "pid", "schema", "steps"]
        assert [r.get("event", r["step"]) for r in port["steps"]] == [
            14, 15, 16, 17, 18, 19, 20, "ckpt_restore"]
        assert port_fr.last_steps(port, 3) == ref_fr.last_steps(ref, 3)
    for kw in ({}, {"last_n": 2}, {"max_age_s": 60.0},
               {"max_age_s": 60.0, "last_n": 5}):
        assert port_fr.collect_dumps(1, [0], **kw) == ref_fr.collect_dumps(
            1, [0], **kw)
        got = port_fr.collect_dumps(2, [0, 1], **kw)
        assert got == ref_fr.collect_dumps(2, [0, 1], **kw)
        assert list(got) == [0]
    old = time.time() - 600
    os.utime(port_fr.dump_path(2, 0), (old, old))
    assert port_fr.collect_dumps(2, [0], max_age_s=60.0) == {}
    assert ref_fr.collect_dumps(2, [0], max_age_s=60.0) == {}
    with open(port_fr.dump_path(3, 0), "w") as f:
        json.dump({"no": "steps"}, f)
    assert port_fr.load_dump(port_fr.dump_path(3, 0)) is None
    assert ref_fr.load_dump(port_fr.dump_path(3, 0)) is None


def test_recorder_without_ranks_arms_no_dump(monkeypatch):
    monkeypatch.setattr(port_fr, "_recorder", None)
    before = (signal.getsignal(signal.SIGTERM), signal.getsignal(
        signal.SIGUSR1), sys.excepthook)
    rec = port_fr.install_recorder(meta={"local_rank": 0})
    try:
        assert port_fr.active_recorder() is rec
        assert rec.on_demand_path() is None and rec.dump() is None
        assert (signal.getsignal(signal.SIGTERM), signal.getsignal(
            signal.SIGUSR1), sys.excepthook) == before
    finally:
        port_fr.reset_recorder()


_CHILD = """
import json, os, signal, sys, time
from dlrover_tpu_torch.observability import flight_recorder as fr
mode = sys.argv[1]
if mode == "runtime":
    from dlrover_tpu_torch.trainer.runtime import init_distributed
    init_distributed(device="cpu")
    rec = fr.active_recorder()
else:
    rec = fr.install_recorder(node_rank=1, local_rank=0,
                              meta={"restart_count": 4})
for s in range(1, 4):
    rec.record_step(s, step_time_s=0.5)
print(json.dumps({"pid": os.getpid(), "meta": rec.meta}), flush=True)
if mode == "raise":
    raise RuntimeError("boom")
if mode == "held":
    # Held as chip_smoke's elastic phase holds a worker: a delay fault.
    import threading
    from dlrover_tpu_torch import fault
    for _ in range(2):
        threading.Thread(target=threading.Event().wait, daemon=True).start()
    fault.arm(fault.FaultSchedule([fault.FaultRule(
        "agent.worker.crash", action="delay", delay_s=60.0)]))
    fault.fault_point("agent.worker.crash", step=3)
time.sleep(60)
"""


def _child(flight_dir, mode, env=None):
    return subprocess.Popen(
        [sys.executable, "-c", _CHILD, mode], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO,
                 DLROVER_TPU_FLIGHT_DIR=str(flight_dir), **(env or {})),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _up(proc):
    line = proc.stdout.readline()
    assert line, proc.stderr.read()[-2000:]
    return json.loads(line)


def test_crash_dump_on_sigterm_in_a_child(flight_dir):
    proc = _child(flight_dir, "sigterm")
    try:
        up = _up(proc)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == -signal.SIGTERM
    finally:
        proc.kill()
        proc.communicate(timeout=30)
    dump = ref_fr.load_dump(ref_fr.dump_path(1, 0))
    assert dump["pid"] == up["pid"] and dump["meta"] == {
        "node_rank": 1, "local_rank": 0, "restart_count": 4}
    assert [r["step"] for r in dump["steps"]] == [1, 2, 3]
    assert "stacks" not in dump


def test_crash_dump_on_an_unhandled_exception(flight_dir):
    proc = _child(flight_dir, "raise")
    up = _up(proc)
    _, err = proc.communicate(timeout=60)
    assert proc.returncode == 1 and "RuntimeError: boom" in err
    dump = port_fr.load_dump(port_fr.dump_path(1, 0))
    assert dump["pid"] == up["pid"]
    assert [r["step"] for r in dump["steps"]] == [1, 2, 3]


def test_on_demand_dump_keeps_the_worker_and_the_crash_path(flight_dir):
    crash_path = port_fr.dump_path(1, 0)
    os.makedirs(flight_dir, exist_ok=True)
    with open(crash_path, "w") as f:
        json.dump({"steps": [], "marker": "earlier crash"}, f)
    proc = _child(flight_dir, "usr1")
    try:
        up = _up(proc)
        demand_path = os.path.join(flight_dir,
                                   "flight_node1_rank0.ondemand.json")
        proc.send_signal(signal.SIGUSR1)
        deadline = time.time() + 60
        while not os.path.exists(demand_path):
            assert time.time() < deadline, "no on-demand dump"
            time.sleep(0.05)
        time.sleep(0.5)
        assert proc.poll() is None, "SIGUSR1 ended the worker"
        dump = ref_fr.load_dump(demand_path)
        assert dump["pid"] == up["pid"] and dump["on_demand"] is True
        assert [r["step"] for r in dump["steps"]] == [1, 2, 3]
        main = [s for k, s in dump["stacks"].items()
                if k.startswith("MainThread")][0]
        # The handler runs on the main thread, inside the sleeping frame.
        assert main[0].endswith(" <module>")
        assert main[-1].endswith(" dump_all_stacks")
        with open(crash_path) as f:
            assert json.load(f)["marker"] == "earlier crash"
    finally:
        proc.kill()
        proc.communicate(timeout=30)


def _hold_main_thread(pid):
    """Seizes and stops ``pid``'s main thread alone (as the native stack
    sampler does while it walks it); returns the detach."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    libc.ptrace.argtypes = [ctypes.c_long, ctypes.c_long, ctypes.c_void_p,
                            ctypes.c_void_p]
    seize, interrupt, detach = 0x4206, 0x4207, 17
    assert libc.ptrace(seize, pid, None, None) == 0, ctypes.get_errno()
    assert libc.ptrace(interrupt, pid, None, None) == 0
    _, status = os.waitpid(pid, 0x40000000)  # __WALL
    assert os.WIFSTOPPED(status)
    return lambda: libc.ptrace(detach, pid, None, None)


def test_on_demand_dump_of_a_held_worker_while_its_main_thread_is_traced(
        flight_dir):
    """A worker held in a delay fault writes its on-demand dump within a
    second of a SIGUSR1 that arrived while a tracer held its main thread:
    the kernel then hands the signal to another thread, which wakes no
    sleep of the main thread, so the delay sleeps in slices (one 60 s
    sleep held the dump for the whole delay)."""
    proc = _child(flight_dir, "held")
    try:
        up = _up(proc)
        demand_path = os.path.join(flight_dir,
                                   "flight_node1_rank0.ondemand.json")
        time.sleep(0.5)  # into the delay
        release = _hold_main_thread(up["pid"])
        try:
            proc.send_signal(signal.SIGUSR1)
            time.sleep(0.2)
        finally:
            release()
        deadline = time.time() + 1.0
        while not os.path.exists(demand_path):
            assert time.time() < deadline, "no on-demand dump"
            time.sleep(0.02)
        assert port_fr.load_dump(demand_path)["pid"] == up["pid"]
        assert proc.poll() is None
    finally:
        proc.kill()
        proc.communicate(timeout=30)


def test_runtime_arms_the_crash_dump_with_the_incarnation(flight_dir):
    proc = _child(flight_dir, "runtime", env={
        "DLROVER_TPU_NODE_RANK": "2", "DLROVER_TPU_LOCAL_RANK": "1",
        "DLROVER_TPU_PROCESS_ID": "5", "DLROVER_TPU_NUM_PROCESSES": "6",
        "DLROVER_TPU_RESTART_COUNT": "3", "DLROVER_TPU_RDZV_ROUND": "7",
        "DLROVER_TPU_HANG_DEADLINE_S": "0"})
    try:
        up = _up(proc)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == -signal.SIGTERM
    finally:
        proc.kill()
        proc.communicate(timeout=30)
    want = {"node_rank": 2, "local_rank": 1, "process_id": 5,
            "num_processes": 6, "restart_count": 3, "rdzv_round": 7}
    assert up["meta"] == want
    dump = port_fr.collect_dumps(2, [1])[1]
    assert dump["meta"] == want and dump["pid"] == up["pid"]
