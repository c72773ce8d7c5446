"""The port's master journal against the reference's
``tests/test_master_journal.py`` and against the JAX package itself.

The reference test's cases run on the port's ``master/journal.py``,
servicer, task manager and HTTP transport: torn-tail repair, the
crash-during-compaction rule, the future-schema refusal, group commit,
exactly-once rehydration, kv/checkpoint/plan rehydration, the dump tool
(``tools/torch_journal_dump.py``), epoch fencing, the outage
ride-through, retry exhaustion and the graceful drain.

Across packages: one scripted session (a dataset, leases, a failed and
a done report, kv writes, a rendezvous commit, a rescale plan cut, a
committed step, a sync) runs through each package's ``LocalJobMaster``
and ``MasterClient`` over HTTP. Each journal loads in both packages'
``load_journal`` to the same ``JournalState``, and ``restore_master_state``
into both packages' ``TaskManager``s gives the same outstanding task ids
and the same next ``get_task`` sequence. Last, the ``master.journal.write``
crash: the port's soak master, SIGKILLed by its fault schedule after a
dispatch became durable and before the reply left, restarts on the same
journal and port, and the lease whose reply died is handed out exactly
once more.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import dataclasses
import importlib
import json
import os
import signal
import socket
import threading
import time

import pytest

from dlrover_tpu_torch.agent.master_client import (
    MAX_RETRIES_ENV,
    OUTAGE_ENV,
    MasterClient,
    RpcRetriesExhausted,
)
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.master.elastic_training.kv_store import KVStoreService
from dlrover_tpu_torch.master.elastic_training.sync_service import SyncService
from dlrover_tpu_torch.master.journal import (
    SCHEMA_VERSION,
    MasterJournal,
    load_journal,
    restore_master_state,
)
from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from dlrover_tpu_torch.observability.registry import default_registry
from dlrover_tpu_torch.rpc.transport import HttpMasterServer
from tests.torch_event_guard import events_off

PACKAGES = ("dlrover_tpu", "dlrover_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_event_files(monkeypatch):
    events_off(monkeypatch)


def _params(name="ds", size=64, shard=16, epochs=1, shuffle=False):
    return {
        "dataset_name": name,
        "dataset_size": size,
        "shard_size": shard,
        "num_epochs": epochs,
        "shuffle": shuffle,
        "task_type": "training",
        "storage_type": "text",
    }


def _journal_with_leases(path, done_tids=(0,), outstanding_tids=(1, 2)):
    """A journal recording a 4-shard dataset with some leases done and
    some outstanding — the canonical crash state."""
    j = MasterJournal(path)
    j.append("dataset", params=_params())
    for tid in sorted(set(done_tids) | set(outstanding_tids)):
        j.append(
            "dispatch", ds="ds", tid=tid, node=0, epoch=1,
            start=tid * 16, end=(tid + 1) * 16,
            idx=list(range(tid * 16, (tid + 1) * 16)), part=0,
        )
    if done_tids:
        j.append("done", ds="ds", node=0, ok=list(done_tids), fail=[])
    return j


# ---------------------------------------------------------------------------
# The reference test's cases, on the port
# ---------------------------------------------------------------------------


def test_roundtrip_and_epoch_bump(tmp_path):
    path = str(tmp_path / "m.journal")
    j = _journal_with_leases(path)
    assert j.master_epoch == 1
    j.append("kv_set", key="rdzv/token", val="dG9r")
    j.append("ckpt_step", step=400)
    j.append("plan_cut", plan_id=3)
    j.close()

    j2 = MasterJournal(path)
    assert j2.master_epoch == 2  # monotone fencing epoch
    st = j2.recovered
    assert st.clean_shutdown
    assert st.corrupt_lines == 0
    assert st.ckpt_step == 400
    assert st.plan_seq == 3
    assert st.kv["rdzv/token"] == b"tok"
    ds = st.datasets["ds"]
    assert sorted(ds.outstanding) == [1, 2]
    assert ds.completed == 1
    j2.close()


def test_torn_final_line_repaired_and_counted(tmp_path):
    path = str(tmp_path / "m.journal")
    j = _journal_with_leases(path)
    # SIGKILL mid-append: a partial record with no newline.
    j._f.write('{"kind": "done", "ds": "ds", "ok": [1')  # noqa: SLF001
    j._f.flush()  # noqa: SLF001
    os.fsync(j._f.fileno())  # noqa: SLF001
    j._f.close()  # noqa: SLF001

    j2 = MasterJournal(path)
    st = j2.recovered
    # The torn line is skipped (counted for forensics), the done it
    # would have recorded never happened: tid 1 stays outstanding.
    assert st.corrupt_lines == 1
    assert not st.clean_shutdown
    assert sorted(st.datasets["ds"].outstanding) == [1, 2]
    # New appends land on a fresh line, not glued to torn bytes.
    j2.append("ckpt_step", step=7)
    j2.close()
    st3 = load_journal(path)
    assert st3.corrupt_lines == 1
    assert st3.ckpt_step == 7
    j2.close()


def test_future_schema_version_refused(tmp_path):
    path = str(tmp_path / "m.journal")
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps(
            {"kind": "header", "v": SCHEMA_VERSION + 1, "epoch": 9}
        ) + "\n")
    with pytest.raises(ValueError, match="newer than supported"):
        MasterJournal(path)
    # The refusing reader must not have truncated or rewritten it.
    with open(path, encoding="utf-8") as f:
        assert f"\"v\": {SCHEMA_VERSION + 1}" in f.read()


def test_crash_during_compaction_old_segment_wins(tmp_path):
    path = str(tmp_path / "m.journal")
    j = _journal_with_leases(path)
    j.close()
    before = load_journal(path)
    # Crash AFTER the snapshot tmp was written+fsynced but BEFORE
    # os.replace: the tmp sibling exists, the live segment is still
    # the old journal, and recovery must read the old segment.
    with open(path + ".compact.tmp", "w", encoding="utf-8") as f:
        f.write(json.dumps({"kind": "header", "v": SCHEMA_VERSION,
                            "epoch": 99, "compaction": 1}) + "\n")
        f.write(json.dumps({"kind": "snapshot", "v": SCHEMA_VERSION,
                            "state": {}}) + "\n")
    j2 = MasterJournal(path)
    assert j2.recovered.records == before.records
    assert j2.master_epoch == before.master_epoch + 1
    assert sorted(j2.recovered.datasets["ds"].outstanding) == [1, 2]
    j2.close()


def test_compaction_preserves_leases_and_keeps_forensic_segment(tmp_path):
    path = str(tmp_path / "m.journal")
    tm = TaskManager(task_timeout=600.0)
    _journal_with_leases(path).close()
    j = MasterJournal(path)
    restore_master_state(j.recovered, task_manager=tm)
    servicer = MasterServicer(
        rdzv_managers={}, task_manager=tm,
        perf_monitor=PerfMonitor(), journal=j,
    )
    # Lease-preserving snapshot compaction: original tids survive.
    j.compact(servicer.journal_snapshot())
    assert os.path.exists(path + ".1")  # forensic chain
    j.close()
    st = load_journal(path)
    assert st.compactions == 1
    assert st.clean_shutdown
    assert sorted(st.datasets["ds"].outstanding) == [1, 2]
    assert st.datasets["ds"].completed == 1
    tm.stop()


def test_auto_compaction_keeps_segments_and_state(tmp_path):
    """Past ``max_bytes`` the journal compacts itself through the
    servicer's snapshot; at most ``KEEP_SEGMENTS`` forensic segments
    stay, and the replay keeps the leases and the kv."""
    from dlrover_tpu_torch.master.journal import KEEP_SEGMENTS

    path = str(tmp_path / "m.journal")
    tm = TaskManager(task_timeout=600.0)
    _journal_with_leases(path).close()
    j = MasterJournal(path, max_bytes=1)  # floored at 64 KiB
    restore_master_state(j.recovered, task_manager=tm)
    kv = KVStoreService()
    MasterServicer(rdzv_managers={}, task_manager=tm,
                   perf_monitor=PerfMonitor(), kv_store=kv, journal=j)
    for i in range(8000):
        j.append("ckpt_step", step=i)
    j.append("kv_set", key="k", val="dg==")
    stats = j.stats()
    j.close()
    assert stats["compactions"] >= KEEP_SEGMENTS + 1
    assert os.path.exists(f"{path}.{KEEP_SEGMENTS}")
    assert not os.path.exists(f"{path}.{KEEP_SEGMENTS + 1}")
    st = load_journal(path)
    assert sorted(st.datasets["ds"].outstanding) == [1, 2]
    assert st.ckpt_step == 7999 and st.kv["k"] == b"v"
    tm.stop()


def test_group_commit_concurrent_appenders(tmp_path):
    path = str(tmp_path / "m.journal")
    j = MasterJournal(path)
    n_threads, per_thread = 8, 25

    def appender(t):
        for i in range(per_thread):
            j.append("ckpt_step", step=t * 1000 + i)

    threads = [
        threading.Thread(target=appender, args=(t,))
        for t in range(n_threads)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    j.close()
    st = load_journal(path)
    assert st.corrupt_lines == 0
    assert st.kinds["ckpt_step"] == n_threads * per_thread
    # Group commit must have shared fsyncs across appenders.
    assert j.stats()["commit_groups"] <= n_threads * per_thread


def test_exactly_once_after_restart(tmp_path):
    path = str(tmp_path / "m.journal")
    _journal_with_leases(path, done_tids=(0,),
                         outstanding_tids=(1, 2)).close()
    j = MasterJournal(path)
    tm = TaskManager(task_timeout=600.0)
    summary = restore_master_state(j.recovered, task_manager=tm)
    assert summary["datasets"]["ds"] == {
        "todo": 1, "doing": 2, "completed": 1, "epoch": 1,
    }
    mgr = tm.get_dataset("ds")
    # Outstanding leases keep their ORIGINAL ids so a riding-through
    # worker's done-report still pops them.
    assert sorted(mgr.doing) == [1, 2]
    # Drain everything: the only new dispatch is the one un-issued
    # shard; done shard 0 is never re-dispatched.
    task = tm.get_task(0, "ds")
    assert (task.start, task.end) == (48, 64)
    assert task.task_id == 3  # next_task_id = max_tid + 1
    for tid in (1, 2, task.task_id):
        tm.report_task_done("ds", tid, 0, True)
    assert tm.get_task(0, "ds").task_id == -1  # exhausted
    assert mgr._completed_count == 4  # noqa: SLF001
    j.close()
    tm.stop()


def test_kv_ckpt_plan_rehydrate(tmp_path):
    from dlrover_tpu_torch.master.elastic_training.rescale_coordinator import (
        RescaleCoordinator,
    )

    path = str(tmp_path / "m.journal")
    j = MasterJournal(path)
    j.append("kv_set", key="k", val="dg==")
    j.append("ckpt_step", step=123)
    j.append("plan_cut", plan_id=5)
    j.close()
    j2 = MasterJournal(path)
    kv = KVStoreService()
    coord = RescaleCoordinator()
    restore_master_state(
        j2.recovered, kv_store=kv, rescale_coordinator=coord
    )
    assert kv.get("k") == b"v"
    # A restarted master never re-issues a stale plan_id and never
    # forgets the newest committed step.
    assert coord._plan_seq == 5  # noqa: SLF001
    assert coord._committed_step == 123  # noqa: SLF001
    j2.close()


def test_streaming_dataset_replays_its_offsets(tmp_path):
    """A stream dataset's leases replay into the streaming manager: the
    outstanding lease keeps its id, the splitter's offsets move past
    every journaled carve, and no shard is handed out twice."""
    path = str(tmp_path / "m.journal")
    j = MasterJournal(path)
    tm = TaskManager(task_timeout=600.0)
    servicer = MasterServicer(rdzv_managers={}, task_manager=tm,
                              perf_monitor=PerfMonitor(), journal=j)
    server = HttpMasterServer(0, servicer)
    server.start()
    client = MasterClient(f"localhost:{server.port}", node_id=0,
                          kind="http", timeout=10.0)
    try:
        client.report_dataset_shard_params(comm.DatasetShardParams(
            dataset_name="s", dataset_size=-1, shard_size=4,
            storage_type="stream", num_partitions=2))
        tasks, _ = client.get_tasks("s", 3)
        client.report_tasks_done_batch(
            "s", [tasks[0].task_id, tasks[1].task_id], [])
    finally:
        client.close()
        server.stop()
        tm.stop()
        j.close()
    j2 = MasterJournal(path)
    tm2 = TaskManager(task_timeout=600.0)
    summary = restore_master_state(j2.recovered, task_manager=tm2)
    mgr = tm2.get_dataset("s")
    assert type(mgr).__name__ == "StreamingDatasetManager"
    assert sorted(mgr.doing) == [tasks[2].task_id]
    assert summary["datasets"]["s"]["completed"] == 2
    seen = {(t.partition, t.start) for t in tasks}
    for _ in range(6):
        t = tm2.get_task(0, "s")
        assert (t.partition, t.start) not in seen
        seen.add((t.partition, t.start))
    j2.close()
    tm2.stop()


def test_journal_dump_tool(tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_journal_dump",
        os.path.join(REPO, "tools", "torch_journal_dump.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    path = str(tmp_path / "m.journal")
    _journal_with_leases(path).close()
    out = mod.dump(path, with_datasets=True)
    assert out["clean_shutdown"]
    assert out["kinds"]["dispatch"] == 3
    assert out["tail"]["torn"] is False
    assert out["datasets"]["ds"]["outstanding_leases"] == [1, 2]
    assert mod.main([path, "--validate"]) == 0


class _LiveMaster:
    """In-process journaled master over the real HTTP transport."""

    def __init__(self, journal_path, port=0):
        self.journal = MasterJournal(journal_path)
        self.task_manager = TaskManager(task_timeout=600.0)
        self.kv_store = KVStoreService()
        restore_master_state(
            self.journal.recovered, task_manager=self.task_manager,
            kv_store=self.kv_store,
        )
        self.servicer = MasterServicer(
            rdzv_managers={}, task_manager=self.task_manager,
            perf_monitor=PerfMonitor(), sync_service=SyncService(),
            kv_store=self.kv_store, journal=self.journal,
        )
        self.server = HttpMasterServer(port, self.servicer)
        self.server.add_shutdown_hook(self.journal.close)
        self.server.start()
        self.port = self.server.port

    def stop(self, graceful=False):
        if graceful:
            self.server.graceful_stop(drain_s=2.0)
        else:
            self.server.stop()
        self.task_manager.stop()
        if not self.journal.closed:
            self.journal.close()


def test_epoch_stamped_and_listener_fires_on_restart(tmp_path):
    path = str(tmp_path / "m.journal")
    m1 = _LiveMaster(path)
    client = MasterClient(
        f"localhost:{m1.port}", node_id=0, kind="http", timeout=10.0
    )
    changes = []
    client.add_epoch_listener(lambda old, new: changes.append((old, new)))
    try:
        client.kv_store_set("k", b"v")
        assert client.master_epoch == 1
        assert changes == []  # first observation only records
        m1.stop(graceful=True)

        m2 = _LiveMaster(path, port=m1.port)
        try:
            # Restored kv survives, and the bumped epoch is fenced
            # into the reply, firing the change listener exactly once.
            assert client.kv_store_get("k") == b"v"
            assert client.master_epoch == 2
            assert changes == [(1, 2)]
        finally:
            m2.stop()
    finally:
        client.close()


def test_outage_ride_through(tmp_path, monkeypatch):
    monkeypatch.setenv(OUTAGE_ENV, "15")
    path = str(tmp_path / "m.journal")
    m1 = _LiveMaster(path)
    client = MasterClient(
        f"localhost:{m1.port}", node_id=0, kind="http", timeout=10.0
    )
    try:
        client.kv_store_set("k", b"v1")
        port = m1.port
        m1.stop(graceful=True)
        restarted = {}

        def restart():
            time.sleep(1.0)
            restarted["m"] = _LiveMaster(path, port=port)

        t = threading.Thread(target=restart, daemon=True)
        t.start()
        # The call spans the outage: refused while the master is
        # down, then rides through to the restarted generation.
        t0 = time.monotonic()
        assert client.kv_store_get("k") == b"v1"
        assert time.monotonic() - t0 >= 0.5
        assert not client.in_outage
        t.join()
        restarted["m"].stop()
    finally:
        client.close()


def test_retries_exhausted_names_verb_and_counts(monkeypatch):
    monkeypatch.setenv(MAX_RETRIES_ENV, "2")
    monkeypatch.delenv(OUTAGE_ENV, raising=False)
    # A port with nothing listening: connection refused every time.
    s = socket.socket()
    s.bind(("localhost", 0))
    dead_port = s.getsockname()[1]
    s.close()
    client = MasterClient(
        f"localhost:{dead_port}", node_id=0, kind="http", timeout=2.0
    )
    counter = default_registry().get("client_rpc_retries_exhausted_total")
    before = counter.value(verb="kv_store_get") if counter else 0.0
    try:
        with pytest.raises(RpcRetriesExhausted) as exc:
            client.kv_store_get("k")
        assert exc.value.verb == "kv_store_get"
        assert exc.value.attempts == 2
        assert "kv_store_get" in str(exc.value)
        counter = default_registry().get(
            "client_rpc_retries_exhausted_total"
        )
        assert counter.value(verb="kv_store_get") == before + 1
    finally:
        client.close()


def test_graceful_stop_flushes_clean_shutdown(tmp_path):
    path = str(tmp_path / "m.journal")
    m = _LiveMaster(path)
    client = MasterClient(
        f"localhost:{m.port}", node_id=0, kind="http", timeout=10.0
    )
    try:
        client.report_ckpt_step(10, committed=True)
    finally:
        client.close()
    m.stop(graceful=True)
    st = load_journal(path)
    assert st.clean_shutdown
    assert st.ckpt_step == 10


# ---------------------------------------------------------------------------
# One format, two writers
# ---------------------------------------------------------------------------


def _session(pkg, path):
    """The scripted session through ``pkg``'s journaled LocalJobMaster
    and MasterClient over HTTP; returns the task ids it dispatched."""
    lm = importlib.import_module(f"{pkg}.master.local_master")
    mc = importlib.import_module(f"{pkg}.agent.master_client")
    pcomm = importlib.import_module(f"{pkg}.common.comm")
    jc = importlib.import_module(f"{pkg}.master.node.job_context")
    consts = importlib.import_module(f"{pkg}.common.constants")
    jc.JobContext.reset_singleton()
    master = lm.LocalJobMaster(port=0, node_num=1, transport="http",
                               journal_path=path)
    master.prepare()
    client = mc.MasterClient(f"localhost:{master.port}", node_id=0,
                             kind="http", timeout=10.0)
    try:
        client.report_dataset_shard_params(pcomm.DatasetShardParams(
            dataset_name="ds", dataset_size=80, shard_size=16,
            num_epochs=2, shuffle=False, task_type="training"))
        first, _ = client.get_tasks("ds", 3)
        client.report_tasks_done_batch(
            "ds", [first[0].task_id], [first[1].task_id])
        second, _ = client.get_tasks("ds", 2)
        client.report_tasks_done_batch("ds", [second[0].task_id], [])
        client.kv_store_set("bin", bytes(range(7)))
        client.kv_store_add("ctr", 3)
        rdzv = consts.RendezvousName.TRAINING
        client.join_rendezvous(0, 1, rdzv)
        for _ in range(50):
            world = client.get_comm_world(rdzv, 0)[2]
            if world:
                break
            time.sleep(0.1)
        client.rescale_join(0, 1)
        for _ in range(50):
            if client.get_rescale_plan(0, -1) is not None:
                break
            time.sleep(0.1)
        client.report_ckpt_step(32, committed=True)
        client.join_sync("s1", 0)
        client.sync_finished("s1")
    finally:
        client.close()
        master.stop()
    return [t.task_id for t in first + second]


def _state_dict(pkg, path):
    state = importlib.import_module(f"{pkg}.master.journal").load_journal(
        path)
    out = dataclasses.asdict(state)
    out["kinds"] = dict(state.kinds)
    return out


def _next_tasks(pkg, path):
    """Restore ``path`` into ``pkg``'s TaskManager: the outstanding task
    ids, then every task until the dataset ends (each reported done)."""
    journal = importlib.import_module(f"{pkg}.master.journal")
    tm_mod = importlib.import_module(f"{pkg}.master.shard.task_manager")
    tm = tm_mod.TaskManager(task_timeout=600.0)
    journal.restore_master_state(journal.load_journal(path),
                                 task_manager=tm)
    mgr = tm.get_dataset("ds")
    outstanding = sorted(mgr.doing)
    seq = []
    for _ in range(40):
        t = tm.get_task(0, "ds")
        if t.task_id < 0:
            break
        seq.append((t.task_id, t.start, t.end))
        tm.report_task_done("ds", t.task_id, 0, True)
    tm.stop()
    return outstanding, seq


@pytest.mark.parametrize("writer", PACKAGES)
def test_one_journal_format_for_both_packages(tmp_path, writer):
    path = str(tmp_path / "m.journal")
    tids = _session(writer, path)
    states = {pkg: _state_dict(pkg, path) for pkg in PACKAGES}
    assert states["dlrover_tpu"] == states["dlrover_tpu_torch"]
    st = states["dlrover_tpu_torch"]
    # Not vacuous: every kind of record the session made replayed.
    assert st["clean_shutdown"] and st["corrupt_lines"] == 0
    for kind in ("dataset", "dispatch", "done", "kv_set", "rdzv",
                 "plan_cut", "ckpt_step", "sync", "close"):
        assert st["kinds"].get(kind, 0) > 0, (kind, st["kinds"])
    assert st["kv"]["bin"] == bytes(range(7))
    assert st["kv"]["ctr"] == b"3"
    assert st["ckpt_step"] == 32 and st["plan_seq"] >= 1
    assert st["rdzv"]["training"]["world"] == {0: 1}
    assert st["sync_finished"] == ["s1"]
    ds = st["datasets"]["ds"]
    assert ds["completed"] == 2
    assert sorted(ds["outstanding"]) == [tids[2], tids[4]]
    # The same leases and the same next tasks from either restore.
    after = {pkg: _next_tasks(pkg, path) for pkg in PACKAGES}
    assert after["dlrover_tpu"] == after["dlrover_tpu_torch"]
    outstanding, seq = after["dlrover_tpu_torch"]
    assert outstanding == sorted([tids[2], tids[4]])
    # The failed shard comes back; two epochs of five shards, the done
    # two and the two outstanding leases excluded.
    assert len(seq) == 10 - 2 - 2
    assert {s[0] for s in seq}.isdisjoint(tids)


# ---------------------------------------------------------------------------
# The master.journal.write crash over HTTP
# ---------------------------------------------------------------------------


def test_journal_write_crash_requeues_the_lost_lease_once(tmp_path,
                                                         monkeypatch):
    """The port's soak master dies on its second durable dispatch, before
    the reply leaves: the client's call fails, the journal holds both
    leases, and the master restarted on the same journal and port (epoch
    2) re-dispatches the lost lease once its timeout expires, while the
    delivered one keeps its id for the done-report. Every shard is
    consumed exactly once."""
    from dlrover_tpu_torch.testing import master_kill_soak as mks

    monkeypatch.setenv(MAX_RETRIES_ENV, "1")
    monkeypatch.delenv(OUTAGE_ENV, raising=False)
    ep_dir = str(tmp_path)
    journal = os.path.join(ep_dir, "master.journal")
    sched = os.path.join(ep_dir, "schedule.json")
    with open(sched, "w") as f:
        f.write(mks.build_master_schedule(0, nth=2).to_json())
    gen0 = mks._spawn_master(ep_dir, journal, os.path.join(ep_dir, "r0"),
                             0, 0, sched, 1.0)
    gen1 = None
    try:
        info = mks._wait_ready(os.path.join(ep_dir, "r0"), gen0)
        assert info["epoch"] == 1
        port = info["port"]
        client = MasterClient(f"localhost:{port}", node_id=0, kind="http",
                              timeout=10.0)
        client.report_dataset_shard_params(comm.DatasetShardParams(
            dataset_name="ds", dataset_size=64, shard_size=16,
            num_epochs=1, shuffle=False, task_type="training"))
        delivered, _ = client.get_tasks("ds", 1)
        with pytest.raises(Exception):
            client.get_tasks("ds", 1)
        client.close()
        assert gen0.wait(timeout=30) == -signal.SIGKILL
        st = load_journal(journal)
        assert sorted(st.datasets["ds"].outstanding) == [0, 1]
        assert not st.clean_shutdown

        gen1 = mks._spawn_master(ep_dir, journal, os.path.join(ep_dir, "r1"),
                                 port, 1, "", 1.0)
        assert mks._wait_ready(os.path.join(ep_dir, "r1"),
                               gen1)["epoch"] == 2
        client = MasterClient(f"localhost:{port}", node_id=0, kind="http",
                              timeout=10.0)
        client.report_tasks_done_batch("ds", [delivered[0].task_id], [])
        ranges = [(delivered[0].start, delivered[0].end)]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            tasks, wait = client.get_tasks("ds", 1)
            if tasks:
                ranges += [(t.start, t.end) for t in tasks]
                client.report_tasks_done_batch(
                    "ds", [t.task_id for t in tasks], [])
            elif wait:
                time.sleep(0.1)
            else:
                break
        assert client.master_epoch == 2
        client.close()
        assert sorted(ranges) == [(s, s + 16) for s in range(0, 64, 16)]
        gen1.terminate()
        assert gen1.wait(timeout=30) == 0
        assert load_journal(journal).clean_shutdown
        with open(os.path.join(ep_dir, "trace_master_gen0.jsonl")) as f:
            trace = [json.loads(ln) for ln in f]
        assert [(t["point"], t["hit"]) for t in trace] == [
            ("master.journal.write", 2)]
    finally:
        for proc in (gen0, gen1):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
