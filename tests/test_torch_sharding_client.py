"""The port's sharding client against the JAX package's.

The same dataset parameters go through the reference's
``IndexShardingClient`` over the reference's ``TaskManager`` and through
the port's over the port's, each behind an in-process fake of the master
client: the record-index streams, the parsed shard checkpoints taken
mid-stream and the streams resumed from them must be equal, with
``shuffle`` off and on (the shuffles draw from ``random`` reseeded
before each package), over two epochs, and over a scripted dataset with
an empty shard. Then the client tests of the reference's
``tests/test_data_pipeline.py`` run on the port: exactly-once
consumption through the prefetcher, the empty shard, coalesced reports,
the checkpoint taken mid-prefetch, a worker killed holding prefetched
leases, the prefetching loader over the client, and ``stop`` waking a
blocked fetch.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import importlib
import json
import random
import threading
import time

import numpy as np
import pytest

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from dlrover_tpu_torch.trainer.elastic.dataloader import PrefetchingDataLoader
from dlrover_tpu_torch.trainer.elastic.sharding_client import (
    IndexShardingClient,
    ShardingClient,
)
from tests.torch_event_guard import events_off

PACKAGES = ("dlrover_tpu", "dlrover_tpu_torch")


@pytest.fixture(autouse=True)
def _no_event_files(monkeypatch):
    events_off(monkeypatch)


def wait_until(predicate, timeout=5.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


class DirectMasterClient:
    """MasterClient data-sharding surface served by an in-process
    TaskManager of either package — no transport, exact RPC counting."""

    def __init__(self, task_manager, node_id: int = 0, comm_mod=comm,
                 wait_type=TaskType.WAIT):
        self._tm = task_manager
        self._node_id = node_id
        self._comm = comm_mod
        self._wait_type = wait_type
        self.rpcs = 0

    def report_dataset_shard_params(self, params):
        self.rpcs += 1
        self._tm.new_dataset(params)

    def get_task(self, dataset_name):
        self.rpcs += 1
        return self._tm.get_task(self._node_id, dataset_name)

    def get_tasks(self, dataset_name, count=1):
        self.rpcs += 1
        tasks = self._tm.get_tasks(self._node_id, dataset_name, count)
        wait = bool(tasks) and tasks[0].task_type == self._wait_type
        return (
            [] if wait else [t for t in tasks if t.task_id >= 0]
        ), wait

    def report_task_done(self, dataset_name, task_id, success=True):
        self.rpcs += 1
        self._tm.report_task_done(
            dataset_name, task_id, self._node_id, success
        )

    def report_tasks_done_batch(self, dataset_name, done_ids, failed_ids=None):
        self.rpcs += 1
        self._tm.report_tasks_done(
            dataset_name, self._node_id, done_ids, failed_ids
        )
        return self._comm.BaseResponse(True)

    def get_shard_checkpoint(self, dataset_name):
        self.rpcs += 1
        return self._tm.get_shard_checkpoint(dataset_name)

    def restore_shard_checkpoint(self, dataset_name, checkpoint):
        self.rpcs += 1
        self._tm.restore_shard_checkpoint(dataset_name, checkpoint)


# ---- the differential runs -------------------------------------------------


def _pkg(pkg):
    return (importlib.import_module(f"{pkg}.master.shard.task_manager"),
            importlib.import_module(f"{pkg}.trainer.elastic.sharding_client"),
            importlib.import_module(f"{pkg}.common.comm"),
            importlib.import_module(f"{pkg}.common.constants"))


def _stream_and_checkpoint(pkg, monkeypatch, size, shard, epochs, shuffle,
                           prefetch, cut):
    """Consume ``cut`` records, snapshot, kill; restore the snapshot into
    a fresh master and consume the rest. Returns (first records, parsed
    snapshot, resumed records)."""
    tm_mod, sc_mod, comm_mod, const = _pkg(pkg)
    # The WAIT backoff's jitter must not draw from the splitter's stream.
    monkeypatch.setattr(sc_mod, "random", random.Random(7))
    random.seed(1234)
    tm = tm_mod.TaskManager()
    client = DirectMasterClient(tm, comm_mod=comm_mod,
                                wait_type=const.TaskType.WAIT)
    isc = sc_mod.IndexShardingClient(
        client, "diff-ds", dataset_size=size, shard_size=shard,
        num_epochs=epochs, shuffle=shuffle, prefetch_depth=prefetch,
    )
    first = [isc.fetch_record_index() for _ in range(cut)]
    snapshot = isc.get_shard_checkpoint()
    isc.kill()
    random.seed(99)
    tm2 = tm_mod.TaskManager()
    client2 = DirectMasterClient(tm2, node_id=1, comm_mod=comm_mod,
                                 wait_type=const.TaskType.WAIT)
    isc2 = sc_mod.IndexShardingClient(
        client2, "diff-ds", dataset_size=size, shard_size=shard,
        num_epochs=epochs, shuffle=shuffle, prefetch_depth=prefetch,
    )
    isc2.restore_shard_checkpoint(snapshot)
    rest = list(isc2)
    assert tm2.finished()
    return first, json.loads(snapshot), rest


@pytest.mark.parametrize("shuffle, epochs, prefetch, cut", [
    (False, 1, 16, 45),
    (True, 1, 16, 38),
    (False, 2, 0, 130),
    (True, 2, 0, 61),
])
def test_port_client_streams_as_the_reference(monkeypatch, shuffle, epochs,
                                              prefetch, cut):
    out = {pkg: _stream_and_checkpoint(pkg, monkeypatch, 100, 7, epochs,
                                       shuffle, prefetch, cut)
           for pkg in PACKAGES}
    ref, port = out["dlrover_tpu"], out["dlrover_tpu_torch"]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    if epochs == 1:
        # Exactly once: the records of the shards the snapshot marks
        # done, then the resumed stream.
        undone = {i for s in port[1]["undone_shards"]
                  for i in (s[2] or range(s[0], s[1]))}
        done = [i for i in port[0] if i not in undone]
        assert sorted(done + port[2]) == list(range(100))


class ScriptedClient:
    """A master client serving a fixed task list (one task empty)."""

    def __init__(self, comm_mod):
        self.done = []
        self._tasks = [
            comm_mod.ShardTask(task_id=0, task_type="training", start=0,
                               end=3),
            comm_mod.ShardTask(task_id=1, task_type="training", start=5,
                               end=5),
            comm_mod.ShardTask(task_id=2, task_type="training", start=3,
                               end=6),
            comm_mod.ShardTask(task_id=3, task_type="training", start=0,
                               end=0, record_indices=[9, 7, 8]),
        ]
        self._comm = comm_mod

    def report_dataset_shard_params(self, params):
        pass

    def get_tasks(self, name, count=1):
        out = []
        while self._tasks and len(out) < count:
            out.append(self._tasks.pop(0))
        return out, False

    def report_task_done(self, name, task_id, success=True):
        self.done.append(task_id)

    def report_tasks_done_batch(self, name, done_ids, failed_ids=None):
        self.done.extend(done_ids)
        return self._comm.BaseResponse(True)


@pytest.mark.parametrize("prefetch_depth", [0, 4])
def test_port_client_streams_an_empty_shard_as_the_reference(prefetch_depth):
    out = {}
    for pkg in PACKAGES:
        _, sc_mod, comm_mod, _ = _pkg(pkg)
        client = ScriptedClient(comm_mod)
        isc = sc_mod.IndexShardingClient(
            client, "empty-ds", dataset_size=10, shard_size=3,
            prefetch_depth=prefetch_depth, report_batch=1,
        )
        stream = list(isc)
        assert wait_until(lambda: sorted(client.done) == [0, 1, 2, 3])
        out[pkg] = stream
    assert out["dlrover_tpu_torch"] == out["dlrover_tpu"] == [
        0, 1, 2, 3, 4, 5, 9, 7, 8]


# ---- the reference's client tests on the port -----------------------------


def test_prefetching_client_consumes_all_exactly_once():
    tm = TaskManager()
    client = DirectMasterClient(tm)
    isc = IndexShardingClient(
        client, "pf-ds", dataset_size=100, shard_size=7
    )
    seen = list(isc)
    assert sorted(seen) == list(range(100))
    assert tm.finished()
    # Strictly fewer control RPCs than the 2-per-shard sync path.
    assert client.rpcs < 2 * 15


def test_empty_shard_skipped_and_reported():
    """An empty shard must neither end iteration nor rot in ``doing``."""
    for prefetch_depth in (0, 4):  # sync and pipelined paths
        client = ScriptedClient(comm)
        client._tasks = client._tasks[:3]
        isc = IndexShardingClient(
            client, "empty-ds", dataset_size=6, shard_size=3,
            prefetch_depth=prefetch_depth, report_batch=1,
        )
        assert sorted(isc) == [0, 1, 2, 3, 4, 5]
        assert wait_until(lambda: sorted(client.done) == [0, 1, 2])


def test_reports_coalesced_and_flushed_on_count():
    tm = TaskManager()
    client = DirectMasterClient(tm)
    sc = ShardingClient(
        client, "co-ds", dataset_size=40, shard_size=10,
        report_batch=4, report_interval_s=3600.0,
        wait_flush_age_s=3600.0,  # only the count flush may fire
    )
    tasks = [sc.fetch_task() for _ in range(4)]
    assert all(t is not None for t in tasks)
    for t in tasks[:3]:
        sc.report_task_done(t)
    mgr = tm.get_dataset("co-ds")
    assert len(mgr.doing) == 4  # below count threshold: nothing sent
    sc.report_task_done(tasks[3])  # 4th report trips the batch flush
    assert wait_until(lambda: len(mgr.doing) == 0)
    assert tm.finished()
    sc.stop()


def test_shard_checkpoint_mid_prefetch_no_replay_no_loss():
    """Shard checkpoint taken while the prefetcher is live: pending done
    reports are force-flushed first, so the checkpoint holds exactly the
    unconsumed shards — restore replays nothing and loses nothing."""
    tm = TaskManager()
    client = DirectMasterClient(tm)
    isc = IndexShardingClient(
        client, "ck-ds", dataset_size=60, shard_size=10,
        report_batch=64, report_interval_s=3600.0,  # only forced flushes
    )
    consumed = [isc.fetch_record_index() for _ in range(20)]
    assert sorted(consumed) == list(range(20))
    mgr = tm.get_dataset("ck-ds")
    # Nothing flushed yet: the two finished shards still sit in doing.
    assert len(mgr.doing) >= 2
    ckpt = isc.get_shard_checkpoint()  # forces the flush
    assert mgr._completed_count == 2
    undone = json.loads(ckpt)["undone_shards"]
    starts = sorted(s[0] for s in undone)
    assert starts == [20, 30, 40, 50]  # done shards NOT in the ckpt
    isc.kill()  # crash: prefetched leases die with the worker

    # Restart: fresh master, fresh worker, restore the checkpoint.
    tm2 = TaskManager()
    client2 = DirectMasterClient(tm2, node_id=1)
    isc2 = IndexShardingClient(
        client2, "ck-ds", dataset_size=60, shard_size=10
    )
    isc2.restore_shard_checkpoint(ckpt)
    resumed = sorted(isc2)
    assert resumed == list(range(20, 60))  # no replay, no loss
    assert tm2.finished()


def test_shard_checkpoint_refused_while_reports_are_unflushed():
    """A snapshot over accounting the master has not seen would bake a
    replay in: when the forced flush cannot land, the snapshot is
    refused and the reports stay queued."""

    class Unreachable(DirectMasterClient):
        def report_tasks_done_batch(self, *a, **kw):
            raise ConnectionError("master unreachable")

    tm = TaskManager()
    client = Unreachable(tm)
    isc = IndexShardingClient(
        client, "rf-ds", dataset_size=30, shard_size=10,
        report_batch=64, report_interval_s=3600.0,
    )
    assert [isc.fetch_record_index() for _ in range(10)] == list(range(10))
    with pytest.raises(RuntimeError, match="shard checkpoint refused"):
        isc.get_shard_checkpoint()
    assert isc._pending_done  # noqa: SLF001 — still queued for a retry
    isc.kill()


def test_chaos_kill_worker_holding_prefetched_leases():
    """A worker dies holding prefetched shard leases. Node-death
    recovery (what the reference's ``TaskRescheduleCallback`` calls on
    its simulated cluster) re-queues them; the union of the dead
    worker's REPORTED shards and the survivor's consumption covers every
    record index exactly once."""
    tm = TaskManager()
    victim_id, survivor_id = 0, 1
    total = 120
    # Victim: prefetches aggressively, reports every done shard
    # immediately (report_batch=1) so "reported" is unambiguous,
    # consumes two full shards, then dies.
    vc = DirectMasterClient(tm, node_id=victim_id)
    victim = IndexShardingClient(
        vc, "chaos-ds", dataset_size=total, shard_size=10,
        prefetch_depth=16, fetch_batch=8, report_batch=1,
    )
    committed = [victim.fetch_record_index() for _ in range(20)]
    dmgr = tm.get_dataset("chaos-ds")
    assert wait_until(lambda: dmgr._completed_count == 2)
    # The prefetcher leased shards beyond the two consumed: the chaos
    # point of the test.
    assert len(dmgr.doing) > 0
    victim.kill()
    tm.recover_node_tasks(victim_id)
    assert wait_until(lambda: len(dmgr.doing) == 0)

    sc = DirectMasterClient(tm, node_id=survivor_id)
    survivor = IndexShardingClient(
        sc, "chaos-ds", dataset_size=total, shard_size=10
    )
    rest = list(survivor)
    everything = sorted(committed + rest)
    assert everything == list(range(total))  # exactly once
    assert tm.finished()


def _record_table(n=64, width=3):
    data = np.arange(n * width, dtype=np.int32).reshape(n, width)
    return data, lambda i: {"x": data[i]}


def test_prefetching_loader_with_sharding_client():
    tm = TaskManager()
    client = DirectMasterClient(tm)
    isc = IndexShardingClient(
        client, "dl-ds", dataset_size=48, shard_size=6
    )
    data, fetch = _record_table(48)
    loader = PrefetchingDataLoader(fetch, isc, per_host_batch_size=8)
    rows = np.concatenate([b["x"].copy() for b in loader])
    np.testing.assert_array_equal(
        np.sort(rows[:, 0]), data[:, 0]
    )
    assert tm.finished()


def test_stop_unblocks_training_thread_in_fetch_task():
    """stop()/kill() from another thread must wake a consumer blocked on
    the empty prefetch queue instead of hanging it forever."""
    tm = TaskManager()
    client = DirectMasterClient(tm, node_id=0)
    # Another worker leases everything: our queue stays empty (WAIT).
    hog = ShardingClient(
        DirectMasterClient(tm, node_id=9), "hang-ds",
        dataset_size=20, shard_size=10, prefetch_depth=0,
    )
    assert hog.fetch_task() is not None and hog.fetch_task() is not None
    sc = ShardingClient(client, "hang-ds", dataset_size=20, shard_size=10)
    result = {}

    def blocked_fetch():
        result["task"] = sc.fetch_task()

    t = threading.Thread(target=blocked_fetch, daemon=True)
    t.start()
    time.sleep(0.3)
    assert t.is_alive()
    sc.kill()
    t.join(timeout=5)
    assert not t.is_alive()
    assert result["task"] is None


def test_pause_and_resume_for_rescale_flush_and_discard():
    """A live rescale pauses the data path: pending reports are flushed
    (the master's ledger holds every finished shard), prefetched leases
    are dropped locally (they stay in ``doing`` for the snapshot restore
    or recovery), and the path resumes with a fresh queue."""
    tm = TaskManager()
    client = DirectMasterClient(tm)
    sc = ShardingClient(
        client, "rs-ds", dataset_size=80, shard_size=10,
        prefetch_depth=4, fetch_batch=2, report_batch=64,
        report_interval_s=3600.0,
    )
    first = sc.fetch_task()
    sc.report_task_done(first)
    mgr = tm.get_dataset("rs-ds")
    assert wait_until(lambda: len(mgr.doing) >= 3)
    assert sc.pause_for_rescale() == 1
    assert mgr._completed_count == 1
    held = len(mgr.doing)
    assert held >= 2  # the discarded leases stay leased
    sc.resume_after_rescale()
    tm.recover_node_tasks(0)
    seen = []
    while True:
        task = sc.fetch_task()
        if task is None:
            break
        seen.append(task.start)
        sc.report_task_done(task)
    sc.stop()
    assert sorted(seen) == list(range(10, 80, 10))
    assert tm.finished()
