"""The port's streaming dataset manager against the reference's
``tests/test_streaming_dataset.py`` and against the JAX package's
manager.

The reference test's nine cases run on the port's
``master/shard/streaming_dataset_manager.py`` (unbounded carving,
per-partition offsets, a bounded stream's exact tail, the retry budget,
node loss, the offsets checkpoint, the task manager's routing, a batch
dataset's failed task, the splitter factory). Then one seeded sequence of
operations (get, done, fail, node loss, checkpoint) runs through both
packages' managers and gives the same tasks and checkpoints, and each
package's checkpoint restores in the other's manager to the same next
tasks.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import importlib
import json
import random

import pytest

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.master.shard.dataset_splitter import (
    StreamingDatasetSplitter,
    create_dataset_splitter,
)
from dlrover_tpu_torch.master.shard.streaming_dataset_manager import (
    _MAX_TASK_RETRIES,
    StreamingDatasetManager,
)
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from tests.torch_event_guard import events_off

PACKAGES = ("dlrover_tpu", "dlrover_tpu_torch")


@pytest.fixture(autouse=True)
def _no_event_files(monkeypatch):
    events_off(monkeypatch)


def make_mgr(partitions=2, size=-1, shard=10, fetch=4):
    splitter = StreamingDatasetSplitter(
        "stream-ds",
        shard_size=shard,
        num_partitions=partitions,
        dataset_size=size,
        fetch_shards=fetch,
    )
    return StreamingDatasetManager("training", splitter)


def test_unbounded_stream_never_finishes():
    mgr = make_mgr(size=-1)
    for _ in range(50):  # far beyond one fetch window
        task = mgr.get_task(node_id=0)
        assert task.task_id >= 0
        mgr.report_task_done(task.task_id, 0)
    assert not mgr.completed()
    assert mgr.completed_records() == 50 * 10


def test_offsets_advance_per_partition():
    mgr = make_mgr(partitions=2, fetch=4)
    tasks = [mgr.get_task(0) for _ in range(4)]
    by_part = {}
    for t in tasks:
        by_part.setdefault(t.shard.partition, []).append(t.shard)
    assert set(by_part) == {0, 1}
    for shards in by_part.values():
        assert [s.start for s in shards] == [0, 10]
        assert [s.end for s in shards] == [10, 20]


def test_bounded_stream_finishes_exactly():
    mgr = make_mgr(size=25, shard=10, fetch=8)
    seen = 0
    while True:
        task = mgr.get_task(0)
        if task.task_id < 0 and task.task_type != TaskType.WAIT:
            break
        mgr.report_task_done(task.task_id, 0)
        seen += task.shard.end - task.shard.start
    assert seen == 25  # tail shard carved exactly
    assert mgr.completed()


def test_failed_task_requeues_then_drops():
    mgr = make_mgr(fetch=1)
    first = mgr.get_task(0)
    key = (first.shard.partition, first.shard.start, first.shard.end)
    for i in range(_MAX_TASK_RETRIES):
        assert not mgr.report_task_done(first.task_id, 0, success=False)
        again = mgr.get_task(0)
        assert (
            again.shard.partition,
            again.shard.start,
            again.shard.end,
        ) == key, "failed shard was not re-queued first"
        first = again
    # Budget exhausted: the shard is dropped, the stream moves on.
    mgr.report_task_done(first.task_id, 0, success=False)
    nxt = mgr.get_task(0)
    assert (nxt.shard.partition, nxt.shard.start, nxt.shard.end) != key


def test_node_loss_requeues_in_flight_shards():
    mgr = make_mgr(fetch=4)
    t_a = mgr.get_task(node_id=7)
    t_b = mgr.get_task(node_id=8)
    mgr.recover_node_tasks(7)
    # Node 7's shard comes back first; node 8's stays in flight.
    t_c = mgr.get_task(node_id=9)
    assert t_c.shard.start == t_a.shard.start
    assert t_c.shard.partition == t_a.shard.partition
    assert t_b.task_id in mgr.doing


def test_checkpoint_restore_resumes_offsets():
    mgr = make_mgr(partitions=2, fetch=4)
    done = mgr.get_task(0)
    mgr.report_task_done(done.task_id, 0)
    inflight = mgr.get_task(0)  # left in doing -> must be in checkpoint
    state = json.loads(json.dumps(mgr.checkpoint()))  # wire round-trip

    restored = make_mgr(partitions=2, fetch=4)
    restored.restore(state, "stream-ds")
    assert restored.completed_records() == 10
    # The in-flight shard is re-dispatched first...
    t = restored.get_task(0)
    assert (t.shard.partition, t.shard.start) == (
        inflight.shard.partition,
        inflight.shard.start,
    )
    # ...and fresh carving continues AFTER the checkpointed offsets:
    # no shard is ever handed out twice.
    seen = {(done.shard.partition, done.shard.start)}
    for _ in range(8):
        t = restored.get_task(0)
        key = (t.shard.partition, t.shard.start)
        assert key not in seen
        seen.add(key)


def test_task_manager_routes_streaming():
    tm = TaskManager()
    tm.new_dataset(
        comm.DatasetShardParams(
            dataset_name="s1",
            dataset_size=-1,
            shard_size=5,
            storage_type="stream",
            num_partitions=3,
        )
    )
    assert isinstance(tm.get_dataset("s1"), StreamingDatasetManager)
    task = tm.get_task(0, "s1")
    assert task.task_id >= 0
    assert task.end - task.start == 5
    # success=False routes to the streaming retry path
    tm.report_task_done("s1", task.task_id, 0, success=False)
    again = tm.get_task(0, "s1")
    assert (again.partition, again.start) == (task.partition, task.start)
    # shard checkpoint round-trips through the servicer JSON surface
    ckpt = tm.get_shard_checkpoint("s1")
    tm.restore_shard_checkpoint("s1", ckpt)
    assert isinstance(tm.get_dataset("s1"), StreamingDatasetManager)


def test_batch_failed_task_requeues():
    """A worker-reported failure on a BATCH dataset re-queues the shard
    instead of counting its records as consumed."""
    tm = TaskManager()
    tm.new_dataset(
        comm.DatasetShardParams(
            dataset_name="b1",
            dataset_size=20,
            shard_size=10,
            storage_type="table",
        )
    )
    task = tm.get_task(0, "b1")
    tm.report_task_done("b1", task.task_id, 0, success=False)
    again = tm.get_task(0, "b1")
    assert (again.start, again.end) == (task.start, task.end)
    mgr = tm.get_dataset("b1")
    assert mgr._completed_count == 0


def test_splitter_factory():
    s = create_dataset_splitter(
        "stream", "x", -1, 4, num_partitions=2
    )
    assert isinstance(s, StreamingDatasetSplitter)


# ---------------------------------------------------------------------------
# Against the JAX package's manager
# ---------------------------------------------------------------------------


def _pkg_mgr(pkg, partitions, size, shard, fetch):
    ds = importlib.import_module(f"{pkg}.master.shard.dataset_splitter")
    sdm = importlib.import_module(
        f"{pkg}.master.shard.streaming_dataset_manager")
    splitter = ds.StreamingDatasetSplitter(
        "stream-ds", shard_size=shard, num_partitions=partitions,
        dataset_size=size, fetch_shards=fetch)
    return sdm.StreamingDatasetManager("training", splitter)


def _t(task):
    s = task.shard
    return [task.task_id, task.task_type, s.partition, s.start, s.end]


def _script(mgr, seed, n_ops=120):
    """A seeded sequence of gets, done and failed reports, node losses
    and checkpoints; returns its transcript."""
    rng = random.Random(seed)
    log = []
    held = []
    for _ in range(n_ops):
        op = rng.random()
        if op < 0.45 or not held:
            node = rng.randint(0, 2)
            task = mgr.get_task(node)
            log.append(("get", node, _t(task)))
            if task.task_id >= 0:
                held.append((task.task_id, node))
        elif op < 0.75:
            tid, node = held.pop(rng.randrange(len(held)))
            log.append(("done", tid, mgr.report_task_done(tid, node)))
        elif op < 0.87:
            tid, node = held.pop(rng.randrange(len(held)))
            log.append(("fail", tid,
                        mgr.report_task_done(tid, node, success=False)))
        elif op < 0.93:
            node = rng.randint(0, 2)
            mgr.recover_node_tasks(node)
            held = [h for h in held if h[1] != node]
            log.append(("lost", node))
        else:
            log.append(("ckpt", mgr.checkpoint()))
    log.append(("final", mgr.checkpoint(), mgr.completed(),
                mgr.completed_records(), sorted(mgr.doing)))
    return log


@pytest.mark.parametrize("seed, partitions, size, shard, fetch", [
    (0, 2, -1, 10, 4),
    (1, 3, 200, 7, 5),
    (2, 1, 90, 16, 2),
])
def test_seeded_ops_match_the_reference(seed, partitions, size, shard,
                                        fetch):
    logs = {pkg: _script(_pkg_mgr(pkg, partitions, size, shard, fetch),
                         seed)
            for pkg in PACKAGES}
    assert logs["dlrover_tpu"] == logs["dlrover_tpu_torch"]
    kinds = {entry[0] for entry in logs["dlrover_tpu_torch"]}
    assert {"get", "done", "fail", "lost", "ckpt"} <= kinds


@pytest.mark.parametrize("src, dst", [PACKAGES, PACKAGES[::-1]])
def test_checkpoint_restores_across_packages(src, dst):
    """A checkpoint of ``src``'s manager (in flight, done and failed
    shards) restores in ``dst``'s manager to the tasks ``src``'s own
    restore gives, and no consumed shard comes back."""
    mgr = _pkg_mgr(src, 2, -1, 10, 4)
    tasks = [mgr.get_task(0) for _ in range(5)]
    mgr.report_task_done(tasks[0].task_id, 0)
    mgr.report_task_done(tasks[1].task_id, 0, success=False)
    state = json.loads(json.dumps(mgr.checkpoint()))
    nexts = {}
    for pkg in (src, dst):
        restored = _pkg_mgr(pkg, 2, -1, 10, 4)
        restored.restore(state, "stream-ds")
        nexts[pkg] = ([_t(restored.get_task(0)) for _ in range(8)],
                      restored.checkpoint(), restored.completed_records())
    assert nexts[src] == nexts[dst]
    consumed = (tasks[0].shard.partition, tasks[0].shard.start)
    assert consumed not in {(t[2], t[3]) for t in nexts[dst][0]}
    assert nexts[dst][2] == 10
