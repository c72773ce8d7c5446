"""The port's data-sharding master against the JAX package's.

The master side of the reference's ``tests/test_data_pipeline.py``
(batched dispatch and its sentinels, recovery requeues at the head,
batched done-reports), plus multi-epoch and shuffled table and text
datasets, timeouts, node recovery and shard checkpoints, run on both
packages' ``master/shard/{dataset_splitter,task_manager}.py`` in this
process. The two transcripts must be equal (the shuffles draw from
``random`` reseeded before each package), and the reference test's
assertions hold on the port's.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import importlib
import json
import random
from collections import deque

import pytest

from tests.torch_event_guard import events_off

PACKAGES = ("dlrover_tpu", "dlrover_tpu_torch")


@pytest.fixture(autouse=True)
def _no_event_files(monkeypatch):
    events_off(monkeypatch)


def _pkg(pkg):
    return (importlib.import_module(f"{pkg}.master.shard.task_manager"),
            importlib.import_module(f"{pkg}.master.shard.dataset_splitter"),
            importlib.import_module(f"{pkg}.common.comm"),
            importlib.import_module(f"{pkg}.common.constants"))


def _task(t):
    if hasattr(t, "shard"):
        return [t.task_id, t.task_type, t.shard.start, t.shard.end,
                t.shard.record_indices, t.epoch if hasattr(t, "epoch")
                else None]
    return [t.task_id, t.task_type, t.dataset_name, t.start, t.end,
            t.epoch, t.record_indices, t.partition]


def batched_dispatch_and_sentinels(tm, ds, comm, c, log):
    mgr = tm.BatchDatasetManager("training", ds.TableDatasetSplitter(
        "ds", 100, 10))
    tasks = mgr.get_tasks(node_id=0, count=4)
    log("first", [_task(t) for t in tasks])
    rest = mgr.get_tasks(node_id=0, count=100)
    log("rest", [_task(t) for t in rest])
    log("waiting", [_task(t) for t in mgr.get_tasks(node_id=1, count=8)])
    log("done", [mgr.report_task_done(t.task_id, 0) for t in tasks + rest])
    log("after", [_task(t) for t in mgr.get_tasks(node_id=1, count=8)])
    log("completed", mgr.completed())


def recovery_requeues_at_head(tm, ds, comm, c, log):
    mgr = tm.BatchDatasetManager("training", ds.TableDatasetSplitter(
        "ds", 40, 10))
    log("deque", isinstance(mgr.todo, deque))
    log("first", _task(mgr.get_task(node_id=7)))
    log("second", _task(mgr.get_task(node_id=8)))
    mgr.recover_node_tasks(7)
    log("redispatched", _task(mgr.get_task(node_id=8)))


def batched_report(tm, ds, comm, c, log):
    t = tm.TaskManager()
    t.new_dataset(comm.DatasetShardParams(
        dataset_name="batch-ds", dataset_size=30, shard_size=10))
    tasks = t.get_tasks(0, "batch-ds", 3)
    log("tasks", [_task(x) for x in tasks])
    t.report_tasks_done("batch-ds", 0, [tasks[0].task_id,
                                        tasks[1].task_id],
                        [tasks[2].task_id])
    mgr = t.get_dataset("batch-ds")
    log("todo", [_task(x) for x in mgr.todo])
    log("doing", len(mgr.doing))
    log("finished", t.finished())


def epochs_and_shuffles(tm, ds, comm, c, log):
    t = tm.TaskManager()
    for name, storage in (("table", "table"), ("text", "text")):
        t.new_dataset(comm.DatasetShardParams(
            dataset_name=name, dataset_size=11, shard_size=3,
            num_epochs=2, shuffle=True, storage_type=storage))
        seen = []
        for _ in range(50):
            task = t.get_task(1, name)
            if task.task_id < 0:
                seen.append(_task(task))
                break
            seen.append(_task(task))
            t.report_task_done(name, task.task_id, 1)
        log(name, seen)
    log("finished", t.finished())


def failed_done_report_requeues(tm, ds, comm, c, log):
    t = tm.TaskManager()
    t.new_dataset(comm.DatasetShardParams(
        dataset_name="d", dataset_size=6, shard_size=3))
    a = t.get_task(0, "d")
    t.report_task_done("d", a.task_id, 0, success=False)
    log("again", _task(t.get_task(0, "d")))
    log("next", _task(t.get_task(1, "d")))
    t.recover_node_tasks(1)
    log("recovered", _task(t.get_task(2, "d")))
    stats = t.queue_stats()
    log("stats", {k: stats[k] for k in ("occupancy", "todo", "doing",
                                        "datasets")})


def timeout_recovery(tm, ds, comm, c, log):
    mgr = tm.BatchDatasetManager("training", ds.TableDatasetSplitter(
        "ds", 20, 10))
    first = mgr.get_task(node_id=0)
    mgr.recover_timeout_tasks(-1.0)
    log("after_timeout", _task(mgr.get_task(node_id=1)))
    log("first", _task(first))


def shard_checkpoint(tm, ds, comm, c, log):
    t = tm.TaskManager()
    t.new_dataset(comm.DatasetShardParams(
        dataset_name="ds2", dataset_size=8, shard_size=4, num_epochs=1))
    log("in_flight", _task(t.get_task(0, "ds2")))
    ckpt = t.get_shard_checkpoint("ds2")
    log("checkpoint", json.loads(ckpt))
    t.restore_shard_checkpoint("ds2", ckpt)
    starts = []
    for _ in range(10):
        task = t.get_task(0, "ds2")
        if task.task_id < 0:
            break
        starts.append(task.start)
        t.report_task_done("ds2", task.task_id, 0)
    log("starts", sorted(starts))


def splitters(tm, ds, comm, c, log):
    for kind in ("table", "text"):
        sp = ds.create_dataset_splitter(kind, "x", 10, 4, 1, False)
        log(kind, [[s.start, s.end, s.record_indices]
                   for s in sp.create_shards()])
        log(kind + "_finished", sp.epoch_finished())


SCENARIOS = [batched_dispatch_and_sentinels, recovery_requeues_at_head,
             batched_report, epochs_and_shuffles,
             failed_done_report_requeues, timeout_recovery,
             shard_checkpoint, splitters]


def _transcript(pkg, scenario):
    out = []
    random.seed(1234)
    tm, ds, comm, consts = _pkg(pkg)
    scenario(tm, ds, comm, consts, lambda step, value: out.append(
        (step, value)))
    return out


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_port_task_manager_answers_as_the_reference(scenario):
    ref, port = (_transcript(pkg, scenario) for pkg in PACKAGES)
    assert ref and port == ref


def test_reference_assertions_hold_on_the_port():
    _, _, _, consts = _pkg("dlrover_tpu_torch")
    wait = consts.TaskType.WAIT
    steps = dict(_transcript("dlrover_tpu_torch",
                             batched_dispatch_and_sentinels))
    assert [t[0] for t in steps["first"]] == [0, 1, 2, 3]
    assert len(steps["rest"]) == 6
    assert len(steps["waiting"]) == 1 and steps["waiting"][0][1] == wait
    assert all(steps["done"]) and steps["completed"]
    assert steps["after"][0][0] < 0 and steps["after"][0][1] != wait
    steps = dict(_transcript("dlrover_tpu_torch", recovery_requeues_at_head))
    assert steps["deque"]
    assert steps["redispatched"][2] == steps["first"][2]
    assert steps["redispatched"][0] != steps["second"][0]
    steps = dict(_transcript("dlrover_tpu_torch", batched_report))
    assert len(steps["todo"]) == 1 and steps["doing"] == 0
    assert steps["todo"][0][2] == steps["tasks"][2][3]
    steps = dict(_transcript("dlrover_tpu_torch", shard_checkpoint))
    assert steps["starts"] == [0, 4]


def test_streaming_dataset_is_routed():
    """A ``stream`` dataset goes to the streaming manager in both
    packages, and the two hand out the same tasks and shard checkpoint."""
    out = {}
    for pkg in PACKAGES:
        tm, _, comm, _ = _pkg(pkg)
        sdm = importlib.import_module(
            f"{pkg}.master.shard.streaming_dataset_manager")
        manager = tm.TaskManager()
        manager.new_dataset(comm.DatasetShardParams(
            dataset_name="s", dataset_size=-1, shard_size=4,
            storage_type="stream", num_partitions=2))
        assert isinstance(manager.get_dataset("s"),
                          sdm.StreamingDatasetManager)
        tasks = [manager.get_task(0, "s") for _ in range(5)]
        manager.report_task_done("s", tasks[0].task_id, 0, success=True)
        manager.report_task_done("s", tasks[1].task_id, 0, success=False)
        out[pkg] = ([_task(t) for t in tasks]
                    + [_task(manager.get_task(1, "s"))],
                    json.loads(manager.get_shard_checkpoint("s")))
        manager.stop()
    assert out["dlrover_tpu"] == out["dlrover_tpu_torch"]
    tasks, ckpt = out["dlrover_tpu_torch"]
    assert all(t[0] >= 0 and t[4] - t[3] == 4 for t in tasks)
    # The failed shard is handed out again first.
    assert tasks[-1][3:5] == tasks[1][3:5]
    assert ckpt["streaming"] and ckpt["completed"] == 1
