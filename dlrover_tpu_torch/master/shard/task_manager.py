"""Dynamic data sharding: datasets -> shards -> dispatched tasks.

Parity: reference dlrover/python/master/shard/task_manager.py and
batch_dataset_manager.py — TODO/DOING queues, timeout re-queue, shard
checkpoint/restore so a restarted job resumes exactly the unconsumed data.

The port's copy of ``dlrover_tpu/master/shard/task_manager.py``.
"""

import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.fault import fault_point
from dlrover_tpu_torch.master.shard.dataset_splitter import (
    DatasetSplitter,
    Shard,
    StreamingDatasetSplitter,
    create_dataset_splitter,
)


@dataclass
class Task:
    task_id: int
    task_type: str
    shard: Shard
    epoch: int = 0
    # Wall time this task (re-)entered the todo queue; 0 = unknown.
    # Dispatch observes now - enqueue_ts as the §32 queue-age
    # histogram — a growing age at constant depth means dispatch is
    # starved, not the dataset.
    enqueue_ts: float = 0.0

    @classmethod
    def create_invalid_task(cls) -> "Task":
        return cls(-1, TaskType.NONE, Shard("", 0, 0))


def _queue_metrics():
    """§32 dispatch self-instrumentation (fresh registry lookup per
    manager instance, same discipline as rdzv_manager's)."""
    from dlrover_tpu_torch.master.rpc_metrics import RPC_BUCKETS
    from dlrover_tpu_torch.observability.registry import default_registry

    reg = default_registry()
    return {
        "dispatch": reg.histogram(
            "shard_dispatch_seconds",
            "time spent inside one get-task(s) dispatch call",
            buckets=RPC_BUCKETS,
        ),
        "queue_age": reg.histogram(
            "shard_task_queue_age_seconds",
            "todo-queue residence time of a lease at dispatch",
        ),
        "todo": reg.gauge(
            "shard_todo_depth", "queued shard leases across datasets"
        ),
        "doing": reg.gauge(
            "shard_doing_depth", "in-flight shard leases across datasets"
        ),
    }


@dataclass
class _DoingTask:
    task: Task
    node_id: int
    start_time: float


def drain_tasks(get_one, node_id: int, count: int) -> List[Task]:
    """THE batched-dispatch sentinel contract, in one place: call
    ``get_one(node_id)`` up to ``count`` times collecting real leases;
    a WAIT/invalid task (negative id) stops the drain and is returned
    alone only when nothing real was collected."""
    out: List[Task] = []
    for _ in range(max(count, 1)):
        task = get_one(node_id)
        if task.task_id < 0:
            if not out:
                out.append(task)
            break
        out.append(task)
    return out


class BatchDatasetManager:
    """Shard queue of one dataset (reference batch_dataset_manager.py:29)."""

    def __init__(self, task_type: str, splitter: DatasetSplitter):
        self._task_type = task_type
        self._splitter = splitter
        # deque, not list: dispatch pops the head and recovery re-queues
        # at the head — O(1) both ways where list.pop(0)/insert(0, ...)
        # were O(n) per task on large shard counts.
        self.todo: Deque[Task] = deque()
        self.doing: Dict[int, _DoingTask] = {}
        self._task_id_seq = 0
        self._completed_count = 0
        self._lock = threading.Lock()
        self._metrics = _queue_metrics()

    def get_task(self, node_id: int) -> Task:
        with self._lock:
            return self._get_task_locked(node_id)

    def _get_task_locked(self, node_id: int) -> Task:
        if not self.todo and not self._splitter.epoch_finished():
            self._create_todo_tasks()
        if not self.todo:
            if self.doing:
                # Data remains in flight: tell the worker to wait, its
                # peers' shards may be re-queued on timeout/failure.
                return Task(-1, TaskType.WAIT, Shard("", 0, 0))
            return Task.create_invalid_task()
        task = self.todo.popleft()
        now = time.time()
        if task.enqueue_ts > 0:
            self._metrics["queue_age"].observe(
                max(now - task.enqueue_ts, 0.0)
            )
        self.doing[task.task_id] = _DoingTask(task, node_id, now)
        return task

    def get_tasks(self, node_id: int, count: int) -> List[Task]:
        """Up to ``count`` leases in one call (the batched-dispatch verb,
        sentinel contract in :func:`drain_tasks`). One lock hold for the
        whole batch — a prefetching worker costs the dispatch path one
        acquisition per batch, not per shard."""
        with self._lock:
            return drain_tasks(self._get_task_locked, node_id, count)

    def _create_todo_tasks(self):
        shards = self._splitter.create_shards()
        epoch = self._splitter.epoch
        now = time.time()
        for shard in shards:
            self.todo.append(
                Task(
                    self._task_id_seq, self._task_type, shard, epoch,
                    enqueue_ts=now,
                )
            )
            self._task_id_seq += 1

    def report_task_done(
        self, task_id: int, node_id: int, success: bool = True
    ) -> bool:
        with self._lock:
            doing = self.doing.pop(task_id, None)
            if doing is None:
                return False
            if not success:
                # The worker explicitly failed the shard: its records
                # were NOT consumed — re-queue, don't count as done.
                logger.warning(
                    "task %d failed on node %d; re-queueing",
                    task_id,
                    node_id,
                )
                doing.task.enqueue_ts = time.time()
                self.todo.appendleft(doing.task)
                return False
            self._completed_count += 1
            return True

    def recover_timeout_tasks(self, timeout: float):
        with self._lock:
            now = time.time()
            expired = [
                tid
                for tid, d in self.doing.items()
                if now - d.start_time > timeout
            ]
            for tid in expired:
                doing = self.doing.pop(tid)
                logger.warning(
                    "task %d of node %d timed out; re-queueing",
                    tid,
                    doing.node_id,
                )
                doing.task.enqueue_ts = now
                self.todo.appendleft(doing.task)

    def recover_node_tasks(self, node_id: int):
        """Re-queue all in-flight shards of a dead node — including
        leases the worker had prefetched but never consumed."""
        with self._lock:
            lost = [
                tid for tid, d in self.doing.items() if d.node_id == node_id
            ]
            now = time.time()
            for tid in lost:
                task = self.doing.pop(tid).task
                task.enqueue_ts = now
                self.todo.appendleft(task)

    def completed(self) -> bool:
        with self._lock:
            return (
                self._splitter.epoch_finished()
                and not self.todo
                and not self.doing
            )

    # ---- shard checkpoint --------------------------------------------------

    def checkpoint(self) -> dict:
        with self._lock:
            undone = [
                [t.task.shard.start, t.task.shard.end, t.task.shard.record_indices]
                for t in self.doing.values()
            ] + [
                [t.shard.start, t.shard.end, t.shard.record_indices]
                for t in self.todo
            ]
            return {
                "epoch": self._splitter.epoch,
                "undone_shards": undone,
                "completed": self._completed_count,
            }

    def restore(self, state: dict, dataset_name: str):
        with self._lock:
            self.todo.clear()
            self.doing.clear()
            self._splitter.epoch = state.get("epoch", 0)
            self._completed_count = state.get("completed", 0)
            now = time.time()
            for entry in state.get("undone_shards", []):
                start, end = entry[0], entry[1]
                indices = entry[2] if len(entry) > 2 else None
                self.todo.append(
                    Task(
                        self._task_id_seq,
                        self._task_type,
                        Shard(dataset_name, start, end, indices),
                        self._splitter.epoch,
                        enqueue_ts=now,
                    )
                )
                self._task_id_seq += 1

    # ---- master-journal crash recovery (docs/DESIGN.md §37) ---------------

    def rehydrate(
        self,
        dataset_name: str,
        epoch: int,
        completed: int,
        todo_shards,
        doing,
        next_task_id: int,
    ):
        """Install journal-replayed state after a master crash. Unlike
        :meth:`restore` (a user-driven shard-checkpoint restore that
        mints fresh ids), crash rehydration must keep outstanding
        leases in ``doing`` under their ORIGINAL task ids so a worker
        that rode through the outage can still report them done —
        re-queueing them with new ids would double-dispatch their data.

        ``todo_shards``: iterable of ``[start, end, indices, partition]``.
        ``doing``: ``tid -> (node_id, epoch, start, end, indices, part)``.
        """
        with self._lock:
            self.todo.clear()
            self.doing.clear()
            self._splitter.epoch = max(epoch, 0)
            self._completed_count = completed
            self._task_id_seq = max(next_task_id, 0)
            now = time.time()
            for entry in todo_shards:
                start, end = entry[0], entry[1]
                indices = entry[2] if len(entry) > 2 else None
                part = entry[3] if len(entry) > 3 else 0
                self.todo.append(
                    Task(
                        self._task_id_seq,
                        self._task_type,
                        Shard(dataset_name, start, end, indices, part),
                        self._splitter.epoch,
                        enqueue_ts=now,
                    )
                )
                self._task_id_seq += 1
            for tid, lease in doing.items():
                node_id, task_epoch, start, end, indices, part = lease
                task = Task(
                    tid,
                    self._task_type,
                    Shard(dataset_name, start, end, indices, part),
                    task_epoch,
                    enqueue_ts=now,
                )
                # start_time = now: a dead worker's rehydrated lease
                # re-queues via the normal timeout path; a live worker
                # pops it with a done-report long before that.
                self.doing[tid] = _DoingTask(task, node_id, now)
                self._task_id_seq = max(self._task_id_seq, tid + 1)

    def journal_snapshot(self) -> dict:
        """Lease-preserving state for journal compaction. Unlike
        :meth:`checkpoint` this does NOT fold ``doing`` into the undone
        list — outstanding leases keep their ids across the snapshot so
        compaction never breaks the exactly-once law above."""
        with self._lock:
            return {
                "epoch": self._splitter.epoch,
                "completed": self._completed_count,
                "todo": [
                    [t.shard.start, t.shard.end, t.shard.record_indices,
                     t.shard.partition]
                    for t in self.todo
                ],
                "doing": {
                    tid: {
                        "node": d.node_id,
                        "epoch": d.task.epoch,
                        "start": d.task.shard.start,
                        "end": d.task.shard.end,
                        "idx": d.task.shard.record_indices,
                        "part": d.task.shard.partition,
                    }
                    for tid, d in self.doing.items()
                },
                "next_tid": self._task_id_seq,
            }


class TaskManager:
    """Owns all dataset managers; periodic timeout recovery thread.

    Parity: reference master/shard/task_manager.py (TaskManager).
    """

    def __init__(self, task_timeout: float = 1800.0, perf_monitor=None):
        self._lock = threading.Lock()
        # BatchDatasetManager or StreamingDatasetManager (duck-typed).
        self._datasets: Dict[str, object] = {}
        self._task_timeout = task_timeout
        self._perf_monitor = perf_monitor
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        from dlrover_tpu_torch.observability.registry import default_registry

        reg = default_registry()
        self._tasks_dispatched = reg.counter(
            "shard_tasks_dispatched_total",
            "shard leases handed to workers",
        )
        self._dispatch_rpcs = reg.counter(
            "shard_dispatch_rpcs_total",
            "get-task RPCs served (single or batched)",
        )
        self._tasks_recovered = reg.counter(
            "shard_tasks_recovered_total",
            "in-flight leases re-queued after timeout/failure/node loss",
        )
        self._metrics = _queue_metrics()

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._recover_loop, daemon=True, name="task-recover"
            )
            self._thread.start()

    def stop(self):
        self._stopped.set()

    def _recover_loop(self):
        while not self._stopped.wait(30):
            with self._lock:
                managers = list(self._datasets.values())
            for m in managers:
                m.recover_timeout_tasks(self._task_timeout)

    # ---- servicer surface --------------------------------------------------

    def new_dataset(self, params: comm.DatasetShardParams):
        with self._lock:
            if params.dataset_name in self._datasets:
                return
            splitter = create_dataset_splitter(
                params.storage_type,
                params.dataset_name,
                params.dataset_size,
                params.shard_size,
                params.num_epochs,
                params.shuffle,
                num_partitions=params.num_partitions,
            )
            if isinstance(splitter, StreamingDatasetSplitter):
                from dlrover_tpu_torch.master.shard.streaming_dataset_manager import (  # noqa: E501
                    StreamingDatasetManager,
                )

                manager = StreamingDatasetManager(params.task_type, splitter)
            else:
                manager = BatchDatasetManager(params.task_type, splitter)
            self._datasets[params.dataset_name] = manager
            logger.info(
                "dataset %s registered (%s): size=%d shard=%d epochs=%d",
                params.dataset_name,
                params.storage_type,
                params.dataset_size,
                params.shard_size,
                params.num_epochs,
            )

    def get_dataset(self, name: str) -> Optional[BatchDatasetManager]:
        with self._lock:
            return self._datasets.get(name)

    @staticmethod
    def _to_shard_task(task: Task, dataset_name: str) -> comm.ShardTask:
        return comm.ShardTask(
            task_id=task.task_id,
            task_type=task.task_type,
            dataset_name=dataset_name,
            start=task.shard.start,
            end=task.shard.end,
            epoch=task.epoch,
            record_indices=task.shard.record_indices,
            partition=task.shard.partition,
        )

    def get_task(self, node_id: int, dataset_name: str) -> comm.ShardTask:
        mgr = self.get_dataset(dataset_name)
        if mgr is None:
            return comm.ShardTask()
        t0 = time.monotonic()
        task = mgr.get_task(node_id)
        self._metrics["dispatch"].observe(time.monotonic() - t0)
        self._dispatch_rpcs.inc()
        if task.task_id >= 0:
            self._tasks_dispatched.inc()
        self._refresh_depth_gauges()
        return self._to_shard_task(task, dataset_name)

    def get_tasks(
        self, node_id: int, dataset_name: str, count: int
    ) -> List[comm.ShardTask]:
        """Batched dispatch: up to ``count`` real leases, or a single
        WAIT/invalid sentinel when none are available right now."""
        fault_point("shard.dispatch", dataset=dataset_name, count=count)
        mgr = self.get_dataset(dataset_name)
        if mgr is None:
            return [comm.ShardTask()]
        t0 = time.monotonic()
        getter = getattr(mgr, "get_tasks", None)
        if getter is not None:
            tasks = getter(node_id, count)
        else:
            # Duck-typed manager without the batched verb: same sentinel
            # contract, one lock acquisition per task.
            tasks = drain_tasks(mgr.get_task, node_id, count)
        self._metrics["dispatch"].observe(time.monotonic() - t0)
        self._dispatch_rpcs.inc()
        self._tasks_dispatched.inc(
            sum(1 for t in tasks if t.task_id >= 0) or 0
        )
        self._refresh_depth_gauges()
        return [self._to_shard_task(t, dataset_name) for t in tasks]

    def report_task_done(
        self,
        dataset_name: str,
        task_id: int,
        node_id: int,
        success: bool = True,
    ):
        mgr = self.get_dataset(dataset_name)
        if mgr is not None:
            mgr.report_task_done(task_id, node_id, success)

    def report_tasks_done(
        self,
        dataset_name: str,
        node_id: int,
        done_ids: List[int],
        failed_ids: Optional[List[int]] = None,
    ):
        """Apply one coalesced done-report batch."""
        mgr = self.get_dataset(dataset_name)
        if mgr is None:
            return
        for tid in done_ids:
            mgr.report_task_done(tid, node_id, True)
        for tid in failed_ids or []:
            mgr.report_task_done(tid, node_id, False)

    def recover_node_tasks(self, node_id: int):
        with self._lock:
            managers = list(self._datasets.values())
        for m in managers:
            before = len(m.doing)
            m.recover_node_tasks(node_id)
            self._tasks_recovered.inc(max(before - len(m.doing), 0))

    def _refresh_depth_gauges(self):
        """Depth gauges after a dispatch; len() per manager under the
        GIL, no manager locks taken — gauges tolerate a ±1 race."""
        with self._lock:
            managers = list(self._datasets.values())
        self._metrics["todo"].set(sum(len(m.todo) for m in managers))
        self._metrics["doing"].set(sum(len(m.doing) for m in managers))

    def queue_stats(self) -> Dict[str, object]:
        """§32 buffer accounting for /api/control_plane: occupancy +
        drops for the lease queues (leases are never dropped — they are
        re-queued, and the recovery counter is the honest analogue)."""
        with self._lock:
            datasets = dict(self._datasets)
        per = {
            name: {"todo": len(m.todo), "doing": len(m.doing)}
            for name, m in datasets.items()
        }
        todo = sum(d["todo"] for d in per.values())
        doing = sum(d["doing"] for d in per.values())
        dispatch = self._metrics["dispatch"]
        return {
            "occupancy": todo + doing,
            "drops": 0,
            "todo": todo,
            "doing": doing,
            "recovered_total": self._tasks_recovered.value(),
            "dispatch_p99_s": dispatch.quantile(0.99),
            "datasets": per,
        }

    def finished(self) -> bool:
        with self._lock:
            if not self._datasets:
                return False
            return all(m.completed() for m in self._datasets.values())

    def journal_snapshots(self) -> Dict[str, dict]:
        """Per-dataset lease-preserving snapshots for journal compaction
        (managers without the surface are skipped)."""
        with self._lock:
            datasets = dict(self._datasets)
        out: Dict[str, dict] = {}
        for name, mgr in datasets.items():
            snap = getattr(mgr, "journal_snapshot", None)
            if snap is not None:
                out[name] = snap()
        return out

    def get_shard_checkpoint(self, dataset_name: str) -> str:
        mgr = self.get_dataset(dataset_name)
        if mgr is None:
            return ""
        return json.dumps(mgr.checkpoint())

    def restore_shard_checkpoint(self, dataset_name: str, checkpoint: str):
        mgr = self.get_dataset(dataset_name)
        if mgr is not None and checkpoint:
            mgr.restore(json.loads(checkpoint), dataset_name)
