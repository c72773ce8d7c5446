"""Streaming dataset manager: dynamic sharding over an unbounded source.

Parity: reference dlrover/python/master/shard/streaming_dataset_manager.py
(StreamingDatasetManager) — tasks are carved on demand from per-partition
offsets, a failed shard is retried up to its budget then dropped (a
poisoned record range must not wedge an infinite stream), completed-step
accounting tracks consumption, and the shard checkpoint captures
partition offsets + undone shards so a restarted job resumes the exact
unconsumed stream positions.

Duck-type compatible with BatchDatasetManager (task_manager.py routes to
either based on the dataset's storage_type).

The port's copy of
``dlrover_tpu/master/shard/streaming_dataset_manager.py``: its shard
checkpoint is the reference's JSON, so either package restores the
other's.
"""

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List

from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.shard.dataset_splitter import (
    Shard,
    StreamingDatasetSplitter,
)
from dlrover_tpu_torch.master.shard.task_manager import (
    Task,
    _DoingTask,
    drain_tasks,
)

_MAX_TASK_RETRIES = 3


@dataclass
class _RetryState:
    count: int = 0


class StreamingDatasetManager:
    def __init__(self, task_type: str, splitter: StreamingDatasetSplitter):
        self._task_type = task_type
        self._splitter = splitter
        self.todo: Deque[Task] = deque()
        self.doing: Dict[int, _DoingTask] = {}
        self._task_id_seq = 0
        self._completed_count = 0
        self._completed_records = 0
        self._retries: Dict[str, _RetryState] = {}
        self._lock = threading.Lock()

    # ---- dispatch ----------------------------------------------------------

    def get_task(self, node_id: int) -> Task:
        with self._lock:
            return self._get_task_locked(node_id)

    def _get_task_locked(self, node_id: int) -> Task:
        if not self.todo and not self._splitter.epoch_finished():
            # Carve the next window of shards from the stream.
            for shard in self._splitter.create_shards():
                self.todo.append(
                    Task(self._task_id_seq, self._task_type, shard)
                )
                self._task_id_seq += 1
        if not self.todo:
            if self.doing:
                return Task(-1, TaskType.WAIT, Shard("", 0, 0))
            return Task.create_invalid_task()
        task = self.todo.popleft()
        self.doing[task.task_id] = _DoingTask(task, node_id, time.time())
        return task

    def get_tasks(self, node_id: int, count: int) -> List[Task]:
        """Batched dispatch (sentinel contract in ``drain_tasks``)."""
        with self._lock:
            return drain_tasks(self._get_task_locked, node_id, count)

    # ---- completion & recovery --------------------------------------------

    def report_task_done(
        self, task_id: int, node_id: int, success: bool = True
    ) -> bool:
        with self._lock:
            doing = self.doing.pop(task_id, None)
            if doing is None:
                return False
            if success:
                self._completed_count += 1
                shard = doing.task.shard
                self._completed_records += shard.end - shard.start
                self._retries.pop(self._shard_key(shard), None)
                return True
            self._recover_locked(doing.task, "reported failed")
            return False

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
                self._recover_locked(doing.task, "timed out")

    def recover_node_tasks(self, node_id: int):
        with self._lock:
            lost = [
                tid for tid, d in self.doing.items() if d.node_id == node_id
            ]
            for tid in lost:
                self._recover_locked(self.doing.pop(tid).task, "node lost")

    def _shard_key(self, shard: Shard) -> str:
        return f"{shard.partition}:{shard.start}:{shard.end}"

    def _recover_locked(self, task: Task, why: str):
        state = self._retries.setdefault(
            self._shard_key(task.shard), _RetryState()
        )
        state.count += 1
        if state.count > _MAX_TASK_RETRIES:
            # A poisoned range must not wedge the stream forever.
            logger.error(
                "streaming shard %s %s %d times; dropping it",
                self._shard_key(task.shard),
                why,
                state.count,
            )
            return
        logger.warning(
            "streaming shard %s %s; re-queueing (retry %d/%d)",
            self._shard_key(task.shard),
            why,
            state.count,
            _MAX_TASK_RETRIES,
        )
        self.todo.appendleft(task)

    # ---- progress ----------------------------------------------------------

    def completed(self) -> bool:
        with self._lock:
            return (
                self._splitter.epoch_finished()
                and not self.todo
                and not self.doing
            )

    def completed_records(self) -> int:
        with self._lock:
            return self._completed_records

    # ---- shard checkpoint --------------------------------------------------

    def checkpoint(self) -> dict:
        with self._lock:
            undone = [
                [t.task.shard.partition, t.task.shard.start, t.task.shard.end]
                for t in self.doing.values()
            ] + [
                [t.shard.partition, t.shard.start, t.shard.end]
                for t in self.todo
            ]
            return {
                "streaming": True,
                "splitter": self._splitter.to_checkpoint(),
                "undone_shards": undone,
                "completed": self._completed_count,
                "completed_records": self._completed_records,
            }

    def restore(self, state: dict, dataset_name: str):
        with self._lock:
            self.todo.clear()
            self.doing.clear()
            self._splitter.restore_checkpoint(state["splitter"])
            self._completed_count = state.get("completed", 0)
            self._completed_records = state.get("completed_records", 0)
            for part, start, end in state.get("undone_shards", []):
                self.todo.append(
                    Task(
                        self._task_id_seq,
                        self._task_type,
                        Shard(dataset_name, start, end, partition=part),
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
        splitter_ckpt: dict = None,
    ):
        """Install journal-replayed state after a master crash: splitter
        offsets advance past every journaled carve, outstanding leases
        keep their ORIGINAL task ids (same exactly-once law as
        ``BatchDatasetManager.rehydrate``). ``epoch`` is ignored —
        per-partition offsets, not epochs, are streaming progress."""
        with self._lock:
            self.todo.clear()
            self.doing.clear()
            if splitter_ckpt:
                self._splitter.restore_checkpoint(splitter_ckpt)
            self._completed_count = completed
            self._task_id_seq = max(next_task_id, 0)
            for entry in todo_shards:
                start, end = entry[0], entry[1]
                part = entry[3] if len(entry) > 3 else 0
                self.todo.append(
                    Task(
                        self._task_id_seq,
                        self._task_type,
                        Shard(dataset_name, start, end, partition=part),
                    )
                )
                self._task_id_seq += 1
            now = time.time()
            for tid, lease in doing.items():
                node_id, task_epoch, start, end, _indices, part = lease
                task = Task(
                    tid,
                    self._task_type,
                    Shard(dataset_name, start, end, partition=part),
                    task_epoch,
                )
                self.doing[tid] = _DoingTask(task, node_id, now)
                self._task_id_seq = max(self._task_id_seq, tid + 1)

    def journal_snapshot(self) -> dict:
        """Lease-preserving state for journal compaction (ids survive,
        unlike :meth:`checkpoint` which folds doing into undone)."""
        with self._lock:
            return {
                "epoch": 0,
                "completed": self._completed_count,
                "splitter": self._splitter.to_checkpoint(),
                "todo": [
                    [t.shard.start, t.shard.end, None, t.shard.partition]
                    for t in self.todo
                ],
                "doing": {
                    tid: {
                        "node": d.node_id,
                        "epoch": d.task.epoch,
                        "start": d.task.shard.start,
                        "end": d.task.shard.end,
                        "idx": None,
                        "part": d.task.shard.partition,
                    }
                    for tid, d in self.doing.items()
                },
                "next_tid": self._task_id_seq,
            }
