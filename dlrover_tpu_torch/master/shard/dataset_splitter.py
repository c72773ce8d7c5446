"""Split datasets into shards for dynamic dispatch.

Parity: reference dlrover/python/master/shard/dataset_splitter.py
(DatasetSplitter:92, TableDatasetSplitter:146, TextDatasetSplitter:259).
A shard is a [start, end) record range; workers fetch shards as tasks so a
slow/dead worker's pending shards get re-dispatched (data elasticity).

The port's copy of ``dlrover_tpu/master/shard/dataset_splitter.py``.
"""

import random
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class Shard:
    name: str
    start: int
    end: int
    record_indices: Optional[List[int]] = None
    # Source partition for streaming datasets ([start, end) offsets are
    # per-partition in a message queue / log store).
    partition: int = 0


class DatasetSplitter(ABC):
    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
    ):
        self.dataset_name = dataset_name
        self.dataset_size = dataset_size
        self.shard_size = max(shard_size, 1)
        self._num_epochs = max(num_epochs, 1)
        self.epoch = 0

    @abstractmethod
    def create_shards(self) -> List[Shard]:
        ...

    def epoch_finished(self) -> bool:
        return self.epoch >= self._num_epochs


class TableDatasetSplitter(DatasetSplitter):
    """Contiguous range shards over an indexed (table-like) dataset."""

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        max_shard_count: int = 50000,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._shuffle = shuffle
        self._max_shard_count = max_shard_count

    def create_shards(self) -> List[Shard]:
        self.epoch += 1
        shards = [
            Shard(
                name=self.dataset_name,
                start=start,
                end=min(start + self.shard_size, self.dataset_size),
            )
            for start in range(0, self.dataset_size, self.shard_size)
        ][: self._max_shard_count]
        if self._shuffle:
            random.shuffle(shards)
        return shards


class TextDatasetSplitter(DatasetSplitter):
    """Shards carrying explicit (possibly shuffled) record indices, for
    line-oriented datasets where a worker reads specific rows."""

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._shuffle = shuffle

    def create_shards(self) -> List[Shard]:
        self.epoch += 1
        indices = list(range(self.dataset_size))
        if self._shuffle:
            random.shuffle(indices)
        shards = []
        for start in range(0, self.dataset_size, self.shard_size):
            end = min(start + self.shard_size, self.dataset_size)
            shards.append(
                Shard(
                    name=self.dataset_name,
                    start=start,
                    end=end,
                    record_indices=indices[start:end],
                )
            )
        return shards


class StreamingDatasetSplitter(DatasetSplitter):
    """Carve shards incrementally from an unbounded, partitioned source
    (message queue / log store read by record offset).

    Parity: reference master/shard/dataset_splitter.py:361
    (StreamingDatasetSplitter) — ``dataset_size=-1`` means infinite;
    each ``create_shards`` call carves at most ``fetch_shards`` new
    shards, round-robin over partitions, advancing per-partition
    offsets. The offsets (not epochs) are the progress state, so the
    shard checkpoint captures them exactly.
    """

    def __init__(
        self,
        dataset_name: str,
        shard_size: int,
        num_partitions: int = 1,
        dataset_size: int = -1,
        partition_offsets: Optional[dict] = None,
        fetch_shards: int = 16,
    ):
        super().__init__(
            dataset_name, dataset_size, shard_size, num_epochs=1
        )
        self.partition_offsets = dict(
            partition_offsets
            if partition_offsets is not None
            else {p: 0 for p in range(max(num_partitions, 1))}
        )
        self._fetch_shards = fetch_shards
        # Remaining records (-1 = unbounded); counts down for bounded
        # streams so the tail shard is exact.
        self.remaining = dataset_size if dataset_size >= 0 else -1
        self._next_partition = 0

    def create_shards(self) -> List[Shard]:
        shards: List[Shard] = []
        parts = sorted(self.partition_offsets)
        for _ in range(self._fetch_shards):
            if self.remaining == 0:
                break
            p = parts[self._next_partition % len(parts)]
            self._next_partition += 1
            start = self.partition_offsets[p]
            take = self.shard_size
            if self.remaining > 0:
                take = min(take, self.remaining)
                self.remaining -= take
            self.partition_offsets[p] = start + take
            shards.append(
                Shard(
                    name=self.dataset_name,
                    start=start,
                    end=start + take,
                    partition=p,
                )
            )
        return shards

    def epoch_finished(self) -> bool:
        # An unbounded stream never finishes; a bounded one finishes when
        # every record has been carved into a shard.
        return self.remaining == 0

    def to_checkpoint(self) -> dict:
        return {
            "partition_offsets": {
                str(p): o for p, o in self.partition_offsets.items()
            },
            "remaining": self.remaining,
            "shard_size": self.shard_size,
        }

    def restore_checkpoint(self, state: dict):
        self.partition_offsets = {
            int(p): o for p, o in state["partition_offsets"].items()
        }
        self.remaining = state["remaining"]
        self.shard_size = state.get("shard_size", self.shard_size)


def create_dataset_splitter(
    storage_type: str,
    dataset_name: str,
    dataset_size: int,
    shard_size: int,
    num_epochs: int = 1,
    shuffle: bool = False,
    num_partitions: int = 1,
) -> DatasetSplitter:
    if storage_type in ("stream", "streaming", "kafka", "sls"):
        return StreamingDatasetSplitter(
            dataset_name,
            shard_size,
            num_partitions=num_partitions,
            dataset_size=dataset_size,
        )
    if storage_type == "text":
        return TextDatasetSplitter(
            dataset_name, dataset_size, shard_size, num_epochs, shuffle
        )
    return TableDatasetSplitter(
        dataset_name, dataset_size, shard_size, num_epochs, shuffle
    )
