"""Elastic distributed sampler (a copy of
``dlrover_tpu/trainer/elastic/sampler.py``: for the same seed it deals
the same indices, and its ``state_dict`` is the same) — a
deterministic per-epoch shuffle,
sharded round-robin over ranks, with ``state_dict``/``load_state_dict``
so a restarted (possibly re-scaled) job resumes mid-epoch without
revisiting consumed records: completed count is recorded globally and the
remaining indices are re-dealt over the *new* world size.
"""

from typing import Dict, Iterator

import numpy as np


class ElasticDistributedSampler:
    def __init__(
        self,
        dataset_size: int,
        rank: int = 0,
        world_size: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if world_size <= 0 or not (0 <= rank < world_size):
            raise ValueError(f"bad rank/world {rank}/{world_size}")
        self.dataset_size = dataset_size
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        # Records consumed across ALL ranks this epoch (global position).
        self._completed = 0

    # ---- iteration ----------------------------------------------------------

    def _epoch_indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            return rng.permutation(self.dataset_size)
        return np.arange(self.dataset_size)

    def __iter__(self) -> Iterator[int]:
        indices = self._epoch_indices()[self._completed :]
        if self.drop_last:
            usable = len(indices) - len(indices) % self.world_size
            indices = indices[:usable]
        # Deal the remaining records round-robin over the current world:
        # after a re-scale every rank resumes from the same global cursor.
        for i in range(self.rank, len(indices), self.world_size):
            yield int(indices[i])

    def __len__(self) -> int:
        remaining = self.dataset_size - self._completed
        if self.drop_last:
            return remaining // self.world_size
        return (remaining + self.world_size - 1 - self.rank) // self.world_size

    # ---- bookkeeping ---------------------------------------------------------

    def record_batch(self, global_batch_size: int):
        """Advance the global cursor by one consumed global batch."""
        self._completed = min(
            self.dataset_size, self._completed + global_batch_size
        )

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self._completed = 0

    # ---- checkpoint ----------------------------------------------------------

    def state_dict(self) -> Dict[str, int]:
        return {
            "epoch": self.epoch,
            "completed": self._completed,
            "dataset_size": self.dataset_size,
        }

    def load_state_dict(self, state: Dict[str, int]):
        saved_size = int(state.get("dataset_size", self.dataset_size))
        if saved_size != self.dataset_size:
            raise ValueError(
                f"checkpoint was taken over a dataset of {saved_size} "
                f"records, this sampler covers {self.dataset_size}; "
                "refusing a silently misaligned cursor"
            )
        self.epoch = int(state.get("epoch", 0))
        self._completed = int(state.get("completed", 0))

    def rescale(self, rank: int, world_size: int):
        """Adopt a new world (after elastic re-mesh), keeping the cursor."""
        if world_size <= 0 or not (0 <= rank < world_size):
            raise ValueError(f"bad rank/world {rank}/{world_size}")
        self.rank = rank
        self.world_size = world_size
