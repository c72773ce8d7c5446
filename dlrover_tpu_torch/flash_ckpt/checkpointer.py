"""User-facing flash checkpoint API (the port of
``dlrover_tpu/flash_ckpt/checkpointer.py``).

Usage:
    ckpt = Checkpointer("/tmp/ckpt")
    ckpt.save_checkpoint(step, tree)                       # memory only
    ckpt.save_checkpoint(step, tree, StorageType.DISK)     # + persist
    step, tree, meta = ckpt.load_checkpoint(target=tree)   # in place
"""

import os
import time
from typing import Any, Optional

from dlrover_tpu_torch.flash_ckpt import storage as ckpt_storage
from dlrover_tpu_torch.flash_ckpt.engine import (
    CKPT_EVENT_QUEUE,
    CheckpointEngine,
)
from dlrover_tpu_torch.flash_ckpt.shared_obj import socket_path


class StorageType:
    MEMORY = "memory"
    DISK = "disk"


def agent_present() -> bool:
    """True when an agent's saver serves this job's socket dir."""
    return os.path.exists(socket_path(f"queue-{CKPT_EVENT_QUEUE}"))


class Checkpointer:
    def __init__(self, checkpoint_dir: str,
                 standalone: Optional[bool] = None):
        if standalone is None:
            standalone = not agent_present()
        self._engine = CheckpointEngine(checkpoint_dir, standalone=standalone)

    def save_checkpoint(self, step: int, state: Any,
                        storage_type: str = StorageType.MEMORY,
                        user_meta: Optional[dict] = None) -> float:
        """Returns the training-blocking seconds of the save."""
        if storage_type == StorageType.DISK:
            return self._engine.save_to_storage(step, state, user_meta)
        return self._engine.save_to_memory(step, state, user_meta)

    def save_checkpoint_async(self, step: int, state: Any,
                              user_meta: Optional[dict] = None,
                              fences: Optional[list] = None) -> float:
        """Launch the device-to-host copy and return (see
        ``CheckpointEngine.save_to_memory_async`` for ``fences``)."""
        return self._engine.save_to_memory_async(step, state, user_meta,
                                                 fences)

    def wait_async_save(self, timeout: float = 600.0) -> bool:
        return self._engine.wait_async_save(timeout)

    def load_checkpoint(self, step: Optional[int] = None, target=None):
        """(step, state, user_meta) or None; with ``target`` its tensors
        are filled in place."""
        return self._engine.load(step, target=target)

    def latest_step(self) -> int:
        return self._engine.latest_step()

    def wait_saving_complete(self, timeout: float = 600.0) -> bool:
        """Block until the engine's last requested DISK save is
        committed. Memory-only saves are not waited on."""
        deadline = time.time() + timeout
        target = self._engine._last_disk_step  # noqa: SLF001
        if target < 0:
            return True
        while time.time() < deadline:
            if ckpt_storage.read_tracker(
                    self._engine.checkpoint_dir) >= target:
                return True
            time.sleep(0.2)
        return False

    def close(self):
        self._engine.close()
