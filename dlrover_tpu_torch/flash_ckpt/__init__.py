"""Flash checkpoint of the port: a tree of tensors to host shared memory
without blocking the step, persisted to storage by the agent's saver,
restored memory first and storage second (``dlrover_tpu/flash_ckpt/``
for PyTorch; the same shm layout, raw and legacy ``.npz`` shard files,
and replica service between nodes' agents)."""

from dlrover_tpu_torch.flash_ckpt.checkpointer import (  # noqa: F401
    Checkpointer,
    StorageType,
)
