"""HuggingFace ``Trainer`` front-end for flash checkpointing (the port
of ``dlrover_tpu/trainer/hf_flash.py``).

HF ``Trainer`` users get second-scale in-memory checkpoints and elastic
resume without changing their training loop:

    from dlrover_tpu_torch.trainer.hf_flash import FlashCkptCallback

    trainer = Trainer(..., callbacks=[FlashCkptCallback("/tmp/ckpt")])
    trainer.train()

On every HF save event the callback snapshots the model, optimizer and
scheduler state to the flash engine (the shm fast path; the agent
persists to disk per its policy), and at train start it restores the
newest snapshot, so a relaunched worker resumes from the last flash
save, not the last (much older) disk save. The port's engine takes
torch trees, so tensors cross as they are: a snapshot copies each one
to the host in its own dtype (bf16 bit for bit), and a restore puts each
back on its own device (the model's parameters and buffers where the
model holds them, the optimizer's state beside its parameters, as
``load_state_dict`` places it).
"""

from typing import Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.flash_ckpt.checkpointer import (
    Checkpointer,
    StorageType,
)


def snapshot_training_state(model, optimizer=None, scheduler=None) -> dict:
    state = {"model": model.state_dict()}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    if scheduler is not None:
        state["scheduler"] = scheduler.state_dict()
    return state


def restore_training_state(state: dict, model, optimizer=None,
                           scheduler=None):
    model.load_state_dict(state["model"])
    if optimizer is not None and "optimizer" in state:
        optimizer.load_state_dict(state["optimizer"])
    if scheduler is not None and "scheduler" in state:
        scheduler.load_state_dict(state["scheduler"])


try:
    from transformers import TrainerCallback as _CallbackBase
except ImportError:  # transformers is optional for the rest of the repo

    class _CallbackBase:  # type: ignore[no-redef]
        pass


class FlashCkptCallback(_CallbackBase):
    """HF TrainerCallback: flash-save on HF's save cadence, restore at
    train begin. ``storage_interval`` additionally persists every Nth
    flash save to disk through the engine (0 = memory only; the agent's
    async saver still persists on failure)."""

    def __init__(self, checkpoint_dir: str, storage_interval: int = 0,
                 checkpointer: Optional[Checkpointer] = None):
        self._ckpt = checkpointer or Checkpointer(checkpoint_dir)
        self._storage_interval = storage_interval
        self._saves = 0

    # ---- HF hooks ----------------------------------------------------------

    def on_train_begin(self, args, state, control, **kw):
        model = kw.get("model")
        optimizer = kw.get("optimizer")
        scheduler = kw.get("lr_scheduler")
        restored = self._ckpt.load_checkpoint()
        if restored is None or model is None:
            return
        step, tree, _ = restored
        restore_training_state(tree, model, optimizer, scheduler)
        state.global_step = step
        logger.info("flash-restored HF trainer at step %d", step)

    def on_save(self, args, state, control, **kw):
        model = kw.get("model")
        if model is None:
            return
        self._saves += 1
        snap = snapshot_training_state(model, kw.get("optimizer"),
                                       kw.get("lr_scheduler"))
        storage = (
            StorageType.DISK
            if self._storage_interval
            and self._saves % self._storage_interval == 0
            else StorageType.MEMORY
        )
        block = self._ckpt.save_checkpoint(state.global_step, snap, storage)
        logger.info("flash save at step %d (%s, blocked %.3fs)",
                    state.global_step, storage, block)

    def on_train_end(self, args, state, control, **kw):
        self._ckpt.wait_saving_complete()

    def close(self):
        self._ckpt.close()
