"""Minimal elastic PyTorch training worker used by the port's agent
tests: the twin of ``simple_train.py`` on the port's ``Checkpointer``,
with the same argv and progress-file format.

Counts steps in a tensor, flash-checkpoints every step to memory, and
resumes from the checkpoint after being killed/restarted by the agent.
"""

import os
import sys
import time

import torch

from dlrover_tpu_torch.flash_ckpt.checkpointer import Checkpointer
from dlrover_tpu_torch.trainer.runtime import init_distributed


def main():
    total_steps = int(sys.argv[1])
    out_path = sys.argv[2]
    ckpt_dir = sys.argv[3]
    crash_at = int(sys.argv[4]) if len(sys.argv) > 4 else -1

    ctx = init_distributed(device="cpu")
    ckpt = Checkpointer(ckpt_dir)
    start = 0
    restored = ckpt.load_checkpoint()
    if restored is not None:
        start = restored[0]
        w = restored[1]["w"]
    else:
        w = torch.zeros(8)

    for step in range(start + 1, total_steps + 1):
        w = w + 1  # "training"
        time.sleep(0.05)
        ckpt.save_checkpoint(step, {"w": w})
        with open(out_path, "a") as f:
            f.write(
                f"{ctx.process_id} {step} restart={ctx.restart_count} "
                f"w0={float(w[0])}\n"
            )
        if crash_at > 0 and step == crash_at and ctx.restart_count == 0:
            os._exit(17)  # simulated fatal worker error
    ckpt.close()
    sys.exit(0)


if __name__ == "__main__":
    main()
