"""Worker of the port's agent test of the post-mortem path: its
behaviour follows its restart count.

    python tests/workers/torch_hang_worker.py <out>

- restart 0: three steps through ``ElasticTrainer`` (each beats the hang
  watchdog and records a flight-recorder step), then it hangs in short
  sleeps until it is killed;
- restart 1: dies at once by ``os._exit(3)`` (no dump is written);
- later: exits 0.

Each incarnation appends ``<pid> <restart count>`` to ``<out>`` once it
is up.
"""

import os
import sys
import time

from dlrover_tpu_torch.trainer.elastic.trainer import (
    ElasticBatchConfig,
    ElasticTrainer,
)
from dlrover_tpu_torch.trainer.runtime import init_distributed


def main():
    ctx = init_distributed(device="cpu")
    with open(sys.argv[1], "a") as f:
        f.write(f"{os.getpid()} {ctx.restart_count}\n")
    if ctx.restart_count == 1:
        os._exit(3)
    if ctx.restart_count == 0:
        trainer = ElasticTrainer(ElasticBatchConfig(2, 1), dp_size=1)
        trainer.start_training()
        for _ in range(3):
            time.sleep(0.05)
            trainer.step_completed()
        # Hung, in short sleeps: the agent's native stack sampler may
        # hold this main thread when the test's SIGTERM comes, and the
        # kernel then hands the signal to another thread, which wakes no
        # sleep of this one; CPython runs the handler here only once the
        # sleep ends.
        for _ in range(12000):
            time.sleep(0.05)
    return 0


if __name__ == "__main__":
    sys.exit(main())
