"""Warm-standby worker process.

Restart latency on a failure is dominated by interpreter + framework
import time (the interpreter and ``import torch`` take seconds on a
card host). A standby is a pre-spawned interpreter that has already
paid that cost and blocks on stdin until the agent ADOPTS it as the
next worker incarnation: the agent writes one JSON line carrying the
final environment and argv (rendezvous outcome, restart count — values
that do not exist when the standby is spawned), and the standby becomes
the worker via runpy in-process. No CUDA context is created while
waiting — importing torch initializes nothing on the card
(``torch.cuda.is_initialized()`` stays false until the adopted worker
touches it), so the standby never holds a context beside the live
worker.

Before it waits, the standby writes one JSON line to stderr (the
worker's log): ``{"event": "standby_ready", "pid", "import_s",
"cuda_initialized"}``.

Spawned by ElasticAgent when ``WorkerSpec.warm_standby`` is set (see
agent/training.py). The port's copy of ``dlrover_tpu/agent/standby.py``.
"""

import json
import os
import runpy
import sys
import time


def prepay_imports() -> float:
    """Import what every worker imports first; returns the seconds.
    ``torch._dynamo`` too: ``torch.optim``'s optimizers import it at
    their first use (their constructor and ``step``), which the port's
    training step makes in every worker; on a card host that import
    takes about as long as ``import torch``."""
    t0 = time.monotonic()
    import numpy  # noqa: F401
    import torch  # noqa: F401
    import torch._dynamo  # noqa: F401

    return time.monotonic() - t0


def wait_and_exec():
    import_s = prepay_imports()
    import torch

    sys.stderr.write(json.dumps({
        "event": "standby_ready", "pid": os.getpid(),
        "import_s": round(import_s, 4),
        "cuda_initialized": torch.cuda.is_initialized(),
    }) + "\n")
    sys.stderr.flush()
    line = sys.stdin.readline()
    if not line:
        # Agent closed stdin without adopting (job ended): exit clean.
        sys.exit(0)
    go = json.loads(line)
    os.environ.update(go["env"])
    sys.argv = list(go["argv"])
    if go.get("module"):
        runpy.run_module(go["module"], run_name="__main__", alter_sys=True)
    else:
        runpy.run_path(go["argv"][0], run_name="__main__")


if __name__ == "__main__":
    wait_and_exec()
