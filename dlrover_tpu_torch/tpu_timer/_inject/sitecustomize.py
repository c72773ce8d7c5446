"""Zero-cooperation profiler injection (reference xpu_timer LD_PRELOAD
contract, nvidia/hook.cc: the profiled script needs no code changes);
the port's copy of ``dlrover_tpu/tpu_timer/_inject/sitecustomize.py``.

The agent prepends this directory to a worker's PYTHONPATH when
DLROVER_TPU_TIMER_XLA is enabled; Python imports `sitecustomize` at
interpreter startup, which arms the capture listener even when the
train script never imports dlrover_tpu_torch. Nothing here imports
torch: the listener imports it at its first capture. Any sitecustomize
that this one shadows (e.g. a platform's bootstrap) is chain-loaded
first so nothing else on the machine changes.
"""

import os
import sys

_d = os.path.dirname(os.path.abspath(__file__))

# Chain-load the sitecustomize we shadowed, if any: drop our dir from
# sys.path, find the next one, and exec it under a distinct module name.
try:
    sys.path.remove(_d)
except ValueError:
    pass
try:
    # PathFinder search, NOT importlib.util.find_spec: the latter would
    # return THIS in-progress module's spec from sys.modules and the
    # chain-load would silently never happen.
    import importlib.machinery
    import importlib.util

    _spec = importlib.machinery.PathFinder.find_spec(
        "sitecustomize", sys.path
    )
    if _spec is not None and _spec.origin and (
        os.path.dirname(os.path.abspath(_spec.origin)) != _d
    ):
        _mod = importlib.util.module_from_spec(_spec)
        sys.modules["_dlrover_tpu_torch_chained_sitecustomize"] = _mod
        _spec.loader.exec_module(_mod)
except Exception:  # noqa: BLE001 - never break interpreter startup
    pass

try:
    from dlrover_tpu_torch.common.env_utils import get_env_bool

    if get_env_bool("DLROVER_TPU_TIMER_XLA"):
        from dlrover_tpu_torch.tpu_timer.xla_capture import (
            maybe_start_listener,
        )

        maybe_start_listener(
            int(os.getenv("DLROVER_TPU_LOCAL_RANK", "0") or 0)
        )
except Exception:  # noqa: BLE001 - profiling must never kill a job
    pass
