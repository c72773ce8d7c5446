"""Agent-side parallel-config tuner.

Parity: reference dlrover/python/elastic_agent/config/
paral_config_tuner.py:30 — polls the master's suggested ParallelConfig
and writes it to a JSON file the trainer watches; trainers that opt in
re-tune micro-batch/grad-accum (and rebuild their jitted step) when the
version changes.

The port's copy of ``dlrover_tpu/agent/paral_config_tuner.py``.
"""

import json
import os
import threading
from typing import Optional

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import logger

CONFIG_FILE_ENV = "DLROVER_TPU_PARAL_CONFIG_FILE"


def default_config_path(job_name: str = "job") -> str:
    import tempfile

    return os.path.join(
        tempfile.gettempdir(), f"dlrover_tpu_paral_config_{job_name}.json"
    )


class ParalConfigTuner:
    def __init__(
        self,
        master_client,
        config_path: str = "",
        interval_s: float = 30.0,
    ):
        self._client = master_client
        self._path = config_path or default_config_path(
            os.getenv(NodeEnv.JOB_NAME, "job")
        )
        self._interval_s = interval_s
        # Start at 0: the master's "no suggestion yet" sentinel is a
        # default ParallelConfig with version=0 and must not be written.
        self._version = 0
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.environ[CONFIG_FILE_ENV] = self._path

    @property
    def config_path(self) -> str:
        return self._path

    def tune_once(self) -> bool:
        """Fetch the suggestion; write the file if the version advanced."""
        try:
            config = self._client.get_parallel_config()
        except Exception:
            logger.warning("parallel config fetch failed", exc_info=True)
            return False
        if config is None or config.version <= self._version:
            return False
        self._version = config.version
        payload = {
            "version": config.version,
            "micro_batch_size": config.micro_batch_size,
            "grad_accum_steps": config.grad_accum_steps,
            "remat_policy": config.remat_policy,
            "mesh_shape": config.mesh_shape,
        }
        tmp = f"{self._path}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.rename(tmp, self._path)
        logger.info("parallel config v%d written to %s",
                    config.version, self._path)
        return True

    def start(self):
        self._stopped.clear()
        self._thread = threading.Thread(
            target=self._loop, name="paral-config-tuner", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _loop(self):
        while not self._stopped.wait(self._interval_s):
            try:
                self.tune_once()
            except Exception:
                logger.warning("config tuning failed", exc_info=True)


def read_parallel_config(path: str = "") -> Optional[dict]:
    """Trainer-side helper: current suggestion or None.

    Zero-valued ``micro_batch_size``/``grad_accum_steps`` mean "no
    suggestion for this knob" (the master may know the mesh/remat answer
    before it knows the global batch); trainers must treat 0 as unset.
    """
    path = path or os.getenv(CONFIG_FILE_ENV, "")
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
