"""The chaos-soak worker's ledger and state checksum (the port's copy of
``EventLog`` and ``state_crc`` from ``dlrover_tpu/testing/soak_worker.py``;
the crash-restart soak worker itself is not ported yet, ROADMAP §A).

``state_crc`` takes numpy arrays or torch tensors (on any device) and
gives the reference's checksum of the same values: each leaf's bytes,
then its dtype's numpy name (``"int64"``, never ``"torch.int64"``), in
sorted key order.
"""

import binascii
import json
import os
import time
from typing import Dict

import numpy as np
import torch


def host_array(leaf) -> np.ndarray:
    """A contiguous numpy array of ``leaf``'s values (a tensor is copied
    to the host first)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous().numpy()
    return np.ascontiguousarray(leaf)


def state_crc(state: Dict[str, object]) -> int:
    crc = 0
    for key in sorted(state):
        arr = host_array(state[key])
        crc = binascii.crc32(arr.tobytes(), crc)
        crc = binascii.crc32(str(arr.dtype).encode(), crc)
    return crc


class EventLog:
    """Append-only fsynced JSONL ledger that survives SIGKILL."""

    def __init__(self, path: str):
        self._f = open(path, "a")

    def append(self, **entry):
        entry.setdefault("t", time.time())
        self._f.write(json.dumps(entry) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
