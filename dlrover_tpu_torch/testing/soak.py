"""Shared pieces of the chaos-soak harnesses (the port's copy of
``SoakInvariantError``, ``_read_events``, ``_read_trace`` and
``_repo_root`` from ``dlrover_tpu/testing/soak.py``). The seeded
whole-stack soak itself, whose serving episode runs a model, is not
ported yet (ROADMAP §A)."""

import json
import os
from typing import Dict, List


class SoakInvariantError(AssertionError):
    pass


def _repo_root() -> str:
    import dlrover_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(
        dlrover_tpu_torch.__file__
    )))


def _read_events(path: str) -> List[Dict]:
    events = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except ValueError:
                    pass  # torn tail line from a SIGKILL mid-write
    except OSError:
        pass
    return events


def _read_trace(path: str, origin: str) -> List[Dict]:
    out = []
    for entry in _read_events(path):
        out.append({
            "origin": origin,
            "point": entry.get("point"),
            "action": entry.get("action"),
            "rule_id": entry.get("rule_id"),
            "hit": entry.get("hit"),
        })
    return out
