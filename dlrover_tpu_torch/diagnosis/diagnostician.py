"""Diagnostician pattern: observe a problem, resolve it to an action.

Parity: reference dlrover/python/diagnosis/common/diagnostician.py:95
(Diagnostician.observe/resolve/diagnose) — each diagnostician watches one
failure mode; the DiagnosisManager runs them periodically and feeds the
resulting actions into the JobContext queues.

The port's copy of ``dlrover_tpu/diagnosis/diagnostician.py``.
"""

import abc
from dataclasses import dataclass, field
from typing import Dict

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.diagnosis.actions import DiagnosisAction, NoAction


@dataclass
class Observation:
    """What a diagnostician saw; empty observation == healthy."""

    observation: str = ""
    extra: Dict[str, str] = field(default_factory=dict)

    def has_problem(self) -> bool:
        return bool(self.observation)


class Diagnostician(abc.ABC):
    """One failure mode: observe() detects it, resolve() picks the cure."""

    # How often the manager should run observe(), in seconds.
    observe_interval_s: float = 30.0

    @property
    def name(self) -> str:
        return type(self).__name__

    @abc.abstractmethod
    def observe(self, **kwargs) -> Observation:
        ...

    @abc.abstractmethod
    def resolve(self, observation: Observation, **kwargs) -> DiagnosisAction:
        ...

    def diagnose(self, **kwargs) -> DiagnosisAction:
        try:
            ob = self.observe(**kwargs)
            if not ob.has_problem():
                return NoAction()
            logger.warning("%s observed: %s", self.name, ob.observation)
            return self.resolve(ob, **kwargs)
        except Exception:
            logger.exception("diagnostician %s crashed", self.name)
            return NoAction()
