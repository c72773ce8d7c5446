"""Predefined event vocabularies per component.

Parity: reference dlrover/python/training_event/predefined/_dlrover.py
:39-269 — typed helpers so event names stay consistent across the
codebase and downstream analysis.

The port's copy of ``dlrover_tpu/training_event/predefined.py``.
"""

from typing import Dict, Optional

from dlrover_tpu_torch.training_event.emitter import DurationSpan, get_emitter


class MasterEvents:
    _e = staticmethod(lambda: get_emitter("master"))

    @classmethod
    def job_stage(cls, stage: str):
        cls._e().instant("job_stage", {"stage": stage})

    @classmethod
    def node_relaunch(cls, node_id: int, rank: int, reason: str):
        cls._e().instant(
            "node_relaunch",
            {"node_id": node_id, "rank": rank, "reason": reason},
        )

    @classmethod
    def node_status(cls, node_id: int, status: str, reason: str = ""):
        cls._e().instant(
            "node_status",
            {"node_id": node_id, "status": status, "reason": reason},
        )

    @classmethod
    def rdzv_round(cls, name: str, round_id: int, world_size: int):
        cls._e().instant(
            "rdzv_round",
            {"rdzv": name, "round": round_id, "world_size": world_size},
        )

    @classmethod
    def diagnosis_action(cls, action_type: str, reason: str):
        cls._e().instant(
            "diagnosis_action", {"action": action_type, "reason": reason}
        )

    @classmethod
    def scale_plan(cls, comment: str, target: int):
        cls._e().instant(
            "scale_plan", {"comment": comment, "target": target}
        )


class AgentEvents:
    _e = staticmethod(lambda: get_emitter("agent"))

    @classmethod
    def rendezvous(cls, content: Optional[Dict] = None) -> DurationSpan:
        return cls._e().duration("rendezvous", content)

    @classmethod
    def start_workers(cls, restart_count: int) -> DurationSpan:
        return cls._e().duration(
            "start_workers", {"restart_count": restart_count}
        )

    @classmethod
    def worker_failure(cls, exit_codes: Dict[int, int], decision: str):
        cls._e().instant(
            "worker_failure",
            {"exit_codes": exit_codes, "decision": decision},
        )

    @classmethod
    def node_check(cls) -> DurationSpan:
        return cls._e().duration("node_check")


class TrainerEvents:
    _e = staticmethod(lambda: get_emitter("trainer"))

    @classmethod
    def ckpt_save_memory(cls, step: int) -> DurationSpan:
        return cls._e().duration("ckpt_save_memory", {"step": step})

    @classmethod
    def ckpt_persist(cls, step: int) -> DurationSpan:
        return cls._e().duration("ckpt_persist", {"step": step})

    @classmethod
    def ckpt_restore(cls, step: int, source: str):
        cls._e().instant(
            "ckpt_restore", {"step": step, "source": source}
        )
