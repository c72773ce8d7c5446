"""Deterministic fault-injection plane of the port (its own copy of
``dlrover_tpu/fault``): named injection sites that are one global read
when disarmed, armed by a seeded :class:`FaultSchedule`."""

from dlrover_tpu_torch.fault.registry import (  # noqa: F401
    KNOWN_POINTS,
    SCHEDULE_ENV,
    TRACE_ENV,
    FaultAction,
    FaultInjected,
    FaultRule,
    FaultSchedule,
    active_schedule,
    arm,
    arm_from_env,
    disarm,
    fault_point,
)
