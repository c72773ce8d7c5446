"""Closed-loop autoscaler: observe goodput signals, decide, actuate.

The L1 "resource brain" control loop (docs/DESIGN.md §30): a
:class:`~dlrover_tpu_torch.autoscaler.signals.SignalBus` samples the live
signal plane (per-rank step-time EWMAs + straggler scores, shard-queue
depths, serving fleet load, fault history + observed MTBF, running
goodput), a deterministic rule
:class:`~dlrover_tpu_torch.autoscaler.policy.RulePolicy` (hysteresis bands,
per-action cooldowns) turns snapshots into typed
:class:`~dlrover_tpu_torch.autoscaler.policy.ScaleDecision`\\ s, and the
:class:`~dlrover_tpu_torch.autoscaler.loop.AutoScaler` loop actuates them —
rescale-coordinator evictions, :class:`ScalePlan`\\ s against a
``Scaler`` backend, serving-fleet add/drain, flash-ckpt cadence — with
every decision landing in a ledger alongside the exact signal snapshot
that triggered it. ``dry_run=True`` produces the same ledger with zero
actuations.

The port's copy of ``dlrover_tpu/autoscaler/``, with the reference's
names and ``__all__``. It runs on the host and launches no kernel.
"""

from dlrover_tpu_torch.autoscaler.actuator import (
    CadenceController,
    FleetActuator,
    TrainWorldActuator,
)
from dlrover_tpu_torch.autoscaler.loop import AutoScaler, BrainPrior
from dlrover_tpu_torch.autoscaler.recorder import (
    RECORD_ENV,
    Recording,
    SignalRecorder,
    load_recording,
    recorder_from_env,
)
from dlrover_tpu_torch.autoscaler.replay import (
    CostModel,
    ReplayMismatch,
    assert_replay_identity,
    diff_ledgers,
    rank_policies,
    replay_policy,
    replay_recording,
    score_ledger,
)
from dlrover_tpu_torch.autoscaler.policy import (
    ACTIONS,
    EVICT_STRAGGLER,
    GROW_FLEET,
    GROW_WORLD,
    SEED_WORLD,
    SET_CKPT_INTERVAL,
    SHRINK_FLEET,
    SHRINK_WORLD,
    DecisionLedger,
    PolicyConfig,
    RulePolicy,
    ScaleDecision,
)
from dlrover_tpu_torch.autoscaler.signals import (
    FaultHistory,
    SignalBus,
    SignalSnapshot,
    control_plane_source,
    data_source,
    fault_source,
    fleet_source,
    kvpool_source,
    perf_source,
)

__all__ = [
    "AutoScaler",
    "BrainPrior",
    "SignalRecorder",
    "Recording",
    "load_recording",
    "recorder_from_env",
    "RECORD_ENV",
    "CostModel",
    "ReplayMismatch",
    "assert_replay_identity",
    "diff_ledgers",
    "rank_policies",
    "replay_policy",
    "replay_recording",
    "score_ledger",
    "SignalBus",
    "SignalSnapshot",
    "FaultHistory",
    "perf_source",
    "data_source",
    "fleet_source",
    "fault_source",
    "kvpool_source",
    "control_plane_source",
    "RulePolicy",
    "PolicyConfig",
    "ScaleDecision",
    "DecisionLedger",
    "ACTIONS",
    "EVICT_STRAGGLER",
    "GROW_WORLD",
    "SHRINK_WORLD",
    "GROW_FLEET",
    "SHRINK_FLEET",
    "SET_CKPT_INTERVAL",
    "SEED_WORLD",
    "TrainWorldActuator",
    "FleetActuator",
    "CadenceController",
]
