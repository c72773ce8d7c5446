"""What-if replay: run a recorded signal stream through candidate
policies offline, diff counterfactual ledgers, score them.

The §30 rules are CLOCKLESS by design — every time comparison is
between snapshot timestamps, never a live clock read — so feeding the
recorded snapshot stream back through the SAME :class:`PolicyConfig`
must reproduce the live run's decision ledger *decision for decision*
(same actions, same targets, same order). That identity is the
invariant :func:`assert_replay_identity` pins, and it is what licenses
the interesting use: replay the stream through a *candidate* config and
read the counterfactual ledger a different policy WOULD have produced,
without touching the live job.

Scoring is a goodput model over the recorded horizon, calibrated from
MEASURED actuation costs (:class:`CostModel` defaults come from the
bench history: rescale-to-first-step seconds, ckpt blocking cost). Per
candidate it estimates lost wall time in four explainable buckets —
actuation pauses, ckpt save overhead along the candidate's interval
trajectory, replay exposure at the failures the recording actually
observed, and the straggler tax accrued while flagged ranks went
unevicted — and returns an estimated goodput fraction. The model is a
counterfactual lower bound, not ground truth (the recording's signals
embed what the LIVE policy did); its job is to rank candidates, and the
recorded policy's own score cross-checks against the measured run.

``SEED_WORLD`` ledger entries are brain-prior seeds, not policy output;
identity comparison excludes them (replay has no brain to ask).

The port's copy of ``dlrover_tpu/autoscaler/replay.py``.
"""

import time
from dataclasses import dataclass, field, fields
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from dlrover_tpu_torch.autoscaler.policy import (
    EVICT_STRAGGLER,
    GROW_FLEET,
    GROW_WORLD,
    PolicyConfig,
    RulePolicy,
    ScaleDecision,
    SEED_WORLD,
    SET_CKPT_INTERVAL,
    SHRINK_FLEET,
    SHRINK_WORLD,
)
from dlrover_tpu_torch.autoscaler.recorder import Recording
from dlrover_tpu_torch.autoscaler.signals import SignalSnapshot


class ReplayMismatch(AssertionError):
    """Replaying the recorded policy did not reproduce its ledger."""


def replay_policy(
    snapshots: Iterable[SignalSnapshot],
    config: Optional[PolicyConfig] = None,
) -> List[ScaleDecision]:
    """Feed snapshots (in recorded order) through a fresh RulePolicy;
    the returned decisions are the counterfactual ledger (seq assigned
    1..N, no outcomes — nothing was actuated)."""
    policy = RulePolicy(config or PolicyConfig())
    out: List[ScaleDecision] = []
    for snap in snapshots:
        for decision in policy.decide(snap):
            decision.seq = len(out) + 1
            out.append(decision)
    return out


def replay_recording(
    recording: Recording,
    config: Optional[PolicyConfig] = None,
) -> List[ScaleDecision]:
    """Replay a loaded recording: with ``config=None`` the RECORDED
    policy config is used (the identity case)."""
    if config is None:
        if recording.policy_config is None:
            raise ValueError(
                "recording carries no policy config; pass one"
            )
        config = PolicyConfig.from_dict(recording.policy_config)
    return replay_policy(recording.snapshots, config)


# ---------------------------------------------------------------------------
# Ledger diffing + the identity invariant
# ---------------------------------------------------------------------------


def _decision_key(d) -> Tuple[str, str, float]:
    """Order-comparable identity of one decision: (action, target, ts).
    Accepts ScaleDecision or a recorded dict. Targets compare as
    strings (JSON round-trips ints losslessly, floats were rounded at
    fire time)."""
    if isinstance(d, dict):
        return (
            str(d.get("action")), str(d.get("target")),
            round(float(d.get("ts", 0.0)), 6),
        )
    return (str(d.action), str(d.target), round(float(d.ts), 6))


def policy_decisions(decisions: Sequence) -> List:
    """Drop non-policy entries (the brain's SEED_WORLD prior) before an
    identity comparison."""
    out = []
    for d in decisions:
        action = d.get("action") if isinstance(d, dict) else d.action
        if action != SEED_WORLD:
            out.append(d)
    return out


def diff_ledgers(recorded: Sequence, replayed: Sequence) -> Dict:
    """Positional diff of two decision sequences (recorded entries may
    be dicts, replayed ones ScaleDecisions)."""
    rec = [_decision_key(d) for d in policy_decisions(recorded)]
    rep = [_decision_key(d) for d in policy_decisions(replayed)]
    matched = 0
    first_divergence = None
    for i, (a, b) in enumerate(zip(rec, rep)):
        if a == b:
            matched += 1
        else:
            first_divergence = {"index": i, "recorded": a, "replayed": b}
            break
    if first_divergence is None and len(rec) != len(rep):
        i = min(len(rec), len(rep))
        first_divergence = {
            "index": i,
            "recorded": rec[i] if i < len(rec) else None,
            "replayed": rep[i] if i < len(rep) else None,
        }
    return {
        "identical": first_divergence is None,
        "recorded_total": len(rec),
        "replayed_total": len(rep),
        "matched": matched,
        "first_divergence": first_divergence,
    }


def assert_replay_identity(recording: Recording) -> Dict:
    """The §34 invariant: the recorded signal stream through the
    recorded PolicyConfig reproduces the recorded ledger exactly.
    Returns the (identical) diff; raises :class:`ReplayMismatch` with
    the first divergence otherwise.

    Only meaningful on a COMPLETE recording: when the rotation bound
    deleted the stream's beginning, a fresh policy cannot know the
    cooldowns/streaks accrued in the deleted era, so identity is
    undecidable and this raises ``ReplayMismatch`` naming the
    truncation rather than reporting a spurious divergence."""
    if recording.truncated:
        raise ReplayMismatch(
            "recording is truncated (oldest rotation generation "
            "deleted); replay identity is undecidable from mid-stream"
        )
    replayed = replay_recording(recording)
    diff = diff_ledgers(recording.decisions, replayed)
    if not diff["identical"]:
        raise ReplayMismatch(
            f"replay of the recorded policy diverged from the live "
            f"ledger at {diff['first_divergence']}"
        )
    return diff


# ---------------------------------------------------------------------------
# Counterfactual scoring
# ---------------------------------------------------------------------------


@dataclass
class CostModel:
    """Measured actuation costs the goodput model charges. The defaults
    are the reference's numbers, from its bench on a 2-core host CPU:
    they were not measured for the port or on the card.
    :meth:`from_bench` recalibrates from the newest bench artifact that
    carries the keys."""

    rescale_to_first_step_s: float = 0.4   # bench `rescale` phase
    evict_pause_s: float = 0.4             # evict == one rescale pause
    fleet_change_s: float = 0.05           # router add/drain latency
    save_block_s: float = 0.01             # ckpt blocking cost per save
    straggler_flag_threshold: float = 1.5  # score at which tax accrues

    _BENCH_KEYS = {
        "rescale_to_first_step_s": "rescale_to_first_step_s",
        "ckpt_save_block_s": "save_block_s",
    }

    @classmethod
    def from_bench(cls, paths: Iterable[str]) -> "CostModel":
        """Best-effort calibration from bench JSON artifacts, newest
        first. Each cost key takes the FIRST (newest) artifact that
        carries it — an artifact missing a key does not stop the scan,
        and keys no artifact carries keep their defaults."""
        import json
        import os

        model = cls()
        remaining = dict(cls._BENCH_KEYS)
        for path in paths:
            if not remaining:
                break
            if not os.path.exists(path):
                continue
            try:
                data = json.loads(open(path).read())
            except (OSError, ValueError):
                continue
            for bench_key in list(remaining):
                value = data.get(bench_key)
                if isinstance(value, (int, float)) and value > 0:
                    setattr(model, remaining.pop(bench_key),
                            float(value))
        if "rescale_to_first_step_s" not in remaining:
            # The eviction pause IS one rescale pause; keep the pair
            # coherent when the rescale number was calibrated.
            model.evict_pause_s = model.rescale_to_first_step_s
        return model

    def to_dict(self) -> Dict[str, float]:
        return {
            f.name: getattr(self, f.name)
            for f in fields(self) if not f.name.startswith("_")
        }


def _snap_clock(snap: SignalSnapshot) -> float:
    """Replay arithmetic runs on the monotonic stamp when the recording
    has one (wall steps must not warp the horizon); old recordings
    (mono==0) fall back to wall."""
    return snap.mono if snap.mono else snap.ts


def score_ledger(
    snapshots: Sequence[SignalSnapshot],
    decisions: Sequence,
    cost: Optional[CostModel] = None,
) -> Dict:
    """Estimated goodput of running ``decisions`` over the recorded
    horizon. See module docstring for the four loss buckets."""
    cost = cost or CostModel()
    if len(snapshots) < 2:
        return {
            "horizon_s": 0.0, "est_goodput_frac": 0.0,
            "decisions_total": len(list(decisions)),
        }
    decisions = policy_decisions(decisions)

    def d_clock(d):
        """Decision time on the SAME clock family as _snap_clock: mono
        when stamped (every §34 recording), wall otherwise — a wall
        step mid-recording must not un-apply a retune or un-mitigate
        an eviction in the comparisons below."""
        if isinstance(d, dict):
            mono = float(d.get("mono", 0.0))
            return mono if mono else float(d.get("ts", 0.0))
        return d.mono if d.mono else d.ts

    def d_action(d):
        return d.get("action") if isinstance(d, dict) else d.action

    def d_target(d):
        return d.get("target") if isinstance(d, dict) else d.target

    horizon = max(
        _snap_clock(snapshots[-1]) - _snap_clock(snapshots[0]), 1e-9
    )
    # Actuation pauses: every world move / evict pays a rescale pause,
    # every fleet change its add/drain latency; retunes are free.
    actuation_cost = 0.0
    evict_ts: List[float] = []
    for d in decisions:
        action = d_action(d)
        if action == EVICT_STRAGGLER:
            actuation_cost += cost.evict_pause_s
            evict_ts.append(d_clock(d))
        elif action in (GROW_WORLD, SHRINK_WORLD):
            actuation_cost += cost.rescale_to_first_step_s
        elif action in (GROW_FLEET, SHRINK_FLEET):
            actuation_cost += cost.fleet_change_s

    # Ckpt interval trajectory: the candidate's retunes, applied at
    # their decision timestamps, govern save overhead and the replay
    # exposure charged at each failure the recording observed.
    retunes = sorted(
        (
            (d_clock(d), float(d_target(d)))
            for d in decisions if d_action(d) == SET_CKPT_INTERVAL
        ),
        key=lambda x: x[0],
    )

    first = snapshots[0]
    interval = first.get("ckpt.interval_s")
    save_block = float(
        first.get("ckpt.save_block_s", cost.save_block_s) or
        cost.save_block_s
    )
    save_overhead = 0.0
    replay_exposure = 0.0
    straggler_tax = 0.0
    failures_seen = 0
    retune_idx = 0
    prev = snapshots[0]
    prev_fail = float(prev.get("fault.failures_total", 0) or 0)
    for snap in snapshots[1:]:
        dt = max(_snap_clock(snap) - _snap_clock(prev), 0.0)
        while (retune_idx < len(retunes)
               and retunes[retune_idx][0] <= _snap_clock(prev)):
            interval = retunes[retune_idx][1]
            retune_idx += 1
        if interval and dt > 0:
            save_overhead += dt / max(float(interval), 1e-9) * save_block
        fails = float(snap.get("fault.failures_total", prev_fail)
                      or prev_fail)
        if fails > prev_fail:
            n = fails - prev_fail
            failures_seen += int(n)
            if interval:
                # Expected replay at a Poisson failure: interval/2,
                # plus the restart pause per death.
                replay_exposure += n * (
                    float(interval) / 2.0 + cost.rescale_to_first_step_s
                )
            prev_fail = fails
        # Straggler tax: while a rank scores over the flag bar and the
        # candidate has not yet evicted ANY rank by this point in the
        # stream, the whole world loses the excess fraction of dt.
        scores = prev.get("perf.straggler_scores") or {}
        worst = 0.0
        for s in scores.values():
            try:
                worst = max(worst, float(s))
            except (TypeError, ValueError):
                continue
        if worst >= cost.straggler_flag_threshold:
            mitigated = any(
                t <= _snap_clock(prev) for t in evict_ts
            )
            if not mitigated:
                straggler_tax += dt * (1.0 - 1.0 / worst)
        prev = snap

    lost = actuation_cost + save_overhead + replay_exposure + straggler_tax
    return {
        "horizon_s": round(horizon, 4),
        "actuation_cost_s": round(actuation_cost, 4),
        "save_overhead_s": round(save_overhead, 4),
        "replay_exposure_s": round(replay_exposure, 4),
        "straggler_tax_s": round(straggler_tax, 4),
        "failures_seen": failures_seen,
        "est_lost_s": round(lost, 4),
        "est_goodput_frac": round(
            max(horizon - lost, 0.0) / horizon, 4
        ),
        "decisions_total": len(decisions),
        "cost_model": cost.to_dict(),
    }


# ---------------------------------------------------------------------------
# Candidate ranking
# ---------------------------------------------------------------------------


@dataclass
class RankedCandidate:
    name: str
    config: PolicyConfig
    score: Dict = field(default_factory=dict)
    diff_vs_recorded: Dict = field(default_factory=dict)
    decisions: List[ScaleDecision] = field(default_factory=list)

    def to_dict(self, with_decisions: bool = False) -> Dict:
        out = {
            "name": self.name,
            "est_goodput_frac": self.score.get("est_goodput_frac"),
            "score": dict(self.score),
            "identical_to_recorded": self.diff_vs_recorded.get(
                "identical"
            ),
            "decisions_total": len(self.decisions),
        }
        if with_decisions:
            out["decisions"] = [d.to_dict() for d in self.decisions]
        return out


def rank_policies(
    recording: Recording,
    candidates: Sequence[Tuple[str, PolicyConfig]],
    cost: Optional[CostModel] = None,
    with_decisions: bool = False,
) -> Dict:
    """Replay + score every candidate over one recording; the recorded
    policy rides along as the baseline (and its replay is asserted
    identical first — a broken identity invalidates every ranking).
    On a TRUNCATED recording (oldest rotation generation deleted)
    identity is undecidable, so it is reported skipped instead of
    asserted — long production recordings must still be rankable.
    Returns {"identity": diff, "ranked": [...best-first...],
    "replay_snapshots_per_s": measured replay throughput}."""
    cost = cost or CostModel()
    ranked: List[RankedCandidate] = []
    snapshots = recording.snapshots
    recorded_config = PolicyConfig.from_dict(
        recording.policy_config or {}
    )
    total_replayed = 0
    t0 = time.monotonic()
    # One replay of the recorded config serves BOTH the identity check
    # and the baseline ranking entry — a second full pass over a
    # production-sized stream would be pure waste.
    recorded_decisions = replay_policy(snapshots, recorded_config)
    total_replayed += len(snapshots)
    recorded_diff = diff_ledgers(recording.decisions,
                                 recorded_decisions)
    if recording.truncated:
        identity: Dict = {
            "identical": None,
            "skipped": "truncated recording: replay identity is "
                       "undecidable from mid-stream",
        }
    else:
        identity = recorded_diff
        if not identity["identical"]:
            raise ReplayMismatch(
                f"replay of the recorded policy diverged from the "
                f"live ledger at {identity['first_divergence']}"
            )
    ranked.append(RankedCandidate(
        name="recorded",
        config=recorded_config,
        score=score_ledger(snapshots, recorded_decisions, cost),
        diff_vs_recorded=recorded_diff,
        decisions=recorded_decisions,
    ))
    for name, config in candidates:
        decisions = replay_policy(snapshots, config)
        total_replayed += len(snapshots)
        ranked.append(RankedCandidate(
            name=name,
            config=config,
            score=score_ledger(snapshots, decisions, cost),
            diff_vs_recorded=diff_ledgers(
                recording.decisions, decisions
            ),
            decisions=decisions,
        ))
    elapsed = max(time.monotonic() - t0, 1e-9)
    ranked.sort(
        key=lambda c: c.score.get("est_goodput_frac", 0.0),
        reverse=True,
    )
    return {
        "identity": identity,
        "snapshots": len(snapshots),
        "candidates": len(ranked),
        "replay_snapshots_per_s": round(total_replayed / elapsed, 1),
        "ranked": [
            c.to_dict(with_decisions=with_decisions) for c in ranked
        ],
        "best": ranked[0].name if ranked else None,
    }
