"""What-if policy ranking over a recorded autoscaler signal stream.

Loads a §34 SignalRecorder recording (``DLROVER_TPU_AUTOSCALE_RECORD``
output, or the autoscale soak's), asserts the replay identity invariant
(the recorded PolicyConfig must reproduce the live ledger decision for
decision), then replays N candidate policies over the same stream and
ranks them under the goodput model — actuation costs calibrated from
the bench artifacts the caller names (``--bench-artifact``, newest
first), else ``CostModel()``'s defaults.

    python tools/torch_whatif.py RECORDING [--candidates cands.json]
        [--top 5] [--full] [--bench-artifact BENCH.json ...]

``--candidates`` is a JSON file ``{"name": {policy-config-overrides},
...}`` applied over the RECORDED config; without it a built-in spread
of perturbations (more/less trigger-happy eviction, wider/narrower
fleet bands, frozen cadence) is ranked. Prints one JSON document.

Also exposes ``run_bench()`` — the ``whatif`` bench phase: a synthetic
deterministic recording is generated in-process (fake clocks, no
sleeps), recorded through the real SignalRecorder, replayed for
identity, and timed for replay throughput (snapshots/s).

The port's copy of ``tools/whatif.py``. A recording that either package
wrote ranks here. The reference calibrates its cost model from the JAX
package's own bench runs (``BENCH_SELF.json``, ``BENCH_r05.json``); this
tool reads no artifact its caller does not name.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dlrover_tpu_torch.autoscaler import (  # noqa: E402
    AutoScaler,
    CostModel,
    EVICT_STRAGGLER,
    GROW_FLEET,
    PolicyConfig,
    RulePolicy,
    SET_CKPT_INTERVAL,
    SHRINK_FLEET,
    SignalBus,
    SignalRecorder,
    load_recording,
    rank_policies,
)

def builtin_candidates(base: PolicyConfig) -> List[Tuple[str, PolicyConfig]]:
    """A spread of plausible perturbations around the recorded config —
    the hand-tuned grid a learned brain would search."""
    return [
        ("evict-eager", replace(
            base, straggler_confirm_ticks=1,
            evict_cooldown_s=base.evict_cooldown_s / 2.0,
        )),
        ("evict-cautious", replace(
            base,
            straggler_confirm_ticks=base.straggler_confirm_ticks + 3,
        )),
        ("never-evict", replace(base, straggler_confirm_ticks=10_000)),
        ("fleet-aggressive", replace(
            base, fleet_util_grow=0.6, fleet_confirm_ticks=1,
        )),
        ("fleet-frozen", replace(
            base, fleet_util_grow=1.01, fleet_util_shrink=-1.0,
        )),
        ("cadence-frozen", replace(base, ckpt_retune_frac=10.0)),
    ]


def load_candidates(path: str,
                    base: PolicyConfig) -> List[Tuple[str, PolicyConfig]]:
    with open(path) as f:
        spec = json.load(f)
    out = []
    for name, overrides in spec.items():
        merged = dict(base.to_dict())
        merged.update(overrides or {})
        out.append((name, PolicyConfig.from_dict(merged)))
    return out


def rank_recording(
    recording_path: str,
    candidates_path: Optional[str] = None,
    cost: Optional[CostModel] = None,
    with_decisions: bool = False,
    bench_artifacts: Sequence[str] = (),
) -> Dict:
    """Rank candidates over the recording. Without ``cost`` the costs
    come from ``bench_artifacts`` (newest first), else the defaults."""
    recording = load_recording(recording_path)
    base = PolicyConfig.from_dict(recording.policy_config or {})
    candidates = (
        load_candidates(candidates_path, base)
        if candidates_path else builtin_candidates(base)
    )
    if cost is None:
        cost = (CostModel.from_bench(bench_artifacts)
                if bench_artifacts else CostModel())
    result = rank_policies(recording, candidates, cost,
                           with_decisions=with_decisions)
    result["recording"] = {
        "path": recording_path,
        "files": recording.files,
        "corrupt_lines": recording.corrupt_lines,
        "previous_runs": recording.previous_runs,
        "outcomes_recorded": len(recording.outcomes),
    }
    return result


# ---------------------------------------------------------------------------
# Synthetic recording + the bench phase
# ---------------------------------------------------------------------------


def synthesize_recording(
    path: str,
    snapshots: int = 50,
    fsync: bool = True,
    seed: int = 0,
) -> Dict:
    """Drive a REAL AutoScaler (fake clocks, scripted sources, no
    sleeps) long enough to exercise every rule family — straggler
    flags, a traffic spike, failure arrivals feeding the MTBF retune —
    and record it. Deterministic in (snapshots, seed)."""
    t = {"now": 1000.0 + seed}

    def clock():
        return t["now"]

    state = {"i": 0, "failures": 0, "interval": 3.0}

    def perf():
        i = state["i"]
        lagging = 10 <= i % 40 < 26
        return {
            "goodput": round(0.5 + 0.3 * ((i % 7) / 7.0), 4),
            "straggler_ranks": [2] if lagging else [],
            "straggler_scores": {2: 2.8} if lagging else {},
            "median_step_s": 0.01,
        }

    def fleet():
        i = state["i"]
        spike = 15 <= i % 50 < 35
        return {
            "replicas": 2,
            "slot_util": 0.97 if spike else 0.2,
            "queue_depth": 40 if spike else 0,
        }

    def fault():
        i = state["i"]
        if i > 0 and i % 12 == 0:
            state["failures"] += 1
        out = {"failures_total": state["failures"]}
        if state["failures"] >= 2:
            out["mtbf_s"] = 12 * 0.25
        return out

    def ckpt():
        return {"interval_s": state["interval"], "save_block_s": 0.01}

    bus = (
        SignalBus(clock=clock)
        .add_source("perf", perf)
        .add_source("fleet", fleet)
        .add_source("fault", fault)
        .add_source("ckpt", ckpt)
    )
    recorder = SignalRecorder(path, fsync=fsync)
    config = PolicyConfig(
        straggler_confirm_ticks=2, evict_cooldown_s=1.0,
        ckpt_cooldown_s=1.0, ckpt_min_interval_s=0.05,
        min_replicas=1, max_replicas=4,
        fleet_confirm_ticks=2, fleet_cooldown_s=1.0,
    )

    def retune(decision):
        state["interval"] = float(decision.target)

    scaler = AutoScaler(
        bus,
        policy=RulePolicy(config),
        actuators={
            EVICT_STRAGGLER: lambda d: None,
            SET_CKPT_INTERVAL: retune,
            GROW_FLEET: lambda d: None,
            SHRINK_FLEET: lambda d: None,
        },
        clock=clock,
        recorder=recorder,
        attribution_window_s=0.5,
    )
    decisions = 0
    for _ in range(snapshots):
        decisions += len(scaler.tick())
        state["i"] += 1
        t["now"] += 0.25
    scaler.stop()
    return {
        "snapshots": snapshots,
        "decisions": decisions,
        "outcomes": scaler.ledger.outcomes_total,
    }


def run_bench(snapshots: int = 4000, seed: int = 0) -> Dict:
    """The ``whatif`` bench phase: synthesize → load → identity →
    throughput → rank. All fake-clock, so the snapshots/s number is
    pure replay machinery."""
    tmp = tempfile.mkdtemp(prefix="whatif-bench-")
    path = os.path.join(tmp, "signals.jsonl")
    try:
        # fsync=False: the durability discipline is pointless on a
        # throwaway temp recording, and 4000 fsyncs on slow storage
        # would bill the phase for the disk, not the replay machinery.
        synth = synthesize_recording(path, snapshots=snapshots,
                                     seed=seed, fsync=False)
        t0 = time.monotonic()
        load_recording(path)
        load_s = time.monotonic() - t0
        result = rank_recording(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    best = result["ranked"][0] if result["ranked"] else {}
    return {
        "whatif_snapshots": synth["snapshots"],
        "whatif_recorded_decisions": synth["decisions"],
        "whatif_outcomes_recorded": synth["outcomes"],
        "whatif_identity_ok": bool(result["identity"]["identical"]),
        "whatif_replay_snapshots_per_s": result[
            "replay_snapshots_per_s"
        ],
        "whatif_load_s": round(load_s, 4),
        "whatif_candidates": result["candidates"],
        "whatif_best_candidate": best.get("name"),
        "whatif_best_est_goodput": best.get("est_goodput_frac"),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="rank candidate autoscaler policies over a recording"
    )
    parser.add_argument("recording", nargs="?", default=None,
                        help="SignalRecorder JSONL path")
    parser.add_argument("--candidates", default=None,
                        help="JSON file of {name: config-overrides}")
    parser.add_argument("--top", type=int, default=0,
                        help="print only the best N candidates")
    parser.add_argument("--full", action="store_true",
                        help="include counterfactual decision ledgers")
    parser.add_argument("--bench", action="store_true",
                        help="run the synthetic bench instead")
    parser.add_argument("--snapshots", type=int, default=4000)
    parser.add_argument(
        "--bench-artifact", action="append", default=[],
        help="bench JSON whose rescale_to_first_step_s and "
        "ckpt_save_block_s calibrate the cost model (repeat, newest "
        "first); without one the defaults hold",
    )
    args = parser.parse_args(argv)
    if args.bench or args.recording is None:
        print(json.dumps(run_bench(snapshots=args.snapshots)),
              flush=True)
        return 0
    result = rank_recording(
        args.recording, candidates_path=args.candidates,
        with_decisions=args.full, bench_artifacts=args.bench_artifact,
    )
    if args.top:
        result["ranked"] = result["ranked"][:args.top]
    print(json.dumps(result, indent=1, default=str), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
