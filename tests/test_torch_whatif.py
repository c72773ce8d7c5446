"""The port's decision-outcome plane (``autoscaler/recorder.py``,
``replay.py``, the loop's outcome attribution), from the reference's
``tests/test_whatif.py``: the SignalRecorder's durable JSONL stream
(schema versioning, torn-line tolerance, rotation, mono ordering), the
loop's outcome attribution, the what-if replay engine (identity
invariant, perturbed counterfactual, scoring), per-cause goodput
attribution and ``tools/torch_whatif.py``. The reference's dashboard
test (``/api/goodput`` and the paginated ``/api/autoscaler``) runs on
the port in ``tests/test_torch_dashboard.py``.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import json
import os

import pytest

from dlrover_tpu_torch.autoscaler import (
    EVICT_STRAGGLER,
    GROW_FLEET,
    SET_CKPT_INTERVAL,
    AutoScaler,
    CostModel,
    DecisionLedger,
    PolicyConfig,
    Recording,
    ReplayMismatch,
    RulePolicy,
    ScaleDecision,
    SignalBus,
    SignalRecorder,
    assert_replay_identity,
    diff_ledgers,
    load_recording,
    recorder_from_env,
    replay_policy,
    replay_recording,
    score_ledger,
)
from dlrover_tpu_torch.autoscaler.recorder import RECORD_ENV, SCHEMA_VERSION
from dlrover_tpu_torch.autoscaler.signals import SignalSnapshot

pytestmark = [pytest.mark.whatif, pytest.mark.autoscale]


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _scripted_scaler(clock, tmp_path, feed, actuators=None,
                     config=None, window=0.5, fsync=True):
    """A real AutoScaler over a scripted source: ``feed(i)`` returns
    the perf values for tick i. Returns (scaler, recording path)."""
    state = {"i": 0}

    def source():
        values = feed(state["i"])
        state["i"] += 1
        return values

    bus = SignalBus(clock=clock).add_source("perf", source)
    path = os.path.join(str(tmp_path), "signals.jsonl")
    scaler = AutoScaler(
        bus,
        policy=RulePolicy(config or PolicyConfig(
            straggler_confirm_ticks=2, evict_cooldown_s=5.0,
        )),
        actuators=actuators or {EVICT_STRAGGLER: lambda d: None},
        clock=clock,
        recorder=SignalRecorder(path, fsync=fsync),
        attribution_window_s=window,
    )
    return scaler, path


# ---------------------------------------------------------------------------
# SignalRecorder: durability, schema, rotation, ordering
# ---------------------------------------------------------------------------


def test_recorder_roundtrips_snapshots_decisions_outcomes(tmp_path):
    clock = FakeClock()

    def feed(i):
        if 2 <= i <= 4:
            return {"straggler_ranks": [3],
                    "straggler_scores": {3: 2.5},
                    "median_step_s": 0.01, "goodput": 0.5}
        return {"goodput": 0.8}

    scaler, path = _scripted_scaler(clock, tmp_path, feed)
    for _ in range(8):
        scaler.tick()
        clock.advance(0.25)
    scaler.stop()
    rec = load_recording(path)
    assert rec.schema_version == SCHEMA_VERSION
    assert len(rec.snapshots) == 8
    assert rec.corrupt_lines == 0
    assert rec.policy_config is not None
    assert rec.policy_config["straggler_confirm_ticks"] == 2
    assert len(rec.decisions) == 1
    d = rec.decisions[0]
    assert d["action"] == EVICT_STRAGGLER and d["outcome"] == "actuated"
    # The outcome backfill reached the recording keyed by ledger seq.
    assert d["seq"] in rec.outcomes
    assert "verdict" in rec.outcomes[d["seq"]]
    # Snapshots carry the (wall, mono) pair.
    assert all(s.mono for s in rec.snapshots)
    assert all(s.ts for s in rec.snapshots)


def test_recorder_tolerates_torn_final_line(tmp_path):
    path = os.path.join(str(tmp_path), "rec.jsonl")
    r = SignalRecorder(path)
    r.record_snapshot(SignalSnapshot(seq=1, ts=1.0, mono=1.0,
                                     values={"a": 1}))
    r.record_snapshot(SignalSnapshot(seq=2, ts=2.0, mono=2.0,
                                     values={"a": 2}))
    r.close()
    # Simulate the SIGKILL torn write: truncate mid final line.
    raw = open(path).read()
    open(path, "w").write(raw[:-9])
    rec = load_recording(path)
    assert rec.corrupt_lines == 1
    assert [s.seq for s in rec.snapshots] == [1]


def test_recorder_rejects_future_schema(tmp_path):
    path = os.path.join(str(tmp_path), "rec.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "header",
                            "v": SCHEMA_VERSION + 1}) + "\n")
    with pytest.raises(ValueError, match="newer than"):
        load_recording(path)


def test_recorder_rotation_is_bounded_and_self_describing(tmp_path):
    path = os.path.join(str(tmp_path), "rec.jsonl")
    r = SignalRecorder(path, fsync=False, max_bytes=2000, max_files=3)
    r.record_policy(PolicyConfig().to_dict())
    for i in range(200):
        r.record_snapshot(SignalSnapshot(
            seq=i + 1, ts=float(i), mono=float(i),
            values={"perf.goodput": 0.5, "pad": "x" * 40},
        ))
    r.close()
    assert r.stats()["rotations"] > 0
    # Bounded: live file + at most max_files-1 generations.
    gens = [p for p in os.listdir(str(tmp_path))
            if p.startswith("rec.jsonl")]
    assert len(gens) <= 3
    rec = load_recording(path)
    # Oldest generations were deleted but what remains is ordered,
    # contiguous, and still carries the policy (re-emitted on rotate).
    seqs = [s.seq for s in rec.snapshots]
    assert seqs == sorted(seqs)
    assert seqs[-1] == 200
    assert rec.policy_config is not None
    # The deleted beginning makes replay identity UNDECIDABLE: the
    # reader flags it, the assert refuses (naming truncation, not a
    # spurious divergence), and ranking downgrades to skipped.
    assert rec.truncated is True
    with pytest.raises(ReplayMismatch, match="truncated"):
        assert_replay_identity(rec)
    from dlrover_tpu_torch.autoscaler import rank_policies

    ranked = rank_policies(rec, [])
    assert ranked["identity"]["identical"] is None
    assert "truncated" in ranked["identity"]["skipped"]
    assert ranked["ranked"]  # still rankable


def test_recording_orders_by_mono_across_wall_steps(tmp_path):
    """An NTP step mid-run makes wall time jump BACKWARD; the reader
    must order by the monotonic stamp, not the wall one."""
    path = os.path.join(str(tmp_path), "rec.jsonl")
    r = SignalRecorder(path)
    r.record_snapshot(SignalSnapshot(seq=1, ts=1000.0, mono=10.0,
                                     values={"a": 1}))
    # Wall slews back 100s; mono keeps going.
    r.record_snapshot(SignalSnapshot(seq=2, ts=900.0, mono=11.0,
                                     values={"a": 2}))
    r.record_snapshot(SignalSnapshot(seq=3, ts=901.0, mono=12.0,
                                     values={"a": 3}))
    r.close()
    rec = load_recording(path)
    assert [s.seq for s in rec.snapshots] == [1, 2, 3]
    assert [s.values["a"] for s in rec.snapshots] == [1, 2, 3]


def test_recorder_survives_a_closed_handle(tmp_path):
    """A failed rotation can leave the file handle closed; the next
    write must reopen and keep recording (never ValueError the tick —
    'recording must never kill the loop')."""
    path = os.path.join(str(tmp_path), "rec.jsonl")
    r = SignalRecorder(path)
    r._f.close()  # noqa: SLF001 — simulate the failed-rotation state
    r.record_snapshot(SignalSnapshot(seq=1, ts=1.0, mono=1.0,
                                     values={"a": 1}))
    r.close()
    rec = load_recording(path)
    assert [s.seq for s in rec.snapshots] == [1]


def test_restarted_writer_keeps_only_the_newest_run(tmp_path):
    """A restarted master appends a second run (fresh header, mono
    clock reset from boot) onto the same path; the loader must NOT
    stitch the runs into one stream — identity would fail with a
    bogus divergence — but keep the newest run and count the rest."""
    path = os.path.join(str(tmp_path), "rec.jsonl")
    r1 = SignalRecorder(path)
    r1.record_policy(PolicyConfig(straggler_confirm_ticks=7).to_dict())
    r1.record_snapshot(SignalSnapshot(seq=1, ts=1000.0, mono=500.0,
                                      values={"run": 1}))
    r1.close()
    r2 = SignalRecorder(path)  # the restart: appends to the same file
    r2.record_policy(PolicyConfig(straggler_confirm_ticks=2).to_dict())
    # Monotonic clock restarted BELOW run 1's values.
    r2.record_snapshot(SignalSnapshot(seq=1, ts=2000.0, mono=3.0,
                                      values={"run": 2}))
    r2.record_snapshot(SignalSnapshot(seq=2, ts=2001.0, mono=4.0,
                                      values={"run": 2}))
    r2.close()
    rec = load_recording(path)
    assert rec.previous_runs == 1
    assert [s.values["run"] for s in rec.snapshots] == [2, 2]
    assert rec.policy_config["straggler_confirm_ticks"] == 2
    assert rec.truncated is False
    assert_replay_identity(rec)  # trivially identical, NOT a mismatch


def test_recorder_from_env(tmp_path, monkeypatch):
    path = os.path.join(str(tmp_path), "env.jsonl")
    monkeypatch.delenv(RECORD_ENV, raising=False)
    assert recorder_from_env() is None
    monkeypatch.setenv(RECORD_ENV, path)
    r = recorder_from_env()
    assert r is not None
    r.record_snapshot(SignalSnapshot(seq=1, ts=1.0, mono=1.0))
    r.close()
    assert len(load_recording(path).snapshots) == 1


def test_signal_bus_stamps_mono_pair():
    clock = FakeClock(500.0)
    bus = SignalBus(clock=clock)
    bus.add_source("a", lambda: {"x": 1})
    s = bus.sample()
    # Injected fake clock drives BOTH stamps coherently.
    assert s.ts == 500.0 and s.mono == 500.0


# ---------------------------------------------------------------------------
# Outcome attribution
# ---------------------------------------------------------------------------


def test_evict_outcome_attributed_with_score_drop(tmp_path):
    clock = FakeClock()

    def feed(i):
        if 1 <= i <= 3:
            return {"straggler_ranks": [3],
                    "straggler_scores": {3: 3.0},
                    "median_step_s": 0.01, "goodput": 0.4}
        return {"goodput": 0.7, "straggler_ranks": [],
                "straggler_scores": {}}

    scaler, _ = _scripted_scaler(clock, tmp_path, feed, window=0.5)
    for _ in range(6):
        scaler.tick()
        clock.advance(0.3)
    entry = scaler.ledger.entries()[0]
    assert entry.action == EVICT_STRAGGLER
    assert entry.realized is not None
    r = entry.realized
    assert r["straggler_score_before"] == 3.0
    assert r["straggler_score_after"] == 1.0
    assert r["straggler_cleared"] is True
    assert r["effect"] == pytest.approx(2.0)
    assert r["verdict"] == "improved"
    assert r["goodput_delta"] == pytest.approx(0.3)
    assert scaler.ledger.outcomes_total == 1
    # Exported as autoscaler_decision_outcome_* metrics.
    from dlrover_tpu_torch.observability.registry import default_registry

    reg = default_registry()
    assert reg.get("autoscaler_decision_outcome_total").value(
        action=EVICT_STRAGGLER, verdict="improved"
    ) >= 1
    assert reg.get("autoscaler_decision_outcome_effect").value(
        action=EVICT_STRAGGLER
    ) == pytest.approx(2.0)


def test_fleet_outcome_measures_backlog_drain(tmp_path):
    clock = FakeClock()
    queue = {"v": 40.0}

    def feed(i):
        return {"goodput": 0.5}

    def fleet_source():
        return {"replicas": 2, "slot_util": 0.97 if queue["v"] else 0.2,
                "queue_depth": queue["v"]}

    bus = (
        SignalBus(clock=clock)
        .add_source("perf", feed)
        .add_source("fleet", fleet_source)
    )

    def grow(decision):
        queue["v"] = 0.0  # the added replica drains the backlog

    scaler = AutoScaler(
        bus,
        policy=RulePolicy(PolicyConfig(
            max_replicas=4, fleet_confirm_ticks=1, fleet_cooldown_s=9.0,
        )),
        actuators={GROW_FLEET: grow},
        clock=clock,
        attribution_window_s=1.0,
    )
    for _ in range(5):
        scaler.tick()
        clock.advance(0.5)
    entry = scaler.ledger.entries()[0]
    assert entry.action == GROW_FLEET
    r = entry.realized
    assert r is not None
    assert r["queue_before"] == 40.0 and r["queue_after"] == 0.0
    assert r["backlog_drain_per_s"] > 0
    assert r["verdict"] == "improved"


def test_ckpt_outcome_estimates_avoided_replay(tmp_path):
    clock = FakeClock()
    interval = {"v": 10.0}

    def perf():
        return {"goodput": 0.5}

    def fault():
        return {"mtbf_s": 60.0}

    def ckpt():
        return {"interval_s": interval["v"], "save_block_s": 0.01}

    bus = (
        SignalBus(clock=clock)
        .add_source("perf", perf)
        .add_source("fault", fault)
        .add_source("ckpt", ckpt)
    )
    scaler = AutoScaler(
        bus,
        policy=RulePolicy(PolicyConfig(
            ckpt_min_interval_s=0.1, ckpt_cooldown_s=100.0,
        )),
        actuators={
            SET_CKPT_INTERVAL: lambda d: interval.update(
                v=float(d.target)
            )
        },
        clock=clock,
        attribution_window_s=0.5,
    )
    for _ in range(4):
        scaler.tick()
        clock.advance(0.3)
    entry = scaler.ledger.entries()[0]
    assert entry.action == SET_CKPT_INTERVAL
    new = float(entry.target)
    assert new < 10.0  # Young/Daly pulls the cadence down at MTBF 60
    r = entry.realized
    assert r is not None
    # (old - new)/2 replay seconds avoided per failure, 60 fail/h.
    assert r["avoided_replay_s_per_hour"] == pytest.approx(
        (10.0 - new) / 2.0 * 60.0, rel=1e-3
    )
    assert r["extra_save_s_per_hour"] > 0
    assert r["est_net_saved_s_per_hour"] == pytest.approx(
        r["avoided_replay_s_per_hour"] - r["extra_save_s_per_hour"],
        rel=1e-6,
    )
    assert r["verdict"] == "improved"


def test_stop_force_resolves_pending_windows(tmp_path):
    clock = FakeClock()

    def feed(i):
        return {"straggler_ranks": [1], "straggler_scores": {1: 2.0},
                "median_step_s": 0.01, "goodput": 0.5}

    scaler, _ = _scripted_scaler(clock, tmp_path, feed, window=100.0)
    scaler.tick()
    clock.advance(0.1)
    scaler.tick()
    assert scaler.ledger.entries()[0].realized is None
    scaler.stop()
    r = scaler.ledger.entries()[0].realized
    assert r is not None
    assert r["window_truncated"] is True


# ---------------------------------------------------------------------------
# DecisionLedger: bounded-eviction backfill + entries() boundaries
# ---------------------------------------------------------------------------


def test_outcome_backfill_on_evicted_entry_is_counted_noop():
    ledger = DecisionLedger(maxlen=2)
    for i in range(3):
        ledger.append(ScaleDecision(
            action="grow_fleet", target=i, reason="t",
        ))
    # seq 1 was evicted by the bound; backfill must be a counted no-op.
    assert ledger.attach_outcome(1, {"verdict": "improved"}) is False
    assert ledger.outcome_misses_total == 1
    assert ledger.outcomes_total == 0
    # A live entry still attaches.
    assert ledger.attach_outcome(3, {"verdict": "neutral"}) is True
    assert ledger.outcomes_total == 1
    assert ledger.entries()[-1].realized == {"verdict": "neutral"}
    # A never-issued future seq is also a counted no-op.
    assert ledger.attach_outcome(99, {}) is False
    assert ledger.outcome_misses_total == 2


def test_ledger_entries_last_and_offset_boundaries():
    ledger = DecisionLedger(maxlen=10)
    for i in range(5):
        ledger.append(ScaleDecision(action="a", target=i, reason="t"))
    seqs = [d.seq for d in ledger.entries()]
    assert seqs == [1, 2, 3, 4, 5]
    # last=0 keeps the historical "falsy = everything" contract.
    assert [d.seq for d in ledger.entries(last=0)] == seqs
    assert [d.seq for d in ledger.entries(last=2)] == [4, 5]
    # last beyond the bound returns everything, no wraparound.
    assert [d.seq for d in ledger.entries(last=99)] == seqs
    # offset pages backward through history.
    assert [d.seq for d in ledger.entries(last=2, offset=2)] == [2, 3]
    assert [d.seq for d in ledger.entries(offset=4)] == [1]
    # offset at/beyond the length is empty, not an error.
    assert ledger.entries(offset=5) == []
    assert ledger.entries(last=3, offset=99) == []


# ---------------------------------------------------------------------------
# Replay: identity, divergence, scoring
# ---------------------------------------------------------------------------


def _flag_snap(seq, ts, rank=2, score=2.5, extra=None):
    values = {
        "perf.straggler_ranks": [rank],
        "perf.straggler_scores": {rank: score},
        "perf.median_step_s": 0.01,
    }
    values.update(extra or {})
    return SignalSnapshot(seq=seq, ts=ts, mono=ts, values=values)


def test_replay_identity_and_perturbed_divergence(tmp_path):
    clock = FakeClock()

    def feed(i):
        if 1 <= i <= 6:
            return {"straggler_ranks": [2],
                    "straggler_scores": {2: 2.5},
                    "median_step_s": 0.01}
        return {}

    scaler, path = _scripted_scaler(
        clock, tmp_path, feed,
        config=PolicyConfig(straggler_confirm_ticks=2,
                            evict_cooldown_s=0.5),
    )
    for _ in range(9):
        scaler.tick()
        clock.advance(0.3)
    scaler.stop()
    recording = load_recording(path)
    assert len(recording.decisions) >= 2
    diff = assert_replay_identity(recording)
    assert diff["identical"] and diff["matched"] >= 2
    # A perturbed config must produce a DIFFERENT counterfactual.
    perturbed = replay_recording(
        recording, PolicyConfig(straggler_confirm_ticks=10_000)
    )
    d = diff_ledgers(recording.decisions, perturbed)
    assert not d["identical"]
    assert d["first_divergence"]["index"] == 0
    assert d["replayed_total"] == 0


def test_replay_mismatch_raises_with_divergence():
    rec = Recording(
        policy_config=PolicyConfig(
            straggler_confirm_ticks=10_000
        ).to_dict(),
        snapshots=[_flag_snap(i + 1, 100.0 + i) for i in range(4)],
        decisions=[{
            "action": EVICT_STRAGGLER, "target": 2, "ts": 101.0,
            "mono": 101.0, "seq": 1,
        }],
    )
    # The recorded config can never evict, yet the ledger says it did:
    # a forged/stale recording must FAIL identity loudly.
    with pytest.raises(ReplayMismatch, match="diverged"):
        assert_replay_identity(rec)


def test_replay_is_deterministic_and_clockless():
    snaps = [_flag_snap(i + 1, 50.0 + 0.5 * i) for i in range(8)]
    cfg = PolicyConfig(straggler_confirm_ticks=3, evict_cooldown_s=1.0)
    a = replay_policy(snaps, cfg)
    b = replay_policy(snaps, cfg)
    assert [(d.action, d.target, d.ts) for d in a] == \
        [(d.action, d.target, d.ts) for d in b]
    assert a, "expected at least one decision"


def test_score_ledger_charges_straggler_tax_until_eviction():
    # 10 snapshots 1s apart, rank 2 flagged at 2.0x throughout.
    snaps = [_flag_snap(i + 1, float(i), score=2.0) for i in range(10)]
    cost = CostModel(evict_pause_s=0.2, rescale_to_first_step_s=0.2)
    early = [ScaleDecision(action=EVICT_STRAGGLER, target=2,
                           reason="t", ts=1.0, mono=1.0)]
    late = [ScaleDecision(action=EVICT_STRAGGLER, target=2,
                          reason="t", ts=8.0, mono=8.0)]
    never = []
    s_early = score_ledger(snaps, early, cost)
    s_late = score_ledger(snaps, late, cost)
    s_never = score_ledger(snaps, never, cost)
    # Tax accrues at (1 - 1/score) = 0.5 per flagged-unmitigated sec.
    assert s_early["straggler_tax_s"] < s_late["straggler_tax_s"]
    assert s_late["straggler_tax_s"] < s_never["straggler_tax_s"]
    assert s_never["straggler_tax_s"] == pytest.approx(4.5)
    assert (s_early["est_goodput_frac"] > s_late["est_goodput_frac"]
            > s_never["est_goodput_frac"])
    # Never-evict pays no actuation cost; the tax still dominates.
    assert s_never["actuation_cost_s"] == 0.0


def test_score_ledger_replay_exposure_follows_interval_trajectory():
    def snap(seq, ts, failures):
        return SignalSnapshot(seq=seq, ts=ts, mono=ts, values={
            "ckpt.interval_s": 10.0,
            "ckpt.save_block_s": 0.01,
            "fault.failures_total": failures,
        })

    snaps = [snap(1, 0.0, 0), snap(2, 10.0, 1), snap(3, 20.0, 1),
             snap(4, 30.0, 2)]
    cost = CostModel(rescale_to_first_step_s=0.5, save_block_s=0.01)
    # No retune: both failures charged at interval 10 -> 5s each.
    base = score_ledger(snaps, [], cost)
    assert base["failures_seen"] == 2
    assert base["replay_exposure_s"] == pytest.approx(
        2 * (5.0 + 0.5)
    )
    # A retune to 2s before the second failure halves its exposure.
    retuned = score_ledger(snaps, [ScaleDecision(
        action=SET_CKPT_INTERVAL, target=2.0, reason="t",
        ts=15.0, mono=15.0,
    )], cost)
    assert retuned["replay_exposure_s"] == pytest.approx(
        (5.0 + 0.5) + (1.0 + 0.5)
    )
    # ...at the price of more save overhead along the tail.
    assert retuned["save_overhead_s"] > base["save_overhead_s"]


def test_whatif_tool_ranks_candidates_on_synthetic_recording(tmp_path):
    """A synthetic 50-snapshot recording through
    tools/torch_whatif.py end to end; the cost model is the default
    one unless the caller names a bench artifact."""
    import sys

    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tools",
    ))
    import torch_whatif as whatif

    path = os.path.join(str(tmp_path), "synth.jsonl")
    synth = whatif.synthesize_recording(path, snapshots=50)
    assert synth["snapshots"] == 50
    assert synth["decisions"] >= 1
    result = whatif.rank_recording(path)
    assert result["identity"]["identical"] is True
    assert result["candidates"] == 7  # recorded + 6 built-ins
    assert result["replay_snapshots_per_s"] > 0
    names = [c["name"] for c in result["ranked"]]
    assert "recorded" in names and "never-evict" in names
    for cand in result["ranked"]:
        assert 0.0 <= cand["est_goodput_frac"] <= 1.0
    # Ranked best-first.
    fracs = [c["est_goodput_frac"] for c in result["ranked"]]
    assert fracs == sorted(fracs, reverse=True)
    assert all(c["score"]["cost_model"] == CostModel().to_dict()
               for c in result["ranked"])
    bench = os.path.join(str(tmp_path), "bench.json")
    with open(bench, "w") as f:
        json.dump({"rescale_to_first_step_s": 2.5}, f)
    calibrated = whatif.rank_recording(path, bench_artifacts=[bench])
    cost = calibrated["ranked"][0]["score"]["cost_model"]
    assert cost["rescale_to_first_step_s"] == cost["evict_pause_s"] == 2.5


# ---------------------------------------------------------------------------
# Per-cause goodput attribution + /api/goodput
# ---------------------------------------------------------------------------


def test_perf_monitor_attributes_lost_time_by_cause():
    from dlrover_tpu_torch.common.constants import GoodputPhase
    from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor

    perf = PerfMonitor()
    t0 = perf._init_time  # noqa: SLF001 — anchor the synthetic ledger
    for node in (0, 1):
        perf.collect_phase(node, GoodputPhase.TRAIN, t0, t0 + 6.0)
        perf.collect_phase(node, GoodputPhase.CKPT, t0 + 6.0, t0 + 7.0)
        perf.collect_phase(node, GoodputPhase.RESTART, t0 + 7.0,
                           t0 + 8.0)  # implied cause: rescale
        perf.collect_phase(node, "stall", t0 + 8.0, t0 + 9.0,
                           cause="straggler")
        # An unknown cause coerces to the single residual bucket.
        perf.collect_phase(node, "mystery", t0 + 9.0, t0 + 9.5,
                           cause="cosmic-rays")
    att = perf.goodput_attribution()
    assert att["nodes"] == 2
    assert att["train_frac"] == pytest.approx(6.0 / 9.5, rel=1e-3)
    causes = att["causes"]
    assert causes["ckpt"]["seconds"] == pytest.approx(1.0)
    assert causes["rescale"]["seconds"] == pytest.approx(1.0)
    assert causes["straggler"]["seconds"] == pytest.approx(1.0)
    assert causes["hang"]["seconds"] == 0.0
    assert causes["shed"]["seconds"] == 0.0
    assert att["unattributed_frac"] == pytest.approx(
        0.5 / 9.5, rel=1e-2
    )
    assert att["attributed_frac"] == pytest.approx(
        3.0 / 3.5, rel=1e-2
    )
    basis = perf.goodput_basis()
    assert basis["averaging"] == "per_node_train_fraction_mean"
    assert basis["nodes_reporting"] == 2
    # The phase records carry the cause for the timeline merger.
    records = perf.phase_records()["records"]
    assert any(r.get("cause") == "straggler" for r in records)
    assert any(r.get("cause") == "unattributed" for r in records)
    assert all("cause" not in r for r in records
               if r["phase"] == GoodputPhase.TRAIN)


def test_trace_merge_emits_lost_by_cause_lane():
    from dlrover_tpu_torch.observability.trace_merge import (
        merge_job_timeline,
        phases_to_trace,
    )

    phases = {
        "init_time": 100.0,
        "max_phase_end": 110.0,
        "records": [
            {"node_id": 0, "phase": "train", "start": 100.0,
             "end": 106.0},
            {"node_id": 0, "phase": "ckpt", "start": 106.0,
             "end": 107.0, "cause": "ckpt"},
            {"node_id": 0, "phase": "stall", "start": 107.0,
             "end": 110.0, "cause": "straggler"},
        ],
    }
    events = phases_to_trace(phases)
    counters = [e for e in events if e.get("name") == "lost_by_cause"]
    assert counters
    assert counters[-1]["args"] == {"ckpt": 1.0, "straggler": 3.0}
    merged = merge_job_timeline(phases=phases)
    assert merged["metadata"]["lost_seconds_by_cause"] == {
        "ckpt": 1.0, "straggler": 3.0,
    }
