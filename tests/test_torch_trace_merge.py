"""The port's job timeline merger (``observability/trace_merge.py``) and
its CLI (``tools/torch_merge_timeline.py``) against the JAX package's:
equal inputs (training events, tpu_timer traces with and without a
clock anchor, flight-recorder dumps, the master's goodput phase ledger,
made from a seed with numpy) give equal chrome events, an equal merged
trace and equal goodput; the reconstruction agrees with the port's
``PerfMonitor``; ``validate_merged`` flags the same problems."""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dlrover_tpu.observability import trace_merge as ref
from dlrover_tpu_torch.common.constants import GoodputPhase
from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor
from dlrover_tpu_torch.observability import trace_merge

REPO = Path(__file__).resolve().parents[1]


def _events(seed, n=30):
    rs = np.random.RandomState(seed)
    out, open_ids = [], []
    t = 1_700_000_000.0
    for i in range(n):
        t += float(rs.rand() * 3)
        kind = rs.randint(4)
        target = ["agent", "master", "trainer/0", "saver"][rs.randint(4)]
        if kind == 0 or not open_ids and kind == 1:
            eid = f"77-{i}"
            open_ids.append((eid, target))
            out.append({"name": f"span{i % 3}", "type": "begin",
                        "target": target, "event_id": eid, "ts": t,
                        "pid": 77, "content": {}})
        elif kind == 1:
            eid, target = open_ids.pop(0)
            out.append({"name": "span", "type": "end", "target": target,
                        "event_id": eid, "ts": t, "pid": 77,
                        "content": {"success": True}})
        elif kind == 2:
            out.append({"name": "ckpt", "type": "end", "target": target,
                        "event_id": "", "ts": t, "pid": 78,
                        "content": {"duration_s": 1.5}})
        else:
            out.append({"name": "failure", "type": "instant",
                        "target": target, "ts": t, "pid": 79,
                        "content": {"rank": int(rs.randint(4))}})
    return out


def _rank_trace(seed, anchored):
    rs = np.random.RandomState(seed)
    trace = {"traceEvents": [
        {"name": f"xla/k{rs.randint(5)}", "ph": "X",
         "ts": 5e9 + float(rs.randint(0, 10**6)),
         "dur": float(rs.randint(1, 900)), "pid": 1, "tid": 3,
         "args": {"kind": 9}} for _ in range(20)]}
    if anchored:
        trace["clock_sync"] = {"epoch_minus_mono_us": 1.69e15,
                               "fetched_at": 1.7e9}
    return trace


def _flight(seed):
    rs = np.random.RandomState(seed)
    steps = []
    for s in range(1, 8):
        rec = {"step": s, "ts": 1.7e9 + s, "step_time_s": 0.9,
               "data_wait_s": float(rs.rand() * 0.2)}
        if s % 3 == 0:
            rec["ckpt_block_s"] = 0.1
        steps.append(rec)
    steps.append({"event": "restore", "ts": 1.7e9 + 9, "seconds": 0.4})
    return {"steps": steps, "meta": {"process_id": 1}}


def _perf(seed):
    rs = np.random.RandomState(seed)
    perf = PerfMonitor()
    t0 = perf.phase_records()["init_time"]
    for node in range(2):
        t = t0 + float(rs.rand())
        for _ in range(6):
            phase = [GoodputPhase.TRAIN, GoodputPhase.CKPT,
                     GoodputPhase.RESTART][rs.randint(3)]
            dur = float(rs.rand() * 10 + 0.5)
            perf.collect_phase(node, phase, t, t + dur)
            t += dur
    return perf


@pytest.mark.parametrize("seed", [0, 1])
def test_pieces_match_the_reference(seed):
    events = _events(seed)
    assert trace_merge.events_to_trace(events) == ref.events_to_trace(events)
    for anchored in (True, False):
        trace = _rank_trace(seed, anchored)
        assert trace_merge.align_trace_events(trace, 2) == \
            ref.align_trace_events(trace, 2)
    dump = _flight(seed)
    assert trace_merge.flight_to_trace(dump, 1) == ref.flight_to_trace(dump,
                                                                       1)
    phases = _perf(seed).phase_records()
    assert trace_merge.phases_to_trace(phases) == ref.phases_to_trace(phases)
    assert trace_merge.reconstruct_goodput(phases) == \
        ref.reconstruct_goodput(phases)


@pytest.mark.parametrize("seed", [2, 3])
def test_merge_matches_the_reference(tmp_path, seed):
    path = tmp_path / "events.jsonl"
    path.write_text("\n".join(json.dumps(e) for e in _events(seed))
                    + "\nnot json\n")
    kwargs = dict(
        event_files=[str(path), str(tmp_path / "missing.jsonl")],
        rank_traces={0: _rank_trace(seed, True),
                     1: _rank_trace(seed + 1, False)},
        flight_dumps={1: _flight(seed)},
        phases=_perf(seed).phase_records())
    got = trace_merge.merge_job_timeline(**kwargs)
    assert got == ref.merge_job_timeline(**kwargs)
    assert trace_merge.validate_merged(got) == [] == ref.validate_merged(got)
    assert got["metadata"]["ranks"] == [0, 1]


def test_reconstructed_goodput_matches_the_perf_monitor():
    perf = _perf(5)
    assert trace_merge.reconstruct_goodput(perf.phase_records()) == \
        pytest.approx(perf.goodput(), rel=1e-9)


@pytest.mark.parametrize("trace", [
    {},
    {"traceEvents": [{"ph": "Q"}]},
    {"traceEvents": [{"ph": "X", "ts": "a", "pid": 1}]},
    {"traceEvents": [{"ph": "i", "ts": 1.0}]},
    {"traceEvents": [{"ph": "X", "ts": 1.0, "dur": 1.0, "pid": 1,
                      "args": {"x": object()}}]},
])
def test_validation_flags_the_same_problems(trace):
    got = trace_merge.validate_merged(trace)
    assert got and len(got) == len(ref.validate_merged(trace))


def test_merge_cli_matches_the_reference_tool(tmp_path):
    """Both CLIs on the same files write the same merged trace and print
    the same goodput; ``--expect-goodput`` fails (exit 4) on a wrong
    expectation."""
    events = tmp_path / "events.jsonl"
    events.write_text("\n".join(json.dumps(e) for e in _events(7)))
    trace0 = tmp_path / "rank0.json"
    trace0.write_text(json.dumps(_rank_trace(7, True)))
    flight = tmp_path / "flight.json"
    flight.write_text(json.dumps(_flight(7)))
    phases = tmp_path / "phases.json"
    phases.write_text(json.dumps(_perf(7).phase_records()))
    outs = {}
    for tool in ("torch_merge_timeline.py", "merge_timeline.py"):
        out = tmp_path / f"{tool}.out.json"
        proc = subprocess.run(
            [sys.executable, str(REPO / "tools" / tool), "--events",
             str(events), "--trace", str(trace0), "--flight", str(flight),
             "--phases", str(phases), "--out", str(out)],
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs[tool] = (json.loads(out.read_text()),
                      proc.stdout.splitlines()[-1])
    assert outs["torch_merge_timeline.py"] == outs["merge_timeline.py"]
    assert outs["merge_timeline.py"][1].startswith("reconstructed goodput")
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "torch_merge_timeline.py"),
         "--phases", str(phases), "--expect-goodput", "0.0001",
         "--out", str(tmp_path / "x.json")],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 4
