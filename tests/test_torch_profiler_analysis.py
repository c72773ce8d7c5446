"""The port's profiler analysis (``tpu_timer/analysis.py``) against the
JAX package's: the timeline summary, the run-over-run diff, the stack
parsing and folding, the clock-offset estimate and the cross-rank merge
return equal results on equal inputs (traces made from a seed with
numpy); the CLIs; and the GEMM sweep on the CPU, whose TFLOP/s is not
asserted (a loaded host makes any floor flaky)."""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import json

import numpy as np
import pytest

from dlrover_tpu.tpu_timer import analysis as ref
from dlrover_tpu_torch.tpu_timer import analysis

_NAMES = ["xla/fusion.1", "xla/all-reduce.2", "xla/flash_fwd_kernel",
          "xla/ncclDevKernel_AllGather_RING", "xla_host/cudaLaunchKernel",
          "train_step", "py_gc_gen0", "xla/reduce-scatter.9"]


def _trace(seed, n=80, skew_us=0.0):
    rs = np.random.RandomState(seed)
    events = [{"name": "xla_capture", "ph": "X", "ts": 0.0, "dur": 5000.0,
               "pid": 1, "tid": 1}]
    for _ in range(n):
        events.append({
            "name": _NAMES[rs.randint(len(_NAMES))], "ph": "X",
            "ts": float(rs.randint(0, 6000)) + skew_us,
            "dur": float(rs.randint(1, 400)), "pid": 1,
            "tid": int(rs.randint(1, 4)),
            "args": {"kind": 9, "flops": 0}})
    events.append({"name": "meta", "ph": "M", "pid": 1})
    return {"traceEvents": events}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_summary_and_diff_match_the_reference(seed):
    base, other = _trace(seed), _trace(seed + 10)
    assert analysis.summarize_timeline(base) == ref.summarize_timeline(base)
    assert analysis.diff_timelines(base, other) == ref.diff_timelines(
        base, other)
    summary = analysis.summarize_timeline(base)
    assert summary["device_busy_fraction"] > 0
    assert summary["collective_us"] > 0


def _collective_traces(seed, ranks=3):
    """Ranks whose collectives end together up to a per-rank clock skew;
    the last rank arrives late to each."""
    rs = np.random.RandomState(seed)
    skews = {r: float(rs.randint(-500, 500)) if r else 0.0
             for r in range(ranks)}
    traces = {}
    for r in range(ranks):
        events = []
        for k in range(6):
            end = 10_000.0 * (k + 1)
            start = end - (300.0 if r == ranks - 1 else 900.0 + 10 * r)
            events.append({"name": "xla/all-reduce.1", "ph": "X",
                           "ts": start + skews[r], "dur": end - start,
                           "pid": 0, "tid": 1})
        events.append({"name": "xla/fusion.2", "ph": "X",
                       "ts": 5.0 + skews[r], "dur": 3.0, "pid": 0,
                       "tid": 1})
        traces[r] = {"traceEvents": events}
    return traces, skews


@pytest.mark.parametrize("seed", [3, 4])
def test_clock_offsets_and_merge_match_the_reference(seed):
    traces, skews = _collective_traces(seed)
    offsets = analysis.estimate_clock_offsets(traces)
    assert offsets == ref.estimate_clock_offsets(traces)
    assert all(abs(offsets[r] - skews[r]) < 1e-6 for r in traces)
    merged, report = analysis.merge_rank_traces(traces)
    assert (merged, report) == ref.merge_rank_traces(traces)
    row = report["xla/all-reduce.1"]
    assert row["straggler_rank"] == 2 and row["straggler_share"] == 1.0


_DUMP = (
    "noise\nThread 0x00007f0000000002 (most recent call first):\n"
    '  File "/w/a.py", line 3 in inner\n'
    '  File "/w/a.py", line 9 in outer\n\n'
    "Current thread 0x00007f0000000001 (most recent call first):\n"
    '  File "/w/b.py", line 1 in wait\n'
    '  File "/w/b.py", line 2 in main\n'
)


def test_stack_parsing_and_folding_match_the_reference():
    stacks = analysis.parse_faulthandler_dumps(_DUMP * 2)
    assert stacks == ref.parse_faulthandler_dumps(_DUMP * 2)
    assert analysis.fold_stacks(stacks) == ref.fold_stacks(stacks)
    assert analysis.top_frames(stacks, k=1) == ref.top_frames(stacks, k=1)
    assert stacks[0] == ["outer (a.py:9)", "inner (a.py:3)"]


def test_timeline_diff_and_stacks_clis(tmp_path, capsys):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps(_trace(5)))
    b.write_text(json.dumps(_trace(6)))
    assert analysis.main(["timeline", str(a), "--top", "3"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert len(report["names"]) == 3
    assert analysis.main(["diff", str(a), str(b), "--top", "2"]) == 0
    assert len(json.loads(capsys.readouterr().out)["rows"]) == 2
    log = tmp_path / "w.log"
    log.write_text(_DUMP)
    assert analysis.main(["stacks", str(log)]) == 0
    assert "2 thread stacks" in capsys.readouterr().out
    empty = tmp_path / "empty.log"
    empty.write_text("nothing here\n")
    assert analysis.main(["stacks", str(empty)]) == 1


def test_merge_cli_roundtrip(tmp_path, capsys):
    traces, _ = _collective_traces(7)
    paths = []
    for r, t in traces.items():
        p = tmp_path / f"rank{r}.json"
        p.write_text(json.dumps(t))
        paths.append(str(p))
    out = tmp_path / "merged.json"
    assert analysis.main(["merge", *paths, "--out", str(out)]) == 0
    merged = json.loads(out.read_text())
    assert merged == json.loads(json.dumps(
        ref.merge_rank_traces(traces)[0]))
    assert "straggler rank 2" in capsys.readouterr().out


def test_matmul_sweep_runs_on_the_cpu(capsys):
    rows = analysis.matmul_analysis([32, 64], iters=2, device="cpu")
    assert [r["size"] for r in rows] == [32, 64]
    for r in rows:
        assert set(r) == {"size", "ms", "tflops", "efficiency_pct", "device"}
        assert r["device"] == "cpu" and r["efficiency_pct"] is None
    assert analysis.main(["matmul", "--sizes", "32", "--iters", "1",
                          "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["size"] == 32
    assert analysis.device_peak_bf16("NVIDIA H100 80GB HBM3") == 989e12
    assert analysis.device_peak_bf16("cpu") == 0.0
