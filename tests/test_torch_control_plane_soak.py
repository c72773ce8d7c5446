"""The master's saturation harness on the port
(``dlrover_tpu_torch/testing/control_plane_soak.py``, its bench
``tools/torch_bench_control_plane.py``), on the CPU.

- the reference's smoke (``tests/test_control_plane.py``): 64 sim
  workers through the ramp, quorum at worlds 8 and 64, and the shed
  phase, with its three invariants and thresholds; its 1k ramp is
  ``slow``, as the reference's;
- the server span's finish path (the tracer's lock, its on_finish
  hooks) runs on the tracer's finisher thread: the reply does not wait
  for it and ``master_rpc_seconds`` does not hold it. On the RPC thread
  it held up to a sixth of a fast verb's window, past the harness's
  15% metric/span agreement at 1024 workers;
- the agreement check still fails on a metric that drifts from its
  spans;
- an RPC on a keep-alive HTTP connection does not wait for the
  client's delayed ACK (TCP_NODELAY on the server's connections). With
  Nagle on, each took about 40 ms, and the smoke's 0.4 s shed window
  under load held no diagnostic RPC at all;
- the bench tool's ``--fast`` line.
"""

import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.observability import tracing

REPO = Path(__file__).resolve().parents[1]


def _smoke_cfg(**overrides):
    from dlrover_tpu_torch.testing.control_plane_soak import (
        ControlPlaneSoakConfig,
    )

    base = dict(
        workers=64, driver_threads=4, stage_duration_s=0.4,
        max_stages=2, quorum_worlds=(8, 64), shed_duration_s=0.4,
    )
    base.update(overrides)
    return ControlPlaneSoakConfig(**base)


def test_control_plane_soak_smoke_64_workers():
    """Fast lane: the full harness — ramp, quorum at {8, 64}, shed —
    with all three invariants, in seconds."""
    from dlrover_tpu_torch.testing.control_plane_soak import (
        run_control_plane_soak,
    )

    rep = run_control_plane_soak(_smoke_cfg())
    assert rep["invariants"] == "pass"
    assert rep["max_sustainable_rps"] > 0
    assert rep["cpu_s_per_1k_rpcs"] > 0
    assert rep["quorum"]["8"]["time_to_quorum_s"] > 0
    assert rep["quorum"]["64"]["time_to_quorum_s"] > 0
    assert rep["shed"]["shed_diagnostic"] > 0
    assert rep["shed"]["lease_rpcs_during_shed"] > 0
    assert rep["shed"]["client_errors"] == 0
    for stats in rep["buffers"].values():
        assert "occupancy" in stats and "drops" in stats
    agree = rep["metric_span_agreement"]
    assert agree["verbs_checked"] >= 1
    assert agree["worst_rel_diff"] <= 0.15


@pytest.mark.slow
def test_control_plane_soak_1k_worker_ramp():
    """Slow lane: 1024 sim workers, quorum swept to world 1024 — the
    acceptance configuration of the bench phase."""
    from dlrover_tpu_torch.testing.control_plane_soak import (
        run_control_plane_soak,
    )

    rep = run_control_plane_soak(_smoke_cfg(
        workers=1024, driver_threads=16, stage_duration_s=1.0,
        max_stages=5, quorum_worlds=(8, 64, 256, 1024),
        shed_duration_s=0.8,
    ))
    assert rep["invariants"] == "pass"
    assert rep["quorum"]["1024"]["time_to_quorum_s"] > 0
    # Quorum time grows with world size but stays bounded: the full
    # 1024-rank world must form well inside the join timeout.
    assert (
        rep["quorum"]["1024"]["time_to_quorum_s"]
        > rep["quorum"]["8"]["time_to_quorum_s"]
    )
    assert rep["quorum"]["1024"]["time_to_quorum_s"] < 30.0


def test_server_span_finish_path_runs_off_the_rpc_thread():
    """A tracer whose on_finish hook takes 20 ms: ten RPCs return
    without waiting for it, the hook runs on another thread, and
    ``master_rpc_seconds`` holds none of its time."""
    durations = {}
    hook_threads = set()

    def slow_finish(record):
        hook_threads.add(threading.get_ident())
        if record["name"].startswith("master."):
            verb = record["name"][len("master."):]
            durations.setdefault(verb, []).append(record["dur_s"])
        time.sleep(0.02)

    servicer = MasterServicer(rdzv_managers={})
    seconds = servicer.telemetry.seconds
    verb = "KVStoreSetRequest"
    before = (seconds.count(verb=verb), seconds.sum(verb=verb))
    prior = tracing.active_tracer()
    tracing.arm(tracing.Tracer(service="master", on_finish=slow_finish))
    try:
        t0 = time.monotonic()
        for i in range(10):
            servicer.report(comm.Message(
                node_id=0, data=comm.KVStoreSetRequest(
                    key=f"k{i}", value=b"v").serialize()))
        calls_s = time.monotonic() - t0
        deadline = time.monotonic() + 5.0
        while (len(durations.get(verb, ())) < 10
               and time.monotonic() < deadline):
            time.sleep(0.01)
    finally:
        tracing.disarm()
        if prior is not None:
            tracing.arm(prior)
    n = seconds.count(verb=verb) - before[0]
    metric_mean = (seconds.sum(verb=verb) - before[1]) / n
    spans = durations[verb]
    span_mean = sum(spans) / len(spans)
    assert n == len(spans) == 10
    assert calls_s < 0.1
    assert threading.get_ident() not in hook_threads
    # The metric's window holds the span's and ends after it.
    assert span_mean <= metric_mean < span_mean + 0.02


class _Seconds:
    def __init__(self, count, total):
        self._count, self._total = count, total

    def count(self, verb):
        return self._count

    def sum(self, verb):
        return self._total


@pytest.mark.parametrize("metric_s,fails", [(1.1e-3, False),
                                            (1.2e-3, True)])
def test_metric_span_agreement_check_fails_on_drift(metric_s, fails):
    """Spans of 1 ms against a metric mean of 1.1 ms (10%) pass, of
    1.2 ms (20%) raise."""
    from dlrover_tpu_torch.testing.control_plane_soak import (
        ControlPlaneInvariantError,
        _check_metric_span_agreement,
        _SpanAgg,
    )

    agg = _SpanAgg()
    for _ in range(60):
        agg({"name": "master.KVStoreSetRequest", "dur_s": 1e-3})
    master = SimpleNamespace(
        span_agg=agg, seconds_baseline={},
        servicer=SimpleNamespace(telemetry=SimpleNamespace(
            seconds=_Seconds(60, 60 * metric_s))))
    cfg = _smoke_cfg()
    if fails:
        with pytest.raises(ControlPlaneInvariantError, match="differ"):
            _check_metric_span_agreement(master, cfg)
    else:
        rep = _check_metric_span_agreement(master, cfg)
        assert rep["verbs_checked"] == 1
        assert rep["worst_rel_diff"] == pytest.approx(0.1)


def test_keep_alive_rpc_does_not_wait_for_a_delayed_ack():
    """Thirty RPCs in a row over one keep-alive HTTP connection: the
    median takes well under the 40 ms a delayed ACK costs."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.rpc.transport import HttpMasterServer

    server = HttpMasterServer(0, MasterServicer(rdzv_managers={}))
    server.start()
    client = MasterClient(f"localhost:{server.port}", node_id=0,
                          kind="http", timeout=10.0)
    try:
        lat = []
        for i in range(30):
            t0 = time.monotonic()
            client.kv_store_set(f"k{i}", b"v")
            lat.append(time.monotonic() - t0)
    finally:
        client.close()
        server.stop()
    assert statistics.median(lat) < 0.02, lat


def test_bench_tool_prints_its_line():
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "torch_bench_control_plane.py"),
         "--fast"],
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["invariants"] == "pass" and out["workers"] == 64
    assert out["max_rps"] > 0 and out["quorum_64_s"] > 0
    assert out["span_agree_verbs"] >= 1
