"""The port's node check worker under the reference agent's launcher
(``agent/node_check.py::_run_probe``, which starts the probe module once
per local rank with the agent's env and reads each result file): a
2-process gloo world at small probe sizes writes results the reference
parses; the fail variable leaves no file; the slow variable adds its
seconds."""

import os
import socket
import tempfile
import types

import pytest

from dlrover_tpu.agent import node_check
from dlrover_tpu.common.constants import NetworkCheckConstant


@pytest.fixture
def probe(monkeypatch):
    monkeypatch.setattr(node_check, "_PROBE_MODULE",
                        "dlrover_tpu_torch.agent.node_check_worker")
    monkeypatch.setattr(NetworkCheckConstant, "MATMUL_SIZE", 64)
    monkeypatch.setattr(NetworkCheckConstant, "MATMUL_ROUNDS", 16)
    monkeypatch.setattr(NetworkCheckConstant, "ALLREDUCE_MB", 1)
    monkeypatch.setenv("DLROVER_TPU_CHECK_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dirs, real_mkdtemp = [], tempfile.mkdtemp

    def mkdtemp(**kw):
        dirs.append(real_mkdtemp(**kw))
        return dirs[-1]

    monkeypatch.setattr(node_check.tempfile, "mkdtemp", mkdtemp)

    def run():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        outcome = types.SimpleNamespace(
            coordinator_address=f"127.0.0.1:{port}", num_processes=2,
            process_id_base=0, round=0)
        ok, elapsed = node_check._run_probe(
            outcome, node_rank=3, nproc_per_node=2, comm_perf=True,
            timeout=120)
        return ok, elapsed, sorted(os.listdir(dirs[-1]))

    return run


def test_probe_results_parse_and_chaos(probe, monkeypatch):
    ok, elapsed, files = probe()
    assert ok and 0 < elapsed < 60 and files == ["r0", "r1"]
    monkeypatch.setenv("DLROVER_TPU_CHAOS_CHECK_SLOW_RANKS", "3")
    monkeypatch.setenv("DLROVER_TPU_CHAOS_CHECK_SLOW_SECS", "2")
    ok, slow, _ = probe()
    assert ok and slow >= 2.0
    monkeypatch.delenv("DLROVER_TPU_CHAOS_CHECK_SLOW_RANKS")
    monkeypatch.setenv("DLROVER_TPU_CHAOS_CHECK_FAIL_RANKS", "3")
    ok, _, files = probe()
    assert not ok and files == []
