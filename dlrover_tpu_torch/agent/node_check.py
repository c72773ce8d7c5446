"""Agent-side network/node check orchestration.

Parity: reference NodeCheckElasticAgent (elastic_agent/torch/training.py:
2055, node_health_check:2316, run_network_check:2410): up to two check
rounds — round 0 pairs nodes arbitrarily; a failing pair's members become
suspects; round 1 pairs each suspect with a known-healthy node so the
master can bisect the fault to a node. Straggler detection compares probe
times against the group median.

The port's copy of ``dlrover_tpu/agent/node_check.py``: the same rounds
and verdicts, launching the port's probe
(``agent/node_check_worker.py``: a bf16 GEMM chain on the card, and with
``comm_perf`` an ``all_reduce``; ``DLROVER_TPU_CHECK_DEVICE=cpu`` puts
it on the CPU over gloo).
"""

import os
import subprocess
import sys
import tempfile
import time
from typing import Tuple

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.rendezvous import MasterRendezvousHandler
from dlrover_tpu_torch.common.constants import (
    NetworkCheckConstant,
    NodeEventType,
    RendezvousName,
)
from dlrover_tpu_torch.common.env_utils import worker_env
from dlrover_tpu_torch.common.log import logger

_PROBE_MODULE = "dlrover_tpu_torch.agent.node_check_worker"


def _run_probe(
    outcome,
    node_rank: int,
    nproc_per_node: int,
    comm_perf: bool,
    timeout: float,
) -> Tuple[bool, float]:
    """Launch the probe process(es) for this node; returns (ok, elapsed)."""
    result_dir = tempfile.mkdtemp(prefix="dlrover_tpu_check_")
    procs = []
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    for local_rank in range(nproc_per_node):
        result_file = os.path.join(result_dir, f"r{local_rank}")
        env = dict(os.environ)
        existing = env.get("PYTHONPATH", "")
        if pkg_root not in existing.split(os.pathsep):
            env["PYTHONPATH"] = (
                f"{existing}{os.pathsep}{pkg_root}" if existing else pkg_root
            )
        env.update(
            worker_env(
                coordinator=outcome.coordinator_address,
                num_processes=outcome.num_processes,
                process_id=outcome.process_id_base + local_rank,
                local_rank=local_rank,
                local_world_size=nproc_per_node,
                rdzv_round=outcome.round,
            )
        )
        env["DLROVER_TPU_CHECK_NODE_RANK"] = str(node_rank)
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    "-m",
                    _PROBE_MODULE,
                    result_file,
                    str(NetworkCheckConstant.MATMUL_SIZE),
                    str(NetworkCheckConstant.MATMUL_ROUNDS),
                    str(NetworkCheckConstant.ALLREDUCE_MB if comm_perf else 0),
                ],
                env=env,
            )
        )
    deadline = time.time() + timeout
    ok = True
    for p in procs:
        remaining = max(deadline - time.time(), 1.0)
        try:
            if p.wait(remaining) != 0:
                ok = False
        except subprocess.TimeoutExpired:
            p.kill()
            ok = False
    elapsed = 0.0
    for local_rank in range(nproc_per_node):
        path = os.path.join(result_dir, f"r{local_rank}")
        if os.path.exists(path):
            elapsed = max(elapsed, float(open(path).read().strip()))
        else:
            ok = False
    return ok, elapsed


def run_network_check(
    client: MasterClient,
    node_rank: int,
    nproc_per_node: int = 1,
    comm_perf: bool = False,
    timeout: float = NetworkCheckConstant.CHECK_TIMEOUT,
    node_unit: int = 1,
) -> bool:
    """Run the probe rounds; returns False if THIS node is faulty."""
    from dlrover_tpu_torch.training_event import AgentEvents

    span = AgentEvents.node_check().begin()
    try:
        ok = _run_network_check(
            client, node_rank, nproc_per_node, comm_perf, timeout, node_unit
        )
    except Exception as e:
        span.fail(str(e))
        raise
    span.end(success=ok)
    return ok


def _run_network_check(
    client: MasterClient,
    node_rank: int,
    nproc_per_node: int = 1,
    comm_perf: bool = False,
    timeout: float = NetworkCheckConstant.CHECK_TIMEOUT,
    node_unit: int = 1,
) -> bool:
    # Up to 4 rounds: pair + bisect in the flat flow; the group-aware
    # flow adds intra/inter phases (rdzv_manager.py
    # GroupNetworkCheckRendezvousManager.MAX_PHASES).
    for attempt in range(4):
        handler = MasterRendezvousHandler(
            client,
            node_rank,
            nproc_per_node,
            rdzv_name=RendezvousName.NETWORK_CHECK,
            node_unit=node_unit,
            join_timeout=timeout,
        )
        outcome = handler.next_rendezvous()
        logger.info(
            "network check round %d: group=%d world=%s",
            outcome.round,
            outcome.group,
            sorted(outcome.world),
        )
        ok, elapsed = _run_probe(
            outcome, node_rank, nproc_per_node, comm_perf, timeout
        )
        client.report_network_check_result(node_rank, ok, elapsed)
        # Wait until the master has concluded the round we reported in.
        verdict = _poll_verdict(client, min_round=attempt, timeout=timeout)
        if verdict is None:
            logger.warning("network check result poll timed out")
            return ok
        faults, evaluated_round, needs_round2 = verdict
        if node_rank in faults:
            client.report_node_event(
                NodeEventType.NODE_CHECK_FAILED,
                reason="network-check",
                message=f"probe failed in round {evaluated_round}",
            )
            return False
        stragglers = client.check_straggler()
        if node_rank in stragglers:
            logger.warning("this node is a straggler (probe %.2fs)", elapsed)
            client.report_node_event(
                NodeEventType.STRAGGLER,
                reason="network-check",
                message=f"{elapsed:.2f}s",
            )
        if not needs_round2:
            return True
        # suspects exist: everyone joins the bisection round
        logger.info("suspects detected; joining verification round")
    return True


def _poll_verdict(client: MasterClient, min_round: int, timeout: float):
    """Poll until a round >= min_round has been evaluated. (A pending
    bisection round surfaces as evaluated_round==0 + needs_round2, which
    satisfies min_round=0; round-1 pollers must wait for the real round-1
    verdict, never round 0's empty one.)"""
    deadline = time.time() + timeout
    while time.time() < deadline:
        faults, evaluated_round, needs_round2 = client.check_fault_node()
        if evaluated_round >= min_round:
            return faults, evaluated_round, needs_round2
        time.sleep(0.5)
    return None
