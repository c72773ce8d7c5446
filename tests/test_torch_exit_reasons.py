"""The exit-reason taxonomy of the port's master
(``dlrover_tpu_torch/master/node/exit_reason.py``, the per-reason
budgets of ``common/node.py``, the OOM and deletion paths of
``dist_job_manager.py``): the reference's scenarios
(``tests/test_exit_reasons.py``) run on the port, then ``classify_exit``,
``relaunch_budget`` and the budget verdicts of both packages on the same
inputs.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import itertools

import pytest

from dlrover_tpu_torch.common.constants import (
    ExitCode,
    JobStage,
    NodeExitReason,
    NodeStatus,
    NodeType,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.node import Node, NodeGroupResource, NodeResource
from dlrover_tpu_torch.master.node.dist_job_manager import DistributedJobManager
from dlrover_tpu_torch.master.node.exit_reason import classify_exit
from dlrover_tpu_torch.master.node.job_context import JobContext, get_job_context
from dlrover_tpu_torch.testing.sim_cluster import (
    SimCluster,
    SimNodeWatcher,
    SimScaler,
)


@pytest.fixture(autouse=True)
def fresh_job_context():
    JobContext.reset_singleton()
    yield
    JobContext.reset_singleton()


# ---------------------------------------------------------------------------
# classify_exit
# ---------------------------------------------------------------------------


def test_classify_by_exit_code():
    assert classify_exit(0) is None
    assert classify_exit(ExitCode.KILLED) == NodeExitReason.KILLED
    assert classify_exit(ExitCode.TERMED) == NodeExitReason.PREEMPTED
    assert (
        classify_exit(ExitCode.HARDWARE_ERROR)
        == NodeExitReason.HARDWARE_ERROR
    )
    assert (
        classify_exit(ExitCode.GPU_DRIVER_ERROR)
        == NodeExitReason.HARDWARE_ERROR
    )
    assert classify_exit(1) == NodeExitReason.SOFTWARE_ERROR
    assert classify_exit(17) == NodeExitReason.SOFTWARE_ERROR


def test_classify_by_message_markers():
    assert (
        classify_exit(1, "RESOURCE_EXHAUSTED: failed to allocate 3.2G")
        == NodeExitReason.OOM
    )
    assert classify_exit(137, "oom-killer invoked") == NodeExitReason.OOM
    assert (
        classify_exit(1, "libtpu.so: initialization failed")
        == NodeExitReason.HARDWARE_ERROR
    )


def test_classify_reason_hint_wins_over_code():
    # The agent's log diagnosis is more specific than the exit code.
    assert (
        classify_exit(1, "reason=OOMKilled codes={0: 1}")
        == NodeExitReason.OOM
    )
    assert (
        classify_exit(137, "reason=HardwareError codes={0: 137}")
        == NodeExitReason.HARDWARE_ERROR
    )
    # Unknown hints fall through to code classification.
    assert (
        classify_exit(137, "reason=Bogus codes={0: 137}")
        == NodeExitReason.KILLED
    )


# ---------------------------------------------------------------------------
# Node per-reason budgets
# ---------------------------------------------------------------------------


def _exhaust(node, reason, times):
    for _ in range(times):
        node.exit_reason = reason
        node.record_exit(reason)


def test_preemption_budget_is_generous():
    node = Node(NodeType.WORKER, 0, max_relaunch_count=2)
    _exhaust(node, NodeExitReason.PREEMPTED, 21)
    assert node.is_unrecoverable_failure()  # 21 > 2*10
    node2 = Node(NodeType.WORKER, 1, max_relaunch_count=2)
    _exhaust(node2, NodeExitReason.PREEMPTED, 20)
    assert not node2.is_unrecoverable_failure()


def test_software_budget_is_tight():
    node = Node(NodeType.WORKER, 0, max_relaunch_count=2)
    _exhaust(node, NodeExitReason.SOFTWARE_ERROR, 2)
    assert not node.is_unrecoverable_failure()
    _exhaust(node, NodeExitReason.SOFTWARE_ERROR, 1)
    assert "budget" in node.is_unrecoverable_failure()


def test_fatal_never_relaunches():
    node = Node(NodeType.WORKER, 0, max_relaunch_count=3)
    node.exit_reason = NodeExitReason.FATAL_ERROR
    assert node.is_unrecoverable_failure()


def test_budgets_are_independent_per_reason():
    node = Node(NodeType.WORKER, 0, max_relaunch_count=1)
    _exhaust(node, NodeExitReason.OOM, 2)  # OOM budget (1) exhausted
    assert node.is_unrecoverable_failure()
    # ... but a preemption on the same lineage still relaunches
    node.exit_reason = NodeExitReason.PREEMPTED
    node.record_exit(NodeExitReason.PREEMPTED)
    assert not node.is_unrecoverable_failure()


def test_legacy_flat_cap_without_history():
    node = Node(NodeType.WORKER, 0, max_relaunch_count=2)
    node.relaunch_count = 2
    assert node.is_unrecoverable_failure()


# ---------------------------------------------------------------------------
# Manager flow
# ---------------------------------------------------------------------------


def make_manager(node_num=1, max_relaunch=2):
    cluster = SimCluster()
    mgr = DistributedJobManager(
        job_name="exit-job",
        node_groups={
            NodeType.WORKER: NodeGroupResource(
                count=node_num, node_resource=NodeResource(tpu_chips=4)
            )
        },
        scaler=SimScaler("exit-job", cluster),
        watcher=SimNodeWatcher("exit-job", cluster),
        max_relaunch_count=max_relaunch,
    )
    get_job_context().set_job_stage(JobStage.RUNNING)
    for node in mgr.worker_manager.init_nodes():
        node.update_status(NodeStatus.RUNNING)
    return mgr


def _fail(mgr, node, reason):
    node.exit_reason = ""
    mgr._observe_failure(node, reason)


def _latest(mgr, rank=0):
    return max(
        (
            n
            for n in mgr.worker_manager.nodes.values()
            if n.rank_index == rank
        ),
        key=lambda n: n.id,
    )


def test_manager_relaunches_through_preemption_storm():
    mgr = make_manager(max_relaunch=1)
    for _ in range(8):  # well past the flat cap of 1, within 10x budget
        node = _latest(mgr)
        node.update_status(NodeStatus.RUNNING)
        _fail(mgr, node, NodeExitReason.PREEMPTED)
        relaunched = _latest(mgr)
        assert relaunched.id != node.id, "preemption was not relaunched"


def test_manager_stops_oom_loop_after_budget():
    mgr = make_manager(max_relaunch=2)
    ids = set()
    for _ in range(2):
        node = _latest(mgr)
        ids.add(node.id)
        node.update_status(NodeStatus.RUNNING)
        _fail(mgr, node, NodeExitReason.OOM)
        assert _latest(mgr).id != node.id
    # Third OOM exceeds the budget: no new incarnation.
    node = _latest(mgr)
    node.update_status(NodeStatus.RUNNING)
    _fail(mgr, node, NodeExitReason.OOM)
    assert _latest(mgr).id == node.id


def test_agent_report_classifies_and_escalates():
    """A NODE_ERROR failure report with an OOM reason hint ends up as an
    OOMKilled exit record on the node (feeding the optimizer's bump)."""
    mgr = make_manager()
    node = _latest(mgr)
    node.update_status(NodeStatus.RUNNING)
    mgr.handle_node_failure(
        comm.NodeFailureReport(
            node_id=node.id,
            node_rank=node.rank_index,
            error_data="reason=OOMKilled codes={0: 1}",
            level=TrainingExceptionLevel.NODE_ERROR,
            restart_count=0,
            exit_code=1,
        )
    )
    assert node.exit_reason == NodeExitReason.OOM
    assert node.exit_history.count(NodeExitReason.OOM) == 1
    assert _latest(mgr).id != node.id  # relaunched within budget


def test_deleted_node_budget_counts_as_killed():
    """A deletion loop must exhaust the KILLED budget, not relaunch
    forever (exit_reason and recorded history must agree)."""
    mgr = make_manager(max_relaunch=1)  # KILLED budget = 2
    for _ in range(2):
        node = _latest(mgr)
        node.update_status(NodeStatus.RUNNING)
        mgr._observe_failure(
            node, "", status=NodeStatus.DELETED
        )
        assert node.exit_reason == NodeExitReason.KILLED
        assert _latest(mgr).id != node.id
    node = _latest(mgr)
    node.update_status(NodeStatus.RUNNING)
    mgr._observe_failure(node, "", status=NodeStatus.DELETED)
    assert _latest(mgr).id == node.id  # budget exhausted


def test_failure_evidence_consumed_once(tmp_path):
    """diagnose + classify share one offset-tracked log read: a stale
    OOM line from a previous failure must not classify a later crash."""
    from dlrover_tpu_torch.agent.diagnosis_agent import (
        DiagnosisAgent,
        FailureContext,
    )

    log = tmp_path / "worker.log"
    log.write_text("RESOURCE_EXHAUSTED: out of HBM\n")
    agent = DiagnosisAgent(log_path=str(log))
    ev1 = agent.consume_failure_evidence()
    ctx1 = FailureContext(
        exit_codes={0: 1}, restart_count=0, max_restarts=3, log_tail=ev1
    )
    assert agent.failure_reason(ctx1) == NodeExitReason.OOM
    # Second failure: plain crash, no new OOM lines appended.
    with open(log, "a") as f:
        f.write("ValueError: bad shape\n")
    ev2 = agent.consume_failure_evidence()
    ctx2 = FailureContext(
        exit_codes={0: 1}, restart_count=1, max_restarts=3, log_tail=ev2
    )
    assert agent.failure_reason(ctx2) == NodeExitReason.SOFTWARE_ERROR


def test_killed_hint_survives_exit_code_zero():
    assert (
        classify_exit(0, "reason=Killed codes={0: 137, 1: 0}")
        == NodeExitReason.KILLED
    )


def test_diagnosis_agent_failure_reason():
    from dlrover_tpu_torch.agent.diagnosis_agent import (
        DiagnosisAgent,
        FailureContext,
    )

    agent = DiagnosisAgent()
    ctx = FailureContext(
        exit_codes={0: 1},
        restart_count=0,
        max_restarts=3,
        log_tail=["RESOURCE_EXHAUSTED: XLA allocation failed"],
    )
    assert agent.failure_reason(ctx) == NodeExitReason.OOM
    ctx2 = FailureContext(
        exit_codes={0: 137}, restart_count=0, max_restarts=3, log_tail=[]
    )
    assert agent.failure_reason(ctx2) == NodeExitReason.KILLED
    ctx3 = FailureContext(
        exit_codes={0: 1},
        restart_count=0,
        max_restarts=3,
        log_tail=["libtpu.so error: device init failed"],
    )
    assert agent.failure_reason(ctx3) == NodeExitReason.HARDWARE_ERROR


# ---------------------------------------------------------------------------
# The port against the JAX package, on the same inputs
# ---------------------------------------------------------------------------

_CODES = (0, 1, 2, 17, ExitCode.KILLED, ExitCode.TERMED,
          ExitCode.HARDWARE_ERROR, ExitCode.GPU_DRIVER_ERROR,
          ExitCode.NODE_CHECK_FAILED, -9, 255)
_MESSAGES = (
    "", "ValueError: bad shape", "RESOURCE_EXHAUSTED: out of HBM",
    "CUDA out of memory. Tried to allocate 2.00 GiB", "oom-killer invoked",
    "libtpu.so: initialization failed", "reason=OOMKilled codes={0: 1}",
    "reason=Preempted codes={0: 143}", "reason=Killed codes={0: 137, 1: 0}",
    "reason=FatalError", "reason=SoftwareError", "reason=HardwareError",
    "reason=Bogus codes={0: 137}", "reason=Succeeded",
    "NCCL error: unhandled system error", "Xid 79: GPU has fallen off",
)


def test_classify_exit_equals_the_reference_on_every_pair():
    from dlrover_tpu.master.node import exit_reason as ref_er

    from dlrover_tpu_torch.master.node import exit_reason as port_er

    pairs = list(itertools.product(_CODES, _MESSAGES))
    got = [port_er.classify_exit(c, m) for c, m in pairs]
    want = [ref_er.classify_exit(c, m) for c, m in pairs]
    assert got == want
    # Every reason the taxonomy has is reached by some pair.
    assert {r for r in got if r} >= {
        NodeExitReason.KILLED, NodeExitReason.PREEMPTED,
        NodeExitReason.OOM, NodeExitReason.HARDWARE_ERROR,
        NodeExitReason.SOFTWARE_ERROR, NodeExitReason.FATAL_ERROR}


_REASONS = (NodeExitReason.SUCCEEDED, NodeExitReason.KILLED,
            NodeExitReason.OOM, NodeExitReason.FATAL_ERROR,
            NodeExitReason.SOFTWARE_ERROR, NodeExitReason.HARDWARE_ERROR,
            NodeExitReason.PREEMPTED, NodeExitReason.UNKNOWN, "", None)


@pytest.mark.parametrize("max_relaunch", [0, 1, 2, 3, 7])
def test_relaunch_budget_equals_the_reference(max_relaunch):
    from dlrover_tpu.master.node import exit_reason as ref_er

    from dlrover_tpu_torch.master.node import exit_reason as port_er

    got = [port_er.relaunch_budget(r, max_relaunch) for r in _REASONS]
    want = [ref_er.relaunch_budget(r, max_relaunch) for r in _REASONS]
    assert got == want


def test_budget_verdicts_equal_the_reference_on_a_seeded_history():
    """One seeded exit history per lineage, recorded into both packages'
    ``Node``: after every exit both give the same relaunch verdict."""
    import random

    from dlrover_tpu.common.node import Node as RefNode

    rng = random.Random(0)
    reasons = [r for r in _REASONS if r]
    for lineage in range(20):
        max_relaunch = rng.randint(0, 4)
        port = Node(NodeType.WORKER, lineage, max_relaunch_count=max_relaunch)
        ref = RefNode("worker", lineage, max_relaunch_count=max_relaunch)
        for _ in range(rng.randint(1, 30)):
            reason = rng.choice(reasons)
            for node in (port, ref):
                node.exit_reason = reason
                node.record_exit(reason)
            assert (port.is_unrecoverable_failure()
                    == ref.is_unrecoverable_failure())
