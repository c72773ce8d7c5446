"""The port's distributed master on the simulated cluster, on the CPU.

- the reference's scenarios (``tests/test_dist_master.py``,
  ``test_node_groups.py``, ``test_auto_scaler.py``,
  ``test_hyperparams.py`` and the topology cases of
  ``test_brain_and_topology.py``) run on the port's copies;
- one scripted ``SimCluster`` event sequence (a kill, OOM through its
  budget, a preemption, a broken host of a slice block, a master
  restart adopting the live nodes) through both packages'
  ``DistributedJobManager``: equal node tables and scale plans;
- ``DpTopologySorter``, ``AllreduceLocalOptimizer``,
  ``SimpleStrategyGenerator`` and ``JobMetricCollector`` of both
  packages on the same inputs;
- the CLI, ``python -m dlrover_tpu_torch.master.main --platform sim``,
  serving two launchers through a lost host's relaunch to exit 0, and
  the platforms and flags that wait for ROADMAP §A item 8b;
- the port's divergences: an agent reporting with its rank's ended
  incarnation's id lands on the live incarnation, an agent's success
  report ends its node, in-band steps that advance veto a hang only
  flat out-of-band counters claim, one endpoint's bad answer does not
  abort a scrape round, and a node failure under the autoscale loop
  reaches the loop's fault history.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import json
import os
import random
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

from dlrover_tpu_torch.agent.paral_config_tuner import (
    ParalConfigTuner,
    read_parallel_config,
)
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import (
    JobExitReason,
    JobStage,
    NodeExitReason,
    NodeStatus,
    NodeType,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource
from dlrover_tpu_torch.master.elastic_training.net_topology import (
    DpTopologySorter,
    SubnetTopologyQuerier,
)
from dlrover_tpu_torch.master.elastic_training.rdzv_manager import (
    ElasticTrainingRendezvousManager,
    GroupNetworkCheckRendezvousManager,
)
from dlrover_tpu_torch.master.hyperparams.simple_strategy_generator import (
    SimpleStrategyGenerator,
    _balanced_mesh,
)
from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor
from dlrover_tpu_torch.master.node.dist_job_manager import DistributedJobManager
from dlrover_tpu_torch.master.node.job_auto_scaler import (
    AllreduceTrainingAutoScaler,
)
from dlrover_tpu_torch.master.node.job_context import (
    JobContext,
    get_job_context,
)
from dlrover_tpu_torch.master.resource.optimizer import (
    AllreduceLocalOptimizer,
    ResourcePlan,
)
from dlrover_tpu_torch.master.stats.job_collector import (
    JobMetricCollector,
    LocalStatsReporter,
)
from dlrover_tpu_torch.testing.sim_cluster import (
    SimCluster,
    SimNodeWatcher,
    SimScaler,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh_job_context():
    from dlrover_tpu.master.node.job_context import JobContext as RefContext

    JobContext.reset_singleton()
    RefContext.reset_singleton()
    yield
    JobContext.reset_singleton()
    RefContext.reset_singleton()


# ---------------------------------------------------------------------------
# The reference's ``tests/test_dist_master.py`` on the port
# ---------------------------------------------------------------------------


def _dm_make_manager(node_num=2, max_relaunch=2, **kwargs):
    cluster = SimCluster()
    scaler = SimScaler("test-job", cluster)
    watcher = SimNodeWatcher("test-job", cluster)
    mgr = DistributedJobManager(
        job_name="test-job",
        node_groups={
            NodeType.WORKER: NodeGroupResource(
                count=node_num, node_resource=NodeResource(tpu_chips=4)
            )
        },
        scaler=scaler,
        watcher=watcher,
        max_relaunch_count=max_relaunch,
        **kwargs,
    )
    return mgr, cluster


def _dm_wait_until(predicate, timeout=5.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def _dm_running_nodes(mgr):
    return [
        n
        for n in mgr.worker_manager.nodes.values()
        if n.status == NodeStatus.RUNNING
    ]


def test_start_creates_and_runs_workers():
    mgr, cluster = _dm_make_manager(node_num=3)
    try:
        mgr.start()
        assert _dm_wait_until(lambda: len(_dm_running_nodes(mgr)) == 3)
        assert get_job_context().job_stage == JobStage.RUNNING
        ranks = sorted(n.rank_index for n in _dm_running_nodes(mgr))
        assert ranks == [0, 1, 2]
    finally:
        mgr.stop()


def test_failed_worker_is_relaunched_with_same_rank():
    mgr, cluster = _dm_make_manager(node_num=2)
    try:
        mgr.start()
        assert _dm_wait_until(lambda: len(_dm_running_nodes(mgr)) == 2)
        victim = _dm_running_nodes(mgr)[0]
        cluster.fail_node(victim.id)
        # A replacement with the same rank but a new id appears.
        assert _dm_wait_until(
            lambda: any(
                n.rank_index == victim.rank_index
                and n.id != victim.id
                and n.status == NodeStatus.RUNNING
                for n in mgr.worker_manager.nodes.values()
            )
        )
        assert get_job_context().failure_count == 1
        replacement = [
            n
            for n in mgr.worker_manager.nodes.values()
            if n.rank_index == victim.rank_index and n.id != victim.id
        ][0]
        assert replacement.relaunch_count == 1
    finally:
        mgr.stop()


def test_preempted_worker_is_replaced():
    mgr, cluster = _dm_make_manager(node_num=2)
    try:
        mgr.start()
        assert _dm_wait_until(lambda: len(_dm_running_nodes(mgr)) == 2)
        victim = _dm_running_nodes(mgr)[1]
        cluster.preempt_node(victim.id)
        assert _dm_wait_until(lambda: len(_dm_running_nodes(mgr)) == 2)
    finally:
        mgr.stop()


def test_fatal_error_is_not_relaunched():
    mgr, cluster = _dm_make_manager(node_num=1)
    try:
        mgr.start()
        assert _dm_wait_until(lambda: len(_dm_running_nodes(mgr)) == 1)
        victim = _dm_running_nodes(mgr)[0]
        cluster.fail_node(victim.id, NodeExitReason.FATAL_ERROR)
        assert _dm_wait_until(mgr.all_workers_exited)
        assert not mgr.all_workers_succeeded()
        # No new incarnation was created.
        assert len(mgr.worker_manager.nodes) == 1
    finally:
        mgr.stop()


def test_relaunch_budget_exhausted():
    # SOFTWARE_ERROR has a 1.0 budget factor (crash loops stop fast;
    # KILLED/PREEMPTED are more generous — tests/test_exit_reasons.py).
    mgr, cluster = _dm_make_manager(node_num=1, max_relaunch=1)
    try:
        mgr.start()
        assert _dm_wait_until(lambda: len(_dm_running_nodes(mgr)) == 1)
        first = _dm_running_nodes(mgr)[0]
        cluster.fail_node(first.id, NodeExitReason.SOFTWARE_ERROR)
        assert _dm_wait_until(
            lambda: any(
                n.id != first.id and n.status == NodeStatus.RUNNING
                for n in mgr.worker_manager.nodes.values()
            )
        )
        second = [
            n for n in mgr.worker_manager.nodes.values() if n.id != first.id
        ][0]
        cluster.fail_node(second.id, NodeExitReason.SOFTWARE_ERROR)
        assert _dm_wait_until(mgr.all_workers_exited)
        assert len(mgr.worker_manager.nodes) == 2
    finally:
        mgr.stop()


def test_all_workers_succeeded():
    mgr, cluster = _dm_make_manager(node_num=2)
    try:
        mgr.start()
        assert _dm_wait_until(lambda: len(_dm_running_nodes(mgr)) == 2)
        for node in _dm_running_nodes(mgr):
            cluster.succeed_node(node.id)
        assert _dm_wait_until(mgr.all_workers_exited)
        assert mgr.all_workers_succeeded()
    finally:
        mgr.stop()


def test_worker_scale_up_and_down():
    mgr, cluster = _dm_make_manager(node_num=2)
    try:
        mgr.start()
        assert _dm_wait_until(lambda: len(_dm_running_nodes(mgr)) == 2)
        plan = mgr.worker_manager.adjust_worker(4)
        mgr._scaler.scale(plan)
        assert _dm_wait_until(lambda: len(_dm_running_nodes(mgr)) == 4)
        ranks = sorted(n.rank_index for n in _dm_running_nodes(mgr))
        assert ranks == [0, 1, 2, 3]
        plan = mgr.worker_manager.adjust_worker(2)
        mgr._scaler.scale(plan)
        assert _dm_wait_until(lambda: len(_dm_running_nodes(mgr)) == 2)
        ranks = sorted(n.rank_index for n in _dm_running_nodes(mgr))
        assert ranks == [0, 1]
    finally:
        mgr.stop()


def test_heartbeat_timeout_marks_node_failed():
    mgr, cluster = _dm_make_manager(node_num=1, heartbeat_timeout_s=0.5)
    try:
        mgr.start()
        assert _dm_wait_until(lambda: len(_dm_running_nodes(mgr)) == 1)
        node = _dm_running_nodes(mgr)[0]
        node.heartbeat_time = time.time() - 10
        # Heartbeat monitor notices within ~1s tick and relaunches.
        assert _dm_wait_until(
            lambda: any(
                n.id != node.id for n in mgr.worker_manager.nodes.values()
            ),
            timeout=5.0,
        )
    finally:
        mgr.stop()


def test_pending_timeout_fires_when_unschedulable():
    cluster = SimCluster()
    cluster.schedulable = False
    scaler = SimScaler("test-job", cluster)
    watcher = SimNodeWatcher("test-job", cluster)
    mgr = DistributedJobManager(
        job_name="test-job",
        node_groups={NodeType.WORKER: NodeGroupResource(count=2)},
        scaler=scaler,
        watcher=watcher,
        pending_timeout_s=0.2,
    )
    try:
        mgr.start()
        assert _dm_wait_until(mgr.pending_timed_out, timeout=3.0)
    finally:
        mgr.stop()


def test_master_restart_adopts_existing_nodes():
    cluster = SimCluster()
    mgr1, _ = _dm_make_manager(node_num=2)
    mgr1._scaler._cluster = cluster
    mgr1._watcher._cluster = cluster
    mgr1.start()
    assert _dm_wait_until(lambda: len(cluster.list_nodes()) == 2)
    mgr1.stop()

    # A new master over the same (still-running) cluster must adopt the
    # two live nodes instead of doubling the worker set.
    JobContext.reset_singleton()
    scaler = SimScaler("test-job", cluster)
    watcher = SimNodeWatcher("test-job", cluster)
    mgr2 = DistributedJobManager(
        job_name="test-job",
        node_groups={NodeType.WORKER: NodeGroupResource(count=2)},
        scaler=scaler,
        watcher=watcher,
    )
    try:
        mgr2.start()
        time.sleep(0.3)
        assert len(cluster.list_nodes()) == 2
        ranks = sorted(
            n.rank_index for n in mgr2.worker_manager.nodes.values()
        )
        assert ranks == [0, 1]
    finally:
        mgr2.stop()


def test_multi_role_evaluator_and_chief():
    """Per-role managers (reference worker/chief/evaluator side-by-side):
    evaluators relaunch independently and never gate job success; the
    chief gates success and is marked critical."""
    cluster = SimCluster()
    mgr = DistributedJobManager(
        job_name="roles-job",
        node_groups={
            NodeType.WORKER: NodeGroupResource(
                count=2, node_resource=NodeResource(tpu_chips=4)
            ),
            NodeType.EVALUATOR: NodeGroupResource(
                count=1, node_resource=NodeResource()
            ),
            NodeType.CHIEF: NodeGroupResource(
                count=1, node_resource=NodeResource()
            ),
        },
        scaler=SimScaler("roles-job", cluster),
        watcher=SimNodeWatcher("roles-job", cluster),
    )
    try:
        mgr.start()
        assert _dm_wait_until(
            lambda: len(
                [n for n in mgr._all_running_nodes()]
            ) == 4
        )
        chief = [
            n
            for n in mgr._managers[NodeType.CHIEF].nodes.values()
        ][0]
        assert chief.critical

        # Evaluator crash: relaunched by ITS manager; workers untouched.
        ev_mgr = mgr._managers[NodeType.EVALUATOR]
        ev = list(ev_mgr.nodes.values())[0]
        cluster.fail_node(ev.id)
        assert _dm_wait_until(
            lambda: any(
                n.id != ev.id and n.status == NodeStatus.RUNNING
                for n in ev_mgr.nodes.values()
            )
        )
        assert len(mgr.worker_manager.nodes) == 2

        # Workers + chief succeed -> job succeeds even though the
        # evaluator still runs.
        for node in mgr.worker_manager.nodes.values():
            cluster.succeed_node(node.id)
        cluster.succeed_node(chief.id)
        assert _dm_wait_until(mgr.all_workers_succeeded)
        assert mgr.all_workers_exited()
    finally:
        mgr.stop()


# ---------------------------------------------------------------------------
# The reference's ``tests/test_node_groups.py`` (slice blocks: complete-group rendezvous, the phased network check, whole-block relaunch) on the port
# ---------------------------------------------------------------------------


def _ng_join_all(mgr, ranks_groups):
    for rank, group in ranks_groups:
        mgr.join_rendezvous(rank, rank, 1, node_group=group)


# ---------------------------------------------------------------------------
# Training rendezvous: complete groups only
# ---------------------------------------------------------------------------


def test_training_rdzv_orders_world_group_major():
    mgr = ElasticTrainingRendezvousManager()
    mgr.update_rdzv_params(4, 4, waiting_timeout=0.0, node_unit=2)
    # Join order scrambled across groups; world must come out
    # group-major so slice hosts are contiguous in rank order.
    _ng_join_all(mgr, [(0, 0), (2, 1), (1, 0), (3, 1)])
    _, _, world = mgr.get_comm_world(0)
    assert list(world) == [0, 1, 2, 3]


def test_training_rdzv_holds_back_incomplete_block():
    """Losing a host in block A never tears down block B: the round
    forms from block B alone while block A waits for its replacement."""
    mgr = ElasticTrainingRendezvousManager()
    mgr.update_rdzv_params(2, 4, waiting_timeout=0.0, node_unit=2)
    # Block 0 is missing rank 1 (host died); block 1 complete.
    _ng_join_all(mgr, [(0, 0), (2, 1), (3, 1)])
    _, _, world = mgr.get_comm_world(2)
    assert list(world) == [2, 3], f"incomplete block leaked in: {world}"
    # Rank 0 is still waiting, not evicted.
    assert mgr.num_nodes_waiting() == 1
    # Replacement arrives: next round forms with both blocks.
    mgr.join_rendezvous(1, 1, 1, node_group=0)
    _, _, world2 = mgr.get_comm_world(0)
    assert list(world2) == [0, 1]  # legal size 2 round with block 0
    # (block 1 already holds a completed round and didn't re-join)


def test_training_rdzv_no_round_without_any_complete_block():
    mgr = ElasticTrainingRendezvousManager()
    mgr.update_rdzv_params(1, 4, waiting_timeout=0.0, node_unit=2)
    _ng_join_all(mgr, [(0, 0), (2, 1)])  # both blocks half-present
    _, _, world = mgr.get_comm_world(0)
    assert world == {}


# ---------------------------------------------------------------------------
# Group network check phases
# ---------------------------------------------------------------------------


def _ng_make_check_mgr():
    mgr = GroupNetworkCheckRendezvousManager()
    mgr.update_rdzv_params(4, 4, waiting_timeout=0.0, node_unit=2)
    return mgr


_NG_GROUPS = [(0, 0), (1, 0), (2, 1), (3, 1)]


def _ng_run_round(mgr, fail_ranks=()):
    """All agents join, fetch their pair, and report."""
    _ng_join_all(mgr, _NG_GROUPS)
    pairs = {}
    for rank, _ in _NG_GROUPS:
        _, _, group = mgr.get_comm_world(rank)
        pairs[rank] = tuple(sorted(group))
    for rank, _ in _NG_GROUPS:
        mgr.report_network_check_result(
            rank, rank not in fail_ranks, 1.0 + 0.01 * rank
        )
    return pairs


def test_clean_intra_then_clean_inter_concludes():
    mgr = _ng_make_check_mgr()
    pairs = _ng_run_round(mgr)
    # Phase INTRA: pairs stay within slices.
    assert pairs[0] == (0, 1) and pairs[2] == (2, 3)
    faults, rnd, needs_more = mgr.check_fault_node()
    assert (faults, rnd, needs_more) == ([], 0, True)
    pairs = _ng_run_round(mgr)
    # Phase INTER: same-position hosts across slices (DCN probe).
    assert pairs[0] == (0, 2) and pairs[1] == (1, 3)
    faults, rnd, needs_more = mgr.check_fault_node()
    assert (faults, rnd, needs_more) == ([], 1, False)


def test_intra_failure_bisects_within_slice():
    mgr = _ng_make_check_mgr()
    _ng_run_round(mgr, fail_ranks={0, 1})  # block 0's pair fails
    _, _, needs_more = mgr.check_fault_node()
    assert needs_more
    pairs = _ng_run_round(mgr, fail_ranks={1})  # diag: only rank 1 fails
    # A fully-suspect 2-host block degenerates to solo host probes (no
    # intra-healthy partner exists); the healthy block re-pairs intra.
    assert pairs[0] == (0,) and pairs[1] == (1,)
    assert pairs[2] == (2, 3)
    faults, rnd, needs_more = mgr.check_fault_node()
    assert faults == [1]
    assert not needs_more


def test_inter_failure_bisects_across_slices():
    mgr = _ng_make_check_mgr()
    _ng_run_round(mgr)  # intra clean
    _ng_run_round(mgr, fail_ranks={0, 2})  # DCN pair (0,2) fails
    _, _, needs_more = mgr.check_fault_node()
    assert needs_more
    # Diag: each suspect pairs with a healthy host of ANOTHER slice.
    pairs = _ng_run_round(mgr, fail_ranks={0})
    assert pairs[0] == (0, 3)
    assert pairs[2] == (1, 2)
    faults, _, needs_more = mgr.check_fault_node()
    assert faults == [0]
    assert not needs_more


def test_mixed_group_info_falls_back_to_flat_flow():
    """One host without group info (e.g. rolling upgrade): the whole
    cycle must run the flat pair/bisect flow and still CONCLUDE."""
    mgr = _ng_make_check_mgr()
    for rank, group in [(0, 0), (1, 0), (2, 1), (3, -1)]:
        mgr.join_rendezvous(rank, rank, 1, node_group=group)
    for rank in range(4):
        mgr.get_comm_world(rank)
    for rank in range(4):
        mgr.report_network_check_result(rank, True, 1.0)
    faults, _, needs_more = mgr.check_fault_node()
    assert faults == []
    assert not needs_more


def test_fresh_cycle_after_conclusion():
    mgr = _ng_make_check_mgr()
    _ng_run_round(mgr)
    _ng_run_round(mgr)
    assert mgr.check_fault_node() == ([], 1, False)
    # A relaunched node re-joining starts a fresh cycle at INTRA.
    pairs = _ng_run_round(mgr)
    assert pairs[0] == (0, 1)
    assert mgr.check_fault_node() == ([], 0, True)


# ---------------------------------------------------------------------------
# Whole-block relaunch
# ---------------------------------------------------------------------------


def _ng_make_manager():
    cluster = SimCluster()
    mgr = DistributedJobManager(
        job_name="grp-job",
        node_groups={
            NodeType.WORKER: NodeGroupResource(
                count=4, node_resource=NodeResource(tpu_chips=4)
            )
        },
        scaler=SimScaler("grp-job", cluster),
        watcher=SimNodeWatcher("grp-job", cluster),
        max_relaunch_count=2,
        node_group_size=2,
    )
    get_job_context().set_job_stage(JobStage.RUNNING)
    for node in mgr.worker_manager.init_nodes():
        if mgr._node_group_size > 1:
            node.node_group = node.rank_index // mgr._node_group_size
        node.update_status(NodeStatus.RUNNING)
    return mgr


def _ng_latest_by_rank(mgr):
    return {n.rank_index: n for n in mgr.worker_manager.latest_nodes()}

def test_hardware_fault_relaunches_whole_block():
    mgr = _ng_make_manager()
    before = _ng_latest_by_rank(mgr)
    mgr._observe_failure(before[0], NodeExitReason.HARDWARE_ERROR)
    after = _ng_latest_by_rank(mgr)
    # Block 0 (ranks 0, 1) fully replaced...
    assert after[0].id != before[0].id
    assert after[1].id != before[1].id
    assert after[0].node_group == 0 and after[1].node_group == 0
    # ...block 1 untouched.
    assert after[2].id == before[2].id
    assert after[3].id == before[3].id
    # The healthy member's old record must not relaunch again when its
    # deletion event lands.
    old_rank1 = before[1]
    old_rank1.update_status(NodeStatus.RUNNING)  # still alive pre-kill
    mgr._observe_failure(old_rank1, "", status=NodeStatus.DELETED)
    newest = _ng_latest_by_rank(mgr)
    assert newest[1].id == after[1].id, "double relaunch of block member"


def test_software_crash_relaunches_single_node_in_block():
    mgr = _ng_make_manager()
    before = _ng_latest_by_rank(mgr)
    mgr._observe_failure(before[0], NodeExitReason.SOFTWARE_ERROR)
    after = _ng_latest_by_rank(mgr)
    assert after[0].id != before[0].id
    assert after[1].id == before[1].id  # block-mate untouched


# ---------------------------------------------------------------------------
# The reference's ``tests/test_auto_scaler.py`` (optimizer, auto-scaler, job stats) on the port
# ---------------------------------------------------------------------------


def _as_wait_until(predicate, timeout=5.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def _as_make_managed_cluster(node_num=2, memory_mb=0.0):
    cluster = SimCluster()
    scaler = SimScaler("as-job", cluster)
    watcher = SimNodeWatcher("as-job", cluster)
    mgr = DistributedJobManager(
        job_name="as-job",
        node_groups={
            NodeType.WORKER: NodeGroupResource(
                count=node_num,
                node_resource=NodeResource(memory_mb=memory_mb),
            )
        },
        scaler=scaler,
        watcher=watcher,
    )
    mgr.start()
    assert _as_wait_until(
        lambda: len(
            [
                n
                for n in mgr.worker_manager.nodes.values()
                if n.status == NodeStatus.RUNNING
            ]
        )
        == node_num
    )
    return mgr, scaler, cluster


def test_optimizer_scales_up_with_no_counter_evidence():
    mgr, scaler, cluster = _as_make_managed_cluster(2)
    try:
        from dlrover_tpu_torch.master.resource.optimizer import _SpeedSample

        perf = PerfMonitor()
        opt = AllreduceLocalOptimizer(
            mgr, perf, legal_counts=[1, 2, 4, 8], cooldown_s=0.0
        )
        # Evidence: current speed at 2 workers, none at 4 yet -> try 4.
        opt._samples.append(_SpeedSample(2, 1.0, time.time()))
        plan = opt.generate_plan()
        assert plan.node_group_resources[NodeType.WORKER].count == 4
    finally:
        mgr.stop()


def test_optimizer_respects_scaling_efficiency():
    mgr, scaler, cluster = _as_make_managed_cluster(2)
    try:
        from dlrover_tpu_torch.master.resource.optimizer import _SpeedSample

        perf = PerfMonitor()
        opt = AllreduceLocalOptimizer(
            mgr, perf, legal_counts=[2, 4], cooldown_s=0.0,
            min_scaling_efficiency=0.7,
        )
        # Already tried 4 workers: speed only 1.2x at 2x cost (eff 0.6).
        opt._samples.append(_SpeedSample(2, 1.0, time.time()))
        opt._samples.append(_SpeedSample(4, 1.2, time.time()))
        plan = opt.generate_plan()
        assert plan.empty()
    finally:
        mgr.stop()


def test_optimizer_without_speed_evidence_stays():
    mgr, scaler, cluster = _as_make_managed_cluster(2)
    try:
        perf = PerfMonitor()
        opt = AllreduceLocalOptimizer(
            mgr, perf, legal_counts=[2, 4], cooldown_s=0.0
        )
        assert opt.generate_plan().empty()
    finally:
        mgr.stop()


def test_oom_bumps_memory():
    mgr, scaler, cluster = _as_make_managed_cluster(1, memory_mb=1000)
    try:
        perf = PerfMonitor()
        opt = AllreduceLocalOptimizer(mgr, perf, cooldown_s=0.0)
        node = list(mgr.worker_manager.nodes.values())[0]
        node.exit_reason = NodeExitReason.OOM
        plan = opt.generate_plan()
        group = plan.node_group_resources[NodeType.WORKER]
        assert group.node_resource.memory_mb == pytest.approx(1500)
    finally:
        mgr.stop()


def test_auto_scaler_executes_plan():
    mgr, scaler, cluster = _as_make_managed_cluster(2)
    try:
        class FixedOptimizer:
            def generate_plan(self):
                plan = ResourcePlan(comment="test")
                plan.node_group_resources[NodeType.WORKER] = (
                    NodeGroupResource(count=4)
                )
                return plan

        auto = AllreduceTrainingAutoScaler(
            mgr, scaler, FixedOptimizer(), interval_s=3600
        )
        auto.scale_once()
        assert _as_wait_until(
            lambda: len(
                [
                    n
                    for n in mgr.worker_manager.nodes.values()
                    if n.status == NodeStatus.RUNNING
                ]
            )
            == 4
        )
    finally:
        mgr.stop()


def test_metric_collector_samples_and_completion():
    mgr, scaler, cluster = _as_make_managed_cluster(2)
    try:
        perf = PerfMonitor()
        perf.collect_global_step(5, time.time())
        reporter = LocalStatsReporter()
        collector = JobMetricCollector("as-job", mgr, perf, reporter)
        sample = collector.collect_once()
        assert sample.worker_count == 2
        assert sample.global_step == 5
        assert len(reporter.samples) == 1
        collector.report_completion(True, "Succeeded", 0)
        assert reporter.completions[0].success
    finally:
        mgr.stop()


def test_oom_bump_fires_once():
    mgr, scaler, cluster = _as_make_managed_cluster(1, memory_mb=1000)
    try:
        perf = PerfMonitor()
        opt = AllreduceLocalOptimizer(mgr, perf, cooldown_s=0.0)
        node = list(mgr.worker_manager.nodes.values())[0]
        node.exit_reason = NodeExitReason.OOM
        plan1 = opt.generate_plan()
        assert not plan1.empty()
        # Same dead record next round: no compounding bump.
        plan2 = opt.generate_plan()
        assert plan2.empty()
        assert mgr.worker_manager.group_resource.node_resource.memory_mb == (
            pytest.approx(1500)
        )
    finally:
        mgr.stop()


def test_scale_up_moves_rendezvous_window():
    from dlrover_tpu_torch.master.elastic_training.rdzv_manager import (
        ElasticTrainingRendezvousManager,
    )

    mgr, scaler, cluster = _as_make_managed_cluster(2)
    try:
        rdzv = ElasticTrainingRendezvousManager()
        rdzv.update_rdzv_params(min_nodes=2, max_nodes=2)

        class FixedOptimizer:
            def generate_plan(self):
                plan = ResourcePlan(comment="grow")
                plan.node_group_resources[NodeType.WORKER] = (
                    NodeGroupResource(count=4)
                )
                return plan

        auto = AllreduceTrainingAutoScaler(
            mgr, scaler, FixedOptimizer(), interval_s=3600,
            rdzv_managers={"training": rdzv},
        )
        auto.scale_once()
        # A 4-node rendezvous round can now complete.
        for i in range(4):
            rdzv.join_rendezvous(i, i, 1)
        _, _, world = rdzv.get_comm_world(0)
        assert len(world) == 4
    finally:
        mgr.stop()


def test_relaunch_uses_bumped_group_resource():
    mgr, scaler, cluster = _as_make_managed_cluster(1, memory_mb=1000)
    try:
        mgr.worker_manager.group_resource.node_resource.memory_mb = 1500
        victim = list(mgr.worker_manager.nodes.values())[0]
        cluster.fail_node(victim.id)
        assert _as_wait_until(
            lambda: any(
                n.id != victim.id and n.status == NodeStatus.RUNNING
                for n in mgr.worker_manager.nodes.values()
            )
        )
        replacement = [
            n for n in mgr.worker_manager.nodes.values() if n.id != victim.id
        ][0]
        assert replacement.config_resource.memory_mb == pytest.approx(1500)
    finally:
        mgr.stop()


def test_optimizer_scales_down_when_inefficient():
    from dlrover_tpu_torch.master.resource.optimizer import _SpeedSample

    mgr, scaler, cluster = _as_make_managed_cluster(4)
    try:
        perf = PerfMonitor()
        opt = AllreduceLocalOptimizer(
            mgr, perf, legal_counts=[2, 4], cooldown_s=0.0,
            min_scaling_efficiency=0.7,
        )
        # Grew to 4 but only 1.2x the 2-worker speed: retreat to 2.
        opt._samples.append(_SpeedSample(2, 1.0, time.time()))
        opt._samples.append(_SpeedSample(4, 1.2, time.time()))
        plan = opt.generate_plan()
        assert plan.node_group_resources[NodeType.WORKER].count == 2
    finally:
        mgr.stop()


def test_optimizer_holds_without_legal_counts():
    from dlrover_tpu_torch.master.resource.optimizer import _SpeedSample

    mgr, scaler, cluster = _as_make_managed_cluster(2)
    try:
        perf = PerfMonitor()
        opt = AllreduceLocalOptimizer(mgr, perf, cooldown_s=0.0)
        opt._samples.append(_SpeedSample(2, 1.0, time.time()))
        assert opt.generate_plan().empty()
    finally:
        mgr.stop()


def test_count_only_plan_keeps_resource_template():
    mgr, scaler, cluster = _as_make_managed_cluster(2, memory_mb=2048)
    try:
        auto = AllreduceTrainingAutoScaler(
            mgr, scaler, optimizer=None, interval_s=3600
        )
        plan = ResourcePlan(comment="count-only")
        plan.node_group_resources[NodeType.WORKER] = NodeGroupResource(
            count=3
        )
        auto.execute_plan(plan)
        assert (
            mgr.worker_manager.group_resource.node_resource.memory_mb
            == 2048
        )
    finally:
        mgr.stop()


# ---------------------------------------------------------------------------
# The reference's ``tests/test_hyperparams.py`` (strategy generator, the agent's tuner) on the port
# ---------------------------------------------------------------------------


def _hp_wait_until(predicate, timeout=5.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def _hp_make_manager(node_num=2):
    cluster = SimCluster()
    mgr = DistributedJobManager(
        job_name="hp-job",
        node_groups={NodeType.WORKER: NodeGroupResource(count=node_num)},
        scaler=SimScaler("hp-job", cluster),
        watcher=SimNodeWatcher("hp-job", cluster),
    )
    mgr.start()
    assert _hp_wait_until(
        lambda: len(
            [
                n
                for n in mgr.worker_manager.nodes.values()
                if n.status == NodeStatus.RUNNING
            ]
        )
        == node_num
    )
    return mgr, cluster


def test_balanced_mesh_shapes():
    assert _balanced_mesh(1) == {"dp": 1}
    assert _balanced_mesh(8) == {"fsdp": 8}
    assert _balanced_mesh(12) == {"dp": 3, "fsdp": 4}


def test_generator_suggests_batching():
    mgr, _ = _hp_make_manager(2)
    try:
        gen = SimpleStrategyGenerator(
            mgr, global_batch_size=64, devices_per_node=4
        )
        config = gen.generate()
        # 8 devices, global 64 -> share 8 -> micro 8, accum 1.
        assert config.micro_batch_size == 8
        assert config.grad_accum_steps == 1
        assert config.mesh_shape == {"fsdp": 8}
        assert config.version == 1
        # Unchanged world: same version (no churn for the tuner).
        assert gen.generate().version == 1
    finally:
        mgr.stop()


def test_generator_remat_after_oom():
    mgr, _ = _hp_make_manager(1)
    try:
        gen = SimpleStrategyGenerator(
            mgr, global_batch_size=8, devices_per_node=4
        )
        assert gen.generate().remat_policy == ""
        node = list(mgr.worker_manager.nodes.values())[0]
        node.exit_reason = NodeExitReason.OOM
        node.record_exit(NodeExitReason.OOM)
        config = gen.generate()
        # first OOM episode: the cheap escalation (attention stays
        # un-rematted); stable across polls with no new evidence
        assert config.remat_policy == "attn_save"
        assert config.version == 2
        assert gen.generate().remat_policy == "attn_save"
        # The relaunched incarnation OOMs AGAIN: the production path
        # builds the replacement record via get_relaunch_node (which
        # SHARES the lineage exit history) and records a second OOM
        # exit — that lineage signal escalates to full remat.
        relaunched = node.get_relaunch_node(node.id + 1000)
        relaunched.exit_reason = NodeExitReason.OOM
        relaunched.record_exit(NodeExitReason.OOM)
        # .nodes returns a copy; insert through the backing dict
        mgr.worker_manager._nodes[relaunched.id] = relaunched
        config = gen.generate()
        assert config.remat_policy == "full"
        assert config.version == 3
    finally:
        mgr.stop()


def test_tuner_writes_file_on_new_version(tmp_path):
    class FakeClient:
        def __init__(self):
            self.version = 1

        def get_parallel_config(self):
            return comm.ParallelConfig(
                micro_batch_size=4,
                grad_accum_steps=2,
                mesh_shape={"dp": 2},
                version=self.version,
            )

    client = FakeClient()
    path = str(tmp_path / "paral.json")
    tuner = ParalConfigTuner(client, config_path=path, interval_s=3600)
    assert tuner.tune_once()
    data = read_parallel_config(path)
    assert data["micro_batch_size"] == 4 and data["version"] == 1
    # Same version again: no rewrite.
    assert not tuner.tune_once()
    client.version = 2
    assert tuner.tune_once()
    assert read_parallel_config(path)["version"] == 2


def test_read_parallel_config_missing():
    assert read_parallel_config("/nonexistent/paral.json") is None


# ---------------------------------------------------------------------------
# The reference's topology cases (tests/test_brain_and_topology.py) on the
# port
# ---------------------------------------------------------------------------


def test_subnet_querier_blocks():
    q = SubnetTopologyQuerier()
    assert q.block_of(0, "10.1.2.3") == "10.1.2"
    assert q.block_of(1, "10.1.2.9") == "10.1.2"
    assert q.block_of(2, "10.1.3.3") == "10.1.3"
    assert q.block_of(3, "") == ""


def test_dp_topology_sorter_groups_slices():
    sorter = DpTopologySorter()
    world = {0: 1, 1: 1, 2: 1, 3: 1}
    # ranks 0,2 share slice A; 1,3 share slice B
    ips = {0: "10.0.1.1", 1: "10.0.2.1", 2: "10.0.1.2", 3: "10.0.2.2"}
    assert sorter.sort(world, ips) == [0, 2, 1, 3]


def test_topology_order_flows_to_agents():
    """With a sorter installed, the completed world's order follows
    physical blocks, and agents assign process ids by that order."""
    mgr = ElasticTrainingRendezvousManager()
    mgr.update_rdzv_params(min_nodes=4, max_nodes=4, waiting_timeout=60)
    mgr.set_topology_sorter(DpTopologySorter())
    ips = {0: "10.0.1.1", 1: "10.0.2.1", 2: "10.0.1.2", 3: "10.0.2.2"}
    for rank in range(4):
        mgr.join_rendezvous(rank, rank, 1, node_ip=ips[rank])
    _, _, world = mgr.get_comm_world(0)
    # Slice-mates adjacent: 0,2 (block .1) then 1,3 (block .2).
    assert list(world) == [0, 2, 1, 3]


# ---------------------------------------------------------------------------
# The port against the JAX package, on the same inputs
# ---------------------------------------------------------------------------


def _package(base):
    """One package's classes the differential tests drive."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{base}.{name}")

    sim = mod("testing.sim_cluster")
    return types.SimpleNamespace(
        SimCluster=sim.SimCluster, SimScaler=sim.SimScaler,
        SimNodeWatcher=sim.SimNodeWatcher,
        Manager=mod("master.node.dist_job_manager").DistributedJobManager,
        Node=mod("common.node").Node,
        Group=mod("common.node").NodeGroupResource,
        Resource=mod("common.node").NodeResource,
        JobContext=mod("master.node.job_context").JobContext,
        PerfMonitor=mod("master.monitor.perf_monitor").PerfMonitor,
        Sorter=mod("master.elastic_training.net_topology").DpTopologySorter,
        Optimizer=mod("master.resource.optimizer").AllreduceLocalOptimizer,
        Generator=mod(
            "master.hyperparams.simple_strategy_generator"
        ).SimpleStrategyGenerator,
        Collector=mod("master.stats.job_collector").JobMetricCollector,
    )


PACKAGES = ("dlrover_tpu", "dlrover_tpu_torch")


def _held_watcher(p, job, cluster):
    """The package's sim watcher whose stream the test drains itself
    (``_drain``): the manager's watch thread waits until stop, so every
    event is processed in order on the test's thread."""
    import threading

    class Held(p.SimNodeWatcher):
        def __init__(self):
            super().__init__(job, cluster)
            self._held = threading.Event()

        def watch(self):
            self._held.wait()
            return iter(())

        def stop(self):
            self._held.set()

    return Held()


def _drain(mgr, cluster):
    import queue

    events = cluster.events()
    while True:
        try:
            event = events.get_nowait()
        except queue.Empty:
            return
        if event is not None:
            mgr._process_event(event)


def _recorded_manager(p, cluster, plans, node_num=4, group_size=2,
                      max_relaunch=2):
    scaler = p.SimScaler("diff-job", cluster)
    real = scaler.scale

    def scale(plan):
        plans.append((
            sorted((n.id, n.rank_index) for n in plan.launch_nodes),
            sorted(n.id for n in plan.remove_nodes),
            {t: g.count for t, g in plan.node_group_resources.items()},
        ))
        real(plan)

    scaler.scale = scale
    return p.Manager(
        job_name="diff-job",
        node_groups={"worker": p.Group(
            count=node_num, node_resource=p.Resource(tpu_chips=4))},
        scaler=scaler,
        watcher=_held_watcher(p, "diff-job", cluster),
        max_relaunch_count=max_relaunch,
        node_group_size=group_size,
    )


def _table(mgr):
    return [
        (n.id, n.rank_index, n.status, n.relaunch_count, n.exit_reason,
         n.node_group, tuple(n.exit_history), n.relaunchable)
        for _, n in sorted(mgr.worker_manager.nodes.items())
    ]


def _scripted_run(base):
    """Kill, OOM through its budget, preemption, a broken host of a
    slice block, then a master restart over the same cluster."""
    p = _package(base)
    cluster = p.SimCluster()
    plans, tables = [], []
    mgr = _recorded_manager(p, cluster, plans)

    def latest(rank):
        return max((n for n in mgr.worker_manager.nodes.values()
                    if n.rank_index == rank), key=lambda n: n.id)

    mgr.start()
    try:
        _drain(mgr, cluster)
        tables.append(_table(mgr))
        cluster.fail_node(latest(0).id, "Killed")
        _drain(mgr, cluster)
        tables.append(_table(mgr))
        for _ in range(3):  # OOM's budget is max_relaunch (2)
            cluster.fail_node(latest(1).id, "OOMKilled")
            _drain(mgr, cluster)
            tables.append(_table(mgr))
        cluster.preempt_node(latest(2).id)
        _drain(mgr, cluster)
        tables.append(_table(mgr))
        cluster.break_node(latest(3).id)
        _drain(mgr, cluster)
        tables.append(_table(mgr))
        ctx = _job_context_of(base)
        stage, failures = ctx.job_stage, ctx.failure_count
    finally:
        mgr.stop()
    # The master restarts: a new manager over the running cluster.
    p.JobContext.reset_singleton()
    mgr2 = _recorded_manager(p, cluster, plans)
    mgr2.start()
    try:
        _drain(mgr2, cluster)
        tables.append(_table(mgr2))
        alive = sorted((n.id, n.rank_index, n.status)
                       for n in cluster.list_nodes())
    finally:
        mgr2.stop()
    return tables, plans, alive, stage, failures


def _job_context_of(base):
    import importlib

    ctx = importlib.import_module(f"{base}.master.node.job_context")
    return ctx.get_job_context()


def test_scripted_cluster_gives_equal_node_tables_and_plans():
    ref, port = (_scripted_run(base) for base in PACKAGES)
    assert port == ref
    tables, plans, alive, stage, failures = port
    # The script did what it says: rank 1 ran out of OOM budget (three
    # records, the last not relaunched) and the block of ranks 2 and 3
    # was relaunched whole.
    final = tables[-2]
    rank1 = [row for row in final if row[1] == 1]
    assert [row[4] for row in rank1] == ["OOMKilled"] * 3
    assert rank1[-1][2] == NodeStatus.FAILED
    assert any(remove for _, remove, _ in plans)
    # A kill, three OOMs and the broken host count as failures; the
    # preemption (a deletion) does not.
    assert stage == JobStage.RUNNING and failures == 5
    # The new master adopted ranks 0, 2 and 3 and launched rank 1 anew.
    assert sorted(rank for _, rank, status in alive
                  if status == NodeStatus.RUNNING) == [0, 1, 2, 3]


@pytest.mark.parametrize("seed", range(3))
def test_topology_sorter_equals_the_reference(seed):
    ref, port = (_package(b).Sorter() for b in PACKAGES)
    rng = random.Random(seed)
    for _ in range(40):
        ranks = rng.sample(range(64), rng.randint(1, 16))
        world = {r: rng.randint(1, 8) for r in ranks}
        ips = {r: f"10.{rng.randint(0, 1)}.{rng.randint(0, 3)}."
                  f"{rng.randint(1, 9)}"
               for r in ranks if rng.random() < 0.85}
        if rng.random() < 0.2:
            ips[ranks[0]] = "not-an-ip"
        assert port.sort(world, ips) == ref.sort(world, ips)


def _stub_job_manager(p, rng_state):
    """A job manager surface of one package: running nodes and records
    with exit reasons, as the optimizer reads them."""
    count, ooms = rng_state
    group = p.Group(count=count, node_resource=p.Resource(memory_mb=1024.0))
    nodes = {}
    for i in range(count + len(ooms)):
        node = p.Node("worker", i, rank_index=i % max(count, 1))
        node.status = NodeStatus.RUNNING if i < count else NodeStatus.FAILED
        if i >= count:
            node.exit_reason = ooms[i - count]
        nodes[i] = node
    wm = types.SimpleNamespace(
        group_resource=group, nodes=nodes,
        running_nodes=lambda: [n for n in nodes.values()
                               if n.status == NodeStatus.RUNNING])
    return types.SimpleNamespace(worker_manager=wm)


@pytest.mark.parametrize("seed", range(4))
def test_local_optimizer_equals_the_reference(seed):
    """A seeded stream of worker counts, speeds and OOM exits through
    both packages' optimizer (no cooldown): the same plans."""
    rng = random.Random(seed)
    legal = sorted(rng.sample([1, 2, 4, 6, 8, 12, 16], rng.randint(0, 5)))
    script = []
    for _ in range(30):
        script.append((
            rng.choice(legal or [2]),
            rng.uniform(0.5, 4.0) if rng.random() < 0.8 else 0.0,
            [rng.choice(["OOMKilled", "Killed", ""])
             for _ in range(rng.randint(0, 2))],
        ))
    plans = {}
    for base in PACKAGES:
        p = _package(base)
        out = []
        perf = types.SimpleNamespace(speed=0.0)
        perf.running_speed = lambda perf=perf: perf.speed
        opt = p.Optimizer(None, perf, legal_counts=legal or None,
                          min_scaling_efficiency=0.7, cooldown_s=0.0)
        for count, speed, ooms in script:
            opt._job_manager = _stub_job_manager(p, (count, ooms))
            perf.speed = speed
            opt.record_speed()
            plan = opt.generate_plan()
            out.append((plan.comment, {
                t: (g.count, g.node_resource.memory_mb)
                for t, g in plan.node_group_resources.items()}))
        plans[base] = out
    assert plans["dlrover_tpu_torch"] == plans["dlrover_tpu"]
    assert any(groups for _, groups in plans["dlrover_tpu"]) or not legal


def _manager_without_cluster(p, count, chips):
    """One package's job manager whose records the test writes itself."""
    cluster = p.SimCluster()
    mgr = p.Manager(
        job_name="gen-job",
        node_groups={"worker": p.Group(
            count=count, node_resource=p.Resource(tpu_chips=chips))},
        scaler=p.SimScaler("gen-job", cluster),
        watcher=p.SimNodeWatcher("gen-job", cluster),
    )
    mgr.worker_manager.init_nodes()
    return mgr


@pytest.mark.parametrize("seed", range(4))
def test_strategy_generator_equals_the_reference(seed):
    """A seeded script of world sizes, chips per host, global batches
    and OOM exits: both packages' generators suggest the same knobs
    (micro batch, accumulation, remat, mesh) under the same versions."""
    rng = random.Random(seed)
    batch = rng.choice([0, 64, 96, 256, 1000, 1024])
    chips = rng.choice([0, 1, 4, 8])
    script = [(rng.randint(0, 6), rng.random() < 0.3) for _ in range(12)]
    seen = {}
    for base in PACKAGES:
        p = _package(base)
        mgr = _manager_without_cluster(p, 6, chips)
        gen = p.Generator(mgr, global_batch_size=batch, devices_per_node=4)
        nodes = sorted(mgr.worker_manager.nodes.values(), key=lambda n: n.id)
        out = []
        for running, oom in script:
            for i, node in enumerate(nodes):
                node.status = (NodeStatus.RUNNING if i < running
                               else NodeStatus.PENDING)
            if oom:
                victim = nodes[len(out) % len(nodes)]
                victim.exit_reason = "OOMKilled"
                victim.record_exit("OOMKilled")
            cfg = gen.generate()
            out.append(None if cfg is None else (
                cfg.micro_batch_size, cfg.grad_accum_steps,
                cfg.remat_policy, dict(cfg.mesh_shape), cfg.version))
        seen[base] = out
    assert seen["dlrover_tpu_torch"] == seen["dlrover_tpu"]


def test_balanced_mesh_equals_the_reference():
    from dlrover_tpu.master.hyperparams import (
        simple_strategy_generator as ref_gen,
    )

    for n in range(0, 130):
        assert _balanced_mesh(n) == ref_gen._balanced_mesh(n)


def test_job_metric_collector_equals_the_reference():
    """Both packages' collectors over the same job state and perf
    reports: equal samples (but their timestamps) and an equal
    completion record (but its duration)."""
    rng = random.Random(0)
    reports = [(s, 1000.0 + 2.0 * s + rng.random()) for s in range(1, 20)]
    phases = [(rng.randint(0, 3), rng.choice(["train", "ckpt", "restart"]),
               1000.0 + i, 1000.5 + i + rng.random())
              for i in range(12)]
    samples, completions = {}, {}
    for base in PACKAGES:
        p = _package(base)
        mgr = _manager_without_cluster(p, 4, 4)
        for i, node in enumerate(sorted(mgr.worker_manager.nodes.values(),
                                        key=lambda n: n.id)):
            node.status = (NodeStatus.RUNNING if i < 3
                           else NodeStatus.FAILED)
            node.update_from_resource_stats(10.0 * i, 512.0 * i)
        perf = p.PerfMonitor()
        perf._init_time = 999.0
        collector = p.Collector("stats-job", mgr, perf)
        out = []
        for step, ts in reports:
            perf.collect_global_step(step, ts)
            if step % 5 == 0:
                for node_id, phase, start, end in phases:
                    perf.collect_phase(node_id, phase, start, end)
                sample = collector.collect_once()
                out.append((sample.global_step, sample.speed,
                            sample.goodput, sample.worker_count,
                            sample.node_usage))
        collector.report_completion(False, "WorkerError", 3)
        record = collector.reporter.completions[-1]
        samples[base] = out
        completions[base] = (record.job_name, record.success,
                             record.exit_reason, record.failure_count)
    assert samples["dlrover_tpu_torch"] == samples["dlrover_tpu"]
    assert completions["dlrover_tpu_torch"] == completions["dlrover_tpu"]
    assert len(samples["dlrover_tpu"]) == 3


# ---------------------------------------------------------------------------
# The CLI, and what waits for ROADMAP §A item 8b
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--platform", "k8s"],
    ["--platform", "gke_tpu"],
    ["--platform", "sim", "--dashboard_port", "0"],
    ["--platform", "sim", "--brain_addr", "localhost:1"],
])
def test_unported_platforms_and_flags_raise_naming_8b(argv):
    from dlrover_tpu_torch.master import main

    with pytest.raises(NotImplementedError, match="ROADMAP §A item 8b"):
        main.main(argv + ["--port", "0"])


def test_from_args_builds_the_sim_master_with_every_flag():
    """The distributed master's flags parse and reach the master: the
    topology sorter, the slice blocks, the legal counts, the
    throughput auto-scaler, the metric endpoints."""
    from dlrover_tpu_torch.master.args import parse_master_args
    from dlrover_tpu_torch.master.dist_master import DistributedJobMaster

    master = DistributedJobMaster.from_args(parse_master_args([
        "--platform", "sim", "--node_num", "4", "--namespace", "ns",
        "--network_check", "--topology_aware", "--node_unit", "2",
        "--auto_scale", "--legal_worker_counts", "2,4,8",
        "--metric_endpoints", "0=127.0.0.1:1,1=127.0.0.1:2",
        "--job_name", "flags-job"]))
    try:
        assert master.job_manager._node_group_size == 2
        assert master.auto_scaler is not None
        assert master.metric_monitor is not None
        assert master.rescale_coordinator is not None
        rdzv = master.rdzv_managers["training"]
        assert rdzv._topology_sorter is not None
        assert master._server.__class__.__name__ == "HttpMasterServer"
    finally:
        _close_unstarted(master)
    with pytest.raises(SystemExit, match="--metric_endpoints"):
        DistributedJobMaster.from_args(parse_master_args([
            "--platform", "sim", "--metric_endpoints", "nope"]))


def _close_unstarted(master):
    """Close the RPC port of a master that was never prepared (a server
    that never served cannot be shut down, only started and stopped)."""
    master._server.start()
    master._server.stop()


def _cli_env(root, job, rank, tag):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               DLROVER_TPU_JOB_NAME=job,
               DLROVER_TPU_SHARED_DIR=os.path.join(root, f"sock{rank}"),
               DLROVER_TPU_EVENT_DIR=os.path.join(root, tag, "events"),
               DLROVER_TPU_FLIGHT_DIR=os.path.join(root, "flight"))
    env.pop("DLROVER_TPU_NODE_RANK", None)
    env.pop("DLROVER_TPU_FAULT_SCHEDULE", None)
    return env


def test_cli_sim_master_serves_two_launchers_through_a_lost_host(
        tmp_path, monkeypatch):
    """``python -m dlrover_tpu_torch.master.main --platform sim
    --node_num 2 --pre_check --port_file f`` with two launchers on the
    CPU (``testing/replica_worker``, the tiny config). Node 1's host is
    lost once its step 3 is committed (launcher and worker SIGKILLed,
    its segment unlinked) and reported to the master as its cluster
    would (a node-level failure with a preemption hint); the master
    relaunches rank 1 through its sim scaler, a fresh launcher joins as
    rank 1 with its rank as its id, and both ranks train to step 5. The
    agents' success reports end the job: the master exits 0. (With the
    reference's handlers the relaunched agent's reports land on the
    dead incarnation and the master never exits.)"""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.flash_ckpt import storage
    from dlrover_tpu_torch.flash_ckpt.shm_handler import SharedMemoryHandler

    root = str(tmp_path)
    job = f"climaster{os.getpid()}"
    port_file = os.path.join(root, "port")
    ckpt, release = os.path.join(root, "ckpt"), os.path.join(root, "go")
    master_log = open(os.path.join(root, "master.log"), "w")
    master = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.master.main",
         "--platform", "sim", "--node_num", "2", "--pre_check",
         "--port_file", port_file, "--job_name", job],
        env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=master_log,
        stderr=subprocess.STDOUT)
    launchers = []

    def launch(rank, tag, steps, hold):
        os.makedirs(os.path.join(root, tag))
        lc = chip_smoke._Launcher(
            ["--config", "tiny", "--layers", "2", "--seq", "8",
             "--device", "cpu", "--steps", str(steps),
             "--persist-every", "3", "--ckpt-dir", ckpt,
             "--hold-file", hold],
            _cli_env(root, job, rank, tag),
            os.path.join(root, tag, "launcher.log"),
            launch=("--master", addr, "--node_rank", str(rank),
                    "--nnodes", "2", "--nproc_per_node", "1",
                    "--max_restarts", "3", "--monitor_interval", "0.2",
                    "-m", "dlrover_tpu_torch.testing.replica_worker"),
            phase="cli")
        launchers.append(lc)
        return lc

    def until(cond, what, timeout=180.0):
        deadline = time.monotonic() + timeout
        while not cond():
            assert master.poll() is None, f"the master exited before {what}"
            assert time.monotonic() < deadline, f"no {what}"
            time.sleep(0.05)

    client = None
    try:
        until(lambda: os.path.exists(port_file), "port file", 60.0)
        addr = f"localhost:{open(port_file).read().strip()}"
        client = MasterClient(addr, node_id=1)
        node0 = launch(0, "node0", 5, release)
        lost = launch(1, "node1", 3, os.path.join(root, "never"))
        node0.wait_event(lambda e: e["event"] == "saved" and e["step"] == 5,
                         "node 0's last save", 180.0)
        lost.wait_event(lambda e: e["event"] == "saved" and e["step"] == 3,
                        "node 1's save", 180.0)
        until(lambda: storage.read_tracker(ckpt) >= 3, "the commit of 3")
        _, workers = lost.pids()
        pids = [lost.proc.pid, *workers]
        for pid in pids:
            os.kill(pid, signal.SIGKILL)
        until(lambda: all(chip_smoke._proc_gone(p) for p in pids),
              "node 1's exit")
        with chip_smoke._process_env({"DLROVER_TPU_JOB_NAME": job,
                                      "DLROVER_TPU_NODE_RANK": "1"}):
            from dlrover_tpu_torch.flash_ckpt.engine import shm_segment_name

            SharedMemoryHandler(shm_segment_name(0)).unlink()
        client.report_failure("reason=Preempted codes={0: 137}",
                              node_rank=1, exit_code=137,
                              level=TrainingExceptionLevel.NODE_ERROR)

        def rank1_nodes():
            return {int(i): n for i, n in client.get_job_detail().nodes.items()
                    if n["rank"] == 1}

        until(lambda: len(rank1_nodes()) == 2, "rank 1's relaunch")
        relaunch = launch(1, "node1_relaunch", 5, release)
        ready = relaunch.wait_event(lambda e: e["event"] == "ready",
                                    "the relaunch's ready line", 180.0)
        relaunch.wait_event(lambda e: e["event"] == "saved"
                            and e["step"] == 5, "the relaunch's save", 180.0)
        detail = rank1_nodes()
        with open(release, "w"):
            pass
        rcs = [lc.proc.wait(timeout=120) for lc in (node0, relaunch)]
        master_rc = master.wait(timeout=60)
    finally:
        if client is not None:
            client.close()
        for lc in launchers:
            lc.stop()
        if master.poll() is None:
            master.kill()
            master.wait()
        master_log.close()
        chip_smoke._unlink_job_segments(job)
    log = open(os.path.join(root, "master.log")).read()
    assert master_rc == 0, log[-3000:]
    assert rcs == [0, 0]
    assert "pre-check ConnectionPreCheckOperator passed" in log
    assert "all workers succeeded; master exiting" in log
    assert ready["restored_from"] == "storage" and ready["restored_step"] == 3
    (old_id, old), (new_id, new) = sorted(detail.items())
    # The failed record was removed from the cluster by its relaunch.
    assert old["status"] == NodeStatus.DELETED and old["relaunch_count"] == 0
    assert new["status"] == NodeStatus.RUNNING and new["relaunch_count"] == 1
    steps = [e["step"] for e in relaunch.events if e["event"] == "step"]
    assert steps == [4, 5]


# ---------------------------------------------------------------------------
# The port's divergences from the reference
# ---------------------------------------------------------------------------


def _started_manager(base, node_num=2):
    p = _package(base)
    cluster = p.SimCluster()
    mgr = p.Manager(
        job_name="alias-job",
        node_groups={"worker": p.Group(count=node_num)},
        scaler=p.SimScaler("alias-job", cluster),
        watcher=_held_watcher(p, "alias-job", cluster),
    )
    mgr.start()
    _drain(mgr, cluster)
    return mgr, cluster


def _relaunched_rank_reports(base):
    """Rank 1's host is lost and relaunched; its new agent joins,
    heartbeats and succeeds with its rank as its id (the launcher's
    ``node_id = node_rank``). Returns each record's (id, status,
    heartbeat seen)."""
    mgr, cluster = _started_manager(base)
    try:
        for node_id in (0, 1):
            mgr.handle_node_joined(node_id, node_id)
        cluster.preempt_node(1)
        _drain(mgr, cluster)
        mgr.handle_node_joined(1, 1)
        mgr.collect_node_heartbeat(1, 12345.0)
        mgr.handle_node_succeeded(1)
        mgr.handle_node_succeeded(0)
        _drain(mgr, cluster)
        return [(n.id, n.rank_index, n.status, n.heartbeat_time == 12345.0)
                for _, n in sorted(mgr.worker_manager.nodes.items())], (
            mgr.all_workers_exited(), mgr.all_workers_succeeded())
    finally:
        mgr.stop()


def test_relaunched_agent_reporting_its_rank_lands_on_the_live_incarnation():
    nodes, done = _relaunched_rank_reports("dlrover_tpu_torch")
    assert nodes == [(0, 0, NodeStatus.SUCCEEDED, False),
                     (1, 1, NodeStatus.DELETED, False),
                     (2, 1, NodeStatus.SUCCEEDED, True)]
    assert done == (True, True)
    # The reference's handlers look the id up first, find the dead
    # incarnation and leave the live one without a report: its job
    # never ends by its agents' reports.
    ref_nodes, ref_done = _relaunched_rank_reports("dlrover_tpu")
    assert ref_nodes[1][3] and not ref_nodes[2][3]
    assert ref_done == (False, False)


def test_success_report_of_a_node_without_an_alias_ends_it():
    mgr, cluster = _started_manager("dlrover_tpu_torch", node_num=1)
    try:
        mgr.handle_node_joined(0, 0)
        mgr.handle_node_succeeded(0)
        node = mgr.worker_manager.nodes[0]
        assert node.status == NodeStatus.SUCCEEDED
        assert node.reported_status == NodeStatus.SUCCEEDED
        assert mgr.all_workers_succeeded()
        # The cluster's own exit event afterwards changes nothing.
        cluster.succeed_node(0)
        _drain(mgr, cluster)
        assert node.status == NodeStatus.SUCCEEDED
        assert get_job_context().failure_count == 0
    finally:
        mgr.stop()


def _hang_master(tmp_path):
    from dlrover_tpu_torch.diagnosis.diagnosticians.training_hang import (
        TrainingHangDiagnostician,
    )
    from dlrover_tpu_torch.master.dist_master import DistributedJobMaster

    cluster = SimCluster()
    master = DistributedJobMaster(
        port=0, job_name="hang-job", node_num=1,
        scaler=SimScaler("hang-job", cluster),
        watcher=SimNodeWatcher("hang-job", cluster),
        transport="http", metric_endpoints={0: "127.0.0.1:1"})
    hang = [d for d in master.diagnosis_master.manager._diagnosticians
            if isinstance(d, TrainingHangDiagnostician)]
    assert len(hang) == 1 and master.metric_monitor is not None
    return master, hang[0]


def _flat_native_counter(master, value=110.0):
    from dlrover_tpu_torch.common.metric import STEP_COUNTER

    now = time.time()
    for i in range(3):
        master.metric_monitor.context.record(
            0, {STEP_COUNTER: value}, ts=now - 3 + i)


def test_advancing_in_band_steps_veto_a_hang_of_flat_native_counters(
        tmp_path):
    """Through the port's ``DistributedJobMaster`` with
    ``metric_endpoints`` (the hang diagnostician gets the metric
    monitor's context): every native step counter is flat, and the
    in-band global step rises between two observations. The reference
    calls that a hang; the port does not."""
    master, hang = _hang_master(tmp_path)
    try:
        _flat_native_counter(master)
        master.perf_monitor.collect_global_step(100, time.time())
        first = hang.observe()
        master.perf_monitor.collect_global_step(120, time.time())
        second = hang.observe()
        # One observation is no evidence of advance: the flat counters
        # still corroborate, as in the reference.
        assert first.observation == "training-hang"
        assert second.observation == ""
    finally:
        _close_unstarted(master)


def test_flat_native_counters_still_mark_a_hang_when_in_band_is_flat(
        tmp_path):
    master, hang = _hang_master(tmp_path)
    try:
        _flat_native_counter(master)
        for _ in range(3):
            master.perf_monitor.collect_global_step(100, time.time())
            assert hang.observe().observation == "training-hang"
    finally:
        _close_unstarted(master)


class _BadStatusServer:
    """A TCP server that answers every request with a garbage status
    line (``http.client.BadStatusLine``, an ``HTTPException``) or an
    undecodable body."""

    def __init__(self, payload):
        import socket
        import threading

        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self.addr = f"127.0.0.1:{self._sock.getsockname()[1]}"
        self._payload = payload
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with conn:
                conn.recv(4096)
                conn.sendall(self._payload)

    def close(self):
        self._sock.close()


@pytest.mark.parametrize("payload", [
    b"garbage\r\n\r\n",
    b"HTTP/1.1 200 OK\r\nContent-Length: 4\r\n\r\n\xff\xfe\xfd\xfc",
], ids=["bad_status_line", "undecodable_body"])
def test_scrape_round_survives_one_endpoint_s_bad_answer(payload):
    """``JobMetricMonitor.scrape_once`` over three endpoints, the middle
    one answering garbage: it is recorded unreachable and the others
    are scraped (the reference's round raises and scrapes neither the
    bad node's record nor the nodes after it)."""
    import http.server
    import threading

    from dlrover_tpu_torch.common.metric import STEP_COUNTER, JobMetricMonitor

    class Metrics(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = b'tpu_timer_counter{name="steps"} 7\n'
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    good = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Metrics)
    threading.Thread(target=good.serve_forever, daemon=True).start()
    bad = _BadStatusServer(payload)
    good_addr = f"127.0.0.1:{good.server_address[1]}"
    try:
        monitor = JobMetricMonitor({0: good_addr, 1: bad.addr, 2: good_addr},
                                   timeout_s=2.0)
        assert monitor.scrape_once() == 2
        summary = monitor.context.summary()
        assert summary[1] == {"unreachable_scrapes": 1}
        assert monitor.context.latest(0, STEP_COUNTER) == 7
        assert monitor.context.latest(2, STEP_COUNTER) == 7
    finally:
        good.shutdown()
        good.server_close()
        bad.close()


def test_sim_node_failure_reaches_the_autoscale_loop_s_fault_history():
    """``--autoscale_loop`` on the sim platform: a node's failure in
    the cluster reaches the loop's ``FaultHistory`` (``_FaultFeed``), so
    the Young/Daly cadence rule sees the job's own MTBF."""
    from dlrover_tpu_torch.master.args import parse_master_args
    from dlrover_tpu_torch.master.dist_master import DistributedJobMaster

    master = DistributedJobMaster.from_args(parse_master_args([
        "--platform", "sim", "--node_num", "2", "--autoscale_loop",
        "--autoscale_dry_run", "--autoscale_interval_s", "0.2",
        "--job_name", "fault-feed-job"]))
    cluster = master.job_manager._scaler._cluster
    master.prepare()
    try:
        assert master.fault_history.failures_total == 0
        victim = sorted(n.id for n in cluster.list_nodes())[0]
        cluster.fail_node(victim, NodeExitReason.KILLED)
        deadline = time.monotonic() + 10.0
        while master.fault_history.failures_total < 1:
            assert time.monotonic() < deadline, "no failure recorded"
            time.sleep(0.02)
        # The relaunched node's own failure is one more.
        deadline = time.monotonic() + 10.0
        while max(n.id for n in cluster.list_nodes()) < 2:
            assert time.monotonic() < deadline, "no relaunch"
            time.sleep(0.02)
        cluster.break_node(max(n.id for n in cluster.list_nodes()))
        deadline = time.monotonic() + 10.0
        while master.fault_history.failures_total < 2:
            assert time.monotonic() < deadline, "no second failure"
            time.sleep(0.02)
        assert master.autoscaler is not None
    finally:
        master.stop()
