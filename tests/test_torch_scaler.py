"""The port's master/scaler (``base_scaler.py``, ``sim_scaler.py``),
from the reference's ``tests/test_scaler.py``: ScalePlan semantics and
the Scaler ABC contract, exercised through the SimClusterScaler
backend."""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)

import pytest

from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.node import Node, NodeGroupResource, NodeResource
from dlrover_tpu_torch.master.scaler.base_scaler import (
    ScalePlan,
    Scaler,
    new_node_id_iter,
)
from dlrover_tpu_torch.master.scaler.sim_scaler import SimClusterScaler


# ---------------------------------------------------------------------------
# ScalePlan construction / merge semantics
# ---------------------------------------------------------------------------


def test_scale_plan_empty_semantics():
    plan = ScalePlan()
    assert plan.empty()
    plan.ps_addrs = ["host:1"]
    # ps_addrs alone does not make a plan actionable.
    assert plan.empty()
    plan.launch_nodes.append(Node(NodeType.WORKER, 0))
    assert not plan.empty()
    assert not ScalePlan(
        node_group_resources={NodeType.WORKER: NodeGroupResource(2)}
    ).empty()
    assert not ScalePlan(
        remove_nodes=[Node(NodeType.WORKER, 1)]
    ).empty()


def test_scale_plan_merge_updates_groups_and_extends_lists():
    a = ScalePlan(
        node_group_resources={
            NodeType.WORKER: NodeGroupResource(2),
            "ps": NodeGroupResource(1),
        },
        launch_nodes=[Node(NodeType.WORKER, 0)],
        remove_nodes=[Node(NodeType.WORKER, 9)],
        ps_addrs=["old:1"],
    )
    b = ScalePlan(
        node_group_resources={NodeType.WORKER: NodeGroupResource(4)},
        launch_nodes=[Node(NodeType.WORKER, 1)],
        ps_addrs=["new:1", "new:2"],
    )
    a.merge(b)
    # Same-role group: the merged-in target wins; untouched roles stay.
    assert a.node_group_resources[NodeType.WORKER].count == 4
    assert a.node_group_resources["ps"].count == 1
    assert [n.id for n in a.launch_nodes] == [0, 1]
    assert [n.id for n in a.remove_nodes] == [9]
    assert a.ps_addrs == ["new:1", "new:2"]
    # Merging a plan with no ps_addrs must NOT wipe the existing list.
    a.merge(ScalePlan())
    assert a.ps_addrs == ["new:1", "new:2"]


def test_scaler_abc_contract():
    with pytest.raises(TypeError):
        Scaler("job")  # abstract: scale() required

    class Minimal(Scaler):
        def __init__(self):
            super().__init__("job")
            self.plans = []

        def scale(self, plan):
            self.plans.append(plan)

    s = Minimal()
    # Defaults are safe no-ops on any backend.
    s.start()
    s.set_master_addr("h:1")
    s.stop()
    s.scale(ScalePlan())
    assert len(s.plans) == 1
    ids = new_node_id_iter(5)
    assert [next(ids) for _ in range(3)] == [5, 6, 7]


# ---------------------------------------------------------------------------
# SimClusterScaler: the working backend
# ---------------------------------------------------------------------------


def _group_plan(count, resource=None):
    plan = ScalePlan()
    plan.node_group_resources[NodeType.WORKER] = NodeGroupResource(
        count=count, node_resource=resource or NodeResource()
    )
    return plan


def test_sim_scaler_group_convergence_is_idempotent():
    s = SimClusterScaler("t", capacity=16)
    s.scale(_group_plan(4))
    nodes = s.alive_nodes(NodeType.WORKER)
    assert [n.rank_index for n in nodes] == [0, 1, 2, 3]
    ids = {n.id for n in nodes}
    # Re-applying the same plan changes nothing (ABC: idempotent).
    s.scale(_group_plan(4))
    assert {n.id for n in s.alive_nodes()} == ids
    # Shrink removes the highest ranks first.
    s.scale(_group_plan(2))
    assert [n.rank_index for n in s.alive_nodes()] == [0, 1]
    # Grow fills the freed ranks.
    s.scale(_group_plan(3))
    assert [n.rank_index for n in s.alive_nodes()] == [0, 1, 2]
    assert s.world_size() == 3


def test_sim_scaler_explicit_launch_remove_and_capacity():
    s = SimClusterScaler("t", capacity=2)
    s.scale(ScalePlan(launch_nodes=[
        Node(NodeType.WORKER, 100, rank_index=0),
        Node(NodeType.WORKER, 101, rank_index=1),
    ]))
    assert s.world_size() == 2
    # Cluster full: the third launch is dropped, visibly.
    s.scale(ScalePlan(launch_nodes=[
        Node(NodeType.WORKER, 102, rank_index=2),
    ]))
    assert s.world_size() == 2
    assert s.launches_dropped == 1
    # Re-launching a present id is a no-op, not a duplicate.
    s.scale(ScalePlan(launch_nodes=[
        Node(NodeType.WORKER, 100, rank_index=0),
    ]))
    assert s.world_size() == 2
    # Removing an absent id is a no-op; removing a present one frees
    # capacity.
    s.scale(ScalePlan(remove_nodes=[Node(NodeType.WORKER, 555)]))
    s.scale(ScalePlan(remove_nodes=[Node(NodeType.WORKER, 101)]))
    assert [n.id for n in s.alive_nodes()] == [100]
    s.scale(ScalePlan(launch_nodes=[
        Node(NodeType.WORKER, 102, rank_index=1),
    ]))
    assert {n.id for n in s.alive_nodes()} == {100, 102}


def test_sim_scaler_evict_and_replace_preserves_world():
    """The autoscaler's evict-and-replace shape: one plan removing a
    flagged node and launching a fresh one in the same rank seat."""
    events = []
    s = SimClusterScaler(
        "t", capacity=8,
        on_scale=lambda job, up, down: events.append(
            ([n.id for n in up], [n.id for n in down])
        ),
    )
    s.scale(_group_plan(3))
    victim = s.find_rank(1)
    assert victim is not None
    replacement = Node(
        NodeType.WORKER, s.next_node_id(), rank_index=1
    )
    s.scale(ScalePlan(
        remove_nodes=[victim], launch_nodes=[replacement]
    ))
    assert s.world_size() == 3
    assert s.find_rank(1).id == replacement.id
    assert victim.id not in {n.id for n in s.alive_nodes()}
    # The callback saw both the boot launch and the swap.
    assert events[0] == ([0, 1, 2], [])
    assert events[1] == ([replacement.id], [victim.id])


def test_sim_scaler_mixed_plan_applies_removals_first():
    """remove + group-converge in one plan: the removal frees the seat
    the convergence refills — net effect is a replace."""
    s = SimClusterScaler("t", capacity=4)
    s.scale(_group_plan(4))
    victim = s.find_rank(2)
    plan = ScalePlan(remove_nodes=[victim])
    plan.node_group_resources[NodeType.WORKER] = NodeGroupResource(4)
    s.scale(plan)
    assert s.world_size() == 4
    assert s.find_rank(2).id != victim.id
