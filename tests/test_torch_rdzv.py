"""The port's rendezvous managers against the JAX package's.

Each scenario of the reference's ``tests/test_rdzv_manager.py`` (and
the group-aware network check and a node-group world) runs on both
packages' ``master/elastic_training/rdzv_manager.py`` in this process;
the two transcripts of what the managers answered must be equal, and
the reference test's own assertions hold on the port's.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import importlib
import math
import time

import pytest

from tests.torch_event_guard import events_off

PACKAGES = ("dlrover_tpu", "dlrover_tpu_torch")


@pytest.fixture(autouse=True)
def _no_event_files(monkeypatch):
    events_off(monkeypatch)


def _rdzv(pkg):
    return importlib.import_module(f"{pkg}.master.elastic_training"
                                   ".rdzv_manager")


def round_completes_at_max_nodes(r, log):
    mgr = r.ElasticTrainingRendezvousManager()
    mgr.update_rdzv_params(min_nodes=2, max_nodes=2, waiting_timeout=60)
    log("join0", mgr.join_rendezvous(0, 0, 1))
    log("world_partial", mgr.get_comm_world(0))
    log("join1", mgr.join_rendezvous(1, 1, 1))
    log("world", mgr.get_comm_world(0))
    log("waiting", mgr.num_nodes_waiting())
    log("groups", mgr.latest_node_groups())


def round_completes_with_min_after_timeout(r, log):
    mgr = r.ElasticTrainingRendezvousManager()
    mgr.update_rdzv_params(min_nodes=1, max_nodes=4, waiting_timeout=0.2)
    mgr.join_rendezvous(0, 0, 1)
    log("world_early", mgr.get_comm_world(0))
    time.sleep(0.25)
    log("world", mgr.get_comm_world(0))


def node_unit_truncates_world(r, log):
    mgr = r.ElasticTrainingRendezvousManager()
    mgr.update_rdzv_params(min_nodes=2, max_nodes=8, waiting_timeout=0.1,
                           node_unit=2)
    for i in range(5):
        mgr.join_rendezvous(i, i, 1)
    time.sleep(0.15)
    log("world", mgr.get_comm_world(0))
    log("waiting", mgr.num_nodes_waiting())


def legal_counts_fn_mesh_topologies(r, log):
    mgr = r.ElasticTrainingRendezvousManager()
    mgr.update_rdzv_params(min_nodes=2, max_nodes=8, waiting_timeout=0.1)
    mgr.set_legal_counts_fn(
        lambda max_n, unit: [n for n in (1, 2, 4, 8) if n <= max_n])
    for i in range(7):
        mgr.join_rendezvous(i, i, 1)
    time.sleep(0.15)
    log("world", mgr.get_comm_world(0))


def dead_node_removed_from_waiting(r, log):
    mgr = r.ElasticTrainingRendezvousManager()
    mgr.update_rdzv_params(min_nodes=2, max_nodes=2, waiting_timeout=60)
    mgr.join_rendezvous(0, 0, 1)
    mgr.join_rendezvous(1, 1, 1)
    mgr.remove_alive_node(1)
    log("world", mgr.get_comm_world(0))
    log("waiting", mgr.num_nodes_waiting())


def next_round_after_a_restart(r, log):
    """A completed round, then both nodes rejoin (an agent restart): the
    round counter advances and the world forms again."""
    mgr = r.ElasticTrainingRendezvousManager()
    mgr.update_rdzv_params(min_nodes=2, max_nodes=2, waiting_timeout=60)
    for rnd in range(2):
        for i in (1, 0):
            log(f"join{rnd}_{i}", mgr.join_rendezvous(i, i, 2))
        log(f"world{rnd}", mgr.get_comm_world(1))


def node_groups_form_whole_slices(r, log):
    mgr = r.ElasticTrainingRendezvousManager()
    mgr.update_rdzv_params(min_nodes=2, max_nodes=6, waiting_timeout=0.1,
                           node_unit=2)
    for i, g in zip(range(5), (0, 1, 0, 2, 1)):
        mgr.join_rendezvous(i, i, 1, node_group=g)
    time.sleep(0.15)
    log("world", mgr.get_comm_world(0))
    log("groups", mgr.latest_node_groups())
    log("waiting", mgr.num_nodes_waiting())


def network_check_pair_grouping_and_fault_isolation(r, log):
    mgr = r.NetworkCheckRendezvousManager()
    mgr.update_rdzv_params(min_nodes=4, max_nodes=4, waiting_timeout=60)
    for i in range(4):
        mgr.join_rendezvous(i, i, 1)
    log("world0", mgr.get_comm_world(0))
    log("world2", mgr.get_comm_world(2))
    mgr.report_network_check_result(0, True, 1.0)
    mgr.report_network_check_result(1, True, 1.0)
    mgr.report_network_check_result(2, False, math.inf)
    mgr.report_network_check_result(3, False, math.inf)
    log("round0", mgr.check_fault_node())
    for i in range(4):
        mgr.join_rendezvous(i, i, 1)
    log("round1_worlds", [mgr.get_comm_world(i) for i in range(4)])
    mgr.report_network_check_result(0, True, 1.0)
    mgr.report_network_check_result(1, True, 1.0)
    mgr.report_network_check_result(2, True, 1.1)
    mgr.report_network_check_result(3, False, math.inf)
    log("round1", mgr.check_fault_node())


def straggler_detection(r, log):
    mgr = r.NetworkCheckRendezvousManager()
    mgr.update_rdzv_params(min_nodes=4, max_nodes=4, waiting_timeout=60)
    for i in range(4):
        mgr.join_rendezvous(i, i, 1)
        mgr.get_comm_world(i)
    for rank, secs in enumerate((1.0, 1.1, 0.9, 5.0)):
        mgr.report_network_check_result(rank, True, secs)
    log("stragglers", mgr.check_straggler())


def group_network_check(r, log):
    mgr = r.GroupNetworkCheckRendezvousManager()
    mgr.update_rdzv_params(min_nodes=4, max_nodes=4, waiting_timeout=60,
                           node_unit=2)
    for i in range(4):
        mgr.join_rendezvous(i, i, 1, node_group=i // 2)
    log("worlds", [mgr.get_comm_world(i) for i in range(4)])
    for i in range(4):
        mgr.report_network_check_result(i, i != 3, 1.0 if i != 3
                                        else math.inf)
    log("verdict", mgr.check_fault_node())


def default_legal_counts(r, log):
    log("8_2", r.default_legal_node_counts(8, 2))
    log("3_1", r.default_legal_node_counts(3, 1))
    log("managers", sorted(r.create_rdzv_managers()))


SCENARIOS = [round_completes_at_max_nodes,
             round_completes_with_min_after_timeout,
             node_unit_truncates_world, legal_counts_fn_mesh_topologies,
             dead_node_removed_from_waiting, next_round_after_a_restart,
             node_groups_form_whole_slices,
             network_check_pair_grouping_and_fault_isolation,
             straggler_detection, group_network_check, default_legal_counts]


def _norm(x):
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _transcript(pkg, scenario):
    out = []
    scenario(_rdzv(pkg), lambda step, value: out.append(
        (step, _norm(value))))
    return out


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_port_rdzv_manager_answers_as_the_reference(scenario):
    ref, port = (_transcript(pkg, scenario) for pkg in PACKAGES)
    assert ref and port == ref


def test_reference_assertions_hold_on_the_port():
    """The reference test's own checks, on the port's managers."""
    r = _rdzv("dlrover_tpu_torch")
    steps = dict(_transcript("dlrover_tpu_torch",
                             round_completes_at_max_nodes))
    assert steps["world_partial"][2] == {}
    assert steps["world"][2] == {0: 1, 1: 1} and steps["waiting"] == 0
    steps = dict(_transcript("dlrover_tpu_torch", node_unit_truncates_world))
    assert len(steps["world"][2]) == 4 and steps["waiting"] == 1
    steps = dict(_transcript("dlrover_tpu_torch",
                             legal_counts_fn_mesh_topologies))
    assert len(steps["world"][2]) == 4
    steps = dict(_transcript(
        "dlrover_tpu_torch", network_check_pair_grouping_and_fault_isolation))
    assert steps["world0"][2] == {0: 1, 1: 1}
    assert steps["world2"][2] == {2: 1, 3: 1}
    assert steps["round0"] == [[], 0, True]
    assert steps["round1"] == [[3], 1, False]
    groups = [set(w[2]) for w in steps["round1_worlds"]]
    assert any(2 in g and (0 in g or 1 in g) for g in groups)
    steps = dict(_transcript("dlrover_tpu_torch", straggler_detection))
    assert steps["stragglers"] == [3]
    assert r.default_legal_node_counts(8, 2) == [2, 4, 6, 8]
    assert r.default_legal_node_counts(3, 1) == [1, 2, 3]
