"""Master-side rendezvous.

Parity: reference dlrover/python/master/elastic_training/rdzv_manager.py
(RendezvousManager:69, ElasticTrainingRendezvousManager:497,
NetworkCheckRendezvousManager:599). Re-designed for JAX: a completed round
hands agents the ``jax.distributed.initialize`` triple (coordinator node,
process count, per-node process id) instead of a torch process-group world.

TPU specifics: the ``node_unit`` constraint generalizes to *legal topology
sizes* — a TPU slice can only form meshes whose host count divides the
physical topology, so a round is truncated to the largest legal node count
<= the waiting set.

The port's copy of ``dlrover_tpu/master/elastic_training/rdzv_manager.py``.
"""

import math
import statistics
import threading
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Callable, Dict, List, Set, Tuple

from dlrover_tpu_torch.common.constants import NetworkCheckConstant, RendezvousName
from dlrover_tpu_torch.common.log import logger


@dataclass
class RendezvousParameters:
    min_nodes: int = 1
    max_nodes: int = 1
    node_unit: int = 1
    waiting_timeout: float = 30.0  # secs after min reached before closing
    join_timeout: float = 600.0


@dataclass
class _WaitingNode:
    node_id: int
    node_rank: int
    local_world_size: int
    join_time: float
    node_ip: str = ""
    node_group: int = -1  # TPU slice/block index; -1 = ungrouped


def default_legal_node_counts(max_nodes: int, node_unit: int) -> List[int]:
    """Node counts that can form a legal mesh: multiples of node_unit."""
    counts = [
        n for n in range(node_unit, max_nodes + 1, node_unit)
    ]
    return counts or [max_nodes]


def _rdzv_metrics():
    """Rendezvous observability (PR-1 registry, scraped at /metrics):
    rounds completed, nodes currently waiting, and time-to-quorum per
    rendezvous domain."""
    from dlrover_tpu_torch.observability.registry import default_registry

    reg = default_registry()
    return {
        "rounds": reg.counter(
            "rdzv_rounds_total",
            "completed rendezvous rounds",
            labelnames=("rdzv",),
        ),
        "waiting": reg.gauge(
            "rdzv_nodes_waiting",
            "nodes currently waiting in the rendezvous",
            labelnames=("rdzv",),
        ),
        "quorum": reg.histogram(
            "rdzv_time_to_quorum_seconds",
            "first join of a round to round completion",
            labelnames=("rdzv",),
        ),
        # World size of the latest completed round, next to the quorum
        # histogram so "time-to-quorum vs world size" reads off one
        # scrape (§32: the load harness sweeps {8,64,256,1024}).
        "world": reg.gauge(
            "rdzv_world_size",
            "node count of the latest completed world",
            labelnames=("rdzv",),
        ),
    }


class RendezvousManager(ABC):
    """Holds the waiting set and completed rounds for one rendezvous name."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()
        self._params = RendezvousParameters()
        self._waiting: Dict[int, _WaitingNode] = {}  # node_rank -> record
        self._latest_world: Dict[int, int] = {}  # rank -> local_world_size
        self._rdzv_round = 0
        self._round_start_time = 0.0
        self._alive_nodes: Set[int] = set()
        self._node_times: Dict[int, float] = {}
        self._legal_counts_fn: Callable[[int, int], List[int]] = (
            default_legal_node_counts
        )
        self._metrics = _rdzv_metrics()

    # ---- configuration -----------------------------------------------------

    def update_rdzv_params(
        self,
        min_nodes: int,
        max_nodes: int,
        waiting_timeout: float = 30.0,
        node_unit: int = 1,
        join_timeout: float = 600.0,
    ):
        with self._lock:
            self._params = RendezvousParameters(
                min_nodes=min_nodes,
                max_nodes=max_nodes,
                node_unit=node_unit,
                waiting_timeout=waiting_timeout,
                join_timeout=join_timeout,
            )

    def set_legal_counts_fn(self, fn: Callable[[int, int], List[int]]):
        """Install slice-topology-aware legal node counts."""
        self._legal_counts_fn = fn

    def set_node_unit(self, node_unit: int):
        with self._lock:
            if node_unit >= 1:
                self._params.node_unit = node_unit

    def add_alive_node(self, node_rank: int):
        with self._lock:
            self._alive_nodes.add(node_rank)

    def remove_alive_node(self, node_rank: int):
        with self._lock:
            self._alive_nodes.discard(node_rank)
            # A dead node must not keep a pending round open.
            if node_rank in self._waiting:
                del self._waiting[node_rank]
                self._metrics["waiting"].set(
                    len(self._waiting), rdzv=self.name
                )

    def restore_committed_world(self, rdzv_round: int, world: Dict[int, int]):
        """Master-journal rehydration (DESIGN.md §37): a restarted
        master re-serves the last committed world at the right round so
        riding-through workers polling ``get_comm_world`` see their own
        world again instead of an empty round-0 — and a genuinely new
        join still starts the next round above the journaled one."""
        with self._lock:
            if rdzv_round + 1 <= self._rdzv_round:
                return
            self._rdzv_round = rdzv_round + 1
            self._latest_world = {int(r): int(n) for r, n in world.items()}

    def _record_round_completed(self):
        """Call under self._lock, right after a round's waiters moved
        into the completed world."""
        self._metrics["rounds"].inc(rdzv=self.name)
        self._metrics["waiting"].set(len(self._waiting), rdzv=self.name)
        self._metrics["world"].set(
            len(self._latest_world), rdzv=self.name
        )
        if self._round_start_time > 0:
            self._metrics["quorum"].observe(
                max(time.time() - self._round_start_time, 0.0),
                rdzv=self.name,
            )

    # ---- join / query ------------------------------------------------------

    def join_rendezvous(
        self,
        node_id: int,
        node_rank: int,
        local_world_size: int,
        node_ip: str = "",
        node_group: int = -1,
    ) -> int:
        with self._lock:
            if not self._waiting:
                self._round_start_time = time.time()
            self._waiting[node_rank] = _WaitingNode(
                node_id=node_id,
                node_rank=node_rank,
                local_world_size=local_world_size,
                join_time=time.time(),
                node_ip=node_ip,
                node_group=node_group,
            )
            self._metrics["waiting"].set(len(self._waiting), rdzv=self.name)
            logger.info(
                "rdzv[%s] round %d: node rank %d joined (%d waiting)",
                self.name,
                self._rdzv_round,
                node_rank,
                len(self._waiting),
            )
            return self._rdzv_round

    def num_nodes_waiting(self) -> int:
        """Non-zero signals running agents that membership wants to change
        (reference rdzv_manager.py num_nodes_waiting / training.py
        _membership_changed)."""
        with self._lock:
            return len(self._waiting)

    @abstractmethod
    def get_comm_world(
        self, node_rank: int
    ) -> Tuple[int, int, Dict[int, int]]:
        """Return (round, group, world) — world empty if round incomplete."""

    # ---- round completion --------------------------------------------------

    def _legal_world_size(self, waiting_count: int) -> int:
        p = self._params
        counts = [
            c
            for c in self._legal_counts_fn(p.max_nodes, p.node_unit)
            if c <= waiting_count
        ]
        return max(counts) if counts else 0

    def _round_ready(self) -> int:
        """Return the node count for a completable round, else 0."""
        p = self._params
        n = len(self._waiting)
        if n == 0:
            return 0
        if n >= p.max_nodes:
            return self._legal_world_size(p.max_nodes)
        elapsed = time.time() - self._round_start_time
        if n >= p.min_nodes and elapsed >= p.waiting_timeout:
            return self._legal_world_size(n)
        return 0

    def _grouped(self) -> bool:
        return any(w.node_group >= 0 for w in self._waiting.values())

    def _select_waiters(self, size: int) -> List[_WaitingNode]:
        """Round participants, longest-waiting first (lowest rank on tie
        so a flapping late joiner cannot evict a stable participant).

        With node groups (TPU slices), only COMPLETE groups are eligible
        — an ICI slice cannot run collectives with a missing host, and
        holding back an incomplete block keeps the other blocks training
        while its replacement host arrives. ``node_unit`` is the hosts-
        per-slice count."""
        waiters = sorted(
            self._waiting.values(),
            key=lambda w: (w.join_time, w.node_rank),
        )
        unit = self._params.node_unit
        if unit <= 1 or not self._grouped():
            return waiters[:size]
        by_group: Dict[int, List[_WaitingNode]] = {}
        for w in waiters:
            by_group.setdefault(w.node_group, []).append(w)
        complete = [
            members[:unit]
            for members in by_group.values()
            if len(members) >= unit
        ]
        complete.sort(key=lambda g: min(w.join_time for w in g))
        chosen: List[_WaitingNode] = []
        for members in complete:
            if len(chosen) + unit > size:
                break
            chosen.extend(members)
        return chosen


class ElasticTrainingRendezvousManager(RendezvousManager):
    """The training rendezvous: single group 0, ranks 0..n-1.

    Reference: rdzv_manager.py:497 (ElasticTrainingRendezvousManager)."""

    def __init__(self):
        super().__init__(RendezvousName.TRAINING)
        self._topology_sorter = None
        self._latest_groups = {}

    def latest_node_groups(self):
        """node_rank -> node_group of the latest completed world."""
        with self._lock:
            return dict(self._latest_groups)

    def get_comm_world_and_groups(self, node_rank: int):
        """(round, group, world, node_groups) under ONE lock hold — a
        round completing between separate calls would pair round-N's
        world with round-N+1's groups."""
        with self._lock:
            rdzv_round, group, world = self.get_comm_world(node_rank)
            return rdzv_round, group, world, dict(self._latest_groups)

    def set_topology_sorter(self, sorter):
        """Install a TopologySorter (net_topology.DpTopologySorter): the
        completed world's ORDER then follows physical blocks, and agents
        assign process ids in that order."""
        self._topology_sorter = sorter

    def _order_world(self, world: Dict[int, int], chosen) -> Dict[int, int]:
        groups = {w.node_rank: w.node_group for w in chosen}
        self._latest_groups = groups
        if any(g >= 0 for g in groups.values()):
            # Group-major order: each slice's hosts are contiguous in
            # the rank order, so dp/allreduce neighbors ride ICI and
            # only block boundaries cross DCN.
            order = sorted(world, key=lambda r: (groups.get(r, -1), r))
            return {rank: world[rank] for rank in order}
        if self._topology_sorter is None:
            return dict(sorted(world.items()))
        node_ips = {w.node_rank: w.node_ip for w in chosen}
        try:
            order = self._topology_sorter.sort(world, node_ips)
        except Exception:
            logger.exception("topology sort failed; numeric order used")
            return dict(sorted(world.items()))
        return {rank: world[rank] for rank in order}

    def get_comm_world(self, node_rank: int):
        with self._lock:
            if node_rank in self._latest_world and node_rank not in self._waiting:
                return self._rdzv_round - 1, 0, dict(self._latest_world)
            size = self._round_ready()
            chosen = self._select_waiters(size) if size else []
            if chosen:
                world = {
                    w.node_rank: w.local_world_size for w in chosen
                }
                self._latest_world = self._order_world(world, chosen)
                for w in chosen:
                    del self._waiting[w.node_rank]
                self._record_round_completed()
                if self._waiting:
                    # Unchosen nodes start the next pending round now.
                    self._round_start_time = time.time()
                self._rdzv_round += 1
                logger.info(
                    "rdzv[%s] round %d completed: world=%s",
                    self.name,
                    self._rdzv_round - 1,
                    self._latest_world,
                )
                from dlrover_tpu_torch.training_event import MasterEvents

                MasterEvents.rdzv_round(
                    self.name, self._rdzv_round - 1, len(self._latest_world)
                )
            if (
                node_rank in self._latest_world
                and node_rank not in self._waiting
            ):
                return self._rdzv_round - 1, 0, dict(self._latest_world)
            # Waiting for the next round: a node that RE-joined (its
            # worker died and it came back) must never be handed the
            # stale world it used to belong to — that world may contain
            # dead peers and would make it restart-loop against them.
            return self._rdzv_round, 0, {}


class NetworkCheckRendezvousManager(RendezvousManager):
    """Rendezvous for the node/network check (reference rdzv_manager.py:599).

    Round 0 groups nodes in pairs to run collective probes; round 1 pairs
    each suspect with a known-healthy node so a failing pair is bisected to
    the faulty member. Stragglers are nodes slower than
    ``straggler_ratio x median``.
    """

    def __init__(self):
        super().__init__(RendezvousName.NETWORK_CHECK)
        self._node_status: Dict[int, bool] = {}
        self._node_groups: List[Dict[int, int]] = []
        self._check_round = 0
        self._stragglers: Set[int] = set()
        self._reported: Dict[int, float] = {}
        # check_round -> evaluated fault list (evaluation happens eagerly
        # when the last report of a round arrives, so agents can poll for
        # a round's verdict without racing the round transition).
        self._eval_results: Dict[int, List[int]] = {}

    def _check_concluded(self) -> bool:
        """Final verdict reached: round 0 clean, or round 1 evaluated."""
        return (
            self._check_round == 0 and 0 in self._eval_results
        ) or 1 in self._eval_results

    def join_rendezvous(
        self,
        node_id: int,
        node_rank: int,
        local_world_size: int,
        node_ip: str = "",
        node_group: int = -1,
    ) -> int:
        # A join after a concluded check starts a FRESH check cycle
        # (e.g. a relaunched node re-running its health probes, or a
        # scheduled re-check); stale verdicts must not leak into it.
        with self._lock:
            if self._check_concluded():
                self._reset_check_locked()
        return super().join_rendezvous(
            node_id, node_rank, local_world_size, node_ip, node_group
        )

    def get_comm_world(self, node_rank: int):
        with self._lock:
            if not self._node_groups or all(
                node_rank not in g for g in self._node_groups
            ):
                size = self._round_ready()
                if size:
                    chosen = sorted(
                        self._waiting.values(),
                        key=lambda w: (w.join_time, w.node_rank),
                    )[:size]
                    world = {w.node_rank: w.local_world_size for w in chosen}
                    for w in chosen:
                        del self._waiting[w.node_rank]
                    # World BEFORE the completion record (training-
                    # manager ordering): the rdzv_world_size gauge
                    # must describe the round that just formed.
                    self._latest_world = dict(sorted(world.items()))
                    self._record_round_completed()
                    self._node_groups = self._group_nodes(
                        self._check_round, self._latest_world
                    )
                    self._reported.clear()
                    self._rdzv_round += 1
                    logger.info(
                        "network-check round %d groups: %s",
                        self._check_round,
                        self._node_groups,
                    )
            for group_idx, group in enumerate(self._node_groups):
                if node_rank in group:
                    return self._rdzv_round - 1, group_idx, dict(group)
            return self._rdzv_round, 0, {}

    @staticmethod
    def _pair_adjacent(
        ranks: List[int], world: Dict[int, int]
    ) -> List[Dict[int, int]]:
        """Pairs (0,1) (2,3) ...; an odd node joins the last group."""
        groups: List[Dict[int, int]] = []
        for i in range(0, len(ranks) - 1, 2):
            groups.append({r: world[r] for r in (ranks[i], ranks[i + 1])})
        if len(ranks) % 2 == 1:
            if groups:
                groups[-1][ranks[-1]] = world[ranks[-1]]
            else:
                groups.append({ranks[-1]: world[ranks[-1]]})
        return groups

    def _pair_suspects(
        self, suspects: List[int], healthy: List[int], world
    ) -> List[Dict[int, int]]:
        """Each suspect pairs with a healthy node (bisection); leftover
        healthy nodes pair adjacently; a partnerless suspect probes
        solo."""
        groups: List[Dict[int, int]] = []
        pool = list(healthy)
        for s in suspects:
            if pool:
                h = pool.pop(0)
                groups.append({s: world[s], h: world[h]})
            else:
                groups.append({s: world[s]})
        groups.extend(self._pair_adjacent(pool, world))
        return groups

    def _group_nodes(
        self, check_round: int, world: Dict[int, int]
    ) -> List[Dict[int, int]]:
        ranks = sorted(world)
        if check_round == 0 or not self._node_status:
            return self._pair_adjacent(ranks, world)
        suspects = [r for r in ranks if not self._node_status.get(r, True)]
        healthy = [r for r in ranks if self._node_status.get(r, True)]
        return self._pair_suspects(suspects, healthy, world)

    def report_network_check_result(
        self, node_rank: int, succeeded: bool, elapsed: float
    ):
        with self._lock:
            self._reported[node_rank] = elapsed if succeeded else math.inf
            # Round 0: failure marks the node suspect. Round 1: the verdict
            # of the suspect+healthy pairing is final for this node.
            self._node_status[node_rank] = succeeded
            self._maybe_evaluate_round()

    def _maybe_evaluate_round(self):
        """Evaluate the current check round once every node reported."""
        expected = set(self._latest_world)
        if not expected or not (set(self._reported) >= expected):
            return
        if self._check_round in self._eval_results:
            return
        suspects = {r for r, ok in self._node_status.items() if not ok}
        self._evaluate_stragglers()  # only ever on a COMPLETE report set
        if self._check_round == 0 and suspects:
            # bisection round needed; no verdict yet
            self._eval_results[0] = []
            self._check_round = 1
            self._node_groups = []  # force suspect+healthy regrouping
            self._reported = {}
            logger.info(
                "network check round 0: suspects %s; running verification "
                "round",
                sorted(suspects),
            )
        else:
            self._eval_results[self._check_round] = sorted(suspects)
            logger.info(
                "network check round %d verdict: faults=%s",
                self._check_round,
                sorted(suspects),
            )

    def check_fault_node(self) -> Tuple[List[int], int, bool]:
        """Return (faults_of_last_evaluated_round, last_evaluated_round,
        needs_round2). last_evaluated_round == -1 while nothing concluded."""
        with self._lock:
            if not self._eval_results:
                return [], -1, False
            last = max(self._eval_results)
            needs_round2 = self._check_round == 1 and 1 not in self._eval_results
            return list(self._eval_results[last]), last, needs_round2

    def _evaluate_stragglers(self):
        """Called under self._lock, ONLY when a round's reports are
        complete — a partial report set would produce false positives.
        Replace (not accumulate) so a later full round corrects earlier
        transients."""
        times = {
            r: t
            for r, t in self._reported.items()
            if not math.isinf(t) and t > 0
        }
        if len(times) < 2:
            return
        med = statistics.median(times.values())
        if med <= 0:
            return
        ratio = NetworkCheckConstant.STRAGGLER_RATIO
        self._stragglers = {r for r, t in times.items() if t > ratio * med}

    def check_straggler(self) -> List[int]:
        with self._lock:
            return sorted(self._stragglers)

    def reset_check(self):
        with self._lock:
            self._reset_check_locked()

    def _reset_check_locked(self):
        self._check_round = 0
        self._node_status.clear()
        self._node_groups = []
        self._latest_world = {}
        self._stragglers.clear()
        self._reported.clear()
        self._eval_results.clear()


class GroupCheckPhase:
    INTRA = "intra"
    INTRA_DIAG = "intra_diag"
    INTER = "inter"
    INTER_DIAG = "inter_diag"


class GroupNetworkCheckRendezvousManager(NetworkCheckRendezvousManager):
    """Slice-aware network check (reference rdzv_manager.py:876
    GroupNodeNetworkCheckRendezvousManager, re-shaped for TPU blocks).

    Hosts belong to node groups (TPU slices: ICI inside a group, DCN
    across groups). Phases:

    - INTRA: adjacent pairs within each slice probe the ICI path.
      Failures enter INTRA_DIAG (suspect + intra-group healthy pairing,
      bisecting to the faulty host — verdict final).
    - A clean intra pass advances to INTER: same-position hosts of
      adjacent slices pair up to probe DCN. Failures enter INTER_DIAG
      (suspect + healthy-from-another-group pairing — verdict final).

    Without group info every phase falls back to the base pair/bisect
    flow, so ungrouped jobs see identical behavior.
    """

    MAX_PHASES = 4

    def __init__(self):
        super().__init__()
        self._rank_group: Dict[int, int] = {}
        self._phase = GroupCheckPhase.INTRA
        self._concluded = False
        # True only while the CURRENT cycle's world is fully grouped —
        # evaluation, conclusion, and verdict must all branch on the
        # same predicate, or mixed group info (one agent without a
        # group) would leave the check permanently unconcluded.
        self._grouped_mode = False

    def join_rendezvous(
        self,
        node_id: int,
        node_rank: int,
        local_world_size: int,
        node_ip: str = "",
        node_group: int = -1,
    ) -> int:
        with self._lock:
            if node_group >= 0:
                self._rank_group[node_rank] = node_group
        return super().join_rendezvous(
            node_id, node_rank, local_world_size, node_ip, node_group
        )

    # ---- phase machinery ---------------------------------------------------

    def _groups_of(self, world: Dict[int, int]):
        by: Dict[int, List[int]] = {}
        for r in sorted(world):
            g = self._rank_group.get(r, -1)
            if g < 0:
                return None  # mixed/absent group info: fall back
            by.setdefault(g, []).append(r)
        return by if len(by) >= 1 else None

    def _check_concluded(self) -> bool:
        if not self._grouped_mode:
            return super()._check_concluded()
        return self._concluded

    def _reset_check_locked(self):
        super()._reset_check_locked()
        self._phase = GroupCheckPhase.INTRA
        self._concluded = False
        self._grouped_mode = False
        # _rank_group survives: slice membership is a fact about the
        # host, not about one check cycle.

    def _group_nodes(self, check_round, world):
        by = self._groups_of(world)
        self._grouped_mode = by is not None
        if by is None:
            return super()._group_nodes(check_round, world)
        phase = self._phase
        if phase == GroupCheckPhase.INTRA:
            groups = []
            for ranks in by.values():
                groups.extend(self._pair_adjacent(ranks, world))
            return groups
        if phase == GroupCheckPhase.INTRA_DIAG:
            # Bisect within each slice: a cross-slice pairing would
            # probe DCN and prove nothing about the suspect ICI path.
            # A fully-suspect block degenerates to solo host probes —
            # a host fault is isolated directly; a pure ICI-link fault
            # passes solo probes and resurfaces at the next training
            # rendezvous, where the block relaunches whole.
            groups = []
            for ranks in by.values():
                suspects = [
                    r for r in ranks if not self._node_status.get(r, True)
                ]
                healthy = [
                    r for r in ranks if self._node_status.get(r, True)
                ]
                groups.extend(self._pair_suspects(suspects, healthy, world))
            return groups
        if phase == GroupCheckPhase.INTER:
            # Same-position hosts of adjacent slices probe DCN.
            glist = sorted(by)
            groups = []
            for i in range(0, len(glist) - 1, 2):
                a, b = by[glist[i]], by[glist[i + 1]]
                for x, y in zip(a, b):
                    groups.append({x: world[x], y: world[y]})
                for rest in (a[len(b):], b[len(a):]):
                    groups.extend(self._pair_adjacent(rest, world))
            if len(glist) % 2 == 1:
                groups.extend(self._pair_adjacent(by[glist[-1]], world))
            return groups
        # INTER_DIAG: suspect + healthy host from a DIFFERENT slice than
        # the suspect's, so a bad DCN link is bisected to the host.
        suspects = [r for r in sorted(world) if not self._node_status.get(r, True)]
        groups = []
        used = set(suspects)
        for s in suspects:
            partner = next(
                (
                    r
                    for r in sorted(world)
                    if r not in used
                    and self._node_status.get(r, True)
                    and self._rank_group.get(r) != self._rank_group.get(s)
                ),
                None,
            )
            if partner is None:
                groups.append({s: world[s]})
            else:
                used.add(partner)
                groups.append({s: world[s], partner: world[partner]})
        leftovers = [r for r in sorted(world) if r not in used]
        groups.extend(self._pair_adjacent(leftovers, world))
        return groups

    def _maybe_evaluate_round(self):
        expected = set(self._latest_world)
        if not expected or not (set(self._reported) >= expected):
            return
        if not self._grouped_mode:
            super()._maybe_evaluate_round()
            return
        if self._check_round in self._eval_results:
            return
        suspects = sorted(
            r for r, ok in self._node_status.items() if not ok
        )
        self._evaluate_stragglers()
        phase = self._phase

        def advance(next_phase):
            self._eval_results[self._check_round] = []
            self._check_round += 1
            self._phase = next_phase
            self._node_groups = []
            self._reported = {}

        def conclude(faults):
            self._eval_results[self._check_round] = list(faults)
            self._concluded = True
            logger.info(
                "group network check concluded at %s: faults=%s",
                phase,
                faults,
            )

        if phase == GroupCheckPhase.INTRA:
            if suspects:
                logger.info(
                    "intra-slice suspects %s; running intra diagnosis",
                    suspects,
                )
                advance(GroupCheckPhase.INTRA_DIAG)
            else:
                logger.info("intra-slice checks clean; probing DCN")
                advance(GroupCheckPhase.INTER)
        elif phase == GroupCheckPhase.INTRA_DIAG:
            conclude(suspects)
        elif phase == GroupCheckPhase.INTER:
            if suspects:
                logger.info(
                    "inter-slice suspects %s; running inter diagnosis",
                    suspects,
                )
                advance(GroupCheckPhase.INTER_DIAG)
            else:
                conclude([])
        else:
            conclude(suspects)

    def check_fault_node(self) -> Tuple[List[int], int, bool]:
        with self._lock:
            if not self._grouped_mode:
                return super().check_fault_node()
            if not self._eval_results:
                return [], -1, False
            last = max(self._eval_results)
            return (
                list(self._eval_results[last]),
                last,
                not self._concluded,
            )


def create_rdzv_managers() -> Dict[str, RendezvousManager]:
    return {
        RendezvousName.TRAINING: ElasticTrainingRendezvousManager(),
        RendezvousName.NETWORK_CHECK: GroupNetworkCheckRendezvousManager(),
    }
