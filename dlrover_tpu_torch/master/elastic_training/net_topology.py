"""Network-topology-aware rank ordering.

Parity: reference dlrover/python/master/elastic_training/net_topology.py
:23-56 (DpTopologySorter) — hooks that reorder the rendezvous world so
data-parallel neighbors land close in the physical network. On TPU the
unit is the slice: hosts of one slice share ICI and must be contiguous
in rank space; cross-slice (DCN) hops go between blocks.

The port's copy of ``dlrover_tpu/master/elastic_training/net_topology.py``.
"""

import abc
from typing import Dict, List


class TopologyQuerier(abc.ABC):
    """Answers "which physical block is this node in?" (slice id for
    TPU; switch/pod id for generic fabrics)."""

    @abc.abstractmethod
    def block_of(self, node_rank: int, node_ip: str) -> str:
        ...


class SubnetTopologyQuerier(TopologyQuerier):
    """Default heuristic: nodes sharing an IP /24 share a block (GKE
    TPU slices get contiguous pod CIDRs per slice)."""

    def block_of(self, node_rank: int, node_ip: str) -> str:
        if not node_ip or "." not in node_ip:
            return ""
        return node_ip.rsplit(".", 1)[0]


class TopologySorter(abc.ABC):
    @abc.abstractmethod
    def sort(
        self, world: Dict[int, int], node_ips: Dict[int, str]
    ) -> List[int]:
        """Return node ranks in communication-friendly order."""


class DpTopologySorter(TopologySorter):
    """Group ranks by physical block, blocks ordered by their smallest
    member: ring/allreduce neighbors stay intra-block (ICI), and only
    block boundaries cross DCN (reference DpTopologySorter semantics)."""

    def __init__(self, querier: TopologyQuerier = None):
        self._querier = querier or SubnetTopologyQuerier()

    def sort(
        self, world: Dict[int, int], node_ips: Dict[int, str]
    ) -> List[int]:
        blocks: Dict[str, List[int]] = {}
        for rank in sorted(world):
            block = self._querier.block_of(rank, node_ips.get(rank, ""))
            blocks.setdefault(block, []).append(rank)
        ordered: List[int] = []
        for block in sorted(blocks.values(), key=lambda rs: rs[0]):
            ordered.extend(block)
        return ordered
