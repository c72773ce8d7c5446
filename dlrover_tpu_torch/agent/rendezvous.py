"""Agent-side rendezvous: from master comm-world to JAX coordination.

Parity: reference elastic_agent MasterRendezvousHandler
(elastic_agent/torch/training.py:405-646). Where torchelastic assembles a
process group store, this produces the ``jax.distributed.initialize``
triple: the lowest-rank node in the completed world hosts the JAX
coordinator; its agent publishes ``host:port`` in the master KV store keyed
by rendezvous round, and every agent derives contiguous process ids from
the world layout.

The port's copy of ``dlrover_tpu/agent/rendezvous.py``.
"""

import os
import time
from dataclasses import dataclass
from typing import Dict

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.common.env_utils import find_free_port, get_hostname_ip
from dlrover_tpu_torch.common.log import logger


class RendezvousTimeoutError(Exception):
    pass


class RendezvousEvictedError(Exception):
    """This node was not chosen into the completed world."""


@dataclass
class RendezvousOutcome:
    round: int
    group: int  # pair group during network check; 0 for training
    world: Dict[int, int]  # node_rank -> local_world_size
    coordinator_address: str
    num_processes: int
    process_id_base: int  # first global process id of this node
    node_world_size: int  # number of nodes in the world
    is_coordinator: bool
    # Slices (node groups) in this world — 1 when ungrouped. With the
    # manager's group-major world order, a dcn mesh axis of this size
    # maps one group per slice row (parallel/mesh.py). Derived from the
    # master's node_groups (explicit DLROVER_TPU_NODE_GROUP or
    # node_unit arithmetic — whichever grouped the rendezvous).
    num_slices: int = 1


class MasterRendezvousHandler:
    def __init__(
        self,
        client: MasterClient,
        node_rank: int,
        local_world_size: int = 1,
        rdzv_name: str = RendezvousName.TRAINING,
        node_unit: int = 1,
        join_timeout: float = 600.0,
        poll_interval: float = 0.5,
        coordinator_port: int = 0,
    ):
        self._client = client
        self._node_rank = node_rank
        self._local_world_size = local_world_size
        self._rdzv_name = rdzv_name
        self._node_unit = node_unit
        self._join_timeout = join_timeout
        self._poll_interval = poll_interval
        self._coordinator_port = coordinator_port
        _, self._node_ip = get_hostname_ip()
        # TPU slice/block index of this host. Explicit env wins; with a
        # node_unit (hosts per slice) configured, the block is derived
        # from the rank so deployments need no extra wiring.
        group_env = os.getenv("DLROVER_TPU_NODE_GROUP", "")
        if group_env.strip():
            self._node_group = int(group_env)
        elif node_unit > 1:
            self._node_group = node_rank // node_unit
        else:
            self._node_group = -1

    def _coordinator_key(self, rdzv_round: int, group: int) -> str:
        return f"rdzv/{self._rdzv_name}/{rdzv_round}/{group}/coordinator"

    def next_rendezvous(self) -> RendezvousOutcome:
        """Join, wait for the world, agree on the JAX coordinator."""
        self._client.join_rendezvous(
            self._node_rank,
            self._local_world_size,
            self._rdzv_name,
            node_unit=self._node_unit,
            node_ip=self._node_ip,
            node_group=self._node_group,
        )
        deadline = time.time() + self._join_timeout
        world: Dict[int, int] = {}
        rank_order: list = []
        node_groups: Dict[int, int] = {}
        rdzv_round = 0
        group = 0
        while time.time() < deadline:
            rdzv_round, group, world, rank_order, node_groups = (
                self._client.get_comm_world(
                    self._rdzv_name, self._node_rank
                )
            )
            if world:
                if self._node_rank in world:
                    break
                # A round completed without us: we were truncated out
                # (illegal topology count) — surface as eviction so the
                # caller can rejoin or exit.
                raise RendezvousEvictedError(
                    f"node {self._node_rank} not in world {sorted(world)}"
                )
            time.sleep(self._poll_interval)
        if not world or self._node_rank not in world:
            raise RendezvousTimeoutError(
                f"rendezvous {self._rdzv_name} timed out after "
                f"{self._join_timeout}s"
            )

        # The master chooses the world ORDER (possibly topology-aware:
        # slice-mates adjacent, DCN hops only at block boundaries) and
        # sends it as an EXPLICIT rank list; global process ids follow
        # that order, not numeric node rank. Relying on the world dict's
        # insertion order surviving the transport would be fragile.
        ranks = rank_order if rank_order else list(world)
        if set(ranks) != set(world):
            raise RuntimeError(
                f"rank_order {ranks} disagrees with world {sorted(world)}; "
                "master/agent protocol mismatch"
            )
        num_processes = sum(world.values())
        my_pos = ranks.index(self._node_rank)
        process_id_base = sum(world[r] for r in ranks[:my_pos])
        coordinator_rank = ranks[0]
        is_coordinator = coordinator_rank == self._node_rank
        key = self._coordinator_key(rdzv_round, group)
        if is_coordinator:
            port = self._coordinator_port or find_free_port()
            coordinator = f"{self._node_ip}:{port}"
            self._client.kv_store_set(key, coordinator.encode())
        else:
            coordinator = self._wait_coordinator(key, deadline)
        logger.info(
            "rdzv[%s] round %d: world=%s coordinator=%s procs=%d base=%d",
            self._rdzv_name,
            rdzv_round,
            world,
            coordinator,
            num_processes,
            process_id_base,
        )
        return RendezvousOutcome(
            round=rdzv_round,
            group=group,
            world=dict(world),
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id_base=process_id_base,
            node_world_size=len(world),
            is_coordinator=is_coordinator,
            num_slices=self._derive_num_slices(world, node_groups),
        )

    def _derive_num_slices(self, world, node_groups) -> int:
        """Distinct node groups in the world (explicit env grouping or
        node_unit arithmetic — the master reports whichever grouped the
        round); falls back to node_unit division for old masters.

        A dcn mesh row must hold exactly one slice, so the grouping only
        counts when it PARTITIONS the world into equal-sized groups with
        no ungrouped nodes — an uneven world (mid-failover, or one host
        missing its group env) would otherwise get a mesh whose
        "intra-slice" collectives silently cross DCN. Such worlds run as
        a single slice instead.
        """
        groups = {r: g for r, g in (node_groups or {}).items() if r in world}
        if groups and len(groups) == len(world):
            ids = list(groups.values())
            if min(ids) >= 0:
                counts = {}
                for g in ids:
                    counts[g] = counts.get(g, 0) + 1
                if len(set(counts.values())) == 1:
                    return len(counts)
                logger.warning(
                    "uneven node groups %s — running as one slice",
                    counts,
                )
                return 1
        if self._node_unit > 1 and len(world) % self._node_unit == 0:
            return len(world) // self._node_unit
        return 1

    def _wait_coordinator(self, key: str, deadline: float) -> str:
        while time.time() < deadline:
            value = self._client.kv_store_get(key)
            if value:
                return value.decode()
            time.sleep(self._poll_interval)
        raise RendezvousTimeoutError(
            f"coordinator address never published under {key}"
        )

    def num_nodes_waiting(self) -> int:
        try:
            return self._client.num_nodes_waiting(self._rdzv_name)
        except Exception:
            return 0
