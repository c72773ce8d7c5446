"""Runtime-knob suggestion (micro-batch / grad-accum / mesh / remat).

Parity: reference dlrover/python/master/hyperparams/
simple_strategy_generator.py:179 (SimpleStrategyGenerator producing a
ParallelConfig the agent-side tuner feeds to trainers) — re-pointed at
JAX knobs: the tunables are the per-device micro batch, gradient
accumulation (fixed global batch), the device-mesh shape for the current
world, and the remat (activation checkpointing) policy when host OOMs
are observed.

The port's copy of ``dlrover_tpu/master/hyperparams/simple_strategy_generator.py``.
"""

import threading
from typing import Dict, Optional

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import NodeExitReason
from dlrover_tpu_torch.common.log import logger


def _balanced_mesh(n_devices: int) -> Dict[str, int]:
    """Factor device count into (dp, fsdp): biggest fsdp power of two
    that divides n, rest dp — the default layout for memory-bound LMs
    (weights sharded, batch replicated across the remainder)."""
    if n_devices <= 1:
        return {"dp": 1}
    fsdp = 1
    while fsdp * 2 <= n_devices and n_devices % (fsdp * 2) == 0:
        fsdp *= 2
    dp = n_devices // fsdp
    if dp == 1:
        return {"fsdp": fsdp}
    return {"dp": dp, "fsdp": fsdp}


class SimpleStrategyGenerator:
    def __init__(
        self,
        job_manager=None,
        global_batch_size: int = 0,
        devices_per_node: int = 4,
    ):
        self._job_manager = job_manager
        self._global_batch_size = global_batch_size
        self._devices_per_node = devices_per_node
        self._version = 0
        self._last: Optional[comm.ParallelConfig] = None
        # generate() mutates suggestion state and is called from every
        # agent tuner's poll through the master's threaded RPC pool —
        # unserialized, two concurrent polls could version-bump twice
        # for identical configs (each bump makes workers rebuild their
        # jitted step: a full XLA recompile).
        self._gen_lock = threading.Lock()

    def generate(self) -> Optional[comm.ParallelConfig]:
        """Suggest knobs for the current world; None if undecidable."""
        if self._job_manager is None:
            return None
        with self._gen_lock:
            return self._generate_locked()

    def _generate_locked(self) -> Optional[comm.ParallelConfig]:
        workers = self._job_manager.worker_manager.running_nodes()
        if not workers:
            return self._last
        # Prefer the declared chips-per-host over the constructor default:
        # mesh suggestions must match the real device count.
        chips = [
            n.config_resource.tpu_chips
            for n in workers
            if n.config_resource.tpu_chips > 0
        ]
        per_node = chips[0] if chips else self._devices_per_node
        n_devices = len(workers) * per_node
        micro = self._suggest_micro_batch(n_devices)
        accum = 1
        if self._global_batch_size > 0 and micro > 0:
            denom = micro * n_devices
            if self._global_batch_size % denom != 0:
                # A fixed global batch must divide exactly — rounding up
                # would silently train on a bigger batch. Leave the
                # batching knobs unset and let the trainer keep its own.
                logger.warning(
                    "global batch %d not divisible by micro(%d) x "
                    "devices(%d); batching suggestion withheld",
                    self._global_batch_size,
                    micro,
                    n_devices,
                )
                micro = 0
                accum = 0
            else:
                accum = self._global_batch_size // denom
        config = comm.ParallelConfig(
            micro_batch_size=micro,
            grad_accum_steps=accum,
            remat_policy=self._suggest_remat(),
            mesh_shape=_balanced_mesh(n_devices),
        )
        if self._last is None or self._changed(config):
            self._version += 1
            config.version = self._version
            self._last = config
            logger.info(
                "parallel config v%d: micro=%d accum=%d mesh=%s remat=%s",
                config.version,
                micro,
                accum,
                config.mesh_shape,
                config.remat_policy,
            )
        else:
            config.version = self._version
        return config

    def _suggest_micro_batch(self, n_devices: int) -> int:
        if self._global_batch_size <= 0:
            return 0
        # Largest power-of-two micro batch that divides the per-device
        # share of the global batch (keeps the MXU batched without
        # breaking fixed-global-batch divisibility).
        share = max(self._global_batch_size // n_devices, 1)
        micro = 1
        while micro * 2 <= share and share % (micro * 2) == 0:
            micro *= 2
        return micro

    def _suggest_remat(self) -> str:
        """Escalate activation rematerialization on OOM evidence: the
        first OOM EPISODE suggests "attn_save" (attention stays
        un-rematted — its re-run dominates the remat bill, see
        models/llama.py remat policies); a REPEATED episode escalates
        to "full". Episode attribution rides the lineage exit history
        (get_relaunch_node shares it across relaunches): one symmetric
        SPMD episode stamps each lineage ONCE no matter how many
        records it marks or how late (heartbeat-timeout) the marks
        land, while a lineage with two OOM exits has provably OOMed
        again after a relaunch — timing-free, so it cannot be confused
        by when records were created or polled."""
        nodes = self._job_manager.worker_manager.nodes.values()
        evidence = [
            n for n in nodes
            if n.exit_reason == NodeExitReason.OOM
            or n.exit_count(NodeExitReason.OOM) > 0
        ]
        if not evidence:
            return ""
        if any(
            n.exit_count(NodeExitReason.OOM) >= 2 for n in evidence
        ):
            return "full"
        return "attn_save"

    def _changed(self, config: comm.ParallelConfig) -> bool:
        last = self._last
        return (
            last.micro_batch_size != config.micro_batch_size
            or last.grad_accum_steps != config.grad_accum_steps
            or last.remat_policy != config.remat_policy
            or last.mesh_shape != config.mesh_shape
        )
