"""Worker-process runtime: read the agent's env and bring up
``torch.distributed`` (the port of ``dlrover_tpu/trainer/runtime.py``).

The agent injects the coordinator address, the world size and this
process's id (``common.constants.WorkerEnv``, the reference's names); a
training script calls ``init_distributed()`` first thing. A world of one
skips ``torch.distributed``, as the reference skips
``jax.distributed``. A larger world joins the process group at
``tcp://<coordinator>`` over nccl on the card and gloo on the CPU.
``world_mesh`` lays the live world out as a mesh, as the reference's
worker builds ``MeshConfig(dp=n_devices)``.

Tracing (``DLROVER_TPU_TRACE_FILE``) and the flight recorder are armed
from the port's own copies. The reference's hang watchdog, stack-dump
handler and tpu_timer daemon have no counterpart in the port yet.
"""

import os
from dataclasses import dataclass
from typing import Optional

from dlrover_tpu_torch.common.constants import NodeEnv, WorkerEnv
from dlrover_tpu_torch.common.log import logger


@dataclass
class DistributedContext:
    coordinator_address: str
    num_processes: int
    process_id: int
    local_rank: int
    local_world_size: int
    restart_count: int
    rdzv_round: int
    node_ranks: tuple = ()
    num_slices: int = 1
    initialized_distributed: bool = False

    @property
    def is_leader(self) -> bool:
        return self.process_id == 0


_context: Optional[DistributedContext] = None


def read_worker_env() -> DistributedContext:
    return DistributedContext(
        coordinator_address=os.getenv(WorkerEnv.COORDINATOR_ADDRESS, ""),
        num_processes=int(os.getenv(WorkerEnv.NUM_PROCESSES, "1")),
        process_id=int(os.getenv(WorkerEnv.PROCESS_ID, "0")),
        local_rank=int(os.getenv(WorkerEnv.LOCAL_RANK, "0")),
        local_world_size=int(os.getenv(WorkerEnv.LOCAL_WORLD_SIZE, "1")),
        restart_count=int(os.getenv(WorkerEnv.RESTART_COUNT, "0")),
        rdzv_round=int(os.getenv(WorkerEnv.RDZV_ROUND, "0")),
        node_ranks=tuple(
            int(r)
            for r in os.getenv(WorkerEnv.NODE_RANKS, "").split(",")
            if r.strip()
        ),
        num_slices=int(os.getenv(WorkerEnv.NUM_SLICES, "1")),
    )


def init_distributed(timeout_secs: int = 300,
                     device: str = "cuda") -> DistributedContext:
    """Join the process group from the agent-injected env (nccl for
    ``device="cuda"``, gloo for ``"cpu"``). Idempotent per process."""
    global _context
    if _context is not None:
        return _context
    ctx = read_worker_env()
    if ctx.num_processes > 1 and ctx.coordinator_address:
        from datetime import timedelta

        import torch.distributed as dist

        backend = "nccl" if str(device).startswith("cuda") else "gloo"
        logger.info("torch.distributed.init_process_group(%s, %s, "
                    "world=%d, rank=%d)", backend, ctx.coordinator_address,
                    ctx.num_processes, ctx.process_id)
        if backend == "nccl":
            import torch

            torch.cuda.set_device(ctx.local_rank)
        dist.init_process_group(
            backend, init_method=f"tcp://{ctx.coordinator_address}",
            world_size=ctx.num_processes, rank=ctx.process_id,
            timeout=timedelta(seconds=timeout_secs))
        ctx.initialized_distributed = True
    _setup_flight_recorder(ctx)
    _setup_tracing(ctx)
    _context = ctx
    return ctx


def _setup_tracing(ctx: DistributedContext):
    """Arm tracing when ``DLROVER_TPU_TRACE_FILE`` names a sink; on a
    multi-process world each process writes ``<base>.rank<pid><ext>``.
    Disarmed (env unset) every span site stays one global check."""
    from dlrover_tpu_torch.observability import tracing

    path = os.getenv(tracing.TRACE_FILE_ENV, "")
    if not path:
        return
    if ctx.num_processes > 1:
        base, ext = os.path.splitext(path)
        path = f"{base}.rank{ctx.process_id}{ext or '.jsonl'}"
    tracing.arm(tracing.Tracer(service=f"worker{ctx.process_id}",
                               sink_path=path))
    logger.info("tracing armed -> %s", path)


def _setup_flight_recorder(ctx: DistributedContext):
    """The per-step ring of host-side records (never on the device
    path), stamped with where this worker sits in the world."""
    from dlrover_tpu_torch.observability import flight_recorder

    flight_recorder.install_recorder(meta={
        "node_rank": int(os.getenv(NodeEnv.NODE_RANK, "0")),
        "local_rank": ctx.local_rank,
        "process_id": ctx.process_id,
        "num_processes": ctx.num_processes,
        "restart_count": ctx.restart_count,
        "rdzv_round": ctx.rdzv_round,
    })


def world_mesh(mesh: str = "", device: str = "cuda"):
    """The worker's ``DeviceMesh`` over the live world: ``mesh`` as
    ``"dp=2,tp=2"``, or ``MeshConfig(dp=world)`` when empty. A world of
    one gets a one-rank group (``parallel.mesh.build_mesh``)."""
    from dlrover_tpu_torch.parallel.mesh import build_mesh, parse_mesh

    ctx = get_context()
    device_type = "cuda" if str(device).startswith("cuda") else "cpu"
    return build_mesh(parse_mesh(mesh, ctx.num_processes), device_type)


def get_context() -> DistributedContext:
    if _context is None:
        return init_distributed()
    return _context


def shutdown_distributed():
    global _context
    if _context is not None and _context.initialized_distributed:
        import torch.distributed as dist

        dist.destroy_process_group()
    _context = None
