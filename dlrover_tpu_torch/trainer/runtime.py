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

SIGUSR2 dumps every thread's Python stack to stderr (the agent's
post-mortem stop sends it; without the handler its default action would
kill the worker without a dump). Then, in the reference's order, the
tpu_timer daemon starts (``DLROVER_TPU_TIMER``: ``/metrics`` and
``/timeline`` at 18889 + local rank, GC pauses as spans, and with
``DLROVER_TPU_TIMER_XLA`` the device-capture listener), the flight
recorder is armed (its ring dumped to the agent-collectable path on
SIGTERM, an unhandled exception and exit, and with every stack on
SIGUSR1), tracing (``DLROVER_TPU_TRACE_FILE``), and the hang watchdog
(``DLROVER_TPU_HANG_DEADLINE_S``).
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
    # Always: SIGUSR2 (the agent's hang post-mortem) must never be fatal,
    # and faulthandler costs nothing until the signal arrives.
    from dlrover_tpu_torch.tpu_timer.py_tracing import (
        install_stack_dump_handler,
    )

    install_stack_dump_handler()
    _maybe_start_tpu_timer(ctx)
    _setup_flight_recorder(ctx)
    _setup_tracing(ctx)
    _setup_hang_watchdog(ctx)
    _context = ctx
    return ctx


def _maybe_start_tpu_timer(ctx: DistributedContext):
    """Start the native profiler daemon when enabled (reference xpu_timer
    daemon at :18889; here 18889 + local_rank per worker process). The
    actually-bound port is published to a port file the launcher-side
    collector re-reads, so an OS-assigned fallback port still gets
    scraped."""
    from dlrover_tpu_torch.common.env_utils import get_env_bool

    if not get_env_bool("DLROVER_TPU_TIMER"):
        return
    try:
        from dlrover_tpu_torch.tpu_timer import get_timer
        from dlrover_tpu_torch.tpu_timer.bridge import publish_port
        from dlrover_tpu_torch.tpu_timer.py_tracing import trace_gc

        timer = get_timer()
        port = timer.start_server(18889 + ctx.local_rank)
        if not port:  # port taken (e.g. stale process): let the OS pick
            port = timer.start_server(0)
        if port:
            publish_port(ctx.local_rank, port)
        trace_gc()
        # Kernel-level acquisition (torch.profiler windows) — the
        # counterpart of the reference's LD_PRELOAD hook layer; gated by
        # DLROVER_TPU_TIMER_XLA.
        from dlrover_tpu_torch.tpu_timer.xla_capture import (
            maybe_start_listener,
        )

        maybe_start_listener(ctx.local_rank)
    except Exception:
        logger.warning("tpu_timer daemon failed to start", exc_info=True)


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


def _setup_hang_watchdog(ctx: DistributedContext):
    """Arm the rolling-deadline hang watchdog (on by default: a wedged
    worker that stops beating past ``max(DLROVER_TPU_HANG_DEADLINE_S,
    factor x EWMA(step gap))`` dumps all-thread stacks to the
    agent-collectable path). ``DLROVER_TPU_HANG_DEADLINE_S=0`` disables;
    the default 300s floor keeps slow first steps quiet."""
    try:
        from dlrover_tpu_torch.observability import hang_watchdog

        raw = os.getenv("DLROVER_TPU_HANG_DEADLINE_S", "300")
        try:
            floor_s = float(raw)
        except ValueError:
            floor_s = 300.0
        if floor_s <= 0:
            return
        node_rank = int(os.getenv(NodeEnv.NODE_RANK, "0"))
        hang_watchdog.install_watchdog(
            node_rank=node_rank,
            local_rank=ctx.local_rank,
            min_deadline_s=floor_s,
            meta={"process_id": ctx.process_id},
        )
    except Exception:
        logger.warning("hang watchdog unavailable", exc_info=True)


def _setup_flight_recorder(ctx: DistributedContext):
    """Arm the per-step flight recorder: a host-side ring (never on the
    device path) dumped as JSON on crash/SIGTERM at a path the agent can
    reconstruct from (node_rank, local_rank), so the last N steps of a
    dead worker survive for diagnosis."""
    try:
        from dlrover_tpu_torch.observability import flight_recorder

        node_rank = int(os.getenv(NodeEnv.NODE_RANK, "0"))
        flight_recorder.install_recorder(
            node_rank=node_rank,
            local_rank=ctx.local_rank,
            meta={
                "process_id": ctx.process_id,
                "num_processes": ctx.num_processes,
                "restart_count": ctx.restart_count,
                "rdzv_round": ctx.rdzv_round,
            },
        )
    except Exception:
        logger.warning("flight recorder unavailable", exc_info=True)


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
