"""Chaos-soak control-plane master: one crash-restartable generation.

Spawned (and re-spawned after the injected SIGKILL) by the
``master_kill`` episode (:mod:`dlrover_tpu_torch.testing.master_kill_soak`).
Each generation runs the REAL master-side stack as its own process:

- :class:`MasterJournal` (append-only fsynced WAL, DESIGN.md §37) at a
  path that survives the process — generation 1 rehydrates the task
  ledger, kv store and epoch from generation 0's journal;
- :class:`MasterServicer` over the HTTP transport, stamping the
  journal's ``master_epoch`` into every reply (worker-side fencing);
- the ``master.journal.write`` fault point armed from the environment —
  a ``crash`` rule there SIGKILLs this process after a dispatch became
  durable but BEFORE the reply left, the canonical crash window;
- SIGTERM → :meth:`HttpMasterServer.graceful_stop` (drain in-flight,
  flush+close the journal) so the clean-shutdown path is exercised too.

A ready file (atomic replace) publishes ``{port, pid, epoch}`` once the
server accepts connections, so the harness knows both when the master
is up and which incarnation answered.

The port's copy of ``dlrover_tpu/testing/soak_master.py``. It imports no
``torch``: a restarted master is up in the interpreter's start-up time.
``--stats-file`` receives the journal's ``stats()`` on a clean stop.
"""

import argparse
import json
import os
import threading
import time


def _write_ready(path: str, payload: dict):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="chaos soak master")
    parser.add_argument("--port", type=int, default=0,
                        help="0 = ephemeral (published via --ready-file)")
    parser.add_argument("--journal", required=True,
                        help="durable journal path, shared across "
                        "generations")
    parser.add_argument("--ready-file", required=True)
    parser.add_argument("--task-timeout", type=float, default=2.0)
    parser.add_argument("--stats-file", default="",
                        help="where to write the journal's stats() on a "
                        "clean stop")
    args = parser.parse_args(argv)

    from dlrover_tpu_torch.fault import arm_from_env

    arm_from_env()

    from dlrover_tpu_torch.master.elastic_training.kv_store import KVStoreService
    from dlrover_tpu_torch.master.elastic_training.sync_service import SyncService
    from dlrover_tpu_torch.master.journal import MasterJournal, restore_master_state
    from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor
    from dlrover_tpu_torch.master.servicer import MasterServicer
    from dlrover_tpu_torch.master.shard.task_manager import TaskManager
    from dlrover_tpu_torch.rpc.transport import HttpMasterServer

    task_manager = TaskManager(task_timeout=args.task_timeout)
    kv_store = KVStoreService()
    sync_service = SyncService()
    journal = MasterJournal(args.journal)
    # BEFORE the servicer: its replica-token seed check must see the
    # restored token, not journal a fresh one (DESIGN.md §37).
    restore_master_state(
        journal.recovered,
        task_manager=task_manager,
        kv_store=kv_store,
        sync_service=sync_service,
    )
    servicer = MasterServicer(
        rdzv_managers={},
        task_manager=task_manager,
        perf_monitor=PerfMonitor(),
        sync_service=sync_service,
        kv_store=kv_store,
        journal=journal,
    )
    server = HttpMasterServer(args.port, servicer)
    stop = threading.Event()
    server.add_shutdown_hook(journal.close)
    server.add_shutdown_hook(stop.set)
    server.install_sigterm_handler(drain_s=5.0)
    server.start()
    _write_ready(args.ready_file, {
        "port": server.port,
        "pid": os.getpid(),
        "epoch": journal.master_epoch,
        "t": time.time(),
    })

    # Supervision loop: lease-timeout recovery is the mechanism that
    # requeues shards journaled-as-dispatched whose reply died with the
    # previous incarnation (the worker never saw them, so no done-report
    # ever comes).
    while not stop.is_set():
        for mgr in list(task_manager._datasets.values()):  # noqa: SLF001
            mgr.recover_timeout_tasks(args.task_timeout)
        stop.wait(0.5)
    task_manager.stop()
    if args.stats_file:
        _write_ready(args.stats_file, journal.stats())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
