"""Master crash-recovery bench: journal cost + replay speed (§37).

Two questions, one harness:

1. **What does the journal cost on the hot lease path?** The same
   multi-threaded get_tasks/report_done drain is run against an
   in-process master over the real HTTP transport twice — journal off,
   then journal on (fsync per group commit, real file) — and the
   journaled RPS must stay within ``RPS_DELTA_BOUND`` of unjournaled.
   Group commit is the mechanism under test: N concurrent appenders
   share one fsync, so the per-RPC overhead amortizes instead of
   serializing.

2. **How fast does a master come back?** The journaled run's journal
   (thousands of dispatch/done records plus dataset/kv state) is then
   replayed cold — ``MasterJournal`` open + ``restore_master_state``
   into a fresh TaskManager — and the wall time is reported as
   ``master_recovery_s`` (the control-plane half of the §37 recovery
   window; the worker-visible half is measured by the master_kill soak
   episode).

Exactly-once is asserted after every drain: completed shard count ==
dataset shards, no task leaked.

Host-only, torch-free. Run directly::

    python tools/torch_bench_master_recovery.py [--work-dir DIR]

The port's copy of ``tools/bench_master_recovery.py``, over the port's
master, journal and HTTP transport. ``--work-dir`` places the journal
(a fresh temp dir by default); the report names the filesystem it sat
on (``journal_fs``, from ``/proc/mounts``), since the fsync per commit
group is paid there.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATASET_SIZE = 48_000
SHARD_SIZE = 16
DRIVERS = 8
FETCH_BATCH = 4
RPS_DELTA_BOUND = 0.15


class _Drain:
    """One timed drain of the full dataset through the lease path."""

    def __init__(self, journal_path: str = ""):
        from dlrover_tpu_torch.master.journal import MasterJournal
        from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor
        from dlrover_tpu_torch.master.servicer import MasterServicer
        from dlrover_tpu_torch.master.shard.task_manager import TaskManager
        from dlrover_tpu_torch.rpc.transport import HttpMasterServer

        self.journal = (
            MasterJournal(journal_path) if journal_path else None
        )
        self.task_manager = TaskManager(task_timeout=600.0)
        self.servicer = MasterServicer(
            rdzv_managers={},
            task_manager=self.task_manager,
            perf_monitor=PerfMonitor(),
            journal=self.journal,
        )
        self.server = HttpMasterServer(0, self.servicer)
        self.server.start()
        self.rpcs = 0
        self._rpc_lock = threading.Lock()

    def _drive(self, node_id: int):
        from dlrover_tpu_torch.agent.master_client import MasterClient

        client = MasterClient(
            f"localhost:{self.server.port}", node_id=node_id, kind="http",
            timeout=30.0,
        )
        rpcs = 0
        while True:
            tasks, wait = client.get_tasks("bench", FETCH_BATCH)
            rpcs += 1
            if tasks:
                client.report_tasks_done_batch(
                    "bench", [t.task_id for t in tasks], []
                )
                rpcs += 1
            elif wait:
                time.sleep(0.002)
            else:
                break
        client.close()
        with self._rpc_lock:
            self.rpcs += rpcs

    def run(self) -> dict:
        from dlrover_tpu_torch.agent.master_client import MasterClient
        from dlrover_tpu_torch.common import comm

        reg = MasterClient(
            f"localhost:{self.server.port}", node_id=0, kind="http",
            timeout=30.0,
        )
        reg.report_dataset_shard_params(comm.DatasetShardParams(
            dataset_name="bench",
            dataset_size=DATASET_SIZE,
            shard_size=SHARD_SIZE,
            num_epochs=1,
            shuffle=False,
            task_type="training",
        ))
        reg.close()
        t0 = time.monotonic()
        threads = [
            threading.Thread(target=self._drive, args=(i,), daemon=True)
            for i in range(DRIVERS)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        mgr = self.task_manager._datasets["bench"]  # noqa: SLF001
        shards = DATASET_SIZE // SHARD_SIZE
        completed = mgr._completed_count  # noqa: SLF001
        if completed != shards:
            raise AssertionError(
                f"exactly-once violated in drain: {completed} completed "
                f"!= {shards} shards"
            )
        return {"wall_s": wall, "rpcs": self.rpcs,
                "rps": self.rpcs / max(wall, 1e-9)}

    def close(self):
        self.server.stop()
        self.task_manager.stop()
        if self.journal is not None and not self.journal.closed:
            self.journal.close()


def run_bench(work_dir=None) -> dict:
    from dlrover_tpu_torch.testing.master_kill_soak import _filesystem_of

    work = tempfile.mkdtemp(prefix="dlrover_mrbench_", dir=work_dir)
    journal_path = os.path.join(work, "master.journal")
    try:
        plain = _Drain()
        try:
            base = plain.run()
        finally:
            plain.close()
        journaled = _Drain(journal_path)
        try:
            jrun = journaled.run()
            jstats = journaled.journal.stats()
        finally:
            journaled.close()
        delta = max(0.0, (base["rps"] - jrun["rps"]) / max(base["rps"], 1e-9))

        # Cold replay: reopen the journal and rehydrate a fresh master.
        from dlrover_tpu_torch.master.journal import (
            MasterJournal,
            restore_master_state,
        )
        from dlrover_tpu_torch.master.shard.task_manager import TaskManager

        t0 = time.monotonic()
        reopened = MasterJournal(journal_path)
        tm = TaskManager(task_timeout=600.0)
        restore_master_state(reopened.recovered, task_manager=tm)
        recovery_s = time.monotonic() - t0
        recovered_records = reopened.recovered.records
        reopened.close()
        tm.stop()

        invariants = "pass" if delta <= RPS_DELTA_BOUND else (
            f"fail: journaled lease path lost {delta:.1%} RPS "
            f"(bound {RPS_DELTA_BOUND:.0%})"
        )
        return {
            "max_rps_unjournaled": round(base["rps"], 1),
            "max_rps_journaled": round(jrun["rps"], 1),
            "rps_delta_frac": round(delta, 4),
            "master_recovery_s": round(recovery_s, 3),
            "journal_records": recovered_records,
            "journal_commit_groups": jstats["commit_groups"],
            "journal_segment_mb": round(
                jstats["segment_bytes"] / 1e6, 2
            ),
            "journal_fs": _filesystem_of(journal_path),
            "drivers": DRIVERS,
            "dataset_shards": DATASET_SIZE // SHARD_SIZE,
            "invariants": invariants,
        }
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="master recovery bench")
    parser.add_argument("--work-dir", default=None,
                        help="where the journal goes (default: a temp dir)")
    args = parser.parse_args(argv)
    out = run_bench(args.work_dir)
    print(json.dumps(out, indent=2))
    return 0 if out["invariants"] == "pass" else 1


if __name__ == "__main__":
    sys.exit(main())
