"""``python -m dlrover_tpu_torch.run`` — the elastic launcher CLI.

Parity: reference dlrover/trainer/torch/elastic_run.py (``dlrover-run``):
a torchrun-superset that (a) bootstraps a local master in standalone mode,
(b) merges master-pushed config, (c) gates on pre-check, then hands off to
the elastic agent. The port's copy of ``dlrover_tpu/run.py``: the
launched workers are PyTorch processes, the local master is the port's
(``python -m dlrover_tpu_torch.master.main --platform local --transport
http``), and ``-m`` runs the training script as a module, as torchrun's
does.

Usage:
    python -m dlrover_tpu_torch.run --standalone --nproc_per_node 1 train.py ...
    python -m dlrover_tpu_torch.run --standalone -m pkg.train --steps 10
    python -m dlrover_tpu_torch.run --master host:port --nnodes 2:4 train.py ...

``--network-check`` runs the node check (``agent/node_check.py``, the
port's probe on the card) before the workers start, and exits 3 without
starting them if this node fails it. With ``DLROVER_TPU_MASTER_JOURNAL``
set, the local master keeps its durable journal there and a restarted
master comes back from it. ``--ckpt_replica_group N`` (N > 1) starts
the checkpoint replica service (``flash_ckpt/replica.py``): the saver
pushes each shm image to the node's group peers, and a relaunched node
pulls its missing segments back from a peer before its workers start,
so they restore from memory; without a replica token it runs without
replicas. With ``DLROVER_TPU_TIMER=1`` each worker runs the tpu_timer
daemon (``trainer/runtime``) and the launcher starts one collector per
local rank that scrapes it every 30 s and forwards the parsed gauges
to the master's diagnosis store; ``DLROVER_TPU_TIMER_XLA=1`` adds the device-capture
listener in each worker (``tpu_timer/xla_capture``). The launcher leaves
the checkpoint saver's shared-memory segments behind when it exits, as
the reference's does: whoever owns the job's name unlinks them.
"""

import argparse
import atexit
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional, Tuple

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.monitor import ResourceMonitor
from dlrover_tpu_torch.agent.training_monitor import (
    METRICS_FILE_ENV,
    TrainingMonitor,
)
from dlrover_tpu_torch.agent.training import ElasticAgent, RunResult, WorkerSpec
from dlrover_tpu_torch.common.constants import (
    NodeEnv,
    PreCheckStatus,
)
from dlrover_tpu_torch.common.env_utils import get_env_bool, get_env_int
from dlrover_tpu_torch.common.log import logger


def parse_nnodes(value: str) -> Tuple[int, int]:
    if ":" in value:
        lo, hi = value.split(":", 1)
        return int(lo), int(hi)
    n = int(value)
    return n, n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dlrover-tpu-torch-run",
        description="elastic PyTorch process launcher",
    )
    p.add_argument("--standalone", action="store_true", default=False)
    p.add_argument("--master", type=str, default="", help="master addr host:port")
    p.add_argument("--nnodes", type=str, default="1", help="N or MIN:MAX")
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=-1)
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--node_unit", type=int, default=1)
    p.add_argument("--rdzv_join_timeout", type=float, default=600.0)
    p.add_argument("--monitor_interval", type=float, default=1.0)
    p.add_argument(
        "--network-check",
        action="store_true",
        default=False,
        help="run node/ICI health probes before training",
    )
    p.add_argument(
        "--comm-perf-test",
        action="store_true",
        default=False,
        help="include bandwidth benchmarks in the network check",
    )
    p.add_argument("--log_dir", type=str, default="")
    p.add_argument("--pre_check_timeout", type=float, default=600.0)
    p.add_argument(
        "--ckpt_replica_group",
        type=int,
        default=1,
        help="nodes per in-memory checkpoint replica group (1 = off)",
    )
    p.add_argument(
        "-m",
        "--module",
        action="store_true",
        default=False,
        help="run training_script as a python module (python -m)",
    )
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p


def _launch_local_master(node_num: int) -> Tuple[subprocess.Popen, str]:
    """Standalone bootstrap (reference elastic_run.py:326
    _launch_dlrover_local_master)."""
    port_dir = tempfile.mkdtemp(prefix="dlrover_tpu_")
    port_file = os.path.join(port_dir, "master_port")
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [
            sys.executable,
            "-m",
            "dlrover_tpu_torch.master.main",
            "--platform",
            "local",
            "--transport",
            "http",
            "--node_num",
            str(node_num),
            "--port_file",
            port_file,
        ],
        start_new_session=True,
    )
    deadline = time.time() + 60
    while time.time() < deadline:
        if os.path.exists(port_file):
            with open(port_file) as f:
                port = f.read().strip()
            if port:
                shutil.rmtree(port_dir, ignore_errors=True)
                logger.info(
                    "local master pid=%d serving at 127.0.0.1:%s after "
                    "%.3f s",
                    proc.pid,
                    port,
                    time.monotonic() - t0,
                )
                return proc, f"127.0.0.1:{port}"
        if proc.poll() is not None:
            raise RuntimeError("local master exited during startup")
        time.sleep(0.2)
    proc.kill()
    raise RuntimeError("local master did not publish its port in 60s")


def wait_pre_check(client: MasterClient, timeout: float):
    """Gate on master pre-check (reference elastic_run.py:295)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            status = client.get_pre_check_result()
        except Exception:
            time.sleep(1)
            continue
        if status in (PreCheckStatus.PASS, PreCheckStatus.DISABLED):
            return
        if status == PreCheckStatus.FAIL:
            raise SystemExit("master pre-check failed; aborting launch")
        time.sleep(2)
    raise SystemExit("timed out waiting for master pre-check")


def _merge_master_config(client: MasterClient, args):
    """Master-pushed config overrides CLI defaults (reference
    elastic_run.py:438 _merge_elastic_config_from_master)."""
    try:
        config = client.get_elastic_run_config()
    except Exception:
        return
    if "network_check" in config:
        args.network_check = config["network_check"].lower() == "true"
    if "max_restarts" in config:
        args.max_restarts = int(config["max_restarts"])
    if "monitor_interval" in config:
        args.monitor_interval = float(config["monitor_interval"])


def _start_timer_collectors(client: MasterClient, node_rank: int,
                            nproc_per_node: int):
    """Under ``DLROVER_TPU_TIMER``, one collector per local rank that
    scrapes the worker's daemon (its published port, or 18889 + local
    rank) and forwards the parsed gauges to the master (reference
    run.py:235-248)."""
    if not get_env_bool("DLROVER_TPU_TIMER"):
        return []
    from dlrover_tpu_torch.diagnosis.collectors import (
        TpuTimerMetricCollector,
    )
    from dlrover_tpu_torch.tpu_timer.bridge import port_file_path

    collectors = []
    for local_rank in range(nproc_per_node):
        c = TpuTimerMetricCollector(
            master_client=client,
            node_id=node_rank,
            port=18889 + local_rank,
            port_file=port_file_path(local_rank),
        )
        c.start()
        logger.info("tpu_timer collector of local rank %d every %.0f s",
                    local_rank, c.interval_s)
        collectors.append(c)
    return collectors


def _start_replica_manager(args, client: MasterClient, node_rank: int,
                           max_nodes: int):
    """The checkpoint replica service for ``--ckpt_replica_group`` above
    1 (reference run.py:263-303), or None: without a replica token the
    node runs without replicas. A relaunched node pulls its missing shm
    segments from a peer before any worker starts."""
    if args.ckpt_replica_group <= 1:
        return None
    from dlrover_tpu_torch.common.env_utils import get_hostname_ip
    from dlrover_tpu_torch.flash_ckpt.replica import (
        CkptReplicaManager,
        ReplicaTokenUnavailable,
    )

    try:
        replica_manager = CkptReplicaManager(
            node_rank=node_rank,
            master_client=client,
            group_size=args.ckpt_replica_group,
        )
    except ReplicaTokenUnavailable:
        logger.error(
            "no replica auth token available; running WITHOUT "
            "cross-host checkpoint replicas"
        )
        return None
    # Publish a routable address, not loopback: peers resolve it from
    # the master KV store.
    replica_manager.start(advertise_host=get_hostname_ip()[1])
    try:
        # Ask every possible rank: the push-time grouping used the
        # rendezvous world, which this fresh node cannot reconstruct.
        t0 = time.monotonic()
        restored = replica_manager.restore_missing_segments(
            args.nproc_per_node,
            candidate_ranks=list(range(max_nodes)),
        )
        seconds = time.monotonic() - t0
        missing = replica_manager.last_pull_missing
        if restored:
            logger.info(
                "restored %d shm checkpoint segments from peers (%d bytes "
                "in %.3f s)", restored, replica_manager.last_pull_bytes,
                seconds,
            )
        if missing > restored:
            logger.warning(
                "%d shm checkpoint segments missing and on no peer; the "
                "workers restore from storage if it holds a step",
                missing - restored,
            )
    except Exception:
        logger.warning(
            "replica pull failed; storage restore will be used",
            exc_info=True,
        )
    return replica_manager


def _stop_master(master_proc: Optional[subprocess.Popen],
                 timeout: float = 30.0):
    """Never return while the master lives: wait for it, then stop it."""
    if master_proc is None:
        return
    try:
        master_proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        master_proc.terminate()
        try:
            master_proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            master_proc.kill()
            master_proc.wait()


def run(args) -> int:
    min_nodes, max_nodes = parse_nnodes(args.nnodes)
    master_proc: Optional[subprocess.Popen] = None

    node_rank = args.node_rank
    if node_rank < 0:
        node_rank = get_env_int(NodeEnv.NODE_RANK, 0)

    if args.standalone and not args.master:
        master_proc, master_addr = _launch_local_master(max_nodes)

        def _cleanup():
            if master_proc.poll() is None:
                master_proc.terminate()
                try:
                    master_proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    master_proc.kill()

        atexit.register(_cleanup)
    else:
        master_addr = args.master or os.getenv(NodeEnv.MASTER_ADDR, "")
        if not master_addr:
            raise SystemExit(
                "--master (or DLROVER_TPU_MASTER_ADDR) required unless "
                "--standalone"
            )

    os.environ[NodeEnv.MASTER_ADDR] = master_addr
    os.environ[NodeEnv.NODE_RANK] = str(node_rank)
    client = MasterClient(master_addr, node_id=node_rank)
    if not client.wait_master_ready(60):
        raise SystemExit(f"master at {master_addr} not reachable")

    _merge_master_config(client, args)
    wait_pre_check(client, args.pre_check_timeout)

    if args.network_check:
        from dlrover_tpu_torch.agent.node_check import run_network_check

        ok = run_network_check(
            client,
            node_rank=node_rank,
            nproc_per_node=args.nproc_per_node,
            comm_perf=args.comm_perf_test,
            node_unit=args.node_unit,
        )
        if not ok:
            logger.error("node failed network check; exiting for relaunch")
            _stop_master(master_proc, timeout=0)
            return 3
        faults, evaluated_round, _ = client.check_fault_node()
        logger.info(
            "network check passed: node %d, the master's fault nodes %s "
            "after round %d, stragglers %s",
            node_rank, faults, evaluated_round, client.check_straggler(),
        )

    monitor = ResourceMonitor(client)
    monitor.start()

    # Metrics-file step reporting (reference TorchTrainingMonitor): a
    # training loop that never talks RPC still feeds goodput accounting
    # by appending JSON lines to DLROVER_TPU_METRICS_FILE.
    training_monitor = None
    metrics_path = os.getenv(METRICS_FILE_ENV, "")
    if metrics_path:
        training_monitor = TrainingMonitor(client, metrics_path)
        training_monitor.start()

    from dlrover_tpu_torch.agent.paral_config_tuner import ParalConfigTuner

    paral_tuner = ParalConfigTuner(client)
    paral_tuner.start()

    # User-pluggable failover extension (reference
    # trainer/torch/elastic_run.py:550 _setup_dynamic_failover_extension):
    # DLROVER_TPU_FAILOVER_EXT="pkg.module:factory" -> factory(client,
    # node_rank) returning a DiagnosisAgent-compatible object.
    diagnosis_agent = None
    ext_spec = os.getenv("DLROVER_TPU_FAILOVER_EXT", "")
    if ext_spec:
        try:
            module_name, factory_name = ext_spec.split(":", 1)
            import importlib

            module = importlib.import_module(module_name)
            diagnosis_agent = getattr(module, factory_name)(
                client, node_rank
            )
            logger.info("loaded failover extension %s", ext_spec)
        except Exception:
            logger.exception(
                "failover extension %r failed to load; using default",
                ext_spec,
            )

    timer_collectors = _start_timer_collectors(client, node_rank,
                                               args.nproc_per_node)

    spec = WorkerSpec(
        entrypoint=(
            f"-m {args.training_script}" if args.module
            else args.training_script
        ),
        args=list(args.training_script_args),
        nproc_per_node=args.nproc_per_node,
        max_restarts=args.max_restarts,
        node_rank=node_rank,
        node_unit=args.node_unit,
        join_timeout=args.rdzv_join_timeout,
        monitor_interval=args.monitor_interval,
        redirect_output=args.log_dir or None,
    )
    from dlrover_tpu_torch.flash_ckpt.saver import AsyncCheckpointSaver

    replica_manager = _start_replica_manager(
        args, client, node_rank, max_nodes
    )
    saver = AsyncCheckpointSaver.start_async_saving_ckpt(
        client=client, replica_manager=replica_manager
    )
    agent = ElasticAgent(
        spec, client, ckpt_saver=saver, diagnosis_agent=diagnosis_agent
    )

    def _signal_handler(signum, frame):
        logger.info("launcher received signal %d; stopping workers", signum)
        agent.stop()
        if training_monitor is not None:
            # Preemption is exactly when the final steps matter for
            # goodput accounting: flush them before dying.
            try:
                training_monitor.poll_once()
            except Exception:
                pass
        sys.exit(128 + signum)

    signal.signal(signal.SIGTERM, _signal_handler)

    result = agent.run()
    # Unlike the reference's launcher, let a persist in flight (the
    # last cadence save, a breakpoint save) land and take the saver's
    # sockets down before exiting; its shm segments stay.
    agent.wait_breakpoint_save()
    saver.stop()
    if replica_manager is not None:
        replica_manager.stop()
    monitor.stop()
    if training_monitor is not None:
        training_monitor.poll_once()  # flush the final steps
        training_monitor.stop()
    paral_tuner.stop()
    for c in timer_collectors:
        c.stop()
    if result == RunResult.SUCCEEDED:
        code = 0
    elif result == RunResult.RELAUNCH:
        code = 3  # cluster layer replaces this node
    else:
        code = 1
    _stop_master(master_proc)
    return code


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
