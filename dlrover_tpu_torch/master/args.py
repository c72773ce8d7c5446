"""Master CLI args (parity: reference dlrover/python/master/args.py; the
port's copy of ``dlrover_tpu/master/args.py``, whose transport defaults
to HTTP).

The distributed master (``--platform sim``, ``k8s`` or ``gke_tpu``)
reads the flags that follow ``--namespace``: ``--dashboard_port >= 0``
serves the dashboard, ``--brain_addr`` reports to a brain service.
"""

import argparse


def build_master_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="dlrover-tpu job master")
    parser.add_argument("--port", type=int, default=0, help="RPC port (0=auto)")
    parser.add_argument("--job_name", type=str, default="dlrover-tpu-job")
    parser.add_argument(
        "--platform",
        type=str,
        default="local",
        choices=["local", "sim", "k8s", "gke_tpu"],
        help="cluster backend",
    )
    parser.add_argument("--node_num", type=int, default=1)
    parser.add_argument("--max_relaunch_count", type=int, default=3)
    parser.add_argument("--namespace", type=str, default="default")
    parser.add_argument(
        "--transport", type=str, default="http", choices=["grpc", "http"]
    )
    parser.add_argument(
        "--port_file",
        type=str,
        default="",
        help="write the bound RPC port to this file (standalone bootstrap)",
    )
    parser.add_argument("--pre_check", action="store_true", default=False)
    parser.add_argument("--network_check", action="store_true", default=False)
    parser.add_argument(
        "--dashboard_port",
        type=int,
        default=-1,
        help="serve the web dashboard on this port (-1 = off, 0 = auto)",
    )
    parser.add_argument(
        "--brain_addr",
        type=str,
        default="",
        help="host:port of a brain service (cross-job stats + optimizer)",
    )
    parser.add_argument(
        "--metric_endpoints",
        type=str,
        default="",
        help="out-of-band metric scrape targets, 'node=host:port,...' "
        "(per-node tpu_timer daemons or any Prometheus exporter)",
    )
    parser.add_argument(
        "--topology_aware",
        action="store_true",
        default=False,
        help="order ranks by network topology (slice-mates adjacent)",
    )
    parser.add_argument(
        "--global_batch_size",
        type=int,
        default=0,
        help="job global batch (enables micro-batch/accum suggestions)",
    )
    parser.add_argument(
        "--micro_batch_per_device",
        type=int,
        default=0,
        help="per-device micro batch; with --global_batch_size, "
        "restricts rendezvous/rescale worlds to dp sizes where "
        "global_batch %% (micro * dp) == 0",
    )
    parser.add_argument(
        "--devices_per_node",
        type=int,
        default=4,
        help="devices per worker host: dp = nodes * devices_per_node "
        "in the batch config's legality",
    )
    parser.add_argument(
        "--node_unit",
        type=int,
        default=0,
        help="hosts per slice block: drives complete-group rendezvous, "
        "slice-aware network check, and whole-block relaunch on "
        "hardware faults (0 = ungrouped)",
    )
    parser.add_argument(
        "--auto_scale",
        action="store_true",
        default=False,
        help="enable the throughput-driven worker auto-scaler",
    )
    parser.add_argument(
        "--autoscale_loop",
        action="store_true",
        default=False,
        help="run the closed-loop autoscaler: watch goodput/straggler/"
        "queue/fault signals; actuate straggler eviction and the ckpt "
        "cadence (Young/Daly from observed MTBF) and, with "
        "--autoscale_max_world on the distributed master, world "
        "resizes; world and fleet decisions stay advisory in the local "
        "master",
    )
    parser.add_argument(
        "--autoscale_dry_run",
        action="store_true",
        default=False,
        help="autoscaler decides and ledgers but never actuates "
        "(advisory mode)",
    )
    parser.add_argument(
        "--autoscale_interval_s",
        type=float,
        default=5.0,
        help="autoscaler decision-loop cadence in seconds",
    )
    parser.add_argument(
        "--autoscale_max_world",
        type=int,
        default=0,
        help="unpin the autoscaler's backlog-driven world resize up to "
        "this many workers (0 = world pinned: only straggler eviction, "
        "ckpt cadence and the brain seed actuate); clamped to "
        "--legal_worker_counts when given",
    )
    parser.add_argument(
        "--autoscale_record",
        type=str,
        default="",
        help="durably record the autoscaler's signal/decision/outcome "
        "stream to this JSONL path for offline what-if policy replay "
        "(tools/torch_whatif.py); also armed by "
        "DLROVER_TPU_AUTOSCALE_RECORD",
    )
    parser.add_argument(
        "--autoscale_ckpt_interval_s",
        type=float,
        default=60.0,
        help="starting flash-ckpt cadence the autoscaler retunes from "
        "observed MTBF (Young/Daly); published on the "
        "autoscaler_ckpt_interval_s gauge and /api/autoscaler",
    )
    parser.add_argument(
        "--legal_worker_counts",
        type=str,
        default="",
        help="comma-separated legal worker counts (mesh shapes), e.g. 1,2,4,8",
    )
    return parser


def parse_master_args(args=None):
    return build_master_parser().parse_args(args)
