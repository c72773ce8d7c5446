"""Master CLI args (parity: reference dlrover/python/master/args.py; the
port's copy of ``dlrover_tpu/master/args.py``, whose transport defaults
to HTTP).

Only the flags the local master reads are here, the four autoscale
flags among them (``--autoscale_loop``, ``--autoscale_dry_run``,
``--autoscale_interval_s``, ``--autoscale_record``). The distributed
master's flags (namespace, network check, dashboard, brain, metric
endpoints, topology, node unit, auto-scaling, legal worker counts,
``--autoscale_max_world`` and ``--autoscale_ckpt_interval_s``) come back
with it (ROADMAP §A item 8).
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
        help="cluster backend (only local is ported)",
    )
    parser.add_argument("--node_num", type=int, default=1)
    parser.add_argument("--max_relaunch_count", type=int, default=3)
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
        "--autoscale_loop",
        action="store_true",
        default=False,
        help="run the closed-loop autoscaler: watch goodput/straggler/"
        "queue/fault signals; actuate straggler eviction and the ckpt "
        "cadence (Young/Daly from observed MTBF); world and fleet "
        "decisions stay advisory in the local master",
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
        "--autoscale_record",
        type=str,
        default="",
        help="durably record the autoscaler's signal/decision/outcome "
        "stream to this JSONL path for offline what-if policy replay "
        "(tools/torch_whatif.py); also armed by "
        "DLROVER_TPU_AUTOSCALE_RECORD",
    )
    return parser


def parse_master_args(args=None):
    return build_master_parser().parse_args(args)
