"""Master CLI args (parity: reference dlrover/python/master/args.py; the
port's copy of ``dlrover_tpu/master/args.py``, whose transport defaults
to HTTP).

Only the flags the local master reads are here. The distributed
master's flags (namespace, network check, dashboard, brain, metric
endpoints, topology, node unit, auto-scaling, legal worker counts) come
back with it (ROADMAP §A item 8). ``--autoscale_loop``, whose path is not
ported, raises ``NotImplementedError`` naming its ROADMAP §A item (4).
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
        help="run the closed-loop autoscaler (not ported: ROADMAP §A "
        "item 4)",
    )
    return parser


def parse_master_args(args=None):
    return build_master_parser().parse_args(args)
