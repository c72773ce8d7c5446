"""Master process entry point.

Parity: reference dlrover/python/master/main.py. Run as
``python -m dlrover_tpu_torch.master.main --platform local --node_num 2``
(the port's copy of ``dlrover_tpu/master/main.py``, over HTTP unless
``--transport grpc``). ``--platform sim`` runs the distributed master
over the simulated cluster; ``k8s`` and ``gke_tpu`` raise
``NotImplementedError`` until their scaler and watcher are ported
(ROADMAP §A item 8b).
"""

import os
import signal
import sys

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.args import parse_master_args


def _install_sigterm(master):
    """SIGTERM = graceful shutdown (DESIGN.md §37): the run loop exits
    on the stop flag and stop() drains the server, runs journal
    flush+fsync hooks, and writes the clean-shutdown close record."""

    def _on_term(signum, frame):
        logger.info("SIGTERM received: requesting graceful master stop")
        req = getattr(master, "request_stop", None)
        (req or master.stop)()

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass  # not on the main thread (embedded use) — caller owns signals


def run(args) -> int:
    if args.platform == "local":
        from dlrover_tpu_torch.master.local_master import LocalJobMaster

        batch_config = None
        if args.global_batch_size > 0 and args.micro_batch_per_device > 0:
            from dlrover_tpu_torch.trainer.elastic.trainer import (
                ElasticBatchConfig,
            )

            batch_config = ElasticBatchConfig(
                global_batch_size=args.global_batch_size,
                micro_batch_per_device=args.micro_batch_per_device,
            )
        master = LocalJobMaster(
            port=args.port,
            job_name=args.job_name,
            node_num=args.node_num,
            max_relaunch_count=args.max_relaunch_count,
            transport=args.transport,
            batch_config=batch_config,
            devices_per_node=args.devices_per_node,
            autoscale_loop=args.autoscale_loop,
            autoscale_dry_run=args.autoscale_dry_run,
            autoscale_interval_s=args.autoscale_interval_s,
            autoscale_record=args.autoscale_record,
        )
    else:
        from dlrover_tpu_torch.master.dist_master import DistributedJobMaster

        master = DistributedJobMaster.from_args(args)
    master.prepare()
    _install_sigterm(master)
    if args.port_file:
        # Publish the port before any blocking pre-check: agents need it
        # to reach the master, and the connection pre-check needs agents.
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(master.port))
        os.rename(tmp, args.port_file)
    if args.pre_check and hasattr(master, "pre_check"):
        if not master.pre_check():
            logger.error("pre-check failed; aborting job")
            master.stop()
            return 1
    return master.run()


def main(argv=None) -> int:
    args = parse_master_args(argv)
    logger.info("starting dlrover-tpu master: %s", vars(args))
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
