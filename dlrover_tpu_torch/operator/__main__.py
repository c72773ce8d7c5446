"""Run the ElasticJob reconciler in-cluster:
``python -m dlrover_tpu_torch.operator --namespace default``.

The port's copy of ``dlrover_tpu/operator/__main__.py``.
"""

import argparse
import signal
import threading

from dlrover_tpu_torch.operator.reconciler import ElasticJobReconciler


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="dlrover-tpu elasticjob operator")
    ap.add_argument("--namespace", default="default")
    ap.add_argument("--resync_interval", type=float, default=30.0)
    ns = ap.parse_args(argv)

    reconciler = ElasticJobReconciler(
        namespace=ns.namespace, resync_interval_s=ns.resync_interval
    )
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    reconciler.start()
    reconciler.resync()
    stop.wait()
    reconciler.stop()
    reconciler.join()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
