"""Kubernetes Pod scaler for GPU worker hosts.

Parity: reference dlrover/python/master/scaler/pod_scaler.py:84 (891 LoC)
— the master converges the cluster to a ScalePlan by creating/deleting
worker Pods directly against the k8s API through a background queue.

The port's copy of ``dlrover_tpu/master/scaler/pod_scaler.py``. One
worker Pod per host; agent env (NODE_ID/NODE_RANK/MASTER_ADDR/JOB_NAME)
is injected so the launched agent dials home. The Pod asks for the
port's accelerator, which are its three declared divergences (ROADMAP
"Divergences"); every other key is the reference's:

- ``resources`` request ``nvidia.com/gpu`` (the NVIDIA device plugin's
  resource), ``NodeResource.tpu_chips`` of them, where the reference
  requests ``google.com/tpu``;
- the ``nodeSelector`` names the GPU type under
  ``GPU_PRODUCT_LABEL`` (``nvidia.com/gpu.product``, the label NVIDIA's
  GPU feature discovery puts on each node; value
  ``NodeResource.tpu_type``, e.g. ``NVIDIA-H100-80GB-HBM3``), where the
  reference names a TPU accelerator and a slice topology (a GPU host
  has no slice topology, so the port takes no ``tpu_topology``);
- the default container command is ``python -m dlrover_tpu_torch.run``.
"""

import queue
import threading
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node, NodeResource
from dlrover_tpu_torch.master.scaler.base_scaler import ScalePlan, Scaler
from dlrover_tpu_torch.master.scheduler.k8s_client import K8sApi, get_k8s_api

_QUEUE_STOP = object()

GPU_RESOURCE = "nvidia.com/gpu"
GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"


def pod_name(job_name: str, node: Node) -> str:
    return f"{job_name}-worker-{node.id}"


def build_worker_pod_manifest(
    job_name: str,
    node: Node,
    master_addr: str,
    image: str,
    command: Optional[list] = None,
) -> Dict:
    res: NodeResource = node.config_resource
    limits: Dict[str, str] = {}
    if res.cpu > 0:
        limits["cpu"] = str(res.cpu)
    if res.memory_mb > 0:
        limits["memory"] = f"{int(res.memory_mb)}Mi"
    if res.tpu_chips > 0:
        limits[GPU_RESOURCE] = str(res.tpu_chips)
    node_selector: Dict[str, str] = {}
    if res.tpu_type:
        node_selector[GPU_PRODUCT_LABEL] = res.tpu_type
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": pod_name(job_name, node),
            "labels": {
                "app": "dlrover-tpu",
                "job-name": job_name,
                "node-id": str(node.id),
                "rank-index": str(node.rank_index),
                "node-type": node.type,
            },
        },
        "spec": {
            "restartPolicy": "Never",
            "nodeSelector": node_selector,
            "containers": [
                {
                    "name": "worker",
                    "image": image,
                    "command": command
                    or ["python", "-m", "dlrover_tpu_torch.run"],
                    "env": [
                        {"name": NodeEnv.NODE_ID, "value": str(node.id)},
                        {
                            "name": NodeEnv.NODE_RANK,
                            "value": str(node.rank_index),
                        },
                        {"name": NodeEnv.MASTER_ADDR, "value": master_addr},
                        {"name": NodeEnv.JOB_NAME, "value": job_name},
                    ],
                    "resources": {"limits": limits, "requests": limits},
                }
            ],
        },
    }


class PodScaler(Scaler):
    def __init__(
        self,
        job_name: str,
        namespace: str = "default",
        master_addr: str = "",
        image: str = "dlrover-tpu:latest",
        command: Optional[list] = None,
        api: Optional[K8sApi] = None,
    ):
        super().__init__(job_name)
        self._namespace = namespace
        self._master_addr = master_addr
        self._image = image
        self._command = command
        self._api = api or get_k8s_api()
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._create_attempts: Dict[int, int] = {}
        self._max_create_attempts = 5
        self._retry_delay_s = 5.0
        # Node ids removed since their (possibly failed) create: a retry
        # must not resurrect a pod that was scaled away in the meantime.
        self._removed_ids: set = set()
        self._retry_timers: list = []
        self._stopped = False

    def set_master_addr(self, addr: str):
        if not self._master_addr:
            self._master_addr = addr

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._worker_loop, name="pod-scaler", daemon=True
            )
            self._thread.start()

    def stop(self):
        self._stopped = True
        for timer in self._retry_timers:
            timer.cancel()
        self._queue.put(_QUEUE_STOP)

    def scale(self, plan: ScalePlan):
        """Queue the plan; pod API calls run on the scaler thread so a
        slow API server never blocks event processing (reference
        pod_scaler queue design)."""
        self._queue.put(plan)

    def scale_now(self, plan: ScalePlan):
        """Synchronous variant for tests/shutdown paths."""
        self._apply(plan)

    def _worker_loop(self):
        while True:
            item = self._queue.get()
            if item is _QUEUE_STOP:
                return
            try:
                self._apply(item)
            except Exception:
                logger.exception("scale plan application failed")

    def _apply(self, plan: ScalePlan):
        retry = ScalePlan()
        for node in plan.launch_nodes:
            if node.id in self._removed_ids:
                continue  # scaled away while a retry was pending
            manifest = build_worker_pod_manifest(
                self._job_name,
                node,
                self._master_addr,
                self._image,
                self._command,
            )
            if self._api.create_pod(self._namespace, manifest):
                self._create_attempts.pop(node.id, None)
                continue
            # The scale() contract is convergence: a transient API-server
            # failure must not permanently orphan the rank.
            attempts = self._create_attempts.get(node.id, 0) + 1
            self._create_attempts[node.id] = attempts
            if attempts < self._max_create_attempts:
                logger.warning(
                    "pod create for %s failed (attempt %d); will retry",
                    node.name,
                    attempts,
                )
                retry.launch_nodes.append(node)
            else:
                logger.error(
                    "pod create for %s failed %d times; giving up",
                    node.name,
                    attempts,
                )
        for node in plan.remove_nodes:
            self._removed_ids.add(node.id)
            self._api.delete_pod(
                self._namespace, pod_name(self._job_name, node)
            )
        if retry.launch_nodes and not self._stopped:
            timer = threading.Timer(
                self._retry_delay_s, self._queue.put, args=(retry,)
            )
            timer.daemon = True
            timer.start()
            self._retry_timers = [
                t for t in self._retry_timers if t.is_alive()
            ] + [timer]
