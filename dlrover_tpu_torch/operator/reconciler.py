"""ElasticJob reconciler: the operator-side control loop.

Parity: reference go/elasticjob/pkg/controllers/elasticjob_controller.go:
85-374 + master.go:56-181 — watches ElasticJob custom resources and, for
each, creates the job-master pod and its service, tracks replica/job
phases into the CR status, and garbage-collects everything when the CR
is deleted. The reference implements this in Go with controller-runtime;
here it is a small Python watch loop over the same narrow K8sApi surface
the scaler/watcher use, testable against FakeK8sApi.

ElasticJob spec shape (deploy/elasticjob_crd.yaml):

    apiVersion: elastic.iml.github.io/v1alpha1
    kind: ElasticJob
    metadata: {name: my-job}
    spec:
      image: ghcr.io/example/dlrover-tpu:latest
      nodeUnit: 2                 # hosts per TPU slice block
      masterResource: {cpu: 2, memory_mb: 4096}
      replicaSpecs:
        worker:
          replicas: 8
          resource: {tpu_chips: 4, tpu_type: tpu-v5e, memory_mb: 16384}
          topology: 4x4

Run in-cluster: ``python -m dlrover_tpu_torch.operator --namespace default``.

The port's copy of ``dlrover_tpu/operator/reconciler.py``. The
master pod runs ``python -m dlrover_tpu_torch.master.main``, where the
reference's runs its own package's (a declared divergence, ROADMAP
"Divergences"); every other key of the manifests is the reference's.
"""

import threading
import time
from typing import Dict, Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.scheduler.k8s_client import (
    ELASTICJOB_GROUP,
    ELASTICJOB_PLURAL,
    ELASTICJOB_VERSION,
    K8sApi,
    get_k8s_api,
)


class JobPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


MASTER_PORT = 50001


def master_name(job_name: str) -> str:
    return f"{job_name}-dlrover-master"


def master_pod_manifest(job: Dict, namespace: str) -> Dict:
    """The job-master pod for an ElasticJob (reference master.go:56-181
    NewMasterTemplateToJob)."""
    name = job["metadata"]["name"]
    spec = job.get("spec", {})
    image = spec.get("image", "dlrover-tpu:latest")
    res = spec.get("masterResource", {})
    replicas = (
        spec.get("replicaSpecs", {}).get("worker", {}).get("replicas", 1)
    )
    args = [
        "python",
        "-m",
        "dlrover_tpu_torch.master.main",
        "--platform",
        "gke_tpu",
        "--job_name",
        name,
        "--namespace",
        namespace,
        "--node_num",
        str(replicas),
        "--port",
        str(MASTER_PORT),
    ]
    node_unit = spec.get("nodeUnit", 0)
    if node_unit:
        args += ["--node_unit", str(node_unit)]
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": master_name(name),
            "labels": {
                "job-name": name,
                "role": "dlrover-master",
            },
            "ownerReferences": [owner_reference(job)],
        },
        "spec": {
            "restartPolicy": "Never",
            "containers": [
                {
                    "name": "master",
                    "image": image,
                    "command": args,
                    "ports": [{"containerPort": MASTER_PORT}],
                    "resources": {
                        "limits": {
                            "cpu": str(res.get("cpu", 2)),
                            "memory": f"{res.get('memory_mb', 4096)}Mi",
                        }
                    },
                }
            ],
        },
    }


def master_service_manifest(job: Dict) -> Dict:
    name = job["metadata"]["name"]
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": master_name(name),
            "labels": {"job-name": name},
            "ownerReferences": [owner_reference(job)],
        },
        "spec": {
            "selector": {"job-name": name, "role": "dlrover-master"},
            "ports": [{"port": MASTER_PORT, "targetPort": MASTER_PORT}],
        },
    }


def owner_reference(job: Dict) -> Dict:
    """Children carry an owner ref so cluster GC also covers them when
    the controller itself is down (reference controller SetControllerReference)."""
    return {
        "apiVersion": f"{ELASTICJOB_GROUP}/{ELASTICJOB_VERSION}",
        "kind": "ElasticJob",
        "name": job["metadata"]["name"],
        "uid": job["metadata"].get("uid", ""),
        "controller": True,
        "blockOwnerDeletion": True,
    }


class ElasticJobReconciler:
    def __init__(
        self,
        namespace: str = "default",
        api: Optional[K8sApi] = None,
        resync_interval_s: float = 30.0,
    ):
        self._namespace = namespace
        self._api = api or get_k8s_api()
        self._resync_interval_s = resync_interval_s
        self._stopped = threading.Event()
        self._threads = []

    # ---- control loop ------------------------------------------------------

    def start(self):
        for target in (self._watch_loop, self._resync_loop):
            t = threading.Thread(
                target=target, name=target.__name__, daemon=True
            )
            t.start()
            self._threads.append(t)
        logger.info(
            "elasticjob reconciler started (namespace=%s)", self._namespace
        )

    def stop(self):
        self._stopped.set()

    def join(self, timeout: float = 5.0):
        for t in self._threads:
            t.join(timeout)

    def _watch_loop(self):
        while not self._stopped.is_set():
            try:
                for event in self._api.watch_custom_objects(
                    self._namespace, ELASTICJOB_PLURAL
                ):
                    if self._stopped.is_set():
                        return
                    job = event.get("object") or {}
                    if event.get("type") == "DELETED":
                        self.gc_job(job["metadata"]["name"])
                    else:
                        self.reconcile(job)
            except Exception:
                logger.exception("elasticjob watch failed; retrying")
                time.sleep(1.0)

    def _resync_loop(self):
        """Level-triggered safety net: periodic full reconcile so a
        missed watch event cannot leave a job unmanaged."""
        while not self._stopped.wait(self._resync_interval_s):
            self.resync()

    def resync(self):
        for job in self._api.list_custom_objects(
            self._namespace, ELASTICJOB_PLURAL
        ):
            try:
                self.reconcile(job)
            except Exception:
                logger.exception(
                    "reconcile of %s failed", job["metadata"]["name"]
                )

    # ---- reconcile ---------------------------------------------------------

    def reconcile(self, job: Dict):
        name = job["metadata"]["name"]
        pods = {
            p["metadata"]["name"]: p
            for p in self._api.list_pods(
                self._namespace, f"job-name={name}"
            )
            if p.get("metadata", {}).get("labels", {}).get("job-name")
            == name
        }
        m_name = master_name(name)
        if m_name not in pods:
            logger.info("creating master pod for job %s", name)
            if not self._api.create_pod(
                self._namespace, master_pod_manifest(job, self._namespace)
            ):
                logger.error("master pod create failed for %s", name)
            pods = {
                p["metadata"]["name"]: p
                for p in self._api.list_pods(
                    self._namespace, f"job-name={name}"
                )
            }
        # The service is reconciled INDEPENDENTLY of the pod: a deleted
        # or failed-to-create service must be recreated on the next
        # pass, or workers can never resolve the master address.
        if self._api.get_service(self._namespace, m_name) is None:
            logger.info("creating master service for job %s", name)
            if not self._api.create_service(
                self._namespace, master_service_manifest(job)
            ):
                logger.error("master service create failed for %s", name)
        self._update_status(job, pods)

    def _update_status(self, job: Dict, pods: Dict[str, Dict]):
        name = job["metadata"]["name"]
        m_pod = pods.get(master_name(name))
        counts: Dict[str, Dict[str, int]] = {}
        for pod in pods.values():
            labels = pod.get("metadata", {}).get("labels", {})
            if labels.get("role") == "dlrover-master":
                continue
            role = labels.get("node-type", "worker")
            phase = pod.get("status", {}).get("phase", "Pending").lower()
            counts.setdefault(role, {})
            counts[role][phase] = counts[role].get(phase, 0) + 1

        phase = JobPhase.PENDING
        if m_pod is not None:
            master_phase = m_pod.get("status", {}).get("phase", "Pending")
            phase = {
                "Pending": JobPhase.PENDING,
                "Running": JobPhase.RUNNING,
                "Succeeded": JobPhase.SUCCEEDED,
                "Failed": JobPhase.FAILED,
            }.get(master_phase, JobPhase.PENDING)

        status = {"phase": phase, "replicaStatuses": counts}
        if job.get("status") != status:
            self._api.patch_custom_object_status(
                self._namespace, ELASTICJOB_PLURAL, name, status
            )

    # ---- garbage collection ------------------------------------------------

    def gc_job(self, job_name: str):
        """Delete everything the job owns (reference controller
        handleDeletedJob); owner refs double-cover this when the cluster
        GC runs."""
        logger.info("garbage-collecting job %s", job_name)
        for pod in self._api.list_pods(
            self._namespace, f"job-name={job_name}"
        ):
            pod_name = pod.get("metadata", {}).get("name", "")
            labels = pod.get("metadata", {}).get("labels", {})
            if pod_name and labels.get("job-name") == job_name:
                self._api.delete_pod(self._namespace, pod_name)
        self._api.delete_service(self._namespace, master_name(job_name))
