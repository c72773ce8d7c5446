"""Thin Kubernetes API wrapper used by the k8s scaler/watcher.

Parity: reference dlrover/python/scheduler/kubernetes.py (k8sClient
singleton). The ``kubernetes`` package is not a hard dependency: the
surface the scaler/watcher need is narrow (pods + custom objects), so it
is defined here as plain methods and backed either by the real client
(when installed, in-cluster or kubeconfig) or by an injected fake in
tests — the reference's mock_k8s_client pattern (tests/test_utils.py:321).

The port's copy of ``dlrover_tpu/master/scheduler/k8s_client.py``.
"""

import threading
from typing import Dict, Iterator, List, Optional

from dlrover_tpu_torch.common.log import logger

ELASTICJOB_GROUP = "elastic.iml.github.io"
ELASTICJOB_VERSION = "v1alpha1"
SCALEPLAN_PLURAL = "scaleplans"
ELASTICJOB_PLURAL = "elasticjobs"


class K8sApi:
    """The narrow API surface; a fake implements exactly these methods."""

    def create_pod(self, namespace: str, pod_manifest: Dict) -> bool:
        raise NotImplementedError

    def delete_pod(self, namespace: str, name: str) -> bool:
        raise NotImplementedError

    def list_pods(self, namespace: str, label_selector: str) -> List[Dict]:
        raise NotImplementedError

    def watch_pods(
        self, namespace: str, label_selector: str
    ) -> Iterator[Dict]:
        """Yield {"type": ADDED|MODIFIED|DELETED, "object": pod_dict}."""
        raise NotImplementedError

    def create_custom_object(
        self, namespace: str, plural: str, body: Dict
    ) -> bool:
        raise NotImplementedError

    def list_custom_objects(self, namespace: str, plural: str) -> List[Dict]:
        raise NotImplementedError

    def watch_custom_objects(
        self, namespace: str, plural: str
    ) -> Iterator[Dict]:
        """Yield {"type": ADDED|MODIFIED|DELETED, "object": cr_dict}."""
        raise NotImplementedError

    def patch_custom_object_status(
        self, namespace: str, plural: str, name: str, status: Dict
    ) -> bool:
        raise NotImplementedError

    def delete_custom_object(
        self, namespace: str, plural: str, name: str
    ) -> bool:
        raise NotImplementedError

    def create_service(self, namespace: str, manifest: Dict) -> bool:
        raise NotImplementedError

    def get_service(self, namespace: str, name: str) -> Optional[Dict]:
        raise NotImplementedError

    def delete_service(self, namespace: str, name: str) -> bool:
        raise NotImplementedError


class RealK8sApi(K8sApi):
    """Backed by the official kubernetes client (lazy import)."""

    def __init__(self):
        import kubernetes  # gated: raises if not installed

        try:
            kubernetes.config.load_incluster_config()
        except Exception:
            kubernetes.config.load_kube_config()
        self._core = kubernetes.client.CoreV1Api()
        self._custom = kubernetes.client.CustomObjectsApi()
        self._watch = kubernetes.watch

    def create_pod(self, namespace, pod_manifest):
        try:
            self._core.create_namespaced_pod(namespace, pod_manifest)
            return True
        except Exception:
            logger.exception("pod create failed")
            return False

    def delete_pod(self, namespace, name):
        try:
            self._core.delete_namespaced_pod(name, namespace)
            return True
        except Exception:
            logger.warning("pod delete failed: %s", name)
            return False

    def list_pods(self, namespace, label_selector):
        resp = self._core.list_namespaced_pod(
            namespace, label_selector=label_selector
        )
        return [
            self._core.api_client.sanitize_for_serialization(item)
            for item in resp.items
        ]

    def watch_pods(self, namespace, label_selector):
        w = self._watch.Watch()
        for event in w.stream(
            self._core.list_namespaced_pod,
            namespace,
            label_selector=label_selector,
        ):
            obj = self._core.api_client.sanitize_for_serialization(
                event["object"]
            )
            yield {"type": event["type"], "object": obj}

    def create_custom_object(self, namespace, plural, body):
        try:
            self._custom.create_namespaced_custom_object(
                ELASTICJOB_GROUP,
                ELASTICJOB_VERSION,
                namespace,
                plural,
                body,
            )
            return True
        except Exception:
            logger.exception("custom object create failed")
            return False

    def list_custom_objects(self, namespace, plural):
        try:
            resp = self._custom.list_namespaced_custom_object(
                ELASTICJOB_GROUP, ELASTICJOB_VERSION, namespace, plural
            )
            return resp.get("items", [])
        except Exception:
            logger.exception("custom object list failed")
            return []

    def watch_custom_objects(self, namespace, plural):
        w = self._watch.Watch()
        for event in w.stream(
            self._custom.list_namespaced_custom_object,
            ELASTICJOB_GROUP,
            ELASTICJOB_VERSION,
            namespace,
            plural,
        ):
            yield {"type": event["type"], "object": event["object"]}

    def patch_custom_object_status(self, namespace, plural, name, status):
        try:
            self._custom.patch_namespaced_custom_object_status(
                ELASTICJOB_GROUP,
                ELASTICJOB_VERSION,
                namespace,
                plural,
                name,
                {"status": status},
            )
            return True
        except Exception:
            logger.warning("status patch failed: %s", name)
            return False

    def delete_custom_object(self, namespace, plural, name):
        try:
            self._custom.delete_namespaced_custom_object(
                ELASTICJOB_GROUP,
                ELASTICJOB_VERSION,
                namespace,
                plural,
                name,
            )
            return True
        except Exception:
            logger.warning("custom object delete failed: %s", name)
            return False

    def create_service(self, namespace, manifest):
        try:
            self._core.create_namespaced_service(namespace, manifest)
            return True
        except Exception:
            logger.exception("service create failed")
            return False

    def get_service(self, namespace, name):
        try:
            svc = self._core.read_namespaced_service(name, namespace)
            return self._core.api_client.sanitize_for_serialization(svc)
        except Exception:
            return None

    def delete_service(self, namespace, name):
        try:
            self._core.delete_namespaced_service(name, namespace)
            return True
        except Exception:
            logger.warning("service delete failed: %s", name)
            return False


_api: Optional[K8sApi] = None
_api_lock = threading.Lock()


def get_k8s_api() -> K8sApi:
    global _api
    with _api_lock:
        if _api is None:
            _api = RealK8sApi()
        return _api


def set_k8s_api(api: Optional[K8sApi]):
    """Inject a fake (tests) or reset."""
    global _api
    with _api_lock:
        _api = api
