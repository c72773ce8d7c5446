"""ScalePlan CRD scaler: declare scale intent for an external operator.

Parity: reference dlrover/python/master/scaler/elasticjob_scaler.py:118-255
(ElasticJobScaler + ScalePlanCrd) — instead of touching pods directly,
the master emits a ScalePlan custom resource that the ElasticJob operator
(or a GKE JobSet controller in the TPU deployment) reconciles. Useful
when pod creation requires cluster-level privileges the master lacks.

The port's copy of ``dlrover_tpu/master/scaler/elasticjob_scaler.py``.
"""

import itertools
import time
from typing import Dict, Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.scaler.base_scaler import ScalePlan, Scaler
from dlrover_tpu_torch.master.scheduler.k8s_client import (
    ELASTICJOB_GROUP,
    ELASTICJOB_VERSION,
    SCALEPLAN_PLURAL,
    K8sApi,
    get_k8s_api,
)


def scale_plan_crd(
    job_name: str, plan: ScalePlan, index, epoch: str = ""
) -> Dict:
    group_specs = {}
    for role, group in plan.node_group_resources.items():
        group_specs[role] = {
            "replicas": group.count,
            "resource": {
                "cpu": group.node_resource.cpu,
                "memory_mb": group.node_resource.memory_mb,
                "tpu_chips": group.node_resource.tpu_chips,
                "tpu_type": group.node_resource.tpu_type,
            },
        }
    return {
        "apiVersion": f"{ELASTICJOB_GROUP}/{ELASTICJOB_VERSION}",
        "kind": "ScalePlan",
        "metadata": {
            # The epoch token keeps names unique across master restarts:
            # a fresh master's counter restarts at 0 and a bare index
            # would collide with CRs from the previous incarnation.
            "name": f"{job_name}-scaleplan-{epoch}{index}",
            "labels": {"job-name": job_name},
        },
        "spec": {
            "ownerJob": job_name,
            "replicaResourceSpecs": group_specs,
            "createPods": [
                {
                    "name": f"{job_name}-worker-{n.id}",
                    "type": n.type,
                    "id": n.id,
                    "rankIndex": n.rank_index,
                }
                for n in plan.launch_nodes
            ],
            "removePods": [
                f"{job_name}-worker-{n.id}" for n in plan.remove_nodes
            ],
        },
    }


class ElasticJobScaler(Scaler):
    def __init__(
        self,
        job_name: str,
        namespace: str = "default",
        api: Optional[K8sApi] = None,
    ):
        super().__init__(job_name)
        self._namespace = namespace
        self._api = api or get_k8s_api()
        self._index = itertools.count(0)
        self._epoch = f"{int(time.time())}-"

    def scale(self, plan: ScalePlan):
        if plan.empty():
            return
        body = scale_plan_crd(
            self._job_name, plan, next(self._index), self._epoch
        )
        if not self._api.create_custom_object(
            self._namespace, SCALEPLAN_PLURAL, body
        ):
            logger.error("ScalePlan CR emit failed")
