"""The port's cluster side against the reference's, on the CPU with a
fake API (the reference's ``tests/test_k8s_backend.py`` pattern: no
cluster, no ``kubernetes`` package).

- ``FakeK8sApi`` is the reference test's fake, with a log of every call;
- both packages' ``PodScaler`` run one seeded ScalePlan sequence: the
  same pod creates and deletes, manifests equal but for the declared
  keys (``DECLARED``: the GPU resource, the GPU type selector, the
  default command), and the same create retries and ``_removed_ids``
  guard;
- both packages' ``PodWatcher`` read one seeded pod event stream into
  equal ``NodeEvent``s, with every branch of
  ``_termination_exit_reason`` a case of its own;
- both packages' ScalePlan CRs are equal apart from the epoch in the
  name;
- both packages' ``ElasticJobReconciler`` make the same API calls and
  status patches for one CR sequence (create, phases, a lost service,
  garbage collection), the master pod's command apart;
- ``RealK8sApi`` of both packages drives the same client calls of a
  stand-in ``kubernetes`` module;
- the port alone: the operator's watch loop and ``python -m
  dlrover_tpu_torch.operator``'s ``main``, ``DistributedJobManager``
  over the k8s backend relaunching a failed pod, the chaos harness's
  ``delete_one_pod``.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import copy
import importlib
import queue
import random
import re
import signal
import sys
import threading
import time
import types

import pytest

from dlrover_tpu_torch.common.constants import (
    ExitCode,
    NodeExitReason,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource
from dlrover_tpu_torch.master.node.dist_job_manager import DistributedJobManager
from dlrover_tpu_torch.master.scaler.pod_scaler import PodScaler
from dlrover_tpu_torch.master.scheduler import k8s_client
from dlrover_tpu_torch.master.scheduler.k8s_client import K8sApi
from dlrover_tpu_torch.master.watcher.k8s_watcher import PodWatcher

PKGS = ("dlrover_tpu", "dlrover_tpu_torch")
JOB = "jobx"


class FakeK8sApi(K8sApi):
    """In-memory pod store + watch stream; schedules pods to Running.
    ``calls`` logs every API call with its arguments (deep copies);
    ``fail_creates[name] = n`` fails the pod's next n creates."""

    def __init__(self, auto_run: bool = True):
        self.pods = {}
        self.custom_objects = []
        self.crs = {}  # (plural, name) -> object (reconciler surface)
        self.services = {}
        self.deleted = []
        self.deleted_services = []
        self.status_patches = []
        self.events: "queue.Queue" = queue.Queue()
        self.cr_events: "queue.Queue" = queue.Queue()
        self.auto_run = auto_run
        self.calls = []
        self.fail_creates = {}
        self._lock = threading.Lock()

    def _log(self, *call):
        with self._lock:
            self.calls.append(copy.deepcopy(call))

    def create_pod(self, namespace, pod_manifest):
        name = pod_manifest["metadata"]["name"]
        self._log("create_pod", namespace, pod_manifest)
        with self._lock:
            if self.fail_creates.get(name, 0) > 0:
                self.fail_creates[name] -= 1
                return False
            pod_manifest.setdefault("status", {})["phase"] = "Pending"
            self.pods[name] = pod_manifest
        self.events.put({"type": "ADDED", "object": pod_manifest})
        if self.auto_run:
            self.set_phase(name, "Running")
        return True

    def delete_pod(self, namespace, name):
        self._log("delete_pod", namespace, name)
        with self._lock:
            pod = self.pods.pop(name, None)
            self.deleted.append(name)
        if pod is not None:
            self.events.put({"type": "DELETED", "object": pod})
        return True

    def list_pods(self, namespace, label_selector):
        self._log("list_pods", namespace, label_selector)
        with self._lock:
            return list(self.pods.values())

    def watch_pods(self, namespace, label_selector):
        while True:
            event = self.events.get()
            if event is None:
                return
            yield event

    def create_custom_object(self, namespace, plural, body):
        self._log("create_custom_object", namespace, plural, body)
        self.custom_objects.append((plural, body))
        name = body.get("metadata", {}).get("name", "")
        with self._lock:
            self.crs[(plural, name)] = body
        self.cr_events.put({"type": "ADDED", "object": body})
        return True

    def list_custom_objects(self, namespace, plural):
        self._log("list_custom_objects", namespace, plural)
        with self._lock:
            return [
                obj for (p, _), obj in self.crs.items() if p == plural
            ]

    def watch_custom_objects(self, namespace, plural):
        while True:
            event = self.cr_events.get()
            if event is None:
                return
            yield event

    def patch_custom_object_status(self, namespace, plural, name, status):
        self._log("patch_custom_object_status", namespace, plural, name,
                  status)
        with self._lock:
            obj = self.crs.get((plural, name))
            if obj is None:
                return False
            obj["status"] = status
        self.status_patches.append((name, status))
        return True

    def delete_custom_object(self, namespace, plural, name):
        self._log("delete_custom_object", namespace, plural, name)
        with self._lock:
            obj = self.crs.pop((plural, name), None)
        if obj is not None:
            self.cr_events.put({"type": "DELETED", "object": obj})
        return True

    def create_service(self, namespace, manifest):
        self._log("create_service", namespace, manifest)
        self.services[manifest["metadata"]["name"]] = manifest
        return True

    def get_service(self, namespace, name):
        self._log("get_service", namespace, name)
        return self.services.get(name)

    def delete_service(self, namespace, name):
        self._log("delete_service", namespace, name)
        self.services.pop(name, None)
        self.deleted_services.append(name)
        return True

    # ---- test controls -----------------------------------------------------

    def set_phase(self, name, phase, **status_extra):
        with self._lock:
            pod = self.pods.get(name)
            if pod is None:
                return
            pod["status"]["phase"] = phase
            pod["status"].update(status_extra)
        self.events.put({"type": "MODIFIED", "object": pod})

    def stop_watch(self):
        self.events.put(None)


def pkg(base, module):
    return importlib.import_module(f"{base}.{module}")


@pytest.fixture(autouse=True)
def fresh_job_context():
    for base in PKGS:
        pkg(base, "master.node.job_context").JobContext.reset_singleton()
    yield
    for base in PKGS:
        pkg(base, "master.node.job_context").JobContext.reset_singleton()


def make_node(base, node_id=0, rank=0, tpu_chips=4, memory_mb=2048, cpu=0.0,
              tpu_type="tpu-v5e"):
    node_mod = pkg(base, "common.node")
    return node_mod.Node(
        NodeType.WORKER,
        node_id,
        rank_index=rank,
        config_resource=node_mod.NodeResource(
            cpu=cpu, tpu_chips=tpu_chips, memory_mb=memory_mb,
            tpu_type=tpu_type,
        ),
    )


def wait_until(predicate, timeout=20.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


# ---- manifests and the declared keys ----------------------------------------

# Paths (see ``flatten``) where the port's worker pod differs from the
# reference's by design: the accelerator it asks for, the node selector
# naming its type, the default command.
DECLARED = (
    re.compile(r"spec\.containers\.0\.resources\.(limits|requests)\."
               r"(google\.com/tpu|nvidia\.com/gpu)$"),
    re.compile(r"spec\.nodeSelector\."),
    re.compile(r"spec\.containers\.0\.command\."),
)


def flatten(obj, prefix=""):
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(flatten(v, f"{prefix}{k}."))
        return out
    if isinstance(obj, list):
        out = {}
        for i, v in enumerate(obj):
            out.update(flatten(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: obj}


def manifest_diff(ref, port):
    """Paths whose values differ (or exist on one side only)."""
    a, b = flatten(ref), flatten(port)
    return sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))


def undeclared(paths):
    return [p for p in paths if not any(r.search(p) for r in DECLARED)]


# The slice topology the reference's selector names; the port takes none
# (a GPU host has no slice topology), so it is given to the reference only.
REF_TOPOLOGY = {"dlrover_tpu": {"tpu_topology": "2x4"},
                "dlrover_tpu_torch": {}}


def test_manifests_differ_only_in_the_declared_keys():
    """One worker pod, both packages: the keys that differ are exactly
    the GPU resource in limits and requests, the node selector and the
    default command, with the port's values."""
    manifests = {
        base: pkg(base, "master.scaler.pod_scaler").build_worker_pod_manifest(
            JOB, make_node(base, 3, 1, cpu=4), "10.0.0.1:5000", "img:1",
            **REF_TOPOLOGY[base])
        for base in PKGS
    }
    ref, port = manifests["dlrover_tpu"], manifests["dlrover_tpu_torch"]
    assert manifest_diff(ref, port) == [
        "spec.containers.0.command.2",
        "spec.containers.0.resources.limits.google.com/tpu",
        "spec.containers.0.resources.limits.nvidia.com/gpu",
        "spec.containers.0.resources.requests.google.com/tpu",
        "spec.containers.0.resources.requests.nvidia.com/gpu",
        "spec.nodeSelector.cloud.google.com/gke-tpu-accelerator",
        "spec.nodeSelector.cloud.google.com/gke-tpu-topology",
        "spec.nodeSelector.nvidia.com/gpu.product",
    ]
    container = port["spec"]["containers"][0]
    assert container["resources"]["limits"]["nvidia.com/gpu"] == "4"
    assert container["resources"]["requests"] == container["resources"][
        "limits"]
    assert port["spec"]["nodeSelector"] == {
        "nvidia.com/gpu.product": "tpu-v5e"}
    assert container["command"] == ["python", "-m", "dlrover_tpu_torch.run"]
    # An explicit command is the caller's in both.
    cmd = ["python", "-m", "pkg.train"]
    given = {
        base: pkg(base, "master.scaler.pod_scaler").build_worker_pod_manifest(
            JOB, make_node(base, tpu_chips=0, tpu_type=""), "m:1", "img",
            command=cmd)
        for base in PKGS
    }
    assert given["dlrover_tpu"] == given["dlrover_tpu_torch"]


def _random_plan_sequence(seed, steps=14):
    """[(launch specs, remove ids)] over growing node ids; a spec is
    (id, rank, tpu_chips, memory_mb, cpu, tpu_type)."""
    rng = random.Random(seed)
    live, next_id, seq = [], 0, []
    for _ in range(steps):
        launch = []
        for _ in range(rng.randint(0, 3)):
            launch.append((next_id, rng.randint(0, 7),
                           rng.choice([0, 1, 4, 8]),
                           rng.choice([0, 2048, 16384]),
                           rng.choice([0.0, 4.0, 7.5]),
                           rng.choice(["", "NVIDIA-H100-80GB-HBM3"])))
            next_id += 1
        remove = rng.sample(live, k=min(len(live), rng.randint(0, 2)))
        live = [i for i in live if i not in remove] + [s[0] for s in launch]
        seq.append((launch, remove))
    return seq


def _plan(base, launch, remove, specs):
    scaler_mod = pkg(base, "master.scaler.base_scaler")

    def node(spec):
        nid, rank, chips, mem, cpu, kind = spec
        return make_node(base, nid, rank, chips, mem, cpu, kind)

    return scaler_mod.ScalePlan(
        launch_nodes=[node(s) for s in launch],
        remove_nodes=[node(specs[i]) for i in remove],
    )


def _normalize_pod_calls(calls):
    """The call log with each manifest's declared keys dropped."""
    out = []
    for call in calls:
        if call[0] == "create_pod":
            flat = flatten(call[2])
            call = (call[0], call[1], {
                k: v for k, v in flat.items()
                if not any(r.search(k) for r in DECLARED)})
        out.append(call)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pod_scaler_plan_sequence_matches_the_reference(seed):
    seq = _random_plan_sequence(seed)
    specs = {s[0]: s for launch, _ in seq for s in launch}
    apis = {}
    for base in PKGS:
        api = FakeK8sApi(auto_run=False)
        scaler = pkg(base, "master.scaler.pod_scaler").PodScaler(
            JOB, namespace="ns", master_addr="m:1", image="img:2",
            api=api, **REF_TOPOLOGY[base])
        for launch, remove in seq:
            scaler.scale_now(_plan(base, launch, remove, specs))
        apis[base] = api
    ref, port = apis["dlrover_tpu"], apis["dlrover_tpu_torch"]
    assert ref.calls and _normalize_pod_calls(port.calls) == \
        _normalize_pod_calls(ref.calls)
    assert sorted(port.pods) == sorted(ref.pods)
    assert port.deleted == ref.deleted
    for name in ref.pods:
        assert undeclared(manifest_diff(ref.pods[name], port.pods[name])) \
            == []


def test_pod_scaler_retries_and_removed_guard_match_the_reference():
    """Through the scaler's queue and retry timers: a pod whose create
    fails twice is created on its third attempt, one that always fails
    is given up after five, and one removed while its retry waits is
    not created again."""
    results = {}
    for base in PKGS:
        api = FakeK8sApi(auto_run=False)
        api.fail_creates = {f"{JOB}-worker-0": 2, f"{JOB}-worker-1": 99,
                            f"{JOB}-worker-2": 1}
        scaler = pkg(base, "master.scaler.pod_scaler").PodScaler(
            JOB, master_addr="m:1", api=api)
        scaler._retry_delay_s = 0.05
        scaler.start()
        try:
            plan_mod = pkg(base, "master.scaler.base_scaler")
            scaler.scale(plan_mod.ScalePlan(launch_nodes=[
                make_node(base, i, i) for i in range(3)]))
            scaler.scale(plan_mod.ScalePlan(
                remove_nodes=[make_node(base, 2, 2)]))

            def attempts():
                return [c[2]["metadata"]["name"] for c in api.calls
                        if c[0] == "create_pod"]

            assert wait_until(
                lambda: attempts().count(f"{JOB}-worker-1") == 5, 10.0)
            time.sleep(0.3)  # no sixth attempt, no late create
            results[base] = (sorted(attempts()), sorted(api.pods),
                             api.deleted, dict(scaler._create_attempts))
        finally:
            scaler.stop()
    assert results["dlrover_tpu_torch"] == results["dlrover_tpu"]
    attempts, pods, deleted, counts = results["dlrover_tpu_torch"]
    assert attempts.count(f"{JOB}-worker-0") == 3
    assert attempts.count(f"{JOB}-worker-2") == 1
    assert pods == [f"{JOB}-worker-0"]
    assert deleted == [f"{JOB}-worker-2"] and counts == {1: 5, 2: 1}


# ---- ScalePlan CRs -------------------------------------------------------------


def _strip_epoch(body):
    body = copy.deepcopy(body)
    name = body["metadata"]["name"]
    body["metadata"]["name"] = re.sub(r"-scaleplan-\d+-", "-scaleplan-", name)
    return body


@pytest.mark.parametrize("seed", [0, 1])
def test_elasticjob_scaler_crs_match_the_reference(seed):
    rng = random.Random(seed)
    seq = _random_plan_sequence(seed, steps=6)
    specs = {s[0]: s for launch, _ in seq for s in launch}
    groups = [(rng.randint(0, 8), rng.choice([0, 4]), rng.choice([0, 1024]))
              for _ in seq]
    bodies = {}
    for base in PKGS:
        node_mod = pkg(base, "common.node")
        api = FakeK8sApi(auto_run=False)
        scaler = pkg(base, "master.scaler.elasticjob_scaler").ElasticJobScaler(
            JOB, namespace="ns", api=api)
        scaler.scale(pkg(base, "master.scaler.base_scaler").ScalePlan())
        for (launch, remove), (count, chips, mem) in zip(seq, groups):
            plan = _plan(base, launch, remove, specs)
            plan.node_group_resources[NodeType.WORKER] = (
                node_mod.NodeGroupResource(
                    count=count, node_resource=node_mod.NodeResource(
                        tpu_chips=chips, memory_mb=mem)))
            scaler.scale(plan)
        bodies[base] = [(c[1], c[2], _strip_epoch(c[3])) for c in api.calls]
        names = [c[3]["metadata"]["name"] for c in api.calls]
        assert all(re.fullmatch(rf"{JOB}-scaleplan-\d+-{i}", n)
                   for i, n in enumerate(names))
    assert len(bodies["dlrover_tpu"]) == len(seq)  # the empty plan emits none
    assert bodies["dlrover_tpu_torch"] == bodies["dlrover_tpu"]


def test_scale_plan_crd_matches_the_reference():
    bodies = {}
    for base in PKGS:
        plan = pkg(base, "master.scaler.base_scaler").ScalePlan(
            remove_nodes=[make_node(base, 7)],
            launch_nodes=[make_node(base, 5, 2)])
        bodies[base] = pkg(base, "master.scaler.elasticjob_scaler") \
            .scale_plan_crd(JOB, plan, 3, "e-")
    assert bodies["dlrover_tpu_torch"] == bodies["dlrover_tpu"]
    assert bodies["dlrover_tpu_torch"]["spec"]["removePods"] == [
        f"{JOB}-worker-7"]


# ---- the watcher ---------------------------------------------------------------


def _terminated(code=None, reason=None, last=False):
    term = {}
    if code is not None:
        term["exitCode"] = code
    if reason is not None:
        term["reason"] = reason
    key = "lastState" if last else "state"
    return {"phase": "Failed", "containerStatuses": [{key: {
        "terminated": term}}]}


# One status a branch of ``_termination_exit_reason`` (and the phases).
STATUS_CASES = {
    "preempted": ({"phase": "Failed", "reason": "Preempted"},
                  NodeExitReason.PREEMPTED),
    "evicted": ({"phase": "Failed", "reason": "Evicted"},
                NodeExitReason.PREEMPTED),
    "shutdown": ({"phase": "Failed", "reason": "Shutdown"},
                 NodeExitReason.PREEMPTED),
    "oom": (_terminated(137, "OOMKilled"), NodeExitReason.OOM),
    "hardware": (_terminated(ExitCode.HARDWARE_ERROR),
                 NodeExitReason.HARDWARE_ERROR),
    "gpu_driver": (_terminated(ExitCode.GPU_DRIVER_ERROR),
                   NodeExitReason.HARDWARE_ERROR),
    "node_check_failed": (_terminated(ExitCode.NODE_CHECK_FAILED),
                          NodeExitReason.HARDWARE_ERROR),
    "killed": (_terminated(ExitCode.KILLED), NodeExitReason.KILLED),
    "termed": (_terminated(ExitCode.TERMED), NodeExitReason.KILLED),
    "nonzero": (_terminated(1, "Error"), NodeExitReason.FATAL_ERROR),
    "zero": (_terminated(0, "Completed"), ""),
    "last_state_oom": (_terminated(137, "OOMKilled", last=True),
                       NodeExitReason.OOM),
    "running": ({"phase": "Running", "podIP": "10.1.2.3",
                 "hostIP": "10.0.0.9"}, ""),
    "pending_host_ip": ({"phase": "Pending", "hostIP": "10.0.0.9"}, ""),
    "succeeded": ({"phase": "Succeeded"}, ""),
    "unknown_phase": ({"phase": "Weird"}, ""),
    "empty": ({}, ""),
}


def _node_tuple(node):
    return (node.type, node.id, node.rank_index, node.name, node.host_name,
            node.host_ip, node.status, node.exit_reason)


@pytest.mark.parametrize("case", sorted(STATUS_CASES))
def test_pod_to_node_branch_matches_the_reference(case):
    status, want_reason = STATUS_CASES[case]
    nodes = {}
    for base in PKGS:
        manifest = pkg(base, "master.scaler.pod_scaler") \
            .build_worker_pod_manifest(JOB, make_node(base, 2, 1), "m:1",
                                       "img")
        manifest["status"] = copy.deepcopy(status)
        manifest["spec"]["nodeName"] = "host-a"
        nodes[base] = _node_tuple(
            pkg(base, "master.watcher.k8s_watcher").pod_to_node(manifest))
    assert nodes["dlrover_tpu_torch"] == nodes["dlrover_tpu"]
    assert nodes["dlrover_tpu_torch"][-1] == want_reason


def _random_pod_events(seed, n=60):
    """A pod event stream over a few pods, with foreign and malformed
    pods among them."""
    rng = random.Random(seed)
    ref_builder = pkg("dlrover_tpu", "master.scaler.pod_scaler") \
        .build_worker_pod_manifest
    events = []
    for _ in range(n):
        kind = rng.random()
        if kind < 0.08:
            pod = {"metadata": {"labels": {"app": "other"}}}
        elif kind < 0.14:
            pod = {"metadata": {"labels": {"app": "dlrover-tpu",
                                           "node-id": rng.choice(
                                               ["x", "-1"])}}}
        else:
            nid = rng.randint(0, 5)
            pod = ref_builder(JOB, make_node("dlrover_tpu", nid, nid % 3),
                              "m:1", "img")
            pod["status"] = copy.deepcopy(
                STATUS_CASES[rng.choice(sorted(STATUS_CASES))][0])
            if rng.random() < 0.5:
                pod["spec"]["nodeName"] = f"host-{nid}"
        events.append({"type": rng.choice(["ADDED", "MODIFIED", "DELETED"]),
                       "object": pod})
    return events


@pytest.mark.parametrize("seed", [0, 1])
def test_pod_watcher_event_stream_matches_the_reference(seed):
    events = _random_pod_events(seed)
    ref_to_node = pkg("dlrover_tpu", "master.watcher.k8s_watcher").pod_to_node
    want_n = sum(ref_to_node(e["object"]) is not None for e in events)
    assert 0 < want_n < len(events)
    seen = {}
    for base in PKGS:
        api = FakeK8sApi(auto_run=False)
        for e in events:
            api.events.put(copy.deepcopy(e))
        watcher = pkg(base, "master.watcher.k8s_watcher").PodWatcher(
            JOB, namespace="ns", api=api)
        out = []
        stream = watcher.watch()
        for ev in stream:
            out.append((ev.event_type, _node_tuple(ev.node)))
            if len(out) == want_n:
                break
        watcher.stop()
        stream.close()
        seen[base] = out
        for e in events:
            api.pods[str(id(e))] = copy.deepcopy(e["object"])
        listed = sorted(_node_tuple(n) for n in watcher.list())
        seen[base + ".list"] = listed
    assert seen["dlrover_tpu_torch"] == seen["dlrover_tpu"]
    assert seen["dlrover_tpu_torch.list"] == seen["dlrover_tpu.list"]
    assert len(seen["dlrover_tpu_torch.list"]) == want_n


def test_pod_watcher_rewatches_a_broken_stream(monkeypatch):
    """A stream that raises is watched again (after the reference's 2 s
    pause, shortened here) and its events still arrive."""
    wk = pkg("dlrover_tpu_torch", "master.watcher.k8s_watcher")
    monkeypatch.setattr(wk.time, "sleep", lambda s: None)

    class Flaky(FakeK8sApi):
        def __init__(self):
            super().__init__(auto_run=False)
            self.watches = 0

        def watch_pods(self, namespace, label_selector):
            self.watches += 1
            if self.watches == 1:
                raise ConnectionError("stream broke")
            yield from super().watch_pods(namespace, label_selector)

    api = Flaky()
    api.create_pod("ns", pkg("dlrover_tpu_torch", "master.scaler.pod_scaler")
                   .build_worker_pod_manifest(JOB, make_node(
                       "dlrover_tpu_torch", 4, 4), "m:1", "img"))
    watcher = wk.PodWatcher(JOB, api=api)
    stream = watcher.watch()
    ev = next(stream)
    watcher.stop()
    stream.close()
    assert api.watches == 2 and ev.node.id == 4
    assert ev.event_type == "ADDED" and ev.node.status == NodeStatus.PENDING


# ---- the operator --------------------------------------------------------------


def make_elasticjob(name="ejob", replicas=2, node_unit=0):
    spec = {
        "image": "img:1",
        "masterResource": {"cpu": 2, "memory_mb": 2048},
        "replicaSpecs": {
            "worker": {
                "replicas": replicas,
                "resource": {"tpu_chips": 4, "tpu_type": "tpu-v5e"},
            }
        },
    }
    if node_unit:
        spec["nodeUnit"] = node_unit
    return {
        "apiVersion": "elastic.iml.github.io/v1alpha1",
        "kind": "ElasticJob",
        "metadata": {"name": name, "uid": "uid-1"},
        "spec": spec,
    }


def _worker_pod(job, i, phase, role="worker"):
    return {"metadata": {"name": f"{job}-worker-{i}",
                         "labels": {"job-name": job, "node-type": role}},
            "status": {"phase": phase}}


def _reconcile_script(base):
    """The reference test's CR sequence on one package's reconciler."""
    api = FakeK8sApi(auto_run=False)
    rec = pkg(base, "operator.reconciler").ElasticJobReconciler(
        namespace="ns", api=api)
    job = make_elasticjob(node_unit=2)
    api.create_custom_object("ns", "elasticjobs", job)
    rec.reconcile(job)                                  # create
    rec.reconcile(job)                                  # idempotent
    api.set_phase("ejob-dlrover-master", "Running")
    for i, phase in enumerate(("Running", "Pending", "Failed")):
        api.create_pod("ns", _worker_pod("ejob", i, phase))
        api.set_phase(f"ejob-worker-{i}", phase)
    api.create_pod("ns", _worker_pod("ejob", 9, "Running", role="ps"))
    api.set_phase("ejob-worker-9", "Running")
    rec.reconcile(job)                                  # phases
    api.services.clear()
    rec.reconcile(job)                                  # lost service
    api.set_phase("ejob-dlrover-master", "Succeeded")
    rec.resync()                                        # level-triggered
    api.set_phase("ejob-dlrover-master", "Failed")
    rec.reconcile(job)
    other = make_elasticjob("other", replicas=3)
    api.create_custom_object("ns", "elasticjobs", other)
    rec.resync()
    rec.gc_job("ejob")                                  # gc
    return api


def test_reconciler_calls_match_the_reference():
    apis = {base: _reconcile_script(base) for base in PKGS}
    ref, port = apis["dlrover_tpu"], apis["dlrover_tpu_torch"]

    def normalized(calls, base):
        out = []
        for call in calls:
            if call[0] == "create_pod" and call[2]["metadata"].get(
                    "labels", {}).get("role") == "dlrover-master":
                call = copy.deepcopy(call)
                cmd = call[2]["spec"]["containers"][0]["command"]
                assert cmd[2] == f"{base}.master.main"
                cmd[2] = "<package>.master.main"
            out.append(call)
        return out

    ref_calls = normalized(ref.calls, "dlrover_tpu")
    port_calls = normalized(port.calls, "dlrover_tpu_torch")
    assert port_calls == ref_calls
    assert port.status_patches == ref.status_patches
    phases = [s["phase"] for name, s in port.status_patches
              if name == "ejob"]
    assert phases == ["Pending", "Running", "Succeeded", "Failed"]
    assert port.status_patches[2][1]["replicaStatuses"] == {
        "worker": {"running": 1, "pending": 1, "failed": 1},
        "ps": {"running": 1}}
    assert [c[0] for c in port.calls].count("create_service") == 3
    assert sorted(port.deleted) == ["ejob-dlrover-master", "ejob-worker-0",
                                    "ejob-worker-1", "ejob-worker-2",
                                    "ejob-worker-9"]
    assert port.deleted_services == ["ejob-dlrover-master"]


def test_master_pod_runs_the_ports_master():
    """The declared divergence of the operator: the master pod's
    command names the port's package; every other key is the
    reference's."""
    job = make_elasticjob(node_unit=2)
    pods = {base: pkg(base, "operator.reconciler").master_pod_manifest(
        job, "ns") for base in PKGS}
    assert manifest_diff(pods["dlrover_tpu"], pods["dlrover_tpu_torch"]) \
        == ["spec.containers.0.command.2"]
    cmd = pods["dlrover_tpu_torch"]["spec"]["containers"][0]["command"]
    assert cmd[:3] == ["python", "-m", "dlrover_tpu_torch.master.main"]
    assert cmd[cmd.index("--platform") + 1] == "gke_tpu"
    svcs = {base: pkg(base, "operator.reconciler").master_service_manifest(
        job) for base in PKGS}
    assert svcs["dlrover_tpu"] == svcs["dlrover_tpu_torch"]


def test_watch_loop_reconciles_and_gcs():
    from dlrover_tpu_torch.operator.reconciler import ElasticJobReconciler

    api = FakeK8sApi(auto_run=False)
    rec = ElasticJobReconciler(namespace="default", api=api)
    rec.start()
    try:
        api.create_custom_object("default", "elasticjobs", make_elasticjob())
        assert wait_until(lambda: "ejob-dlrover-master" in api.pods)
        api.delete_custom_object("default", "elasticjobs", "ejob")
        assert wait_until(lambda: "ejob-dlrover-master" in api.deleted)
    finally:
        rec.stop()
        api.cr_events.put(None)
        rec.join(timeout=2.0)


def test_operator_main_reconciles_until_sigterm(monkeypatch):
    """``python -m dlrover_tpu_torch.operator``'s ``main`` on a set API:
    its first resync creates the CR's master pod and service; SIGTERM
    stops it with 0."""
    from dlrover_tpu_torch.operator import __main__ as op_main

    class Api(FakeK8sApi):
        def watch_custom_objects(self, namespace, plural):
            # A stream that ends every 0.1 s: the watch loop sees stop().
            try:
                yield self.cr_events.get(timeout=0.1)
            except queue.Empty:
                return

    api = Api(auto_run=False)
    api.create_custom_object("ns", "elasticjobs", make_elasticjob())
    api.cr_events.get()
    handlers = {}

    class Event(threading.Event):
        def wait(self, timeout=None):
            handlers[signal.SIGTERM](signal.SIGTERM, None)  # the SIGTERM
            return super().wait(timeout)

    monkeypatch.setattr(op_main, "signal", types.SimpleNamespace(
        SIGINT=signal.SIGINT, SIGTERM=signal.SIGTERM,
        signal=lambda sig, h: handlers.__setitem__(sig, h)))
    monkeypatch.setattr(op_main, "threading",
                        types.SimpleNamespace(Event=Event))
    k8s_client.set_k8s_api(api)
    try:
        t0 = time.monotonic()
        rc = op_main.main(["--namespace", "ns", "--resync_interval", "60"])
        elapsed = time.monotonic() - t0
    finally:
        k8s_client.set_k8s_api(None)
    assert rc == 0 and set(handlers) == {signal.SIGINT, signal.SIGTERM}
    assert elapsed < 4.0  # the threads joined, not timed out
    assert "ejob-dlrover-master" in api.pods
    assert "ejob-dlrover-master" in api.services


# ---- the client surface --------------------------------------------------------


def _fake_kubernetes(log):
    """A stand-in ``kubernetes`` module whose client methods log their
    calls and return canned objects."""

    class Api:
        def __init__(self, kind):
            self._kind = kind
            self.api_client = types.SimpleNamespace(
                sanitize_for_serialization=lambda o: {"sanitized": o})

        def __getattr__(self, name):
            def call(*args, **kwargs):
                log.append((self._kind, name, args, kwargs))
                if name == "list_namespaced_pod":
                    return types.SimpleNamespace(items=["p0", "p1"])
                if name == "list_namespaced_custom_object":
                    return {"items": [{"k": 1}]}
                if name == "read_namespaced_service":
                    return "svc"
                if name.startswith("delete_namespaced_custom"):
                    raise RuntimeError("api error")
                return None
            return call

    class Watch:
        def stream(self, fn, *args, **kwargs):
            log.append(("watch", fn.__name__ if hasattr(fn, "__name__")
                        else "fn", args, kwargs))
            yield {"type": "ADDED", "object": "o1"}

    config = types.SimpleNamespace(
        load_incluster_config=lambda: (_ for _ in ()).throw(
            RuntimeError("not in a cluster")),
        load_kube_config=lambda: log.append(("config", "kube", (), {})))
    client = types.SimpleNamespace(CoreV1Api=lambda: Api("core"),
                                   CustomObjectsApi=lambda: Api("custom"))
    return types.SimpleNamespace(config=config, client=client,
                                 watch=types.SimpleNamespace(Watch=Watch))


def test_real_api_drives_the_same_client_calls(monkeypatch):
    logs, results = {}, {}
    for base in PKGS:
        log = []
        monkeypatch.setitem(sys.modules, "kubernetes", _fake_kubernetes(log))
        api = pkg(base, "master.scheduler.k8s_client").RealK8sApi()
        results[base] = [
            api.create_pod("ns", {"m": 1}), api.delete_pod("ns", "p"),
            api.list_pods("ns", "a=b"), list(api.watch_pods("ns", "a=b")),
            api.create_custom_object("ns", "scaleplans", {"b": 1}),
            api.list_custom_objects("ns", "elasticjobs"),
            list(api.watch_custom_objects("ns", "elasticjobs")),
            api.patch_custom_object_status("ns", "elasticjobs", "j",
                                           {"phase": "Running"}),
            api.delete_custom_object("ns", "elasticjobs", "j"),
            api.create_service("ns", {"s": 1}), api.get_service("ns", "s"),
            api.delete_service("ns", "s"),
        ]
        logs[base] = log
    assert logs["dlrover_tpu_torch"] == logs["dlrover_tpu"]
    assert results["dlrover_tpu_torch"] == results["dlrover_tpu"]
    assert results["dlrover_tpu_torch"][8] is False  # the raising delete


def test_get_k8s_api_without_the_client_raises_import_error(monkeypatch):
    """No API set and no ``kubernetes`` importable: the real client's
    import fails, which the master turns into its ``SystemExit``."""
    monkeypatch.setitem(sys.modules, "kubernetes", None)
    k8s_client.set_k8s_api(None)
    with pytest.raises(ImportError):
        k8s_client.get_k8s_api()
    api = FakeK8sApi()
    k8s_client.set_k8s_api(api)
    try:
        assert k8s_client.get_k8s_api() is api
    finally:
        k8s_client.set_k8s_api(None)


# ---- the port over the k8s backend ---------------------------------------------


def test_job_manager_over_k8s_backend():
    api = FakeK8sApi()
    scaler = PodScaler(JOB, master_addr="m:1", api=api)
    watcher = PodWatcher(JOB, api=api)
    mgr = DistributedJobManager(
        job_name=JOB,
        node_groups={
            NodeType.WORKER: NodeGroupResource(
                count=2, node_resource=NodeResource(tpu_chips=4)
            )
        },
        scaler=scaler,
        watcher=watcher,
    )
    try:
        mgr.start()

        def running():
            return [
                n
                for n in mgr.worker_manager.nodes.values()
                if n.status == NodeStatus.RUNNING
            ]

        assert wait_until(lambda: len(running()) == 2)
        # Kill pod 0 with an OOM: the manager relaunches a replacement.
        api.set_phase(
            f"{JOB}-worker-0",
            "Failed",
            containerStatuses=[{"state": {"terminated": {
                "reason": "OOMKilled", "exitCode": 137}}}],
        )
        assert wait_until(
            lambda: any(
                n.id not in (0, 1) and n.status == NodeStatus.RUNNING
                for n in mgr.worker_manager.nodes.values()
            )
        )
        assert f"{JOB}-worker-0" in api.deleted
        replacement = [p for name, p in api.pods.items()
                       if name not in (f"{JOB}-worker-0", f"{JOB}-worker-1")]
        limits = replacement[0]["spec"]["containers"][0]["resources"][
            "limits"]
        assert limits == {"nvidia.com/gpu": "4"}
        assert mgr.worker_manager.nodes[0].exit_reason == NodeExitReason.OOM
    finally:
        mgr.stop()
        api.stop_watch()


def test_chaos_deletes_one_running_worker_pod():
    from dlrover_tpu_torch.testing import chaos

    api = FakeK8sApi(auto_run=False)
    for i, phase in enumerate(("Running", "Pending", "Running")):
        api.create_pod("ns", _worker_pod(JOB, i, phase))
        api.set_phase(f"{JOB}-worker-{i}", phase)
    api.create_pod("ns", {"metadata": {"name": f"{JOB}-dlrover-master",
                                       "labels": {"job-name": JOB,
                                                  "role": "dlrover-master"}},
                          "status": {"phase": "Running"}})
    api.set_phase(f"{JOB}-dlrover-master", "Running")
    victims = set()
    for seed in range(8):
        random.seed(seed)
        victim = chaos.delete_one_pod(JOB, "ns", api=api)
        victims.add(victim)
        if victim is not None:
            api.create_pod("ns", _worker_pod(JOB, victim[-1], "Running"))
            api.set_phase(victim, "Running")
    assert victims == {f"{JOB}-worker-0", f"{JOB}-worker-2"}
    empty = FakeK8sApi()
    assert chaos.delete_one_pod(JOB, "ns", api=empty) is None


def _deleted_pod_run(base):
    """Both packages' job manager over the k8s backend: pod 1 is
    deleted from under a running job (the chaos harness's move)."""
    pkg(base, "master.node.job_context").JobContext.reset_singleton()
    node_mod = pkg(base, "common.node")
    api = FakeK8sApi()
    mgr = pkg(base, "master.node.dist_job_manager").DistributedJobManager(
        job_name=JOB,
        node_groups={NodeType.WORKER: node_mod.NodeGroupResource(
            count=2, node_resource=node_mod.NodeResource(tpu_chips=4))},
        scaler=pkg(base, "master.scaler.pod_scaler").PodScaler(
            JOB, master_addr="m:1", api=api),
        watcher=pkg(base, "master.watcher.k8s_watcher").PodWatcher(
            JOB, api=api),
    )

    def table():
        return sorted((n.id, n.rank_index, n.status, n.relaunch_count)
                      for n in mgr.worker_manager.nodes.values())

    try:
        mgr.start()
        assert wait_until(lambda: [t[2] for t in table()] == [
            NodeStatus.RUNNING] * 2)
        api.delete_pod("default", f"{JOB}-worker-1")
        assert wait_until(lambda: len(table()) == 3
                          and table()[-1][2] == NodeStatus.RUNNING)
        return table(), sorted(api.pods)
    finally:
        mgr.stop()
        api.stop_watch()


def test_job_manager_over_k8s_backend_relaunches_a_deleted_pod():
    runs = {base: _deleted_pod_run(base) for base in PKGS}
    assert runs["dlrover_tpu_torch"] == runs["dlrover_tpu"]
    nodes, pods = runs["dlrover_tpu_torch"]
    assert [(nid, rank, count) for nid, rank, _, count in nodes] == [
        (0, 0, 0), (1, 1, 0), (2, 1, 1)]
    assert nodes[1][2] == NodeStatus.DELETED
    assert pods == [f"{JOB}-worker-0", f"{JOB}-worker-2"]
