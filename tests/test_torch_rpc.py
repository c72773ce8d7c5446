"""The port's RPC plane and local master against the JAX package's.

The wire pickles classes under their module path, so a port client
cannot talk to a JAX master. Each package instead runs its own
``LocalJobMaster`` (port 0) in a child process of its own, and that
package's ``MasterClient``s drive it through one script, the scenarios
of the reference's ``tests/test_rpc_and_servicer.py``: a rendezvous
round of two nodes, the KV store and a sync barrier, the data-sharding
flow, a shard checkpoint restore, heartbeats and checkpoint steps,
failure and success reports, the pre-check and the pushed config, and
the cluster version. The two transcripts (plain values, times masked)
must be equal over HTTP; the port's gRPC transport must give the same
transcript. Also here: the restricted unpickler admits the wire's
classes and nothing else, and the HTTP stub keeps its connection.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import json
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import dataclasses, importlib, json, sys, time

pkg, kind = sys.argv[1], sys.argv[2]


def mod(name):
    return importlib.import_module(f"{pkg}.{name}")


comm = mod("common.comm")
consts = mod("common.constants")
MasterClient = mod("agent.master_client").MasterClient
LocalJobMaster = mod("master.local_master").LocalJobMaster
JobContext = mod("master.node.job_context").JobContext
TRAINING = consts.RendezvousName.TRAINING
TaskType = consts.TaskType


def norm(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        out = {"class": type(x).__name__}
        for f in dataclasses.fields(x):
            out[f.name] = norm(getattr(x, f.name))
        return out
    if isinstance(x, dict):
        return [[norm(k), norm(v)]
                for k, v in sorted(x.items(), key=lambda kv: repr(kv[0]))]
    if isinstance(x, (list, tuple, set)):
        return [norm(v) for v in x]
    if isinstance(x, bytes):
        return {"bytes": x.hex()}
    if isinstance(x, float) and x > 1e8:
        return "<time>"
    return x


transcript = []


def log(step, value):
    transcript.append([step, norm(value)])


def scenario(node_num=1):
    def wrap(fn):
        JobContext.reset_singleton()
        master = LocalJobMaster(port=0, node_num=node_num, transport=kind)
        master.prepare()
        clients = []

        def client(node_id):
            c = MasterClient(f"localhost:{master.port}", node_id=node_id,
                             kind=kind)
            clients.append(c)
            return c

        try:
            c0 = client(0)
            log(fn.__name__ + ".ready", c0.wait_master_ready(30))
            fn(master, c0, client)
        finally:
            for c in clients:
                c.close()
            master.stop()
            JobContext.reset_singleton()
        return fn
    return wrap


@scenario(node_num=2)
def rendezvous_round(master, c0, client):
    c1 = client(1)
    log("join0", c0.join_rendezvous(0, 1, TRAINING))
    log("waiting_before", c0.num_nodes_waiting(TRAINING))
    log("join1", c1.join_rendezvous(1, 1, TRAINING))
    log("world0", c0.get_comm_world(TRAINING, 0))
    log("world1", c1.get_comm_world(TRAINING, 1))
    log("waiting_after", c0.num_nodes_waiting(TRAINING))


@scenario()
def kv_store_and_sync(master, c0, client):
    c0.kv_store_set("alpha", b"1")
    log("get", c0.kv_store_get("alpha"))
    log("get_missing", c0.kv_store_get("nope"))
    log("add2", c0.kv_store_add("ctr", 2))
    log("add3", c0.kv_store_add("ctr", 3))
    log("multi", c0.kv_store_multi_get(["alpha", "ctr", "nope"]))
    c0.join_sync("barrier1", 0)
    log("barrier_open", c0.sync_barrier("barrier1"))
    c0.sync_finished("barrier1")
    log("barrier_done", c0.sync_barrier("barrier1"))


@scenario()
def data_sharding_flow(master, c0, client):
    c0.report_dataset_shard_params(comm.DatasetShardParams(
        dataset_name="ds", dataset_size=10, shard_size=4, num_epochs=1,
        storage_type="table", task_type=TaskType.TRAINING))
    seen = []
    for _ in range(100):
        task = c0.get_task("ds")
        seen.append(task)
        if task.task_id < 0 and task.task_type != TaskType.WAIT:
            break
        if task.task_type != TaskType.WAIT:
            c0.report_task_done("ds", task.task_id)
    log("tasks", seen)
    c0.report_dataset_shard_params(comm.DatasetShardParams(
        dataset_name="batched", dataset_size=30, shard_size=10))
    leased, wait = c0.get_tasks("batched", 2)
    log("batch", [leased, wait])
    log("batch_wait", c0.get_tasks("batched", 4))
    c0.report_tasks_done_batch("batched", [leased[0].task_id],
                               [leased[1].task_id])
    log("batch_after_report", c0.get_tasks("batched", 4))


@scenario()
def shard_checkpoint_restore(master, c0, client):
    c0.report_dataset_shard_params(comm.DatasetShardParams(
        dataset_name="ds2", dataset_size=8, shard_size=4, num_epochs=1))
    log("in_flight", c0.get_task("ds2"))
    ckpt = c0.get_shard_checkpoint("ds2")
    log("checkpoint", json.loads(ckpt))
    c0.restore_shard_checkpoint("ds2", ckpt)
    starts = []
    for _ in range(10):
        t = c0.get_task("ds2")
        if t.task_id < 0:
            break
        starts.append(t.start)
        c0.report_task_done("ds2", t.task_id)
    log("starts", sorted(starts))


@scenario()
def heartbeat_and_ckpt_step(master, c0, client):
    log("actions", c0.report_heartbeat())
    c0.report_ckpt_step(10, committed=False)
    log("latest_uncommitted", c0.get_ckpt_latest_step())
    c0.report_ckpt_step(10, committed=True)
    log("latest_committed", c0.get_ckpt_latest_step())
    c0.report_global_step(5, elapsed_train_secs=1.0)
    c0.report_used_resource(12.5, 1024.0)


@scenario()
def failure_and_success_reports(master, c0, client):
    log("join", c0.join_rendezvous(0, 1, TRAINING))
    c0.report_failure("boom", node_rank=0, restart_count=1, exit_code=1)
    c0.report_succeeded()
    detail = c0.get_job_detail()
    log("job", [detail.job_name, detail.stage, sorted(detail.nodes)])


@scenario()
def pre_check_and_config(master, c0, client):
    log("pre_check", c0.get_pre_check_result())
    log("config_empty", c0.get_elastic_run_config())
    master.servicer.set_elastic_run_config({"network_check": "false"})
    log("config", c0.get_elastic_run_config())
    log("parallel", c0.get_parallel_config())


@scenario()
def cluster_version(master, c0, client):
    c0.update_cluster_version("local", 3, "worker", 0)
    log("version", c0.get_cluster_version("local", "worker", 0))


print(json.dumps(transcript))
"""


def _transcript(pkg: str, kind: str = "http"):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               DLROVER_TPU_EVENT_EXPORTER="off")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, pkg, kind], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def transcripts():
    runs = [("dlrover_tpu", "http"), ("dlrover_tpu_torch", "http"),
            ("dlrover_tpu_torch", "grpc")]
    with ThreadPoolExecutor(len(runs)) as pool:
        got = list(pool.map(lambda r: _transcript(*r), runs))
    return dict(zip(runs, got))


SCENARIOS = ["rendezvous_round", "kv_store_and_sync", "data_sharding_flow",
             "shard_checkpoint_restore", "heartbeat_and_ckpt_step",
             "failure_and_success_reports", "pre_check_and_config",
             "cluster_version"]


_SCENARIO_STEPS = {
    "rendezvous_round": {"join0", "waiting_before", "join1", "world0",
                         "world1", "waiting_after"},
    "kv_store_and_sync": {"get", "get_missing", "add2", "add3", "multi",
                          "barrier_open", "barrier_done"},
    "data_sharding_flow": {"tasks", "batch", "batch_wait",
                           "batch_after_report"},
    "shard_checkpoint_restore": {"in_flight", "checkpoint", "starts"},
    "heartbeat_and_ckpt_step": {"actions", "latest_uncommitted",
                                "latest_committed"},
    "failure_and_success_reports": {"join", "job"},
    "pre_check_and_config": {"pre_check", "config_empty", "config",
                             "parallel"},
    "cluster_version": {"version"},
}


def _scenario(transcript, scenario):
    names = _SCENARIO_STEPS[scenario] | {scenario + ".ready"}
    return [s for s in transcript if s[0] in names]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_port_master_answers_as_the_jax_master_over_http(transcripts,
                                                         scenario):
    ref = _scenario(transcripts[("dlrover_tpu", "http")], scenario)
    port = _scenario(transcripts[("dlrover_tpu_torch", "http")], scenario)
    assert len(ref) == len(_SCENARIO_STEPS[scenario]) + 1
    assert port == ref


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_port_grpc_transport_gives_the_http_transcript(transcripts,
                                                       scenario):
    http = _scenario(transcripts[("dlrover_tpu_torch", "http")], scenario)
    grpc = _scenario(transcripts[("dlrover_tpu_torch", "grpc")], scenario)
    assert grpc == http


def test_transcript_shows_the_scripted_outcomes(transcripts):
    """The shared transcript holds the reference test's outcomes, so
    two equal wrong transcripts cannot pass."""
    steps = dict(map(tuple, (
        (s[0], json.dumps(s[1]))
        for s in transcripts[("dlrover_tpu_torch", "http")])))
    world = json.loads(steps["world0"])
    assert world[2] == [[0, 1], [1, 1]] and world[3] == [0, 1]
    assert json.loads(steps["multi"]) == [
        ["alpha", {"bytes": "31"}], ["ctr", {"bytes": "35"}]]
    assert json.loads(steps["barrier_open"]) is False
    assert json.loads(steps["barrier_done"]) is True
    tasks = json.loads(steps["tasks"])
    assert sorted((t["start"], t["end"]) for t in tasks
                  if t["task_id"] >= 0) == [(0, 4), (4, 8), (8, 10)]
    assert json.loads(steps["starts"]) == [0, 4]
    assert json.loads(steps["latest_uncommitted"]) == -1
    assert json.loads(steps["latest_committed"]) == 10
    assert json.loads(steps["actions"]) == []
    assert json.loads(steps["pre_check"]) == "PASS"
    assert json.loads(steps["config"]) == [["network_check", "false"]]
    assert json.loads(steps["version"]) == 3


def test_transport_defaults_to_http_and_imports_no_grpc():
    code = (
        "import sys\n"
        "from dlrover_tpu_torch.rpc import transport\n"
        "from dlrover_tpu_torch.agent.master_client import MasterClient\n"
        "from dlrover_tpu_torch.master.args import parse_master_args\n"
        "assert transport.DEFAULT_KIND == 'http'\n"
        "assert parse_master_args([]).transport == 'http'\n"
        "c = MasterClient('localhost:1')\n"
        "assert type(c._stub).__name__ == 'HttpMasterStub'\n"
        "print('grpc' in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "False"


def test_unknown_transport_is_refused():
    from dlrover_tpu_torch.rpc.transport import (
        build_master_stub,
        create_master_server,
    )

    with pytest.raises(ValueError):
        build_master_stub("localhost:1", kind="zmq")
    with pytest.raises(ValueError):
        create_master_server(0, None, kind="zmq")


class _Gadget:
    def __reduce__(self):
        return (os.getcwd, ())


@pytest.mark.parametrize("payload", [
    "builtins.eval", "os.system", "subprocess.Popen",
    "dlrover_tpu.common.comm.Message",
    "dlrover_tpu_torch.flash_ckpt.shm_handler.ShardMeta",
    "dlrover_tpu_torch.common.serialize.dumps",
    "gadget",
])
def test_wire_unpickler_rejects_other_classes(payload):
    """The RPC wire admits builtins' value constructors and the classes
    of the message modules; a message naming any other class, or any
    callable, is rejected."""
    from dlrover_tpu_torch.common import serialize

    if payload == "gadget":
        data = pickle.dumps(_Gadget())
    else:
        module, name = payload.rsplit(".", 1)
        data = (b"\x80\x04c" + module.encode() + b"\n" + name.encode()
                + b"\n)\x81.")
    with pytest.raises(pickle.UnpicklingError):
        serialize.loads(data)


def test_wire_unpickler_admits_messages_and_heartbeat_actions():
    from dlrover_tpu_torch.common import comm, serialize
    from dlrover_tpu_torch.diagnosis.actions import NodeAction
    from dlrover_tpu_torch.diagnosis.diagnosis_data import TrainingLog

    resp = comm.HeartbeatResponse(actions=[NodeAction(node_id=3)])
    back = comm.BaseResponse.deserialize(resp.serialize())
    assert back == resp and isinstance(back.actions[0], NodeAction)
    log = TrainingLog(logs=["x"])
    assert serialize.loads(log.serialize()) == log
    msg = comm.Message(node_id=1, data=comm.CkptStepReport(step=4)
                       .serialize(), trace={"trace_id": "t"})
    assert comm.Message.deserialize(msg.serialize()) == msg
    # The checkpoint loader still admits the port's other classes.
    from dlrover_tpu_torch.flash_ckpt.shm_handler import ShardMeta

    meta = ShardMeta(index=((0, 1),), local_shape=(1,), offset=0, nbytes=4)
    with pytest.raises(pickle.UnpicklingError):
        serialize.loads(serialize.dumps(meta))
    assert serialize.loads_pytree(serialize.dumps(meta)) == meta


def test_http_stub_reuses_connection():
    import http.client as http_client

    from dlrover_tpu_torch.common.comm import Message
    from dlrover_tpu_torch.rpc.transport import (
        HttpMasterServer,
        HttpMasterStub,
        MasterService,
    )

    class Echo(MasterService):
        def get(self, message):
            return message

        def report(self, message):
            return message

    server = HttpMasterServer(0, Echo())
    server.start()
    try:
        stub = HttpMasterStub(f"localhost:{server.port}")
        stub.get(Message(node_id=1))
        conn1 = stub._local.conn
        sock1 = conn1.sock
        stub.get(Message(node_id=2))
        assert stub._local.conn is conn1 and conn1.sock is sock1

        class StaleConn:
            def request(self, *a, **k):
                raise http_client.RemoteDisconnected("idle timeout")

            def close(self):
                pass

        stub._local.conn = StaleConn()
        assert stub.get(Message(node_id=3)).node_id == 3
        assert not isinstance(stub._local.conn, StaleConn)
        stub.close()
    finally:
        server.stop()
