"""The port's checkpoint replica service (``dlrover_tpu_torch/flash_ckpt/
replica.py``): the eight cases of the reference's
``tests/test_ckpt_replica.py`` (two simulated agents in one process,
distinct HTTP replica services), then the port against the JAX package:
a segment snapshotted by either package's ``snapshot_segment`` restores
through the other's ``restore_segment`` to the same bytes; the group
topology agrees for worlds of 1-8 nodes and groups of 1-4; a port agent
pushes to and pulls from a JAX-package ``CkptReplicaManager`` over HTTP
with the token, and the reverse. Bytes are compared exactly.

The saver's push (``AsyncCheckpointSaver._push_replicas``): one push in
flight, a step already pushed is skipped, and, where the port diverges
from the reference, a save that lands while a push is in flight is
pushed when that push ends (the reference never pushes it).
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import os
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from dlrover_tpu.flash_ckpt import replica as ref_replica
from dlrover_tpu.flash_ckpt.shm_handler import (
    SharedMemoryHandler as RefHandler,
)
from dlrover_tpu_torch.flash_ckpt.engine import SaveEvent, shm_segment_name
from dlrover_tpu_torch.flash_ckpt.replica import (
    CkptReplicaManager,
    ReplicaTokenUnavailable,
    restore_segment,
    snapshot_segment,
)
from dlrover_tpu_torch.flash_ckpt.shm_handler import SharedMemoryHandler


@pytest.fixture(autouse=True)
def replica_token(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_REPLICA_TOKEN", "test-secret")


@pytest.fixture(autouse=True)
def job(monkeypatch, tmp_path):
    """A job name of its own: segment names derive from it."""
    name = f"trep{uuid.uuid4().hex[:10]}"
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", name)
    monkeypatch.setenv("DLROVER_TPU_NODE_RANK", "0")
    monkeypatch.setenv("DLROVER_TPU_SHARED_DIR", str(tmp_path / "uds"))
    yield name
    for seg in os.listdir("/dev/shm"):
        if name in seg:
            os.unlink(os.path.join("/dev/shm", seg))


def test_refuses_to_start_without_token(monkeypatch):
    monkeypatch.delenv("DLROVER_TPU_REPLICA_TOKEN", raising=False)
    with pytest.raises(ReplicaTokenUnavailable):
        CkptReplicaManager(node_rank=0, group_size=2)


def test_token_fetched_from_master_kv(monkeypatch):
    class FakeClient:
        def kv_store_get(self, key):
            assert key == "ckpt-replica/token"
            return b"master-random-token"

        def kv_store_set(self, key, value):
            pass

    monkeypatch.delenv("DLROVER_TPU_REPLICA_TOKEN", raising=False)
    m = CkptReplicaManager(node_rank=0, master_client=FakeClient())
    try:
        assert m._token == "master-random-token"
    finally:
        m.stop()


def _state():
    return {"w": torch.arange(32, dtype=torch.float32),
            "b": torch.ones(4, dtype=torch.float64)}


@pytest.fixture
def primary_segment():
    name = shm_segment_name(0)
    handler = SharedMemoryHandler(name)
    state = _state()
    handler.save_state_dict(7, state, {"process_id": 0})
    handler.close()
    yield name, state
    SharedMemoryHandler(name).unlink()


def _load(name):
    handler = SharedMemoryHandler(name)
    try:
        return handler.load_state_dict()
    finally:
        handler.close()


def test_snapshot_restore_roundtrip(primary_segment):
    name, state = primary_segment
    payload = snapshot_segment(name)
    assert payload is not None
    SharedMemoryHandler(name).unlink()
    assert SharedMemoryHandler(name).load_meta() is None
    restore_segment(name, payload)
    step, loaded, meta = _load(name)
    assert step == 7 and meta["process_id"] == 0
    assert torch.equal(loaded["w"], state["w"])
    assert torch.equal(loaded["b"], state["b"])
    assert snapshot_segment(name) == payload


def test_snapshot_missing_segment_returns_none():
    assert snapshot_segment("dlrover_tpu_test_nonexistent") is None


def make_pair(mods=(None, None)):
    """Node 0's and node 1's managers, each the port's or (``mods[i]``)
    the JAX package's, on one address map."""
    m0 = (mods[0] or CkptReplicaManager)(node_rank=0, group_size=2)
    m1 = (mods[1] or CkptReplicaManager)(node_rank=1, group_size=2)
    m0._addr_map = {1: f"127.0.0.1:{m1.port}", 0: f"127.0.0.1:{m0.port}"}
    m1._addr_map = dict(m0._addr_map)
    m0.start()
    m1.start()
    m0.set_world([0, 1])
    m1.set_world([0, 1])
    return m0, m1


def test_group_topology():
    m = CkptReplicaManager(node_rank=2, group_size=2)
    m.set_world([0, 1, 2, 3, 4])
    assert m.group_peers() == [3]
    assert m.group_peers(0) == [1]
    assert m.group_peers(4) == []  # incomplete trailing group
    m4 = CkptReplicaManager(node_rank=0, group_size=1)
    m4.set_world([0, 1])
    assert m4.group_peers() == []
    m.stop()
    m4.stop()


def test_push_and_pull_replica(primary_segment):
    name, state = primary_segment
    m0, m1 = make_pair()
    try:
        # Node 0 pushes its segment to its group peer (node 1).
        assert m0.push_node_image(local_world_size=1) == 1
        pushed = snapshot_segment(name)
        assert m0.last_push_bytes == len(pushed)
        # Host replacement: node 0 loses its shm.
        SharedMemoryHandler(name).unlink()
        assert SharedMemoryHandler(name).load_meta() is None
        # Relaunched node 0 pulls the segment back from node 1.
        assert m0.restore_missing_segments(local_world_size=1) == 1
        assert (m0.last_pull_missing, m0.last_pull_bytes) == (1, len(pushed))
        step, loaded, _ = _load(name)
        assert step == 7
        assert torch.equal(loaded["w"], state["w"])
        assert snapshot_segment(name) == pushed
    finally:
        m0.stop()
        m1.stop()


def test_restore_noop_when_segment_present(primary_segment):
    m0, m1 = make_pair()
    try:
        m0.push_node_image(local_world_size=1)
        # Segment still present: pull must not overwrite anything.
        assert m0.restore_missing_segments(local_world_size=1) == 0
        assert m0.last_pull_missing == 0
    finally:
        m0.stop()
        m1.stop()


def test_pull_without_peer_replica(primary_segment):
    name, _ = primary_segment
    m0, m1 = make_pair()
    try:
        SharedMemoryHandler(name).unlink()
        # No push happened: pull finds nothing, restores nothing.
        assert m0.restore_missing_segments(local_world_size=1) == 0
        assert m0.last_pull_missing == 1
    finally:
        m0.stop()
        m1.stop()


# ---- the port against the JAX package -------------------------------------


def _jax_segment(name, step=3):
    handler = RefHandler(name, create=True)
    handler.save_state_dict(step, {"w": np.arange(40, dtype=np.float32),
                                   "i": np.arange(3, dtype=np.int64)},
                            {"process_id": 0})
    handler.close()


def test_jax_snapshot_restores_through_the_port_and_back(primary_segment):
    name, _ = primary_segment
    # A JAX package's image: its snapshot restores through the port's
    # restore_segment to the same bytes, which the reference then reads.
    jax_name = f"{name}_jax"
    _jax_segment(jax_name)
    try:
        payload = ref_replica.snapshot_segment(jax_name)
        RefHandler(jax_name).unlink()
        restore_segment(jax_name, payload)
        assert ref_replica.snapshot_segment(jax_name) == payload
        handler = RefHandler(jax_name)
        step, loaded, _ = handler.load_state_dict()
        handler.close()
        assert step == 3 and np.array_equal(
            loaded["w"], np.arange(40, dtype=np.float32))
    finally:
        RefHandler(jax_name).unlink()
    # The port's image: its snapshot restores through the reference's
    # restore_segment to the same bytes, which the port then reads.
    payload = snapshot_segment(name)
    SharedMemoryHandler(name).unlink()
    ref_replica.restore_segment(name, payload)
    assert snapshot_segment(name) == payload
    step, loaded, _ = _load(name)
    assert step == 7 and torch.equal(loaded["w"], _state()["w"])


def test_group_peers_agree_with_the_reference():
    ports = [CkptReplicaManager(node_rank=0, group_size=g)
             for g in range(1, 5)]
    refs = [ref_replica.CkptReplicaManager(node_rank=0, group_size=g)
            for g in range(1, 5)]
    try:
        rng = np.random.default_rng(0)
        for n in range(1, 9):
            for world in (list(range(n)), sorted(rng.choice(
                    16, n, replace=False).tolist())):
                for port, ref in zip(ports, refs):
                    port.set_world(world)
                    ref.set_world(world)
                    for rank in world + [99]:
                        assert port.group_peers(rank) == ref.group_peers(
                            rank), (world, rank)
    finally:
        for m in ports + refs:
            m.stop()


@pytest.mark.parametrize("pusher", ["port", "jax"])
def test_agents_of_both_packages_exchange_replicas(primary_segment, pusher):
    """Node 0 (``pusher``'s package) pushes its segment to node 1 (the
    other package) over HTTP with the token, loses it, and pulls the
    same bytes back."""
    name, _ = primary_segment
    if pusher == "jax":
        SharedMemoryHandler(name).unlink()
        _jax_segment(name)
        snapshot = ref_replica.snapshot_segment
        mods = (ref_replica.CkptReplicaManager, None)
    else:
        snapshot = snapshot_segment
        mods = (None, ref_replica.CkptReplicaManager)
    m0, m1 = make_pair(mods)
    try:
        before = snapshot(name)
        assert m0.push_node_image(local_world_size=1) == 1
        assert m1._store.get(0, 0) == before
        SharedMemoryHandler(name).unlink()
        assert m0.restore_missing_segments(local_world_size=1) == 1
        assert snapshot(name) == before
        # A wrong token is refused by either package's service.
        m0._token = "wrong"
        assert not m0._http_put(m0._addr_map[1], 0, 0, b"x")
        assert m0._http_get(m0._addr_map[1], 0, 0) is None
        assert m1._store.get(0, 0) == before
    finally:
        m0.stop()
        m1.stop()


# ---- the saver's push ------------------------------------------------------


class _BlockingManager:
    """A replica manager whose pushes wait on ``gate``; it records the
    step each push ran for (the saver's ``_last_replica_step``)."""

    def __init__(self, saver_box):
        self.gate = threading.Event()
        self.pushed = []
        self.inside = 0
        self.most_inside = 0
        self.last_push_bytes = 0
        self._box = saver_box
        self._lock = threading.Lock()

    def set_world(self, world):
        pass

    def push_node_image(self, local_world_size, locks=None):
        with self._lock:
            self.inside += 1
            self.most_inside = max(self.most_inside, self.inside)
        self.gate.wait(30)
        self.pushed.append(self._box[0]._last_replica_step)
        with self._lock:
            self.inside -= 1
        return 1


def _drive_pushes(saver_cls, event_cls, make_saver):
    box = []
    manager = _BlockingManager(box)
    saver = make_saver(manager)
    box.append(saver)
    try:
        saver._push_replicas(event_cls(event_cls.SAVE_MEM, 1, "d", 1))
        time.sleep(0.1)
        # Lands while step 1's push is in flight.
        saver._push_replicas(event_cls(event_cls.SAVE_MEM, 2, "d", 1))
        # Already pushed (or pending): skipped.
        saver._push_replicas(event_cls(event_cls.SAVE_DISK, 1, "d", 1))
        manager.gate.set()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            time.sleep(0.2)
            if manager.inside == 0 and len(manager.pushed) >= 1:
                time.sleep(0.3)
                if manager.inside == 0:
                    break
        return manager.pushed, manager.most_inside
    finally:
        saver.stop()


def test_saver_pushes_the_save_that_landed_during_a_push(tmp_path):
    from dlrover_tpu.flash_ckpt import engine as ref_engine
    from dlrover_tpu.flash_ckpt.saver import (
        AsyncCheckpointSaver as RefSaver,
    )
    from dlrover_tpu_torch.flash_ckpt.saver import AsyncCheckpointSaver

    port, port_most = _drive_pushes(
        AsyncCheckpointSaver, SaveEvent,
        lambda m: AsyncCheckpointSaver(local_world_size=1,
                                       replica_manager=m))
    ref, ref_most = _drive_pushes(
        RefSaver, ref_engine.SaveEvent,
        lambda m: RefSaver(local_world_size=1, replica_manager=m))
    assert port_most == ref_most == 1
    # The reference drops step 2 for good; the port pushes it once step
    # 1's push ends.
    assert ref == [1]
    assert port == [1, 2]
