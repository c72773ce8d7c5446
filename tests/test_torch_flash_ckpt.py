"""The port's flash checkpoint (``dlrover_tpu_torch/flash_ckpt``) against
the JAX package's, on the same numpy inputs.

Byte identity where the formats are shared: a ``proc-<pid>.raw`` file
from the same arrays, bounds, step and process id, and the shm image's
data region (leaf offsets, sizes and bytes) from the same nested dict
with f32, bf16 and int leaves, are byte-identical to the reference's,
and each package's reader reads the other's file. Behaviour where the
port copies the reference: memory round trips, async saves that land
and coalesce, the foreign-image check, the disk commit protocol, the
torn-write fallback, deletion strategies, the autotune math (equal to
the reference's to the last bit), the agent's saver over UDS with its
breakpoint save, and the restricted unpickler.

Each test gets its own job name and socket dir (segment and socket
names derive from them) and unlinks its segments, so the tests run in
parallel workers and leave nothing in ``/dev/shm``.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import os
import pickle
import threading
import time
import uuid

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dlrover_tpu.flash_ckpt import autotune as jax_autotune
from dlrover_tpu.flash_ckpt import raw_format as jax_raw
from dlrover_tpu.flash_ckpt import storage as jax_storage
from dlrover_tpu.flash_ckpt.checkpointer import Checkpointer as JaxCheckpointer
from dlrover_tpu.flash_ckpt.checkpointer import StorageType as JaxStorageType
from dlrover_tpu.flash_ckpt.shm_handler import (
    SharedMemoryHandler as JaxShmHandler,
)
from dlrover_tpu.trainer import runtime as jax_runtime
from dlrover_tpu_torch import fault
from dlrover_tpu_torch.common import serialize
from dlrover_tpu_torch.flash_ckpt import autotune, raw_format
from dlrover_tpu_torch.flash_ckpt import storage as ckpt_storage
from dlrover_tpu_torch.flash_ckpt.checkpointer import (
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.flash_ckpt.engine import (
    CheckpointEngine,
    shm_segment_name,
)
from dlrover_tpu_torch.flash_ckpt.saver import (
    AsyncCheckpointSaver,
    persist_shm_to_storage,
)
from dlrover_tpu_torch.flash_ckpt.shm_handler import (
    LeafMeta,
    SharedMemoryHandler,
    tree_flatten,
)
from dlrover_tpu_torch.trainer import runtime


@pytest.fixture(autouse=True)
def job(monkeypatch, tmp_path):
    """A unique job name and socket dir; fresh runtime contexts; every
    segment of the job unlinked at teardown."""
    name = f"tt{os.getpid()}_{uuid.uuid4().hex[:10]}"
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", name)
    monkeypatch.setenv("DLROVER_TPU_SHARED_DIR", str(tmp_path / "uds"))
    monkeypatch.setenv("DLROVER_TPU_NODE_RANK", "0")
    runtime._context = None
    jax_runtime._context = None
    yield name
    runtime._context = None
    jax_runtime._context = None
    fault.disarm()
    for seg in os.listdir("/dev/shm"):
        if name in seg:
            os.unlink(os.path.join("/dev/shm", seg))


def _arrays():
    rs = np.random.RandomState(0)
    bf16 = rs.randn(4, 8).astype(ml_dtypes.bfloat16)
    return {
        "leaf0_shard0": rs.randn(3, 5).astype(np.float32),
        "leaf1_shard0": bf16,
        "leaf2_shard0": rs.randint(-9, 9, (7,)).astype(np.int32),
        "leaf3_shard0": np.asarray(11, np.int64),
        "leaf4_shard0": np.zeros((0, 3), np.float32),
        "leaf5_shard0": rs.rand(2, 2) > 0.5,
    }


def _port_arrays(arrays):
    """The same arrays as the port holds them: bf16 as uint16 bits."""
    out, dtypes = {}, {}
    for k, a in arrays.items():
        if a.dtype.name == "bfloat16":
            out[k], dtypes[k] = a.view(np.uint16), "bfloat16"
        else:
            out[k] = a
    return out, dtypes


def _bounds(arrays):
    return {k: tuple((0, s) for s in a.shape) for k, a in arrays.items()}


def test_raw_shards_byte_identical_and_cross_readable(tmp_path):
    arrays = _arrays()
    ref, port = tmp_path / "ref.raw", tmp_path / "port.raw"
    jax_raw.write_raw_shards(str(ref), 7, 0, arrays, _bounds(arrays))
    port_arrays, dtypes = _port_arrays(arrays)
    raw_format.write_raw_shards(str(port), 7, 0, port_arrays,
                                _bounds(arrays), dtypes=dtypes)
    assert port.read_bytes() == ref.read_bytes()
    with raw_format.RawShardReader(str(ref)) as reader:
        assert reader.step == 7 and set(reader.keys()) == set(arrays)
        for k, a in port_arrays.items():
            out = np.empty(a.shape, a.dtype)
            reader.read_slice_into(k, (), out, verify=True)
            assert out.tobytes() == a.tobytes()
            assert reader.get(k).tobytes() == a.tobytes()
    with jax_raw.RawShardReader(str(port)) as reader:
        for k, a in arrays.items():
            got = reader.get(k)
            assert got.dtype == a.dtype and got.tobytes() == a.tobytes()


def test_raw_reader_rejects_truncation_header_and_bitflips(tmp_path):
    arrays, dtypes = _port_arrays(_arrays())
    path = tmp_path / "p.raw"
    raw_format.write_raw_shards(str(path), 1, 0, arrays, dtypes=dtypes)
    data = bytearray(path.read_bytes())
    path.write_bytes(bytes(data[:len(data) // 2]))
    with pytest.raises(raw_format.ShardCorruptionError, match="truncated"):
        raw_format.RawShardReader(str(path))
    bad = bytearray(data)
    bad[30] ^= 1  # inside the JSON header
    path.write_bytes(bytes(bad))
    with pytest.raises(raw_format.ShardCorruptionError, match="header"):
        raw_format.RawShardReader(str(path))
    path.write_bytes(bytes(data))
    with raw_format.RawShardReader(str(path)) as reader:
        start = reader._data_start  # noqa: SLF001
    bad = bytearray(data)
    bad[start + 3] ^= 0x10  # the first shard's bytes
    path.write_bytes(bytes(bad))
    with raw_format.RawShardReader(str(path)) as reader:
        out = np.empty((3, 5), np.float32)
        with pytest.raises(raw_format.ShardCorruptionError,
                           match="checksum"):
            reader.read_slice_into("leaf0_shard0", (), out, verify=True)


def _nested(arrays):
    return {"params": {"w": arrays["leaf0_shard0"],
                       "b": arrays["leaf1_shard0"]},
            "opt": [arrays["leaf2_shard0"], None],
            "step": 3}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    if isinstance(tree, np.ndarray):
        if tree.dtype.name == "bfloat16":
            return torch.from_numpy(tree.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(tree.copy())
    return tree


def _region(buf, meta):
    start = meta["data_start"]
    end = max(lm.shards[0].offset + lm.shards[0].nbytes
              for lm in meta["leaves"])
    return bytes(buf[start:start + end])


def test_shm_image_data_region_identical_to_reference(job):
    tree = _nested(_arrays())
    ref = JaxShmHandler(f"{job}_ref")
    port = SharedMemoryHandler(f"{job}_port")
    try:
        ref.save_state_dict(4, tree, {"k": 1})
        port.save_state_dict(4, _torch_tree(tree), {"k": 1})
        ref_meta, port_meta = ref.load_meta(), port.load_meta()
        assert len(port_meta["leaves"]) == len(ref_meta["leaves"]) == 4
        for a, b in zip(ref_meta["leaves"], port_meta["leaves"]):
            assert (a.leaf_id, tuple(a.global_shape), a.dtype) == (
                b.leaf_id, tuple(b.global_shape), b.dtype)
            assert [(s.index, tuple(s.local_shape), s.offset, s.nbytes)
                    for s in a.shards] == [
                (s.index, tuple(s.local_shape), s.offset, s.nbytes)
                for s in b.shards]
        assert _region(port._shm.buf, port_meta) == _region(  # noqa: SLF001
            ref._shm.buf, ref_meta)  # noqa: SLF001
        assert port.get_step() == ref.get_step() == 4
        step, got, user = port.load_state_dict()
        assert step == 4 and user == {"k": 1} and got["step"] == 3
        assert got["opt"][1] is None
        assert got["params"]["b"].dtype == torch.bfloat16
        assert torch.equal(got["params"]["w"],
                           torch.from_numpy(tree["params"]["w"]))
        # A JAX image (its tree is a PyTreeDef) is not the port's to load.
        assert SharedMemoryHandler(f"{job}_ref").load_meta() is None
    finally:
        ref.unlink()
        port.unlink()


def test_tree_flatten_orders_leaves_like_jax():
    tree = {"b": [np.ones(2), (np.zeros(1), None)], "a": {"z": np.ones(3),
                                                          "c": np.ones(4)}}
    leaves, spec = tree_flatten(tree)
    want = jax.tree_util.tree_leaves(tree)
    assert [x.shape for x in leaves] == [x.shape for x in want]
    # The spec is builtins only: the restricted unpickler takes it.
    assert serialize.loads_pytree(pickle.dumps(spec)) == spec


def _state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(6, 4, generator=g),
                       "b": torch.randn(4, generator=g).bfloat16()},
            "opt": {"count": torch.tensor(2.0)}, "step": 2}


def test_memory_round_trip_in_place(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ckpt"), standalone=True)
    state = _state()
    ckpt.save_checkpoint(2, state, user_meta={"cursor": 5})
    step, host, meta = ckpt.load_checkpoint()
    assert step == 2 and meta["cursor"] == 5 and host["step"] == 2
    assert torch.equal(host["params"]["w"], state["params"]["w"])
    target = _state()
    target["params"]["w"].zero_()
    w = target["params"]["w"]
    _, restored, _ = ckpt.load_checkpoint(target=target)
    assert restored["params"]["w"] is w
    assert torch.equal(w, state["params"]["w"])
    bad = _state()
    bad["params"]["w"] = torch.zeros(5, 4)
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(target=bad)
    ckpt._engine._shm.unlink()  # noqa: SLF001
    ckpt.close()


def test_async_save_lands_and_coalesces_to_newest(tmp_path):
    engine = CheckpointEngine(str(tmp_path / "ckpt"), standalone=True)
    state = _state()
    engine.save_to_memory_async(1, state)
    assert engine.wait_async_save(30)
    # The writer blocks on the shm mutex while writing step 2; steps 3
    # and 4 arrive meanwhile: 3 waits, then 4 replaces it.
    with engine._save_mutex:  # noqa: SLF001
        engine.save_to_memory_async(2, state)
        deadline = time.time() + 30
        while engine._writing is None:  # noqa: SLF001
            assert time.time() < deadline
            time.sleep(0.01)
        engine.save_to_memory_async(3, state)
        state["params"]["w"].add_(1.0)  # in place, after the snapshot
        engine.save_to_memory_async(4, state)
    assert engine.wait_async_save(30)
    assert engine.dropped_snapshots == 1
    assert [r["step"] for r in engine.save_records()] == [1, 2, 4]
    assert all(r["async"] for r in engine.save_records())
    step, got, _ = engine.load()
    assert step == 4 and torch.equal(got["params"]["w"],
                                     state["params"]["w"])
    # shm only moves forward: an older direct save is refused.
    assert engine.save_to_memory(3, state) == 0.0
    assert engine.last_written_step == 4
    engine._shm.unlink()  # noqa: SLF001
    engine.close()


def test_async_snapshot_is_a_copy(tmp_path):
    engine = CheckpointEngine(str(tmp_path / "ckpt"), standalone=True)
    state = _state()
    want = state["params"]["w"].clone()
    with engine._save_mutex:  # noqa: SLF001
        engine.save_to_memory_async(1, state)
        state["params"]["w"].mul_(3.0)
    assert engine.wait_async_save(30)
    _, got, _ = engine.load()
    assert torch.equal(got["params"]["w"], want)
    engine._shm.unlink()  # noqa: SLF001
    engine.close()


def test_foreign_image_rejected(tmp_path):
    mine = Checkpointer(str(tmp_path / "a"), standalone=True)
    mine.save_checkpoint(3, _state())
    other = Checkpointer(str(tmp_path / "b"), standalone=True)
    assert other.load_checkpoint() is None
    assert other.latest_step() == -1
    assert mine.latest_step() == 3
    mine._engine._shm.unlink()  # noqa: SLF001
    mine.close()
    other.close()


def test_disk_save_commit_and_storage_restore(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt = Checkpointer(d, standalone=True)
    state = _state()
    ckpt.save_checkpoint(10, state, StorageType.DISK, {"cursor": 1})
    assert ckpt.wait_saving_complete(10)
    assert ckpt_storage.read_tracker(d) == 10
    assert ckpt_storage.nodes_done(d, 10) == [0]
    assert sorted(os.listdir(ckpt_storage.step_dir(d, 10))) == [
        "._dlrover_ckpt_done", "proc-0.meta", "proc-0.raw"]
    ckpt._engine._shm.unlink()  # noqa: SLF001
    target = _state()
    target["params"]["w"].zero_()
    step, restored, meta = ckpt.load_checkpoint(target=target)
    assert step == 10 and meta["cursor"] == 1
    assert ckpt._engine.last_restore_source == "storage"  # noqa: SLF001
    assert torch.equal(target["params"]["w"], state["params"]["w"])
    assert torch.equal(restored["params"]["b"], state["params"]["b"])
    # The reference reads the port's shard file.
    with jax_storage.load_proc_arrays(d, 10, 0) as reader:
        assert reader.get("leaf1_shard0").dtype == ml_dtypes.bfloat16
    ckpt.close()


def test_engine_raw_file_identical_to_reference_engine(tmp_path, job):
    """The whole persist path: each package's standalone engine saves
    the same dict to storage; the shard files are byte-identical."""
    arrays = _arrays()
    tree = {"w": arrays["leaf0_shard0"], "b": arrays["leaf1_shard0"],
            "i": arrays["leaf2_shard0"]}
    ref = JaxCheckpointer(str(tmp_path / "ref"), standalone=True)
    ref.save_checkpoint(5, {k: jnp.asarray(v) for k, v in tree.items()},
                        JaxStorageType.DISK)
    ref._engine._shm.unlink()  # noqa: SLF001
    ref.close()
    port = Checkpointer(str(tmp_path / "port"), standalone=True)
    port.save_checkpoint(5, _torch_tree(tree), StorageType.DISK)
    port._engine._shm.unlink()  # noqa: SLF001
    port.close()
    name = os.path.join("checkpoint-5", "proc-0.raw")
    assert (tmp_path / "port" / name).read_bytes() == (
        tmp_path / "ref" / name).read_bytes()


def test_multi_node_commit_waits_for_every_node(tmp_path):
    d = str(tmp_path / "ckpt")
    shm = SharedMemoryHandler(shm_segment_name(0))
    shm.save_state_dict(7, {"w": torch.ones(3)}, {"process_id": 0})
    result = {}
    leader = threading.Thread(target=lambda: result.setdefault(
        "ok", persist_shm_to_storage(d, 7, 0, 1, [0, 1],
                                     commit_timeout=30.0)))
    leader.start()
    time.sleep(1.0)
    assert ckpt_storage.read_tracker(d) == -1  # node 1 not done yet
    assert ckpt_storage.nodes_done(d, 7) == [0]
    # Node 1 (not the leader) persists without committing.
    assert persist_shm_to_storage(d, 7, 1, 1, [0, 1])
    leader.join(30)
    assert result["ok"] and ckpt_storage.read_tracker(d) == 7
    assert ckpt_storage.nodes_done(d, 7) == [0, 1]
    shm.unlink()


def test_torn_write_falls_back_to_previous_step(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt = Checkpointer(d, standalone=True)
    state = _state()
    ckpt.save_checkpoint(10, state, StorageType.DISK)
    want = state["params"]["w"].clone()
    state["params"]["w"].add_(1.0)
    fault.arm(fault.FaultSchedule([fault.FaultRule(
        "ckpt.persist.torn_write", action="truncate",
        truncate_bytes=4096)]))  # past the last page's padding
    ckpt.save_checkpoint(20, state, StorageType.DISK)
    fault.disarm()
    assert ckpt_storage.read_tracker(d) == 20  # committed, then torn
    fault.arm(fault.FaultSchedule([fault.FaultRule(
        "ckpt.restore.memory", action="raise")]))
    step, got, _ = ckpt.load_checkpoint()
    assert step == 10 and torch.equal(got["params"]["w"], want)
    ckpt._engine._shm.unlink()  # noqa: SLF001
    ckpt.close()


@pytest.mark.parametrize("interval,keep", [(0, 3), (0, 0), (4, 2), (3, 1)])
def test_deletion_strategies_match_reference(tmp_path, interval, keep):
    survivors = []
    for pkg, root in ((ckpt_storage, tmp_path / "port"),
                      (jax_storage, tmp_path / "ref")):
        for s in (2, 4, 6, 8, 9, 12, 13):
            os.makedirs(pkg.step_dir(str(root), s))
        pkg.write_tracker(str(root), 9)
        strategy = (pkg.KeepStepIntervalDeletionStrategy(interval, keep)
                    if interval else pkg.KeepLatestDeletionStrategy(keep))
        strategy.clean_up(str(root))
        survivors.append(pkg.list_step_dirs(str(root)))
    assert survivors[0] == survivors[1]
    assert 9 in survivors[0]


def test_autotune_matches_reference():
    for block in (1e-5, 3e-3, 0.2, 4.0):
        for drain in (0.0, 0.05, 2.0):
            for mtbf in (60.0, 3600.0, 86400.0):
                want = jax_autotune.optimal_save_interval_s(
                    block, drain, mtbf)
                assert autotune.optimal_save_interval_s(
                    block, drain, mtbf) == want
                assert autotune.expected_goodput_pct(
                    30.0, block, 12.0, mtbf, drain) == \
                    jax_autotune.expected_goodput_pct(
                        30.0, block, 12.0, mtbf, drain)
    trackers = (autotune.SaveCostTracker(4), jax_autotune.SaveCostTracker(4))
    mtbfs = (autotune.MtbfTracker(8), jax_autotune.MtbfTracker(8))
    for i, v in enumerate((0.3, 0.01, 0.2, 0.05, 0.4, 0.02)):
        for t in trackers:
            t.record_block(v)
            t.record_drain(v * 3)
        for m in mtbfs:
            m.record_failure(100.0 * i * i)
        assert trackers[0].recommended_interval_s(900.0) == \
            trackers[1].recommended_interval_s(900.0)
        assert mtbfs[0].observed_mtbf_s() == mtbfs[1].observed_mtbf_s()


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline
        time.sleep(0.02)


def test_async_saver_over_uds_and_breakpoint_save(tmp_path, job):
    d = str(tmp_path / "ckpt")
    saver = AsyncCheckpointSaver(local_world_size=1)
    sock_dir = os.environ["DLROVER_TPU_SHARED_DIR"]
    try:
        ckpt = Checkpointer(d)  # the saver's socket exists: agent mode
        assert not ckpt._engine._standalone  # noqa: SLF001
        state = _state()
        ckpt.save_checkpoint(5, state, StorageType.DISK)
        assert ckpt.wait_saving_complete(30)
        _wait(lambda: saver.last_persisted_step == 5)
        ckpt.save_checkpoint_async(7, state)
        assert ckpt.wait_async_save(30)
        _wait(lambda: saver._latest_mem_event is not None  # noqa: SLF001
              and saver._latest_mem_event.step == 7)  # noqa: SLF001
        assert ckpt_storage.read_tracker(d) == 5
        saver.save_shm_on_failure()  # the worker died after step 7
        assert ckpt_storage.read_tracker(d) == 7
        assert [r["step"] for r in saver.persist_records] == [5, 7]
        ckpt.close()
    finally:
        saver.stop()
        saver.unlink_all(1)
    assert not SharedMemoryHandler(shm_segment_name(0)).exists()
    assert os.listdir(sock_dir) == []


def test_restricted_unpickler_blocks_gadgets():
    class Evil:
        def __reduce__(self):
            return (eval, ("1+1",))

    with pytest.raises(pickle.UnpicklingError):
        serialize.loads_pytree(pickle.dumps(Evil()))

    class EvilFnOfThePort:
        def __reduce__(self):
            return (ckpt_storage.write_tracker, ("/tmp/x", 1))

    with pytest.raises(pickle.UnpicklingError):
        serialize.loads_pytree(pickle.dumps(EvilFnOfThePort()))
    treedef = jax.tree_util.tree_structure({"a": 1})
    with pytest.raises(pickle.UnpicklingError):
        serialize.loads_pytree(pickle.dumps(treedef))
    meta = LeafMeta(0, (2,), "float32")
    assert serialize.loads_pytree(pickle.dumps(meta)) == meta


def test_first_save_of_a_process_skips_the_dtensor_import(tmp_path):
    """A process that never imported ``torch.distributed.tensor`` holds
    no DTensor, so its first save and restore do not import it (the
    import loads sympy; on the card host a soak worker's first save held
    its prefetched leases past the master's task timeout)."""
    import subprocess
    import sys

    code = (
        "import os, sys, time, torch\n"
        "from dlrover_tpu_torch.flash_ckpt.engine import CheckpointEngine\n"
        "e = CheckpointEngine(sys.argv[1], standalone=True)\n"
        "t = time.monotonic()\n"
        "e.save_to_storage(0, {'w': torch.ones(3)}, user_meta={'a': 1})\n"
        "step, state, meta = e._load_from_storage(None, None)\n"
        "assert step == 0 and state['w'].tolist() == [1.0, 1.0, 1.0]\n"
        "e.close()\n"
        "print('torch.distributed.tensor' in sys.modules)\n")
    job = f"tfirst{os.getpid()}"
    env = dict(os.environ, DLROVER_TPU_JOB_NAME=job)
    try:
        out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                             env=env, capture_output=True, text=True,
                             timeout=120)
    finally:
        for seg in os.listdir("/dev/shm"):
            if job in seg:
                os.unlink(os.path.join("/dev/shm", seg))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "False"


def test_shared_lock_held_by_a_killed_process_is_released(tmp_path):
    """A worker SIGKILLed while it holds the shm lock never releases it:
    the next acquire (the agent's breakpoint save, the restarted
    worker's first save) takes it at once instead of waiting out its
    60 s timeout on every save."""
    import signal
    import subprocess
    import sys

    from dlrover_tpu_torch.flash_ckpt.shared_obj import (
        SharedLockClient,
        SharedLockServer,
    )

    sock_dir = str(tmp_path)
    server = SharedLockServer("ckpt_shm_0", sock_dir)
    holder = subprocess.Popen([sys.executable, "-c", (
        "import sys, time\n"
        "from dlrover_tpu_torch.flash_ckpt.shared_obj import "
        "SharedLockClient\n"
        f"lock = SharedLockClient('ckpt_shm_0', {sock_dir!r})\n"
        "assert lock.acquire(timeout=10)\n"
        "print('held', flush=True)\n"
        "time.sleep(60)\n")],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        stdout=subprocess.PIPE, text=True)
    try:
        assert holder.stdout.readline().strip() == "held"
        live = SharedLockClient("ckpt_shm_0", sock_dir)
        assert not live.acquire(blocking=False)
        holder.send_signal(signal.SIGKILL)
        holder.wait(timeout=10)
        t0 = time.monotonic()
        assert live.acquire(timeout=10)
        assert time.monotonic() - t0 < 5
        live.release()
        assert server.acquire(timeout=1)
        server.release()
    finally:
        if holder.poll() is None:
            holder.kill()
            holder.wait()
        server.stop()
