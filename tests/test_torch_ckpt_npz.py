"""The legacy ``.npz`` step-dir format, both ways, exact: a step dir the
JAX package writes with ``persist_node_shards(..., fmt="npz")`` (its
``_persist_one_proc`` npz branch) restores through the port's
``open_proc_shards`` (``storage.NpzShardReader``) leaf for leaf, and
through the port's ``load_global_state`` into a target; one the port
writes restores through the reference's ``open_proc_shards`` leaf for
leaf. bf16 crosses as its bits (the reference's ml_dtypes bfloat16 loads
as raw 2-byte values, which the port reads as uint16, as it stores
bf16). A raw proc file is preferred over an npz one.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import os
import uuid

import ml_dtypes
import numpy as np
import pytest
import torch

from dlrover_tpu.flash_ckpt import saver as ref_saver
from dlrover_tpu.flash_ckpt import storage as ref_storage
from dlrover_tpu.flash_ckpt.shm_handler import (
    SharedMemoryHandler as RefHandler,
)
from dlrover_tpu_torch.flash_ckpt import saver as port_saver
from dlrover_tpu_torch.flash_ckpt import storage as port_storage
from dlrover_tpu_torch.flash_ckpt.engine import (
    load_global_state,
    shm_segment_name,
)
from dlrover_tpu_torch.flash_ckpt.raw_format import RawShardReader
from dlrover_tpu_torch.flash_ckpt.shm_handler import SharedMemoryHandler


@pytest.fixture(autouse=True)
def job(monkeypatch):
    name = f"tnpz{uuid.uuid4().hex[:10]}"
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", name)
    monkeypatch.setenv("DLROVER_TPU_NODE_RANK", "0")
    yield name
    for seg in os.listdir("/dev/shm"):
        if name in seg:
            os.unlink(os.path.join("/dev/shm", seg))


def _numpy_state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "b": rng.standard_normal(5),
        "w": rng.standard_normal((6, 4)).astype(np.float32),
        "h": rng.standard_normal((3, 8)).astype(np.float16),
        "ids": rng.integers(-50, 50, (7,), dtype=np.int32),
        "bf": rng.standard_normal((4, 4)).astype(ml_dtypes.bfloat16),
        "count": np.asarray(3, dtype=np.int64),
    }


def _arrays_of(reader):
    return {k: reader.get(k) for k in reader.keys()}


def test_jax_written_npz_step_dir_restores_through_the_port(tmp_path):
    state = _numpy_state()
    handler = RefHandler(shm_segment_name(0), create=True)
    handler.save_state_dict(5, state, {"process_id": 0})
    handler.close()
    step, payload = ref_saver.read_shm_payload(0)
    ckpt = str(tmp_path / "ckpt")
    ref_storage.persist_node_shards(ckpt, step, 0, {0: payload}, fmt="npz")
    sdir = port_storage.step_dir(ckpt, 5)
    assert sorted(os.listdir(sdir)) == [
        "._dlrover_ckpt_done", "proc-0.meta", "proc-0.npz"]

    reader = port_storage.open_proc_shards(ckpt, 5, 0)
    assert isinstance(reader, port_storage.NpzShardReader)
    with reader:
        got = _arrays_of(reader)
        assert sorted(got) == sorted(payload["arrays"])
        for key, want in payload["arrays"].items():
            bits = want.view(np.uint16) if want.dtype == ml_dtypes.bfloat16 \
                else want
            assert got[key].dtype == bits.dtype and got[key].shape == (
                bits.shape)
            assert np.array_equal(got[key], bits), key
            assert reader.bounds(key) is None
            if bits.ndim:
                sl = (slice(1, None),) + (slice(None),) * (bits.ndim - 1)
                assert np.array_equal(reader.read_slice(key, sl), bits[sl])
        assert reader.bytes_read > 0

    # The port's storage restore of the JAX package's step, into a
    # target, leaf for leaf.
    metas = port_storage.load_step_meta(ckpt, 5)
    target = {k: torch.zeros(v.shape, dtype=torch.bfloat16 if k == "bf"
                             else torch.from_numpy(np.asarray(v)).dtype)
              for k, v in state.items()}
    stats = {}
    out_step, tree, _ = load_global_state(ckpt, 5, metas, target, stats)
    assert out_step == 5 and stats["bytes_read"] > 0
    for k, v in state.items():
        got = tree[k]
        if k == "bf":
            assert np.array_equal(got.view(torch.int16).numpy().view(
                np.uint16), v.view(np.uint16))
        else:
            assert np.array_equal(got.numpy(), v), k


def test_port_written_npz_step_dir_restores_through_the_reference(tmp_path):
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in
             _numpy_state(1).items() if k != "bf"}
    state["bf"] = torch.randn(4, 4, generator=torch.Generator().manual_seed(
        3)).to(torch.bfloat16)
    handler = SharedMemoryHandler(shm_segment_name(0))
    handler.save_state_dict(9, state, {"process_id": 0})
    handler.close()
    step, payload = port_saver.read_shm_payload(0)
    ckpt = str(tmp_path / "ckpt")
    port_storage.persist_node_shards(ckpt, step, 0, {0: payload},
                                     fmt=port_storage.NPZ_FORMAT)
    assert "proc-0.npz" in os.listdir(port_storage.step_dir(ckpt, 9))

    reader = ref_storage.open_proc_shards(ckpt, 9, 0)
    assert isinstance(reader, ref_storage.NpzShardReader)
    with reader:
        got = _arrays_of(reader)
    assert sorted(got) == sorted(payload["arrays"])
    for key, want in payload["arrays"].items():
        assert got[key].dtype == want.dtype and np.array_equal(
            got[key], want), key
    # And back through the port's own reader, the same bytes.
    with port_storage.open_proc_shards(ckpt, 9, 0) as reader:
        again = _arrays_of(reader)
    for key, want in payload["arrays"].items():
        assert np.array_equal(again[key], want), key


def test_raw_proc_file_is_preferred_over_npz(tmp_path):
    state = {"w": torch.arange(12, dtype=torch.float32)}
    handler = SharedMemoryHandler(shm_segment_name(0))
    handler.save_state_dict(2, state, {"process_id": 0})
    handler.close()
    _, payload = port_saver.read_shm_payload(0)
    ckpt = str(tmp_path / "ckpt")
    port_storage.persist_node_shards(ckpt, 2, 0, {0: payload},
                                     fmt=port_storage.NPZ_FORMAT)
    port_storage.persist_node_shards(ckpt, 2, 0, {0: payload})
    with port_storage.open_proc_shards(ckpt, 2, 0) as reader:
        assert isinstance(reader, RawShardReader)
    assert port_storage.open_proc_shards(ckpt, 3, 0) is None
