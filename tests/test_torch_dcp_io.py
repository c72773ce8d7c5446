"""The port's flash <-> ``torch.distributed.checkpoint`` bridge
(``flash_ckpt/dcp_io.py``), mirroring the reference's orbax bridge tests
(``tests/test_orbax_io.py``): export then load, import of a checkpoint
``dcp.save`` wrote directly then the engine's restores, the full round
trip and the CLI; bf16 (NaN, infinities and subnormals among its bits)
crosses both ways bit for bit; and the same state saved by each
package's checkpointer and exported by each package's bridge (orbax for
the JAX package, DCP for the port) loads to the same leaves bit for
bit.

Each test gets its own job name and socket dir and unlinks its shm
segments."""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import os
import uuid

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

from dlrover_tpu.flash_ckpt import orbax_io
from dlrover_tpu.flash_ckpt.checkpointer import Checkpointer as JaxCheckpointer
from dlrover_tpu.flash_ckpt.checkpointer import StorageType as JaxStorageType
from dlrover_tpu.trainer import runtime as jax_runtime
from dlrover_tpu_torch.flash_ckpt import dcp_io
from dlrover_tpu_torch.flash_ckpt import engine as ckpt_engine
from dlrover_tpu_torch.flash_ckpt import storage as ckpt_storage
from dlrover_tpu_torch.flash_ckpt.checkpointer import (
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.trainer import runtime


@pytest.fixture(autouse=True)
def job(monkeypatch, tmp_path):
    name = f"dcp{os.getpid()}_{uuid.uuid4().hex[:10]}"
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", name)
    monkeypatch.setenv("DLROVER_TPU_SHARED_DIR", str(tmp_path / "uds"))
    monkeypatch.setenv("DLROVER_TPU_NODE_RANK", "0")
    runtime._context = None
    jax_runtime._context = None
    yield name
    runtime._context = None
    jax_runtime._context = None
    for seg in os.listdir("/dev/shm"):
        if name in seg:
            os.unlink(os.path.join("/dev/shm", seg))


def sample_state():
    return {
        "params": {
            "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": torch.ones(4),
        },
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _save_flash(flash_dir, step, state):
    ckpt = Checkpointer(flash_dir, standalone=True)
    ckpt.save_checkpoint(step, state, StorageType.DISK)
    assert ckpt.wait_saving_complete()
    ckpt.close()


def _bits(t):
    """A tensor's or array's bytes, for bit-for-bit comparison."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(t)).tobytes()


def test_export_then_dcp_load(tmp_path):
    flash_dir = str(tmp_path / "flash")
    _save_flash(flash_dir, 7, sample_state())
    step = dcp_io.export_step(flash_dir, str(tmp_path / "dcp"))
    assert step == 7
    assert dcp_io.list_dcp_steps(str(tmp_path / "dcp")) == [7]
    got_step, state = dcp_io.load_dcp(str(tmp_path / "dcp"), device="cpu")
    assert got_step == 7
    assert torch.equal(state["params"]["w"],
                       torch.arange(12, dtype=torch.float32).reshape(3, 4))
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 7
    # Any DCP consumer reads it into its own template.
    mine = {"params": {"w": torch.zeros(3, 4), "b": torch.zeros(4)},
            "step": torch.zeros((), dtype=torch.int32)}
    dcp.load(mine, checkpoint_id=str(tmp_path / "dcp" / "7"), no_dist=True)
    assert torch.equal(mine["params"]["b"], torch.ones(4))
    meta = (tmp_path / "dcp" / "7" / "dlrover_tpu_meta.json").read_text()
    assert '"step": 7' in meta


def test_import_then_engine_restore(tmp_path):
    # A checkpoint produced by plain DCP (no flash involvement), with a
    # list and a Python scalar among its values...
    src = {"params": {"w": torch.full((2, 2), 3.0)},
           "layers": [torch.arange(6.0).reshape(2, 3),
                      torch.ones(3, dtype=torch.bfloat16)],
           "step": 42}
    dcp.save(src, checkpoint_id=str(tmp_path / "dcp" / "42"), no_dist=True)
    # ...imported into the flash layout...
    flash_dir = str(tmp_path / "flash")
    step = dcp_io.import_step(str(tmp_path / "dcp"), flash_dir)
    assert step == 42
    assert ckpt_storage.read_tracker(flash_dir) == 42
    # ...restores through the engine's own path (storage fallback)...
    ckpt = Checkpointer(flash_dir, standalone=True)
    restored = ckpt.load_checkpoint()
    assert restored is not None
    got_step, state, meta = restored
    assert got_step == 42 and state["step"] == 42
    assert torch.equal(state["params"]["w"], torch.full((2, 2), 3.0))
    assert isinstance(state["layers"], list)
    assert _bits(state["layers"][1]) == _bits(src["layers"][1])
    # ...in place into a target...
    target = {"params": {"w": torch.zeros(2, 2)},
              "layers": [torch.zeros(2, 3),
                         torch.zeros(3, dtype=torch.bfloat16)],
              "step": 0}
    _, filled, _ = ckpt.load_checkpoint(target=target)
    ckpt.close()
    assert filled["layers"][0] is target["layers"][0]
    assert torch.equal(target["layers"][0], src["layers"][0])
    # ...and by the regions a resharded rank reads.
    _, leaves, _ = ckpt_engine.load_state_regions(
        flash_dir, 42, {0: [((0, 2), (1, 3))]})
    (region,) = leaves[0].values()
    np.testing.assert_array_equal(region, src["layers"][0][:, 1:].numpy())


def test_full_round_trip(tmp_path):
    flash_dir = str(tmp_path / "flash")
    _save_flash(flash_dir, 3, sample_state())
    dcp_io.export_step(flash_dir, str(tmp_path / "d"))
    flash2 = str(tmp_path / "flash2")
    dcp_io.import_step(str(tmp_path / "d"), flash2)
    ckpt2 = Checkpointer(flash2, standalone=True)
    restored = ckpt2.load_checkpoint()
    ckpt2.close()
    got_step, state, _ = restored
    assert got_step == 3
    for path in (("params", "w"), ("params", "b"), ("step",)):
        want, got = sample_state(), state
        for key in path:
            want, got = want[key], got[key]
        assert got.dtype == want.dtype and torch.equal(got, want), path


def test_cli(tmp_path, capsys):
    flash_dir = str(tmp_path / "flash")
    _save_flash(flash_dir, 1, sample_state())
    assert dcp_io.main(["export", "--flash-dir", flash_dir,
                        "--dcp-dir", str(tmp_path / "d")]) == 0
    assert capsys.readouterr().out.strip() == "1"
    assert dcp_io.main(["import", "--dcp-dir", str(tmp_path / "d"),
                        "--flash-dir", str(tmp_path / "back")]) == 0
    assert capsys.readouterr().out.strip() == "1"
    assert ckpt_storage.read_tracker(str(tmp_path / "back")) == 1


def _bf16_state():
    """bf16 leaves over every class of bit pattern (NaN, infinities,
    subnormals, signed zeros) and an f32 and int leaf."""
    rs = np.random.RandomState(4)
    bits = rs.randint(0, 1 << 16, (64, 33)).astype(np.uint16)
    bits[0, :6] = [0x7FC1, 0xFF80, 0x7F80, 0x0001, 0x8000, 0x807F]
    return {
        "w": torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16),
        "moments": [torch.from_numpy(rs.randn(5, 7).astype(np.float32))
                    .bfloat16(), torch.from_numpy(rs.randn(3).astype(
                        np.float32))],
        "count": torch.tensor(9, dtype=torch.int64),
    }


def test_bf16_crosses_both_ways_bit_for_bit(tmp_path):
    state = _bf16_state()
    flash_dir = str(tmp_path / "flash")
    _save_flash(flash_dir, 5, state)
    dcp_io.export_step(flash_dir, str(tmp_path / "d"))
    _, loaded = dcp_io.load_dcp(str(tmp_path / "d"), device="cpu")
    flash2 = str(tmp_path / "flash2")
    dcp_io.import_step(str(tmp_path / "d"), flash2)
    ckpt = Checkpointer(flash2, standalone=True)
    _, back, _ = ckpt.load_checkpoint()
    ckpt.close()
    for tree in (loaded, back):
        assert tree["w"].dtype == torch.bfloat16
        assert _bits(tree["w"]) == _bits(state["w"])
        for got, want in zip(tree["moments"], state["moments"]):
            assert got.dtype == want.dtype and _bits(got) == _bits(want)
        assert _bits(tree["count"]) == _bits(state["count"])


def test_each_packages_bridge_loads_the_same_leaves(tmp_path, monkeypatch,
                                                     job):
    """The same numpy state through each package: its checkpointer saves
    it, its bridge exports it (orbax, DCP), the bridge's loader reads
    it: the leaves agree bit for bit."""
    rs = np.random.RandomState(8)
    w = rs.randn(6, 4).astype(np.float32)
    e = rs.randn(5, 3).astype(ml_dtypes.bfloat16)
    count = np.asarray(12, np.int32)
    jax_state = {"params": {"w": jnp.asarray(w), "e": jnp.asarray(e)},
                 "count": jnp.asarray(count)}
    port_state = {"params": {"w": torch.from_numpy(w),
                             "e": torch.from_numpy(e.view(np.int16)).view(
                                 torch.bfloat16)},
                  "count": torch.from_numpy(count)}
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", job + "j")
    jdir = str(tmp_path / "jflash")
    jckpt = JaxCheckpointer(jdir, standalone=True)
    jckpt.save_checkpoint(2, jax_state, JaxStorageType.DISK)
    assert jckpt.wait_saving_complete()
    jckpt.close()
    orbax_io.export_step(jdir, str(tmp_path / "orbax"))
    _, jgot = orbax_io.load_orbax(str(tmp_path / "orbax"))
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", job)
    _save_flash(str(tmp_path / "pflash"), 2, port_state)
    dcp_io.export_step(str(tmp_path / "pflash"), str(tmp_path / "dcp"))
    _, pgot = dcp_io.load_dcp(str(tmp_path / "dcp"), device="cpu")
    for path in (("params", "w"), ("params", "e"), ("count",)):
        j, p = jgot, pgot
        for key in path:
            j, p = j[key], p[key]
        assert tuple(np.shape(j)) == tuple(p.shape), path
        assert _bits(j) == _bits(p), path
    for seg in os.listdir("/dev/shm"):
        if job + "j" in seg:
            os.unlink(os.path.join("/dev/shm", seg))
