"""The resharding restore between the packages and across layouts.

- A checkpoint the JAX ``Checkpointer`` wrote from the 8-device
  ``P("x", None)`` mesh (as ``tests/test_flash_ckpt.py``) restores into a
  4-rank port world at (dp=2, tp=2): each rank's DTensor shards hold the
  bytes of their slice, and each rank reads only its regions.
- A checkpoint that 4-rank world wrote (one proc file a rank, its
  shards' global bounds in meta and raw header) restores in a port
  world at dp=4, whole in this process, and through the JAX
  ``load_global_state`` under another sharding.
- ``load_state_regions`` equals the reference's on the same files.
- A shard whose bounds moved by one row is refused.
"""

import os
import pickle
import shutil
import uuid

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from dlrover_tpu.flash_ckpt import engine as jax_engine
from dlrover_tpu.flash_ckpt import shm_handler as jax_shm
from dlrover_tpu.flash_ckpt.checkpointer import Checkpointer as JaxCheckpointer
from dlrover_tpu.flash_ckpt.checkpointer import StorageType as JaxStorageType
from dlrover_tpu.trainer import runtime as jax_runtime
from dlrover_tpu_torch.flash_ckpt import engine
from dlrover_tpu_torch.flash_ckpt import storage as ckpt_storage
from dlrover_tpu_torch.flash_ckpt.raw_format import write_raw_shards
from dlrover_tpu_torch.trainer import runtime
from tests.test_torch_sharded_train import run_world

# name -> (shape, dtype, the port's spec on (dp=2, tp=2)); flatten order
# (sorted names) is the leaf id.
LEAVES = {
    "b": ((8, 16), "bfloat16", ("tp", "dp")),
    "n": ((4,), "float32", (None,)),
    "w": ((16, 8), "float32", ("dp", "tp")),
}


def _full():
    rs = np.random.RandomState(5)
    return {"b": rs.randn(8, 16).astype(ml_dtypes.bfloat16),
            "n": rs.randn(4).astype(np.float32),
            "w": rs.randn(16, 8).astype(np.float32)}


def _port_full(full):
    """The arrays as the port stores them (bf16 as uint16 bits)."""
    return {k: v.view(np.uint16) if v.dtype == ml_dtypes.bfloat16 else v
            for k, v in full.items()}


@pytest.fixture
def job(monkeypatch, tmp_path):
    name = f"tr{os.getpid()}_{uuid.uuid4().hex[:10]}"
    env = {"DLROVER_TPU_JOB_NAME": name, "DLROVER_TPU_NODE_RANK": "0",
           "DLROVER_TPU_SHARED_DIR": str(tmp_path / "uds")}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    runtime._context = None
    jax_runtime._context = None
    yield env
    runtime._context = None
    jax_runtime._context = None
    for seg in os.listdir("/dev/shm"):
        if name in seg:
            os.unlink(os.path.join("/dev/shm", seg))


def _leaves_meta(specs=None):
    return {k: (shape, dtype, (specs or {}).get(k, spec))
            for k, (shape, dtype, spec) in LEAVES.items()}


def _check_local(outs, full):
    """Each rank's shards equal their slice of ``full``; it read exactly
    its shards' bytes."""
    port = _port_full(full)
    for out in outs:
        assert out["restored"]
        want_bytes = 0
        for name, (bounds, local) in out["local"].items():
            want = port[name][tuple(slice(lo, hi) for lo, hi in bounds)]
            np.testing.assert_array_equal(
                local.view(want.dtype).reshape(want.shape), want)
            want_bytes += want.nbytes
        assert out["bytes_read"] == want_bytes, out["bytes_read"]


def _jax_save(ckpt_dir, full):
    devices = np.array(jax.devices())
    mesh = Mesh(devices.reshape(8), ("x",))
    tree = {"b": jax.device_put(jnp.asarray(full["b"]),
                                NamedSharding(mesh, PartitionSpec(None, "x"))),
            "n": jnp.asarray(full["n"]),
            "w": jax.device_put(jnp.asarray(full["w"]),
                                NamedSharding(mesh, PartitionSpec("x", None)))}
    ckpt = JaxCheckpointer(ckpt_dir, standalone=True)
    ckpt.save_checkpoint(2, tree, JaxStorageType.DISK)
    assert ckpt.wait_saving_complete(60)
    ckpt._engine._shm.unlink()  # noqa: SLF001
    ckpt.close()


def test_port_world_restores_jax_checkpoint(tmp_path, job):
    ckpt_dir = str(tmp_path / "jax_ckpt")
    full = _full()
    _jax_save(ckpt_dir, full)
    outs = run_world("restore", tmp_path / "w", {
        "mesh": {"dp": 2, "tp": 2}, "ckpt_dir": ckpt_dir, "step": 2,
        "leaves_meta": _leaves_meta()}, 4, env=job)
    _check_local(outs, full)
    # The same files through both packages' explicit-region reads.
    regions = {0: [((2, 6), (0, 16)), ((0, 8), (3, 4))],
               2: [((5, 13), (1, 7))]}
    want = jax_engine.load_state_regions(ckpt_dir, 2, regions)
    got = engine.load_state_regions(ckpt_dir, 2, regions)
    assert got[0] == want[0] == 2
    for leaf_id, by_bounds in want[1].items():
        assert set(got[1][leaf_id]) == set(by_bounds)
        for bounds, arr in by_bounds.items():
            got_arr = got[1][leaf_id][bounds]
            assert got_arr.tobytes() == np.ascontiguousarray(arr).tobytes()
    assert engine.load_state_regions(ckpt_dir, 2, {2: [((0, 17), (0, 8))]}
                                     ) is None


def _jax_metas(metas):
    """The port's proc metas as the reference's: its LeafMeta classes
    and a JAX tree definition of the same structure."""
    treedef = jax.tree_util.tree_structure({k: 0 for k in LEAVES})
    out = {}
    for pid, meta in metas.items():
        out[pid] = {"treedef": pickle.dumps(treedef),
                    "user_meta": meta["user_meta"],
                    "leaves": [jax_shm.LeafMeta(
                        lm.leaf_id, lm.global_shape, lm.dtype,
                        [jax_shm.ShardMeta(s.index, s.local_shape, s.offset,
                                           s.nbytes) for s in lm.shards],
                        lm.replicated) for lm in meta["leaves"]]}
    return out


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    """Step 3 saved by a 4-rank port world at (dp=2, tp=2)."""
    root = tmp_path_factory.mktemp("port_world")
    name = f"trw{os.getpid()}_{uuid.uuid4().hex[:10]}"
    env = {"DLROVER_TPU_JOB_NAME": name, "DLROVER_TPU_NODE_RANK": "0",
           "DLROVER_TPU_SHARED_DIR": str(root / "uds")}
    ckpt_dir = str(root / "port_ckpt")
    try:
        saved = run_world("save", root / "s", {
            "mesh": {"dp": 2, "tp": 2}, "ckpt_dir": ckpt_dir, "step": 3,
            "leaves_meta": _leaves_meta(), "full": _port_full(_full())}, 4,
            env=env)
    finally:
        for seg in os.listdir("/dev/shm"):
            if name in seg:
                os.unlink(os.path.join("/dev/shm", seg))
    assert [o["tracker"] for o in saved] == [3] * 4
    return ckpt_dir


def test_port_world_checkpoint_restores_everywhere(tmp_path, job, port_ckpt):
    ckpt_dir = port_ckpt
    full = _full()
    metas = ckpt_storage.load_step_meta(ckpt_dir, 3)
    assert sorted(metas) == [0, 1, 2, 3]
    # Rank 3 sits at (dp=1, tp=1): its shard of w is rows 8:16, cols 4:8.
    w3 = metas[3]["leaves"][2]
    assert w3.shards[0].index == ((8, 16), (4, 8)) and not w3.replicated
    with ckpt_storage.load_proc_arrays(ckpt_dir, 3, 3) as reader:
        assert reader.bounds("leaf2_shard0") == ((8, 16), (4, 8))

    # Another layout in the port: dp=4 (b's rows over tp become columns).
    outs = run_world("restore", tmp_path / "r", {
        "mesh": {"dp": 4}, "ckpt_dir": ckpt_dir, "step": 3,
        "leaves_meta": _leaves_meta({"b": (None, "dp"), "w": ("dp", None)})},
        4, env=job)
    _check_local(outs, full)

    # Whole leaves in this process.
    target = {k: torch.zeros(shape, dtype=getattr(torch, dtype))
              for k, (shape, dtype, _) in LEAVES.items()}
    stats = {}
    step, tree, _ = engine.load_global_state(ckpt_dir, 3, metas, target,
                                             stats)
    assert step == 3 and tree["w"] is target["w"]
    port = _port_full(full)
    for k, t in target.items():
        got = t.view(torch.uint16) if t.dtype == torch.bfloat16 else t
        np.testing.assert_array_equal(got.numpy(), port[k])
    # The replicated leaf sits in all four files and is read once.
    assert stats["bytes_read"] == sum(a.nbytes for a in port.values())

    # The JAX package's restore under another sharding.
    devices = np.array(jax.devices())
    mesh = Mesh(devices.reshape(2, 4), ("a", "b"))
    shardings = {"b": NamedSharding(mesh, PartitionSpec("b", None)),
                 "n": NamedSharding(mesh, PartitionSpec()),
                 "w": NamedSharding(mesh, PartitionSpec(None, "b"))}
    result = jax_engine.load_global_state(ckpt_dir, 3, _jax_metas(metas),
                                          shardings)
    assert result is not None and result[0] == 3
    for k, arr in result[1].items():
        assert arr.sharding == shardings[k]
        np.testing.assert_array_equal(np.asarray(arr), full[k])


def _moved(meta, leaf_id, rows=1):
    """``meta`` with one shard's bounds moved ``rows`` rows."""
    lm = meta["leaves"][leaf_id]
    (lo, hi), *rest = lm.shards[0].index
    lm.shards[0].index = ((lo + rows, hi + rows), *rest)
    return meta


def test_moved_shard_is_refused(tmp_path, job, port_ckpt):
    """w's shards are held by one rank each (dp x tp): a proc file whose
    meta moves its shard by one row disagrees with its raw header, and
    a checkpoint whose meta and header both moved leaves a row no file
    covers. Both are refused."""
    ckpt_dir = str(tmp_path / "port_ckpt")
    shutil.copytree(port_ckpt, ckpt_dir)
    target = {k: torch.zeros(shape, dtype=getattr(torch, dtype))
              for k, (shape, dtype, _) in LEAVES.items()}
    metas = ckpt_storage.load_step_meta(ckpt_dir, 3)
    assert engine.load_global_state(ckpt_dir, 3, metas, target) is not None
    metas = ckpt_storage.load_step_meta(ckpt_dir, 3)
    assert engine.load_global_state(ckpt_dir, 3, {
        **metas, 0: _moved(metas[0], 2)}, target) is None
    # Meta and raw header agree on the moved bounds: row 0 is uncovered.
    metas = ckpt_storage.load_step_meta(ckpt_dir, 3)
    moved = _moved(metas[0], 2)
    with ckpt_storage.load_proc_arrays(ckpt_dir, 3, 0) as reader:
        arrays = {k: np.array(reader.get(k)) for k in reader.keys()}
    bounds = {f"leaf{lm.leaf_id}_shard0": lm.shards[0].index
              for lm in moved["leaves"]}
    path = os.path.join(ckpt_storage.step_dir(ckpt_dir, 3), "proc-0.raw")
    write_raw_shards(path, 3, 0, arrays, bounds,
                     dtypes={"leaf0_shard0": "bfloat16"})
    assert engine.load_global_state(ckpt_dir, 3, {**metas, 0: moved},
                                    target) is None
    # Restored: the checkpoint restores again.
    write_raw_shards(path, 3, 0, arrays, {
        **bounds, "leaf2_shard0": ((0, 8), (0, 4))},
        dtypes={"leaf0_shard0": "bfloat16"})
    metas = ckpt_storage.load_step_meta(ckpt_dir, 3)
    assert engine.load_global_state(ckpt_dir, 3, metas, target) is not None


_PHASES = r"""
import json
import chip_smoke as cs
from dlrover_tpu_torch.models import llama
cfg = llama.tiny_config()
state, launches = cs.phase_mesh_train(cfg, device="cpu", micro=2, seq=16)
row = cs.phase_reshard_restore(cfg, state, device="cpu", config="tiny")
print(json.dumps({"launches": launches, "bytes": row["rank_bytes_read"]}))
"""


def test_chip_mesh_phases_on_cpu(tmp_path):
    """chip_smoke's mesh phases at the tiny config on the CPU (their
    gates raise): the world-one mesh step bitwise equal to the mesh-less
    one, and the state through a 4-rank gloo world and back bitwise with
    the planted fault refused. (The node check phase's worker runs in
    ``test_torch_node_check.py``.)"""
    import json
    import subprocess
    import sys

    from tests.test_torch_sharded_train import REPO

    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               DLROVER_TPU_JOB_NAME=f"phases{uuid.uuid4().hex[:8]}",
               DLROVER_TPU_SHARED_DIR=str(tmp_path / "uds"),
               TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", _PHASES], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["launches"] == {"flash_forward": 0, "flash_backward_dq": 0,
                               "flash_backward_dkv": 0}
    assert len(out["bytes"]) == 4
