"""The port's elastic worker path (``trainer/runtime.py``,
``trainer/elastic/``, the train state's checkpoint view and
``examples/train_llama.py``) against the JAX package's.

- The sampler deals the reference's indices and keeps its
  ``state_dict``; the loaders yield the reference's batches in its
  order; the batch config and the trainer's bookkeeping agree.
- ``read_worker_env`` reads the reference's env names, and
  ``init_distributed`` joins a 2-process gloo world.
- A JAX train state (tiny f32 config, 2 steps) crosses with
  ``convert.train_state_from_numpy`` and continues 3 steps on the port,
  within ``test_train_trajectory_matches_jax``'s tolerances of JAX's own
  3 more steps; converted back it has the reference's structure.
- The port's worker at a tiny config, run on the CPU by
  ``chip_smoke.phase_elastic_ckpt`` as on the card: under the port's
  launcher (``python -m dlrover_tpu_torch.run --standalone``), whose
  agent restarts it after a SIGKILL from memory, then from storage
  after its segment is unlinked; every loss and the final state equal
  an uninterrupted run's bit for bit.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import dataclasses
import json
import os
import socket
import subprocess
import sys
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu.trainer import runtime as jax_runtime
from dlrover_tpu.trainer import train_step as jax_ts
from dlrover_tpu.trainer.elastic import dataloader as jax_dl
from dlrover_tpu.trainer.elastic import trainer as jax_trainer
from dlrover_tpu.trainer.elastic.sampler import (
    ElasticDistributedSampler as JaxSampler,
)
from dlrover_tpu_torch.flash_ckpt.checkpointer import Checkpointer
from dlrover_tpu_torch.models import convert, llama
from dlrover_tpu_torch.observability import flight_recorder
from dlrover_tpu_torch.trainer import runtime
from dlrover_tpu_torch.trainer import train_step as ts
from dlrover_tpu_torch.trainer.elastic import dataloader as dl
from dlrover_tpu_torch.trainer.elastic import trainer as el
from dlrover_tpu_torch.trainer.elastic.sampler import (
    ElasticDistributedSampler,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("size,rank,world,shuffle,seed,drop_last", [
    (37, 0, 1, True, 0, False), (37, 2, 3, True, 5, False),
    (40, 1, 4, False, 0, True), (11, 3, 4, True, 9, True)])
def test_sampler_matches_reference(size, rank, world, shuffle, seed,
                                   drop_last):
    port = ElasticDistributedSampler(size, rank, world, shuffle, seed,
                                     drop_last)
    ref = JaxSampler(size, rank, world, shuffle, seed, drop_last)
    for epoch in range(2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for s in (port, ref):
            s.record_batch(6)
        assert list(port) == list(ref) and len(port) == len(ref)
        assert port.state_dict() == ref.state_dict()
    state = ref.state_dict()
    port2 = ElasticDistributedSampler(size, 0, 1, shuffle, seed, drop_last)
    port2.load_state_dict(state)
    port2.rescale(rank, world)
    assert list(port2) == list(ref)
    with pytest.raises(ValueError):
        port2.load_state_dict(dict(state, dataset_size=size + 1))


def _fetch(i):
    return {"x": np.full((3,), i, np.int32), "y": np.float32(i) * 0.5}


def test_loaders_and_prefetch_match_reference_order():
    def batches(pkg, cls, sampler_cls):
        sampler = sampler_cls(23, 0, 1, True, 3)
        if cls == "elastic":
            loader = pkg.ElasticDataLoader(_fetch, sampler, 4)
        else:
            loader = pkg.PrefetchingDataLoader(_fetch, sampler, 4,
                                               sampler=sampler)
        out = []
        for batch in loader:
            out.append(({k: np.array(v) for k, v in batch.items()},
                        sampler.state_dict()))
        return out

    for cls in ("elastic", "prefetch"):
        want = batches(jax_dl, cls, JaxSampler)
        got = batches(dl, cls, ElasticDistributedSampler)
        assert len(got) == len(want) == 5
        for (g, gs), (w, ws) in zip(got, want):
            assert gs == ws and set(g) == set(w)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
    # The device prefetch (here: a copy per batch) keeps the order, and
    # its batches outlive the loader's recycled ring slots.
    sampler = ElasticDistributedSampler(23, 0, 1, True, 3)
    loader = dl.PrefetchingDataLoader(_fetch, sampler, 4, sampler=sampler)
    held = list(dl.device_put_prefetch(loader, device="cpu"))
    for h, (w, _) in zip(held, want):
        assert isinstance(h["x"], torch.Tensor)
        np.testing.assert_array_equal(h["x"].numpy(), w["x"])


def test_batch_config_and_trainer_bookkeeping(tmp_path, monkeypatch):
    for gb, micro in ((32, 2), (24, 4), (16, 8)):
        port, ref = (el.ElasticBatchConfig(gb, micro),
                     jax_trainer.ElasticBatchConfig(gb, micro))
        assert port.legal_dp_sizes(8) == ref.legal_dp_sizes(8)
        assert port.legal_node_counts_fn(2)(8, 1) == \
            ref.legal_node_counts_fn(2)(8, 1)
    monkeypatch.setattr(flight_recorder, "_recorder", None)
    rec = flight_recorder.install_recorder(meta={"local_rank": 0})
    trainer = el.ElasticTrainer(el.ElasticBatchConfig(32, 2), dp_size=4)
    assert trainer.grad_accum == 4
    assert trainer.rescale(8) and trainer.grad_accum == 2
    assert not trainer.rescale(8)
    with pytest.raises(ValueError):
        trainer.rescale(3)
    trainer.start_training()
    trainer.step_completed()
    trainer.step_completed(steps=2)
    assert trainer.global_step == 3
    assert [r["step"] for r in rec.records() if "step_time_s" in r] == [1, 3]
    # restore_checkpoint adopts the step, into the target in place.
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"te{uuid.uuid4().hex[:10]}")
    monkeypatch.setenv("DLROVER_TPU_SHARED_DIR", str(tmp_path / "uds"))
    monkeypatch.setattr(runtime, "_context", None)
    ckpt = Checkpointer(str(tmp_path / "ckpt"), standalone=True)
    tree = {"w": torch.arange(4.0), "step": 9}
    ckpt.save_checkpoint(9, tree, user_meta={"sampler": {}})
    target = {"w": torch.zeros(4), "step": 0}
    try:
        state, meta = trainer.restore_checkpoint(ckpt, target=target)
        assert trainer.global_step == 9 and state["step"] == 9
        assert state["w"] is target["w"] and torch.equal(target["w"],
                                                          tree["w"])
        assert rec.records()[-1]["event"] == "ckpt_restore"
    finally:
        ckpt._engine._shm.unlink()  # noqa: SLF001
        ckpt.close()
        monkeypatch.setattr(flight_recorder, "_recorder", None)


def test_read_worker_env_matches_reference(monkeypatch):
    env = {"DLROVER_TPU_COORDINATOR": "10.0.0.1:1234",
           "DLROVER_TPU_NUM_PROCESSES": "4", "DLROVER_TPU_PROCESS_ID": "2",
           "DLROVER_TPU_LOCAL_RANK": "1",
           "DLROVER_TPU_LOCAL_WORLD_SIZE": "2",
           "DLROVER_TPU_RESTART_COUNT": "3", "DLROVER_TPU_RDZV_ROUND": "5",
           "DLROVER_TPU_NODE_RANKS": "0,1", "DLROVER_TPU_NUM_SLICES": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, ref = runtime.read_worker_env(), jax_runtime.read_worker_env()
    got = dataclasses.asdict(port)
    want = dataclasses.asdict(ref)
    assert got.pop("initialized_distributed") is False
    want.pop("initialized_jax_distributed")
    assert got == want and port.is_leader == ref.is_leader is False


_GLOO_CHILD = r"""
import json, torch, torch.distributed as dist
from dlrover_tpu_torch.trainer import runtime
ctx = runtime.init_distributed(timeout_secs=60, device="cpu")
t = torch.tensor([float(ctx.process_id + 1)])
dist.all_reduce(t)
print(json.dumps({"pid": ctx.process_id, "sum": t.item(),
                  "init": ctx.initialized_distributed,
                  "world": dist.get_world_size()}))
runtime.shutdown_distributed()
"""


def test_init_distributed_two_process_gloo():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   DLROVER_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   DLROVER_TPU_NUM_PROCESSES="2",
                   DLROVER_TPU_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _GLOO_CHILD], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    got = sorted((json.loads(out.strip().splitlines()[-1])
                  for out, _ in outs), key=lambda g: g["pid"])
    assert got == [{"pid": i, "sum": 3.0, "init": True, "world": 2}
                   for i in range(2)]


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.int32)


def test_train_state_from_jax_continues_like_jax():
    """2 JAX steps, then the state crosses and both packages take 3 more
    steps on the same batches."""
    jcfg = jax_llama.tiny_config()
    jtc = jax_ts.TrainConfig(learning_rate=5e-3, warmup_steps=2)
    mesh = build_mesh(MeshConfig(dp=1), jax.devices()[:1])
    jopt = jax_ts.make_optimizer(jtc)
    jstate, _ = jax_ts.init_train_state(jcfg, jopt, mesh, jax.random.key(0))
    jstep, _ = jax_ts.make_train_step(jcfg, jtc, jopt, mesh, donate=False)
    for i in range(2):
        jstate, _ = jstep(jstate, {"tokens": jnp.asarray(_tokens(i, (4, 17)))})
    crossed = jax.device_get(jstate)

    cfg = llama.TpuLMConfig(**dataclasses.asdict(jcfg))
    tc = ts.TrainConfig(**dataclasses.asdict(jtc))
    opt = ts.make_optimizer(tc)
    state = convert.train_state_from_numpy(cfg, crossed, opt, device="cpu")
    assert state["step"] == 2
    # Converted back, the state is the reference's, leaf for leaf.
    back = convert.train_state_to_numpy(state, like=crossed)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(crossed))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(crossed)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    step = ts.make_train_step(cfg, tc, opt, device="cpu")
    for i in range(2, 5):
        toks = _tokens(i, (4, 17))
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": toks})
        assert m["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    want = jax.tree_util.tree_leaves_with_path(
        jax.device_get(jstate["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.params_to_numpy(state["params"])))
    for path, w in want:
        diff = np.abs(got[path] - w)
        assert diff.mean() <= 1e-6, (path, diff.mean())
        assert np.mean(diff > 2e-5) <= 1e-3, (path, np.mean(diff > 2e-5))
        assert diff.max() <= tc.learning_rate, (path, diff.max())


def test_state_tree_restores_in_place_keeping_identity():
    cfg = llama.tiny_config(n_layers=2)
    tc = ts.TrainConfig(learning_rate=1e-2, warmup_steps=1)
    opt = ts.make_optimizer(tc)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    state = ts.init_train_state(cfg, opt, params)
    step = ts.make_train_step(cfg, tc, opt, device="cpu")
    for i in range(2):
        state, _ = step(state, {"tokens": _tokens(i, (2, 9))})
    saved = ts.state_tree(state)
    copy = jax.tree_util.tree_map(
        lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t,
        saved)
    fresh_opt = ts.make_optimizer(tc)
    fresh = ts.init_train_state(cfg, fresh_opt, llama.init_params(
        cfg, torch.Generator().manual_seed(1), device="cpu"))
    leaves = ts.param_leaves(fresh["params"])
    ts.load_state_tree_(fresh, copy)
    assert fresh["step"] == 2
    held = fresh["opt_state"].param_groups[0]["params"]
    assert len(held) == len(leaves) and all(
        a is b for a, b in zip(held, leaves))
    for a, b in zip(jax.tree_util.tree_leaves(ts.state_tree(fresh)),
                    jax.tree_util.tree_leaves(saved)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    # The next step from the restored state equals the original's.
    s1, m1 = step(state, {"tokens": _tokens(7, (2, 9))})
    s2, m2 = ts.make_train_step(cfg, tc, fresh_opt, device="cpu")(
        fresh, {"tokens": _tokens(7, (2, 9))})
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(ts.param_leaves(s1["params"]),
                    ts.param_leaves(s2["params"])):
        assert torch.equal(a, b)


def test_killed_worker_replays_bitwise(monkeypatch):
    """chip_smoke's elastic phase on the CPU: the worker at a tiny
    config under the port's launcher, killed after step 5 (the agent's
    restart restores it from memory) and after step 8 with its segment
    unlinked (restored from storage), ends bitwise equal to an
    uninterrupted run beside it; each held worker writes a hang dump
    (its watchdog), which the master receives through the agent, and an
    on-demand flight dump (SIGUSR1); the uninterrupted run writes no
    hang dump; the phase's gates raise otherwise."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    launches = chip_smoke.phase_elastic_ckpt(device="cpu", config="tiny",
                                             micro=2, seq=16)
    assert launches == {"flash_forward": 0, "flash_backward_dq": 0,
                        "flash_backward_dkv": 0}
