"""The port's sharded train step on gloo worlds of 2 and 4 CPU processes
against the JAX package's ``make_train_step`` on the same mesh over as
many of the 8 virtual CPU devices: a 5-step f32 trajectory of the tiny
dense config from the same state and batches (loss and grad norm within
rtol 1e-4 each step, final params within rtol 1e-4 / atol 1e-5, as
``tests/test_torch_train.py`` holds the one-device path; then the eval
step's CE within rtol 1e-4). The world on
(dp=2, tp=2) also checks grad accumulation 2 against 1, the CE routes
under tp, one step each of an sp axis, a pp axis, pipeline stages and a
dropless MoE on a mesh of the world against the same step without one,
and the mesh case that still raises (the 2-process world too).

The ranks run ``tests/workers/torch_mesh_worker.py`` (no JAX there)."""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu.trainer import train_step as jax_ts
from dlrover_tpu_torch.models import convert

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "workers" / "torch_mesh_worker.py"
STEPS = 5


def run_world(case, work: Path, inp: dict, world: int, env=None,
              timeout=240):
    """Run ``case`` of the worker on a gloo world of ``world`` processes;
    returns each rank's output dict."""
    work.mkdir(parents=True, exist_ok=True)
    (work / "in.pkl").write_bytes(pickle.dumps(inp))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        penv = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                    DLROVER_TPU_COORDINATOR=f"127.0.0.1:{port}",
                    DLROVER_TPU_NUM_PROCESSES=str(world),
                    DLROVER_TPU_PROCESS_ID=str(rank),
                    DLROVER_TPU_LOCAL_RANK=str(rank),
                    DLROVER_TPU_LOCAL_WORLD_SIZE=str(world), **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), case, str(work)], env=penv,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [pickle.loads((work / f"out{r}.pkl").read_bytes())
            for r in range(world)]


def _batches(cfg, rows=8, seq=16):
    rs = np.random.RandomState(3)
    return [rs.randint(0, cfg.vocab_size, (rows, seq + 1)).astype(np.int32)
            for _ in range(STEPS)]


def _jax_run(jcfg, jtc, mesh_kw, batches):
    n = int(np.prod(list(mesh_kw.values())))
    mesh = build_mesh(MeshConfig(**mesh_kw), jax.devices()[:n])
    jopt = jax_ts.make_optimizer(jtc)
    jstate, _ = jax_ts.init_train_state(jcfg, jopt, mesh, jax.random.key(0))
    crossed = jax.device_get(jstate)
    jstep, _ = jax_ts.make_train_step(jcfg, jtc, jopt, mesh, donate=False)
    losses, norms = [], []
    for tokens in batches:
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    ce = float(jax_ts.make_eval_step(jcfg, mesh)(
        jstate["params"], {"tokens": jnp.asarray(batches[0])}))
    adam = convert._adam_state(crossed["opt_state"])
    state = {"params": crossed["params"],
             "opt_state": types.SimpleNamespace(
                 count=np.asarray(adam.count), mu=adam.mu, nu=adam.nu),
             "step": np.asarray(crossed["step"])}
    return state, losses, norms, jax.device_get(jstate["params"]), ce


def check_trajectory(tmp_path, jcfg, mesh_kw, rows=8, seq=16):
    """The port's 5-step trajectory of ``jcfg`` on a gloo world of
    ``mesh_kw`` against JAX's ``make_train_step`` on the same mesh."""
    jtc = jax_ts.TrainConfig(learning_rate=5e-3, warmup_steps=2)
    batches = _batches(jcfg, rows=rows, seq=seq)
    state, losses, norms, jparams, ce = _jax_run(jcfg, jtc, mesh_kw,
                                                 batches)
    outs = run_world("train", tmp_path, {
        "mesh": mesh_kw, "cfg": dataclasses.asdict(jcfg),
        "tc": dataclasses.asdict(jtc), "state": state, "batches": batches,
        "extra": False}, int(np.prod(list(mesh_kw.values()))))
    for out in outs:
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-4)
        np.testing.assert_allclose(out["norms"], norms, rtol=1e-4)
        np.testing.assert_allclose(out["eval_ce"], ce, rtol=1e-4)
    got = outs[0]["params"]
    for path, want in jax.tree_util.tree_leaves_with_path(jparams):
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf, want, rtol=1e-4, atol=1e-5,
                                   err_msg=str(path))


MESHES = [
    pytest.param({"dp": 4}, id="dp4"),
    pytest.param({"dp": 2, "tp": 2}, id="dp2_tp2"),
    pytest.param({"dcn": 2, "dp": 2}, id="dcn2_dp2"),
    pytest.param({"tp": 2}, id="tp2"),
]


@pytest.mark.parametrize("mesh_kw", MESHES)
def test_sharded_trajectory_matches_jax(tmp_path, mesh_kw):
    jcfg = jax_llama.tiny_config(n_layers=2)
    jtc = jax_ts.TrainConfig(learning_rate=5e-3, warmup_steps=2)
    batches = _batches(jcfg)
    state, losses, norms, jparams, ce = _jax_run(jcfg, jtc, mesh_kw,
                                                 batches)
    world = int(np.prod(list(mesh_kw.values())))
    extra = len(mesh_kw) == 2 and "tp" in mesh_kw or world == 2
    outs = run_world("train", tmp_path, {
        "mesh": mesh_kw, "cfg": dataclasses.asdict(jcfg),
        "tc": dataclasses.asdict(jtc), "state": state, "batches": batches,
        "extra": extra}, world)
    for rank, out in enumerate(outs):
        # init_device_mesh lays the world out row-major, as the reference
        # reshapes its devices.
        assert tuple(out["coord"]) == np.unravel_index(
            rank, MeshConfig(**mesh_kw).shape)
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-4)
        np.testing.assert_allclose(out["norms"], norms, rtol=1e-4)
        np.testing.assert_allclose(out["eval_ce"], ce, rtol=1e-4)
    got = outs[0]["params"]
    for path, want in jax.tree_util.tree_leaves_with_path(jparams):
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf, want, rtol=1e-4, atol=1e-5,
                                   err_msg=str(path))
    if not extra:
        return
    out = outs[0]
    # The axes that used to raise run on the world and take the step the
    # port takes without a mesh; a pp axis without stages still raises.
    for name in ("sp", "pp_axis", "pp_stages", "moe"):
        (loss, norm), (want_loss, want_norm) = out["runs"][name]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(norm, want_norm, rtol=1e-4, err_msg=name)
    assert "ROADMAP §A" in out["raises"]["pp_replicas"], out["raises"]
    # grad_accum 2 takes the same step as 1 over the same batch.
    (l1, n1, p1, _), (l2, n2, p2, _) = out["ga1"], out["ga2"]
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    np.testing.assert_allclose(n2, n1, rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(p2),
                    jax.tree_util.tree_leaves(p1)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # Above one rank the CE route is the vocab scan, as the reference
    # picks; under tp the fused CE does not apply, and the vocab scan over
    # this rank's columns equals the dense CE of the whole logits.
    assert out["ce_impl"] == "xla"
    assert out["fused_ce_applicable"] is ("tp" not in mesh_kw)
    if "tp" in mesh_kw:
        scan = out["vocab_scan"]
        np.testing.assert_allclose(*scan["loss"], rtol=1e-6)
        assert scan["dx"] <= 1e-6 and scan["dw"] <= 1e-6, scan


def test_elastic_worker_trains_one_model_on_a_two_rank_mesh(tmp_path):
    """The port's elastic worker on a 2-process gloo world (``--mesh
    dp=2``, the reference worker's ``MeshConfig(dp=world)``): both ranks
    report the global mean loss of every step, the same on each (each
    rank used to train a replica of its own on its own rows), and the
    persisted step holds one proc file a rank with that rank's shards of
    the FSDP-sharded embedding."""
    import json
    import uuid

    from dlrover_tpu_torch.flash_ckpt import storage as ckpt_storage

    job = f"mw{uuid.uuid4().hex[:10]}"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ckpt = tmp_path / "ckpt"
    procs = []
    try:
        for rank in range(2):
            env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                       DLROVER_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       DLROVER_TPU_NUM_PROCESSES="2",
                       DLROVER_TPU_PROCESS_ID=str(rank),
                       DLROVER_TPU_LOCAL_RANK=str(rank),
                       DLROVER_TPU_LOCAL_WORLD_SIZE="2",
                       DLROVER_TPU_NODE_RANK="0", DLROVER_TPU_JOB_NAME=job,
                       DLROVER_TPU_SHARED_DIR=str(tmp_path / "uds"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "dlrover_tpu_torch.examples.train_llama", "--device", "cpu",
                 "--mesh", "dp=2", "--steps", "3", "--global-batch", "8",
                 "--micro-batch", "2", "--seq", "16", "--persist-every", "3",
                 "--ckpt-dir", str(ckpt)], env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for seg in os.listdir("/dev/shm"):
            if job in seg:
                os.unlink(os.path.join("/dev/shm", seg))
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    losses = [[e["loss"] for e in map(json.loads, out.splitlines())
               if e["event"] == "step"] for out, _ in outs]
    assert len(losses[0]) == 3 and losses[0] == losses[1]
    metas = ckpt_storage.load_step_meta(str(ckpt), 3)
    assert sorted(metas) == [0, 1]
    embed = [metas[r]["leaves"][0] for r in (0, 1)]  # params.embed
    assert [lm.shards[0].index for lm in embed] == [
        ((0, 256), (0, 32)), ((0, 256), (32, 64))]
