"""The port's GPipe pipeline (``trainer/pipeline.py``) and the stage
layout of the layer params, against the JAX package.

- ``pipelined_forward`` (through ``llama.forward`` under ``pp_stages >
  1``) against the flat forward and against JAX's ``pipelined_forward``
  on the same numpy params and tokens: dense at 2 and 4 stages, MoE at 2
  (f32; logits within 2e-4 as the reference's own tests hold them, aux
  against JAX within rtol 1e-4 and, for MoE, against the flat forward's
  within rtol 0.2: per-micro-batch means only approximate the whole
  batch's load-balance statistic);
- ``init_params`` under ``pp_stages > 1`` gives JAX's shapes and the
  flat params' draws, and ``convert.to_stage_layout`` /
  ``to_flat_layout`` move a tree between the layouts both ways;
- a 5-step trajectory with ``pp_stages = 2`` on one process, and on
  gloo worlds of (pp=2) and (dp=2, pp=2), against JAX's
  ``make_train_step`` on the same mesh (loss and grad norm each step
  within rtol 1e-4, final params within rtol 1e-4 / atol 1e-5);
- the pipeline launches the flash forward once per layer per
  micro-batch (its plain version counted on the CPU).
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu.trainer import train_step as jax_ts
from dlrover_tpu_torch.models import convert, llama
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.trainer import pipeline
from dlrover_tpu_torch.trainer import train_step as ts
from tests.test_torch_sharded_train import _batches, check_trajectory

FORWARDS = [
    pytest.param(dict(n_layers=4), 2, 2, id="dense_s2_m2"),
    pytest.param(dict(n_layers=4), 4, 4, id="dense_s4_m4"),
    pytest.param(dict(n_layers=2, n_experts=4, mlp_dim=64), 2, 2,
                 id="moe_s2_m2"),
]


def _port_cfg(jcfg):
    return llama.TpuLMConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("kw,stages,micro", FORWARDS)
def test_pipelined_forward_matches_flat_and_jax(kw, stages, micro):
    flat_j = jax_llama.tiny_config(**kw)
    pp_j = jax_llama.tiny_config(pp_stages=stages, num_microbatches=micro,
                                 **kw)
    params, _ = jax_llama.init_params(flat_j, jax.random.key(0))
    params = jax.device_get(params)
    pp_params = convert.to_stage_layout(params, stages)
    tokens = np.random.RandomState(1).randint(0, 256, (4, 16)).astype(
        np.int32)
    want, want_aux = jax_llama.forward(pp_j, pp_params, jnp.asarray(tokens))

    tok = torch.from_numpy(tokens)
    flat, flat_aux = llama.forward(
        _port_cfg(flat_j), convert.params_from_numpy(params, "cpu"), tok)
    got, aux = llama.forward(_port_cfg(pp_j), convert.params_from_numpy(
        pp_params, "cpu"), tok)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4,
                               atol=1e-6)
    if "n_experts" in kw:
        np.testing.assert_allclose(float(aux), float(flat_aux), rtol=0.2)
    else:
        assert float(aux) == float(flat_aux) == 0.0


@pytest.mark.parametrize("stages", [2, 4])
def test_stage_layout_params_and_conversion(stages):
    flat = llama.tiny_config(n_layers=4, n_experts=4)
    cfg = dataclasses.replace(flat, pp_stages=stages)
    jparams, _ = jax_llama.init_params(
        jax_llama.tiny_config(**dataclasses.asdict(cfg)), jax.random.key(0))
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    flat_params = llama.init_params(flat, torch.Generator().manual_seed(0),
                                    device="cpu")
    for name, ref in jparams["layers"].items():
        assert tuple(params["layers"][name].shape) == ref.shape, name
        assert ref.shape[:2] == (stages, 4 // stages)
    staged = convert.to_stage_layout(flat_params, stages)
    back = convert.to_flat_layout(params)
    for name in params["layers"]:
        assert torch.equal(staged["layers"][name], params["layers"][name])
        assert torch.equal(back["layers"][name],
                           flat_params["layers"][name])
    # numpy trees (the JAX package's) cross the same way.
    jflat = convert.to_flat_layout(jax.device_get(jparams))
    assert jflat["layers"]["wq"].shape == (4, 64, 4, 16)
    np.testing.assert_array_equal(
        convert.to_stage_layout(jflat, stages)["layers"]["w_up"],
        np.asarray(jparams["layers"]["w_up"]))


def test_pipeline_flash_launches_once_per_layer_and_micro(monkeypatch):
    cfg = llama.tiny_config(n_layers=4, pp_stages=2, num_microbatches=2)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    calls = []
    real = fa.flash_attention_reference

    def counting(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_reference", counting)
    tokens = torch.randint(0, 256, (4, 16), generator=torch.Generator()
                           .manual_seed(2))
    with torch.no_grad():
        pipeline.pipelined_forward(cfg, params, tokens,
                                   attention_fn=fa.make_flash_attention())
    # Bubble ticks compute nothing: 4 layers x 2 micro-batches of 2 rows.
    assert calls == [2] * 8


def _jax_one_device(jcfg, jtc, batches):
    """JAX's make_train_step on a mesh of one device: the state it starts
    from (as numpy), losses, grad norms and final params."""
    mesh = build_mesh(MeshConfig(), jax.devices()[:1])
    jopt = jax_ts.make_optimizer(jtc)
    jstate, _ = jax_ts.init_train_state(jcfg, jopt, mesh, jax.random.key(0))
    crossed = jax.device_get(jstate)
    jstep, _ = jax_ts.make_train_step(jcfg, jtc, jopt, mesh, donate=False)
    losses, norms = [], []
    for tokens in batches:
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return crossed, losses, norms, jax.device_get(jstate["params"])


def test_pp_stages_trajectory_on_one_process_matches_jax():
    jcfg = jax_llama.tiny_config(n_layers=4, pp_stages=2, num_microbatches=2)
    jtc = jax_ts.TrainConfig(learning_rate=5e-3, warmup_steps=2)
    batches = _batches(jcfg)
    crossed, losses, norms, jparams = _jax_one_device(jcfg, jtc, batches)
    cfg = _port_cfg(jcfg)
    tc = ts.TrainConfig(**dataclasses.asdict(jtc))
    opt = ts.make_optimizer(tc)
    state = convert.train_state_from_numpy(cfg, crossed, opt, device="cpu")
    step = ts.make_train_step(cfg, tc, opt, device="cpu")
    got_l, got_n = [], []
    for tokens in batches:
        state, m = step(state, {"tokens": tokens})
        got_l.append(float(m["loss"]))
        got_n.append(float(m["grad_norm"]))
    np.testing.assert_allclose(got_l, losses, rtol=1e-4)
    np.testing.assert_allclose(got_n, norms, rtol=1e-4)
    got = convert.params_to_numpy(state["params"])
    for path, want in jax.tree_util.tree_leaves_with_path(jparams):
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf, want, rtol=1e-4, atol=1e-5,
                                   err_msg=str(path))


@pytest.mark.parametrize("mesh_kw", [{"pp": 2}, {"dp": 2, "pp": 2}],
                         ids=["pp2", "dp2_pp2"])
def test_pp_trajectory_on_a_world_matches_jax(tmp_path, mesh_kw):
    check_trajectory(tmp_path, jax_llama.tiny_config(
        n_layers=4, pp_stages=2, num_microbatches=2), mesh_kw)

