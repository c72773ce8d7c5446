"""The MoE TpuLM, port against the JAX package, on ``tiny_config`` with 4
experts, top-2, dropless and gshard: JAX params cross with
``convert.params_from_numpy`` and the same numpy tokens go through both.
JAX's dropless path runs its Pallas grouped-FFN kernel in interpret
mode; the port's runs the plain versions of B7/B8 on the CPU.

Tolerances (f32), as ``test_torch_train.py``: logits and loss within
2e-5 / rtol 1e-5 (the same math, sums in another order); every param
gradient within 1e-5 + 1e-4 * |g|; the 5-step trajectory's loss and
grad_norm within rtol 1e-4 and the final params within 1e-6 on average,
all but 0.1% of elements within 2e-5 and the rest within one step's lr
(Adam moves an element whose gradient is rounding noise by up to lr).
Greedy tokens, from ``generate()`` and from the flat serving engines,
must be equal: dropless routing is per token, and at these widths no
router near-tie sits inside f32 rounding.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlrover_tpu.models import generate as jax_gen
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu.serving.engine import ServingEngine as JaxServingEngine
from dlrover_tpu.trainer import train_step as jax_ts
from dlrover_tpu_torch.models import convert, generate, llama
from dlrover_tpu_torch.serving import PagedServingEngine, ServingEngine
from dlrover_tpu_torch.trainer import train_step as ts

_IMPLS = ("dropless", "gshard")


def _kw(impl):
    return dict(n_layers=2, n_experts=4, moe_top_k=2, moe_impl=impl)


@pytest.fixture(scope="module", params=_IMPLS)
def moe(request):
    """(impl, jax config, jax params as numpy, port config, port params)."""
    jcfg = jax_llama.tiny_config(**_kw(request.param))
    jparams, _ = jax_llama.init_params(jcfg, jax.random.key(0))
    jparams = jax.device_get(jparams)
    cfg = llama.TpuLMConfig(**dataclasses.asdict(jcfg))
    return (request.param, jcfg, jparams, cfg,
            convert.params_from_numpy(jparams, "cpu"))


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.int32)


def test_config_counts_and_init_layout_match_jax(moe):
    impl, jcfg, jparams, cfg, _ = moe
    assert cfg.count_params() == jcfg.count_params()
    assert cfg.count_active_params() == jcfg.count_active_params()
    assert cfg.count_active_params() < cfg.count_params()
    assert llama._moe_resolve_impl(cfg) == impl
    own = llama.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    for name, ref in jparams["layers"].items():
        assert tuple(own["layers"][name].shape) == ref.shape, name
        assert own["layers"][name].dtype == torch.float32
    assert set(own["layers"]) == set(jparams["layers"])


def test_moe_leaves_cross_both_ways_bit_for_bit(moe):
    _, _, jparams, _, params = moe
    back = convert.params_to_numpy(params)
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(back["layers"][name],
                                      jparams["layers"][name])


def test_logits_loss_and_every_grad_match_jax(moe):
    _, jcfg, jparams, cfg, params = moe
    toks = _tokens(3, (2, 17))
    want_logits, want_aux = jax_llama.forward(jcfg, jparams,
                                              jnp.asarray(toks[:, :-1]))
    (want_loss, _), want_grads = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jparams)

    with torch.no_grad():
        logits, aux = llama.forward(cfg, params,
                                    torch.from_numpy(toks[:, :-1]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert float(aux) > 0
    leaves = ts.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = llama.loss_fn(cfg, params, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5, atol=2e-5)
    want = {".".join(k.key for k in path): np.asarray(w) for path, w in
            jax.tree_util.tree_leaves_with_path(jax.device_get(want_grads))}
    assert len(want) == len(grads) == 13
    for name, g in zip(_leaf_names(params), grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def _leaf_names(tree, prefix=""):
    """Dotted names of ``train_step.param_leaves(tree)``, in its order."""
    names = []
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            names += _leaf_names(tree[key], f"{prefix}{key}.")
        else:
            names.append(prefix + key)
    return names


def test_train_trajectory_matches_jax(moe):
    """5 steps of make_train_step on both sides from the same params and
    batch (grad_accum 2)."""
    _, jcfg, jparams, cfg, _ = moe
    jtc = jax_ts.TrainConfig(learning_rate=5e-3, warmup_steps=2,
                             grad_accum=2)
    mesh = build_mesh(MeshConfig(dp=1), jax.devices()[:1])
    jopt = jax_ts.make_optimizer(jtc)
    jstate, _ = jax_ts.init_train_state(jcfg, jopt, mesh, jax.random.key(0))
    params = convert.params_from_numpy(jax.device_get(jstate["params"]),
                                       "cpu")
    jstep, _ = jax_ts.make_train_step(jcfg, jtc, jopt, mesh)
    tc = ts.TrainConfig(**dataclasses.asdict(jtc))
    opt = ts.make_optimizer(tc)
    state = ts.init_train_state(cfg, opt, params)
    step = ts.make_train_step(cfg, tc, opt, device="cpu")

    toks = _tokens(9, (4, 17))
    losses = []
    for i in range(5):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": toks})
        assert m["step"] == int(jm["step"]) == i + 1
        losses.append(float(m["loss"]))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert losses[-1] < losses[0]
    want = jax.tree_util.tree_leaves_with_path(
        jax.device_get(jstate["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.params_to_numpy(state["params"])))
    for path, w in want:
        diff = np.abs(got[path] - w)
        assert diff.mean() <= 1e-6, (path, diff.mean())
        assert np.mean(diff > 2e-5) <= 1e-3, (path, np.mean(diff > 2e-5))
        assert diff.max() <= tc.learning_rate, (path, diff.max())


def test_greedy_generate_tokens_match_jax(moe):
    _, jcfg, jparams, cfg, params = moe
    prompt = _tokens(4, (2, 6))
    want = jax_gen.generate(jcfg, jparams, jnp.asarray(prompt),
                            max_new_tokens=6).tokens
    got = generate.generate(cfg, params, prompt, 6, device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want))


def test_flat_engine_tokens_match_jax_engine(moe):
    _, jcfg, jparams, cfg, params = moe
    kw = dict(slots=2, max_len=32, prefill_chunk=8)
    jeng = JaxServingEngine(jcfg, jparams, **kw)
    eng = ServingEngine(cfg, params, device="cpu", **kw)
    rs = np.random.RandomState(5)
    work = [(rs.randint(0, 256, n).astype(np.int32), int(k))
            for n, k in ((5, 4), (11, 3), (3, 5))]
    want = [jeng.submit(p, k) for p, k in work]
    got = [eng.submit(p, k) for p, k in work]
    jeng.run_until_idle()
    eng.run_until_idle()
    for g, w in zip(got, want):
        assert g.state == "done" and len(g.tokens) == len(w.tokens)
        assert g.tokens == w.tokens


def test_paged_engine_refuses_moe(moe):
    _, _, _, cfg, params = moe
    with pytest.raises(NotImplementedError, match="MoE"):
        PagedServingEngine(cfg, params, slots=1, max_len=32, prefill_chunk=8,
                           block_size=8, device="cpu")
