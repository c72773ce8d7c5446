"""The port's TpuLM against the JAX package's on ``tiny_config``: JAX
params (made by ``dlrover_tpu.models.llama.init_params``) cross with
``params_from_numpy``, the same tokens go through both forwards.

Tolerances: f32 logits within 2e-5 (same math, sums in another order);
bf16 logits within 0.1 absolute at |logits| < 4, where one bf16 ulp is
1/64: both frameworks round every matmul output and the residual stream
to bf16, at slightly different places."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models import llama


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_llama.tiny_config()
    params, _ = jax_llama.init_params(cfg, jax.random.key(0))
    return jax.device_get(params)


def _tokens(seed=0, shape=(2, 12)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.int32
    )


def test_config_mirrors_reference_fields():
    ref = jax_llama.tiny_config(dtype="bfloat16")
    cfg = llama.TpuLMConfig(**dataclasses.asdict(ref))
    assert cfg == llama.tiny_config(dtype="bfloat16")
    assert cfg.count_params() == ref.count_params()
    flagship = dict(vocab_size=32000, embed_dim=1024, n_layers=16,
                    n_heads=8, n_kv_heads=8, head_dim=128, mlp_dim=4096)
    assert llama.TpuLMConfig(**flagship).count_params() == (
        jax_llama.TpuLMConfig(**flagship).count_params()
    )


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 0.1)])
def test_forward_logits_match_jax(jax_params, dtype, atol):
    toks = _tokens()
    want, _ = jax_llama.forward(
        jax_llama.tiny_config(dtype=dtype), jax_params, jnp.asarray(toks)
    )
    params = convert.params_from_numpy(jax_params, "cpu")
    got, aux = llama.forward(
        llama.tiny_config(dtype=dtype), params, torch.from_numpy(toks)
    )
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=0, atol=atol
    )


def test_forward_with_explicit_positions_matches_jax(jax_params):
    toks = _tokens(1, (1, 6))
    pos = np.arange(10, 16, dtype=np.int32)[None]
    cfg = jax_llama.tiny_config()
    want, _ = jax_llama.forward(
        cfg, jax_params, jnp.asarray(toks), positions=jnp.asarray(pos)
    )
    got, _ = llama.forward(
        llama.tiny_config(), convert.params_from_numpy(jax_params, "cpu"),
        torch.from_numpy(toks), positions=torch.from_numpy(pos),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_param_round_trip_is_bit_exact(jax_params):
    """f32 and bf16 leaves cross numpy -> torch -> numpy unchanged, with
    the reference's leaf names and stacked [L, ...] shapes."""
    bf16 = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), jax_params
    )
    for tree in (jax_params, bf16):
        params = convert.params_from_numpy(tree, "cpu")
        assert set(params["layers"]) == set(tree["layers"])
        back = convert.params_to_numpy(params)
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        for path, a in flat_a:
            b = flat_b[path]
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(
                a.view(np.uint8), b.view(np.uint8)
            )
    params = convert.params_from_numpy(bf16, "cpu")
    assert params["layers"]["wq"].dtype == torch.bfloat16
    assert params["layers"]["wq"].shape == (4, 64, 4, 16)


def test_port_init_params_layout_matches_reference(jax_params):
    params = llama.init_params(
        llama.tiny_config(), torch.Generator().manual_seed(0), device="cpu"
    )
    for name, ref in jax_params["layers"].items():
        assert tuple(params["layers"][name].shape) == ref.shape, name
    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(params[name].shape) == jax_params[name].shape


@pytest.mark.parametrize("override", [dict(n_experts=4),
                                      dict(pp_stages=2)])
def test_moe_and_pipeline_raise_until_ported(override):
    """MoE layers and pipeline stages are both ported: their params build
    (the router included) in JAX's shapes, pipeline stages in the
    ``[stages, layers_per_stage, ...]`` layout."""
    cfg = llama.tiny_config(**override)
    jparams, _ = jax_llama.init_params(
        jax_llama.tiny_config(**override), jax.random.key(0))
    layers = llama.init_params(cfg, device="cpu")["layers"]
    assert set(layers) == set(jparams["layers"])
    for name, ref in jparams["layers"].items():
        assert tuple(layers[name].shape) == ref.shape, name
    if cfg.pp_stages > 1:
        assert layers["wq"].shape == (2, 2, 64, 4, 16)
    else:
        assert layers["router"].shape == (4, 64, 4)
        assert layers["w_gate"].shape == (4, 4, 64, 128)
