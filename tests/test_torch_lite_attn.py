"""The lite attention block (``llama._AttnBlockLite``), which the
``attn_save`` remat policy runs with the plain flash op: its loss and
every gradient against the JAX package's ``attn_save`` through its lite
block (``make_flash_attention()``, Pallas in interpret mode) and against
the port's own escape (a flash attention function without
``is_plain_flash``), f32 on the tiny config, within rtol 1e-4 / atol
1e-5 as ``tests/test_torch_train.py`` holds gradients; what it saves for
the backward (x, out and lse, not q/k/v); and that the flash forward
runs once a layer a step (its plain version counted on the CPU)."""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.ops.pallas_attention import make_flash_attention as jax_flash
from dlrover_tpu_torch.models import convert, llama
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.trainer import train_step as ts

B, S = 2, 32


def _cfgs(**kw):
    jcfg = jax_llama.tiny_config(n_layers=2, remat_policy="attn_save", **kw)
    return jcfg, llama.TpuLMConfig(**dataclasses.asdict(jcfg))


def _escape():
    """The flash op without ``is_plain_flash``: attn_save keeps the
    escape (q/k/v/out/lse saved, flanks recomputed)."""
    def attention_fn(q, k, v, causal=True, q_positions=None,
                     kv_positions=None, softmax_scale=None):
        return fa.flash_attention(q, k, v, causal, softmax_scale)

    attention_fn.saveable_residuals = True
    return attention_fn


def _tokens():
    return np.random.RandomState(9).randint(0, 256, (B, S + 1)).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_side():
    jcfg, _ = _cfgs()
    params, _ = jax_llama.init_params(jcfg, jax.random.key(0))
    flash = jax_flash()
    assert flash.is_plain_flash
    batch = {"tokens": jnp.asarray(_tokens())}
    (loss, _), grads = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(jcfg, p, batch, flash), has_aux=True)(
            params)
    return jax.device_get(params), float(loss), jax.device_get(grads)


def _port(params_np, attention_fn, cfg=None):
    cfg = cfg or _cfgs()[1]
    params = convert.params_from_numpy(params_np, "cpu")
    leaves = ts.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = llama.loss_fn(cfg, params, {
        "tokens": torch.from_numpy(_tokens())}, attention_fn)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), dict(zip(
        _leaf_paths(params_np), (g.numpy() for g in grads)))


def _leaf_paths(tree, prefix=()):
    """Leaf paths in ``train_step.param_leaves`` order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.extend(_leaf_paths(tree[k], prefix + (k,)))
        else:
            out.append(prefix + (k,))
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("against", ["jax_lite", "port_escape"])
def test_lite_block_grads(jax_side, against):
    params_np, jax_loss, jax_grads = jax_side
    loss, grads = _port(params_np, fa.make_flash_attention())
    if against == "jax_lite":
        want_loss = jax_loss
        want = {p: _get(jax_grads, p) for p in grads}
    else:
        want_loss, want = _port(params_np, _escape())
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert len(grads) == 12
    for path, g in grads.items():
        np.testing.assert_allclose(g, want[path], rtol=1e-4, atol=1e-5,
                                   err_msg=str(path))


def _saved_shapes(params_np, attention_fn):
    """Shapes of the distinct tensors (by storage) saved outside
    checkpointed regions during one forward: the tensors themselves,
    and the inputs of the checkpointed flanks (the attention output and
    the residual, which the lite block saves too)."""
    _, cfg = _cfgs()
    params = convert.params_from_numpy(params_np, "cpu")
    for p in ts.param_leaves(params):
        p.requires_grad_(True)
    shapes = {}

    def pack(t):
        shapes[t.untyped_storage().data_ptr()] = tuple(t.shape)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        llama.loss_fn(cfg, params, {"tokens": torch.from_numpy(_tokens())},
                      attention_fn)
    return list(shapes.values())


def test_lite_block_saves_x_out_lse_not_qkv(jax_side):
    _, cfg = _cfgs()
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lite = _saved_shapes(jax_side[0], fa.make_flash_attention())
    escape = _saved_shapes(jax_side[0], _escape())
    per_layer = {
        "q_or_out": (B, S, h, hd), "kv": (B, S, kh, hd),
        "x": (B, S, cfg.embed_dim), "lse": (B, h, S)}
    count = {name: [shapes.count(shape) for shapes in (lite, escape)]
             for name, shape in per_layer.items()}
    L = cfg.n_layers
    # The escape saves q, k, v, out and lse; the lite block x, out, lse.
    assert count["q_or_out"] == [L, 2 * L], count
    assert count["kv"] == [0, 2 * L], count
    assert count["lse"] == [L, L], count
    assert count["x"][0] == count["x"][1] >= L, count


def test_lite_block_runs_the_flash_forward_once_a_layer(jax_side,
                                                        monkeypatch):
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_attention_reference, fa._plain_backward

    def counting_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def counting_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_reference", counting_fwd)
    monkeypatch.setattr(fa, "_plain_backward", counting_bwd)
    _port(jax_side[0], fa.make_flash_attention())
    L = _cfgs()[1].n_layers
    # B1 once a layer (never re-run in the backward); B2's dq and dk/dv
    # halves once each a layer.
    assert calls == {"fwd": L, "bwd": 2 * L}, calls
