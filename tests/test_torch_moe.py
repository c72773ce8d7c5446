"""The port's MoE layer (``models/moe.py``) against the JAX package's:
the same numpy activations and weights go through ``moe_mlp`` (gshard)
and ``moe_mlp_dropless`` on both sides. JAX's dropless path runs its
Pallas kernel and megablox ``gmm`` in interpret mode; the port's
"fused" route runs the plain versions of B7/B8 on the CPU and its "gmm"
route a per-expert matmul loop.

Tolerances (f32): outputs and every gradient within 1e-5 + 1e-4 * |ref|
(the same products, f32 sums in another order); router metrics within
rtol 1e-6; ``dropped_fraction`` exactly equal (it counts tokens).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlrover_tpu.models import moe as jax_moe
from dlrover_tpu_torch.models import moe


def _inputs(seed=0, b=2, s=12, d=16, f=32, e=4):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s, d).astype(np.float32)
    router = rs.randn(d, e).astype(np.float32)
    w_gate = (rs.randn(e, d, f) / np.sqrt(d)).astype(np.float32)
    w_up = (rs.randn(e, d, f) / np.sqrt(d)).astype(np.float32)
    w_down = (rs.randn(e, f, d) / np.sqrt(f)).astype(np.float32)
    dy = rs.randn(b, s, d).astype(np.float32)
    return (x, router, w_gate, w_up, w_down), dy


def _jax_run(fn, args, dy):
    """JAX output, metrics and the VJP of every input at ``dy``."""
    out, vjp, metrics = jax.vjp(fn, *(jnp.asarray(a) for a in args),
                                has_aux=True)
    grads = vjp(jnp.asarray(dy))
    return (np.asarray(out), [np.asarray(g) for g in grads],
            {k: float(v) for k, v in metrics._asdict().items()})


def _port_run(fn, args, dy):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out, metrics = fn(*leaves)
    out.backward(torch.from_numpy(dy))
    return (out.detach().numpy(), [t.grad.numpy() for t in leaves],
            {k: float(v.detach()) for k, v in metrics._asdict().items()})


_NAMES = ("x", "router", "w_gate", "w_up", "w_down")

# JAX results per configuration, computed once for the module (each
# interpret-mode compile costs seconds).
_CONFIGS = {
    "gshard_cap1.25": (
        lambda j: (lambda *a: j.moe_mlp(*a, top_k=2, capacity_factor=1.25)),
        {}),
    "gshard_cap100": (
        lambda j: (lambda *a: j.moe_mlp(*a, top_k=2, capacity_factor=100.0)),
        {}),
    "dropless_fused": (
        lambda j: (lambda *a: j.moe_mlp_dropless(*a, top_k=2,
                                                 dispatch="fused")),
        {}),
    "dropless_gmm": (
        lambda j: (lambda *a: j.moe_mlp_dropless(*a, top_k=2,
                                                 dispatch="gmm")),
        {}),
    "dropless_top1": (
        lambda j: (lambda *a: j.moe_mlp_dropless(*a, top_k=1,
                                                 dispatch="fused")),
        {}),
}


@pytest.fixture(scope="module")
def jax_results():
    args, dy = _inputs()
    return {name: _jax_run(make(jax_moe), args, dy)
            for name, (make, _) in _CONFIGS.items()}


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_outputs_grads_and_metrics_match_jax(jax_results, name):
    args, dy = _inputs()
    want_out, want_grads, want_metrics = jax_results[name]
    got_out, got_grads, got_metrics = _port_run(
        _CONFIGS[name][0](moe), args, dy)
    np.testing.assert_allclose(got_out, want_out, rtol=1e-4, atol=1e-5)
    for leaf, g, w in zip(_NAMES, got_grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=leaf)
    assert got_metrics["dropped_fraction"] == want_metrics["dropped_fraction"]
    for key in ("aux_loss", "router_z_loss"):
        np.testing.assert_allclose(got_metrics[key], want_metrics[key],
                                   rtol=1e-6, err_msg=key)
    if name == "gshard_cap1.25":
        assert got_metrics["dropped_fraction"] > 0   # the case drops
    if name == "gshard_cap100":
        assert got_metrics["dropped_fraction"] == 0.0


def test_gshard_at_ample_capacity_equals_dropless():
    args, _ = _inputs(seed=5)
    t = [torch.from_numpy(a) for a in args]
    gshard, _ = moe.moe_mlp(*t, top_k=2, capacity_factor=100.0)
    dropless, _ = moe.moe_mlp_dropless(*t, top_k=2)
    torch.testing.assert_close(gshard, dropless, rtol=1e-5, atol=1e-6)


def test_top_k_puts_the_lower_index_first_on_ties():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 2)
    got_v, got_i = moe._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("value,want", [
    (None, "fused"), ("fused", "fused"), ("gmm", "gmm"), ("GMM", "gmm"),
    ("not-a-dispatch", "fused"),
])
def test_dispatch_impl_resolves_as_jax(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("DLROVER_TPU_MOE_DISPATCH", raising=False)
    else:
        monkeypatch.setenv("DLROVER_TPU_MOE_DISPATCH", value)
    assert jax_moe._dispatch_impl() == want
    assert moe._dispatch_impl() == want


def test_dispatch_typo_warns_once(monkeypatch):
    from dlrover_tpu_torch.common import env_utils
    from dlrover_tpu_torch.common.log import logger

    warned = []
    monkeypatch.setattr(env_utils, "_WARNED_CHOICES", set())
    monkeypatch.setattr(logger, "warning", lambda *a: warned.append(a))
    monkeypatch.setenv("DLROVER_TPU_MOE_DISPATCH", "fuzed")
    assert moe._dispatch_impl() == "fused"
    assert moe._dispatch_impl() == "fused"
    assert len(warned) == 1 and "DLROVER_TPU_MOE_DISPATCH" in warned[0]


@pytest.mark.parametrize("seq,e,k,cf", [(12, 4, 2, 1.25), (1, 8, 2, 1.25),
                                        (2048, 8, 2, 2.0)])
def test_expert_capacity_matches_jax(seq, e, k, cf):
    assert moe.expert_capacity(seq, e, k, cf) == jax_moe.expert_capacity(
        seq, e, k, cf)
