"""The port's fused cross-entropy (``dlrover_tpu_torch/ops/fused_ce.py``)
against the JAX package's, on the CPU: the same numpy inputs go through
JAX's ``fused_cross_entropy`` and the port's, impl for impl. JAX's
``impl="pallas"`` runs its kernels in interpret mode on the CPU; the
port's kernel wrappers run their plain versions (the vocab-scan loops)
on CPU tensors.

Tolerances, f32: the loss within rtol 1e-5; dx and dw within rtol 1e-4,
atol 1e-6 (the same math, sums in another order). bf16 inputs: per-token
losses and logz within rtol 2e-6, dx/dw within one bf16 ulp of g's
rounding (see the bf16 tests), a tolerance that logits rounded to bf16
fail.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlrover_tpu.ops import fused_ce as jax_ce
from dlrover_tpu_torch.models.llama import cross_entropy
from dlrover_tpu_torch.ops import fused_ce

IMPLS = ["xla", "pallas", "chunked"]


def _inputs(seed, b=2, s=12, d=32, v=300):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s, d).astype(np.float32)
    w = (rs.randn(d, v) / np.sqrt(d)).astype(np.float32)
    targets = rs.randint(0, v, (b, s)).astype(np.int32)
    mask = (rs.rand(b, s) > 0.3).astype(np.int32)
    return x, w, targets, mask


def _jax_loss_and_grads(x, w, targets, mask, impl, **kw):
    def loss(x, w):
        return jax_ce.fused_cross_entropy(
            x, w, jnp.asarray(targets),
            None if mask is None else jnp.asarray(mask), impl=impl, **kw)

    val, (dx, dw) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    return float(val), np.asarray(dx), np.asarray(dw)


def _port_loss_and_grads(x, w, targets, mask, impl, **kw):
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    loss = fused_ce.fused_cross_entropy(
        tx, tw, torch.from_numpy(targets),
        None if mask is None else torch.from_numpy(mask), impl=impl, **kw)
    dx, dw = torch.autograd.grad(loss, [tx, tw])
    return float(loss.detach()), dx.numpy(), dw.numpy()


def _assert_match(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_jax(impl, masked):
    x, w, targets, mask = _inputs(0)
    mask = mask if masked else None
    want = _jax_loss_and_grads(x, w, targets, mask, impl, block_n=8,
                               block_v=128, block_rows=8)
    got = _port_loss_and_grads(x, w, targets, mask, impl, block_v=128,
                               block_rows=8)
    _assert_match(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_ragged_vocab_and_tokens_match_jax(impl):
    # V=300 is not a multiple of block_v=128 and b*s=21 not a multiple
    # of 8: the padding must be invisible on both sides.
    x, w, targets, _ = _inputs(1, b=3, s=7, d=16)
    want = _jax_loss_and_grads(x, w, targets, None, impl, block_n=8,
                               block_v=128, block_rows=8)
    got = _port_loss_and_grads(x, w, targets, None, impl, block_v=128,
                               block_rows=8)
    _assert_match(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_default_blocks_match_jax(impl):
    """Default block sizes and chunk choice (one vocab block, one chunk
    of the padded rows)."""
    x, w, targets, mask = _inputs(5, b=4, s=9, d=16, v=77)
    want = _jax_loss_and_grads(x, w, targets, mask, impl)
    got = _port_loss_and_grads(x, w, targets, mask, impl)
    _assert_match(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_zero_mask_gives_exactly_zero(impl):
    x, w, targets, mask = _inputs(2)
    loss, dx, dw = _port_loss_and_grads(x, w, targets,
                                        np.zeros_like(mask), impl)
    assert np.isfinite(loss) and loss == 0.0
    assert not dx.any() and not dw.any()


def _stats_inputs(seed, n, d, v, dtype=np.float32):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, d).astype(np.float32)
    w = (rs.randn(d, v) / np.sqrt(d)).astype(np.float32)
    tgt = rs.randint(0, v, (n,)).astype(np.int32)
    tgt[0] = v - 1  # a target in the last, ragged vocab block
    coef_a = (rs.rand(n) * 0.1).astype(np.float32)
    coef_b = (rs.rand(n) * 0.1).astype(np.float32)
    coef_a[::3] = coef_b[::3] = 0.0  # masked rows
    return x, w, tgt, coef_a, coef_b


@pytest.mark.parametrize("n,d,v", [(24, 32, 300), (16, 16, 77)])
def test_plain_kernels_match_pallas_interpret(n, d, v):
    """B3's and B4's plain versions (the wrappers on CPU tensors) against
    the TPU kernels ``_pallas_forward`` / ``_pallas_backward`` in
    interpret mode: per_tok, logz, dx and dw."""
    x, w, tgt, a, b = _stats_inputs(3, n, d, v)
    z = 1e-4
    j_ptok, j_logz = jax_ce._pallas_forward(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(tgt), z, 8, 128,
        interpret=True)
    tx, tw, tt = map(torch.from_numpy, (x, w, tgt))
    ptok, logz = fused_ce.fused_ce_forward(tx, tw, tt, z, block_v=128)
    np.testing.assert_allclose(ptok.numpy(), np.asarray(j_ptok), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(logz.numpy(), np.asarray(j_logz), rtol=1e-5,
                               atol=1e-6)
    j_dx, j_dw = jax_ce._pallas_backward(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(tgt), j_logz,
        jnp.asarray(a), jnp.asarray(b), 8, 128, interpret=True)
    stats = (torch.tensor(np.asarray(j_logz)), torch.from_numpy(a),
             torch.from_numpy(b))
    dx = fused_ce.fused_ce_backward_dx(tx, tw, tt, *stats, block_v=128)
    dw = fused_ce.fused_ce_backward_dw(tx, tw, tt, *stats, block_v=128)
    assert dx.dtype == torch.float32 and dw.dtype == torch.float32
    assert tuple(dw.shape) == (d, v)
    np.testing.assert_allclose(dx.numpy(), np.asarray(j_dx), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(j_dw), rtol=1e-4,
                               atol=1e-6)
    assert not dx.numpy()[::3].any()  # a = b = 0 rows get no gradient


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


def _bf16_logits_per_tok(x, w, tgt, z):
    """What a route that rounds its logits to bf16 would give (the trap
    the f32-logits rule avoids)."""
    logits = (x @ w).float()
    logz = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(1, tgt.long()[:, None])[:, 0]
    return logz - tl + z * logz.square(), logz


def test_bf16_plain_kernels_keep_f32_logits():
    """bf16 x and w: the plain B3/B4 against the Pallas kernels in
    interpret mode, both forming f32 logits from exact bf16 products.
    per_tok and logz agree within rtol 2e-6 (f32 sums in another order);
    logits rounded to bf16 miss that by far. dx and dw (f32 sums of the
    bf16 g) agree within rtol 1e-3 of the row's largest value: g is
    rounded to bf16 from logits that differ in the last f32 bits, so an
    element may round one bf16 ulp (2^-8) the other way."""
    n, d, v, z = 32, 64, 500, 1e-4
    x, w, tgt, a, b = _stats_inputs(4, n, d, v)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    j_ptok, j_logz = jax_ce._pallas_forward(jx, jw, jnp.asarray(tgt), z, 8,
                                            128, interpret=True)
    tx, tw, tt = _bf16(x), _bf16(w), torch.from_numpy(tgt)
    ptok, logz = fused_ce.fused_ce_forward(tx, tw, tt, z, block_v=128)
    tol = dict(rtol=2e-6, atol=0)
    np.testing.assert_allclose(ptok.numpy(), np.asarray(j_ptok), **tol)
    np.testing.assert_allclose(logz.numpy(), np.asarray(j_logz), **tol)
    bad_ptok, bad_logz = _bf16_logits_per_tok(tx, tw, tt, z)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(bad_ptok.numpy(), np.asarray(j_ptok),
                                   **tol)

    j_dx, j_dw = jax_ce._pallas_backward(
        jx, jw, jnp.asarray(tgt), j_logz, jnp.asarray(a), jnp.asarray(b),
        8, 128, interpret=True)
    stats = (torch.tensor(np.asarray(j_logz)), torch.from_numpy(a),
             torch.from_numpy(b))
    dx = fused_ce.fused_ce_backward_dx(tx, tw, tt, *stats, block_v=128)
    dw = fused_ce.fused_ce_backward_dw(tx, tw, tt, *stats, block_v=128)
    assert dx.dtype == torch.bfloat16  # x's dtype, as the TPU kernel's
    j_dx = np.asarray(j_dx.astype(jnp.float32))
    j_dw = np.asarray(j_dw)
    for got, want, axis in ((dx.float().numpy(), j_dx, 1),
                            (dw.numpy(), j_dw, 0)):
        scale = np.abs(want).max(axis=axis, keepdims=True) + 1e-30
        assert (np.abs(got - want) / scale).max() <= 1e-3


@pytest.mark.parametrize("masked", [False, True])
def test_bf16_chunked_matches_jax(masked):
    """bf16 x and w through the chunked route: the loss and each token's
    loss within rtol 2e-6 (a bf16 logits tile misses it), dx (bf16) and
    dw in w's dtype (bf16,
    the residual's cast) within one bf16 ulp (rtol 2^-7) plus an atol of
    1e-3 of the largest value (g elements rounding the other way)."""
    x, w, targets, mask = _inputs(6, b=2, s=16, d=64, v=500)
    mask = mask if masked else None
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jw = jnp.asarray(w).astype(jnp.bfloat16)

    def jloss(x, w):
        return jax_ce.fused_cross_entropy(
            x, w, jnp.asarray(targets),
            None if mask is None else jnp.asarray(mask), impl="chunked")

    want, (j_dx, j_dw) = jax.value_and_grad(jloss, argnums=(0, 1))(jx, jw)
    tx = _bf16(x).requires_grad_(True)
    tw = _bf16(w).requires_grad_(True)
    tm = None if mask is None else torch.from_numpy(mask)
    loss = fused_ce.fused_cross_entropy(tx, tw, torch.from_numpy(targets),
                                        tm, impl="chunked")
    dx, dw = torch.autograd.grad(loss, [tx, tw])
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=2e-6)
    logits = (tx.detach().reshape(-1, 64) @ tw.detach()).float()
    bad = cross_entropy(logits, torch.from_numpy(targets).reshape(-1),
                              None if tm is None else tm.reshape(-1))
    assert abs(float(bad) - float(want)) > 2e-6 * abs(float(want))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.bfloat16
    # Per token: the loss-only sweep with one-hot weights on both sides.
    n = targets.size
    eye = np.eye(n, dtype=np.float32)
    j_tok = jax.vmap(lambda wgt: jax_ce._chunked_loss_only(
        jx.reshape(n, 64), jw, jnp.asarray(targets).reshape(n), wgt, 1e-4,
        8))(jnp.asarray(eye))
    t_tok = [float(fused_ce._chunked_loss_only(
        tx.detach().reshape(n, 64), tw.detach(),
        torch.from_numpy(targets).reshape(n).long(), torch.from_numpy(row),
        1e-4, 8)) for row in eye]
    np.testing.assert_allclose(t_tok, np.asarray(j_tok), rtol=2e-6)
    for got, want_g in ((dx, j_dx), (dw, j_dw)):
        want_f = np.asarray(want_g.astype(jnp.float32))
        np.testing.assert_allclose(
            got.float().numpy(), want_f, rtol=2.0 ** -7,
            atol=1e-3 * np.abs(want_f).max())


def test_chunked_without_grad_computes_the_loss_only(monkeypatch):
    """Under ``torch.no_grad`` (the eval step) the chunked route runs the
    loss alone, as the reference's primal does, and builds no dw."""
    x, w, targets, mask = _inputs(7)

    def no_sweep(*a, **k):
        raise AssertionError("the gradient sweep ran under no_grad")

    with_grad = _port_loss_and_grads(x, w, targets, mask, "chunked")[0]
    monkeypatch.setattr(fused_ce, "_chunked_fwd_pass", no_sweep)
    tx = torch.tensor(x, requires_grad=True)
    with torch.no_grad():
        loss = fused_ce.fused_cross_entropy(
            tx, torch.from_numpy(w), torch.from_numpy(targets),
            torch.from_numpy(mask), impl="chunked")
    np.testing.assert_allclose(float(loss), with_grad, rtol=1e-6)


@pytest.mark.parametrize("n,v,block_rows", [
    (16384, 32000, None), (8200, 32000, None), (21, 300, 8),
    (32768, 32000, 4096), (8, 256, None), (100000, 50000, None),
    (5, 300, None),
])
def test_pick_chunk_matches_jax(n, v, block_rows):
    assert fused_ce._pick_chunk(n, v, block_rows) == jax_ce._pick_chunk(
        n, v, block_rows)


def test_resolve_impl_matches_jax_without_a_mesh():
    for impl in (None, "xla", "pallas", "chunked"):
        assert fused_ce.resolve_impl(impl) == jax_ce.resolve_impl(impl)
    with pytest.raises(ValueError, match="impl"):
        fused_ce.fused_cross_entropy(torch.zeros(8, 4), torch.zeros(4, 3),
                                     torch.zeros(8, dtype=torch.int32),
                                     impl="dense")


def test_cpu_wrappers_launch_nothing_and_other_devices_raise():
    x, w, tgt, a, b = _stats_inputs(8, 8, 16, 40)
    tx, tw, tt = map(torch.from_numpy, (x, w, tgt))
    fused_ce.reset_launch_counts()
    _, logz = fused_ce.fused_ce_forward(tx, tw, tt, 1e-4)
    stats = (logz, torch.from_numpy(a), torch.from_numpy(b))
    fused_ce.fused_ce_backward_dx(tx, tw, tt, *stats)
    fused_ce.fused_ce_backward_dw(tx, tw, tt, *stats)
    assert set(fused_ce.launch_counts.values()) == {0}
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_ce.fused_ce_forward(tx.to("meta"), tw.to("meta"),
                                  tt.to("meta"), 1e-4)


def test_auto_crossover_matches_jax():
    assert fused_ce.AUTO_FUSED_MIN_NV == jax_ce.AUTO_FUSED_MIN_NV
    for n, v in ((16384, 32000), (32768, 32000), (2 ** 24, 32), (8, 256)):
        assert fused_ce.auto_prefers_dense(n, v) == \
            jax_ce.auto_prefers_dense(n, v)
