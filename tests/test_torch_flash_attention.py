"""The port's flash attention (plain versions of kernels B1/B2, which
its wrappers run on CPU tensors) against the JAX package's Pallas
kernels in interpret mode, on the same numpy inputs.

Tolerances: f32 outputs and lse within 2e-5 (the cases and tolerance of
``tests/test_pallas_attention.py``); f32 gradients within 5e-5; bf16
outputs within 2e-2 absolute at |out| < 4 and bf16 gradients within
2e-2 * max|ref|: both sides round P and dS to bf16 from f32 values
summed in another order, so a few elements round one bf16 ulp apart.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from dlrover_tpu.ops import pallas_attention as pa
from dlrover_tpu_torch.ops import flash_attention as fa

CASES = [(4, 4, 16), (4, 2, 16), (4, 4, 128), (4, 2, 128), (1, 1, 16)]


def _inputs(seed, b, s, h, kh, d, dtype=np.float32):
    rs = np.random.RandomState(seed)
    shapes = [(b, s, h, d), (b, s, kh, d), (b, s, kh, d), (b, s, h, d)]
    return [rs.randn(*sh).astype(np.float32).astype(dtype) for sh in shapes]


def _t(a):
    """numpy (f32 or ml_dtypes bf16) -> torch, bit for bit."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    return t.detach().float().numpy()


def _jax_forward(q, k, v, causal):
    out, lse = pa._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, None, True)
    b, s, h, _ = q.shape
    return out, lse[:, :, 0].reshape(b, h, s)


def _jax_backward(q, k, v, do, out, lse_bhs, causal):
    b, s, h, _ = q.shape
    lse = jnp.broadcast_to(jnp.asarray(lse_bhs).reshape(b * h, s, 1),
                           (b * h, s, pa.LANES))
    di = pa.flash_backward_delta(jnp.asarray(do), out)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    grads = pa.flash_backward_T(tr(q), tr(k), tr(v), tr(do), lse, di,
                                causal, None, True)
    return [np.asarray(g.transpose(0, 2, 1, 3).astype(jnp.float32))
            for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kh,d", CASES)
def test_forward_matches_jax_kernel(causal, h, kh, d):
    q, k, v, _ = _inputs(0, 2, 64, h, kh, d)
    want_out, want_lse = _jax_forward(q, k, v, causal)
    out, lse = fa.flash_attention_reference(_t(q), _t(k), _t(v), causal)
    assert out.dtype == torch.float32 and lse.shape == (2, h, 64)
    np.testing.assert_allclose(_np(out), np.asarray(want_out), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(_np(lse), np.asarray(want_lse), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kh,d", CASES)
def test_backward_matches_jax_kernel(causal, h, kh, d):
    """Same q, k, v, out, lse and delta into both backward kernels."""
    q, k, v, do = _inputs(1, 2, 64, h, kh, d)
    out, lse = _jax_forward(q, k, v, causal)
    want = _jax_backward(q, k, v, do, out, lse, causal)
    got = fa.flash_backward_reference(
        _t(q), _t(k), _t(v), _t(np.asarray(out)), _t(np.asarray(lse)),
        _t(do), causal,
    )
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(g), w, rtol=5e-5, atol=5e-5,
                                   err_msg=name)
    # The CPU wrappers take the same plain path, from a precomputed delta.
    delta = fa.flash_backward_delta(_t(do), _t(np.asarray(out)))
    dq = fa.flash_backward_dq(_t(q), _t(k), _t(v), _t(do),
                              _t(np.asarray(lse)), delta, causal)
    dk, dv = fa.flash_backward_dkv(_t(q), _t(k), _t(v), _t(do),
                                   _t(np.asarray(lse)), delta, causal)
    for g, w in zip((dq, dk, dv), got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("h,kh,d", [(4, 2, 8), (4, 4, 16)])
def test_autograd_matches_jax_grad(h, kh, d):
    """torch.autograd through ``flash_attention`` against jax.grad
    through the Pallas op's custom VJP, on sum(out^2)."""
    q, k, v, _ = _inputs(2, 1, 32, h, kh, d)
    flash = pa.make_flash_attention(interpret=True)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jnp.square(flash(q, k, v))),
        argnums=(0, 1, 2),
    )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    fa.flash_attention(*leaves).square().sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), rtol=5e-5,
                                   atol=5e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_matches_jax_kernel(causal):
    q, k, v, do = _inputs(3, 2, 64, 4, 2, 128, ml_dtypes.bfloat16)
    want_out, want_lse = _jax_forward(q, k, v, causal)
    out, lse = fa.flash_attention_reference(_t(q), _t(k), _t(v), causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        _np(out), np.asarray(want_out.astype(jnp.float32)), rtol=0,
        atol=2e-2,
    )
    np.testing.assert_allclose(_np(lse), np.asarray(want_lse), rtol=1e-5,
                               atol=1e-5)
    want = _jax_backward(q, k, v, do, want_out, want_lse, causal)
    got = fa.flash_backward_reference(
        _t(q), _t(k), _t(v), _t(np.asarray(want_out)),
        _t(np.asarray(want_lse)), _t(do), causal,
    )
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        err = np.abs(_np(g) - w).max()
        assert err <= 2e-2 * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_matches_plain_attention(causal):
    """s = 72 is not a multiple of the kernels' 64-row tiles (the JAX
    kernel would pick a block of 8 for it): the plain flash and the
    port's plain attention op agree."""
    from dlrover_tpu_torch.ops.attention import dot_product_attention

    q, k, v, do = (_t(a) for a in _inputs(4, 2, 72, 4, 2, 16))
    out, lse = fa.flash_attention_reference(q, k, v, causal)
    want = dot_product_attention(q, k, v, causal=causal)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    jo, jl = _jax_forward(*(a.numpy() for a in (q, k, v)), causal)
    np.testing.assert_allclose(_np(lse), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    dot_product_attention(*leaves, causal=causal).backward(do)
    got = fa.flash_backward_reference(q, k, v, out, lse, do, causal)
    for g, t in zip(got, leaves):
        torch.testing.assert_close(g, t.grad, rtol=5e-5, atol=5e-5)


def test_cpu_tensors_launch_nothing():
    fa.reset_launch_counts()
    q, k, v, do = (_t(a).requires_grad_(i < 3) for i, a in
                   enumerate(_inputs(5, 1, 16, 2, 1, 16)))
    fa.flash_attention(q, k, v).backward(do)
    fa.flash_forward(q.detach(), k.detach(), v.detach())
    assert fa.launch_counts == {
        "flash_forward": 0, "flash_backward_dq": 0, "flash_backward_dkv": 0,
    }


def test_other_devices_raise():
    q = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_forward(q, q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_backward_dq(q, q, q, q, q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_backward_dkv(q, q, q, q, q, q)


def test_attention_fn_declares_saveable_residuals():
    fn = fa.make_flash_attention()
    assert fn.saveable_residuals and fn.is_plain_flash
    q, k, v, _ = (_t(a) for a in _inputs(6, 1, 16, 2, 2, 16))
    pos = torch.arange(16)[None] + 100   # positions are ignored
    torch.testing.assert_close(
        fn(q, k, v, causal=True, q_positions=pos, kv_positions=pos),
        fa.flash_attention(q, k, v), rtol=0, atol=0,
    )


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_forward_matches_jax_kernel_head_dims(causal, d):
    """B1 takes any head dim that is a multiple of 16 up to 128 (the
    kernel computes d <= 64 at 64 and the rest at 128, its tensor maps
    zero-filling the columns past d): the plain version at the widths
    between the ones above."""
    q, k, v, _ = _inputs(7, 2, 64, 4, 2, d)
    want_out, want_lse = _jax_forward(q, k, v, causal)
    out, lse = fa.flash_attention_reference(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(_np(out), np.asarray(want_out), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(_np(lse), np.asarray(want_lse), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("sq,skv", [(1, 1), (1, 77), (40, 72), (72, 40)])
@pytest.mark.parametrize("causal", [True, False])
def test_uneven_lengths_match_numpy(sq, skv, causal):
    """seq_q != seq_k: rows and columns both count from 0, so row i sees
    keys j <= i (every row sees key 0); numpy in float64 as the yardstick."""
    rs = np.random.RandomState(sq * 100 + skv)
    q = rs.randn(2, sq, 4, 32).astype(np.float32)
    k = rs.randn(2, skv, 2, 32).astype(np.float32)
    v = rs.randn(2, skv, 2, 32).astype(np.float32)
    out, lse = fa.flash_attention_reference(_t(q), _t(k), _t(v), causal)
    kk = np.repeat(k, 2, axis=2).astype(np.float64)
    vv = np.repeat(v, 2, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / np.sqrt(32)
    if causal:
        s = np.where(np.arange(sq)[:, None] >= np.arange(skv)[None, :], s,
                     -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    want = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), vv)
    np.testing.assert_allclose(_np(out), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        _np(lse), (m[..., 0] + np.log(p.sum(-1))), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sq,skv", [(1, 1), (1, 77), (100, 192),
                                    (129, 129), (200, 130), (130, 200)])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_uneven_lengths_match_numpy(sq, skv, causal):
    """B2's plain version (what the dq and dk/dv kernels are held to on
    the card) at lengths on and across the kernels' 64- and 128-row tile
    edges, seq_q != seq_k both ways, GQA (h=4, kh=2): dq, dk and dv
    against numpy's gradients of the same attention in float64."""
    rs = np.random.RandomState(sq * 1000 + skv)
    b, h, kh, d = 2, 4, 2, 32
    q = rs.randn(b, sq, h, d).astype(np.float32)
    k = rs.randn(b, skv, kh, d).astype(np.float32)
    v = rs.randn(b, skv, kh, d).astype(np.float32)
    do = rs.randn(b, sq, h, d).astype(np.float32)
    out, lse = fa.flash_attention_reference(_t(q), _t(k), _t(v), causal)
    dq, dk, dv = fa.flash_backward_reference(_t(q), _t(k), _t(v), out, lse,
                                             _t(do), causal)
    f64 = lambda a: a.astype(np.float64)  # noqa: E731
    kk, vv = np.repeat(f64(k), h // kh, 2), np.repeat(f64(v), h // kh, 2)
    scale = 1 / np.sqrt(d)
    s = np.einsum("bqhd,bkhd->bhqk", f64(q), kk) * scale
    if causal:
        s = np.where(np.arange(sq)[:, None] >= np.arange(skv)[None, :], s,
                     -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    o = np.einsum("bhqk,bkhd->bqhd", p, vv)
    dp = np.einsum("bqhd,bkhd->bhqk", f64(do), vv)
    delta = (f64(do) * o).sum(-1).transpose(0, 2, 1)[..., None]
    ds = p * (dp - delta) * scale
    want_dq = np.einsum("bhqk,bkhd->bqhd", ds, kk)
    per_head = lambda g: g.reshape(b, skv, kh, h // kh, d).sum(3)  # noqa
    want_dk = per_head(np.einsum("bhqk,bqhd->bkhd", ds, f64(q)))
    want_dv = per_head(np.einsum("bhqk,bqhd->bkhd", p, f64(do)))
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        np.testing.assert_allclose(_np(got), want, rtol=2e-5, atol=2e-5)


def test_strided_keeps_what_the_tensor_maps_take():
    """B1 reads q/k/v through rank-4 tensor maps: views with unit last
    stride and strides that are positive multiples of 8 elements pass as
    they are (the fused qkv projection's slices); a stride of 0 on a
    dimension of size > 1 (an expand), a unit-stride miss or an odd
    stride gets a contiguous copy. A dimension of size 1 may carry any
    stride."""
    qkv = torch.zeros(2, 16, 12, 32, dtype=torch.bfloat16)
    for t in (qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]):
        assert fa._strided(t) is t
    one = torch.zeros(1, 16, 4, 32).as_strided((1, 16, 4, 32),
                                               (0, 128, 32, 1))
    assert fa._strided(one) is one
    expanded = torch.zeros(2, 16, 1, 32).expand(2, 16, 4, 32)
    copy = fa._strided(expanded)
    assert copy is not expanded and copy.is_contiguous()
    for bad in (qkv[..., ::2], qkv[:, :, :, 1:17]):
        assert fa._strided(bad).is_contiguous()
