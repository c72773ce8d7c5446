"""The port's plain ops against the JAX package's ops on the CPU: the
same numpy inputs through both, f32, tolerance 1e-5 (the two frameworks
reduce in different orders; the ops are otherwise the same math)."""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlrover_tpu.ops import attention as jax_attn
from dlrover_tpu.ops import kv_quant as jax_kvq
from dlrover_tpu.ops.norms import rms_norm as jax_rms_norm
from dlrover_tpu.ops.rope import apply_rope as jax_apply_rope
from dlrover_tpu.ops.rope import rope_frequencies as jax_rope_freqs
from dlrover_tpu_torch.ops import attention as pt_attn
from dlrover_tpu_torch.ops import kv_quant as pt_kvq
from dlrover_tpu_torch.ops.norms import rms_norm
from dlrover_tpu_torch.ops.rope import apply_rope, rope_frequencies

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("d", [16, 64])
def test_rms_norm_matches_jax(d):
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5, d).astype(np.float32)
    scale = (0.1 * rs.randn(d)).astype(np.float32)
    got = rms_norm(_t(x), _t(scale)).numpy()
    want = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    np.testing.assert_allclose(got, want, **TOL)


def test_rms_norm_keeps_bf16_dtype():
    x = torch.randn(2, 8, dtype=torch.float32).to(torch.bfloat16)
    out = rms_norm(x, torch.zeros(8))
    assert out.dtype == torch.bfloat16


def test_rope_matches_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 7, 3, 16).astype(np.float32)
    pos = rs.randint(0, 500, size=(2, 7)).astype(np.int32)
    got = apply_rope(_t(x), _t(pos), 10000.0).numpy()
    want = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(
        rope_frequencies(16).numpy(), np.asarray(jax_rope_freqs(16)), **TOL
    )


@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2), (8, 2)])
def test_attention_gqa_with_positions_matches_jax(h, kh):
    rs = np.random.RandomState(2)
    b, sq, skv, d = 2, 5, 12, 16
    q = rs.randn(b, sq, h, d).astype(np.float32)
    k = rs.randn(b, skv, kh, d).astype(np.float32)
    v = rs.randn(b, skv, kh, d).astype(np.float32)
    q_pos = np.array([[3, 4, 5, 6, 7], [7, 8, 9, 10, 11]], np.int32)
    kv_pos = np.arange(skv, dtype=np.int32)
    got = pt_attn.dot_product_attention(
        _t(q), _t(k), _t(v), causal=True, q_positions=_t(q_pos),
        kv_positions=_t(kv_pos),
    ).numpy()
    want = np.asarray(jax_attn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_positions=jnp.asarray(q_pos), kv_positions=jnp.asarray(kv_pos),
    ))
    np.testing.assert_allclose(got, want, **TOL)


def test_attention_fully_masked_rows_are_exact_zeros():
    """A query whose every key lies in its future gets exactly zero, as
    in the reference (ring attention's merge relies on it)."""
    rs = np.random.RandomState(3)
    q = rs.randn(1, 2, 2, 16).astype(np.float32)
    k = rs.randn(1, 4, 2, 16).astype(np.float32)
    v = rs.randn(1, 4, 2, 16).astype(np.float32)
    q_pos = np.array([0, 9], np.int32)
    kv_pos = np.array([5, 6, 7, 8], np.int32)
    got = pt_attn.dot_product_attention(
        _t(q), _t(k), _t(v), q_positions=_t(q_pos),
        kv_positions=_t(kv_pos),
    ).numpy()
    assert np.all(got[0, 0] == 0.0)
    assert np.any(got[0, 1] != 0.0)
    want = np.asarray(jax_attn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(q_pos), kv_positions=jnp.asarray(kv_pos),
    ))
    np.testing.assert_allclose(got, want, **TOL)
    assert pt_attn.NEG_INF == jax_attn.NEG_INF


def test_quantize_kv_matches_jax_bit_for_bit():
    """Same int8 values and scales as the reference (round half to
    even on both sides), including an all-zero row (scale floor)."""
    rs = np.random.RandomState(4)
    x = rs.randn(3, 6, 2, 16).astype(np.float32)
    x[0, 0, 0] = 0.0
    q, s = pt_kvq.quantize_kv(_t(x))
    jq, js = jax_kvq.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    deq = pt_kvq.dequantize_kv(q, s).numpy()
    jdeq = np.asarray(jax_kvq.dequantize_kv(jq, js))
    np.testing.assert_allclose(deq, jdeq, rtol=1e-7, atol=1e-7)
    # Round trip within amax / 254 per element.
    bound = np.abs(x).max(axis=-1, keepdims=True) / 254.0 + 1e-7
    assert np.all(np.abs(deq - x) <= bound)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_bytes_per_head_row_matches_jax(kv_dtype):
    for d in (16, 128):
        assert pt_kvq.bytes_per_head_row(d, kv_dtype) == (
            jax_kvq.bytes_per_head_row(d, kv_dtype)
        )
