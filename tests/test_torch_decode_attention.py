"""The port's decode-attention plain version against the JAX package's
Pallas kernel, which runs in interpret mode on the CPU
(``dlrover_tpu/ops/decode_attention.py``). Same numpy inputs, f32 q and
scales; tolerance 2e-5 (f32 sums in another order: the reference kernel
sweeps 16-row blocks with an online softmax, the port's plain version
takes one softmax over all rows)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlrover_tpu.ops.decode_attention import decode_attention as jax_decode
from dlrover_tpu.ops.kv_quant import quantize_kv as jax_quantize_kv
from dlrover_tpu_torch.ops import decode_attention as pt_da

TOL = dict(rtol=2e-5, atol=2e-5)
B, S, D, BLOCK = 4, 64, 16, 16
# Ragged fills: empty row, one row, a non-multiple of the block, full.
LENGTHS = np.array([0, 1, 23, S], np.int32)


def _inputs(h, kh, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, h, D).astype(np.float32)
    k = rs.randn(B, S, kh, D).astype(np.float32)
    v = rs.randn(B, S, kh, D).astype(np.float32)
    return q, k, v


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_reference_matches_jax_kernel_ragged(g, kv_dtype):
    kh = 2
    q, k, v = _inputs(g * kh, kh, seed=g)
    if kv_dtype == "int8":
        kq, ks = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(k)))
        vq, vs = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(v)))
        want = jax_decode(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
            jnp.asarray(LENGTHS), block_k=BLOCK,
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        )
        got = pt_da.decode_attention_reference(
            _t(q), _t(kq), _t(vq), _t(LENGTHS), _t(ks), _t(vs)
        )
    else:
        want = jax_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(LENGTHS), block_k=BLOCK,
        )
        got = pt_da.decode_attention_reference(
            _t(q), _t(k), _t(v), _t(LENGTHS)
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # A row of fill 0 gives exact zeros, on both sides.
    assert np.all(got.numpy()[0] == 0.0)


def test_scalar_length_matches_jax_kernel():
    q, k, v = _inputs(4, 2, seed=7)
    want = jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(17),
        block_k=BLOCK,
    )
    got = pt_da.decode_attention_reference(_t(q), _t(k), _t(v), 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; a fill above max_len reads max_len rows."""
    q, k, v = _inputs(4, 2, seed=8)
    pt_da.reset_launch_counts()
    lens = np.array([S + 5, 3, 0, S], np.int32)
    got = pt_da.decode_attention(_t(q), _t(k), _t(v), _t(lens))
    want = pt_da.decode_attention_reference(
        _t(q), _t(k), _t(v), _t(np.minimum(lens, S))
    )
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert sum(pt_da.launch_counts.values()) == 0


def test_bf16_reference_keeps_dtype():
    q, k, v = (_t(a).to(torch.bfloat16) for a in _inputs(2, 2, seed=9))
    out = pt_da.decode_attention_reference(q, k, v, torch.tensor(5))
    assert out.dtype == torch.bfloat16 and out.shape == (B, 2, D)
