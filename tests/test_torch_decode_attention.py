"""The port's decode-attention plain version against the JAX package's
Pallas kernel, which runs in interpret mode on the CPU
(``dlrover_tpu/ops/decode_attention.py``). Same numpy inputs, f32 q and
scales; tolerance 2e-5 (f32 sums in another order: the reference kernel
sweeps 16-row blocks with an online softmax, the port's plain version
takes one softmax over all rows)."""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
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


# ---- split-K partition (the kernel's host-side plan) --------------------


@pytest.mark.parametrize("b,h,kh,max_len,sms,want", [
    (8, 8, 8, 384, 132, (64, 6)),      # generate()'s decode step
    (8, 8, 8, 2048, 132, (128, 16)),   # the flagship at a 2048-row cache
    (8, 32, 8, 2048, 132, (128, 16)),  # GQA: one block per 8 query heads
    (16, 8, 8, 1024, 132, (128, 8)),   # the paged engine's 64 blocks of 16
    (64, 8, 8, 4096, 132, (256, 16)),  # capped at 256 rows a split
    (1, 2, 2, 40, 132, (64, 1)),       # one split: no scratch
])
def test_split_plan(b, h, kh, max_len, sms, want):
    assert pt_da.split_plan(b, h, kh, max_len, sms) == want


@pytest.mark.parametrize("b,h,kh,max_len", [
    (1, 1, 1, 1), (3, 40, 2, 300), (64, 8, 8, 100000), (2, 8, 1, 65),
])
def test_split_plan_covers_max_len(b, h, kh, max_len):
    rows, n = pt_da.split_plan(b, h, kh, max_len, 132)
    assert rows % 64 == 0 and 64 <= rows <= 256
    assert (n - 1) * rows < max_len <= n * rows


def _edge_lengths(split_rows, max_len):
    # Fills on every split edge, and the full cache.
    return np.array([0, 1, split_rows - 1, split_rows, split_rows + 1,
                     max_len], np.int32)


@pytest.mark.parametrize("h,kh", [(8, 2), (40, 2)])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_split_k_combine_matches_jax_kernel(h, kh, kv_dtype):
    """The kernel's split-K arithmetic (partials per split of 64 rows,
    combined in split order) against the JAX kernel and the plain
    version, at fills on every split edge; GQA groups of 4 and 20 (the
    kernel's blockIdx.z splits the latter into 8 + 8 + 4)."""
    rs = np.random.RandomState(h + kh)
    b, max_len, d, split = 6, 200, 16, 64
    q = rs.randn(b, h, d).astype(np.float32)
    k = rs.randn(b, max_len, kh, d).astype(np.float32)
    v = rs.randn(b, max_len, kh, d).astype(np.float32)
    lens = _edge_lengths(split, max_len)
    scales, jscales = (), {}
    if kv_dtype == "int8":
        k, ks = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(k)))
        v, vs = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(v)))
        scales = (_t(ks), _t(vs))
        jscales = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    want = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(lens), block_k=8, **jscales)
    got = pt_da.split_k_reference(_t(q), _t(k), _t(v), _t(lens), split,
                                  *scales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = pt_da.decode_attention_reference(_t(q), _t(k), _t(v), _t(lens),
                                             *scales)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    assert np.all(got.numpy()[0] == 0.0)


def test_split_k_reference_is_the_plain_version_for_any_split():
    q, k, v = (_t(a) for a in _inputs(4, 2, seed=10))
    lens = _t(np.array([0, 1, 33, S], np.int32))
    plain = pt_da.decode_attention_reference(q, k, v, lens)
    for split in (1, 7, 16, 64, 1000):
        torch.testing.assert_close(
            pt_da.split_k_reference(q, k, v, lens, split), plain, **TOL)


def test_ticket_buffers_are_per_stream_and_grow_zeroed():
    pt_da._ticket_buffers.clear()
    dev = torch.device("cpu")
    a = pt_da._tickets(dev, 7, 10)
    assert a.dtype == torch.int32 and a.numel() >= 10
    assert not torch.any(a)
    assert pt_da._tickets(dev, 7, 5) is a          # reused on its stream
    assert pt_da._tickets(dev, 8, 5) is not a      # another stream: its own
    big = pt_da._tickets(dev, 7, a.numel() + 1)    # grown, still zero
    assert big.numel() > a.numel() and not torch.any(big)
    pt_da._ticket_buffers.clear()
