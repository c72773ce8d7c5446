"""The port's paged decode-attention plain version against the JAX
package's Pallas kernel ``paged_decode_attention``, which runs in
interpret mode on the CPU (as ``tests/test_kvpool.py`` and
``tests/test_kernel_parity.py`` run it). Same numpy inputs from a seed:
a pool larger than the batch needs, filled with noise everywhere, read
through SHUFFLED block tables at ragged fills that include an empty
row, a non-multiple of the block and a full row; table entries past a
row's fill are poisoned with ids of blocks that belong to other rows,
which neither side may read.

Tolerances: f32 inputs within 2e-5 (f32 sums in another order: the
reference kernel sweeps one pool block at a time with an online
softmax, the port's plain version takes one softmax over all rows);
bf16 inputs within 1e-2 (both round one f32 result to bf16, and the
reference kernel also rounds its probabilities to bf16 before p.v).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlrover_tpu.ops.decode_attention import (
    paged_decode_attention as jax_paged,
)
from dlrover_tpu.ops.kv_quant import quantize_kv as jax_quantize_kv
from dlrover_tpu_torch.ops import decode_attention as pt_da

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}
B, D, BS, MB = 4, 16, 8, 6
S = BS * MB
NUM_BLOCKS = 2 * B * MB + 1
# Ragged fills: empty row, inside the first block, a non-multiple of the
# block, full.
LENGTHS = np.array([0, 3, 29, S], np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(h, kh, seed, lengths=LENGTHS):
    """q, noise-filled pools, shuffled tables with poisoned tails."""
    rs = np.random.RandomState(seed)
    q = rs.randn(B, h, D).astype(np.float32)
    k_pool = rs.randn(NUM_BLOCKS, BS, kh, D).astype(np.float32)
    v_pool = rs.randn(NUM_BLOCKS, BS, kh, D).astype(np.float32)
    tables = (rs.permutation(NUM_BLOCKS - 1)[:B * MB] + 1).reshape(
        B, MB).astype(np.int32)
    for i, n in enumerate(lengths):
        used = -(-int(min(n, S)) // BS)
        # Stale ids: blocks of the next row, as a recycled slot holds.
        tables[i, used:] = tables[(i + 1) % B, :MB - used][::-1]
    return q, k_pool, v_pool, tables


def _quantized(k_pool, v_pool):
    kq, ks = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(k_pool)))
    vq, vs = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(v_pool)))
    return kq, vq, ks, vs


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_reference_matches_jax_paged_kernel(g, kv_dtype):
    """MHA (g=1) and GQA, f32 q; fp and int8 pools."""
    kh = 2
    q, k_pool, v_pool, tables = _inputs(g * kh, kh, seed=g)
    if kv_dtype == "int8":
        kq, vq, ks, vs = _quantized(k_pool, v_pool)
        want = jax_paged(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
            jnp.asarray(tables), jnp.asarray(LENGTHS), interpret=True,
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        )
        got = pt_da.paged_decode_attention_reference(
            _t(q), _t(kq), _t(vq), _t(tables), _t(LENGTHS), _t(ks), _t(vs)
        )
    else:
        want = jax_paged(
            jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
            jnp.asarray(tables), jnp.asarray(LENGTHS), interpret=True,
        )
        got = pt_da.paged_decode_attention_reference(
            _t(q), _t(k_pool), _t(v_pool), _t(tables), _t(LENGTHS)
        )
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), **TOL["float32"]
    )
    # A row of fill 0 gives exact zeros, on both sides.
    assert np.all(got.numpy()[0] == 0.0)
    assert np.all(np.asarray(want)[0] == 0.0)


@pytest.mark.parametrize("g", [1, 4])
def test_reference_matches_jax_paged_kernel_bf16(g):
    kh = 2
    q, k_pool, v_pool, tables = _inputs(g * kh, kh, seed=10 + g)
    want = jax_paged(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k_pool, jnp.bfloat16),
        jnp.asarray(v_pool, jnp.bfloat16), jnp.asarray(tables),
        jnp.asarray(LENGTHS), interpret=True,
    )
    got = pt_da.paged_decode_attention_reference(
        _t(q).bfloat16(), _t(k_pool).bfloat16(), _t(v_pool).bfloat16(),
        _t(tables), _t(LENGTHS),
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        **TOL["bfloat16"],
    )


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_paged_equals_flat_reference_on_the_gathered_view(kv_dtype):
    """Paged through a table IS the flat plain version on the logical
    caches the table names: bit for bit, the same math on the same
    rows."""
    q, k_pool, v_pool, tables = _inputs(4, 2, seed=20)
    pools = [k_pool, v_pool]
    if kv_dtype == "int8":
        kq, vq, ks, vs = _quantized(k_pool, v_pool)
        pools = [kq, vq, ks, vs]
    views = [p[tables].reshape(B, S, *p.shape[2:]) for p in pools]
    got = pt_da.paged_decode_attention_reference(
        _t(q), _t(pools[0]), _t(pools[1]), _t(tables), _t(LENGTHS),
        *(_t(p) for p in pools[2:]),
    )
    want = pt_da.decode_attention_reference(
        _t(q), _t(views[0]), _t(views[1]), _t(LENGTHS),
        *(_t(p) for p in views[2:]),
    )
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_stale_table_entries_past_the_fill_never_show():
    """Rewriting every table entry at or past a row's fill, and every
    pool block no row owns below its fill, changes nothing."""
    q, k_pool, v_pool, tables = _inputs(4, 2, seed=21)
    want = pt_da.paged_decode_attention_reference(
        _t(q), _t(k_pool), _t(v_pool), _t(tables), _t(LENGTHS)
    )
    owned = set()
    other = tables.copy()
    for i, n in enumerate(LENGTHS):
        used = -(-int(n) // BS)
        owned.update(tables[i, :used].tolist())
        other[i, used:] = 0
    k2, v2 = k_pool.copy(), v_pool.copy()
    free = [b for b in range(NUM_BLOCKS) if b not in owned]
    k2[free] = 1e6
    v2[free] = -1e6
    got = pt_da.paged_decode_attention_reference(
        _t(q), _t(k2), _t(v2), _t(other), _t(LENGTHS)
    )
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; a fill above the table's rows reads them all, and a scalar
    fill is broadcast."""
    q, k_pool, v_pool, tables = _inputs(4, 2, seed=22,
                                        lengths=[S, S, S, S])
    pt_da.reset_launch_counts()
    lens = np.array([S + 5, 3, 0, S], np.int32)
    got = pt_da.paged_decode_attention(
        _t(q), _t(k_pool), _t(v_pool), _t(tables), _t(lens)
    )
    want = pt_da.paged_decode_attention_reference(
        _t(q), _t(k_pool), _t(v_pool), _t(tables), _t(np.minimum(lens, S))
    )
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    scalar = pt_da.paged_decode_attention(
        _t(q), _t(k_pool), _t(v_pool), _t(tables), 11
    )
    want = pt_da.paged_decode_attention_reference(
        _t(q), _t(k_pool), _t(v_pool), _t(tables),
        _t(np.full(B, 11, np.int32)),
    )
    np.testing.assert_array_equal(scalar.numpy(), want.numpy())
    assert sum(pt_da.launch_counts.values()) == 0
    assert set(pt_da.launch_counts) >= {
        "paged_decode_attention_fp", "paged_decode_attention_int8"
    }


@pytest.mark.parametrize("block_size", [1, 3, 16])
def test_any_block_size(block_size):
    """The reference takes any block size (not only the sublane
    multiples its TPU kernel wants); so does the port: paged equals flat
    on the gathered view for each."""
    rs = np.random.RandomState(block_size)
    mb, kh, h = 5, 2, 4
    nb = B * mb + 3
    q = rs.randn(B, h, D).astype(np.float32)
    k_pool = rs.randn(nb, block_size, kh, D).astype(np.float32)
    v_pool = rs.randn(nb, block_size, kh, D).astype(np.float32)
    tables = (rs.permutation(nb - 1)[:B * mb] + 1).reshape(B, mb).astype(
        np.int32)
    lens = np.array([0, 1, 2 * block_size + 1, mb * block_size], np.int32)
    got = pt_da.paged_decode_attention(
        _t(q), _t(k_pool), _t(v_pool), _t(tables), _t(lens)
    )
    view = lambda p: p[tables].reshape(B, mb * block_size, kh, D)  # noqa
    want = pt_da.decode_attention_reference(
        _t(q), _t(view(k_pool)), _t(view(v_pool)), _t(lens)
    )
    np.testing.assert_array_equal(got.numpy(), want.numpy())
