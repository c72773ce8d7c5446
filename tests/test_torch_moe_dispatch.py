"""The port's MoE dispatch layer (``ops/moe_dispatch``) against the JAX
package's: the same numpy routing goes through both
``build_dispatch_layout``s, and the same numpy activations and weights
through both ``grouped_ffn``s (JAX's Pallas kernels in interpret mode,
the port's plain versions of B7/B8 on the CPU).

Tolerances: the layout is integer and must be equal element for element.
f32 grouped FFN: forward and every gradient within 1e-5 + 1e-5 * |ref|
(the same products, f32 sums in another order). bf16: both sides round
a, dh and the outputs to bf16 at the same places from f32 sums taken in
another order, so an element may land one bf16 step (2^-8 relative)
away, and that step can pass through the next product: within 2e-2 *
|ref| + 2e-2 * rms(ref).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from dlrover_tpu.ops import moe_dispatch as jax_md
from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.ops import moe_dispatch as md


def _routing(case, rs):
    """(flat_expert [m] int32, n_groups, tile_m, copies_per_src)."""
    if case == "random_16":
        return rs.randint(0, 4, 48).astype(np.int32), 4, 16, 2
    if case == "random_128":
        return rs.randint(0, 8, 2048).astype(np.int32), 8, 128, 2
    if case == "empty_expert":
        fe = rs.randint(0, 4, 40).astype(np.int32)
        return np.where(fe == 2, 3, fe).astype(np.int32), 4, 16, 2
    if case == "all_on_one":
        return np.full(64, 5, np.int32), 8, 16, 2
    if case == "sentinels":
        # entries >= n_groups get no slot (the ep exchange's padding)
        return rs.randint(0, 5, 50).astype(np.int32), 4, 16, 1
    if case == "m_below_tile":
        return rs.randint(0, 8, 6).astype(np.int32), 8, 16, 2
    if case == "skewed_128":
        fe = rs.randint(0, 8, 3000)
        fe[: 1500] = 1
        return np.where(fe == 6, 7, fe).astype(np.int32), 8, 128, 2
    raise ValueError(case)


_CASES = ["random_16", "random_128", "empty_expert", "all_on_one",
          "sentinels", "m_below_tile", "skewed_128"]


@pytest.mark.parametrize("case", _CASES)
def test_layout_equals_jax_element_for_element(case):
    fe, g, tm, cps = _routing(case, np.random.RandomState(len(case)))
    want = jax_md.build_dispatch_layout(jnp.asarray(fe), g, tm, cps)
    got = md.build_dispatch_layout(torch.from_numpy(fe), g, tm, cps)
    for name, w, t in zip(("row_ids", "dest_ids", "tile_expert"), want, got):
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(w),
                                      err_msg=name)
    T = -(-fe.shape[0] // tm) + g + 1
    assert got[0].shape == (T * tm,) and got[2].shape == (T,)


@pytest.mark.parametrize("m", [1, 1023, 1024, 5000])
def test_default_tile_m_matches_jax(m):
    assert md.default_tile_m(m) == jax_md.default_tile_m(m)


def test_silu_bwd_matches_jax():
    rs = np.random.RandomState(0)
    hg, hu, da = (rs.randn(64).astype(np.float32) * 4 for _ in range(3))
    want = jax_md._silu_bwd(jnp.asarray(hg), jnp.asarray(hu), jnp.asarray(da))
    got = md._silu_bwd(*(torch.from_numpy(a) for a in (hg, hu, da)))
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def _ffn_inputs(case, dtype, seed=0):
    """x [n, d], w_gu [e, d, 2f], w_down [e, f, d], dy [m, d] as numpy in
    ``dtype`` (bf16 as ml_dtypes), and the routing. ``tile_128``: enough
    copies for 128-row tiles (1200), expert 1 without rows. ``unit_16``
    and ``unit_128``: the same at tile 16 and 128 with f in B8 dx's
    64-column units of f, three (one past a cluster's two) and two."""
    rs = np.random.RandomState(seed)
    n = 600 if case in ("tile_128", "unit_128") else 20
    f = {"unit_16": 192, "unit_128": 128}.get(case, 32)
    d, e, k = 16, 4, 2
    x = rs.randn(n, d)
    w_gu = rs.randn(e, d, 2 * f) / np.sqrt(d)
    w_down = rs.randn(e, f, d) / np.sqrt(f)
    dy = rs.randn(n * k, d)
    fe = rs.randint(0, e, n * k).astype(np.int32)
    if case in ("empty_expert", "tile_128", "unit_16", "unit_128"):
        fe = np.where(fe == 1, 0, fe).astype(np.int32)
    elif case == "skewed":
        # three quarters of the copies on expert 2, expert 3 empty: the
        # order the dw kernels take the experts in is not their index
        fe[: 3 * n * k // 4] = 2
        fe = np.where(fe == 3, 1, fe).astype(np.int32)
    cast = (lambda a: a.astype(ml_dtypes.bfloat16)) if dtype == "bfloat16" \
        else (lambda a: a.astype(np.float32))
    return [cast(a) for a in (x, w_gu, w_down, dy)], fe, e, k


def _close(got, want, dtype, what):
    got = got.astype(np.float32)
    want = np.asarray(want).astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
    else:
        tol = 2e-2 * np.abs(want) + 2e-2 * np.sqrt(np.mean(want ** 2))
        assert np.all(np.abs(got - want) <= tol), (
            what, float(np.abs(got - want).max()))


@pytest.fixture(scope="module")
def ffn_cases():
    """JAX's grouped_ffn forward and VJP (interpret mode) per (dtype,
    routing case), computed once for the module."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        for case in ("random", "empty_expert", "skewed", "tile_128",
                     "unit_16", "unit_128"):
            (x, w_gu, w_down, dy), fe, e, k = _ffn_inputs(case, dtype)
            m = fe.shape[0]
            tm = jax_md.default_tile_m(m)
            ids = jax_md.build_dispatch_layout(jnp.asarray(fe), e, tm, k)

            def f(x_, wgu_, wd_):
                return jax_md.grouped_ffn(x_, wgu_, wd_, *ids, m, k, tm, True)

            y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w_gu),
                             jnp.asarray(w_down))
            grads = vjp(jnp.asarray(dy))
            out[(dtype, case)] = (
                (x, w_gu, w_down, dy), fe, e, k, tm,
                [np.asarray(a) for a in (y, *grads)],
            )
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "empty_expert", "skewed"])
def test_grouped_ffn_forward_and_vjp_match_jax(ffn_cases, dtype, case):
    (x, w_gu, w_down, dy), fe, e, k, tm, want = ffn_cases[(dtype, case)]
    m = fe.shape[0]
    tx, twgu, twd = (convert.params_from_numpy(a, "cpu").requires_grad_()
                     for a in (x, w_gu, w_down))
    ids = md.build_dispatch_layout(torch.from_numpy(fe), e, tm, k)
    y = md.grouped_ffn(tx, twgu, twd, *ids, m, k, tm)
    y.backward(convert.params_from_numpy(dy, "cpu"))
    got = [y.detach(), tx.grad, twgu.grad, twd.grad]
    for name, g, w in zip(("y", "dx", "dw_gu", "dw_down"), got, want):
        assert g.dtype == tx.dtype, name
        _close(convert.params_to_numpy(g), w, dtype, name)
    if case == "empty_expert":
        # expert 1 has no rows: an exactly zero weight gradient
        assert not twgu.grad[1].any() and not twd.grad[1].any()
        assert twgu.grad[0].abs().max() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["empty_expert", "tile_128", "unit_16",
                                  "unit_128"])
def test_plain_ffn_matches_pallas_at_kernel_tile_edges(ffn_cases, dtype,
                                                       case):
    """B7 and B8 dx's plain versions (the wrappers on CPU tensors) against
    the Pallas grouped FFN in interpret mode where the card kernels' units
    end: at tile_m 16 and 128, f in B8 dx's 64-column units (``unit_*``),
    each layout holding an all-padding tile (the gate|up launches write
    their zero ``a`` and ``dh`` rows, the down launches nothing) and an
    expert without rows. y per copy, and dx summed over the copies from
    the wrappers' dx_c."""
    (x, w_gu, w_down, dy), fe, e, k, tm, want = ffn_cases[(dtype, case)]
    assert tm == (128 if case.endswith("128") else 16)
    m = fe.shape[0]
    tx, twgu, twd, tdy = (convert.params_from_numpy(a, "cpu")
                          for a in (x, w_gu, w_down, dy))
    ri, di, te = md.build_dispatch_layout(torch.from_numpy(fe), e, tm, k)
    tiles = ri.view(-1, tm)
    assert (tiles < 0).all(dim=1).any()       # an all-padding tile
    assert not (torch.from_numpy(fe) == 1).any()  # expert 1 has no rows
    y = md.grouped_ffn_forward(tx, twgu, twd, ri, di, te, m, tm)
    dx_c, dh, a = md.grouped_ffn_backward_dx(tx, tdy, twgu, twd, ri, di, te,
                                             tm)
    _close(convert.params_to_numpy(y), want[0], dtype, "y")
    dx = dx_c.float().reshape(-1, k, dx_c.shape[-1]).sum(dim=1)
    _close(dx.numpy(), want[1], dtype, "dx")
    pad = ri < 0
    assert not a[pad].any() and not dh[pad].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "empty_expert", "skewed"])
def test_dw_plain_versions_match_pallas(ffn_cases, dtype, case):
    """The B8 weight-gradient wrappers alone (their plain versions on the
    CPU), fed the sorted dh and a of the plain dx, against the Pallas
    grouped FFN's dw_gu and dw_down in interpret mode; an expert without
    rows gets exact zeros."""
    (x, w_gu, w_down, dy), fe, e, k, tm, want = ffn_cases[(dtype, case)]
    tx, twgu, twd, tdy = (convert.params_from_numpy(a, "cpu")
                          for a in (x, w_gu, w_down, dy))
    ri, di, te = md.build_dispatch_layout(torch.from_numpy(fe), e, tm, k)
    _, dh, a = md._backward_dx_reference(tx, tdy, twgu, twd, ri, di, te, tm)
    dw_gu = md.grouped_ffn_backward_dw_gu(tx, dh, ri, te, e, tm)
    dw_down = md.grouped_ffn_backward_dw_down(a, tdy, di, te, e, tm)
    assert dw_gu.dtype == dw_down.dtype == torch.float32
    _close(dw_gu.numpy(), want[2], dtype, "dw_gu")
    _close(dw_down.numpy(), want[3], dtype, "dw_down")
    empty = np.setdiff1d(np.arange(e), fe)
    assert not dw_gu[empty].any() and not dw_down[empty].any()


def test_plain_flag_equals_the_cpu_wrappers(ffn_cases):
    """On CPU tensors each wrapper runs its plain version, so ``plain``
    changes nothing there: equal bits, forward and backward."""
    (x, w_gu, w_down, dy), fe, e, k, tm, _ = ffn_cases[("float32", "random")]
    m = fe.shape[0]
    ids = md.build_dispatch_layout(torch.from_numpy(fe), e, tm, k)
    outs = []
    for plain in (False, True):
        leaves = [torch.from_numpy(a).requires_grad_()
                  for a in (x, w_gu, w_down)]
        y = md.grouped_ffn(*leaves, *ids, m, k, tm, plain=plain)
        y.backward(torch.from_numpy(dy))
        outs.append([y.detach()] + [t.grad for t in leaves])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_cpu_wrappers_launch_nothing(ffn_cases):
    (x, w_gu, w_down, dy), fe, e, k, tm, _ = ffn_cases[("float32", "random")]
    md.reset_launch_counts()
    ids = md.build_dispatch_layout(torch.from_numpy(fe), e, tm, k)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w_gu, w_down)]
    md.grouped_ffn(*leaves, *ids, fe.shape[0], k, tm).sum().backward()
    assert all(n == 0 for n in md.launch_counts.values())


def test_wrappers_refuse_other_devices():
    x = torch.zeros(4, 128, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        md.grouped_ffn_forward(x, x, x, x, x, x, 4, 16)


def test_shape_checks_name_the_operand():
    """The card wrappers hold every operand to the shape its kernel reads
    (a mismatch would read or write past a buffer)."""
    t = torch.zeros(6, 4)
    md._check_shapes("k", t=(t, (None, 4)), u=(t, (6, 4)))
    with pytest.raises(ValueError, match=r"k: t has shape \(6, 4\), "
                                         r"want \('\*', 5\)"):
        md._check_shapes("k", t=(t, (None, 5)))
    with pytest.raises(ValueError, match="t has shape"):
        md._check_shapes("k", t=(t, (6,)))
    assert md._ffn_dims("k", torch.zeros(2, 8, 6)) == (2, 8, 3)
    with pytest.raises(ValueError, match="not 2f"):
        md._ffn_dims("k", torch.zeros(2, 8, 5))
    with pytest.raises(ValueError, match="w_gu has shape"):
        md._ffn_dims("k", torch.zeros(8, 6))


def test_dw_kernel_bounds_find_each_experts_tiles():
    """The weight-gradient kernels read each expert's tile range from
    ``_expert_tile_bounds``: every tile lies in exactly its expert's
    range, and an empty expert still owns its one all-padding tile."""
    fe, g, tm, cps = _routing("empty_expert", np.random.RandomState(3))
    _, _, te = md.build_dispatch_layout(torch.from_numpy(fe), g, tm, cps)
    b = md._expert_tile_bounds(te, g).tolist()
    assert b[0] == 0 and b[-1] == te.shape[0]
    for e in range(g):
        assert b[e + 1] - b[e] >= 1
        assert (te[b[e]:b[e + 1]] == e).all()


def test_layout_builder_reads_nothing_back(monkeypatch):
    """No ``.item()``/``.tolist()``/``bincount``: building the layout
    never needs the routing on the host, so a card's kernel grids are
    known without waiting on the device."""
    calls = []
    for name in ("item", "tolist"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    monkeypatch.setattr(torch, "bincount",
                        lambda *a, **k: calls.append("bincount"))
    fe = torch.from_numpy(np.random.RandomState(1).randint(0, 8, 300))
    _, _, te = md.build_dispatch_layout(fe.to(torch.int32), 8, 16, 2)
    # nor do the dw kernels' tile ranges: the kernels rank the experts
    # by their rows themselves
    md._expert_tile_bounds(te, 8)
    assert calls == []

