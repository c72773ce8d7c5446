"""The two mesh cases the reference runs through GSPMD, in the port:
gshard MoE under sp > 1, and a pp axis with ``pp_stages`` 1 (every pp
rank a replica), against the JAX package.

- ``moe.moe_mlp_chunk`` in one process: a sequence split into sp
  contiguous chunks, each run with the offsets its lower chunks and the
  whole sequence give (``gshard_counts``), concatenated, against JAX's
  ``moe_mlp`` on the whole sequence: out, ``dropped_fraction`` (> 0),
  aux, z and the gradients of ``sum(y * g) + 0.3 * (aux + 0.001 z)``
  for x and every weight (f32, within 1e-5 + 1e-4 |ref|; the router is
  skewed so that the tokens a chunk would keep under its own capacity
  differ from the whole sequence's, which the test also shows);
- the same layer on a gloo world of sp = 2 (``moe_mlp(sp_group=)``,
  the weights laid out and gathered as the model's), each rank's rows
  and gradient shards against JAX's whole-sequence ``moe_mlp``;
- 5-step trajectories against JAX's ``make_train_step`` on the same
  virtual mesh (``check_trajectory``): the tiny MoE config with
  ``moe_impl="auto"`` (gshard on a mesh of more than one rank) on
  (sp=2) at capacity factor 1.0 and on (dp=2, sp=2) at 1.25, and the
  tiny dense config with ``pp_stages`` 1 on (pp=2) and (dp=2, pp=2).

The worlds run ``tests/workers/torch_mesh_worker.py`` (``run_world``).
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.models import moe as jax_moe
from dlrover_tpu_torch.models import moe
from tests.test_torch_sharded_train import check_trajectory, run_world

AUX_WEIGHT = 0.3
NAMES = ("x", "router", "w_gate", "w_up", "w_down")


def _skewed(rows=2, seq=16, d=16, f=32, e=4, seed=13):
    """Inputs whose router sends most tokens' first choice to expert 0,
    so the first chunk fills expert 0's capacity."""
    rs = np.random.RandomState(seed)
    router = rs.randn(d, e).astype(np.float32)
    router[:, 0] += 0.5
    return {
        "x": (rs.randn(rows, seq, d) + 0.5).astype(np.float32),
        "gout": rs.randn(rows, seq, d).astype(np.float32),
        "router": router,
        "w_gate": (rs.randn(e, d, f) / np.sqrt(d)).astype(np.float32),
        "w_up": (rs.randn(e, d, f) / np.sqrt(d)).astype(np.float32),
        "w_down": (rs.randn(e, f, d) / np.sqrt(f)).astype(np.float32),
        "top_k": 2, "aux_weight": AUX_WEIGHT,
    }


def _jax_layer(inp, cf, seq=slice(None)):
    """JAX's ``moe_mlp`` on the tokens ``seq`` of every row (the whole
    sequence by default): out, metrics and the gradients of the weighted
    loss."""
    x, gout = inp["x"][:, seq], inp["gout"][:, seq]

    def loss(*args):
        y, m = jax_moe.moe_mlp(*args, top_k=inp["top_k"],
                               capacity_factor=cf)
        aux = m.aux_loss + 0.001 * m.router_z_loss
        return jnp.sum(y * gout) + AUX_WEIGHT * aux, (y, m)

    args = [jnp.asarray(x)] + [jnp.asarray(inp[k]) for k in NAMES[1:]]
    (_, (y, m)), grads = jax.value_and_grad(
        loss, argnums=tuple(range(5)), has_aux=True)(*args)
    return (np.asarray(y), {k: float(v) for k, v in m._asdict().items()},
            dict(zip(NAMES, map(np.asarray, grads))))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("cf", [1.0, 1.25])
def test_chunk_body_matches_whole_sequence(sp, cf):
    inp = _skewed()
    want_y, want_m, want_g = _jax_layer(inp, cf)
    assert want_m["dropped_fraction"] > 0
    leaves = [torch.from_numpy(inp[k]).requires_grad_(True) for k in NAMES]
    x, weights = leaves[0], leaves[1:]
    chunks = x.chunk(sp, dim=1)
    counts = [moe.gshard_counts(c, weights[0], inp["top_k"])
              for c in chunks]
    totals = torch.stack(counts).sum(dim=0)
    seq = x.shape[1]
    ys, stats, dropped = [], [], []
    for i, chunk in enumerate(chunks):
        lower = sum(counts[:i], torch.zeros_like(totals))
        y, st, kept = moe.moe_mlp_chunk(chunk, *weights, lower, totals,
                                        seq, inp["top_k"], cf)
        ys.append(y)
        stats.append(st)
        dropped.append(moe.dropped_share(kept))
    y = torch.cat(ys, dim=1)
    e = weights[0].shape[-1]
    aux, z = moe.router_losses_from_stats(torch.stack(stats).mean(dim=0), e)
    loss = ((y * torch.from_numpy(inp["gout"])).sum()
            + AUX_WEIGHT * (aux + 0.001 * z))
    grads = torch.autograd.grad(loss, leaves)
    y, aux, z = y.detach(), aux.detach(), z.detach()
    _close(y.numpy(), want_y, "out")
    np.testing.assert_allclose(
        float(torch.stack(dropped).mean()) / inp["top_k"],
        want_m["dropped_fraction"], rtol=1e-6)
    np.testing.assert_allclose(float(aux), want_m["aux_loss"], rtol=1e-6)
    np.testing.assert_allclose(float(z), want_m["router_z_loss"], rtol=1e-6)
    for name, g in zip(NAMES, grads):
        _close(g.numpy(), want_g[name], name)
    # Each chunk under its own capacity and offsets keeps other tokens:
    # the whole sequence's are what the port must reproduce.
    local = [_jax_layer(inp, cf, slice(i * seq // sp, (i + 1) * seq // sp))
             for i in range(sp)]
    local_y = np.concatenate([r[0] for r in local], axis=1)
    assert np.abs(local_y - want_y).max() > 1e-2


def test_whole_sequence_moe_mlp_is_the_chunk_body_with_no_offsets():
    inp = _skewed(seed=3)
    t = [torch.from_numpy(inp[k]) for k in NAMES]
    y, metrics = moe.moe_mlp(*t, top_k=2, capacity_factor=1.0)
    counts = moe.gshard_counts(t[0], t[1], 2)
    y2, _, kept = moe.moe_mlp_chunk(*t, torch.zeros_like(counts), counts,
                                    t[0].shape[1], 2, 1.0)
    assert torch.equal(y, y2)
    assert kept.shape == (2,) + t[0].shape[:2] and not kept.all()
    assert float(metrics.dropped_fraction) == float(
        moe.dropped_share(kept)) / 2


def test_gshard_layer_on_an_sp_world_matches_whole_sequence(tmp_path):
    cf = 1.0
    inp = _skewed()
    want_y, want_m, want_g = _jax_layer(inp, cf)
    assert want_m["dropped_fraction"] > 0
    outs = run_world("gshard", tmp_path, dict(inp, mesh={"sp": 2},
                                              capacity_factor=cf), 2)
    got_y = np.full_like(want_y, np.nan)
    got_dx = np.full_like(want_g["x"], np.nan)
    got_w = {k: np.full_like(want_g[k], np.nan) for k in NAMES[1:]}
    for out in outs:
        o = out["gshard"]
        rows, seq = slice(*o["rows"]), slice(*o["seq"])
        got_y[rows, seq] = o["y"]
        got_dx[rows, seq] = o["dx"]
        np.testing.assert_allclose(o["dropped"], want_m["dropped_fraction"],
                                   rtol=1e-6)
        np.testing.assert_allclose(o["aux"], want_m["aux_loss"], rtol=1e-5)
        np.testing.assert_allclose(o["z"], want_m["router_z_loss"],
                                   rtol=1e-5)
        for k, (bounds, g) in o["grads"].items():
            got_w[k][tuple(slice(a, b) for a, b in bounds)] = g
    _close(got_y, want_y, "out")
    _close(got_dx, want_g["x"], "x")
    for k, g in got_w.items():
        _close(g, want_g[k], k)


TRAJECTORIES = [
    pytest.param(dict(n_experts=4, capacity_factor=1.0), {"sp": 2},
                 id="gshard_sp2_cap1"),
    pytest.param(dict(n_experts=4), {"dp": 2, "sp": 2},
                 id="gshard_dp2_sp2"),
    pytest.param({}, {"pp": 2}, id="pp2_replicas"),
    pytest.param({}, {"dp": 2, "pp": 2}, id="dp2_pp2_replicas"),
]


@pytest.mark.parametrize("kw,mesh_kw", TRAJECTORIES)
def test_mesh_case_trajectory_matches_jax(tmp_path, kw, mesh_kw):
    jcfg = jax_llama.tiny_config(n_layers=2, **kw)
    assert jcfg.pp_stages == 1 and jcfg.moe_impl == "auto"
    assert math.prod(mesh_kw.values()) <= 4
    check_trajectory(tmp_path, jcfg, mesh_kw)
