"""The sharded and expert-parallel dropless MoE of the port on gloo worlds
of 2 and 4 CPU processes, against the JAX package's on the same meshes
over as many of its 8 virtual CPU devices (f32, the same numpy inputs).

- ``_moe_resolve_impl`` on the reference's meshes (a world of one here:
  the port reads only the mesh's axis sizes, given by a stand-in);
- ``moe_mlp_dropless_ep`` on (ep=4) and (dp=2, ep=2), and
  ``moe_mlp_dropless_sharded`` on (dp=2): each rank's output rows, the
  global router aux and z, and the gradients of ``sum(y * g) + 0.3 *
  (aux + 0.001 z)`` for x and every weight (the weights laid out by the
  model's rules and gathered as the model gathers them; each rank's
  gradient shard placed at its bounds) within rtol 1e-4 / atol 1e-5;
  the "gmm" dispatch equals the "fused" one;
- 5-step trajectories of the tiny dropless MoE config on (dp=2, ep=2)
  and of the gshard one on (ep=4) (8 experts, as the reference's
  ``test_ep4_moe_train``): loss and grad norm each step within rtol
  1e-4, final params within rtol 1e-4 / atol 1e-5.

Each world runs in its own subprocesses with a timeout (``run_world``).
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.models import moe as jax_moe
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel import mesh as port_mesh
from dlrover_tpu_torch.parallel import sharding
from tests.test_torch_sharded_train import check_trajectory, run_world

AUX_WEIGHT = 0.3


class _AxisSizes:
    """The axis sizes of a mesh, as ``sharding.axis_size`` reads them."""

    mesh_dim_names = port_mesh.AXIS_NAMES

    def __init__(self, config):
        self._shape = config.shape

    def size(self, dim=None):
        return math.prod(self._shape) if dim is None else self._shape[dim]


@pytest.mark.parametrize("mesh_kw", [None, {"ep": 2, "dp": 4}, {"dp": 8}],
                         ids=["none", "ep2_dp4", "dp8"])
@pytest.mark.parametrize("kw", [
    dict(), dict(capacity_factor=2.0), dict(moe_impl="dropless"),
    dict(moe_impl="gshard")], ids=["auto", "auto_cap2", "dropless",
                                   "gshard"])
def test_moe_resolve_impl_matches_jax(mesh_kw, kw):
    jcfg = jax_llama.tiny_config(n_experts=4, **kw)
    cfg = llama.TpuLMConfig(**dataclasses.asdict(jcfg))
    if mesh_kw is None:
        assert llama._moe_resolve_impl(cfg) == jax_llama._moe_resolve_impl(
            jcfg)
        return
    with build_mesh(MeshConfig(**mesh_kw)):
        want = jax_llama._moe_resolve_impl(jcfg)
    with sharding.use_mesh(_AxisSizes(port_mesh.MeshConfig(**mesh_kw))):
        assert llama._moe_resolve_impl(cfg) == want


def _inputs(e, rows=8, seq=8, d=16, f=32, seed=11):
    rs = np.random.RandomState(seed)
    return {
        "x": rs.randn(rows, seq, d).astype(np.float32),
        "gout": rs.randn(rows, seq, d).astype(np.float32),
        "router": rs.randn(d, e).astype(np.float32),
        "w_gate": (rs.randn(e, d, f) / np.sqrt(d)).astype(np.float32),
        "w_up": (rs.randn(e, d, f) / np.sqrt(d)).astype(np.float32),
        "w_down": (rs.randn(e, f, d) / np.sqrt(f)).astype(np.float32),
        "top_k": 2, "aux_weight": AUX_WEIGHT,
    }


def _jax_moe(inp, impl, mesh_kw):
    n = math.prod(mesh_kw.values())
    mesh = build_mesh(MeshConfig(**mesh_kw), jax.devices()[:n])
    fn = (jax_moe.moe_mlp_dropless_ep if impl == "ep"
          else jax_moe.moe_mlp_dropless_sharded)
    names = ("x", "router", "w_gate", "w_up", "w_down")

    def loss(*args):
        y, m = fn(*args, mesh, top_k=inp["top_k"])
        aux = m.aux_loss + 0.001 * m.router_z_loss
        return jnp.sum(y * inp["gout"]) + AUX_WEIGHT * aux, (y, m)

    with mesh:
        (_, (y, m)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=tuple(range(5)), has_aux=True))(
                *(jnp.asarray(inp[k]) for k in names))
    return (np.asarray(y), float(m.aux_loss), float(m.router_z_loss),
            dict(zip(names, map(np.asarray, grads))))


MOE_WORLDS = [
    pytest.param("ep", {"ep": 4}, 8, id="ep4"),
    pytest.param("ep", {"dp": 2, "ep": 2}, 4, id="dp2_ep2"),
    pytest.param("sharded", {"dp": 2}, 4, id="sharded_dp2"),
]


@pytest.mark.parametrize("impl,mesh_kw,experts", MOE_WORLDS)
def test_dropless_moe_on_a_world_matches_jax(tmp_path, impl, mesh_kw,
                                              experts):
    inp = _inputs(experts)
    want_y, want_aux, want_z, want_g = _jax_moe(inp, impl, mesh_kw)
    world = math.prod(mesh_kw.values())
    outs = run_world("moe", tmp_path, dict(inp, mesh=mesh_kw, impl=impl),
                     world)
    for dispatch in ("fused", "gmm"):
        got_y = np.zeros_like(want_y)
        got_dx = np.zeros_like(want_g["x"])
        got_w = {k: np.full_like(want_g[k], np.nan)
                 for k in ("router", "w_gate", "w_up", "w_down")}
        for out in outs:
            o = out[dispatch]
            lo, hi = o["rows"]
            got_y[lo:hi] = o["y"]
            got_dx[lo:hi] = o["dx"]
            np.testing.assert_allclose(o["aux"], want_aux, rtol=1e-4)
            np.testing.assert_allclose(o["z"], want_z, rtol=1e-4)
            for k, (bounds, g) in o["grads"].items():
                got_w[k][tuple(slice(a, b) for a, b in bounds)] = g
        np.testing.assert_allclose(got_y, want_y, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_dx, want_g["x"], rtol=1e-4, atol=1e-5)
        for k, g in got_w.items():
            np.testing.assert_allclose(g, want_g[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{dispatch} {k}")


TRAJECTORIES = [
    pytest.param(dict(n_experts=4, moe_impl="dropless"), {"dp": 2, "ep": 2},
                 id="dropless_dp2_ep2"),
    pytest.param(dict(n_experts=8), {"ep": 4}, id="gshard_ep4"),
]


@pytest.mark.parametrize("kw,mesh_kw", TRAJECTORIES)
def test_moe_trajectory_on_a_world_matches_jax(tmp_path, kw, mesh_kw):
    check_trajectory(tmp_path, jax_llama.tiny_config(n_layers=2, **kw),
                     mesh_kw)

