"""Ring attention of the port (``ops/ring_attention.py``) on gloo worlds of
4 CPU processes, (sp=2, tp=2) and (sp=4), against the JAX package's
``make_ring_attention`` (both impls, the "pallas" one in interpret mode)
and dense attention on the same meshes over 4 of its 8 virtual CPU
devices: f32, b=2, s=32, h=4, kv heads 2, d=16, causal and not; every
rank's output and its gradients of ``sum(out * g)`` for q, k and v
placed at its rows, sequence chunk and heads, within rtol 1e-4 / atol
1e-5 (the "pallas" impl runs the plain versions of B1/B2 here).

Also: positions reset within a chunk give NaN through "pallas" and the
dense answer through "xla"; an unknown impl raises; the one-process hop
runner (every rank's chunk in one process, what chip_smoke's
``ring_hops`` phase runs on the card) gives what the gloo ring gave;
and a 5-step trajectory on (dp=2, sp=2) against JAX's
``make_train_step`` (which picks ring attention on an sp mesh).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.ops.attention import dot_product_attention
from dlrover_tpu.ops.ring_attention import make_ring_attention
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu_torch.ops import ring_attention as ra
from tests.test_torch_sharded_train import check_trajectory, run_world

B, S, H, KH, D = 2, 32, 4, 2, 16
CASES = [(impl, causal) for impl in ("xla", "pallas")
         for causal in (True, False)]


def _inputs(seed=3):
    rs = np.random.RandomState(seed)
    return {
        "q": rs.randn(B, S, H, D).astype(np.float32),
        "k": rs.randn(B, S, KH, D).astype(np.float32),
        "v": rs.randn(B, S, KH, D).astype(np.float32),
        "gout": rs.randn(B, S, H, D).astype(np.float32),
    }


def _jax(inp, mesh_kw):
    """{(impl, causal): (out, dq, dk, dv)} of JAX's ring on the mesh, and
    the same of dense attention under the key "dense"."""
    n = math.prod(mesh_kw.values())
    mesh = build_mesh(MeshConfig(**mesh_kw), jax.devices()[:n])
    q, k, v, g = (jnp.asarray(inp[n]) for n in ("q", "k", "v", "gout"))
    res = {}
    fns = {impl: make_ring_attention(mesh, impl=impl)
           for impl in ("xla", "pallas")}
    fns["dense"] = dot_product_attention
    with mesh:
        for name, fn in fns.items():
            for causal in (True, False):
                def loss(q, k, v, fn=fn, causal=causal):
                    out = fn(q, k, v, causal=causal)
                    return jnp.sum(out * g), out

                (_, out), grads = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
                res[(name, causal)] = [np.asarray(out)] + [
                    np.asarray(t) for t in grads]
    return res


WORLDS = [pytest.param({"sp": 2, "tp": 2}, id="sp2_tp2"),
          pytest.param({"sp": 4}, id="sp4")]


@pytest.fixture(scope="module", params=WORLDS)
def world(request, tmp_path_factory):
    """One gloo world per mesh (every case of the mesh in one launch),
    with the JAX results on the same mesh and each rank's slices
    assembled into global arrays."""
    mesh_kw = request.param
    inp = _inputs()
    outs = run_world("ring", tmp_path_factory.mktemp("ring"),
                     dict(inp, mesh=mesh_kw), math.prod(mesh_kw.values()))
    got = {}
    for case in CASES:
        arrs = [np.full_like(inp[n], np.nan) for n in ("q", "q", "k", "v")]
        for out in outs:
            sl = out["slices"]
            rows, seq = slice(*sl["rows"]), slice(*sl["seq"])
            for a, t, heads in zip(arrs, out["ring"][case],
                                   ("heads", "heads", "kv_heads",
                                    "kv_heads")):
                a[rows, seq, slice(*sl[heads])] = t
        got[case] = arrs
    return {"mesh": mesh_kw, "inp": inp, "outs": outs, "got": got,
            "jax": _jax(inp, mesh_kw)}


@pytest.mark.parametrize("impl,causal", CASES)
@pytest.mark.parametrize("against", ["jax_ring", "dense"])
def test_ring_matches_jax(world, impl, causal, against):
    want = world["jax"][(impl if against == "jax_ring" else "dense",
                         causal)]
    for name, g, w in zip(("out", "dq", "dk", "dv"),
                          world["got"][(impl, causal)], want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_packed_positions_poison_pallas_only(world):
    # As the worker builds them: every chunk holds two runs.
    runs = 2 * world["mesh"]["sp"]
    packed = np.tile(np.arange(S // runs), runs)
    want = np.asarray(dot_product_attention(
        *(jnp.asarray(world["inp"][n]) for n in ("q", "k", "v")),
        causal=True, q_positions=jnp.asarray(packed),
        kv_positions=jnp.asarray(packed)))
    for out in world["outs"]:
        assert np.isnan(out["packed"]["pallas"]).all()
        sl = out["slices"]
        np.testing.assert_allclose(
            out["packed"]["xla"],
            want[slice(*sl["rows"]), slice(*sl["seq"]), slice(*sl["heads"])],
            rtol=1e-4, atol=1e-5)


def test_unknown_impl_raises(world):
    for out in world["outs"]:
        assert "impl" in out["bad_impl"]
    with pytest.raises(ValueError, match="impl"):
        ra._ring_impl("flash", "cpu")
    assert ra._ring_impl(None, "cuda") == "pallas"
    assert ra._ring_impl("auto", "cpu") == "xla"


@pytest.mark.parametrize("causal", [True, False])
def test_one_process_runner_equals_the_gloo_ring(world, causal):
    """The hop loops driven with every rank's chunk in this process give
    the gloo ring's "pallas" outputs and gradients (each rank there
    holds some heads; the runner runs all heads of a chunk at once)."""
    n = world["mesh"]["sp"]
    inp = world["inp"]
    sl = S // n
    chunks = {name: [torch.from_numpy(np.ascontiguousarray(
        inp[name][:, r * sl:(r + 1) * sl])) for r in range(n)]
        for name in ("q", "k", "v", "gout")}
    offsets = [r * sl for r in range(n)]
    fwd = ra.one_process_ring_forward(chunks["q"], chunks["k"],
                                      chunks["v"], offsets, causal)
    bwd = ra.one_process_ring_backward(
        chunks["q"], chunks["k"], chunks["v"], [o for o, _ in fwd],
        [lse for _, lse in fwd], chunks["gout"], offsets, causal)
    got = [np.concatenate([t[i].numpy() for t in parts], axis=1)
           for i, parts in ((0, fwd), (0, bwd), (1, bwd), (2, bwd))]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got,
                          world["got"][("pallas", causal)]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_lm_trajectory_on_dp2_sp2_matches_jax(tmp_path):
    check_trajectory(tmp_path, jax_llama.tiny_config(n_layers=2),
                     {"dp": 2, "sp": 2})
