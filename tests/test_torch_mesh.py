"""The port's mesh helpers and sharding rules against the JAX package
(no processes): ``MeshConfig``, ``factorize_devices``,
``mesh_config_for_slices`` and the legal host shapes on a grid of device
counts; ``logical_to_spec`` for every logical tuple the model uses; and,
for every leaf of ``state_specs`` (tiny dense config) on four meshes over
2 or 4 of the 8 virtual devices, the port's placements and each rank's
local shard bounds against the index JAX's ``NamedSharding`` gives the
same device. (Rank r sits at the row-major coordinate of r, as
``init_device_mesh`` lays out ``arange(world)``; the gloo worlds of
``test_torch_sharded_train.py`` check it on a live mesh.)"""

import dataclasses
import types

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel import mesh as jax_mesh
from dlrover_tpu.parallel import sharding as jax_sharding
from dlrover_tpu.trainer import train_step as jax_ts
from dlrover_tpu_torch.models import convert, llama
from dlrover_tpu_torch.parallel import mesh, sharding
from dlrover_tpu_torch.trainer import train_step as ts

COUNTS = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256]


@pytest.mark.parametrize("n", COUNTS)
def test_mesh_configs_match_reference(n):
    for kw in ({}, {"max_tp": 2, "max_pp": 1},
               {"want_sp": False, "want_ep": False}):
        want = jax_mesh.factorize_devices(n, **kw)
        got = mesh.factorize_devices(n, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.shape, got.num_devices, got.data_parallel_size,
                got.devices_per_slice, got.describe()) == (
            want.shape, want.num_devices, want.data_parallel_size,
            want.devices_per_slice, want.describe())
    for slices in (1, 2, 4):
        if n % slices:
            with pytest.raises(ValueError):
                mesh.mesh_config_for_slices(n, slices)
            continue
        assert dataclasses.asdict(mesh.mesh_config_for_slices(
            n, slices, max_tp=4)) == dataclasses.asdict(
            jax_mesh.mesh_config_for_slices(n, slices, max_tp=4))
    assert mesh.legal_mesh_shapes(n) == jax_mesh.legal_mesh_shapes(n)
    assert mesh.largest_legal_hosts(n, 8) == jax_mesh.largest_legal_hosts(
        n, 8)
    assert mesh.AXIS_NAMES == jax_mesh.AXIS_NAMES
    assert mesh.parse_mesh("", n) == mesh.MeshConfig(dp=n)


def _logical_tuples():
    tuples = set()

    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)
            else:
                tuples.add(v)

    for cfg in (llama.tiny_config(), llama.tiny_config(n_experts=4),
                llama.tiny_config(pp_stages=2)):
        walk(llama.param_axes(cfg))
    # The activations the model constrains.
    tuples |= {("batch", "seq", "heads", "head_dim"),
               ("batch", "seq", "kv_heads", "head_dim"),
               ("batch", "seq", "embed"), ("batch", "seq", "mlp"),
               ("batch", "seq", "vocab"), ("vocab", None), ("batch", None),
               ("embed", "vocab")}
    return sorted(tuples, key=str)


def test_param_axes_and_specs_match_reference():
    for cfg_kw in ({}, {"n_experts": 4}, {"pp_stages": 2}):
        jcfg = jax_llama.tiny_config(**cfg_kw)
        cfg = llama.TpuLMConfig(**dataclasses.asdict(jcfg))
        assert llama.param_axes(cfg) == jax_llama.param_axes(jcfg)
    for axes in _logical_tuples():
        assert tuple(sharding.logical_to_spec(axes)) == tuple(
            jax_sharding.logical_to_spec(axes)), axes
    assert tuple(ts.batch_spec()) == tuple(jax_ts.batch_spec())


def _stub_mesh(config):
    """The shape and names a ``DeviceMesh`` of ``config`` has."""
    return types.SimpleNamespace(mesh=np.zeros(config.shape),
                                 mesh_dim_names=mesh.AXIS_NAMES)


def _bounds(index, shape):
    return tuple((s.start or 0, shape[d] if s.stop is None else s.stop)
                 for d, s in enumerate(index))


@pytest.mark.parametrize("mesh_kw", [{"dp": 4}, {"dp": 2, "tp": 2},
                                     {"dcn": 2, "dp": 2}, {"tp": 2}],
                         ids=["dp4", "dp2_tp2", "dcn2_dp2", "tp2"])
def test_state_shard_bounds_match_jax(mesh_kw):
    jcfg = jax_llama.tiny_config()
    cfg = llama.TpuLMConfig(**dataclasses.asdict(jcfg))
    config = mesh.MeshConfig(**mesh_kw)
    n = config.num_devices
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(**mesh_kw),
                                jax.devices()[:n])
    jspecs = jax_ts.state_specs(jcfg, jax_ts.make_optimizer(jax_ts.
                                                            TrainConfig()))
    adam = convert._adam_state(jspecs["opt_state"])
    pairs = {"params": jspecs["params"], "exp_avg": adam.mu,
             "exp_avg_sq": adam.nu}
    specs = ts.state_specs(cfg)
    ported = {"params": specs["params"],
              "exp_avg": specs["opt_state"]["exp_avg"],
              "exp_avg_sq": specs["opt_state"]["exp_avg_sq"]}
    shapes = jax.eval_shape(lambda: jax_llama.init_params(
        jcfg, jax.random.key(0))[0])
    stub = _stub_mesh(config)
    checked = 0
    for group, jtree in pairs.items():
        for path, jspec in jax.tree_util.tree_leaves_with_path(
                jtree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec)):
            keys = [k.key for k in path]
            spec, shape = ported[group], shapes
            for k in keys:
                spec, shape = spec[k], shape[k]
            shape = tuple(shape.shape)
            assert tuple(spec) == tuple(jspec), (group, keys)
            places = sharding.placements(spec, stub)
            imap = NamedSharding(jmesh, jspec).devices_indices_map(shape)
            for rank, dev in enumerate(jax.devices()[:n]):
                coord = np.unravel_index(rank, config.shape)
                got = sharding.shard_bounds(shape, stub, places, coord)
                assert got == _bounds(imap[dev], shape), (group, keys, rank)
            checked += 1
    assert checked == 3 * 12
    # Counts and the step are replicated, as the reference's.
    assert adam.count == jax.sharding.PartitionSpec()
    assert all(s == sharding.P() for s in ts.param_leaves(
        specs["opt_state"]["step"])) and specs["step"] == sharding.P()


def test_uneven_split_and_unknown_axis_raise():
    stub = _stub_mesh(mesh.MeshConfig(tp=4))
    places = sharding.placements(sharding.P(None, "tp"), stub)
    with pytest.raises(ValueError, match="evenly"):
        sharding.shard_bounds((2, 6), stub, places, (0,) * 6)
    with pytest.raises(ValueError, match="not in the mesh"):
        sharding.placements(sharding.P("x"), stub)
    # Outside a mesh every helper is an identity.
    x = np.ones(3)
    assert sharding.current_mesh() is None
    assert sharding.with_logical_constraint(x, ("batch",)) is x
