"""Logical-axis sharding rules (the port of
``dlrover_tpu/parallel/sharding.py``).

Model code names each tensor's dims by *logical* axes; a rule table maps
those to mesh axes. The table, ``logical_to_spec`` (a mesh axis is used
at most once in a spec) and ``spec_tree`` are the reference's. A spec
(:class:`PartitionSpec`, one entry per dim: None, a mesh axis name or a
tuple of names) becomes DTensor placements on a ``DeviceMesh``
(:func:`placements`): ``Shard(dim)`` on the mesh dims the spec names,
``Replicate()`` elsewhere. That takes the place of ``NamedSharding``.

The train state lives as DTensors; the model computes on plain local
tensors (``jax.shard_map``'s view of the same layout):

- :func:`local_param` turns a param (a :class:`ShardedParam`: a DTensor's
  local shard and its placements) into the local tensor a layer
  computes with: its dims sharded off tp gathered (all-gather over dp,
  and over ep where the experts are not kept local), its tp shards
  kept. Its backward reduce-scatters the gradient over the gathered
  axes and sums it over the batch axes and sp where the param is
  replicated (each of those ranks holds a share of the loss). The
  expert-parallel MoE keeps its experts' ep shard local
  (``keep=("ep",)``) and gathers their tp shard
  (``gather_tp=True``): every tp rank runs the whole expert FFN.
- :func:`stage_param` takes one pipeline stage of a layer param whose
  stage dim is sharded over pp: the stage is this rank's own, so no
  collective runs over pp (the pipeline sums the gradients of the
  params replicated over pp, embedding and unembedding, in the train
  step).
- :func:`copy_to_tp` and :func:`reduce_from_tp` are the two collectives
  of tensor parallelism: the input of a column-parallel product (its
  gradient summed over tp) and the output of a row-parallel one (summed
  over tp in the forward); :func:`mean_over_shares` averages a
  statistic over the ranks that hold distinct tokens (the MoE router's
  global means), its gradient summed back.

``use_mesh(mesh)`` takes the place of ``with mesh:``; outside it every
helper here is an identity, so the one-device path is unchanged.
"""

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]

BATCH_AXES = ("dcn", "dp", "ep")
# Axes whose ranks hold distinct tokens of a micro-batch: the batch axes
# and sp (a contiguous chunk of every sequence). A param replicated over
# one of them has its gradient summed over it.
SHARE_AXES = BATCH_AXES + ("sp",)
# Placement of a mesh dim whose shard a layer keeps as it is: a pipeline
# stage taken by stage_param (its own over pp, nothing to reduce).
LOCAL = "local"

# logical axis -> mesh axis (or tuple of mesh axes): the reference's.
DEFAULT_RULES: Tuple[Tuple[str, MeshAxes], ...] = (
    ("batch", ("dcn", "dp", "ep")),
    ("seq", "sp"),
    ("embed", "dp"),       # FSDP: params' embed dim sharded over dp (ZeRO)
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("head_dim", None),
    ("mlp", "tp"),
    ("vocab", "tp"),
    ("stage", "pp"),
    ("layer", None),
    ("expert", "ep"),
    ("capacity", None),
    ("norm", None),
    ("micro", None),
)


class PartitionSpec(tuple):
    """One entry per dim: None, a mesh axis, or a tuple of mesh axes
    (major first). ``PartitionSpec()`` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def rules_dict(
    rules: Sequence[Tuple[str, MeshAxes]] = DEFAULT_RULES,
) -> Dict[str, MeshAxes]:
    return dict(rules)


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    rules: Sequence[Tuple[str, MeshAxes]] = DEFAULT_RULES,
) -> PartitionSpec:
    """("batch","seq","embed") -> P(("dcn","dp","ep"), "sp", None)."""
    table = rules_dict(rules)
    out = []
    used = set()
    for ax in logical_axes:
        mesh_ax = table.get(ax) if ax is not None else None
        # A mesh axis may appear at most once in a spec; later logical
        # axes that map to an already-used mesh axis stay unsharded.
        if mesh_ax is None:
            out.append(None)
            continue
        flat = (mesh_ax,) if isinstance(mesh_ax, str) else tuple(mesh_ax)
        free = tuple(a for a in flat if a not in used)
        if not free:
            out.append(None)
            continue
        used.update(free)
        out.append(free[0] if len(free) == 1 else free)
    return P(*out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, PartitionSpec) and all(
        a is None or isinstance(a, str) for a in x)


def spec_tree(logical_tree, rules=DEFAULT_RULES):
    """Map a tree (nested dicts) of logical-axis tuples to specs."""
    if isinstance(logical_tree, dict):
        return {k: spec_tree(v, rules) for k, v in logical_tree.items()}
    if _is_axes(logical_tree):
        return logical_to_spec(logical_tree, rules)
    raise TypeError(f"not a logical-axes tuple: {logical_tree!r}")


def placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    by_axis = {}
    for dim, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            by_axis[axis] = Shard(dim)
    unknown = set(by_axis) - set(mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {unknown} not in the mesh")
    return [by_axis.get(name, Replicate()) for name in mesh.mesh_dim_names]


def shard_bounds(global_shape, mesh, places, coord=None
                 ) -> Tuple[Tuple[int, int], ...]:
    """The ``(lo, hi)`` per dim of the shard at mesh coordinate
    ``coord`` (this rank's by default) under ``places``: a dim sharded
    over several mesh dims splits in mesh-dim order, major first, as
    JAX splits a dim over a tuple of axes. Dims must split evenly."""
    from torch.distributed.tensor import Shard

    if coord is None:
        coord = mesh.get_coordinate()
    sizes = mesh.mesh.shape
    lo = [0] * len(global_shape)
    ext = list(global_shape)
    for mdim, place in enumerate(places):
        if not isinstance(place, Shard):
            continue
        d, n = place.dim, sizes[mdim]
        if ext[d] % n:
            raise ValueError(
                f"dim {d} of {tuple(global_shape)} does not split evenly "
                f"over mesh axis {mesh.mesh_dim_names[mdim]} ({n})")
        ext[d] //= n
        lo[d] += coord[mdim] * ext[d]
    return tuple((a, a + e) for a, e in zip(lo, ext))


def shard_tensor(full: torch.Tensor, mesh, spec: PartitionSpec):
    """A DTensor of ``full`` (the same global tensor on every rank) laid
    out by ``spec``: each rank keeps a contiguous copy of its slice."""
    from torch.distributed.tensor import DTensor

    places = placements(spec, mesh)
    bounds = shard_bounds(full.shape, mesh, places)
    local = full[tuple(slice(a, b) for a, b in bounds)].contiguous()
    return DTensor.from_local(local, mesh, places, run_check=False)


# ---- the active mesh -------------------------------------------------------

_active = threading.local()


def current_mesh():
    """The mesh of the innermost :func:`use_mesh` on this thread, if
    any."""
    stack = getattr(_active, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` current on this thread (the reference's ``with
    mesh:``)."""
    stack = getattr(_active, "stack", None)
    if stack is None:
        stack = _active.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def axis_size(name: str, mesh=None) -> int:
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def with_logical_constraint(x, logical_axes: Sequence[Optional[str]],
                            rules=DEFAULT_RULES):
    """Lay ``x`` out by logical axes under the current mesh. No-op
    outside a mesh, as in the reference, and for a plain local tensor:
    the model's local tensors already hold the layout the rules give
    (batch over the batch axes, heads/mlp/vocab over tp). A DTensor is
    redistributed to the spec's placements."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(
        logical_to_spec(logical_axes, rules), mesh))


# ---- local compute ---------------------------------------------------------


class ShardedParam:
    """A DTensor param as the model computes with it: its local shard
    (in the train step, the autograd leaf) and its layout. The train
    step hands the model these, never DTensors: every product and
    collective runs on plain local tensors."""

    __slots__ = ("local", "mesh", "placements")

    def __init__(self, local: torch.Tensor, mesh, placements):
        self.local = local
        self.mesh = mesh
        self.placements = tuple(placements)

    def to(self, dtype) -> "ShardedParam":
        return ShardedParam(self.local.to(dtype), self.mesh, self.placements)

    @property
    def shape(self):
        """The local shard's shape."""
        return self.local.shape


def local_shard(p):
    """The local shard of DTensor ``p``: the tensor that holds its bytes
    (``p`` itself for a plain tensor)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return p
    with torch.no_grad():
        return p.to_local()


def local_param(p, index: Optional[int] = None, keep: Sequence[str] = (),
                gather_tp: bool = False):
    """The local tensor a layer computes with, from a param ``p``.

    A plain tensor is returned as it is (``p[index]``). A
    :class:`ShardedParam` is indexed on its leading (unsharded layer)
    dim; its dims sharded over a mesh axis other than tp and not in
    ``keep`` are gathered (backward: the gradient reduce-scattered), and
    over each of :data:`SHARE_AXES` it is replicated on its gradient is
    summed. Its tp shards are kept, or with ``gather_tp`` gathered with a
    backward that keeps this rank's slice (the tp ranks compute the same
    gradient of the whole tensor)."""
    from torch.distributed.tensor import Shard

    if not isinstance(p, ShardedParam):
        return p if index is None else p[index]
    local, places, mesh = p.local, list(p.placements), p.mesh
    if index is not None:
        if any(isinstance(pl, Shard) and pl.dim == 0 for pl in places):
            raise ValueError("a param's indexed dim must not be sharded")
        local = local[index]
        places = [Shard(pl.dim - 1) if isinstance(pl, Shard) else pl
                  for pl in places]
    for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names, places)):
        n = mesh.size(i)
        if n == 1 or pl is LOCAL or name in keep:
            continue
        if name == "tp":
            if gather_tp and isinstance(pl, Shard):
                local = _GatherReplicated.apply(
                    local, mesh.get_group(name), pl.dim, n,
                    mesh.get_local_rank(name))
            continue
        if isinstance(pl, Shard):
            local = _GatherShard.apply(local, mesh.get_group(name), pl.dim,
                                       n)
        elif name in SHARE_AXES:
            local = _CopyToGroup.apply(local, mesh.get_group(name))
    return local


def stage_param(p, stage: int):
    """Stage ``stage`` (an index into this rank's own stages) of a layer
    param stored ``[stages, layers_per_stage, ...]``: a plain tensor's
    ``p[stage]``; a :class:`ShardedParam`'s local ``[stage]`` with its pp
    placement :data:`LOCAL`, so :func:`local_param` leaves pp alone."""
    from torch.distributed.tensor import Shard

    if not isinstance(p, ShardedParam):
        return p[stage]
    places = []
    for pl in p.placements:
        if isinstance(pl, Shard):
            pl = LOCAL if pl.dim == 0 else Shard(pl.dim - 1)
        places.append(pl)
    return ShardedParam(p.local[stage], p.mesh, places)


class _GatherShard(torch.autograd.Function):
    """All-gather along ``dim`` forward; reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, group, dim, n):
        import torch.distributed as dist

        ctx.group, ctx.dim, ctx.n = group, dim, n
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + src.shape[1:])
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        src = g.movedim(ctx.dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // ctx.n,) + src.shape[1:])
        dist.reduce_scatter_tensor(out, src, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward keeps this rank's slice
    of the gradient, which every rank of the group computed whole."""

    @staticmethod
    def forward(ctx, x, group, dim, n, rank):
        ctx.dim, ctx.n, ctx.rank = dim, n, rank
        return _GatherShard.forward(ctx, x, group, dim, n)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.n, dim=ctx.dim)[ctx.rank].contiguous(), None,
                None, None, None)


def axis_group(name: str):
    """The current mesh's process group of axis ``name``, or None without
    a mesh or where the axis has one rank."""
    mesh = current_mesh()
    if mesh is None or axis_size(name, mesh) == 1:
        return None
    return mesh.get_group(name)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product: the same on every tp rank,
    its gradient the sum of theirs. Identity without a tp axis."""
    group = axis_group("tp")
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sums, summed over tp (the
    gradient passes as it is). Identity without a tp axis."""
    group = axis_group("tp")
    return x if group is None else _ReduceFromGroup.apply(x, group)


def max_over_tp(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over tp, outside autograd."""
    group = axis_group("tp")
    if group is None:
        return x
    import torch.distributed as dist

    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


class _SumOverGroup(torch.autograd.Function):
    """Sum over the group forward and backward: the autograd-true
    all-reduce of a partial sum whose consumers on every rank hold
    shares of the loss."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def share_groups(mesh=None):
    """Process groups of the current mesh's :data:`SHARE_AXES` above one
    rank (an empty list without a mesh)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return []
    return [mesh.get_group(a) for a in SHARE_AXES if axis_size(a, mesh) > 1]


def share_count(mesh=None) -> int:
    """How many ranks hold distinct tokens of one micro-batch: the
    product of the :data:`SHARE_AXES` sizes (1 without a mesh)."""
    mesh = mesh if mesh is not None else current_mesh()
    n = 1
    for a in SHARE_AXES:
        n *= axis_size(a, mesh)
    return n


def mean_over_shares(x: torch.Tensor) -> torch.Tensor:
    """The mean of a per-rank mean over the ranks of :func:`share_groups`
    (each holds as many tokens), differentiable: the global mean of a
    statistic the reference computes over the whole batch."""
    groups = share_groups()
    for group in groups:
        x = _SumOverGroup.apply(x, group)
    return x / share_count() if groups else x


def tp_rank() -> int:
    mesh = current_mesh()
    if mesh is None:
        return 0
    return mesh.get_local_rank("tp")


def batch_index(mesh) -> Tuple[int, int]:
    """(this rank's index, count) over the batch axes, major first:
    the row block of a batch dim sharded over ("dcn", "dp", "ep")."""
    idx, count = 0, 1
    for name in BATCH_AXES:
        n = axis_size(name, mesh)
        idx = idx * n + mesh.get_local_rank(name)
        count *= n
    return idx, count


def replication(p) -> int:
    """How many ranks hold each element of DTensor ``p``."""
    from torch.distributed.tensor import Replicate

    mesh = p.device_mesh
    out = 1
    for i, pl in enumerate(p.placements):
        if isinstance(pl, Replicate):
            out *= mesh.size(i)
    return out
