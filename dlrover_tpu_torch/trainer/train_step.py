"""Training step factory (port of
``dlrover_tpu/trainer/train_step.py``), on one device or sharded over a
mesh.

``step(state, batch) -> (state, metrics)`` as in the reference: the
batch's leading dim splits into ``grad_accum`` micro-batches whose
gradients average in f32, the global grad norm is taken on the averaged
(unclipped) gradients, then clip-by-global-norm and AdamW under a
warmup-cosine schedule update the f32 master params. PyTorch updates
the params and the optimizer moments in place (the reference returns
new arrays); the returned state is the same dict with ``step`` advanced.
Before those in-place writes the step waits on the CUDA events in the
state's ``"fences"`` (a flash checkpoint's device-to-host copy of the
previous state, see ``flash_ckpt/engine.py``). ``state_tree`` views the
state as a tree of tensors for the checkpoint engine, and
``load_state_tree_`` restores one into it in place.

Given a ``mesh`` (``parallel.mesh.build_mesh``) the state lives as
DTensors laid out by ``state_specs`` (the reference's: params by
``llama.param_axes`` and the rule table, FSDP over dp and TP over tp;
Adam's moments inherit the param specs, counts replicated), and the
step splits each micro-batch's rows over the batch axes ("dcn", "dp",
"ep") and, under sp, each sequence into contiguous chunks over sp (the
attention is then ring attention, as the reference's step picks it).
Each rank computes its tokens on local tensors (``parallel.sharding``)
and differentiates its share of the global loss: its tokens' mean over
the number of ranks holding distinct tokens (batch axes times sp), and
under a pp axis only the rank of the last stage holds the CE
(``trainer/pipeline.py``). The gradients of params replicated over pp
(embedding, unembedding, final norm) are summed over pp after the
backward. The loss and the metrics are the global means, the grad norm
counts each element once, and clipping and AdamW run on the local
shards. A world of one runs the same code with every collective an
identity. A pp axis above 1 without pipeline stages raises
``NotImplementedError`` (ROADMAP §A, cases the port refuses).
"""

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import torch

from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel import sharding
from dlrover_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    P,
    ShardedParam,
    local_shard,
    logical_to_spec,
    spec_tree,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    grad_accum: int = 1              # microbatches per step (fixed batch)


def warmup_cosine_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """lr as a function of the update count: optax's
    ``warmup_cosine_decay_schedule(0, lr, max(warmup, 1), 100_000,
    0.1 * lr)``. Count 0 gives lr 0, so the first update moves nothing
    (the moments still take the first gradient)."""
    peak = tc.learning_rate
    warmup = max(tc.warmup_steps, 1)
    decay = 100_000 - warmup
    alpha = 0.0 if peak == 0.0 else (0.1 * peak) / peak

    def schedule(count: int) -> float:
        count = float(count)
        if count < warmup:
            frac = 1.0 - min(max(count, 0.0), warmup) / warmup
            return -peak * frac + peak
        c = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


def param_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """The param tree's tensors in a fixed order."""
    out = []
    for name in sorted(params):
        value = params[name]
        if isinstance(value, dict):
            out.extend(param_leaves(value))
        else:
            out.append(value)
    return out


def global_norm(tensors, replication=None) -> torch.Tensor:
    """sqrt of the summed squares of every element, in f32. With
    ``replication`` (per tensor, how many ranks of the world hold each of
    its elements) the tensors are local shards and the sum runs over the
    world's, each element counted once."""
    if replication is None:
        return torch.sqrt(sum(t.float().square().sum() for t in tensors))
    total = sum(t.float().square().sum() / r
                for t, r in zip(tensors, replication))
    torch.distributed.all_reduce(total)
    return torch.sqrt(total)


def clip_by_global_norm_(grads, max_norm: float, norm: torch.Tensor):
    """optax's clip, in place and without a host sync: ``g / norm *
    max_norm`` when ``norm >= max_norm``, else ``g`` unchanged (no
    epsilon, unlike ``torch.nn.utils.clip_grad_norm_``)."""
    keep = norm < max_norm
    denom = torch.where(keep, torch.ones_like(norm), norm)
    mult = torch.where(keep, torch.ones_like(norm),
                       torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(denom).mul_(mult)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Clip by global norm, then AdamW on every leaf (decay unmasked)
    with the warmup-cosine lr: the reference's optax chain. ``init``
    builds the moments over the given params; ``update`` applies one
    step in place. DTensor params are updated through their local
    shards, which AdamW's state is keyed by."""

    tc: TrainConfig

    @property
    def schedule(self):
        return warmup_cosine_schedule(self.tc)

    def init(self, params) -> torch.optim.AdamW:
        tc = self.tc
        return torch.optim.AdamW(
            [local_shard(p) for p in param_leaves(params)], lr=0.0,
            betas=(tc.beta1, tc.beta2), eps=1e-8,
            weight_decay=tc.weight_decay, foreach=True,
        )

    def update(self, opt_state: torch.optim.AdamW, params, grads,
               norm: torch.Tensor, count: int) -> None:
        """``grads`` in ``param_leaves`` order (local shards for DTensor
        params); ``count`` updates so far (the schedule's argument)."""
        clip_by_global_norm_(grads, self.tc.grad_clip, norm)
        leaves = [local_shard(p) for p in param_leaves(params)]
        for p, g in zip(leaves, grads):
            p.grad = g
        opt_state.param_groups[0]["lr"] = self.schedule(count)
        opt_state.step()
        for p in leaves:
            p.grad = None


def make_optimizer(tc: TrainConfig) -> Optimizer:
    return Optimizer(tc)


# ---------------------------------------------------------------------------
# State & sharding layout
# ---------------------------------------------------------------------------


def state_specs(config: llama.TpuLMConfig, optimizer: Optimizer = None,
                rules=DEFAULT_RULES) -> Dict[str, Any]:
    """Spec tree of ``state_tree``'s structure: the params' from
    ``llama.param_axes``, Adam's moments inheriting them (ZeRO), the
    per-leaf counts and the step replicated. (``optimizer`` is the
    reference's argument; AdamW's state has one layout.)"""
    param_specs = spec_tree(llama.param_axes(config), rules)
    return {
        "params": param_specs,
        "opt_state": {
            "exp_avg": param_specs,
            "exp_avg_sq": param_specs,
            "step": params_like(param_specs, lambda _: P()),
        },
        "step": P(),
    }


def state_shardings(specs, mesh):
    """Spec tree -> DTensor placements tree on ``mesh``."""
    return params_like(specs, lambda s: sharding.placements(s, mesh))


def batch_spec(rules=DEFAULT_RULES):
    # tokens [batch, seq+1]: batch over the batch axes; seq unsharded.
    return logical_to_spec(("batch", None), rules)


def _require_mesh_path(config: llama.TpuLMConfig, mesh) -> None:
    """Raise for the mesh cases the port refuses (ROADMAP §A)."""
    if sharding.axis_size("pp", mesh) > 1 and config.pp_stages == 1:
        raise NotImplementedError(
            "a pp axis above 1 with pp_stages 1: every pp rank would run "
            "the whole stack as a replica (ROADMAP §A, cases the port "
            "refuses); set pp_stages to a multiple of pp")
    with sharding.use_mesh(mesh):
        llama.require_run_moe(config)


def shard_params(config: llama.TpuLMConfig, params, mesh,
                 rules=DEFAULT_RULES):
    """A tree of full tensors (the same on every rank) as DTensors laid
    out by ``state_specs``: each rank keeps its slices."""
    specs = spec_tree(llama.param_axes(config), rules)
    return _zip_like(params, specs, lambda p, spec: sharding.shard_tensor(
        p, mesh, spec))


def _zip_like(tree, other, fn):
    return {k: _zip_like(v, other[k], fn) if isinstance(v, dict)
            else fn(v, other[k]) for k, v in tree.items()}


def init_train_state(config: llama.TpuLMConfig, optimizer: Optimizer,
                     params, mesh=None, rules=DEFAULT_RULES
                     ) -> Dict[str, Any]:
    """{"params", "opt_state", "step"} over ``params`` (f32 master
    params; they become autograd leaves in place). With ``mesh`` the
    params are full tensors, the same on every rank (from one seed),
    or DTensors already laid out by ``state_specs``; each rank keeps its
    slices as DTensors on ``mesh``."""
    if mesh is not None:
        from torch.distributed.tensor import DTensor

        _require_mesh_path(config, mesh)
        if not isinstance(param_leaves(params)[0], DTensor):
            params = shard_params(config, params, mesh, rules)
    for p in param_leaves(params):
        if p.dtype != torch.float32:
            raise TypeError(f"master params must be f32, got {p.dtype}")
        local_shard(p).requires_grad_(True)
    return {"params": params, "opt_state": optimizer.init(params),
            "step": 0, "fences": []}


def params_like(params, fn):
    """A tree of ``params``' structure with ``fn(p)`` at each leaf."""
    return {k: params_like(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in params.items()}


def state_tree(state) -> Dict[str, Any]:
    """The train state as a tree of tensors: the params, AdamW's
    ``exp_avg``, ``exp_avg_sq`` and ``step`` per leaf (each a tree of
    the params' structure) and ``state["step"]``. The tensors are the
    live ones, so a checkpoint restored into this tree lands in place.
    AdamW's state is created as its first update would (zeros, count 0)
    where no update has run yet. For DTensor params the moments are
    DTensors of the params' layout over AdamW's local tensors."""
    from torch.distributed.tensor import DTensor

    params, opt = state["params"], state["opt_state"]
    for p in param_leaves(params):
        key = local_shard(p)
        if not opt.state[key]:
            opt.state[key] = {
                "step": torch.tensor(0.0, dtype=torch.float32),
                "exp_avg": torch.zeros_like(
                    key, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(
                    key, memory_format=torch.preserve_format),
            }

    def moment(p, name):
        t = opt.state[local_shard(p)][name]
        if isinstance(p, DTensor) and name != "step":
            with torch.no_grad():
                t = DTensor.from_local(t, p.device_mesh, p.placements,
                                       run_check=False)
        return t

    return {
        "params": params,
        "opt_state": {name: params_like(params,
                                        lambda p, n=name: moment(p, n))
                      for name in ("exp_avg", "exp_avg_sq", "step")},
        "step": state["step"],
    }


def load_state_tree_(state, tree) -> Dict[str, Any]:
    """Adopt a restored tree: its tensors are copied into the state's
    own (nothing is copied where the engine already restored in place,
    ``load(target=state_tree(state))``), so the optimizer keeps its
    parameter identity; ``state["step"]`` takes the tree's."""
    from dlrover_tpu_torch.flash_ckpt.shm_handler import tree_flatten

    dst, dst_spec = tree_flatten(state_tree(state))
    src, src_spec = tree_flatten(tree)
    if dst_spec != src_spec:
        raise ValueError("restored tree differs from the train state's")
    with torch.no_grad():
        for d, s in zip(dst, src):
            d, s = local_shard(d), local_shard(s)
            if isinstance(d, torch.Tensor) and d is not s:
                d.copy_(s)
    state["step"] = int(tree["step"])
    return state


def local_view(params):
    """The model's view of DTensor params: each its local shard (the
    autograd leaf) with its layout, never a DTensor."""
    return params_like(params, lambda p: ShardedParam(
        local_shard(p), p.device_mesh, p.placements))


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class _MeshSplit:
    """How a micro-batch's tokens split over a mesh: rows over the batch
    axes, each sequence into contiguous chunks over sp. ``shares`` ranks
    hold distinct tokens; each tp rank holds the same ones."""

    def __init__(self, mesh, local_batch: bool):
        self.b_idx, self.b_count = sharding.batch_index(mesh)
        self.sp = sharding.axis_size("sp", mesh)
        self.sp_idx = mesh.get_local_rank("sp") if self.sp > 1 else 0
        self.shares = self.b_count * self.sp
        self.tp = sharding.axis_size("tp", mesh)
        self.local_batch = local_batch

    def local(self, batch: Dict[str, torch.Tensor]):
        """This rank's rows of ``batch`` (all of them with
        ``local_batch``) and its chunk of each sequence: ``tokens [rows,
        s + 1]`` gives ``[rows / batch ranks, s / sp + 1]``, the chunk's
        inputs and its next-token targets."""
        tokens = batch["tokens"]
        out = dict(batch)
        if not self.local_batch:
            rows = tokens.shape[0]
            if rows % self.b_count:
                raise ValueError(f"micro-batch {rows} not divisible by the "
                                 f"{self.b_count} batch ranks")
            per = rows // self.b_count
            out = {k: v[self.b_idx * per:(self.b_idx + 1) * per]
                   for k, v in out.items()}
        if self.sp > 1:
            s = out["tokens"].shape[1] - 1
            if s % self.sp:
                raise ValueError(
                    f"sequence {s} not divisible by sp={self.sp}")
            sl = s // self.sp
            lo = self.sp_idx * sl
            out["tokens"] = out["tokens"][:, lo:lo + sl + 1]
            if "mask" in out:
                out["mask"] = out["mask"][:, lo:lo + sl]
        return out

    def global_mean(self, share: torch.Tensor) -> torch.Tensor:
        """The global value from this rank's share of it: the sum over
        the world, each tp rank holding the same share."""
        import torch.distributed as dist

        share = share.clone()
        dist.all_reduce(share)
        return share / self.tp


def _sum_grads_over_pp(params, grads, mesh) -> None:
    """Sum over pp the gradients of the params replicated over pp (each
    pp rank holds the gradient of its own stages' use of them), in
    place."""
    from torch.distributed.tensor import Replicate
    import torch.distributed as dist

    if sharding.axis_size("pp", mesh) == 1:
        return
    group = mesh.get_group("pp")
    dim = mesh.mesh_dim_names.index("pp")
    for p, g in zip(param_leaves(params), grads):
        if isinstance(p.placements[dim], Replicate):
            dist.all_reduce(g, group=group)


def make_train_step(config: llama.TpuLMConfig, tc: TrainConfig,
                    optimizer: Optimizer, device="cuda",
                    loss_fn: Optional[Callable] = None, mesh=None,
                    local_batch: bool = False):
    """Returns ``step(state, batch) -> (state, metrics)``.

    batch["tokens"]: [grad_accum * micro_batch, seq + 1] int. Metrics:
    loss (mean over micro-batches), grad_norm (before clipping), step.
    The batch's "mask" is not used, as in the reference.

    With ``mesh`` (the state from ``init_train_state(..., mesh=mesh)``;
    the device is the mesh's) every rank passes the global batch and
    takes its rows of each micro-batch and, under sp, its chunk of each
    sequence; with ``local_batch`` it passes only its own rows
    ``[grad_accum * micro_batch / batch ranks, seq + 1]``. The loss runs
    under ``use_mesh(mesh)``, through ring attention when sp > 1."""
    attention_fn = None
    if mesh is not None:
        _require_mesh_path(config, mesh)
        device = _mesh_device(mesh)
        split = _MeshSplit(mesh, local_batch)
        if split.sp > 1:
            from dlrover_tpu_torch.ops.ring_attention import (
                make_ring_attention,
            )

            attention_fn = make_ring_attention(mesh)
    device = torch.device(device)
    _loss = loss_fn or (
        lambda params, batch: llama.loss_fn(config, params, batch,
                                            attention_fn=attention_fn)
    )

    def single_grad(params, leaves, micro):
        if mesh is None:
            loss, _ = _loss(params, micro)
            return loss.detach(), torch.autograd.grad(loss, leaves)
        params = local_view(params)
        micro = split.local(micro)
        with sharding.use_mesh(mesh):
            loss, _ = _loss(params, micro)
            if split.shares > 1:
                # This rank's share of the global mean: the tokens split
                # evenly, so the mean of the ranks' means.
                loss = loss / split.shares
            # A pp rank uses only its own stages' params (and the
            # embedding or unembedding where its stages need them).
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def mean_loss(loss):
        """The global mean from this rank's share (world of one: as
        is)."""
        if mesh is None or mesh.size() == 1:
            return loss
        return split.global_mean(loss)

    def step(state, batch):
        params = state["params"]
        leaves = [local_shard(p) for p in param_leaves(params)]
        tokens = torch.as_tensor(batch["tokens"]).to(device)
        ga = tc.grad_accum
        if ga > 1:
            if tokens.shape[0] % ga:
                raise ValueError(
                    f"batch {tokens.shape[0]} not divisible by grad_accum "
                    f"{ga}"
                )
            mb = tokens.shape[0] // ga
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(ga):
                l_i, g_i = single_grad(
                    params, leaves, {"tokens": tokens[i * mb:(i + 1) * mb]}
                )
                for acc, g in zip(grads, g_i):
                    acc.add_(g.float() / ga)
                loss = loss + l_i / ga
        else:
            loss, g_1 = single_grad(params, leaves, {"tokens": tokens})
            grads = list(g_1)
        loss = mean_loss(loss)
        if mesh is not None:
            _sum_grads_over_pp(params, grads, mesh)

        with llama.scope("optimizer"):
            grad_norm = global_norm(
                grads, None if mesh is None or mesh.size() == 1 else [
                    sharding.replication(p) for p in param_leaves(params)])
            fences = state.get("fences")
            if fences:
                # A snapshot's copy still reads the tensors about to
                # change.
                stream = torch.cuda.current_stream(device)
                for event in fences:
                    stream.wait_event(event)
                fences.clear()
            optimizer.update(state["opt_state"], params, grads, grad_norm,
                             state["step"])
        new_state = dict(state, step=state["step"] + 1)
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "step": new_state["step"]}
        return new_state, metrics

    return step


def make_eval_step(config: llama.TpuLMConfig, device="cuda", mesh=None):
    """Returns ``ev(params, batch) -> ce`` (no gradients). With ``mesh``
    every rank passes the global batch and gets the global mean CE."""
    if mesh is not None:
        _require_mesh_path(config, mesh)
        device = _mesh_device(mesh)
        split = _MeshSplit(mesh, local_batch=False)
    device = torch.device(device)

    def ev(params, batch):
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        if mesh is None:
            with torch.no_grad():
                _, metrics = llama.loss_fn(config, params, batch)
            return metrics["ce"]
        batch = split.local(batch)
        with torch.no_grad(), sharding.use_mesh(mesh):
            _, metrics = llama.loss_fn(config, local_view(params), batch)
            ce = metrics["ce"]
            if mesh.size() > 1:
                ce = split.global_mean(ce / split.shares)
        return ce

    return ev
