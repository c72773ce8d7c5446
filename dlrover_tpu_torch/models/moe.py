"""Mixture-of-Experts MLP: GShard one-hot dispatch and a dropless
sorted grouped path, on one device or a mesh (port of
``dlrover_tpu/models/moe.py``).

- **gshard** (:func:`moe_mlp`): one-hot einsum dispatch with per-expert
  capacity; over-capacity tokens are dropped (the residual carries
  them). Plain PyTorch, no kernel.
- **dropless** (:func:`moe_mlp_dropless`): token copies sorted by expert,
  no token dropped. ``DLROVER_TPU_MOE_DISPATCH`` picks the expert
  compute: "fused" (the default) runs ``ops/moe_dispatch.grouped_ffn``,
  kernels B7/B8 on the card; "gmm" keeps the reference's A/B baseline
  role with a per-expert ``torch.matmul`` loop over the sorted rows
  (where the reference calls megablox ``gmm``, a library).

Routing follows the reference's ties: ``jax.lax.top_k`` puts the lower
expert first on equal probabilities, which a stable descending sort
gives (``torch.topk`` leaves the order of ties undefined), and
``torch.argmax`` takes the first maximum as ``jnp.argmax`` does.

On a mesh (``parallel.sharding.use_mesh``) each rank holds its own
tokens:

- **gshard** on every rank's rows; under sp each rank holds a
  contiguous chunk of every sequence and runs :func:`moe_mlp_chunk` on
  it, with the whole sequences' capacity and slot offsets from one
  all-gather of the chunks' per-round expert counts over the sp group
  (:func:`sp_offsets`), which the reference's GSPMD cumsum over the
  sharded sequence computes;
- **dropless sharded** (:func:`moe_mlp_dropless_sharded`, ep == 1): every
  rank holds every expert and runs :func:`_dropless_core` on its tokens;
- **dropless under ep** (:func:`moe_mlp_dropless_ep`): each rank holds
  ``e / ep`` experts. It routes its tokens, ships each copy to the rank
  of its expert in one ``all_to_all_single`` over the ep group sized by
  the actual routing (:func:`_exchange`, the ragged exchange of the
  reference's TPU branch), runs :func:`ep_expert_body` (B7/B8 on the
  exchange layout) on what it received, and ships the results home
  through the mirrored exchange. The split sizes are host integers: one
  device-to-host read of the counts a layer call.

The router's load-balance and z losses are global over the ranks that
hold distinct tokens (the batch axes and sp): ``aux = e * sum(frac_tokens
* mean_probs)`` is a product of two global means, so both means are
averaged over those ranks before the product, the gradient flowing back
through the average (``sharding.mean_over_shares``).
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.common.env_utils import resolve_env_choice
from dlrover_tpu_torch.ops import moe_dispatch as md
from dlrover_tpu_torch.ops.fused_ce import _mm_f32
from dlrover_tpu_torch.parallel import sharding


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor     # load-balance loss (scalar)
    router_z_loss: torch.Tensor
    dropped_fraction: torch.Tensor


def expert_capacity(seq: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    cap = int(seq * top_k * capacity_factor / n_experts)
    return max(cap, 1)


def _router_logits(x, router_w):
    """f32 router logits ``[..., e]`` from f32 copies of x and the
    router (the router stays f32 through the compute-dtype casts)."""
    return x.float() @ router_w.float()


def _gshard_rounds(probs, top_k: int):
    """The ``top_k`` routing rounds of gshard: per round the chosen
    expert's one-hot ``[b, s, e]`` (f32) and its probability ``[b, s]``,
    each round's choice masked out of the next."""
    e = probs.shape[-1]
    rounds = []
    remaining = probs
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                    # [g, s]
        onehot = F.one_hot(idx, e).float()                       # [g, s, e]
        rounds.append((onehot, (remaining * onehot).sum(dim=-1)))
        remaining = remaining * (1.0 - onehot)
    return rounds


def gshard_counts(x, router_w, top_k: int = 2):
    """``[top_k, b, e]`` int64: how many of the tokens ``x [b, s, d]``
    pick each expert in each routing round of :func:`moe_mlp_chunk`.
    Routing needs no capacity, so a chunk's counts are known before any
    slot is assigned."""
    with torch.no_grad():
        probs = torch.softmax(_router_logits(x, router_w), dim=-1)
        return torch.stack([onehot.sum(dim=1) for onehot, _ in
                            _gshard_rounds(probs, top_k)]).long()


def moe_mlp_chunk(x, router_w, w_gate, w_up, w_down, lower, totals,
                  seq: int, top_k: int = 2, capacity_factor: float = 1.25):
    """gshard on one contiguous chunk ``x [b, s_c, d]`` of sequences of
    ``seq`` tokens, as :func:`moe_mlp` computes the whole sequences.

    ``lower [top_k, b, e]`` counts the tokens of the chunks before this
    one that pick each expert in each round, ``totals [top_k, b, e]``
    those of the whole sequences (both from :func:`gshard_counts`). The
    capacity is ``seq``'s; in each round a token's slot is the exclusive
    cumsum of the round's one-hots inside the chunk, plus ``lower``, plus
    the slots the earlier rounds kept, which grow by ``min(totals,
    cap - used)``: the reference's cumsum over the whole sequence. Each
    kept token's output depends only on its own gates and slot, so the
    expert compute and the combine need nothing of the other chunks.

    Returns ``(out, stats, kept)``: ``stats`` the router's local means
    (:func:`_router_stats`), for the caller to average over the chunks
    (:func:`moe_mlp` over the ranks holding distinct tokens), and
    ``kept [top_k, b, s_c]`` whether each token's choice of each round
    took a slot (:func:`dropped_share` of it is the chunk's share of
    dropped choices)."""
    b, s, d = x.shape
    e = router_w.shape[-1]
    cap = expert_capacity(seq, e, top_k, capacity_factor)
    router_logits = _router_logits(x, router_w)
    probs = torch.softmax(router_logits, dim=-1)

    # Iterative top-k one-hot assignment with capacity.
    combine = torch.zeros((b, s, e, cap), dtype=torch.float32,
                          device=x.device)
    # Slots per expert taken by the earlier rounds, over whole sequences.
    used = torch.zeros((b, e), dtype=torch.int64, device=x.device)
    kept = []
    for r, (onehot, gate) in enumerate(_gshard_rounds(probs, top_k)):
        pos_in_expert = (torch.cumsum(onehot, dim=1) - onehot
                         + (lower[r] + used)[:, None, :])        # [g, s, e]
        pos = (pos_in_expert * onehot).sum(dim=-1).long()
        fits = pos < cap
        kept.append(fits)
        gate = gate * fits
        # Out-of-range positions give an all-zero one-hot row.
        pos_onehot = F.one_hot(torch.where(fits, pos, cap), cap + 1)[
            ..., :cap].float()
        combine = combine + (gate[..., None, None] * onehot[..., None]
                             * pos_onehot[:, :, None, :])
        used = used + torch.minimum(totals[r], (cap - used).clamp(min=0))

    # Renormalize the kept gates so they sum to 1 per token (when any).
    denom = combine.sum(dim=(-2, -1), keepdim=True)
    combine = combine / torch.clamp(denom, min=1e-9)
    dispatch = (combine > 0.0).to(x.dtype)
    combine = combine.to(x.dtype)

    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, x)
    h = torch.einsum("egcd,edf->egcf", expert_in, w_gate.to(x.dtype))
    u = torch.einsum("egcd,edf->egcf", expert_in, w_up.to(x.dtype))
    h = F.silu(h) * u
    expert_out = torch.einsum("egcf,efd->egcd", h, w_down.to(x.dtype))
    out = torch.einsum("egcd,gsec->gsd", expert_out, combine)
    return out, _router_stats(router_logits, probs), torch.stack(kept)


def dropped_share(kept):
    """The mean over the tokens of dropped choices, summed over the
    rounds, from :func:`moe_mlp_chunk`'s ``kept`` (the reference's sum,
    round by round)."""
    dropped = torch.zeros((), dtype=torch.float32, device=kept.device)
    for fits in kept:
        dropped = dropped + (1.0 - fits.float()).mean()
    return dropped


def sp_offsets(counts, group=None):
    """``(lower, totals)`` of :func:`moe_mlp_chunk` for this rank's chunk
    from its :func:`gshard_counts`: one all-gather of the counts over the
    sp ``group`` (chunk order = group rank). Without a group the chunk
    is the whole sequence."""
    if group is None:
        return torch.zeros_like(counts), counts
    import torch.distributed as dist

    n, me = dist.get_world_size(group), dist.get_rank(group)
    gathered = counts.new_empty((n * counts.shape[0],)
                                + tuple(counts.shape[1:]))
    dist.all_gather_into_tensor(gathered, counts.contiguous(), group=group)
    gathered = gathered.reshape((n,) + tuple(counts.shape))
    return gathered[:me].sum(dim=0), gathered.sum(dim=0)


def moe_mlp(x, router_w, w_gate, w_up, w_down, top_k: int = 2,
            capacity_factor: float = 1.25, sp_group=None):
    """x: [batch, seq, embed] -> (out, MoEMetrics). Groups are batch
    rows (tokens of one sequence compete for expert capacity);
    over-capacity tokens are dropped.

    Under sp (``sp_group``, the current mesh's sp group) ``x`` is this
    rank's contiguous chunk of every sequence, and the capacity and
    slots are the whole sequences' (:func:`moe_mlp_chunk`, offsets from
    :func:`sp_offsets`), as GSPMD computes the reference's cumsum over
    the sharded sequence. ``dropped_fraction`` and the router losses
    are global means over the ranks holding distinct tokens."""
    b, s, d = x.shape
    e = router_w.shape[-1]
    sp = 1
    if sp_group is not None:
        import torch.distributed as dist

        sp = dist.get_world_size(sp_group)
    lower, totals = sp_offsets(gshard_counts(x, router_w, top_k), sp_group)
    out, stats, kept = moe_mlp_chunk(
        x, router_w, w_gate, w_up, w_down, lower, totals, s * sp, top_k,
        capacity_factor)
    dropped = sharding.mean_over_shares(dropped_share(kept))
    aux, z = router_losses_from_stats(sharding.mean_over_shares(stats), e)
    return out, MoEMetrics(aux_loss=aux, router_z_loss=z,
                           dropped_fraction=dropped / top_k)


def _router_stats(router_logits, probs):
    """This rank's router means in one vector: the top-1 fractions
    ``[e]``, the mean probabilities ``[e]`` and the mean squared
    log-sum-exp."""
    e = probs.shape[-1]
    top1 = F.one_hot(torch.argmax(probs, dim=-1), e).float()
    lead = tuple(range(top1.ndim - 1))
    z = torch.logsumexp(router_logits, dim=-1).square().mean()
    return torch.cat([top1.mean(dim=lead), probs.mean(dim=lead), z[None]])


def router_losses_from_stats(stats, e: int):
    """(aux, z) from :func:`_router_stats` averaged over every token:
    ``aux = e * sum(frac_tokens * mean_probs)``, a product of two global
    means."""
    frac_tokens, mean_probs = stats[:e], stats[e:2 * e]
    return e * (frac_tokens * mean_probs).sum(), stats[2 * e]


def _router_losses(router_logits, probs):
    """(aux, z) over the whole batch: under a mesh the per-rank means
    (top-1 fractions, mean probabilities, mean squared log-sum-exp) are
    averaged over the ranks holding distinct tokens in one reduction."""
    return router_losses_from_stats(sharding.mean_over_shares(
        _router_stats(router_logits, probs)), probs.shape[-1])


def _top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first on ties (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


# The dispatch and combine gathers are permutations whose inverses are in
# hand (argsort byproducts), so each backward is another gather.


class _PermuteRows(torch.autograd.Function):
    """x[perm], with ``inv_perm`` perm's inverse."""

    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x[perm]

    @staticmethod
    def backward(ctx, g):
        (inv_perm,) = ctx.saved_tensors
        return g[inv_perm], None, None


class _GatherDispatch(torch.autograd.Function):
    """xs[i] = xf[order[i] // top_k] (each token top_k times, sorted by
    expert). Backward: unsort to token-major and sum the k copies
    densely."""

    @staticmethod
    def forward(ctx, xf, order, inv_order, top_k):
        ctx.save_for_backward(inv_order)
        ctx.shape = (xf.shape[0], top_k)
        return xf[order // top_k]

    @staticmethod
    def backward(ctx, g):
        (inv_order,) = ctx.saved_tensors
        n, top_k = ctx.shape
        gt = g[inv_order].reshape(n, top_k, g.shape[-1])
        return gt.float().sum(dim=1).to(g.dtype), None, None, None


def _dispatch_impl() -> str:
    """"fused" (the grouped kernels, the default) | "gmm" (the per-expert
    matmul loop, the A/B baseline) for the dropless expert compute.
    DLROVER_TPU_MOE_DISPATCH picks; typos warn once and fall back to
    "fused"."""
    return resolve_env_choice(
        "DLROVER_TPU_MOE_DISPATCH", ("fused", "gmm"), "fused"
    )


def _grouped_matmul(rows, w, group_sizes):
    """``rows [m, k] @ w[g]`` over consecutive row groups of
    ``group_sizes`` (host ints), f32 out: megablox ``gmm``'s function as
    one product per expert."""
    out = torch.empty((rows.shape[0], w.shape[-1]), dtype=torch.float32,
                      device=rows.device)
    start = 0
    for g, size in enumerate(group_sizes):
        out[start:start + size] = _mm_f32(rows[start:start + size], w[g])
        start += size
    return out


def _dropless_core(xf, router_w, w_gate, w_up, w_down, top_k: int,
                   dispatch=None):
    """Sorted grouped expert compute over flat tokens [n, d] -> out
    [n, d] f32, all experts on this device. ``dispatch``: "fused" runs
    ``grouped_ffn``; "gmm" the per-expert matmul loop."""
    n, d = xf.shape
    e = router_w.shape[-1]
    m = n * top_k
    dispatch = dispatch or _dispatch_impl()

    probs = torch.softmax(_router_logits(xf, router_w), dim=-1)
    gates, experts = _top_k(probs, top_k)                      # [n, k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    flat_expert = experts.reshape(m)
    cdt = xf.dtype
    w_gu = torch.cat([w_gate.to(cdt), w_up.to(cdt)], dim=-1)

    if dispatch == "fused":
        tm = md.default_tile_m(m)
        row_ids, dest_ids, tile_expert = md.build_dispatch_layout(
            flat_expert, e, tm, top_k)
        out_tok = md.grouped_ffn(xf, w_gu, w_down.to(cdt), row_ids, dest_ids,
                                 tile_expert, m, top_k, tm)
        return (out_tok.reshape(n, top_k, d).float()
                * gates[:, :, None]).sum(dim=1)

    order = torch.argsort(flat_expert, stable=True)            # [m]
    inv_order = torch.argsort(order)
    xs = _GatherDispatch.apply(xf, order, inv_order, top_k)   # [m, d]
    # The per-expert loop needs the group sizes on the host.
    sizes = torch.bincount(flat_expert, minlength=e).tolist()
    f = w_gate.shape[-1]
    hu = _grouped_matmul(xs, w_gu, sizes)                      # f32
    a = (F.silu(hu[:, :f]) * hu[:, f:]).to(cdt)
    out_sorted = _grouped_matmul(a, w_down.to(cdt), sizes)     # [m, d] f32
    out_tok = _PermuteRows.apply(out_sorted, inv_order, order)
    return (out_tok.reshape(n, top_k, d) * gates[:, :, None]).sum(dim=1)


def _global_router_metrics(x, router_w):
    logits = _router_logits(x, router_w)
    aux, z = _router_losses(logits, torch.softmax(logits, dim=-1))
    return MoEMetrics(aux_loss=aux, router_z_loss=z,
                      dropped_fraction=torch.zeros((), dtype=torch.float32,
                                                   device=x.device))


def moe_mlp_dropless(x, router_w, w_gate, w_up, w_down, top_k: int = 2,
                     dispatch=None):
    """x: [batch, seq, embed] -> (out, MoEMetrics). Zero dropped tokens:
    token copies are stably sorted by their routed expert and the expert
    products run over the sorted rows (see :func:`_dropless_core`)."""
    b, s, d = x.shape
    out = _dropless_core(x.reshape(b * s, d), router_w, w_gate, w_up,
                         w_down, top_k, dispatch=dispatch)
    return (out.to(x.dtype).reshape(b, s, d),
            _global_router_metrics(x, router_w))


def moe_mlp_dropless_sharded(x, router_w, w_gate, w_up, w_down, mesh,
                             top_k: int = 2, dispatch=None):
    """Dropless MoE on a mesh without expert parallelism: every rank holds
    every expert (``w_*`` whole) and routes and computes its own tokens
    ``x [b_local, s_local, d]`` with :func:`_dropless_core`; the router
    losses are global. ``mesh`` is the reference's argument (the groups
    come from the current mesh)."""
    b, s, d = x.shape
    out = _dropless_core(x.reshape(b * s, d), router_w, w_gate, w_up,
                         w_down, top_k, dispatch=dispatch)
    return (out.to(x.dtype).reshape(b, s, d),
            _global_router_metrics(x, router_w))


class _Exchange(torch.autograd.Function):
    """``all_to_all_single`` of ``rows`` over ``group`` with host split
    sizes; the backward runs the mirrored exchange."""

    @staticmethod
    def forward(ctx, rows, send, recv, group):
        import torch.distributed as dist

        ctx.send, ctx.recv, ctx.group = send, recv, group
        out = rows.new_empty((sum(recv),) + tuple(rows.shape[1:]))
        dist.all_to_all_single(out, rows.contiguous(), recv, send,
                               group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        out = g.new_empty((sum(ctx.send),) + tuple(g.shape[1:]))
        dist.all_to_all_single(out, g.contiguous(), ctx.send, ctx.recv,
                               group=ctx.group)
        return out, None, None, None


def _exchange(rows, sizes_mat, me: int, group, reverse: bool = False):
    """One ragged all-to-all hop of ``rows`` over the ep group.

    ``sizes_mat[src][dst]`` (host ints, the same on every rank) counts
    the rows ``src`` ships to ``dst``. Each rank sends its chunks in
    destination order and receives them in source order (the reference's
    source-major layout, without its capacity padding: the buffers are
    sized by the routing). ``reverse=True`` runs the mirrored exchange
    (processed rows travel home). A group of one rank is the identity."""
    if reverse:
        sizes_mat = [list(col) for col in zip(*sizes_mat)]
    send = [int(n) for n in sizes_mat[me]]
    recv = [int(row[me]) for row in sizes_mat]
    if group is None:
        return rows
    return _Exchange.apply(rows, send, recv, group)


def ep_cap_rows(n_local: int, ep: int, top_k: int) -> int:
    """Rows of the expert body's buffer on one ep rank: every copy of the
    ep row of ranks could land on it (``ep * n_local * top_k``), rounded
    up to 128 as the reference sizes its receive buffer."""
    cap = ep * n_local * top_k
    return (cap + 127) // 128 * 128


def ep_expert_body(recv, counts, e_loc: int, cap_rows: int, w_gu, w_down,
                   dispatch=None, plain: bool = False):
    """The expert side of the ep exchange on one rank: ``recv [n_recv,
    d]`` holds the rows every source rank sent, source-major and within a
    source by local expert, ``counts[src][j]`` (host ints) how many rows
    source ``src`` sent to local expert ``j``. The rows are padded to
    ``cap_rows`` with sentinel rows (expert ``e_loc``, which get no slot)
    and run through the local experts ``w_gu [e_loc, d, 2f]`` (gate|up)
    and ``w_down [e_loc, f, d]``: "fused" is ``grouped_ffn`` over
    ``build_dispatch_layout(row_expert, e_loc, tile_m, 1)`` (B7 forward,
    B8 backward on the card; ``plain`` runs their plain versions), "gmm"
    the per-expert matmul loop over the rows sorted by expert. Returns
    the ``[n_recv, d]`` results in ``recv``'s order."""
    n_recv, d = recv.shape
    cdt = recv.dtype
    dispatch = dispatch or _dispatch_impl()
    ep = len(counts)
    flat_counts = [int(c) for row in counts for c in row]
    if sum(flat_counts) != n_recv or n_recv > cap_rows:
        raise ValueError(
            f"{n_recv} received rows against counts {flat_counts} and "
            f"cap_rows {cap_rows}")
    rows = torch.cat([recv, recv.new_zeros((cap_rows - n_recv, d))])
    seg = torch.arange(e_loc, device=recv.device).repeat(ep)
    row_expert = torch.cat([
        torch.repeat_interleave(
            seg, torch.tensor(flat_counts, device=recv.device),
            output_size=n_recv),
        torch.full((cap_rows - n_recv,), e_loc, dtype=seg.dtype,
                   device=recv.device)])
    if dispatch == "fused":
        tm = md.default_tile_m(cap_rows)
        row_ids, dest_ids, tile_expert = md.build_dispatch_layout(
            row_expert, e_loc, tm, 1)
        ys = md.grouped_ffn(rows, w_gu, w_down, row_ids, dest_ids,
                            tile_expert, cap_rows, 1, tm, plain=plain)
        return ys.to(cdt)[:n_recv]
    order = torch.argsort(row_expert, stable=True)
    inv = torch.argsort(order)
    xs = _PermuteRows.apply(rows, order, inv)
    sizes = [sum(flat_counts[j::e_loc]) for j in range(e_loc)]
    sizes[-1] += cap_rows - n_recv       # the zero pad rows, zero outputs
    f = w_down.shape[1]
    hu = _grouped_matmul(xs, w_gu, sizes)
    a = (F.silu(hu[:, :f]) * hu[:, f:]).to(cdt)
    ys = _grouped_matmul(a, w_down, sizes).to(cdt)
    return _PermuteRows.apply(ys, inv, order)[:n_recv]


def moe_mlp_dropless_ep(x, router_w, w_gate, w_up, w_down, mesh,
                        top_k: int = 2, axis_name: str = "ep",
                        dispatch=None):
    """Dropless MoE under expert parallelism. ``x [b_local, s_local, d]``
    are this rank's tokens, ``router_w`` whole, ``w_*`` this ep rank's
    ``e / ep`` experts (their expert dim sharded over ``axis_name``,
    every other dim whole).

    Route the local tokens, sort the ``top_k`` copies by expert (which
    groups them by destination rank), ship them with :func:`_exchange`
    (split sizes from an all-gather of every rank's per-expert counts),
    run :func:`ep_expert_body` on the received rows, ship the results
    home through the mirrored exchange, unsort, and combine the copies
    by their gates. Nothing is dropped."""
    import torch.distributed as dist

    b, s, d = x.shape
    e = router_w.shape[-1]
    ep = sharding.axis_size(axis_name, mesh)
    if e % ep:
        raise ValueError(f"{e} experts not divisible by ep={ep}")
    e_loc = e // ep
    if w_gate.shape[0] != e_loc:
        raise ValueError(
            f"expert weights hold {w_gate.shape[0]} experts; the ep shard "
            f"of {e} over {ep} ranks is {e_loc}")
    me = mesh.get_local_rank(axis_name) if ep > 1 else 0
    group = mesh.get_group(axis_name) if ep > 1 else None
    cdt = x.dtype
    n_loc = b * s
    m_loc = n_loc * top_k
    xf = x.reshape(n_loc, d)

    probs = torch.softmax(_router_logits(xf, router_w), dim=-1)
    gates, experts = _top_k(probs, top_k)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    flat_expert = experts.reshape(m_loc)
    order = torch.argsort(flat_expert, stable=True)
    inv_order = torch.argsort(order)
    xs = _GatherDispatch.apply(xf, order, inv_order, top_k)   # [m_loc, d]
    counts = torch.zeros(e, dtype=torch.long, device=x.device)
    counts.scatter_add_(0, flat_expert, torch.ones_like(flat_expert))
    if group is not None:
        gathered = counts.new_empty((ep * e,))
        dist.all_gather_into_tensor(gathered, counts, group=group)
        counts = gathered
    # The one host read of the layer: the exchange's split sizes.
    counts_all = counts.reshape(ep, ep, e_loc).tolist()   # [src][dst][j]
    sizes_mat = [[sum(c) for c in row] for row in counts_all]

    w_gu = torch.cat([w_gate.to(cdt), w_up.to(cdt)], dim=-1)
    recv = _exchange(xs.to(cdt), sizes_mat, me, group)
    ys = ep_expert_body(recv, [row[me] for row in counts_all], e_loc,
                        ep_cap_rows(n_loc, ep, top_k), w_gu,
                        w_down.to(cdt), dispatch)
    back = _exchange(ys, sizes_mat, me, group, reverse=True)
    out_tok = _PermuteRows.apply(back, inv_order, order)
    out = (out_tok.reshape(n_loc, top_k, d).float()
           * gates[:, :, None]).sum(dim=1)
    return (out.to(x.dtype).reshape(b, s, d),
            _global_router_metrics(x, router_w))
