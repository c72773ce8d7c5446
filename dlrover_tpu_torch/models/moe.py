"""Mixture-of-Experts MLP: GShard one-hot dispatch and a dropless
sorted grouped path (port of ``dlrover_tpu/models/moe.py``, one device).

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
``torch.argmax`` takes the first maximum as ``jnp.argmax`` does. The
sharded and expert-parallel dropless variants wait for the multi-GPU
slice.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.common.env_utils import resolve_env_choice
from dlrover_tpu_torch.ops import moe_dispatch as md
from dlrover_tpu_torch.ops.fused_ce import _mm_f32


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


def moe_mlp(x, router_w, w_gate, w_up, w_down, top_k: int = 2,
            capacity_factor: float = 1.25):
    """x: [batch, seq, embed] -> (out, MoEMetrics). Groups are batch
    rows (tokens of one sequence compete for expert capacity);
    over-capacity tokens are dropped."""
    b, s, d = x.shape
    e = router_w.shape[-1]
    cap = expert_capacity(s, e, top_k, capacity_factor)
    router_logits = _router_logits(x, router_w)
    probs = torch.softmax(router_logits, dim=-1)

    # Iterative top-k one-hot assignment with capacity.
    combine = torch.zeros((b, s, e, cap), dtype=torch.float32,
                          device=x.device)
    remaining = probs
    # Position counters per expert, advanced between the k rounds.
    used = torch.zeros((b, e), dtype=torch.int64, device=x.device)
    dropped = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                    # [g, s]
        onehot = F.one_hot(idx, e).float()                       # [g, s, e]
        gate = (remaining * onehot).sum(dim=-1)                  # [g, s]
        remaining = remaining * (1.0 - onehot)
        pos_in_expert = (torch.cumsum(onehot, dim=1) - onehot
                         + used[:, None, :])                     # [g, s, e]
        pos = (pos_in_expert * onehot).sum(dim=-1).long()
        fits = pos < cap
        dropped = dropped + (1.0 - fits.float()).mean()
        gate = gate * fits
        # Out-of-range positions give an all-zero one-hot row.
        pos_onehot = F.one_hot(torch.where(fits, pos, cap), cap + 1)[
            ..., :cap].float()
        combine = combine + (gate[..., None, None] * onehot[..., None]
                             * pos_onehot[:, :, None, :])
        used = used + (onehot * fits[..., None]).sum(dim=1).long()

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

    aux, z = _router_losses(router_logits, probs)
    return out, MoEMetrics(aux_loss=aux, router_z_loss=z,
                           dropped_fraction=dropped / top_k)


def _router_losses(router_logits, probs):
    e = probs.shape[-1]
    top1 = F.one_hot(torch.argmax(probs, dim=-1), e).float()
    lead = tuple(range(top1.ndim - 1))
    frac_tokens = top1.mean(dim=lead)
    mean_probs = probs.mean(dim=lead)
    aux = e * (frac_tokens * mean_probs).sum()
    z = torch.logsumexp(router_logits, dim=-1).square().mean()
    return aux, z


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
