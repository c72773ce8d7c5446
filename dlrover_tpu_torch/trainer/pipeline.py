"""Pipeline parallelism, the GPipe schedule (port of
``dlrover_tpu/trainer/pipeline.py``).

Layer params are stored ``[stages, layers_per_stage, ...]`` with the
stage dim sharded over the mesh's ``pp`` axis, so a pp rank holds ``S /
pp`` consecutive stages (all of them without a mesh or at pp 1). The
batch splits into ``M = num_microbatches`` micro-batches and the
schedule runs ``M + S - 1`` ticks: at tick ``t`` stage ``i`` runs
micro-batch ``t - i`` if it exists. Bubble ticks compute nothing. A
stage's output goes to the next stage for the next tick: a local move
between stages of one rank, a p2p send to the next pp rank otherwise
(:class:`_SendNext` / :class:`_RecvPrev`, autograd Functions whose
backward is the reverse p2p). Each rank makes its p2p calls in tick
order in the forward and, since the autograd engine runs the nodes of
one rank's graph in reverse creation order, in reverse tick order in
the backward, so the two ends of every link agree.

The embedding and the unembedding are replicated over pp. Stage 0's
rank embeds the tokens; the last stage's rank has the hidden states,
which only it unembeds (the other ranks' ``forward`` returns None
logits and their share of the loss is their stages' aux), so the
gradients of the replicated params are summed over pp by the train
step. Aux sums over the valid ticks only and divides by M, as the
reference's. B1/B2 launch exactly as the flat stack over the same
tokens: one B1 and one B2 pair per layer per micro-batch.
"""

from typing import Optional

import torch

from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel import sharding


class _SendNext(torch.autograd.Function):
    """Send ``x`` to the next pp rank; returns a zero scalar for the
    caller to add into its loss share, whose backward receives x's
    gradient from that rank."""

    @staticmethod
    def forward(ctx, x, dst, group):
        import torch.distributed as dist

        ctx.dst, ctx.group = dst, group
        ctx.like = (x.shape, x.dtype, x.device)
        dist.send(x.contiguous(), dst, group=group)
        return x.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, _):
        import torch.distributed as dist

        shape, dtype, device = ctx.like
        g = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(g, ctx.dst, group=ctx.group)
        return g, None, None


class _RecvPrev(torch.autograd.Function):
    """Receive a tensor shaped like ``like`` from the previous pp rank;
    the backward sends its gradient back (``like``, a tensor on the
    params' path, takes a zero gradient, which keeps this node in every
    backward)."""

    @staticmethod
    def forward(ctx, like, src, group):
        import torch.distributed as dist

        ctx.src, ctx.group = src, group
        out = torch.empty_like(like)
        dist.recv(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        dist.send(g.contiguous(), ctx.src, group=ctx.group)
        return torch.zeros_like(g), None, None


def _pp_layout(config):
    """(this rank's pp index, its first stage, its stage count, the pp
    group or None, the pp ranks' global ranks or None)."""
    import torch.distributed as dist

    S = config.pp_stages
    mesh = sharding.current_mesh()
    pp = sharding.axis_size("pp", mesh)
    if S % pp:
        raise ValueError(f"pp_stages {S} not divisible by the pp axis {pp}")
    rank = mesh.get_local_rank("pp") if pp > 1 else 0
    group = mesh.get_group("pp") if pp > 1 else None
    per = S // pp
    peers = ([dist.get_global_rank(group, r) for r in range(pp)]
             if group is not None else None)
    return rank, rank * per, per, group, peers


def pipelined_forward(config, params, tokens,
                      positions: Optional[torch.Tensor] = None,
                      attention_fn=None):
    """Returns (logits ``[b, s, vocab]`` f32 on the rank of the last
    stage and None elsewhere, aux). ``b`` must divide into
    ``num_microbatches``. Embedding and unembedding run outside the
    schedule."""
    S = config.pp_stages
    M = config.num_microbatches
    b, s = tokens.shape
    if b % M:
        raise ValueError(f"batch {b} not divisible by microbatches {M}")
    mb = b // M
    if positions is None:
        positions = llama.default_positions(tokens)
    positions = positions.expand(b, s)
    rank, first, per, group, peers = _pp_layout(config)

    x = llama.embed_tokens(config, params, tokens)      # [b, s, d]
    micro_x = x.reshape((M, mb) + x.shape[1:])
    micro_pos = positions.reshape(M, mb, s)
    stages = [{k: sharding.stage_param(w, j)
               for k, w in params["layers"].items()} for j in range(per)]

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    outputs = [None] * M
    held = {}                 # local stage -> its input for this tick
    for t in range(M + S - 1):
        passed = {}
        for j in range(per):
            i = first + j
            m = t - i
            if not 0 <= m < M:
                continue
            if i == 0:
                inp = micro_x[m]
            elif j == 0:
                inp = _RecvPrev.apply(micro_x[m], peers[rank - 1], group)
            else:
                inp = held[j]
            out, aux_t = llama.run_layer_stack(
                config, stages[j], inp, micro_pos[m], attention_fn)
            aux = aux + aux_t
            if i == S - 1:
                outputs[m] = out
            elif j == per - 1:
                aux = aux + _SendNext.apply(out, peers[rank + 1], group)
            else:
                passed[j + 1] = out
        held = passed
    # Mean over micro-batches: aux must not scale with M.
    aux = aux / M
    if first + per < S:
        return None, aux
    return llama.unembed(config, params, torch.cat(outputs)), aux
