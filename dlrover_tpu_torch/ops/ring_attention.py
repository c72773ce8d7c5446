"""Ring attention: exact attention over a sequence-parallel mesh axis
(port of ``dlrover_tpu/ops/ring_attention.py``).

Each rank of the ``sp`` group holds a contiguous chunk of the sequence
(q, k and v at their global positions). It attends its queries to the
K/V chunk it holds, merges the partial result by a running max and sum,
and rotates K/V one hop around the ring (``dist.batch_isend_irecv`` to
the next sp rank, from the previous one). The default schedule is the
reference's overlap schedule: the next chunk's rotation is issued before
the hop's compute, and the last hop rotates nothing, so a ring of ``n``
ranks makes ``n - 1`` rotations.

Two implementations, as the reference's:

- "xla" (:func:`ring_attention_local`): plain PyTorch blocks
  (:func:`_block_attn`, f32 logits) merged by running max and sum; the
  gradients flow through the rotations (an autograd Function whose
  backward is the reverse rotation).
- "pallas" (:func:`ring_flash_attention_local`, the name kept from the
  reference, whose kernel is the Pallas flash kernel): each hop is one
  flash forward, kernel B1 (causal on the diagonal chunk, non-causal on
  a chunk of the past, skipped on a chunk of the future), merged through
  its log-sum-exp (:func:`_merge`). The backward is the ring's own: with
  ``p_ij = exp(s_ij - lse_final)`` each hop's grads are exact partials
  of the global softmax, so every hop feeds kernel B2 (dq, dk/dv) the
  final lse and the global ``delta = rowsum(dO * O)``; the dk/dv
  accumulators ride the ring with k/v and are home after ``n`` hops.
  It needs every rank's chunk contiguous; other positions give NaN
  (:func:`_contiguity_poison`), as the reference's.

The hop loops (:func:`_fwd_hops`, :func:`_bwd_hops`) are generators that
yield what they rotate and get back a callable that returns what
arrived: on the main path the sp group's p2p (:class:`_P2PRing`), and in
:func:`one_process_ring_forward` / :func:`one_process_ring_backward`
every rank's chunk held in one process, each rank receiving what the
previous one yields (the card's check of the hop loop; nothing on the
main path calls them). "auto" picks "pallas" on a CUDA mesh and "xla"
on the CPU, as the reference picks Pallas on the TPU only. The
reference's ``DLROVER_TPU_RING`` and ``DLROVER_TPU_RING_OVERLAP`` knobs
are not kept.
"""

from typing import List, Optional, Sequence, Tuple

import torch

from dlrover_tpu_torch.ops.attention import NEG_INF
from dlrover_tpu_torch.parallel.sharding import DEFAULT_RULES


def _block_attn(q, k, v, q_pos, kv_pos, causal, scale):
    """Partial attention of q ``[b, sq, h, d]`` against one K/V block
    ``[b, skv, kh, d]``: (o, m, l) with o = sum(exp(logits - m) @ v),
    m the row max of the logits and l the row sum of the exponentials,
    f32, ``[b, kh, g, sq(, d)]``. The scale applies to the f32 logits."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if causal:
        mask = q_pos[:, :, None] >= kv_pos[:, None, :]   # [b, sq, skv]
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    p = torch.where((m > NEG_INF / 2)[..., None], p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    return o, m, l


class _P2PRing:
    """The sp group as a ring: rank ``me`` sends to ``me + 1`` and
    receives from ``me - 1`` (reversed for gradients)."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.n = 1 if group is None else dist.get_world_size(group)
        self.me = 0 if group is None else dist.get_rank(group)
        if self.n > 1:
            self.next = dist.get_global_rank(group, (self.me + 1) % self.n)
            self.prev = dist.get_global_rank(group, (self.me - 1) % self.n)

    def start(self, tensors: Sequence[torch.Tensor], reverse: bool = False):
        """Start the rotation of ``tensors``; returns a callable that
        waits for it and returns what arrived."""
        if self.n == 1:
            return lambda: tuple(tensors)
        import torch.distributed as dist

        dst, src = (self.prev, self.next) if reverse else (self.next,
                                                           self.prev)
        ops, outs = [], []
        for t in tensors:
            t = t.contiguous()
            out = torch.empty_like(t)
            ops.append(dist.P2POp(dist.isend, t, dst, self.group))
            ops.append(dist.P2POp(dist.irecv, out, src, self.group))
            outs.append(out)
        reqs = dist.batch_isend_irecv(ops)

        def wait():
            for r in reqs:
                r.wait()
            return tuple(outs)

        return wait

    def rotate(self, tensors, reverse: bool = False):
        return self.start(tensors, reverse)()

    def offsets(self, q_pos, kv_pos) -> Tuple[int, List[int]]:
        """(this rank's first query position, the first kv position of
        the chunk held at each hop): hop ``i`` holds rank ``me - i``'s."""
        q_off = int(q_pos[0, 0])
        first = kv_pos[0, :1].to(torch.int64).contiguous()
        if self.n == 1:
            return q_off, [int(first)]
        import torch.distributed as dist

        every = first.new_empty((self.n,))
        dist.all_gather_into_tensor(every, first, group=self.group)
        every = every.tolist()
        return q_off, [every[(self.me - i) % self.n] for i in range(self.n)]


# ---- "xla": plain blocks, gradients through the rotations ------------------


class _Rotate(torch.autograd.Function):
    """One hop of float tensors around the ring; the backward sends the
    gradients the other way."""

    @staticmethod
    def forward(ctx, ring, *tensors):
        ctx.ring = ring
        return ring.rotate(tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(g) if g is None else g for g in grads]
        return (None,) + ctx.ring.rotate(grads, reverse=True)


def ring_attention_local(q, k, v, q_positions, kv_positions, ring,
                         causal: bool = True,
                         softmax_scale: Optional[float] = None):
    """The "xla" ring body on one rank. Shapes are local: q ``[b, sq, h,
    d]``, k/v ``[b, skv, kh, d]``; positions are the global positions of
    the local rows (``[b, sq]`` / ``[b, skv]``)."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    n = ring.n
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    o = q.new_zeros((b, kh, h // kh, sq, d), dtype=torch.float32)
    m = torch.full(o.shape[:-1], NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    k_cur, v_cur, p_cur = k, v, kv_positions
    for i in range(n):
        if i < n - 1:
            # The next chunk's rotation before this chunk's block.
            k_nxt, v_nxt = _Rotate.apply(ring, k_cur, v_cur)
            (p_nxt,) = ring.rotate((p_cur,))
        bo, bm, bl = _block_attn(q, k_cur, v_cur, q_positions, p_cur,
                                 causal, scale)
        m_new = torch.maximum(m, bm)
        corr = torch.exp(m - m_new)
        bcorr = torch.exp(bm - m_new)
        o = o * corr[..., None] + bo * bcorr[..., None]
        l = l * corr + bl * bcorr
        m = m_new
        if i < n - 1:
            k_cur, v_cur, p_cur = k_nxt, v_nxt, p_nxt
    out = o / torch.clamp(l, min=1e-30)[..., None]
    out = torch.where((m > NEG_INF / 2)[..., None], out, 0.0)
    # [b, kh, g, sq, d] -> [b, sq, h, d]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


# ---- "pallas": the flash kernels a hop, the ring's own backward -----------


def _merge(o, lse, out_b, lse_b):
    """Merge a block partial (out_b ``[b, sq, h, d]``, lse_b ``[b, h,
    sq]``) into the running (o f32, lse f32) accumulator."""
    m = torch.maximum(lse, lse_b)
    lse_new = m + torch.log(torch.exp(lse - m) + torch.exp(lse_b - m))
    w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_b - lse_new).transpose(1, 2)[..., None]
    return o * w_old + out_b.float() * w_new, lse_new


def _hop_kind(causal: bool, q_off: int, kv_off: int) -> Optional[bool]:
    """The flash call of a hop: its causal flag, or None to skip it (a
    chunk wholly in the future of every query)."""
    if not causal:
        return False
    if kv_off > q_off:
        return None
    return kv_off == q_off


def _fwd_hops(q, k, v, q_off: int, kv_offs: Sequence[int], causal: bool,
              scale):
    """One rank's forward hop loop (a generator; see the module doc).
    Returns (o f32 ``[b, sq, h, d]``, lse f32 ``[b, h, sq]``)."""
    from dlrover_tpu_torch.ops.flash_attention import flash_forward

    b, sq, h, d = q.shape
    n = len(kv_offs)
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                     device=q.device)
    cur = (k, v)
    for i in range(n):
        wait = (yield cur) if i < n - 1 else None
        kind = _hop_kind(causal, q_off, kv_offs[i])
        if kind is not None:
            out_b, lse_b = flash_forward(q, cur[0], cur[1], kind, scale)
            o, lse = _merge(o, lse, out_b, lse_b)
        if wait is not None:
            cur = wait()
    return o, lse


def _bwd_hops(q, k, v, do, lse, delta, q_off: int, kv_offs: Sequence[int],
              causal: bool, scale):
    """One rank's backward hop loop (a generator): kernel B2 fed the
    final ``lse`` and the global ``delta`` on every hop that is not
    skipped; the dk/dv accumulators rotate after each hop's adds, ``n``
    times in all. Returns f32 (dq, dk, dv)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    n = len(kv_offs)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    cur = (k, v)
    for i in range(n):
        wait_kv = (yield cur) if i < n - 1 else None
        kind = _hop_kind(causal, q_off, kv_offs[i])
        if kind is not None:
            dq_b = fa.flash_backward_dq(q, cur[0], cur[1], do, lse, delta,
                                        kind, scale)
            dk_b, dv_b = fa.flash_backward_dkv(q, cur[0], cur[1], do, lse,
                                               delta, kind, scale)
            dq += dq_b.float()
            dk += dk_b.float()
            dv += dv_b.float()
        dk, dv = (yield (dk, dv))()
        if wait_kv is not None:
            cur = wait_kv()
    return dq, dk, dv


def _drive(gen, ring: _P2PRing):
    """Run one rank's hop loop, each yielded tuple rotated over
    ``ring``."""
    try:
        item = next(gen)
        while True:
            item = gen.send(ring.start(item))
    except StopIteration as stop:
        return stop.value


def _drive_one_process(gens):
    """Run every rank's hop loop of a ring in one process, in lockstep:
    rank ``r`` receives what rank ``r - 1`` yielded at the same step."""
    n = len(gens)
    items, done = [], []
    for g in gens:
        try:
            items.append(next(g))
        except StopIteration as stop:
            done.append(stop.value)
    while not done:
        nxt = []
        for r, g in enumerate(gens):
            arrived = items[(r - 1) % n]
            try:
                nxt.append(g.send(lambda a=arrived: a))
            except StopIteration as stop:
                done.append(stop.value)
        items = nxt
    if len(done) != n:
        raise RuntimeError("hop loops of one ring ended at different hops")
    return done


def _contiguity_poison(q_pos, kv_pos):
    """0.0, or NaN unless every batch row of the positions is the same
    contiguous run: the layout the "pallas" path assumes. Packed or
    per-row positions then fail loudly (NaN loss on step one) instead of
    training on wrong causal masks; such callers use impl="xla"."""
    sq, skv = q_pos.shape[1], kv_pos.shape[1]
    ok_q = torch.all(q_pos == q_pos[0, 0] + torch.arange(
        sq, device=q_pos.device, dtype=q_pos.dtype)[None, :])
    ok_kv = torch.all(kv_pos == kv_pos[0, 0] + torch.arange(
        skv, device=kv_pos.device, dtype=kv_pos.dtype)[None, :])
    nan = torch.tensor(float("nan"), device=q_pos.device)
    return torch.where(ok_q & ok_kv, torch.zeros_like(nan), nan)


class _RingFlash(torch.autograd.Function):
    """The "pallas" ring on one rank, with the ring's own backward. Saves
    (q, k, v, out, lse), all O(s*d)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, ring, causal, scale):
        q_off, kv_offs = ring.offsets(q_pos, kv_pos)
        o, lse = _drive(_fwd_hops(q, k, v, q_off, kv_offs, causal, scale),
                        ring)
        if causal:
            # Only causal masking reads positions.
            o = o + _contiguity_poison(q_pos, kv_pos)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        ctx.offsets = (q_off, kv_offs)
        return out

    @staticmethod
    def backward(ctx, g):
        from dlrover_tpu_torch.ops.flash_attention import (
            flash_backward_delta,
        )

        q, k, v, out, lse = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        delta = flash_backward_delta(g, out)
        q_off, kv_offs = ctx.offsets
        dq, dk, dv = _drive(_bwd_hops(q, k, v, g, lse, delta, q_off,
                                      kv_offs, ctx.causal, ctx.scale),
                            ctx.ring)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def ring_flash_attention_local(q, k, v, q_positions, kv_positions, ring,
                               causal: bool = True,
                               softmax_scale: Optional[float] = None):
    """The "pallas" ring body on one rank (shapes as
    :func:`ring_attention_local`)."""
    return _RingFlash.apply(q, k, v, q_positions, kv_positions, ring,
                            causal, softmax_scale)


def _hop_offsets(offsets: Sequence[int], r: int) -> List[int]:
    n = len(offsets)
    return [offsets[(r - i) % n] for i in range(n)]


def one_process_ring_forward(qs, ks, vs, offsets: Sequence[int],
                             causal: bool = True,
                             softmax_scale: Optional[float] = None):
    """The "pallas" forward hop loop of every rank of a ring of
    ``len(qs)`` ranks in one process: rank ``r`` holds ``qs[r]``,
    ``ks[r]``, ``vs[r]`` starting at global position ``offsets[r]``.
    Returns each rank's (out in q's dtype, lse f32 ``[b, h, sq]``), what
    :func:`ring_flash_attention_local` computes on that rank."""
    gens = [_fwd_hops(q, k, v, offsets[r], _hop_offsets(offsets, r), causal,
                      softmax_scale)
            for r, (q, k, v) in enumerate(zip(qs, ks, vs))]
    return [(o.to(q.dtype), lse)
            for (o, lse), q in zip(_drive_one_process(gens), qs)]


def one_process_ring_backward(qs, ks, vs, outs, lses, dos,
                              offsets: Sequence[int], causal: bool = True,
                              softmax_scale: Optional[float] = None):
    """The "pallas" backward hop loop of every rank in one process (as
    :func:`one_process_ring_forward`). Returns each rank's (dq, dk, dv)
    in the inputs' dtypes."""
    from dlrover_tpu_torch.ops.flash_attention import flash_backward_delta

    gens = []
    for r, (q, k, v, out, lse, do) in enumerate(
            zip(qs, ks, vs, outs, lses, dos)):
        do = do.to(q.dtype).contiguous()
        gens.append(_bwd_hops(q, k, v, do, lse, flash_backward_delta(do, out),
                              offsets[r], _hop_offsets(offsets, r), causal,
                              softmax_scale))
    return [(dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
            for (dq, dk, dv), q, k, v in zip(_drive_one_process(gens), qs,
                                              ks, vs)]


def _ring_impl(impl: Optional[str], device_type: str) -> str:
    """"pallas" (the flash kernels a hop) or "xla": "auto" (or None)
    picks "pallas" on CUDA and "xla" elsewhere. The "pallas" path needs
    each rank's chunk contiguous; callers with packed positions pass
    "xla"."""
    impl = (impl or "auto").lower()
    if impl == "auto":
        return "pallas" if device_type == "cuda" else "xla"
    if impl not in ("pallas", "xla"):
        raise ValueError(
            f"ring attention impl {impl!r} not in ('auto', 'pallas', "
            f"'xla'); refusing to fall back silently")
    return impl


def make_ring_attention(mesh, rules=DEFAULT_RULES, axis_name: str = "sp",
                        impl: Optional[str] = None):
    """An ``attention_fn`` for ``llama.forward`` that runs ring attention
    over ``axis_name`` of ``mesh``. It takes this rank's local q/k/v
    chunk; positions default to the chunk's global positions (sp rank
    ``r`` of ``n`` holds ``[r * s, (r + 1) * s)``). ``rules`` is the
    reference's argument (the local tensors already hold its layout)."""
    from dlrover_tpu_torch.parallel import sharding

    impl = _ring_impl(impl, mesh.device_type)
    n = sharding.axis_size(axis_name, mesh)
    ring = _P2PRing(mesh.get_group(axis_name) if n > 1 else None)
    local_fn = (ring_flash_attention_local if impl == "pallas"
                else ring_attention_local)

    def attention_fn(q, k, v, causal=True, q_positions=None,
                     kv_positions=None, softmax_scale=None):
        b, sq = q.shape[0], q.shape[1]
        skv = k.shape[1]
        if q_positions is None:
            q_positions = torch.arange(sq, device=q.device) + ring.me * sq
        if kv_positions is None:
            kv_positions = torch.arange(skv, device=q.device) + ring.me * skv
        q_positions = q_positions.expand(b, sq)
        kv_positions = kv_positions.expand(b, skv)
        return local_fn(q, k, v, q_positions, kv_positions, ring, causal,
                        softmax_scale)

    # The "pallas" path's ring-level backward keeps O(s*d) residuals
    # (q/k/v/out + lse), so mlp_only remat may leave it outside
    # checkpointing (llama.run_layer_stack).
    attention_fn.saveable_residuals = impl == "pallas"
    return attention_fn
