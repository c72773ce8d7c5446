"""Plain attention (port of ``dlrover_tpu/ops/attention.py``).

Layout: [batch, seq, heads, head_dim]. GQA by ``kv_heads <= heads``;
the query heads of one group share a kv head through a reshape, never a
copy of K/V. The serving path's prefill runs this op over the cache.
"""

from typing import Optional

import torch

NEG_INF = -2.0 ** 30  # large-but-finite: avoids NaN from (-inf) - (-inf)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
):
    """Multi-head attention with optional GQA and causal masking.

    q: [b, sq, h, d]; k, v: [b, skv, hkv, d]. Positions (shape [sq] /
    [skv] or per-row [b, sq] / [b, skv]) drive the causal mask. Query
    rows with no visible key produce exactly zero output."""
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    if h % hkv:
        raise ValueError(f"heads {h} not a multiple of kv_heads {hkv}")
    groups = h // hkv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5

    qg = (q * scale).float().reshape(b, sq, hkv, groups, d)
    # [b, hkv, g, sq, skv]
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    if causal:
        if q_positions is None:
            q_positions = torch.arange(sq, device=q.device)
        if kv_positions is None:
            kv_positions = torch.arange(skv, device=q.device)
        q_pos = q_positions.expand(b, sq)
        kv_pos = kv_positions.expand(b, skv)
        mask = q_pos[:, :, None] >= kv_pos[:, None, :]  # [b, sq, skv]
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    row_max = logits.amax(dim=-1, keepdim=True)
    probs = torch.exp(logits - row_max)
    probs = probs / (probs.sum(dim=-1, keepdim=True) + 1e-30)
    # Fully masked rows (row_max still at NEG_INF) contribute zero, not
    # a uniform average of the illegal keys.
    probs = torch.where(row_max > NEG_INF / 2, probs, 0.0)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)
