"""Rotary position embeddings (port of ``dlrover_tpu/ops/rope.py``).

Takes explicit global position indices, so callers with a per-row
cursor (the serving engine's ragged slots) rotate with true positions.
"""

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None):
    """Inverse frequencies, shape [head_dim // 2], float32."""
    exponents = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim
    )
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0):
    """Rotate x: [..., seq, heads, head_dim] by positions: [..., seq].

    Half-split convention: the first half of head_dim pairs with the
    second half."""
    head_dim = x.shape[-1]
    inv_freq = rope_frequencies(head_dim, theta, device=x.device)
    # [..., seq, 1, head_dim // 2]: broadcast over the heads axis.
    angles = (positions[..., None].float() * inv_freq)[..., None, :]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1)
    return rotated.to(x.dtype)
