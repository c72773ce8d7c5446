"""Normalization ops (port of ``dlrover_tpu/ops/norms.py``).

RMSNorm is computed in float32 whatever the input dtype, then cast
back, as the reference does.
"""

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMSNorm with a (1 + scale) parameterization (zero-init friendly)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)
