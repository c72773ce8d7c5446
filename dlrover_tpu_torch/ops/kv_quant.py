"""Int8 KV-cache quantization (port of ``dlrover_tpu/ops/kv_quant.py``).

One f32 scale per KV head per cache row (``amax / 127`` over the
head_dim vector), symmetric round-to-nearest. A row is written once, so
its scale is computed at append time and never changes. Dequantization
happens at the read site: folded into the decode kernel's math
(``ops/decode_attention.py``), or materialized by
:func:`dequantize_kv` for the prefill's plain attention. The wire
format for KV migration is not ported yet.
"""

import torch

# Scales of all-zero rows would be 0 -> 0/0 at dequant; clamp to a
# denormal-free floor instead (the quantized values are 0 either way).
_SCALE_FLOOR = 1e-20


def quantize_kv(x: torch.Tensor):
    """x [..., d] float -> (q int8 [..., d], scale f32 [...])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=_SCALE_FLOOR)
    # torch.round is round-half-to-even, as jnp.round.
    q = torch.round(xf / scale[..., None])
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32):
    """Materializing inverse (prefill's view of an int8 cache)."""
    return (q.float() * scale[..., None]).to(dtype)


def bytes_per_head_row(head_dim: int, kv_dtype: str,
                       fp_itemsize: int = 2) -> int:
    """Device-memory bytes one KV head's cache row costs: int8 values
    plus one f32 scale, or ``head_dim * fp_itemsize`` for fp caches."""
    if kv_dtype == "int8":
        return head_dim + 4
    return head_dim * fp_itemsize
