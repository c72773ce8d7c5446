"""TpuLM — the flagship decoder-only transformer (port of
``dlrover_tpu/models/llama.py``): RMSNorm + RoPE + GQA + SwiGLU.

Parameters are a plain dict of tensors with the reference's leaf names
and its stacked ``[L, ...]`` layer layout, so a JAX param tree maps
leaf for leaf (``models/convert.py``). Functions over tensors, no
``nn.Module`` state. Dense only: MoE and pipeline stages raise
``NotImplementedError`` until their slices are ported.
"""

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.ops.attention import dot_product_attention
from dlrover_tpu_torch.ops.norms import rms_norm
from dlrover_tpu_torch.ops.rope import apply_rope

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class TpuLMConfig:
    """The reference's config, field for field (training-only fields
    are kept so a reference config converts with ``asdict``)."""

    vocab_size: int = 32000
    embed_dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    mlp_dim: int = 11008
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"          # compute dtype (params stay f32)
    n_experts: int = 0
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_impl: str = "auto"
    pp_stages: int = 1
    num_microbatches: int = 1
    remat: bool = True
    remat_policy: str = "mlp_only"

    def __post_init__(self):
        if self.remat_policy not in (
            "mlp_only", "attn_save", "dots", "full"
        ):
            raise ValueError(
                f"remat_policy {self.remat_policy!r} not in ('mlp_only', "
                f"'attn_save', 'dots', 'full')"
            )
        if self.moe_impl not in ("auto", "gshard", "dropless"):
            raise ValueError(
                f"moe_impl {self.moe_impl!r} not in ('auto', 'gshard', "
                f"'dropless')"
            )
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype {self.dtype!r} not in {list(_DTYPES)}")

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def count_params(self) -> int:
        d, hd = self.embed_dim, self.head_dim
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd
        attn += self.n_heads * hd * d
        if self.n_experts > 0:
            mlp = 3 * d * self.mlp_dim * self.n_experts + d * self.n_experts
        else:
            mlp = 3 * d * self.mlp_dim
        per_layer = attn + mlp + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab_size * d + d


def tiny_config(**overrides) -> TpuLMConfig:
    """A config small enough for CPU tests (the reference's defaults)."""
    defaults = dict(
        vocab_size=256,
        embed_dim=64,
        n_layers=4,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        mlp_dim=128,
        dtype="float32",
    )
    defaults.update(overrides)
    return TpuLMConfig(**defaults)


def require_dense(config: TpuLMConfig) -> None:
    if config.n_experts > 0:
        raise NotImplementedError("MoE layers are not ported yet")
    if config.pp_stages > 1:
        raise NotImplementedError(
            "pipeline stages are not ported; the port runs the flat "
            "layer stack"
        )


def init_params(
    config: TpuLMConfig,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> Dict[str, Any]:
    """f32 params: normal(0, 1/sqrt(fan_in)); norm scales zero (the
    (1 + scale) parameterization makes zero the identity). Draws from
    ``generator``, which must live on ``device``."""
    require_dense(config)
    d, hd = config.embed_dim, config.head_dim
    h, kv = config.n_heads, config.n_kv_heads
    f, v = config.mlp_dim, config.vocab_size
    L = config.n_layers

    def dense(shape, fan_in):
        w = torch.randn(
            shape, generator=generator, device=device, dtype=torch.float32
        )
        return w.div_(math.sqrt(fan_in))

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=torch.float32)

    layers = {
        "attn_norm": zeros((L, d)),
        "wq": dense((L, d, h, hd), d),
        "wk": dense((L, d, kv, hd), d),
        "wv": dense((L, d, kv, hd), d),
        "wo": dense((L, h, hd, d), h * hd),
        "mlp_norm": zeros((L, d)),
        "w_gate": dense((L, d, f), d),
        "w_up": dense((L, d, f), d),
        "w_down": dense((L, f, d), f),
    }
    return {
        "embed": dense((v, d), 1.0),
        "layers": layers,
        "final_norm": zeros((d,)),
        "lm_head": dense((d, v), d),
    }


def layer_params(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves out of the stacked ``[L, ...]`` layout."""
    return {k: w[i] for k, w in params["layers"].items()}


def attention_qkv(config: TpuLMConfig, p, x, positions):
    """Pre-attention block: norm + QKV projections + RoPE."""
    cdt = config.compute_dtype
    hx = rms_norm(x, p["attn_norm"]).to(cdt)
    q = torch.einsum("bsd,dhk->bshk", hx, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", hx, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", hx, p["wv"].to(cdt))
    q = apply_rope(q, positions, config.rope_theta)
    k = apply_rope(k, positions, config.rope_theta)
    return q, k, v


def attention_out(config: TpuLMConfig, p, attn, residual):
    """Post-attention projection + residual add."""
    cdt = config.compute_dtype
    out = torch.einsum("bshk,hkd->bsd", attn, p["wo"].to(cdt))
    return residual + out.to(residual.dtype)


def mlp_block(config: TpuLMConfig, p, x):
    """Residual dense SwiGLU MLP. Returns (x, aux) as the reference."""
    require_dense(config)
    cdt = config.compute_dtype
    hx = rms_norm(x, p["mlp_norm"]).to(cdt)
    g = hx @ p["w_gate"].to(cdt)
    u = hx @ p["w_up"].to(cdt)
    out = (F.silu(g) * u) @ p["w_down"].to(cdt)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out.to(x.dtype), aux


def embed_tokens(config: TpuLMConfig, params, tokens):
    return params["embed"][tokens.long()].to(config.compute_dtype)


def final_hidden(config: TpuLMConfig, params, x):
    """Final norm + compute-dtype cast."""
    return rms_norm(x, params["final_norm"]).to(config.compute_dtype)


def unembed(config: TpuLMConfig, params, x):
    """Logits in f32 from a compute-dtype matmul."""
    x = final_hidden(config, params, x)
    logits = x @ params["lm_head"].to(config.compute_dtype)
    return logits.float()


def forward(
    config: TpuLMConfig,
    params,
    tokens: torch.Tensor,                 # [b, s] int
    positions: Optional[torch.Tensor] = None,   # [b, s]
):
    """Teacher-forced forward with plain causal attention. Returns
    (logits [b, s, vocab] f32, aux_loss scalar)."""
    require_dense(config)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed_tokens(config, params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(config.n_layers):
        p = layer_params(params, i)
        q, k, v = attention_qkv(config, p, x, positions)
        attn = dot_product_attention(
            q, k, v, causal=True, q_positions=positions,
            kv_positions=positions,
        )
        x = attention_out(config, p, attn, x)
        x, a = mlp_block(config, p, x)
        aux = aux + a
    return unembed(config, params, x), aux
