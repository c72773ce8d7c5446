"""TpuLM — the flagship decoder-only transformer (port of
``dlrover_tpu/models/llama.py``): RMSNorm + RoPE + GQA + SwiGLU.

Parameters are a plain dict of tensors with the reference's leaf names
and its stacked ``[L, ...]`` layer layout, so a JAX param tree maps
leaf for leaf (``models/convert.py``). Functions over tensors, no
``nn.Module`` state. Dense only: MoE and pipeline stages raise
``NotImplementedError`` until their slices are ported.

Training runs ``loss_fn`` -> ``forward_hidden`` -> ``run_layer_stack``,
a loop over the stacked layers with the reference's remat policies as
``torch.utils.checkpoint``, then either the dense logits and
``cross_entropy`` or the fused CE (``ops/fused_ce``), as
``DLROVER_TPU_FUSED_CE`` and ``resolve_ce_path`` pick. On a CUDA device
the attention is the flash kernel pair (``ops/flash_attention``), as
the reference picks its Pallas flash kernel on the TPU.
"""

import dataclasses
import functools
import math
import os
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from dlrover_tpu_torch.ops.attention import dot_product_attention
from dlrover_tpu_torch.ops.fused_ce import (
    auto_prefers_dense,
    fused_cross_entropy,
)
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

    def flops_per_token(self) -> float:
        """Approximate training FLOPs per token (fwd+bwd ~= 6 * params)."""
        return 6.0 * self.count_params()

    def attention_flops_per_token(self, seq: int, causal: bool = True):
        """Training attention-matmul FLOPs per token at sequence ``seq``:
        3 (fwd + bwd) x 2 matmuls (QK^T, AV) x 2 FLOPs/MAC x seq x
        n_heads x head_dim per layer, halved for causal masking."""
        f = 12.0 * self.n_layers * self.n_heads * self.head_dim * seq
        return f / 2 if causal else f

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


def _project_heads(hx, w):
    """hx ``[b, s, d]`` x w ``[d, h, k]`` -> ``[b, s, h, k]`` as one 2-D
    product (``aten.mm``, which the "dots" remat policy saves; an einsum
    would run a batch-1 ``aten.bmm``)."""
    d, h, k = w.shape
    return (hx @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def attention_qkv(config: TpuLMConfig, p, x, positions):
    """Pre-attention block: norm + QKV projections + RoPE."""
    cdt = config.compute_dtype
    hx = rms_norm(x, p["attn_norm"]).to(cdt)
    q = _project_heads(hx, p["wq"].to(cdt))
    k = _project_heads(hx, p["wk"].to(cdt))
    v = _project_heads(hx, p["wv"].to(cdt))
    q = apply_rope(q, positions, config.rope_theta)
    k = apply_rope(k, positions, config.rope_theta)
    return q, k, v


def attention_out(config: TpuLMConfig, p, attn, residual):
    """Post-attention projection + residual add."""
    cdt = config.compute_dtype
    wo = p["wo"].to(cdt)
    out = attn.flatten(-2) @ wo.reshape(-1, wo.shape[-1])
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


def default_attention_fn(device):
    """Attention for contiguous-position causal attention on ``device``:
    the flash kernels (B1/B2) on a CUDA device; ``None`` elsewhere,
    which ``transformer_layer`` reads as the plain
    ``dot_product_attention``."""
    if torch.device(device).type != "cuda":
        return None
    from dlrover_tpu_torch.ops.flash_attention import make_flash_attention

    return make_flash_attention()


def transformer_layer(config: TpuLMConfig, p, x, positions,
                      attention_fn=None):
    """One decoder block. x: [b, s, d]; positions: [b, s]. Returns
    (x, aux)."""
    attn_fn = attention_fn or dot_product_attention
    q, k, v = attention_qkv(config, p, x, positions)
    attn = attn_fn(q, k, v, causal=True, q_positions=positions,
                   kv_positions=positions)
    x = attention_out(config, p, attn, x)
    return mlp_block(config, p, x)


# The "dots" remat policy (the reference's dots_with_no_batch_dims_saveable):
# keep the output of every matrix product without batch dims, recompute
# the rest (norms, RoPE, activations, and attention's batched [b, h, s, s]
# products and softmax).
_DOT_OPS = [
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
]


def _remat(fn, dots: bool, *args):
    """``fn(*args)`` under activation checkpointing, saving the matrix
    products (``dots``) or nothing. Without autograd there is nothing to
    save, and ``fn`` simply runs."""
    if not torch.is_grad_enabled():
        return fn(*args)
    if dots:
        return checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _DOT_OPS
            ),
        )
    return checkpoint(fn, *args, use_reentrant=False)


def run_layer_stack(config: TpuLMConfig, layer_params, x, positions,
                    attention_fn=None):
    """The stacked ``[L, ...]`` layers, one after the other, under the
    config's remat policy. Returns (x, summed aux).

    - ``mlp_only`` (with an attention_fn whose residuals are O(s*d), the
      flash op): the attention call stays outside checkpointing, so its
      forward kernel runs once per layer; the qkv and out+MLP flanks
      are checkpointed saving their matrix products;
    - ``attn_save``: the same escape with fully recomputed flanks;
    - ``dots``: the whole layer checkpointed, saving matrix products;
    - ``full``: the whole layer checkpointed, saving nothing.
    Other attention functions demote ``mlp_only``/``attn_save`` to
    whole-layer checkpointing (``dots`` / ``full``), since their
    residuals are O(s^2)."""
    # Matmul leaves go to the compute dtype once, outside the loop; the
    # norm scales stay f32 (rms_norm computes in f32). Gradients still
    # reach the f32 master params through the cast.
    cdt = config.compute_dtype
    if cdt != torch.float32:
        keep_f32 = {"attn_norm", "mlp_norm"}
        layer_params = {
            k: (v if k in keep_f32 else v.to(cdt))
            for k, v in layer_params.items()
        }
    n_layers = next(iter(layer_params.values())).shape[0]

    attn_escapes = (
        config.remat
        and config.remat_policy in ("mlp_only", "attn_save")
        and getattr(attention_fn, "saveable_residuals", False)
    )
    if attn_escapes:
        flank_dots = config.remat_policy == "mlp_only"
        qkv = functools.partial(attention_qkv, config)

        def out_mlp(p, attn, residual):
            return mlp_block(config, p, attention_out(config, p, attn,
                                                      residual))

        def body(x, p):
            q, k, v = _remat(qkv, flank_dots, p, x, positions)
            attn = attention_fn(q, k, v, causal=True, q_positions=positions,
                                kv_positions=positions)
            return _remat(out_mlp, flank_dots, p, attn, x)

    else:
        def layer(x, p):
            return transformer_layer(config, p, x, positions, attention_fn)

        if config.remat:
            dots = config.remat_policy in ("dots", "mlp_only")

            def body(x, p):
                return _remat(layer, dots, x, p)

        else:
            body = layer

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_layers):
        x, aux = body(x, {k: w[i] for k, w in layer_params.items()})
        aux_total = aux_total + aux
    return x, aux_total


def forward_hidden(config: TpuLMConfig, params, tokens, positions=None,
                   attention_fn=None):
    """Forward up to (but excluding) the final norm and unembedding.
    Returns (hidden [b, s, d], aux scalar).

    With neither ``attention_fn`` nor ``positions`` given (contiguous
    [0..s) positions), the attention is ``default_attention_fn`` of the
    tokens' device: the flash kernels on the card."""
    require_dense(config)
    if attention_fn is None and positions is None:
        attention_fn = default_attention_fn(tokens.device)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed_tokens(config, params, tokens)
    return run_layer_stack(config, params["layers"], x, positions,
                           attention_fn)


def forward(
    config: TpuLMConfig,
    params,
    tokens: torch.Tensor,                 # [b, s] int
    positions: Optional[torch.Tensor] = None,   # [b, s]
    attention_fn=None,
):
    """Teacher-forced forward. Returns (logits [b, s, vocab] f32,
    aux_loss scalar). Attention as in :func:`forward_hidden`."""
    x, aux = forward_hidden(config, params, tokens, positions, attention_fn)
    return unembed(config, params, x), aux


# ---- loss ------------------------------------------------------------------


def cross_entropy(logits, targets, mask=None, z_weight: float = 1e-4):
    """Token-mean CE + z-loss. logits f32 [b, s, v]; targets int [b, s];
    mask [b, s] (any dtype; nonzero = counted)."""
    logz = torch.logsumexp(logits, dim=-1)
    target_logit = logits.gather(-1, targets.long()[..., None])[..., 0]
    per_tok = logz - target_logit + z_weight * logz.square()
    if mask is None:
        return per_tok.mean()
    mask = mask.float()
    return (per_tok * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _fused_ce_mode() -> str:
    """DLROVER_TPU_FUSED_CE: "on" | "off" | "auto". Unrecognized values
    warn and fall back to auto."""
    raw = os.environ.get("DLROVER_TPU_FUSED_CE", "auto").lower()
    if raw in ("on", "1", "fused", "true"):
        return "on"
    if raw in ("off", "0", "unfused", "false"):
        return "off"
    if raw != "auto":
        from dlrover_tpu_torch.common.log import logger

        logger.warning(
            "DLROVER_TPU_FUSED_CE=%r not in (on, off, auto); using auto", raw
        )
    return "auto"


def _fused_ce_applicable(config: TpuLMConfig) -> bool:
    """The fused CE handles one pipeline stage. (The reference also
    refuses a vocab-sharded mesh; the port has no mesh yet.)"""
    return config.pp_stages <= 1


def resolve_ce_path(config: TpuLMConfig, n_tokens: int) -> str:
    """"fused" | "dense": the CE path ``loss_fn`` takes for a batch of
    ``n_tokens`` tokens. "auto" picks the fused CE only at or above the
    N*V crossover of ``ops/fused_ce.AUTO_FUSED_MIN_NV``."""
    mode = _fused_ce_mode()
    use_fused = mode == "on" or (
        mode == "auto"
        and not auto_prefers_dense(n_tokens, config.vocab_size)
    )
    if use_fused and _fused_ce_applicable(config):
        return "fused"
    return "dense"


def loss_fn(config: TpuLMConfig, params, batch, attention_fn=None):
    """batch: {"tokens": [b, s+1], optional "mask": [b, s]}. Next-token
    LM loss; returns (loss, {"ce", "aux"}). The CE runs fused
    (``ops/fused_ce.fused_cross_entropy``, no [b, s, vocab] logits) or
    dense as ``resolve_ce_path`` picks."""
    tokens = batch["tokens"][:, :-1]
    targets = batch["tokens"][:, 1:]
    if resolve_ce_path(config, tokens.numel()) == "fused":
        x, aux = forward_hidden(config, params, tokens,
                                attention_fn=attention_fn)
        # Long sequences cap the CE row chunk at 4096, as the reference
        # does for its whole-program compile at 32k tokens.
        ce = fused_cross_entropy(
            final_hidden(config, params, x),
            params["lm_head"].to(config.compute_dtype),
            targets,
            batch.get("mask"),
            block_rows=4096 if tokens.shape[1] >= 32768 else None,
        )
    else:
        logits, aux = forward(config, params, tokens,
                              attention_fn=attention_fn)
        ce = cross_entropy(logits, targets, batch.get("mask"))
    loss = ce + config.moe_aux_weight * aux
    return loss, {"ce": ce, "aux": aux}
