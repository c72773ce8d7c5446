"""TpuLM — the flagship decoder-only transformer (port of
``dlrover_tpu/models/llama.py``): RMSNorm + RoPE + GQA + SwiGLU.

Parameters are a plain dict of tensors with the reference's leaf names
and its stacked ``[L, ...]`` layer layout (``[stages, layers_per_stage,
...]`` under ``pp_stages > 1``), so a JAX param tree maps leaf for leaf
(``models/convert.py``). Functions over tensors, no ``nn.Module``
state. MoE layers (``n_experts > 0``) run ``models/moe.py``: gshard,
dropless, or on a mesh the sharded or expert-parallel dropless MoE, as
``_moe_resolve_impl`` picks.

Under a mesh (``parallel.sharding.use_mesh``; the train step makes one
current) the params are DTensors laid out by ``param_axes`` and the
rule table, and every layer computes on local tensors: FSDP's
dp-sharded embed dim is gathered per layer (``sharding.local_param``),
``wq``/``wk``/``wv``/``w_gate``/``w_up`` are column-parallel over tp and
``wo``/``w_down`` row-parallel (their outputs summed over tp), the
embedding lookup and the unembedding are vocab-parallel, and the dense
CE reduces its log-sum-exp and target logit over tp. The batch arrives
already split over the batch axes; under sp each rank holds a contiguous
chunk of every sequence, at its global positions, and attends through
ring attention (``ops/ring_attention.py``). MoE experts sharded over ep
stay on their rank under the expert-parallel dropless MoE and are
gathered otherwise; every tp rank runs the whole expert FFN. Pipeline
stages (``pp_stages > 1``) run ``trainer/pipeline.py`` from
:func:`forward`. Not run: gshard MoE under sp > 1 (its capacity is per
sequence; ROADMAP §A "Cases the port refuses").

Training runs ``loss_fn`` -> ``forward_hidden`` -> ``run_layer_stack``,
a loop over the stacked layers with the reference's remat policies as
``torch.utils.checkpoint`` (``attn_save`` through the lite attention
block, :class:`_AttnBlockLite`, with the flash kernels), then either the
dense logits and ``cross_entropy`` or the fused CE (``ops/fused_ce``), as
``DLROVER_TPU_FUSED_CE`` and ``resolve_ce_path`` pick. On a CUDA device
the attention is the flash kernel pair (``ops/flash_attention``), as
the reference picks its Pallas flash kernel on the TPU.
"""

import contextlib
import dataclasses
import functools
import math
import os
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from dlrover_tpu_torch.models import moe as moe_lib
from dlrover_tpu_torch.ops.attention import dot_product_attention
from dlrover_tpu_torch.ops.fused_ce import (
    auto_prefers_dense,
    fused_cross_entropy,
)
from dlrover_tpu_torch.ops.norms import rms_norm
from dlrover_tpu_torch.ops.rope import apply_rope
from dlrover_tpu_torch.parallel import sharding
from dlrover_tpu_torch.parallel.sharding import (
    copy_to_tp,
    local_param,
    reduce_from_tp,
    with_logical_constraint,
)



def scope(name: str):
    """A ``record_function`` range named ``name`` while this thread's
    profiler records (the counterpart of the reference's
    ``jax.named_scope``), else nothing: a range costs host time on every
    call even with no profiler, where a name scope costs none."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


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
    def layers_per_stage(self) -> int:
        if self.n_layers % self.pp_stages:
            raise ValueError(
                f"n_layers {self.n_layers} % pp_stages {self.pp_stages} != 0"
            )
        return self.n_layers // self.pp_stages

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

    def count_active_params(self) -> int:
        """Params a single token touches: for MoE, top_k experts instead
        of all of them (the 6N basis for MoE model FLOPs; equals
        count_params() for dense configs)."""
        if self.n_experts == 0:
            return self.count_params()
        dense_mlp = 3 * self.embed_dim * self.mlp_dim
        all_mlp = dense_mlp * self.n_experts
        active_mlp = dense_mlp * self.moe_top_k
        return self.count_params() - self.n_layers * (all_mlp - active_mlp)


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


def flagship_config(**overrides) -> TpuLMConfig:
    """The flagship TpuLM (334M params): vocab 32000, embed 1024, 16
    layers, 8 heads of 128, mlp 4096, bf16 compute."""
    defaults = dict(
        vocab_size=32000,
        embed_dim=1024,
        n_layers=16,
        n_heads=8,
        n_kv_heads=8,
        head_dim=128,
        mlp_dim=4096,
        dtype="bfloat16",
    )
    defaults.update(overrides)
    return TpuLMConfig(**defaults)


def require_flat_stack(config: TpuLMConfig, what: str = "decode") -> None:
    """Decode and serving run the flat layer stack, as the reference's:
    pipeline stages raise there."""
    if config.pp_stages > 1:
        raise NotImplementedError(
            f"{what} runs on the flat layer stack; merge pipeline stages "
            "for inference"
        )


def _layer_leading(config: TpuLMConfig):
    """Leading dims/axes of stacked layer params."""
    if config.pp_stages > 1:
        return (
            (config.pp_stages, config.layers_per_stage),
            ("stage", "layer"),
        )
    return ((config.n_layers,), ("layer",))


def param_axes(config: TpuLMConfig) -> Dict[str, Any]:
    """Logical-axis names per param leaf (the reference's)."""
    lead_ax = _layer_leading(config)[1]
    layer_axes = {
        "attn_norm": lead_ax + ("norm",),
        "wq": lead_ax + ("embed", "heads", "head_dim"),
        "wk": lead_ax + ("embed", "kv_heads", "head_dim"),
        "wv": lead_ax + ("embed", "kv_heads", "head_dim"),
        "wo": lead_ax + ("heads", "head_dim", "embed"),
        "mlp_norm": lead_ax + ("norm",),
    }
    if config.n_experts > 0:
        layer_axes.update(
            router=lead_ax + ("embed", "expert"),
            w_gate=lead_ax + ("expert", "embed", "mlp"),
            w_up=lead_ax + ("expert", "embed", "mlp"),
            w_down=lead_ax + ("expert", "mlp", "embed"),
        )
    else:
        layer_axes.update(
            w_gate=lead_ax + ("embed", "mlp"),
            w_up=lead_ax + ("embed", "mlp"),
            w_down=lead_ax + ("mlp", "embed"),
        )
    return {
        "embed": ("vocab", "embed"),
        "layers": layer_axes,
        "final_norm": ("norm",),
        "lm_head": ("embed", "vocab"),
    }


def init_params(
    config: TpuLMConfig,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> Dict[str, Any]:
    """f32 params: normal(0, 1/sqrt(fan_in)); norm scales zero (the
    (1 + scale) parameterization makes zero the identity). Draws from
    ``generator``, which must live on ``device``. Layer leaves are
    ``[L, ...]``, or ``[stages, layers_per_stage, ...]`` under
    ``pp_stages > 1`` (the same draws, reshaped)."""
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
    }
    if config.n_experts > 0:
        e = config.n_experts
        layers.update(
            router=dense((L, d, e), d),
            w_gate=dense((L, e, d, f), d),
            w_up=dense((L, e, d, f), d),
            w_down=dense((L, e, f, d), f),
        )
    else:
        layers.update(
            w_gate=dense((L, d, f), d),
            w_up=dense((L, d, f), d),
            w_down=dense((L, f, d), f),
        )
    lead = _layer_leading(config)[0]
    return {
        "embed": dense((v, d), 1.0),
        "layers": {k: w.reshape(lead + w.shape[1:])
                   for k, w in layers.items()},
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
    """Pre-attention block: norm + QKV projections + RoPE. Under tp the
    projections are column-parallel: q, k, v hold this rank's heads."""
    cdt = config.compute_dtype
    hx = copy_to_tp(rms_norm(x, p["attn_norm"]).to(cdt))
    q = _project_heads(hx, p["wq"].to(cdt))
    k = _project_heads(hx, p["wk"].to(cdt))
    v = _project_heads(hx, p["wv"].to(cdt))
    q = with_logical_constraint(q, ("batch", "seq", "heads", "head_dim"))
    k = with_logical_constraint(k, ("batch", "seq", "kv_heads", "head_dim"))
    q = apply_rope(q, positions, config.rope_theta)
    k = apply_rope(k, positions, config.rope_theta)
    return q, k, v


def attention_out(config: TpuLMConfig, p, attn, residual):
    """Post-attention projection + residual add. Under tp the projection
    is row-parallel: the local heads' partial sums are summed over tp."""
    cdt = config.compute_dtype
    wo = p["wo"].to(cdt)
    out = reduce_from_tp(attn.flatten(-2) @ wo.reshape(-1, wo.shape[-1]))
    x = residual + out.to(residual.dtype)
    return with_logical_constraint(x, ("batch", "seq", "embed"))


def _moe_resolve_impl(config: TpuLMConfig) -> str:
    """Which MoE path runs: "gshard" | "dropless" | "dropless_sharded" |
    "dropless_ep", as the reference picks under the current mesh.

    Explicit ``moe_impl="dropless"`` maps to the mesh's dropless variant:
    the one-device core, the per-rank form on a mesh of more than one rank
    without ep, or the expert-parallel exchange when ep > 1. "auto" picks
    dropless on one device once the capacity factor reaches 2.0 (where
    it is also drop-free) and gshard below; on a mesh of more than one
    rank "auto" stays on gshard."""
    mesh = sharding.current_mesh()
    multi = mesh is not None and mesh.size() > 1
    has_ep = mesh is not None and sharding.axis_size("ep", mesh) > 1
    if config.moe_impl == "gshard":
        return "gshard"
    if config.moe_impl == "dropless":
        if has_ep:
            return "dropless_ep"
        return "dropless_sharded" if multi else "dropless"
    if not multi and config.capacity_factor >= 2.0:
        return "dropless"
    return "gshard"


def require_run_moe(config: TpuLMConfig) -> None:
    """Raise for the MoE case the port refuses under the current mesh:
    gshard under sp > 1, whose expert capacity is per sequence while an
    sp rank holds a chunk of each."""
    if (config.n_experts > 0 and sharding.axis_size("sp") > 1
            and _moe_resolve_impl(config) == "gshard"):
        raise NotImplementedError(
            "gshard MoE under sp > 1: its expert capacity is per sequence, "
            "and a rank holds a chunk of each (ROADMAP §A, cases the port "
            "refuses); use moe_impl='dropless'")


_EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def _expert_local_kw(config: TpuLMConfig) -> Dict[str, Any]:
    """``local_param``'s arguments for the expert weights: their ep shard
    stays on its rank under "dropless_ep" (the rank runs its own experts)
    and is gathered otherwise; their tp shard is gathered (every tp rank
    runs the whole expert FFN on the same tokens, as the reference's
    expert computation replicates every dim but ep)."""
    if config.n_experts == 0:
        return {}
    keep = ("ep",) if _moe_resolve_impl(config) == "dropless_ep" else ()
    return {"keep": keep, "gather_tp": True}


def mlp_block(config: TpuLMConfig, p, x):
    """Residual MLP, dense SwiGLU or MoE. Returns (x, aux) as the
    reference: for MoE ``aux = aux_loss + 0.001 * router_z_loss``."""
    with scope("mlp"):
        return _mlp_block_inner(config, p, x)


def _mlp_block_inner(config: TpuLMConfig, p, x):
    cdt = config.compute_dtype
    hx = rms_norm(x, p["mlp_norm"]).to(cdt)
    if config.n_experts > 0:
        impl = _moe_resolve_impl(config)
        experts = (p["router"], p["w_gate"], p["w_up"], p["w_down"])
        if impl == "dropless":
            out, metrics = moe_lib.moe_mlp_dropless(
                hx, *experts, top_k=config.moe_top_k)
        elif impl in ("dropless_sharded", "dropless_ep"):
            fn = (moe_lib.moe_mlp_dropless_ep if impl == "dropless_ep"
                  else moe_lib.moe_mlp_dropless_sharded)
            out, metrics = fn(hx, *experts, mesh=sharding.current_mesh(),
                              top_k=config.moe_top_k)
        else:
            require_run_moe(config)
            out, metrics = moe_lib.moe_mlp(
                hx, *experts, top_k=config.moe_top_k,
                capacity_factor=config.capacity_factor)
        aux = metrics.aux_loss + 0.001 * metrics.router_z_loss
    else:
        hx = copy_to_tp(hx)
        g = hx @ p["w_gate"].to(cdt)
        u = hx @ p["w_up"].to(cdt)
        g = with_logical_constraint(g, ("batch", "seq", "mlp"))
        out = reduce_from_tp((F.silu(g) * u) @ p["w_down"].to(cdt))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = x + out.to(x.dtype)
    return with_logical_constraint(x, ("batch", "seq", "embed")), aux


def embed_tokens(config: TpuLMConfig, params, tokens):
    """Embedding lookup. Under tp the table holds this rank's vocab rows:
    tokens outside them look up zeros, and the rows sum over tp."""
    table = with_logical_constraint(local_param(params["embed"]),
                                    ("vocab", None))
    tokens = tokens.long()
    if sharding.axis_size("tp") == 1:
        x = table[tokens]
    else:
        rows = table.shape[0]
        ids = tokens - sharding.tp_rank() * rows
        hit = (ids >= 0) & (ids < rows)
        x = reduce_from_tp(table[ids.clamp(0, rows - 1)]
                           * hit[..., None].to(table.dtype))
    x = x.to(config.compute_dtype)
    return with_logical_constraint(x, ("batch", "seq", "embed"))


def final_hidden(config: TpuLMConfig, params, x):
    """Final norm + compute-dtype cast."""
    return rms_norm(x, local_param(params["final_norm"])).to(
        config.compute_dtype)


def lm_head(config: TpuLMConfig, params):
    """The unembedding in the compute dtype, as this rank computes with
    it (``[d, V / tp]`` under tp)."""
    return local_param(params["lm_head"].to(config.compute_dtype))


def unembed(config: TpuLMConfig, params, x):
    """Logits in f32 from a compute-dtype matmul (under tp, this rank's
    vocab columns)."""
    with scope("vocab"):
        x = copy_to_tp(final_hidden(config, params, x))
        logits = x @ lm_head(config, params)
        return with_logical_constraint(logits.float(),
                                       ("batch", "seq", "vocab"))


def default_attention_fn(device):
    """Attention for contiguous-position causal attention on ``device``:
    ring attention over the current mesh's sp axis when it is above one
    rank; else the flash kernels (B1/B2) on a CUDA device and ``None``
    elsewhere, which ``transformer_layer`` reads as the plain
    ``dot_product_attention``."""
    mesh = sharding.current_mesh()
    if mesh is not None and sharding.axis_size("sp", mesh) > 1:
        from dlrover_tpu_torch.ops.ring_attention import make_ring_attention

        return make_ring_attention(mesh)
    if torch.device(device).type != "cuda":
        return None
    from dlrover_tpu_torch.ops.flash_attention import make_flash_attention

    return make_flash_attention()


_LITE_KEYS = ("attn_norm", "wq", "wk", "wv")


class _AttnBlockLite(torch.autograd.Function):
    """Norm + qkv projections + RoPE + flash attention (B1) as one
    differentiable unit whose saved tensors are (p, x, out, lse), not
    (q, k, v, out, lse): the backward re-derives q/k/v from x (the
    projections' recompute the flanks already pay) and feeds B2 the
    saved out and lse, so the flash forward never re-runs. This is what
    keeps the ``attn_save`` policy's saved state small at 64k tokens."""

    @staticmethod
    def forward(ctx, config, positions, x, *ws):
        from dlrover_tpu_torch.ops.flash_attention import flash_forward

        q, k, v = attention_qkv(config, dict(zip(_LITE_KEYS, ws)), x,
                                positions)
        out, lse = flash_forward(q, k, v, causal=True)
        ctx.config, ctx.positions = config, positions
        ctx.save_for_backward(x, out, lse, *ws)
        return out

    @staticmethod
    def backward(ctx, g):
        from dlrover_tpu_torch.ops import flash_attention as fa

        x, out, lse, *ws = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in [x] + ws]
            q, k, v = attention_qkv(
                ctx.config, dict(zip(_LITE_KEYS, inputs[1:])), inputs[0],
                ctx.positions)
        g = g.contiguous()
        qd, kd, vd = q.detach(), k.detach(), v.detach()
        delta = fa.flash_backward_delta(g, out)
        dq = fa.flash_backward_dq(qd, kd, vd, g, lse, delta, True)
        dk, dv = fa.flash_backward_dkv(qd, kd, vd, g, lse, delta, True)
        grads = torch.autograd.grad((q, k, v), inputs, (dq, dk, dv),
                                    allow_unused=True)
        return (None, None) + tuple(grads)


def attn_block_lite(config: TpuLMConfig, p, x, positions):
    """The lite block's attention output ``[b, s, h, hd]`` (see
    :class:`_AttnBlockLite`)."""
    return _AttnBlockLite.apply(config, positions, x,
                                *(p[k] for k in _LITE_KEYS))


def transformer_layer(config: TpuLMConfig, p, x, positions,
                      attention_fn=None):
    """One decoder block. x: [b, s, d]; positions: [b, s]. Returns
    (x, aux)."""
    attn_fn = attention_fn or dot_product_attention
    # The scope reaches every op under it, forward and backward (the
    # backward through its forward op, ``tpu_timer.xla_capture``).
    with scope("attn"):
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
    - ``attn_save``: the same escape with fully recomputed flanks; with
      the plain flash op (``is_plain_flash``) the norm, projections,
      RoPE and attention run as the lite block (:class:`_AttnBlockLite`);
    - ``dots``: the whole layer checkpointed, saving matrix products;
    - ``full``: the whole layer checkpointed, saving nothing.
    Other attention functions demote ``mlp_only``/``attn_save`` to
    whole-layer checkpointing (``dots`` / ``full``), since their
    residuals are O(s^2)."""
    # Matmul leaves go to the compute dtype once, outside the loop; the
    # norm scales and the MoE router stay f32 (rms_norm and the router
    # compute in f32, and a rounded router would flip near-tie routing).
    # Gradients still reach the f32 master params through the cast.
    cdt = config.compute_dtype
    if cdt != torch.float32:
        keep_f32 = {"attn_norm", "mlp_norm", "router"}
        layer_params = {
            k: (v if k in keep_f32 else v.to(cdt))
            for k, v in layer_params.items()
        }
    n_layers = next(iter(layer_params.values())).shape[0]
    expert_kw = _expert_local_kw(config)

    attn_escapes = (
        config.remat
        and config.remat_policy in ("mlp_only", "attn_save")
        and getattr(attention_fn, "saveable_residuals", False)
    )
    if attn_escapes:
        flank_dots = config.remat_policy == "mlp_only"
        qkv = functools.partial(attention_qkv, config)

        def out_mlp(p, attn, residual):
            with scope("attn"):
                y = attention_out(config, p, attn, residual)
            return mlp_block(config, p, y)

        if config.remat_policy == "attn_save" and getattr(
                attention_fn, "is_plain_flash", False):
            def body(x, p):
                with scope("attn"):
                    attn = attn_block_lite(config, p, x, positions)
                return _remat(out_mlp, False, p, attn, x)

        else:
            def body(x, p):
                with scope("attn"):
                    q, k, v = _remat(qkv, flank_dots, p, x, positions)
                    attn = attention_fn(q, k, v, causal=True,
                                        q_positions=positions,
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
        x, aux = body(x, {
            k: local_param(w, i, **(expert_kw if k in _EXPERT_KEYS else {}))
            for k, w in layer_params.items()})
        aux_total = aux_total + aux
    return x, aux_total


def forward_hidden(config: TpuLMConfig, params, tokens, positions=None,
                   attention_fn=None):
    """Forward up to (but excluding) the final norm and unembedding, over
    the flat layer stack (``pp_stages`` 1; :func:`forward` runs the
    pipeline). Returns (hidden [b, s, d], aux scalar).

    With neither ``attention_fn`` nor ``positions`` given (contiguous
    positions), the attention is ``default_attention_fn`` of the tokens'
    device: the flash kernels on the card, ring attention under an sp
    mesh, whose ranks each hold a chunk at :func:`default_positions`."""
    if config.pp_stages > 1:
        raise ValueError("forward_hidden runs the flat layer stack; "
                         "pp_stages > 1 runs through forward()")
    if attention_fn is None and positions is None:
        attention_fn = default_attention_fn(tokens.device)
    if positions is None:
        positions = default_positions(tokens)
    x = embed_tokens(config, params, tokens)
    return run_layer_stack(config, params["layers"], x, positions,
                           attention_fn)


def default_positions(tokens: torch.Tensor) -> torch.Tensor:
    """Global positions ``[b, s]`` of ``tokens``: ``[0..s)``, or under an
    sp mesh this rank's contiguous chunk of the sequence (rank ``r`` of
    sp holds ``[r * s, (r + 1) * s)``)."""
    b, s = tokens.shape
    offset = 0
    mesh = sharding.current_mesh()
    if mesh is not None and sharding.axis_size("sp", mesh) > 1:
        offset = mesh.get_local_rank("sp") * s
    return (torch.arange(s, device=tokens.device) + offset).expand(b, s)


def forward(
    config: TpuLMConfig,
    params,
    tokens: torch.Tensor,                 # [b, s] int
    positions: Optional[torch.Tensor] = None,   # [b, s]
    attention_fn=None,
):
    """Teacher-forced forward. Returns (logits [b, s, vocab] f32,
    aux_loss scalar). Attention as in :func:`forward_hidden`. Under
    ``pp_stages > 1`` the pipeline runs (``trainer/pipeline.py``); on a
    pp mesh only the rank of the last stage has logits, the others
    return None."""
    if config.pp_stages > 1:
        if attention_fn is None and positions is None:
            attention_fn = default_attention_fn(tokens.device)
        from dlrover_tpu_torch.trainer.pipeline import pipelined_forward

        return pipelined_forward(config, params, tokens, positions,
                                 attention_fn)
    x, aux = forward_hidden(config, params, tokens, positions, attention_fn)
    return unembed(config, params, x), aux


# ---- loss ------------------------------------------------------------------


def cross_entropy(logits, targets, mask=None, z_weight: float = 1e-4):
    """Token-mean CE + z-loss. logits f32 [b, s, v]; targets int [b, s];
    mask [b, s] (any dtype; nonzero = counted). Under tp the logits are
    this rank's vocab columns: the log-sum-exp and the target logit are
    reduced over tp."""
    if sharding.axis_size("tp") == 1:
        logz = torch.logsumexp(logits, dim=-1)
        target_logit = logits.gather(-1, targets.long()[..., None])[..., 0]
    else:
        m = sharding.max_over_tp(logits.amax(dim=-1))
        logz = m + torch.log(reduce_from_tp(
            torch.exp(logits - m[..., None]).sum(dim=-1)))
        cols = logits.shape[-1]
        ids = targets.long() - sharding.tp_rank() * cols
        hit = (ids >= 0) & (ids < cols)
        target_logit = reduce_from_tp(torch.where(
            hit, logits.gather(-1, ids.clamp(0, cols - 1)[..., None])[..., 0],
            0.0))
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
    """The fused CE handles one pipeline stage and a vocab-unsharded
    mesh, as the reference: under tp the dense path shards the logits
    product and reduces its log-sum-exp over tp."""
    if config.pp_stages > 1:
        return False
    mesh = sharding.current_mesh()
    if mesh is None:
        return True
    vocab_spec = sharding.logical_to_spec(("embed", "vocab"))[1]
    if vocab_spec is None:
        return True
    axes = (vocab_spec,) if isinstance(vocab_spec, str) else vocab_spec
    return all(sharding.axis_size(a, mesh) == 1 for a in axes)


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
        with scope("vocab"):
            ce = fused_cross_entropy(
                final_hidden(config, params, x),
                lm_head(config, params),
                targets,
                batch.get("mask"),
                block_rows=4096 if tokens.shape[1] >= 32768 else None,
            )
    else:
        logits, aux = forward(config, params, tokens,
                              attention_fn=attention_fn)
        if logits is None:
            # A pipeline rank without the last stage: its share of the
            # loss is its stages' aux (see trainer/pipeline.py).
            ce = torch.zeros((), dtype=torch.float32, device=aux.device)
        else:
            ce = cross_entropy(logits, targets, batch.get("mask"))
    loss = ce + config.moe_aux_weight * aux
    return loss, {"ce": ce, "aux": aux}
