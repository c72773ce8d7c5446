"""Autoregressive decoding for TpuLM: KV-cache prefill + generate (port
of ``dlrover_tpu/models/generate.py``).

The cache is pre-allocated at ``max_len`` as [layers, batch, max_len,
kv_heads, head_dim] and written IN PLACE (the reference's immutable
arrays are rebuilt by XLA; here the tensors are simply updated). Each
layer:

1. projects q/k/v with the fused ``wqkv`` matmul and applies RoPE;
2. writes the new K/V rows at the cursor (int8 caches quantize them
   first, ``ops/kv_quant.py``);
3. attends: a single-token step (``sq == 1``) calls
   ``ops/decode_attention.decode_attention`` — the hand-written CUDA
   kernel on the card, which reads only each row's filled cache rows —
   and a prefill (``sq > 1``) runs plain attention over the cache with
   a positional causal mask.

This is the math of the reference's ``_layer_decode`` with its Pallas
branch taken (``DLROVER_TPU_DECODE_ATTN=pallas``), the port's one decode
route on the card. Decoding is an eager Python loop; nothing is
compiled. The serving engines' speculative verify step runs
:func:`_layer_verify` instead: T new tokens over a read-only cache, their
rows appended by the caller.
"""

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from dlrover_tpu_torch.common.env_utils import resolve_env_choice
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops.attention import dot_product_attention
from dlrover_tpu_torch.ops.decode_attention import (
    decode_attention,
    paged_decode_attention,
    spec_verify_attention,
)
from dlrover_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv
from dlrover_tpu_torch.ops.norms import rms_norm
from dlrover_tpu_torch.ops.rope import apply_rope


@dataclasses.dataclass
class DecodeCache:
    k: torch.Tensor  # [layers, b, max_len, kv_heads, head_dim]
    v: torch.Tensor
    length: torch.Tensor  # [b] int32 — tokens filled so far, per row
    # int8 caches only: per-(row, head) f32 scales [layers, b, max_len,
    # kv_heads]; None for fp caches.
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; asking for CUDA without a card
    raises (there is no silent CPU path)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch sees no CUDA device; pass "
            "device='cpu' to run the plain versions"
        )
    return device


def _kv_cache_dtype() -> str:
    """"fp" (cache in compute_dtype, the default) | "int8". The
    DLROVER_TPU_KV_DTYPE env var picks; typos warn once and fall back to
    "fp"."""
    return resolve_env_choice("DLROVER_TPU_KV_DTYPE", ("fp", "int8"), "fp")


def init_cache(
    config: llama.TpuLMConfig, batch: int, max_len: int,
    kv_dtype: Optional[str] = None, device="cuda",
) -> DecodeCache:
    llama.require_flat_stack(config)
    kv_dtype = kv_dtype or _kv_cache_dtype()
    if kv_dtype not in ("fp", "int8"):
        raise ValueError(f"kv_dtype {kv_dtype!r} not in ('fp', 'int8')")
    shape = (
        config.n_layers, batch, max_len, config.n_kv_heads, config.head_dim,
    )
    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    if kv_dtype == "int8":
        return DecodeCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            length=length,
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device),
        )
    dtype = config.compute_dtype
    return DecodeCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=length,
    )


def _fuse_decode_params(config, layers):
    """wq|wk|wv -> one [L, d, h + 2kh, hd] projection and w_gate|w_up ->
    one [L, d, 2f]: two matmuls per layer fewer on every step, same
    math. MoE layers are left as they are (their MLP is
    ``llama.mlp_block``)."""
    if config.n_experts > 0:
        return layers
    fused = dict(layers)
    fused["wqkv"] = torch.cat(
        [layers["wq"], layers["wk"], layers["wv"]], dim=2
    )
    fused["w_gu"] = torch.cat([layers["w_gate"], layers["w_up"]], dim=2)
    for k in ("wq", "wk", "wv", "w_gate", "w_up"):
        del fused[k]
    return fused


def prepare_decode_params(config, params, device="cuda"):
    """Decode-ready params on ``device``: matmul leaves cast to the
    compute dtype once (decode reads every weight each step, so bf16
    halves those bytes), norm scales and the MoE router kept f32, and
    the fused projections (:func:`_fuse_decode_params`)."""
    llama.require_flat_stack(config)
    cdt = config.compute_dtype
    keep = {"attn_norm", "mlp_norm", "router"}
    layers = {
        k: w.to(device=device, dtype=torch.float32 if k in keep else cdt)
        for k, w in params["layers"].items()
    }
    return {
        "embed": params["embed"].to(device=device, dtype=cdt),
        "layers": _fuse_decode_params(config, layers),
        "final_norm": params["final_norm"].to(device=device,
                                              dtype=torch.float32),
        "lm_head": params["lm_head"].to(device=device, dtype=cdt),
    }


def _fused_qkv(config, p, x, positions):
    """attention_qkv over the concatenated projection."""
    cdt = config.compute_dtype
    hx = rms_norm(x, p["attn_norm"]).to(cdt)
    qkv = torch.einsum("bsd,dhk->bshk", hx, p["wqkv"].to(cdt))
    h, kh = config.n_heads, config.n_kv_heads
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kh], qkv[:, :, h + kh:]
    q = apply_rope(q, positions, config.rope_theta)
    k = apply_rope(k, positions, config.rope_theta)
    return q, k, v


def _fused_mlp(config, p, x):
    cdt = config.compute_dtype
    hx = rms_norm(x, p["mlp_norm"]).to(cdt)
    f = config.mlp_dim
    gu = hx @ p["w_gu"].to(cdt)
    a = F.silu(gu[..., :f]) * gu[..., f:]
    out = a @ p["w_down"].to(cdt)
    return x + out.to(x.dtype)


def _append(cache: torch.Tensor, new: torch.Tensor,
            cursor: Union[int, torch.Tensor, tuple]) -> None:
    """Write ``new`` [b, sq, ...] into ``cache`` in place. A flat
    [b, max_len, ...] cache takes one shared cursor (an int) or one row
    per batch row at a per-row [b] cursor (ragged slots; sq must be 1).
    A tuple names the target of each of the b * sq new rows in order:
    ``(i0, i1)`` two [b * sq] index vectors into the cache's first two
    dims (a paged [num_blocks, block_size, ...] pool's ``(block,
    offset)``; rows sharing a target may land in any order), or ``(i0,
    i1, src)`` to write only the new rows ``src`` of the flattened
    [b * sq] (the others are dropped)."""
    if isinstance(cursor, int):
        cache[:, cursor:cursor + new.shape[1]] = new
    elif isinstance(cursor, tuple):
        rows = new.flatten(0, 1)
        if len(cursor) == 3:
            rows = rows[cursor[2]]
        cache[cursor[0], cursor[1]] = rows
    else:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, cursor] = new[:, 0]


def _layer_decode(
    config, p, x, positions, k_cache, v_cache, cursor, fill=None,
    k_scale=None, v_scale=None, block_tables=None, plain_attention=False,
):
    """One decoder block over [b, sq] new tokens with cache append.

    ``k_cache``/``v_cache`` are this layer's [b, max_len, kh, d] cache
    views, updated in place at ``cursor`` (see :func:`_append`);
    ``k_scale``/``v_scale`` mark an int8 cache. A single-token step
    attends through the decode kernel over ``fill`` [b] rows (the fill
    after the append, clamped to max_len); a prefill attends over the
    whole cache with the positional causal mask, so unfilled rows never
    show (``plain_attention`` sends a single token that way too). With
    ``block_tables`` [b, max_blocks] the caches are block pools
    [num_blocks, block_size, kh, d], ``cursor`` is a ``(block, offset)``
    pair and the single-token step attends through the paged kernel."""
    residual = x
    if "wqkv" in p:
        q, k, v = _fused_qkv(config, p, x, positions)
    else:
        q, k, v = llama.attention_qkv(config, p, x, positions)
    quantized = k_scale is not None
    if quantized:
        kq, ks_new = quantize_kv(k)
        vq, vs_new = quantize_kv(v)
        _append(k_cache, kq, cursor)
        _append(v_cache, vq, cursor)
        _append(k_scale, ks_new, cursor)
        _append(v_scale, vs_new, cursor)
    else:
        _append(k_cache, k.to(k_cache.dtype), cursor)
        _append(v_cache, v.to(v_cache.dtype), cursor)
    if block_tables is not None:
        attn = paged_decode_attention(
            q[:, 0].contiguous(), k_cache, v_cache, block_tables, fill,
            k_scale=k_scale, v_scale=v_scale,
        )[:, None]
    elif q.shape[1] == 1 and not plain_attention:
        attn = decode_attention(
            q[:, 0].contiguous(), k_cache, v_cache, fill,
            k_scale=k_scale, v_scale=v_scale,
        )[:, None]
    else:
        if quantized:
            cdt = config.compute_dtype
            k_attn = dequantize_kv(k_cache, k_scale, cdt)
            v_attn = dequantize_kv(v_cache, v_scale, cdt)
        else:
            k_attn, v_attn = k_cache, v_cache
        max_len = k_cache.shape[1]
        attn = dot_product_attention(
            q, k_attn, v_attn, causal=True, q_positions=positions,
            kv_positions=torch.arange(max_len, device=q.device),
        )
    x = llama.attention_out(config, p, attn, residual)
    if "w_gu" in p:
        return _fused_mlp(config, p, x)
    return llama.mlp_block(config, p, x)[0]


def _layer_verify(config, p, x, positions, k_cache, v_cache, cache_len,
                  k_scale=None, v_scale=None):
    """One decoder block over [b, T] tokens (the speculative-decoding
    verify step: the fed token plus K drafts); the cache is read-only
    (after the reference's ``_layer_verify_read_only``). Attention runs
    :func:`spec_verify_attention` over ``cache_len`` [b] visible rows,
    the drafts causal among themselves. Returns ``(x, k_rows, v_rows,
    k_rows_scale, v_rows_scale)``: the T new rows as the cache stores
    them, for the caller to append (the scales are None for an fp
    cache).

    One difference from the reference, on purpose: the port's decode
    step appends a token's row first and reads it back, so an int8
    cache's token sees its OWN row quantized (the reference keeps it at
    full precision). The verify step follows the port's decode step, so
    that spec-on gives the port's spec-off tokens: with ``k_scale``
    given, the new rows are quantized in the layer and every new key,
    the self key too, is read quantized. With an fp cache in the compute
    dtype the storage round trip is the identity and both conventions
    are one."""
    residual = x
    if "wqkv" in p:
        q, k, v = _fused_qkv(config, p, x, positions)
    else:
        q, k, v = llama.attention_qkv(config, p, x, positions)
    if k_scale is not None:
        kq, ks_rows = quantize_kv(k)
        vq, vs_rows = quantize_kv(v)
        attn = spec_verify_attention(
            q, k_cache, v_cache, dequantize_kv(kq, ks_rows),
            dequantize_kv(vq, vs_rows), cache_len,
            k_scale=k_scale, v_scale=v_scale,
            k_new_q=kq, k_new_scale=ks_rows,
            v_new_q=vq, v_new_scale=vs_rows,
        )
        rows = (kq, vq, ks_rows, vs_rows)
    else:
        k, v = k.to(k_cache.dtype), v.to(v_cache.dtype)
        attn = spec_verify_attention(q, k_cache, v_cache, k, v, cache_len)
        rows = (k, v, None, None)
    x = llama.attention_out(config, p, attn, residual)
    if "w_gu" in p:
        x = _fused_mlp(config, p, x)
    else:
        x = llama.mlp_block(config, p, x)[0]
    return (x, *rows)


def _forward_with_cache(config, params, tokens, cache: DecodeCache,
                        cursor: Optional[int] = None):
    """Run [b, sq] tokens through all layers, appending to the cache at
    the uniform fill ``cursor`` (read from ``cache.length`` when not
    given; callers that track it on the host avoid that sync). Returns
    (logits of the LAST position [b, vocab], the updated cache)."""
    b, sq = tokens.shape
    if cursor is None:
        cursor = int(cache.length[0])
    max_len = cache.k.shape[2]
    if cursor + sq > max_len:
        raise ValueError(f"cursor {cursor} + {sq} tokens > max_len {max_len}")
    positions = (
        cursor + torch.arange(sq, dtype=torch.int32, device=tokens.device)
    ).expand(b, sq)
    fill = None
    if sq == 1:
        fill = torch.full((b,), cursor + 1, dtype=torch.int32,
                          device=tokens.device)
    x = llama.embed_tokens(config, params, tokens)
    quantized = cache.k_scale is not None
    for i in range(config.n_layers):
        x = _layer_decode(
            config, llama.layer_params(params, i), x, positions,
            cache.k[i], cache.v[i], cursor, fill,
            k_scale=cache.k_scale[i] if quantized else None,
            v_scale=cache.v_scale[i] if quantized else None,
        )
    logits = llama.unembed(config, params, x[:, -1:, :])[:, 0, :]
    cache.length += sq
    return logits, cache


def sample_token(logits: torch.Tensor, temperature,
                 generator: Optional[torch.Generator] = None):
    """Greedy-or-sampled next token over the last axis of ``logits``.
    ``temperature`` is a float or a per-row vector; rows with t <= 0
    take the argmax of the raw logits. Sampling is gumbel-max:
    ``argmax(logits / t + gumbel)``, the noise drawn from ``generator``
    (which must live on the logits' device). Host temperatures that are
    all <= 0 draw no noise."""
    if not isinstance(temperature, torch.Tensor):
        if (np.asarray(temperature, np.float32) <= 0.0).all():
            return logits.argmax(dim=-1).to(torch.int32)
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=logits.device)
    t_rows = t[..., None] if t.ndim else t
    z = logits / torch.clamp(t_rows, min=1e-6)
    # -log(Exp(1)) is Gumbel(0, 1).
    gumbel = -torch.empty_like(z).exponential_(generator=generator).log()
    z = torch.where(t_rows > 0.0, z + gumbel, logits)
    return z.argmax(dim=-1).to(torch.int32)


def sample_token_logprobs(logits: torch.Tensor, temperature,
                          generator: Optional[torch.Generator] = None,
                          top_k: int = 0):
    """:func:`sample_token` that also returns the chosen token's
    log-probability under the (temperature-scaled) sampling
    distribution and, with ``top_k > 0``, the top-k alternatives. The
    token is :func:`sample_token`'s for the same generator state (the
    same call); only the log_softmax pass is new. Rows with t <= 0
    report the argmax token's logprob under the unscaled softmax; host
    temperatures that are all <= 0 copy nothing to the device.

    Returns ``(token, logprob)``, or with ``top_k``:
    ``(token, logprob, topk_tokens, topk_logprobs)``."""
    tok = sample_token(logits, temperature, generator)
    base = logits
    if isinstance(temperature, torch.Tensor) or (
            np.asarray(temperature, np.float32) > 0.0).any():
        t = torch.as_tensor(temperature, dtype=torch.float32,
                            device=logits.device)
        t_rows = t[..., None] if t.ndim else t
        base = torch.where(t_rows > 0.0,
                           logits / torch.clamp(t_rows, min=1e-6), logits)
    logp = torch.log_softmax(base.float(), dim=-1)
    lp = logp.gather(-1, tok.long()[..., None])[..., 0]
    if top_k:
        tk_lp, tk_idx = logp.topk(top_k, dim=-1)
        return tok, lp, tk_idx.to(torch.int32), tk_lp
    return tok, lp


class GenerateResult(NamedTuple):
    tokens: torch.Tensor      # [b, max_new_tokens] int32
    cache: DecodeCache


@torch.inference_mode()
def generate(
    config: llama.TpuLMConfig,
    params,
    prompt,                    # [b, prompt_len] int
    max_new_tokens: int,
    max_len: Optional[int] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    kv_cache_dtype: Optional[str] = None,
    device="cuda",
) -> GenerateResult:
    """Greedy (temperature=0) or sampled decoding: one fixed-batch
    prefill, then one single-token step per new token.
    ``kv_cache_dtype``: "fp" (default; DLROVER_TPU_KV_DTYPE sets it) or
    "int8", which halves the KV bytes every step reads."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    device = resolve_device(device)
    prompt = torch.as_tensor(prompt, dtype=torch.int32, device=device)
    b, prompt_len = prompt.shape
    max_len = max_len or (prompt_len + max_new_tokens)
    if max_len < prompt_len + max_new_tokens:
        raise ValueError("max_len too small for prompt + new tokens")
    if temperature > 0.0 and generator is None:
        # A silent fixed default would make every sampled call return
        # identical tokens.
        raise ValueError("temperature > 0 requires an explicit generator")
    params = prepare_decode_params(config, params, device)
    cache = init_cache(config, b, max_len, kv_dtype=kv_cache_dtype,
                       device=device)
    logits, cache = _forward_with_cache(config, params, prompt, cache, 0)
    tok = sample_token(logits, temperature, generator)
    out = [tok]
    for cursor in range(prompt_len, prompt_len + max_new_tokens - 1):
        logits, cache = _forward_with_cache(
            config, params, tok[:, None], cache, cursor
        )
        tok = sample_token(logits, temperature, generator)
        out.append(tok)
    return GenerateResult(tokens=torch.stack(out, dim=1), cache=cache)
