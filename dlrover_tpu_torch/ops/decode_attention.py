"""Single-query (decode-step) attention over a KV cache.

Port of ``dlrover_tpu/ops/decode_attention.py::decode_attention``, the
Pallas kernel family with the fp body ``_kernel`` and the int8 body
``_kernel_q8`` (both over ``_decode_body``). On a CUDA tensor
:func:`decode_attention` launches the hand-written Hopper kernel in
``csrc/decode_attention.cu``; on a CPU tensor it runs
:func:`decode_attention_reference`, the plain PyTorch version of the
same math. There is no other route: a CUDA call that cannot launch
raises.

The fill lengths are per row (a scalar is broadcast), so the serving
engine's ragged slots each read only their own filled rows.
"""

import ctypes
from typing import Dict, Optional, Union

import torch

_SOURCE = "decode_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
# Finite "minus infinity" of the reference kernel's online softmax.
_NEG_INF = -1e30

# Kernel launches per body, counted where the wrapper launches it.
launch_counts: Dict[str, int] = {
    "decode_attention_fp": 0,
    "decode_attention_int8": 0,
}

_lib = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _library():
    global _lib
    if _lib is None:
        from dlrover_tpu_torch.ops import _ext

        lib = _ext.library(_SOURCE)
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.dlr_decode_attention.argtypes = [
            i, i, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            i, i, i, i, i, ctypes.c_float, ptr,
        ]
        lib.dlr_decode_attention.restype = i
        lib.dlr_cuda_error_string.argtypes = [i]
        lib.dlr_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _row_lengths(length, b: int, device) -> torch.Tensor:
    """Scalar-or-[b] fill -> contiguous [b] int32 on ``device``."""
    lens = torch.as_tensor(length, dtype=torch.int32, device=device)
    if lens.numel() not in (1, b):
        raise ValueError(
            f"length has {lens.numel()} entries for a batch of {b}"
        )
    return lens.reshape(-1).expand(b).contiguous()


def decode_attention_reference(
    q: torch.Tensor,        # [b, h, d]
    k_cache: torch.Tensor,  # [b, max_len, kh, d]
    v_cache: torch.Tensor,
    length: Union[int, torch.Tensor],   # [] or [b]
    k_scale: Optional[torch.Tensor] = None,  # [b, max_len, kh] f32
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: softmax over the rows
    ``< min(length[b], max_len)``, f32 math, int8 K scales on the logits
    and V scales on the probabilities (the denominator keeps the
    unscaled ones). Rows of length 0 give zeros. Returns [b, h, d] in
    q's dtype."""
    b, h, d = q.shape
    _, max_len, kh, _ = k_cache.shape
    g = h // kh
    qg = q.float().reshape(b, kh, g, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * d ** -0.5
    if k_scale is not None:
        s = s * k_scale.float().permute(0, 2, 1)[:, :, None, :]
    lens = _row_lengths(length, b, q.device).clamp(0, max_len)
    visible = (
        torch.arange(max_len, device=q.device)[None, :] < lens[:, None]
    )[:, None, None, :]                                   # [b, 1, 1, S]
    s = torch.where(visible, s, _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(visible, p, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = out / torch.clamp(denom, min=1e-30)
    return out.reshape(b, h, d).to(q.dtype)


def _check(q, k_cache, v_cache, k_scale, v_scale):
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(
            f"q must be [b, h, d] and the caches [b, max_len, kh, d]; got "
            f"{tuple(q.shape)} and {tuple(k_cache.shape)}"
        )
    b, h, d = q.shape
    _, max_len, kh, _ = k_cache.shape
    if k_cache.shape != (b, max_len, kh, d) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"cache shapes {tuple(k_cache.shape)} / {tuple(v_cache.shape)} "
            f"do not match q {tuple(q.shape)}"
        )
    if h % kh:
        raise ValueError(f"n_heads {h} not divisible by kv_heads {kh}")
    if d % 16 or d > _MAX_HEAD_DIM:
        raise ValueError(
            f"head_dim {d} unsupported by the kernel (a multiple of 16, "
            f"at most {_MAX_HEAD_DIM})"
        )
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPE_CODES)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    tensors = [q, k_cache, v_cache]
    if k_scale is None:
        if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
            raise TypeError("an fp cache must have q's dtype")
    else:
        if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
            raise TypeError("scales given: the caches must be int8")
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or sc.shape != (b, max_len, kh):
                raise TypeError(
                    f"scales must be f32 [{b}, {max_len}, {kh}]; got "
                    f"{sc.dtype} {tuple(sc.shape)}"
                )
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"tensor on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError("decode_attention needs contiguous tensors")
    # The kernel reads K/V rows as 16-byte vectors.
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention needs 16-byte aligned caches")


def decode_attention(
    q: torch.Tensor,        # [b, n_heads, d] — one query token per row
    k_cache: torch.Tensor,  # [b, max_len, kv_heads, d]
    v_cache: torch.Tensor,
    length: Union[int, torch.Tensor],   # [] or [b] int — filled rows
    k_scale: Optional[torch.Tensor] = None,  # [b, max_len, kv_heads] f32
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Length-masked single-query attention; returns [b, n_heads, d].

    With ``k_scale``/``v_scale`` the caches are int8
    (``ops/kv_quant.py``) and the kernel dequantizes inside its math.
    A fill above ``max_len`` reads ``max_len`` rows. CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return decode_attention_reference(
            q, k_cache, v_cache, length, k_scale, v_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    _check(q, k_cache, v_cache, k_scale, v_scale)
    b, h, d = q.shape
    _, max_len, kh, _ = k_cache.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    lens = _row_lengths(length, b, q.device)
    quantized = k_scale is not None
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dlr_decode_attention(
            _DTYPE_CODES[q.dtype], int(quantized),
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            lens.data_ptr(), out.data_ptr(),
            b, h, kh, max_len, d, d ** -0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(
            "decode_attention kernel launch failed: "
            + lib.dlr_cuda_error_string(rc).decode()
        )
    launch_counts[
        "decode_attention_int8" if quantized else "decode_attention_fp"
    ] += 1
    return out
