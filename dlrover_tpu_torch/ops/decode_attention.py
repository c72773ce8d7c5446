"""Single-query (decode-step) attention over a KV cache, flat or paged.

Port of ``dlrover_tpu/ops/decode_attention.py``: ``decode_attention``
(the Pallas bodies ``_kernel`` and ``_kernel_q8``) over a flat
[b, max_len, kh, d] cache, and ``paged_decode_attention``
(``_paged_kernel`` and ``_paged_kernel_q8``) over a block pool
[num_blocks, block_size, kh, d] that every sequence reads through its
row of a block table; all four bodies run ``_decode_body``. On a CUDA
tensor :func:`decode_attention` and :func:`paged_decode_attention`
launch the hand-written Hopper kernels in ``csrc/decode_attention.cu``
(one body, two ways to turn a logical row into an address); on a CPU
tensor they run :func:`decode_attention_reference` and
:func:`paged_decode_attention_reference`, the plain PyTorch versions of
the same math. There is no other route: a CUDA call that cannot launch
raises.

The fill lengths are per row (a scalar is broadcast), so the serving
engines' ragged slots each read only their own filled rows.
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
    "paged_decode_attention_fp": 0,
    "paged_decode_attention_int8": 0,
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
        lib.dlr_paged_decode_attention.argtypes = [
            i, i, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            i, i, i, i, i, i, ctypes.c_float, ptr,
        ]
        lib.dlr_paged_decode_attention.restype = i
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


def _check(q, k_cache, v_cache, k_scale, v_scale,
           what="decode_attention"):
    """The checks the flat and the paged kernel share. ``k_cache`` is
    [rows..., kh, d] with any leading layout; the callers check that."""
    b, h, d = q.shape
    kh = k_cache.shape[-2]
    if k_cache.shape[-1] != d or v_cache.shape != k_cache.shape:
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
            if sc.dtype != torch.float32 or sc.shape != k_cache.shape[:-1]:
                raise TypeError(
                    f"scales must be f32 {list(k_cache.shape[:-1])}; got "
                    f"{sc.dtype} {tuple(sc.shape)}"
                )
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"tensor on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous tensors")
    # The kernel reads K/V rows as 16-byte vectors.
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"{what} needs 16-byte aligned caches")


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            + lib.dlr_cuda_error_string(rc).decode()
        )


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
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape[0] != q.shape[0]:
        raise ValueError(
            f"q must be [b, h, d] and the caches [b, max_len, kh, d]; got "
            f"{tuple(q.shape)} and {tuple(k_cache.shape)}"
        )
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
    _raise_on(rc, lib, "decode_attention")
    launch_counts[
        "decode_attention_int8" if quantized else "decode_attention_fp"
    ] += 1
    return out


def _logical_view(pool: torch.Tensor, block_tables: torch.Tensor):
    """[num_blocks, block_size, ...] through [b, max_blocks] tables ->
    the sequences' logical caches [b, max_blocks * block_size, ...]."""
    b, max_blocks = block_tables.shape
    view = pool[block_tables.long()]
    return view.reshape(b, max_blocks * pool.shape[1], *pool.shape[2:])


def paged_decode_attention_reference(
    q: torch.Tensor,             # [b, h, d]
    k_pool: torch.Tensor,        # [num_blocks, block_size, kh, d]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [b, max_blocks] int — pool blocks per row
    length: Union[int, torch.Tensor],   # [] or [b] — filled LOGICAL rows
    k_scale: Optional[torch.Tensor] = None,  # [num_blocks, block_size, kh]
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the paged kernel: gather each sequence's
    logical cache through its table row, then the math of
    :func:`decode_attention_reference`. A logical row is read iff it is
    below the fill, so what stale table entries past it point at never
    shows."""
    quantized = k_scale is not None
    return decode_attention_reference(
        q, _logical_view(k_pool, block_tables),
        _logical_view(v_pool, block_tables), length,
        _logical_view(k_scale, block_tables) if quantized else None,
        _logical_view(v_scale, block_tables) if quantized else None,
    )


def paged_decode_attention(
    q: torch.Tensor,             # [b, n_heads, d] — one query token per row
    k_pool: torch.Tensor,        # [num_blocks, block_size, kv_heads, d]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [b, max_blocks] int32
    length: Union[int, torch.Tensor],   # [] or [b] int — filled rows
    k_scale: Optional[torch.Tensor] = None,  # [num_blocks, block_size, kh]
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-query attention straight through a block table; returns
    [b, n_heads, d].

    Logical row ``r`` of sequence ``b`` lives at pool row
    ``block_tables[b, r // block_size] * block_size + r % block_size``;
    the rows ``< min(length[b], max_blocks * block_size)`` are read and
    no table entry at or past the fill is dereferenced, so stale ids
    there are harmless. Entries below the fill must name blocks of the
    pool (they are not checked: that would read the table back to the
    host on every step). With ``k_scale``/``v_scale`` the pools are int8
    and the kernel dequantizes inside its math. Any ``block_size`` is
    taken; what the kernel cannot take (a head_dim that is not a
    multiple of 16 or above 128, a pool that is not contiguous and
    16-byte aligned, a table that is not int32) raises. CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, length, k_scale, v_scale
        )
    what = "paged_decode_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {q.device}")
    if q.dim() != 3 or k_pool.dim() != 4 or block_tables.dim() != 2 \
            or block_tables.shape[0] != q.shape[0]:
        raise ValueError(
            f"q must be [b, h, d], the pools [num_blocks, block_size, kh, "
            f"d] and the tables [b, max_blocks]; got {tuple(q.shape)}, "
            f"{tuple(k_pool.shape)} and {tuple(block_tables.shape)}"
        )
    _check(q, k_pool, v_pool, k_scale, v_scale, what)
    if block_tables.dtype != torch.int32 or not block_tables.is_contiguous() \
            or block_tables.device != q.device:
        raise TypeError(
            f"{what} needs contiguous int32 block tables on {q.device}"
        )
    b, h, d = q.shape
    _, block_size, kh, _ = k_pool.shape
    max_blocks = block_tables.shape[1]
    out = torch.empty_like(q)
    if b == 0:
        return out
    if block_size < 1 or max_blocks < 1:
        raise ValueError(f"{what}: empty blocks or tables")
    lens = _row_lengths(length, b, q.device)
    quantized = k_scale is not None
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dlr_paged_decode_attention(
            _DTYPE_CODES[q.dtype], int(quantized),
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
            b, h, kh, block_size, max_blocks, d, d ** -0.5, stream,
        )
    _raise_on(rc, lib, what)
    launch_counts[
        "paged_decode_attention_int8" if quantized
        else "paged_decode_attention_fp"
    ] += 1
    return out
