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

The kernel is split-K flash decoding: :func:`split_plan` cuts max_len
into splits of 64-256 rows so that the grid fills the card's SMs several
times over; each split writes a partial softmax (m, l, acc) to scratch
allocated here, and the last split of a (row, kv head) to finish, found
through a per-stream ticket buffer (:func:`_tickets`), combines them in
split order. One CUDA launch per call either way.

The fill lengths are per row (a scalar is broadcast), so the serving
engines' ragged slots each read only their own filled rows.

:func:`spec_verify_attention` is the speculative-decoding verify step's
T-query attention. The reference's is plain JAX with no Pallas call, so
its port is plain PyTorch, on every device.
"""

import ctypes
import threading
from typing import Dict, Optional, Tuple, Union

import torch

_SOURCE = "decode_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
# Finite "minus infinity" of the reference kernel's online softmax.
_NEG_INF = -1e30
# Split-K: rows per split (multiples of 64, at most the kernel's 256),
# query heads per block, and the blocks per SM the plan aims for.
_SPLIT_ALIGN, _SPLIT_MAX, _MAX_GROUP, _WAVES = 64, 256, 8, 8

# Kernel launches per body, counted where the wrapper launches it
# (under a lock: a fleet's replica threads launch concurrently).
_count_lock = threading.Lock()
launch_counts: Dict[str, int] = {
    "decode_attention_fp": 0,
    "decode_attention_int8": 0,
    "paged_decode_attention_fp": 0,
    "paged_decode_attention_int8": 0,
}

_lib = None
_sm_counts: Dict[int, int] = {}
# Per (device, stream): int32 ticket counters, zero between launches.
_ticket_buffers: Dict[Tuple[str, int], torch.Tensor] = {}


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _count(name: str) -> None:
    with _count_lock:
        launch_counts[name] += 1


def _library():
    global _lib
    if _lib is None:
        from dlrover_tpu_torch.ops import _ext

        lib = _ext.library(_SOURCE)
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.dlr_decode_attention.argtypes = [
            i, i, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            ptr, ptr, ptr, i, i, i, i, i, i, i, ctypes.c_float, ptr,
        ]
        lib.dlr_decode_attention.restype = i
        lib.dlr_paged_decode_attention.argtypes = [
            i, i, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            ptr, ptr, ptr, i, i, i, i, i, i, i, i, ctypes.c_float, ptr,
        ]
        lib.dlr_paged_decode_attention.restype = i
        lib.dlr_cuda_error_string.argtypes = [i]
        lib.dlr_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def split_plan(b: int, h: int, kh: int, max_len: int,
               sms: int) -> Tuple[int, int]:
    """(split_rows, n_splits) of the kernel's split-K partition: the
    fewest rows per split (a multiple of 64, at most 256) that give
    b * kh * ceil(h / kh / 8) * n_splits about 8 blocks per SM, and
    n_splits = ceil(max_len / split_rows). One split means no scratch:
    the block writes its output directly."""
    blocks = b * kh * -(-(h // kh) // _MAX_GROUP)
    want = -(-max_len * blocks // (_WAVES * sms))
    rows = min(_SPLIT_MAX, max(_SPLIT_ALIGN,
                               -(-want // _SPLIT_ALIGN) * _SPLIT_ALIGN))
    return rows, -(-max_len // rows)


def split_k_reference(q, k_cache, v_cache, length, split_rows: int,
                      k_scale=None, v_scale=None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, f32: each split of
    ``split_rows`` rows below a row's fill keeps its own max m, sum l and
    unnormalised acc; the partials are combined in split order as
    m* = max m_s, l = sum l_s e^(m_s - m*), out = sum acc_s e^(m_s - m*)
    / max(l, 1e-30). Same function as :func:`decode_attention_reference`
    (the CPU tests hold the two together)."""
    b, h, d = q.shape
    _, max_len, kh, _ = k_cache.shape
    g = h // kh
    lens = _row_lengths(length, b, q.device).clamp(0, max_len)
    qg = q.float().reshape(b, kh, g, d)
    out = torch.zeros(b, kh, g, d, device=q.device)
    for i in range(b):
        n = int(lens[i])
        m_all, l_all, acc_all = [], [], []
        for r0 in range(0, n, split_rows):
            r1 = min(n, r0 + split_rows)
            s = torch.einsum("kgd,skd->kgs", qg[i],
                             k_cache[i, r0:r1].float()) * d ** -0.5
            if k_scale is not None:
                s = s * k_scale[i, r0:r1].float().T[:, None, :]
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            l_all.append(p.sum(dim=-1, keepdim=True))
            if v_scale is not None:
                p = p * v_scale[i, r0:r1].float().T[:, None, :]
            acc_all.append(torch.einsum("kgs,skd->kgd", p,
                                        v_cache[i, r0:r1].float()))
            m_all.append(m)
        if not m_all:
            continue
        m_star = torch.stack(m_all).amax(dim=0)
        w = [torch.exp(m - m_star) for m in m_all]
        l_tot = sum(l * wi for l, wi in zip(l_all, w))
        acc = sum(a * wi for a, wi in zip(acc_all, w))
        out[i] = acc / torch.clamp(l_tot, min=1e-30)
    return out.reshape(b, h, d).to(q.dtype)


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The ticket counters of ``stream`` on ``device``: at least ``n``
    int32 zeros. The kernel's last split of each (row, kv head) resets
    its counter, so a buffer stays zero between launches; launches on
    one stream run in order, and each stream has its own buffer, so no
    two launches in flight share a counter."""
    key = (str(device), stream)
    buf = _ticket_buffers.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _ticket_buffers[key] = buf
    return buf


def _scratch(q, b, h, kh, max_len, d, stream):
    """(split_rows, n_splits, part_acc, part_ml, tickets) for one launch:
    the partials and tickets are None when one split covers max_len."""
    rows, n_splits = split_plan(b, h, kh, max_len, _sm_count(q.device))
    if n_splits == 1:
        return rows, 1, None, None, None
    part_acc = torch.empty(b * h * n_splits * d, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(b * h * n_splits * 2, dtype=torch.float32,
                          device=q.device)
    gz = -(-(h // kh) // _MAX_GROUP)
    return (rows, n_splits, part_acc, part_ml,
            _tickets(q.device, stream, b * gz * kh))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


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


def spec_verify_attention(
    q: torch.Tensor,        # [b, T, h, d] — the fed token + K drafts
    k_cache: torch.Tensor,  # [b, S, kh, d] read-only; rows >= cache_len unread
    v_cache: torch.Tensor,
    k_new: torch.Tensor,    # [b, T, kh, d] K/V of the T new tokens
    v_new: torch.Tensor,
    cache_len: Union[int, torch.Tensor],   # [] or [b] — visible cache rows
    k_scale: Optional[torch.Tensor] = None,      # [b, S, kh] f32 (int8)
    v_scale: Optional[torch.Tensor] = None,
    k_new_q: Optional[torch.Tensor] = None,      # [b, T, kh, d] int8
    k_new_scale: Optional[torch.Tensor] = None,  # [b, T, kh] f32
    v_new_q: Optional[torch.Tensor] = None,
    v_new_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """T-query attention of the speculative-decoding verify step, plain
    PyTorch (the reference's is plain JAX: no kernel to port). Scores
    all T = K+1 new tokens against a READ-ONLY ragged cache, as K+1
    sequential one-token steps would if each drafted token's K/V had
    been appended before the next. Three key groups in one softmax:

    - the cache ([b, S]): rows visible iff ``< cache_len``, per row;
    - the intra-draft keys ([b, T]): query t sees new key u iff u < t.
      With int8 rows (``k_new_q``) these are the quantized values, the
      per-(row, head) scales folded after the reduction as in the cache
      part: what a sequential step would read back from the cache;
    - the self key: each query sees its own ``k_new``/``v_new`` as given.

    T = 1 is one-token decode with the new row kept apart. Returns
    [b, T, h, d] in q's dtype."""
    b, T, h, d = q.shape
    _, skv, kh, _ = k_cache.shape
    g = h // kh
    dev = q.device
    q32 = (q * d ** -0.5).float().reshape(b, T, kh, g, d)
    # Cache part: [b, kh, g, T, S], masked per row.
    logits = torch.einsum("btkgd,bskd->bkgts", q32, k_cache.float())
    if k_scale is not None:
        logits = logits * k_scale.float().permute(0, 2, 1)[:, :, None, None]
    lens = _row_lengths(cache_len, b, dev)
    visible = (
        torch.arange(skv, device=dev)[None, :] < lens[:, None]
    )[:, None, None, None, :]                            # [b, 1, 1, 1, S]
    logits = torch.where(visible, logits, _NEG_INF)
    # Intra-draft part: [b, kh, g, T, T], key u visible to query t iff
    # u < t (fp: the storage round trip is the identity).
    intra_k = (k_new_q if k_new_q is not None else k_new).float()
    l_intra = torch.einsum("btkgd,bukd->bkgtu", q32, intra_k)
    if k_new_scale is not None:
        l_intra = l_intra * k_new_scale.float().permute(0, 2, 1)[
            :, :, None, None]
    tq = torch.arange(T, device=dev)
    intra_mask = tq[None, :] < tq[:, None]                # [T, T] u < t
    l_intra = torch.where(intra_mask, l_intra, _NEG_INF)
    # Self part.
    l_self = torch.einsum("btkgd,btkd->bkgt", q32, k_new.float())
    m = torch.maximum(
        torch.maximum(logits.amax(dim=-1), l_intra.amax(dim=-1)), l_self
    )                                                     # [b, kh, g, T]
    p = torch.where(visible, torch.exp(logits - m[..., None]), 0.0)
    p_intra = torch.where(intra_mask, torch.exp(l_intra - m[..., None]),
                          0.0)
    p_self = torch.exp(l_self - m)
    denom = p.sum(dim=-1) + p_intra.sum(dim=-1) + p_self   # >= p_self
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None, None]
    intra_v = (v_new_q if v_new_q is not None else v_new).float()
    if v_new_scale is not None:
        p_intra = p_intra * v_new_scale.float().permute(0, 2, 1)[
            :, :, None, None]
    out = (
        torch.einsum("bkgts,bskd->bkgtd", p, v_cache.float())
        + torch.einsum("bkgtu,bukd->bkgtd", p_intra, intra_v)
        + p_self[..., None]
        * v_new.float().permute(0, 2, 1, 3)[:, :, None]
    ) / denom[..., None]
    # [b, kh, g, T, d] -> [b, T, h, d]
    return out.permute(0, 3, 1, 2, 4).reshape(b, T, h, d).to(q.dtype)


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
        rows, n_splits, part_acc, part_ml, tickets = _scratch(
            q, b, h, kh, max_len, d, stream)
        rc = lib.dlr_decode_attention(
            _DTYPE_CODES[q.dtype], int(quantized),
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), lens.data_ptr(), out.data_ptr(),
            _ptr(part_acc), _ptr(part_ml), _ptr(tickets),
            b, h, kh, max_len, d, rows, n_splits, d ** -0.5, stream,
        )
    _raise_on(rc, lib, "decode_attention")
    _count("decode_attention_int8" if quantized else "decode_attention_fp")
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
        rows, n_splits, part_acc, part_ml, tickets = _scratch(
            q, b, h, kh, max_blocks * block_size, d, stream)
        rc = lib.dlr_paged_decode_attention(
            _DTYPE_CODES[q.dtype], int(quantized),
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
            lens.data_ptr(), out.data_ptr(),
            _ptr(part_acc), _ptr(part_ml), _ptr(tickets),
            b, h, kh, block_size, max_blocks, d, rows, n_splits, d ** -0.5,
            stream,
        )
    _raise_on(rc, lib, what)
    _count("paged_decode_attention_int8" if quantized
           else "paged_decode_attention_fp")
    return out
