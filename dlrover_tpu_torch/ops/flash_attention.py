"""Flash attention, forward and backward (port of
``dlrover_tpu/ops/pallas_attention.py``).

On CUDA tensors the three wrappers launch the hand-written Hopper
kernels in ``csrc/flash_attention.cu``:

- :func:`flash_forward` (kernel B1, the TPU's ``_flash_forward`` /
  ``_flash_kernel``): online-softmax attention, returns ``out`` and the
  row log-sum-exp ``lse``;
- :func:`flash_backward_dq` and :func:`flash_backward_dkv` (kernel B2,
  the TPU's ``flash_backward_T`` / ``_bwd_dq_kernel`` /
  ``_bwd_dkv_kernel``): the FlashAttention-2 backward, P recomputed from
  ``lse``; dk/dv summed over the query heads of each GQA group inside
  one block, so no atomics.

On CPU tensors each wrapper runs its plain PyTorch version of the same
math; on any other device it raises. The kernels take bf16 with a head
dim that is a multiple of 16 and at most 128, in the model's
``[b, s, h, d]`` layout read through its strides (no transposes). ``lse``
and ``delta`` are compact ``[b, h, s]`` f32 (the TPU kernel's
``[b*h, s, 128]`` lane broadcast is a TPU layout and is not kept).
"""

import ctypes
from typing import Dict, Optional, Tuple

import torch

from dlrover_tpu_torch.ops.attention import NEG_INF

_SOURCE = "flash_attention.cu"
_MAX_HEAD_DIM = 128

# Kernel launches per kernel, counted where the wrapper launches it.
launch_counts: Dict[str, int] = {
    "flash_forward": 0,
    "flash_backward_dq": 0,
    "flash_backward_dkv": 0,
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
        ptr, f32 = ctypes.c_void_p, ctypes.c_float
        lib.dlr_flash_forward.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, f32, ptr,
        ]
        lib.dlr_flash_backward_dq.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, f32, ptr,
        ]
        lib.dlr_flash_backward_dkv.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, f32, ptr,
        ]
        for fn in (lib.dlr_flash_forward, lib.dlr_flash_backward_dq,
                   lib.dlr_flash_backward_dkv):
            fn.restype = ctypes.c_int
        lib.dlr_flash_error_string.argtypes = [ctypes.c_int]
        lib.dlr_flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# ---- plain PyTorch versions ---------------------------------------------


def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """f32 logits ``[b, kh, g, sq, skv]``, scaled after the product and
    causally masked (row index >= column index) with the finite
    NEG_INF, as the TPU kernels do."""
    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    qg = q.reshape(b, sq, kh, h // kh, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, NEG_INF)
    return s


def _resolve_scale(q, softmax_scale):
    return softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5


def flash_attention_reference(
    q: torch.Tensor,   # [b, sq, h, d]
    k: torch.Tensor,   # [b, skv, kh, d]
    v: torch.Tensor,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel B1. Returns (out ``[b, sq, h, d]`` in q's
    dtype, lse ``[b, h, sq]`` f32). P is rounded to V's dtype before
    P.V, as the kernel does; rows with no visible key give zeros."""
    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    s = _scores(q, k, causal, _resolve_scale(q, softmax_scale))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    l_q = l[..., 0].permute(0, 3, 1, 2)[..., None]       # [b, sq, kh, g, 1]
    m_q = m[..., 0].permute(0, 3, 1, 2)[..., None]
    out = o / torch.clamp(l_q, min=1e-30)
    out = torch.where(m_q > NEG_INF / 2, out, 0.0)
    lse = m + torch.log(torch.clamp(l, min=1e-30))       # [b, kh, g, sq, 1]
    return (out.reshape(b, sq, h, d).to(q.dtype),
            lse.reshape(b, h, sq))


def flash_backward_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, compact ``[b, h, s]``."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _plain_backward(q, k, v, lse, do, delta, causal, softmax_scale,
                    want_dq=True, want_dkv=True):
    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    g = h // kh
    scale = _resolve_scale(q, softmax_scale)
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.reshape(b, kh, g, sq)[..., None])
    dog = do.reshape(b, sq, kh, g, d).float()
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - delta.reshape(b, kh, g, sq)[..., None]) * scale
    ds = ds.to(q.dtype).float()
    dq = dk = dv = None
    if want_dq:
        dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float())
        dq = dq.reshape(b, sq, h, d).to(q.dtype)
    if want_dkv:
        qg = q.reshape(b, sq, kh, g, d).float()
        dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg).to(k.dtype)
        dv = torch.einsum(
            "bkgqs,bqkgd->bskd", p.to(do.dtype).float(), dog
        ).to(v.dtype)
    return dq, dk, dv


def flash_backward_reference(
    q, k, v, out, lse, do, causal: bool = True,
    softmax_scale: Optional[float] = None,
):
    """Plain version of kernel B2: P = exp(s * scale - lse), dP = dO.V^T,
    dS = P * (dP - delta) * scale rounded to the input dtype before the
    dq/dk products, P rounded to V's dtype before dV; dk and dv summed
    over each GQA group. Returns (dq, dk, dv)."""
    return _plain_backward(q, k, v, lse, do, flash_backward_delta(do, out),
                           causal, softmax_scale)


# ---- kernel wrappers ----------------------------------------------------


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel can read it through its strides (unit last
    stride, rows on 16-byte boundaries), else a contiguous copy."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(st % 8 == 0 for st in t.stride()[:3]))
    return t if ok else t.contiguous()


def _check(q, k, v, extra=()):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash attention needs q [b, sq, h, d] and k/v [b, skv, kh, d]; "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, _, h, d = q.shape
    _, _, kh, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ")
    if h % kh:
        raise ValueError(f"heads {h} not a multiple of kv_heads {kh}")
    if d % 16 or d > _MAX_HEAD_DIM:
        raise ValueError(
            f"head_dim {d} unsupported by the kernel (a multiple of 16, at "
            f"most {_MAX_HEAD_DIM})"
        )
    for t in (q, k, v) + tuple(extra):
        if t.device != q.device:
            raise ValueError(f"tensor on {t.device}, q on {q.device}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"the flash kernels take bfloat16, got {t.dtype} (f32 flash "
                f"on the card is not ported)"
            )


def _device(q, name):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    return q.device.type == "cuda"


def _dims(q, k, causal):
    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    return (ctypes.c_longlong * 7)(b, h, kh, sq, skv, d, int(bool(causal)))


def _strides(*ts):
    flat = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            + _library().dlr_flash_error_string(rc).decode()
        )


def _stats(t: torch.Tensor, b, h, sq, name):
    if t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq):
        raise TypeError(
            f"{name} must be f32 [{b}, {h}, {sq}]; got {t.dtype} "
            f"{tuple(t.shape)}"
        )
    return t.contiguous()


def flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, softmax_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1: (out ``[b, sq, h, d]``, lse ``[b, h, sq]`` f32). CPU
    tensors run :func:`flash_attention_reference`; CUDA tensors launch
    the kernel or raise."""
    if not _device(q, "flash_forward"):
        return flash_attention_reference(q, k, v, causal, softmax_scale)
    _check(q, k, v)
    q, k, v = _strided(q), _strided(k), _strided(v)
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.dlr_flash_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _dims(q, k, causal), _strides(q, k, v),
            _resolve_scale(q, softmax_scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(rc, "flash_forward")
    launch_counts["flash_forward"] += 1
    return out, lse


def flash_backward_dq(q, k, v, do, lse, delta, causal=True,
                      softmax_scale=None) -> torch.Tensor:
    """Kernel B2, dq half: one block per (b, head, 64-row q tile) loops
    over the kv tiles. CPU tensors run the plain version."""
    if not _device(q, "flash_backward_dq"):
        return _plain_backward(q, k, v, lse, do, delta, causal,
                               softmax_scale, want_dkv=False)[0]
    _check(q, k, v, (do, lse, delta))
    b, sq, h, d = q.shape
    q, k, v, do = _strided(q), _strided(k), _strided(v), _strided(do)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise TypeError(f"do {do.dtype} {tuple(do.shape)} must match q")
    lse = _stats(lse, b, h, sq, "lse")
    delta = _stats(delta, b, h, sq, "delta")
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.dlr_flash_backward_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _dims(q, k, causal), _strides(q, k, v, do),
            _resolve_scale(q, softmax_scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(rc, "flash_backward_dq")
    launch_counts["flash_backward_dq"] += 1
    return dq


def flash_backward_dkv(q, k, v, do, lse, delta, causal=True,
                       softmax_scale=None):
    """Kernel B2, dk/dv half: one block per (b, kv head, 64-row kv
    tile) loops over the query heads of its group and the q tiles at or
    past the diagonal. Returns (dk, dv). CPU tensors run the plain
    version."""
    if not _device(q, "flash_backward_dkv"):
        return _plain_backward(q, k, v, lse, do, delta, causal,
                               softmax_scale, want_dq=False)[1:]
    _check(q, k, v, (do, lse, delta))
    b, sq, h, d = q.shape
    q, k, v, do = _strided(q), _strided(k), _strided(v), _strided(do)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise TypeError(f"do {do.dtype} {tuple(do.shape)} must match q")
    lse = _stats(lse, b, h, sq, "lse")
    delta = _stats(delta, b, h, sq, "delta")
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.dlr_flash_backward_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _dims(q, k, causal), _strides(q, k, v, do),
            _resolve_scale(q, softmax_scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(rc, "flash_backward_dkv")
    launch_counts["flash_backward_dkv"] += 1
    return dk, dv


def flash_backward(q, k, v, out, lse, do, causal=True, softmax_scale=None):
    """delta, then kernel B2's two halves. Returns (dq, dk, dv)."""
    delta = flash_backward_delta(do, out)
    dq = flash_backward_dq(q, k, v, do, lse, delta, causal, softmax_scale)
    dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, causal,
                                softmax_scale)
    return dq, dk, dv


# ---- the differentiable op ----------------------------------------------


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v); saves (q, k, v, out, lse), all O(s*d),
    so the training step may keep them instead of recomputing."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softmax_scale):
        out, lse = flash_forward(q, k, v, causal, softmax_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.softmax_scale = softmax_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, do, ctx.causal,
                                    ctx.softmax_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Drop-in for ``dot_product_attention`` with contiguous positions:
    q ``[b, sq, h, d]``, k/v ``[b, skv, kh, d]``; returns ``[b, sq, h, d]``."""
    return FlashAttention.apply(q, k, v, causal, softmax_scale)


def make_flash_attention():
    """attention_fn for ``llama.forward``. Ignores explicit positions
    (it assumes contiguous [0..s) per call)."""

    def attention_fn(q, k, v, causal=True, q_positions=None,
                     kv_positions=None, softmax_scale=None):
        return flash_attention(q, k, v, causal, softmax_scale)

    # Backward residuals are O(s*d) (q/k/v/out + compact lse), so the
    # "mlp_only" remat policy may leave this call outside checkpointing.
    attention_fn.saveable_residuals = True
    attention_fn.is_plain_flash = True
    return attention_fn
