"""Fused blockwise cross-entropy: the LM loss without the [N, V] logits
(port of ``dlrover_tpu/ops/fused_ce.py``).

Computes the same token-mean ``nll + z_weight * logz^2`` loss as
``llama.cross_entropy`` over f32 logits, from the hidden states ``x`` and
the unembedding ``w``, by three routes (``impl``):

- ``"chunked"`` (the default): row chunks with an exact softmax each,
  computing the loss AND the unit-cotangent gradients in the forward (the
  loss is a scalar, so the backward only scales them). Its products are
  plain matrix products, as the reference leaves them to XLA.
- ``"xla"``: the same math as a loop over vocab blocks with an online
  logsumexp; the backward recomputes each logits block from (x, w,
  logz). These loops are also the plain versions of the kernels below.
- ``"pallas"``: the hand-written Hopper kernels of ``csrc/fused_ce.cu``
  behind the same custom backward: :func:`fused_ce_forward` (kernel B3,
  the TPU's ``_pallas_forward`` / ``_fwd_kernel``) and
  :func:`fused_ce_backward_dx` / :func:`fused_ce_backward_dw` (kernel
  B4, ``_pallas_backward`` / ``_bwd_dx_kernel`` / ``_bwd_dw_kernel``).

Every route forms its logits in f32 from the inputs' products, as the
reference's ``preferred_element_type=float32`` does: a bf16 logits tile
would put ~1e-2 errors on each token's logz. Per-row statistics are
compact ``[n]`` f32 vectors (the TPU's ``[n, 128]`` lane broadcast is a
TPU layout and is not kept). On CPU tensors each kernel wrapper runs its
plain version; on a CUDA tensor it launches the kernel or raises.
"""

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30

# N*V at which "auto" switches from dense logits to the fused CE: 2 GiB
# of f32 logits (the JAX package's measured crossover).
AUTO_FUSED_MIN_NV = 2 * 1024**3 // 4

_SOURCE = "fused_ce.cu"
_KERNEL_D = 128       # the kernels take d a multiple of this ...
_KERNEL_MAX_D = 1024  # ... up to this (8 warps x 128 columns)

# Kernel launches per kernel, counted where the wrapper launches it.
launch_counts: Dict[str, int] = {
    "fused_ce_forward": 0,
    "fused_ce_backward_dx": 0,
    "fused_ce_backward_dw": 0,
}

_lib = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def auto_prefers_dense(n_tokens: int, vocab: int) -> bool:
    """True when CE "auto" should run the dense logits path for a batch
    of ``n_tokens`` rows over ``vocab`` classes (below the measured
    crossover, see AUTO_FUSED_MIN_NV)."""
    return n_tokens * vocab < AUTO_FUSED_MIN_NV


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as f32 from the operands' exact products with f32 sums
    (XLA's ``preferred_element_type=float32``). bf16/fp16 on the card: one
    GEMM with an f32 output; elsewhere the operands go to f32 first
    (bf16 x bf16 products are exact in f32)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) \
            and b.dtype == a.dtype:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


# ---------------------------------------------------------------------------
# Vocab-scan path (impl="xla") -- also the plain versions of B3 and B4
# ---------------------------------------------------------------------------


def _vocab_blocks(x, w, block_v):
    """Yield (first column, column indices, w's block in x's dtype, its
    f32 logits) per vocab block. The last block is cut at V rather than
    padded with NEG_INF columns, which would add only exp(NEG_INF - m) = 0
    terms."""
    wc = w.to(x.dtype)
    for j0 in range(0, w.shape[1], block_v):
        wj = wc[:, j0:j0 + block_v]
        cols = torch.arange(j0, j0 + wj.shape[1], device=x.device)
        yield j0, cols, wj, _mm_f32(x, wj)


def _xla_forward(x, w, tgt, z_weight: float, block_v: int = 1024):
    """Plain version of kernel B3: online logsumexp over vocab blocks.
    Returns (per_tok, logz), both ``[n]`` f32."""
    n = x.shape[0]
    m = torch.full((n,), NEG_INF, dtype=torch.float32, device=x.device)
    l = torch.zeros((n,), dtype=torch.float32, device=x.device)
    tl = torch.zeros((n,), dtype=torch.float32, device=x.device)
    tgt = tgt.long()
    for _, cols, _, logits in _vocab_blocks(x, w, block_v):
        m_new = torch.maximum(m, logits.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        hit = cols[None, :] == tgt[:, None]
        tl = tl + torch.where(hit, logits, 0.0).sum(dim=-1)
        m = m_new
    logz = m + torch.log(torch.clamp(l, min=1e-30))
    per_tok = logz - tl + z_weight * logz.square()
    return per_tok, logz


def _xla_backward(x, w, tgt, logz, coef_a, coef_b, block_v: int = 1024,
                  want_dx: bool = True, want_dw: bool = True):
    """Plain version of kernel B4: per vocab block, the logits again,
    ``g = a * exp(logits - logz) - b * onehot`` rounded to x's dtype,
    ``dx += g @ w_blk^T`` and ``dw[:, blk] = x^T @ g`` (f32 sums).
    Returns (dx ``[n, d]`` f32 or None, dw ``[d, V]`` f32 or None)."""
    n, d = x.shape
    v = w.shape[1]
    tgt = tgt.long()
    dx = torch.zeros((n, d), dtype=torch.float32, device=x.device) \
        if want_dx else None
    dw = torch.empty((d, v), dtype=torch.float32, device=x.device) \
        if want_dw else None
    for j0, cols, wj, logits in _vocab_blocks(x, w, block_v):
        p = torch.exp(logits - logz[:, None])
        hit = cols[None, :] == tgt[:, None]
        g = coef_a[:, None] * p - torch.where(hit, coef_b[:, None], 0.0)
        g = g.to(x.dtype)
        if want_dx:
            dx += _mm_f32(g, wj.t())
        if want_dw:
            dw[:, j0:j0 + wj.shape[1]] = _mm_f32(x.t(), g)
    return dx, dw


# ---------------------------------------------------------------------------
# Chunked path (impl="chunked") -- gradients computed in the forward
# ---------------------------------------------------------------------------


def _pick_chunk(n: int, v: int, block_rows: Optional[int]) -> int:
    """Rows per chunk: the largest power of two whose f32 logits tile
    stays under ~1.1 GB, halved while padding n to a chunk multiple would
    waste more than ~12.5% of n (padded rows cost real matmul flops)."""
    if block_rows is not None:
        return max(8, min(block_rows, n))
    budget = 1152 * 1024**2
    c = 8
    while c * 2 <= n and (c * 2) * v * 4 <= budget:
        c *= 2
    while c > 8 and ((n + c - 1) // c * c - n) * 8 > n:
        c //= 2
    return c


def _chunk_grad_tile(x, w, tgt, wgt, z_weight):
    """One row chunk, exact softmax: (loss_contrib, dx_unit in x's dtype,
    dw_unit [d, V] f32). The [c, V] f32 logits are turned into g in
    place."""
    logits = _mm_f32(x, w)                               # [c, V] f32
    m = logits.amax(dim=-1, keepdim=True)
    logz = (m + torch.exp(logits - m).sum(dim=-1, keepdim=True).log())[:, 0]
    tl = logits.gather(1, tgt[:, None])[:, 0]
    per_tok = logz - tl + z_weight * logz.square()
    loss = (per_tok * wgt).sum()
    # d(loss)/d(logits) at unit cotangent: a * softmax - wgt * onehot.
    a = wgt * (1.0 + 2.0 * z_weight * logz)
    g = logits.sub_(logz[:, None]).exp_().mul_(a[:, None])
    rows = torch.arange(g.shape[0], device=g.device)
    g[rows, tgt] -= wgt
    g = g.to(x.dtype)
    dx = _mm_f32(g, w.t()).to(x.dtype)
    dw = _mm_f32(x.t(), g)                               # [d, V] f32
    return loss, dx, dw


def _chunked_loss_only(x, w, tgt, wgt, z_weight, chunk):
    """The loss alone (the primal, run without autograd)."""
    wc = w.to(x.dtype)
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for r0 in range(0, x.shape[0], chunk):
        logits = _mm_f32(x[r0:r0 + chunk], wc)
        logz = torch.logsumexp(logits, dim=-1)
        tl = logits.gather(1, tgt[r0:r0 + chunk, None])[:, 0]
        per_tok = logz - tl + z_weight * logz.square()
        loss = loss + (per_tok * wgt[r0:r0 + chunk]).sum()
    return loss


def _chunked_fwd_pass(x, w, tgt, wgt, z_weight, chunk):
    """Full fwd+grad sweep: (loss, dx_unit [n, d], dw_unit [d, V] f32)."""
    n, d = x.shape
    wc = w.to(x.dtype)
    dw = torch.zeros((d, w.shape[1]), dtype=torch.float32, device=x.device)
    dx = torch.empty((n, d), dtype=x.dtype, device=x.device)
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for r0 in range(0, n, chunk):
        sl = slice(r0, r0 + chunk)
        l_c, dx[sl], dw_c = _chunk_grad_tile(x[sl], wc, tgt[sl], wgt[sl],
                                             z_weight)
        dw += dw_c
        loss = loss + l_c
    return loss, dx, dw


class _ChunkedCE(torch.autograd.Function):
    """The reference's ``_chunked_ce_core``: the forward keeps (dx_unit,
    dw_unit in w's dtype) as residuals; the backward scales them by the
    incoming gradient in f32 and casts back."""

    @staticmethod
    def forward(ctx, x, w, tgt, wgt, z_weight, chunk):
        loss, dx_unit, dw_unit = _chunked_fwd_pass(x, w, tgt, wgt, z_weight,
                                                   chunk)
        ctx.save_for_backward(dx_unit, dw_unit.to(w.dtype))
        return loss

    @staticmethod
    def backward(ctx, gbar):
        dx_unit, dw_unit = ctx.saved_tensors
        dx = (gbar * dx_unit.float()).to(dx_unit.dtype)
        dw = (gbar * dw_unit.float()).to(dw_unit.dtype)
        return dx, dw, None, None, None, None


# ---------------------------------------------------------------------------
# Kernels B3 / B4
# ---------------------------------------------------------------------------


def _library():
    global _lib
    if _lib is None:
        from dlrover_tpu_torch.ops import _ext

        lib = _ext.library(_SOURCE)
        ptr = ctypes.c_void_p
        lib.dlr_ce_forward.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_float, ptr,
        ]
        for fn in (lib.dlr_ce_backward_dx, lib.dlr_ce_backward_dw):
            fn.argtypes = [ptr] * 9
        for fn in (lib.dlr_ce_forward, lib.dlr_ce_backward_dx,
                   lib.dlr_ce_backward_dw):
            fn.restype = ctypes.c_int
        lib.dlr_ce_error_string.argtypes = [ctypes.c_int]
        lib.dlr_ce_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _on_card(x, name) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return x.device.type == "cuda"


def _kernel_args(x, w, tgt, stats=()):
    """Checks what the kernels take and returns (x, w with a row stride
    padded to 8 elements, int32 targets, f32 stats, dims)."""
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"fused CE needs x [n, d] and w [d, V]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    n, d = x.shape
    v = w.shape[1]
    if d % _KERNEL_D or d > _KERNEL_MAX_D:
        raise ValueError(
            f"d {d} unsupported by the fused CE kernels (a multiple of "
            f"{_KERNEL_D}, at most {_KERNEL_MAX_D})"
        )
    for t in (w, tgt) + tuple(stats):
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, x on {x.device}")
    for t in (x, w):
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"the fused CE kernels take bfloat16, got {t.dtype} (f32 "
                f"kernels on the card are not ported)"
            )
    if tuple(tgt.shape) != (n,):
        raise ValueError(f"targets {tuple(tgt.shape)} must be [{n}]")
    for s in stats:
        if s.dtype != torch.float32 or tuple(s.shape) != (n,):
            raise TypeError(f"row stats must be f32 [{n}]; got {s.dtype} "
                            f"{tuple(s.shape)}")
    ldw = _ceil_to(v, 8)  # 16-byte aligned rows for cp.async
    w = F.pad(w, (0, ldw - v)) if ldw != v else w.contiguous()
    dims = (ctypes.c_longlong * 4)(n, d, v, ldw)
    return (x.contiguous(), w, tgt.to(torch.int32).contiguous(),
            [s.contiguous() for s in stats], dims)


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            + _library().dlr_ce_error_string(rc).decode()
        )


def fused_ce_forward(x, w, tgt, z_weight: float, block_v: int = 1024):
    """Kernel B3: (per_tok, logz), both ``[n]`` f32, for x ``[n, d]``, w
    ``[d, V]`` and int targets ``[n]``. CPU tensors run
    :func:`_xla_forward` (``block_v`` is its block); CUDA tensors launch
    the kernel or raise."""
    if not _on_card(x, "fused_ce_forward"):
        return _xla_forward(x, w, tgt, z_weight, block_v)
    x, w, tgt, _, dims = _kernel_args(x, w, tgt)
    n = x.shape[0]
    per_tok = torch.empty(n, dtype=torch.float32, device=x.device)
    logz = torch.empty(n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library().dlr_ce_forward(
            x.data_ptr(), w.data_ptr(), tgt.data_ptr(), per_tok.data_ptr(),
            logz.data_ptr(), dims, float(z_weight),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(rc, "fused_ce_forward")
    launch_counts["fused_ce_forward"] += 1
    return per_tok, logz


def _backward_kernel(name, x, w, tgt, logz, coef_a, coef_b, out):
    x, w, tgt, (logz, coef_a, coef_b), dims = _kernel_args(
        x, w, tgt, (logz, coef_a, coef_b))
    fn = getattr(_library(), "dlr_ce_" + name[len("fused_ce_"):])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), tgt.data_ptr(), logz.data_ptr(),
                coef_a.data_ptr(), coef_b.data_ptr(), out.data_ptr(), dims,
                torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, name)
    launch_counts[name] += 1
    return out


def fused_ce_backward_dx(x, w, tgt, logz, coef_a, coef_b,
                         block_v: int = 1024):
    """Kernel B4, dx: ``sum_v g @ w^T`` in x's dtype, with
    ``g = a * softmax - b * onehot`` from the recomputed logits. CPU
    tensors run the plain version."""
    if not _on_card(x, "fused_ce_backward_dx"):
        dx, _ = _xla_backward(x, w, tgt, logz, coef_a, coef_b, block_v,
                              want_dw=False)
        return dx.to(x.dtype)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    return _backward_kernel("fused_ce_backward_dx", x, w, tgt, logz, coef_a,
                            coef_b, out)


def fused_ce_backward_dw(x, w, tgt, logz, coef_a, coef_b,
                         block_v: int = 1024):
    """Kernel B4, dw: ``x^T @ g`` as ``[d, V]`` f32. CPU tensors run the
    plain version."""
    if not _on_card(x, "fused_ce_backward_dw"):
        return _xla_backward(x, w, tgt, logz, coef_a, coef_b, block_v,
                             want_dx=False)[1]
    out = torch.empty(w.shape, dtype=torch.float32, device=x.device)
    return _backward_kernel("fused_ce_backward_dw", x, w, tgt, logz, coef_a,
                            coef_b, out)


# ---------------------------------------------------------------------------
# Custom-backward core and public op
# ---------------------------------------------------------------------------


class _FusedCE(torch.autograd.Function):
    """The reference's ``_fused_ce_core`` over the vocab-scan loops
    (``use_kernels`` False) or kernels B3/B4. Residuals: (x, w in x's
    dtype, targets, weights, logz [n] f32)."""

    @staticmethod
    def forward(ctx, x, w, tgt, wgt, z_weight, block_v, use_kernels):
        wc = w.to(x.dtype)
        if use_kernels:
            per_tok, logz = fused_ce_forward(x, wc, tgt, z_weight, block_v)
        else:
            per_tok, logz = _xla_forward(x, wc, tgt, z_weight, block_v)
        ctx.save_for_backward(x, wc, tgt, wgt, logz)
        ctx.cfg = (z_weight, block_v, use_kernels, w.dtype)
        return (per_tok * wgt).sum()

    @staticmethod
    def backward(ctx, gbar):
        x, wc, tgt, wgt, logz = ctx.saved_tensors
        z_weight, block_v, use_kernels, w_dtype = ctx.cfg
        scaled = gbar * wgt                                  # [n] f32
        coef_a = scaled * (1.0 + 2.0 * z_weight * logz)
        coef_b = scaled
        if use_kernels:
            dx = fused_ce_backward_dx(x, wc, tgt, logz, coef_a, coef_b,
                                      block_v)
            dw = fused_ce_backward_dw(x, wc, tgt, logz, coef_a, coef_b,
                                      block_v)
        else:
            dx, dw = _xla_backward(x, wc, tgt, logz, coef_a, coef_b,
                                   block_v)
        return dx.to(x.dtype), dw.to(w_dtype), None, None, None, None, None


def resolve_impl(impl: Optional[str] = None) -> str:
    """The fused-CE sub-impl: ``impl`` if given, else "chunked" (the
    reference's single-device choice; its multi-device-mesh case, which
    picks "xla", waits for the port's mesh)."""
    return impl if impl is not None else "chunked"


def fused_cross_entropy(
    x: torch.Tensor,
    w: torch.Tensor,
    targets: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    z_weight: float = 1e-4,
    block_v: int = 1024,
    block_rows: Optional[int] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Token-mean CE + z-loss from hidden states, no [N, V] logits.

    Same semantics as ``llama.cross_entropy`` over f32 ``x @ w`` logits.
    x: [..., d] hidden states (post final-norm, compute dtype); w: [d, V]
    unembedding; targets int [...]; mask optional [...] -- tokens with
    mask 0 contribute nothing. impl: "chunked" | "xla" | "pallas" | None
    (see :func:`resolve_impl`). ``block_v`` is the vocab block of the
    "xla" loops; ``block_rows`` caps the "chunked" row chunk. The
    kernels pick their own tiles (the reference's ``block_n`` exists for
    TPU VMEM budgets and is not kept).
    """
    impl = resolve_impl(impl)
    if impl not in ("chunked", "xla", "pallas"):
        raise ValueError(f"impl {impl!r} not in ('chunked', 'xla', 'pallas')")
    d = x.shape[-1]
    n = x.numel() // d
    x2 = x.reshape(n, d)
    tgt = targets.reshape(n).long()
    if mask is None:
        wgt = torch.full((n,), 1.0 / n, dtype=torch.float32, device=x.device)
    else:
        m = mask.reshape(n).float()
        wgt = m / torch.clamp(m.sum(), min=1.0)
    wgt = wgt.detach()
    if impl == "chunked":
        chunk = _pick_chunk(max(n, 8), w.shape[1], block_rows)
        n_pad = _ceil_to(max(n, 8), chunk)
    else:
        # Padded rows carry weight 0 and target 0: they move neither the
        # loss nor the gradients.
        n_pad = _ceil_to(max(n, 8), 8)
    if n_pad != n:
        x2 = F.pad(x2, (0, 0, 0, n_pad - n))
        tgt = F.pad(tgt, (0, n_pad - n))
        wgt = F.pad(wgt, (0, n_pad - n))
    if impl == "chunked":
        if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
            return _ChunkedCE.apply(x2, w, tgt, wgt, z_weight, chunk)
        return _chunked_loss_only(x2, w, tgt, wgt, z_weight, chunk)
    return _FusedCE.apply(x2, w, tgt, wgt, z_weight, block_v,
                          impl == "pallas")
