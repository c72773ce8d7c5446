"""Sort-based MoE dispatch: tile-blocked gather -> GEMM -> scatter over
the expert-sorted row order (port of ``dlrover_tpu/ops/moe_dispatch.py``).

The dropless MoE path (``models/moe._dropless_core``) routes ``m`` token
copies to experts. :func:`build_dispatch_layout` sorts the copies by
expert into a group-aligned padded layout: every ``tile_m``-row tile
belongs to ONE expert, padding slots carry id -1. The permutation never
moves data through memory: the kernels gather source rows by
``row_ids`` and scatter result rows to ``dest_ids`` themselves.

- :func:`grouped_ffn` (a ``torch.autograd.Function``): per tile, gather
  ``x[row_ids]`` (-1 reads a zero row), ``h = x @ w_gu[e]`` in f32,
  ``a = silu(h[:, :f]) * h[:, f:]`` rounded to x's dtype, ``y = a @
  w_down[e]``, scattered to ``y[dest_ids]`` (-1 skipped);
- its backward reuses the same ids: dx (h and a recomputed, ``da = dy @
  w_down[e]^T``, ``dh`` through the silu gate, ``dx_c = dh @ w_gu[e]^T``
  scattered per copy, then the dense sum over the k copies of each
  source row) and two per-expert weight gradients ``dw = lhs^T @ rhs``
  summed over each expert's tiles in order.

Kernels (``csrc/moe_dispatch.cu``, hand-written for sm_90a), each
behind a wrapper with a plain PyTorch version of the same math:

- B7 :func:`grouped_ffn_forward` (the TPU's ``_grouped_ffn_fwd`` /
  ``_fwd_kernel``);
- B8 :func:`grouped_ffn_backward_dx` (``_dx_kernel``),
  :func:`grouped_ffn_backward_dw_gu` (``_dw_accum_kernel``) and
  :func:`grouped_ffn_backward_dw_down` (``_dw_sorted_lhs_kernel``).

On CPU tensors a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. The layout is static-shaped and built on
the tokens' device without a host sync, so the kernel grids are known
before the routing is.
"""

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

_SOURCE = "moe_dispatch.cu"
_KERNEL_ALIGN = 128   # the kernels take d and f multiples of this
_TILES = (16, 128)    # ... and these tile_m
_MAX_GROUPS = 1024    # the dw kernels rank at most this many experts

# Kernel launches per kernel, counted where the wrapper launches it (B7
# and B8 dx each run as two CUDA launches and count once).
launch_counts: Dict[str, int] = {
    "grouped_ffn_forward": 0,
    "grouped_ffn_backward_dx": 0,
    "grouped_ffn_backward_dw_gu": 0,
    "grouped_ffn_backward_dw_down": 0,
}

_lib = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def default_tile_m(m: int) -> int:
    """Row-tile size: 128 once there is enough work, 16 for small
    inputs (a decode step's handful of copies)."""
    return 128 if m >= 1024 else 16


def build_dispatch_layout(flat_expert: torch.Tensor, n_groups: int,
                          tile_m: int, copies_per_src: int):
    """Group-aligned padded layout for ``m`` copies sorted by expert.

    ``flat_expert`` [m] holds each copy's routed group in ``[0,
    n_groups)``; entries >= n_groups are sentinel copies that get no
    slot. Returns int32 tensors on ``flat_expert``'s device:

    - ``row_ids`` [m_pad]: source row (``sorted_copy // copies_per_src``)
      per padded slot, -1 on padding;
    - ``dest_ids`` [m_pad]: copy-major output row per slot (the sorted
      copy's original index), -1 on padding;
    - ``tile_expert`` [T]: the one group every row of tile ``t`` belongs
      to (non-decreasing; trailing all-padding tiles take the last
      group);

    with ``T = cdiv(m, tile_m) + n_groups + 1`` and ``m_pad = T * tile_m``.
    Only values depend on the routing, never shapes, and nothing is read
    back to the host."""
    m = flat_expert.shape[0]
    T = -(-m // tile_m) + n_groups + 1
    m_pad = T * tile_m
    dev = flat_expert.device
    # Sentinel copies sort into an internal trailing group and are
    # dropped from the slot scatter below.
    fe = torch.clamp(flat_expert.long(), max=n_groups)
    order = torch.argsort(fe, stable=True)                      # [m]
    sorted_grp = fe[order]
    # scatter_add_ rather than bincount: bincount sizes its output from
    # the data, which reads it back to the host.
    counts = torch.zeros(n_groups + 1, dtype=torch.long, device=dev)
    counts.scatter_add_(0, fe, torch.ones_like(fe))
    padded = -(-counts // tile_m) * tile_m
    # Every real group gets >= 1 tile even when empty: its dw block is
    # then written with the zero gradient by an all-padding tile.
    padded[:n_groups] = torch.clamp(padded[:n_groups], min=tile_m)
    ends = torch.cumsum(padded, 0)
    pad_off = ends - padded                                     # [g+1]
    grp_start = torch.cumsum(counts, 0) - counts
    j = torch.arange(m, device=dev)
    slot = pad_off[sorted_grp] + (j - grp_start[sorted_grp])
    # Out-of-range slots (sentinels) land on a dump row past m_pad.
    slot = torch.where(sorted_grp < n_groups, slot, m_pad)
    row_ids = torch.full((m_pad + 1,), -1, dtype=torch.int32, device=dev)
    dest_ids = torch.full((m_pad + 1,), -1, dtype=torch.int32, device=dev)
    row_ids[slot] = (order // copies_per_src).to(torch.int32)
    dest_ids[slot] = order.to(torch.int32)
    tile_start = torch.arange(T, device=dev) * tile_m
    tile_expert = torch.searchsorted(ends, tile_start, right=True)
    tile_expert = torch.clamp(tile_expert, 0, n_groups - 1).to(torch.int32)
    return row_ids[:m_pad], dest_ids[:m_pad], tile_expert


def _silu_bwd(hg, hu, da):
    """d(silu(hg) * hu) pulled back through the elementwise gate."""
    sg = torch.sigmoid(hg)
    silu = hg * sg
    dhu = da * silu
    dhg = da * hu * (sg * (1.0 + hg * (1.0 - sg)))
    return dhg, dhu


# ---------------------------------------------------------------------------
# Plain versions of B7 / B8 (the kernels' math, batched over tiles)
# ---------------------------------------------------------------------------


def _gather_rows(src, ids):
    """``src[ids]`` with rows of id < 0 read as zeros."""
    rows = src[torch.clamp(ids.long(), min=0)]
    return torch.where((ids >= 0)[:, None], rows, torch.zeros_like(rows))


def _scatter_rows(rows, ids, n_out):
    """[n_out, d] with row ``ids[j]`` = ``rows[j]`` (ids < 0 skipped;
    rows no id names are zero)."""
    out = torch.zeros((n_out + 1, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    out[torch.where(ids >= 0, ids.long(), n_out)] = rows
    return out[:n_out]


def _tiled(rows, tile_m):
    """[m_pad, c] -> [T, tile_m, c] in f32 (bf16 products are exact in
    f32, so an f32 product gives the kernels' f32-accumulated GEMM)."""
    return rows.float().reshape(-1, tile_m, rows.shape[-1])


def _forward_reference(x, w_gu, w_down, row_ids, dest_ids, tile_expert,
                       n_out, tile_m):
    """Plain version of B7."""
    te = tile_expert.long()
    f = w_down.shape[1]
    h = torch.bmm(_tiled(_gather_rows(x, row_ids), tile_m), w_gu[te].float())
    a = (F.silu(h[..., :f]) * h[..., f:]).to(x.dtype)
    y = torch.bmm(a.float(), w_down[te].float()).to(x.dtype)
    return _scatter_rows(y.reshape(-1, x.shape[1]), dest_ids, n_out)


def _backward_dx_reference(x, g, w_gu, w_down, row_ids, dest_ids,
                           tile_expert, tile_m):
    """Plain version of B8 dx: (dx_c [n_out, d], dh_sorted [m_pad, 2f],
    a_sorted [m_pad, f]), all in x's dtype."""
    te = tile_expert.long()
    d = x.shape[1]
    f = w_down.shape[1]
    xs = _gather_rows(x, row_ids)
    # dy rows masked by the slot's row id, as the reference masks them.
    dys = torch.where((row_ids >= 0)[:, None], _gather_rows(g, dest_ids),
                      torch.zeros((), dtype=g.dtype, device=g.device))
    h = torch.bmm(_tiled(xs, tile_m), w_gu[te].float())
    hg, hu = h[..., :f], h[..., f:]
    a_sorted = (F.silu(hg) * hu).to(x.dtype).reshape(-1, f)
    da = torch.bmm(_tiled(dys.to(w_down.dtype), tile_m),
                   w_down[te].float().transpose(1, 2))
    dhg, dhu = _silu_bwd(hg, hu, da)
    dh = torch.cat([dhg, dhu], dim=-1)
    dh_sorted = dh.to(x.dtype).reshape(-1, 2 * f)
    dx_t = torch.bmm(dh.to(w_gu.dtype).float(),
                     w_gu[te].float().transpose(1, 2)).to(x.dtype)
    dx_c = _scatter_rows(dx_t.reshape(-1, d), dest_ids, g.shape[0])
    return dx_c, dh_sorted, a_sorted


def _dw_reference(lhs, rhs, tile_expert, n_groups, tile_m):
    """``dw[e] = sum over e's tiles of lhs_t^T @ rhs_t`` as [E, c_l, c_r]
    f32: per-tile products, then a one-hot product over tiles (f32, no
    atomics)."""
    contrib = torch.bmm(_tiled(lhs, tile_m).transpose(1, 2),
                        _tiled(rhs, tile_m))                   # [T, l, r]
    onehot = F.one_hot(tile_expert.long(), n_groups).float()   # [T, E]
    T = contrib.shape[0]
    return (onehot.t() @ contrib.reshape(T, -1)).reshape(
        n_groups, *contrib.shape[1:])


def _backward_dw_gu_reference(x, dh_sorted, row_ids, tile_expert, n_groups,
                              tile_m):
    """Plain version of B8 dw_gu: [E, d, 2f] f32."""
    return _dw_reference(_gather_rows(x, row_ids), dh_sorted, tile_expert,
                         n_groups, tile_m)


def _backward_dw_down_reference(a_sorted, g, dest_ids, tile_expert,
                                n_groups, tile_m):
    """Plain version of B8 dw_down: [E, f, d] f32."""
    return _dw_reference(a_sorted, _gather_rows(g, dest_ids), tile_expert,
                         n_groups, tile_m)


# ---------------------------------------------------------------------------
# Kernels B7 / B8
# ---------------------------------------------------------------------------


def _library():
    global _lib
    if _lib is None:
        from dlrover_tpu_torch.ops import _ext

        lib = _ext.library(_SOURCE)
        ptr = ctypes.c_void_p
        lib.dlr_moe_forward.argtypes = [ptr] * 10
        lib.dlr_moe_backward_dx.argtypes = [ptr] * 12
        lib.dlr_moe_backward_dx_launch.argtypes = (
            [ptr] * 11 + [ctypes.c_int, ptr])
        lib.dlr_moe_backward_dw.argtypes = [ptr] * 9
        for fn in (lib.dlr_moe_forward, lib.dlr_moe_backward_dx,
                   lib.dlr_moe_backward_dx_launch, lib.dlr_moe_backward_dw):
            fn.restype = ctypes.c_int
        lib.dlr_moe_dw_config.argtypes = [ctypes.c_int] * 3 + [ptr] * 3
        lib.dlr_moe_dw_config.restype = ctypes.c_int
        for fn in (lib.dlr_moe_ffn_config, lib.dlr_moe_dx_gu_config):
            fn.argtypes = [ctypes.c_int] + [ptr] * 4
            fn.restype = ctypes.c_int
        lib.dlr_moe_error_string.argtypes = [ctypes.c_int]
        lib.dlr_moe_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def dw_kernel_config(m: int, n: int, gather_lhs: bool) -> Dict[str, int]:
    """B8 dw's launch for an [m, n] weight gradient (dw_gu gathers the
    lhs, dw_down the rhs): its unit tile and dynamic shared memory
    (ptxas reports only static shared memory)."""
    out = [ctypes.c_int() for _ in range(3)]
    _library().dlr_moe_dw_config(m, n, int(gather_lhs),
                                 *map(ctypes.byref, out))
    return {"dynamic_smem_bytes": out[0].value,
            "tile": [out[1].value, out[2].value]}


def ffn_kernel_config(tile_m: int) -> Dict[str, int]:
    """The launch of B7's two kernels and B8 dx's second at ``tile_m``:
    dynamic shared memory, threads and blocks an SM, and the output
    columns of a unit (ptxas reports none of these)."""
    out = [ctypes.c_int() for _ in range(4)]
    rc = _library().dlr_moe_ffn_config(tile_m, *map(ctypes.byref, out))
    _raise_on(rc, "grouped_ffn_forward")
    return {"dynamic_smem_bytes": out[0].value, "threads": out[1].value,
            "blocks_per_sm": out[2].value, "tile_n": out[3].value}


def dx_gate_up_kernel_config(tile_m: int) -> Dict[str, int]:
    """The launch of B8 dx's first kernel at ``tile_m`` (one block an
    SM): dynamic shared memory, threads, cluster size, and the columns
    of f a unit (ptxas reports none of these)."""
    out = [ctypes.c_int() for _ in range(4)]
    rc = _library().dlr_moe_dx_gu_config(tile_m, *map(ctypes.byref, out))
    _raise_on(rc, "grouped_ffn_backward_dx")
    return {"dynamic_smem_bytes": out[0].value, "threads": out[1].value,
            "cluster": out[2].value, "f_cols": out[3].value}


def _on_card(name, x, *others) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU ones
    (the plain version); a DTensor or another device raises."""
    from dlrover_tpu_torch.ops import _ext

    _ext.require_local(name, x, *others)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return x.device.type == "cuda"


def _check(name, tile_m, floats=(), ids=(), d=None, f=None):
    """What the kernels take: bf16 operands and int32 ids on one CUDA
    device, contiguous, d and f multiples of 128, tile_m 16 or 128."""
    dev = (floats or ids)[0].device
    for t in tuple(floats) + tuple(ids):
        if t.device != dev:
            raise ValueError(f"{name}: tensor on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for t in floats:
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"{name} takes bfloat16, got {t.dtype} (f32 kernels on the "
                f"card are not ported)"
            )
    for t in ids:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: ids must be int32, got {t.dtype}")
    for label, v in (("d", d), ("f", f)):
        if v is not None and (v % _KERNEL_ALIGN or v < _KERNEL_ALIGN):
            raise ValueError(f"{name}: {label} {v} must be a multiple of "
                             f"{_KERNEL_ALIGN}")
    if tile_m not in _TILES:
        raise ValueError(f"{name}: tile_m {tile_m} not in {_TILES}")


def _check_shapes(name, **operands):
    """Each operand against the shape the kernel reads it at (None: any
    size): a mismatch would read or write past a buffer. The id values
    are the layout builder's to bound."""
    for label, (t, want) in operands.items():
        if t.dim() != len(want) or any(
                w is not None and s != w for s, w in zip(t.shape, want)):
            shown = tuple("*" if w is None else w for w in want)
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"want {shown}")


def _ffn_dims(name, w_gu):
    """(e, d, f) of ``w_gu`` [e, d, 2f]."""
    _check_shapes(name, w_gu=(w_gu, (None, None, None)))
    e, d, two_f = w_gu.shape
    if two_f % 2:
        raise ValueError(f"{name}: w_gu's last dim {two_f} is not 2f")
    return e, d, two_f // 2


def _dims(*values):
    return (ctypes.c_longlong * len(values))(*values)


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            + _library().dlr_moe_error_string(rc).decode()
        )


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def grouped_ffn_forward(x, w_gu, w_down, row_ids, dest_ids, tile_expert,
                        n_out: int, tile_m: int):
    """Kernel B7: ``y [n_out, d]`` in x's dtype, ``y[dest_ids[j]] =
    ffn(x[row_ids[j]])`` under expert ``tile_expert[j // tile_m]``. Two
    launches: gather + gate|up GEMM + silu·mul into a sorted ``a``
    [m_pad, f] scratch, then ``a @ w_down`` scattered. Rows of y that no
    dest id names are left unwritten, as in the reference. CPU tensors
    run the plain version."""
    if not _on_card("grouped_ffn_forward", x, w_gu, w_down, row_ids,
                    dest_ids, tile_expert):
        return _forward_reference(x, w_gu, w_down, row_ids, dest_ids,
                                  tile_expert, n_out, tile_m)
    e, d, f = _ffn_dims("grouped_ffn_forward", w_gu)
    _check("grouped_ffn_forward", tile_m, (x, w_gu, w_down),
           (row_ids, dest_ids, tile_expert), d, f)
    T = tile_expert.numel()
    m_pad = T * tile_m
    _check_shapes("grouped_ffn_forward", x=(x, (None, d)),
                  w_down=(w_down, (e, f, d)), row_ids=(row_ids, (m_pad,)),
                  dest_ids=(dest_ids, (m_pad,)),
                  tile_expert=(tile_expert, (T,)))
    y = torch.empty((n_out, d), dtype=x.dtype, device=x.device)
    a = torch.empty((m_pad, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library().dlr_moe_forward(
            x.data_ptr(), w_gu.data_ptr(), w_down.data_ptr(),
            row_ids.data_ptr(), dest_ids.data_ptr(),
            tile_expert.data_ptr(), a.data_ptr(), y.data_ptr(),
            _dims(x.shape[0], n_out, d, f, T, tile_m, e), _stream(x))
    _raise_on(rc, "grouped_ffn_forward")
    launch_counts["grouped_ffn_forward"] += 1
    return y


def grouped_ffn_backward_dx(x, g, w_gu, w_down, row_ids, dest_ids,
                            tile_expert, tile_m: int):
    """Kernel B8 dx: (``dx_c`` [n_out, d] per copy, ``dh_sorted`` [m_pad,
    2f], ``a_sorted`` [m_pad, f]), all in x's dtype. Two launches: the
    gathered ``x @ w_gu`` and ``dy @ w_down^T`` with the silu-gate
    backward, writing dh and a; then ``dh @ w_gu^T`` scattered. CPU
    tensors run the plain version."""
    if not _on_card("grouped_ffn_backward_dx", x, g, w_gu, w_down, row_ids,
                    dest_ids, tile_expert):
        return _backward_dx_reference(x, g, w_gu, w_down, row_ids, dest_ids,
                                      tile_expert, tile_m)
    out = _backward_dx_kernel(x, g, w_gu, w_down, row_ids, dest_ids,
                              tile_expert, tile_m, 0)
    launch_counts["grouped_ffn_backward_dx"] += 1
    return out


def backward_dx_launch(x, g, w_gu, w_down, row_ids, dest_ids, tile_expert,
                       tile_m: int, which: int, dh=None):
    """One of B8 dx's two CUDA launches alone, for timing them apart (not
    counted in ``launch_counts``): ``which`` 1 writes the sorted a and dh
    (returned as (dh, a)), 2 reads ``dh`` and returns dx_c."""
    if which not in (1, 2):
        raise ValueError(f"which {which} is not 1 or 2")
    if which == 2 and dh is None:
        raise ValueError("the second launch reads dh")
    out = _backward_dx_kernel(x, g, w_gu, w_down, row_ids, dest_ids,
                              tile_expert, tile_m, which, dh)
    return out[1:] if which == 1 else out[0]


def _backward_dx_kernel(x, g, w_gu, w_down, row_ids, dest_ids, tile_expert,
                        tile_m, which, dh=None):
    e, d, f = _ffn_dims("grouped_ffn_backward_dx", w_gu)
    two_f = 2 * f
    _check("grouped_ffn_backward_dx", tile_m,
           (x, g, w_gu, w_down) + (() if dh is None else (dh,)),
           (row_ids, dest_ids, tile_expert), d, f)
    T = tile_expert.numel()
    m_pad = T * tile_m
    _check_shapes("grouped_ffn_backward_dx", x=(x, (None, d)),
                  g=(g, (None, d)), w_down=(w_down, (e, f, d)),
                  row_ids=(row_ids, (m_pad,)), dest_ids=(dest_ids, (m_pad,)),
                  tile_expert=(tile_expert, (T,)))
    n_out = g.shape[0]
    dx_c = torch.empty((n_out, d), dtype=x.dtype, device=x.device)
    if dh is None:
        dh = torch.empty((m_pad, two_f), dtype=x.dtype, device=x.device)
    _check_shapes("grouped_ffn_backward_dx", dh=(dh, (m_pad, two_f)))
    a = torch.empty((m_pad, f), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), g.data_ptr(), w_gu.data_ptr(), w_down.data_ptr(),
            row_ids.data_ptr(), dest_ids.data_ptr(), tile_expert.data_ptr(),
            dx_c.data_ptr(), dh.data_ptr(), a.data_ptr(),
            _dims(x.shape[0], n_out, d, f, T, tile_m, e))
    with torch.cuda.device(x.device):
        if which:
            rc = _library().dlr_moe_backward_dx_launch(*args, which,
                                                       _stream(x))
        else:
            rc = _library().dlr_moe_backward_dx(*args, _stream(x))
    _raise_on(rc, "grouped_ffn_backward_dx")
    return dx_c, dh, a


def _expert_tile_bounds(tile_expert, n_groups):
    """[E + 1] int32: expert e's tiles are ``[b[e], b[e + 1])`` (the
    tiles of one expert are consecutive), found on the device."""
    want = torch.arange(n_groups + 1, dtype=torch.int32,
                        device=tile_expert.device)
    return torch.searchsorted(tile_expert, want).to(torch.int32)


def _dw_kernel(name, lhs, rhs, lhs_ids, rhs_ids, tile_expert, n_groups,
               tile_m):
    """``dw[e] = sum over e's tiles lhs_t^T @ rhs_t`` [E, c_l, c_r] f32,
    lhs or rhs rows gathered by their ids (the other read in slot
    order). The kernel's persistent blocks take tiles of dw from a work
    counter, zeroed here, experts with the most rows first."""
    if (lhs_ids is None) == (rhs_ids is None):
        raise ValueError(f"{name}: exactly one operand is gathered by ids")
    if n_groups > _MAX_GROUPS:
        raise ValueError(f"{name}: {n_groups} experts, the kernel takes at "
                         f"most {_MAX_GROUPS}")
    lhs, rhs = lhs.contiguous(), rhs.contiguous()
    ids = tuple(t for t in (lhs_ids, rhs_ids) if t is not None)
    _check_shapes(name, lhs=(lhs, (None, None)), rhs=(rhs, (None, None)))
    _check(name, tile_m, (lhs, rhs), ids + (tile_expert,),
           lhs.shape[1], rhs.shape[1])
    T = tile_expert.numel()
    m_pad = T * tile_m
    # The gathered operand may have any rows; the other is in slot order.
    _check_shapes(
        name, tile_expert=(tile_expert, (T,)),
        ids=(ids[0], (m_pad,)),
        lhs=(lhs, (None if lhs_ids is not None else m_pad, None)),
        rhs=(rhs, (None if rhs_ids is not None else m_pad, None)))
    bounds = _expert_tile_bounds(tile_expert, n_groups)
    dw = torch.empty((n_groups, lhs.shape[1], rhs.shape[1]),
                     dtype=torch.float32, device=lhs.device)
    work = torch.zeros(1, dtype=torch.int32, device=lhs.device)
    with torch.cuda.device(lhs.device):
        rc = _library().dlr_moe_backward_dw(
            lhs.data_ptr(), rhs.data_ptr(),
            lhs_ids.data_ptr() if lhs_ids is not None else None,
            rhs_ids.data_ptr() if rhs_ids is not None else None,
            bounds.data_ptr(), dw.data_ptr(),
            _dims(lhs.shape[1], rhs.shape[1], m_pad, tile_m, n_groups,
                  lhs.shape[0], rhs.shape[0]),
            work.data_ptr(), _stream(lhs),
        )
    _raise_on(rc, name)
    launch_counts[name] += 1
    return dw


def grouped_ffn_backward_dw_gu(x, dh_sorted, row_ids, tile_expert,
                               n_groups: int, tile_m: int):
    """Kernel B8 dw_gu: ``dw_gu[e] = sum over e's tiles of x[row_ids]^T
    @ dh_sorted`` as [E, d, 2f] f32; an expert without rows gets zeros.
    CPU tensors run the plain version."""
    if not _on_card("grouped_ffn_backward_dw_gu", x, dh_sorted, row_ids,
                    tile_expert):
        return _backward_dw_gu_reference(x, dh_sorted, row_ids, tile_expert,
                                         n_groups, tile_m)
    return _dw_kernel("grouped_ffn_backward_dw_gu", x, dh_sorted, row_ids,
                      None, tile_expert, n_groups, tile_m)


def grouped_ffn_backward_dw_down(a_sorted, g, dest_ids, tile_expert,
                                 n_groups: int, tile_m: int):
    """Kernel B8 dw_down: ``dw_down[e] = sum over e's tiles of
    a_sorted^T @ g[dest_ids]`` as [E, f, d] f32. CPU tensors run the
    plain version."""
    if not _on_card("grouped_ffn_backward_dw_down", a_sorted, g, dest_ids,
                    tile_expert):
        return _backward_dw_down_reference(a_sorted, g, dest_ids,
                                           tile_expert, n_groups, tile_m)
    return _dw_kernel("grouped_ffn_backward_dw_down", a_sorted, g, None,
                      dest_ids, tile_expert, n_groups, tile_m)


# ---------------------------------------------------------------------------
# Custom-backward op
# ---------------------------------------------------------------------------


class _GroupedFFN(torch.autograd.Function):
    """The reference's ``grouped_ffn`` custom VJP. Residuals: x, the
    weights and the three id vectors; h and a are recomputed in the
    backward. ``plain`` runs the kernels' plain versions whatever the
    device (the reference's interpret mode)."""

    @staticmethod
    def forward(ctx, x, w_gu, w_down, row_ids, dest_ids, tile_expert, n_out,
                copies_per_src, tile_m, plain):
        fwd = _forward_reference if plain else grouped_ffn_forward
        y = fwd(x, w_gu, w_down, row_ids, dest_ids, tile_expert, n_out,
                tile_m)
        ctx.save_for_backward(x, w_gu, w_down, row_ids, dest_ids,
                              tile_expert)
        ctx.cfg = (copies_per_src, tile_m, plain)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w_gu, w_down, row_ids, dest_ids, tile_expert = ctx.saved_tensors
        copies_per_src, tile_m, plain = ctx.cfg
        e = w_gu.shape[0]
        g = g.to(x.dtype).contiguous()
        if plain:
            dx_c, dh, a = _backward_dx_reference(
                x, g, w_gu, w_down, row_ids, dest_ids, tile_expert, tile_m)
            dwgu = _backward_dw_gu_reference(x, dh, row_ids, tile_expert, e,
                                             tile_m)
            dwdn = _backward_dw_down_reference(a, g, dest_ids, tile_expert,
                                               e, tile_m)
        else:
            dx_c, dh, a = grouped_ffn_backward_dx(
                x, g, w_gu, w_down, row_ids, dest_ids, tile_expert, tile_m)
            dwgu = grouped_ffn_backward_dw_gu(x, dh, row_ids, tile_expert, e,
                                              tile_m)
            dwdn = grouped_ffn_backward_dw_down(a, g, dest_ids, tile_expert,
                                                e, tile_m)
        # Per-copy dx reduces densely over the k copies of each source
        # row (row_ids == dest_ids // copies): no scatter.
        n_src, d = x.shape
        dx = dx_c.reshape(n_src, copies_per_src, d).float().sum(dim=1)
        return (dx.to(x.dtype), dwgu.to(w_gu.dtype), dwdn.to(w_down.dtype),
                None, None, None, None, None, None, None)


def grouped_ffn(x, w_gu, w_down, row_ids, dest_ids, tile_expert, n_out: int,
                copies_per_src: int, tile_m: int, plain: bool = False):
    """Fused dispatch-FFN over expert-sorted row segments:
    ``y[dest_ids[j]] = ffn(x[row_ids[j]], w_*[tile_expert[j // tile_m]])``
    for every non-padding slot ``j``. ``x`` is ``[n_src, d]`` token-major
    and the result ``[n_out, d]`` copy-major (callers combine the
    ``top_k`` copies densely). Requires ``row_ids[j] == dest_ids[j] //
    copies_per_src``, which lets the backward sum the per-copy dx
    densely. ``plain`` runs the plain versions on any device (the
    reference's ``interpret``)."""
    return _GroupedFFN.apply(
        x.contiguous(), w_gu.contiguous(), w_down.contiguous(), row_ids,
        dest_ids, tile_expert, n_out, copies_per_src, tile_m, plain)
