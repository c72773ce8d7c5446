"""A/B of the weight-gradient kernels B4 dw and B8 dw (dw_gu, dw_down) on
one GPU, the committed designs against the first ones.

    python3 tools/torch_dw_ab.py [--rev e2a199e]
    python3 tools/torch_dw_ab.py --extract-only

The first designs' ``fused_ce.cu`` and ``moe_dispatch.cu`` are read from
git revision ``--rev`` (``git show``) into ``build/dw_ab/<rev>/``
(git-ignored) and built there by nvcc with ``ops/_ext.py``'s flags,
beside the committed libraries. B4 dw keeps its C entry point, so the
wrapper of ``ops/fused_ce.py`` drives either library; the first B8 dw
takes no work counter, so it is called through its own argument list. A
copy of the tree without git history needs the sources extracted first
(``--extract-only`` where the history is, then copy ``build/dw_ab/``
along).

At ``chip_smoke.py``'s shapes (``phase_ce_kernels``: 16384 x 1024 x
32000, ragged 4100 x 32003, masked; ``phase_moe_kernels``: the training
shape, the skewed routing, the decode step), one JSON line per shape:
each kernel's µs for each design (CUDA events, cold L2,
``chip_smoke._time_ms``; in turns first, committed, committed, first),
the library yardstick's µs and the bound, and max |committed - first|
as a share of chip_smoke's ``_ce_ratio`` bound (the order of sums
changed, so the bits may). Then chip_smoke's MoE training gate with the
committed kernels, and the card's name and power limit.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SOURCES = ("fused_ce.cu", "moe_dispatch.cu")
OUT = ROOT / "build" / "dw_ab"


def extract(rev):
    """The first designs' sources at ``rev``, written once under OUT."""
    paths = []
    for name in SOURCES:
        src = OUT / rev / name
        if not src.exists():
            text = subprocess.run(
                ["git", "-C", str(ROOT), "show",
                 f"{rev}:dlrover_tpu_torch/ops/csrc/{name}"],
                capture_output=True, text=True, check=True).stdout
            src.parent.mkdir(parents=True, exist_ok=True)
            src.write_text(text)
        paths.append(src)
    return paths


def _nvcc(src):
    """Builds ``src`` beside itself with ``ops/_ext.py``'s flags; returns
    the library's path and ptxas's lines for its dw kernels."""
    from dlrover_tpu_torch.ops import _ext

    lib_path = src.with_suffix(".so")
    build = subprocess.run(
        [_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", str(lib_path), str(src)],
        capture_output=True, text=True)
    if build.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{build.stdout}"
                         f"{build.stderr}")
    return lib_path, _dw_ptxas(build.stdout + build.stderr)


def committed_ptxas():
    """ptxas's lines for the committed dw kernels (a build of its own
    under OUT: the libraries the wrappers load may predate this
    process)."""
    from dlrover_tpu_torch.ops import _ext

    out = {}
    for name in SOURCES:
        src = OUT / "committed" / name
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text((_ext.CSRC / name).read_text())
        out[name] = _nvcc(src)[1]
    return out


def first_designs(rev):
    """The first designs' libraries (fused_ce, moe_dispatch), built from
    ``extract(rev)``, and nvcc's ptxas lines for their dw kernels."""
    from dlrover_tpu_torch.ops import fused_ce as fc

    libs, ptxas = [], {}
    for src in extract(rev):
        lib_path, ptxas[src.name] = _nvcc(src)
        libs.append(ctypes.CDLL(str(lib_path)))
    ce, moe = libs
    for name in ("dlr_ce_backward_dw", "dlr_ce_error_string"):
        getattr(ce, name).argtypes = getattr(fc._library(), name).argtypes
        getattr(ce, name).restype = getattr(fc._library(), name).restype
    moe.dlr_moe_backward_dw.argtypes = [ctypes.c_void_p] * 8
    moe.dlr_moe_backward_dw.restype = ctypes.c_int
    return ce, moe, ptxas


def _dw_ptxas(log):
    """ptxas's lines for the dw kernels (the line naming the function,
    then its spill and register lines)."""
    out, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            keep = "dw_kernel" in ln
        if keep and ("entry function" in ln or "registers" in ln
                     or "spill" in ln or "C75" in ln):
            out.append(ln.strip())
    return out


def _first_moe_dw(lib, lhs, rhs, lhs_ids, rhs_ids, te, e, tm):
    """The first B8 dw design through its own C argument list."""
    import torch

    from dlrover_tpu_torch.ops import moe_dispatch as md

    m_pad = te.numel() * tm
    bounds = md._expert_tile_bounds(te, e)
    dw = torch.empty((e, lhs.shape[1], rhs.shape[1]), dtype=torch.float32,
                     device=lhs.device)
    rc = lib.dlr_moe_backward_dw(
        lhs.data_ptr(), rhs.data_ptr(),
        lhs_ids.data_ptr() if lhs_ids is not None else None,
        rhs_ids.data_ptr() if rhs_ids is not None else None,
        bounds.data_ptr(), dw.data_ptr(),
        md._dims(lhs.shape[1], rhs.shape[1], m_pad, tm, e, lhs.shape[0],
                 rhs.shape[0]),
        torch.cuda.current_stream(lhs.device).cuda_stream)
    if rc:
        raise RuntimeError(f"first B8 dw design failed: {rc}")
    return dw


def _turns(calls):
    """µs of each arm's call, in turns first, committed, committed,
    first."""
    import chip_smoke as cs

    us = {arm: [] for arm in calls}
    for arm in ("first", "committed", "committed", "first"):
        us[arm].append(cs._time_ms(calls[arm], iters=10) * 1e3)
    return us


def compare_ce(ce_lib):
    import torch

    import chip_smoke as cs
    from dlrover_tpu_torch.ops import fused_ce as fc

    committed = fc._library()
    gen = torch.Generator("cuda").manual_seed(cs.SEED + 4)
    for label, n, d, v, masked in (
            ("ce_ab", cs.CE_N, cs.CE_D, cs.CE_V, False),
            ("ragged", 4100, cs.CE_D, 32003, False),
            ("masked", cs.CE_N, cs.CE_D, cs.CE_V, True)):
        x, w, tgt, wgt = cs._ce_inputs(n, d, v, gen, masked)
        _, logz = fc._xla_forward(x, w, tgt, cs.CE_Z)
        a, b = wgt * (1.0 + 2.0 * cs.CE_Z * logz), wgt

        def call(lib):
            def run():
                fc._lib = lib
                try:
                    return fc.fused_ce_backward_dw(x, w, tgt, logz, a, b)
                finally:
                    fc._lib = committed
            return run

        calls = {"first": call(ce_lib), "committed": call(committed)}
        outs = {arm: fn() for arm, fn in calls.items()}
        torch.cuda.synchronize()
        library = cs._dense_ce_calls(x, w, tgt, a, b)["fused_ce_backward_dw"]
        print(json.dumps({
            "kernel": "fused_ce_backward_dw", "shape": label, "n": n, "d": d,
            "v": v, "us": _turns(calls),
            "library_us": cs._time_ms(library, iters=5) * 1e3,
            "bound_us": cs._ce_bound("fused_ce_backward_dw", n, d, v,
                                     int((wgt > 0).sum()))[0] * 1e3,
            "diff_share_of_bound": cs._ce_ratio(outs["committed"],
                                                outs["first"], 0),
        }), flush=True)
        del x, w, outs, library
        torch.cuda.empty_cache()


def compare_moe(moe_lib):
    import torch

    import chip_smoke as cs
    from dlrover_tpu_torch.ops import moe_dispatch as md

    gen = torch.Generator("cuda").manual_seed(cs.SEED + 7)
    for label, n, routing in (("train", cs.MOE_MICRO * cs.MOE_SEQ, "router"),
                              ("skewed", cs.MOE_MICRO * cs.MOE_SEQ, "skewed"),
                              ("decode", 8, "router")):
        x, w_gu, w_down, dy, ids, tm = cs._moe_kernel_inputs(n, routing, gen)
        ri, di, te = ids
        e, d, two_f = w_gu.shape
        f, m, T = two_f // 2, dy.shape[0], te.shape[0]
        _, dh, a = md._backward_dx_reference(x, dy, w_gu, w_down, ri, di, te,
                                             tm)
        routed = torch.zeros(e, dtype=torch.bool, device="cuda")
        routed[te[(ri.view(-1, tm) >= 0).any(dim=1)].long()] = True
        library = cs._moe_library_calls(x, w_gu, w_down, dy, dh, a, ids, tm)
        arms = {
            "grouped_ffn_backward_dw_gu": {
                "first": lambda: _first_moe_dw(moe_lib, x, dh, ri, None, te,
                                               e, tm),
                "committed": lambda: md.grouped_ffn_backward_dw_gu(
                    x, dh, ri, te, e, tm)},
            "grouped_ffn_backward_dw_down": {
                "first": lambda: _first_moe_dw(moe_lib, a, dy, None, di, te,
                                               e, tm),
                "committed": lambda: md.grouped_ffn_backward_dw_down(
                    a, dy, di, te, e, tm)},
        }
        for name, calls in arms.items():
            outs = {arm: fn() for arm, fn in calls.items()}
            torch.cuda.synchronize()
            print(json.dumps({
                "kernel": name, "shape": label, "m": m, "tile_m": tm,
                "us": _turns(calls),
                "library_us": cs._time_ms(library[name], iters=5) * 1e3,
                "bound_us": cs._moe_bound(name, n, m, T * tm, T, d, f, e,
                                          int(routed.sum()))[0] * 1e3,
                "diff_share_of_bound": cs._ce_ratio(outs["committed"],
                                                    outs["first"], 1),
            }), flush=True)
        del x, w_gu, w_down, dy, dh, a, library, arms
        torch.cuda.empty_cache()


def moe_gate():
    import chip_smoke as cs

    failed, rows = [], []
    check, emit = cs.check, cs.emit
    cs.check = lambda ok, msg: ok or failed.append(msg)
    cs.emit = lambda obj: obj.get("phase") == "moe_train_vs_plain" and (
        rows.append({arm: {key: obj[arm][key] for key in
                           ("loss_rel", "grad_norm_rel", "grads")}
                     for arm in ("kernel", "fault_dw_down")}))
    try:
        cs.phase_moe_train(cs.moe_config())
    finally:
        cs.check, cs.emit = check, emit
    print(json.dumps({"moe_train_vs_plain": rows[0], "gate": cs.TRAIN_GATES,
                      "failed_checks": failed}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rev", default="e2a199e",
                        help="git revision of the first designs")
    parser.add_argument("--extract-only", action="store_true",
                        help="write the first designs' sources and stop")
    parser.add_argument("--no-gate", action="store_true",
                        help="skip the MoE training gate")
    args = parser.parse_args()
    if args.extract_only:
        print(*extract(args.rev))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_dw_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dlrover_tpu_torch.ops import _ext

    _ext.build(SOURCES)
    ce_lib, moe_lib, old_ptxas = first_designs(args.rev)
    print(json.dumps({"ptxas": {"committed": committed_ptxas(),
                                args.rev: old_ptxas}}), flush=True)
    compare_ce(ce_lib)
    compare_moe(moe_lib)
    if not args.no_gate:
        moe_gate()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
