"""A/B of B4 dx and B7 (with B8 dx, whose second launch shares B7's
body) on one GPU, the committed designs against the first ones.

    python3 tools/torch_dx_ffn_ab.py [--rev 293d9a3]
    python3 tools/torch_dx_ffn_ab.py --extract-only

The first designs' ``fused_ce.cu`` and ``moe_dispatch.cu`` are read from
git revision ``--rev`` (``git show``) into ``build/dx_ffn_ab/<rev>/``
(git-ignored) and built there by nvcc with ``ops/_ext.py``'s flags,
beside the committed libraries. The three kernels keep their C entry
points, so the committed wrappers drive either library. A copy of the
tree without git history needs the sources extracted first
(``--extract-only`` where the history is, then copy
``build/dx_ffn_ab/`` along).

At ``chip_smoke.py``'s shapes (``phase_ce_kernels``: 16384 x 1024 x
32000, ragged 4100 x 32003, masked; ``phase_moe_kernels``: the training
shape, the skewed routing, the decode step), one JSON line per kernel
and shape: its µs for each design (CUDA events, cold L2,
``chip_smoke._time_ms``; in turns first, committed, committed, first),
the library yardstick's µs and the bound, and max |committed - first|
as a share of chip_smoke's ``_ce_ratio`` bound (the order of sums
changed, so the bits may). Before them, ptxas's lines for both designs'
kernels and the HGMMA count of each committed kernel's SASS
(``cuobjdump -sass``). Then chip_smoke's MoE training gate with the
committed kernels (``tools/torch_dw_ab.moe_gate``), and the card's name
and power limit.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
SOURCES = ("fused_ce.cu", "moe_dispatch.cu")
OUT = ROOT / "build" / "dx_ffn_ab"
# The kernels compared, by the entry function names ptxas prints.
KERNELS = ("ce_dx_kernel", "moe_gate_up_kernel", "moe_out_kernel",
           "moe_ffn_kernel")


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


def _ptxas(log):
    """ptxas's lines for the compared kernels: the line naming each
    function, then its spill and register lines, and the C75xx notes
    that name one of them (ptxas prints those before the function)."""
    out, keep = [], False
    for ln in log.splitlines():
        named = any(k in ln for k in KERNELS)
        if "Compiling entry function" in ln:
            keep = named
        if ("C75" in ln and named) or (keep and (
                "entry function" in ln or "registers" in ln
                or "spill" in ln)):
            out.append(ln.strip())
    return out


def _hgmma(lib_path):
    """HGMMA instructions per compared kernel in a built library's SASS
    (``cuobjdump -sass``): the kernels that run wgmma show them."""
    from dlrover_tpu_torch.ops import _ext

    cuobjdump = str(Path(_ext._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function : " in ln:
            name = ln.split("Function : ")[1].strip()
            fn = next((name[name.index(k):][:40] for k in KERNELS
                       if k in name), None)
            if fn:
                counts[fn] = 0
        elif fn and "HGMMA" in ln:
            counts[fn] += 1
    return counts


def _nvcc(src):
    """Builds ``src`` beside itself with ``ops/_ext.py``'s flags; returns
    the library's path and ptxas's lines for the compared kernels."""
    from dlrover_tpu_torch.ops import _ext

    lib_path = src.with_suffix(".so")
    build = subprocess.run(
        [_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", str(lib_path), str(src)],
        capture_output=True, text=True)
    if build.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{build.stdout}"
                         f"{build.stderr}")
    return lib_path, _ptxas(build.stdout + build.stderr)


def first_designs(rev):
    """The first designs' libraries (fused_ce, moe_dispatch) with the
    committed wrappers' argument types, and their ptxas lines."""
    from dlrover_tpu_torch.ops import fused_ce as fc
    from dlrover_tpu_torch.ops import moe_dispatch as md

    libs, ptxas = [], {}
    for src in extract(rev):
        lib_path, ptxas[src.name] = _nvcc(src)
        libs.append(ctypes.CDLL(str(lib_path)))
    ce, moe = libs
    for lib, committed, names in (
            (ce, fc._library(), ("dlr_ce_backward_dx", "dlr_ce_error_string")),
            (moe, md._library(), ("dlr_moe_forward", "dlr_moe_backward_dx",
                                  "dlr_moe_error_string"))):
        for name in names:
            getattr(lib, name).argtypes = getattr(committed, name).argtypes
            getattr(lib, name).restype = getattr(committed, name).restype
    return ce, moe, ptxas


def _arms(module, first_lib, fn):
    """fn() through the first design's library and through the
    committed one (the module's ``_lib`` swapped for the call)."""
    committed = module._library()

    def through(lib):
        def run():
            module._lib = lib
            try:
                return fn()
            finally:
                module._lib = committed
        return run

    return {"first": through(first_lib), "committed": through(committed)}


def compare_ce(ce_lib):
    import torch

    import chip_smoke as cs
    import torch_dw_ab
    from dlrover_tpu_torch.ops import fused_ce as fc

    gen = torch.Generator("cuda").manual_seed(cs.SEED + 4)
    for label, n, d, v, masked in (
            ("ce_ab", cs.CE_N, cs.CE_D, cs.CE_V, False),
            ("ragged", 4100, cs.CE_D, 32003, False),
            ("masked", cs.CE_N, cs.CE_D, cs.CE_V, True)):
        x, w, tgt, wgt = cs._ce_inputs(n, d, v, gen, masked)
        _, logz = fc._xla_forward(x, w, tgt, cs.CE_Z)
        a, b = wgt * (1.0 + 2.0 * cs.CE_Z * logz), wgt
        calls = _arms(fc, ce_lib, lambda: fc.fused_ce_backward_dx(
            x, w, tgt, logz, a, b))
        outs = {arm: fn() for arm, fn in calls.items()}
        torch.cuda.synchronize()
        library = cs._dense_ce_calls(x, w, tgt, a, b)["fused_ce_backward_dx"]
        print(json.dumps({
            "kernel": "fused_ce_backward_dx", "shape": label, "n": n, "d": d,
            "v": v, "us": torch_dw_ab._turns(calls),
            "library_us": cs._time_ms(library, iters=5) * 1e3,
            "bound_us": cs._ce_bound("fused_ce_backward_dx", n, d, v,
                                     int((wgt > 0).sum()))[0] * 1e3,
            "diff_share_of_bound": cs._ce_ratio(outs["committed"],
                                                outs["first"], -1),
        }), flush=True)
        del x, w, outs, library
        torch.cuda.empty_cache()


def compare_moe(moe_lib):
    import torch

    import chip_smoke as cs
    import torch_dw_ab
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
            "grouped_ffn_forward": _arms(
                md, moe_lib, lambda: md.grouped_ffn_forward(
                    x, w_gu, w_down, ri, di, te, m, tm)),
            "grouped_ffn_backward_dx": _arms(
                md, moe_lib, lambda: md.grouped_ffn_backward_dx(
                    x, dy, w_gu, w_down, ri, di, te, tm)),
        }
        for name, calls in arms.items():
            outs = {arm: fn() for arm, fn in calls.items()}
            torch.cuda.synchronize()
            pairs = zip(*(o if isinstance(o, tuple) else (o,)
                          for o in (outs["committed"], outs["first"])))
            print(json.dumps({
                "kernel": name, "shape": label, "m": m, "tile_m": tm,
                "us": torch_dw_ab._turns(calls),
                "library_us": cs._time_ms(library[name], iters=5) * 1e3,
                "bound_us": cs._moe_bound(name, n, m, T * tm, T, d, f, e,
                                          int(routed.sum()))[0] * 1e3,
                "diff_share_of_bound": max(cs._ce_ratio(p, q, -1)
                                           for p, q in pairs),
            }), flush=True)
        del x, w_gu, w_down, dy, dh, a, library, arms
        torch.cuda.empty_cache()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rev", default="293d9a3",
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
        print("torch_dx_ffn_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dlrover_tpu_torch.ops import _ext

    _ext.build(SOURCES)
    ce_lib, moe_lib, old_ptxas = first_designs(args.rev)
    committed, hgmma = {}, {}
    for name in SOURCES:
        src = OUT / "committed" / name
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text((_ext.CSRC / name).read_text())
        lib_path, committed[name] = _nvcc(src)
        hgmma[name] = _hgmma(lib_path)
    print(json.dumps({"ptxas": {"committed": committed,
                                args.rev: old_ptxas}}), flush=True)
    print(json.dumps({"sass_hgmma": {"committed": hgmma}}), flush=True)
    compare_ce(ce_lib)
    compare_moe(moe_lib)
    if not args.no_gate:
        import torch_dw_ab

        torch_dw_ab.moe_gate()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
