"""A/B of B3 (the fused-CE forward) and B8 dx (with its first launch
apart) on one GPU, the committed designs against the first ones.

    python3 tools/torch_ce_fwd_ab.py [--rev 3b0fbdd]
    python3 tools/torch_ce_fwd_ab.py --extract-only

The first designs' ``fused_ce.cu`` and ``moe_dispatch.cu`` are read from
git revision ``--rev`` (``git show``) into ``build/ce_fwd_ab/<rev>/``
(git-ignored) and built there by nvcc with ``ops/_ext.py``'s flags,
beside the committed libraries. Both kernels keep their C entry points,
so the committed wrappers drive either library (the first B3 reads the
first four of the wrapper's dims and ignores its launch plan); the first
``moe_dispatch.cu`` gets a ``dlr_moe_backward_dx_launch`` appended that
runs one of its two launches, as the committed one does. A copy of the
tree without git history needs the sources extracted first
(``--extract-only`` where the history is, then copy
``build/ce_fwd_ab/`` along).

At ``chip_smoke.py``'s shapes (``phase_ce_kernels``: 16384 x 1024 x
32000, ragged 4100 x 32003, masked; ``phase_moe_kernels``: the training
shape, the skewed routing, the decode step), one JSON line per kernel
and shape: its µs for each design (CUDA events, cold L2,
``chip_smoke._time_ms``; in turns first, committed, committed, first),
the library yardstick's µs and the bound, and max |committed - first|
as a share of chip_smoke's bound (``_stat_ratio`` for B3's per_tok and
logz, ``_ce_ratio`` for B8 dx's outputs). Before them, ptxas's lines
for both designs' kernels. Then chip_smoke's MoE training gate with the
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
OUT = ROOT / "build" / "ce_fwd_ab"
# The kernels compared, by the entry function names ptxas prints.
KERNELS = ("ce_fwd_kernel", "moe_dx_gate_up_kernel", "moe_dx_gu_kernel")
# One of the first design's two B8 dx launches alone, with the committed
# entry point's arguments (appended to its moe_dispatch.cu).
_DX_LAUNCH = """
namespace {
template <int BM>
int dx_launch_ab(const Params& p, int which, cudaStream_t s) {
  if (which == 1)
    return launch(moe_dx_gate_up_kernel<BM>, dim3(p.f / kBF, p.T),
                  dx_gate_up_smem<BM>(), p, s);
  return launch_ffn<BM, kFfnDownNK>(p, s);
}
}  // namespace

extern "C" int dlr_moe_backward_dx_launch(
    const void* x, const void* dy, const void* w_gu, const void* w_down,
    const void* row_ids, const void* dest_ids, const void* tile_expert,
    void* dx_c, void* dh, void* a, const long long* dims, int which,
    void* stream) {
  Params p = {};
  int rc = fill(&p, dims);
  if (rc) return rc;
  p.x = static_cast<const bf16*>(x);
  p.dy = static_cast<const bf16*>(dy);
  p.w_gu = static_cast<const bf16*>(w_gu);
  p.w_down = static_cast<const bf16*>(w_down);
  p.row_ids = static_cast<const int*>(row_ids);
  p.dest_ids = static_cast<const int*>(dest_ids);
  p.tile_expert = static_cast<const int*>(tile_expert);
  p.out = static_cast<bf16*>(dx_c);
  p.dh = static_cast<bf16*>(dh);
  p.a = static_cast<bf16*>(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.tile_m == 128 ? dx_launch_ab<128>(p, which, s)
                         : dx_launch_ab<16>(p, which, s);
}
"""


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
            if name == "moe_dispatch.cu":
                text += _DX_LAUNCH
            src.parent.mkdir(parents=True, exist_ok=True)
            src.write_text(text)
        paths.append(src)
    return paths


def _ptxas(log):
    """ptxas's lines for the compared kernels: the line naming each
    function, then its spill and register lines, and the C75xx notes
    that name one of them."""
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
            (ce, fc._library(), ("dlr_ce_forward", "dlr_ce_error_string")),
            (moe, md._library(), ("dlr_moe_backward_dx",
                                  "dlr_moe_backward_dx_launch",
                                  "dlr_moe_error_string"))):
        for name in names:
            getattr(lib, name).argtypes = getattr(committed, name).argtypes
            getattr(lib, name).restype = getattr(committed, name).restype
    return ce, moe, ptxas


def compare_ce(ce_lib):
    import torch

    import chip_smoke as cs
    import torch_dw_ab
    import torch_dx_ffn_ab
    from dlrover_tpu_torch.ops import fused_ce as fc

    gen = torch.Generator("cuda").manual_seed(cs.SEED + 4)
    for label, n, d, v, masked in (
            ("ce_ab", cs.CE_N, cs.CE_D, cs.CE_V, False),
            ("ragged", 4100, cs.CE_D, 32003, False),
            ("masked", cs.CE_N, cs.CE_D, cs.CE_V, True)):
        x, w, tgt, _ = cs._ce_inputs(n, d, v, gen, masked)
        calls = torch_dx_ffn_ab._arms(
            fc, ce_lib, lambda: fc.fused_ce_forward(x, w, tgt, cs.CE_Z))
        outs = {arm: fn() for arm, fn in calls.items()}
        torch.cuda.synchronize()
        library = cs._dense_ce_calls(x, w, tgt, None, None)[
            "fused_ce_forward"]
        print(json.dumps({
            "kernel": "fused_ce_forward", "shape": label, "n": n, "d": d,
            "v": v, "plan": fc.forward_plan(n, v, fc._sm_count(x.device)),
            "us": torch_dw_ab._turns(calls),
            "library_us": cs._time_ms(library, iters=5) * 1e3,
            "bound_us": cs._ce_bound("fused_ce_forward", n, d, v, n)[0] * 1e3,
            "diff_share_of_bound": max(
                cs._stat_ratio(p, q)
                for p, q in zip(outs["committed"], outs["first"])),
        }), flush=True)
        del x, w, outs, library
        torch.cuda.empty_cache()


def compare_moe(moe_lib):
    import torch

    import chip_smoke as cs
    import torch_dw_ab
    import torch_dx_ffn_ab
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
            "grouped_ffn_backward_dx": torch_dx_ffn_ab._arms(
                md, moe_lib, lambda: md.grouped_ffn_backward_dx(
                    x, dy, w_gu, w_down, ri, di, te, tm)),
            "grouped_ffn_backward_dx_first": torch_dx_ffn_ab._arms(
                md, moe_lib, lambda: md.backward_dx_launch(
                    x, dy, w_gu, w_down, ri, di, te, tm, 1)),
        }
        for name, calls in arms.items():
            outs = {arm: fn() for arm, fn in calls.items()}
            torch.cuda.synchronize()
            pairs = zip(outs["committed"], outs["first"])
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
    parser.add_argument("--rev", default="3b0fbdd",
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
        print("torch_ce_fwd_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dlrover_tpu_torch.ops import _ext

    _ext.build(SOURCES)
    ce_lib, moe_lib, old_ptxas = first_designs(args.rev)
    committed = {}
    for name in SOURCES:  # a copy, for ptxas's lines
        src = OUT / "committed" / name
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text((_ext.CSRC / name).read_text())
        committed[name] = _nvcc(src)[1]
    print(json.dumps({"ptxas": {"committed": committed,
                                args.rev: old_ptxas}}), flush=True)
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
