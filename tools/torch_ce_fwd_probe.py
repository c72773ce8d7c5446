"""What bounds B3 (``ce_fwd_kernel``) and B8 dx's first launch
(``moe_dx_gu_kernel``) on one GPU: the committed kernels beside variants
of their own sources that change one part, and B3 under other launch
plans.

    python3 tools/torch_ce_fwd_probe.py

Each variant is the committed source with text replacements (listed
below), built by nvcc (one process a variant, all at once, with
``tools/torch_dw_probe.build_variants``) into ``build/dw_probe/``
(git-ignored) and driven through the committed wrapper. Variants that
drop a part compute wrong values; only their time is read (µs, CUDA
events, cold L2, ``chip_smoke._time_ms``), one JSON line each:

- B3 at ``chip_smoke.py``'s CE shapes (16384 x 1024 x 32000 and the
  ragged 4100 x 32003): the committed plan (``fused_ce.forward_plan``)
  against the plan of the other cluster size that the same cost picks
  (one split of single blocks at 16384; seven splits of pairs at 4100,
  two waves); ``no_exp`` (the row sums without the exponential),
  ``no_mask`` (no NEG_INF select on the columns);
- B8 dx's first launch at the MoE training shape (m = 32768 copies, d =
  f = 1024, 8 experts, tile 128): ``no_store`` (the epilogue's math
  kept, nothing stored), ``no_wgmma``, ``loads_only`` (neither
  products nor stores), ``weights_only``, ``rows_only`` (the gathered
  rows and the pushes between the pair), ``rows_only_no_push`` and
  ``no_gather_no_push``.

Then the card's name and power limit.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

CE_FWD_VARIANTS = {
    "no_exp": [("            rs[e >> 1] += expf(acc[h][nt][e] - m[e >> 1]);",
                "            rs[e >> 1] += acc[h][nt][e] - m[e >> 1];")],
    "no_mask": [("            const float s = o < lim ? acc[h][nt][e] : "
                 "kNegInf;", "            const float s = acc[h][nt][e];")],
}
_NO_PUSH = [
    ("3 * kBox + 2 * (kC - 1) * Cfg::kPart);", "3 * kBox);"),
    ("            if (pending >= 0) push(pending);",
     "            if (false) push(pending);"),
    ("      if (pt == 0 && pending >= 0) push(pending);",
     "      if (false) push(pending);"),
]
_NO_GATHER = [
    ("          xr.copy(x_s(st) + part_row * 128, p.x, p.d, k0, pt);\n", ""),
    ("          dyr.copy(dy_s(st) + part_row * 128, p.dy, p.d, k0, pt);\n",
     ""),
]
_NO_WGMMA = [
    ("          wgmma_ss<1>(h, dxs,", "          if (g < 0) wgmma_ss<1>(h, dxs,"),
    ("          wgmma_ss<0>(da, dys,", "          if (g < 0) wgmma_ss<0>(da, dys,"),
]
# keep is false at run time, but not provably: the epilogue's math stays.
_NO_STORE = [("const bool keep = row < BM;\n        const long long slot = keep",
              "const bool keep = row < -p.n_src;\n"
              "        const long long slot = keep")]
_WEIGHTS = [
    "            tma_load_2d(wgu_s(st), &map_wgu, full(st), c0, e * p.d + k0);\n",
    "            tma_load_2d(wgu_s(st) + kBox, &map_wgu, full(st), p.f + c0,\n"
    "                        e * p.d + k0);\n",
    "            tma_load_2d(wdn_s(st), &map_wdn, full(st), k0, e * p.f + c0);\n",
]
_NO_WEIGHTS = [("3 * kBox + 2 * (kC - 1) * Cfg::kPart);",
                "2 * (kC - 1) * Cfg::kPart);")] + [(w, "") for w in _WEIGHTS]
DX_GU_VARIANTS = {
    "no_store": _NO_STORE,
    "no_wgmma": _NO_WGMMA,
    "loads_only": _NO_WGMMA + _NO_STORE,
    "weights_only": _NO_WGMMA + _NO_STORE + _NO_GATHER + _NO_PUSH,
    "rows_only": _NO_WGMMA + _NO_STORE + _NO_WEIGHTS,
    "rows_only_no_push": _NO_WGMMA + _NO_STORE + [
        ("3 * kBox + 2 * (kC - 1) * Cfg::kPart);", "0);")] + _NO_PUSH[1:]
        + [(w, "") for w in _WEIGHTS],
    "no_gather_no_push": _NO_GATHER + _NO_PUSH,
}


def probe_ce_fwd():
    import torch

    import chip_smoke as cs
    import torch_dw_probe
    from dlrover_tpu_torch.ops import fused_ce as fc

    committed = fc._library()
    libs = {"committed": committed, **torch_dw_probe.build_variants(
        "fused_ce.cu", CE_FWD_VARIANTS, committed,
        ("dlr_ce_forward", "dlr_ce_error_string"))}
    plan = fc.forward_plan
    gen = torch.Generator("cuda").manual_seed(cs.SEED + 4)
    # (n, V, the other cluster size's plan: splits, cluster)
    for n, v, other in ((cs.CE_N, cs.CE_V, (1, 1)), (4100, 32003, (7, 2))):
        x, w, tgt, _ = cs._ce_inputs(n, cs.CE_D, v, gen)
        runs = [(name, lib, None) for name, lib in libs.items()]
        runs += [(f"plan_cluster{other[1]}", committed, other)]
        for name, lib, forced in runs:
            fc._lib = lib
            if forced is not None:
                fc.forward_plan = lambda *_, f=forced: f
            try:
                print(json.dumps({
                    "kernel": "B3", "variant": name, "n": n, "v": v,
                    "plan": fc.forward_plan(n, v, fc._sm_count(x.device)),
                    "us": cs._time_ms(lambda: fc.fused_ce_forward(
                        x, w, tgt, cs.CE_Z), iters=10) * 1e3,
                }), flush=True)
            finally:
                fc._lib = committed
                fc.forward_plan = plan
        del x, w
        torch.cuda.empty_cache()


def probe_dx_gu():
    import torch

    import chip_smoke as cs
    import torch_dw_probe
    from dlrover_tpu_torch.ops import moe_dispatch as md

    committed = md._library()
    libs = {"committed": committed, **torch_dw_probe.build_variants(
        "moe_dispatch.cu", DX_GU_VARIANTS, committed,
        ("dlr_moe_backward_dx_launch", "dlr_moe_error_string"))}
    gen = torch.Generator("cuda").manual_seed(cs.SEED + 7)
    x, w_gu, w_down, dy, (ri, di, te), tm = cs._moe_kernel_inputs(
        cs.MOE_MICRO * cs.MOE_SEQ, "router", gen)
    for name, lib in libs.items():
        md._lib = lib
        try:
            print(json.dumps({
                "kernel": "B8 dx, launch 1", "variant": name,
                "us": cs._time_ms(lambda: md.backward_dx_launch(
                    x, dy, w_gu, w_down, ri, di, te, tm, 1), iters=10) * 1e3,
            }), flush=True)
        finally:
            md._lib = committed


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_ce_fwd_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from dlrover_tpu_torch.ops import _ext

    _ext.build(("fused_ce.cu", "moe_dispatch.cu"))
    probe_ce_fwd()
    probe_dx_gu()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
