"""What bounds the weight-gradient kernels B8 dw and B4 dw on one GPU:
each is timed beside variants of its own source that change one part.

    python3 tools/torch_dw_probe.py

Each variant is the committed source with text replacements (listed
below), built by nvcc (one process a variant, all at once) with ``ops/_ext.py``'s flags into
``build/dw_probe/`` (git-ignored) and driven through the committed
wrapper. Variants that drop a part compute wrong sums; only their time
is read. At ``chip_smoke.py``'s training shapes (B8: m = 32768 copies,
d = f = 1024, 8 experts, random routing, tile 128; B4: n = 16384,
d = 1024, V = 32000), one JSON line per variant with its µs (CUDA
events, cold L2, ``chip_smoke._time_ms``), then the card's name and
power limit:

- B8: ``lsu<k>``, k of 8 gathered row segments by cp.async and the rest
  by one-row TMA boxes (the committed split is ``kLsuRows``);
  ``no_gather``, the gathered tile not loaded at all;
- B4: ``no_push`` (no partial crosses the cluster), ``no_freed`` (no
  `freed` handshake either), ``no_exp`` (g without the exponential),
  ``short_s`` (the partial over 32 columns of d, not the block's 512),
  ``no_dw`` (no dw product), and ``skeleton`` (the four of no_push,
  no_freed, short_s and no_dw together: loads, waits and g alone).
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "dw_probe"

_NO_PUSH = [
    ("        if constexpr (kC > 1) {\n          // The copy engine",
     "        if constexpr (false) {\n          // The copy engine"),
    ("          if (kC > 1 && warp == 0)\n            mbar_expect_tx",
     "          if (false)\n            mbar_expect_tx"),
]
_NO_FREED = [
    ("        if (j >= 2) mbar_spin<true>(freed(b), ((j >> 1) - 1) & 1, "
     "live);", ""),
    ("        for (int r = 0; r < kC; ++r) "
     "mbar_arrive_cluster_relaxed(freed(b), r);", "        ;"),
]
_SHORT_S = [
    ("      for (int kk = 0; kk < 2 * kDQ / 16; ++kk)\n        wgmma_tn_n32(",
     "      for (int kk = 0; kk < 2; ++kk)\n        wgmma_tn_n32("),
]
_NO_DW = [
    ("      issue_dw<kDQ>(acc, ga, x_s(st) + c * kQBoxes * kXBox);",
     "      if (j < 0) issue_dw<kDQ>(acc, ga, x_s(st) + c * kQBoxes * kXBox);"),
]
CE_VARIANTS = {
    "no_push": _NO_PUSH,
    "no_freed": _NO_PUSH + _NO_FREED,
    "no_exp": [("          const float pe = expf(logit - sl[kDwR + r]);",
                "          const float pe = logit;")],
    "short_s": _SHORT_S,
    "no_dw": _NO_DW,
    "skeleton": _NO_PUSH + _NO_FREED + _SHORT_S + _NO_DW,
}
MOE_VARIANTS = {
    **{f"lsu{k}": [(re.compile(r"constexpr int kLsuRows = \d;"),
                    f"constexpr int kLsuRows = {k};")]
       for k in range(9)},
    "no_gather": [("        if (has) {\n          if (kGatherLhs)\n"
                   "            gather_stage",
                   "        if (false) {\n          if (kGatherLhs)\n"
                   "            gather_stage"),
                  ("kBytes + gathered_tma_bytes<kGatherLhs ? kTileM : "
                   "kTileN>()", "kBytes")],
}


def build_variants(source, variants, committed, entry_points):
    """Each of ``variants`` applied to ``source`` and built, one nvcc per
    variant, all started together; returns the loaded libraries with
    the committed library's argument types, by name."""
    from dlrover_tpu_torch.ops import _ext

    started = {}
    for name, reps in variants.items():
        text = (_ext.CSRC / source).read_text()
        for old, new in reps:
            if isinstance(old, re.Pattern):
                text, hits = old.subn(new, text)
            else:
                hits = text.count(old)
                text = text.replace(old, new)
            if not hits:
                raise SystemExit(f"{name}: the source no longer holds "
                                 f"{old!r}")
        src = OUT / f"{Path(source).stem}_{name}.cu"
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(text)
        started[name] = (src.with_suffix(".so"), subprocess.Popen(
            [_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", str(src.with_suffix(".so")),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib_path, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        for fn in entry_points:
            getattr(lib, fn).argtypes = getattr(committed, fn).argtypes
            getattr(lib, fn).restype = getattr(committed, fn).restype
        libs[name] = lib
    return libs


def probe_moe():
    import torch

    import chip_smoke as cs
    from dlrover_tpu_torch.ops import moe_dispatch as md

    gen = torch.Generator("cuda").manual_seed(cs.SEED + 7)
    x, w_gu, w_down, dy, ids, tm = cs._moe_kernel_inputs(
        cs.MOE_MICRO * cs.MOE_SEQ, "router", gen)
    ri, di, te = ids
    e = w_gu.shape[0]
    _, dh, a = md._backward_dx_reference(x, dy, w_gu, w_down, ri, di, te, tm)
    committed = md._library()
    libs = {"committed": committed, **build_variants(
        "moe_dispatch.cu", MOE_VARIANTS, committed,
        ("dlr_moe_backward_dw", "dlr_moe_error_string"))}
    for name, lib in libs.items():
        md._lib = lib
        try:
            print(json.dumps({
                "kernel": "B8 dw", "variant": name,
                "dw_gu_us": cs._time_ms(lambda: md.grouped_ffn_backward_dw_gu(
                    x, dh, ri, te, e, tm), iters=10) * 1e3,
                "dw_down_us": cs._time_ms(
                    lambda: md.grouped_ffn_backward_dw_down(
                        a, dy, di, te, e, tm), iters=10) * 1e3,
            }), flush=True)
        finally:
            md._lib = committed


def probe_ce():
    import torch

    import chip_smoke as cs
    from dlrover_tpu_torch.ops import fused_ce as fc

    gen = torch.Generator("cuda").manual_seed(cs.SEED + 4)
    x, w, tgt, wgt = cs._ce_inputs(cs.CE_N, cs.CE_D, cs.CE_V, gen)
    _, logz = fc._xla_forward(x, w, tgt, cs.CE_Z)
    a, b = wgt * (1.0 + 2.0 * cs.CE_Z * logz), wgt
    committed = fc._library()
    libs = {"committed": committed, **build_variants(
        "fused_ce.cu", CE_VARIANTS, committed,
        ("dlr_ce_backward_dw", "dlr_ce_error_string"))}
    for name, lib in libs.items():
        fc._lib = lib
        try:
            print(json.dumps({
                "kernel": "B4 dw", "variant": name,
                "us": cs._time_ms(lambda: fc.fused_ce_backward_dw(
                    x, w, tgt, logz, a, b), iters=5) * 1e3,
            }), flush=True)
        finally:
            fc._lib = committed


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_dw_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from dlrover_tpu_torch.ops import _ext

    _ext.build(("fused_ce.cu", "moe_dispatch.cu"))
    probe_moe()
    probe_ce()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
