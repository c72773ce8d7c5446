"""What bounds B4 dx (``ce_dx_kernel``) on one GPU: the committed
kernel beside variants of its own source that change one part.

    python3 tools/torch_dx_ffn_probe.py

Each variant is the committed ``fused_ce.cu`` with text replacements
(listed below), built by nvcc (one process a variant, all at once, with
``tools/torch_dw_probe.build_variants``) into ``build/dw_probe/``
(git-ignored) and driven through the committed wrapper. Variants that
drop a part compute wrong sums; only their time is read. At
``chip_smoke.py``'s CE shape (n = 16384, d = 1024, V = 32000: clusters
of 4), one JSON line per variant with its µs (CUDA events, cold L2,
``chip_smoke._time_ms``); then some of them at V = 16000 (w fits in
L2), the committed kernel at d = 512 and 256 (clusters of 2 and 1),
and the card's name and power limit:

- ``ex2``: g's exponential by ex2.approx (x log2 e), not expf;
  ``no_exp``: without the exponential;
- ``offset``: warpgroup 1 starts once warpgroup 0 has pushed its first
  partial, so the two run half a step apart;
- ``l2_prefetch4``: the producer asks w's tile j + 4 into L2
  (``cp.async.bulk.prefetch.tensor``) as it loads tile j;
- ``no_exchange``: nothing pushed and nothing waited for between the
  blocks: every warp pair sums its own block's slots (racy sums);
- ``no_dx``: no dx product; ``short_s``: the partial over 16 columns of
  d, not the block's slice;
- ``skeleton``: no_exchange, no_dx and short_s together: the loads,
  the ring's waits and g alone.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

_NO_EXCHANGE = [
    ("    const bool owned = owner == rank;", "    const bool owned = true;"),
    ("        if constexpr (kC > 1) {\n          if (warp % 2 == 0 && lane == 0)"
     "\n            mbar_expect_tx(pready(oi)",
     "        if constexpr (false) {\n          if (warp % 2 == 0 && lane == 0)"
     "\n            mbar_expect_tx(pready(oi)"),
    ("        if constexpr (kC > 1)\n          if (j >= 1) mbar_spin<true>("
     "gfreed(oi)",
     "        if constexpr (false)\n          if (j >= 1) mbar_spin<true>("
     "gfreed(oi)"),
    ("          if constexpr (kC > 1)\n            for (int r = 0; r < kC; ++r)"
     "\n              if (r != rank) st_async_u4",
     "          if constexpr (false)\n            for (int r = 0; r < kC; ++r)"
     "\n              if (r != rank) st_async_u4"),
    ("        if constexpr (kC > 1) {\n          // The senders may refill",
     "        if constexpr (false) {\n          // The senders may refill"),
]
_NO_DX = [("          wgmma_rs_kmaj_n128(\n",
           "          if (j < 0) wgmma_rs_kmaj_n128(\n")]
_SHORT_S = [("        for (int kk = 0; kk < kDS / 16; ++kk)\n"
             "          wgmma_kn_n64(",
             "        for (int kk = 0; kk < 1; ++kk)\n"
             "          wgmma_kn_n64(")]
_PRODUCER_LOAD = ("        mbar_expect_tx(full(st), Cfg::kWBytes);\n"
                  "        for (int bx = 0; bx < kBoxes; ++bx)\n"
                  "          tma_load_2d(w_s(st) + bx * kWBox, &map_w, full(st),"
                  " j * kDxVt,\n")


def _l2_prefetch(ahead):
    """w's tile j + ahead asked into L2 as tile j is loaded."""
    return [(_PRODUCER_LOAD,
             "        if (j + %d < n_vt)\n"
             "          for (int bx = 0; bx < kBoxes; ++bx)\n"
             "            asm volatile(\"cp.async.bulk.prefetch.tensor.2d.L2"
             ".global.tile [%%0, {%%1, %%2}];\" :: \"l\"(reinterpret_cast"
             "<uint64_t>(&map_w)), \"r\"((j + %d) * kDxVt), \"r\"(d0 + 64 "
             "* bx) : \"memory\");\n" % (ahead, ahead) + _PRODUCER_LOAD)]


# Warpgroup 1 starts once warpgroup 0 has pushed its first partial
# (named barrier 1), so the two run half a step apart.
_OFFSET = [
    ("    mbar_spin<false>(x_full, 0, live);\n    issue_s(0);",
     "    mbar_spin<false>(x_full, 0, live);\n"
     "    if (c == 1) asm volatile(\"bar.sync 1, 256;\" ::: \"memory\");\n"
     "    issue_s(0);"),
    ("        put_partial(pslot(rank) + nt * 1024, owner, owned, s[nt], "
     "pready(oi));",
     "        put_partial(pslot(rank) + nt * 1024, owner, owned, s[nt], "
     "pready(oi));\n"
     "      if (c == 0 && j == 0) asm volatile(\"bar.arrive 1, 256;\" ::: "
     "\"memory\");"),
]
_EXPF = "              gv[e] = __fsub_rn(__fmul_rn(ca[h], expf(logit - lz[h])),"
_EX2 = [(_EXPF, _EXPF.replace(
    "expf(logit - lz[h])",
    "[&] { float r; asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(r) : "
    "\"f\"((logit - lz[h]) * 1.4426950408889634f)); return r; }()"))]
_NO_EXP = [(_EXPF, _EXPF.replace("expf(logit - lz[h])", "(logit - lz[h])"))]
CE_DX_VARIANTS = {
    "ex2": _EX2,
    "no_exp": _NO_EXP,
    "offset": _OFFSET,
    "l2_prefetch4": _l2_prefetch(4),
    "no_exchange": _NO_EXCHANGE,
    "no_dx": _NO_DX,
    "short_s": _SHORT_S,
    "skeleton": _NO_EXCHANGE + _NO_DX + _SHORT_S,
}


def probe_ce_dx(variants):
    import torch

    import chip_smoke as cs
    import torch_dw_probe
    from dlrover_tpu_torch.ops import fused_ce as fc

    committed = fc._library()
    libs = {"committed": committed, **torch_dw_probe.build_variants(
        "fused_ce.cu", variants, committed,
        ("dlr_ce_backward_dx", "dlr_ce_error_string"))}
    gen = torch.Generator("cuda").manual_seed(cs.SEED + 4)
    for d, v, names in ((cs.CE_D, cs.CE_V, None),
                        (cs.CE_D, cs.CE_V // 2,
                         ("committed", "no_exchange", "skeleton")),
                        (512, cs.CE_V, ("committed",)),
                        (256, cs.CE_V, ("committed",))):
        x, w, tgt, wgt = cs._ce_inputs(cs.CE_N, d, v, gen)
        _, logz = fc._xla_forward(x, w, tgt, cs.CE_Z)
        a, b = wgt * (1.0 + 2.0 * cs.CE_Z * logz), wgt
        for name, lib in libs.items():
            if names is not None and name not in names:
                continue
            fc._lib = lib
            try:
                print(json.dumps({
                    "kernel": "B4 dx", "variant": name, "d": d, "v": v,
                    "cluster": fc.dx_kernel_config(d)["cluster"],
                    "us": cs._time_ms(lambda: fc.fused_ce_backward_dx(
                        x, w, tgt, logz, a, b), iters=5) * 1e3,
                }), flush=True)
            finally:
                fc._lib = committed
        del x, w
        torch.cuda.empty_cache()


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_dx_ffn_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from dlrover_tpu_torch.ops import _ext

    _ext.build(("fused_ce.cu",))
    probe_ce_dx(CE_DX_VARIANTS)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
