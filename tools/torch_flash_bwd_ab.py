"""A/B of kernel B2 (flash attention's backward: dq and dk/dv) on one
GPU, the committed design against the first one.

    python3 tools/torch_flash_bwd_ab.py [--rev aed37a9]
    python3 tools/torch_flash_bwd_ab.py --extract-only

The first design's ``flash_attention.cu`` is read from git revision
``--rev`` (``git show``) into ``build/flash_bwd_ab/<rev>/`` (git-ignored)
and built there by nvcc with ``ops/_ext.py``'s flags, beside the
committed library; both export the same C entry points, so the wrappers
of ``ops/flash_attention.py`` drive either. A copy of the tree without
git history needs the source extracted first (``--extract-only`` where
the history is, then copy ``build/flash_bwd_ab/`` along).

At ``chip_smoke.FLASH_SHAPES`` (the inputs of ``phase_flash_kernels``),
one JSON line per shape: dq's and dk/dv's µs for each design (CUDA
events, cold L2, ``chip_smoke._time_ms``; in turns first, committed,
committed, first), SDPA backward's µs (dq, dk and dv in one call),
and whether the two designs' dq, dk and dv are equal bit for bit (lse
and delta from the committed B1, the same for both). Then chip_smoke's
MoE training gate with the committed B2 (B7/B8 against the plain
grouped FFN on one pinned routing, ``chip_smoke.phase_moe_train``): the
loss, grad-norm and gradient gaps and the checks that fail; and the
card's name and power limit.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SOURCE = "dlrover_tpu_torch/ops/csrc/flash_attention.cu"
OUT = ROOT / "build" / "flash_bwd_ab"
ENTRY_POINTS = ("dlr_flash_forward", "dlr_flash_backward_dq",
                "dlr_flash_backward_dkv", "dlr_flash_error_string")


def extract(rev):
    """The first design's source at ``rev``, written once under OUT."""
    src = OUT / rev / "flash_attention.cu"
    if not src.exists():
        text = subprocess.run(
            ["git", "-C", str(ROOT), "show", f"{rev}:{SOURCE}"],
            capture_output=True, text=True, check=True).stdout
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(text)
    return src


def first_design(rev):
    """The first design's library, built from ``extract(rev)`` and
    given the committed library's argument types. Returns (library,
    nvcc's ptxas lines)."""
    from dlrover_tpu_torch.ops import _ext
    from dlrover_tpu_torch.ops import flash_attention as fa

    src = extract(rev)
    lib_path = src.with_suffix(".so")
    build = subprocess.run(
        [_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", str(lib_path), str(src)],
        capture_output=True, text=True)
    if build.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{build.stdout}"
                         f"{build.stderr}")
    committed = fa._library()
    lib = ctypes.CDLL(str(lib_path))
    for name in ENTRY_POINTS:
        getattr(lib, name).argtypes = getattr(committed, name).argtypes
        getattr(lib, name).restype = getattr(committed, name).restype
    ptxas = [ln.strip() for ln in (build.stdout + build.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return lib, ptxas


@contextmanager
def library(lib):
    """The flash wrappers launch ``lib``'s kernels inside the block."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    saved = fa._library()
    fa._lib = lib
    try:
        yield
    finally:
        fa._lib = saved


def compare(old_lib):
    import torch

    import chip_smoke as cs
    from dlrover_tpu_torch.ops import flash_attention as fa

    libs = {"first": old_lib, "committed": fa._library()}
    for label, b, s, h, kh, d, causal, (q, k, v, do) in cs.flash_inputs():
        out, lse = fa.flash_forward(q, k, v, causal)
        delta = fa.flash_backward_delta(do, out)
        calls = {
            "dq": lambda: fa.flash_backward_dq(q, k, v, do, lse, delta,
                                               causal),
            "dkv": lambda: fa.flash_backward_dkv(q, k, v, do, lse, delta,
                                                 causal),
        }
        grads = {}
        for arm, lib in libs.items():
            with library(lib):
                dq = calls["dq"]()
                dk, dv = calls["dkv"]()
                torch.cuda.synchronize()
            grads[arm] = {"dq": dq, "dk": dk, "dv": dv}
        us = {f"{name}_{arm}_us": [] for name in calls
              for arm in ("first", "committed")}
        for arm in ("first", "committed", "committed", "first"):
            with library(libs[arm]):
                for name, call in calls.items():
                    us[f"{name}_{arm}_us"].append(cs._time_ms(call) * 1e3)
        _, sdpa_bwd = cs._sdpa_fwd_bwd(q, k, v, do, causal)
        row = {
            "shape": label, "b": b, "s": s, "h": h, "kh": kh, "d": d,
            "causal": causal, **us,
            "sdpa_backward_us": cs._time_ms(sdpa_bwd) * 1e3,
            "bits_equal": {n: torch.equal(grads["first"][n],
                                          grads["committed"][n])
                           for n in ("dq", "dk", "dv")},
        }
        for name in calls:
            row[f"bound_{name}_us"] = cs._flash_bound(
                {"dq": "flash_backward_dq",
                 "dkv": "flash_backward_dkv"}[name], q, k, causal)[0] * 1e3
        print(json.dumps(row), flush=True)
        del q, k, v, do, out, lse, delta, grads, calls, sdpa_bwd
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
    parser.add_argument("--rev", default="aed37a9",
                        help="git revision of the first design")
    parser.add_argument("--extract-only", action="store_true",
                        help="write the first design's source and stop")
    args = parser.parse_args()
    if args.extract_only:
        print(extract(args.rev))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dlrover_tpu_torch.ops import _ext

    _ext.build(("flash_attention.cu",))
    old_lib, old_ptxas = first_design(args.rev)
    print(json.dumps({"ptxas": {
        "committed": [ln.strip() for ln in
                      _ext.build_logs.get("flash_attention.cu", "")
                      .splitlines() if "registers" in ln or "spill" in ln],
        args.rev: old_ptxas}}), flush=True)
    compare(old_lib)
    moe_gate()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
