"""A/B of the exponent in kernel B1's softmax, on one GPU.

    python3 tools/torch_flash_exp_ab.py

B1 (``dlrover_tpu_torch/ops/csrc/flash_attention.cu``) computes
x = s scale and p = expf(x - m), the first design's arithmetic, so it
gives that design's bits ("expf"). Two more arms patch the same source:
"ex2_approx", p = ex2.approx(log2(e) (x - m)); and "ex2_fma", the max
taken over the raw logits s and p = ex2.approx(fma(s, c, -m c)) with
c = scale log2(e), one FFMA and one MUFU an element. For each arm, in a
copy of the port under ``build/exp_ab/`` (git-ignored), one JSON line:
B1's time at the training shape (b=8, s=2048, h=kh=8, d=128, causal)
beside SDPA forward (CUDA events, cold L2, ``chip_smoke._time_ms``),
whether its out and lse equal the committed kernel's bit for bit, and
chip_smoke's MoE training gate (B7/B8 against the plain grouped FFN on one pinned
routing, ``chip_smoke.phase_moe_train``): the grad-norm, loss and
gradient gaps and the checks that fail.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "exp_ab"
SOFTMAX_EXP = (
    ("corr[r] = expf(m[r] - mt[r]);",
     "corr[r] = ex2_approx(1.4426950408889634f * (m[r] - mt[r]));"),
    ("const float pe = expf(s[nt][e] - m[e >> 1]);",
     "const float pe = ex2_approx(1.4426950408889634f * "
     "(s[nt][e] - m[e >> 1]));"),
    ("// Named barrier `id` over the 256 consumer threads",
     "__device__ __forceinline__ float ex2_approx(float x) {\n"
     "  float y;\n"
     "  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));\n"
     "  return y;\n"
     "}\n\n"
     "// Named barrier `id` over the 256 consumer threads"),
)

SL2 = "(p.scale * 1.4426950408889634f)"
SOFTMAX_FMA = (
    ("          float x = s[nt][e] * p.scale;\n",
     "          float x = s[nt][e];\n"),
    ("corr[r] = expf(m[r] - mt[r]);",
     f"corr[r] = ex2_approx({SL2} * (m[r] - mt[r]));"),
    ("const float pe = expf(s[nt][e] - m[e >> 1]);",
     f"const float pe = ex2_approx(fmaf(s[nt][e], {SL2}, "
     f"-m[e >> 1] * {SL2}));"),
    ("lse[row] = m[r] + logf(div[r]);",
     "lse[row] = m[r] * p.scale + logf(div[r]);"),
    SOFTMAX_EXP[2],
)

ARM = r'''
import json, sys, torch
import chip_smoke as cs
from dlrover_tpu_torch.ops import _ext, flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False
_ext.build()
b, s, h, d = 8, 2048, 8, 128
g = torch.Generator("cuda").manual_seed(cs.SEED + 3)
q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda").bfloat16()
               for _ in range(4))
out, lse = fa.flash_forward(q, k, v, True)
torch.save({"out": out.cpu(), "lse": lse.cpu()}, sys.argv[1])
sdpa, _ = cs._sdpa_fwd_bwd(q, k, v, do, True)
times = {name: [cs._time_ms(fn) * 1e3 for _ in range(2)] for name, fn in
         (("b1_us", lambda: fa.flash_forward(q, k, v, True)),
          ("sdpa_us", sdpa))}
del q, k, v, do, out, lse
torch.cuda.empty_cache()
failed, rows = [], []
cs.check = lambda ok, msg: ok or failed.append(msg)
cs.emit = lambda obj: obj.get("phase") == "moe_train_vs_plain" and rows.append(
    {arm: {key: obj[arm][key] for key in ("loss_rel", "grad_norm_rel", "grads")}
     for arm in ("kernel", "fault_dw_down")})
cs.phase_moe_train(cs.moe_config())
print(json.dumps({**times, "moe_train_vs_plain": rows[0],
                  "gate": cs.TRAIN_GATES, "failed_checks": failed}))
'''


def _arm(name, edits):
    tree = OUT / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "dlrover_tpu_torch", tree / "dlrover_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", tree / "chip_smoke.py")
    src = tree / "dlrover_tpu_torch" / "ops" / "csrc" / "flash_attention.cu"
    text = src.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: the kernel source no longer has {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    bits = tree / "b1.pt"
    run = subprocess.run(
        [sys.executable, "-c", ARM, str(bits)], cwd=tree, text=True,
        capture_output=True, env={**os.environ, "PYTHONPATH": str(tree)})
    if run.returncode:
        raise SystemExit(f"{name} failed:\n{run.stdout[-2000:]}"
                         f"{run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1]), bits


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_exp_ab: no CUDA device", file=sys.stderr)
        return 1
    arms = {"expf": (), "ex2_approx": SOFTMAX_EXP, "ex2_fma": SOFTMAX_FMA}
    results, bits = {}, {}
    for name, edits in arms.items():
        results[name], bits[name] = _arm(name, edits)
    base = torch.load(bits["expf"])
    for name in arms:
        other = torch.load(bits[name])
        results[name]["bits_equal_committed"] = all(
            torch.equal(base[key], other[key]) for key in ("out", "lse"))
        print(json.dumps({"arm": name, **results[name]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
