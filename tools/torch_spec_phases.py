"""The speculative-decoding and paged-MoE phases of ``chip_smoke.py``
alone, on one GPU, several times in one process.

    python3 tools/torch_spec_phases.py [--repeat 2]

Builds the kernels, then per repeat: the flat engine phase (phase 5:
16 requests on the flagship, 8 slots) whose output makes the prompts
``p + greedy(p) + p``, ``chip_smoke.phase_spec_engine`` (flat: spec off,
n-gram, early exit) and ``phase_paged_spec_engine`` (paged fp: off,
n-gram, early exit; int8: off, n-gram); then the MoE engine phase and
``phase_moe_paged_engine`` (``moe_config``, paged fp: off, n-gram). Each
run prints chip_smoke's JSON row with its own gates (completion, the
teacher-forced gap, block conservation, more than one token a verify
step, exact launches); a failed gate raises. Repeats in one process
show how far the host-bound tokens/s move from run to run on one card.
Then the card's name and power limit. Takes ~2 min a repeat.
"""

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_spec_phases: torch sees no CUDA device", file=sys.stderr)
        return 1
    from dlrover_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.phase_device()
    cs.phase_build()
    for name, make in (("flagship", cs.flagship_config),
                       ("moe", cs.moe_config)):
        cfg = make()
        params = llama.init_params(
            cfg, torch.Generator("cuda").manual_seed(cs.SEED), device="cuda")
        for rep in range(args.repeat):
            cs.emit({"repeat": rep, "model": name})
            if name == "flagship":
                _, served = cs.phase_engine(cfg, params)
                cs.phase_spec_engine(cfg, params, served)
                cs.phase_paged_spec_engine(cfg, params, served)
            else:
                _, served = cs.phase_engine(cfg, params, phase="moe_engine",
                                            gated=False)
                cs.phase_moe_paged_engine(cfg, params, served)
        del params
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
