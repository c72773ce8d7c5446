"""The migration and fleet phases of ``chip_smoke.py`` alone, on one
GPU, several times in one process.

    python3 tools/torch_fleet_phases.py [--repeat 2]
    python3 tools/torch_fleet_phases.py --phases migrate,disagg,subprocess

Builds the kernels, makes the flagship's weights (seed 0), then per
repeat: the unmigrated paged runs of phase 11's 32 requests (fp over 513
blocks, int8 over 993; ``chip_smoke._run_paged``, with its gates), and
``chip_smoke.phase_migrate`` (11c), ``phase_fleet_disagg`` (11d: thread
replicas, prefill/decode then mixed) and ``phase_fleet_subprocess``
(11e: three worker processes on the card, one killed at its first
import). Each phase prints chip_smoke's JSON rows with its own gates; a
failed gate raises. Then the card's name and power limit.
"""

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

PHASES = ("migrate", "disagg", "subprocess")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("torch_fleet_phases: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    from dlrover_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.phase_device()
    cs.phase_build()
    cfg = llama.flagship_config()
    params = llama.init_params(
        cfg, torch.Generator("cuda").manual_seed(cs.SEED), device="cuda")
    for rep in range(args.repeat):
        cs.emit({"repeat": rep})
        if "migrate" in phases:
            work = cs._paged_workload(cfg)
            unmigrated = {
                kv: cs._run_paged(cfg, params, work, kv, kv, 16, blocks)[1]
                for kv, blocks in (("fp", cs.FP_BLOCKS),
                                   ("int8", cs.INT8_BLOCKS))}
            cs.phase_migrate(cfg, params, unmigrated)
        if "disagg" in phases:
            cs.phase_fleet_disagg(cfg, params)
        if "subprocess" in phases:
            cs.phase_fleet_subprocess(cfg, params)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
