"""The mesh phases of ``chip_smoke.py`` alone, on one GPU.

    python3 tools/torch_mesh_phases.py [--phases mesh_train,reshard,node_check]

Builds the kernels, then runs ``chip_smoke.phase_mesh_train`` (the
flagship's sharded train step on a world of one over nccl against the
mesh-less step, bitwise, with exact B1/B2 launches),
``phase_reshard_restore`` (the card's train state through a 4-process
gloo CPU world at dp=2, tp=2 and back, bitwise, and a planted fault)
and ``phase_node_check`` (the node check worker on the card, and its
fail variable). A failed gate raises. Then the card's name and power
limit.

    python3 tools/torch_mesh_phases.py --reshard-rank CARD_DIR STEP \\
        OWN_DIR OUT_JSON CONFIG

is one rank of the reshard phase's CPU world (the phase starts them).
"""

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--reshard-rank":
        card_dir, step, own_dir, out, config = sys.argv[2:7]
        return cs.reshard_rank_main(card_dir, int(step), own_dir, out, config)
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="mesh_train,reshard,node_check")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("torch_mesh_phases: torch sees no CUDA device", file=sys.stderr)
        return 1
    from dlrover_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.phase_device()
    cs.phase_build()
    cfg = llama.flagship_config()
    if phases & {"mesh_train", "reshard"}:
        state, _ = cs.timed("mesh_train", cs.phase_mesh_train, cfg)
        if "reshard" in phases:
            cs.timed("reshard_restore", cs.phase_reshard_restore, cfg, state)
        del state
        torch.cuda.empty_cache()
    if "node_check" in phases:
        cs.timed("node_check", cs.phase_node_check)
    cs.emit({"phase": "seconds", **cs.PHASE_SECONDS})
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
