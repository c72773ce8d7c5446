"""The elastic checkpoint phase of ``chip_smoke.py`` alone, on one GPU.

    python3 tools/torch_elastic_phase.py [--repeat 2]

Builds the kernels (the worker processes load them from the build
directory), then per repeat runs ``chip_smoke.phase_elastic_ckpt``: the
port's elastic worker on the flagship under the port's launcher, master
and agent (``python -m dlrover_tpu_torch.run --standalone``), trained
uninterrupted (run A) and killed twice and restarted by the agent, from
memory and from storage (run B), with its gates. A failed gate raises. Then the card's name and power limit.
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
        print("torch_elastic_phase: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    smi = cs.phase_device()
    cs.phase_build()
    for rep in range(args.repeat):
        cs.emit({"repeat": rep})
        cs.phase_elastic_ckpt()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
