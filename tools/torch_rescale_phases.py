"""chip_smoke.py's phases 24 and 25 alone, on one GPU.

    python3 tools/torch_rescale_phases.py [--phases live_rescale,agent_paths]
        [--repeat N]

Builds the kernels (the agent's workers load them from the build
directory), then per repeat runs ``chip_smoke.phase_live_rescale`` (the
live 2 -> 1 -> 2 rescale episode, the workers' state on the card) and
``chip_smoke.phase_agent_paths`` (the launcher's network check, the
agent's warm standby against a cold relaunch), each with its gates and
its JSON line and seconds. A failed gate raises. Then the card's name
and power limit.
"""

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

PHASES = {"live_rescale": cs.phase_live_rescale,
          "agent_paths": cs.phase_agent_paths}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_rescale_phases: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    smi = cs.phase_device()
    cs.phase_build()
    for rep in range(args.repeat):
        for name in args.phases.split(","):
            t0 = time.monotonic()
            PHASES[name]()
            cs.emit({"repeat": rep, "phase": name,
                     "seconds": time.monotonic() - t0})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
