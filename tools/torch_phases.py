"""Some of chip_smoke.py's phases alone, on one GPU.

    python3 tools/torch_phases.py --phases chaos_soak,master_kill
        [--repeat N]

Each name is a ``chip_smoke.phase_<name>`` that needs no argument (the
soak's ``chaos_soak`` and ``master_kill``, the rescale plane's
``live_rescale`` and ``agent_paths``, ``node_check``, ...). Builds the
kernels, then per repeat runs each named phase with its gates and
prints its JSON line and its seconds. A failed gate raises. Then the
card's name and power limit.
"""

import argparse
import inspect
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def phase(name):
    """``chip_smoke.phase_<name>``, if it runs with no argument."""
    fn = getattr(cs, f"phase_{name}", None)
    if fn is None:
        raise SystemExit(f"torch_phases: chip_smoke has no phase {name!r}")
    needs = [p.name for p in inspect.signature(fn).parameters.values()
             if p.default is inspect.Parameter.empty
             and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    if needs:
        raise SystemExit(f"torch_phases: phase {name!r} needs {needs}")
    return fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", required=True,
                    help="comma-separated phase names, in order")
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args(argv)
    phases = [(name, phase(name)) for name in args.phases.split(",")]
    if not torch.cuda.is_available():
        print("torch_phases: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = cs.phase_device()
    cs.phase_build()
    for rep in range(args.repeat):
        for name, fn in phases:
            t0 = time.monotonic()
            fn()
            cs.emit({"repeat": rep, "phase": name,
                     "seconds": time.monotonic() - t0})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
