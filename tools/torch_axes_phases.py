"""The phases of ``chip_smoke.py`` for the mesh's last axes, alone, on one
GPU.

    python3 tools/torch_axes_phases.py \\
        [--phases long_context,pipeline_train,ring_hops,moe_ep_body] \\
        [--record]

Builds the kernels, then runs ``chip_smoke.phase_long_context`` (the
flagship at 32768 and 65536 tokens through the lite attention block
against the escape), ``phase_pipeline_train`` (the flagship at 4
pipeline stages against the flat step), ``phase_ring_hops`` (ring
attention's hop loops at sp = 4 through the one-process runner) and
``phase_moe_ep_body`` (the ep expert body of one rank of ep = 4), and
``phase_elastic_ckpt`` when ``elastic_ckpt`` is named. A failed gate
raises, or with ``--record`` is printed and counted (exit 1 at the end),
so one run reads every gate. Then the phases' seconds and the card's
name and power limit.

    python3 tools/torch_axes_phases.py --nccl-two-ranks

checks whether NCCL lets two processes on the one card join one world
and all-reduce (whether a world of two ranks can run on this machine's
one card): prints each rank's exit code and the end of its output and
errors, each rank killed after 120 s.
"""

import argparse
import socket
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

PHASES = {
    "long_context": cs.phase_long_context,
    "pipeline_train": cs.phase_pipeline_train,
    "ring_hops": cs.phase_ring_hops,
    "moe_ep_body": cs.phase_moe_ep_body,
    "elastic_ckpt": cs.phase_elastic_ckpt,
}


_RANK = r"""
import sys, torch, torch.distributed as dist
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="tcp://127.0.0.1:" + sys.argv[2],
                        world_size=2, rank=int(sys.argv[1]))
x = torch.ones(4, device="cuda")
dist.all_reduce(x)
torch.cuda.synchronize()
print("all_reduce sum", float(x[0]), flush=True)
dist.destroy_process_group()
"""


def nccl_two_ranks():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r),
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    rows = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        rows.append({"rc": p.returncode, "stdout": out.strip()[-300:],
                     "stderr": err.strip()[-1500:]})
    cs.emit({"phase": "nccl_two_ranks_one_card", "ranks": rows})
    return 0


def main():
    if sys.argv[1:] == ["--nccl-two-ranks"]:
        return nccl_two_ranks()
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="long_context,pipeline_train,"
                    "ring_hops,moe_ep_body")
    ap.add_argument("--record", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_axes_phases: torch sees no CUDA device", file=sys.stderr)
        return 1
    failed = []
    if args.record:
        def record(cond, msg):
            if not cond:
                failed.append(msg)
                cs.emit({"failed_check": msg})
        cs.check = record
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.phase_device()
    cs.phase_build()
    for name in args.phases.split(","):
        launches = cs.timed(name, PHASES[name])
        cs.emit({"phase": f"{name}_launches", "launches": launches})
        torch.cuda.empty_cache()
    cs.emit({"phase": "seconds", **cs.PHASE_SECONDS})
    print(smi, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
