"""Where a flagship replica worker's start goes, on a card host.

    python3 tools/torch_start_probe.py [--out chiprun_out/probe]

The card's name and power limit (``nvidia-smi``); then, twice each, in
fresh interpreters: a bare interpreter; ``import torch``; ``import
numpy``; ``import dlrover_tpu_torch.run`` (the launcher),
``dlrover_tpu_torch.testing.replica_worker`` and
``dlrover_tpu_torch.agent.training`` under ``-X importtime`` (the
profiles go to ``--out``). Then twice, in a fresh interpreter, the
pieces of ``testing/replica_worker``'s start on the card: ``import
torch``, the rest of the worker's imports, the CUDA context, the
flagship's params at 4 layers, ``trainer/train_step.init_train_state``
(AdamW), ``make_train_step`` and three steps of batch 1 x 128. One JSON
line a run (its wall seconds), and the pieces' seconds as one JSON
object a run.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PIECES = r"""
import time, json
t = {}
t0 = time.monotonic()
import torch
t['import_torch'] = time.monotonic() - t0; t1 = time.monotonic()
from dlrover_tpu_torch.testing import replica_worker as rw
t['import_rw_rest'] = time.monotonic() - t1; t1 = time.monotonic()
torch.zeros(1, device='cuda'); torch.cuda.synchronize()
t['cuda_init'] = time.monotonic() - t1; t1 = time.monotonic()
import dataclasses
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.trainer import train_step as ts
cfg = dataclasses.replace(llama.flagship_config(), n_layers=4)
tc = ts.TrainConfig(warmup_steps=20)
opt = ts.make_optimizer(tc)
gen = torch.Generator('cuda').manual_seed(0)
params = llama.init_params(cfg, gen, device=torch.device('cuda'))
torch.cuda.synchronize()
t['init_params'] = time.monotonic() - t1; t1 = time.monotonic()
state = ts.init_train_state(cfg, opt, params)
torch.cuda.synchronize()
t['init_state'] = time.monotonic() - t1; t1 = time.monotonic()
step_fn = ts.make_train_step(cfg, tc, opt, device='cuda')
t['make_step'] = time.monotonic() - t1; t1 = time.monotonic()
for i in range(3):
    state, m = step_fn(state, rw.batch(i + 1, 1, 128, cfg.vocab_size))
    float(m['loss'])
    t[f'step{i+1}'] = time.monotonic() - t1; t1 = time.monotonic()
t['total'] = time.monotonic() - t0
print(json.dumps(t))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join("chiprun_out", "probe"))
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO)

    def timed_run(name, argv):
        t0 = time.monotonic()
        proc = subprocess.run(argv, env=env, capture_output=True, text=True)
        dt = time.monotonic() - t0
        with open(os.path.join(args.out, f"{name}.txt"), "w") as f:
            f.write(proc.stdout + "\n---stderr---\n" + proc.stderr)
        print(json.dumps({"probe": name, "s": round(dt, 3),
                          "rc": proc.returncode}), flush=True)
        return proc

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"probe": "device", "nvidia_smi": smi.stdout.strip()}),
          flush=True)
    py = sys.executable
    for i in range(2):
        timed_run(f"python_bare_{i}", [py, "-c", "pass"])
        timed_run(f"import_torch_{i}", [py, "-c", "import torch"])
        timed_run(f"import_numpy_{i}", [py, "-c", "import numpy"])
        for name, module in (
                ("run", "dlrover_tpu_torch.run"),
                ("rw", "dlrover_tpu_torch.testing.replica_worker"),
                ("agent", "dlrover_tpu_torch.agent.training")):
            timed_run(f"import_{name}_{i}",
                      [py, "-X", "importtime", "-c", f"import {module}"])
    rc = 0
    for i in range(2):
        proc = timed_run(f"worker_pieces_{i}", [py, "-c", PIECES])
        print(proc.stdout.strip()[-2000:], proc.stderr[-2000:], flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
