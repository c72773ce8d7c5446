"""The host cost of the model's profiler scopes (``llama.scope``:
``attn``, ``mlp``, ``vocab``, ``optimizer``) on one GPU.

    python3 tools/torch_scope_ab.py [--tokens 64]

A scope enters a ``record_function`` range only while the thread's
profiler records; otherwise it costs one check. This counts the scopes
one ``generate()`` on the flagship (batch 8, prompt 128, ``--tokens``
new tokens) and one flagship train step (4 layers, micro-batch 2 x 512)
enter, times that step and that ``generate()``, and times one scope
without a profiler and one ``record_function`` range, so the scopes'
cost of a call is bounded by count x microseconds. Prints one JSON line
and the card's name and power limit.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dlrover_tpu_torch.models import generate, llama  # noqa: E402
from dlrover_tpu_torch.ops import _ext  # noqa: E402
from dlrover_tpu_torch.trainer import train_step as ts  # noqa: E402


def _per_call_us(enter, n=20000):
    t0 = time.perf_counter()
    for _ in range(n):
        with enter("mlp"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_scope_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    _ext.build()
    cfg = llama.flagship_config()
    params = llama.init_params(
        cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
    prompt = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, 128)).astype(np.int32)
    tcfg = llama.flagship_config(n_layers=4)
    tc = ts.TrainConfig(warmup_steps=2, grad_accum=1)
    opt = ts.make_optimizer(tc)
    state = ts.init_train_state(tcfg, opt, llama.init_params(
        tcfg, torch.Generator("cuda").manual_seed(0), device="cuda"))
    step = ts.make_train_step(tcfg, tc, opt, device="cuda")
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 513)).astype(np.int32)).cuda()
    scope = llama.scope
    calls = [0]

    def counted(name):
        calls[0] += 1
        return scope(name)

    def run(what):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if what == "generate":
            generate.generate(cfg, params, prompt, args.tokens)
        else:
            float(step(state, {"tokens": tokens})[1]["loss"])
        torch.cuda.synchronize()
        return time.monotonic() - t0

    out = {}
    for what in ("generate", "train_step"):
        run(what)  # warm-up
        calls[0] = 0
        llama.scope = counted
        try:
            out[f"{what}_s"] = run(what)
        finally:
            llama.scope = scope
        out[f"{what}_scopes"] = calls[0]
    out["scope_us"] = _per_call_us(scope)
    out["range_us"] = _per_call_us(torch.profiler.record_function)
    for what in ("generate", "train_step"):
        out[f"{what}_scope_share_bound"] = (
            out[f"{what}_scopes"] * out["scope_us"] / 1e6 / out[f"{what}_s"])
    print(json.dumps(out), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
