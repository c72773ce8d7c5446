"""Node health probe run as a worker process (the port of
``dlrover_tpu/agent/node_check_worker.py``).

    python -m dlrover_tpu_torch.agent.node_check_worker <result_file> \
        [matmul_size=1024] [rounds=30] [comm_mb=0]

The argv, the chaos variables and the result file are the reference's,
so its agent (``agent/node_check.py``) launches this module and reads
the file as it reads its own. The probe: a bf16 GEMM chain on the card
(``torch.matmul``, as the reference's ``jnp.dot`` outside any kernel),
then, with ``comm_mb`` > 0, an ``all_reduce`` of ``comm_mb`` MB over
the world (a world of one reduces over a one-rank group). It writes the
elapsed seconds to the result file; any exception, or a rank named in
``DLROVER_TPU_CHAOS_CHECK_FAIL_RANKS``, leaves no file, which the agent
reports as a failed probe. A probe that passed writes one JSON line to
stderr (``"event": "node_check_probe"``: its node rank, device and
elapsed seconds). It runs on the card unless
``DLROVER_TPU_CHECK_DEVICE=cpu`` asks for the CPU (gloo).
"""

import json
import os
import sys
import time

CHECK_DEVICE_ENV = "DLROVER_TPU_CHECK_DEVICE"


def _chaos_ranks(var: str) -> set:
    return {
        int(r)
        for r in os.getenv(var, "").split(",")
        if r.strip().lstrip("-").isdigit()
    }


def _my_node_rank() -> int:
    return int(os.getenv("DLROVER_TPU_CHECK_NODE_RANK", "-1"))


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    result_file = argv[1]
    matmul_size = int(argv[2]) if len(argv) > 2 else 1024
    rounds = int(argv[3]) if len(argv) > 3 else 30
    comm_mb = int(argv[4]) if len(argv) > 4 else 0

    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.trainer.runtime import init_distributed

    device = os.getenv(CHECK_DEVICE_ENV, "cuda")
    ctx = init_distributed(device=device)
    if device == "cuda":
        torch.cuda.set_device(ctx.local_rank)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    start = time.time()

    # Matrix-unit probe: a bf16 GEMM chain, each product renormalised.
    gen = torch.Generator(device).manual_seed(0)
    x = torch.randn(matmul_size, matmul_size, generator=gen, device=device,
                    dtype=torch.bfloat16)
    for _ in range(rounds // 8 or 1):
        for _ in range(8):
            x = torch.matmul(x, x)
            x = x / (x.abs().max() + 1.0)
    sync()

    # Collective probe over the whole probe world.
    if comm_mb > 0:
        if not dist.is_initialized():
            dist.init_process_group(
                "nccl" if device == "cuda" else "gloo",
                store=dist.HashStore(), world_size=1, rank=0)
        n = comm_mb * 1024 * 1024 // 4
        buf = torch.ones(n, dtype=torch.float32, device=device)
        dist.all_reduce(buf)
        sync()

    # Chaos: a rigged rank straggles inside the timed region or fails
    # after the collectives, so its partners complete cleanly.
    rank = _my_node_rank()
    if rank in _chaos_ranks("DLROVER_TPU_CHAOS_CHECK_SLOW_RANKS"):
        time.sleep(float(os.getenv("DLROVER_TPU_CHAOS_CHECK_SLOW_SECS", "3")))
    if rank in _chaos_ranks("DLROVER_TPU_CHAOS_CHECK_FAIL_RANKS"):
        return 1  # no result file: the agent reports a failed probe

    elapsed = time.time() - start
    tmp = result_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{elapsed:.6f}")
    os.replace(tmp, result_file)
    sys.stderr.write(json.dumps({
        "event": "node_check_probe", "node_rank": rank,
        "device": str(x.device),
        "device_name": (torch.cuda.get_device_name(x.device)
                        if x.is_cuda else "cpu"),
        "elapsed": elapsed,
    }) + "\n")
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
