"""Where a flash checkpoint's time goes on one GPU machine: the host side
of ``flash_ckpt/engine.py``'s async save, and what it costs a training
step.

    python3 tools/torch_ckpt_probe.py [--gb 4.0] [--steps 4]

1. Writes into a POSIX shm segment of ``--gb`` GB, three times each, by
   one thread (``np.copyto``), by torch's intra-op threads
   (``Tensor.copy_``), and by a device-to-host DMA into the segment
   registered with ``cudaHostRegister``; and the pinned device-to-host
   copy for scale. GB/s per pass.
2. A fresh attach of a warm segment (a relaunched worker's mapping):
   host-to-device reads in 64 MB copies and one-thread writes, plain,
   after ``cudaHostRegister`` and after ``MADV_POPULATE_WRITE``.
3. A memory restore of ``--gb`` GB onto the card from a fresh attach,
   the segment registered for the copy or not, in turns (seconds).
4. The flagship's training step (``make_train_step``, micro-batch 8 x
   2048, ga 2, seed 0): ``--steps`` steps without checkpoints, then as
   many with ``save_to_memory_async`` after each (standalone engine),
   its shm write by one thread and, patched, by torch's threads, then
   again without; seconds a step and the engine's save records.

Prints one JSON line per measurement, then the card's name and power
limit. Unlinks its segments.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def emit(obj):
    print(json.dumps(obj), flush=True)


def shm_rates(gb):
    from dlrover_tpu_torch.flash_ckpt.shm_handler import SharedMemoryHandler

    n = int(gb * 1e9)
    h = SharedMemoryHandler(f"ckptprobe{os.getpid()}")
    h._ensure_shm(n)  # noqa: SLF001
    dst = h._bytes[:n]  # noqa: SLF001
    src = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    src.fill_(7)
    dev = torch.full((n,), 3, dtype=torch.uint8, device="cuda")
    rows = {}

    def timed(label, fn):
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            out.append(n / 1e9 / (time.monotonic() - t0))
        rows[label] = out

    try:
        timed("d2h_pinned", lambda: src.copy_(dev, non_blocking=True))
        timed("numpy_1_thread", lambda: np.copyto(dst.numpy(), src.numpy()))
        timed("torch_threads", lambda: dst.copy_(src))
        err = torch.cuda.cudart().cudaHostRegister(dst.data_ptr(), n, 0)
        rows["host_register_rc"] = int(err)
        if int(err) == 0:
            timed("d2h_into_registered_shm",
                  lambda: dst.copy_(dev, non_blocking=True))
            torch.cuda.cudart().cudaHostUnregister(dst.data_ptr())
        emit({"probe": "shm_write_gb_per_s", "gb": gb,
              "torch_threads": torch.get_num_threads(), **rows})
    finally:
        del dst, src, dev
        h.unlink()


def attach_rates(gb):
    """A relaunched worker's view: the segment exists and is warm in
    another mapping; each fresh attach (a new mapping) is timed for a
    host-to-device read and a one-thread write, plain, after
    ``cudaHostRegister`` and after ``madvise(MADV_POPULATE_WRITE)``."""
    import mmap

    from dlrover_tpu_torch.flash_ckpt.shm_handler import SharedMemoryHandler

    n = int(gb * 1e9)
    name = f"ckptprobeattach{os.getpid()}"
    owner = SharedMemoryHandler(name)
    owner._ensure_shm(n)  # noqa: SLF001
    warm = torch.full((n,), 5, dtype=torch.uint8)
    owner._bytes[:n].copy_(warm)  # noqa: SLF001
    src = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    rows = {}
    try:
        for mode in ("plain", "registered", "populated"):
            h = SharedMemoryHandler(name)
            h.attach()
            view = h._bytes[:n]  # noqa: SLF001
            t0 = time.monotonic()
            if mode == "registered":
                rc = torch.cuda.cudart().cudaHostRegister(
                    view.data_ptr(), n, 0)
                rows["register_rc"] = int(rc)
            elif mode == "populated":
                try:
                    h._shm._mmap.madvise(  # noqa: SLF001
                        mmap.MADV_POPULATE_WRITE)
                    rows["populate"] = "ok"
                except (AttributeError, OSError) as e:
                    rows["populate"] = repr(e)
            prep = time.monotonic() - t0
            reads, writes = [], []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                for lo in range(0, n, 64 << 20):  # leaf-sized copies
                    dev[lo:lo + (64 << 20)].copy_(view[lo:lo + (64 << 20)])
                torch.cuda.synchronize()
                reads.append(n / 1e9 / (time.monotonic() - t0))
            for _ in range(2):
                t0 = time.monotonic()
                np.copyto(view.numpy(), src.numpy())
                writes.append(n / 1e9 / (time.monotonic() - t0))
            if mode == "registered":
                torch.cuda.cudart().cudaHostUnregister(view.data_ptr())
            rows[mode] = {"prep_s": prep, "h2d_gb_per_s": reads,
                          "write_1_thread_gb_per_s": writes}
            del view
            h.close()
        emit({"probe": "fresh_attach", "gb": gb, **rows})
    finally:
        del src, dev
        owner.unlink()


def restore_ab(gb):
    """``SharedMemoryHandler.load_state_dict`` onto the card from a
    fresh attach (a relaunched worker's), with the segment registered
    for the copy and without (the registration refused), in turns."""
    from dlrover_tpu_torch.flash_ckpt import shm_handler as sh

    n_leaves = max(int(gb * 1e9) // (64 << 20), 1)
    tree = [torch.full((64 << 18,), float(i), device="cuda")
            for i in range(n_leaves)]
    name = f"ckptproberestore{os.getpid()}"
    owner = sh.SharedMemoryHandler(name)
    owner.save_state_dict(1, tree)
    cudart = torch.cuda.cudart

    class _Refuses:
        def cudaHostRegister(self, *args):
            return 1  # any error code: the copy runs pageable

    rows = {"registered": [], "pageable": []}
    try:
        for mode in ("registered", "pageable", "pageable", "registered"):
            torch.cuda.cudart = (cudart if mode == "registered"
                                 else (lambda: _Refuses()))
            h = sh.SharedMemoryHandler(name)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            h.load_state_dict(target=tree)
            torch.cuda.synchronize()
            rows[mode].append(time.monotonic() - t0)
            h.close()
        emit({"probe": "restore_from_shm_s",
              "gb": n_leaves * (64 << 20) / 1e9, **rows})
    finally:
        torch.cuda.cudart = cudart
        owner.unlink()


def step_times(steps):
    from dlrover_tpu_torch.flash_ckpt.engine import CheckpointEngine
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer import train_step as ts

    cfg = llama.flagship_config()
    tc = ts.TrainConfig(warmup_steps=2, grad_accum=cs.TRAIN_GA)
    opt, state = cs._train_state(cfg, tc)  # noqa: SLF001
    step = ts.make_train_step(cfg, tc, opt, device="cuda")
    rs = np.random.RandomState(cs.SEED + 1)
    tokens = torch.from_numpy(rs.randint(
        0, cfg.vocab_size, (cs.TRAIN_GA * cs.TRAIN_MICRO, cs.TRAIN_SEQ + 1)
    ).astype(np.int32)).cuda()
    os.environ["DLROVER_TPU_JOB_NAME"] = f"ckptprobe{os.getpid()}"
    engine = CheckpointEngine("/tmp/ckptprobe", standalone=True)
    one_thread = np.copyto

    def torch_threads(dst, src):
        torch.from_numpy(dst).copy_(torch.from_numpy(src))

    try:
        for label in ("no_ckpt", "async_every_step",
                      "async_every_step_torch_threads", "no_ckpt_after"):
            # The engine's shm write calls np.copyto.
            np.copyto = torch_threads if "torch" in label else one_thread
            times = []
            for _ in range(steps):
                t0 = time.monotonic()
                state, m = step(state, {"tokens": tokens})
                float(m["loss"])
                if label.startswith("async"):
                    engine.save_to_memory_async(
                        state["step"], ts.state_tree(state),
                        fences=state["fences"])
                times.append(time.monotonic() - t0)
            engine.wait_async_save()
            emit({"probe": "step_s", "mode": label, "step_s": times,
                  "saves": engine.save_records()[-steps:]
                  if label.startswith("async") else []})
    finally:
        np.copyto = one_thread
        engine._shm.unlink()  # noqa: SLF001
        engine.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=4.0)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ckpt_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = cs.phase_device()
    cs.phase_build()
    shm_rates(args.gb)
    attach_rates(args.gb)
    restore_ab(args.gb)
    step_times(args.steps)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
