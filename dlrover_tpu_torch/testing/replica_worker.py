"""Worker of a checkpoint-replica run: one node's rank of a world of
nodes that share one card, run by the agent of ``python -m
dlrover_tpu_torch.run --nnodes N --ckpt_replica_group G``:

    python -m dlrover_tpu_torch.testing.replica_worker --ckpt-dir d \\
        --steps 5 --persist-every 3 --hold-file h [--config flagship \\
        --layers 4] [--device cuda]

The ranks form no process group (two ranks on one card cannot form an
NCCL group): the worker drops the agent's coordinator address before
``init_distributed``, so each rank trains the same model on the same
batches (a data-parallel world whose gradients agree without an
all-reduce) and saves its own image. It:

- reads the image its node's segment holds before the restore (its
  step, bytes and crc32: a segment pulled from a peer is read as pulled);
- restores memory first, storage second, in place into its train state
  on ``--device`` (``cuda`` by default; without a card it raises), and
  gives the crc32 of every leaf it restored;
- trains to ``--steps`` through ``make_train_step``, saves each step to
  shm (``save_to_memory_async``) and every ``--persist-every`` steps
  asks the agent's saver to persist it, then waits for that step's
  commit (a commit needs every node's files of one step: ranks of a
  world that shares no collective keep their persists in step so);
- with ``--pause-at N``, stops after its step N (once that step is in
  shm and committed) and waits to be stopped: its agent restarts it when
  the world re-forms, and the next incarnation restores step N and
  trains on;
- under a master (the launcher exports ``DLROVER_TPU_MASTER_ADDR``),
  reports each step to the master's perf monitor, with its rank as its
  node id: the step (``MasterClient.report_global_step``) and its wall
  interval as a train phase (``report_goodput_phase``), which the
  master's goodput counts;
- waits, after its last step and the last save's commit, until
  ``--hold-file`` exists (a node stays up to serve its peers' replicas
  until the run lets it go), then exits 0.

Stdout carries one JSON line per event, each with the node's rank:
``ready`` (pid, restart count, the image read before the restore, the
restored step and source, the restore's seconds, the leaves' crc32s),
``step`` (loss, the flash kernels' launch counts so far), ``saved``
(the newest step committed to shm), ``paused`` and ``done``.
"""

import argparse
import dataclasses
import json
import os
import sys
import time
import zlib

import torch

from dlrover_tpu_torch import fault
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import (
    GoodputPhase,
    NodeEnv,
    WorkerEnv,
)
from dlrover_tpu_torch.common.env_utils import get_master_addr
from dlrover_tpu_torch.flash_ckpt.engine import (
    CheckpointEngine,
    shm_segment_name,
)
from dlrover_tpu_torch.flash_ckpt.replica import image_end
from dlrover_tpu_torch.flash_ckpt.shm_handler import (
    SharedMemoryHandler,
    leaf_bytes,
    tree_flatten,
)
from dlrover_tpu_torch.flash_ckpt.storage import read_tracker
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.trainer import train_step as ts
from dlrover_tpu_torch.trainer.runtime import init_distributed


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--persist-every", type=int, default=3)
    p.add_argument("--hold-file", required=True)
    p.add_argument("--hold-timeout", type=float, default=600.0,
                   help="seconds to wait for a commit or the hold file")
    p.add_argument("--pause-at", type=int, default=0,
                   help="after this step, wait to be stopped (0: never)")
    p.add_argument("--config", choices=["tiny", "flagship"], default="tiny")
    p.add_argument("--layers", type=int, default=0,
                   help="cut the config's depth (0: the config's own)")
    p.add_argument("--micro-batch", type=int, default=1)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def leaf_crcs(tree) -> list:
    """crc32 of every leaf's bytes, in the tree's flatten order."""
    return [zlib.crc32(leaf_bytes(leaf).cpu().numpy())
            for leaf in tree_flatten(tree)[0]]


def image_digest(name: str):
    """The committed image in segment ``name``, read in place: its
    step, its valid bytes' length and crc32 (the bytes a replica
    carries), and the crc32 of each leaf's bytes; None without one."""
    handler = SharedMemoryHandler(name)
    try:
        meta = handler.load_meta()
        if meta is None:
            return None
        buf = handler._shm.buf  # noqa: SLF001
        end = image_end(meta)
        with buf[:end] as view:
            crc = zlib.crc32(view)
        leaves = []
        for leaf in meta["leaves"]:
            start = meta["data_start"] + leaf.shards[0].offset
            with buf[start:start + leaf.shards[0].nbytes] as view:
                leaves.append(zlib.crc32(view))
        del buf
        return {"step": meta["step"], "bytes": end, "crc32": crc,
                "leaf_crc32": leaves}
    finally:
        handler.close()


def batch(step: int, rows: int, seq: int, vocab: int) -> dict:
    """The step's tokens, the same on every rank."""
    gen = torch.Generator().manual_seed(step)
    return {"tokens": torch.randint(0, vocab, (rows, seq + 1),
                                    generator=gen, dtype=torch.int32)}


def _wait(cond, deadline, what):
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"replica worker: no {what} in time")
        time.sleep(0.05)


def main(argv=None) -> int:
    args = parse_args(argv)
    t_start = time.monotonic()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "replica worker: --device cuda but torch sees no CUDA device")
    # No process group: the ranks share the card.
    os.environ.pop(WorkerEnv.COORDINATOR_ADDRESS, None)
    fault.arm_from_env()
    ctx = init_distributed(device=args.device)
    node_rank = int(os.getenv(NodeEnv.NODE_RANK, "0"))

    def emit(obj):
        sys.stdout.write(json.dumps(dict(obj, rank=node_rank)) + "\n")
        sys.stdout.flush()

    cfg = (llama.flagship_config() if args.config == "flagship"
           else llama.tiny_config(n_layers=4))
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    tc = ts.TrainConfig(warmup_steps=20)
    opt = ts.make_optimizer(tc)
    gen = torch.Generator(device).manual_seed(args.seed)
    state = ts.init_train_state(cfg, opt,
                                llama.init_params(cfg, gen, device=device))
    step_fn = ts.make_train_step(cfg, tc, opt, device=args.device)

    image = image_digest(shm_segment_name(ctx.local_rank))
    engine = CheckpointEngine(args.ckpt_dir)
    t0 = time.monotonic()
    restored = engine.load(target=ts.state_tree(state))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    restore_s = time.monotonic() - t0
    deadline = time.monotonic() + args.hold_timeout
    start_step, crcs = 0, None
    if restored is not None:
        start_step, tree, _ = restored
        ts.load_state_tree_(state, tree)
        crcs = leaf_crcs(ts.state_tree(state))
    emit({"event": "ready", "pid": os.getpid(),
          "restart_count": ctx.restart_count,
          "image": None if image is None else {
              k: image[k] for k in ("step", "bytes", "crc32")},
          "restored_step": start_step,
          "restored_from": engine.last_restore_source,
          "restore_read": engine.last_restore_read,
          "restore_s": restore_s, "leaf_crc32": crcs,
          "start_s": time.monotonic() - t_start})

    master_addr = get_master_addr()
    client = MasterClient(master_addr, node_id=node_rank) if master_addr \
        else None
    t_prev, wall_prev = time.monotonic(), time.time()
    for step in range(start_step + 1, args.steps + 1):
        state, metrics = step_fn(state, batch(step, args.micro_batch,
                                              args.seq, cfg.vocab_size))
        tree = ts.state_tree(state)
        engine.save_to_memory_async(step, tree, fences=state["fences"])
        if step % args.persist_every == 0:
            engine.save_to_storage(step, tree)
            _wait(lambda s=step: read_tracker(args.ckpt_dir) >= s,
                  deadline, f"the commit of step {step}")
        emit({"event": "step", "step": step, "loss": float(metrics["loss"]),
              "launches": dict(fa.launch_counts)})
        if client is not None:
            now, wall_now = time.monotonic(), time.time()
            client.report_global_step(step, step_time_s=now - t_prev)
            client.report_goodput_phase(GoodputPhase.TRAIN, wall_prev,
                                        wall_now)
            t_prev, wall_prev = now, wall_now
        if step == args.pause_at:
            engine.wait_async_save()
            emit({"event": "paused", "step": engine.last_written_step})
            _wait(lambda: False, deadline, "stop after the pause")
    engine.wait_async_save()
    emit({"event": "saved", "step": engine.last_written_step})
    _wait(lambda: os.path.exists(args.hold_file), deadline, args.hold_file)
    engine.close()
    emit({"event": "done", "step": max(start_step, args.steps)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
