"""Elastic TpuLM pretraining worker of the port (the twin of
``examples/train_llama.py``), run by an agent:

    python -m dlrover_tpu_torch.examples.train_llama --steps 200 \\
        --ckpt-dir /tmp/llama_ckpt [--config flagship] [--device cpu]

What it does:
- joins the world from the agent's env (``init_distributed``) and lays
  it out as a mesh (``--mesh``, by default ``dp=<world>`` as the
  reference's worker); the train state lives as DTensors on it, so each
  rank's checkpoint holds its own shards;
- restores memory first (the agent's shm segment survives a worker
  restart on this host), storage second, in place into its own tensors,
  and resumes from the restored step and data cursor;
- trains with a fixed global batch (``ElasticBatchConfig``) on records
  ``synthetic_record(index)`` dealt by an ``ElasticDistributedSampler``
  whose cursor rides in the checkpoint's ``user_meta`` (one replica per
  rank of the batch axes; tp ranks read the same rows), through a
  prefetching loader and double-buffered host-to-device copies;
- under a master (``DLROVER_TPU_MASTER_ADDR``, set by the launcher)
  reports its global steps to the master's perf monitor; its records
  still come from the sampler, not from the master's shards (the
  reference's worker reads ``IndexShardingClient`` shards of 4096
  records there, whose snapshot would replay a whole shard after a
  kill);
- after each step launches an async flash checkpoint to shm, and every
  ``--persist-every`` steps asks the agent's saver to persist it.

Without an agent (no saver socket for this job) the checkpoint engine
runs standalone and persists in this process. Stdout carries one JSON
line per event: ``ready`` (after the restore: this process's pid, the
restart count, the restored step and its source, and what the restore
read, the segment's step and the storage tracker's), ``step`` (loss, the
step's and the save's seconds, the flash kernels' launch counts so
far), ``shm`` (a step committed to shm,
with the save's blocking and drain seconds), ``held`` (with
``--hold-file``: the last step ran, and the process waits for the file)
and a last ``done`` line (losses, a digest of the final state,
launches).
"""

import argparse
import dataclasses
import json
import os
import sys
import threading
import time
import zlib
from collections import deque

import numpy as np
import torch

from dlrover_tpu_torch import fault
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.env_utils import get_master_addr
from dlrover_tpu_torch.flash_ckpt.checkpointer import agent_present
from dlrover_tpu_torch.flash_ckpt.engine import CheckpointEngine
from dlrover_tpu_torch.flash_ckpt.shm_handler import leaf_bytes, tree_flatten
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.parallel.sharding import batch_index
from dlrover_tpu_torch.trainer import train_step as ts
from dlrover_tpu_torch.trainer.elastic.dataloader import PrefetchingDataLoader
from dlrover_tpu_torch.trainer.elastic.sampler import (
    ElasticDistributedSampler,
)
from dlrover_tpu_torch.trainer.elastic.trainer import (
    ElasticBatchConfig,
    ElasticTrainer,
)
from dlrover_tpu_torch.trainer.runtime import init_distributed, world_mesh


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--ckpt-dir", type=str, default="/tmp/llama_ckpt")
    p.add_argument("--global-batch", type=int, default=32)
    p.add_argument("--micro-batch", type=int, default=2)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--dataset-size", type=int, default=1_000_000)
    p.add_argument("--persist-every", type=int, default=20)
    p.add_argument(
        "--remat-policy", type=str, default="mlp_only",
        choices=["mlp_only", "attn_save", "dots", "full"],
    )
    p.add_argument("--config", choices=["tiny", "flagship"], default="tiny",
                   help="tiny: the reference's 4-layer tiny_config; "
                   "flagship: the 334M TpuLM")
    p.add_argument("--layers", type=int, default=0,
                   help="cut the config's depth to this many layers (0: "
                   "the config's own)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--mesh", default="",
                   help='mesh axes, e.g. "dp=2,tp=2" (default dp=<world>)')
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the params and the sampler's shuffle")
    p.add_argument("--hold-file", default="",
                   help="after the last step, wait until this file exists "
                        "(the process and its daemons stay up)")
    return p.parse_args(argv)


def synthetic_record(index: int, seq: int, vocab: int) -> np.ndarray:
    rng = np.random.default_rng(index)
    return rng.integers(0, vocab, size=(seq + 1,), dtype=np.int32)


def state_digest(tree) -> str:
    """crc32 over every leaf's bytes in the tree's flatten order."""
    crc = 0
    for leaf in tree_flatten(tree)[0]:
        crc = zlib.crc32(leaf_bytes(leaf).cpu().numpy(), crc)
    return f"{crc:08x}"


class _Emitter:
    """One JSON object a line on stdout, whole lines from any thread,
    each stamped with this process's rank (the ranks of a world share
    the agent's stdout)."""

    def __init__(self, rank: int = 0):
        self._lock = threading.Lock()
        self._rank = rank

    def __call__(self, obj):
        with self._lock:
            sys.stdout.write(json.dumps(dict(obj, rank=self._rank)) + "\n")
            sys.stdout.flush()


def _report_saves(engine, emit, stop: threading.Event):
    """Emit an ``shm`` line for each save as it commits."""
    seen = 0
    while True:
        records = engine.save_records()
        for rec in records[seen:]:
            emit({"event": "shm", "step": rec["step"],
                  "block_s": rec["block_s"], "drain_s": rec["drain_s"],
                  "copy_s": rec["copy_s"], "write_s": rec["write_s"],
                  "dropped": engine.dropped_snapshots})
        seen = len(records)
        if stop.is_set():
            return
        time.sleep(0.005)


def main(argv=None):
    args = parse_args(argv)
    t_start = time.monotonic()
    fault.arm_from_env()
    ctx = init_distributed(device=args.device)
    mesh = world_mesh(args.mesh, args.device)
    b_idx, b_count = batch_index(mesh)
    emit = _Emitter(ctx.process_id)
    device = torch.device(args.device)
    if args.config == "flagship":
        cfg = llama.flagship_config(remat_policy=args.remat_policy)
    else:
        cfg = llama.tiny_config(n_layers=4, remat_policy=args.remat_policy)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    batch_cfg = ElasticBatchConfig(args.global_batch, args.micro_batch)
    # Under a master (the launcher sets its address) the trainer reports
    # its global steps to the master's perf monitor.
    master_addr = get_master_addr()
    elastic = ElasticTrainer(
        batch_cfg,
        dp_size=b_count,
        master_client=MasterClient(master_addr, ctx.process_id)
        if master_addr
        else None,
    )
    tc = ts.TrainConfig(warmup_steps=20, grad_accum=elastic.grad_accum)
    opt = ts.make_optimizer(tc)
    gen = torch.Generator(device).manual_seed(args.seed)
    state = ts.init_train_state(cfg, opt,
                                llama.init_params(cfg, gen, device=device),
                                mesh=mesh)
    step_fn = ts.make_train_step(cfg, tc, opt, mesh=mesh, local_batch=True)

    # Resume: memory first, storage second, into this state's tensors.
    engine = CheckpointEngine(args.ckpt_dir, standalone=not agent_present())
    sampler = ElasticDistributedSampler(
        args.dataset_size, b_idx, b_count, shuffle=True, seed=args.seed)
    t0 = time.monotonic()
    restored = engine.load(target=ts.state_tree(state))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    restore_s = time.monotonic() - t0
    start_step = 0
    if restored is not None:
        start_step, tree, user_meta = restored
        ts.load_state_tree_(state, tree)
        sampler.load_state_dict(user_meta["sampler"])
        elastic.global_step = start_step
    emit({"event": "ready", "pid": os.getpid(),
          "restored_step": start_step,
          "restored_from": engine.last_restore_source,
          "restore_read": engine.last_restore_read,
          "restore_s": restore_s, "restart_count": ctx.restart_count,
          "start_s": time.monotonic() - t_start,
          "state_bytes": sum(leaf_bytes(x).numel() for x in tree_flatten(
              ts.state_tree(state))[0])})

    per_host = args.global_batch // b_count
    loader = PrefetchingDataLoader(
        lambda i: {"tokens": synthetic_record(i, args.seq, cfg.vocab_size)},
        sampler, per_host, sampler=sampler)
    # The cursor that counts each batch, taken as the loader hands it
    # over: the device prefetch holds the next batch before this one
    # trains, so the sampler itself runs a batch ahead.
    cursors: deque = deque()

    def with_cursor(batches):
        for batch in batches:
            cursors.append(sampler.state_dict())
            yield batch

    batches = elastic.device_prefetch(with_cursor(loader), device=device)
    stop = threading.Event()
    reporter = threading.Thread(target=_report_saves,
                                args=(engine, emit, stop), daemon=True)
    reporter.start()
    losses = {}
    elastic.start_training()
    try:
        for step in range(start_step + 1, args.steps + 1):
            batch = next(batches, None)
            if batch is None:
                emit({"event": "exhausted", "step": step - 1})
                break
            cursor = cursors.popleft()
            t0 = time.monotonic()
            state, metrics = step_fn(state, batch)
            losses[step] = float(metrics["loss"])
            compute_s = time.monotonic() - t0
            elastic.step_completed()
            tree = ts.state_tree(state)
            meta = {"sampler": cursor}
            block_s = engine.save_to_memory_async(step, tree, meta,
                                                  fences=state["fences"])
            if step % args.persist_every == 0:
                block_s += engine.save_to_storage(step, tree, meta)
            emit({"event": "step", "step": step, "loss": losses[step],
                  "compute_s": compute_s, "block_s": block_s,
                  "launches": dict(fa.launch_counts)})
    finally:
        loader.stop()
    if args.hold_file:
        emit({"event": "held"})
        while not os.path.exists(args.hold_file):
            time.sleep(0.05)
    engine.wait_async_save()
    stop.set()
    reporter.join(timeout=10.0)
    engine.close()
    emit({"event": "done", "losses": losses,
          "digest": state_digest(ts.state_tree(state)),
          "launches": dict(fa.launch_counts),
          "dropped": engine.dropped_snapshots})
    return 0


if __name__ == "__main__":
    sys.exit(main())
