"""Chaos-soak training worker: one crash-restartable generation.

Spawned (and re-spawned after every injected crash) by
:mod:`dlrover_tpu_torch.testing.soak`. Each generation runs the REAL
worker-side stack against the soak's master:

- :class:`MasterClient` over the HTTP transport (keep-alive stub,
  at-most-once retry semantics);
- :class:`ShardingClient` with the prefetch pipeline + coalesced
  done-reports (exactly-once shard accounting under test);
- :class:`CheckpointEngine` standalone (shm image + raw-format disk
  persist + commit protocol, torn-shard rejection + fallback restore
  under test);
- :class:`ElasticTrainer` step bookkeeping (the ``agent.worker.crash``
  fault site) and the flight recorder.

The "model" is a deterministic state updated per record — integer
leaves are order-independent exact sums, so after any fault sequence
the final state equals the exactly-once expectation iff every record
contributed exactly once relative to the restored checkpoints.

Crash-surviving evidence: every step/save/restore appends one fsynced
JSON line to ``--events`` BEFORE training continues, so even a SIGKILL
mid-step leaves a complete ledger for the runner's invariant checks.

The port's copy of ``dlrover_tpu/testing/soak_worker.py``. The state
(``sum`` int64, ``hist`` int64[64], ``vec`` float64[256]) is tensors on
``--device`` (``cuda`` unless asked for ``cpu``; ``cuda`` without a card
raises), updated with ``index_add_``. On the card ``vec``'s float sums
land in another order than ``np.add.at``'s and are not bitwise
repeatable; the integer leaves are exact, and every restore is held to
its own save's CRC.

``state_crc`` takes numpy arrays or torch tensors (on any device) and
gives the reference's checksum of the same values: each leaf's bytes,
then its dtype's numpy name (``"int64"``, never ``"torch.int64"``), in
sorted key order.
"""

import argparse
import binascii
import json
import os
import sys
import time
from typing import Dict

import numpy as np
import torch

HIST_BUCKETS = 64
VEC_LEN = 256

# Worker exit codes the runner interprets.
EXIT_OK = 0
EXIT_INTEGRITY = 3      # restored checkpoint failed its content check
EXIT_ACCOUNTING = 4     # shard/report protocol failed


def fresh_state(device="cpu") -> Dict[str, torch.Tensor]:
    return {
        "sum": torch.zeros((), dtype=torch.int64, device=device),
        "hist": torch.zeros(HIST_BUCKETS, dtype=torch.int64, device=device),
        "vec": torch.zeros(VEC_LEN, dtype=torch.float64, device=device),
    }


def apply_shard(state: Dict[str, torch.Tensor], start: int, end: int):
    """Deterministic, order-independent (on the integer leaves) state
    update for records [start, end)."""
    device = state["hist"].device
    idxs = torch.arange(start, end, dtype=torch.int64, device=device)
    state["sum"] += idxs.sum()
    state["hist"].index_add_(0, idxs % HIST_BUCKETS, torch.ones_like(idxs))
    state["vec"].index_add_(0, idxs % VEC_LEN,
                            torch.sqrt(idxs.to(torch.float64) + 1.0))


def expected_sum(dataset_size: int) -> int:
    return dataset_size * (dataset_size - 1) // 2


def expected_hist(dataset_size: int) -> np.ndarray:
    idxs = np.arange(dataset_size, dtype=np.int64)
    hist = np.zeros(HIST_BUCKETS, np.int64)
    np.add.at(hist, idxs % HIST_BUCKETS, 1)
    return hist


def host_array(leaf) -> np.ndarray:
    """A contiguous numpy array of ``leaf``'s values (a tensor is copied
    to the host first)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous().numpy()
    return np.ascontiguousarray(leaf)


def state_crc(state: Dict[str, object]) -> int:
    crc = 0
    for key in sorted(state):
        arr = host_array(state[key])
        crc = binascii.crc32(arr.tobytes(), crc)
        crc = binascii.crc32(str(arr.dtype).encode(), crc)
    return crc


class EventLog:
    """Append-only fsynced JSONL ledger that survives SIGKILL."""

    def __init__(self, path: str):
        self._f = open(path, "a")

    def append(self, **entry):
        entry.setdefault("t", time.time())
        self._f.write(json.dumps(entry) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())


def _write_progress(path: str, step: int):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{step} {time.time():.6f}")
    os.replace(tmp, path)


def _restore(engine, events: EventLog):
    """Restore the newest restorable checkpoint, integrity-checked.

    Memory-first through the engine; a torn/implausible shm image (the
    worker may have been SIGKILLed mid shm write) falls back to the
    committed storage checkpoint, which itself falls back past
    torn/corrupt step dirs (engine fallback walk). The state comes back
    as host tensors."""
    result = None
    try:
        result = engine.load()
    except Exception as e:  # noqa: BLE001 — a torn shm image may raise
        events.append(kind="restore_memory_error", error=str(e)[:200])
    if result is not None:
        step, state, meta = result
        crc = state_crc(state)
        if crc == meta.get("state_crc"):
            return step, state, meta, "memory_or_storage"
        events.append(
            kind="restore_crc_mismatch", step=step,
            got=crc, want=meta.get("state_crc"),
        )
        # The shm image lied; retry restricted to committed storage.
        result = None
    try:
        result = engine._load_from_storage(None, None)  # noqa: SLF001
    except Exception as e:  # noqa: BLE001
        events.append(kind="restore_storage_error", error=str(e)[:200])
        result = None
    if result is None:
        return None
    step, state, meta = result
    crc = state_crc(state)
    if crc != meta.get("state_crc"):
        events.append(
            kind="restore_crc_mismatch", step=step,
            got=crc, want=meta.get("state_crc"), source="storage",
        )
        print("restored storage checkpoint failed integrity check",
              file=sys.stderr)
        sys.exit(EXIT_INTEGRITY)
    return step, state, meta, "storage"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="chaos soak worker")
    parser.add_argument("--master-addr", required=True)
    parser.add_argument("--node-id", type=int, default=0)
    parser.add_argument("--dataset", default="soak")
    parser.add_argument("--dataset-size", type=int, required=True)
    parser.add_argument("--shard-size", type=int, default=16)
    parser.add_argument("--ckpt-dir", required=True)
    parser.add_argument("--ckpt-every", type=int, default=2,
                        help="checkpoint every N steps (shards)")
    parser.add_argument("--events", required=True,
                        help="append-only JSONL ledger path")
    parser.add_argument("--progress", required=True,
                        help="progress file (atomic replace per step)")
    parser.add_argument("--generation", type=int, default=0)
    parser.add_argument(
        "--step-ms", type=float, default=0.0,
        help="simulated compute per step, so goodput accounting has a "
        "visible productive-time signal",
    )
    parser.add_argument("--device", default="cuda",
                        help="where the state lives: cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "soak worker: --device cuda but torch sees no CUDA device"
        )

    from dlrover_tpu_torch.fault import arm_from_env

    arm_from_env()

    from dlrover_tpu_torch.observability import flight_recorder

    flight_recorder.install_recorder(
        node_rank=args.node_id, local_rank=0,
        meta={"soak_generation": args.generation},
    )

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.flash_ckpt.engine import CheckpointEngine
    from dlrover_tpu_torch.trainer.elastic.sharding_client import (
        ShardingClient,
    )
    from dlrover_tpu_torch.trainer.elastic.trainer import (
        ElasticBatchConfig,
        ElasticTrainer,
    )

    events = EventLog(args.events)
    if device.type == "cuda":
        torch.cuda.init()
    events.append(kind="worker_start", generation=args.generation,
                  pid=os.getpid(), device=str(device),
                  device_name=(torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"))

    client = MasterClient(
        args.master_addr, node_id=args.node_id, kind="http", timeout=10.0
    )
    engine = CheckpointEngine(args.ckpt_dir, standalone=True)

    restored = _restore(engine, events)
    if restored is not None:
        step0, host_state, meta, source = restored
        shard_ckpt = meta.get("shard_ckpt", "")
        state = {k: torch.as_tensor(v).to(device)
                 for k, v in host_state.items()}
        events.append(
            kind="restore", step=int(step0), crc=state_crc(state),
            source=source, generation=args.generation,
        )
    else:
        step0, state, shard_ckpt = 0, fresh_state(device), ""
        events.append(kind="fresh_start", generation=args.generation)

    sharding_client = ShardingClient(
        client,
        dataset_name=args.dataset,
        dataset_size=args.dataset_size,
        shard_size=args.shard_size,
        prefetch_depth=4,
        fetch_batch=2,
        report_batch=2,
        report_interval_s=0.2,
        wait_backoff_s=0.05,
        wait_backoff_max_s=0.5,
    )
    # The dataset position must rewind to EXACTLY the snapshot taken
    # with the restored state — shards completed after that snapshot
    # were rolled back out of the state and must be re-dispatched.
    sharding_client.restore_shard_checkpoint(shard_ckpt)

    trainer = ElasticTrainer(
        ElasticBatchConfig(
            global_batch_size=args.shard_size,
            micro_batch_per_device=args.shard_size,
        ),
        dp_size=1,
        master_client=client,
        report_interval_s=0.5,
    )
    trainer.global_step = int(step0)
    trainer.start_training()

    if restored is None:
        # Initial checkpoint BEFORE consuming anything: a later restart
        # then always has a (state, shard-snapshot) pair to rewind to.
        # Without it, a crash before the first cadence save would leave
        # the next generation starting with fresh state against a
        # master that already counted this generation's done-reports —
        # records silently lost (exactly-once broken).
        crc = state_crc(state)
        engine.save_to_storage(
            0, state,
            user_meta={
                "state_crc": crc,
                "shard_ckpt": sharding_client.get_shard_checkpoint(),
            },
        )
        events.append(kind="save", step=0, crc=crc,
                      generation=args.generation)

    while True:
        t_step = time.time()
        task = sharding_client.fetch_task()
        if task is None:
            break
        apply_shard(state, task.start, task.end)
        if device.type == "cuda":
            # The step's device work is part of its duration.
            torch.cuda.synchronize(device)
        if args.step_ms > 0:
            time.sleep(args.step_ms / 1e3)
        sharding_client.report_task_done(task)
        # agent.worker.crash fires inside step_completed — the ledger
        # entry below is intentionally AFTER it, so a crashed step never
        # claims completion.
        trainer.step_completed(steps=1)
        step = trainer.global_step
        events.append(
            kind="step", step=step, dur=time.time() - t_step,
            shard=[task.start, task.end], generation=args.generation,
        )
        _write_progress(args.progress, step)
        if step % max(args.ckpt_every, 1) == 0:
            try:
                ckpt_str = sharding_client.get_shard_checkpoint()
            except RuntimeError as e:
                # Unflushable done-reports: refusing the checkpoint is
                # the correct degraded behavior; train on and retry at
                # the next cadence tick.
                events.append(kind="ckpt_refused", step=step,
                              error=str(e)[:200])
                continue
            crc = state_crc(state)
            engine.save_to_storage(
                step, state,
                user_meta={"state_crc": crc, "shard_ckpt": ckpt_str},
            )
            events.append(kind="save", step=step, crc=crc,
                          generation=args.generation)

    sharding_client.stop()
    final = {
        "sum": int(state["sum"]),
        "hist": host_array(state["hist"]).tolist(),
        "steps": int(trainer.global_step),
        "generation": args.generation,
        "crc": state_crc(state),
    }
    events.append(kind="done", **final)
    engine.close()
    return EXIT_OK


if __name__ == "__main__":
    raise SystemExit(main())
