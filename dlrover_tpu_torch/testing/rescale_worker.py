"""Live-rescale soak worker: survives N→M world changes in-process.

Spawned by :mod:`dlrover_tpu_torch.testing.rescale_soak`. Unlike a
crash-restart worker, this process is built to NEVER exit across a
world change: it runs the full worker-side rescale protocol
(docs/DESIGN.md §27) against the master's :class:`RescaleCoordinator` —

- plan poll → pause the ShardingClient prefetcher (force-flushing
  done-reports) → "barrier" ack/wait;
- restore EXACTLY its new addressable byte ranges of the sharded
  leaves (params ``w`` AND optimizer ``opt``) at the plan's
  restore_step through :func:`flash_ckpt.engine.load_state_regions`
  into its device tensors, then allgather peers' ranges over the master
  KV store (the interconnect here: no NCCL, no torch process group) to
  rebuild its replica;
- the designated (lowest) rank rewinds the master's dataset cursor to
  the restored checkpoint's shard snapshot — so shards consumed after
  the restore step are re-dispatched exactly once;
- "restored" barrier → ``trainer.rescale(new_dp)`` /
  ``sampler.rescale(rank, world)`` → prefetcher resume → "resumed" ack
  (passing the ``rescale.resume.first_step`` kill window).

The model state is all-integer and order-independent: workers exchange
per-step shard contributions through the KV store and apply the summed
"gradient" identically, so every replica of the state is a pure
function of the SET of consumed shards — after any fault/rescale
sequence the state is bit-identical to a single-host reference run over
the same consumed set, which is what the harness asserts.

The port's copy of ``dlrover_tpu/testing/rescale_worker.py``. Its state
(``hist``, ``opt``, ``sum``, ``w``) is int64 tensors on ``--device``
(``cuda`` unless asked for ``cpu``; ``cuda`` without a card raises). A
contribution crosses the KV store as its nonzero entries, a restored
block as its raw bytes; both rebuild the same tensors as the
reference's JSON lists.
"""

import argparse
import json
import os
import struct
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

VEC_LEN = 64
HIST_BUCKETS = 32

# Leaf ids of the sorted-key state tree {"hist", "opt", "sum", "w"}.
LEAF_HIST, LEAF_OPT, LEAF_SUM, LEAF_W = 0, 1, 2, 3

EXIT_OK = 0
EXIT_INTEGRITY = 3
EXIT_EVICTED = 0  # eviction is a clean, expected exit


def fresh_state(vec_len: int = VEC_LEN, device="cpu") -> Dict[str, torch.Tensor]:
    return {
        "hist": torch.zeros(HIST_BUCKETS, dtype=torch.int64, device=device),
        "opt": torch.zeros(vec_len, dtype=torch.int64, device=device),
        "sum": torch.zeros((), dtype=torch.int64, device=device),
        "w": torch.zeros(vec_len, dtype=torch.int64, device=device),
    }


def shard_contribution(start: int, end: int, vec_len: int = VEC_LEN,
                       device="cpu"):
    """Order-independent integer contribution of records [start, end)."""
    idxs = torch.arange(start, end, dtype=torch.int64, device=device)
    vec = torch.zeros(vec_len, dtype=torch.int64, device=device)
    vec.index_add_(0, idxs % vec_len, idxs + 1)
    hist = torch.zeros(HIST_BUCKETS, dtype=torch.int64, device=device)
    hist.index_add_(0, idxs % HIST_BUCKETS, torch.ones_like(idxs))
    return {"vec": vec, "sum": int(idxs.sum()), "hist": hist}


def apply_contribution(state: Dict[str, torch.Tensor], c):
    state["w"] += c["vec"]
    state["opt"] += 3 * c["vec"]  # "optimizer" leaf: distinct content
    state["sum"] += c["sum"]
    state["hist"] += c["hist"]


def _apply_ranges(state, ranges, vec_len: int):
    """``apply_contribution(state, shard_contribution(s, e))`` for every
    range, without the dense [vec_len] intermediates."""
    device = state["w"].device
    for start, end in ranges:
        idxs = torch.arange(start, end, dtype=torch.int64, device=device)
        slots = idxs % vec_len
        state["w"].index_add_(0, slots, idxs + 1)
        state["opt"].index_add_(0, slots, 3 * (idxs + 1))
        state["sum"] += idxs.sum()
        state["hist"].index_add_(0, idxs % HIST_BUCKETS,
                                 torch.ones_like(idxs))


def reference_state(
    dataset_size: int,
    consumed_ranges: List[Tuple[int, int]],
    vec_len: int = VEC_LEN,
    device="cpu",
) -> Dict[str, torch.Tensor]:
    """Single-host reference: the state after consuming exactly
    ``consumed_ranges``, each once. Integer leaves make this bit-exact
    regardless of consumption order or world-size trajectory."""
    state = fresh_state(vec_len, device)
    _apply_ranges(state, consumed_ranges, vec_len)
    return state


def world_lcm(world: int) -> int:
    """lcm(1..world): the grad-accum multiplier making every dp size up
    to ``world`` divide the global batch."""
    import math

    return math.lcm(*range(1, max(world, 1) + 1))


def block_bounds(rank_index: int, world: int, vec_len: int):
    """Contiguous row block rank ``rank_index`` of ``world`` owns."""
    lo = rank_index * vec_len // world
    hi = (rank_index + 1) * vec_len // world
    return lo, hi


def _encode(payload: dict) -> bytes:
    """JSON fields, then each tensor's raw bytes (int64, little-endian):
    an 8-byte header length, the header, the blobs."""
    fields, blobs, offset = {}, [], 0
    for key, value in payload.items():
        if isinstance(value, (torch.Tensor, np.ndarray)):
            arr = value
            if isinstance(arr, torch.Tensor):
                arr = arr.detach().cpu().contiguous().numpy()
            raw = np.ascontiguousarray(arr, dtype=np.int64).tobytes()
            fields[key] = {"__blob__": [offset, len(raw)],
                           "shape": list(arr.shape)}
            blobs.append(raw)
            offset += len(raw)
        else:
            fields[key] = value
    head = json.dumps(fields).encode()
    return struct.pack("<Q", len(head)) + head + b"".join(blobs)


def _decode(raw: bytes) -> dict:
    """``_encode``'s fields, its blobs as int64 numpy arrays."""
    (n,) = struct.unpack_from("<Q", raw)
    fields = json.loads(raw[8:8 + n].decode())
    body = memoryview(raw)[8 + n:]
    for key, value in fields.items():
        if isinstance(value, dict) and "__blob__" in value:
            off, size = value["__blob__"]
            fields[key] = np.frombuffer(
                body[off:off + size], dtype=np.int64
            ).reshape(value["shape"])
    return fields


def contribution_payload(c, start: int, end: int) -> dict:
    """A contribution for the KV store: its vector's nonzero entries."""
    idx = torch.nonzero(c["vec"]).reshape(-1)
    return {"kind": "c", "idx": idx, "val": c["vec"][idx],
            "sum": c["sum"], "hist": c["hist"], "range": [start, end]}


def contribution_from_payload(p: dict, vec_len: int, device):
    """The dense contribution ``contribution_payload`` was made from."""
    vec = torch.zeros(vec_len, dtype=torch.int64, device=device)
    vec[torch.from_numpy(p["idx"].copy()).to(device)] = (
        torch.from_numpy(p["val"].copy()).to(device))
    return {"vec": vec, "sum": int(p["sum"]),
            "hist": torch.from_numpy(p["hist"].copy()).to(device)}


class _Aborted(Exception):
    """A newer plan arrived while gathering — restart the loop on it."""

    def __init__(self, plan):
        super().__init__(f"superseded by plan {plan.plan_id}")
        self.plan = plan


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="live rescale worker")
    parser.add_argument("--master-addr", required=True)
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True,
                        help="bootstrap world size (env NUM_PROCESSES)")
    parser.add_argument("--dataset", default="rescale")
    parser.add_argument("--dataset-size", type=int, required=True)
    parser.add_argument("--shard-size", type=int, default=16)
    parser.add_argument("--ckpt-dir", required=True)
    parser.add_argument("--ckpt-every", type=int, default=2)
    parser.add_argument("--events", required=True)
    parser.add_argument("--generation", type=int, default=0)
    parser.add_argument("--vec-len", type=int, default=VEC_LEN)
    parser.add_argument("--step-ms", type=float, default=0.0)
    parser.add_argument("--deadline-s", type=float, default=300.0)
    parser.add_argument("--device", default="cuda",
                        help="where the state lives: cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rescale worker: --device cuda but torch sees no CUDA device"
        )

    # Identity env BEFORE any framework import touches the runtime
    # context: the shm segment name keys on NODE_RANK, the checkpoint
    # proc files on PROCESS_ID.
    os.environ["DLROVER_TPU_NODE_RANK"] = str(args.rank)
    os.environ["DLROVER_TPU_PROCESS_ID"] = str(args.rank)
    os.environ["DLROVER_TPU_NUM_PROCESSES"] = str(args.world)
    os.environ["DLROVER_TPU_NODE_RANKS"] = ",".join(
        str(r) for r in range(args.world)
    )

    from dlrover_tpu_torch.fault import arm_from_env

    arm_from_env()

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.flash_ckpt import engine as engine_mod
    from dlrover_tpu_torch.flash_ckpt.engine import CheckpointEngine
    from dlrover_tpu_torch.testing.soak_worker import EventLog, state_crc
    from dlrover_tpu_torch.trainer.elastic.rescale import (
        BARRIER_READY,
        RescaleClient,
    )
    from dlrover_tpu_torch.trainer.elastic.sampler import (
        ElasticDistributedSampler,
    )
    from dlrover_tpu_torch.trainer.elastic.sharding_client import (
        ShardingClient,
    )
    from dlrover_tpu_torch.trainer.elastic.trainer import (
        ElasticBatchConfig,
        ElasticTrainer,
    )
    from dlrover_tpu_torch.trainer.runtime import get_context

    vec_len = args.vec_len
    deadline = time.monotonic() + args.deadline_s
    events = EventLog(args.events)
    if device.type == "cuda":
        torch.cuda.init()
    events.append(kind="worker_start", rank=args.rank,
                  generation=args.generation, pid=os.getpid(),
                  device=str(device),
                  device_name=(torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"))

    client = MasterClient(
        args.master_addr, node_id=args.rank, kind="http", timeout=10.0
    )
    rescale = RescaleClient(client, args.rank, poll_interval_s=0.02)
    engine = CheckpointEngine(args.ckpt_dir, standalone=True)
    ctx = get_context()
    ctx.process_id = args.rank

    batch_config = ElasticBatchConfig(
        # Every dp size 1..world must be legal so any scale-down world
        # can form: global = shard * lcm(1..world).
        global_batch_size=args.shard_size * world_lcm(args.world),
        micro_batch_per_device=args.shard_size,
    )
    trainer = ElasticTrainer(batch_config, dp_size=1, master_client=client,
                             report_interval_s=1.0)
    sampler = ElasticDistributedSampler(
        args.dataset_size, rank=0, world_size=1, shuffle=False
    )
    state = fresh_state(vec_len, device)
    step = 0
    sharding: Optional[ShardingClient] = None
    plan = None
    my_index = 0

    def kv_gather(keys: List[str], current_plan):
        """Poll the KV store until every key is set; abort to a newer
        plan the moment one is broadcast (a dead peer would otherwise
        wedge the gather forever)."""
        last_plan_poll = 0.0
        while True:
            values = client.kv_store_multi_get(keys)
            if len(values) >= len(keys):
                return values
            now = time.monotonic()
            if now - last_plan_poll > 0.1:
                last_plan_poll = now
                newer = rescale.poll_plan(current_plan.plan_id)
                if newer is not None:
                    raise _Aborted(newer)
            if now > deadline:
                raise TimeoutError("worker deadline during kv gather")
            time.sleep(0.02)

    def make_sharding_client() -> ShardingClient:
        return ShardingClient(
            client,
            dataset_name=args.dataset,
            dataset_size=args.dataset_size,
            shard_size=args.shard_size,
            prefetch_depth=4,
            fetch_batch=2,
            report_batch=2,
            report_interval_s=0.2,
            wait_backoff_s=0.05,
            wait_backoff_max_s=0.3,
        )

    def to_device(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(arr, dtype=np.int64)).to(device)

    def restore_at(plan_view):
        """Partial-restore this rank's NEW byte ranges at the plan step
        into device tensors, allgather peers' ranges over KV, rebuild the
        full replica."""
        nonlocal state, step
        world = plan_view.world_size
        k = plan_view.new_rank_index(args.rank)
        lo, hi = block_bounds(k, world, vec_len)
        t0 = time.monotonic()
        result = engine_mod.load_state_regions(
            args.ckpt_dir,
            plan_view.restore_step,
            regions_by_leaf={
                LEAF_OPT: [((lo, hi),)],
                LEAF_W: [((lo, hi),)],
            },
        )
        if result is None:
            events.append(kind="restore_failed", step=plan_view.restore_step,
                          plan=plan_view.plan_id)
            print("partial restore failed", file=sys.stderr)
            sys.exit(EXIT_INTEGRITY)
        _, leaves, user_meta = result
        read_bytes = sum(
            arr.nbytes for regions in leaves.values()
            for arr in regions.values()
        )
        my_w = to_device(leaves[LEAF_W][((lo, hi),)])
        my_opt = to_device(leaves[LEAF_OPT][((lo, hi),)])
        read_s = time.monotonic() - t0
        # Publish my block; gather everyone's — the KV store plays the
        # interconnect for the replica rebuild.
        client.kv_store_set(
            f"resh/{plan_view.plan_id}/{args.rank}",
            _encode({"lo": lo, "hi": hi, "w": my_w, "opt": my_opt}),
        )
        keys = [
            f"resh/{plan_view.plan_id}/{r}" for r in plan_view.rank_order
        ]
        values = kv_gather(keys, plan_view)
        new_state = fresh_state(vec_len, device)
        new_state["hist"].copy_(to_device(
            leaves[LEAF_HIST][((0, HIST_BUCKETS),)]))
        new_state["sum"].copy_(to_device(leaves[LEAF_SUM][()]))
        for key in keys:
            if key == f"resh/{plan_view.plan_id}/{args.rank}":
                block = {"lo": lo, "hi": hi, "w": my_w, "opt": my_opt}
            else:
                block = _decode(values[key])
                block["w"] = to_device(block["w"])
                block["opt"] = to_device(block["opt"])
            new_state["w"][block["lo"]:block["hi"]] = block["w"]
            new_state["opt"][block["lo"]:block["hi"]] = block["opt"]
        crc = state_crc(new_state)
        want = user_meta.get("state_crc")
        if crc != want:
            events.append(
                kind="restore_crc_mismatch", step=plan_view.restore_step,
                got=crc, want=want, plan=plan_view.plan_id,
            )
            print("restored state failed integrity check", file=sys.stderr)
            sys.exit(EXIT_INTEGRITY)
        state = new_state
        step = plan_view.restore_step
        if "sampler" in user_meta:
            sampler.load_state_dict(user_meta["sampler"])
        events.append(
            kind="restore", step=step, crc=crc, plan=plan_view.plan_id,
            generation=args.generation, bytes_read=read_bytes,
            block=[lo, hi], source="storage_partial",
            read_s=round(read_s, 4),
            seconds=round(time.monotonic() - t0, 4),
        )
        return user_meta

    def adopt_plan(new_plan):
        """Run the full worker-side rescale protocol for ``new_plan``.
        Returns the plan actually adopted (a barrier may surface an even
        newer one) or exits if this rank was evicted."""
        nonlocal plan, sharding, my_index, step
        while True:
            t_seen = time.monotonic()
            if not new_plan.includes(args.rank):
                if sharding is not None:
                    sharding.pause_for_rescale()
                events.append(kind="evicted", plan=new_plan.plan_id,
                              rank=args.rank)
                engine.close()
                sys.exit(EXIT_EVICTED)
            if sharding is not None:
                sharding.pause_for_rescale()
            rescale.ack(new_plan.plan_id, "barrier")
            outcome = rescale.wait_barrier(
                new_plan.plan_id, "barrier",
                timeout_s=new_plan.barrier_timeout_s + 15.0,
            )
            if outcome != BARRIER_READY:
                # An expiry may find NO legal replacement world — the
                # coordinator then holds the expired plan until a rejoin
                # restores legality (docs/DESIGN.md §27). Dying here
                # would take the whole job down exactly when the
                # protocol says to wait; keep polling for the
                # superseding plan — the soak watchdog bounds us.
                got = None
                while got is None:
                    got = rescale.wait_for_plan(
                        new_plan.plan_id, timeout_s=30.0
                    )
                new_plan = got
                continue
            t_barrier = time.monotonic()
            # Adopt the new world in the runtime context so checkpoint
            # persist/commit expects exactly the new membership.
            ctx.num_processes = new_plan.world_size
            ctx.node_ranks = tuple(new_plan.rank_order)
            my_index = new_plan.new_rank_index(args.rank)
            designated = args.rank == min(new_plan.world)
            try:
                if new_plan.restore_step >= 0:
                    user_meta = restore_at(new_plan)
                    if sharding is None:
                        sharding = make_sharding_client()
                    if designated:
                        # Rewind the master's dataset cursor to the shard
                        # snapshot matching the restored state: shards
                        # consumed after the restore step are re-queued,
                        # shards done before it never replay.
                        sharding.restore_shard_checkpoint(
                            user_meta.get("shard_ckpt", "")
                        )
                else:
                    # Bootstrap: fresh state + an initial committed
                    # checkpoint so any later rescale has a (state,
                    # snapshot) pair to rewind to. EVERY rank saves —
                    # the commit leader waits for every node's shard
                    # marker before advancing the tracker.
                    if sharding is None:
                        sharding = make_sharding_client()
                    if step == 0:
                        save_checkpoint(new_plan, bootstrap=True)
                t_restore = time.monotonic()
                rescale.ack(new_plan.plan_id, "restored")
                outcome = rescale.wait_barrier(
                    new_plan.plan_id, "restored",
                    timeout_s=new_plan.barrier_timeout_s + 15.0,
                )
            except _Aborted as a:
                new_plan = a.plan
                continue
            if outcome != BARRIER_READY:
                # Same as the 'barrier' phase above: an expiry with no
                # legal replacement world means WAIT for the rejoin
                # re-plan, not die — the watchdog bounds us.
                got = None
                while got is None:
                    got = rescale.wait_for_plan(
                        new_plan.plan_id, timeout_s=30.0
                    )
                new_plan = got
                continue
            t_ready = time.monotonic()
            trainer.rescale(new_plan.world_size)
            sampler.rescale(my_index, new_plan.world_size)
            if sharding is not None:
                sharding.resume_after_rescale()
            plan = new_plan
            # Ledger entry BEFORE the resume ack: a kill in the
            # restore-to-first-step window must not erase the evidence
            # that the rescale itself completed.
            events.append(
                kind="rescale", plan=new_plan.plan_id,
                world=list(new_plan.rank_order),
                restore_step=new_plan.restore_step,
                reason=new_plan.reason,
                plan_created_at=new_plan.created_at,
                barrier_s=round(t_barrier - t_seen, 4),
                restore_s=round(t_restore - t_barrier, 4),
                restored_wait_s=round(t_ready - t_restore, 4),
                total_s=round(time.monotonic() - t_seen, 4),
                generation=args.generation,
            )
            rescale.mark_resumed(new_plan.plan_id)
            return plan

    def save_checkpoint(plan_view, bootstrap=False):
        """Lockstep cadence save: all ranks flush, agree via KV, the
        designated rank snapshots the shard cursor, everyone persists
        the SAME step and the leader commits."""
        designated = args.rank == min(plan_view.world)
        if not bootstrap:
            flushed_ok = True
            try:
                sharding.flush_reports()
                with sharding._report_lock:  # noqa: SLF001
                    flushed_ok = not (
                        sharding._pending_done or sharding._pending_failed
                    )
            except Exception:
                flushed_ok = False
            client.kv_store_set(
                f"ckok/{plan_view.plan_id}/{step}/{args.rank}",
                b"1" if flushed_ok else b"0",
            )
            values = kv_gather(
                [
                    f"ckok/{plan_view.plan_id}/{step}/{r}"
                    for r in plan_view.rank_order
                ],
                plan_view,
            )
            if any(v != b"1" for v in values.values()):
                # Someone could not flush: refusing the checkpoint is
                # the correct degraded behavior (a snapshot over stale
                # accounting would bake a replay in). Retry next tick.
                events.append(kind="ckpt_refused", step=step,
                              plan=plan_view.plan_id)
                return
        key = f"snap/{plan_view.plan_id}/{step}"
        if designated:
            snap = (
                sharding.get_shard_checkpoint() if sharding is not None
                else ""
            )
            client.kv_store_set(key, json.dumps({"snap": snap}).encode())
        else:
            values = kv_gather([key], plan_view)
            snap = json.loads(values[key].decode())["snap"]
        crc = state_crc(state)
        engine.save_to_storage(
            step, state,
            user_meta={
                "state_crc": crc,
                "shard_ckpt": snap,
                "sampler": sampler.state_dict(),
            },
        )
        committed = engine._last_disk_step == step  # noqa: SLF001
        if designated and committed:
            client.report_ckpt_step(step, committed=True)
        events.append(kind="save", step=step, crc=crc, snapshot=snap,
                      committed=bool(committed), plan=plan_view.plan_id,
                      generation=args.generation)

    # ---- bootstrap ---------------------------------------------------------

    rescale.join(local_world_size=1)
    first = rescale.wait_for_plan(-1, timeout_s=60.0)
    if first is None:
        print("no rescale plan within 60s", file=sys.stderr)
        return 1
    try:
        adopt_plan(first)
    except _Aborted as a:
        adopt_plan(a.plan)
    trainer.global_step = step
    trainer.start_training()

    # ---- lockstep training loop -------------------------------------------

    it = 0
    while True:
        if time.monotonic() > deadline:
            print("worker deadline exceeded", file=sys.stderr)
            return 1
        newer = rescale.poll_plan(plan.plan_id)
        if newer is not None:
            try:
                adopt_plan(newer)
            except _Aborted as a:
                adopt_plan(a.plan)
            it = 0
            continue
        status, task = sharding.poll_task(timeout_s=0.1)
        if status == "task":
            payload = contribution_payload(
                shard_contribution(task.start, task.end, vec_len, device),
                task.start, task.end)
        elif status == "end":
            payload = {"kind": "end"}
        else:
            payload = {"kind": "idle"}
        it += 1
        client.kv_store_set(
            f"ar/{plan.plan_id}/{it}/{args.rank}", _encode(payload)
        )
        try:
            values = kv_gather(
                [f"ar/{plan.plan_id}/{it}/{r}" for r in plan.rank_order],
                plan,
            )
        except _Aborted as a:
            adopt_plan(a.plan)
            it = 0
            continue
        contribs = [
            _decode(values[f"ar/{plan.plan_id}/{it}/{r}"])
            for r in plan.rank_order
        ]
        if all(c["kind"] == "end" for c in contribs):
            break
        applied = [c for c in contribs if c["kind"] == "c"]
        if not applied:
            time.sleep(0.02)
            continue
        t_step = time.time()
        records = 0
        for c in applied:
            apply_contribution(
                state, contribution_from_payload(c, vec_len, device))
            records += c["range"][1] - c["range"][0]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if args.step_ms > 0:
            time.sleep(args.step_ms / 1e3)
        if status == "task":
            sharding.report_task_done(task)
        sampler.record_batch(records)
        trainer.global_step = step  # keep the crash-site step ctx exact
        trainer.step_completed(steps=1)
        step += 1
        events.append(
            kind="step", step=step, dur=time.time() - t_step,
            plan=plan.plan_id, world=len(plan.world),
            shards=[c["range"] for c in applied],
            generation=args.generation,
        )
        if step % max(args.ckpt_every, 1) == 0:
            try:
                save_checkpoint(plan)
            except _Aborted as a:
                adopt_plan(a.plan)
                it = 0
                continue

    sharding.stop()
    final = {
        "sum": int(state["sum"]),
        "hist": state["hist"].tolist(),
        "steps": step,
        "rank": args.rank,
        "generation": args.generation,
        "crc": state_crc(state),
        "plan": plan.plan_id,
        "world": len(plan.world),
    }
    events.append(kind="done", **final)
    engine.close()
    return EXIT_OK


if __name__ == "__main__":
    raise SystemExit(main())
