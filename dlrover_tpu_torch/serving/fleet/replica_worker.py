"""Fleet replica subprocess: one serving engine of the port behind
stdin/stdout JSONL (port of ``dlrover_tpu/serving/fleet/replica_worker.py``).

Spawned (and respawned after every crash) by
:class:`dlrover_tpu_torch.serving.fleet.replica.SubprocessReplica`:
fault schedules arm from ``DLROVER_TPU_FAULT_SCHEDULE``, fired
injections append (fsynced) to ``DLROVER_TPU_FAULT_TRACE`` BEFORE
acting, so even this process's own SIGKILL leaves its trace entry
behind.

    python -m dlrover_tpu_torch.serving.fleet.replica_worker \\
        --config flagship --device cuda --paged --slots 16 ...

Protocol (one JSON object per line):

- stdin:  ``{"op": "submit", "request_id", "attempt", "prompt",
  "max_new_tokens", "temperature", "deadline_s"}`` | ``{"op": "stop"}``
  | the migration ops ``import`` / ``export`` / ``release``
  (see :mod:`dlrover_tpu_torch.serving.fleet.replica`)
- stdout: ``{"kind": "ready"}`` once warm, ``{"kind": "heartbeat"}``
  every ``--heartbeat-s`` while serving, one ``{"kind": "done",
  ...}`` completion per accepted (request, attempt) — ok, explicitly
  failed, or shed; never silence — plus ``exported`` / ``imported``
  migration events when serving the paged engine.

The model is ``--config`` (``tiny``, the reference's, or the 334M
``flagship``) with weights from ``init_params`` and a generator on
``--device`` seeded 0, so every replica of a fleet on one kind of
device serves identical weights and a re-routed greedy request decodes
the same tokens on its new replica. ``--device cuda`` without a card
exits non-zero; the worker never falls back to the CPU.
"""

import argparse
import json
import os
import queue
import sys
import threading
import time


def _emit(obj: dict) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _read_commands(q: "queue.Queue[dict]") -> None:
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            q.put(json.loads(line))
        except ValueError:
            continue
    q.put({"op": "stop"})  # parent closed the pipe


CONFIGS = ("tiny", "flagship")


def main(argv=None) -> int:
    from dlrover_tpu_torch.serving.scheduler import (
        FLEET_SLO_CLASSES,
        parse_slo_classes,
    )

    parser = argparse.ArgumentParser(description="fleet replica worker")
    parser.add_argument("--replica-id", default="0")
    parser.add_argument("--slots", type=int, default=2)
    parser.add_argument("--max-len", type=int, default=64)
    parser.add_argument("--prefill-chunk", type=int, default=8)
    parser.add_argument("--heartbeat-s", type=float, default=0.2)
    parser.add_argument(
        "--paged", action="store_true",
        help="serve from the paged block-table engine "
        "(serving/kvpool) instead of the flat slot pool; heartbeats "
        "then carry allocator stats for the block-reclaim invariant",
    )
    parser.add_argument("--block-size", type=int, default=8)
    parser.add_argument(
        "--num-blocks", type=int, default=0,
        help="managed pool size (0 = flat-equivalent: "
        "slots*max_len/block_size + sentinel)",
    )
    parser.add_argument(
        "--slo-classes",
        default=",".join(
            f"{c.name}:{c.weight:g}" for c in FLEET_SLO_CLASSES
        ),
        help='SLO classes as "name:weight,..."; first is the default '
        "for untagged requests. The default is scheduler."
        "FLEET_SLO_CLASSES — a stock replica understands the "
        "conventional interactive/batch split so tagged fleet "
        "traffic is never rejected at the scheduler",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="where the engine runs: cuda (the default; exits when "
        "torch sees no card) or cpu",
    )
    parser.add_argument(
        "--config", default="tiny", choices=CONFIGS,
        help="the model: tiny (the reference's CPU model) or flagship "
        "(334M, bf16)",
    )
    args = parser.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("replica worker: --device cuda but torch sees no CUDA "
              "device", file=sys.stderr, flush=True)
        return 2

    from dlrover_tpu_torch.fault import arm_from_env, fault_point
    from dlrover_tpu_torch.observability import tracing

    arm_from_env()
    # Same env-rigging pattern for tracing: DLROVER_TPU_TRACE_FILE set
    # by the parent replica handle when the router process traces.
    tracing.arm_from_env(service=f"replica{args.replica_id}")

    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import decode_attention
    from dlrover_tpu_torch.serving.engine import ServingEngine
    from dlrover_tpu_torch.serving.fleet.replica import (
        serve_control,
        serve_exports,
        serve_step,
        serve_submit,
    )

    cfg = (llama.flagship_config() if args.config == "flagship"
           else llama.tiny_config())
    params = llama.init_params(
        cfg, torch.Generator(args.device).manual_seed(0),
        device=args.device,
    )
    slo_classes = parse_slo_classes(args.slo_classes)
    if args.paged:
        from dlrover_tpu_torch.serving.kvpool import PagedServingEngine

        engine = PagedServingEngine(
            cfg, params,
            slots=args.slots,
            max_len=args.max_len,
            prefill_chunk=args.prefill_chunk,
            block_size=args.block_size,
            num_blocks=args.num_blocks or None,
            slo_classes=slo_classes,
            device=args.device,
        )
    else:
        engine = ServingEngine(
            cfg, params,
            slots=args.slots,
            max_len=args.max_len,
            prefill_chunk=args.prefill_chunk,
            slo_classes=slo_classes,
            device=args.device,
        )
    del params  # the engine holds its decode copy
    engine.warmup()

    commands: "queue.Queue[dict]" = queue.Queue()
    reader = threading.Thread(
        target=_read_commands, args=(commands,), daemon=True
    )
    reader.start()

    # The ready line names the device the engine's weights live on, and
    # every heartbeat carries this process's decode-kernel launches.
    _emit({"kind": "ready", "replica": args.replica_id,
           "pid": os.getpid(), "device": str(engine.device)})
    by_rid = {}  # engine rid -> (request_id, attempt)
    migrate_rids = set()  # engine rids flagged for post-prefill export
    last_hb = 0.0
    while True:
        now = time.monotonic()
        if now - last_hb >= args.heartbeat_s:
            try:
                fault_point(
                    "fleet.health.heartbeat", replica=args.replica_id
                )
                beat = {"kind": "heartbeat", "replica": args.replica_id,
                        "launches": dict(decode_attention.launch_counts)}
                if args.paged:
                    # Allocator accounting rides every beat so block
                    # conservation is checkable THROUGH a crash: the
                    # parent validates at receipt, and a SIGKILLed
                    # replica's last-known stats survive it.
                    beat["kv"] = engine.kv_stats()
                _emit(beat)
                last_hb = now
            except Exception:
                last_hb = now  # dropped beat; try again next window
        try:
            cmd = commands.get(
                timeout=0.0 if engine.pending() else 0.02
            )
        except queue.Empty:
            cmd = None
        if cmd is not None:
            if cmd.get("op") == "stop":
                return 0
            if cmd.get("op") == "submit":
                req = serve_submit(
                    engine, by_rid, _emit,
                    cmd["request_id"], cmd.get("attempt", 0),
                    cmd["prompt"], cmd["max_new_tokens"],
                    cmd.get("temperature", 0.0), cmd.get("deadline_s"),
                    trace=cmd.get("trace"),
                    slo_class=cmd.get("slo_class"),
                )
                if req is not None and cmd.get("migrate_after_prefill"):
                    migrate_rids.add(req.rid)
            elif cmd.get("op") in ("import", "export", "release"):
                if cmd["op"] == "import":
                    # The kill-during-migration window: the payload has
                    # left the source (export done) and no import ack
                    # has been emitted — a ``crash`` rule here SIGKILLs
                    # the destination holding the bytes. The source was
                    # never released, so it must still complete the
                    # request exactly once with zero blocks lost on
                    # either end.
                    fault_point(
                        "fleet.replica.import", replica=args.replica_id
                    )
                serve_control(engine, by_rid, _emit, migrate_rids, cmd)
        if engine.pending():
            # A ``crash`` rule on fleet.replica.step fires between two
            # engine iterations with requests live in slots; a ``delay``
            # rule slows the replica down.
            fault_point("fleet.replica.step", replica=args.replica_id)
            serve_step(engine, by_rid, _emit)
        serve_exports(engine, by_rid, _emit, migrate_rids)


if __name__ == "__main__":
    raise SystemExit(main())
