"""Seeded chaos-soak CLI: drive the whole stack through reproducible
fault episodes and assert the system invariants.

    python tools/torch_chaos_soak.py --seed 0 --episodes 3
    python tools/torch_chaos_soak.py --seed 0 --episode 1      # repro one
    python tools/torch_chaos_soak.py --seed 0 --episode 3      # rescale kill
    python tools/torch_chaos_soak.py --seed 0 --episode 7      # master kill
    python tools/torch_chaos_soak.py --device cpu --episode 0  # no card
    python tools/torch_chaos_soak.py --episode 4 --fleet-config flagship
    python tools/torch_chaos_soak.py --device cpu --episode 5  # autoscaler

Each episode runs a master, worker subprocesses and a serving engine
under a deterministic seeded fault schedule (worker SIGKILL mid-step,
dropped RPC replies, torn checkpoint shard writes, serving step errors,
SIGKILL mid-live-rescale, SIGKILL of the master between a journaled
dispatch and its reply, SIGKILL of a serving replica mid-decode or
holding an unacked KV import, a delayed straggler the autoscaler must
evict). The worker's state, the serving engine and the fleet episodes'
replicas live on ``--device`` (``cuda`` by default); the replicas serve
``--fleet-config`` (``tiny`` by default, or ``flagship``). The autoscaler's
episode (5) simulates its cluster on the host. The implementation and the
invariant definitions live in ``dlrover_tpu_torch/testing/soak.py``;
exit code 0 means every episode held every invariant. Prints one JSON
summary line with goodput fraction and per-fault MTTR.

The port's copy of ``tools/chaos_soak.py``, with ``--device`` and
``--fleet-config``. Every episode kind (0–7) runs.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dlrover_tpu_torch.testing.soak import (  # noqa: E402
    SoakConfig,
    SoakInvariantError,
    run_soak,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="seeded chaos soak")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--episodes", type=int, default=3,
        help="episode count; 3 covers the worker SIGKILL, the dropped "
        "replies, the torn shard write and the serving step error",
    )
    parser.add_argument(
        "--episode", type=int, default=None,
        help="run only this episode index (repro mode)",
    )
    parser.add_argument("--dataset-size", type=int, default=512)
    parser.add_argument("--shard-size", type=int, default=16)
    parser.add_argument("--watchdog-s", type=float, default=180.0)
    parser.add_argument("--no-serving", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="where the worker state and the serving "
                        "engine live: cuda (default) or cpu")
    parser.add_argument("--fleet-config", default="tiny",
                        choices=("tiny", "flagship"),
                        help="the model the fleet episodes' replicas "
                        "serve")
    parser.add_argument("--work-dir", default=None,
                        help="the episodes' work directory (default: a "
                        "new temporary one)")
    parser.add_argument(
        "--artifact-dir", default=None,
        help="where failure evidence lands (default: under the work dir)",
    )
    parser.add_argument(
        "--keep-artifacts", action="store_true",
        help="keep episode dirs even on success",
    )
    args = parser.parse_args(argv)
    cfg = SoakConfig(
        dataset_size=args.dataset_size,
        shard_size=args.shard_size,
        watchdog_s=args.watchdog_s,
        serve=not args.no_serving,
        keep_artifacts_on_success=args.keep_artifacts,
        device=args.device,
        fleet_config=args.fleet_config,
    )
    try:
        summary = run_soak(
            seed=args.seed,
            episodes=args.episodes,
            episode=args.episode,
            cfg=cfg,
            work_dir=args.work_dir,
            artifact_dir=args.artifact_dir,
        )
    except SoakInvariantError as e:
        # run_episode printed the repro command (and for most kinds the
        # failure and the artifact dir); the autoscaler's kind prints
        # only the repro, so the broken invariant goes to stderr here.
        print(f"soak invariant failed: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
