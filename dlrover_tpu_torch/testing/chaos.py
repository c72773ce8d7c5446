"""Operational chaos / fault-injection harness.

Parity: reference examples/pytorch/mnist/start_chaos.sh:18-30 (the
kill-a-random-worker loop used to demo fault tolerance on a live
deployment). Three injection surfaces:

- ``local``: find the job's worker processes on this host (by the
  DLROVER_TPU_* env the agent injects) and SIGKILL one per interval —
  drives the agent's restart/rendezvous/flash-restore path on a real
  run, exactly like a host fault.
- ``k8s``: delete a random worker pod of the job through the K8sApi —
  drives the master's relaunch path (and block relaunch when
  node groups are on).
- probe rigging (env, no CLI): DLROVER_TPU_CHAOS_CHECK_FAIL_RANKS /
  _SLOW_RANKS make specific ranks fail or straggle the network check
  (agent/node_check_worker.py), driving bisection/eviction.

Usage::

    python -m dlrover_tpu_torch.testing.chaos --job myjob --interval 60

The port's copy of ``dlrover_tpu/testing/chaos.py``.
"""

import argparse
import os
import random
import signal
import time
from typing import List, Optional, Tuple

from dlrover_tpu_torch.common.constants import NodeEnv, WorkerEnv
from dlrover_tpu_torch.common.log import logger


def _read_environ(pid: str) -> dict:
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            raw = f.read()
    except OSError:
        return {}
    env = {}
    for entry in raw.split(b"\0"):
        if b"=" in entry:
            k, _, v = entry.partition(b"=")
            env[k.decode(errors="replace")] = v.decode(errors="replace")
    return env


def find_local_workers(job_name: str) -> List[Tuple[int, int]]:
    """(pid, process_id) of the job's training workers on this host.
    Workers are the processes carrying the agent-injected PROCESS_ID;
    the agent/master themselves don't, so they are never targets."""
    me = os.getpid()
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == me:
            continue
        env = _read_environ(pid)
        if env.get(NodeEnv.JOB_NAME) != job_name:
            continue
        if WorkerEnv.PROCESS_ID not in env:
            continue
        out.append((int(pid), int(env[WorkerEnv.PROCESS_ID])))
    return sorted(out)


def kill_one_local(job_name: str, sig: int = signal.SIGKILL) -> Optional[int]:
    workers = find_local_workers(job_name)
    if not workers:
        logger.info("chaos: no local workers of job %s found", job_name)
        return None
    pid, proc_id = random.choice(workers)
    logger.warning(
        "chaos: killing worker process_id=%d pid=%d (sig %d)",
        proc_id,
        pid,
        sig,
    )
    try:
        os.kill(pid, sig)
        return pid
    except ProcessLookupError:
        return None


def delete_one_pod(
    job_name: str, namespace: str = "default", api=None
) -> Optional[str]:
    """Delete a random running worker pod of the job (the reference's
    k8s surface)."""
    from dlrover_tpu_torch.master.scheduler.k8s_client import get_k8s_api

    api = api or get_k8s_api()
    pods = [
        p["metadata"]["name"]
        for p in api.list_pods(namespace, f"job-name={job_name}")
        if p.get("metadata", {}).get("labels", {}).get("role")
        != "dlrover-master"
        and p.get("status", {}).get("phase") == "Running"
    ]
    if not pods:
        logger.info("chaos: no running worker pods of %s", job_name)
        return None
    victim = random.choice(pods)
    logger.warning("chaos: deleting pod %s", victim)
    api.delete_pod(namespace, victim)
    return victim


def run_chaos(
    job_name: str,
    mode: str = "local",
    interval_s: float = 60.0,
    rounds: int = 0,
    namespace: str = "default",
    seed: Optional[int] = None,
):
    """Kill loop: one victim per interval; rounds=0 runs forever."""
    if seed is not None:
        random.seed(seed)
    n = 0
    while rounds <= 0 or n < rounds:
        if mode == "k8s":
            delete_one_pod(job_name, namespace)
        else:
            kill_one_local(job_name)
        n += 1
        if rounds > 0 and n >= rounds:
            break
        time.sleep(interval_s)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="chaos harness")
    parser.add_argument("--job", required=True, help="job name to attack")
    parser.add_argument("--mode", choices=["local", "k8s"], default="local")
    parser.add_argument("--interval", type=float, default=60.0)
    parser.add_argument(
        "--rounds", type=int, default=0, help="0 = run until stopped"
    )
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)
    run_chaos(
        args.job,
        mode=args.mode,
        interval_s=args.interval,
        rounds=args.rounds,
        namespace=args.namespace,
        seed=args.seed,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
