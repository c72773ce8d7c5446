"""The elastic agent: per-node supervisor of worker processes.

Parity: reference dlrover/python/elastic_agent/torch/training.py
(ElasticTrainingAgent:648, _invoke_run:1247, _initialize_workers:1073).
Re-designed as a plain process supervisor: torchelastic's WorkerGroup
machinery is replaced by direct subprocess management, because on TPU a
re-mesh requires restarting worker *processes* anyway
(``jax.distributed`` cannot re-initialize in-process).

Run states per monitor tick:
- all workers exited 0     -> exit barrier, report success, done
- any worker failed        -> breakpoint-save signal, restart-or-raise
- membership change wanted -> graceful stop, new rendezvous, restart
- otherwise                -> heartbeat (executing piggy-backed diagnosis
                              actions), resource report

The port's copy of ``dlrover_tpu/agent/training.py``, the warm standby
(``WorkerSpec.warm_standby``, ``agent/standby.py``) included. Under
``DLROVER_TPU_TIMER_XLA`` the workers' PYTHONPATH starts with the
capture injection (``tpu_timer/_inject``). The post-mortem stop sends
SIGUSR2 for the worker's Python stacks (the port's ``init_distributed``
registers the dump) and appends every live worker's native stacks
(``tpu_timer/native_stack``, at most 12 s, the sampler prebuilt when
the agent starts) to its log, or to the agent's stderr where the
worker's output goes when it is not redirected. Beyond the reference,
a live worker whose hang watchdog writes a hang dump has its native
stacks appended the same way, once per dump, without stopping it: the
sampler seizes each thread (``PTRACE_SEIZE``) and queues nothing on
it, so a thread wedged in the kernel is skipped and a sampler killed at
its timeout leaves the worker running. (The reference's post-mortem
stop reaches a hung worker only once the master's hang diagnostician
escalates, after minutes.) On
a worker failure the agent reports the failed workers' flight-recorder
crash dumps and hang-watchdog stack dumps of the current incarnation to
the master.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.rendezvous import (
    MasterRendezvousHandler,
    RendezvousEvictedError,
    RendezvousOutcome,
    RendezvousTimeoutError,
)
from dlrover_tpu_torch.common.constants import (
    DiagnosisActionType,
    GoodputPhase,
    JobConstant,
    RendezvousName,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.env_utils import worker_env
from dlrover_tpu_torch.common.log import logger


class RunResult(Enum):
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    RELAUNCH = "relaunch"  # ask the cluster layer for a new node


@dataclass
class WorkerSpec:
    entrypoint: str  # path to the training script, or "-m module"
    args: List[str] = field(default_factory=list)
    nproc_per_node: int = 1
    max_restarts: int = 3
    node_rank: int = 0
    node_unit: int = 1
    rdzv_name: str = RendezvousName.TRAINING
    join_timeout: float = 600.0
    monitor_interval: float = 1.0
    env: Dict[str, str] = field(default_factory=dict)
    redirect_output: Optional[str] = None  # dir for per-worker logs
    # Keep a pre-spawned interpreter (python + framework imports
    # already paid) and adopt it as the next incarnation on restart:
    # cuts restart latency by the import cost (agent/standby.py).
    warm_standby: bool = False


@dataclass
class _Worker:
    local_rank: int
    process: subprocess.Popen
    log_file: Optional[object] = None


class ElasticAgent:
    """Supervises one node's worker processes across elastic restarts."""

    def __init__(
        self,
        spec: WorkerSpec,
        client: MasterClient,
        ckpt_saver=None,
        diagnosis_agent=None,
    ):
        self._spec = spec
        self._client = client
        if diagnosis_agent is None:
            from dlrover_tpu_torch.agent.diagnosis_agent import DiagnosisAgent

            log_path = ""
            if spec.redirect_output:
                log_path = os.path.join(
                    spec.redirect_output, f"worker-{spec.node_rank}-0.log"
                )
            diagnosis_agent = DiagnosisAgent(
                master_client=client,
                node_id=spec.node_rank,
                log_path=log_path,
            )
        self._diagnosis_agent = diagnosis_agent
        self._rdzv = MasterRendezvousHandler(
            client,
            spec.node_rank,
            spec.nproc_per_node,
            rdzv_name=spec.rdzv_name,
            node_unit=spec.node_unit,
            join_timeout=spec.join_timeout,
        )
        self._workers: List[_Worker] = []
        self._standby: Optional[subprocess.Popen] = None
        self._standby_log = None
        self._breakpoint_thread: Optional[threading.Thread] = None
        self._restart_count = 0
        self._ckpt_saver = ckpt_saver
        self._last_heartbeat = 0.0
        self._last_resource_report = 0.0
        self._current_outcome: Optional[RendezvousOutcome] = None
        self._stopping = False
        self._workers_started_at = 0.0
        # local rank -> mtime of the hang dump whose native stacks were
        # taken (``_sample_hung_workers``).
        self._hang_sampled: Dict[int, float] = {}
        from dlrover_tpu_torch.observability.registry import default_registry

        registry = default_registry()
        self._restarts_counter = registry.counter(
            "agent_worker_restarts_total",
            "worker restarts performed by this agent",
        )
        self._failures_counter = registry.counter(
            "agent_worker_failures_total",
            "worker failures observed by this agent",
        )

    # ---- worker lifecycle --------------------------------------------------

    def _initialize_workers(self) -> RendezvousOutcome:
        from dlrover_tpu_torch.training_event import AgentEvents

        rdzv_start = time.time()
        with AgentEvents.rendezvous({"node_rank": self._spec.node_rank}):
            outcome = self._rdzv.next_rendezvous()
        self._client.report_goodput_phase(
            GoodputPhase.RENDEZVOUS, rdzv_start, time.time()
        )
        self._current_outcome = outcome
        if self._ckpt_saver is not None:
            self._ckpt_saver.set_world(outcome.world)
        self._start_workers(outcome)
        return outcome

    def _start_workers(self, outcome: RendezvousOutcome):
        from dlrover_tpu_torch.training_event import AgentEvents

        spec = self._spec
        with AgentEvents.start_workers(self._restart_count) as span:
            self._start_workers_inner(outcome, spec)
            span.content["num_workers"] = len(self._workers)

    def _base_worker_env(self, spec) -> Dict[str, str]:
        """Environment shared by every incarnation (and by standbys):
        everything except the rendezvous-outcome values."""
        # Workers must be able to import this framework even when the
        # launcher was started from a different cwd/PYTHONPATH.
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env = dict(os.environ)
        existing = env.get("PYTHONPATH", "")
        if pkg_root not in existing.split(os.pathsep):
            env["PYTHONPATH"] = (
                f"{existing}{os.pathsep}{pkg_root}" if existing else pkg_root
            )
        env.update(spec.env)
        # Gate AFTER merging spec.env (the launcher may enable the
        # flag there). Zero-cooperation profiling: when the capture is
        # enabled, the injection dir's sitecustomize arms the listener
        # at interpreter startup even if the train script never imports
        # this framework (reference xpu_timer's LD_PRELOAD contract).
        # It chain-loads any sitecustomize it shadows.
        from dlrover_tpu_torch.common.env_utils import env_bool

        if env_bool(env, "DLROVER_TPU_TIMER_XLA"):
            inject_dir = os.path.join(
                pkg_root, "dlrover_tpu_torch", "tpu_timer", "_inject"
            )
            env["PYTHONPATH"] = (
                f"{inject_dir}{os.pathsep}" + env["PYTHONPATH"]
            )
        return env

    def _outcome_env(
        self, outcome: RendezvousOutcome, local_rank: int, spec
    ) -> Dict[str, str]:
        return worker_env(
            coordinator=outcome.coordinator_address,
            num_processes=outcome.num_processes,
            process_id=outcome.process_id_base + local_rank,
            local_rank=local_rank,
            local_world_size=spec.nproc_per_node,
            restart_count=self._restart_count,
            rdzv_round=outcome.round,
            node_ranks=list(outcome.world),
            num_slices=outcome.num_slices,
        )

    def _worker_argv(self, spec) -> tuple:
        """(argv-after-python, module-or-None) for the entrypoint."""
        if spec.entrypoint.startswith("-m "):
            module = spec.entrypoint[3:].strip()
            return [module, *spec.args], module
        return [spec.entrypoint, *spec.args], None

    def _open_worker_log(self, spec, local_rank: int):
        if not spec.redirect_output:
            return None
        os.makedirs(spec.redirect_output, exist_ok=True)
        path = os.path.join(
            spec.redirect_output,
            f"worker-{spec.node_rank}-{local_rank}.log",
        )
        return open(path, "ab")

    def _start_workers_inner(self, outcome: RendezvousOutcome, spec):
        self._workers = []
        self._workers_started_at = time.time()
        for local_rank in range(spec.nproc_per_node):
            env = self._base_worker_env(spec)
            env.update(self._outcome_env(outcome, local_rank, spec))
            argv, module = self._worker_argv(spec)
            adopted = (
                local_rank == 0
                and self._adopt_standby(env, argv, module)
            )
            if adopted:
                proc, log_file = adopted
            else:
                if module is not None:
                    cmd = [sys.executable, "-m", *argv]
                else:
                    cmd = [sys.executable, *argv]
                log_file = self._open_worker_log(spec, local_rank)
                stdout = stderr = log_file
                proc = subprocess.Popen(
                    cmd,
                    env=env,
                    stdout=stdout,
                    stderr=stderr,
                    start_new_session=True,
                )
            self._workers.append(_Worker(local_rank, proc, log_file))
            logger.info(
                "started worker local_rank=%d pid=%d process_id=%d%s",
                local_rank,
                proc.pid,
                outcome.process_id_base + local_rank,
                " (adopted warm standby)" if adopted else "",
            )
        if spec.warm_standby and spec.nproc_per_node == 1:
            self._spawn_standby(spec)

    # ---- warm standby ------------------------------------------------------

    def _spawn_standby(self, spec):
        """Pre-spawn the NEXT incarnation's interpreter so a restart
        skips the python + ``import torch`` cost (agent/standby.py).
        The standby blocks on stdin; it never touches the card until
        adopted."""
        if self._standby is not None and self._standby.poll() is None:
            return
        self._standby_log = self._open_worker_log(spec, 0)
        try:
            self._standby = subprocess.Popen(
                [sys.executable, "-m", "dlrover_tpu_torch.agent.standby"],
                env=self._base_worker_env(spec),
                stdin=subprocess.PIPE,
                stdout=self._standby_log,
                stderr=self._standby_log,
                start_new_session=True,
            )
            logger.info("warm standby spawned pid=%d", self._standby.pid)
        except OSError:
            logger.warning("standby spawn failed", exc_info=True)
            self._standby = None

    def _adopt_standby(self, env, argv, module):
        """Hand the final env/argv to a live standby; returns
        (process, log_file) or None (no/dead standby -> cold spawn)."""
        standby, log_file = self._standby, self._standby_log
        self._standby = self._standby_log = None
        if standby is None:
            if log_file:  # spawn-failed leftovers must not leak the fd
                log_file.close()
            return None
        if standby.poll() is not None:
            if log_file:
                log_file.close()
            return None
        try:
            line = json.dumps({"env": env, "argv": argv, "module": module})
            standby.stdin.write(line.encode() + b"\n")
            standby.stdin.flush()
            standby.stdin.close()
        except (OSError, ValueError):
            logger.warning("standby adoption failed; cold spawn",
                           exc_info=True)
            try:
                standby.kill()
            except OSError:
                pass
            if log_file:
                log_file.close()
            return None
        return standby, log_file

    def _close_standby(self):
        standby, log_file = self._standby, self._standby_log
        self._standby = self._standby_log = None
        if standby is not None and standby.poll() is None:
            try:
                standby.stdin.close()  # EOF -> clean exit
                standby.wait(timeout=5.0)
            except (OSError, subprocess.TimeoutExpired):
                try:
                    standby.kill()
                except OSError:
                    pass
        if log_file:
            log_file.close()

    def _stop_workers(self, timeout: float = 15.0, post_mortem: bool = False):
        if post_mortem:
            # Failure/hang stop: SIGUSR2 makes workers dump all-thread
            # PYTHON stacks into their logs (a worker wedged in a
            # collective tells us where), then a grace period lets
            # faulthandler finish writing before SIGTERM lands.
            dumped = False
            for w in self._workers:
                if w.process.poll() is None:
                    try:
                        os.kill(w.process.pid, signal.SIGUSR2)
                        dumped = True
                    except (ProcessLookupError, OSError):
                        pass
            if dumped:
                time.sleep(0.5)
            self._capture_native_stacks()
        for w in self._workers:
            if w.process.poll() is None:
                try:
                    os.killpg(w.process.pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
        deadline = time.time() + timeout
        for w in self._workers:
            remaining = max(deadline - time.time(), 0.1)
            try:
                w.process.wait(remaining)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(w.process.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                w.process.wait()
        for w in self._workers:
            if w.log_file:
                w.log_file.close()
                w.log_file = None

    def _capture_native_stacks(self, workers=None, timeout: float = 12.0):
        """Append native (ptrace) stacks of every live worker (or of
        ``workers``) to its log, CONCURRENTLY and with a hard bound —
        this runs on the hang-recovery path, where the diagnostic must
        never become the delay (the sampler binary is prebuilt at agent
        start). A worker whose output is not redirected writes to this
        process's stderr, so its stacks go there."""
        try:
            from dlrover_tpu_torch.tpu_timer.native_stack import (
                sample_native_stacks,
            )
        except Exception:  # noqa: BLE001 - diagnosis best-effort
            return

        def one(w):
            t0 = time.monotonic()
            try:
                text = sample_native_stacks(w.process.pid, timeout=timeout)
            except Exception:  # noqa: BLE001
                text = None
            if not text:
                return
            try:
                if w.log_file:
                    w.log_file.write(text.encode())
                    w.log_file.flush()
                else:
                    sys.stderr.write(text)
                    sys.stderr.flush()
            except (OSError, ValueError):
                return
            logger.info(
                "native stacks of worker pid %d: %d threads in %.3f s",
                w.process.pid, text.count("Native thread "),
                time.monotonic() - t0)

        threads = [
            threading.Thread(target=one, args=(w,), daemon=True)
            for w in (self._workers if workers is None else workers)
            if w.process.poll() is None
        ]
        for t in threads:
            t.start()
        deadline = time.time() + timeout + 3.0
        for t in threads:
            t.join(timeout=max(deadline - time.time(), 0.1))

    def _sample_hung_workers(self):
        """A live worker whose hang watchdog wrote a new hang dump gets
        its native stacks appended to its log (in the background, once
        per dump): the watchdog's Python stacks cannot show a thread
        wedged in native code."""
        from dlrover_tpu_torch.observability.hang_watchdog import (
            hang_dump_path,
        )

        started = getattr(self, "_workers_started_at", 0.0)
        for local_rank, w in enumerate(self._workers):
            path = hang_dump_path(self._spec.node_rank, local_rank)
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                continue
            if mtime < started or self._hang_sampled.get(
                    local_rank) == mtime or w.process.poll() is not None:
                continue
            self._hang_sampled[local_rank] = mtime
            try:
                with open(path) as f:
                    pid = json.load(f).get("pid")
            except (OSError, ValueError):
                continue
            if pid != w.process.pid:
                continue
            logger.info("hang dump of worker local_rank=%d pid=%d: "
                        "sampling its native stacks", local_rank, pid)
            threading.Thread(target=self._capture_native_stacks,
                             args=([w],), daemon=True).start()

    def _restart_workers(self, post_mortem: bool = False):
        restart_start = time.time()
        self._stop_workers(post_mortem=post_mortem)
        self._restart_count += 1
        self._restarts_counter.inc()
        self._initialize_workers()
        self._client.report_goodput_phase(
            GoodputPhase.RESTART, restart_start, time.time()
        )

    # ---- monitoring --------------------------------------------------------

    def _monitor_workers(self) -> Optional[str]:
        """Return "succeeded"|"failed"|None (still running)."""
        states = [w.process.poll() for w in self._workers]
        if all(s == 0 for s in states):
            return "succeeded"
        if any(s is not None and s != 0 for s in states):
            return "failed"
        return None

    def _failed_exit_codes(self) -> Dict[int, int]:
        return {
            w.local_rank: w.process.returncode
            for w in self._workers
            if w.process.poll() is not None and w.process.returncode != 0
        }

    def _membership_changed(self) -> bool:
        return self._rdzv.num_nodes_waiting() > 0

    def _heartbeat_and_actions(self) -> Optional[RunResult]:
        try:
            actions = self._client.report_heartbeat()
        except Exception:
            logger.warning("heartbeat failed", exc_info=True)
            return None
        for action in actions or []:
            atype = getattr(action, "action_type", None)
            if atype == DiagnosisActionType.RESTART_WORKER:
                # Diagnosis-driven restart usually means a hang: capture
                # stacks before tearing the workers down.
                logger.info("diagnosis action: restart workers in place")
                self._restart_workers(post_mortem=True)
            elif atype == DiagnosisActionType.RELAUNCH_WORKER:
                logger.info("diagnosis action: relaunch node")
                self._stop_workers()
                return RunResult.RELAUNCH
            elif atype == DiagnosisActionType.JOB_ABORT:
                logger.info("diagnosis action: abort job")
                self._stop_workers()
                return RunResult.FAILED
            elif atype == DiagnosisActionType.JOB_RESTART:
                logger.info("diagnosis action: job restart")
                self._restart_workers()
        return None

    # ---- failure handling --------------------------------------------------

    def collect_flight_records(
        self, local_ranks=None, last_n: int = 64
    ) -> Dict[int, Dict]:
        """Fetch the flight-recorder crash dumps of this node's workers
        (the last N steps each dead worker managed to record). Dumps
        older than the current incarnation are skipped: a SIGKILLed
        worker writes nothing, and reporting the PREVIOUS incarnation's
        ring as this failure's postmortem would mislead diagnosis."""
        from dlrover_tpu_torch.observability import flight_recorder

        if local_ranks is None:
            local_ranks = range(self._spec.nproc_per_node)
        # Cutoff AT the incarnation start: the previous incarnation
        # always dumps before _start_workers_inner stamps the new
        # start time, so its file's mtime lands before the cutoff.
        started = getattr(self, "_workers_started_at", 0.0)
        max_age = max(time.time() - started, 0.0) if started else None
        return flight_recorder.collect_dumps(
            self._spec.node_rank,
            local_ranks,
            max_age_s=max_age,
            last_n=last_n,
        )

    def _report_flight_records(self, codes: Dict[int, int]):
        """Forward dead workers' last-steps rings to the master's
        diagnosis store; best-effort — postmortem data must never delay
        the restart path."""
        try:
            dumps = self.collect_flight_records(local_ranks=codes.keys())
        except Exception:  # noqa: BLE001 - diagnosis best-effort
            logger.warning("flight record collection failed", exc_info=True)
            return
        from dlrover_tpu_torch.diagnosis.diagnosis_data import DiagnosisDataType

        for local_rank, dump in dumps.items():
            steps = dump.get("steps", [])
            if steps:
                logger.info(
                    "flight recorder (local_rank %d): last step %s",
                    local_rank,
                    steps[-1],
                )
            try:
                self._client.report_diagnosis_data(
                    DiagnosisDataType.FLIGHT_RECORDER,
                    {
                        "node_rank": self._spec.node_rank,
                        "local_rank": local_rank,
                        "steps": steps,
                    },
                )
            except Exception:  # noqa: BLE001
                logger.debug("flight record report failed", exc_info=True)
        # Hang-watchdog / SIGUSR1 stack dumps ride the same postmortem
        # path: a wedged-then-killed worker's blocked frames reach the
        # master's hang diagnostician as evidence.
        try:
            from dlrover_tpu_torch.observability.hang_watchdog import (
                collect_hang_dumps,
            )

            started = getattr(self, "_workers_started_at", 0.0)
            max_age = max(time.time() - started, 0.0) if started else None
            hang_dumps = collect_hang_dumps(
                self._spec.node_rank, codes.keys(), max_age_s=max_age
            )
            for local_rank, dump in hang_dumps.items():
                self._client.report_diagnosis_data(
                    DiagnosisDataType.STACK_DUMP, dump
                )
        except Exception:  # noqa: BLE001 — postmortem best-effort
            logger.debug("hang dump report failed", exc_info=True)

    def _on_workers_failed(self) -> Optional[RunResult]:
        codes = self._failed_exit_codes()
        logger.warning("worker failure, exit codes %s", codes)
        self._failures_counter.inc()
        self._report_flight_records(codes)
        if self._ckpt_saver is not None:
            # Breakpoint save runs in the background: a same-host
            # restart restores MEMORY-FIRST from the shm image (owned
            # by this agent process, so it survives the worker), and
            # the storage persist only protects the node-loss case —
            # where minutes of latency are fine — so the restart
            # needn't wait the seconds a large state takes to persist.
            # The persist only READS shm (serialized against new saves
            # by the per-rank locks). A crash-looping worker must not
            # stack concurrent saves (save_shm_on_failure is not
            # self-reentrant): if the previous persist is still running
            # after the join grace, skip this round — the next failure
            # or cadence save covers it.
            prev = self._breakpoint_thread
            if prev is not None:
                prev.join(timeout=60.0)
            if prev is not None and prev.is_alive():
                logger.warning(
                    "previous breakpoint save still running; skipping"
                )
            else:
                def _breakpoint_save():
                    try:
                        self._ckpt_saver.save_shm_on_failure()
                    except Exception:
                        logger.exception(
                            "breakpoint checkpoint save failed"
                        )

                self._breakpoint_thread = threading.Thread(
                    target=_breakpoint_save, daemon=True,
                    name="breakpoint-save",
                )
                self._breakpoint_thread.start()
        from dlrover_tpu_torch.agent.diagnosis_agent import (
            FailureContext,
            WorkerAction,
        )

        ctx = FailureContext(
            exit_codes=codes,
            restart_count=self._restart_count,
            max_restarts=self._spec.max_restarts,
            # One offset-tracked read shared by diagnosis and the
            # reason classifier: the scan offset advances per read, so
            # two reads would leave the second one blind.
            log_tail=self._diagnosis_agent.consume_failure_evidence(),
        )
        decision = self._diagnosis_agent.diagnose_training_failure(ctx)
        reason = self._diagnosis_agent.failure_reason(ctx)
        from dlrover_tpu_torch.common.constants import NodeExitReason
        from dlrover_tpu_torch.training_event import AgentEvents

        if reason == NodeExitReason.OOM:
            # Restarting in place with the same config just OOMs again;
            # escalate so the master's optimizer can bump resources.
            decision = WorkerAction.RELAUNCH_NODE
        AgentEvents.worker_failure(codes, decision)
        try:
            self._client.report_failure(
                error_data=f"reason={reason} codes={codes}",
                node_rank=self._spec.node_rank,
                restart_count=self._restart_count,
                exit_code=next(iter(codes.values()), 1),
                level=TrainingExceptionLevel.NODE_ERROR
                if decision == WorkerAction.RELAUNCH_NODE
                else TrainingExceptionLevel.PROCESS_ERROR,
            )
        except Exception:
            logger.warning("failure report failed", exc_info=True)
        if decision == WorkerAction.RELAUNCH_NODE:
            return RunResult.RELAUNCH
        if decision == WorkerAction.FAIL_JOB:
            logger.error(
                "max restarts (%d) exhausted", self._spec.max_restarts
            )
            return RunResult.FAILED
        # Some workers may still be alive while siblings crashed; their
        # stacks are evidence for the failure diagnosis.
        self._restart_workers(post_mortem=True)
        return None

    # ---- main loop ---------------------------------------------------------

    def run(self) -> RunResult:
        self._diagnosis_agent.start()

        # Prebuild the native stack sampler off the critical path: a
        # first-use g++ build during hang recovery would delay the
        # restart (see _capture_native_stacks).
        def _prebuild():
            try:
                from dlrover_tpu_torch.tpu_timer.native_stack import (
                    ensure_built,
                )

                ensure_built()
            except Exception:  # noqa: BLE001 - diagnosis best-effort
                pass

        threading.Thread(target=_prebuild, daemon=True).start()
        try:
            return self._run()
        except RendezvousEvictedError:
            logger.warning("evicted from rendezvous; requesting relaunch")
            self._stop_workers()
            return RunResult.RELAUNCH
        except RendezvousTimeoutError:
            logger.error("rendezvous timed out; requesting relaunch")
            self._stop_workers()
            try:
                self._client.report_failure(
                    "rendezvous timeout",
                    node_rank=self._spec.node_rank,
                    restart_count=self._restart_count,
                    level=TrainingExceptionLevel.RDZV_ERROR,
                )
            except Exception:
                pass
            return RunResult.RELAUNCH
        finally:
            self._diagnosis_agent.stop()
            self._close_standby()

    def _run(self) -> RunResult:
        spec = self._spec
        self._initialize_workers()
        while True:
            time.sleep(spec.monitor_interval)
            state = self._monitor_workers()
            if state == "succeeded":
                self._exit_barrier()
                if self._ckpt_saver is not None:
                    # Unlike the reference's agent: the persist the
                    # workers asked for last lands, and reports its step,
                    # before the master hears of success and exits.
                    self._ckpt_saver.wait_idle()
                try:
                    self._client.report_succeeded()
                except Exception:
                    logger.warning("success report failed", exc_info=True)
                logger.info("all workers succeeded")
                return RunResult.SUCCEEDED
            if state == "failed":
                result = self._on_workers_failed()
                if result is not None:
                    return result
                continue
            # healthy: hung workers' native stacks, heartbeat +
            # membership check
            self._sample_hung_workers()
            now = time.time()
            if now - self._last_heartbeat > JobConstant.NODE_HEARTBEAT_INTERVAL:
                self._last_heartbeat = now
                result = self._heartbeat_and_actions()
                if result is not None:
                    return result
            if self._membership_changed():
                logger.info(
                    "membership change detected; gracefully re-meshing"
                )
                self._restart_workers()

    def _exit_barrier(self, timeout: float = 300.0):
        """All agents wait so slow savers/rank committers can finish.

        Reference: training.py exit_barrier via master KV store. Implemented
        with set+poll on per-node keys (idempotent under RPC retry, unlike a
        counter)."""
        outcome = self._current_outcome
        if outcome is None or len(outcome.world) <= 1:
            return
        key = f"exit-barrier/{outcome.round}/{self._spec.node_rank}"
        try:
            self._client.kv_store_set(key, b"1")
            peer_keys = [
                f"exit-barrier/{outcome.round}/{r}" for r in outcome.world
            ]
            deadline = time.time() + timeout
            while time.time() < deadline:
                values = self._client.kv_store_multi_get(peer_keys)
                if len(values) >= len(peer_keys):
                    return
                time.sleep(0.5)
            logger.warning("exit barrier timed out")
        except Exception:
            logger.warning("exit barrier failed", exc_info=True)

    def wait_breakpoint_save(self, timeout: float = 60.0):
        """Join a breakpoint save still persisting (up to ``timeout``)."""
        if self._breakpoint_thread is not None:
            self._breakpoint_thread.join(timeout=timeout)

    def stop(self):
        self._stopping = True
        self._diagnosis_agent.stop()
        self._stop_workers()
        self._close_standby()
        self.wait_breakpoint_save()
