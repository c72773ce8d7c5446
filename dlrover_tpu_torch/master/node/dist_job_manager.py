"""Distributed job manager: node lifecycle across a cluster backend.

Parity: reference dlrover/python/master/node/dist_job_manager.py:107-1568
(DistributedJobManager.start/_monitor_nodes/_process_event/
_should_relaunch/_relaunch_node) — creates/monitors/relaunches worker
nodes through a Scaler + NodeWatcher pair, detects dead nodes by
heartbeat timeout (reference :532-610), and applies the exit-reason
relaunch policy (:996).

TPU specifics vs the reference: node groups map to TPU hosts of a slice;
a relaunch of a host keeps its rank_index so the slice's physical mesh
coordinates stay valid; hardware-broken hosts are replaced rather than
restarted (ICI requires the full slice, so the rendezvous holds workers
until the replacement arrives).

Two divergences from the reference, both on the agent-facing handlers
(ROADMAP §C): an agent that reports with the id of its rank's ended
incarnation (the launcher reports ``node_id = node_rank``, so a
relaunched host reports its first incarnation's id) is attributed to
the rank's live incarnation, and an agent's success report moves its
node to SUCCEEDED through the event path, as an agent's node-level
failure report already moves it to FAILED. A master whose cluster
reports no process exits (the simulated cluster under external
launchers) can then finish a job.

The port's copy of ``dlrover_tpu/master/node/dist_job_manager.py``.
"""

import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import (
    JobStage,
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node, NodeEvent, NodeGroupResource
from dlrover_tpu_torch.diagnosis.actions import DiagnosisAction, NodeAction
from dlrover_tpu_torch.master.node.event_callback import NodeEventCallback
from dlrover_tpu_torch.master.node.exit_reason import classify_exit
from dlrover_tpu_torch.master.node.job_context import get_job_context
from dlrover_tpu_torch.master.node.training_node import (
    WorkerManager,
    create_role_manager,
)
from dlrover_tpu_torch.master.scaler.base_scaler import ScalePlan, Scaler
from dlrover_tpu_torch.master.watcher.base_watcher import NodeWatcher
from dlrover_tpu_torch.training_event import MasterEvents

_MONITOR_INTERVAL_S = 1.0


class DistributedJobManager:
    def __init__(
        self,
        job_name: str,
        node_groups: Dict[str, NodeGroupResource],
        scaler: Scaler,
        watcher: NodeWatcher,
        max_relaunch_count: int = 3,
        heartbeat_timeout_s: float = 600.0,
        pending_timeout_s: float = 900.0,
        relaunch_on_worker_failure: bool = True,
        node_group_size: int = 0,
    ):
        self._job_name = job_name
        self._job_context = get_job_context()
        self._scaler = scaler
        self._watcher = watcher
        self._max_relaunch_count = max_relaunch_count
        self._heartbeat_timeout_s = heartbeat_timeout_s
        self._pending_timeout_s = pending_timeout_s
        self._relaunch_on_worker_failure = relaunch_on_worker_failure
        # Hosts per TPU slice (0/1 = no grouping): drives group
        # assignment at init and whole-block relaunch on hardware
        # faults (reference dist_job_manager.py:1128
        # _relaunch_node_group).
        self._node_group_size = node_group_size
        self._node_event_callbacks: List[NodeEventCallback] = []
        self._stopped = threading.Event()
        self._threads: List[threading.Thread] = []
        self._id_lock = threading.Lock()
        self._next_node_id = 0
        # Serializes status transitions: events arrive from the watcher
        # thread, the heartbeat monitor, and RPC servicer threads.
        self._event_lock = threading.Lock()
        # Agent-reported node ids may differ from the master's internal
        # record ids (e.g. a relaunched pod keeps NODE_ID of its rank);
        # handle_node_joined records the mapping here.
        self._id_alias: Dict[int, int] = {}

        # Per-role managers (reference runs worker/chief/evaluator/ps
        # manager instances side by side; TF PS is by-design absent).
        groups = dict(node_groups)
        groups.setdefault(NodeType.WORKER, NodeGroupResource(count=1))
        self._managers = {
            node_type: create_role_manager(
                node_type,
                group,
                self._new_node_id,
                max_relaunch_count,
                node_group_size=node_group_size,
            )
            for node_type, group in groups.items()
        }
        self._worker_manager = self._managers[NodeType.WORKER]

    # ---- wiring ------------------------------------------------------------

    def add_node_event_callback(self, callback: NodeEventCallback):
        self._node_event_callbacks.append(callback)

    @property
    def worker_manager(self) -> WorkerManager:
        return self._worker_manager

    @property
    def role_managers(self):
        return dict(self._managers)

    def set_master_addr(self, addr: str):
        self._scaler.set_master_addr(addr)

    def _new_node_id(self) -> int:
        with self._id_lock:
            node_id = self._next_node_id
            self._next_node_id += 1
            return node_id

    # ---- lifecycle ---------------------------------------------------------

    def start(self):
        self._job_context.set_job_stage(JobStage.PENDING)
        self._scaler.start()
        # Reconcile: adopt nodes that already exist in the backend (master
        # restart while workers keep running, reference
        # dist_job_manager.py _init_nodes), launch only the missing ranks.
        backend_nodes = [
            n
            for n in self._watcher.list()
            if n.status not in NodeStatus.end_states()
        ]
        plan = ScalePlan()
        for node_type, manager in self._managers.items():
            existing = {
                n.rank_index: n
                for n in backend_nodes
                if n.type == node_type
            }
            for node in manager.init_nodes():
                alive = existing.get(node.rank_index)
                if alive is not None:
                    manager.remove_node(node.id)
                    manager.update_node(alive)
                    self._job_context.update_node(alive)
                    logger.info("adopted existing node %s", alive.name)
                else:
                    self._job_context.update_node(node)
                    plan.launch_nodes.append(node)
        if not plan.empty():
            self._scaler.scale(plan)
        self._job_context.set_job_stage(JobStage.RUNNING)
        for target in (self._monitor_nodes, self._monitor_heartbeats):
            t = threading.Thread(
                target=target, name=target.__name__, daemon=True
            )
            t.start()
            self._threads.append(t)
        logger.info(
            "distributed job manager started: %d workers",
            self._worker_manager.group_resource.count,
        )

    def stop(self):
        self._stopped.set()
        self._job_context.set_job_stage(JobStage.STOPPING)
        self._watcher.stop()
        self._scaler.stop()

    def join(self, timeout: float = 5.0):
        for t in self._threads:
            t.join(timeout)

    # ---- monitor loops ------------------------------------------------------

    def _monitor_nodes(self):
        """Consume watcher events (reference dist_job_manager.py:516)."""
        while not self._stopped.is_set():
            try:
                for event in self._watcher.watch():
                    if self._stopped.is_set():
                        return
                    self._process_event(event)
            except Exception:
                logger.exception("node watch stream failed; retrying")
                time.sleep(1.0)

    def _monitor_heartbeats(self):
        """Detect dead nodes whose process stopped reporting
        (reference dist_job_manager.py:543 _monitor_node_heart_beat)."""
        while not self._stopped.is_set():
            time.sleep(_MONITOR_INTERVAL_S)
            now = time.time()
            for node in self._all_running_nodes():
                if node.heartbeat_time <= 0:
                    continue
                if now - node.heartbeat_time > self._heartbeat_timeout_s:
                    logger.warning(
                        "node %s heartbeat lost for %.0fs; marking failed",
                        node.name,
                        now - node.heartbeat_time,
                    )
                    self._observe_failure(node, NodeExitReason.KILLED)

    def _all_running_nodes(self):
        nodes = []
        for manager in self._managers.values():
            nodes.extend(manager.running_nodes())
        return nodes

    def _manager_of(self, node: Node):
        return self._managers.get(node.type, self._worker_manager)

    def pending_timed_out(self) -> bool:
        times = [
            m.first_pending_since() for m in self._managers.values()
        ]
        times = [t for t in times if t]
        since = min(times) if times else 0.0
        return bool(since) and (time.time() - since) > self._pending_timeout_s

    # ---- event processing ----------------------------------------------------

    def _observe_failure(
        self,
        node: Node,
        exit_reason: str,
        status: str = NodeStatus.FAILED,
    ):
        """Feed a synthetic failure observation through the normal event
        path (detached copy: _process_event diffs observed vs recorded)."""
        observed = Node(
            node_type=node.type,
            node_id=node.id,
            rank_index=node.rank_index,
            name=node.name,
            status=status,
        )
        observed.exit_reason = exit_reason
        self._process_event(NodeEvent(NodeEventType.MODIFIED, observed))

    def _process_event(self, event: NodeEvent):
        if event.node is None:
            return
        with self._event_lock:
            self._process_event_locked(event)

    def _process_event_locked(self, event: NodeEvent):
        observed = event.node
        node = None
        for manager in self._managers.values():
            node = manager.get_node(observed.id)
            if node is not None:
                break
        if node is None:
            # A node created outside our records (e.g. scaler raced the
            # watcher at startup): adopt it under its role's manager.
            node = observed
            self._manager_of(node).update_node(node)
        node.host_name = observed.host_name or node.host_name
        node.host_ip = observed.host_ip or node.host_ip
        if observed.exit_reason:
            node.exit_reason = observed.exit_reason

        new_status = observed.status
        if event.event_type == NodeEventType.DELETED:
            # Deletion of a non-finished pod means the host was reclaimed.
            if node.status not in NodeStatus.end_states():
                new_status = NodeStatus.DELETED
            node.is_released = True
        retired = not node.relaunchable
        old_status = node.status
        if not node.update_status(new_status):
            return
        if new_status == old_status:
            return
        self._job_context.update_node(node)
        logger.info(
            "node %s: %s -> %s (%s)",
            node.name,
            old_status,
            new_status,
            node.exit_reason or event.event_type,
        )
        MasterEvents.node_status(
            node.id, new_status, node.exit_reason or event.event_type
        )

        if new_status == NodeStatus.RUNNING:
            for cb in self._node_event_callbacks:
                cb.on_node_started(node)
        elif new_status == NodeStatus.SUCCEEDED:
            for cb in self._node_event_callbacks:
                cb.on_node_succeeded(node)
        elif new_status in (NodeStatus.FAILED, NodeStatus.BREAKDOWN):
            self._job_context.inc_failure_count()
            for cb in self._node_event_callbacks:
                cb.on_node_failed(node)
            # An intentionally-retired record (e.g. a healthy block
            # member torn down by a group relaunch) must not write into
            # the lineage's exit history — that would silently erode
            # the budget of a host that never failed.
            if not retired:
                # exit_reason and the recorded history must agree — the
                # budget check counts exit_history entries matching
                # exit_reason (common/node.py is_unrecoverable_failure).
                node.exit_reason = (
                    node.exit_reason or NodeExitReason.UNKNOWN
                )
                node.record_exit(node.exit_reason)
                self._handle_node_gone(node)
        elif new_status == NodeStatus.DELETED:
            for cb in self._node_event_callbacks:
                cb.on_node_deleted(node)
            # Deleting an already-finished node is cleanup, not a new
            # failure: relaunch only on the first transition into an
            # end state.
            if old_status not in NodeStatus.end_states() and not retired:
                node.exit_reason = (
                    node.exit_reason or NodeExitReason.KILLED
                )
                node.record_exit(node.exit_reason)
                self._handle_node_gone(node)

    def _handle_node_gone(self, node: Node):
        if (
            self._node_group_size > 1
            and node.type == NodeType.WORKER
            and node.node_group >= 0
            and node.exit_reason == NodeExitReason.HARDWARE_ERROR
            and self._should_relaunch(node)
        ):
            # A broken host invalidates its whole ICI slice: the block's
            # hosts must be replaced TOGETHER (a fresh slice), while
            # other blocks keep their processes and simply re-rendezvous
            # when the replacement block arrives.
            self._relaunch_node_group(node.node_group)
            return
        if self._should_relaunch(node):
            new_node, plan = self._manager_of(node).relaunch_node(node)
            if new_node is not None:
                logger.info(
                    "relaunching %s as %s (attempt %d/%d)",
                    node.name,
                    new_node.name,
                    new_node.relaunch_count,
                    node.max_relaunch_count,
                )
                self._job_context.update_node(new_node)
                MasterEvents.node_relaunch(
                    node.id, node.rank_index, node.exit_reason
                )
                self._scaler.scale(plan)
                return
        logger.warning("node %s will not be relaunched", node.name)

    def _relaunch_node_group(self, group_idx: int):
        """Relaunch every member of a slice block in one scale plan
        (reference dist_job_manager.py:1128 _relaunch_node_group)."""
        members = [
            n
            for n in self._worker_manager.latest_nodes()
            if n.node_group == group_idx
        ]
        plan = ScalePlan()
        relaunched = []
        for m in members:
            new_node, p = self._worker_manager.relaunch_node(m)
            # The old incarnation gets torn down by this plan; its later
            # DELETED event must not trigger a second relaunch.
            m.relaunchable = False
            self._job_context.update_node(m)
            if new_node is None:
                continue
            new_node.node_group = group_idx
            new_node.relaunchable = True
            self._job_context.update_node(new_node)
            relaunched.append((m, new_node))
            plan.launch_nodes.extend(p.launch_nodes)
            plan.remove_nodes.extend(p.remove_nodes)
        logger.warning(
            "relaunching slice block %d: %s",
            group_idx,
            [f"{m.name}->{n.name}" for m, n in relaunched],
        )
        for m, n in relaunched:
            MasterEvents.node_relaunch(m.id, m.rank_index, m.exit_reason)
        if not plan.empty():
            self._scaler.scale(plan)

    def _should_relaunch(self, node: Node) -> bool:
        """Exit-reason relaunch policy (reference
        dist_job_manager.py:996 _should_relaunch).

        Each classified reason spends its own relaunch budget
        (common.constants.RELAUNCH_BUDGET_FACTOR via
        Node.is_unrecoverable_failure): preemptions are near-free,
        kills get double budget, OOM/hardware/software one budget
        (OOM additionally triggers the optimizer's memory bump and the
        strategy generator's remat escalation), fatal never relaunches.
        """
        if self._job_context.job_stage != JobStage.RUNNING:
            return False
        if not self._relaunch_on_worker_failure:
            return False
        if node.status == NodeStatus.SUCCEEDED:
            return False
        blocker = node.is_unrecoverable_failure()
        if blocker:
            logger.warning(
                "no relaunch for %s (%s): %s",
                node.name,
                node.exit_reason or "unclassified",
                blocker,
            )
            return False
        return True

    # ---- servicer surface (shared with LocalJobManager) ----------------------

    def _resolve_node(self, reported_id: int) -> Optional[Node]:
        """Map an agent-reported node id to the master's record, via the
        alias recorded at join time if the ids diverged. The alias comes
        first: an id can alias a newer incarnation while its own ended
        record is still in the table."""
        for node_id in (self._id_alias.get(reported_id), reported_id):
            if node_id is None:
                continue
            for manager in self._managers.values():
                node = manager.get_node(node_id)
                if node is not None:
                    return node
        return None

    def handle_node_joined(self, node_id: int, node_rank: int):
        # Direct id lookup across EVERY role manager first — a chief or
        # evaluator agent must never be mis-attributed to a same-rank
        # worker record.
        node = None
        for manager in self._managers.values():
            node = manager.get_node(node_id)
            if node is not None:
                break
        ended = None
        if (
            node is not None
            and node.type == NodeType.WORKER
            and node.is_end()
        ):
            # The id is that of the rank's ended incarnation (a relaunched
            # host's agent reports its rank as its id): the join belongs
            # to the rank's live incarnation, if there is one.
            ended, node = node, None
        if node is None:
            # Agent ids are assigned by the backend; match the newest
            # live incarnation of the rank and remember the alias. Only
            # workers use backend-assigned ids this way (their ranks
            # come from the elastic rendezvous protocol).
            candidates = [
                n
                for n in self._worker_manager.nodes.values()
                if n.rank_index == node_rank and not n.is_end()
            ]
            if candidates:
                node = max(candidates, key=lambda n: n.id)
                self._id_alias[node_id] = node.id
        if node is None:
            node = ended
        if node is None:
            node = Node(NodeType.WORKER, node_id, rank_index=node_rank)
            self._worker_manager.update_node(node)
        node.update_status(NodeStatus.RUNNING)
        node.heartbeat_time = time.time()
        self._job_context.update_node(node)

    def collect_node_heartbeat(
        self, node_id: int, timestamp: float
    ) -> List[DiagnosisAction]:
        node = self._resolve_node(node_id)
        if node is not None:
            node.heartbeat_time = timestamp
            node_id = node.id
        return self._job_context.drain_node_actions(node_id)

    def handle_node_failure(self, report: comm.NodeFailureReport):
        node = self._resolve_node(report.node_id)
        if node is None:
            return
        node.relaunch_count = max(node.relaunch_count, report.restart_count)
        # Classify from the agent's evidence (exit code + reason hint /
        # log markers); the watcher's container-status reason, if any,
        # stays authoritative.
        reason = classify_exit(report.exit_code, report.error_data)
        if reason and not node.exit_reason:
            node.exit_reason = reason
        if report.level == TrainingExceptionLevel.NODE_ERROR:
            self._observe_failure(
                node, node.exit_reason or NodeExitReason.KILLED
            )

    def handle_node_succeeded(self, node_id: int):
        node = self._resolve_node(node_id)
        if node is not None:
            node.reported_status = NodeStatus.SUCCEEDED
            # Through the event path, as a node-level failure report is.
            self._observe_failure(node, "", status=NodeStatus.SUCCEEDED)

    def handle_reported_node_event(self, report: comm.NodeEventReport):
        logger.info(
            "node %d event %s: %s %s",
            report.node_id,
            report.event_type,
            report.reason,
            report.message,
        )
        if report.event_type == NodeEventType.NODE_CHECK_FAILED:
            node = self._resolve_node(report.node_id)
            if node is not None:
                self._observe_failure(
                    node,
                    NodeExitReason.HARDWARE_ERROR,
                    status=NodeStatus.BREAKDOWN,
                )

    def update_node_resource_usage(self, stats: comm.ResourceStats):
        node = self._resolve_node(stats.node_id)
        if node is not None:
            node.update_from_resource_stats(stats.cpu_percent, stats.memory_mb)

    def update_ckpt_step(self, node_id: int, step: int, committed: bool):
        self._job_context.update_ckpt_step(node_id, step, committed)

    def get_committed_ckpt_step(self) -> int:
        return self._job_context.committed_ckpt_step()

    def set_strategy_generator(self, generator):
        self._strategy_generator = generator

    def get_parallel_config(self) -> Optional[comm.ParallelConfig]:
        generator = getattr(self, "_strategy_generator", None)
        if generator is None:
            return None
        return generator.generate()

    def get_job_detail(self) -> comm.JobDetailResponse:
        nodes = {}
        for manager in self._managers.values():
            for node_id, node in manager.nodes.items():
                nodes[node_id] = {
                    "type": node.type,
                    "rank": node.rank_index,
                    "status": node.status,
                    "relaunch_count": node.relaunch_count,
                    "host": node.host_name,
                }
        return comm.JobDetailResponse(
            job_name=self._job_name,
            stage=self._job_context.job_stage,
            nodes=nodes,
        )

    # ---- run-loop queries ----------------------------------------------------

    def _success_gating_managers(self):
        """Roles whose completion gates job success: workers and the
        chief. Evaluators are auxiliary — a finished training job tears
        them down rather than waiting on them."""
        return [
            m
            for t, m in self._managers.items()
            if t in (NodeType.WORKER, NodeType.CHIEF)
        ]

    def all_workers_exited(self) -> bool:
        return all(
            m.all_nodes_exited() for m in self._success_gating_managers()
        )

    def all_workers_succeeded(self) -> bool:
        return all(
            m.all_nodes_succeeded()
            for m in self._success_gating_managers()
        )

    def all_running_node_hanged(self) -> bool:
        running = self._all_running_nodes()
        if not running:
            return False
        now = time.time()
        return all(
            n.heartbeat_time > 0
            and now - n.heartbeat_time > self._heartbeat_timeout_s / 2
            for n in running
        )

    def restart_worker_processes(self, reason: str):
        """Queue an in-place worker restart on every running node."""
        for node in self._worker_manager.running_nodes():
            self._job_context.enqueue_action(
                NodeAction(
                    instance=node.id,
                    node_id=node.id,
                    reason=reason,
                )
            )
