"""Agent-resident async checkpoint saver (the port's copy of
``dlrover_tpu/flash_ckpt/saver.py``). The saver lives in the AGENT
process so a dying worker cannot take the persistence thread with it;
shm segments likewise outlive workers. With a replica manager
(``flash_ckpt/replica.py``) the saver pushes each new shm image to the
node's replica-group peers.

Commit protocol (crash-safe):
1. every node writes its proc files + a ``node-<rank>.done`` marker into
   the step dir (all writes are tmp+rename);
2. the leader node (lowest rank in the world) polls until every expected
   marker exists, then atomically replaces the tracker file and reports
   the committed step to the master;
3. a leader dying mid-commit is safe: markers persist, any relaunched
   leader re-runs step 2 idempotently; an uncommitted step dir is garbage-
   collected by the deletion strategy.
"""

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.flash_ckpt import storage as ckpt_storage
from dlrover_tpu_torch.flash_ckpt.engine import (
    CKPT_EVENT_QUEUE,
    CKPT_LOCK_PREFIX,
    SaveEvent,
    shm_segment_name,
)
from dlrover_tpu_torch.flash_ckpt.shared_obj import (
    SharedDictServer,
    SharedLockServer,
    SharedQueueServer,
)
from dlrover_tpu_torch.flash_ckpt.shm_handler import (
    SharedMemoryHandler,
    storage_dtype,
)

_MAX_LOCAL_WORKERS = 16


class ShmReadCache:
    """The saver's per-local-rank segment attachments and host buffers,
    kept across persists. A fresh mapping and freshly allocated memory
    fault every page of a multi-GB image again, which costs seconds on
    hosts where a page fault is expensive; a segment its writer
    recreated (larger) or unlinked is attached anew."""

    def __init__(self):
        self._handlers: Dict[int, SharedMemoryHandler] = {}
        self._buffers: Dict[int, np.ndarray] = {}

    def handler(self, local_rank: int) -> SharedMemoryHandler:
        handler = self._handlers.get(local_rank)
        if handler is not None and not handler.is_current():
            handler.close()
            handler = None
        if handler is None:
            handler = SharedMemoryHandler(shm_segment_name(local_rank))
            self._handlers[local_rank] = handler
        return handler

    def buffer(self, local_rank: int, nbytes: int) -> np.ndarray:
        buf = self._buffers.get(local_rank)
        if buf is None or buf.nbytes < nbytes:
            buf = self._buffers[local_rank] = np.empty(nbytes, np.uint8)
        return buf[:nbytes]

    def close(self):
        for handler in self._handlers.values():
            handler.close()
        self._handlers.clear()
        self._buffers.clear()


def read_shm_payload(local_rank: int, lock=None,
                     cache: Optional[ShmReadCache] = None):
    """Extract (step, proc_payload) from a local worker's shm image.

    Data is COPIED out while holding ``lock`` (the same SharedLock the
    worker's engine takes while writing), so a concurrent next-step save
    cannot tear the payload; the lock is released before any disk IO.

    The image is copied EXACTLY ONCE (one bulk copy of the data region);
    the payload's arrays are views of that copy (C-contiguous by
    layout), which the raw persist path streams straight to disk, so the
    agent holds 1x the node's state in RAM. bf16 shards come out as
    their uint16 bits (``shm_handler.storage_dtype``). With ``cache``
    the attachment and the copy's buffer are the cache's (the arrays
    stay valid until its next read of this rank).
    """
    if lock is not None:
        lock.acquire()
    try:
        handler = (cache.handler(local_rank) if cache is not None
                   else SharedMemoryHandler(shm_segment_name(local_rank)))
        meta = handler.load_meta()
        if meta is None:
            if cache is None:
                handler.close()
            return None
        region = handler.data_region(meta)
        if cache is not None:
            data = cache.buffer(local_rank, region.numel())
        else:
            data = np.empty(region.numel(), np.uint8)
        torch.from_numpy(data).copy_(region)
        del region  # the segment closes only with no view left on it
        if cache is None:
            handler.close()
    finally:
        if lock is not None:
            lock.release()
    arrays = {}
    for leaf_meta in meta["leaves"]:
        dtype = storage_dtype(leaf_meta.dtype)
        for j, shard in enumerate(leaf_meta.shards):
            arrays[f"leaf{leaf_meta.leaf_id}_shard{j}"] = data[
                shard.offset:shard.offset + shard.nbytes
            ].view(dtype).reshape(shard.local_shape)
    payload = {
        "arrays": arrays,
        "meta": {
            "treespec": meta["treespec"],
            "leaves": meta["leaves"],
            "user_meta": meta.get("user_meta", {}),
        },
    }
    return meta["step"], payload


def default_deletion_strategy(max_to_keep: int = 3):
    """Retention policy for committed checkpoints. Env-selectable:
    DLROVER_TPU_CKPT_KEEP_INTERVAL=N keeps every Nth step forever in
    addition to the newest max_to_keep (sparse history for rollback)."""
    from dlrover_tpu_torch.common.env_utils import get_env_int

    interval = get_env_int("DLROVER_TPU_CKPT_KEEP_INTERVAL", 0)
    if interval > 0:
        return ckpt_storage.KeepStepIntervalDeletionStrategy(
            interval, max_to_keep
        )
    return ckpt_storage.KeepLatestDeletionStrategy(max_to_keep)


def persist_shm_to_storage(
    checkpoint_dir: str,
    step: int,
    node_rank: int,
    local_world_size: int,
    expected_nodes: List[int],
    master_client=None,
    commit_timeout: float = 600.0,
    max_to_keep: int = 3,
    locks: Optional[list] = None,
    deletion_strategy=None,
    cache: Optional[ShmReadCache] = None,
) -> bool:
    """Persist this node's shm images for ``step`` and run the commit.

    Aborts (returns False) if local ranks hold images of different steps —
    a step dir must never mix shards from different training steps.
    """
    proc_payloads: Dict[int, dict] = {}
    common_step: Optional[int] = None
    for local_rank in range(local_world_size):
        lock = locks[local_rank] if locks else None
        result = read_shm_payload(local_rank, lock, cache)
        if result is None:
            logger.warning(
                "no shm image for local rank %d; aborting persist",
                local_rank,
            )
            return False
        shm_step, payload = result
        if common_step is None:
            common_step = shm_step
        elif shm_step != common_step:
            logger.error(
                "local ranks hold mixed steps (%d vs %d); aborting persist "
                "to avoid committing an inconsistent checkpoint",
                common_step,
                shm_step,
            )
            return False
        process_id = payload["meta"]["user_meta"].get(
            "process_id", local_rank
        )
        proc_payloads[process_id] = payload
    if common_step != step:
        logger.warning(
            "shm images hold step %d (requested %d); persisting step %d",
            common_step,
            step,
            common_step,
        )
        step = common_step
    ckpt_storage.persist_node_shards(
        checkpoint_dir, step, node_rank, proc_payloads
    )

    # Commit (leader only).
    leader = min(expected_nodes) if expected_nodes else node_rank
    if node_rank != leader:
        if master_client is not None:
            try:
                master_client.report_ckpt_step(step, committed=False)
            except Exception:
                pass
        return True
    deadline = time.time() + commit_timeout
    while time.time() < deadline:
        done = ckpt_storage.nodes_done(checkpoint_dir, step)
        if set(done) >= set(expected_nodes):
            ckpt_storage.write_tracker(checkpoint_dir, step)
            strategy = deletion_strategy or default_deletion_strategy(
                max_to_keep
            )
            strategy.clean_up(checkpoint_dir)
            if master_client is not None:
                try:
                    master_client.report_ckpt_step(step, committed=True)
                except Exception:
                    pass
            logger.info("checkpoint step %d committed", step)
            return True
        time.sleep(0.5)
    logger.error("commit of step %d timed out waiting for %s", step,
                 expected_nodes)
    return False


class AsyncCheckpointSaver:
    """Hosted by the agent; singleton per agent process."""

    _instance: Optional["AsyncCheckpointSaver"] = None
    _lock = threading.Lock()

    def __init__(
        self,
        client=None,
        local_world_size: int = _MAX_LOCAL_WORKERS,
        replica_manager=None,
    ):
        self._client = client
        self._replica_manager = replica_manager
        self._last_replica_step = -1
        self._replica_lock = threading.Lock()
        self._replica_inflight = False
        self._replica_pending: Optional[SaveEvent] = None
        self._node_rank = int(os.getenv(NodeEnv.NODE_RANK, "0"))
        self._event_queue = SharedQueueServer(CKPT_EVENT_QUEUE)
        self._locks = [
            SharedLockServer(f"{CKPT_LOCK_PREFIX}_{r}")
            for r in range(local_world_size)
        ]
        self._conf_dict = SharedDictServer("ckpt_conf")
        self._world_nodes: List[int] = [self._node_rank]
        self._latest_mem_event: Optional[SaveEvent] = None
        self._last_persisted_step = -1
        self._read_cache = ShmReadCache()
        # The saver loop and the agent's breakpoint save both persist;
        # they share the read cache's buffers, so one persist at a time.
        self._persist_lock = threading.Lock()
        # One record per persist this saver ran: step, seconds, bytes.
        self.persist_records: List[dict] = []
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._saver_loop, daemon=True, name="ckpt-saver"
        )
        self._thread.start()

    # ---- agent wiring ------------------------------------------------------

    @classmethod
    def start_async_saving_ckpt(
        cls, client=None, replica_manager=None
    ) -> "AsyncCheckpointSaver":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls(
                    client=client, replica_manager=replica_manager
                )
            return cls._instance

    @classmethod
    def reset(cls):
        with cls._lock:
            if cls._instance is not None:
                cls._instance.stop()
                cls._instance = None

    def set_world(self, world: Dict[int, int]):
        """Called by the agent after each rendezvous round."""
        self._world_nodes = sorted(world) if world else [self._node_rank]

    # ---- saver loop --------------------------------------------------------

    def _saver_loop(self):
        while not self._stopped.is_set():
            try:
                event = self._event_queue.get(timeout=1.0)
            except Exception:
                continue
            try:
                self._handle_event(event)
            except Exception:
                logger.exception("checkpoint event handling failed")
            finally:
                self._event_queue.task_done()

    def wait_idle(self, timeout: float = 600.0) -> bool:
        """Block until every event the workers queued has been handled
        (the last persist they asked for has landed); False on
        timeout."""
        deadline = time.monotonic() + timeout
        while self._event_queue.unfinished() > 0:
            if time.monotonic() > deadline or not self._thread.is_alive():
                return False
            time.sleep(0.05)
        return True

    @property
    def last_persisted_step(self) -> int:
        return self._last_persisted_step

    def _handle_event(self, event: SaveEvent):
        self._latest_mem_event = event
        if event.kind == SaveEvent.SAVE_DISK:
            self._persist(event.checkpoint_dir, event.step,
                          event.local_world_size, commit_timeout=600.0)
        self._push_replicas(event)

    def _push_replicas(self, event: SaveEvent):
        """Replicate this node's shm image to its group peers on a thread
        of its own: an upload of a multi-GB image must not stall the
        saver loop (breakpoint-save freshness) or, worse, the workers.
        One push runs at a time, and a step already pushed is skipped
        (``save_to_storage`` queues SAVE_MEM then SAVE_DISK). Unlike the
        reference, which drops a save that lands while a push is in
        flight, the newest such save is pushed when that push ends: the
        last image before a node is lost must reach its peers."""
        if self._replica_manager is None:
            return
        with self._replica_lock:
            if event.step <= self._last_replica_step:
                return
            if self._replica_inflight:
                self._replica_pending = event
                return
            self._last_replica_step = event.step
            self._replica_inflight = True
        threading.Thread(target=self._push_loop, args=(event,),
                         name="ckpt-replica-push", daemon=True).start()

    def _push_loop(self, event: SaveEvent):
        while event is not None:
            t0 = time.monotonic()
            try:
                self._replica_manager.set_world(self._world_nodes)
                n = self._replica_manager.push_node_image(
                    event.local_world_size, locks=self._locks
                )
                if n:
                    logger.info(
                        "pushed %d shm segment replicas for step %d "
                        "(%d bytes in %.3f s)", n, event.step,
                        self._replica_manager.last_push_bytes,
                        time.monotonic() - t0)
            except Exception:
                logger.exception("replica push failed")
            with self._replica_lock:
                event, self._replica_pending = self._replica_pending, None
                if event is not None and (
                        event.step <= self._last_replica_step):
                    event = None
                if event is None:
                    self._replica_inflight = False
                else:
                    self._last_replica_step = event.step

    @staticmethod
    def _image_step(local_world_size: int) -> int:
        """The newest step the local ranks' shm images hold (-1: none)."""
        newest = -1
        for r in range(local_world_size):
            h = SharedMemoryHandler(shm_segment_name(r))
            newest = max(newest, h.get_step())
            h.close()
        return newest

    def _persist(self, checkpoint_dir, step, local_world_size,
                 commit_timeout) -> bool:
        """Persist and commit the image the local ranks' segments hold
        (one persist at a time: the saver loop and the agent's
        breakpoint save share the read cache's buffers). A
        ``ckpt_persist`` training event spans it, as in the reference's
        saver, with the step committed and its bytes."""
        from dlrover_tpu_torch.training_event import TrainerEvents

        with self._persist_lock:
            # The image moves on while a persist runs, and a persist
            # commits the image it finds: one queued behind it may find
            # that image committed already.
            if 0 <= self._image_step(local_world_size) <= (
                    self._last_persisted_step):
                return True
            with TrainerEvents.ckpt_persist(step) as span:
                ok = self._persist_locked(checkpoint_dir, step,
                                          local_world_size, commit_timeout)
                record = self.persist_records[-1]
                span.content.update(committed=ok,
                                    committed_step=record["step"],
                                    bytes=record["bytes"])
            if ok:
                self._last_persisted_step = record["step"]
            return ok

    def _persist_locked(self, checkpoint_dir, step, local_world_size,
                        commit_timeout) -> bool:
        t0 = time.monotonic()
        ok = persist_shm_to_storage(
            checkpoint_dir,
            step,
            self._node_rank,
            local_world_size,
            self._world_nodes,
            master_client=self._client,
            commit_timeout=commit_timeout,
            locks=self._locks,
            cache=self._read_cache,
        )
        record = {"step": step, "committed": ok,
                  "seconds": time.monotonic() - t0, "bytes": 0}
        if ok:
            # The step shm held (it may be newer than the one asked for),
            # as the leader committed it.
            record["step"] = ckpt_storage.read_tracker(checkpoint_dir)
            sdir = ckpt_storage.step_dir(checkpoint_dir, record["step"])
            record["bytes"] = sum(
                os.path.getsize(os.path.join(sdir, name))
                for name in os.listdir(sdir) if name.endswith(".raw"))
        self.persist_records.append(record)
        return ok

    # ---- failure path ------------------------------------------------------

    def save_shm_on_failure(self):
        """Breakpoint save: persist the newest shm image before restart.

        The agent calls it when a worker fails, before the restart."""
        event = self._latest_mem_event
        if event is None:
            return
        newest = self._image_step(event.local_world_size)
        if newest <= self._last_persisted_step or newest < 0:
            return
        tracker = ckpt_storage.read_tracker(event.checkpoint_dir)
        if newest <= tracker:
            return
        logger.info("breakpoint-saving shm step %d to storage", newest)
        # A failure save must not block on dead peers: the tracker only
        # advances if all expected markers appear.
        self._persist(event.checkpoint_dir, newest, event.local_world_size,
                      commit_timeout=60.0)

    # ---- cleanup -----------------------------------------------------------

    def unlink_all(self, local_world_size: int = _MAX_LOCAL_WORKERS):
        for r in range(local_world_size):
            SharedMemoryHandler(shm_segment_name(r)).unlink()

    def stop(self, timeout: float = 600.0):
        """Stop the servers and let a persist in progress finish (up to
        ``timeout`` seconds) before the saver lets go of the segments."""
        self._stopped.set()
        self._event_queue.stop()
        for lock in self._locks:
            lock.stop()
        self._conf_dict.stop()
        self._thread.join(timeout)
        if not self._thread.is_alive():
            self._read_cache.close()
