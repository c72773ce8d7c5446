"""Trainer-side flash checkpoint engine (the port of
``dlrover_tpu/flash_ckpt/engine.py``).

A save lands the state's image in POSIX shared memory; the agent's
saver persists it to storage. Restore is memory first, storage second,
with the reference's walk back over earlier step dirs when the newest
is torn.

**Where the port differs: in-place updates.** The reference hands the
live JAX arrays to its writer thread, which is safe because JAX arrays
are immutable. The port's optimizer updates params and moments in
place, so :meth:`CheckpointEngine.save_to_memory_async` snapshots
instead:

- it launches the device-to-host copy at save time into a pinned
  staging buffer, on a copy stream that first waits on the compute
  stream (the step that produced the state);
- the next in-place update must wait on that copy's event: the event is
  appended to the caller's ``fences`` list (``train_step`` waits on its
  state's ``"fences"`` before the optimizer writes), or, without a list,
  the compute stream waits on it at once;
- the writer thread receives only the staging buffer, never the live
  tensors; it waits for the copy's event, then writes shm;
- there are two staging buffers. A save takes a free one, or else the
  one whose snapshot still waits for the writer: that older snapshot is
  dropped (coalesced, logged and counted) and the newest is written.
  The buffer the writer is reading is never overwritten, and shm only
  moves forward.

``save_records()`` gives each save's blocking seconds (the launch) and
its drain (copy done, then the shm write).

**Sharded state.** A DTensor leaf is saved as this rank's local shard
with its global bounds, so each rank's image and proc file hold its
shards, as each reference process holds its addressable shards. The
storage restore (:func:`load_global_state`) reads only the regions a
target's DTensors need on this rank from whichever proc files hold
them, under any layout, and :func:`load_state_regions` reads explicit
regions.
"""

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.env_utils import get_env_int
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.fault import FaultInjected, fault_point
from dlrover_tpu_torch.flash_ckpt import storage as ckpt_storage
from dlrover_tpu_torch.flash_ckpt.autotune import SaveCostTracker
from dlrover_tpu_torch.flash_ckpt.raw_format import ShardCorruptionError
from dlrover_tpu_torch.flash_ckpt.shared_obj import (
    SharedLockClient,
    SharedQueueClient,
)
from dlrover_tpu_torch.flash_ckpt.shm_handler import (
    LeafMeta,
    SharedMemoryHandler,
    check_target_leaf,
    dtensor_bounds,
    layout,
    leaf_bytes,
    leaves_filler,
    local_tensor,
    storage_dtype,
    torch_dtype,
    tree_flatten,
    tree_unflatten,
)
from dlrover_tpu_torch.observability.registry import default_registry
from dlrover_tpu_torch.trainer.runtime import get_context

CKPT_EVENT_QUEUE = "ckpt_event"
CKPT_LOCK_PREFIX = "ckpt_shm"
STAGING_BUFFERS = 2


def shm_segment_name(local_rank: int) -> str:
    """Per-worker shm segment: the reference's name, so either package's
    agent finds it. Agent and workers of one node share NODE_RANK."""
    job = os.getenv(NodeEnv.JOB_NAME, "job")
    node_rank = os.getenv(NodeEnv.NODE_RANK, "0")
    return f"dlrover_tpu_ckpt_{job}_n{node_rank}_{local_rank}"


class SaveEvent:
    SAVE_MEM = "save_mem"
    SAVE_DISK = "save_disk"

    def __init__(self, kind: str, step: int, checkpoint_dir: str = "",
                 local_world_size: int = 1):
        self.kind = kind
        self.step = step
        self.checkpoint_dir = checkpoint_dir
        self.local_world_size = local_world_size


class _Staging:
    """One host copy of a snapshot: a pinned uint8 buffer in the image's
    data layout for the leaves on the card, filled by the copy event,
    and copies of the host leaves."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None
        self.host: list = []
        self.event = None
        self.step = -1
        self.spec = None
        self.metas = None
        self.data_bytes = 0
        self.user_meta = None
        self.launched = 0.0
        self.block_s = 0.0

    def ensure(self, nbytes: int):
        if self.buf is None or self.buf.numel() < nbytes:
            # The host allocator keeps a buffer alive until the copies
            # recorded on it complete.
            self.buf = torch.empty(nbytes, dtype=torch.uint8,
                                   pin_memory=True)


class CheckpointEngine:
    """One instance per worker process."""

    def __init__(self, checkpoint_dir: str, standalone: bool = False):
        """``standalone=True`` runs without an agent (no UDS servers):
        saves go to shm and persistence runs in this process."""
        self.checkpoint_dir = checkpoint_dir
        self._ctx = get_context()
        self._local_rank = self._ctx.local_rank
        self._shm = SharedMemoryHandler(shm_segment_name(self._local_rank))
        self._standalone = standalone
        if standalone:
            self._lock = None
            self._event_queue = None
        else:
            self._lock = SharedLockClient(
                f"{CKPT_LOCK_PREFIX}_{self._local_rank}")
            self._event_queue = SharedQueueClient(CKPT_EVENT_QUEUE)
        self._last_disk_step = -1
        # "memory" or "storage" after a successful load(), else None.
        self.last_restore_source: Optional[str] = None
        # What the last load() read: the segment's step (-1: no image)
        # and the storage tracker's (None: storage not consulted).
        self.last_restore_read: Dict[str, Optional[int]] = {}
        self._snap_cond = threading.Condition()
        # Serializes every shm write of this process (a direct save vs
        # the writer thread); the UDS lock guards against the agent only.
        self._save_mutex = threading.Lock()
        self._staging = [_Staging() for _ in range(STAGING_BUFFERS)]
        self._pending: Optional[_Staging] = None
        self._writing: Optional[_Staging] = None
        self._copy_stream = None
        self._last_launched_step = -1
        self._last_written_step = -1
        self._write_error: Optional[BaseException] = None
        self._writer_thread = None
        self._writer_stop = False
        self.dropped_snapshots = 0
        self._records: deque = deque(maxlen=4096)
        self.cost_tracker = SaveCostTracker()
        registry = default_registry()
        self._saves_counter = registry.counter(
            "flash_ckpt_memory_saves_total",
            "flash checkpoint shm saves completed")
        self._save_block_hist = registry.histogram(
            "flash_ckpt_save_block_seconds",
            "training-thread seconds blocked per shm save")
        self._restore_hist = registry.histogram(
            "flash_ckpt_restore_seconds",
            "storage restore wall seconds (read + assembly)")
        self._restore_bw_hist = registry.histogram(
            "flash_ckpt_restore_mb_per_s",
            "storage restore bandwidth (local bytes / wall seconds)",
            buckets=(1, 4, 16, 64, 256, 1024, 4096, 16384))
        self._restore_bytes = registry.counter(
            "flash_ckpt_restore_bytes_total",
            "bytes materialized by storage restores")
        self._restore_rejected = registry.counter(
            "flash_ckpt_restore_steps_rejected_total",
            "checkpoint steps rejected at restore (torn/corrupt shards)")
        self._dropped_counter = registry.counter(
            "flash_ckpt_snapshots_dropped_total",
            "async snapshots replaced by a newer one before the writer "
            "took them")
        # How many earlier step dirs a restore may fall back through.
        self._restore_fallback_steps = get_env_int(
            "DLROVER_TPU_CKPT_RESTORE_FALLBACK_STEPS", 3)

    # ---- bookkeeping -------------------------------------------------------

    @property
    def last_written_step(self) -> int:
        """Newest step committed to shm by this engine."""
        return self._last_written_step

    def save_records(self) -> List[dict]:
        """One record per committed save: step, block_s (the caller's
        blocked seconds), drain_s (launch to shm commit), copy_s (the
        device-to-host copy's wait) and write_s (the shm write)."""
        return list(self._records)

    def _stamp(self, user_meta) -> dict:
        meta = dict(user_meta or {})
        meta["process_id"] = self._ctx.process_id
        meta["num_processes"] = self._ctx.num_processes
        meta["local_rank"] = self._local_rank
        # A segment left by another job that shares the name must never
        # be restored; realpath makes spellings of one dir agree.
        meta["ckpt_dir"] = os.path.realpath(self.checkpoint_dir)
        return meta

    def _commit(self, step, spec, metas, data_bytes, fill, user_meta):
        """Write one image into shm under the agent's lock and tell the
        agent, inside a ``ckpt_save_memory`` training event. Returns the
        write's seconds."""
        from dlrover_tpu_torch.training_event import TrainerEvents

        t0 = time.monotonic()
        with TrainerEvents.ckpt_save_memory(step) as span:
            if self._lock is not None:
                self._lock.acquire()
            try:
                self._shm.write_image(step, spec, metas, data_bytes, fill,
                                      self._stamp(user_meta))
            finally:
                if self._lock is not None:
                    self._lock.release()
            if self._event_queue is not None and self._local_rank == 0:
                self._event_queue.put(SaveEvent(
                    SaveEvent.SAVE_MEM, step, self.checkpoint_dir,
                    self._ctx.local_world_size))
            write_s = time.monotonic() - t0
            span.content["write_s"] = write_s
        self._last_written_step = max(self._last_written_step, step)
        self._saves_counter.inc()
        return write_s

    # ---- save --------------------------------------------------------------

    def save_to_memory(self, step: int, state: Any,
                       user_meta: Optional[Dict[str, Any]] = None) -> float:
        """Blocking save: device -> shm. Returns the blocked seconds."""
        start = time.monotonic()
        leaves, spec = tree_flatten(state)
        metas, data_bytes = layout(leaves)
        with self._save_mutex:
            if step < self._last_written_step:
                # shm only moves forward.
                logger.warning(
                    "refusing to write step %d over newer shm step %d",
                    step, self._last_written_step)
                return 0.0
            write_s = self._commit(step, spec, metas, data_bytes,
                                   leaves_filler(leaves, metas), user_meta)
        elapsed = time.monotonic() - start
        self.cost_tracker.record_block(elapsed)
        self.cost_tracker.record_drain(elapsed)
        self._save_block_hist.observe(elapsed)
        self._records.append({"step": step, "block_s": elapsed,
                              "drain_s": elapsed, "copy_s": 0.0,
                              "write_s": write_s, "async": False})
        return elapsed

    def save_to_memory_async(self, step: int, state: Any,
                             user_meta: Optional[Dict[str, Any]] = None,
                             fences: Optional[list] = None) -> float:
        """Non-blocking save: launch the device-to-host copy and return.

        The copy waits on the current stream (the step that produced
        ``state``) and runs on a copy stream into a staging buffer; a
        writer thread lands it in shm. ``fences``: a list to which the
        copy's event is appended; the caller's next in-place write to
        ``state`` must wait on it (``train_step`` does, for its state's
        ``"fences"``). Without a list the current stream waits on the
        event now. Returns the blocked seconds (the launch)."""
        start = time.monotonic()
        leaves, spec = tree_flatten(state)
        metas, data_bytes = layout(leaves)
        leaves = [local_tensor(leaf) for leaf in leaves]
        on_card = [isinstance(leaf, torch.Tensor) and leaf.is_cuda
                   for leaf in leaves]
        devices = {leaf.device for leaf, c in zip(leaves, on_card) if c}
        if len(devices) > 1:
            raise ValueError(f"state spans devices {devices}")
        with self._snap_cond:
            slot = next((s for s in self._staging
                         if s is not self._pending
                         and s is not self._writing), None)
            if slot is None:
                slot, self._pending = self._pending, None
                self._drop(slot.step, step)
        event = None
        if devices:
            device = devices.pop()
            slot.ensure(data_bytes)
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device)
            compute = torch.cuda.current_stream(device)
            self._copy_stream.wait_stream(compute)
            with torch.cuda.stream(self._copy_stream):
                for leaf, meta, c in zip(leaves, metas, on_card):
                    if c:
                        shard = meta.shards[0]
                        slot.buf[shard.offset:shard.offset + shard.nbytes
                                 ].copy_(leaf_bytes(leaf), non_blocking=True)
                        leaf.record_stream(self._copy_stream)
                event = torch.cuda.Event()
                event.record(self._copy_stream)
            if fences is not None:
                fences.append(event)
            else:
                compute.wait_event(event)
        # Host leaves (AdamW's step counts, ints) are copied now: the
        # host updates them in place before the device catches up.
        slot.host = [(meta.shards[0], leaf_bytes(leaf).clone())
                     for leaf, meta, c in zip(leaves, metas, on_card)
                     if not c]
        slot.event, slot.step, slot.spec, slot.metas = event, step, spec, metas
        slot.data_bytes, slot.user_meta = data_bytes, user_meta
        slot.launched = start
        slot.block_s = time.monotonic() - start
        with self._snap_cond:
            if self._pending is not None:
                self._drop(self._pending.step, step)
            self._pending = slot
            self._last_launched_step = step
            self._ensure_writer()
            self._snap_cond.notify_all()
        self.cost_tracker.record_block(slot.block_s)
        self._save_block_hist.observe(slot.block_s)
        return slot.block_s

    def _drop(self, dropped: int, step: int):
        logger.info("dropping unwritten snapshot of step %d for step %d",
                    dropped, step)
        self.dropped_snapshots += 1
        self._dropped_counter.inc()

    def recommended_interval_s(self, mtbf_s: float = 3600.0):
        """Young/Daly save cadence from this engine's measured costs."""
        return self.cost_tracker.recommended_interval_s(mtbf_s)

    def wait_async_save(self, timeout: float = 600.0) -> bool:
        """Block until every launched snapshot has landed in shm. False
        on timeout or if the last write failed."""
        deadline = time.monotonic() + timeout
        with self._snap_cond:
            while self._pending is not None or self._writing is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._snap_cond.wait(min(remaining, 1.0))
            return self._write_error is None

    def _ensure_writer(self):
        if self._writer_thread is None or not self._writer_thread.is_alive():
            self._writer_stop = False
            self._writer_thread = threading.Thread(
                target=self._writer_loop, name="ckpt-writer", daemon=True)
            self._writer_thread.start()

    def _writer_loop(self):
        while True:
            with self._snap_cond:
                while self._pending is None:
                    if self._writer_stop:
                        return
                    self._snap_cond.wait(1.0)
                slot, self._pending = self._pending, None
                self._writing = slot
            try:
                self._write_snapshot(slot)
                with self._snap_cond:
                    self._write_error = None
            except Exception as e:
                logger.exception("async snapshot write failed")
                with self._snap_cond:
                    self._write_error = e
            finally:
                with self._snap_cond:
                    self._writing = None
                    self._snap_cond.notify_all()

    def _write_snapshot(self, slot: _Staging):
        t0 = time.monotonic()
        if slot.event is not None:
            slot.event.synchronize()
        copy_s = time.monotonic() - t0

        def fill(data):
            if slot.event is not None:
                data.copy_(slot.buf[:slot.data_bytes])
            for shard, host in slot.host:
                data[shard.offset:shard.offset + shard.nbytes].copy_(host)

        with self._save_mutex:
            if slot.step <= self._last_written_step:
                # A direct save of a newer step landed first.
                logger.info("skipping stale async snapshot of step %d "
                            "(step %d already in shm)", slot.step,
                            self._last_written_step)
                return
            write_s = self._commit(slot.step, slot.spec, slot.metas,
                                   slot.data_bytes, fill, slot.user_meta)
        drain_s = time.monotonic() - slot.launched
        self.cost_tracker.record_drain(drain_s)
        self._records.append({"step": slot.step, "block_s": slot.block_s,
                              "drain_s": drain_s, "copy_s": copy_s,
                              "write_s": write_s, "async": True})

    def save_to_storage(self, step: int, state: Any,
                        user_meta: Optional[Dict[str, Any]] = None) -> float:
        """Land ``step`` in shm, then request its persistence. A step
        just launched by :meth:`save_to_memory_async` is waited for, not
        copied again. Returns the blocked seconds."""
        start = time.monotonic()
        if not (step == self._last_launched_step and self.wait_async_save()
                and self._last_written_step == step):
            self.save_to_memory(step, state, user_meta)
        elapsed = time.monotonic() - start
        prev_disk_step = self._last_disk_step
        self._last_disk_step = step
        if self._standalone:
            # One persister per node, as on the agent path.
            if self._local_rank == 0 and not self._persist_in_process(step):
                logger.error("standalone persist of step %d failed; the "
                             "disk checkpoint for this step was NOT "
                             "committed", step)
                self._last_disk_step = prev_disk_step
        elif self._local_rank == 0:
            self._event_queue.put(SaveEvent(
                SaveEvent.SAVE_DISK, step, self.checkpoint_dir,
                self._ctx.local_world_size))
        return elapsed

    def _persist_in_process(self, step: int) -> bool:
        from dlrover_tpu_torch.flash_ckpt.saver import persist_shm_to_storage

        node_rank = int(os.getenv(NodeEnv.NODE_RANK, "0"))
        if not self._wait_local_segments(step, timeout=30.0):
            logger.error("not all %d local shm segments reached step %d "
                         "within 30s; aborting standalone persist",
                         self._ctx.local_world_size, step)
            return False
        expected = list(self._ctx.node_ranks) or [node_rank]
        commit_timeout = get_env_int("DLROVER_TPU_CKPT_COMMIT_TIMEOUT_S", 30)
        return persist_shm_to_storage(
            self.checkpoint_dir, step, node_rank,
            local_world_size=self._ctx.local_world_size,
            expected_nodes=expected, commit_timeout=float(commit_timeout))

    def _wait_local_segments(self, step: int, timeout: float) -> bool:
        """True once every local worker's segment holds >= ``step``."""
        deadline = time.time() + timeout
        handlers = {
            lr: SharedMemoryHandler(shm_segment_name(lr))
            for lr in range(self._ctx.local_world_size)
            if lr != self._local_rank
        }
        try:
            polls = 0
            while True:
                ready = True
                for handler in handlers.values():
                    if handler.get_step() < step:
                        ready = False
                        if polls and polls % 20 == 0:
                            handler.close()  # re-attach next poll
                        break
                if ready:
                    return True
                if time.time() >= deadline:
                    return False
                polls += 1
                time.sleep(0.05)
        finally:
            for handler in handlers.values():
                handler.close()

    # ---- load --------------------------------------------------------------

    def load(self, step: Optional[int] = None, target=None):
        """(step, state, user_meta), or None.

        Memory first (the segment survives worker restarts on this
        host), then the committed storage checkpoint. ``target``: a tree
        of the checkpoint's structure whose tensors are filled in place
        (see ``shm_handler.fill_tree``); without it the leaves come back
        as host tensors."""
        from dlrover_tpu_torch.training_event import TrainerEvents

        self.last_restore_read = {"shm_step": -1, "tracker_step": None}
        result = self._load_from_memory(step, target)
        if result is not None:
            logger.info("restored step %d from host memory", result[0])
            self.last_restore_source = "memory"
            TrainerEvents.ckpt_restore(result[0], "memory")
            return result
        result = self._load_from_storage(step, target)
        if result is not None:
            logger.info("restored step %d from storage", result[0])
            self.last_restore_source = "storage"
            TrainerEvents.ckpt_restore(result[0], "storage")
        return result

    def _load_from_memory(self, step=None, target=None):
        try:
            fault_point("ckpt.restore.memory", step=step)
        except FaultInjected:
            # The host (and its shm) was replaced: storage must carry
            # the recovery.
            logger.warning("chaos: shm image treated as lost")
            return None
        mem_step = self._shm.get_step()
        self.last_restore_read["shm_step"] = mem_step
        if mem_step < 0 or (step is not None and mem_step != step):
            return None
        meta = self._shm.load_meta()
        if meta is None:
            return None
        user_meta = meta.get("user_meta", {})
        if self._is_foreign_image(user_meta):
            logger.warning("ignoring shm image of foreign checkpoint %s",
                           user_meta.get("ckpt_dir"))
            return None
        if user_meta.get("num_processes") != self._ctx.num_processes:
            # World changed: storage has the complete picture.
            return None
        if not _image_fits(meta["leaves"], target):
            # Another layout (or no target for sharded leaves): the
            # resharding restore reads storage.
            return None
        loaded = self._shm.load_state_dict(target)
        if loaded is None:
            return None
        return loaded

    def _load_from_storage(self, step=None, target=None):
        """Restore the requested (or tracker) step; when that step's
        shard files are torn or incomplete and no step was demanded,
        fall back to the newest earlier step dir that restores."""
        want = step
        if want is None:
            want = ckpt_storage.read_tracker(self.checkpoint_dir)
            self.last_restore_read["tracker_step"] = want
        if want < 0:
            return None
        candidates = [want]
        if step is None:
            candidates += [
                s for s in sorted(
                    ckpt_storage.list_step_dirs(self.checkpoint_dir),
                    reverse=True)
                if s < want
            ][:self._restore_fallback_steps]
        for i, cand in enumerate(candidates):
            metas = ckpt_storage.load_step_meta(self.checkpoint_dir, cand)
            if not metas:
                continue
            start = time.time()
            result = load_global_state(self.checkpoint_dir, cand, metas,
                                       target)
            if result is None:
                self._restore_rejected.inc()
                logger.error("checkpoint step %d is not restorable "
                             "(torn/corrupt/incomplete shards); trying an "
                             "earlier step", cand)
                continue
            if i > 0:
                logger.warning("restored FALLBACK step %d (newest step %d "
                               "was unrestorable)", cand, want)
            elapsed = max(time.time() - start, 1e-9)
            nbytes = state_nbytes(result[1])
            self._restore_hist.observe(elapsed)
            self._restore_bytes.inc(nbytes)
            self._restore_bw_hist.observe(nbytes / 1e6 / elapsed)
            return result
        return None

    def _is_foreign_image(self, meta: dict) -> bool:
        stamped = meta.get("ckpt_dir")
        return stamped is not None and stamped != os.path.realpath(
            self.checkpoint_dir)

    def latest_step(self) -> int:
        """Newest restorable step (max of shm image and storage
        tracker); a foreign job's image is not ours to advertise."""
        mem_step = -1
        meta = self._shm.load_meta()
        if meta is not None and not self._is_foreign_image(
                meta.get("user_meta", {})):
            mem_step = meta.get("step", -1)
        return max(mem_step, ckpt_storage.read_tracker(self.checkpoint_dir))

    def close(self):
        drained = self.wait_async_save(timeout=60.0)
        with self._snap_cond:
            self._writer_stop = True
            self._snap_cond.notify_all()
        if not drained:
            logger.error("async snapshot did not drain cleanly before "
                         "close; the newest launched step may not be "
                         "restorable from memory")
        if self._writer_thread is not None:
            self._writer_thread.join(timeout=10.0)
            if self._writer_thread.is_alive():
                # Never close the segment under a write in progress.
                logger.error("ckpt writer still running at close; leaving "
                             "shm open")
                return
        self._shm.close()


def _image_fits(leaf_metas, target) -> bool:
    """True when each image leaf's one shard is what ``target`` needs on
    this rank (the whole leaf where the target is not a DTensor)."""
    if target is None:
        return all(lm.replicated for lm in leaf_metas)
    targets, _ = tree_flatten(target)
    if len(targets) != len(leaf_metas):
        return True  # fill_tree reports the mismatch
    for dst, lm in zip(targets, leaf_metas):
        if not isinstance(dst, torch.Tensor):
            continue
        want = dtensor_bounds(dst) or tuple((0, n) for n in lm.global_shape)
        if tuple(lm.shards[0].index) != tuple(want):
            return False
    return True


def state_nbytes(state) -> int:
    """Bytes of the tensors this rank holds (local shards of DTensors)."""
    leaves, _ = tree_flatten(state)
    return sum(local_tensor(leaf).numel() * leaf.element_size()
               for leaf in leaves if isinstance(leaf, torch.Tensor))


# ---- the resharding restore ------------------------------------------------


def _norm_bounds(bounds, global_shape):
    """Close open slice ends: ((0,None),) over (8,) -> ((0,8),)."""
    return tuple(
        (lo if lo is not None else 0, hi if hi is not None else dim)
        for (lo, hi), dim in zip(bounds, global_shape)
    )


def _intersect_bounds(a, b):
    """Intersection of two closed bounds tuples, or None if empty."""
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def _bounds_volume(b) -> int:
    vol = 1
    for lo, hi in b:
        vol *= hi - lo
    return vol


def _tiles_exactly(region, inters) -> bool:
    """True if ``inters`` (intersections already clipped to ``region``)
    are pairwise disjoint and their volumes sum to the region's: a proof
    of full coverage without a per-element mask."""
    if sum(_bounds_volume(b) for b in inters) != _bounds_volume(region):
        return False
    for i in range(len(inters)):
        for j in range(i + 1, len(inters)):
            if _intersect_bounds(inters[i], inters[j]) is not None:
                return False
    return True


def _needed_region_bounds(leaf, global_shape):
    """The index bounds this rank must materialize for a target leaf: a
    DTensor's local shard (from its placements), the whole leaf
    otherwise."""
    return [dtensor_bounds(leaf) or tuple((0, d) for d in global_shape)]


class _LazyReaders:
    """Opens a process's shard file on first use, not up front: after a
    re-mesh a partial restore may need bytes from a handful of the proc
    files, and opening all of them puts O(world size) metadata I/O on
    the restore. Counts the bytes read."""

    def __init__(self, checkpoint_dir: str, step: int, pids):
        self._dir = checkpoint_dir
        self._step = step
        self._pids = set(pids)
        self._lock = threading.Lock()
        self._open: Dict[int, Any] = {}
        self._missing = set()
        self.bytes_read = 0

    def get(self, pid: int):
        if pid not in self._pids or pid in self._missing:
            return None
        with self._lock:
            reader = self._open.get(pid)
            if reader is None and pid not in self._missing:
                reader = ckpt_storage.open_proc_shards(
                    self._dir, self._step, pid)
                if reader is None:
                    self._missing.add(pid)
                else:
                    self._open[pid] = reader
            return reader

    def count(self, nbytes: int):
        with self._lock:
            self.bytes_read += nbytes

    def close_all(self):
        with self._lock:
            for reader in self._open.values():
                reader.close()
            self._open.clear()


def _index_shard_locations(metas: Dict[int, dict]):
    """(leaf_info, locations) from per-process metas: leaf_info[i] =
    (global_shape, dtype_name); locations[i] = [(pid, key, closed shard
    bounds), ...]."""
    first = metas[min(metas)]
    num_leaves = len(first["leaves"])
    leaf_info = [None] * num_leaves
    locations = [[] for _ in range(num_leaves)]
    for pid, meta in sorted(metas.items()):
        for leaf_meta in meta["leaves"]:
            i = leaf_meta.leaf_id
            gshape = tuple(leaf_meta.global_shape)
            leaf_info[i] = (gshape, leaf_meta.dtype)
            for j, shard in enumerate(leaf_meta.shards):
                locations[i].append(
                    (pid, f"leaf{i}_shard{j}",
                     _norm_bounds(shard.index, gshape)))
    return leaf_info, locations


def _assemble_leaf_regions(info, shard_locs, readers, region_bounds_list):
    """Read exactly the byte ranges covering ``region_bounds_list`` for
    one leaf (host memory O(region bytes), never the global shape).
    Returns {bounds: array of the stored dtype}, or None if a region is
    not fully covered by the stored shards. Raises
    ``ShardCorruptionError`` when a proc file's bounds disagree with its
    meta's, or two stored copies of one element disagree."""
    gshape, dtype_name = info
    dtype = storage_dtype(dtype_name)
    regions = {}
    for rb in region_bounds_list:
        shape = tuple(hi - lo for lo, hi in rb)
        if 0 in shape:
            regions[rb] = np.empty(shape, dtype=dtype)
            continue
        # The stored shards that intersect this region; identical
        # intersections (a replicated shard in every proc file) are read
        # once.
        hits = []
        seen_inter = set()
        for pid, key, sb in shard_locs:
            inter = _intersect_bounds(rb, sb) if shape else ()
            if inter is None or inter in seen_inter:
                continue
            reader = readers.get(pid)
            if reader is None or key not in reader:
                continue
            stored = reader.bounds(key)
            if stored is not None and _norm_bounds(stored, gshape) != sb:
                raise ShardCorruptionError(
                    f"proc {pid} {key}: file bounds {stored} differ from "
                    f"its meta's {sb}")
            seen_inter.add(inter)
            hits.append((reader, key, inter, sb))
        if not hits:
            return None
        out = np.empty(shape, dtype=dtype)
        if not shape:
            hits[0][0].read_slice_into(hits[0][1], (), out, verify=True)
            readers.count(out.nbytes)
            regions[rb] = out
            continue
        exact = _tiles_exactly(rb, [h[2] for h in hits])
        covered = None if exact else np.zeros(shape, dtype=bool)
        for reader, key, inter, sb in hits:
            src = tuple(slice(lo - s0, hi - s0)
                        for (lo, hi), (s0, _) in zip(inter, sb))
            dst = tuple(slice(lo - r0, hi - r0)
                        for (lo, hi), (r0, _) in zip(inter, rb))
            if covered is None:
                # Full-shard reads checksum the copied bytes.
                reader.read_slice_into(key, src, out[dst],
                                       verify=(inter == sb))
            else:
                part = np.empty(tuple(hi - lo for lo, hi in inter), dtype)
                reader.read_slice_into(key, src, part, verify=(inter == sb))
                seen = covered[dst]
                if not np.array_equal(out[dst][seen], part[seen]):
                    raise ShardCorruptionError(
                        f"{key}: stored copies of region {inter} disagree")
                out[dst] = part
                covered[dst] = True
            readers.count(_bounds_volume(inter) * dtype.itemsize)
        if covered is not None and not covered.all():
            return None
        regions[rb] = out
    return regions


def _host_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """A host tensor of dtype ``name`` over a stored-dtype array."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return torch.from_numpy(flat).view(torch_dtype(name)).reshape(arr.shape)


def load_global_state(checkpoint_dir: str, step: int, metas: Dict[int, dict],
                      target=None, stats: Optional[dict] = None):
    """The state of ``step`` from its shard files, under any layout.

    Without ``target``: whole host leaves (every byte is read). With
    ``target`` (a tree of the checkpoint's structure): each DTensor
    leaf's local shard is filled in place from only the byte ranges its
    bounds intersect, read from whichever proc files hold them; other
    tensor leaves are filled whole. A step the JAX package wrote (its
    metas carry a JAX tree definition, not the port's tree spec)
    restores into a ``target``. Full-shard reads are checked against
    their sum64. ``stats["bytes_read"]`` receives the bytes read.
    Returns (step, state, user_meta), or None when a file is missing,
    torn or corrupt, or a needed region is not covered."""
    first = metas[min(metas)]
    spec = first.get("treespec")
    leaf_info, locations = _index_shard_locations(metas)
    targets = None
    if target is not None:
        targets, target_spec = tree_flatten(target)
        if (spec is not None and target_spec != spec) or len(
                targets) != len(leaf_info):
            raise ValueError("restore target's tree differs from the "
                             "checkpoint's")
        spec = target_spec
    if spec is None:
        logger.error("step %d holds another package's tree; restore it "
                     "into a target", step)
        return None
    if any(info is None for info in leaf_info):
        return None

    def regions_for(i):
        gshape = leaf_info[i][0]
        if targets is None or not isinstance(targets[i], torch.Tensor):
            return [tuple((0, d) for d in gshape)]
        return _needed_region_bounds(targets[i], gshape)

    readers = _LazyReaders(checkpoint_dir, step, metas)
    try:
        with ThreadPoolExecutor(
                max_workers=ckpt_storage.io_threads(max(len(leaf_info), 1)),
                thread_name_prefix="ckpt-restore") as pool:
            futures = [pool.submit(_assemble_leaf_regions, leaf_info[i],
                                   locations[i], readers, regions_for(i))
                       for i in range(len(leaf_info))]
            regions = [fut.result() for fut in futures]
    except (ShardCorruptionError, KeyError) as e:
        logger.error("refusing corrupt checkpoint step %d: %s", step, e)
        return None
    finally:
        readers.close_all()
    if stats is not None:
        stats["bytes_read"] = readers.bytes_read
    if any(r is None for r in regions):
        logger.error("step %d: a needed region is not covered by the "
                     "stored shards", step)
        return None
    leaves = []
    for i, region in enumerate(regions):
        (arr,) = region.values()
        host = _host_tensor(arr, leaf_info[i][1])
        dst = None if targets is None else targets[i]
        if isinstance(dst, torch.Tensor):
            check_target_leaf(dst, LeafMeta(i, *leaf_info[i]))
            with torch.no_grad():
                local_tensor(dst).copy_(host)
            leaves.append(dst)
        else:
            leaves.append(host)
    return step, tree_unflatten(spec, leaves), first.get("user_meta", {})


def load_state_regions(checkpoint_dir: str, step: int,
                       regions_by_leaf: Optional[Dict[int, list]] = None):
    """Explicit-region partial restore (the reference's): leaf_id -> a
    list of closed bounds tuples; leaves absent from the map are read in
    full. Reads only the intersecting byte ranges. Returns ``(step,
    leaves, user_meta)`` with ``leaves[leaf_id] = {bounds: array}`` (bf16
    as its uint16 bits), or None when the step is missing, torn or does
    not cover a requested region."""
    metas = ckpt_storage.load_step_meta(checkpoint_dir, step)
    if not metas:
        return None
    first = metas[min(metas)]
    leaf_info, locations = _index_shard_locations(metas)
    regions_by_leaf = regions_by_leaf or {}
    readers = _LazyReaders(checkpoint_dir, step, metas)
    leaves: Dict[int, dict] = {}
    try:
        for i, info in enumerate(leaf_info):
            if info is None:
                return None
            bounds_list = regions_by_leaf.get(i) or [
                tuple((0, d) for d in info[0])]
            bounds_list = [tuple(tuple(b) for b in bounds)
                           for bounds in bounds_list]
            regions = _assemble_leaf_regions(info, locations[i], readers,
                                             bounds_list)
            if regions is None:
                logger.error("step %d leaf %d: requested regions not "
                             "covered by stored shards", step, i)
                return None
            leaves[i] = regions
    except ShardCorruptionError as e:
        logger.error("refusing corrupt checkpoint step %d: %s", step, e)
        return None
    finally:
        readers.close_all()
    return step, leaves, first.get("user_meta", {})
