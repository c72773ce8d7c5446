"""Elastic data loaders: batches that keep the global batch fixed (the
port of ``dlrover_tpu/trainer/elastic/dataloader.py``). The loaders
yield stacked numpy batches selected by an ElasticDistributedSampler;
:func:`device_put_prefetch` moves them to the card.

Two loaders:

- :class:`ElasticDataLoader` — the simple synchronous path (fetch and
  ``np.stack`` in the training thread), kept as the A/B baseline.
- :class:`PrefetchingDataLoader` — batches are assembled in a background
  thread into a ring of reusable preallocated buffers (no per-batch
  ``np.stack`` allocation churn) with a bounded depth, so record fetch
  and batch assembly overlap the training step. Buffer ownership rule:
  a yielded batch's arrays are views into ring buffers and stay valid
  ONLY until the next batch is requested; anything that must outlive
  that must copy explicitly — :func:`device_put_prefetch` does.
"""

import queue
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from dlrover_tpu_torch.trainer.elastic.sampler import (
    ElasticDistributedSampler,
)

_END = object()


class ElasticDataLoader:
    def __init__(
        self,
        fetch_record: Callable[[int], dict],
        sampler: ElasticDistributedSampler,
        per_host_batch_size: int,
    ):
        """``fetch_record(index) -> dict of np arrays`` is the user's
        record accessor (memory-mapped file, array slice, ...)."""
        self._fetch = fetch_record
        self.sampler = sampler
        self.per_host_batch_size = per_host_batch_size

    @property
    def global_batch_size(self) -> int:
        return self.per_host_batch_size * self.sampler.world_size

    def __iter__(self) -> Iterator[dict]:
        batch = []
        for index in self.sampler:
            batch.append(self._fetch(index))
            if len(batch) == self.per_host_batch_size:
                # Advance the cursor BEFORE yielding: a checkpoint taken
                # after training on this batch must count it, or resume
                # would replay the same records.
                self.sampler.record_batch(self.global_batch_size)
                yield self._stack(batch)
                batch = []
        # Trailing partial batch dropped: static shapes.

    def __len__(self) -> int:
        return len(self.sampler) // self.per_host_batch_size

    @staticmethod
    def _stack(records) -> dict:
        keys = records[0].keys()
        return {
            k: np.stack([np.asarray(r[k]) for r in records]) for k in keys
        }


class PrefetchingDataLoader:
    """Double-buffered batch assembly over any record-index source.

    A background assembler thread pulls indices from ``index_source``
    (a sampler, or any iterable of ints), fetches records — optionally
    through a small thread pool —
    and writes them row-by-row into one of ``depth + 1`` preallocated
    buffer sets. Ready batches wait in a bounded queue; the consumer
    recycles the previously yielded buffer set each time it asks for the
    next batch.

    ``sampler``: when given, ``sampler.record_batch(global_batch)`` is
    called as each batch is YIELDED (not when it is assembled) so
    checkpoint cursors count exactly the batches handed to training —
    batches sitting assembled-but-unconsumed in the ring are not counted.
    """

    def __init__(
        self,
        fetch_record: Callable[[int], dict],
        index_source: Iterable[int],
        per_host_batch_size: int,
        depth: int = 2,
        num_workers: int = 0,
        sampler: Optional[ElasticDistributedSampler] = None,
        world_size: int = 1,
    ):
        if per_host_batch_size <= 0:
            raise ValueError("per_host_batch_size must be positive")
        self._fetch = fetch_record
        self._source = index_source
        self.per_host_batch_size = per_host_batch_size
        self.depth = max(depth, 1)
        self._num_workers = max(num_workers, 0)
        self.sampler = sampler
        self._world_size = (
            sampler.world_size if sampler is not None else max(world_size, 1)
        )
        # depth ready slots + the one the consumer currently holds.
        self._nslots = self.depth + 1
        self._buffers: list = [None] * self._nslots
        self._free: "queue.Queue[int]" = queue.Queue()
        self._ready: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pool = None
        from dlrover_tpu_torch.observability.registry import (
            default_registry,
        )

        reg = default_registry()
        self._assembly_hist = reg.histogram(
            "data_batch_assembly_seconds",
            "wall time to assemble one host batch into the ring",
        )
        self._batch_wait = reg.counter(
            "data_batch_wait_seconds_total",
            "seconds the training thread waited for an assembled batch",
        )
        self._batches_total = reg.counter(
            "data_batches_total", "host batches yielded to training"
        )
        self._ring_depth = reg.gauge(
            "data_ready_batches", "assembled batches waiting for training"
        )

    @property
    def global_batch_size(self) -> int:
        return self.per_host_batch_size * self._world_size

    # ---- assembler thread --------------------------------------------------

    def _alloc_slot(self, slot: int, proto: Dict[str, np.ndarray]):
        self._buffers[slot] = {
            k: np.empty(
                (self.per_host_batch_size,) + v.shape, dtype=v.dtype
            )
            for k, v in proto.items()
        }

    def _assemble_loop(self):
        try:
            rows_iter = iter(self._source)
            proto: Optional[Dict[str, np.ndarray]] = None
            while not self._stopped.is_set():
                try:
                    slot = self._free.get(timeout=0.2)
                except queue.Empty:
                    continue
                t0 = time.monotonic()
                indices = []
                for index in rows_iter:
                    indices.append(index)
                    if len(indices) == self.per_host_batch_size:
                        break
                    if self._stopped.is_set():
                        return
                if self._stopped.is_set():
                    return
                if len(indices) < self.per_host_batch_size:
                    # Trailing partial batch dropped: static shapes
                    # (same contract as ElasticDataLoader).
                    break
                if self._pool is not None:
                    records = list(self._pool.map(self._fetch, indices))
                else:
                    records = [self._fetch(i) for i in indices]
                if proto is None:
                    proto = {
                        k: np.asarray(v) for k, v in records[0].items()
                    }
                if self._buffers[slot] is None:
                    self._alloc_slot(slot, proto)
                buf = self._buffers[slot]
                for row, rec in enumerate(records):
                    for k in buf:
                        buf[k][row] = rec[k]
                self._assembly_hist.observe(time.monotonic() - t0)
                self._put_ready((slot, None))
        except Exception as exc:  # noqa: BLE001 — surfaced to consumer
            self._put_ready((None, exc))
            return
        self._put_ready(_END)

    def _put_ready(self, item):
        while not self._stopped.is_set():
            try:
                self._ready.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    # ---- consumer ----------------------------------------------------------

    def __iter__(self) -> Iterator[dict]:
        if self._thread is not None:
            raise RuntimeError(
                "PrefetchingDataLoader is single-pass: its index source "
                "is consumed and its ring retired; build a new loader "
                "per epoch"
            )
        if self._num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self._num_workers,
                thread_name_prefix="data-fetch",
            )
        for slot in range(self._nslots):
            self._free.put(slot)
        self._thread = threading.Thread(
            target=self._assemble_loop,
            daemon=True,
            name="batch-assembler",
        )
        self._thread.start()
        held: Optional[int] = None
        try:
            while True:
                t0 = time.monotonic()
                while True:
                    try:
                        item = self._ready.get(timeout=0.2)
                        break
                    except queue.Empty:
                        if self._stopped.is_set():
                            # stop() from another thread while we were
                            # blocked: the assembler's sentinel may have
                            # been dropped — end cleanly, don't hang.
                            self._batch_wait.inc(time.monotonic() - t0)
                            return
                self._batch_wait.inc(time.monotonic() - t0)
                self._ring_depth.set(self._ready.qsize())
                if held is not None:
                    # The consumer is done with the previous buffers —
                    # only now may the assembler overwrite them.
                    self._free.put(held)
                    held = None
                if item is _END:
                    return
                slot, err = item
                if err is not None:
                    raise err
                held = slot
                if self.sampler is not None:
                    # Cursor advances when training RECEIVES the batch,
                    # mirroring ElasticDataLoader's resume contract.
                    self.sampler.record_batch(self.global_batch_size)
                self._batches_total.inc()
                yield self._buffers[slot]
        finally:
            if held is not None:
                self._free.put(held)
            self.stop()

    def stop(self):
        self._stopped.set()
        if self._thread is not None:
            # Short join: the assembler polls _stopped between queue ops
            # and index yields, but an index SOURCE wedged inside a
            # blocking call can't be interrupted — abandon the daemon
            # thread rather than stall teardown behind it.
            self._thread.join(timeout=1.0)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None


def device_put_prefetch(batches, device="cuda", depth: int = 2):
    """Double-buffered host-to-device transfers: the copy of batch n+1
    is enqueued before batch n is handed to the caller, so it overlaps
    the step on batch n.

    On the card each batch is first copied into one of ``depth`` pinned
    ring slots, then sent ``non_blocking`` on a side stream; a slot is
    reused only after its copy's event has completed, and the caller's
    (current) stream waits on that event before the batch is handed
    over. The yielded tensors are recorded on the caller's stream, so
    the allocator keeps them until its work on them is done. Safe over
    reusable ring buffers (:class:`PrefetchingDataLoader`): every host
    batch is copied before the next is requested. On the CPU each batch
    is a copy of the host batch."""
    device = torch.device(device)
    if device.type != "cuda":
        for host_batch in batches:
            yield {k: torch.from_numpy(np.array(v))
                   for k, v in host_batch.items()}
        return
    stream = torch.cuda.Stream(device)
    slots = [None] * max(depth, 1)
    events = [None] * len(slots)
    prev = None
    for n, host_batch in enumerate(batches):
        i = n % len(slots)
        if events[i] is not None:
            events[i].synchronize()
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in host_batch.items()}
        if slots[i] is None:
            slots[i] = {k: torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True)
                        for k, t in host.items()}
        for k, t in host.items():
            slots[i][k].copy_(t)
        with torch.cuda.stream(stream):
            dev = {k: t.to(device, non_blocking=True)
                   for k, t in slots[i].items()}
            events[i] = torch.cuda.Event()
            events[i].record(stream)
        if prev is not None:
            yield _hand_over(*prev, device)
        prev = (dev, events[i])
    if prev is not None:
        yield _hand_over(*prev, device)


def _hand_over(batch, event, device):
    compute = torch.cuda.current_stream(device)
    compute.wait_event(event)
    for t in batch.values():
        t.record_stream(compute)
    return batch
