"""Worker-side dynamic data sharding client.

Parity: reference dlrover/python/elastic_agent/sharding/client.py
(ShardingClient:29, IndexShardingClient:232) — workers pull record-range
tasks from the master's TaskManager instead of statically partitioning
the dataset, so shards owned by a dead/slow worker are re-dispatched and
elasticity needs no data re-splitting.

Pipelined: a background prefetcher keeps a bounded queue of shard leases
in flight (fetched ``fetch_batch`` at a time through the batched
``get_tasks`` verb) and done-reports are coalesced into batched RPCs, so
the training thread never blocks on a master round trip at a shard
boundary. Lease lifecycle and flush-ordering rules are documented in
docs/DESIGN.md §24:

- a lease lives in the master's ``doing`` table from the moment the
  batched fetch returns it, so a worker dying with prefetched-but-
  unconsumed leases gets them re-queued by ``recover_node_tasks``;
- pending done-reports are force-flushed before every fetch RPC, on a
  WAIT response, and before ``get_shard_checkpoint`` — the checkpoint
  must never hold a shard this worker already finished;
- the WAIT poll backs off with jitter inside the prefetcher thread,
  never the training thread.

The port's copy of ``dlrover_tpu/trainer/elastic/sharding_client.py``:
the same leases, reports, snapshots and metric names, against the
port's master client.
"""

import queue
import random
import threading
import time
from typing import Iterator, List, Optional

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.fault import fault_point

# End-of-dataset sentinel in the prefetch queue (left in the queue so
# every later fetch also sees it).
_END = object()


def _data_metrics():
    from dlrover_tpu_torch.observability.registry import default_registry

    reg = default_registry()
    return {
        "fetch_wait": reg.counter(
            "data_fetch_wait_seconds_total",
            "seconds the training thread waited for a shard lease",
        ),
        "queue_depth": reg.gauge(
            "data_prefetch_queue_depth",
            "shard leases currently prefetched and unconsumed",
        ),
        "tasks_fetched": reg.counter(
            "data_shard_tasks_fetched_total",
            "shard leases fetched from the master",
        ),
        "fetch_rpcs": reg.counter(
            "data_fetch_rpcs_total", "get-task round trips issued"
        ),
        "report_rpcs": reg.counter(
            "data_report_rpcs_total", "done-report round trips issued"
        ),
        "rpcs_saved": reg.counter(
            "data_rpcs_saved_total",
            "control RPCs avoided by task/report batching",
        ),
    }


class ShardingClient:
    """Task-granular client: fetch a shard, process it, report done.

    ``prefetch_depth=0`` disables the pipeline entirely (synchronous
    fetch, immediate reports) — the pre-batching behavior, kept for A/B
    benchmarking and as a debugging escape hatch.
    """

    def __init__(
        self,
        master_client,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        task_type: str = "training",
        prefetch_depth: int = 16,
        fetch_batch: int = 8,
        report_batch: int = 8,
        report_interval_s: float = 2.0,
        wait_backoff_s: float = 0.2,
        wait_backoff_max_s: float = 2.0,
        wait_flush_age_s: float = 0.25,
    ):
        self._client = master_client
        self.dataset_name = dataset_name
        self._current_task: Optional[comm.ShardTask] = None
        self._prefetch_depth = max(prefetch_depth, 0)
        self._fetch_batch = max(fetch_batch, 1)
        self._report_batch = max(report_batch, 1)
        self._report_interval_s = report_interval_s
        self._wait_backoff_s = wait_backoff_s
        self._wait_backoff_max_s = wait_backoff_max_s
        self._wait_flush_age_s = wait_flush_age_s
        self._queue: "queue.Queue" = queue.Queue(
            maxsize=self._prefetch_depth or 1
        )
        self._stopped = threading.Event()
        self._prefetcher: Optional[threading.Thread] = None
        self._prefetcher_lock = threading.Lock()
        # Coalesced done-reports (flushed on count/interval/WAIT/ckpt).
        # _report_lock guards the pending lists; _flush_lock is held
        # across the whole swap+RPC so "flush" means FLUSHED, not
        # "someone else's flush is still in flight" (lock order:
        # _flush_lock -> _report_lock, never the reverse).
        self._report_lock = threading.Lock()
        # RLock: the master-epoch listener fires on the RPC thread, so a
        # flush whose own RPC observes a new master incarnation re-enters
        # flush_reports from inside the lock; cross-thread exclusion (the
        # "flushed means FLUSHED" guarantee) is unchanged.
        self._flush_lock = threading.RLock()
        self._pending_done: List[int] = []
        self._pending_failed: List[int] = []
        self._pending_since = 0.0
        self._metrics = _data_metrics()
        from dlrover_tpu_torch.observability.flight_recorder import active_recorder

        self._recorder = active_recorder()
        # Idempotent on the master: every worker reports the params, the
        # first one creates the dataset.
        self._shard_params = comm.DatasetShardParams(
            dataset_name=dataset_name,
            dataset_size=dataset_size,
            shard_size=shard_size,
            num_epochs=num_epochs,
            shuffle=shuffle,
            task_type=task_type,
        )
        self._client.report_dataset_shard_params(self._shard_params)
        # Master crash ride-through (DESIGN.md §37): when the client
        # observes a new master incarnation, re-register the dataset
        # params (no-op if the journal already rehydrated it) and flush
        # coalesced done-reports so exactly-once accounting re-converges
        # on the new epoch without restarting the prefetcher.
        add_listener = getattr(master_client, "add_epoch_listener", None)
        if callable(add_listener):
            add_listener(self._on_master_epoch_change)

    # ---- prefetcher --------------------------------------------------------

    @property
    def prefetching(self) -> bool:
        return self._prefetch_depth > 0

    def _ensure_prefetcher(self):
        if not self.prefetching or self._prefetcher is not None:
            return
        with self._prefetcher_lock:
            if self._prefetcher is None:
                self._prefetcher = threading.Thread(
                    target=self._prefetch_loop,
                    # Bound at spawn, NOT read from self inside the
                    # loop: resume_after_rescale swaps the stop event
                    # and queue attributes, and a stale thread that
                    # outlived its pause join (wedged in a slow RPC)
                    # must keep seeing ITS OWN set event and drain into
                    # ITS OWN dead queue — never the new epoch's.
                    args=(self._stopped, self._queue),
                    daemon=True,
                    name=f"shard-prefetch-{self.dataset_name}",
                )
                self._prefetcher.start()

    def _prefetch_loop(self, stopped: threading.Event, out_queue):
        backoff = self._wait_backoff_s
        while not stopped.is_set():
            # Reports first: keeps master-side shard accounting tight and
            # lets the master retire shards before handing out new ones.
            self._flush_if_due()
            try:
                fault_point(
                    "data.prefetch.fetch", dataset=self.dataset_name
                )
                tasks, wait = self._client.get_tasks(
                    self.dataset_name, self._fetch_batch
                )
            except Exception:
                # Never end iteration on transport failure — a silent
                # _END here would truncate the dataset. Retry with
                # growing backoff; if the master is really gone the
                # agent tears this worker down anyway.
                logger.warning(
                    "shard prefetch RPC failed; retrying", exc_info=True
                )
                if stopped.wait(backoff):
                    return
                backoff = min(backoff * 2, self._wait_backoff_max_s)
                continue
            self._metrics["fetch_rpcs"].inc()
            if wait:
                # Peers (or this worker's own unflushed dones) hold the
                # remaining shards. Flush reports older than
                # ``wait_flush_age_s`` — they may be exactly what the
                # master waits for — but keep young ones batching so a
                # drained queue doesn't degrade reports to one-per-RPC.
                flushed = 0
                with self._report_lock:
                    count = len(self._pending_done) + len(
                        self._pending_failed
                    )
                    aged = (
                        count > 0
                        and time.monotonic() - self._pending_since
                        >= self._wait_flush_age_s
                    )
                if count >= self._report_batch or aged:
                    flushed = self.flush_reports()
                if flushed:
                    # Our dones may have completed the dataset: re-poll
                    # soon, but not in a hot RPC loop.
                    if stopped.wait(0.05):
                        return
                else:
                    if stopped.wait(
                        backoff * (1.0 + random.uniform(-0.3, 0.3))
                    ):
                        return
                    backoff = min(backoff * 2, self._wait_backoff_max_s)
                continue
            backoff = self._wait_backoff_s
            if not tasks:
                # Dataset exhausted: flush the tail of reports, then park
                # the end sentinel for every future fetch.
                self.flush_reports()
                if self._recorder is not None:
                    self._recorder.annotate(
                        "data_exhausted", dataset=self.dataset_name
                    )
                out_queue.put(_END)
                return
            self._metrics["tasks_fetched"].inc(len(tasks))
            self._metrics["rpcs_saved"].inc(len(tasks) - 1)
            for task in tasks:
                while True:
                    try:
                        out_queue.put(task, timeout=0.2)
                        break
                    except queue.Full:
                        if stopped.is_set():
                            return
                self._metrics["queue_depth"].set(out_queue.qsize())

    def stop(self):
        """Stop the prefetcher and flush pending reports. Leases already
        prefetched but unconsumed stay in the master's ``doing`` table —
        on worker death they are re-queued by ``recover_node_tasks``."""
        self._stopped.set()
        if self._prefetcher is not None:
            self._prefetcher.join(timeout=5.0)
        self.flush_reports()

    def kill(self):
        """Chaos/testing: die WITHOUT flushing — pending done-reports
        are lost and prefetched leases stay unconsumed, exactly like a
        crashed worker. The master's ``recover_node_tasks`` (node death)
        or task timeout re-queues everything not already reported."""
        self._stopped.set()
        if self._prefetcher is not None:
            self._prefetcher.join(timeout=5.0)
        with self._report_lock:
            self._pending_done, self._pending_failed = [], []

    # ---- live rescale ------------------------------------------------------

    def pause_for_rescale(self) -> int:
        """Tear down ONLY the data-path prefetcher for a live rescale
        (docs/DESIGN.md §27): stop the prefetch thread, discard locally
        queued-but-unconsumed leases (they stay in the master's
        ``doing`` table and come back via the shard-snapshot restore or
        timeout recovery — consuming them here after the state rolled
        back would double-count their records), and force-flush pending
        done-reports so the master's ledger reflects every shard this
        worker actually finished BEFORE the rescale rolls the dataset
        cursor back. Returns the number of reports flushed."""
        self._stopped.set()
        if self._prefetcher is not None:
            self._prefetcher.join(timeout=5.0)
            if self._prefetcher.is_alive():
                # Wedged in a slow RPC. Safe to proceed: the thread
                # holds ITS OWN (now set) stop event and ITS OWN queue,
                # so it can neither feed the post-rescale queue nor
                # outlive its next loop check — but say so, because a
                # lease it fetches on the way out sits in the master's
                # doing table until timeout recovery.
                logger.warning(
                    "prefetcher still draining a slow RPC at rescale "
                    "pause; it will exit on its own stop event"
                )
        self._prefetcher = None
        discarded = 0
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _END:
                discarded += 1
        self._current_task = None
        flushed = self.flush_reports()
        self._metrics["queue_depth"].set(0)
        if self._recorder is not None:
            self._recorder.annotate(
                "rescale_pause",
                dataset=self.dataset_name,
                flushed=flushed,
                discarded=discarded,
            )
        return flushed

    def resume_after_rescale(self):
        """Bring the data path back after the new world's shard cursor
        is in place: fresh queue + stop flag, prefetcher restarts
        lazily on the next fetch. The end-of-data sentinel is dropped
        with the old queue — the snapshot restore may have re-queued
        shards a previous world left in flight."""
        self._stopped = threading.Event()
        self._queue = queue.Queue(maxsize=self._prefetch_depth or 1)
        self._prefetcher = None
        self._current_task = None

    # ---- fetch -------------------------------------------------------------

    def fetch_task(self) -> Optional[comm.ShardTask]:
        """Next shard, or None when the dataset is exhausted.

        With prefetch on this blocks only when the queue has run dry (the
        fetch-wait seconds counter tells you how often). A WAIT response
        (peers hold the remaining shards in flight) is polled by the
        prefetcher until the master either re-dispatches a recovered
        shard or declares the dataset done — returning early would
        orphan shards re-queued after a peer failure.
        """
        if not self.prefetching:
            return self._fetch_task_sync()
        self._ensure_prefetcher()
        t0 = time.monotonic()
        while True:
            try:
                item = self._queue.get(timeout=0.2)
                break
            except queue.Empty:
                if self._stopped.is_set():
                    # stop()/kill() while we were blocked: the
                    # prefetcher is gone and nothing else will ever
                    # arrive — report end-of-data instead of hanging.
                    self._metrics["fetch_wait"].inc(
                        time.monotonic() - t0
                    )
                    return None
        self._metrics["fetch_wait"].inc(time.monotonic() - t0)
        if item is _END:
            self._queue.put(_END)
            return None
        self._metrics["queue_depth"].set(self._queue.qsize())
        self._current_task = item
        return item

    def poll_task(self, timeout_s: float = 0.2):
        """Non-blocking lease poll for lockstep consumers: ("task", t)
        when a lease is ready, ("end", None) once the dataset is
        exhausted, ("wait", None) when nothing arrived within
        ``timeout_s`` (peers hold the remaining shards, or the
        prefetcher is still warming) — the caller keeps its collective
        step loop turning instead of blocking a whole world on one
        rank's empty queue."""
        if not self.prefetching:
            raise RuntimeError("poll_task requires prefetch_depth > 0")
        self._ensure_prefetcher()
        try:
            item = self._queue.get(timeout=max(timeout_s, 0.0))
        except queue.Empty:
            return ("end", None) if self._stopped.is_set() else ("wait", None)
        if item is _END:
            self._queue.put(_END)
            return "end", None
        self._metrics["queue_depth"].set(self._queue.qsize())
        self._current_task = item
        return "task", item

    def _fetch_task_sync(self) -> Optional[comm.ShardTask]:
        backoff = self._wait_backoff_s
        t0 = time.monotonic()
        while True:
            tasks, wait = self._client.get_tasks(self.dataset_name, 1)
            self._metrics["fetch_rpcs"].inc()
            if wait:
                if self.flush_reports() == 0:
                    time.sleep(backoff * (1.0 + random.uniform(-0.3, 0.3)))
                    backoff = min(backoff * 2, self._wait_backoff_max_s)
                continue
            self._metrics["fetch_wait"].inc(time.monotonic() - t0)
            if not tasks:
                self.flush_reports()
                return None
            self._metrics["tasks_fetched"].inc()
            self._current_task = tasks[0]
            return tasks[0]

    # ---- done reports ------------------------------------------------------

    def report_task_done(
        self, task: Optional[comm.ShardTask] = None, success: bool = True
    ):
        """Queue a done-report; coalesced into one batched RPC flushed on
        count (``report_batch``), age (``report_interval_s``, enforced by
        the prefetcher), WAIT responses, end-of-data, and — forcibly —
        before a shard checkpoint. Synchronous mode reports inline."""
        task = task or self._current_task
        if task is None:
            return
        if not self.prefetching:
            self._client.report_task_done(
                self.dataset_name, task.task_id, success
            )
            self._metrics["report_rpcs"].inc()
            return
        with self._report_lock:
            if not self._pending_done and not self._pending_failed:
                self._pending_since = time.monotonic()
            (self._pending_done if success else self._pending_failed).append(
                task.task_id
            )
            count = len(self._pending_done) + len(self._pending_failed)
        if count >= self._report_batch or not success:
            # Failures flush immediately: the sooner the master re-queues
            # the shard, the sooner a healthy peer picks it up.
            self.flush_reports()

    def flush_reports(self) -> int:
        """Send every pending done-report in one batched RPC; returns how
        many reports were flushed. Safe to call from any thread, and on
        return no flush is still in flight: the lock spans the RPC, so a
        caller that needs flushed-before-X ordering (shard checkpoints)
        really gets it, instead of racing another thread's send."""
        with self._flush_lock:
            with self._report_lock:
                done, failed = self._pending_done, self._pending_failed
                if not done and not failed:
                    return 0
                self._pending_done, self._pending_failed = [], []
            try:
                self._client.report_tasks_done_batch(
                    self.dataset_name, done, failed
                )
            except Exception:
                # Lost reports are re-queued locally; the master's
                # timeout recovery bounds the damage if we die before a
                # retry lands.
                logger.warning(
                    "batched done-report failed; re-queueing %d reports",
                    len(done) + len(failed),
                    exc_info=True,
                )
                with self._report_lock:
                    self._pending_done = done + self._pending_done
                    self._pending_failed = failed + self._pending_failed
                    self._pending_since = time.monotonic()
                return 0
            n = len(done) + len(failed)
        self._metrics["report_rpcs"].inc()
        self._metrics["rpcs_saved"].inc(n - 1)
        return n

    def _on_master_epoch_change(self, old_epoch: int, new_epoch: int):
        """Runs on the RPC thread that first reached the restarted
        master. Re-registering is idempotent (journal rehydration already
        recreated the dataset; a params report for an existing name is a
        no-op) and the flush drains done-reports coalesced during the
        outage so the new incarnation's ledger converges."""
        logger.info(
            "master epoch %d -> %d; re-registering dataset %s and "
            "flushing %s",
            old_epoch,
            new_epoch,
            self.dataset_name,
            "pending done-reports",
        )
        try:
            self._client.report_dataset_shard_params(self._shard_params)
        except Exception:  # noqa: BLE001 — prefetcher keeps retrying anyway
            logger.warning(
                "dataset re-register after master restart failed",
                exc_info=True,
            )
        self.flush_reports()

    def _flush_if_due(self):
        with self._report_lock:
            count = len(self._pending_done) + len(self._pending_failed)
            stale = (
                count > 0
                and time.monotonic() - self._pending_since
                >= self._report_interval_s
            )
        if count >= self._report_batch or stale:
            self.flush_reports()

    # ---- shard checkpoint (dataset position survives restarts) ------------

    def get_shard_checkpoint(self) -> str:
        """Snapshot of undone shards. Pending done-reports are FORCIBLY
        flushed first — otherwise the checkpoint would still hold shards
        this worker finished, and a restore would replay them. If the
        flush cannot land, the checkpoint is refused: snapshotting stale
        accounting would silently bake the replay in."""
        flushed = self.flush_reports()
        with self._report_lock:
            remaining = len(self._pending_done) + len(self._pending_failed)
        if remaining:
            raise RuntimeError(
                f"shard checkpoint refused: {remaining} done-reports "
                "could not be flushed to the master"
            )
        if flushed and self._recorder is not None:
            self._recorder.annotate(
                "shard_ckpt_flush",
                dataset=self.dataset_name,
                reports=flushed,
            )
        return self._client.get_shard_checkpoint(self.dataset_name)

    def restore_shard_checkpoint(self, checkpoint: str):
        if checkpoint:
            self._client.restore_shard_checkpoint(
                self.dataset_name, checkpoint
            )


class IndexShardingClient(ShardingClient):
    """Record-granular iterator: hides tasks behind ``next index``.

    Iteration ends when the master reports the dataset done; shard
    boundaries are hidden behind the prefetch queue.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._indices: "queue.Queue[int]" = queue.Queue()
        self._records_consumed = 0
        self._records_in_task = 0
        self._lock = threading.Lock()

    def fetch_record_index(self) -> Optional[int]:
        """Next global record index, or None at end of data."""
        with self._lock:
            if self._indices.empty():
                if not self._fill_from_next_task():
                    return None
            index = self._indices.get()
            self._records_consumed += 1
            self._records_in_task -= 1
            if self._records_in_task == 0 and self._current_task:
                self.report_task_done(self._current_task)
        return index

    def _fill_from_next_task(self) -> bool:
        # Loop, don't return on the first empty shard: an empty task must
        # not end iteration early — and it is reported done immediately so
        # the master doesn't hold it in ``doing`` until timeout.
        while True:
            task = self.fetch_task()
            if task is None:
                return False
            indices: List[int] = (
                task.record_indices
                if task.record_indices
                else list(range(task.start, task.end))
            )
            if not indices:
                self.report_task_done(task)
                continue
            for i in indices:
                self._indices.put(i)
            self._records_in_task = len(indices)
            return True

    def __iter__(self) -> Iterator[int]:
        while True:
            index = self.fetch_record_index()
            if index is None:
                return
            yield index
