"""Durable master journal: the control plane's write-ahead log.

Everything the master must not forget across a crash is appended here as
schema-versioned JSONL *before* the reply leaves the servicer: shard
lease dispatch/done, dataset registration and shard-checkpoint state,
rendezvous world commits, kv-store writes, committed checkpoint steps
and rescale ``plan_id`` cuts. A restarted master replays the journal and
resumes with the same outstanding leases (original task ids, so a
riding-through worker's done-report still pops them), never re-dispatches
a done shard, never re-issues a stale ``plan_id`` and never forgets the
newest committed checkpoint (docs/DESIGN.md §37).

Durability discipline borrows from ``autoscaler/recorder.py``:

- fsync per *group commit*: concurrent appenders buffer under a mutex
  and one of them flushes+fsyncs the whole batch, so the lease path pays
  one fsync per commit group, not per record (the bench gate: journaled
  lease-path RPS within 15% of unjournaled).
- torn-tail tolerance: a SIGKILL mid-write leaves a partial final line;
  the loader counts and skips it, and reopening repairs the tail with a
  newline so new records never concatenate onto the torn one.
- rotation-with-snapshot compaction: when the segment outgrows
  ``max_bytes`` the live state is snapshotted into a sibling temp file,
  fsynced, then atomically ``os.replace``d over the journal (the old
  segment wins until the snapshot is fully durable); the previous
  segment is kept as ``<path>.1`` for forensics.
- future-schema refusal: a header with ``v`` above ``SCHEMA_VERSION``
  raises — an old master must not half-understand a new journal.

``master_epoch`` is persisted in every header and bumped on every
reopen; the servicer stamps it into every response so workers can fence
against a restarted master (see ``MasterClient``).

The port's copy of ``dlrover_tpu/master/journal.py``: the same JSONL
records, schema version and snapshot layout (kv values base64), so
either package replays a journal the other wrote.
"""

import base64
import json
import os
import threading
import time
from collections import Counter as KindCounter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.fault import fault_point

SCHEMA_VERSION = 1

# Forensic segments kept after compaction: <path>.1 (newest) .. <path>.N.
KEEP_SEGMENTS = 2

JOURNAL_ENV = "DLROVER_TPU_MASTER_JOURNAL"


def _b64(value: bytes) -> str:
    return base64.b64encode(value).decode("ascii")


def _unb64(value: str) -> bytes:
    return base64.b64decode(value.encode("ascii"))


# ---------------------------------------------------------------------------
# Replay state
# ---------------------------------------------------------------------------


@dataclass
class DatasetReplay:
    """Per-dataset shard accounting reconstructed from the journal."""

    params: dict
    epoch: int = 0
    completed: int = 0
    # tid -> dispatch record (the outstanding, dispatched-but-not-done
    # leases; these keep their ORIGINAL task ids on rehydration).
    outstanding: Dict[int, dict] = field(default_factory=dict)
    # (start, end, partition) ranges consumed in the current epoch.
    consumed: Set[Tuple[int, int, int]] = field(default_factory=set)
    # Record indices consumed in the current epoch (text datasets).
    consumed_idx: Set[int] = field(default_factory=set)
    has_indices: bool = False
    # Explicit todo list (from a snapshot or shard-checkpoint restore);
    # None means "derive the remainder from the splitter geometry".
    base_todo: Optional[List[list]] = None
    # Streaming splitter offsets from a snapshot/shard-checkpoint (the
    # offsets, not epochs, are streaming progress).
    splitter_ckpt: Optional[dict] = None
    max_tid: int = -1

    def _key(self, rec: dict) -> Tuple[int, int, int]:
        return (rec["start"], rec["end"], rec.get("part", 0))

    def apply_dispatch(self, rec: dict):
        if rec.get("epoch", 0) > self.epoch:
            # A new epoch began: the previous epoch's consumption no
            # longer constrains the fresh shard set.
            self.epoch = rec.get("epoch", 0)
            self.consumed.clear()
            self.consumed_idx.clear()
            self.base_todo = None
        tid = rec["tid"]
        self.max_tid = max(self.max_tid, tid)
        if tid in self.outstanding:
            return  # idempotent re-apply (snapshot/tail overlap)
        if rec.get("idx"):
            self.has_indices = True
        if self.base_todo is not None:
            key = self._key(rec)
            for i, entry in enumerate(self.base_todo):
                if (entry[0], entry[1], entry[3] if len(entry) > 3 else 0) \
                        == key:
                    del self.base_todo[i]
                    break
        self.outstanding[tid] = rec

    def apply_done(self, tid: int, ok: bool):
        rec = self.outstanding.pop(tid, None)
        if rec is None:
            return  # duplicate / stale report: idempotent
        if not ok:
            # Failed shard returns to the unconsumed pool; it will be
            # re-dispatched (same or regenerated id) later.
            return
        self.completed += 1
        if rec.get("epoch", 0) == self.epoch:
            self.consumed.add(self._key(rec))
            for i in rec.get("idx") or ():
                self.consumed_idx.add(i)

    def apply_shard_ckpt(self, ckpt: dict):
        self.epoch = ckpt.get("epoch", 0)
        self.completed = ckpt.get("completed", 0)
        if ckpt.get("streaming"):
            # Streaming undone entries are [partition, start, end].
            self.base_todo = [
                [s, e, None, p] for p, s, e in ckpt.get("undone_shards", [])
            ]
            self.splitter_ckpt = ckpt.get("splitter")
        else:
            self.base_todo = [list(e) for e in ckpt.get("undone_shards", [])]
        self.outstanding.clear()
        self.consumed.clear()
        self.consumed_idx.clear()


@dataclass
class JournalState:
    """Everything ``load_journal`` reconstructs from one journal chain."""

    path: str = ""
    schema_version: int = SCHEMA_VERSION
    master_epoch: int = 0
    compactions: int = 0
    records: int = 0
    corrupt_lines: int = 0
    clean_shutdown: bool = False
    kinds: KindCounter = field(default_factory=KindCounter)
    datasets: Dict[str, DatasetReplay] = field(default_factory=dict)
    kv: Dict[str, bytes] = field(default_factory=dict)
    ckpt_step: int = -1
    plan_seq: int = 0
    rdzv: Dict[str, dict] = field(default_factory=dict)
    sync_joins: Dict[str, List[int]] = field(default_factory=dict)
    sync_finished: List[str] = field(default_factory=list)

    def is_empty(self) -> bool:
        return self.records == 0


def _apply_snapshot(state: JournalState, snap: dict):
    state.datasets.clear()
    for name, ds in (snap.get("datasets") or {}).items():
        replay = DatasetReplay(params=dict(ds.get("params") or {}))
        replay.epoch = ds.get("epoch", 0)
        replay.completed = ds.get("completed", 0)
        replay.base_todo = [list(e) for e in ds.get("todo", [])]
        for tid, d in (ds.get("doing") or {}).items():
            rec = dict(d)
            rec["tid"] = int(tid)
            replay.outstanding[int(tid)] = rec
            if rec.get("idx"):
                replay.has_indices = True
        replay.max_tid = ds.get("next_tid", 0) - 1
        replay.splitter_ckpt = ds.get("splitter")
        state.datasets[name] = replay
    state.kv = {
        k: _unb64(v) for k, v in (snap.get("kv") or {}).items()
    }
    state.ckpt_step = snap.get("ckpt_step", -1)
    state.plan_seq = snap.get("plan_seq", 0)
    state.rdzv = {
        name: dict(w) for name, w in (snap.get("rdzv") or {}).items()
    }
    sync = snap.get("sync") or {}
    state.sync_joins = {
        name: list(ranks) for name, ranks in (sync.get("joins") or {}).items()
    }
    state.sync_finished = list(sync.get("finished") or [])


def _apply_record(state: JournalState, rec: dict):
    kind = rec.get("kind")
    state.kinds[kind] += 1
    state.clean_shutdown = kind == "close"
    if kind == "header":
        version = rec.get("v", 0)
        if version > SCHEMA_VERSION:
            raise ValueError(
                f"journal schema v{version} is newer than supported "
                f"v{SCHEMA_VERSION}: refusing to replay"
            )
        state.schema_version = version
        state.master_epoch = max(state.master_epoch, rec.get("epoch", 0))
        state.compactions = max(state.compactions, rec.get("compaction", 0))
    elif kind == "snapshot":
        _apply_snapshot(state, rec.get("state") or {})
    elif kind == "dataset":
        params = rec.get("params") or {}
        name = params.get("dataset_name", "")
        if name and name not in state.datasets:
            state.datasets[name] = DatasetReplay(params=params)
    elif kind == "dispatch":
        ds = state.datasets.get(rec.get("ds", ""))
        if ds is not None:
            ds.apply_dispatch(rec)
    elif kind == "done":
        ds = state.datasets.get(rec.get("ds", ""))
        if ds is not None:
            for tid in rec.get("ok") or ():
                ds.apply_done(tid, True)
            for tid in rec.get("fail") or ():
                ds.apply_done(tid, False)
    elif kind == "shard_ckpt":
        ds = state.datasets.get(rec.get("ds", ""))
        if ds is not None:
            ckpt = rec.get("ckpt")
            if isinstance(ckpt, str):
                ckpt = json.loads(ckpt)
            ds.apply_shard_ckpt(ckpt or {})
    elif kind == "kv_set":
        state.kv[rec["key"]] = _unb64(rec.get("val", ""))
    elif kind == "ckpt_step":
        state.ckpt_step = max(state.ckpt_step, rec.get("step", -1))
    elif kind == "plan_cut":
        state.plan_seq = max(state.plan_seq, rec.get("plan_id", 0))
    elif kind == "rdzv":
        state.rdzv[rec.get("name", "")] = {
            "round": rec.get("round", 0),
            "world": {int(r): n for r, n in (rec.get("world") or {}).items()},
        }
    elif kind == "sync":
        name = rec.get("name", "")
        if rec.get("op") == "finish":
            if name not in state.sync_finished:
                state.sync_finished.append(name)
        else:
            state.sync_joins.setdefault(name, [])
            rank = rec.get("rank", -1)
            if rank not in state.sync_joins[name]:
                state.sync_joins[name].append(rank)
    # Unknown kinds within a supported schema version are skipped (the
    # same forward-tolerance load_recording() gives signal records).


def load_journal(path: str) -> JournalState:
    """Replay one journal file into a :class:`JournalState`.

    Torn/corrupt lines are counted and skipped; a header newer than
    ``SCHEMA_VERSION`` raises ``ValueError`` (future-schema refusal).
    """
    state = JournalState(path=path)
    if not os.path.exists(path):
        return state
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except (json.JSONDecodeError, ValueError):
                state.corrupt_lines += 1
                continue
            if not isinstance(rec, dict):
                state.corrupt_lines += 1
                continue
            _apply_record(state, rec)
            state.records += 1
    return state


# ---------------------------------------------------------------------------
# The journal writer
# ---------------------------------------------------------------------------


class MasterJournal:
    """Append-only group-commit JSONL WAL for master control state.

    ``append`` returns only after the record is durable (flushed and, by
    default, fsynced). Concurrent appenders share one fsync via group
    commit: each buffers its record under ``_mu`` and then contends on
    ``_commit_mu``; whichever thread wins writes *every* pending record
    and publishes the durable sequence number, so the losers return
    without touching the file.
    """

    def __init__(
        self,
        path: str,
        fsync: bool = True,
        max_bytes: int = 64 * 1024 * 1024,
        snapshot_fn: Optional[Callable[[], dict]] = None,
    ):
        self.path = path
        self._fsync = fsync
        self._max_bytes = max(int(max_bytes), 1 << 16)
        self._snapshot_fn = snapshot_fn
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        # Future-schema refusal propagates; IO corruption does not stop
        # a master from starting with what it could read.
        self.recovered = load_journal(path)
        self.master_epoch = self.recovered.master_epoch + 1
        self._compactions = self.recovered.compactions
        self._mu = threading.Lock()
        self._commit_mu = threading.Lock()
        self._pending: List[dict] = []
        self._seq = 0
        self._durable_seq = 0
        self._records = 0
        self._groups = 0
        self._closed = False
        self._last_append = 0.0
        self._repair_torn_tail()
        self._f = open(path, "a", encoding="utf-8")
        self._write_header()

    # ---- durability core ---------------------------------------------------

    def _repair_torn_tail(self):
        """A SIGKILL mid-write leaves a partial final line; terminate it
        so appended records never concatenate onto the torn bytes (the
        loader still counts the torn line as corrupt, preserved for
        forensics)."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size == 0:
            return
        with open(self.path, "rb+") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"\n":
                f.write(b"\n")
                f.flush()
                os.fsync(f.fileno())

    def _header_record(self) -> dict:
        return {
            "kind": "header",
            "v": SCHEMA_VERSION,
            "epoch": self.master_epoch,
            "compaction": self._compactions,
            "pid": os.getpid(),
            "wall": time.time(),
            "mono": time.monotonic(),
        }

    def _write_header(self):
        line = json.dumps(self._header_record()) + "\n"
        self._f.write(line)
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())

    def append(self, kind: str, **fields):
        rec = {"kind": kind}
        rec.update(fields)
        self._append_records([rec])
        fault_point("master.journal.write", kind=kind)

    def append_many(self, records: List[dict]):
        """Append a batch durably (one group commit for the caller's
        whole batch), then fire the write fault point once per record —
        so a crash schedule matched on ``kind=dispatch`` kills the
        master *after* the dispatch is durable and *before* the reply
        leaves (the exactly-once crash window the soak exercises)."""
        if not records:
            return
        self._append_records(records)
        for rec in records:
            fault_point("master.journal.write", kind=rec.get("kind", ""))

    def _append_records(self, records: List[dict]):
        with self._mu:
            if self._closed:
                return
            self._pending.extend(records)
            self._seq += len(records)
            my_seq = self._seq
        self._commit(my_seq)

    def _commit(self, upto: int):
        with self._commit_mu:
            with self._mu:
                if self._durable_seq >= upto or self._closed:
                    return
                batch = self._pending
                self._pending = []
                batch_seq = self._seq
            if batch:
                payload = "".join(
                    json.dumps(rec, default=str) + "\n" for rec in batch
                )
                self._f.write(payload)
                self._f.flush()
                if self._fsync:
                    os.fsync(self._f.fileno())
                self._groups += 1
                self._records += len(batch)
                self._last_append = time.time()
            with self._mu:
                self._durable_seq = max(self._durable_seq, batch_seq)
            if (
                self._snapshot_fn is not None
                and self._segment_bytes() > self._max_bytes
            ):
                try:
                    self._compact_locked(self._snapshot_fn())
                except Exception:
                    logger.exception("journal auto-compaction failed")

    def _segment_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    # ---- compaction --------------------------------------------------------

    def compact(self, snapshot: Optional[dict] = None):
        """Snapshot-compact the live segment. The dance is crash-safe:
        the snapshot is written to a sibling temp file and fsynced
        BEFORE ``os.replace`` swaps it in — until that replace, the old
        segment is the journal (a crash mid-compaction loses nothing)."""
        if snapshot is None:
            if self._snapshot_fn is None:
                raise ValueError("compact() needs a snapshot or snapshot_fn")
            snapshot = self._snapshot_fn()
        with self._commit_mu:
            with self._mu:
                if self._closed:
                    return
                batch = self._pending
                self._pending = []
                batch_seq = self._seq
            if batch:
                self._f.write(
                    "".join(
                        json.dumps(rec, default=str) + "\n" for rec in batch
                    )
                )
                self._f.flush()
            with self._mu:
                self._durable_seq = max(self._durable_seq, batch_seq)
            self._compact_locked(snapshot)

    def _compact_locked(self, snapshot: dict):
        self._compactions += 1
        tmp = self.path + ".compact.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(self._header_record()) + "\n")
            f.write(
                json.dumps(
                    {
                        "kind": "snapshot",
                        "v": SCHEMA_VERSION,
                        "state": snapshot,
                    },
                    default=str,
                )
                + "\n"
            )
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        # Keep the replaced segments as a forensic chain (.1 newest).
        try:
            for i in range(KEEP_SEGMENTS, 1, -1):
                older = f"{self.path}.{i - 1}"
                if os.path.exists(older):
                    os.replace(older, f"{self.path}.{i}")
            seg1 = self.path + ".1"
            if os.path.exists(seg1):
                os.remove(seg1)
            os.link(self.path, seg1)
        except OSError:
            pass  # forensics are best-effort; durability is not
        os.replace(tmp, self.path)
        try:
            dir_fd = os.open(os.path.dirname(os.path.abspath(self.path)),
                             os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)
        except OSError:
            pass
        self._f = open(self.path, "a", encoding="utf-8")
        logger.info(
            "journal %s compacted (epoch=%d compaction=%d)",
            self.path, self.master_epoch, self._compactions,
        )

    # ---- lifecycle / introspection ----------------------------------------

    def flush(self):
        """Drain pending records to durable storage (graceful-shutdown
        hook: called by ``HttpMasterServer`` after the RPC drain)."""
        with self._mu:
            upto = self._seq
        self._commit(upto)

    def close(self):
        self.append("close")
        with self._commit_mu:
            with self._mu:
                if self._closed:
                    return
                self._closed = True
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
                self._f.close()
            except (OSError, ValueError):
                pass

    @property
    def closed(self) -> bool:
        return self._closed

    def stats(self) -> dict:
        return {
            "path": self.path,
            "schema_version": SCHEMA_VERSION,
            "master_epoch": self.master_epoch,
            "records_appended": self._records,
            "commit_groups": self._groups,
            "segment_bytes": self._segment_bytes(),
            "compactions": self._compactions,
            "recovered_records": self.recovered.records,
            "recovered_corrupt_lines": self.recovered.corrupt_lines,
            "fsync": self._fsync,
            "last_append_unix": self._last_append,
        }


# ---------------------------------------------------------------------------
# Rehydration: JournalState -> live master components
# ---------------------------------------------------------------------------


def _derived_todo(replay: DatasetReplay) -> List[list]:
    """Reconstruct the unconsumed, un-leased remainder of the current
    epoch for a dataset without an explicit todo list."""
    if replay.base_todo is not None:
        return [list(e) for e in replay.base_todo]
    if replay.epoch <= 0:
        # Nothing was ever dispatched: leave the manager fresh and the
        # splitter will generate epoch 1 on first demand.
        return []
    params = replay.params
    size = int(params.get("dataset_size", 0))
    shard = max(int(params.get("shard_size", 1)), 1)
    leased = {(r["start"], r["end"], r.get("part", 0))
              for r in replay.outstanding.values()}
    if replay.has_indices:
        # Text datasets: shards address POSITIONS into a (possibly
        # shuffled) permutation, record_indices carry the truth, and
        # unshuffled consumers rely on position == index. The
        # permutation died with the master, so keep the positional
        # complement (positions not consumed, not leased) and assign
        # the un-taken indices to those positions in order — the
        # identity permutation reproduces exactly; a shuffled one is
        # re-drawn validly (any assignment of remaining indices to
        # remaining positions is a correct remainder).
        taken: Set[int] = set(replay.consumed_idx)
        for rec in replay.outstanding.values():
            for i in rec.get("idx") or ():
                taken.add(i)
        remaining_idx = [i for i in range(size) if i not in taken]
        out = []
        cursor = 0
        for start in range(0, size, shard):
            end = min(start + shard, size)
            if (start, end, 0) in replay.consumed:
                continue
            if (start, end, 0) in leased:
                continue
            chunk = remaining_idx[cursor:cursor + (end - start)]
            cursor += end - start
            out.append([start, end, chunk, 0])
        return out
    out = []
    for start in range(0, size, shard):
        end = min(start + shard, size)
        if (start, end, 0) in replay.consumed:
            continue
        if (start, end, 0) in leased:
            continue
        out.append([start, end, None, 0])
    return out


def _streaming_splitter_ckpt(replay: DatasetReplay, todo: List[list]) -> dict:
    """Rebuild streaming splitter offsets from journaled carves: every
    dispatched or still-queued shard has already advanced its partition's
    offset past its end."""
    params = replay.params
    offsets: Dict[int, int] = {
        p: 0 for p in range(max(int(params.get("num_partitions", 1) or 1), 1))
    }
    carved = 0
    for start, end, part in replay.consumed:
        offsets[part] = max(offsets.get(part, 0), end)
    for rec in replay.outstanding.values():
        part = rec.get("part", 0)
        offsets[part] = max(offsets.get(part, 0), rec.get("end", 0))
    for entry in todo:
        part = entry[3] if len(entry) > 3 else 0
        offsets[part] = max(offsets.get(part, 0), entry[1])
    carved = sum(offsets.values())
    size = int(params.get("dataset_size", -1))
    remaining = -1 if size < 0 else max(size - carved, 0)
    return {
        "partition_offsets": {str(p): o for p, o in offsets.items()},
        "remaining": remaining,
        "shard_size": max(int(params.get("shard_size", 1) or 1), 1),
    }


def _restore_task_manager(state: JournalState, task_manager) -> dict:
    from dlrover_tpu_torch.common import comm

    summary = {}
    for name, replay in state.datasets.items():
        params_fields = {
            k: v for k, v in replay.params.items()
            if k in comm.DatasetShardParams.__dataclass_fields__
        }
        task_manager.new_dataset(comm.DatasetShardParams(**params_fields))
        mgr = task_manager.get_dataset(name)
        if mgr is None:
            continue
        doing = {
            tid: (
                rec.get("node", -1),
                rec.get("epoch", 0),
                rec.get("start", 0),
                rec.get("end", 0),
                rec.get("idx"),
                rec.get("part", 0),
            )
            for tid, rec in replay.outstanding.items()
        }
        rehydrate = getattr(mgr, "rehydrate", None)
        if rehydrate is None:
            logger.warning(
                "dataset %s: manager %s has no rehydrate(); skipping",
                name, type(mgr).__name__,
            )
            continue
        todo = _derived_todo(replay)
        kwargs = dict(
            dataset_name=name,
            epoch=replay.epoch,
            completed=replay.completed,
            todo_shards=todo,
            doing=doing,
            next_task_id=replay.max_tid + 1,
        )
        storage = str(replay.params.get("storage_type") or "").lower()
        if storage in ("stream", "streaming", "kafka", "sls"):
            kwargs["splitter_ckpt"] = (
                replay.splitter_ckpt
                or _streaming_splitter_ckpt(replay, todo)
            )
        rehydrate(**kwargs)
        summary[name] = {
            "todo": len(todo),
            "doing": len(doing),
            "completed": replay.completed,
            "epoch": replay.epoch,
        }
    return summary


def restore_master_state(
    state: Optional[JournalState],
    task_manager=None,
    kv_store=None,
    rescale_coordinator=None,
    sync_service=None,
    rdzv_managers=None,
    job_manager=None,
) -> dict:
    """Rehydrate live master components from a replayed journal.

    Exactly-once law: outstanding leases land back in ``doing`` with
    their ORIGINAL task ids (a riding-through worker's done-report pops
    them; a dead worker's leases re-queue via the normal timeout path),
    and done shards are excluded from the rebuilt todo so they are never
    re-dispatched.
    """
    if state is None or state.is_empty():
        return {}
    fault_point("master.restart", epoch=state.master_epoch)
    summary: dict = {"master_epoch": state.master_epoch}
    if task_manager is not None:
        summary["datasets"] = _restore_task_manager(state, task_manager)
    if kv_store is not None and state.kv:
        for key, value in state.kv.items():
            kv_store.set(key, value)
        summary["kv_keys"] = len(state.kv)
    if rescale_coordinator is not None:
        restore = getattr(
            rescale_coordinator, "restore_journal_state", None
        )
        if restore is not None:
            restore(state.plan_seq, state.ckpt_step)
            summary["plan_seq"] = state.plan_seq
            summary["ckpt_step"] = state.ckpt_step
    if job_manager is not None and state.ckpt_step >= 0:
        # The client-visible get_ckpt_latest_step verb reads the job
        # context, not the rescale coordinator — feed it too so a
        # restarted master never answers -1 for a step it committed.
        update = getattr(job_manager, "update_ckpt_step", None)
        if update is not None:
            update(-1, state.ckpt_step, committed=True)
    if sync_service is not None and (
        state.sync_joins or state.sync_finished
    ):
        restore = getattr(sync_service, "restore_journal_state", None)
        if restore is not None:
            restore(state.sync_joins, state.sync_finished)
            summary["syncs"] = len(state.sync_joins)
    for name, committed in (state.rdzv or {}).items():
        mgr = (rdzv_managers or {}).get(name)
        restore = getattr(mgr, "restore_committed_world", None)
        if restore is not None:
            restore(committed.get("round", 0), committed.get("world", {}))
            summary.setdefault("rdzv", {})[name] = committed.get("round", 0)
    logger.info("master state rehydrated from journal: %s", summary)
    return summary


def journal_path_from_env() -> Optional[str]:
    return os.getenv(JOURNAL_ENV) or None
