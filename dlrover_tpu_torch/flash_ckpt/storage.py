"""Checkpoint storage backends + on-disk layout (the port's copy of
``dlrover_tpu/flash_ckpt/storage.py``: the same layout, commit protocol
and fault points, so either package restores the other's step dirs).

Layout under ``checkpoint_dir``:

    checkpoint-<step>/
        proc-<process_id>.raw     # v1 raw shard file (see raw_format.py)
        proc-<process_id>.meta    # pickled shard metadata (treespec etc.)
        .done/node-<rank>.done    # per-node completion markers
    latest_checkpointed_iteration.txt   # tracker, atomically replaced

Read compat: step dirs written before the raw format carry
``proc-<pid>.npz`` instead; :func:`open_proc_shards` falls back to a
zip-backed reader for those, so old checkpoints (either package's) stay
restorable. ``persist_node_shards(..., fmt=NPZ_FORMAT)`` still writes
that legacy layout, for compat tests and A/B runs.
"""

import contextlib
import os
import pickle
import shutil
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.common.env_utils import get_env_int
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.fault import FaultAction, fault_point
from dlrover_tpu_torch.flash_ckpt.raw_format import (
    RAW_SUFFIX,
    RawShardReader,
    write_raw_shards,
)

RAW_FORMAT = "raw"
NPZ_FORMAT = "npz"


def io_threads(n_tasks: int) -> int:
    """Thread-pool width for checkpoint file I/O. Disk writes/reads are
    GIL-releasing and spend much of their time stalled on page faults /
    device queues, so 2x-cpu oversubscription (capped at 8) measures
    fastest even on small hosts; DLROVER_TPU_CKPT_IO_THREADS overrides."""
    configured = get_env_int("DLROVER_TPU_CKPT_IO_THREADS", 0)
    if configured > 0:
        return max(1, min(configured, n_tasks))
    return max(1, min(n_tasks, 2 * (os.cpu_count() or 2), 8))


def fsync_dir(path: str):
    """fsync a directory so renames into it survive a crash."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class CheckpointStorage(ABC):
    @abstractmethod
    def write(self, content: bytes, path: str):
        ...

    @abstractmethod
    def read(self, path: str) -> Optional[bytes]:
        ...

    @abstractmethod
    def exists(self, path: str) -> bool:
        ...

    @abstractmethod
    def listdir(self, path: str) -> List[str]:
        ...

    @abstractmethod
    def makedirs(self, path: str):
        ...

    @abstractmethod
    def remove(self, path: str):
        ...


class PosixDiskStorage(CheckpointStorage):
    def write(self, content: bytes, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(content)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def read(self, path: str) -> Optional[bytes]:
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> List[str]:
        return os.listdir(path) if os.path.isdir(path) else []

    def makedirs(self, path: str):
        os.makedirs(path, exist_ok=True)

    def remove(self, path: str):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.unlink(path)


def step_dir(checkpoint_dir: str, step: int) -> str:
    return os.path.join(
        checkpoint_dir, f"{CheckpointConstant.STEP_DIR_PREFIX}{step}"
    )


def tracker_path(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, CheckpointConstant.TRACKER_FILE)


def read_tracker(checkpoint_dir: str) -> int:
    path = tracker_path(checkpoint_dir)
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (FileNotFoundError, ValueError):
        return -1


def write_tracker(checkpoint_dir: str, step: int):
    os.makedirs(checkpoint_dir, exist_ok=True)
    # Per-process tmp name: concurrent committers (multi-node standalone)
    # must not os.replace each other's tmp files out from under them.
    tmp = tracker_path(checkpoint_dir) + f".tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, tracker_path(checkpoint_dir))
        # The rename is the commit point: make it durable, not just the
        # file contents (a crash could otherwise roll the tracker back).
        fsync_dir(checkpoint_dir)
    except OSError:
        # Unique names never self-overwrite: reclaim the orphan.
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _tear_file(path: str, nbytes: int):
    """Chaos: chop ``nbytes`` off a just-landed shard file, simulating a
    write torn by a crash/power cut after the rename. The reader's
    open-time length/checksum validation must reject the file."""
    size = os.path.getsize(path)
    keep = max(size - max(nbytes, 1), 0)
    with open(path, "r+b") as f:
        f.truncate(keep)
        f.flush()
        os.fsync(f.fileno())
    logger.warning(
        "chaos: tore %d bytes off %s (%d -> %d)", size - keep, path,
        size, keep,
    )


def _persist_one_proc(sdir: str, step: int, process_id: int, payload: dict,
                      fmt: str = RAW_FORMAT):
    """Write one process's shard + meta files (tmp + rename, one fsync
    per file). Runs on a persist-pool thread."""
    fault_point("ckpt.persist.proc_file", step=step, process_id=process_id)
    meta = payload.get("meta")
    if fmt == NPZ_FORMAT:
        # Legacy writer: kept for the A/B bench and compat tests only.
        npz_tmp = os.path.join(sdir, f".proc-{process_id}.npz.tmp")
        with open(npz_tmp, "wb") as f:
            np.savez(f, **payload["arrays"])
            f.flush()
            os.fsync(f.fileno())
        os.replace(npz_tmp, os.path.join(sdir, f"proc-{process_id}.npz"))
    else:
        raw_tmp = os.path.join(sdir, f".proc-{process_id}{RAW_SUFFIX}.tmp")
        bounds = payload.get("shard_bounds") or _bounds_from_meta(meta)
        write_raw_shards(raw_tmp, step, process_id, payload["arrays"],
                         bounds, dtypes=_dtypes_from_meta(meta))
        raw_final = os.path.join(sdir, f"proc-{process_id}{RAW_SUFFIX}")
        os.replace(raw_tmp, raw_final)
        directive = fault_point(
            "ckpt.persist.torn_write",
            step=step, process_id=process_id, path=raw_final,
        )
        if directive and directive.get("action") == FaultAction.TRUNCATE:
            _tear_file(raw_final, directive.get("truncate_bytes", 64))
    meta_tmp = os.path.join(sdir, f".proc-{process_id}.meta.tmp")
    with open(meta_tmp, "wb") as f:
        pickle.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(meta_tmp, os.path.join(sdir, f"proc-{process_id}.meta"))


def _dtypes_from_meta(meta) -> Dict[str, str]:
    """shard key -> stored dtype name (bf16 shards arrive as uint16)."""
    if not isinstance(meta, dict):
        return {}
    return {
        f"leaf{leaf_meta.leaf_id}_shard{j}": leaf_meta.dtype
        for leaf_meta in meta.get("leaves", [])
        for j in range(len(leaf_meta.shards))
    }


def _bounds_from_meta(meta) -> Dict[str, tuple]:
    """shard key -> global slice bounds, from the pickled LeafMeta list
    (so the raw header's JSON index is self-describing)."""
    bounds: Dict[str, tuple] = {}
    if not isinstance(meta, dict):
        return bounds
    for leaf_meta in meta.get("leaves", []):
        for j, shard in enumerate(leaf_meta.shards):
            bounds[f"leaf{leaf_meta.leaf_id}_shard{j}"] = shard.index
    return bounds


def persist_node_shards(
    checkpoint_dir: str,
    step: int,
    node_rank: int,
    proc_payloads: Dict[int, dict],
    fmt: str = RAW_FORMAT,
):
    """Write one node's processes' shard files + its done marker.

    proc_payloads: process_id -> {"arrays": {name: np.ndarray},
    "meta": {"treespec", "leaves", "user_meta"}}. Proc files fan out
    over a thread pool (the writes are GIL-releasing I/O); each file is
    fsynced once, and the
    step dir is fsynced after the renames so the commit protocol's
    done-marker implies durable shard files.
    """
    sdir = step_dir(checkpoint_dir, step)
    os.makedirs(sdir, exist_ok=True)
    if proc_payloads:
        with ThreadPoolExecutor(
            max_workers=io_threads(len(proc_payloads)),
            thread_name_prefix="ckpt-persist",
        ) as pool:
            futures = [
                pool.submit(
                    _persist_one_proc, sdir, step, pid, payload, fmt
                )
                for pid, payload in proc_payloads.items()
            ]
            for fut in futures:
                fut.result()  # surface the first failure
    fsync_dir(sdir)
    done_dir = os.path.join(sdir, CheckpointConstant.DONE_DIR)
    os.makedirs(done_dir, exist_ok=True)
    done_tmp = os.path.join(done_dir, f".node-{node_rank}.tmp")
    with open(done_tmp, "w") as f:
        f.write("1")
        f.flush()
        os.fsync(f.fileno())
    os.replace(done_tmp, os.path.join(done_dir, f"node-{node_rank}.done"))
    fsync_dir(done_dir)


def nodes_done(checkpoint_dir: str, step: int) -> List[int]:
    done_dir = os.path.join(
        step_dir(checkpoint_dir, step), CheckpointConstant.DONE_DIR
    )
    ranks = []
    if os.path.isdir(done_dir):
        for name in os.listdir(done_dir):
            if name.startswith("node-") and name.endswith(".done"):
                try:
                    ranks.append(int(name[5:-5]))
                except ValueError:
                    pass
    return sorted(ranks)


def load_step_meta(checkpoint_dir: str, step: int) -> Dict[int, dict]:
    """process_id -> meta for every proc file present."""
    # Restricted unpickle: checkpoint dirs may live on shared storage.
    from dlrover_tpu_torch.common.serialize import loads_pytree

    sdir = step_dir(checkpoint_dir, step)
    metas: Dict[int, dict] = {}
    if not os.path.isdir(sdir):
        return metas
    for name in os.listdir(sdir):
        if name.startswith("proc-") and name.endswith(".meta"):
            pid = int(name[5:-5])
            with open(os.path.join(sdir, name), "rb") as f:
                metas[pid] = loads_pytree(f.read())
    return metas


class NpzShardReader:
    """Read-compat adapter over a legacy ``proc-<pid>.npz`` step file,
    presenting the same surface as :class:`RawShardReader`. The zip
    container has no checksums and no sub-range reads: ``read_slice``
    inflates the full shard and slices (correct, just not partial-I/O).
    """

    step = -1  # the zip carries no step stamp; the dir name does
    process_id = -1

    def __init__(self, path: str):
        import threading

        self.path = path
        self._npz = np.load(path, allow_pickle=False)
        # NpzFile shares one zip file handle; concurrent reads from the
        # restore pool would interleave seeks.
        self._read_lock = threading.Lock()
        # Partial restore makes one read PER INTERSECTING REGION; the
        # zip can only inflate whole members, so cache each inflated
        # member or an N-region leaf costs N full decompressions (all
        # serialized under the lock). Dropped on close.
        self._cache: dict = {}
        self.bytes_read = 0

    def keys(self):
        return self._npz.files

    def __contains__(self, key: str) -> bool:
        return key in self._npz.files

    def _member(self, key: str) -> np.ndarray:
        with self._read_lock:
            arr = self._cache.get(key)
            if arr is None:
                arr = self._npz[key]  # zipfile crc-checks the inflate
                if arr.dtype.kind == "V" and arr.dtype.itemsize in (1, 2):
                    # A dtype numpy lacks (the reference's ml_dtypes
                    # bfloat16) loads as raw void: its bits, as the
                    # port stores bf16 (``shm_handler.storage_dtype``).
                    arr = arr.view(f"u{arr.dtype.itemsize}")
                self._cache[key] = arr
            return arr

    def bounds(self, key: str):
        """The zip stores no shard bounds: the meta file's govern."""
        return None

    def get(self, key: str, verify: bool = True) -> np.ndarray:
        arr = self._member(key)
        self.bytes_read += arr.nbytes
        return arr

    def read_slice(self, key: str, slices) -> np.ndarray:
        out = np.ascontiguousarray(self._member(key)[slices])
        self.bytes_read += out.nbytes
        return out

    def read_slice_into(self, key: str, slices, dest: np.ndarray,
                        verify: bool = False):
        # ``verify`` is moot here: zipfile already crc-checks every
        # member as it inflates.
        src = self._member(key)
        if slices:
            src = src[slices]
        np.copyto(dest, src)
        self.bytes_read += dest.nbytes

    def close(self):
        self._cache.clear()
        self._npz.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_proc_shards(checkpoint_dir: str, step: int, process_id: int):
    """Open one process's shard file for ``step``; None if absent.

    Prefers the raw v1 format; falls back to the legacy ``.npz`` layout.
    The returned reader owns a file handle / mmap — close it (it is a
    context manager) or the mapping lives until GC.
    """
    base = os.path.join(step_dir(checkpoint_dir, step), f"proc-{process_id}")
    raw_path = base + RAW_SUFFIX
    if os.path.exists(raw_path):
        return RawShardReader(raw_path)
    npz_path = base + ".npz"
    if os.path.exists(npz_path):
        return NpzShardReader(npz_path)
    return None


@contextlib.contextmanager
def load_proc_arrays(checkpoint_dir: str, step: int, process_id: int):
    """Context-managed access to one process's shard arrays (or None).

    The handle/mmap is released on exit.
    """
    reader = open_proc_shards(checkpoint_dir, step, process_id)
    try:
        yield reader
    finally:
        if reader is not None:
            reader.close()


def list_step_dirs(checkpoint_dir: str) -> List[int]:
    steps = []
    if os.path.isdir(checkpoint_dir):
        for name in os.listdir(checkpoint_dir):
            if name.startswith(CheckpointConstant.STEP_DIR_PREFIX):
                try:
                    steps.append(
                        int(name[len(CheckpointConstant.STEP_DIR_PREFIX):])
                    )
                except ValueError:
                    pass
    return sorted(steps)


class KeepStepIntervalDeletionStrategy:
    """Keep the newest ``max_to_keep`` steps AND every step that is a
    multiple of ``keep_interval`` (reference storage.py
    KeepStepIntervalStrategy): long-horizon jobs keep sparse history for
    evaluation/rollback without unbounded disk growth."""

    def __init__(self, keep_interval: int, max_to_keep: int = 3):
        self.keep_interval = max(keep_interval, 1)
        self.max_to_keep = max_to_keep

    def clean_up(self, checkpoint_dir: str):
        steps = list_step_dirs(checkpoint_dir)
        committed = read_tracker(checkpoint_dir)
        # steps[-0:] would be the WHOLE list, not "none recent".
        recent = (
            set(steps[-self.max_to_keep :]) if self.max_to_keep > 0 else set()
        )
        for s in steps:
            if s == committed or s in recent:
                continue
            if s % self.keep_interval == 0:
                continue
            logger.info("removing old checkpoint step %d", s)
            shutil.rmtree(step_dir(checkpoint_dir, s), ignore_errors=True)


class KeepLatestDeletionStrategy:
    """Retain the newest ``max_to_keep`` step dirs (reference
    storage.py deletion strategies)."""

    def __init__(self, max_to_keep: int = 3):
        self.max_to_keep = max_to_keep

    def clean_up(self, checkpoint_dir: str):
        steps = list_step_dirs(checkpoint_dir)
        committed = read_tracker(checkpoint_dir)
        victims = [s for s in steps if s != committed]
        # lst[:-0] is the WHOLE list: max_to_keep=0 must mean "keep only
        # the committed step", not "keep everything" (same guard
        # KeepStepIntervalDeletionStrategy carries).
        if self.max_to_keep > 0:
            victims = victims[: -self.max_to_keep]
        for s in victims:
            if s == committed:
                continue
            logger.info("removing old checkpoint step %d", s)
            shutil.rmtree(step_dir(checkpoint_dir, s), ignore_errors=True)
