"""Raw, mmap-able on-disk shard format for flash checkpoints (v1): the
port's copy of ``dlrover_tpu/flash_ckpt/raw_format.py``. For the same
arrays, bounds, step and process id it writes the reference's bytes, so
either package reads the other's files.

Shards are laid out as page-aligned raw bytes behind a JSON index, so
restore can ``np.memmap`` the file and read only the byte ranges a
process needs, and persist streams each shard to disk with one copy.

numpy has no bfloat16 here (no ``ml_dtypes`` on the checkpoint path): a
bf16 shard is passed as its uint16 bits with its dtype name given in
``write_raw_shards(dtypes=...)``, and the reader returns it as uint16
under the header's name ``"bfloat16"``.

Layout of ``proc-<pid>.raw``::

    [8B magic "DLRTPUS1"][8B header_len big-endian][4B header adler32]
    [JSON header][zero padding to data_start (page aligned)]
    [shard bytes, each shard offset page-aligned]

The 4-byte adler32 of the JSON payload guards the INDEX itself: shard
checksums are useless if a corrupted-but-parseable header misdirects
the reads (a flipped digit in an ``offset`` field would send partial
reads — which verify nothing by design — into another shard's bytes).

Header (pure JSON — no pickle on the index path)::

    {
      "version": 1,
      "step": <int>,
      "process_id": <int>,
      "data_start": <int>,
      "shards": [
        {"key": "leaf3_shard0", "leaf_id": 3, "shard_id": 0,
         "dtype": "float32", "local_shape": [8, 4],
         "bounds": [[0, 8], [null, null]],
         "offset": 0, "nbytes": 128,
         "adler32": 123456, "sum64": 7890}, ...
      ]
    }

``bounds`` are the global slice bounds of the shard (``null`` = open end,
matching ``ShardMeta.index``). Two checksums per shard, both computed
during the streaming write: ``adler32`` (zlib) is the strong check used
by :meth:`RawShardReader.get` / ``verify_all`` and external tooling;
``sum64`` (a ZFS-fletcher-style uint64 word sum, :func:`_sum64`) is
what the RESTORE hot path verifies on full-shard reads — it runs at
SIMD memory bandwidth instead of adler's ~1 GB/s and still catches
every single-event corruption (bitflip, byte change, zeroed range).
Partial range reads verify nothing (they deliberately do not touch
every page) and are documented as such. Truncated files are rejected at
open: the header records exactly how many bytes the data region must
span.

Compat policy: readers must keep accepting every on-disk version they
ever shipped; ``VERSION`` only bumps on layout changes. Legacy ``.npz``
step dirs are read through ``storage.NpzShardReader``.
"""

import json
import os
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from dlrover_tpu_torch.common.log import logger

MAGIC = b"DLRTPUS1"
VERSION = 1
_PREFIX = 20  # magic + header_len + header adler32
PAGE = 4096  # shard offsets are page-aligned so mmap slices hit whole pages
_WRITE_CHUNK = 16 << 20  # stream writes in 16MB chunks (GIL-releasing I/O)

RAW_SUFFIX = ".raw"


class ShardCorruptionError(Exception):
    """A shard file is torn, truncated, or fails its checksum."""


def shard_key(leaf_id: int, shard_id: int) -> str:
    return f"leaf{leaf_id}_shard{shard_id}"


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a stored dtype name's bytes (the shm
    image's convention, see ``shm_handler.storage_dtype``)."""
    from dlrover_tpu_torch.flash_ckpt.shm_handler import storage_dtype

    return storage_dtype(name)


def _align(n: int, a: int = PAGE) -> int:
    return (n + a - 1) // a * a


def _as_bytes(arr: np.ndarray) -> np.ndarray:
    """Flat uint8 view of a C-contiguous array. memoryview(...).cast("B")
    raises on ml_dtypes (bfloat16/float8) and on zero-size or 0-d
    shapes; a reshape+view is dtype-agnostic and zero-copy."""
    if arr.nbytes == 0:
        return np.empty(0, np.uint8)
    return arr.reshape(-1).view(np.uint8)


_U64_MOD = 1 << 64


def _sum64(chunk: np.ndarray, acc: int = 0) -> int:
    """Running word-sum checksum over uint8 ``chunk`` (ZFS-fletcher-style
    speed/strength tradeoff: SIMD memory-bandwidth fast, catches every
    single-event corruption — any lone bitflip, byte change, or zeroed
    range shifts the sum — while compensating multi-word corruptions
    can escape it; the full adler32 stays in the header for the strong
    path). Chunking-invariant as long as every chunk but the last is a
    multiple of 8 bytes."""
    n8 = chunk.nbytes // 8 * 8
    if n8:
        acc += int(
            np.add.reduce(chunk[:n8].view(np.uint64), dtype=np.uint64)
        )
    tail = chunk[n8:]
    if tail.nbytes:
        acc += int(tail.astype(np.uint64).sum())
    return acc % _U64_MOD


def _json_bounds(bounds) -> Optional[List[List[Optional[int]]]]:
    if bounds is None:
        return None
    return [[b[0], b[1]] for b in bounds]


def _tuple_bounds(bounds):
    if bounds is None:
        return None
    return tuple((b[0], b[1]) for b in bounds)


def write_raw_shards(
    path: str,
    step: int,
    process_id: int,
    arrays: Dict[str, np.ndarray],
    shard_bounds: Optional[Dict[str, tuple]] = None,
    fsync: bool = True,
    dtypes: Optional[Dict[str, str]] = None,
) -> int:
    """Write ``arrays`` as a v1 raw shard file at ``path``; returns bytes.

    ``dtypes`` names the stored dtype of a key whose array holds another
    dtype's bits (``"bfloat16"`` for a uint16 view). The caller owns
    atomicity (write to a tmp name, then rename). One fsync per file at
    the end — not one per shard.
    """
    shard_bounds = shard_bounds or {}
    dtypes = dtypes or {}
    entries = []
    offset = 0
    contiguous: Dict[str, np.ndarray] = {}
    for key in sorted(arrays):
        arr = np.asarray(arrays[key])
        if not arr.flags.c_contiguous:
            # ascontiguousarray promotes 0-d to (1,); restore the shape.
            arr = np.ascontiguousarray(arr).reshape(arr.shape)
        contiguous[key] = arr
        leaf_id = shard_id = -1
        try:
            body = key.split("leaf", 1)[1]
            leaf_s, shard_s = body.split("_shard", 1)
            leaf_id, shard_id = int(leaf_s), int(shard_s)
        except (IndexError, ValueError):
            pass
        entries.append(
            {
                "key": key,
                "leaf_id": leaf_id,
                "shard_id": shard_id,
                "dtype": dtypes.get(key, arr.dtype.name),
                "local_shape": list(arr.shape),
                "bounds": _json_bounds(shard_bounds.get(key)),
                "offset": offset,
                "nbytes": int(arr.nbytes),
                # Placeholders at max width: checksums are computed
                # DURING the single streaming write pass and patched
                # afterwards; real values are never longer, so the final
                # header always fits the reserved region.
                "adler32": 0xFFFFFFFF,
                "sum64": _U64_MOD - 1,
            }
        )
        offset = _align(offset + arr.nbytes)
    data_bytes = offset

    header = {
        "version": VERSION,
        "step": int(step),
        "process_id": int(process_id),
        "data_start": 0,  # patched after sizing
        "shards": entries,
    }
    payload = json.dumps(header).encode("utf-8")
    # data_start shifts the JSON length by at most a few digits; give the
    # header its own page multiple and re-encode once.
    data_start = _align(_PREFIX + len(payload) + 32)
    header["data_start"] = data_start

    with open(path, "wb") as f:
        f.write(b"\x00" * _PREFIX)  # prefix lands last (commit ordering)
        f.seek(data_start)
        pos = 0
        for entry in entries:
            if entry["offset"] > pos:
                f.write(b"\x00" * (entry["offset"] - pos))
                pos = entry["offset"]
            flat = _as_bytes(contiguous[entry["key"]])
            csum = 1  # adler32 seed
            wsum = 0
            for lo in range(0, flat.nbytes, _WRITE_CHUNK):
                chunk = flat[lo : lo + _WRITE_CHUNK]
                csum = zlib.adler32(chunk, csum)
                wsum = _sum64(chunk, wsum)
                f.write(chunk)
            entry["adler32"] = csum
            entry["sum64"] = wsum
            pos += flat.nbytes
        if pos < data_bytes:
            f.write(b"\x00" * (data_bytes - pos))
        payload = json.dumps(header).encode("utf-8")
        assert _PREFIX + len(payload) <= data_start
        f.seek(_PREFIX)
        f.write(payload)
        f.write(b"\x00" * (data_start - _PREFIX - len(payload)))
        f.seek(0)
        f.write(MAGIC)
        f.write(len(payload).to_bytes(8, "big"))
        f.write(zlib.adler32(payload).to_bytes(4, "big"))
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    return data_start + data_bytes


class RawShardReader:
    """Zero-copy reader over one ``proc-<pid>.raw`` file.

    ``get`` returns a verified copy; ``view`` returns an mmap-backed
    array (valid until :meth:`close`); ``read_slice`` copies only the
    requested sub-range — the partial-restore primitive. Use as a
    context manager so the mmap is closed deterministically.
    """

    @staticmethod
    def _contig_span(shape, slices, itemsize):
        """(byte_offset, byte_len) within the shard if ``slices`` select
        a contiguous span — the whole shard, or a leading-axis range
        with every later axis full — else None."""
        if not shape:
            return 0, itemsize  # scalar shard
        norm = [
            (s.start or 0, s.stop if s.stop is not None else d)
            for s, d in zip(slices or (), shape)
        ]
        norm += [(0, d) for d in shape[len(norm):]]
        partial = [
            i for i, (b, d) in enumerate(zip(norm, shape))
            if b != (0, d)
        ]
        if partial not in ([], [0]):
            return None
        row = itemsize
        for d in shape[1:]:
            row *= d
        lo0, hi0 = norm[0]
        return lo0 * row, (hi0 - lo0) * row

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(_PREFIX)
            if len(head) < _PREFIX or head[:8] != MAGIC:
                raise ShardCorruptionError(
                    f"{path}: bad magic (torn or not a raw shard file)"
                )
            header_len = int.from_bytes(head[8:16], "big")
            header_sum = int.from_bytes(head[16:_PREFIX], "big")
            payload = f.read(header_len)
            if len(payload) < header_len:
                raise ShardCorruptionError(f"{path}: truncated header")
            if zlib.adler32(payload) != header_sum:
                # The index tells every read where to look; corruption
                # here would misdirect the (unverified-by-design)
                # partial-range reads, so it must die at open.
                raise ShardCorruptionError(
                    f"{path}: header checksum mismatch"
                )
            try:
                header = json.loads(payload.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ShardCorruptionError(
                    f"{path}: unparseable header ({e})"
                ) from e
        if header.get("version") != VERSION:
            raise ShardCorruptionError(
                f"{path}: unsupported raw format version "
                f"{header.get('version')!r}"
            )
        self.step = int(header["step"])
        self.process_id = int(header["process_id"])
        self._data_start = int(header["data_start"])
        self._index: Dict[str, dict] = {
            e["key"]: e for e in header["shards"]
        }
        end = self._data_start + max(
            (e["offset"] + e["nbytes"] for e in self._index.values()),
            default=0,
        )
        size = os.path.getsize(path)
        if size < end:
            raise ShardCorruptionError(
                f"{path}: truncated data region ({size} < {end} bytes)"
            )
        self._mm: Optional[np.memmap] = None
        self._mm_lock = threading.Lock()
        self._fd: Optional[int] = None  # pread path; offset-less, shared
        self.bytes_read = 0

    # ---- mapping interface -------------------------------------------------

    def keys(self):
        return self._index.keys()

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def bounds(self, key: str):
        return _tuple_bounds(self._index[key]["bounds"])

    def _mmap(self) -> np.memmap:
        # Restore fans leaf reads over a thread pool that shares one
        # reader per proc file; guard the lazy map (reads themselves are
        # lock-free — the mapping is immutable once created).
        with self._mm_lock:
            if self._mm is None:
                self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
            return self._mm

    def view(self, key: str) -> np.ndarray:
        """Zero-copy mmap-backed array; only touched pages are read."""
        e = self._index[key]
        mm = self._mmap()
        start = self._data_start + e["offset"]
        flat = mm[start : start + e["nbytes"]]
        return flat.view(_np_dtype(e["dtype"])).reshape(
            tuple(e["local_shape"])
        )

    def get(self, key: str, verify: bool = True) -> np.ndarray:
        """Full-shard copy, checksum-verified by default."""
        e = self._index[key]
        arr = np.array(self.view(key))  # copy out of the mmap
        self.bytes_read += arr.nbytes
        if verify:
            csum = zlib.adler32(_as_bytes(arr))
            if csum != e["adler32"]:
                raise ShardCorruptionError(
                    f"{self.path}: checksum mismatch on {key} "
                    f"(stored {e['adler32']}, read {csum})"
                )
        return arr

    def read_slice(self, key: str, slices: Tuple[slice, ...]) -> np.ndarray:
        """Copy of ``shard[slices]`` — reads only the pages the slice
        touches. No checksum (verifying would read the whole shard and
        defeat the point of a partial restore)."""
        out = np.array(self.view(key)[slices])
        self.bytes_read += out.nbytes
        return out

    def read_slice_into(
        self,
        key: str,
        slices: Tuple[slice, ...],
        dest: np.ndarray,
        verify: bool = False,
    ):
        """Copy ``shard[slices]`` straight from the mmap into ``dest``
        (a writable view) — one copy, no intermediate buffer.

        ``verify=True`` is only meaningful when the read covers the
        WHOLE shard (the engine passes it exactly then): the copied
        bytes are crc-checked against the header so full-shard restores
        honor the format's bitflip guarantee; a mismatch raises before
        the caller can use the poisoned region."""
        e = self._index[key]
        # The stored checksum covers the WHOLE shard; a sub-range read
        # cannot be verified against it.
        verify = verify and dest.nbytes == e["nbytes"]
        span = None
        if dest.flags.c_contiguous and dest.nbytes:
            span = self._contig_span(
                tuple(e["local_shape"]), slices,
                _np_dtype(e["dtype"]).itemsize,
            )
        if span is not None:
            # pread path: a contiguous byte span read straight into the
            # destination buffer skips the mmap's ~64k minor faults per
            # GB; the sum64 checksum (full-shard reads only) runs per
            # chunk while the bytes are cache-hot at SIMD speed.
            if self._fd is None:
                with self._mm_lock:
                    if self._fd is None:
                        self._fd = os.open(self.path, os.O_RDONLY)
            file_off = self._data_start + e["offset"] + span[0]
            dflat = _as_bytes(dest)
            wsum = 0
            chunk = 4 << 20
            for lo in range(0, dflat.nbytes, chunk):
                part = dflat[lo : lo + chunk]
                n = os.preadv(self._fd, [part], file_off + lo)
                if n != part.nbytes:
                    raise ShardCorruptionError(
                        f"{self.path}: short read on {key} "
                        f"({n} != {part.nbytes} bytes)"
                    )
                if verify:
                    wsum = _sum64(part, wsum)
        else:
            src = self.view(key)
            if slices:
                src = src[slices]
            np.copyto(dest, src)
            wsum = (
                _sum64(_as_bytes(np.ascontiguousarray(dest)))
                if verify
                else 0
            )
        self.bytes_read += dest.nbytes
        if verify and wsum != e["sum64"]:
            raise ShardCorruptionError(
                f"{self.path}: checksum mismatch on {key} "
                f"(stored sum64 {e['sum64']}, read {wsum})"
            )

    def verify_all(self) -> bool:
        try:
            for key in self._index:
                self.get(key, verify=True)
        except ShardCorruptionError as e:
            logger.error("%s", e)
            return False
        return True

    # ---- lifecycle ---------------------------------------------------------

    def close(self):
        if self._fd is not None:
            fd = self._fd
            self._fd = None
            try:
                os.close(fd)
            except OSError:
                pass
        if self._mm is not None:
            mm = self._mm
            self._mm = None
            # np.memmap keeps the mapping alive through ._mmap; close it
            # deterministically instead of waiting on the GC.
            try:
                mm._mmap.close()  # noqa: SLF001
            except (AttributeError, BufferError):
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best-effort backstop; close() is the contract
        try:
            self.close()
        except Exception:
            pass
