"""POSIX shared-memory image of a checkpoint tree of tensors (the port's
counterpart of ``dlrover_tpu/flash_ckpt/shm_handler.py``).

Layout (self-contained, parseable by any process that attaches), the
reference's:

    [8B magic "DLRTPUC2"][8B meta_len][8B step][pickled meta][padding]
    [leaf data, each leaf at a 128-byte aligned offset]

The tree is nested dicts, lists and tuples whose leaves are torch
tensors (on the card or the host), DTensors, numpy arrays or Python
scalars. A DTensor leaf is stored as this rank's shard: its
``ShardMeta.index`` holds the shard's global bounds, as the reference
stores a JAX array's addressable shard, and the leaf is ``replicated``
only when the shard is the whole leaf. It
flattens as ``jax.tree_util`` flattens a tree of arrays: dict keys in
sorted order, sequences in order, ``None`` an empty subtree. So the same
nested dict of arrays gets the same leaf ids, offsets and data region,
byte for byte, as the reference's image.

The meta pickle differs from the reference's: where it holds a pickled
JAX ``PyTreeDef`` under ``"treedef"``, the port holds its tree spec, a
structure of builtins, under ``"treespec"`` (``tree_flatten``). Neither
package restores the other's segment as a tree; the data region and
``LeafMeta`` describe the same bytes.

bf16 crosses as its uint16 bits under the dtype name ``"bfloat16"``
(``storage_dtype``); nothing here imports ``ml_dtypes``.
"""

import os
import pickle
import threading
from dataclasses import dataclass, field
from multiprocessing import shared_memory
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.serialize import loads_pytree

MAGIC = b"DLRTPUC2"
_HDR = 24  # magic + meta_len + step
_ALIGN = 128

# Tree spec nodes (builtins only, so the restricted unpickler admits
# them): a tensor or array leaf, a Python scalar leaf, None, or a
# ("dict", keys, children) / ("list", children) / ("tuple", children).
LEAF = "*"
SCALAR = "py"
NONE = "none"


def _untrack_shm(shm: shared_memory.SharedMemory):
    """Detach the segment from multiprocessing's resource tracker.

    The image must outlive the process that wrote it: a SIGKILLed
    worker's state survives in host memory. On CPython 3.12 both
    creating and attaching register the name with the tracker, which
    unlinks what it holds when its process dies; the agent owns cleanup
    instead (``AsyncCheckpointSaver.unlink_all``).
    """
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
    except Exception:
        pass


# ---- dtypes ---------------------------------------------------------------

_BITS_AS = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
            "float8_e5m2": np.uint8}


def dtype_name(leaf) -> str:
    """The reference's dtype name of a leaf (numpy's names; torch's
    bf16 and float8 names are ml_dtypes')."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).rsplit(".", 1)[-1]
    return np.asarray(leaf).dtype.name


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype whose bytes hold a stored dtype: bf16 and float8
    as their unsigned bits, every other name as itself."""
    return np.dtype(_BITS_AS.get(name, name))


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def local_tensor(leaf):
    """The tensor holding a leaf's stored bytes: a DTensor's local
    shard, any other leaf itself."""
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        with torch.no_grad():
            return leaf.to_local()
    return leaf


def dtensor_bounds(leaf):
    """A DTensor's shard bounds on this rank, or None for another
    leaf."""
    from torch.distributed.tensor import DTensor

    if not isinstance(leaf, DTensor):
        return None
    from dlrover_tpu_torch.parallel.sharding import shard_bounds

    return shard_bounds(leaf.shape, leaf.device_mesh, leaf.placements)


def leaf_bytes(leaf) -> torch.Tensor:
    """A flat uint8 view (or, for a non-contiguous tensor, copy) of a
    leaf's bytes (a DTensor's: its local shard's), on the leaf's
    device."""
    leaf = local_tensor(leaf)
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.from_numpy(np.ascontiguousarray(np.asarray(leaf)))
    return leaf.contiguous().reshape(-1).view(torch.uint8)


# ---- tree spec ------------------------------------------------------------


def tree_flatten(tree) -> Tuple[list, Any]:
    """(leaves, spec), in ``jax.tree_util`` order."""
    leaves: list = []

    def walk(node):
        if node is None:
            return NONE
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return ("dict", keys, tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, tuple(walk(v) for v in node))
        if isinstance(node, (torch.Tensor, np.ndarray, np.generic)):
            leaves.append(node)
            return LEAF
        if isinstance(node, (bool, int, float)):
            leaves.append(node)
            return SCALAR
        raise TypeError(f"checkpoint leaf of type {type(node).__name__}")

    spec = walk(tree)
    return leaves, spec


def tree_unflatten(spec, leaves) -> Any:
    it = iter(leaves)

    def build(node):
        if node == NONE:
            return None
        if node in (LEAF, SCALAR):
            leaf = next(it)
            if node == SCALAR and isinstance(leaf, torch.Tensor):
                return leaf.item()
            return leaf
        if node[0] == "dict":
            return {k: build(c) for k, c in zip(node[1], node[2])}
        children = [build(c) for c in node[1]]
        return children if node[0] == "list" else tuple(children)

    return build(spec)


# ---- metadata -------------------------------------------------------------


@dataclass
class ShardMeta:
    """One shard of one leaf: a whole leaf, or a DTensor's local
    shard."""

    index: Tuple[Tuple[Optional[int], Optional[int]], ...]  # slice bounds
    local_shape: Tuple[int, ...]
    offset: int = 0
    nbytes: int = 0


@dataclass
class LeafMeta:
    leaf_id: int
    global_shape: Tuple[int, ...]
    dtype: str
    shards: List[ShardMeta] = field(default_factory=list)
    replicated: bool = False  # every process holds the full leaf


def layout(leaves) -> Tuple[List[LeafMeta], int]:
    """Leaf metas with 128-byte aligned offsets, and the data bytes."""
    metas, offset = [], 0
    for i, leaf in enumerate(leaves):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        name = dtype_name(leaf)
        whole = tuple((0, s) for s in shape)
        bounds = dtensor_bounds(leaf) or whole
        local_shape = tuple(hi - lo for lo, hi in bounds)
        nbytes = int(np.prod(local_shape, dtype=np.int64)) * storage_dtype(
            name).itemsize
        shard = ShardMeta(bounds, local_shape, offset, nbytes)
        metas.append(LeafMeta(i, shape, name, [shard],
                              replicated=bounds == whole))
        offset = (offset + nbytes + _ALIGN - 1) // _ALIGN * _ALIGN
    return metas, offset


def leaves_filler(leaves, leaf_metas: List[LeafMeta]):
    """``fill(data)`` for ``write_image``: each leaf's bytes copied to
    its offset (straight from the card for leaves there)."""
    def fill(data: torch.Tensor):
        for leaf, meta in zip(leaves, leaf_metas):
            shard = meta.shards[0]
            data[shard.offset:shard.offset + shard.nbytes].copy_(
                leaf_bytes(leaf))

    return fill


def host_leaf(data: torch.Tensor, meta: LeafMeta) -> torch.Tensor:
    """A leaf's tensor over its bytes in ``data`` (no copy)."""
    shard = meta.shards[0]
    raw = data[shard.offset:shard.offset + shard.nbytes]
    return raw.view(torch_dtype(meta.dtype)).reshape(shard.local_shape)


class SharedMemoryHandler:
    """Owns one named shm segment holding the latest checkpoint image."""

    def __init__(self, name: str):
        self._name = name.replace("/", "_")
        self._shm: Optional[shared_memory.SharedMemory] = None
        self._bytes: Optional[torch.Tensor] = None  # uint8 over the segment
        self._lock = threading.Lock()

    @property
    def name(self) -> str:
        return self._name

    @property
    def size(self) -> int:
        return self._shm.size if self._shm is not None else 0

    # ---- plumbing ----------------------------------------------------------

    def _open(self, create: bool, size: int = 0):
        self._shm = shared_memory.SharedMemory(
            name=self._name, create=create, size=size)
        _untrack_shm(self._shm)
        self._bytes = torch.frombuffer(self._shm.buf, dtype=torch.uint8)

    def _ensure_shm(self, size: int):
        if self._shm is None:
            # A restarted worker reuses the segment its predecessor left.
            self.attach()
        if self._shm is not None and self._shm.size >= size:
            return
        if self._shm is not None:
            self._release()
            _unlink_name(self._name)
        # Grow with headroom so steady-state saves never reallocate.
        alloc = max(int(size * 1.2), 1 << 20)
        self._open(create=True, size=alloc)
        logger.info("created shm %s (%d MB)", self._name, alloc >> 20)

    def attach(self) -> bool:
        """Attach to an existing segment (agent side / restarted worker)."""
        if self._shm is not None:
            return True
        try:
            self._open(create=False)
            return True
        except FileNotFoundError:
            return False

    def exists(self) -> bool:
        return self.attach()

    def is_current(self) -> bool:
        """True while the attached segment is the one the name points
        at (not unlinked, nor recreated larger by its writer)."""
        if self._shm is None:
            return False
        try:
            named = os.stat(os.path.join("/dev/shm", self._name)).st_ino
        except FileNotFoundError:
            return False
        return named == os.fstat(self._shm._fd).st_ino  # noqa: SLF001

    def _release(self):
        # The tensor view exports the buffer: drop it before closing.
        self._bytes = None
        self._shm.close()
        self._shm = None

    # ---- save --------------------------------------------------------------

    def write_image(self, step: int, spec, leaf_metas: List[LeafMeta],
                    data_bytes: int, fill,
                    user_meta: Optional[Dict[str, Any]] = None) -> int:
        """Write one image: ``fill(data)`` copies the leaves into
        ``data``, a uint8 tensor over the segment's data region. The
        magic is zero while the bytes move and is written last, so a
        reader never takes a half-written image. Returns bytes."""
        meta_obj = {
            "step": step,
            "user_meta": user_meta or {},
            "treespec": spec,
            "leaves": leaf_metas,
            "data_start": 0,
        }
        meta_len = len(pickle.dumps(meta_obj))
        # Reserve generous meta space so minor growth doesn't re-layout.
        meta_space = (meta_len + 4096 + _ALIGN - 1) // _ALIGN * _ALIGN
        data_start = _HDR + meta_space
        total = data_start + data_bytes
        with self._lock:
            self._ensure_shm(total)
            buf = self._shm.buf
            buf[:8] = b"\x00" * 8
            meta_obj["data_start"] = data_start
            payload = pickle.dumps(meta_obj)
            buf[8:16] = len(payload).to_bytes(8, "big")
            # Step in the fixed header: get_step() must not unpickle.
            buf[16:_HDR] = int(step).to_bytes(8, "big", signed=True)
            buf[_HDR:_HDR + len(payload)] = payload
            fill(self._bytes[data_start:total])
            buf[:8] = MAGIC  # commit
        return total

    def save_state_dict(self, step: int, state: Any,
                        user_meta: Optional[Dict[str, Any]] = None) -> int:
        """Write the tree's image synchronously (leaves on the card are
        copied straight into the segment); returns bytes written."""
        leaves, spec = tree_flatten(state)
        leaf_metas, data_bytes = layout(leaves)
        return self.write_image(step, spec, leaf_metas, data_bytes,
                                leaves_filler(leaves, leaf_metas),
                                user_meta)

    # ---- load --------------------------------------------------------------

    def load_meta(self) -> Optional[dict]:
        if not self.attach():
            return None
        buf = self._shm.buf
        if bytes(buf[:8]) != MAGIC:
            return None
        meta_len = int.from_bytes(bytes(buf[8:16]), "big")
        # Restricted unpickle: a segment is outside input. The JAX
        # package's image (its meta names that package's classes and a
        # PyTreeDef) is not the port's to restore.
        try:
            meta = loads_pytree(bytes(buf[_HDR:_HDR + meta_len]))
        except pickle.UnpicklingError as e:
            logger.warning("shm %s holds no image of the port: %s",
                           self._name, e)
            return None
        return meta if "treespec" in meta else None

    def data_region(self, meta: dict) -> torch.Tensor:
        """uint8 tensor over the image's data region (valid while the
        handler stays attached)."""
        start = meta["data_start"]
        end = max((lm.shards[0].offset + lm.shards[0].nbytes
                   for lm in meta["leaves"]), default=0)
        return self._bytes[start:start + end]

    def load_state_dict(self, target=None
                        ) -> Optional[Tuple[int, Any, dict]]:
        """(step, tree, user_meta), or None without a committed image.

        Without ``target`` the leaves are host tensors copied out of the
        segment. With ``target`` (a tree of the image's structure) every
        tensor leaf of ``target`` is filled in place, on its own device,
        and the returned tree holds those tensors; Python scalar leaves
        come back as the image's values."""
        meta = self.load_meta()
        if meta is None:
            return None
        data = self.data_region(meta)
        on_card = target is not None and any(
            isinstance(t, torch.Tensor) and local_tensor(t).is_cuda
            for t in tree_flatten(target)[0])
        # Registered (page-locked) for the copy, the segment feeds the
        # card by DMA; pageable, every page goes through a bounce buffer.
        ptr = self._bytes.data_ptr()
        registered = on_card and torch.cuda.cudart().cudaHostRegister(
            ptr, self._shm.size, 0) == 0
        try:
            tree = fill_tree(meta["treespec"], meta["leaves"],
                             lambda lm: host_leaf(data, lm), target)
            if registered:
                torch.cuda.synchronize()
        finally:
            if registered:
                torch.cuda.cudart().cudaHostUnregister(ptr)
        return meta["step"], tree, meta.get("user_meta", {})

    def get_step(self) -> int:
        """Step of the current image, or -1: a 24-byte header read (the
        persist barrier polls it)."""
        if not self.attach():
            return -1
        buf = self._shm.buf
        if bytes(buf[:8]) != MAGIC:
            return -1
        return int.from_bytes(bytes(buf[16:_HDR]), "big", signed=True)

    # ---- cleanup -----------------------------------------------------------

    def close(self):
        with self._lock:
            if self._shm is not None:
                self._release()

    def unlink(self):
        with self._lock:
            if self._shm is not None:
                self._release()
            _unlink_name(self._name)


def _unlink_name(name: str):
    try:
        shm = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return
    # unlink() also unregisters the name the attach registered.
    try:
        shm.unlink()
    except FileNotFoundError:
        pass
    shm.close()


def fill_tree(spec, leaf_metas: List[LeafMeta], read, target=None):
    """Rebuild a checkpoint tree from ``read(leaf_meta) -> host tensor``
    (a view of the stored bytes of the leaf's one shard). Without
    ``target`` each tensor leaf is a host copy; with one, its tensors
    are filled in place after the structure, shapes, dtypes and (for a
    DTensor, whose local shard is filled) shard bounds are checked
    against the image."""
    if target is None:
        leaves = [read(lm).clone() for lm in leaf_metas]
        return tree_unflatten(spec, leaves)
    targets, target_spec = tree_flatten(target)
    if target_spec != spec:
        raise ValueError("restore target's tree differs from the image's")
    leaves = []
    for dst, lm in zip(targets, leaf_metas):
        if isinstance(dst, torch.Tensor):
            check_target_leaf(dst, lm)
            bounds = dtensor_bounds(dst) or tuple(
                (0, s) for s in lm.global_shape)
            if tuple(lm.shards[0].index) != bounds:
                raise ValueError(
                    f"leaf {lm.leaf_id}: target shard {bounds}, image "
                    f"shard {lm.shards[0].index}")
            with torch.no_grad():  # params are autograd leaves
                local_tensor(dst).copy_(read(lm))
            leaves.append(dst)
        else:
            leaves.append(read(lm).clone())
    return tree_unflatten(spec, leaves)


def check_target_leaf(dst, lm: LeafMeta) -> None:
    """A restore target's tensor must have the stored leaf's global
    shape and dtype."""
    if (tuple(dst.shape) != tuple(lm.global_shape)
            or dtype_name(dst) != lm.dtype):
        raise ValueError(
            f"leaf {lm.leaf_id}: target {tuple(dst.shape)} "
            f"{dtype_name(dst)}, image {lm.global_shape} {lm.dtype}")
