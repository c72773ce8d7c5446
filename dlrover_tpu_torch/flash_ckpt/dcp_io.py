"""``torch.distributed.checkpoint`` interop: export flash checkpoints
to PyTorch's standard sharded layout and import them back (the port's
counterpart of ``dlrover_tpu/flash_ckpt/orbax_io.py``, which bridges the
JAX package's checkpoints to orbax).

The flash engine's own format (raw mmap-able shards and a restricted
pickle meta, ``flash_ckpt/raw_format.py``) serves the shm fast path and
the self-restore. This module bridges it to DCP, so anything in the
PyTorch world (``dcp.load`` in another trainer, model surgery tools,
eval harnesses) can consume or produce the port's checkpoints:

    from dlrover_tpu_torch.flash_ckpt import dcp_io
    dcp_io.export_step(flash_dir, dcp_dir)              # newest step
    step, state = dcp_io.load_dcp(dcp_dir)              # any DCP dir
    dcp_io.import_step(dcp_dir, flash_dir)              # back in

Tensors cross both ways in their own dtype, bf16 bit for bit. A DCP
checkpoint is read without a template state dict, from one process
with no process group: its metadata gives every tensor's shape and
dtype and every key's nesting.

CLI: ``python -m dlrover_tpu_torch.flash_ckpt.dcp_io export|import ...``.
"""

import argparse
import contextlib
import json
import os
import warnings
from typing import Any, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.flash_ckpt import storage as fstorage

_META_FILE = "dlrover_tpu_meta.json"


def _dcp():
    import torch.distributed.checkpoint as dcp

    return dcp


@contextlib.contextmanager
def _one_process():
    """DCP without a process group warns that it assumes one process,
    which is what the bridge asks for."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message=".*assuming the intent is to (save|load) in "
            "a single process")
        yield


# ---------------------------------------------------------------------------
# Flash -> DCP
# ---------------------------------------------------------------------------


def export_step(flash_dir: str, dcp_dir: str,
                step: Optional[int] = None) -> int:
    """Write one flash step as a DCP checkpoint (``{dcp_dir}/{step}``)
    of the global state, with ``dlrover_tpu_meta.json`` (the step and
    the checkpoint's user meta) beside it. Without ``step``, the newest
    committed step (else the newest step dir). Returns the exported
    step."""
    from dlrover_tpu_torch.flash_ckpt.engine import load_global_state

    if step is None:
        committed = fstorage.read_tracker(flash_dir)
        steps = fstorage.list_step_dirs(flash_dir)
        candidates = [s for s in steps if s <= committed] or steps
        if not candidates:
            raise FileNotFoundError(
                f"no flash checkpoint steps under {flash_dir}")
        step = max(candidates)
    metas = fstorage.load_step_meta(flash_dir, step)
    if not metas:
        raise FileNotFoundError(
            f"flash step {step} has no metadata under {flash_dir}")
    loaded = load_global_state(flash_dir, step, metas)
    if loaded is None:
        raise RuntimeError(
            f"flash step {step} is incomplete (missing shards)")
    _, state, user_meta = loaded
    path = os.path.join(os.path.abspath(dcp_dir), str(step))
    os.makedirs(path, exist_ok=True)
    with _one_process():
        _dcp().save(state, checkpoint_id=path, no_dist=True)
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump({"step": step, "user_meta": user_meta}, f, default=str)
    logger.info("exported flash step %d -> DCP at %s", step, path)
    return step


# ---------------------------------------------------------------------------
# DCP -> flash (or direct use)
# ---------------------------------------------------------------------------


def list_dcp_steps(dcp_dir: str):
    steps = []
    try:
        for name in os.listdir(dcp_dir):
            if name.isdigit():
                steps.append(int(name))
    except OSError:
        pass
    return sorted(steps)


def _set_path(tree, path, value):
    """Put ``value`` at ``path`` (dict keys, list indices) in ``tree``,
    making the dicts and lists on the way."""
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            node.extend([None] * (key + 1 - len(node)))
        elif key not in node:
            node[key] = None
        if node[key] is None:
            node[key] = [] if isinstance(nxt, int) else {}
        node = node[key]
    last = path[-1]
    if isinstance(node, list):
        node.extend([None] * (last + 1 - len(node)))
    node[last] = value


def _template(metadata, device):
    """A state dict to load into, built from a checkpoint's metadata:
    an empty tensor of the stored shape and dtype for each tensor key,
    a placeholder for each non-tensor key, nested as the saver's
    flattening recorded (``planner_data``)."""
    dcp = _dcp()
    mappings = metadata.planner_data or {}
    tree: dict = {}
    for fqn, md in metadata.state_dict_metadata.items():
        if isinstance(md, dcp.TensorStorageMetadata):
            value = torch.empty(tuple(md.size), dtype=md.properties.dtype,
                                device=device)
        else:
            value = None
        _set_path(tree, tuple(mappings.get(fqn, (fqn,))), value)
    return tree


def load_dcp(dcp_dir: str, step: Optional[int] = None,
             device="cuda") -> Tuple[int, Any]:
    """Load a DCP checkpoint (written by this module or any DCP
    producer) without a template, in this process alone: the newest
    step under ``dcp_dir`` by default. Tensors land on ``device`` (the
    card unless the caller asks for the CPU). Returns (step, state)."""
    dcp = _dcp()
    if step is None:
        steps = list_dcp_steps(dcp_dir)
        if not steps:
            raise FileNotFoundError(f"no DCP steps under {dcp_dir}")
        step = steps[-1]
    path = os.path.join(os.path.abspath(dcp_dir), str(step))
    state = _template(dcp.FileSystemReader(path).read_metadata(),
                      torch.device(device))
    with _one_process():
        dcp.load(state, checkpoint_id=path, no_dist=True)
    return step, state


def _host_array(leaf) -> np.ndarray:
    """A leaf's bytes as the flash format stores them (bf16 and float8
    as their unsigned bits)."""
    from dlrover_tpu_torch.flash_ckpt.shm_handler import (
        dtype_name,
        storage_dtype,
    )

    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    host = leaf.detach().cpu().contiguous()
    return host.reshape(-1).view(torch.uint8).numpy().view(
        storage_dtype(dtype_name(host))).reshape(tuple(host.shape))


def import_step(dcp_dir: str, flash_dir: str,
                step: Optional[int] = None) -> int:
    """Bring a DCP checkpoint into the flash layout, each leaf one
    replicated shard, and commit it in the tracker, so the engine's
    restore (storage fallback, replicas, the resharding restore into a
    mesh's DTensors) can serve it. Returns the imported step."""
    from dlrover_tpu_torch.flash_ckpt.shm_handler import (
        LeafMeta,
        ShardMeta,
        dtype_name,
        tree_flatten,
    )

    step, state = load_dcp(dcp_dir, step, device="cpu")
    leaves, spec = tree_flatten(state)
    arrays = {}
    leaf_metas = []
    for i, leaf in enumerate(leaves):
        arr = _host_array(leaf)
        shape = tuple(arr.shape)
        leaf_metas.append(LeafMeta(
            leaf_id=i, global_shape=shape, dtype=dtype_name(leaf),
            shards=[ShardMeta(tuple((0, n) for n in shape), shape)],
            replicated=True))
        arrays[f"leaf{i}_shard0"] = arr
    meta = {
        "step": step,
        "treespec": spec,
        "leaves": leaf_metas,
        "user_meta": {"imported_from": os.path.abspath(dcp_dir)},
        "num_processes": 1,
    }
    fstorage.persist_node_shards(
        flash_dir, step, node_rank=0,
        proc_payloads={0: {"arrays": arrays, "meta": meta}})
    fstorage.write_tracker(flash_dir, step)
    logger.info("imported DCP step %d -> flash at %s", step, flash_dir)
    return step


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="flash <-> DCP bridge")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_exp = sub.add_parser("export", help="flash checkpoint -> DCP")
    p_exp.add_argument("--flash-dir", required=True)
    p_exp.add_argument("--dcp-dir", required=True)
    p_exp.add_argument("--step", type=int, default=None)
    p_imp = sub.add_parser("import", help="DCP checkpoint -> flash")
    p_imp.add_argument("--dcp-dir", required=True)
    p_imp.add_argument("--flash-dir", required=True)
    p_imp.add_argument("--step", type=int, default=None)
    args = parser.parse_args(argv)
    if args.cmd == "export":
        step = export_step(args.flash_dir, args.dcp_dir, args.step)
    else:
        step = import_step(args.dcp_dir, args.flash_dir, args.step)
    print(step)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
