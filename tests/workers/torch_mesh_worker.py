"""One rank of a gloo world for the port's mesh tests (no JAX here).

    python tests/workers/torch_mesh_worker.py <case> <dir>

The world comes from the agent's env (``DLROVER_TPU_COORDINATOR``,
``DLROVER_TPU_NUM_PROCESSES``, ``DLROVER_TPU_PROCESS_ID``). ``<dir>``
holds ``in.pkl`` (the case's numpy inputs, written by the test); rank r
writes ``out<r>.pkl``. Cases:

- ``train``: the tiny config's trajectory on ``in["mesh"]`` from the
  JAX package's state, then the eval step's CE on the first batch;
  with ``in["extra"]`` also grad accumulation 2 against 1, the CE
  routes under tp, and the mesh cases that raise;
- ``restore``: ``load_global_state`` of ``in["ckpt_dir"]``'s step into
  DTensor targets laid out by ``in["leaves_meta"]`` on ``in["mesh"]``;
  each rank returns its local shards and the bytes it read;
- ``save``: the same targets filled from ``in["full"]`` and saved to
  storage through the standalone checkpoint engine.
"""

import os
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from dlrover_tpu_torch.flash_ckpt import engine as ckpt_engine  # noqa: E402
from dlrover_tpu_torch.flash_ckpt import storage as ckpt_storage  # noqa: E402
from dlrover_tpu_torch.models import convert, llama  # noqa: E402
from dlrover_tpu_torch.ops import fused_ce  # noqa: E402
from dlrover_tpu_torch.parallel import sharding  # noqa: E402
from dlrover_tpu_torch.parallel.mesh import (  # noqa: E402
    MeshConfig,
    build_mesh,
)
from dlrover_tpu_torch.trainer import runtime  # noqa: E402
from dlrover_tpu_torch.trainer import train_step as ts  # noqa: E402


def _trajectory(cfg, tc, crossed, mesh, batches):
    opt = ts.make_optimizer(tc)
    state = convert.train_state_from_numpy(cfg, crossed, opt, mesh=mesh)
    step = ts.make_train_step(cfg, tc, opt, mesh=mesh)
    losses, norms = [], []
    for tokens in batches:
        state, m = step(state, {"tokens": tokens})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    ce = ts.make_eval_step(cfg, mesh=mesh)(state["params"],
                                           {"tokens": batches[0]})
    return (losses, norms, convert.params_to_numpy(state["params"]),
            float(ce))


def _raises(fn) -> str:
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return ""


def _extra(cfg, tc, crossed, mesh, batches, out):
    """Grad accumulation, the CE routes and the cases that raise."""
    ga2 = ts.TrainConfig(**{**tc.__dict__, "grad_accum": 2})
    out["ga1"] = _trajectory(cfg, tc, crossed, mesh, batches[:1])
    out["ga2"] = _trajectory(cfg, ga2, crossed, mesh, batches[:1])
    with sharding.use_mesh(mesh):
        out["ce_impl"] = fused_ce.resolve_impl()
        out["fused_ce_applicable"] = llama._fused_ce_applicable(cfg)
    # The vocab scan over a tp-sharded lm_head against the dense CE of
    # the whole logits, loss and gradients.
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(12, cfg.embed_dim).astype(np.float32))
    w = torch.from_numpy(rs.randn(cfg.embed_dim, cfg.vocab_size)
                         .astype(np.float32) / 8)
    tgt = torch.from_numpy(rs.randint(0, cfg.vocab_size, 12))
    x.requires_grad_(True)
    w_full = w.clone().requires_grad_(True)
    dense = llama.cross_entropy((x @ w_full)[None], tgt[None])
    dx_want, dw_want = torch.autograd.grad(dense, (x, w_full))
    cols = cfg.vocab_size // sharding.axis_size("tp", mesh)
    lo = mesh.get_local_rank("tp") * cols
    w_local = w[:, lo:lo + cols].clone().requires_grad_(True)
    with sharding.use_mesh(mesh):
        fused = fused_ce.fused_cross_entropy(x, w_local, tgt)
    dx_got, dw_got = torch.autograd.grad(fused, (x, w_local))
    out["vocab_scan"] = {
        "loss": (float(fused), float(dense)),
        "dx": float((dx_got - dx_want).abs().max()),
        "dw": float((dw_got - dw_want[:, lo:lo + cols]).abs().max()),
    }
    opt = ts.make_optimizer(tc)
    n = mesh.size()
    moe = llama.tiny_config(n_layers=1, n_experts=4)
    out["raises"] = {
        "sp": _raises(lambda: ts.make_train_step(
            cfg, tc, opt, mesh=build_mesh(MeshConfig(sp=n), "cpu"))),
        "pp_axis": _raises(lambda: ts.make_train_step(
            cfg, tc, opt, mesh=build_mesh(MeshConfig(pp=n), "cpu"))),
        "pp_stages": _raises(lambda: ts.make_train_step(
            llama.tiny_config(pp_stages=2), tc, opt, mesh=mesh)),
        "moe": _raises(lambda: ts.make_train_step(moe, tc, opt, mesh=mesh)),
    }


def _targets(inp, mesh):
    """Zeroed DTensors of the checkpoint's leaves, laid out by the case's
    specs, with the JAX package's leaf names."""
    from dlrover_tpu_torch.parallel.sharding import P, shard_tensor

    return {name: shard_tensor(torch.zeros(shape, dtype=getattr(
        torch, dtype)), mesh, P(*spec))
        for name, (shape, dtype, spec) in inp["leaves_meta"].items()}


def main():
    case, work = sys.argv[1], Path(sys.argv[2])
    inp = pickle.loads((work / "in.pkl").read_bytes())
    torch.set_num_threads(1)
    ctx = runtime.init_distributed(timeout_secs=120, device="cpu")
    mesh = build_mesh(MeshConfig(**inp["mesh"]), "cpu")
    out = {"rank": ctx.process_id, "coord": mesh.get_coordinate()}
    if case == "train":
        cfg = llama.TpuLMConfig(**inp["cfg"])
        tc = ts.TrainConfig(**inp["tc"])
        out["losses"], out["norms"], out["params"], out["eval_ce"] = \
            _trajectory(cfg, tc, inp["state"], mesh, inp["batches"])
        if inp.get("extra"):
            _extra(cfg, tc, inp["state"], mesh, inp["batches"], out)
    elif case == "restore":
        targets = _targets(inp, mesh)
        metas = ckpt_storage.load_step_meta(inp["ckpt_dir"], inp["step"])
        stats = {}
        result = ckpt_engine.load_global_state(
            inp["ckpt_dir"], inp["step"], metas, target=targets, stats=stats)
        out["restored"] = result is not None
        out["bytes_read"] = stats.get("bytes_read")
        # Raw bytes (numpy has no bf16); the test views them.
        out["local"] = {
            k: (sharding.shard_bounds(t.shape, mesh, t.placements),
                t.to_local().contiguous().view(torch.uint8).numpy())
            for k, t in targets.items()}
    elif case == "save":
        targets = _targets(inp, mesh)
        for name, t in targets.items():
            bounds = sharding.shard_bounds(t.shape, mesh, t.placements)
            src = torch.from_numpy(np.ascontiguousarray(inp["full"][name][
                tuple(slice(lo, hi) for lo, hi in bounds)]))
            # bf16 arrives as its uint16 bits.
            t.to_local().copy_(src.view(t.dtype))
        engine = ckpt_engine.CheckpointEngine(inp["ckpt_dir"],
                                              standalone=True)
        engine.save_to_storage(inp["step"], targets)
        torch.distributed.barrier()
        engine.close()
        out["tracker"] = ckpt_storage.read_tracker(inp["ckpt_dir"])
    (work / f"out{ctx.process_id}.pkl").write_bytes(pickle.dumps(out))
    runtime.shutdown_distributed()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
