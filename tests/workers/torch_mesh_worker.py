"""One rank of a gloo world for the port's mesh tests (no JAX here).

    python tests/workers/torch_mesh_worker.py <case> <dir>

The world comes from the agent's env (``DLROVER_TPU_COORDINATOR``,
``DLROVER_TPU_NUM_PROCESSES``, ``DLROVER_TPU_PROCESS_ID``). ``<dir>``
holds ``in.pkl`` (the case's numpy inputs, written by the test); rank r
writes ``out<r>.pkl``. Cases:

- ``train``: the tiny config's trajectory on ``in["mesh"]`` from the
  JAX package's state, then the eval step's CE on the first batch;
  with ``in["extra"]`` also grad accumulation 2 against 1, the CE
  routes under tp, one step of each of sp, a pp axis, pipeline stages,
  a pp axis of replicas (``pp_stages`` 1) and a dropless MoE on a mesh
  of the world (against the same step without a mesh);
- ``moe``: one dropless MoE layer (``in["impl"]`` "ep" or "sharded")
  on this rank's rows, its params laid out by the model's rules and
  gathered as the model gathers them; the output, the global router
  losses, and the gradients of a weighted loss;
- ``gshard``: one gshard MoE layer (``moe_mlp`` with the mesh's sp
  group) on this rank's rows and sequence chunk, its weights laid out
  and gathered as the model's; the output, ``dropped_fraction``, the
  global router losses, and the gradients of a weighted loss;
- ``ring``: ring attention on this rank's rows, sequence chunk and
  heads, both impls, causal and not: outputs and the gradients of a
  weighted loss; packed positions through both impls; an unknown
  impl;
- ``restore``: ``load_global_state`` of ``in["ckpt_dir"]``'s step into
  DTensor targets laid out by ``in["leaves_meta"]`` on ``in["mesh"]``;
  each rank returns its local shards and the bytes it read;
- ``save``: the same targets filled from ``in["full"]`` and saved to
  storage through the standalone checkpoint engine.
"""

import dataclasses
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


def _one_step(cfg, tc, params_np, mesh, tokens):
    """(loss, grad norm) of one step from ``params_np`` with a fresh
    optimizer, on ``mesh`` or without one."""
    opt = ts.make_optimizer(tc)
    params = convert.params_from_numpy(params_np, "cpu")
    state = ts.init_train_state(cfg, opt, params, mesh=mesh)
    step = ts.make_train_step(cfg, tc, opt, device="cpu", mesh=mesh)
    _, m = step(state, {"tokens": tokens})
    return float(m["loss"]), float(m["grad_norm"])


def _extra(cfg, tc, crossed, mesh, batches, out):
    """Grad accumulation, the CE routes and the mesh axes."""
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
    # Each axis on the world: one step each, against the same step
    # without a mesh.
    n = mesh.size()
    tokens = batches[0]
    flat = crossed["params"]
    moe = llama.tiny_config(n_layers=1, n_experts=4, moe_impl="dropless")
    moe_np = convert.params_to_numpy(llama.init_params(
        moe, torch.Generator().manual_seed(5), device="cpu"))
    pp_cfg = dataclasses.replace(cfg, pp_stages=2, num_microbatches=2)
    staged = convert.to_stage_layout(flat, 2)
    cases = {
        "sp": (cfg, flat, MeshConfig(sp=n)),
        "pp_axis": (pp_cfg, staged, MeshConfig(pp=2, dp=n // 2)),
        "pp_stages": (pp_cfg, staged, None),
        "pp_replicas": (cfg, flat, MeshConfig(pp=n)),
        "moe": (moe, moe_np, None),
    }
    out["runs"] = {}
    for name, (c, p_np, mcfg) in cases.items():
        m = mesh if mcfg is None else build_mesh(mcfg, "cpu")
        out["runs"][name] = (_one_step(c, tc, p_np, m, tokens),
                             _one_step(c, tc, p_np, None, tokens))


_MOE_AXES = {"router": ("embed", "expert"),
             "w_gate": ("expert", "embed", "mlp"),
             "w_up": ("expert", "embed", "mlp"),
             "w_down": ("expert", "mlp", "embed")}


def _rows(mesh, n_rows):
    idx, count = sharding.batch_index(mesh)
    per = n_rows // count
    return idx * per, (idx + 1) * per


def _moe_case(inp, mesh, out):
    """One MoE layer on this rank's rows (see the module doc)."""
    from dlrover_tpu_torch.models import moe as moe_lib

    lo, hi = _rows(mesh, inp["x"].shape[0])
    x = torch.from_numpy(inp["x"][lo:hi]).requires_grad_(True)
    g = torch.from_numpy(inp["gout"][lo:hi])
    keep = ("ep",) if inp["impl"] == "ep" else ()
    fn = (moe_lib.moe_mlp_dropless_ep if inp["impl"] == "ep"
          else moe_lib.moe_mlp_dropless_sharded)
    for dispatch in ("fused", "gmm"):
        leaves, bounds, local = {}, {}, {}
        for name, axes in _MOE_AXES.items():
            dt = sharding.shard_tensor(torch.from_numpy(inp[name]), mesh,
                                       sharding.logical_to_spec(axes))
            leaves[name] = dt.to_local().clone().requires_grad_(True)
            bounds[name] = sharding.shard_bounds(dt.shape, mesh,
                                                 dt.placements)
            view = sharding.ShardedParam(leaves[name], mesh, dt.placements)
            kw = {} if name == "router" else {"keep": keep,
                                               "gather_tp": True}
            local[name] = sharding.local_param(view, **kw)
        with sharding.use_mesh(mesh):
            y, metrics = fn(x, *(local[k] for k in _MOE_AXES), mesh=mesh,
                            top_k=inp["top_k"], dispatch=dispatch)
            aux = metrics.aux_loss + 0.001 * metrics.router_z_loss
            loss = (y * g).sum() + inp["aux_weight"] * aux / (
                sharding.share_count(mesh))
            grads = torch.autograd.grad(loss, [x] + list(leaves.values()))
        out[dispatch] = {
            "rows": (lo, hi), "y": y.detach().numpy(),
            "aux": float(metrics.aux_loss), "z": float(metrics.router_z_loss),
            "dx": grads[0].numpy(),
            "grads": {k: (bounds[k], gr.numpy())
                      for k, gr in zip(leaves, grads[1:])}}


def _seq(mesh, seq_len):
    """(lo, hi) of this rank's contiguous chunk of a sequence over sp."""
    sp = sharding.axis_size("sp", mesh)
    r = mesh.get_local_rank("sp") if sp > 1 else 0
    return r * seq_len // sp, (r + 1) * seq_len // sp


def _gshard_case(inp, mesh, out):
    """One gshard MoE layer on this rank's tokens (see the module doc)."""
    from dlrover_tpu_torch.models import moe as moe_lib

    lo, hi = _rows(mesh, inp["x"].shape[0])
    s0, s1 = _seq(mesh, inp["x"].shape[1])
    x = torch.from_numpy(np.ascontiguousarray(
        inp["x"][lo:hi, s0:s1])).requires_grad_(True)
    g = torch.from_numpy(np.ascontiguousarray(inp["gout"][lo:hi, s0:s1]))
    leaves, bounds, local = {}, {}, {}
    for name, axes in _MOE_AXES.items():
        dt = sharding.shard_tensor(torch.from_numpy(inp[name]), mesh,
                                   sharding.logical_to_spec(axes))
        leaves[name] = dt.to_local().clone().requires_grad_(True)
        bounds[name] = sharding.shard_bounds(dt.shape, mesh, dt.placements)
        view = sharding.ShardedParam(leaves[name], mesh, dt.placements)
        kw = {} if name == "router" else {"gather_tp": True}
        local[name] = sharding.local_param(view, **kw)
    with sharding.use_mesh(mesh):
        y, metrics = moe_lib.moe_mlp(
            x, *(local[k] for k in _MOE_AXES), top_k=inp["top_k"],
            capacity_factor=inp["capacity_factor"],
            sp_group=sharding.axis_group("sp"))
        aux = metrics.aux_loss + 0.001 * metrics.router_z_loss
        loss = (y * g).sum() + inp["aux_weight"] * aux / (
            sharding.share_count(mesh))
        grads = torch.autograd.grad(loss, [x] + list(leaves.values()))
    out["gshard"] = {
        "rows": (lo, hi), "seq": (s0, s1), "y": y.detach().numpy(),
        "aux": float(metrics.aux_loss), "z": float(metrics.router_z_loss),
        "dropped": float(metrics.dropped_fraction),
        "dx": grads[0].numpy(),
        "grads": {k: (bounds[k], gr.numpy())
                  for k, gr in zip(leaves, grads[1:])}}


def _ring_case(inp, mesh, out):
    """Ring attention on this rank's slice (see the module doc)."""
    from dlrover_tpu_torch.ops import ring_attention as ra

    B, S, H, _ = inp["q"].shape
    KH = inp["k"].shape[2]
    rows = _rows(mesh, B)
    sp, tp = (sharding.axis_size(a, mesh) for a in ("sp", "tp"))
    sl = S // sp
    r_sp = mesh.get_local_rank("sp") if sp > 1 else 0
    r_tp = mesh.get_local_rank("tp") if tp > 1 else 0
    seq = (r_sp * sl, (r_sp + 1) * sl)
    heads = (r_tp * H // tp, (r_tp + 1) * H // tp)
    kv_heads = (r_tp * KH // tp, (r_tp + 1) * KH // tp)

    def part(name, hd):
        a = inp[name][rows[0]:rows[1], seq[0]:seq[1], hd[0]:hd[1]]
        return torch.from_numpy(np.ascontiguousarray(a))

    out["slices"] = {"rows": rows, "seq": seq, "heads": heads,
                     "kv_heads": kv_heads}
    g = part("gout", heads)
    res = {}
    for impl in ("xla", "pallas"):
        fn = ra.make_ring_attention(mesh, impl=impl)
        assert fn.saveable_residuals == (impl == "pallas")
        for causal in (True, False):
            q, k, v = (part(n, h).requires_grad_(True) for n, h in (
                ("q", heads), ("k", kv_heads), ("v", kv_heads)))
            o = fn(q, k, v, causal=causal)
            grads = torch.autograd.grad((o * g).sum(), (q, k, v))
            res[(impl, causal)] = [o.detach().numpy()] + [
                t.numpy() for t in grads]
    out["ring"] = res
    # Positions reset within each chunk break the "pallas" path's
    # contiguity: NaN there, exact through "xla".
    packed = torch.arange(S // (2 * sp)).repeat(2 * sp)[seq[0]:seq[1]]
    q, k, v = (part(n, h) for n, h in (
        ("q", heads), ("k", kv_heads), ("v", kv_heads)))
    out["packed"] = {
        impl: ra.make_ring_attention(mesh, impl=impl)(
            q, k, v, causal=True, q_positions=packed,
            kv_positions=packed).numpy()
        for impl in ("pallas", "xla")}
    try:
        ra.make_ring_attention(mesh, impl="flash")
        out["bad_impl"] = ""
    except ValueError as e:
        out["bad_impl"] = str(e)


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
    elif case == "moe":
        _moe_case(inp, mesh, out)
    elif case == "gshard":
        _gshard_case(inp, mesh, out)
    elif case == "ring":
        _ring_case(inp, mesh, out)
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
