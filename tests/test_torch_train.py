"""The port's training path (``loss_fn`` -> ``forward_hidden`` ->
``run_layer_stack``, then the dense or the fused cross-entropy;
``make_train_step``) against the JAX package on ``tiny_config``: JAX
params cross with ``params_from_numpy``, the same numpy tokens go
through both. Where JAX reaches the flash or fused-CE kernels they run
in interpret mode; the port's kernel wrappers run their plain versions
on the CPU.

Tolerances (f32): logits and loss within 2e-5 / rtol 1e-5 (same math,
sums in another order); every param gradient within 1e-5 + 1e-4 * |g|;
the 5-step trajectory's loss and grad_norm within rtol 1e-4; the final
params within 1e-6 on average, all but 0.1% of elements within 2e-5, and
the rest within one step's lr: Adam normalizes each element's update, so
an element whose gradient is rounding noise (~1e-9, where the two sides'
f32 sums cancel differently) still moves by up to lr in a direction that
noise picks.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.ops import fused_ce as jax_fused_ce
from dlrover_tpu.ops.pallas_attention import make_flash_attention as jax_flash
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu.trainer import train_step as jax_ts
from dlrover_tpu_torch.models import convert, llama
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import fused_ce
from dlrover_tpu_torch.trainer import train_step as ts


def _cfg(**kw):
    return llama.tiny_config(n_layers=2, **kw)


def _jax_cfg(**kw):
    return jax_llama.tiny_config(n_layers=2, **kw)


@pytest.fixture(scope="module")
def jax_params():
    params, _ = jax_llama.init_params(_jax_cfg(), jax.random.key(0))
    return jax.device_get(params)


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.int32
    )


def _grads_close(got, want):
    """got: torch tree; want: numpy tree (same leaf names)."""
    flat = jax.tree_util.tree_leaves_with_path(want)
    got_flat = dict(jax.tree_util.tree_leaves_with_path(
        convert.params_to_numpy(got)
    ))
    assert len(flat) == len(got_flat) == 12
    for path, w in flat:
        np.testing.assert_allclose(got_flat[path], np.asarray(w),
                                   rtol=1e-4, atol=1e-5, err_msg=str(path))


def test_forward_with_flash_matches_jax(jax_params):
    toks = _tokens(2, (2, 32))
    want, _ = jax_llama.forward(_jax_cfg(), jax_params, jnp.asarray(toks),
                                attention_fn=jax_flash(True))
    got, aux = llama.forward(_cfg(), convert.params_from_numpy(
        jax_params, "cpu"), torch.from_numpy(toks),
        attention_fn=fa.make_flash_attention())
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)


def test_default_attention_fn_follows_the_device():
    assert llama.default_attention_fn("cpu") is None
    fn = llama.default_attention_fn(torch.device("cuda"))
    assert fn.saveable_residuals and fn.is_plain_flash


@pytest.mark.parametrize("attention", ["plain", "flash"])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_every_grad_match_jax(jax_params, attention, masked):
    toks = _tokens(3, (2, 33))
    mask = (np.random.RandomState(4).rand(2, 32) > 0.3).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks)}
    if masked:
        jbatch["mask"] = jnp.asarray(mask)
        tbatch["mask"] = torch.from_numpy(mask)
    jfn = jax_flash(True) if attention == "flash" else None
    tfn = fa.make_flash_attention() if attention == "flash" else None
    (want_loss, want_m), want_g = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(_jax_cfg(), p, jbatch, jfn),
        has_aux=True,
    )(jax_params)
    params = convert.params_from_numpy(jax_params, "cpu")
    leaves = ts.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = llama.loss_fn(_cfg(), params, tbatch, tfn)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()),
                               float(want_m["ce"]),
                               rtol=1e-5)
    _grads_close(_tree_like(params, grads), want_g)


def _tree_like(params, leaves):
    it = iter(leaves)

    def rebuild(tree):
        return {k: (rebuild(tree[k]) if isinstance(tree[k], dict)
                    else next(it)) for k in sorted(tree)}

    return rebuild(params)


def _port_grads(cfg, params, batch, attention_fn):
    leaves = ts.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    fa.reset_launch_counts()
    loss, _ = llama.loss_fn(cfg, params, batch, attention_fn)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("attention", ["plain", "flash"])
def test_remat_policies_give_the_same_grads(jax_params, attention):
    batch = {"tokens": torch.from_numpy(_tokens(5, (2, 33)))}
    fn = fa.make_flash_attention() if attention == "flash" else None
    params = convert.params_from_numpy(jax_params, "cpu")
    ref_loss, ref = _port_grads(_cfg(remat=False), params, batch, fn)
    for policy in ("mlp_only", "dots", "full", "attn_save"):
        loss, got = _port_grads(_cfg(remat_policy=policy), params, batch, fn)
        assert loss == ref_loss
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-7)


def test_mlp_only_keeps_flash_outside_checkpointing(jax_params):
    """Under mlp_only the flash forward runs once per layer (its saved
    residuals are kept), under dots twice (recomputed in the backward):
    counted through the plain op's calls on the CPU."""
    calls = []
    real = fa.flash_attention_reference

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    batch = {"tokens": torch.from_numpy(_tokens(6, (2, 17)))}
    fa.flash_attention_reference = counting
    try:
        for policy, want in (("mlp_only", 2), ("dots", 4)):
            calls.clear()
            params = convert.params_from_numpy(jax_params, "cpu")
            _port_grads(_cfg(remat_policy=policy), params, batch,
                        fa.make_flash_attention())
            assert len(calls) == want, policy
    finally:
        fa.flash_attention_reference = real


class _CountProducts(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_dots_policy_saves_only_products_without_batch_dims(jax_params,
                                                            policy):
    """As the reference's dots_with_no_batch_dims_saveable: under "dots"
    the backward recomputes no projection (2-D ``mm``) but does recompute
    plain attention's batched ``bmm`` products; "full" recomputes both.
    Counted against the backward of the same loss without remat."""
    batch = {"tokens": torch.from_numpy(_tokens(8, (2, 17)))}
    backward = {}
    for label, cfg in (("none", _cfg(remat=False)),
                       (policy, _cfg(remat_policy=policy))):
        params = convert.params_from_numpy(jax_params, "cpu")
        leaves = ts.param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = llama.loss_fn(cfg, params, batch)
        with _CountProducts() as mode:
            torch.autograd.grad(loss, leaves)
        backward[label] = mode.counts
    n_layers = _cfg().n_layers
    # Two batched products per layer's attention (QK^T, PV) run again.
    assert backward[policy]["bmm"] == backward["none"]["bmm"] + 2 * n_layers
    if policy == "dots":
        assert backward[policy]["mm"] == backward["none"]["mm"]
    else:
        # q, k, v, out, gate and up run again; the recompute stops before
        # down, whose output no backward needs.
        assert (backward[policy]["mm"]
                == backward["none"]["mm"] + 6 * n_layers)


def test_cross_entropy_matches_jax():
    rs = np.random.RandomState(7)
    logits = (rs.randn(2, 5, 11) * 3).astype(np.float32)
    targets = rs.randint(0, 11, (2, 5)).astype(np.int32)
    mask = (rs.rand(2, 5) > 0.5).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jax_llama.cross_entropy(
            jnp.asarray(logits), jnp.asarray(targets),
            None if m is None else jnp.asarray(m),
        )
        got = llama.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if m is None else torch.from_numpy(m),
        )
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("env", [None, "on", "off", "bogus"])
@pytest.mark.parametrize("n_tokens,vocab", [
    (16384, 32000),        # the flagship micro-batch: dense
    (16384 * 2, 32000),    # above the crossover: fused
    (8, 256),
    (2 ** 24, 32),         # exactly at the crossover
])
def test_resolve_ce_path_matches_jax(monkeypatch, env, n_tokens, vocab):
    if env is None:
        monkeypatch.delenv("DLROVER_TPU_FUSED_CE", raising=False)
    else:
        monkeypatch.setenv("DLROVER_TPU_FUSED_CE", env)
    for pp in (1, 2):
        want = jax_llama.resolve_ce_path(
            jax_llama.TpuLMConfig(vocab_size=vocab, pp_stages=pp,
                                  n_layers=2), n_tokens)
        got = llama.resolve_ce_path(
            llama.TpuLMConfig(vocab_size=vocab, pp_stages=pp, n_layers=2),
            n_tokens)
        assert got == want


def test_fused_ce_branch_raises_until_ported(monkeypatch, jax_params):
    """The fused branch is ported: with DLROVER_TPU_FUSED_CE=on it runs
    (it raised until the fused CE landed) and gives the dense loss
    within rtol 1e-5 (f32 logits on both routes)."""
    batch = {"tokens": torch.from_numpy(_tokens(0, (1, 9)))}
    params = convert.params_from_numpy(jax_params, "cpu")
    monkeypatch.setenv("DLROVER_TPU_FUSED_CE", "on")
    fused, fused_m = llama.loss_fn(_cfg(), params, batch)
    monkeypatch.setenv("DLROVER_TPU_FUSED_CE", "off")
    dense, dense_m = llama.loss_fn(_cfg(), params, batch)
    np.testing.assert_allclose(float(fused), float(dense), rtol=1e-5)
    np.testing.assert_allclose(float(fused_m["ce"]), float(dense_m["ce"]),
                               rtol=1e-5)


@pytest.mark.parametrize("mode", ["on", "auto_above_crossover"])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_loss_and_every_grad_match_jax(monkeypatch, jax_params, mode,
                                             masked):
    """loss_fn through the fused branch (the chunked route) against JAX's
    loss_fn through its fused branch: loss, ce and all 12 gradients. In
    "auto" the tiny batch crosses a crossover lowered to 1 on both
    sides."""
    if mode == "on":
        monkeypatch.setenv("DLROVER_TPU_FUSED_CE", "on")
    else:
        monkeypatch.setenv("DLROVER_TPU_FUSED_CE", "auto")
        monkeypatch.setattr(fused_ce, "AUTO_FUSED_MIN_NV", 1)
        monkeypatch.setattr(jax_fused_ce, "AUTO_FUSED_MIN_NV", 1)
    assert llama.resolve_ce_path(_cfg(), 64) == "fused"
    toks = _tokens(11, (2, 33))
    mask = (np.random.RandomState(12).rand(2, 32) > 0.3).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks)}
    if masked:
        jbatch["mask"] = jnp.asarray(mask)
        tbatch["mask"] = torch.from_numpy(mask)
    (want_loss, want_m), want_g = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(_jax_cfg(), p, jbatch), has_aux=True,
    )(jax_params)
    params = convert.params_from_numpy(jax_params, "cpu")
    leaves = ts.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = llama.loss_fn(_cfg(), params, tbatch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()),
                               float(want_m["ce"]), rtol=1e-5)
    _grads_close(_tree_like(params, grads), want_g)


def _jax_pallas_loss(cfg):
    """loss_fn for JAX's make_train_step: forward_hidden -> final_hidden
    -> fused_cross_entropy(impl="pallas") (kernels B3/B4, interpret mode
    on the CPU)."""
    def loss(params, batch):
        tokens, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
        x, aux = jax_llama.forward_hidden(cfg, params, tokens)
        ce = jax_fused_ce.fused_cross_entropy(
            jax_llama.final_hidden(cfg, params, x),
            params["lm_head"].astype(cfg.compute_dtype), targets,
            impl="pallas")
        return ce + cfg.moe_aux_weight * aux, {"ce": ce, "aux": aux}

    return loss


def _port_pallas_loss(cfg):
    """The same loss_fn in the port (the kernel wrappers run their plain
    versions on the CPU)."""
    def loss(params, batch):
        tokens, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
        x, aux = llama.forward_hidden(cfg, params, tokens)
        ce = fused_ce.fused_cross_entropy(
            llama.final_hidden(cfg, params, x),
            params["lm_head"].to(cfg.compute_dtype), targets, impl="pallas")
        return ce + cfg.moe_aux_weight * aux, {"ce": ce, "aux": aux}

    return loss


def test_train_trajectory_through_fused_ce_kernels_matches_jax():
    """Three make_train_step steps whose loss_fn reaches the fused CE's
    kernel route (impl="pallas") on both sides: loss and grad_norm
    within rtol 1e-4 each step, final params as in
    test_train_trajectory_matches_jax."""
    jcfg = jax_llama.tiny_config(n_layers=2)
    jtc = jax_ts.TrainConfig(learning_rate=5e-3, warmup_steps=2)
    mesh = build_mesh(MeshConfig(dp=1), jax.devices()[:1])
    jopt = jax_ts.make_optimizer(jtc)
    jstate, _ = jax_ts.init_train_state(jcfg, jopt, mesh, jax.random.key(0))
    params = convert.params_from_numpy(jax.device_get(jstate["params"]),
                                       "cpu")
    jstep, _ = jax_ts.make_train_step(jcfg, jtc, jopt, mesh,
                                      loss_fn=_jax_pallas_loss(jcfg))

    cfg = llama.TpuLMConfig(**dataclasses.asdict(jcfg))
    tc = ts.TrainConfig(**dataclasses.asdict(jtc))
    opt = ts.make_optimizer(tc)
    state = ts.init_train_state(cfg, opt, params)
    step = ts.make_train_step(cfg, tc, opt, device="cpu",
                              loss_fn=_port_pallas_loss(cfg))
    toks = _tokens(13, (2, 17))
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": toks})
        losses.append(float(m["loss"]))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert losses[-1] < losses[0]
    want = jax.tree_util.tree_leaves_with_path(
        jax.device_get(jstate["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.params_to_numpy(state["params"])))
    for path, w in want:
        diff = np.abs(got[path] - w)
        assert diff.mean() <= 1e-6, (path, diff.mean())
        assert diff.max() <= tc.learning_rate, (path, diff.max())


@pytest.mark.parametrize("lr,warmup", [(5e-3, 2), (3e-4, 100), (1e-3, 0)])
def test_schedule_matches_optax(lr, warmup):
    tc = ts.TrainConfig(learning_rate=lr, warmup_steps=warmup)
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=max(warmup, 1),
        decay_steps=100_000, end_value=lr * 0.1,
    )
    sched = ts.warmup_cosine_schedule(tc)
    assert sched(0) == 0.0
    counts = list(range(301)) + [50_000, 99_999, 100_000, 200_000]
    # optax evaluates in f32: a few ulps of relative error.
    np.testing.assert_allclose([sched(c) for c in counts],
                               [float(want(c)) for c in counts],
                               rtol=5e-6, atol=1e-12)


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0])
def test_clip_matches_optax(scale):
    rs = np.random.RandomState(8)
    tree = {"a": (rs.randn(3, 4) * scale).astype(np.float32),
            "b": (rs.randn(5) * scale).astype(np.float32)}
    want, _ = optax.clip_by_global_norm(1.0).update(
        jax.tree_util.tree_map(jnp.asarray, tree), None)
    grads = [torch.from_numpy(tree[k].copy()) for k in ("a", "b")]
    norm = ts.global_norm(grads)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(want))
                               if scale < 0.1 else float(
                                   optax.global_norm(tree)), rtol=1e-6)
    ts.clip_by_global_norm_(grads, 1.0, norm)
    for g, k in zip(grads, ("a", "b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_trajectory_matches_jax(grad_accum):
    """The slice as a whole: 5 steps of make_train_step on both sides
    from the same params and batch."""
    jcfg = jax_llama.tiny_config()
    jtc = jax_ts.TrainConfig(learning_rate=5e-3, warmup_steps=2,
                             grad_accum=grad_accum)
    mesh = build_mesh(MeshConfig(dp=1), jax.devices()[:1])
    jopt = jax_ts.make_optimizer(jtc)
    jstate, _ = jax_ts.init_train_state(jcfg, jopt, mesh, jax.random.key(0))
    params = convert.params_from_numpy(jax.device_get(jstate["params"]),
                                       "cpu")
    jstep, _ = jax_ts.make_train_step(jcfg, jtc, jopt, mesh)

    cfg = llama.TpuLMConfig(**dataclasses.asdict(jcfg))
    tc = ts.TrainConfig(**dataclasses.asdict(jtc))
    opt = ts.make_optimizer(tc)
    state = ts.init_train_state(cfg, opt, params)
    step = ts.make_train_step(cfg, tc, opt, device="cpu")

    toks = _tokens(9, (4, 17))
    for i in range(5):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": toks})
        assert m["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    want = jax.tree_util.tree_leaves_with_path(
        jax.device_get(jstate["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.params_to_numpy(state["params"])))
    for path, w in want:
        diff = np.abs(got[path] - w)
        assert diff.mean() <= 1e-6, (path, diff.mean())
        assert np.mean(diff > 2e-5) <= 1e-3, (path, np.mean(diff > 2e-5))
        assert diff.max() <= tc.learning_rate, (path, diff.max())


def test_first_update_moves_nothing():
    """Count 0 of the schedule gives lr 0: after one step the params are
    unchanged (weight decay is scaled by lr too)."""
    cfg = _cfg()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    before = [p.clone() for p in ts.param_leaves(params)]
    tc = ts.TrainConfig(learning_rate=1e-2, warmup_steps=3)
    opt = ts.make_optimizer(tc)
    state = ts.init_train_state(cfg, opt, params)
    state, m = ts.make_train_step(cfg, tc, opt, device="cpu")(
        state, {"tokens": _tokens(1, (2, 9))})
    assert state["step"] == 1 and float(m["grad_norm"]) > 0
    for p, b in zip(ts.param_leaves(state["params"]), before):
        torch.testing.assert_close(p.detach(), b, rtol=0, atol=0)


def test_bf16_steps_stay_finite():
    cfg = llama.tiny_config(dtype="bfloat16")
    params = llama.init_params(cfg, torch.Generator().manual_seed(1),
                               device="cpu")
    tc = ts.TrainConfig(learning_rate=1e-3, warmup_steps=1, grad_accum=2)
    opt = ts.make_optimizer(tc)
    state = ts.init_train_state(cfg, opt, params)
    step = ts.make_train_step(cfg, tc, opt, device="cpu")
    toks = _tokens(2, (4, 17))
    for _ in range(3):
        state, m = step(state, {"tokens": toks})
        assert np.isfinite(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    assert all(torch.isfinite(p).all() for p in ts.param_leaves(
        state["params"]))
    assert all(p.dtype == torch.float32 for p in ts.param_leaves(
        state["params"]))


@pytest.mark.parametrize("ce_mode", ["off", "on"])
def test_eval_step_matches_jax(monkeypatch, jax_params, ce_mode):
    """The eval step on both sides, dense or through the fused branch.
    Fused, the port runs under no_grad, so the chunked route computes the
    loss alone (its gradient sweep would raise here)."""
    monkeypatch.setenv("DLROVER_TPU_FUSED_CE", ce_mode)
    toks = _tokens(10, (2, 17))
    mesh = build_mesh(MeshConfig(dp=1), jax.devices()[:1])
    want = jax_ts.make_eval_step(_jax_cfg(), mesh)(
        jax_params, {"tokens": jnp.asarray(toks)})

    def no_sweep(*a, **k):
        raise AssertionError("the gradient sweep ran in the eval step")

    monkeypatch.setattr(fused_ce, "_chunked_fwd_pass", no_sweep)
    got = ts.make_eval_step(_cfg(), device="cpu")(
        convert.params_from_numpy(jax_params, "cpu"), {"tokens": toks})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_init_train_state_rejects_bf16_master_params():
    cfg = _cfg()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    params["embed"] = params["embed"].bfloat16()
    with pytest.raises(TypeError, match="f32"):
        ts.init_train_state(cfg, ts.make_optimizer(ts.TrainConfig()), params)
