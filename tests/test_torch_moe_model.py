"""The MoE TpuLM, port against the JAX package, on ``tiny_config`` with 4
experts, top-2, dropless and gshard: JAX params cross with
``convert.params_from_numpy`` and the same numpy tokens go through both.
JAX's dropless path runs its Pallas grouped-FFN kernel in interpret
mode; the port's runs the plain versions of B7/B8 on the CPU.

Tolerances (f32), as ``test_torch_train.py``: logits and loss within
2e-5 / rtol 1e-5 (the same math, sums in another order); every param
gradient within 1e-5 + 1e-4 * |g|; the 5-step trajectory's loss and
grad_norm within rtol 1e-4 and the final params within 1e-6 on average,
all but 0.1% of elements within 2e-5 and the rest within one step's lr
(Adam moves an element whose gradient is rounding noise by up to lr).
Greedy tokens, from ``generate()`` and from the flat serving engines,
must be equal: dropless routing is per token, and at these widths no
router near-tie sits inside f32 rounding. The paged engine (dropless)
gives the JAX paged engine's tokens and block accounting with an fp
pool, and with an int8 pool tokens within the 0.2 logit distance
``tests/test_torch_kvpool.py`` pins; spec on gives spec off's tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlrover_tpu.models import generate as jax_gen
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu.serving.engine import ServingEngine as JaxServingEngine
from dlrover_tpu.serving.kvpool import (
    PagedServingEngine as JaxPagedServingEngine,
)
from dlrover_tpu.trainer import train_step as jax_ts
from dlrover_tpu_torch.models import convert, generate, llama
from dlrover_tpu_torch.serving import PagedServingEngine, ServingEngine
from dlrover_tpu_torch.trainer import train_step as ts

_IMPLS = ("dropless", "gshard")


def _kw(impl):
    return dict(n_layers=2, n_experts=4, moe_top_k=2, moe_impl=impl)


@pytest.fixture(scope="module", params=_IMPLS)
def moe(request):
    """(impl, jax config, jax params as numpy, port config, port params)."""
    jcfg = jax_llama.tiny_config(**_kw(request.param))
    jparams, _ = jax_llama.init_params(jcfg, jax.random.key(0))
    jparams = jax.device_get(jparams)
    cfg = llama.TpuLMConfig(**dataclasses.asdict(jcfg))
    return (request.param, jcfg, jparams, cfg,
            convert.params_from_numpy(jparams, "cpu"))


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.int32)


def test_config_counts_and_init_layout_match_jax(moe):
    impl, jcfg, jparams, cfg, _ = moe
    assert cfg.count_params() == jcfg.count_params()
    assert cfg.count_active_params() == jcfg.count_active_params()
    assert cfg.count_active_params() < cfg.count_params()
    assert llama._moe_resolve_impl(cfg) == impl
    own = llama.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    for name, ref in jparams["layers"].items():
        assert tuple(own["layers"][name].shape) == ref.shape, name
        assert own["layers"][name].dtype == torch.float32
    assert set(own["layers"]) == set(jparams["layers"])


def test_moe_leaves_cross_both_ways_bit_for_bit(moe):
    _, _, jparams, _, params = moe
    back = convert.params_to_numpy(params)
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(back["layers"][name],
                                      jparams["layers"][name])


def test_logits_loss_and_every_grad_match_jax(moe):
    _, jcfg, jparams, cfg, params = moe
    toks = _tokens(3, (2, 17))
    want_logits, want_aux = jax_llama.forward(jcfg, jparams,
                                              jnp.asarray(toks[:, :-1]))
    (want_loss, _), want_grads = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jparams)

    with torch.no_grad():
        logits, aux = llama.forward(cfg, params,
                                    torch.from_numpy(toks[:, :-1]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert float(aux) > 0
    leaves = ts.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = llama.loss_fn(cfg, params, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5, atol=2e-5)
    want = {".".join(k.key for k in path): np.asarray(w) for path, w in
            jax.tree_util.tree_leaves_with_path(jax.device_get(want_grads))}
    assert len(want) == len(grads) == 13
    for name, g in zip(_leaf_names(params), grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def _leaf_names(tree, prefix=""):
    """Dotted names of ``train_step.param_leaves(tree)``, in its order."""
    names = []
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            names += _leaf_names(tree[key], f"{prefix}{key}.")
        else:
            names.append(prefix + key)
    return names


def test_train_trajectory_matches_jax(moe):
    """5 steps of make_train_step on both sides from the same params and
    batch (grad_accum 2)."""
    _, jcfg, jparams, cfg, _ = moe
    jtc = jax_ts.TrainConfig(learning_rate=5e-3, warmup_steps=2,
                             grad_accum=2)
    mesh = build_mesh(MeshConfig(dp=1), jax.devices()[:1])
    jopt = jax_ts.make_optimizer(jtc)
    jstate, _ = jax_ts.init_train_state(jcfg, jopt, mesh, jax.random.key(0))
    params = convert.params_from_numpy(jax.device_get(jstate["params"]),
                                       "cpu")
    jstep, _ = jax_ts.make_train_step(jcfg, jtc, jopt, mesh)
    tc = ts.TrainConfig(**dataclasses.asdict(jtc))
    opt = ts.make_optimizer(tc)
    state = ts.init_train_state(cfg, opt, params)
    step = ts.make_train_step(cfg, tc, opt, device="cpu")

    toks = _tokens(9, (4, 17))
    losses = []
    for i in range(5):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": toks})
        assert m["step"] == int(jm["step"]) == i + 1
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
        assert np.mean(diff > 2e-5) <= 1e-3, (path, np.mean(diff > 2e-5))
        assert diff.max() <= tc.learning_rate, (path, diff.max())


def test_greedy_generate_tokens_match_jax(moe):
    _, jcfg, jparams, cfg, params = moe
    prompt = _tokens(4, (2, 6))
    want = jax_gen.generate(jcfg, jparams, jnp.asarray(prompt),
                            max_new_tokens=6).tokens
    got = generate.generate(cfg, params, prompt, 6, device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want))


def test_flat_engine_tokens_match_jax_engine(moe):
    _, jcfg, jparams, cfg, params = moe
    kw = dict(slots=2, max_len=32, prefill_chunk=8)
    jeng = JaxServingEngine(jcfg, jparams, **kw)
    eng = ServingEngine(cfg, params, device="cpu", **kw)
    rs = np.random.RandomState(5)
    work = [(rs.randint(0, 256, n).astype(np.int32), int(k))
            for n, k in ((5, 4), (11, 3), (3, 5))]
    want = [jeng.submit(p, k) for p, k in work]
    got = [eng.submit(p, k) for p, k in work]
    jeng.run_until_idle()
    eng.run_until_idle()
    for g, w in zip(got, want):
        assert g.state == "done" and len(g.tokens) == len(w.tokens)
        assert g.tokens == w.tokens


@pytest.fixture(scope="module")
def dropless():
    """The dropless config alone (gshard's capacity depends on the batch,
    so a [slots, K + 1] verify step may drop other tokens than a
    [slots, 1] decode step: spec-on and spec-off differ by design)."""
    jcfg = jax_llama.tiny_config(**_kw("dropless"))
    jparams, _ = jax_llama.init_params(jcfg, jax.random.key(0))
    jparams = jax.device_get(jparams)
    cfg = llama.TpuLMConfig(**dataclasses.asdict(jcfg))
    return jcfg, jparams, cfg, convert.params_from_numpy(jparams, "cpu")


def _paged_work():
    """Prompts that miss, hit a shared 16-token prefix (two blocks of 8)
    and repeat in full, over two slots."""
    rs = np.random.RandomState(8)
    head = rs.randint(0, 256, 16)
    tails = [rs.randint(0, 256, n) for n in (5, 9, 7)]
    prompts = [np.concatenate([head, tails[0]]), tails[1],
               np.concatenate([head, tails[2]]), head]
    return [p.astype(np.int32) for p in prompts], (6, 5, 7, 4)


_PAGED_KW = dict(slots=2, max_len=48, prefill_chunk=4, block_size=8)
_STAT_KEYS = ("total", "free", "used", "cached", "cow_copies",
              "prefix_hits", "prefix_misses", "prefix_hit_blocks")


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_paged_engine_matches_jax_paged_engine(dropless, kv):
    """MoE through the paged engine: the port against the JAX
    PagedServingEngine on the same prompts, all submitted at once. fp:
    equal tokens; int8: every token either engine chose lies within
    0.2 of the teacher-forced f32 max (the port reads a new row
    quantized, the reference at full precision; the bound
    ``tests/test_torch_kvpool.py`` pins). The block accounting, which
    sees no values, is equal."""
    jcfg, jparams, cfg, params = dropless
    kw = dict(_PAGED_KW, kv_cache_dtype=kv)
    jeng = JaxPagedServingEngine(jcfg, jparams, **kw)
    eng = PagedServingEngine(cfg, params, device="cpu", **kw)
    prompts, news = _paged_work()
    want = [jeng.submit(p, n) for p, n in zip(prompts, news)]
    got = [eng.submit(p, n) for p, n in zip(prompts, news)]
    jeng.run_until_idle()
    eng.run_until_idle()
    for g, w in zip(got, want):
        assert len(g.tokens) == len(w.tokens) == g.max_new_tokens
        assert g.prefix_hit_blocks == w.prefix_hit_blocks
        if kv == "fp":
            assert g.tokens == w.tokens
            continue
        for r in (g, w):
            seq = torch.from_numpy(np.concatenate(
                [r.prompt, np.asarray(r.tokens, np.int32)]).astype(np.int64))
            with torch.no_grad():
                logits, _ = llama.forward(cfg, params, seq[None])
            pred = logits[0, r.prompt_len - 1:-1]
            chosen = pred[torch.arange(len(r.tokens)), r.tokens]
            assert float((pred.max(-1).values - chosen).max()) <= 0.2
    stats, jstats = eng.kv_stats(), jeng.kv_stats()
    assert {k: stats[k] for k in _STAT_KEYS} == {
        k: jstats[k] for k in _STAT_KEYS}
    assert stats["prefix_hits"] >= 1
    eng.check_block_invariants()


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_paged_spec_on_equals_spec_off(dropless, kv):
    """Speculative decoding over the MoE paged engine (the n-gram drafter
    and a one-layer early exit): the spec-off tokens, drafts proposed,
    block invariants held."""
    _, _, cfg, params = dropless
    prompts, news = _paged_work()

    def run(**spec):
        eng = PagedServingEngine(cfg, params, device="cpu",
                                 kv_cache_dtype=kv, **_PAGED_KW, **spec)
        eng.warmup()
        reqs = [eng.submit(p, n) for p, n in zip(prompts, news)]
        eng.run_until_idle()
        eng.check_block_invariants()
        return [r.tokens for r in reqs], sum(r.spec_drafted for r in reqs)

    off, _ = run()
    for spec in (dict(spec_k=3),
                 dict(spec_k=3, spec_drafter="early_exit",
                      spec_draft_layers=1)):
        tokens, drafted = run(**spec)
        assert tokens == off, spec
        assert drafted > 0, spec


def _flip_share(gen_ids, fwd_ids, n_layers, b, prompt_len, new):
    """Share of (layer, row, position) whose top-k expert set differs
    between the cached decode path (``gen_ids``: per layer the prefill's
    [b * prompt_len, k] ids, then per layer one [b, k] call a
    single-token step) and the teacher-forced forward over prompt +
    output (``fwd_ids``: per layer [b * s, k]). The last token is never
    fed to the decode path."""
    n_pos = prompt_len + new - 1
    k = gen_ids[0].shape[-1]
    flips = 0
    for layer in range(n_layers):
        steps = [gen_ids[n_layers * (j + 1) + layer].reshape(b, 1, k)
                 for j in range(new - 1)]
        cached = np.concatenate(
            [gen_ids[layer].reshape(b, prompt_len, k)] + steps, axis=1)
        free = fwd_ids[layer].reshape(b, -1, k)[:, :n_pos]
        flips += int(np.any(np.sort(cached, -1) != np.sort(free, -1),
                            axis=-1).sum())
    return flips / (n_layers * b * n_pos)


def test_routing_flips_match_jax(monkeypatch):
    """The cached decode path and the teacher-forced forward round bf16
    at other places, so a router near-tie may pick another top-2 set at
    a (layer, position): a routing flip, which then changes that token's
    K/V for every later layer and position. On the same numpy weights and
    prompts, in bf16, the port flips no more than twice as often as the
    JAX package (or neither flips): the flips belong to the model's
    arithmetic, not to a fault of the port's decode path."""
    from dlrover_tpu_torch.models import moe as pt_moe

    L, b, prompt_len, new = 2, 8, 16, 16
    jcfg = jax_llama.tiny_config(n_layers=L, n_experts=4, moe_top_k=2,
                                 moe_impl="dropless", dtype="bfloat16")
    jparams, _ = jax_llama.init_params(jcfg, jax.random.key(3))
    jparams = jax.device_get(jparams)
    cfg = llama.TpuLMConfig(**dataclasses.asdict(jcfg))
    params = convert.params_from_numpy(jparams, "cpu")
    prompt = _tokens(9, (b, prompt_len))

    store = []
    top_k = jax.lax.top_k

    def recorded(x, k):
        values, ids = top_k(x, k)
        jax.debug.callback(lambda a: store.append(np.asarray(a)), ids,
                           ordered=True)
        return values, ids

    monkeypatch.setattr(jax.lax, "top_k", recorded)
    jax.clear_caches()
    jtoks = np.asarray(jax_gen.generate(jcfg, jparams, jnp.asarray(prompt),
                                        max_new_tokens=new).tokens)
    jax.effects_barrier()
    j_gen, store[:] = list(store), []
    jax_llama.forward(jcfg, jparams,
                      jnp.asarray(np.concatenate([prompt, jtoks], 1)))
    jax.effects_barrier()
    j_fwd, store[:] = list(store), []
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    jax.clear_caches()

    orig = pt_moe._top_k

    def recorded_pt(probs, k):
        values, ids = orig(probs, k)
        store.append(ids.numpy())
        return values, ids

    monkeypatch.setattr(pt_moe, "_top_k", recorded_pt)
    toks = generate.generate(cfg, params, prompt, new, device="cpu").tokens
    p_gen, store[:] = list(store), []
    llama.forward(cfg, params, torch.cat([torch.from_numpy(prompt).long(),
                                          toks.long()], 1))
    p_fwd = list(store)

    for ids in (j_gen, p_gen):
        assert len(ids) >= L * new and ids[0].shape == (b * prompt_len, 2)
    jax_share = _flip_share(j_gen, j_fwd, L, b, prompt_len, new)
    port_share = _flip_share(p_gen, p_fwd, L, b, prompt_len, new)
    assert port_share <= 2 * jax_share, (port_share, jax_share)
    # The measure sees a flip: the first decode step routed elsewhere at
    # layer 0 flips every row there.
    planted = list(p_gen)
    planted[L] = (planted[L] + 1) % 4
    assert _flip_share(planted, p_fwd, L, b, prompt_len, new) >= \
        port_share + 1 / (L * (prompt_len + new - 1))
