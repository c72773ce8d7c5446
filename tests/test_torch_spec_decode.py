"""The port's speculative decoding (counterpart of
``tests/test_spec_decode.py``) on ``tiny_config`` (f32), ``device="cpu"``,
held against the JAX package on the same numpy inputs and parameters
(crossed with ``convert.params_from_numpy``):

- ``spec_verify_attention`` against JAX's, fp and int8, ragged fills,
  T = 1 and T = 4, within 1e-5 (f32, the same sums in another order);
  T = 1 against the port's one-token decode (append, then the plain
  decode attention);
- ``spec_accept``: greedy rows give JAX's ``emitted`` and
  ``accept_len`` exactly; sampled rows follow the rejection-sampling law
  (they draw from a ``torch.Generator``, so JAX's bits are not theirs);
- ``sample_token_logprobs``, ``propose_ngram``, ``clamp_draft_len``;
- both engines: greedy spec-on tokens equal spec-off tokens, the
  teacher-forced loop and the JAX spec engines' (fp); int8 paged tokens
  lie within the 0.2 logit distance pinned for int8 decode steps
  (``tests/test_torch_kvpool.py``), because the port reads a new row
  quantized where the reference keeps it at full precision;
- block invariants under random accept lengths, the scheduler's budget,
  the per-token latency accounting, the drop rule near ``max_len``.

The n-gram drafter only proposes where the history repeats, and greedy
verification only accepts what the model itself would say. The engine
tests therefore build their prompts from the model's own greedy output,
``p + greedy(p) + p``: after the second ``p`` the drafter proposes the
continuation ``greedy(p)`` took, and where the model repeats it the
drafts are accepted. This makes the draft-and-accept path run (a random
prompt drafts nothing and would pass vacuously); it chooses no data
around a defect, and the engine tests assert that drafts were proposed.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.models import generate as jax_gen
from dlrover_tpu.ops import decode_attention as jax_da
from dlrover_tpu.serving import spec_decode as jax_spec
from dlrover_tpu.serving.engine import ServingEngine as JaxServingEngine
from dlrover_tpu.serving.kvpool import (
    PagedServingEngine as JaxPagedServingEngine,
)
from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models import generate as gen
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.observability.registry import MetricsRegistry
from dlrover_tpu_torch.ops import decode_attention as da
from dlrover_tpu_torch.ops.kv_quant import quantize_kv
from dlrover_tpu_torch.serving import (
    DECODE,
    SENTINEL_BLOCK,
    PagedServingEngine,
    Scheduler,
    ServingEngine,
)
from dlrover_tpu_torch.serving import spec_decode as spec_lib

# The decode-step logit distance pinned between the int8 and the fp
# cache on this config (tests/test_torch_kvpool.py).
INT8_LOGIT_BOUND = 0.2


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_llama.tiny_config()
    jparams, _ = jax_llama.init_params(jcfg, jax.random.key(0))
    params = convert.params_from_numpy(jax.device_get(jparams), "cpu")
    return llama.tiny_config(), params, jcfg, jparams


def naive_greedy(cfg, params, prompt, max_new):
    """Teacher-forced reference: re-forward the growing sequence."""
    seq = torch.from_numpy(np.asarray(prompt, np.int64))[None, :]
    out = []
    for _ in range(max_new):
        logits, _ = llama.forward(cfg, params, seq)
        nxt = logits[:, -1, :].argmax(dim=-1)
        out.append(int(nxt[0]))
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    return out


def repeat_prompts(cfg, params, lens, seed, cont=10):
    """``p + greedy(p)[:cont] + p`` for random prompts p of ``lens``."""
    rs = np.random.RandomState(seed)
    out = []
    for n in lens:
        p = rs.randint(0, cfg.vocab_size, size=n).astype(np.int32)
        g = np.asarray(naive_greedy(cfg, params, p, cont), np.int32)
        out.append(np.concatenate([p, g, p]))
    return out


def flat(cfg, params, **kw):
    kw.setdefault("registry", MetricsRegistry())
    return ServingEngine(cfg, params, device="cpu", **kw)


def paged(cfg, params, **kw):
    kw.setdefault("registry", MetricsRegistry())
    return PagedServingEngine(cfg, params, device="cpu", **kw)


def run_staggered(eng, prompts, news, lead=4):
    """The first request alone for ``lead`` steps (its fill runs ahead),
    then the rest at once."""
    reqs = [eng.submit(prompts[0], news[0])]
    for _ in range(lead):
        eng.step()
    reqs += [eng.submit(p, n) for p, n in zip(prompts[1:], news[1:])]
    eng.run_until_idle()
    return reqs


def teacher_forced_gap(cfg, params, req):
    """Largest gap between the teacher-forced f32 max logit and the
    logit of the token the engine chose, over a request's tokens."""
    seq = torch.from_numpy(np.concatenate(
        [req.prompt, np.asarray(req.tokens, np.int32)]).astype(np.int64))
    logits, _ = llama.forward(cfg, params, seq[None])
    pred = logits[0, req.prompt_len - 1:-1]
    chosen = pred[torch.arange(len(req.tokens)), req.tokens]
    return float((pred.max(dim=-1).values - chosen).max())


# ---- spec_verify_attention -----------------------------------------------


def _verify_inputs(T, seed=5):
    b, S, h, kh, d = 3, 16, 4, 2, 8
    rs = np.random.RandomState(seed)
    arrays = dict(
        q=rs.randn(b, T, h, d), k_cache=rs.randn(b, S, kh, d),
        v_cache=rs.randn(b, S, kh, d), k_new=rs.randn(b, T, kh, d),
        v_new=rs.randn(b, T, kh, d),
    )
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    lens = np.array([0, 5, 16], np.int32)   # empty, ragged, full
    return arrays, lens


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_spec_verify_attention_matches_jax(kv, T):
    """The three key groups (masked cache, u < t drafts, self) against
    the JAX function, fp and int8 arguments (int8 cache with scales,
    quantized intra-draft rows), within 1e-5."""
    a, lens = _verify_inputs(T)
    args = dict(a, cache_len=lens)
    if kv == "int8":
        for name in ("k_cache", "v_cache"):
            q8, sc = quantize_kv(torch.from_numpy(a[name]))
            args[name] = q8.numpy()
            args[name[0] + "_scale"] = sc.numpy()
        for name in ("k_new", "v_new"):
            q8, sc = quantize_kv(torch.from_numpy(a[name]))
            args[name + "_q"] = q8.numpy()
            args[name + "_scale"] = sc.numpy()
    want = jax_da.spec_verify_attention(
        **{k: jnp.asarray(v) for k, v in args.items()})
    got = da.spec_verify_attention(
        **{k: torch.from_numpy(np.asarray(v)) for k, v in args.items()})
    assert got.shape == (3, T, 4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_spec_verify_attention_T1_matches_one_token_decode(kv):
    """T = 1 (no drafts) is the port's one-token decode step: append the
    new row, then the plain decode attention over fill + 1 rows. For
    int8 the verify layer passes the new row quantized as its self key
    (the port's convention, ``gen._layer_verify``)."""
    a, lens = _verify_inputs(1)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    b = t["q"].shape[0]
    rows = torch.arange(b)
    write = torch.from_numpy(np.minimum(lens, 15)).long()
    k_c, v_c = t["k_cache"].clone(), t["v_cache"].clone()
    # The full row (fill 16) has no room: its one-token step would
    # write at row 15, so compare it over a cache with that row free.
    fill = np.minimum(lens + 1, 16)
    vis = torch.from_numpy(np.minimum(lens, 15))
    if kv == "fp":
        k_c[rows, write] = t["k_new"][:, 0]
        v_c[rows, write] = t["v_new"][:, 0]
        want = da.decode_attention_reference(t["q"][:, 0], k_c, v_c,
                                             torch.from_numpy(fill))
        got = da.spec_verify_attention(
            t["q"], t["k_cache"], t["v_cache"], t["k_new"], t["v_new"],
            vis)
    else:
        kq, ks = quantize_kv(t["k_cache"])
        vq, vs = quantize_kv(t["v_cache"])
        knq, kns = quantize_kv(t["k_new"])
        vnq, vns = quantize_kv(t["v_new"])
        kq2, ks2, vq2, vs2 = kq.clone(), ks.clone(), vq.clone(), vs.clone()
        kq2[rows, write], ks2[rows, write] = knq[:, 0], kns[:, 0]
        vq2[rows, write], vs2[rows, write] = vnq[:, 0], vns[:, 0]
        want = da.decode_attention_reference(
            t["q"][:, 0], kq2, vq2, torch.from_numpy(fill), ks2, vs2)
        got = da.spec_verify_attention(
            t["q"], kq, vq, knq.float() * kns[..., None],
            vnq.float() * vns[..., None], vis, k_scale=ks, v_scale=vs,
            k_new_q=knq, k_new_scale=kns, v_new_q=vnq, v_new_scale=vns)
    np.testing.assert_allclose(got[:, 0].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


# ---- the accept law --------------------------------------------------------


def _jax_accept(logits, drafts, draft_len, temps, active, fed, seed=7):
    emitted, acc = jax.jit(jax_spec.spec_accept)(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(draft_len),
        jnp.asarray(temps), jnp.asarray(active), jnp.asarray(fed),
        jax.random.key(seed), jnp.int32(0),
    )
    return np.asarray(emitted), np.asarray(acc)


def _port_accept(logits, drafts, draft_len, temps, active, fed,
                 generator=None):
    emitted, acc = spec_lib.spec_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.from_numpy(draft_len), temps, torch.from_numpy(active),
        torch.from_numpy(fed), generator)
    return emitted.numpy(), acc.numpy()


def test_spec_accept_greedy_law():
    """Hand-built logits (the reference's case): drafts on the argmax
    chain are accepted up to the first mismatch, the final token is the
    argmax there, columns past draft_len never count; equal to JAX."""
    slots, K, V = 3, 3, 11
    logits = np.full((slots, K + 1, V), -5.0, np.float32)
    best = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 1, 2, 3]], np.int32)
    for s in range(slots):
        for t in range(K + 1):
            logits[s, t, best[s, t]] = 5.0
    drafts = np.array([[1, 2, 3], [5, 0, 8], [9, 1, 2]], np.int32)
    args = (logits, drafts, np.array([3, 3, 0], np.int32),
            np.zeros(slots, np.float32), np.ones(slots, bool),
            np.zeros(slots, np.int32))
    emitted, acc = _port_accept(*args)
    assert acc.tolist() == [3, 1, 0]
    assert emitted[0, :4].tolist() == [1, 2, 3, 4]
    assert emitted[1, :2].tolist() == [5, 6]
    assert emitted[2, 0] == 9
    want_e, want_a = _jax_accept(*args)
    np.testing.assert_array_equal(acc, want_a)
    np.testing.assert_array_equal(emitted, want_e)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_accept_greedy_rows_match_jax(seed):
    """Random logits, drafts on the argmax chain with a random wrong
    token, draft_len 0, partial and full, and inactive rows: the port's
    emitted and accept_len equal JAX's exactly."""
    rs = np.random.RandomState(seed)
    slots, K, V = 64, 4, 37
    logits = rs.randn(slots, K + 1, V).astype(np.float32)
    drafts = logits[:, :K].argmax(-1).astype(np.int32)
    wrong = rs.rand(slots, K) < 0.25
    drafts = np.where(wrong, (drafts + 1) % V, drafts).astype(np.int32)
    draft_len = rs.randint(0, K + 1, slots).astype(np.int32)
    active = rs.rand(slots) < 0.8
    fed = rs.randint(0, V, slots).astype(np.int32)
    args = (logits, drafts, draft_len, np.zeros(slots, np.float32),
            active, fed)
    emitted, acc = _port_accept(*args)
    want_e, want_a = _jax_accept(*args)
    np.testing.assert_array_equal(acc, want_a)
    np.testing.assert_array_equal(emitted, want_e)
    assert set(acc[active]) >= {0, K} and (acc[~active] == 0).all()
    assert (emitted[~active] == fed[~active, None]).all()


def test_spec_accept_rejection_sampling_is_distribution_correct():
    """temperature > 0: each draft accepted with probability p(draft),
    the correction drawn from the residual (draft masked out), over
    4096 independent slots; the bonus token follows p at position 1.
    4 sigma of 4096 Bernoulli trials is ~0.031."""
    slots, V, K = 4096, 8, 1
    rs = np.random.RandomState(11)
    logits = rs.randn(slots, K + 1, V).astype(np.float32)
    drafts = np.full((slots, K), 3, np.int32)
    emitted, acc = _port_accept(
        logits, drafts, np.ones(slots, np.int32),
        np.full(slots, 1.0, np.float32), np.ones(slots, bool),
        np.zeros(slots, np.int32), torch.Generator().manual_seed(3))
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    assert abs(float((acc == 1).mean()) - float(p[:, 0, 3].mean())) < 0.035
    rejected = acc == 0
    assert rejected.any() and (~rejected).any()
    # The residual never re-emits the rejected token ...
    assert (emitted[rejected, 0] != 3).all()
    # ... and draws the rest in proportion: P(token j | rejected) over
    # the rejected slots is p_j / (1 - p_3) on average.
    resid = p[rejected, 0] / (1.0 - p[rejected, 0, 3])[:, None]
    resid[:, 3] = 0.0
    for j in (0, 5):
        assert abs(float((emitted[rejected, 0] == j).mean())
                   - float(resid[:, j].mean())) < 0.05


def test_sample_token_logprobs_matches_sample_token():
    """The same token as sample_token for the same generator state, its
    logprob under the temperature-scaled softmax (as JAX's), and top-k
    that holds the argmax, sorted."""
    rs = np.random.RandomState(4)
    logits = torch.from_numpy(rs.randn(6, 32).astype(np.float32))
    temps = np.array([0.0, 0.0, 0.7, 1.0, 1.5, 0.3], np.float32)
    for seed in range(3):
        want = gen.sample_token(logits, temps,
                                torch.Generator().manual_seed(seed))
        tok, lp = gen.sample_token_logprobs(
            logits, temps, torch.Generator().manual_seed(seed))
        assert torch.equal(tok, want)
        _, jlp = jax_gen.sample_token_logprobs(
            jnp.asarray(logits.numpy()), jax.random.key(0),
            jnp.asarray(temps))
        # JAX's token differs (its own noise); its logprob of OUR token:
        base = np.where(temps[:, None] > 0,
                        logits.numpy() / np.maximum(temps[:, None], 1e-6),
                        logits.numpy())
        ref = jax.nn.log_softmax(jnp.asarray(base), axis=-1)
        np.testing.assert_allclose(
            lp.numpy(), np.asarray(ref)[np.arange(6), tok.numpy()],
            rtol=1e-5, atol=1e-5)
        assert np.isfinite(np.asarray(jlp)).all()
    tok, lp, tk_idx, tk_lp = gen.sample_token_logprobs(
        logits, temps, torch.Generator().manual_seed(0), top_k=5)
    assert tk_idx.shape == (6, 5) and tk_lp.shape == (6, 5)
    assert (tk_idx[:, 0] == logits.argmax(-1)).all()
    assert (torch.diff(tk_lp, dim=1) <= 1e-6).all()


# ---- host drafter and clamp ------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "repetitive"])
def test_propose_ngram_matches_reference(kind):
    """A sweep of histories, k and max_ngram: the port's copy proposes
    what the reference's does."""
    rs = np.random.RandomState(17)
    proposed = 0
    for _ in range(300):
        n = int(rs.randint(0, 40))
        if kind == "random":
            hist = rs.randint(0, 6, n)
        else:
            motif = rs.randint(0, 50, int(rs.randint(1, 6)))
            hist = np.tile(motif, 10)[:n]
        k, g = int(rs.randint(0, 6)), int(rs.randint(1, 5))
        got = spec_lib.propose_ngram(hist, k, max_ngram=g)
        want = jax_spec.propose_ngram(hist, k, max_ngram=g)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
        proposed += got.size > 0
    assert proposed > 100


def test_clamp_draft_len_matches_reference():
    rs = np.random.RandomState(3)
    for _ in range(500):
        args = (int(rs.randint(0, 6)), int(rs.randint(0, 20)),
                int(rs.randint(1, 24)), int(rs.randint(0, 64)), 64)
        assert spec_lib.clamp_draft_len(*args) == \
            jax_spec.clamp_draft_len(*args)


# ---- engines against the JAX package ---------------------------------------


@pytest.mark.parametrize("drafter,layers", [("ngram", 0), ("early_exit", 2)])
def test_flat_spec_engine_matches_naive_and_jax(tiny, drafter, layers):
    """Staggered admissions over two slots, three requests: every
    request's greedy tokens equal the teacher-forced loop's and the JAX
    spec engine's; drafts were proposed, and the n-gram drafter's were
    accepted."""
    cfg, params, jcfg, jparams = tiny
    prompts = repeat_prompts(cfg, params, (7, 5, 12), seed=1)
    news = (12, 10, 9)
    kw = dict(slots=2, max_len=64, prefill_chunk=4, spec_k=3,
              spec_drafter=drafter, spec_draft_layers=layers)
    eng = flat(cfg, params, **kw)
    eng.warmup()
    got = run_staggered(eng, prompts, news)
    jeng = JaxServingEngine(jcfg, jparams, **kw)
    want = run_staggered(jeng, prompts, news)
    for g, w, p, n in zip(got, want, prompts, news):
        assert g.tokens == naive_greedy(cfg, params, p, n), f"rid {g.rid}"
        assert g.tokens == w.tokens
    assert sum(r.spec_drafted for r in got) > 0
    if drafter == "ngram":
        assert sum(r.spec_accepted for r in got) > 0
    counts = eng.call_counts
    assert counts["decode"] == 1          # warmup's only
    assert counts["draft"] == (counts["verify"] if layers else 0)


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_paged_spec_matches_spec_off_and_jax(tiny, kv):
    """The paged engine, spec on (n-gram and early exit) against spec
    off, token for token, with the block invariants after each run; fp
    tokens equal the JAX paged spec engine's, int8 tokens (the JAX
    engine's too) lie within INT8_LOGIT_BOUND of the teacher-forced max
    and the block accounting is equal."""
    cfg, params, jcfg, jparams = tiny
    prompts = repeat_prompts(cfg, params, (7, 5, 12), seed=1)
    news = (12, 10, 9)
    kw = dict(slots=2, max_len=64, prefill_chunk=4, block_size=4,
              kv_cache_dtype=kv)

    def run(**spec):
        eng = paged(cfg, params, **kw, **spec)
        eng.warmup()
        reqs = run_staggered(eng, prompts, news)
        eng.check_block_invariants()
        return eng, reqs

    _, off = run()
    for spec in (dict(spec_k=3), dict(spec_k=3, spec_drafter="early_exit")):
        eng, on = run(**spec)
        assert [r.tokens for r in on] == [r.tokens for r in off], spec
        assert sum(r.spec_drafted for r in on) > 0
    _, on = run(spec_k=3)
    assert sum(r.spec_accepted for r in on) > 0
    jeng = JaxPagedServingEngine(jcfg, jparams, spec_k=3, **kw)
    want = run_staggered(jeng, prompts, news)
    if kv == "fp":
        assert [r.tokens for r in on] == [r.tokens for r in want]
    else:
        for r in on + want:
            assert len(r.tokens) == r.max_new_tokens
            gap = teacher_forced_gap(cfg, params, r)
            assert gap <= INT8_LOGIT_BOUND, f"rid {r.rid}: gap {gap}"
    keys = ("total", "free", "used", "cached", "prefix_hits",
            "prefix_hit_blocks")
    stats, jstats = eng.kv_stats(), jeng.kv_stats()
    assert {k: stats[k] for k in keys} == {k: jstats[k] for k in keys}


class _OracleDraftEngine(PagedServingEngine):
    """Paged engine whose drafter proposes the TRUE greedy continuation
    with a randomly corrupted tail: the accept length sweeps 0..K per
    slot per step while greedy output stays checkable."""

    def __init__(self, *a, oracle_seed=0, **kw):
        super().__init__(*a, **kw)
        self._oracle = {}  # rid -> full greedy continuation
        self._oracle_rs = np.random.RandomState(oracle_seed)

    def _spec_draft(self, decoding, active):
        K = self.spec_k
        draft_len = np.zeros(self.slots, np.int32)
        drafts = np.zeros((self.slots, K), np.int32)
        for r in decoding:
            cap = spec_lib.clamp_draft_len(
                K, len(r.tokens), r.max_new_tokens,
                int(self._lengths[r.slot]), self.max_len,
            )
            n = self._oracle_rs.randint(0, cap + 1)
            if n == 0:
                continue
            cont = self._oracle[r.rid][len(r.tokens):len(r.tokens) + n]
            row = np.zeros(n, np.int32)
            row[:len(cont)] = cont
            if self._oracle_rs.rand() < 0.5:
                j = self._oracle_rs.randint(0, n)
                row[j] = (row[j] + 1) % self.config.vocab_size
            drafts[r.slot, :n] = row
            draft_len[r.slot] = n
        return drafts, draft_len


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_random_accept_lengths_keep_block_invariants(tiny, kv):
    """Random accept-length vectors through the paged engine with the
    prefix cache and COW live (shared prompt heads), two episodes:
    tokens equal the spec-off engine's (int8: its own spec-off pool),
    block conservation and refcounts hold, nothing stays in use."""
    cfg, params, _, _ = tiny
    rs = np.random.RandomState(21)
    head = rs.randint(0, cfg.vocab_size, 8).astype(np.int32)
    prompts = [np.concatenate([
        head, rs.randint(0, cfg.vocab_size, 1 + rs.randint(4))
    ]).astype(np.int32) for _ in range(4)]
    kw = dict(slots=2, max_len=64, prefill_chunk=4, block_size=4,
              kv_cache_dtype=kv)
    ref = paged(cfg, params, **kw)
    expect = []
    for p in prompts:
        r = ref.submit(p, 12)
        ref.run_until_idle()
        expect.append(r.tokens)
    eng = _OracleDraftEngine(cfg, params, spec_k=3, oracle_seed=13,
                             registry=MetricsRegistry(), device="cpu",
                             **kw)
    eng.warmup()
    for episode in range(2):
        reqs = []
        for i, p in enumerate(prompts):
            r = eng.submit(p, 12)
            eng._oracle[r.rid] = expect[i]
            reqs.append(r)
            eng.step()  # interleave admissions with decode
        eng.run_until_idle()
        for i, r in enumerate(reqs):
            assert r.tokens == expect[i], f"episode {episode} req {i}"
        eng.check_block_invariants()
        stats = eng.kv_stats()
        assert stats["used"] == 0
        assert stats["free"] + stats["cached"] == eng._allocator.managed
        assert stats["prefix_hits"] > 0
    assert sum(r.spec_accepted for r in reqs) > 0


# ---- scheduler, metrics, arguments -----------------------------------------


def test_scheduler_budget_counts_verification_tokens():
    """With decode_tokens_per_slot = 1 + spec_k a decoding slot reserves
    its verification tokens: the budget that admits a prefill chunk
    beside one-token decode refuses it when a step may run K+1."""

    def gated(per_slot):
        sch = Scheduler(slots=2, max_len=32, prefill_chunk=8,
                        token_budget=10, decode_tokens_per_slot=per_slot)
        dec = sch.submit(np.arange(4, dtype=np.int32), 4)
        sch.submit(np.arange(4, dtype=np.int32), 4)
        sch.admit(0.0)
        dec.state = DECODE
        return sch.pick_prefill() is None

    assert not gated(1)   # 1 + 8 <= 10: the prefill runs
    assert gated(4)       # 4 + 8 > 10: decode reserves first
    sch = Scheduler(slots=2, max_len=32, prefill_chunk=8,
                    decode_tokens_per_slot=4)
    assert sch.token_budget == 8 + 2 * 4
    with pytest.raises(ValueError, match="decode_tokens_per_slot"):
        Scheduler(slots=2, max_len=32, prefill_chunk=8,
                  decode_tokens_per_slot=0)


def test_progress_resets_clear_spec_accounting():
    sch = Scheduler(slots=2, max_len=32, prefill_chunk=8)
    a = sch.submit(np.arange(4, dtype=np.int32), 4)
    b = sch.submit(np.arange(4, dtype=np.int32), 4)
    sch.admit(0.0)
    for r in (a, b):
        r.spec_drafted, r.spec_accepted = 6, 2
        r.draft_s, r.verify_s = 0.5, 0.25
    sch.preempt(b)
    sch.requeue_active()
    for r in (a, b):
        assert (r.spec_drafted, r.spec_accepted, r.draft_s,
                r.verify_s) == (0, 0, 0.0, 0.0)


@pytest.mark.parametrize("engine", ["flat", "paged"])
def test_engines_check_spec_arguments(tiny, engine):
    """spec_k < 0, an unknown drafter and spec_draft_layers outside
    1..n_layers raise ValueError; spec_k wires the scheduler budget."""
    cfg, params, _, _ = tiny
    make = flat if engine == "flat" else paged
    kw = dict(slots=2, max_len=32, prefill_chunk=4)
    if engine == "paged":
        kw["block_size"] = 4
    with pytest.raises(ValueError, match="spec_k"):
        make(cfg, params, spec_k=-1, **kw)
    with pytest.raises(ValueError, match="spec_drafter"):
        make(cfg, params, spec_k=2, spec_drafter="nope", **kw)
    for layers in (0, cfg.n_layers + 1):
        with pytest.raises(ValueError, match="spec_draft_layers"):
            make(cfg, params, spec_k=2, spec_drafter="early_exit",
                 spec_draft_layers=layers, **kw)
    eng = make(cfg, params, spec_k=3, **kw)
    assert eng.scheduler.decode_tokens_per_slot == 4
    assert eng.scheduler.token_budget == 4 + 2 * 4
    assert eng.spec_draft_layers == 0     # n-gram: no device drafter


def test_token_latency_observed_once_per_token(tiny):
    """A verify step committing N tokens adds N latency observations,
    not one: the count equals the decode-token counter less the first
    tokens prefill emits; the spec families move with the episode."""
    cfg, params, _, _ = tiny
    reg = MetricsRegistry()
    eng = flat(cfg, params, slots=2, max_len=64, prefill_chunk=4,
               spec_k=3, registry=reg)
    eng.warmup()
    for p, n in zip(repeat_prompts(cfg, params, (7, 12), seed=3), (12, 9)):
        eng.submit(p, n)
    eng.run_until_idle()
    decode_tokens = reg.get("serving_tokens_total").value(kind="decode")
    assert decode_tokens == 21
    assert reg.get("serving_token_latency_seconds").count() == (
        decode_tokens - 2)
    spec = reg.get("serving_spec_tokens_total")
    drafted = spec.value(kind="drafted")
    accepted = spec.value(kind="accepted")
    assert drafted == accepted + spec.value(kind="rejected") > 0
    assert accepted > 0
    per_step = reg.get("serving_spec_accepted_tokens_per_step").value()
    assert per_step == (decode_tokens - 2) / eng._spec_slot_steps > 1.0
    assert reg.get("serving_spec_accept_rate").count() > 0


# ---- the edges: draft_len 0, max_len, inactive slots, sampling -------------


class _NoDraftEngine(ServingEngine):
    """Proposes nothing: every verify step is a one-token decode."""

    def _spec_draft(self, decoding, active):
        return (np.zeros((self.slots, self.spec_k), np.int32),
                np.zeros(self.slots, np.int32))


def test_draft_len_zero_is_one_token_decode(tiny):
    """With nothing drafted the verify step degenerates to one-token
    decode: the tokens and the visible cache rows equal the spec-off
    engine's (rows within 1e-5: the same math, summed in another
    order), one token a step."""
    cfg, params, _, _ = tiny
    prompts = repeat_prompts(cfg, params, (5, 9), seed=4)
    kw = dict(slots=2, max_len=32, prefill_chunk=4)
    off = flat(cfg, params, **kw)
    on = _NoDraftEngine(cfg, params, spec_k=3, registry=MetricsRegistry(),
                        device="cpu", **kw)
    reqs = {}
    for eng in (off, on):
        reqs[eng] = [eng.submit(p, 6) for p in prompts]
        while eng.pending():
            eng.step()
            if eng.scheduler.active():
                fills = eng._lengths.copy()
    for a, b in zip(reqs[off], reqs[on]):
        assert a.tokens == b.tokens
        assert b.spec_drafted == 0
    assert on.call_counts["verify"] == off.call_counts["decode"]
    n = int(fills.min())
    np.testing.assert_allclose(on._k[:, :, :n].numpy(),
                               off._k[:, :, :n].numpy(), atol=1e-5)


@pytest.mark.parametrize("engine", ["flat", "paged"])
def test_spec_near_max_len_drops_rows(tiny, engine):
    """A request that runs into max_len with spec on: rows past max_len
    are dropped (an index there would raise), the empty slot's rows
    stay unwritten (flat) or its writes reach only the sentinel block
    (paged), the visible rows equal the spec-off engine's, and the
    request ends truncated with the JAX spec engine's tokens."""
    cfg, params, jcfg, jparams = tiny
    (p,) = repeat_prompts(cfg, params, (9,), seed=6)   # 28 tokens
    kw = dict(slots=2, max_len=32, prefill_chunk=4,
              spec_drafter="early_exit", spec_draft_layers=2)
    if engine == "paged":
        kw.update(block_size=4, prefix_cache=False)
    make = flat if engine == "flat" else paged
    eng = make(cfg, params, spec_k=3, **kw)
    off = make(cfg, params, **{k: v for k, v in kw.items()
                               if not k.startswith("spec")})
    r, r_off = eng.submit(p, 20), off.submit(p, 20)
    eng.run_until_idle()
    off.run_until_idle()
    jeng = (JaxServingEngine if engine == "flat" else
            JaxPagedServingEngine)(jcfg, jparams, spec_k=3, **kw)
    want = jeng.submit(p, 20)
    jeng.run_until_idle()
    assert r.truncated and want.truncated and r_off.truncated
    assert r.tokens == want.tokens == r_off.tokens
    assert len(r.tokens) == 32 - len(p) + 1
    assert r.spec_drafted > 0
    if engine == "flat":
        assert not eng._k[:, 1].any() and not eng._v[:, 1].any()
        np.testing.assert_allclose(eng._k[:, 0].numpy(),
                                   off._k[:, 0].numpy(), atol=1e-5)
    else:
        # Slot 0 owned every block but the sentinel at the end; nothing
        # else is written but through the sentinel.
        eng.check_block_invariants()
        assert eng.kv_stats()["used"] == 0


def test_paged_spec_inactive_slots_write_only_the_sentinel_block(tiny):
    """Spec on (early exit: draft and verify both write): blocks no
    request ever owned stay zero; the free slots' and the out-of-range
    rows go to the sentinel block."""
    cfg, params, _, _ = tiny
    eng = paged(cfg, params, slots=4, max_len=32, prefill_chunk=8,
                block_size=8, prefix_cache=False, spec_k=3,
                spec_drafter="early_exit")
    eng.warmup()
    (prompt,) = repeat_prompts(cfg, params, (5,), seed=21, cont=3)
    owned = set()
    req = eng.submit(prompt, 9)
    while eng.pending():
        eng.step()
        if req.slot >= 0:
            owned.update(eng._slot_blocks[req.slot])
    assert owned and SENTINEL_BLOCK not in owned
    assert req.spec_drafted > 0
    untouched = [b for b in range(1, eng.num_blocks) if b not in owned]
    assert not eng._k[:, untouched].any()
    assert not eng._v[:, untouched].any()
    assert eng._k[:, sorted(owned)].any()


@pytest.mark.parametrize("engine", ["flat", "paged"])
def test_sampled_spec_rows_reproduce_per_generator(tiny, engine):
    """Sampled requests through the spec path: every request completes,
    the same generator seed gives the same tokens, another seed other
    tokens, and a greedy request beside them keeps its exact tokens."""
    cfg, params, _, _ = tiny
    prompts = repeat_prompts(cfg, params, (6, 8, 7), seed=8)
    make = flat if engine == "flat" else paged
    kw = dict(slots=3, max_len=64, prefill_chunk=4, spec_k=3)
    if engine == "paged":
        kw["block_size"] = 4

    def run(seed):
        eng = make(cfg, params, generator=torch.Generator().manual_seed(seed),
                   **kw)
        reqs = [eng.submit(prompts[0], 10, temperature=1.0),
                eng.submit(prompts[1], 10, temperature=0.7),
                eng.submit(prompts[2], 10)]
        eng.run_until_idle()
        assert all(len(r.tokens) == 10 for r in reqs)
        return [r.tokens for r in reqs]

    a = run(7)
    assert a == run(7)
    b = run(8)
    assert a[:2] != b[:2]
    assert a[2] == b[2] == naive_greedy(cfg, params, prompts[2], 10)
