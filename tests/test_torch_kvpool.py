"""The port's paged KV plane (counterpart of ``tests/test_kvpool.py``)
on ``tiny_config`` (f32), ``device="cpu"``, where the paged
decode-attention wrapper runs its plain version: allocator and prefix
cache properties, the paged engine token-exact against the flat engine
and the teacher-forced loop, prefix hits that skip prefill, COW,
recycled blocks, preemption under an oversubscribed pool, the admission
gate, the KV metrics, and the int8 pool. The engine as a whole is held to
the JAX package's ``PagedServingEngine``: the same prompts through both
(params crossed with ``params_from_numpy``), greedy, f32, give equal
tokens and equal block accounting after each request.

Two things differ from the reference on purpose, and the tests say so:

- The reference's decode step attends over the gathered view with the
  new token's own K/V kept apart at full precision; the port appends
  first and reads the row back through the paged kernel (the math of
  the reference's Pallas branch). With an f32 pool the two agree to
  rounding, so fp greedy tokens are held EQUAL to the JAX engine's. With
  an int8 pool the port reads the new row quantized: int8 tokens are
  held equal to the port's own int8 ``generate()`` (both append, then
  read), and against the JAX int8 engine by the logit distance that
  ``tests/test_kernel_parity.py`` pins for int8 decode steps (0.2):
  every token either engine chose lies within it of the teacher-forced
  f32 maximum.
- The reference counts jit traces (``trace_counts``) and its
  ``test_no_retrace_across_admissions_with_varying_tables`` pins them
  flat. The port is eager and compiles nothing, so that test has no
  counterpart here.
"""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import numpy as np
import pytest
import torch

import jax

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.serving.kvpool import (
    PagedServingEngine as JaxPagedServingEngine,
)
from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models import generate as gen
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.observability.registry import MetricsRegistry
from dlrover_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv
from dlrover_tpu_torch.serving import (
    SENTINEL_BLOCK,
    BlockAllocator,
    BlockPoolExhausted,
    PagedServingEngine,
    PrefixCache,
    Scheduler,
    ServingEngine,
    SloClass,
)

# The decode-step logit distance tests/test_kernel_parity.py pins
# between the int8 and the fp cache on this config.
INT8_LOGIT_BOUND = 0.2


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_llama.tiny_config()
    jparams, _ = jax_llama.init_params(jcfg, jax.random.key(0))
    params = convert.params_from_numpy(jax.device_get(jparams), "cpu")
    return llama.tiny_config(), params, jcfg, jparams


def paged(cfg, params, **kw):
    kw.setdefault("registry", MetricsRegistry())
    return PagedServingEngine(cfg, params, device="cpu", **kw)


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


def make_prompts(cfg, lens, seed=0):
    rs = np.random.RandomState(seed)
    return [
        rs.randint(0, cfg.vocab_size, size=n).astype(np.int32)
        for n in lens
    ]


# ---- allocator properties ---------------------------------------------------


def test_allocator_alloc_free_conservation():
    a = BlockAllocator(9, reserved=1)
    assert a.managed == 8
    got = a.alloc(3)
    assert len(got) == 3 and 0 not in got
    assert a.free_count() == 5
    for b in got:
        assert a.refcount(b) == 1
        assert a.decref(b)            # freed
    assert a.free_count() == 8
    a.check()
    with pytest.raises(ValueError):
        a.decref(got[0])              # double free raises


def test_allocator_all_or_nothing_exhaustion():
    a = BlockAllocator(5, reserved=1)
    a.alloc(3)
    with pytest.raises(BlockPoolExhausted):
        a.alloc(2)                    # only 1 free: nothing granted
    assert a.free_count() == 1
    a.check()


def test_allocator_refcount_and_cow():
    a = BlockAllocator(6, reserved=1)
    (b,) = a.alloc(1)
    # Sole owner: ensure_private is the identity, no copy.
    same, copied = a.ensure_private(b)
    assert same == b and not copied
    a.incref(b)                       # a second owner appears
    new, copied = a.ensure_private(b)
    assert copied and new != b
    assert a.refcount(b) == 1         # the other owner keeps the old
    assert a.refcount(new) == 1
    assert a.cow_copies_total == 1
    a.check()


def test_allocator_stats_split_used_vs_cached():
    a = BlockAllocator(8, reserved=1)
    blocks = a.alloc(4)
    stats = a.stats(live_blocks=blocks[:3])
    assert stats == {
        "total": 7, "free": 3, "used": 3, "cached": 1,
        "min_ref": 1, "negative_refs": 0,
    }


def test_allocator_rejects_a_pool_of_sentinels_only():
    with pytest.raises(ValueError, match="must exceed"):
        BlockAllocator(1, reserved=1)
    a = BlockAllocator(3, reserved=1)
    with pytest.raises(ValueError, match="unallocated"):
        a.incref(2)


# ---- prefix cache properties ------------------------------------------------


def test_prefix_cache_insert_lookup_refcounts():
    a = BlockAllocator(17, reserved=1)
    cache = PrefixCache(a, block_size=4)
    prompt = np.arange(10, dtype=np.int32)     # 2 full blocks + tail
    blocks = a.alloc(3)
    assert cache.insert(prompt, blocks[:2]) == 2   # tail never cached
    assert a.refcount(blocks[0]) == 2              # slot + cache
    hit = cache.lookup(prompt)
    assert hit == blocks[:2]
    assert a.refcount(blocks[0]) == 3              # + the new borrower
    # A diverging prompt shares only the common full blocks.
    other = prompt.copy()
    other[6] += 1                                  # diverge in block 1
    assert cache.lookup(other) == blocks[:1]
    # Unrelated prompt: clean miss.
    assert cache.lookup(np.arange(100, 108, dtype=np.int32)) == []
    assert cache.hits_total == 2 and cache.misses_total == 1


def test_prefix_cache_leaf_first_eviction_frees_blocks():
    a = BlockAllocator(17, reserved=1)
    cache = PrefixCache(a, block_size=4)
    prompt = np.arange(12, dtype=np.int32)         # 3 full blocks
    blocks = a.alloc(3)
    cache.insert(prompt, blocks)
    for b in blocks:
        a.decref(b)                                # slot released
    assert a.stats()["cached"] == 3
    # One eviction takes the LEAF (block 2), never an interior entry.
    assert cache.evict_lru(1) == 1
    assert a.refcount(blocks[2]) == 0              # freed
    assert a.refcount(blocks[0]) == 1              # chain head intact
    assert cache.lookup(prompt) == blocks[:2]      # prefix still hits
    for b in blocks[:2]:
        a.decref(b)
    cache.clear()
    a.check()
    assert a.free_count() == a.managed


def test_prefix_cache_capacity_evicts_on_insert():
    a = BlockAllocator(17, reserved=1)
    cache = PrefixCache(a, block_size=4, capacity_blocks=2)
    blocks = a.alloc(3)
    cache.insert(np.arange(12, dtype=np.int32), blocks)
    assert cache.cached_entries == 2               # the leaf went
    assert cache.stats()["evicted_blocks"] == 1
    assert a.refcount(blocks[2]) == 1              # only the slot's ref


# ---- paged engine: exactness and reuse --------------------------------------


def test_paged_ragged_decode_matches_flat_and_teacher_forced(tiny):
    """The same staggered ragged workload through the flat engine and
    the paged engine (greedy): token-exact against each other AND the
    teacher-forced reference."""
    cfg, params, _, _ = tiny
    prompts = make_prompts(cfg, (5, 3, 9), seed=1)
    plans = list(zip(prompts, (6, 5, 4)))

    def run(engine):
        reqs = [engine.submit(prompts[0], 6)]
        for _ in range(4):
            engine.step()
        reqs.append(engine.submit(prompts[1], 5))
        reqs.append(engine.submit(prompts[2], 4))
        engine.run_until_idle()
        return [r.tokens for r in reqs]

    flat = ServingEngine(cfg, params, slots=2, max_len=32,
                         prefill_chunk=4, registry=MetricsRegistry(),
                         device="cpu")
    flat.warmup()
    eng = paged(cfg, params, slots=2, max_len=32, prefill_chunk=4,
                block_size=8)
    eng.warmup()
    flat_tokens = run(flat)
    paged_tokens = run(eng)
    assert paged_tokens == flat_tokens
    for tokens, (prompt, max_new) in zip(paged_tokens, plans):
        assert tokens == naive_greedy(cfg, params, prompt, max_new)
    eng.check_block_invariants()


def test_prefix_cache_hit_skips_prefill_and_stays_exact(tiny):
    """A repeated prompt must HIT (prefill chunks skipped — measured by
    the engine's prefill-token counter), decode the exact same greedy
    tokens, and leave the allocator conserved."""
    cfg, params, _, _ = tiny
    eng = paged(cfg, params, slots=2, max_len=32, prefill_chunk=4,
                block_size=8)
    eng.warmup()
    (prompt,) = make_prompts(cfg, (17,), seed=3)   # 2 full blocks + 1
    ref = naive_greedy(cfg, params, prompt, 5)
    r1 = eng.submit(prompt, 5)
    eng.run_until_idle()
    assert r1.tokens == ref and r1.prefix_hit_blocks == 0
    first_prefill = eng.metrics.tokens.value(kind="prefill")
    r2 = eng.submit(prompt, 5)
    eng.run_until_idle()
    assert r2.tokens == ref
    assert r2.prefix_hit_blocks == 2
    resumed_prefill = (
        eng.metrics.tokens.value(kind="prefill") - first_prefill
    )
    # 17-token prompt, 16 covered, resume at 16 (chunk-aligned): only
    # the final 1-valid-token chunk re-runs.
    assert resumed_prefill < first_prefill
    assert resumed_prefill == 1
    eng.check_block_invariants()


def test_cow_privatizes_shared_block_on_rewrite(tiny):
    """A fully-cached block-aligned prompt re-runs its last chunk (the
    first token must be re-sampled) INTO a shared block: the write must
    COW, both requests stay exact, refcounts stay sane, and the cached
    block keeps its bytes."""
    cfg, params, _, _ = tiny
    eng = paged(cfg, params, slots=2, max_len=32, prefill_chunk=4,
                block_size=8)
    eng.warmup()
    (prompt,) = make_prompts(cfg, (8,), seed=5)    # exactly one block
    ref = naive_greedy(cfg, params, prompt, 5)
    r1 = eng.submit(prompt, 5)
    eng.run_until_idle()
    (cached,) = eng._cache.cached_block_ids()
    before = eng._k[:, cached].clone(), eng._v[:, cached].clone()
    r2 = eng.submit(prompt, 5)
    eng.run_until_idle()
    assert r1.tokens == ref and r2.tokens == ref
    assert eng.kv_stats()["cow_copies"] >= 1
    assert torch.equal(eng._k[:, cached], before[0])
    assert torch.equal(eng._v[:, cached], before[1])
    eng.check_block_invariants()


def test_recycled_block_does_not_leak_kv(tiny):
    """Blocks freed by a long request and re-allocated to a short one
    must not leak the previous occupant's KV (cache disabled so reuse
    is guaranteed)."""
    cfg, params, _, _ = tiny
    eng = paged(cfg, params, slots=1, max_len=32, prefill_chunk=8,
                block_size=8, prefix_cache=False)
    eng.warmup()
    long_p, short_p = make_prompts(cfg, (12, 3), seed=2)
    r_long = eng.submit(long_p, 12)
    eng.run_until_idle()
    assert r_long.state == "done" and len(r_long.tokens) == 12
    assert eng.kv_stats()["free"] == eng.num_blocks - 1  # all recycled
    r_short = eng.submit(short_p, 6)
    eng.run_until_idle()
    assert r_short.tokens == naive_greedy(cfg, params, short_p, 6)
    eng.check_block_invariants()


def test_oversubscribed_pool_preempts_youngest_and_conserves(tiny):
    """More logical slot capacity than physical blocks: the pool runs
    dry mid-decode, the youngest request is preempted (front-requeued,
    NOT failed) and everything still completes with exact tokens."""
    cfg, params, _, _ = tiny
    eng = paged(cfg, params, slots=4, max_len=32, prefill_chunk=8,
                block_size=8, num_blocks=10, prefix_cache=False)
    eng.warmup()
    prompts = make_prompts(cfg, (12, 12, 12, 12), seed=7)
    reqs = [eng.submit(p, 16) for p in prompts]
    eng.run_until_idle()
    assert all(r.state == "done" and not r.failed for r in reqs)
    assert eng.metrics.kv_preemptions.value() >= 1
    # Being the youngest when the pool runs dry is scheduling, not
    # failure: no requeue-budget charge, and the oldest is never taken.
    assert all(r.requeues == 0 for r in reqs)
    assert reqs[0].preemptions == 0
    assert sum(r.preemptions for r in reqs) == (
        eng.metrics.kv_preemptions.value()
    )
    for req, prompt in zip(reqs, prompts):
        assert req.tokens == naive_greedy(cfg, params, prompt, 16)
    eng.check_block_invariants()
    assert eng.kv_stats()["free"] == eng.num_blocks - 1


def test_chunk_aligned_discarded_hit_reports_as_miss(tiny):
    """A raw cache hit whose blocks are ALL discarded by chunk
    alignment saved nothing: kv_stats must report it as a miss."""
    cfg, params, _, _ = tiny
    # chunk 16 > block 8: a 1-block hit on a 9-token prompt aligns
    # start to 0 — the whole hit is discarded.
    eng = paged(cfg, params, slots=2, max_len=32, prefill_chunk=16,
                block_size=8)
    eng.warmup()
    (prompt,) = make_prompts(cfg, (9,), seed=13)
    eng.submit(prompt, 3)
    eng.run_until_idle()
    r2 = eng.submit(prompt, 3)
    eng.run_until_idle()
    assert r2.prefix_hit_blocks == 0
    stats = eng.kv_stats()
    assert stats["prefix_hits"] == 0
    assert stats["prefix_hit_rate"] == 0.0
    eng.check_block_invariants()


def test_inactive_slots_write_only_the_sentinel_block(tiny):
    """Blocks no request ever owned stay zero: the free slots' appends
    all go to the sentinel block, and a prefill scatters back only the
    blocks its chunk touches."""
    cfg, params, _, _ = tiny
    eng = paged(cfg, params, slots=4, max_len=32, prefill_chunk=8,
                block_size=8, prefix_cache=False)
    eng.warmup()
    (prompt,) = make_prompts(cfg, (5,), seed=21)
    owned = set()
    req = eng.submit(prompt, 6)
    while eng.pending():
        eng.step()
        if req.slot >= 0:
            owned.update(eng._slot_blocks[req.slot])
    assert owned and SENTINEL_BLOCK not in owned
    untouched = [b for b in range(1, eng.num_blocks) if b not in owned]
    assert not eng._k[:, untouched].any()
    assert not eng._v[:, untouched].any()
    assert eng._k[:, sorted(owned)].any()


def test_cancel_returns_the_slots_blocks(tiny):
    cfg, params, _, _ = tiny
    eng = paged(cfg, params, slots=1, max_len=32, prefill_chunk=4,
                block_size=8, prefix_cache=False)
    p1, p2 = make_prompts(cfg, (9, 3), seed=9)
    r1 = eng.submit(p1, 20)
    eng.step()
    assert eng.kv_stats()["used"] == 1
    eng.cancel(r1)
    assert r1.state == "done" and eng.pending() == 0
    assert eng.kv_stats()["free"] == eng.num_blocks - 1
    assert not eng._tables.any()
    r2 = eng.submit(p2, 5)
    eng.run_until_idle()
    assert r2.tokens == naive_greedy(cfg, params, p2, 5)
    eng.check_block_invariants()


def test_step_error_rebuilds_pool_allocator_and_cache(tiny, monkeypatch):
    """A raising step restarts everything that points at the device
    blocks; the request then completes with exact tokens."""
    cfg, params, _, _ = tiny
    reg = MetricsRegistry()
    eng = paged(cfg, params, slots=2, max_len=32, prefill_chunk=4,
                block_size=8, registry=reg)
    (warm, prompt) = make_prompts(cfg, (9, 6), seed=10)
    eng.submit(warm, 2)
    eng.run_until_idle()
    assert eng.kv_stats()["cached"] == 1
    real, calls = eng._decode, {"n": 0}

    def flaky(active):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected")
        return real(active)

    monkeypatch.setattr(eng, "_decode", flaky)
    req = eng.submit(prompt, 4)
    eng.run_until_idle()
    assert reg.get("serving_step_errors_total").value() == 1
    assert req.requeues == 1 and not req.failed
    assert req.tokens == naive_greedy(cfg, params, prompt, 4)
    stats = eng.kv_stats()
    # The warm chain went with the pool; the rerun cached its own.
    assert stats["prefix_hits"] == 0
    eng.check_block_invariants()


def test_truncation_at_pool_row_capacity(tiny):
    cfg, params, _, _ = tiny
    eng = paged(cfg, params, slots=1, max_len=16, prefill_chunk=8,
                block_size=8)
    (prompt,) = make_prompts(cfg, (10,), seed=4)
    req = eng.submit(prompt, 50)
    eng.run_until_idle()
    assert req.truncated
    assert len(req.tokens) == eng.max_len - len(prompt) + 1
    assert req.tokens == naive_greedy(cfg, params, prompt, len(req.tokens))
    eng.check_block_invariants()


def test_engine_argument_checks(tiny):
    cfg, params, _, _ = tiny
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        paged(cfg, params, slots=1, max_len=32, kv_cache_dtype="fp8")
    with pytest.raises(ValueError, match="multiple of block_size"):
        paged(cfg, params, slots=1, max_len=36, prefill_chunk=4,
              block_size=8)
    with pytest.raises(ValueError, match="divide one another"):
        paged(cfg, params, slots=1, max_len=48, prefill_chunk=12,
              block_size=8)
    with pytest.raises(ValueError, match="cannot hold one full slot"):
        paged(cfg, params, slots=2, max_len=32, prefill_chunk=8,
              block_size=8, num_blocks=4)
    with pytest.raises(ValueError, match="spec_k"):
        paged(cfg, params, slots=1, max_len=32, prefill_chunk=8,
              block_size=8, spec_k=-1)
    with pytest.raises(ValueError, match="spec_drafter"):
        paged(cfg, params, slots=1, max_len=32, prefill_chunk=8,
              block_size=8, spec_k=2, spec_drafter="lookup")
    with pytest.raises(ValueError, match="spec_draft_layers"):
        paged(cfg, params, slots=1, max_len=32, prefill_chunk=8,
              block_size=8, spec_k=2, spec_drafter="early_exit",
              spec_draft_layers=0)


@pytest.mark.parametrize("kv_dtype,per_row", [("fp", 4 * 16), ("int8", 20)])
def test_default_pool_matches_the_flat_budget(tiny, kv_dtype, per_row):
    """num_blocks defaults to slots * max_len / block_size + sentinel;
    a block's bytes are K+V over all layers at the pool's row cost
    (f32 rows of head_dim 16 here; int8 rows pay 16 + one f32 scale)."""
    cfg, params, _, _ = tiny
    eng = paged(cfg, params, slots=3, max_len=32, prefill_chunk=8,
                block_size=8, kv_cache_dtype=kv_dtype)
    assert eng.num_blocks == 3 * 4 + 1
    assert eng._k.shape == (cfg.n_layers, 13, 8, cfg.n_kv_heads,
                            cfg.head_dim)
    assert eng._block_bytes == (
        2 * cfg.n_layers * 8 * cfg.n_kv_heads * per_row
    )
    assert (eng._kscale is not None) == (kv_dtype == "int8")


# ---- scheduler hooks of the paged engine ------------------------------------


def test_admission_gate_veto_preserves_drr_credit():
    """A block-watermark veto must not charge the selected class's
    deficit-round-robin credit: repeated vetoes under pool pressure
    would otherwise invert the configured class weights."""
    classes = (SloClass("interactive", weight=3.0),
               SloClass("batch", weight=1.0))
    sch = Scheduler(slots=4, max_len=64, prefill_chunk=8,
                    slo_classes=classes)
    for _ in range(4):
        sch.submit(np.zeros(4, np.int32), 4, slo_class="interactive")
        sch.submit(np.zeros(4, np.int32), 4, slo_class="batch")
    vetoes = {"n": 0}

    def gate(req):
        vetoes["n"] += 1
        return False

    sch.admission_gate = gate
    for _ in range(5):
        assert sch.admit(now=1.0) == []
    assert vetoes["n"] == 5
    sch.admission_gate = None
    admitted = sch.admit(now=2.0)
    # The weighted-fair ratio survives the vetoed rounds untilted.
    assert [r.slo_class for r in admitted] == [
        "interactive", "interactive", "interactive", "batch",
    ]


def test_admission_gate_veto_keeps_the_single_class_queue_head():
    sch = Scheduler(slots=2, max_len=64, prefill_chunk=8)
    reqs = [sch.submit(np.zeros(4, np.int32), 4) for _ in range(2)]
    sch.admission_gate = lambda req: False
    assert sch.admit(now=1.0) == []
    assert list(sch.queue) == reqs
    # An expired head is shed even while the gate vetoes.
    doomed = sch.submit(np.zeros(4, np.int32), 4, now=1.0, deadline_s=1.0)
    sch.queue.rotate(1)
    assert sch.admit(now=9.0) == []
    assert [r.rid for r in sch.drain_admission_shed()] == [doomed.rid]


def test_scheduler_preempt_requeues_at_the_front_without_budget():
    sch = Scheduler(slots=2, max_len=64, prefill_chunk=8)
    a, b = (sch.submit(np.zeros(4, np.int32), 4) for _ in range(2))
    waiting = sch.submit(np.zeros(4, np.int32), 4)
    sch.admit(now=1.0)
    b.prefill_pos, b.tokens, b.prefix_hit_blocks = 4, [1, 2], 1
    sch.preempt(b)
    assert b.state == "queued" and b.slot == -1
    assert (b.prefill_pos, b.tokens, b.prefix_hit_blocks) == (0, [], 0)
    assert b.preemptions == 1 and b.requeues == 0
    assert list(sch.queue) == [b, waiting]
    assert sch.active() == [a]


def test_can_admit_watermark_counts_cache_as_free(tiny):
    """The gate admits against free + evictable-cache blocks, and a
    request that was preempted re-admits against its whole worst case."""
    cfg, params, _, _ = tiny
    eng = paged(cfg, params, slots=2, max_len=32, prefill_chunk=8,
                block_size=8, num_blocks=5)
    (p,) = make_prompts(cfg, (17,), seed=3)
    eng.submit(p, 2)
    eng.run_until_idle()
    stats = eng.kv_stats()
    assert (stats["free"], stats["cached"]) == (2, 2)
    sch = Scheduler(slots=1, max_len=32, prefill_chunk=8)
    fits = sch.submit(np.zeros(24, np.int32), 7)      # 25 rows: 4 blocks
    assert eng._can_admit(fits)
    fits.preemptions = 1                              # 31 rows: 4 blocks
    assert eng._can_admit(fits)
    over = sch.submit(np.zeros(31, np.int32), 1)      # 32 rows: 4 blocks
    assert eng._can_admit(over)
    eng._slot_blocks[0] = eng._allocator.alloc(1)     # a live slot's block
    assert not eng._can_admit(over)


# ---- metrics wiring ---------------------------------------------------------


def test_kv_metrics_land_in_registry(tiny):
    cfg, params, _, _ = tiny
    reg = MetricsRegistry()
    eng = paged(cfg, params, slots=2, max_len=32, prefill_chunk=4,
                block_size=8, registry=reg)
    eng.warmup()
    (prompt,) = make_prompts(cfg, (17,), seed=3)
    eng.submit(prompt, 3)
    eng.run_until_idle()
    eng.submit(prompt, 3)
    eng.run_until_idle()
    assert reg.get("serving_kv_blocks_total").value() == eng.num_blocks - 1
    blocks = reg.get("serving_kv_blocks")
    assert blocks.value(state="used") == 0
    assert blocks.value(state="cached") == 2
    assert blocks.value(state="free") == eng.num_blocks - 3
    assert reg.get("serving_kv_bytes_in_use").value() == (
        2 * eng._block_bytes
    )
    lookups = reg.get("serving_prefix_lookups_total")
    assert lookups.value(outcome="miss") == 1
    assert lookups.value(outcome="hit") == 1
    assert reg.get("serving_prefix_hit_blocks_total").value() == 2
    assert reg.get("serving_kv_cow_copies_total").value() == (
        eng.kv_stats()["cow_copies"]
    )
    assert reg.get("serving_kv_preemptions_total").value() == 0


def test_preemption_metrics_count_the_wasted_tokens(tiny):
    cfg, params, _, _ = tiny
    reg = MetricsRegistry()
    eng = paged(cfg, params, slots=4, max_len=32, prefill_chunk=8,
                block_size=8, num_blocks=10, prefix_cache=False,
                registry=reg)
    for p in make_prompts(cfg, (12, 12, 12, 12), seed=7):
        eng.submit(p, 16)
    eng.run_until_idle()
    n = reg.get("serving_kv_preemptions_total").value()
    assert n >= 1
    assert reg.get("serving_requests_total").value(
        outcome="preempted") == n
    wasted = reg.get("serving_tokens_wasted_total")
    assert wasted.value(kind="prefill") >= 12 * n
    assert wasted.value(kind="decode") >= n


# ---- int8 pool --------------------------------------------------------------


def test_quantize_round_trip_is_exact_in_f32():
    """The int8 prefill rests on this: dequantizing to f32 and
    quantizing again returns the stored values AND scales bit for bit
    (the amax element maps to +-127, and q * scale is exact in f32)."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(
        (rs.randn(4096, 16) * np.exp(rs.randn(4096, 1) * 3)).astype(
            np.float32))
    x[7] = 0.0                                     # an all-zero row
    q, scale = quantize_kv(x)
    q2, scale2 = quantize_kv(dequantize_kv(q, scale))
    assert torch.equal(q2, q)
    assert torch.equal(scale2, scale)


def test_int8_prefill_keeps_untouched_rows_bit_stable(tiny):
    """chunk 8 inside block 16: the second chunk's scatter-back rewrites
    the whole block, rows 0-7 included, through the f32 round trip; they
    must come back bit-identical."""
    cfg, params, _, _ = tiny
    eng = paged(cfg, params, slots=1, max_len=32, prefill_chunk=8,
                block_size=16, kv_cache_dtype="int8", prefix_cache=False)
    (prompt,) = make_prompts(cfg, (13,), seed=17)
    req = eng.submit(prompt, 2)
    eng.step()
    assert req.prefill_pos == 8
    (blk,) = eng._slot_blocks[req.slot]
    pools = (eng._k, eng._v, eng._kscale, eng._vscale)
    before = [p[:, blk, :8].clone() for p in pools]
    assert before[0].any() and before[2].any()
    eng.step()
    assert req.prefill_pos == 13
    for pool, want in zip(pools, before):
        assert torch.equal(pool[:, blk, :8], want)
    assert eng._k[:, blk, 8:13].any()


def test_int8_paged_engine_matches_int8_generate(tiny):
    """Admissions, prefix hits and COW over the int8 pool: every
    request's greedy tokens equal the port's int8 ``generate()`` (both
    append the quantized row, then read it back)."""
    cfg, params, _, _ = tiny
    rs = np.random.RandomState(0)
    shared = rs.randint(0, cfg.vocab_size, size=16).tolist()
    prompts = [
        rs.randint(0, cfg.vocab_size, size=n).tolist() for n in (9, 17)
    ] + [shared + rs.randint(0, cfg.vocab_size, size=5).tolist(),
         shared + rs.randint(0, cfg.vocab_size, size=7).tolist()]
    eng = paged(cfg, params, slots=4, max_len=64, prefill_chunk=16,
                block_size=8, num_blocks=40, kv_cache_dtype="int8")
    eng.warmup()
    for p in prompts:
        eng.submit(p, max_new_tokens=8)
    done = eng.run_until_idle()
    eng.check_block_invariants()
    assert len(done) == len(prompts)
    for r in sorted(done, key=lambda r: r.rid):
        ref = gen.generate(
            cfg, params, np.asarray([r.prompt], np.int32), 8,
            kv_cache_dtype="int8", device="cpu",
        )
        assert r.tokens == ref.tokens[0].tolist(), (
            f"rid {r.rid} diverged from int8 generate"
        )


# ---- the engine against the JAX package's paged engine ----------------------


_STAT_KEYS = ("total", "free", "used", "cached", "cow_copies",
              "prefix_entries", "prefix_hits", "prefix_misses",
              "prefix_hit_blocks", "prefix_hit_rate", "bytes_in_use")


def _workload(cfg):
    """Prompts that miss, hit a shared 16-token prefix, repeat in full
    (COW) and outgrow a block while decoding."""
    rs = np.random.RandomState(42)
    shared = rs.randint(0, cfg.vocab_size, size=16)
    tail = lambda n: rs.randint(0, cfg.vocab_size, size=n)  # noqa: E731
    prompts = [
        np.concatenate([shared, tail(5)]), tail(9),
        np.concatenate([shared, tail(7)]), np.concatenate([shared]),
        np.concatenate([shared]), tail(23),
    ]
    return [p.astype(np.int32) for p in prompts], (7, 5, 9, 4, 6, 8)


def test_paged_engine_matches_jax_paged_engine_request_by_request(tiny):
    """Same prompts, one request at a time: equal greedy tokens, and
    equal block accounting and prefix-hit counts after each request."""
    cfg, params, jcfg, jparams = tiny
    # chunk 4 inside block 8: the full repeats resume at row 12, inside
    # the shared second block, and must copy it before writing.
    kw = dict(slots=2, max_len=48, prefill_chunk=4, block_size=8)
    jeng = JaxPagedServingEngine(jcfg, jparams, **kw)
    eng = paged(cfg, params, **kw)
    prompts, news = _workload(cfg)
    for prompt, n in zip(prompts, news):
        want = jeng.submit(prompt, n)
        got = eng.submit(prompt, n)
        jeng.run_until_idle()
        eng.run_until_idle()
        assert got.tokens == want.tokens
        assert got.prefix_hit_blocks == want.prefix_hit_blocks
        jstats, stats = jeng.kv_stats(), eng.kv_stats()
        assert {k: stats[k] for k in _STAT_KEYS} == {
            k: jstats[k] for k in _STAT_KEYS
        }
    assert eng.kv_stats()["prefix_hits"] >= 3
    assert eng.kv_stats()["cow_copies"] >= 1
    eng.check_block_invariants()


def test_paged_engine_matches_jax_paged_engine_under_pressure(tiny):
    """All requests at once over a pool that forces cache eviction and
    preemption: the two engines take the same decisions step by step
    (same tokens, preemptions, hits and final accounting)."""
    cfg, params, jcfg, jparams = tiny
    kw = dict(slots=3, max_len=48, prefill_chunk=8, block_size=8,
              num_blocks=9)
    jeng = JaxPagedServingEngine(jcfg, jparams, **kw)
    eng = paged(cfg, params, **kw)
    prompts, news = _workload(cfg)
    want = [jeng.submit(p, n) for p, n in zip(prompts, news)]
    got = [eng.submit(p, n) for p, n in zip(prompts, news)]
    while jeng.pending() or eng.pending():
        jeng.step()
        eng.step()
        assert eng.kv_stats()["used"] == jeng.kv_stats()["used"]
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert g.preemptions == w.preemptions
        assert g.prefix_hit_blocks == w.prefix_hit_blocks
    assert sum(g.preemptions for g in got) >= 1
    jstats, stats = jeng.kv_stats(), eng.kv_stats()
    assert {k: stats[k] for k in _STAT_KEYS} == {
        k: jstats[k] for k in _STAT_KEYS
    }
    eng.check_block_invariants()


def test_int8_paged_engines_stay_within_the_pinned_logit_distance(tiny):
    """The JAX int8 engine keeps the new token's K/V at full precision
    in its own step; the port reads it back quantized. Neither is held
    to the other's tokens: every token either chose lies within
    INT8_LOGIT_BOUND of the teacher-forced f32 maximum, and the
    bookkeeping (which sees no values) is equal."""
    cfg, params, jcfg, jparams = tiny
    kw = dict(slots=2, max_len=48, prefill_chunk=8, block_size=8,
              kv_cache_dtype="int8")
    jeng = JaxPagedServingEngine(jcfg, jparams, **kw)
    eng = paged(cfg, params, **kw)
    prompts, news = _workload(cfg)
    want = [jeng.submit(p, n) for p, n in zip(prompts, news)]
    got = [eng.submit(p, n) for p, n in zip(prompts, news)]
    jeng.run_until_idle()
    eng.run_until_idle()
    for reqs in (got, want):
        for r in reqs:
            assert len(r.tokens) == r.max_new_tokens
            seq = torch.from_numpy(np.concatenate(
                [r.prompt, np.asarray(r.tokens, np.int32)]
            ).astype(np.int64))[None]
            logits, _ = llama.forward(cfg, params, seq)
            pred = logits[0, r.prompt_len - 1:-1]
            chosen = pred[torch.arange(len(r.tokens)), r.tokens]
            gap = float((pred.max(dim=-1).values - chosen).max())
            assert gap <= INT8_LOGIT_BOUND, f"rid {r.rid}: gap {gap}"
    jstats, stats = jeng.kv_stats(), eng.kv_stats()
    assert {k: stats[k] for k in _STAT_KEYS} == {
        k: jstats[k] for k in _STAT_KEYS
    }
