"""The port's continuous-batching engine (ported from
``tests/test_serving.py``): ragged batched decode through the
decode-attention route must equal each sequence's teacher-forced greedy
loop EXACTLY (tiny f32 config; the decode kernel's plain version runs
on the CPU), a recycled slot must not leak the previous occupant's KV,
truncation at cache capacity, the scheduler's budget and drain rules,
and the metrics landing in the port's registry. JAX params (from
``dlrover_tpu.models.llama.init_params``) cross with
``params_from_numpy``; the oracle is the port's forward, which
``test_torch_model.py`` holds to the JAX forward."""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import numpy as np
import pytest
import torch

import jax

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.observability.registry import MetricsRegistry
from dlrover_tpu_torch.serving import (
    DECODE,
    PREFILL,
    Scheduler,
    ServingEngine,
)


@pytest.fixture(scope="module")
def tiny():
    jparams, _ = jax_llama.init_params(
        jax_llama.tiny_config(), jax.random.key(0)
    )
    params = convert.params_from_numpy(jax.device_get(jparams), "cpu")
    return llama.tiny_config(), params


def engine(cfg, params, **kw):
    kw.setdefault("registry", MetricsRegistry())
    return ServingEngine(cfg, params, device="cpu", **kw)


def naive_greedy(cfg, params, prompt: np.ndarray, max_new: int):
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


def test_ragged_decode_matches_teacher_forced(tiny):
    """Three requests over TWO slots (slot reuse), admissions staggered
    mid-decode so the batch is genuinely ragged, multi-chunk prefill
    (chunk 4 < prompt lens)."""
    cfg, params = tiny
    eng = engine(cfg, params, slots=2, max_len=32, prefill_chunk=4)
    eng.warmup()
    prompts = make_prompts(cfg, (5, 3, 9), seed=1)
    plans = list(zip(prompts, (6, 5, 4)))

    reqs = [eng.submit(prompts[0], 6)]
    for _ in range(4):
        eng.step()
    reqs.append(eng.submit(prompts[1], 5))
    reqs.append(eng.submit(prompts[2], 4))
    eng.run_until_idle()

    for req, (prompt, max_new) in zip(reqs, plans):
        assert req.state == "done"
        assert not req.truncated
        assert req.tokens == naive_greedy(cfg, params, prompt, max_new), (
            f"rid {req.rid}"
        )


def test_recycled_slot_does_not_leak_kv(tiny):
    cfg, params = tiny
    eng = engine(cfg, params, slots=1, max_len=32, prefill_chunk=8)
    eng.warmup()
    long_p, short_p = make_prompts(cfg, (12, 3), seed=2)
    r_long = eng.submit(long_p, 12)
    eng.run_until_idle()
    assert r_long.state == "done" and len(r_long.tokens) == 12
    r_short = eng.submit(short_p, 6)
    eng.run_until_idle()
    assert r_short.tokens == naive_greedy(cfg, params, short_p, 6)


def test_engine_rejects_non_chunk_divisible_max_len(tiny):
    cfg, params = tiny
    with pytest.raises(ValueError, match="multiple of"):
        engine(cfg, params, slots=1, max_len=40, prefill_chunk=16)


def test_truncation_at_cache_capacity(tiny):
    cfg, params = tiny
    eng = engine(cfg, params, slots=1, max_len=16, prefill_chunk=8)
    eng.warmup()
    (prompt,) = make_prompts(cfg, (10,), seed=4)
    req = eng.submit(prompt, 50)
    eng.run_until_idle()
    assert req.truncated
    # fill never exceeds max_len: prompt(10) + fed-back tokens.
    assert len(req.tokens) == eng.max_len - len(prompt) + 1
    assert req.tokens == naive_greedy(cfg, params, prompt, len(req.tokens))
    (p2,) = make_prompts(cfg, (3,), seed=5)
    r2 = eng.submit(p2, 4)
    eng.run_until_idle()
    assert r2.tokens == naive_greedy(cfg, params, p2, 4)


def test_sampled_requests_deterministic_per_engine_generator(tiny):
    cfg, params = tiny

    def run(seed):
        eng = engine(cfg, params, slots=2, max_len=32, prefill_chunk=4,
                     generator=torch.Generator().manual_seed(seed))
        eng.warmup()
        (p1, p2) = make_prompts(cfg, (4, 6), seed=6)
        r1 = eng.submit(p1, 6, temperature=1.0)
        r2 = eng.submit(p2, 6, temperature=1.0)
        eng.run_until_idle()
        return r1.tokens, r2.tokens

    a = run(7)
    assert a == run(7)
    assert a != run(8)


def test_cancel_recycles_slot(tiny):
    cfg, params = tiny
    eng = engine(cfg, params, slots=1, max_len=32, prefill_chunk=4)
    p1, p2 = make_prompts(cfg, (6, 3), seed=9)
    r1 = eng.submit(p1, 20)
    eng.step()
    eng.cancel(r1)
    assert r1.state == "done" and eng.pending() == 0
    r2 = eng.submit(p2, 5)
    eng.run_until_idle()
    assert r2.tokens == naive_greedy(cfg, params, p2, 5)


def test_step_error_requeues_then_fails_explicitly(tiny, monkeypatch):
    """A raising step rebuilds the pool and re-queues in-flight work; a
    request that keeps landing in raising steps fails after
    ``max_requeues`` restarts, and every error is counted."""
    cfg, params = tiny
    reg = MetricsRegistry()
    eng = engine(cfg, params, slots=1, max_len=32, prefill_chunk=4,
                 registry=reg, max_requeues=1)
    (p,) = make_prompts(cfg, (5,), seed=10)

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(eng, "_prefill", boom)
    req = eng.submit(p, 3)
    eng.run_until_idle()
    assert req.failed and req.failure_reason == "requeue_budget"
    assert req.requeues == 2
    assert reg.get("serving_step_errors_total").value() == 2


# ---- scheduler unit behavior ------------------------------------------------


def test_scheduler_budget_gates_prefill():
    sch = Scheduler(slots=4, max_len=64, prefill_chunk=8,
                    token_budget=10)
    for plen in (8, 8, 8):
        sch.submit(np.zeros(plen, np.int32), 4)
    sch.admit()
    reqs = sch.active()
    reqs[0].state = DECODE
    reqs[1].state = DECODE
    assert sch.pick_prefill() is reqs[2]
    assert reqs[2].state == PREFILL
    reqs[2].state = DECODE
    sch.submit(np.zeros(4, np.int32), 4)
    sch.admit()
    assert sch.pick_prefill() is None


def test_scheduler_drain_mode_admits_only_empty():
    sch = Scheduler(slots=2, max_len=64, prefill_chunk=8,
                    drain_mode=True)
    for _ in range(3):
        sch.submit(np.zeros(4, np.int32), 4)
    first = sch.admit()
    assert len(first) == 2 and not sch.admit()
    sch.finish(first[0])
    assert not sch.admit()
    sch.finish(first[1])
    assert len(sch.admit()) == 1


def test_scheduler_rejects_prompt_without_decode_room():
    sch = Scheduler(slots=1, max_len=8, prefill_chunk=4)
    with pytest.raises(ValueError, match="decode room"):
        sch.submit(np.zeros(8, np.int32), 1)


# ---- metrics wiring ---------------------------------------------------------


def test_serving_metrics_land_in_registry(tiny):
    cfg, params = tiny
    reg = MetricsRegistry()
    eng = engine(cfg, params, slots=2, max_len=32, prefill_chunk=4,
                 registry=reg)
    eng.warmup()
    prompts = make_prompts(cfg, (5, 3), seed=11)
    for p in prompts:
        eng.submit(p, 4)
    eng.run_until_idle()
    tokens = reg.get("serving_tokens_total")
    assert tokens.value(kind="prefill") == 8
    assert tokens.value(kind="decode") == 8
    assert reg.get("serving_requests_total").value(
        outcome="finished") == 2
    assert reg.get("serving_requests_total").value(
        outcome="admitted") == 2
    assert reg.get("serving_ttft_seconds").count() == 2
    assert reg.get("serving_token_latency_seconds").count() == 6
    assert reg.get("serving_slots_total").value() == 2
    assert reg.get("serving_active_slots").value() == 0
    assert reg.get("serving_step_errors_total").value() == 0
