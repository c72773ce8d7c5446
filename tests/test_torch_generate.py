"""The port's KV-cache decoding against the JAX package's on
``tiny_config`` (f32): greedy tokens identical to JAX ``generate`` with
fp and int8 caches, cached logits equal to the teacher-forced forward,
and sampling reproducible per ``torch.Generator`` seed.

The JAX side runs with ``DLROVER_TPU_DECODE_ATTN=pallas``: its
single-token step then appends the new K/V and calls the Pallas
decode-attention kernel (interpret mode on the CPU), the route the port
takes. Under its default append-free step an int8 cache would attend to
the new token's own K/V unquantized, which the port never does."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlrover_tpu.models import generate as jax_gen
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models import generate as gen
from dlrover_tpu_torch.models import llama

# f32 logits through the cache vs the full forward: same math, other
# summation order (and a masked softmax over the padded cache).
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_llama.tiny_config()
    jparams, _ = jax_llama.init_params(jcfg, jax.random.key(0))
    jparams = jax.device_get(jparams)
    return jcfg, jparams, convert.params_from_numpy(jparams, "cpu")


def _prompt(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.int32
    )


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_greedy_tokens_match_jax_generate(tiny, monkeypatch, kv_dtype):
    jcfg, jparams, params = tiny
    monkeypatch.setenv("DLROVER_TPU_DECODE_ATTN", "pallas")
    prompt = _prompt(3, (2, 6))
    # prompt + new = 16 rows: a multiple of the JAX kernel's block.
    want = jax_gen.generate(
        jcfg, jparams, jnp.asarray(prompt), max_new_tokens=10,
        kv_cache_dtype=kv_dtype,
    ).tokens
    got = gen.generate(
        llama.tiny_config(), params, prompt, 10, kv_cache_dtype=kv_dtype,
        device="cpu",
    )
    assert got.tokens.dtype == torch.int32
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want))
    assert got.cache.length.tolist() == [15, 15]


def test_prefill_logits_match_forward(tiny):
    _, _, params = tiny
    cfg = llama.tiny_config()
    prompt = torch.from_numpy(_prompt(1, (2, 7)))
    dparams = gen.prepare_decode_params(cfg, params, "cpu")
    cache = gen.init_cache(cfg, 2, 16, device="cpu")
    logits, cache = gen._forward_with_cache(cfg, dparams, prompt, cache)
    full, _ = llama.forward(cfg, params, prompt)
    np.testing.assert_allclose(
        logits.numpy(), full[:, -1, :].numpy(), **TOL
    )
    assert cache.length.tolist() == [7, 7]


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_incremental_decode_matches_forward(tiny, kv_dtype):
    """Token-by-token cached logits (the decode-attention route) equal
    the full re-forward's. int8 caches quantize K/V, so their logits
    only track the forward to the quantization error (amax/254 per
    element)."""
    _, _, params = tiny
    cfg = llama.tiny_config()
    tokens = torch.from_numpy(_prompt(2, (1, 6)))
    dparams = gen.prepare_decode_params(cfg, params, "cpu")
    cache = gen.init_cache(cfg, 1, 8, kv_dtype=kv_dtype, device="cpu")
    full, _ = llama.forward(cfg, params, tokens)
    tol = TOL if kv_dtype == "fp" else dict(rtol=0, atol=5e-2)
    for i in range(6):
        logits, cache = gen._forward_with_cache(
            cfg, dparams, tokens[:, i:i + 1], cache, i
        )
        np.testing.assert_allclose(
            logits.numpy(), full[:, i, :].numpy(), err_msg=f"pos {i}",
            **tol,
        )


def test_sampled_generate_reproducible_per_generator_seed(tiny):
    _, _, params = tiny
    cfg = llama.tiny_config()
    prompt = np.zeros((2, 3), np.int32)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return gen.generate(
            cfg, params, prompt, 8, temperature=1.0, generator=g,
            device="cpu",
        ).tokens.numpy()

    a = run(7)
    np.testing.assert_array_equal(a, run(7))
    assert not np.array_equal(a, run(8))


def test_generate_argument_checks(tiny):
    _, _, params = tiny
    cfg = llama.tiny_config()
    prompt = np.zeros((1, 3), np.int32)
    with pytest.raises(ValueError, match="generator"):
        gen.generate(cfg, params, prompt, 2, temperature=0.5,
                     device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        gen.generate(cfg, params, prompt, 4, max_len=5, device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        gen.init_cache(cfg, 1, 8, kv_dtype="fp8", device="cpu")


def test_cuda_device_without_a_card_raises(tiny, monkeypatch):
    """No silent CPU path: asking for the card where torch sees none
    raises before any work."""
    _, _, params = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen.generate(llama.tiny_config(), params,
                     np.zeros((1, 3), np.int32), 2, device="cuda")


def test_sample_token_greedy_rows_take_raw_argmax():
    logits = torch.tensor([[0.0, 3.0, 1.0], [2.0, 0.0, 1.0]])
    g = torch.Generator().manual_seed(0)
    out = gen.sample_token(logits, np.array([0.0, 0.0], np.float32), g)
    assert out.tolist() == [1, 0]
    # A sampled row among greedy ones: the greedy row stays the argmax.
    out = gen.sample_token(logits, np.array([0.0, 5.0], np.float32), g)
    assert out[0].item() == 1
