"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; each test skips where torch sees no CUDA device
(the kernels are built by nvcc at first use). On a GPU machine without
JAX, run them with the repository conftest left out:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: bf16 outputs within 1e-2 + 1e-2 * |ref| (the kernel and the
plain version round the same f32 result to bf16, from sums taken in
another order); f32 outputs within 2e-5."""

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.models import generate as gen
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops import decode_attention as da
from dlrover_tpu_torch.ops.kv_quant import quantize_kv
from dlrover_tpu_torch.serving import ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _tol(dtype):
    if dtype == torch.bfloat16:
        return dict(rtol=1e-2, atol=1e-2)
    return dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("h,kh,d", [(8, 8, 128), (32, 8, 128),
                                    (8, 2, 64), (4, 2, 16), (40, 2, 32)])
def test_kernel_matches_plain_version(cuda, dtype, kv, h, kh, d):
    g = torch.Generator(cuda).manual_seed(h * 7 + d)
    b, S = 5, 300
    q = torch.randn(b, h, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, S, kh, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, S, kh, d, generator=g, device=cuda).to(dtype)
    lens = torch.tensor([0, 1, 77, 128, S], dtype=torch.int32,
                        device=cuda)
    scales = ()
    if kv == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        scales = (ks, vs)
    before = dict(da.launch_counts)
    got = da.decode_attention(q, k, v, lens, *scales)
    torch.cuda.synchronize()
    want = da.decode_attention_reference(q, k, v, lens, *scales)
    torch.testing.assert_close(got, want, **_tol(dtype))
    assert torch.all(got[0] == 0)
    name = f"decode_attention_{kv}"
    assert da.launch_counts[name] == before[name] + 1


def test_scalar_length_and_overlong_fill(cuda):
    g = torch.Generator(cuda).manual_seed(1)
    q = torch.randn(3, 8, 128, generator=g, device=cuda).bfloat16()
    k = torch.randn(3, 64, 4, 128, generator=g, device=cuda).bfloat16()
    v = torch.randn(3, 64, 4, 128, generator=g, device=cuda).bfloat16()
    a = da.decode_attention(q, k, v, 40)
    b = da.decode_attention(
        q, k, v, torch.full((3,), 40, dtype=torch.int32, device=cuda)
    )
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    over = da.decode_attention(q, k, v, 1000)
    full = da.decode_attention_reference(q, k, v, 64)
    torch.testing.assert_close(over, full, **_tol(torch.bfloat16))


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(2, 4, 128, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(2, 16, 2, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                            k, k, 3)
    with pytest.raises(TypeError):
        da.decode_attention(q, k.float(), k.float(), 3)
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_attention(q[..., :24].contiguous(),
                            k[..., :24].contiguous(),
                            k[..., :24].contiguous(), 3)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_generate_on_card_matches_cpu(cuda, kv_dtype):
    """tiny f32 config: greedy tokens through the kernel equal those
    through its plain version on the CPU."""
    cfg = llama.tiny_config()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    prompt = np.random.RandomState(0).randint(0, 256, (3, 7))
    want = gen.generate(cfg, params, prompt, 12, kv_cache_dtype=kv_dtype,
                        device="cpu").tokens
    got = gen.generate(cfg, params, prompt, 12, kv_cache_dtype=kv_dtype,
                       device=cuda).tokens
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_engine_on_card_matches_cpu(cuda):
    cfg = llama.tiny_config()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    prompts = [np.random.RandomState(i).randint(0, 256, n)
               for i, n in enumerate((5, 9, 3))]

    def serve(device):
        eng = ServingEngine(cfg, params, slots=2, max_len=32,
                            prefill_chunk=4, device=device)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run_until_idle()
        return [r.tokens for r in reqs]

    assert serve(cuda) == serve("cpu")
