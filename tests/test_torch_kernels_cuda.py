"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; each test skips where torch sees no CUDA device
(the kernels are built by nvcc at first use). On a GPU machine without
JAX, run them with the repository conftest left out:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: bf16 outputs within 1e-2 + 1e-2 * |ref| (the kernel and the
plain version round the same f32 result to bf16, from sums taken in
another order); f32 outputs within 2e-5. Flash attention: lse (f32)
within 1e-3; gradients within 1e-2 * max|ref| + 1e-6 (dS is rounded to bf16
before the dq/dk products in both, from dP sums taken in another order,
so a few elements round the other way). Fused cross-entropy: per_tok and
logz (f32) within rtol 1e-5; dx and dw elementwise (see _ce_ratio); the
MoE weight gradients the same way. The dw kernels (B4 dw, B8 dw_gu and
dw_down) sum in a fixed order with one owner per element: a rerun gives
the same bits."""

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.models import generate as gen
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops import decode_attention as da
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops.kv_quant import quantize_kv
from dlrover_tpu_torch.serving import PagedServingEngine, ServingEngine

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


def _paged_inputs(device, dtype, kv, h, kh, d, bs, mb, lengths, seed):
    """q, noise-filled pools twice the batch's need, a shuffled table
    whose entries past each row's fill name another row's blocks."""
    g = torch.Generator(device).manual_seed(seed)
    b = len(lengths)
    nb = 2 * b * mb + 1
    q = torch.randn(b, h, d, generator=g, device=device).to(dtype)
    k = torch.randn(nb, bs, kh, d, generator=g, device=device).to(dtype)
    v = torch.randn(nb, bs, kh, d, generator=g, device=device).to(dtype)
    tables = (torch.randperm(nb - 1, generator=g, device=device)[:b * mb]
              + 1).reshape(b, mb).int()
    for i, n in enumerate(lengths):
        used = -(-min(n, bs * mb) // bs)
        tables[i, used:] = tables[(i + 1) % b, :mb - used].flip(0)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    scales = ()
    if kv == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        scales = (ks, vs)
    return q, k, v, tables.contiguous(), lens, scales


def _paged_faults(q, k, v, tables, lens, scales):
    """What two broken paged kernels would return, from the plain
    version: one that ignores the table (reads the pool as if row i's
    blocks were i * max_blocks + j), one that drops each row's last,
    partly filled block."""
    b, mb = tables.shape
    bs = k.shape[1]
    identity = torch.arange(b * mb, dtype=torch.int32,
                            device=q.device).reshape(b, mb)
    no_table = da.paged_decode_attention_reference(q, k, v, identity, lens,
                                                   *scales)
    short = da.paged_decode_attention_reference(
        q, k, v, tables, lens - lens % bs, *scales)
    return {"ignores_table": no_table, "drops_last_block": short}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("h,kh,d,bs", [
    (8, 8, 128, 16), (32, 8, 128, 16), (8, 8, 128, 32), (8, 8, 128, 128),
    (8, 2, 64, 8), (4, 2, 16, 1), (40, 2, 32, 24),
])
def test_paged_kernel_matches_plain_version(cuda, dtype, kv, h, kh, d, bs):
    mb = max(2, 320 // bs)
    cap = bs * mb
    lengths = [0, 1, bs - 1, bs, bs + 1, 77 % cap, cap]
    q, k, v, tables, lens, scales = _paged_inputs(
        cuda, dtype, kv, h, kh, d, bs, mb, lengths, seed=h * 7 + d + bs)
    before = dict(da.launch_counts)
    got = da.paged_decode_attention(q, k, v, tables, lens, *scales)
    torch.cuda.synchronize()
    want = da.paged_decode_attention_reference(q, k, v, tables, lens,
                                               *scales)
    torch.testing.assert_close(got, want, **_tol(dtype))
    assert torch.all(got[0] == 0)
    name = f"paged_decode_attention_{kv}"
    assert da.launch_counts[name] == before[name] + 1
    for fault, out in _paged_faults(q, k, v, tables, lens, scales).items():
        if fault == "drops_last_block" and bs == 1:
            continue  # no block is ever partly filled
        with pytest.raises(AssertionError):
            torch.testing.assert_close(out, want, **_tol(dtype))


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_paged_kernel_through_an_identity_table_is_the_flat_kernel(cuda, kv):
    """The two kernels share their body: the same rows in the same
    order give the same bits."""
    g = torch.Generator(cuda).manual_seed(5)
    b, S, h, kh, d, bs = 4, 256, 8, 8, 128, 16
    q = torch.randn(b, h, d, generator=g, device=cuda).bfloat16()
    k = torch.randn(b, S, kh, d, generator=g, device=cuda).bfloat16()
    v = torch.randn(b, S, kh, d, generator=g, device=cuda).bfloat16()
    lens = torch.tensor([0, 17, 200, S], dtype=torch.int32, device=cuda)
    scales = ()
    if kv == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        scales = (ks, vs)
    flat = da.decode_attention(q, k, v, lens, *scales)
    tables = torch.arange(b * S // bs, dtype=torch.int32,
                          device=cuda).reshape(b, S // bs)
    pool = lambda t: t.reshape(b * S // bs, bs, *t.shape[2:])  # noqa: E731
    paged = da.paged_decode_attention(
        q, pool(k), pool(v), tables, lens, *(pool(s) for s in scales))
    torch.testing.assert_close(paged, flat, rtol=0, atol=0)


def _split_edge_lengths(b, h, kh, max_len):
    """Fills on every edge of the kernel's split-K partition of max_len:
    0, 1, split - 1, split, split + 1, max_len, then one more row."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split, n_splits = da.split_plan(b, h, kh, max_len, sms)
    assert n_splits > 1
    return [0, 1, split - 1, split, split + 1, max_len, split // 2][:b]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("h,kh,d", [(8, 2, 128), (40, 2, 32)])
def test_kernel_at_split_edges_reruns_bitwise(cuda, dtype, kv, h, kh, d):
    """B5 at fills on every split edge, GQA groups of 4 and 20 (blockIdx.z
    splits the latter 8 + 8 + 4): within the plain version's tolerance,
    the fill-0 row zero, and two calls give the same bits (the partials
    are combined in split order)."""
    b, max_len = 7, 1500
    lengths = _split_edge_lengths(b, h, kh, max_len)
    g = torch.Generator(cuda).manual_seed(h + d)
    q = torch.randn(b, h, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, max_len, kh, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, max_len, kh, d, generator=g, device=cuda).to(dtype)
    scales = ()
    if kv == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        scales = (ks, vs)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = da.decode_attention(q, k, v, lens, *scales)
    again = da.decode_attention(q, k, v, lens, *scales)
    torch.cuda.synchronize()
    want = da.decode_attention_reference(q, k, v, lens, *scales)
    torch.testing.assert_close(got, want, **_tol(dtype))
    assert torch.all(got[0] == 0)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("h,kh,d,bs", [(8, 2, 128, 16), (40, 2, 32, 24)])
def test_paged_kernel_at_split_edges_reruns_bitwise(cuda, dtype, kv, h, kh,
                                                    d, bs):
    """B6 at fills on every split edge, through a shuffled table with
    stale entries past each fill: within the plain version's tolerance,
    the fill-0 row zero, two calls bitwise equal, and through an identity
    table bitwise equal to B5 (one body)."""
    b, mb = 7, 64
    lengths = _split_edge_lengths(b, h, kh, bs * mb)
    q, k, v, tables, lens, scales = _paged_inputs(
        cuda, dtype, kv, h, kh, d, bs, mb, lengths, seed=d + bs)
    got = da.paged_decode_attention(q, k, v, tables, lens, *scales)
    again = da.paged_decode_attention(q, k, v, tables, lens, *scales)
    torch.cuda.synchronize()
    want = da.paged_decode_attention_reference(q, k, v, tables, lens,
                                               *scales)
    torch.testing.assert_close(got, want, **_tol(dtype))
    assert torch.all(got[0] == 0)
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    logical = lambda t: da._logical_view(t, tables).contiguous()  # noqa: E731
    flat = da.decode_attention(q, logical(k), logical(v), lens,
                               *(logical(sc) for sc in scales))
    identity = torch.arange(b * mb, dtype=torch.int32,
                            device=cuda).reshape(b, mb)
    pool = lambda t: t.reshape(b * mb, bs, *t.shape[2:])  # noqa: E731
    paged = da.paged_decode_attention(
        q, pool(logical(k)), pool(logical(v)), identity, lens,
        *(pool(logical(sc)) for sc in scales))
    torch.testing.assert_close(paged, flat, rtol=0, atol=0)


def test_paged_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(2, 4, 128, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(9, 16, 2, 128, device=cuda, dtype=torch.bfloat16)
    tables = torch.zeros(2, 4, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        da.paged_decode_attention(q, k, k, tables.long(), 3)
    with pytest.raises(ValueError, match="tables"):
        da.paged_decode_attention(q, k, k, tables[:1], 3)
    with pytest.raises(TypeError):
        da.paged_decode_attention(q, k.float(), k.float(), tables, 3)
    with pytest.raises(ValueError, match="head_dim"):
        da.paged_decode_attention(q[..., :24].contiguous(),
                                  k[..., :24].contiguous(),
                                  k[..., :24].contiguous(), tables, 3)
    with pytest.raises(TypeError, match="int8"):
        da.paged_decode_attention(q, k, k, tables, 3,
                                  torch.ones(9, 16, 2, device=cuda),
                                  torch.ones(9, 16, 2, device=cuda))


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_paged_engine_on_card_matches_cpu(cuda, kv_dtype):
    """tiny f32 config, an oversubscribed pool with a shared prefix:
    greedy tokens through the paged kernel equal those through its plain
    version on the CPU, and the bookkeeping is the same."""
    cfg = llama.tiny_config()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    rs = np.random.RandomState(1)
    shared = rs.randint(0, 256, 16)
    prompts = [np.concatenate([shared, rs.randint(0, 256, n)])
               for n in (5, 9, 3)] + [rs.randint(0, 256, 12)]

    def serve(device):
        eng = PagedServingEngine(cfg, params, slots=3, max_len=48,
                                 prefill_chunk=8, block_size=8,
                                 num_blocks=11, kv_cache_dtype=kv_dtype,
                                 device=device)
        eng.warmup()
        reqs = [eng.submit(p, 10) for p in prompts]
        eng.run_until_idle()
        eng.check_block_invariants()
        return [r.tokens for r in reqs], eng.kv_stats()

    before = da.launch_counts[f"paged_decode_attention_{kv_dtype}"]
    assert serve(cuda) == serve("cpu")
    assert da.launch_counts[f"paged_decode_attention_{kv_dtype}"] > before


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_migration_on_card_matches_cpu(cuda, kv_dtype):
    """tiny f32 config: the wire a CUDA engine exports (gathered and, for
    an fp pool, quantized on the card) is byte for byte ``kv_to_wire``
    on the CPU of the same rows; imported into a CUDA and a CPU engine,
    it lands the same rows and the request continues to the same
    tokens."""
    import struct

    from dlrover_tpu_torch.ops.kv_quant import kv_to_wire
    from dlrover_tpu_torch.serving import kvpool

    cfg = llama.tiny_config()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    prompt = np.random.RandomState(2).randint(0, 256, 19)

    def engine(device):
        eng = PagedServingEngine(cfg, params, slots=2, max_len=48,
                                 prefill_chunk=8, block_size=8,
                                 kv_cache_dtype=kv_dtype, device=device)
        eng.warmup()
        return eng

    src = engine(cuda)
    req = src.submit(prompt, 12)
    while req.state != "decode" or len(req.tokens) < 3:
        src.step()
    payload = kvpool.export_request(src, req)
    (hlen,) = struct.unpack_from("<I", payload, 4)
    ids = torch.tensor(src._slot_blocks[req.slot], device=cuda)
    rows = [pool.index_select(1, ids).cpu()
            for pool in (src._k, src._v, src._kscale, src._vscale)
            if pool is not None]
    assert payload[8 + hlen:] == kv_to_wire(*rows)
    out = {}
    for device in (cuda, "cpu"):
        dst = engine(device)
        moved = kvpool.import_request(dst, payload)
        blocks = dst._slot_blocks[moved.slot]
        landed = [pool[:, blocks].cpu()
                  for pool in (dst._k, dst._v, dst._kscale, dst._vscale)
                  if pool is not None]
        dst.run_until_idle()
        dst.check_block_invariants()
        assert dst.call_counts["import"] == 1
        out[str(device)] = (landed, moved.tokens)
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        assert torch.equal(a, b)
    assert out["cuda"][1] == out["cpu"][1] and len(out["cpu"][1]) == 12
    kvpool.release_exported(src, req)
    src.check_block_invariants()
    assert src.kv_stats()["used"] == 0 and src.call_counts["export"] == 1


@pytest.mark.parametrize("engine,kv,drafter", [
    ("flat", "fp", "ngram"), ("flat", "fp", "early_exit"),
    ("paged", "fp", "early_exit"), ("paged", "int8", "ngram"),
    ("paged", "int8", "early_exit"),
])
def test_spec_engines_on_card_match_cpu(cuda, engine, kv, drafter):
    """tiny f32 config, speculative decoding (K = 3) over prompts ``p +
    greedy(p) + p``: greedy tokens through the kernels equal those
    through their plain versions on the CPU; the early-exit drafter
    launches the decode kernel 2 x 3 times a draft call, and nothing
    else launches it after warmup."""
    cfg = llama.tiny_config()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    rs = np.random.RandomState(2)
    prompts = []
    for n in (6, 9):
        p = rs.randint(0, 256, n).astype(np.int32)
        g = gen.generate(cfg, params, p[None], 8, device="cpu").tokens[0]
        prompts.append(np.concatenate([p, g.numpy(), p]))
    kw = dict(slots=2, max_len=64, prefill_chunk=8, spec_k=3,
              spec_drafter=drafter, spec_draft_layers=2)
    if engine == "paged":
        kw.update(block_size=8, kv_cache_dtype=kv)
    make = PagedServingEngine if engine == "paged" else ServingEngine
    name = ("paged_" if engine == "paged" else "") + f"decode_attention_{kv}"

    def serve(device):
        eng = make(cfg, params, device=device, **kw)
        eng.warmup()
        before = da.launch_counts[name]
        reqs = [eng.submit(p, 12) for p in prompts]
        eng.run_until_idle()
        if engine == "paged":
            eng.check_block_invariants()
        launches = da.launch_counts[name] - before
        return [r.tokens for r in reqs], eng.call_counts, launches

    got, counts, launches = serve(cuda)
    want, _, _ = serve("cpu")
    assert got == want
    assert counts["decode"] == 1
    drafts_after_warmup = counts["draft"] - (drafter == "early_exit")
    assert launches == 2 * 3 * drafts_after_warmup


def _flash_inputs(device, b, sq, skv, h, kh, d, seed):
    g = torch.Generator(device).manual_seed(seed)
    q = torch.randn(b, sq, h, d, generator=g, device=device).bfloat16()
    k = torch.randn(b, skv, kh, d, generator=g, device=device).bfloat16()
    v = torch.randn(b, skv, kh, d, generator=g, device=device).bfloat16()
    do = torch.randn(b, sq, h, d, generator=g, device=device).bfloat16()
    return q, k, v, do


def _flash_ratio(got, want):
    """Largest |got - want| / (2e-2 |want| + 2e-2 rms_d(want) + 1e-3
    rms(want) + 1e-6) over a ``[b, s, heads, d]`` tensor: the
    elementwise bound chip_smoke.py holds the flash kernels to at full
    size, with rms_d over the head dim of the element's own query row or
    key (a row's rounding errors scale with its own size, which spans
    decades under a causal mask). The 1e-6 floor covers all-zero
    references (one key per row: dP equals delta up to f32 rounding, so
    dq is ~1e-8 rather than 0)."""
    want = want.float()
    sq = want.square()
    tol = (2e-2 * want.abs() + 2e-2 * sq.mean(dim=-1, keepdim=True).sqrt()
           + 1e-3 * sq.mean().sqrt() + 1e-6)
    return float(((got.float() - want).abs() / tol).max())


def _assert_flash_close(got, want, name):
    assert got.shape == want.shape and got.dtype == want.dtype
    ratio = _flash_ratio(got, want)
    assert ratio <= 1.0, f"{name}: at {ratio} of its bound"


def _skip_last_tile(q, k, v, do, lse, delta, causal):
    """What kernels that skip their last 64-wide tile would return: out
    and dq without the last kv tile, dk/dv without the last q tile
    (sq == skv)."""
    cut = 64 * ((q.shape[1] - 1) // 64)
    out, _ = fa.flash_attention_reference(q, k[:, :cut], v[:, :cut], causal)
    dq = fa._plain_backward(q, k[:, :cut], v[:, :cut], lse, do, delta,
                            causal, None, want_dkv=False)[0]
    _, dk, dv = fa._plain_backward(q[:, :cut], k, v, lse[..., :cut],
                                   do[:, :cut], delta[..., :cut], causal,
                                   None, want_dq=False)
    return out, dq, dk, dv


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,skv,h,kh,d", [
    (2, 128, 128, 4, 4, 64),
    (2, 200, 200, 8, 2, 128),    # GQA, ragged tail
    (1, 72, 72, 4, 2, 16),       # d below the 64-wide instantiation
    (2, 130, 130, 4, 4, 128),
    (1, 100, 192, 4, 1, 32),     # sq != skv
    (1, 1, 1, 2, 1, 128),
])
def test_flash_kernels_match_plain_versions(cuda, causal, b, sq, skv, h, kh,
                                            d):
    q, k, v, do = _flash_inputs(cuda, b, sq, skv, h, kh, d, sq * 31 + h)
    before = dict(fa.launch_counts)
    out, lse = fa.flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_reference(q, k, v, causal)
    _assert_flash_close(out, want_out, "out")
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    delta = fa.flash_backward_delta(do, want_out)
    dq = fa.flash_backward_dq(q, k, v, do, want_lse, delta, causal)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, want_lse, delta, causal)
    torch.cuda.synchronize()
    ref = (want_out,) + fa.flash_backward_reference(q, k, v, want_out,
                                                    want_lse, do, causal)
    names = ("out", "dq", "dk", "dv")
    for name, got, want in zip(names[1:], (dq, dk, dv), ref[1:]):
        _assert_flash_close(got, want, name)
    for name in fa.launch_counts:
        assert fa.launch_counts[name] == before[name] + 1
    if sq == skv and sq > 64:
        # The same bound rejects kernels that skip their last tile.
        faults = _skip_last_tile(q, k, v, do, want_lse, delta, causal)
        for name, fault, want in zip(names, faults, ref):
            assert _flash_ratio(fault, want) > 1.0, name


@pytest.mark.parametrize("d", [16, 32, 48, 64, 96, 112, 128])
@pytest.mark.parametrize("sq,skv,causal", [
    (1, 1, True), (1, 77, False), (130, 130, True), (300, 200, True),
    (200, 300, False), (257, 257, False),
])
def test_flash_forward_shapes_rerun_bitwise(cuda, d, sq, skv, causal):
    """B1 (TMA + wgmma) at every head-dim class it takes (d <= 64
    computes at 64, the rest at 128, the tensor maps zero-filling the
    columns past d), seq_q != seq_k, s = 1 and s not a multiple of 64 or
    128, GQA: within the flash bound of the plain version, lse within
    1e-3, and two calls give the same bits."""
    q, k, v, _ = _flash_inputs(cuda, 2, sq, skv, 4, 2, d, d * 7 + sq)
    out, lse = fa.flash_forward(q, k, v, causal)
    out2, lse2 = fa.flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_reference(q, k, v, causal)
    _assert_flash_close(out, want_out, "out")
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    torch.testing.assert_close(lse2, lse, rtol=0, atol=0)


@pytest.mark.parametrize("d", [16, 32, 48, 64, 96, 112, 128])
@pytest.mark.parametrize("sq,skv,causal", [
    (1, 1, True), (1, 77, False), (127, 127, True), (129, 129, True),
    (257, 257, False), (300, 200, True), (200, 300, False),
    (129, 257, True),
])
def test_flash_backward_shapes_rerun_bitwise(cuda, d, sq, skv, causal):
    """B2 (TMA + wgmma) at every head-dim class it takes (d <= 64
    computes at 64, the rest at 128), s = 1, seq_q != seq_k both ways,
    lengths on either side of its 128-row owned tiles (127, 129, 257)
    and not multiples of its 64-row streamed tiles, GQA (4 query heads
    on 2 kv heads): dq, dk and dv within the flash bound of the plain
    version, and two calls give the same bits."""
    q, k, v, do = _flash_inputs(cuda, 2, sq, skv, 4, 2, d, d * 5 + sq + skv)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, causal)
    delta = fa.flash_backward_delta(do, want_out)
    dq = fa.flash_backward_dq(q, k, v, do, want_lse, delta, causal)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, want_lse, delta, causal)
    dq2 = fa.flash_backward_dq(q, k, v, do, want_lse, delta, causal)
    dk2, dv2 = fa.flash_backward_dkv(q, k, v, do, want_lse, delta, causal)
    torch.cuda.synchronize()
    refs = fa.flash_backward_reference(q, k, v, want_out, want_lse, do,
                                       causal)
    for name, got, again, want in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                      (dq2, dk2, dv2), refs):
        _assert_flash_close(got, want, name)
        torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_flash_backward_reads_fused_qkv_and_strided_do(cuda):
    """B2's tensor maps read q/k/v as slices of one fused projection
    [b, s, h + 2 kh, d] and dO as a strided view (every other head of a
    wider tensor): dq, dk and dv equal those of the contiguous copies
    bit for bit, within the bound of the plain version."""
    g = torch.Generator(cuda).manual_seed(8)
    h, kh = 8, 2
    qkv = torch.randn(2, 333, h + 2 * kh, 128, generator=g,
                      device=cuda).bfloat16()
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kh], qkv[:, :, h + kh:]
    do = torch.randn(2, 333, 2 * h, 128, generator=g,
                     device=cuda).bfloat16()[:, :, ::2]
    assert fa._strided(q) is q and fa._strided(do) is do
    assert not do.is_contiguous()
    out, lse = fa.flash_attention_reference(q, k, v)
    delta = fa.flash_backward_delta(do, out)
    got = (fa.flash_backward_dq(q, k, v, do, lse, delta),
           *fa.flash_backward_dkv(q, k, v, do, lse, delta))
    c = [t.contiguous() for t in (q, k, v, do)]
    want = (fa.flash_backward_dq(*c, lse, delta),
            *fa.flash_backward_dkv(*c, lse, delta))
    refs = fa.flash_backward_reference(q, k, v, out, lse, do)
    for name, a, b, ref in zip(("dq", "dk", "dv"), got, want, refs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        _assert_flash_close(a, ref, name)


def test_flash_forward_reads_fused_qkv_with_gqa(cuda):
    """The flagship's q/k/v are slices of one fused projection
    [b, s, h + 2 kh, d]: B1's tensor maps read them through their
    strides, bit for bit as their contiguous copies, within the bound."""
    g = torch.Generator(cuda).manual_seed(6)
    h, kh = 8, 2
    qkv = torch.randn(2, 333, h + 2 * kh, 128, generator=g,
                      device=cuda).bfloat16()
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kh], qkv[:, :, h + kh:]
    assert fa._strided(q) is q and fa._strided(k) is k
    out, lse = fa.flash_forward(q, k, v)
    c_out, c_lse = fa.flash_forward(q.contiguous(), k.contiguous(),
                                    v.contiguous())
    torch.testing.assert_close(out, c_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, c_lse, rtol=0, atol=0)
    want_out, _ = fa.flash_attention_reference(q, k, v)
    _assert_flash_close(out, want_out, "out")


def test_flash_reads_strided_inputs(cuda):
    """q/k/v as views into one packed [b, s, 3, h, d] tensor (no copy)
    give what their contiguous copies give, bit for bit."""
    g = torch.Generator(cuda).manual_seed(5)
    qkv = torch.randn(2, 96, 3, 4, 64, generator=g, device=cuda).bfloat16()
    q, k, v = qkv.unbind(dim=2)
    assert not q.is_contiguous()
    a_out, a_lse = fa.flash_forward(q, k, v)
    b_out, b_lse = fa.flash_forward(q.contiguous(), k.contiguous(),
                                    v.contiguous())
    torch.testing.assert_close(a_out, b_out, rtol=0, atol=0)
    torch.testing.assert_close(a_lse, b_lse, rtol=0, atol=0)


def test_flash_autograd_on_card_matches_cpu(cuda):
    q, k, v, do = _flash_inputs("cpu", 2, 80, 80, 4, 2, 64, 11)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_(True)
                  for t in (q, k, v)]
        out = fa.flash_attention(*leaves)
        out.backward(do.to(dev))
        grads[str(dev)] = [out.detach().cpu()] + [
            t.grad.cpu() for t in leaves
        ]
    cpu, card = grads["cpu"], grads[str(cuda)]
    for name, got, want in zip(("out", "dq", "dk", "dv"), card, cpu):
        _assert_flash_close(got, want, name)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_forward(q, q, q)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_forward(qb[..., :24], qb[..., :24], qb[..., :24])
    with pytest.raises(ValueError, match="kv_heads"):
        fa.flash_forward(torch.zeros(1, 8, 3, 64, device=cuda).bfloat16(),
                         qb, qb)


def test_train_step_on_card_matches_cpu(cuda):
    """Two steps of the bf16 tiny config: the card (flash kernels) and
    the CPU (plain attention) give losses within bf16 noise."""
    from dlrover_tpu_torch.trainer import train_step as ts

    cfg = llama.tiny_config(n_layers=2, dtype="bfloat16", head_dim=64,
                            n_heads=4, n_kv_heads=2)
    tc = ts.TrainConfig(learning_rate=1e-3, warmup_steps=1)
    tokens = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (2, 65)).astype(np.int32)
    )
    losses = {}
    for dev in ("cpu", cuda):
        params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
        params = {k: (v.to(dev) if torch.is_tensor(v) else
                      {n: w.to(dev) for n, w in v.items()})
                  for k, v in params.items()}
        opt = ts.make_optimizer(tc)
        state = ts.init_train_state(cfg, opt, params)
        step = ts.make_train_step(cfg, tc, opt, device=dev)
        out = []
        for _ in range(2):
            state, m = step(state, {"tokens": tokens.to(dev)})
            out.append(float(m["loss"]))
        losses[str(dev)] = out
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=2e-2)


def test_remat_policies_on_card(cuda):
    """Through the kernels, every remat policy gives the gradients of
    no remat (recompute runs the same kernels on the same inputs), and
    the forward kernel runs once per layer under mlp_only (the flash op
    stays outside checkpointing) and twice under dots/full."""
    from dlrover_tpu_torch.trainer import train_step as ts

    tokens = torch.from_numpy(
        np.random.RandomState(1).randint(0, 256, (2, 97)).astype(np.int32)
    ).to(cuda)
    grads = {}
    for policy, remat in (("none", False), ("mlp_only", True),
                          ("attn_save", True), ("dots", True),
                          ("full", True)):
        cfg = llama.tiny_config(
            n_layers=2, dtype="bfloat16", head_dim=64, n_heads=4,
            n_kv_heads=2, remat=remat,
            remat_policy="mlp_only" if policy == "none" else policy)
        params = llama.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                                   device=cuda)
        leaves = ts.param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        fa.reset_launch_counts()
        loss, _ = llama.loss_fn(cfg, params, {"tokens": tokens})
        grads[policy] = torch.autograd.grad(loss, leaves)
        forwards = 2 * cfg.n_layers if policy in ("dots", "full") else (
            cfg.n_layers)
        assert fa.launch_counts == {
            "flash_forward": forwards,
            "flash_backward_dq": cfg.n_layers,
            "flash_backward_dkv": cfg.n_layers,
        }, policy
    for policy, got in grads.items():
        for g, r in zip(got, grads["none"]):
            torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-5,
                                       msg=policy)


def _ce_inputs(device, n, d, v, masked, seed):
    """bf16 x [n, d], w [d, V] (scaled as the flagship's lm_head), int32
    targets (row 0's in the last vocab column), and the backward's
    coefficients for a token-mean loss (a = b = 0 on masked rows)."""
    from dlrover_tpu_torch.ops import fused_ce as fc

    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(n, d, generator=g, device=device).bfloat16()
    w = (torch.randn(d, v, generator=g, device=device) / d ** 0.5).bfloat16()
    tgt = torch.randint(0, v, (n,), generator=g, device=device,
                        dtype=torch.int32)
    tgt[0] = v - 1
    keep = torch.ones(n, device=device)
    if masked:
        keep = (torch.rand(n, generator=g, device=device) >= 0.3).float()
        keep[0] = 1.0
    wgt = keep / keep.sum()
    _, logz = fc._xla_forward(x, w, tgt, 1e-4)
    return x, w, tgt, logz, wgt * (1.0 + 2e-4 * logz), wgt


def _ce_ratio(got, want, dim):
    """Largest |got - want| / (2e-2 |want| + 2e-2 rms_d(want) + 1e-3
    rms(want) + 1e-30): the elementwise bound chip_smoke.py holds B4's
    outputs to, rms_d over d of the element's row (dx, dim=-1) or column
    (dw, dim=0)."""
    want = want.float()
    sq = want.square()
    tol = (2e-2 * want.abs() + 2e-2 * sq.mean(dim=dim, keepdim=True).sqrt()
           + 1e-3 * sq.mean().sqrt() + 1e-30)
    return float(((got.float() - want).abs() / tol).max())


@pytest.mark.parametrize("n,d,v,masked", [
    (100, 256, 1003, False),     # ragged rows and vocab
    (300, 128, 77, True),        # one partial vocab tile, masked rows
    (1000, 1024, 4099, True),    # the flagship's d
    (64, 512, 128, False),       # exact tiles
])
def test_fused_ce_kernels_match_plain_versions(cuda, n, d, v, masked):
    """B3 against its plain version: per_tok and logz within rtol 1e-5
    (f32 sums of the same bf16 products in another order). B4 dx and dw
    within _ce_ratio's bound (dx is rounded to bf16 on both sides, from
    f32 sums in another order, so an element may land one bf16 ulp
    away). A planted fault (the last vocab tile, or dw's last 64-row
    tile, left out) fails the same bounds."""
    from dlrover_tpu_torch.ops import fused_ce as fc

    x, w, tgt, logz, a, b = _ce_inputs(cuda, n, d, v, masked, n + v)
    before = dict(fc.launch_counts)
    per_tok, got_logz = fc.fused_ce_forward(x, w, tgt, 1e-4)
    dx = fc.fused_ce_backward_dx(x, w, tgt, logz, a, b)
    dw = fc.fused_ce_backward_dw(x, w, tgt, logz, a, b)
    torch.cuda.synchronize()
    for name in fc.launch_counts:
        assert fc.launch_counts[name] == before[name] + 1
    want_pt, want_logz = fc._xla_forward(x, w, tgt, 1e-4)
    torch.testing.assert_close(per_tok, want_pt, rtol=1e-5, atol=0)
    torch.testing.assert_close(got_logz, want_logz, rtol=1e-5, atol=0)
    want_dx, want_dw = fc._xla_backward(x, w, tgt, logz, a, b)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert _ce_ratio(dx, want_dx.bfloat16(), -1) <= 1.0
    assert _ce_ratio(dw, want_dw, 0) <= 1.0
    if masked:
        assert not dx[a == 0].any()
    fault_pt, _ = fc._xla_forward(x, w[:, :128 * ((v - 1) // 128)], tgt,
                                  1e-4)
    assert not torch.allclose(fault_pt, want_pt, rtol=1e-5, atol=0)
    fault_dx, _ = fc._xla_backward(x, w[:, :64 * ((v - 1) // 64)], tgt, logz,
                                   a, b, want_dw=False)
    assert _ce_ratio(fault_dx.bfloat16(), want_dx.bfloat16(), -1) > 1.0
    cut = 64 * ((n - 1) // 64)
    _, fault_dw = fc._xla_backward(x[:cut], w, tgt[:cut], logz[:cut],
                                   a[:cut], b[:cut], want_dx=False)
    assert _ce_ratio(fault_dw, want_dw, 0) > 1.0


@pytest.mark.parametrize("n,d,v,masked", [
    (200, 256, 999, True),     # B3: one row tile, four vocab splits
    (300, 1024, 2000, False),  # B3: pairs of blocks, eight splits combined
])
def test_fused_ce_kernels_rerun_bitwise(cuda, n, d, v, masked):
    """One owner per output element and a fixed order of sums (B3's
    splits combined in split order): a second launch gives the same
    bits."""
    from dlrover_tpu_torch.ops import fused_ce as fc

    x, w, tgt, logz, a, b = _ce_inputs(cuda, n, d, v, masked, 3)
    first = (fc.fused_ce_forward(x, w, tgt, 1e-4)
             + (fc.fused_ce_backward_dx(x, w, tgt, logz, a, b),
                fc.fused_ce_backward_dw(x, w, tgt, logz, a, b)))
    second = (fc.fused_ce_forward(x, w, tgt, 1e-4)
              + (fc.fused_ce_backward_dx(x, w, tgt, logz, a, b),
                 fc.fused_ce_backward_dw(x, w, tgt, logz, a, b)))
    for p, q in zip(first, second):
        assert torch.equal(p, q)


def test_fused_ce_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from dlrover_tpu_torch.ops import fused_ce as fc

    x = torch.zeros(16, 128, device=cuda)
    w = torch.zeros(128, 40, device=cuda)
    tgt = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        fc.fused_ce_forward(x, w, tgt, 1e-4)
    with pytest.raises(TypeError, match="bfloat16"):
        fc.fused_cross_entropy(x, w, tgt, impl="pallas")
    with pytest.raises(ValueError, match="d 96"):
        fc.fused_ce_forward(x[:, :96].bfloat16(), w[:96].bfloat16(), tgt,
                            1e-4)
    with pytest.raises(ValueError, match="tensor on"):
        fc.fused_ce_forward(x.bfloat16(), w.bfloat16().cpu(), tgt, 1e-4)


@pytest.mark.parametrize("n,d,v,masked", [
    (127, 1024, 255, True),      # one short of a row tile and a vocab tile
    (129, 1024, 257, False),     # one past each: a pair, two splits
    (257, 512, 769, True),       # three row tiles (a pair's pad), four splits
    (4100, 1024, 32003, True),   # ragged: four splits of single blocks
    (1000, 128, 4099, False),    # the narrowest d, nine splits of pairs
    (300, 1024, 2000, True),     # eight splits of pairs, a padded row tile
])
def test_fused_ce_forward_at_its_tile_and_split_edges(cuda, n, d, v,
                                                      masked):
    """B3 (128-row tiles alone or in pairs that share w, 256-column vocab
    tiles split across blocks, the last split of a row tile combining
    the partials) against its plain version where its tiles and splits
    end: per_tok and logz within rtol 1e-5; a second launch gives the
    same bits, and the plain version without the last vocab tile fails
    the bound."""
    from dlrover_tpu_torch.ops import fused_ce as fc

    x, w, tgt, _, _, _ = _ce_inputs(cuda, n, d, v, masked, n + d + v)
    per_tok, logz = fc.fused_ce_forward(x, w, tgt, 1e-4)
    again = fc.fused_ce_forward(x, w, tgt, 1e-4)
    torch.cuda.synchronize()
    want_pt, want_logz = fc._xla_forward(x, w, tgt, 1e-4)
    torch.testing.assert_close(per_tok, want_pt, rtol=1e-5, atol=0)
    torch.testing.assert_close(logz, want_logz, rtol=1e-5, atol=0)
    assert torch.equal(per_tok, again[0]) and torch.equal(logz, again[1])
    fault, _ = fc._xla_forward(x, w[:, :256 * ((v - 1) // 256)], tgt, 1e-4)
    assert not torch.allclose(fault, want_pt, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n,d,v,masked", [
    (4100, 1024, 32003, True),   # ragged rows and vocab, the flagship's d
    (4100, 1024, 32033, False),  # V = 32000 + a partial vocab tile
    (4100, 512, 32003, True),    # one block a cluster
    (4100, 128, 32033, False),   # the narrowest d
    (33, 1024, 65, True),        # one row past a step, one column past a tile
])
def test_fused_ce_dw_at_its_tile_edges(cuda, n, d, v, masked):
    """B4 dw (clusters over d, 64-column vocab tiles, 32-row steps)
    against its plain version where its tiles end, within _ce_ratio's
    bound; a second launch gives the same bits."""
    from dlrover_tpu_torch.ops import fused_ce as fc

    x, w, tgt, logz, a, b = _ce_inputs(cuda, n, d, v, masked, n + d + v)
    dw = fc.fused_ce_backward_dw(x, w, tgt, logz, a, b)
    again = fc.fused_ce_backward_dw(x, w, tgt, logz, a, b)
    torch.cuda.synchronize()
    _, want = fc._xla_backward(x, w, tgt, logz, a, b, want_dx=False)
    assert tuple(dw.shape) == (d, v) and dw.dtype == torch.float32
    assert _ce_ratio(dw, want, 0) <= 1.0
    assert torch.equal(dw, again)


@pytest.mark.parametrize("n,d,v,masked", [
    (4100, 1024, 32003, True),   # ragged rows and vocab, clusters of 4
    (129, 1024, 65, False),      # one row past a tile, one column past a step
    (127, 512, 63, True),        # one short of each, clusters of 2
    (300, 384, 1000, False),     # d-slices of 128, clusters of 3
    (257, 768, 4097, True),      # d-slices of 256, clusters of 3
    (200, 896, 129, False),      # clusters of 7
    (130, 128, 4033, True),      # one block a tile, no exchange
])
def test_fused_ce_dx_at_its_tile_edges(cuda, n, d, v, masked):
    """B4 dx (clusters over d, 128-row tiles, 64-column vocab steps, the
    partials reduce-scattered and g all-gathered between the blocks)
    against its plain version where its tiles end, within _ce_ratio's
    bound; masked rows get zeros and a second launch gives the same
    bits."""
    from dlrover_tpu_torch.ops import fused_ce as fc

    x, w, tgt, logz, a, b = _ce_inputs(cuda, n, d, v, masked, n + d + v)
    dx = fc.fused_ce_backward_dx(x, w, tgt, logz, a, b)
    again = fc.fused_ce_backward_dx(x, w, tgt, logz, a, b)
    torch.cuda.synchronize()
    want, _ = fc._xla_backward(x, w, tgt, logz, a, b, want_dw=False)
    assert tuple(dx.shape) == (n, d) and dx.dtype == torch.bfloat16
    assert _ce_ratio(dx, want.bfloat16(), -1) <= 1.0
    assert torch.equal(dx, again)
    if masked:
        assert not dx[a == 0].any()


@pytest.mark.parametrize("impl", ["pallas", "chunked", "xla"])
def test_fused_cross_entropy_on_card_matches_cpu(cuda, impl):
    """bf16 hidden states and unembedding, masked: the loss on the card
    within rtol 1e-5 of the CPU's (f32 logits on both), dx and dw within
    _ce_ratio's bound."""
    from dlrover_tpu_torch.ops import fused_ce as fc

    x, w, tgt, _, _, _ = _ce_inputs("cpu", 3 * 77, 256, 1000, False, 9)
    mask = (torch.rand(3 * 77, generator=torch.Generator().manual_seed(1))
            > 0.3).float()
    out = {}
    for dev in ("cpu", cuda):
        xl = x.to(dev).requires_grad_(True)
        wl = w.to(dev).requires_grad_(True)
        loss = fc.fused_cross_entropy(xl.reshape(3, 77, 256), wl,
                                      tgt.to(dev).reshape(3, 77),
                                      mask.to(dev).reshape(3, 77), impl=impl)
        out[str(dev)] = (loss.detach().cpu(),) + tuple(
            g.cpu() for g in torch.autograd.grad(loss, [xl, wl]))
    cpu, card = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(card[0], cpu[0], rtol=1e-5, atol=0)
    assert _ce_ratio(card[1], cpu[1], -1) <= 1.0
    assert _ce_ratio(card[2], cpu[2], 0) <= 1.0


def test_train_step_through_fused_ce_kernels_on_card(cuda):
    """A bf16 tiny config (embed 128, which the kernels take) trained
    through a loss_fn that reaches B3/B4: one launch of each per
    micro-step, and losses within bf16 noise of the CPU's."""
    from dlrover_tpu_torch.ops import fused_ce as fc
    from dlrover_tpu_torch.trainer import train_step as ts

    cfg = llama.tiny_config(n_layers=2, dtype="bfloat16", embed_dim=128,
                            head_dim=64, n_heads=4, n_kv_heads=2)
    tc = ts.TrainConfig(learning_rate=1e-3, warmup_steps=1, grad_accum=2)

    def loss_fn(params, batch):
        toks = batch["tokens"]
        x, aux = llama.forward_hidden(cfg, params, toks[:, :-1])
        ce = fc.fused_cross_entropy(
            llama.final_hidden(cfg, params, x),
            params["lm_head"].to(cfg.compute_dtype), toks[:, 1:],
            impl="pallas")
        return ce + cfg.moe_aux_weight * aux, {"ce": ce, "aux": aux}

    tokens = torch.from_numpy(
        np.random.RandomState(2).randint(0, 256, (4, 65)).astype(np.int32))
    losses = {}
    for dev in ("cpu", cuda):
        params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
        params = {k: (v.to(dev) if torch.is_tensor(v) else
                      {n: t.to(dev) for n, t in v.items()})
                  for k, v in params.items()}
        opt = ts.make_optimizer(tc)
        state = ts.init_train_state(cfg, opt, params)
        step = ts.make_train_step(cfg, tc, opt, device=dev, loss_fn=loss_fn)
        fc.reset_launch_counts()
        out = []
        for _ in range(2):
            state, m = step(state, {"tokens": tokens.to(dev)})
            out.append(float(m["loss"]))
        losses[str(dev)] = out
        want = 0 if dev == "cpu" else 2 * tc.grad_accum
        assert set(fc.launch_counts.values()) == {want}, dev
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=2e-2)


# ---- MoE grouped FFN (B7, B8) ---------------------------------------------


def _moe_inputs(device, n, d, f, e, k, routing, seed):
    """bf16 x [n, d], w_gu [e, d, 2f], w_down [e, f, d] (scaled by 1 /
    sqrt(fan_in)), dy [n k, d], and the layout of a routing: "random",
    "skewed" (half the copies on expert 0, expert e - 1 empty) or
    "one" (every copy on expert 1)."""
    from dlrover_tpu_torch.ops import moe_dispatch as md

    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(n, d, generator=g, device=device).bfloat16()
    w_gu = (torch.randn(e, d, 2 * f, generator=g, device=device)
            / d ** 0.5).bfloat16()
    w_down = (torch.randn(e, f, d, generator=g, device=device)
              / f ** 0.5).bfloat16()
    dy = torch.randn(n * k, d, generator=g, device=device).bfloat16()
    fe = torch.randint(0, e, (n * k,), generator=g, device=device)
    if routing == "skewed":
        fe[: n * k // 2] = 0
        fe[fe == e - 1] = 1
    elif routing == "one":
        fe[:] = 1
    tm = md.default_tile_m(n * k)
    ids = md.build_dispatch_layout(fe.to(torch.int32), e, tm, k)
    return x, w_gu, w_down, dy, ids, tm


@pytest.mark.parametrize("n,d,f,e,k,routing", [
    (8, 1024, 1024, 8, 2, "random"),      # a decode step, tile 16
    (600, 256, 384, 8, 2, "skewed"),      # tile 128, an empty expert
    (40, 128, 128, 4, 2, "one"),          # tile 16, three empty experts
    (700, 384, 256, 4, 1, "random"),      # top-1, tile 16
])
def test_moe_kernels_match_plain_versions(cuda, n, d, f, e, k, routing):
    """B7 and B8 against their plain versions: bf16 outputs (y, dx_c, a,
    dh) and the f32 weight gradients within the elementwise bound of
    _ce_ratio (both round a, dh and y at the same places from f32 sums
    in another order). Rows of y and dx_c that no slot names are not
    compared (the kernels leave them unwritten)."""
    from dlrover_tpu_torch.ops import moe_dispatch as md

    x, w_gu, w_down, dy, (ri, di, te), tm = _moe_inputs(
        cuda, n, d, f, e, k, routing, n + d)
    m = n * k
    before = dict(md.launch_counts)
    y = md.grouped_ffn_forward(x, w_gu, w_down, ri, di, te, m, tm)
    dx_c, dh, a = md.grouped_ffn_backward_dx(x, dy, w_gu, w_down, ri, di,
                                             te, tm)
    dwgu = md.grouped_ffn_backward_dw_gu(x, dh, ri, te, e, tm)
    dwdn = md.grouped_ffn_backward_dw_down(a, dy, di, te, e, tm)
    torch.cuda.synchronize()
    for name in md.launch_counts:
        assert md.launch_counts[name] == before[name] + 1
    want_y = md._forward_reference(x, w_gu, w_down, ri, di, te, m, tm)
    want_dx, want_dh, want_a = md._backward_dx_reference(
        x, dy, w_gu, w_down, ri, di, te, tm)
    assert _ce_ratio(y, want_y, -1) <= 1.0
    assert _ce_ratio(dx_c, want_dx, -1) <= 1.0
    assert _ce_ratio(a, want_a, -1) <= 1.0
    assert _ce_ratio(dh, want_dh, -1) <= 1.0
    want_gu = md._backward_dw_gu_reference(x, want_dh, ri, te, e, tm)
    want_dn = md._backward_dw_down_reference(want_a, dy, di, te, e, tm)
    assert dwgu.dtype == dwdn.dtype == torch.float32
    assert _ce_ratio(dwgu, want_gu, 1) <= 1.0
    assert _ce_ratio(dwdn, want_dn, 1) <= 1.0
    # padding slots carry zero a and dh; experts without rows get zeros
    pad = ri < 0
    assert not a[pad].any() and not dh[pad].any()
    routed = torch.zeros(e, dtype=torch.bool, device=cuda)
    routed[te[(ri.view(-1, tm) >= 0).any(dim=1)].long()] = True
    assert not dwgu[~routed].any() and not dwdn[~routed].any()
    # A planted fault fails the same bound: the last tile of routed rows
    # run with the next expert's weights.
    last = int((ri.view(-1, tm) >= 0).any(dim=1).nonzero().max())
    te_bad = te.clone()
    te_bad[last] = (te_bad[last] + 1) % e
    bad = md._forward_reference(x, w_gu, w_down, ri, di, te_bad, m, tm)
    assert _ce_ratio(bad, want_y, -1) > 1.0


@pytest.mark.parametrize("n,d,f,e,k,routing", [
    (8, 1024, 1024, 8, 2, "random"),      # a decode step, tile 16
    (600, 256, 384, 8, 2, "skewed"),      # tile 128, an empty expert
    (40, 128, 128, 4, 2, "one"),          # tile 16, every row on one expert
    (1200, 384, 384, 4, 2, "one"),        # tile 128, [128 x 128] dw_down units
    (900, 256, 640, 6, 2, "random"),      # f != d, [128 x 256] units
])
def test_moe_dw_kernels_at_their_edges(cuda, n, d, f, e, k, routing):
    """B8 dw_gu and dw_down against their plain versions (fed the plain
    dx's dh and a) within _ce_ratio's bound at both tile_m, experts with
    no rows and one with every row, f != d; experts without rows get
    zeros and a second launch gives the same bits."""
    from dlrover_tpu_torch.ops import moe_dispatch as md

    x, w_gu, w_down, dy, (ri, di, te), tm = _moe_inputs(
        cuda, n, d, f, e, k, routing, n + f)
    _, dh, a = md._backward_dx_reference(x, dy, w_gu, w_down, ri, di, te, tm)
    routed = torch.zeros(e, dtype=torch.bool, device=cuda)
    routed[te[(ri.view(-1, tm) >= 0).any(dim=1)].long()] = True
    for name, call, plain in (
            ("dw_gu", lambda: md.grouped_ffn_backward_dw_gu(x, dh, ri, te, e,
                                                            tm),
             lambda: md._backward_dw_gu_reference(x, dh, ri, te, e, tm)),
            ("dw_down", lambda: md.grouped_ffn_backward_dw_down(a, dy, di, te,
                                                                e, tm),
             lambda: md._backward_dw_down_reference(a, dy, di, te, e, tm))):
        got, again = call(), call()
        torch.cuda.synchronize()
        assert _ce_ratio(got, plain(), 1) <= 1.0, name
        assert torch.equal(got, again), name
        assert not got[~routed].any(), name


@pytest.mark.parametrize("n,d,f,e,k,routing", [
    (8, 1024, 1024, 8, 2, "random"),      # a decode step, tile 16
    (700, 384, 256, 4, 2, "skewed"),      # tile 128, d past a 256 unit
    (40, 256, 640, 4, 2, "one"),          # tile 16, three empty experts
    (1100, 1024, 128, 8, 1, "random"),    # top-1, tile 128, f one unit
    (600, 128, 384, 6, 2, "skewed"),      # tile 128, d half a unit
])
def test_moe_ffn_kernels_at_their_edges(cuda, n, d, f, e, k, routing):
    """B7 (gate|up, down) and B8 dx (its second launch on B7's body)
    against their plain versions within _ce_ratio's bound where the
    units end: tile_m 16 and 128, all-padding tiles, experts without
    rows, d not a multiple of the 256-column unit. The sorted a and dh
    are zero on padding slots, and a second launch gives the same
    bits."""
    from dlrover_tpu_torch.ops import moe_dispatch as md

    x, w_gu, w_down, dy, (ri, di, te), tm = _moe_inputs(
        cuda, n, d, f, e, k, routing, n + d + f)
    assert (ri.view(-1, tm) < 0).all(dim=1).any()
    m = n * k

    def run():
        return ((md.grouped_ffn_forward(x, w_gu, w_down, ri, di, te, m,
                                        tm),)
                + md.grouped_ffn_backward_dx(x, dy, w_gu, w_down, ri, di, te,
                                             tm))

    got, again = run(), run()
    torch.cuda.synchronize()
    want = ((md._forward_reference(x, w_gu, w_down, ri, di, te, m, tm),)
            + md._backward_dx_reference(x, dy, w_gu, w_down, ri, di, te, tm))
    for name, g, a2, w_ in zip(("y", "dx_c", "dh", "a"), got, again, want):
        assert _ce_ratio(g, w_, -1) <= 1.0, name
        assert torch.equal(g, a2), name
    pad = ri < 0
    assert not got[2][pad].any() and not got[3][pad].any()


@pytest.mark.parametrize("n,d,f,e,k,routing", [
    (8, 1024, 1024, 8, 2, "random"),      # a decode step, tile 16
    (40, 128, 128, 4, 2, "one"),          # tile 16, two units, empty experts
    (1100, 1024, 128, 8, 1, "random"),    # tile 128, one pair of units
    (700, 384, 384, 4, 2, "skewed"),      # tile 128, three pairs, an empty expert
    (600, 256, 640, 6, 2, "random"),      # tile 128, five pairs
])
def test_moe_dx_gate_up_at_its_unit_edges(cuda, n, d, f, e, k, routing):
    """B8 dx's first launch (64-column units of f, tile 128 in pairs of
    blocks that share the gathered rows) and the whole B8 dx against the
    plain version within _ce_ratio's bound where the units end: tile_m
    16 and 128, all-padding tiles (zero a and dh rows written), experts
    without rows. The two launches run apart give the whole call's bits
    and count no launch; a second call gives the same bits."""
    from dlrover_tpu_torch.ops import moe_dispatch as md

    x, w_gu, w_down, dy, (ri, di, te), tm = _moe_inputs(
        cuda, n, d, f, e, k, routing, n + 2 * f)
    assert (ri.view(-1, tm) < 0).all(dim=1).any()
    before = dict(md.launch_counts)
    dh1, a1 = md.backward_dx_launch(x, dy, w_gu, w_down, ri, di, te, tm, 1)
    dx2 = md.backward_dx_launch(x, dy, w_gu, w_down, ri, di, te, tm, 2,
                                dh=dh1)
    torch.cuda.synchronize()
    assert md.launch_counts == before
    got = md.grouped_ffn_backward_dx(x, dy, w_gu, w_down, ri, di, te, tm)
    again = md.grouped_ffn_backward_dx(x, dy, w_gu, w_down, ri, di, te, tm)
    torch.cuda.synchronize()
    want = md._backward_dx_reference(x, dy, w_gu, w_down, ri, di, te, tm)
    for name, g, a2, w_ in zip(("dx_c", "dh", "a"), got, again, want):
        assert _ce_ratio(g, w_, -1) <= 1.0, name
        assert torch.equal(g, a2), name
    assert torch.equal(got[1], dh1) and torch.equal(got[2], a1)
    assert torch.equal(got[0], dx2)
    pad = ri < 0
    assert not got[1][pad].any() and not got[2][pad].any()


def test_dx_ffn_wrappers_reject_misaligned_operands(cuda):
    """TMA reads B4 dx's and B7's operands: a tensor whose data is not
    16-byte aligned is refused by the C entry point and the wrapper
    raises."""
    from dlrover_tpu_torch.ops import fused_ce as fc
    from dlrover_tpu_torch.ops import moe_dispatch as md

    x, w, tgt, logz, a, b = _ce_inputs(cuda, 16, 128, 40, False, 2)
    shifted = torch.empty(16 * 128 + 1, dtype=x.dtype, device=cuda)
    shifted[1:] = x.reshape(-1)
    with pytest.raises(RuntimeError, match="launch failed"):
        fc.fused_ce_backward_dx(shifted[1:].view(16, 128), w, tgt, logz, a, b)
    x, w_gu, w_down, _, (ri, di, te), tm = _moe_inputs(
        cuda, 8, 128, 128, 4, 2, "random", 4)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    shifted[1:] = x.reshape(-1)
    with pytest.raises(RuntimeError, match="launch failed"):
        md.grouped_ffn_forward(shifted[1:].view(x.shape), w_gu, w_down, ri,
                               di, te, 16, tm)


def test_moe_kernels_rerun_bitwise(cuda):
    """No atomics, one owner per output element: a second launch gives
    the same bits."""
    from dlrover_tpu_torch.ops import moe_dispatch as md

    x, w_gu, w_down, dy, (ri, di, te), tm = _moe_inputs(
        cuda, 600, 256, 256, 8, 2, "random", 7)

    def run():
        y = md.grouped_ffn_forward(x, w_gu, w_down, ri, di, te, 1200, tm)
        dx_c, dh, a = md.grouped_ffn_backward_dx(x, dy, w_gu, w_down, ri, di,
                                                 te, tm)
        return (y, dx_c, dh, a,
                md.grouped_ffn_backward_dw_gu(x, dh, ri, te, 8, tm),
                md.grouped_ffn_backward_dw_down(a, dy, di, te, 8, tm))

    for p, q in zip(run(), run()):
        assert torch.equal(p, q)


def test_moe_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from dlrover_tpu_torch.ops import moe_dispatch as md

    x, w_gu, w_down, _, (ri, di, te), tm = _moe_inputs(
        cuda, 8, 128, 128, 4, 2, "random", 1)
    with pytest.raises(TypeError, match="bfloat16"):
        md.grouped_ffn_forward(x.float(), w_gu.float(), w_down.float(), ri,
                               di, te, 16, tm)
    with pytest.raises(TypeError, match="int32"):
        md.grouped_ffn_forward(x, w_gu, w_down, ri.long(), di, te, 16, tm)
    with pytest.raises(ValueError, match="multiple of 128"):
        md.grouped_ffn_forward(x[:, :64].contiguous(),
                               w_gu[:, :64].contiguous(), w_down[..., :64]
                               .contiguous(), ri, di, te, 16, tm)
    with pytest.raises(ValueError, match="tile_m"):
        md.grouped_ffn_forward(x, w_gu, w_down, ri, di, te[:4], 16, 32)
    # Shapes that disagree would read or write past a buffer.
    x, w_gu, w_down, dy, (ri, di, te), tm = _moe_inputs(
        cuda, 8, 256, 128, 4, 2, "random", 2)
    with pytest.raises(ValueError, match="w_down has shape"):
        md.grouped_ffn_forward(x, w_gu, w_down.transpose(1, 2).contiguous(),
                               ri, di, te, 16, tm)
    with pytest.raises(ValueError, match="row_ids has shape"):
        md.grouped_ffn_forward(x, w_gu, w_down, ri[:-tm], di, te, 16, tm)
    with pytest.raises(ValueError, match="g has shape"):
        md.grouped_ffn_backward_dx(x, dy[:, :128].contiguous(), w_gu, w_down,
                                   ri, di, te, tm)
    dh = torch.zeros(ri.shape[0] - tm, 256, dtype=torch.bfloat16,
                     device=cuda)
    with pytest.raises(ValueError, match="rhs has shape"):
        md.grouped_ffn_backward_dw_gu(x, dh, ri, te, 4, tm)
    a = torch.zeros(ri.shape[0], 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="ids has shape"):
        md.grouped_ffn_backward_dw_down(a, dy, di[:-tm], te, 4, tm)


def test_dw_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """The dw kernels gather exactly one operand, rank at most 1024
    experts, and take bf16."""
    from dlrover_tpu_torch.ops import fused_ce as fc
    from dlrover_tpu_torch.ops import moe_dispatch as md

    x, _, _, dy, (ri, di, te), tm = _moe_inputs(cuda, 8, 128, 128, 4, 2,
                                                "random", 3)
    dh = torch.zeros(ri.shape[0], 256, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="exactly one"):
        md._dw_kernel("grouped_ffn_backward_dw_gu", x, dh, ri, ri, te, 4, tm)
    with pytest.raises(ValueError, match="exactly one"):
        md._dw_kernel("grouped_ffn_backward_dw_gu", dh, dh, None, None, te,
                      4, tm)
    with pytest.raises(ValueError, match="at most 1024"):
        md.grouped_ffn_backward_dw_gu(x, dh, ri, te, 1025, tm)
    with pytest.raises(TypeError, match="bfloat16"):
        md.grouped_ffn_backward_dw_down(dh.float(), dy.float(), di, te, 4, tm)
    xc, w, tgt, logz, a, b = _ce_inputs(cuda, 16, 128, 40, False, 1)
    with pytest.raises(TypeError, match="bfloat16"):
        fc.fused_ce_backward_dw(xc.float(), w.float(), tgt, logz, a, b)
    with pytest.raises(ValueError, match="d 96"):
        fc.fused_ce_backward_dw(xc[:, :96].contiguous(), w[:96], tgt, logz,
                                a, b)


def test_moe_train_step_on_card_matches_cpu(cuda):
    """A dropless MoE TpuLM at tiny widths, bf16: one make_train_step
    step through B7/B8 on the card against the same step on the CPU (the
    plain versions): loss within rtol 2e-3 (bf16 rounding at other
    places) and each kernel launched."""
    from dlrover_tpu_torch.ops import moe_dispatch as md
    from dlrover_tpu_torch.trainer import train_step as ts

    cfg = llama.tiny_config(n_layers=2, embed_dim=128, n_heads=1,
                            n_kv_heads=1, head_dim=128, mlp_dim=128,
                            n_experts=4, moe_top_k=2, moe_impl="dropless",
                            dtype="bfloat16")
    toks = np.random.RandomState(0).randint(0, 256, (2, 65)).astype(np.int32)
    losses = {}
    for device in ("cpu", "cuda"):
        params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
        params = {k: ({n: t.to(device) for n, t in v.items()}
                      if isinstance(v, dict) else v.to(device))
                  for k, v in params.items()}
        tc = ts.TrainConfig(warmup_steps=2)
        opt = ts.make_optimizer(tc)
        state = ts.init_train_state(cfg, opt, params)
        md.reset_launch_counts()
        _, m = ts.make_train_step(cfg, tc, opt, device=device)(
            state, {"tokens": toks})
        losses[device] = float(m["loss"])
        if device == "cuda":
            assert all(n > 0 for n in md.launch_counts.values())
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=2e-3)


def test_moe_generate_on_card_launches_b7(cuda):
    from dlrover_tpu_torch.ops import moe_dispatch as md

    cfg = llama.tiny_config(n_layers=2, embed_dim=128, n_heads=1,
                            n_kv_heads=1, head_dim=128, mlp_dim=128,
                            n_experts=4, moe_top_k=2, moe_impl="dropless",
                            dtype="bfloat16")
    params = llama.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                               device=cuda)
    md.reset_launch_counts()
    out = gen.generate(cfg, params, np.ones((2, 5), np.int32), 4,
                       device=cuda)
    assert out.tokens.shape == (2, 4)
    # one launch per layer per forward: the prefill and 3 decode steps
    assert md.launch_counts["grouped_ffn_forward"] == 2 * 4


@pytest.mark.parametrize("fenced", [True, False])
def test_async_snapshot_before_inplace_step_equals_sync_snapshot(
        cuda, tmp_path, monkeypatch, fenced):
    """A flash checkpoint launched right before an in-place optimizer
    step lands in shm with the bits of a blocking snapshot of the same
    step: the step waits on the copy's event (through the state's
    ``fences``, or at once without them)."""
    import uuid

    from dlrover_tpu_torch.flash_ckpt.engine import CheckpointEngine
    from dlrover_tpu_torch.ops.attention import dot_product_attention
    from dlrover_tpu_torch.trainer import runtime
    from dlrover_tpu_torch.trainer import train_step as ts

    monkeypatch.setattr(runtime, "_context", None)
    cfg = llama.tiny_config(n_layers=2, vocab_size=32000, embed_dim=512,
                            mlp_dim=2048)
    tc = ts.TrainConfig(learning_rate=1e-2, warmup_steps=1)
    opt = ts.make_optimizer(tc)
    state = ts.init_train_state(cfg, opt, llama.init_params(
        cfg, torch.Generator(cuda).manual_seed(0), device=cuda))
    step = ts.make_train_step(cfg, tc, opt, device=cuda, loss_fn=(
        lambda p, b: llama.loss_fn(cfg, p, b,
                                   attention_fn=dot_product_attention)))
    toks = torch.randint(0, cfg.vocab_size, (4, 257),
                         generator=torch.Generator(cuda).manual_seed(1),
                         device=cuda)
    for _ in range(2):
        state, _ = step(state, {"tokens": toks})
    job = f"cardsnap{uuid.uuid4().hex[:10]}"
    engines = {}
    for kind in ("sync", "async"):
        monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"{job}{kind}")
        engines[kind] = CheckpointEngine(str(tmp_path / kind),
                                         standalone=True)
    try:
        engines["sync"].save_to_memory(2, ts.state_tree(state))
        engines["async"].save_to_memory_async(
            2, ts.state_tree(state),
            fences=state["fences"] if fenced else None)
        state, _ = step(state, {"tokens": toks})  # in place, at once
        assert engines["async"].wait_async_save(60)
        regions = []
        for engine in engines.values():
            meta = engine._shm.load_meta()  # noqa: SLF001
            regions.append(engine._shm.data_region(meta).clone())  # noqa: SLF001
        assert torch.equal(regions[0], regions[1])
        _, snap, _ = engines["sync"].load()
        assert not torch.equal(ts.param_leaves(snap["params"])[0],
                               ts.param_leaves(state["params"])[0].cpu())
    finally:
        for engine in engines.values():
            engine._shm.unlink()  # noqa: SLF001
            engine.close()
