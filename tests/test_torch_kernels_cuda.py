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
logz (f32) within rtol 1e-5; dx and dw elementwise (see _ce_ratio)."""

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.models import generate as gen
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops import decode_attention as da
from dlrover_tpu_torch.ops import flash_attention as fa
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


def test_fused_ce_kernels_rerun_bitwise(cuda):
    """One owner per output element and a fixed order of sums: a second
    launch gives the same bits."""
    from dlrover_tpu_torch.ops import fused_ce as fc

    x, w, tgt, logz, a, b = _ce_inputs(cuda, 200, 256, 999, True, 3)
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
