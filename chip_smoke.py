"""Smoke run of the PyTorch port on one NVIDIA GPU (sm_90a: H100).

    python3 chip_smoke.py

Drives ``dlrover_tpu_torch`` (and nothing of the JAX package) through
its serving and training paths at the full width and depth of the
flagship TpuLM (vocab 32000, embed 1024, 16 layers, 8 heads of 128, mlp
4096, bf16 compute, f32 master params; random weights from a seed), in
phases that each print JSON lines:

1. device: the card's name, and its power limit from nvidia-smi;
2. build: the CUDA kernels, compiled from ``dlrover_tpu_torch/ops/csrc``;
3. kernels: every kernel against its plain PyTorch version on the card,
   with its time (CUDA events, cold L2), its bound, the plain version's
   time and a library call's time. Decode attention (B5) at the main
   path's shape and at the flagship and GQA decode shapes, also at fills
   on every edge of its split-K partition; flash attention forward (B1)
   and its dq and dk/dv backward kernels (B2) at the training shape
   (b=8, s=2048, h=kh=8, d=128, causal), a GQA shape (b=2, h=32, kh=8), a
   non-causal one and a ragged s=1000, each held elementwise and with a
   planted fault its bound must reject; B1, B2 (dq and dk/dv, at all
   four flash shapes), B5 and B6 give the same bytes on a second call;
4. generate(): b=8, prompt 128, 256 new tokens, fp and int8 KV caches;
5. ServingEngine: 8 slots, max_len 1024, 16 greedy requests;
6. train: ``make_train_step`` on the flagship, remat ``mlp_only``,
   micro-batch 8 x seq 2048 with ``grad_accum`` 2 (the JAX package's
   compute phase uses 16; cut for this script's time limit). One
   grad_accum=1 step through the kernels against the same step through
   plain attention (loss, grad norm and every leaf's gradient), and a
   planted fault the gradient gate must reject; 6 steps through the
   kernels with falling loss,
   exact kernel launch counts and a second run from the same seed that
   gives the same losses; step time, tokens/s, model FLOP share, peak
   memory and a profiled step;
7. fused CE kernels: B3 (forward) and B4 (dx, dw) against their plain
   versions at the CE A/B shape (n=16384, d=1024, V=32000, bf16), a
   ragged one (n=4100, V=32003) and a masked one (30% of the rows with
   weight 0), elementwise, each with planted faults the same bounds must
   reject (B3 also without the last 128 vocab columns, inside its
   256-column tile); B3, B4 dx and B4 dw give the same bits on a second
   call;
   times, bounds and the dense route's time;
8. CE A/B (the JAX package's ``bench.py`` ``ce_ab_phase``): loss, dx and
   dw at n=16384, d=1024, V=32000 through the dense logits, the chunked
   fused CE and the B3/B4 kernels: ms and peak memory of each;
9. train through the fused CE: one grad_accum=1 flagship step each
   through the dense CE, the chunked fused CE (``DLROVER_TPU_FUSED_CE=on``)
   and a ``loss_fn`` that reaches B3/B4, held against the dense step
   with a planted fault the gates must reject; then 3 steps through
   B3/B4 with falling loss, exact launch counts and a bitwise rerun;
10. paged decode attention (B6) against its plain version, fp and int8,
    through a shuffled block table over a pool larger than the batch
    needs and filled with noise, with stale ids past every row's fill:
    the paged engine's shape (b=16, h=kh=8, d=128, block 16, 64 blocks a
    row, 513 blocks; int8 also over its engine's 993 blocks) with
    fills that include 0, 1, 15, 16, 17 and 1024 (and, apart, fills on
    every split edge), GQA h=32/kh=8, and blocks of 32 and 128 rows;
    times, the bytes bound, and gather + SDPA
    as the library call. Two planted faults the same tolerance must
    reject (a kernel that ignores the table, one that drops a row's last
    partly filled block), and whether B6 through an identity table
    equals B5 bit for bit (reported);
11. PagedServingEngine on the flagship, full depth: (a) fp at the bytes
    of phase 5's flat engine and twice its slots (16 slots, 513 blocks
    of 16 rows), 32 greedy requests (prompts 16-300, 32-128 new tokens,
    60% opening with one shared 48-token prefix), run twice from the
    same seed; (b) the same requests over 129 blocks, which forces cache
    eviction and preemption and must give the same tokens; (c) an int8
    pool at equal bytes (993 blocks), 16 slots. The prefill chunk is
    32, not phase 5's 64: a resume point is chunk-aligned, so chunks of
    64 would discard every hit on a 48-token prefix (48 -> 0). Checks:
    every request complete, no step errors, the teacher-forced argmax
    gap, prefix hits that skip prefill, block conservation with no block
    left in use, and B6 launched exactly n_layers times per decode step.
    Then 20 steps of an fp and an int8 engine under the profiler.
11a. speculative decoding on the flat engine (phase 5's settings) over
    phase 5's 16 requests with prompts ``p + greedy(p) + p`` from phase
    5's own output: spec off, n-gram K = 3, early exit K = 3 over 4
    layers. Every request complete, no step error, the teacher-forced
    gap within ARGMAX_GAP, more than one token a verify step, and exact
    B5 launches from the engine's step counts (n_layers a decode step,
    4 x 3 a draft call, warmup included: a spec engine decodes only in
    its warmup); decode tokens/s against spec off, accept rate, the
    draft/verify split and the share of tokens equal to spec off's;
11b. the same on the paged engine at phase 11's settings: fp spec off,
    n-gram and early exit; int8 spec off and n-gram (B6 exact, block
    conservation);
12. MoE kernels: the grouped FFN forward (B7) and its dx, dw_gu and
    dw_down kernels (B8) against their plain versions at the MoE
    training shape (8 x 2048 tokens, d = f = 1024, 8 experts, top-2,
    routed by a router), a skewed routing (half the copies on one
    expert, one expert empty) and a decode step (8 tokens), elementwise
    as B4, each with a planted fault the same bound must reject; B7, B8
    dx, dw_gu and dw_down give the same bits on a second call; times,
    bounds, and the per-expert matmul loop as the library yardstick, B8
    dx's two launches also apart;
13. MoE ``generate()`` on ``moe_config()`` (bench.py's moe_phase model:
    the flagship's attention, 8 experts of mlp 1024, top-2, dropless,
    535M params, 233M active): b=8, prompt 128, 256 new tokens, fp
    cache; a bitwise rerun and exact B5 and B7 launches. Routing flips
    (positions whose top-2 expert set differs between the cached path
    and the teacher-forced forward at some layer) are counted and
    reported, not bounded. The teacher-forced gap is held to ARGMAX_GAP
    at every position once the forward is pinned to the decode path's
    routing, and at every position without a flip in the free forward;
    every flip at the first layer must be a near-tie (MOE_TIE);
14. MoE ``ServingEngine``: phase 5's 16 requests, every one complete;
    tokens/s and TTFT;
14a. MoE ``PagedServingEngine`` at phase 11's fp settings over phase
    14's requests with prompts ``p + greedy(p) + p``: spec off and
    n-gram K = 3, the gates of 11a (the gap reported, as phase 14) with
    exact B6 and B7 launches (n_layers B7 launches a prefill, decode or
    verify step);
15. MoE training: ``make_train_step``, remat ``mlp_only``, micro-batch 8
    x 2048, grad_accum 1. One step through the kernels against the same
    step through the plain grouped FFN (TRAIN_GATES) with a planted
    fault the gates must reject; 6 steps with falling loss, a bitwise
    rerun, exact B1, B2, B7 and B8 launches; step time, tokens/s, the
    share of the bf16 peak on 6 x active params a token, peak memory
    and a profiled step.

Phases 4, 5, 11 and 11a-b check the tokens against the argmax of the
port's own teacher-forced forward over prompt + output, check that
repeated runs agree, and read the kernels' launch counters to show the
decode path went through them. Any failure raises (exit code 1) before the last
line, which is ``{"ok": true, "device": {...}}``; before it come the
ptxas lines of the redesigned sources (registers, spills and the C75xx
performance notes of each entry function: B1 and B2's four flash
kernels, B5/B6, B3/B4 and B7/B8 with the rest of their files) with the
dynamic shared memory, tile and cluster size of the B3, B4 dx, B4 dw,
B7, B8 dx (first launch) and B8 dw launches, the card's name and power
limit, and the ``kernels`` line.
"""

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "int8": 1979e12}
# Training phase: micro-batch x seq, grad_accum (cut from 16), steps.
TRAIN_MICRO, TRAIN_SEQ, TRAIN_GA, TRAIN_STEPS = 8, 2048, 2, 6
# A flash kernel's output passes against its plain version when every
# element has |got - ref| <= FLASH_REL |ref| + FLASH_ROW rms_d(ref) +
# FLASH_FLOOR rms(ref): rms_d over the head dim of the element's own
# query row (out, dq) or key (dk, dv), rms over the whole tensor (see
# phase_flash_kernels).
FLASH_REL, FLASH_ROW, FLASH_FLOOR = 2e-2, 2e-2, 1e-3
# The grad_accum=1 step through the kernels against the same step through
# plain attention (see phase_train): relative loss and grad norm gaps,
# and the largest per-leaf relative L2 distance of the clipped gradients.
TRAIN_GATES = {"loss": 1e-4, "grad_norm": 2e-4, "grads": 5e-2}
# Largest gap (logit units) allowed between the max teacher-forced logit
# and the logit of the token the decode path chose: the forward and the
# cached decode round to bf16 at different places (and int8 caches
# quantize K/V), so near-ties may break either way; a wrong token from
# a broken kernel lands far below the max.
ARGMAX_GAP = {"fp": 0.25, "int8": 0.5}
# Fused CE (B3, B4). The CE A/B shape (bench.py ce_ab_phase) and z-loss.
CE_N, CE_D, CE_V, CE_Z = 16384, 1024, 32000, 1e-4
# B3's per_tok and logz pass within CE_STAT_REL |ref| of the plain
# version (f32 sums of the same bf16 products in another order). B4's dx
# and dw pass elementwise within CE_REL |ref| + CE_ROW rms_d(ref) +
# CE_FLOOR rms(ref), rms_d over d of the element's row (dx) or vocab
# column (dw), as the flash bound (see phase_ce_kernels).
CE_STAT_REL = 1e-5
CE_REL, CE_ROW, CE_FLOOR = 2e-2, 2e-2, 1e-3
# A grad_accum=1 step through a fused CE route against the same step
# through the dense CE (see phase_train_ce): as TRAIN_GATES.
CE_TRAIN_GATES = {"loss": 1e-4, "grad_norm": 2e-4, "grads": 5e-2}
CE_TRAIN_STEPS = 3
# MoE training (bench.py moe_phase): micro-batch x seq, grad_accum 1, steps.
MOE_MICRO, MOE_SEQ, MOE_STEPS = 8, 2048, 6
# MoE generate(): a routing flip at the first layer, where the cached
# decode path and the teacher-forced forward read the same K/V and only
# rounding separates them, must be a near-tie: the forward's router has
# its k-th and (k+1)-th expert within MOE_TIE in log-probability (see
# phase_moe_generate).
MOE_TIE = 0.1


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def flagship_config():
    from dlrover_tpu_torch.models import llama

    return llama.TpuLMConfig(
        vocab_size=32000, embed_dim=1024, n_layers=16, n_heads=8,
        n_kv_heads=8, head_dim=128, mlp_dim=4096, dtype="bfloat16",
    )


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    return smi


def phase_build():
    """Builds every kernel source; returns nvcc's ptxas lines per source
    (entry functions, registers, shared memory, spills)."""
    from dlrover_tpu_torch.ops import _ext

    t0 = time.monotonic()
    per_source = _ext.build()
    ptxas = {s: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "entry function" in ln or "C75" in ln]
             for s, log in _ext.build_logs.items()}
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "per_source_s": per_source, "ptxas": ptxas})
    return ptxas


# ---- kernels -----------------------------------------------------------


def _time_ms(fn, iters=20):
    """Mean device time of one call, with the 50 MB L2 flushed before
    each call (the decode path finds each layer's cache cold). A long
    device-side sleep holds the GPU while the host enqueues every call,
    so the events time the device and not the host's launch overhead."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)  # ~0.1 s of GPU clock cycles
    for start, end in zip(starts, ends):
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def _decode_inputs(b, h, kh, d, max_len, lengths, kv, gen):
    from dlrover_tpu_torch.ops.kv_quant import quantize_kv

    q = torch.randn(b, h, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, max_len, kh, d, generator=gen,
                    device="cuda").bfloat16()
    v = torch.randn(b, max_len, kh, d, generator=gen,
                    device="cuda").bfloat16()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if kv == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        return q, k, v, lens, (ks, vs)
    return q, k, v, lens, ()


def _decode_bound(q, k, lens, kv, tables=None):
    """Least time for this call's work: the bytes it must move (each
    input read once, the output written once; only filled cache rows,
    and for a paged cache the block table) over the HBM rate, against
    the q.k and p.v flops over the peak rate of the inputs' type. ``k``
    is a flat cache [b, max_len, kh, d], or with ``tables`` [b,
    max_blocks] a pool [num_blocks, block_size, kh, d]."""
    from dlrover_tpu_torch.ops.kv_quant import bytes_per_head_row

    b, h, d = q.shape
    kh = k.shape[2]
    max_len = k.shape[1] * (1 if tables is None else tables.shape[1])
    rows = int(torch.clamp(lens, 0, max_len).sum())
    row_bytes = kh * bytes_per_head_row(d, kv, fp_itemsize=k.element_size())
    moved = 2 * rows * row_bytes + 2 * q.numel() * q.element_size() \
        + lens.numel() * 4 + (0 if tables is None else tables.numel() * 4)
    flops = 4 * rows * (h // kh) * kh * d
    rate = PEAK_OPS_PER_S["int8" if kv == "int8" else "bfloat16"]
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", moved)


def _sdpa_call(q, k, v, lens, scales=()):
    """The library's route to the kernel's function: one masked SDPA
    call, after an int8 cache (``scales`` given) is dequantised to bf16
    inside the timed call (rows of fill 0 give NaN there; it is only
    timed)."""
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops.kv_quant import dequantize_kv

    b, h, d = q.shape
    _, max_len, kh, _ = k.shape
    qs = q[:, :, None, :]
    mask = (torch.arange(max_len, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]

    def call():
        kk, vv = k, v
        if scales:
            kk = dequantize_kv(k, scales[0], torch.bfloat16)
            vv = dequantize_kv(v, scales[1], torch.bfloat16)
        return F.scaled_dot_product_attention(
            qs, kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=mask,
            enable_gqa=h != kh)

    return call


def _split_edges(b, h, kh, max_len):
    """Fills on every edge of the kernel's split-K partition of max_len
    (B5/B6, see ``ops/decode_attention.split_plan``): 0, 1, split - 1,
    split, split + 1 and max_len, the rest of the batch at random."""
    from dlrover_tpu_torch.ops import decode_attention as da

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split, _ = da.split_plan(b, h, kh, max_len, sms)
    return [0, 1, split - 1, split, split + 1, max_len], split


def _check_rerun(name, call):
    """A redesigned kernel gives the same bytes from run to run: two
    calls on the same inputs agree bit for bit (every output tensor)."""
    first, second = call(), call()
    torch.cuda.synchronize()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    check(same, f"{name}: two calls on the same inputs differ")
    return same


def phase_kernels():
    from dlrover_tpu_torch.ops import decode_attention as da

    gen = torch.Generator("cuda").manual_seed(SEED)
    # (label, b, h, kh, d, max_len): the generate() step of phase 4, the
    # flagship decode shape at a 2048-row cache, and the default
    # TpuLMConfig's GQA (4 query heads per kv head).
    shapes = [
        ("main_path", 8, 8, 8, 128, 384),
        ("flagship_2048", 8, 8, 8, 128, 2048),
        ("gqa_2048", 8, 32, 8, 128, 2048),
    ]
    rs = np.random.RandomState(SEED)
    # The split-edge inputs draw from streams of their own, so the timed
    # rows keep the inputs of earlier runs.
    edge_gen = torch.Generator("cuda").manual_seed(SEED + 9)
    edge_rs = np.random.RandomState(SEED + 9)
    results = {}
    for label, b, h, kh, d, max_len in shapes:
        # Ragged fills: empty, one row, full, the rest at random.
        lengths = [0, 1, max_len] + list(
            rs.randint(2, max_len, size=b - 3)
        )
        for kv in ("fp", "int8"):
            q, k, v, lens, scales = _decode_inputs(
                b, h, kh, d, max_len, lengths, kv, gen
            )
            got = da.decode_attention(q, k, v, lens, *scales)
            torch.cuda.synchronize()
            want = da.decode_attention_reference(q, k, v, lens, *scales)
            err = (got.float() - want.float()).abs()
            # bf16 outputs: both round one f32 result, summed in another
            # order.
            ok = bool(torch.all(err <= 1e-2 + 1e-2 * want.float().abs()))
            check(ok, f"{label}/{kv}: kernel disagrees, max err "
                      f"{float(err.max())}")
            check(bool(torch.all(got[0] == 0)),
                  f"{label}/{kv}: fill-0 row not zero")
            bitwise = _check_rerun(
                f"{label}/{kv}",
                lambda: da.decode_attention(q, k, v, lens, *scales))
            edges, split = _split_edges(b, h, kh, max_len)
            edge_lengths = edges + list(
                edge_rs.randint(2, max_len, size=b - len(edges)))
            eq, ek, ev, elens, escales = _decode_inputs(
                b, h, kh, d, max_len, edge_lengths, kv, edge_gen)
            egot = da.decode_attention(eq, ek, ev, elens, *escales)
            torch.cuda.synchronize()
            ewant = da.decode_attention_reference(eq, ek, ev, elens,
                                                  *escales)
            eerr = (egot.float() - ewant.float()).abs()
            check(bool(torch.all(eerr <= 1e-2 + 1e-2 * ewant.float().abs())),
                  f"{label}/{kv}: kernel disagrees at the split edges "
                  f"{edge_lengths}, max err {float(eerr.max())}")
            check(bool(torch.all(egot[0] == 0)),
                  f"{label}/{kv}: fill-0 row not zero at the split edges")
            del eq, ek, ev, escales
            ms = _time_ms(lambda: da.decode_attention(q, k, v, lens,
                                                      *scales))
            plain_ms = _time_ms(lambda: da.decode_attention_reference(
                q, k, v, lens, *scales))
            library_ms = _time_ms(_sdpa_call(q, k, v, lens, scales))
            bound_ms, bound_by, moved = _decode_bound(q, k, lens, kv)
            row = {
                "phase": "kernel", "shape": label, "kv": kv,
                "b": b, "h": h, "kh": kh, "d": d, "max_len": max_len,
                "lengths": [int(x) for x in lengths],
                "max_abs_err": float(err.max()), "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "library": ("int8 -> bf16 dequantise, then " if scales
                            else "") + "SDPA + mask",
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": moved, "bound_share": bound_ms / ms,
                "bitwise_rerun": bitwise, "split_rows": split,
                "split_edge_lengths": [int(x) for x in edge_lengths],
                "split_edge_max_abs_err": float(eerr.max()),
            }
            emit(row)
            results[(label, kv)] = row
    return results


def _flash_bound(name, q, k, causal):
    """Least time for one flash kernel's work: the larger of its bytes
    (inputs read once, outputs written once) over the HBM rate and its
    tensor-core flops over the bf16 peak. Causal work counts the
    s(s+1)/2 visible (row, key) pairs; per pair and head dim a product
    costs 2 flops: B1 runs QK^T and PV, dq runs QK^T, dO.V^T and dS.K,
    dk/dv runs QK^T, dO.V^T, P^T.dO and dS^T.Q."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    pairs = sq * (sq + 1) // 2 if causal else sq * skv
    products = {"flash_forward": 2, "flash_backward_dq": 3,
                "flash_backward_dkv": 4}[name]
    flops = 2 * products * b * h * d * pairs
    q_bytes, kv_bytes = q.numel() * 2, k.numel() * 2
    stats = b * h * sq * 4
    moved = {
        "flash_forward": q_bytes + 2 * kv_bytes + q_bytes + stats,
        "flash_backward_dq": 3 * q_bytes + 2 * kv_bytes + 2 * stats,
        "flash_backward_dkv": 2 * q_bytes + 4 * kv_bytes + 2 * stats,
    }[name]
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_OPS_PER_S["bfloat16"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", moved, flops)


def _sdpa_fwd_bwd(q, k, v, do, causal):
    """One library forward call, and one library backward call (dq, dk
    and dv together) on a graph built once, both on the same inputs;
    only timed."""
    import torch.nn.functional as F

    h, kh = q.shape[2], k.shape[2]
    leaves = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(
            *leaves, is_causal=causal, enable_gqa=h != kh
        )

    out = fwd()
    return fwd, lambda: torch.autograd.grad(out, leaves, dot,
                                            retain_graph=True)


def _flash_ratio(got, want):
    """Largest |got - want| / (FLASH_REL |want| + FLASH_ROW rms_d(want) +
    FLASH_FLOOR rms(want)) over a ``[b, s, heads, d]`` tensor; at most 1
    passes."""
    want = want.float()
    sq = want.square()
    tol = (FLASH_REL * want.abs()
           + FLASH_ROW * sq.mean(dim=-1, keepdim=True).sqrt()
           + FLASH_FLOOR * sq.mean().sqrt())
    return float(((got.float() - want).abs() / tol).max())


def _planted_faults(q, k, v, do, lse, delta, causal):
    """What kernels that skip their last 64-wide tile would return, from
    the plain versions: B1 and B2's dq without the last kv tile (with
    the full rows' lse and delta, as such a dq kernel would read them),
    B2's dk/dv without the last q tile (its keys get no gradient)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    cut = 64 * ((q.shape[1] - 1) // 64)
    out, _ = fa.flash_attention_reference(q, k[:, :cut], v[:, :cut], causal)
    dq = fa._plain_backward(q, k[:, :cut], v[:, :cut], lse, do, delta,
                            causal, None, want_dkv=False)[0]
    _, dk, dv = fa._plain_backward(q[:, :cut], k, v, lse[..., :cut],
                                   do[:, :cut], delta[..., :cut], causal,
                                   None, want_dq=False)
    return {"out": out, "dq": dq, "dk": dk, "dv": dv}


# B1/B2's shapes in phase_flash_kernels: label, b, s, h, kh, d, causal.
FLASH_SHAPES = (
    ("train", TRAIN_MICRO, TRAIN_SEQ, 8, 8, 128, True),
    ("gqa", 2, 2048, 32, 8, 128, True),
    ("full", 2, 2048, 8, 8, 128, False),
    ("ragged_1000", 2, 1000, 8, 8, 128, True),
)


def flash_inputs():
    """Each of FLASH_SHAPES with its q, k, v and dO (bf16, on the card),
    drawn in turn from one generator seeded SEED + 3."""
    gen = torch.Generator("cuda").manual_seed(SEED + 3)
    for label, b, s, h, kh, d, causal in FLASH_SHAPES:
        shapes = ((b, s, h, d), (b, s, kh, d), (b, s, kh, d), (b, s, h, d))
        yield (label, b, s, h, kh, d, causal,
               tuple(torch.randn(shape, generator=gen, device="cuda")
                     .bfloat16() for shape in shapes))


def phase_flash_kernels():
    """B1 and B2 against their plain versions, at the training shape and
    three more. lse is f32 from the same f32 sums, within 1e-3. out, dq,
    dk and dv are bf16 and pass elementwise (see _flash_ratio). The
    kernel rounds P to bf16 from a running max and the plain version
    from the final one, and both round dS to bf16 from dP sums in
    another order, so a few P and dS elements round the other way: an
    element's error scales with the size of its own row or key, not the
    tensor's. That size spans decades under a causal mask: row i (key
    j) spreads over ~i (s - j) terms, so early rows and keys are ~1 and
    late ones ~1/sqrt(s). The bound follows it through the row's (key's)
    rms over the head dim; the relative term covers large elements, and
    the tensor-wide floor covers rows that are all rounding noise (dq of
    row 0, where dP - delta cancels). A bound scaled to the largest
    value would pass garbage in the late rows. Every shape also plants a
    fault (kernels that skip their last tile, see _planted_faults) and
    checks that the same bound rejects it. B1, dq and dk/dv each give
    the same bits on a second call (``bitwise_rerun``)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    rows = {}
    for label, b, s, h, kh, d, causal, (q, k, v, do) in flash_inputs():
        out, lse = fa.flash_forward(q, k, v, causal)
        torch.cuda.synchronize()
        bitwise = {"out": _check_rerun(
            f"flash_forward/{label}",
            lambda: fa.flash_forward(q, k, v, causal))}
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal)
        out_err = (out.float() - ref_out.float()).abs()
        lse_err = float((lse - ref_lse).abs().max())
        check(lse_err <= 1e-3, f"flash_forward/{label}: lse err {lse_err}")
        delta = fa.flash_backward_delta(do, ref_out)
        dq = fa.flash_backward_dq(q, k, v, do, ref_lse, delta, causal)
        dk, dv = fa.flash_backward_dkv(q, k, v, do, ref_lse, delta, causal)
        torch.cuda.synchronize()
        bitwise["dq"] = _check_rerun(
            f"flash_backward_dq/{label}",
            lambda: fa.flash_backward_dq(q, k, v, do, ref_lse, delta, causal))
        bitwise["dkv"] = _check_rerun(
            f"flash_backward_dkv/{label}",
            lambda: fa.flash_backward_dkv(q, k, v, do, ref_lse, delta,
                                          causal))
        refs = dict(zip(("dq", "dk", "dv"), fa.flash_backward_reference(
            q, k, v, ref_out, ref_lse, do, causal)))
        refs["out"] = ref_out
        got = {"out": out, "dq": dq, "dk": dk, "dv": dv}
        ratio = {n: _flash_ratio(got[n], refs[n]) for n in got}
        grad_err = {n: float((got[n].float() - refs[n].float()).abs().max())
                    for n in ("dq", "dk", "dv")}
        faults = _planted_faults(q, k, v, do, ref_lse, delta, causal)
        fault_ratio = {n: _flash_ratio(faults[n], refs[n]) for n in got}
        # The planted fault against a bound of 1e-2 max|ref|, for the
        # gradients: how far a bound scaled to the largest value sees.
        fault_vs_max = {
            n: float((faults[n].float() - refs[n].float()).abs().max())
            / (1e-2 * float(refs[n].float().abs().max()))
            for n in ("dq", "dk", "dv")}
        emit({"phase": "flash_bounds", "shape": label, "ratio": ratio,
              "bitwise_rerun": bitwise,
              "planted_fault_ratio": fault_ratio,
              "planted_fault_vs_1e-2_max_ref": fault_vs_max})
        for n in got:
            check(ratio[n] <= 1.0, f"flash/{label}: {n} at {ratio[n]} of "
                                   f"its bound")
            check(fault_ratio[n] > 1.0,
                  f"flash/{label}: the {n} bound passes a kernel that "
                  f"skips its last tile ({fault_ratio[n]})")
        del refs, ref_out, got, faults, dq, dk, dv
        library_ms = {"sdpa forward": None,
                      "sdpa backward (dq, dk, dv in one call)": None}
        for lib_name, lib in zip(library_ms,
                                 _sdpa_fwd_bwd(q, k, v, do, causal)):
            library_ms[lib_name] = _time_ms(lib)
        kernel_calls = {
            "flash_forward": (
                lambda: fa.flash_forward(q, k, v, causal),
                lambda: fa.flash_attention_reference(q, k, v, causal),
                "sdpa forward", float(out_err.max())),
            "flash_backward_dq": (
                lambda: fa.flash_backward_dq(q, k, v, do, ref_lse, delta,
                                             causal),
                lambda: fa._plain_backward(q, k, v, ref_lse, do, delta,
                                           causal, None, want_dkv=False),
                "sdpa backward (dq, dk, dv in one call)", grad_err["dq"]),
            "flash_backward_dkv": (
                lambda: fa.flash_backward_dkv(q, k, v, do, ref_lse, delta,
                                              causal),
                lambda: fa._plain_backward(q, k, v, ref_lse, do, delta,
                                           causal, None, want_dq=False),
                "sdpa backward (dq, dk, dv in one call)",
                max(grad_err["dk"], grad_err["dv"])),
        }
        for name, (kernel, plain, lib_name, err) in kernel_calls.items():
            ms = _time_ms(kernel)
            plain_ms = _time_ms(plain, iters=5)
            bound_ms, bound_by, moved, flops = _flash_bound(name, q, k,
                                                            causal)
            row = {
                "phase": "kernel", "kernel": name, "shape": label, "b": b,
                "s": s, "h": h, "kh": kh, "d": d, "causal": causal,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms[lib_name], "library": lib_name,
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
                "flops": flops, "bound_share": bound_ms / ms,
                "tflops": flops / ms / 1e9,
            }
            row["bitwise_rerun"] = bitwise[
                {"flash_forward": "out", "flash_backward_dq": "dq",
                 "flash_backward_dkv": "dkv"}[name]]
            if name == "flash_forward":
                row["lse_max_abs_err"] = lse_err
            emit(row)
            rows[(name, label)] = row
        del kernel_calls
        torch.cuda.empty_cache()
    return rows


# ---- paged decode attention (B6) ---------------------------------------


def _paged_inputs(b, h, kh, d, bs, mb, nb, lengths, kv, gen, rs):
    """q, pools of ``nb`` blocks filled with noise, and a table that
    hands each row its blocks from a shuffle of 1..nb-1; entries past a
    row's fill name another row's blocks, as a recycled slot's do."""
    from dlrover_tpu_torch.ops.kv_quant import quantize_kv

    q = torch.randn(b, h, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(nb, bs, kh, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(nb, bs, kh, d, generator=gen, device="cuda").bfloat16()
    need = [-(-n // bs) for n in lengths]
    check(sum(need) <= nb - 1, f"paged inputs need {sum(need)} of {nb - 1}")
    ids = rs.permutation(nb - 1) + 1
    tables = np.zeros((b, mb), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = ids[at:at + n]
        at += n
    for i, n in enumerate(need):
        other = tables[(i + 1) % b, :need[(i + 1) % b]]
        stale = other if len(other) else ids[:1]
        tables[i, n:] = np.resize(stale, mb - n)
    tables = torch.from_numpy(tables).cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if kv == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        return q, k, v, tables, lens, (ks, vs)
    return q, k, v, tables, lens, ()


def _paged_sdpa_call(q, k, v, tables, lens, scales=()):
    """The library's route to the kernel's function: gather every row's
    logical cache through the table (an int8 pool with its scales, then
    dequantised to bf16), then one masked SDPA call (rows of fill 0 give
    NaN there; it is only timed)."""
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops.kv_quant import dequantize_kv

    b, h, d = q.shape
    kh = k.shape[2]
    max_len = tables.shape[1] * k.shape[1]
    idx = tables.long()
    mask = (torch.arange(max_len, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]

    def logical(pool, scale):
        rows = pool[idx]
        if scale is not None:
            rows = dequantize_kv(rows, scale[idx], torch.bfloat16)
        return rows.reshape(b, max_len, kh, d).transpose(1, 2)

    def call():
        ks, vs = scales or (None, None)
        return F.scaled_dot_product_attention(
            q[:, :, None, :], logical(k, ks), logical(v, vs), attn_mask=mask,
            enable_gqa=h != kh)

    return call


def phase_paged_kernels():
    from dlrover_tpu_torch.ops import decode_attention as da
    from dlrover_tpu_torch.ops.kv_quant import quantize_kv

    gen = torch.Generator("cuda").manual_seed(SEED + 6)
    rs = np.random.RandomState(SEED + 6)
    # The split-edge inputs draw from streams of their own (see
    # phase_kernels).
    edge_gen = torch.Generator("cuda").manual_seed(SEED + 10)
    edge_rs = np.random.RandomState(SEED + 10)
    # (label, b, h, kh, d, block_size, max_blocks, num_blocks, top random
    # fill, kvs): the fp and the int8 paged engine as served below, then GQA
    # and larger blocks.
    shapes = [
        ("engine", 16, 8, 8, 128, 16, 64, 513, 700, ("fp", "int8")),
        ("engine_int8", 16, 8, 8, 128, 16, 64, 993, 700, ("int8",)),
        ("gqa", 16, 32, 8, 128, 16, 64, 513, 700, ("fp", "int8")),
        ("block_32", 16, 8, 8, 128, 32, 32, 257, 700, ("fp", "int8")),
        ("block_128", 16, 8, 8, 128, 128, 8, 65, 500, ("fp", "int8")),
    ]

    def within(got, want):
        # As B5's rows: bf16 outputs, both round one f32 result, summed
        # in another order.
        err = (got.float() - want.float()).abs()
        return bool(torch.all(err <= 1e-2 + 1e-2 * want.float().abs())), err

    results = {}
    for label, b, h, kh, d, bs, mb, nb, top, kvs in shapes:
        fixed = [0, 1, 15, 16, 17, bs * mb]
        lengths = fixed + [int(x) for x in
                           rs.randint(2, top, size=b - len(fixed))]
        edges, split = _split_edges(b, h, kh, bs * mb)
        edge_lengths = edges + [int(x) for x in
                                edge_rs.randint(2, top, size=b - len(edges))]
        for kv in kvs:
            eq, ek, ev, etables, elens, escales = _paged_inputs(
                b, h, kh, d, bs, mb, nb, edge_lengths, kv, edge_gen, edge_rs
            )
            egot = da.paged_decode_attention(eq, ek, ev, etables, elens,
                                             *escales)
            torch.cuda.synchronize()
            ok, eerr = within(egot, da.paged_decode_attention_reference(
                eq, ek, ev, etables, elens, *escales))
            check(ok, f"paged {label}/{kv}: kernel disagrees at the split "
                      f"edges {edge_lengths}, max err {float(eerr.max())}")
            check(bool(torch.all(egot[0] == 0)),
                  f"paged {label}/{kv}: fill-0 row not zero at the split "
                  f"edges")
            del eq, ek, ev, etables, escales
            q, k, v, tables, lens, scales = _paged_inputs(
                b, h, kh, d, bs, mb, nb, lengths, kv, gen, rs
            )
            got = da.paged_decode_attention(q, k, v, tables, lens, *scales)
            torch.cuda.synchronize()
            want = da.paged_decode_attention_reference(q, k, v, tables, lens,
                                                       *scales)
            ok, err = within(got, want)
            check(ok, f"paged {label}/{kv}: kernel disagrees, max err "
                      f"{float(err.max())}")
            check(bool(torch.all(got[0] == 0)),
                  f"paged {label}/{kv}: fill-0 row not zero")
            bitwise = _check_rerun(
                f"paged {label}/{kv}", lambda: da.paged_decode_attention(
                    q, k, v, tables, lens, *scales))
            # Planted faults, from the plain version: the pool read as if
            # row i's blocks were i * max_blocks + j, and every row cut
            # to its last full block.
            identity = torch.arange(b * mb, dtype=torch.int32,
                                    device="cuda").reshape(b, mb) % nb
            faults = {
                "ignores_table": da.paged_decode_attention_reference(
                    q, k, v, identity, lens, *scales),
                "drops_last_block": da.paged_decode_attention_reference(
                    q, k, v, tables, lens - lens % bs, *scales),
            }
            fault_err = {}
            for name, out in faults.items():
                passed, ferr = within(out, want)
                fault_err[name] = float(ferr.max())
                check(not passed, f"paged {label}/{kv}: the tolerance passes "
                                  f"a kernel that {name}")
            ms = _time_ms(lambda: da.paged_decode_attention(
                q, k, v, tables, lens, *scales))
            plain_ms = _time_ms(lambda: da.paged_decode_attention_reference(
                q, k, v, tables, lens, *scales))
            library_ms = _time_ms(
                _paged_sdpa_call(q, k, v, tables, lens, scales))
            bound_ms, bound_by, moved = _decode_bound(q, k, lens, kv, tables)
            row = {
                "phase": "kernel", "kernel": f"paged_decode_attention_{kv}",
                "shape": label, "kv": kv, "b": b, "h": h, "kh": kh, "d": d,
                "block_size": bs, "max_blocks": mb, "num_blocks": nb,
                "lengths": lengths, "max_abs_err": float(err.max()),
                "planted_fault_max_abs_err": fault_err, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "library": "gather through the table, then "
                           + ("int8 -> bf16 dequantise, " if scales else "")
                           + "SDPA + mask",
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
                "bound_share": bound_ms / ms, "bitwise_rerun": bitwise,
                "split_rows": split, "split_edge_lengths": edge_lengths,
                "split_edge_max_abs_err": float(eerr.max()),
            }
            emit(row)
            results[(label, kv)] = row

    # Reported, not gated: B6 through an identity table against B5 on the
    # same rows (the two share their body, so the bits should agree).
    b, S, h, kh, d, bs = 8, 1024, 8, 8, 128, 16
    q = torch.randn(b, h, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, S, kh, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, S, kh, d, generator=gen, device="cuda").bfloat16()
    lens = torch.tensor([0, 1, 17, S] + list(rs.randint(2, S, size=b - 4)),
                        dtype=torch.int32, device="cuda")
    tables = torch.arange(b * S // bs, dtype=torch.int32,
                          device="cuda").reshape(b, S // bs)
    same = {}
    for kv in ("fp", "int8"):
        caches, scales = (k, v), ()
        if kv == "int8":
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            caches, scales = (kq, vq), (ks, vs)
        flat = da.decode_attention(q, *caches, lens, *scales)
        paged = da.paged_decode_attention(
            q, *(t.reshape(b * S // bs, bs, *t.shape[2:]) for t in caches),
            tables, lens,
            *(t.reshape(b * S // bs, bs, kh) for t in scales))
        same[kv] = bool(torch.equal(flat, paged))
    emit({"phase": "paged_vs_flat", "b": b, "max_len": S, "block_size": bs,
          "identity_table_equals_flat_bitwise": same})
    return results


# ---- main path -----------------------------------------------------------


def _argmax_gaps(cfg, params, seqs, start):
    """Teacher-forced gaps [b, n]: for each token a row produced from
    position ``start`` on, the max logit of the port's forward at the
    previous position less the chosen token's logit; and whether each
    chosen token is that argmax."""
    from dlrover_tpu_torch.models import llama

    with torch.inference_mode():
        logits, _ = llama.forward(cfg, params, seqs)
    pred = logits[:, start - 1:-1]
    chosen = seqs[:, start:].long()
    gap = pred.max(dim=-1).values - pred.gather(-1, chosen[..., None])[..., 0]
    return gap, pred.argmax(dim=-1) == chosen


def _argmax_gap(cfg, params, seqs, start, kv, label, gated=True):
    """The worst teacher-forced gap (held to ARGMAX_GAP[kv] when
    ``gated``) and the share of tokens that are the argmax."""
    gap, hit = _argmax_gaps(cfg, params, seqs, start)
    worst = float(gap.max())
    check(not gated or worst <= ARGMAX_GAP[kv],
          f"{label}: token {worst} logits below the teacher-forced max")
    return worst, float(hit.float().mean())


def _device_profile(fn):
    """Run ``fn`` under torch.profiler. Returns the host wall seconds
    and, per device activity name (kernels, copies, memsets), the count
    and summed device milliseconds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    device = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            n, ms = device.get(evt.name, (0, 0.0))
            device[evt.name] = (n + 1, ms + evt.time_range.elapsed_us() / 1e3)
    return wall, device


def _profile_row(label, wall, device, kernel="decode_attention",
                 match="decode_attention_kernel", top_n=6):
    total = sum(ms for _, ms in device.values())
    attn = sum(ms for name, (_, ms) in device.items() if match in name)
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:top_n]
    return {
        "phase": "profile", "run": label, "wall_ms": wall * 1e3,
        "device_ms": total,
        "device_busy_share": total / (wall * 1e3) if total else None,
        f"{kernel}_ms": attn,
        f"{kernel}_share_of_device": attn / total if total else None,
        "top_device": [[name[:60], n, ms] for name, (n, ms) in top],
    }


def phase_generate(cfg, params):
    from dlrover_tpu_torch.models import generate as gen

    b, prompt_len, new = 8, 128, 256
    prompt = torch.randint(
        0, cfg.vocab_size, (b, prompt_len),
        generator=torch.Generator("cuda").manual_seed(SEED + 1),
        device="cuda", dtype=torch.int32,
    )
    out = {}
    for kv in ("fp", "int8"):
        # Prefill alone, then the full run twice (the second is timed).
        torch.cuda.synchronize()
        t0 = time.monotonic()
        gen.generate(cfg, params, prompt, 1, kv_cache_dtype=kv)
        torch.cuda.synchronize()
        t_prefill = time.monotonic() - t0
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            res = gen.generate(cfg, params, prompt, new, kv_cache_dtype=kv)
            toks = res.tokens.cpu()
            runs.append((toks, time.monotonic() - t0))
            del res
        toks, t_total = runs[1]
        check(toks.shape == (b, new), f"generate/{kv}: shape {toks.shape}")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"generate/{kv}: token out of range")
        check(torch.equal(runs[0][0], toks),
              f"generate/{kv}: two runs disagree")
        seqs = torch.cat([prompt.cpu(), toks], dim=1).cuda()
        worst, agree = _argmax_gap(cfg, params, seqs, prompt_len, kv,
                                   f"generate/{kv}")
        row = {
            "phase": "generate", "kv": kv, "batch": b,
            "prompt_len": prompt_len, "new_tokens": new,
            "total_s": t_total, "prefill_s": t_prefill,
            "decode_tok_s": b * (new - 1) / (t_total - t_prefill),
            "ms_per_step": 1e3 * (t_total - t_prefill) / (new - 1),
            "argmax_gap_max": worst, "argmax_agree": agree,
        }
        emit(row)
        out[kv] = row
        # Where a step's time goes: a profiled run of 32 new tokens
        # (profiling adds host time per op, so the busy share is a
        # lower bound).
        wall, device = _device_profile(lambda: gen.generate(
            cfg, params, prompt, 32, kv_cache_dtype=kv).tokens.cpu())
        emit(_profile_row(f"generate/{kv}/32", wall, device))
    return out


def phase_engine(cfg, params, phase="engine", gated=True):
    """The flat engine: 8 slots, 16 greedy requests. Every request must
    complete; the teacher-forced gap is held to ARGMAX_GAP when
    ``gated``, else reported. Returns the decode-attention and grouped
    FFN launches counted up to the engine's last step, before the
    teacher-forced checks (whose forward launches B7 on a MoE model),
    and each request's (prompt, tokens, max_new_tokens)."""
    from dlrover_tpu_torch.observability.registry import MetricsRegistry
    from dlrover_tpu_torch.ops import decode_attention as da
    from dlrover_tpu_torch.ops import moe_dispatch as md
    from dlrover_tpu_torch.serving import ServingEngine

    rs = np.random.RandomState(SEED + 2)
    prompts = [rs.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in rs.randint(16, 301, size=16)]
    news = [int(n) for n in rs.randint(32, 129, size=16)]
    reg = MetricsRegistry()
    eng = ServingEngine(cfg, params, slots=8, max_len=1024,
                        prefill_chunk=64, registry=reg)
    eng.warmup()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs = [eng.submit(p, n) for p, n in zip(prompts, news)]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {**da.launch_counts, **md.launch_counts}
    for r, n in zip(reqs, news):
        check(r.state == "done" and not r.failed and not r.truncated,
              f"{phase}: request {r.rid} ended {r.state} "
              f"failed={r.failed} truncated={r.truncated}")
        check(len(r.tokens) == n,
              f"{phase}: request {r.rid} got {len(r.tokens)} of {n}")
        check(r.requeues == 0, f"{phase}: request {r.rid} was requeued")
    errors = reg.get("serving_step_errors_total").value()
    check(errors == 0, f"{phase}: {errors} step errors")
    worst = 0.0
    agree = []
    for r, p in zip(reqs, prompts):
        seq = torch.from_numpy(
            np.concatenate([p, np.asarray(r.tokens, np.int32)])
        ).cuda()[None]
        w, a = _argmax_gap(cfg, params, seq, len(p), "fp",
                           f"{phase}/request {r.rid}", gated)
        worst = max(worst, w)
        agree.append(a)
    ttfts = sorted(r.ttft_s for r in reqs)
    gen_tokens = sum(len(r.tokens) for r in reqs)
    row = {
        "phase": phase, "requests": len(reqs), "slots": 8,
        "max_len": 1024, "prefill_chunk": 64,
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "new_tokens": gen_tokens, "wall_s": wall,
        "decode_tok_s": gen_tokens / wall,
        "total_tok_s": (gen_tokens + sum(len(p) for p in prompts)) / wall,
        "ttft_p50_s": float(np.median(ttfts)),
        "ttft_max_s": ttfts[-1],
        "iterations": reg.get("serving_iterations_total").value(),
        "step_errors": errors, "argmax_gap_max": worst,
        "argmax_gap_gated": gated,
        "argmax_agree": float(np.mean(agree)),
        "launches": launches,
    }
    emit(row)
    return launches, [(p, r.tokens, n) for p, r, n in zip(prompts, reqs, news)]


def _paged_workload(cfg, n_requests=32, prefix_share=0.6, prefix_len=48):
    """32 greedy requests, all submitted at once: prompts of 16-300
    tokens, 32-128 new tokens, and ``prefix_share`` of the prompts
    opening with ONE fixed ``prefix_len``-token system prefix (the
    shared-system-prompt workload a prefix cache exists for; the prefix
    counts toward the prompt's length)."""
    rs = np.random.RandomState(SEED + 7)
    prefix = rs.randint(0, cfg.vocab_size, size=prefix_len).astype(np.int32)
    work = []
    for _ in range(n_requests):
        prompt = rs.randint(0, cfg.vocab_size,
                            size=int(rs.randint(16, 301))).astype(np.int32)
        shared = bool(rs.rand() < prefix_share)
        if shared:
            n = min(prefix_len, len(prompt))
            prompt[:n] = prefix[:n]
        work.append((prompt, int(rs.randint(32, 129)),
                     shared and len(prompt) > prefix_len))
    return work


PAGED_KW = dict(max_len=1024, prefill_chunk=32, block_size=16)


def _paged_engine(cfg, params, kv, slots, num_blocks):
    """A warmed-up PagedServingEngine at the paged phase's settings and
    its registry. ``eng.call_counts["decode"]`` counts its decode steps
    (the warmup's included): each makes one B6 launch per layer."""
    from dlrover_tpu_torch.observability.registry import MetricsRegistry
    from dlrover_tpu_torch.serving import PagedServingEngine

    reg = MetricsRegistry()
    eng = PagedServingEngine(
        cfg, params, slots=slots, num_blocks=num_blocks, kv_cache_dtype=kv,
        registry=reg, **PAGED_KW,
    )
    eng.warmup()
    torch.cuda.synchronize()
    return eng, reg


def _profile_paged(cfg, params, work, kv, num_blocks, skip=60, window=20):
    """Where a paged iteration's time goes: ``window`` steps under the
    profiler after ``skip`` unprofiled ones (every slot busy, most steps
    running a prefill chunk and a decode step; profiling adds host time
    per op, so the busy share is a lower bound). Returns the B6 launches
    the engine must have made."""
    eng, _ = _paged_engine(cfg, params, kv, 16, num_blocks)
    for p, n, _ in work:
        eng.submit(p, n)
    for _ in range(skip):
        eng.step()
    before = eng.call_counts["decode"]

    def steps():
        for _ in range(window):
            eng.step()

    wall, device = _device_profile(steps)
    row = _profile_row(f"paged_engine/{kv}/{window} steps", wall, device)
    row["decode_steps"] = eng.call_counts["decode"] - before
    emit(row)
    return cfg.n_layers * eng.call_counts["decode"]


def _run_paged(cfg, params, work, label, kv, slots, num_blocks):
    """One PagedServingEngine over ``work``; checks what every run must
    show and returns (row, tokens per request, B6 launches wanted)."""
    eng, reg = _paged_engine(cfg, params, kv, slots, num_blocks)
    used = reg.get("serving_kv_blocks")
    peak_used = 0
    t0 = time.monotonic()
    reqs = [eng.submit(p, n) for p, n, _ in work]
    while eng.pending():
        eng.step()
        peak_used = max(peak_used, int(used.value(state="used")))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for r, (_, n, _) in zip(reqs, work):
        check(r.state == "done" and not r.failed and not r.truncated,
              f"{label}: request {r.rid} ended {r.state} "
              f"failed={r.failed} truncated={r.truncated}")
        check(len(r.tokens) == n,
              f"{label}: request {r.rid} got {len(r.tokens)} of {n}")
        check(r.requeues == 0, f"{label}: request {r.rid} was requeued")
    errors = reg.get("serving_step_errors_total").value()
    check(errors == 0, f"{label}: {errors} step errors")
    eng.check_block_invariants()
    stats = eng.kv_stats()
    check(stats["used"] == 0 and
          stats["free"] + stats["cached"] == num_blocks - 1,
          f"{label}: blocks left in use at the end: {stats}")
    prompt_tokens = int(sum(len(p) for p, _, _ in work))
    prefill_tokens = int(reg.get("serving_tokens_total").value(
        kind="prefill"))
    wasted = reg.get("serving_tokens_wasted_total")
    check(stats["prefix_hits"] > 0, f"{label}: no prefix hit: {stats}")
    check(prefill_tokens - int(wasted.value(kind="prefill")) < prompt_tokens,
          f"{label}: {prefill_tokens} prefill tokens for {prompt_tokens} "
          f"prompt tokens: the hits skipped nothing")
    worst, agree = 0.0, []
    for r, (p, _, _) in zip(reqs, work):
        seq = torch.from_numpy(
            np.concatenate([p, np.asarray(r.tokens, np.int32)])
        ).cuda()[None]
        w, a = _argmax_gap(cfg, params, seq, len(p), kv,
                           f"{label}/request {r.rid}")
        worst = max(worst, w)
        agree.append(a)

    def ttft(hit):
        """Among the shared-prefix requests that hit (or missed) the
        cache: submit to first token, and admission to first token (all
        requests are submitted at once, and only those that wait for a
        slot can hit, so the first mostly measures the queue)."""
        rs = [r for r, (_, _, shared) in zip(reqs, work)
              if shared and (r.prefix_hit_blocks > 0) == hit]
        if not rs:
            return {"n": 0}
        ts = sorted(r.ttft_s for r in rs)
        admit = [r.first_token_ts - r.admit_ts for r in rs]
        return {"n": len(ts), "p50_s": float(np.median(ts)), "max_s": ts[-1],
                "after_admit_p50_s": float(np.median(admit)),
                "after_admit_max_s": max(admit)}

    gen_tokens = sum(len(r.tokens) for r in reqs)
    row = {
        "phase": "paged_engine", "run": label, "kv": kv,
        "requests": len(reqs), "slots": slots, "max_len": eng.max_len,
        "prefill_chunk": eng.prefill_chunk, "block_size": eng.block_size,
        "num_blocks": num_blocks,
        "pool_mib": (num_blocks * eng._block_bytes) / 2**20,
        "prompt_tokens": prompt_tokens, "prefill_tokens": prefill_tokens,
        "new_tokens": gen_tokens, "wall_s": wall,
        "decode_tok_s": gen_tokens / wall,
        "total_tok_s": (gen_tokens + prompt_tokens) / wall,
        "ttft_shared_prefix_hit": ttft(True),
        "ttft_shared_prefix_miss": ttft(False),
        "ttft_p50_s": float(np.median([r.ttft_s for r in reqs])),
        "prefix_hit_rate": stats["prefix_hit_rate"],
        "prefix_hits": stats["prefix_hits"],
        "prefix_hit_blocks": stats["prefix_hit_blocks"],
        "cow_copies": stats["cow_copies"],
        "preemptions": int(reg.get("serving_kv_preemptions_total").value()),
        "tokens_wasted": {k: int(wasted.value(kind=k))
                          for k in ("prefill", "decode")},
        "evicted_blocks": stats["prefix_evicted_blocks"],
        "peak_blocks_used": peak_used,
        "iterations": reg.get("serving_iterations_total").value(),
        "decode_steps": eng.call_counts["decode"], "step_errors": errors,
        "argmax_gap_max": worst, "argmax_agree": float(np.mean(agree)),
    }
    emit(row)
    return (row, [r.tokens for r in reqs],
            cfg.n_layers * eng.call_counts["decode"])


def phase_paged_engine(cfg, params):
    """The paged main path: submit -> step -> admission through the
    prefix cache -> chunked paged prefill -> ragged paged decode with
    every single-token attention through B6. Returns the B6 launches the
    runs must have made, by kernel."""
    from dlrover_tpu_torch.ops.kv_quant import bytes_per_head_row

    work = _paged_workload(cfg)
    # Phase 5's flat engine holds 8 slots x 1024 rows: the same bytes as
    # blocks, twice the slots.
    fp_blocks = 8 * 1024 // 16 + 1
    want = {"fp": 0, "int8": 0}
    row, tokens, n = _run_paged(cfg, params, work, "fp", "fp", 16, fp_blocks)
    want["fp"] += n
    check(row["preemptions"] == 0, f"paged fp: {row['preemptions']} "
                                   f"preemptions at {fp_blocks} blocks")
    _, again, n = _run_paged(cfg, params, work, "fp_rerun", "fp", 16,
                             fp_blocks)
    want["fp"] += n
    check(again == tokens, "paged fp: two runs from one seed disagree")
    # Two full slots' worth of blocks for 16 slots: the relief ladder
    # (evict the cache, then preempt the youngest) must run, and change
    # no token.
    row, small, n = _run_paged(cfg, params, work, "fp_oversubscribed", "fp",
                               16, 2 * 64 + 1)
    want["fp"] += n
    check(row["preemptions"] > 0, "paged fp, 129 blocks: no preemption")
    check(small == tokens,
          "paged fp, 129 blocks: tokens differ from the 513-block run")
    # int8 at equal bytes: a row costs 132 bytes a head against 256, so
    # ~1.94x the blocks. The slots stay at 16: with a slot for each of
    # the 32 requests all are admitted before any prompt is cached, and
    # nothing could hit.
    fp_row = bytes_per_head_row(cfg.head_dim, "fp", 2)
    int8_blocks = ((fp_blocks - 1) * fp_row
                   // bytes_per_head_row(cfg.head_dim, "int8") + 1)
    _, _, n = _run_paged(cfg, params, work, "int8", "int8", 16, int8_blocks)
    want["int8"] += n
    want["fp"] += _profile_paged(cfg, params, work, "fp", fp_blocks)
    want["int8"] += _profile_paged(cfg, params, work, "int8", int8_blocks)
    return {f"paged_decode_attention_{kv}": n for kv, n in want.items()}


# ---- speculative decoding and MoE over the paged pool ----------------------


def _spec_work(served):
    """Greedy requests with repetitive prompts built from an engine
    phase's own output: ``p + greedy(p) + p`` and the same token budget.
    After the second ``p`` the n-gram drafter proposes ``greedy(p)``."""
    return [(np.concatenate([p, np.asarray(toks, np.int32), p]), n)
            for p, toks, n in served]


def _run_spec(cfg, params, work, phase, label, kv, gated, engine_kw,
              base=None):
    """One engine (flat, or paged with ``num_blocks`` in ``engine_kw``)
    over ``work``: every request complete, no step error, the
    teacher-forced gap (held to ARGMAX_GAP[kv] when ``gated``), block
    conservation (paged), more than one token a verify step (spec on),
    and exact decode-attention and grouped-FFN launches from the
    engine's own step counts: n_layers a decode step, draft layers x K
    a draft call (warmup included), and for MoE n_layers B7 launches a
    prefill, decode or verify step. Returns (row, tokens, launches)."""
    from dlrover_tpu_torch.observability.registry import MetricsRegistry
    from dlrover_tpu_torch.ops import decode_attention as da
    from dlrover_tpu_torch.ops import moe_dispatch as md
    from dlrover_tpu_torch.serving import PagedServingEngine, ServingEngine

    paged = "num_blocks" in engine_kw
    reg = MetricsRegistry()
    da.reset_launch_counts()
    md.reset_launch_counts()
    if paged:
        eng = PagedServingEngine(cfg, params, kv_cache_dtype=kv,
                                 registry=reg, **engine_kw)
    else:
        eng = ServingEngine(cfg, params, registry=reg, **engine_kw)
    eng.warmup()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs = [eng.submit(p, n) for p, n in work]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {**da.launch_counts, **md.launch_counts}
    for r, (_, n) in zip(reqs, work):
        check(r.state == "done" and not r.failed and not r.truncated,
              f"{label}: request {r.rid} ended {r.state} "
              f"failed={r.failed} truncated={r.truncated}")
        check(len(r.tokens) == n,
              f"{label}: request {r.rid} got {len(r.tokens)} of {n}")
        check(r.requeues == 0, f"{label}: request {r.rid} was requeued")
    errors = reg.get("serving_step_errors_total").value()
    check(errors == 0, f"{label}: {errors} step errors")
    if paged:
        eng.check_block_invariants()
        stats = eng.kv_stats()
        check(stats["used"] == 0,
              f"{label}: blocks left in use at the end: {stats}")
    # Exact launches.
    counts = dict(eng.call_counts)
    K, d = eng.spec_k, eng.spec_draft_layers
    attn = (f"paged_decode_attention_{kv}" if paged
            else f"decode_attention_{kv}")
    want = {name: 0 for name in launches}
    want[attn] = cfg.n_layers * counts["decode"] + d * K * counts["draft"]
    if cfg.n_experts:
        want["grouped_ffn_forward"] = cfg.n_layers * (
            counts["prefill"] + counts["decode"] + counts["verify"]
        ) + d * K * counts["draft"]
    check(launches == want,
          f"{label}: launches {launches}, want {want} from {counts}")
    if K:
        check(counts["decode"] == 1,
              f"{label}: {counts['decode']} decode steps beside warmup's")
    worst, agree = 0.0, []
    for r, (p, _) in zip(reqs, work):
        seq = torch.from_numpy(
            np.concatenate([p, np.asarray(r.tokens, np.int32)])
        ).cuda()[None]
        w, a = _argmax_gap(cfg, params, seq, len(p), kv,
                           f"{label}/request {r.rid}", gated)
        worst = max(worst, w)
        agree.append(a)
    gen_tokens = sum(len(r.tokens) for r in reqs)
    row = {
        "phase": phase, "run": label, "kv": kv,
        "engine": "paged" if paged else "flat", "requests": len(reqs),
        **{k: v for k, v in engine_kw.items()},
        "prompt_tokens": int(sum(len(p) for p, _ in work)),
        "new_tokens": gen_tokens, "wall_s": wall,
        "decode_tok_s": gen_tokens / wall,
        "iterations": reg.get("serving_iterations_total").value(),
        "step_calls": counts, "step_errors": errors,
        "argmax_gap_max": worst, "argmax_gap_gated": gated,
        "argmax_agree": float(np.mean(agree)), "launches": launches,
    }
    if K:
        drafted = sum(r.spec_drafted for r in reqs)
        accepted = sum(r.spec_accepted for r in reqs)
        per_step = eng._spec_emitted / eng._spec_slot_steps
        check(per_step > 1.0,
              f"{label}: {per_step} tokens a verify step, not above 1")
        draft_s = sum(r.draft_s for r in reqs)
        verify_s = sum(r.verify_s for r in reqs)
        row.update({
            "spec_drafted": drafted, "spec_accepted": accepted,
            "accept_rate": accepted / drafted if drafted else None,
            "tokens_per_verify_step": per_step,
            "verify_slot_steps": eng._spec_slot_steps,
            "draft_s": draft_s, "verify_s": verify_s,
            "draft_share": draft_s / (draft_s + verify_s),
        })
    if base is not None:
        same = [float(np.mean(np.asarray(t) == np.asarray(b)))
                for t, b in zip([r.tokens for r in reqs], base[1])]
        row["agree_with_spec_off"] = float(np.mean(same))
        row["speedup_vs_spec_off"] = row["decode_tok_s"] / base[0][
            "decode_tok_s"]
    emit(row)
    del eng
    torch.cuda.empty_cache()
    return row, [r.tokens for r in reqs], launches


def _spec_runs(cfg, params, work, phase, kv, gated, engine_kw, runs):
    """``runs`` [(label, spec kwargs)], the spec-off one first; returns
    the launches of all, summed by kernel."""
    total, base = {}, None
    for label, spec in runs:
        row, tokens, launches = _run_spec(
            cfg, params, work, phase, f"{kv}/{label}", kv, gated,
            {**engine_kw, **spec}, base)
        if base is None:
            base = (row, tokens)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return total


SPEC_K, SPEC_DRAFT_LAYERS = 3, 4
_NGRAM = dict(spec_k=SPEC_K)
_EARLY_EXIT = dict(spec_k=SPEC_K, spec_drafter="early_exit",
                   spec_draft_layers=SPEC_DRAFT_LAYERS)


def phase_spec_engine(cfg, params, served):
    """Speculative decoding on the flat engine (phase 5's settings: 8
    slots, max_len 1024, chunk 64) over phase 5's 16 requests with
    prompts ``p + greedy(p) + p``: spec off, n-gram K = 3, early exit
    K = 3 over 4 layers. Returns the launches by kernel."""
    return _spec_runs(
        cfg, params, _spec_work(served), "spec_engine", "fp", True,
        dict(slots=8, max_len=1024, prefill_chunk=64),
        [("off", {}), ("ngram", _NGRAM), ("early_exit", _EARLY_EXIT)])


def phase_paged_spec_engine(cfg, params, served):
    """Speculative decoding on the paged engine at phase 11's settings
    (16 slots, chunk 32, blocks of 16; 513 fp blocks, 993 int8 at equal
    bytes) over the same requests: fp spec off, n-gram and early exit;
    int8 spec off and n-gram. Returns the launches by kernel."""
    work = _spec_work(served)
    total = {}
    for kv, blocks, runs in (
            ("fp", 513, [("off", {}), ("ngram", _NGRAM),
                         ("early_exit", _EARLY_EXIT)]),
            ("int8", 993, [("off", {}), ("ngram", _NGRAM)])):
        launches = _spec_runs(
            cfg, params, work, "paged_spec_engine", kv, True,
            dict(slots=16, num_blocks=blocks, **PAGED_KW), runs)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return total


def phase_moe_paged_engine(cfg, params, served):
    """MoE over the paged pool: ``moe_config`` at phase 11's fp settings,
    the MoE engine phase's 16 requests with prompts ``p + greedy(p) +
    p``, spec off and n-gram K = 3; the teacher-forced gap is reported,
    as the MoE engine phase's. Returns the launches by kernel."""
    return _spec_runs(
        cfg, params, _spec_work(served), "moe_paged_engine", "fp", False,
        dict(slots=16, num_blocks=513, **PAGED_KW),
        [("off", {}), ("ngram", _NGRAM)])


def _leaf_names(tree, prefix=""):
    """Names of ``train_step.param_leaves(tree)``, in its order."""
    names = []
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            names += _leaf_names(tree[key], f"{prefix}{key}.")
        else:
            names.append(prefix + key)
    return names


def _train_state(cfg, tc):
    """Fresh f32 master params from the seed, and their optimizer."""
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer import train_step as ts

    params = llama.init_params(
        cfg, torch.Generator("cuda").manual_seed(SEED), device="cuda"
    )
    opt = ts.make_optimizer(tc)
    return opt, ts.init_train_state(cfg, opt, params)


def _one_step_rows(cfg, tokens, variants):
    """One grad_accum=1 step per variant, each from the seed's params:
    ``variants`` maps a label to (a ``loss_fn`` for ``make_train_step``
    or None, a context manager factory the step runs under or None).
    Returns {label: row}; every row after the first (the reference)
    carries its relative loss and grad-norm gaps and, per leaf, the
    relative L2 distance of Adam's first moment (0.1 x the clipped
    gradient: the lr is 0 at the first update) to the reference's."""
    import contextlib

    from dlrover_tpu_torch.trainer import train_step as ts

    tc1 = ts.TrainConfig(warmup_steps=2, grad_accum=1)
    one, ref_moments = {}, None
    for label, (loss_fn, patch) in variants.items():
        opt, state = _train_state(cfg, tc1)
        step = ts.make_train_step(cfg, tc1, opt, device="cuda",
                                  loss_fn=loss_fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        with (patch or contextlib.nullcontext)():
            state, m = step(state, {"tokens": tokens})
        # Peak memory of the step alone: the reference's moments, kept
        # for the comparison, are not counted.
        held = sum(t.numel() * 4 for t in ref_moments or ())
        row = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "step_s": time.monotonic() - t0,
               "peak_bytes": torch.cuda.max_memory_allocated() - held}
        moments = [state["opt_state"].state[p]["exp_avg"]
                   for p in ts.param_leaves(state["params"])]
        if ref_moments is None:
            ref, ref_moments = row, moments
        else:
            row["loss_rel"] = abs(row["loss"] - ref["loss"]) / ref["loss"]
            row["grad_norm_rel"] = abs(
                row["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
            dist = [float((a - b).norm() / b.norm())
                    for a, b in zip(moments, ref_moments)]
            row["grads_rel_l2"] = dict(zip(_leaf_names(state["params"]),
                                           dist))
            row["grads"] = max(dist)
        one[label] = row
        del opt, state, step, m, moments
        torch.cuda.empty_cache()
    return one


def _check_step_gates(phase, one, fault):
    """The "kernel" row within TRAIN_GATES of the reference; the planted
    ``fault`` row outside the gradient and grad-norm gates."""
    gate_keys = {"loss": "loss_rel", "grad_norm": "grad_norm_rel",
                 "grads": "grads"}
    for gate, key in gate_keys.items():
        check(one["kernel"][key] <= TRAIN_GATES[gate],
              f"{phase}: kernel vs plain {key} {one['kernel'][key]} > "
              f"{TRAIN_GATES[gate]}")
    for gate in ("grads", "grad_norm"):
        key = gate_keys[gate]
        check(one[fault][key] > TRAIN_GATES[gate],
              f"{phase}: the {gate} gate passes a planted fault "
              f"({one[fault][key]})")


def phase_train(cfg):
    """The training main path: ``make_train_step`` -> ``loss_fn`` ->
    ``forward`` -> ``run_layer_stack`` with the flash kernels, on a
    fixed batch from seed 1. Returns the flash kernels' launch counts
    over the 6-step run."""
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops.attention import dot_product_attention
    from dlrover_tpu_torch.trainer import train_step as ts

    rs = np.random.RandomState(SEED + 1)
    tokens = torch.from_numpy(rs.randint(
        0, cfg.vocab_size, (TRAIN_GA * TRAIN_MICRO, TRAIN_SEQ + 1)
    ).astype(np.int32)).cuda()

    # Check one: a grad_accum=1 step through plain attention, through the
    # kernels, and through two planted faults (the kernels given all but
    # the last 64 keys, or only the first half of them: B1 and B2
    # skipping their last kv tile, or stopping halfway), from the same
    # params. The lr is 0 at the first update, so the step leaves the
    # params alone and Adam's first moment holds 0.1 x the clipped
    # gradients: each leaf's relative L2 distance to the plain step's
    # shows where the gradients part. All run bf16 matmuls, and the
    # kernels round P and their outputs at other places than plain
    # attention, so the gradients part by bf16 noise (a few percent) even
    # with sound kernels; the gates sit above that, and only the larger
    # fault is required to fail them.
    def keys_cut(cut):
        def attention_fn(q, k, v, causal=True, **_):
            return fa.flash_attention(q, k[:, :cut], v[:, :cut], causal)
        return lambda p, b: llama.loss_fn(cfg, p, b,
                                          attention_fn=attention_fn)

    variants = {
        "plain": (lambda p, b: llama.loss_fn(
            cfg, p, b, attention_fn=dot_product_attention), None),
        "kernel": (None, None),
        "fault_last_tile": (keys_cut(64 * ((TRAIN_SEQ - 1) // 64)), None),
        "fault_half": (keys_cut(TRAIN_SEQ // 2), None),
    }
    one = _one_step_rows(cfg, tokens[:TRAIN_MICRO], variants)
    emit({"phase": "train_vs_plain", "micro_batch": TRAIN_MICRO,
          "seq": TRAIN_SEQ, "gates": TRAIN_GATES, **one})
    _check_step_gates("train", one, "fault_half")

    # Check two: TRAIN_STEPS steps through the kernels, twice from the
    # same seed.
    tc = ts.TrainConfig(warmup_steps=2, grad_accum=TRAIN_GA)
    runs = []
    for run in range(2):
        opt, state = _train_state(cfg, tc)
        step = ts.make_train_step(cfg, tc, opt, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        losses, norms, times = [], [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.monotonic()
            state, m = step(state, {"tokens": tokens})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
        launches = dict(fa.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        runs.append((losses, norms, times, launches, peak))
        if run == 0:
            # Where a step's time goes (profiling adds host time per op,
            # so the busy share is a lower bound).
            wall, device = _device_profile(
                lambda: float(step(state, {"tokens": tokens})[1]["loss"]))
            emit(_profile_row("train/step", wall, device, kernel="flash",
                              match="flash_", top_n=10))
        del opt, state, step
        torch.cuda.empty_cache()

    losses, norms, times, launches, peak = runs[0]
    step_s = float(np.mean(times[1:]))
    tokens_per_step = TRAIN_GA * TRAIN_MICRO * TRAIN_SEQ
    flops_per_token = (cfg.flops_per_token()
                       + cfg.attention_flops_per_token(TRAIN_SEQ))
    rerun_rel = max(abs(a - b) / abs(b) for a, b in zip(runs[1][0], losses))
    row = {
        "phase": "train", "remat_policy": cfg.remat_policy,
        "micro_batch": TRAIN_MICRO, "seq": TRAIN_SEQ,
        "grad_accum": TRAIN_GA, "grad_accum_reduced_from": 16,
        "steps": TRAIN_STEPS, "losses": losses, "grad_norms": norms,
        "step_s": times, "step_s_mean_after_first": step_s,
        "tokens_per_s": tokens_per_step / step_s,
        "model_flops_per_token": flops_per_token,
        "model_tflops_per_s": flops_per_token * tokens_per_step / step_s
        / 1e12,
        "model_flops_share_of_peak": flops_per_token * tokens_per_step
        / step_s / PEAK_OPS_PER_S["bfloat16"],
        "peak_memory_gib": peak / 2**30, "launches": launches,
        "rerun_losses": runs[1][0], "rerun_max_rel_diff": rerun_rel,
        "rerun_bitwise_equal": runs[1][0] == losses,
    }
    emit(row)
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"train: non-finite loss or grad norm {losses} {norms}")
    check(losses[-1] < losses[0], f"train: loss did not fall {losses}")
    want = cfg.n_layers * TRAIN_STEPS * TRAIN_GA
    for name, n in launches.items():
        check(n == want, f"train: {name} launched {n} times, want {want}")
    check(rerun_rel <= 1e-6, f"train: a second run gave {runs[1][0]}, "
                             f"the first {losses}")
    return launches


# ---- fused cross-entropy ---------------------------------------------------


def _ce_inputs(n, d, v, gen, masked=False):
    """bf16 x [n, d] and w [d, V] scaled as bench.py's CE A/B (w ~
    N(0, 1) / 32), int32 targets with row 0's in the last vocab column
    (every kernel's last tile holds a target), and token-mean weights,
    30% of them zero when ``masked`` (row 0 kept)."""
    x = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(d, v, generator=gen, device="cuda") / 32).bfloat16()
    tgt = torch.randint(0, v, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    tgt[0] = v - 1
    keep = torch.ones(n, device="cuda")
    if masked:
        keep = (torch.rand(n, generator=gen, device="cuda") >= 0.3).float()
        keep[0] = 1.0
    return x, w, tgt, keep / keep.sum()


def _ce_ratio(got, want, dim):
    """Largest |got - want| / (CE_REL |want| + CE_ROW rms_d(want) +
    CE_FLOOR rms(want)), rms_d over ``dim`` (d); at most 1 passes."""
    want = want.float()
    sq = want.square()
    tol = (CE_REL * want.abs()
           + CE_ROW * sq.mean(dim=dim, keepdim=True).sqrt()
           + CE_FLOOR * sq.mean().sqrt()) + 1e-30
    return float(((got.float() - want).abs() / tol).max())


def _stat_ratio(got, want):
    return float(((got - want).abs() / (CE_STAT_REL * want.abs())).max())


def _ce_bound(name, n, d, v, active_rows):
    """Least time for one fused-CE kernel's work: its bytes (x, w, the
    row inputs and the outputs, each once) over the HBM rate, against 2 n
    d V flops per logits-sized product over the bf16 peak. B3 runs one
    product over every row; dx and dw run two (the logits again, then g
    @ w^T or x^T @ g) over the rows with a nonzero weight (the others
    give zeros)."""
    inputs = n * d * 2 + d * v * 2 + n * 4
    moved, flops = {
        "fused_ce_forward": (inputs + 2 * n * 4, 2 * n * d * v),
        "fused_ce_backward_dx": (inputs + 3 * n * 4 + n * d * 2,
                                 4 * active_rows * d * v),
        "fused_ce_backward_dw": (inputs + 3 * n * 4 + d * v * 4,
                                 4 * active_rows * d * v),
    }[name]
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_OPS_PER_S["bfloat16"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", moved, flops)


def _dense_ce_calls(x, w, tgt, coef_a, coef_b):
    """The dense route's calls at B3's and B4's shape (no single PyTorch
    call computes either), only timed: B3 <- the cuBLAS logits product
    (bf16 in, f32 out) then logsumexp and the target gather; dx <-
    softmax-grad from stored f32 logits, rounded to bf16, then g @ w^T;
    dw <- the same softmax-grad, then x^T @ g (f32 out)."""
    from dlrover_tpu_torch.ops.fused_ce import _mm_f32

    rows = torch.arange(x.shape[0], device=x.device)
    tl = tgt.long()
    logits = _mm_f32(x, w)

    def forward():
        lg = _mm_f32(x, w)
        return torch.logsumexp(lg, dim=-1), lg[rows, tl]

    def grad():
        g = torch.softmax(logits, dim=-1).mul_(coef_a[:, None])
        g[rows, tl] -= coef_b
        return g.bfloat16()

    return {
        "fused_ce_forward": forward,
        "fused_ce_backward_dx": lambda: grad() @ w.t(),
        "fused_ce_backward_dw": lambda: _mm_f32(x.t(), grad()),
    }


def phase_ce_kernels():
    """B3 and B4 against their plain versions (the vocab-scan loops of
    ``ops/fused_ce``) on the same inputs, at the CE A/B shape, a ragged
    one and a masked one. B4 gets the plain forward's logz and the
    coefficients of a token-mean loss: a = wgt (1 + 2 z logz), b = wgt.
    per_tok and logz pass within CE_STAT_REL; dx (bf16 on both sides:
    an element may round one bf16 ulp the other way) and dw pass
    elementwise (see _ce_ratio). Each shape also plants faults and
    checks that the same bounds reject them: B3 and dx without their
    last vocab tile (256 and 64 columns), B3 also without its last 128
    columns (inside a tile: the column mask), dw without its last
    64-row tile; row 0's target sits in the last vocab column. B3, B4
    dx and B4 dw give the same bits on a second call."""
    from dlrover_tpu_torch.ops import fused_ce as fc

    gen = torch.Generator("cuda").manual_seed(SEED + 4)
    shapes = [  # label, n, d, V, masked
        ("ce_ab", CE_N, CE_D, CE_V, False),
        ("ragged", 4100, CE_D, 32003, False),
        ("masked", CE_N, CE_D, CE_V, True),
    ]
    rows = {}
    for label, n, d, v, masked in shapes:
        x, w, tgt, wgt = _ce_inputs(n, d, v, gen, masked)
        per_tok, logz = fc.fused_ce_forward(x, w, tgt, CE_Z)
        torch.cuda.synchronize()
        ref_pt, ref_logz = fc._xla_forward(x, w, tgt, CE_Z)
        a = wgt * (1.0 + 2.0 * CE_Z * ref_logz)
        b = wgt
        dx = fc.fused_ce_backward_dx(x, w, tgt, ref_logz, a, b)
        dw = fc.fused_ce_backward_dw(x, w, tgt, ref_logz, a, b)
        torch.cuda.synchronize()
        ref_dx, ref_dw = fc._xla_backward(x, w, tgt, ref_logz, a, b)
        ref_dx = ref_dx.bfloat16()
        ratio = {"per_tok": _stat_ratio(per_tok, ref_pt),
                 "logz": _stat_ratio(logz, ref_logz),
                 "dx": _ce_ratio(dx, ref_dx, -1),
                 "dw": _ce_ratio(dw, ref_dw, 0)}
        err = {"fused_ce_forward": max(float((per_tok - ref_pt).abs().max()),
                                       float((logz - ref_logz).abs().max())),
               "fused_ce_backward_dx": float(
                   (dx.float() - ref_dx.float()).abs().max()),
               "fused_ce_backward_dw": float((dw - ref_dw).abs().max())}
        del dx, dw
        # B3, B4 dx and dw (redesigned): the same bits on a second call.
        bitwise = {
            "fwd": _check_rerun(
                f"fused_ce_forward/{label}",
                lambda: fc.fused_ce_forward(x, w, tgt, CE_Z)),
            "dx": _check_rerun(
                f"fused_ce_backward_dx/{label}",
                lambda: fc.fused_ce_backward_dx(x, w, tgt, ref_logz, a, b)),
            "dw": _check_rerun(
                f"fused_ce_backward_dw/{label}",
                lambda: fc.fused_ce_backward_dw(x, w, tgt, ref_logz, a, b)),
        }
        f_pt, f_logz = fc._xla_forward(x, w[:, :256 * ((v - 1) // 256)],
                                       tgt, CE_Z)
        # A sub-tile drop (the last 128 columns, or the ragged vocab's
        # last partial 128): B3's in-tile column mask.
        f_pt128, f_logz128 = fc._xla_forward(
            x, w[:, :128 * ((v - 1) // 128)], tgt, CE_Z)
        f_dx, _ = fc._xla_backward(x, w[:, :64 * ((v - 1) // 64)], tgt,
                                   ref_logz, a, b, want_dw=False)
        cut = 64 * ((n - 1) // 64)
        _, f_dw = fc._xla_backward(x[:cut], w, tgt[:cut], ref_logz[:cut],
                                   a[:cut], b[:cut], want_dx=False)
        fault = {"per_tok": _stat_ratio(f_pt, ref_pt),
                 "logz": _stat_ratio(f_logz, ref_logz),
                 "per_tok_128": _stat_ratio(f_pt128, ref_pt),
                 "logz_128": _stat_ratio(f_logz128, ref_logz),
                 "dx": _ce_ratio(f_dx.bfloat16(), ref_dx, -1),
                 "dw": _ce_ratio(f_dw, ref_dw, 0)}
        del f_pt, f_logz, f_pt128, f_logz128, f_dx, f_dw, ref_dx, ref_dw
        emit({"phase": "ce_bounds", "shape": label, "ratio": ratio,
              "planted_fault_ratio": fault, "bitwise_rerun": bitwise,
              "fwd_plan": dict(zip(("splits", "cluster"), fc.forward_plan(
                  n, v, torch.cuda.get_device_properties(
                      0).multi_processor_count)))})
        for out in ratio:
            check(ratio[out] <= 1.0,
                  f"fused_ce/{label}: {out} at {ratio[out]} of its bound")
        # Each kernel's fault must fail its outputs' bounds (B3's last
        # tile may hold only a few columns: row 0's per_tok loses its
        # target logit, while logz moves by their small share).
        for kernel, outs in (("B3", ("per_tok", "logz")),
                             ("B3 (128 columns)", ("per_tok_128", "logz_128")),
                             ("dx", ("dx",)), ("dw", ("dw",))):
            worst = max(fault[o] for o in outs)
            check(worst > 1.0,
                  f"fused_ce/{label}: the {kernel} bounds pass a kernel "
                  f"that skips its last tile ({worst})")

        active = int((wgt > 0).sum())
        library = _dense_ce_calls(x, w, tgt, a, b)
        calls = {
            "fused_ce_forward": (
                lambda: fc.fused_ce_forward(x, w, tgt, CE_Z),
                lambda: fc._xla_forward(x, w, tgt, CE_Z)),
            "fused_ce_backward_dx": (
                lambda: fc.fused_ce_backward_dx(x, w, tgt, ref_logz, a, b),
                lambda: fc._xla_backward(x, w, tgt, ref_logz, a, b,
                                         want_dw=False)),
            "fused_ce_backward_dw": (
                lambda: fc.fused_ce_backward_dw(x, w, tgt, ref_logz, a, b),
                lambda: fc._xla_backward(x, w, tgt, ref_logz, a, b,
                                         want_dx=False)),
        }
        for name, (kernel, plain) in calls.items():
            ms = _time_ms(kernel, iters=10)
            plain_ms = _time_ms(plain, iters=3)
            library_ms = _time_ms(library[name], iters=5)
            bound_ms, bound_by, moved, flops = _ce_bound(name, n, d, v,
                                                         active)
            row = {
                "phase": "kernel", "kernel": name, "shape": label, "n": n,
                "d": d, "v": v, "active_rows": active,
                "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms,
                "library": "dense route, two calls: " + {
                    "fused_ce_forward": "cuBLAS logits, logsumexp+gather",
                    "fused_ce_backward_dx": "softmax-grad, g @ w^T",
                    "fused_ce_backward_dw": "softmax-grad, x^T @ g",
                }[name],
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
                "flops": flops, "bound_share": bound_ms / ms,
                "tflops": flops / ms / 1e9,
            }
            emit(row)
            rows[(name, label)] = row
        del library, calls, x, w
        torch.cuda.empty_cache()
    return rows


def phase_ce_ab():
    """bench.py's ce_ab_phase on the card: loss, dx and dw (fwd+bwd) at
    n=16384, d=1024, V=32000 (bf16 x and w, token-mean) through the dense
    logits (the port's dense CE: a bf16 product cast to f32, then
    ``cross_entropy``), the chunked fused CE and the B3/B4 kernels; ms
    (CUDA events, cold L2) and peak memory above the inputs, and the
    [n, V] logits GEMM alone with an f32 and a bf16 output. The routes
    must agree: chunked vs kernels within 1e-5 on the loss and the B4
    bounds on dx and dw; dense (bf16 logits) within 1e-3 on the loss."""
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import fused_ce as fc

    gen = torch.Generator("cuda").manual_seed(SEED + 5)
    x, w, tgt, _ = _ce_inputs(CE_N, CE_D, CE_V, gen)
    routes = {
        "dense": lambda xl, wl: llama.cross_entropy((xl @ wl).float(), tgt),
        "chunked": lambda xl, wl: fc.fused_cross_entropy(
            xl, wl, tgt, impl="chunked"),
        "pallas": lambda xl, wl: fc.fused_cross_entropy(
            xl, wl, tgt, impl="pallas"),
    }

    def fwd_bwd(route):
        xl = x.detach().requires_grad_(True)
        wl = w.detach().requires_grad_(True)
        loss = routes[route](xl, wl)
        return (loss.detach(),) + torch.autograd.grad(loss, [xl, wl])

    out, ms, peak = {}, {}, {}
    for route in routes:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out[route] = fwd_bwd(route)
        torch.cuda.synchronize()
        peak[route] = torch.cuda.max_memory_allocated() - base
        ms[route] = _time_ms(lambda: fwd_bwd(route), iters=5)
    # The chunked route's logits product alone: bf16 operands with an f32
    # output (what the port runs), beside the same GEMM with a bf16 output.
    logits_gemm_ms = {
        "bf16_in_f32_out": _time_ms(lambda: fc._mm_f32(x, w), iters=10),
        "bf16_out": _time_ms(lambda: x @ w, iters=10),
    }
    loss = {r: float(o[0]) for r, o in out.items()}
    ref = out["pallas"]
    agree = {
        "chunked_vs_pallas_loss_rel": abs(loss["chunked"] - loss["pallas"])
        / loss["pallas"],
        "dense_vs_pallas_loss_rel": abs(loss["dense"] - loss["pallas"])
        / loss["pallas"],
        "chunked_vs_pallas_dx_ratio": _ce_ratio(out["chunked"][1], ref[1],
                                                -1),
        "chunked_vs_pallas_dw_ratio": _ce_ratio(out["chunked"][2], ref[2],
                                                0),
    }
    row = {
        "phase": "ce_ab", "n": CE_N, "d": CE_D, "v": CE_V,
        "ce_auto_path": ("dense" if fc.auto_prefers_dense(CE_N, CE_V)
                         else "fused"),
        "ce_auto_crossover_nv": fc.AUTO_FUSED_MIN_NV,
        "ce_dense_ms": ms["dense"], "ce_fused_chunked_ms": ms["chunked"],
        "ce_fused_pallas_ms": ms["pallas"],
        "ce_fused_chunked_vs_dense": ms["chunked"] / ms["dense"],
        "ce_fused_pallas_vs_dense": ms["pallas"] / ms["dense"],
        "ce_auto_pin_consistent": int(
            (ms["chunked"] / ms["dense"] >= 1.0)
            == fc.auto_prefers_dense(CE_N, CE_V)),
        "peak_bytes": peak, "loss": loss, "logits_gemm_ms": logits_gemm_ms,
        "ce_fused_logits_bytes_saved_mb": CE_N * CE_V * 4 / 1e6,
        **agree,
    }
    emit(row)
    check(agree["chunked_vs_pallas_loss_rel"] <= 1e-5,
          f"ce_ab: chunked vs kernels loss {agree}")
    check(agree["dense_vs_pallas_loss_rel"] <= 1e-3,
          f"ce_ab: dense vs kernels loss {agree}")
    check(agree["chunked_vs_pallas_dx_ratio"] <= 1.0
          and agree["chunked_vs_pallas_dw_ratio"] <= 1.0,
          f"ce_ab: chunked vs kernels gradients {agree}")
    del out, x, w
    torch.cuda.empty_cache()
    return row


def _kernel_ce_loss(cfg, vocab_cut=None):
    """A ``loss_fn`` for ``make_train_step`` that reaches B3/B4:
    forward_hidden -> final_hidden -> fused_cross_entropy(impl="pallas").
    With ``vocab_cut`` the kernels see only the first columns of the
    unembedding (a planted fault: tokens past the cut lose their target
    logit and those columns get no gradient)."""
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import fused_ce as fc

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        x, aux = llama.forward_hidden(cfg, params, tokens[:, :-1])
        w = params["lm_head"].to(cfg.compute_dtype)
        ce = fc.fused_cross_entropy(
            llama.final_hidden(cfg, params, x),
            w if vocab_cut is None else w[:, :vocab_cut], tokens[:, 1:],
            impl="pallas")
        return ce + cfg.moe_aux_weight * aux, {"ce": ce, "aux": aux}

    return loss_fn


def phase_train_ce(cfg):
    """Training through the fused CE on the flagship at micro-batch
    8 x 2048 (N V = 5.24e8, below the auto crossover, so each route is
    chosen explicitly). Check one: a grad_accum=1 step through the dense
    CE (``DLROVER_TPU_FUSED_CE=off``), the chunked fused CE (``on``),
    the B3/B4 kernels and a planted fault (the kernels given the first
    half of the vocabulary), from the same params; each fused step's
    loss, grad norm and per-leaf gradient (Adam's first moment, as in
    phase_train) against the dense step's. The dense CE rounds its
    logits to bf16, the fused routes keep them in f32, so they part by
    bf16 noise; the gates sit above it and the fault must fail them. Two
    more steps of each route are timed. Check two: CE_TRAIN_STEPS steps
    through B3/B4 (grad_accum TRAIN_GA) with falling loss, one launch of
    each kernel per micro-step, and a rerun from the same seed giving
    the same losses bit for bit. Returns the kernels' launch counts over
    the first run."""
    from dlrover_tpu_torch.ops import fused_ce as fc
    from dlrover_tpu_torch.trainer import train_step as ts

    rs = np.random.RandomState(SEED + 1)
    tokens = torch.from_numpy(rs.randint(
        0, cfg.vocab_size, (TRAIN_GA * TRAIN_MICRO, TRAIN_SEQ + 1)
    ).astype(np.int32)).cuda()
    micro_tokens = TRAIN_MICRO * TRAIN_SEQ
    tc1 = ts.TrainConfig(warmup_steps=2, grad_accum=1)
    variants = {  # label: (DLROVER_TPU_FUSED_CE, loss_fn)
        "dense": ("off", None),
        "chunked": ("on", None),
        "kernels": ("off", _kernel_ce_loss(cfg)),
        "fault_half": ("off", _kernel_ce_loss(cfg, cfg.vocab_size // 2)),
    }
    saved_env = os.environ.get("DLROVER_TPU_FUSED_CE")
    one, dense_moments = {}, None
    try:
        for label, (env, loss_fn) in variants.items():
            os.environ["DLROVER_TPU_FUSED_CE"] = env
            opt, state = _train_state(cfg, tc1)
            step = ts.make_train_step(cfg, tc1, opt, device="cuda",
                                      loss_fn=loss_fn)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state, m = step(state, {"tokens": tokens[:TRAIN_MICRO]})
            held = sum(t.numel() * 4 for t in dense_moments or ())
            row = {"loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]),
                   "peak_bytes": torch.cuda.max_memory_allocated() - held}
            moments = [state["opt_state"].state[p]["exp_avg"]
                       for p in ts.param_leaves(state["params"])]
            if dense_moments is None:
                # A copy: the timed steps below update the moments in place.
                dense_moments = [t.clone() for t in moments]
            else:
                ref = one["dense"]
                row["loss_rel"] = abs(row["loss"] - ref["loss"]) / ref["loss"]
                row["grad_norm_rel"] = abs(
                    row["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
                dist = [float((a - b).norm() / b.norm())
                        for a, b in zip(moments, dense_moments)]
                row["grads_rel_l2"] = dict(zip(
                    _leaf_names(state["params"]), dist))
                row["grads"] = max(dist)
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                step(state, {"tokens": tokens[:TRAIN_MICRO]})
                torch.cuda.synchronize()
                times.append(time.monotonic() - t0)
            row["step_s"] = times
            row["tokens_per_s"] = micro_tokens / float(np.mean(times))
            one[label] = row
            del opt, state, step, m, moments
            torch.cuda.empty_cache()
    finally:
        if saved_env is None:
            os.environ.pop("DLROVER_TPU_FUSED_CE", None)
        else:
            os.environ["DLROVER_TPU_FUSED_CE"] = saved_env
    del dense_moments
    emit({"phase": "train_ce_vs_dense", "micro_batch": TRAIN_MICRO,
          "seq": TRAIN_SEQ, "gates": CE_TRAIN_GATES, **one})
    gate_keys = {"loss": "loss_rel", "grad_norm": "grad_norm_rel",
                 "grads": "grads"}
    for label in ("chunked", "kernels"):
        for gate, key in gate_keys.items():
            check(one[label][key] <= CE_TRAIN_GATES[gate],
                  f"train_ce: {label} vs dense {key} {one[label][key]} > "
                  f"{CE_TRAIN_GATES[gate]}")
    for gate, key in gate_keys.items():
        check(one["fault_half"][key] > CE_TRAIN_GATES[gate],
              f"train_ce: the {gate} gate passes a planted fault "
              f"({one['fault_half'][key]})")

    tc = ts.TrainConfig(warmup_steps=2, grad_accum=TRAIN_GA)
    runs = []
    for _ in range(2):
        opt, state = _train_state(cfg, tc)
        step = ts.make_train_step(cfg, tc, opt, device="cuda",
                                  loss_fn=_kernel_ce_loss(cfg))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fc.reset_launch_counts()
        losses, times = [], []
        for _ in range(CE_TRAIN_STEPS):
            t0 = time.monotonic()
            state, m = step(state, {"tokens": tokens})
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
        runs.append((losses, times, dict(fc.launch_counts),
                     torch.cuda.max_memory_allocated()))
        del opt, state, step
        torch.cuda.empty_cache()
    losses, times, launches, peak = runs[0]
    step_s = float(np.mean(times[1:]))
    emit({"phase": "train_ce", "route": "B3/B4 kernels",
          "micro_batch": TRAIN_MICRO, "seq": TRAIN_SEQ,
          "grad_accum": TRAIN_GA, "steps": CE_TRAIN_STEPS, "losses": losses,
          "step_s": times, "step_s_mean_after_first": step_s,
          "tokens_per_s": TRAIN_GA * micro_tokens / step_s,
          "peak_memory_gib": peak / 2**30, "launches": launches,
          "rerun_losses": runs[1][0],
          "rerun_bitwise_equal": runs[1][0] == losses})
    check(all(np.isfinite(losses)), f"train_ce: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"train_ce: loss did not fall {losses}")
    want = CE_TRAIN_STEPS * TRAIN_GA
    for name, n in launches.items():
        check(n == want, f"train_ce: {name} launched {n} times, want {want}")
    check(runs[1][0] == losses, f"train_ce: a rerun gave {runs[1][0]}, "
                                f"the first {losses}")
    return launches


# ---- MoE (B7, B8) ------------------------------------------------------------


def moe_config():
    """bench.py's moe_phase model (:725-729): the flagship's attention
    with 8 experts of mlp 1024 in every layer, top-2, dropless (535M
    params, 233M active); remat ``mlp_only``."""
    from dlrover_tpu_torch.models import llama

    return llama.TpuLMConfig(
        vocab_size=32000, embed_dim=1024, n_layers=16, n_heads=8,
        n_kv_heads=8, head_dim=128, mlp_dim=1024, dtype="bfloat16",
        n_experts=8, moe_top_k=2, moe_impl="dropless",
    )


def _moe_kernel_inputs(n, routing, gen, d=1024, f=1024, e=8, k=2):
    """bench.py ``_moe_bench_tensors``' scales (:773): x ~ N(0, 1) bf16
    [n, d], router N(0, 1) / 8 f32, gate|up [e, d, 2f] and down [e, f, d]
    N(0, 1) / sqrt(fan_in) bf16, and a bf16 cotangent dy ~ N(0, 1) [n k,
    d]. ``routing`` "router" takes the router's top-k; "skewed" puts the
    first half of the copies on expert 0 and the rest at random on
    experts 0..e-2, so expert e-1 is empty. Returns the tensors, the
    layout and its tile."""
    from dlrover_tpu_torch.models import moe
    from dlrover_tpu_torch.ops import moe_dispatch as md

    x = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
    router = torch.randn(d, e, generator=gen, device="cuda") / 8
    w_gu = (torch.randn(e, d, 2 * f, generator=gen, device="cuda")
            / d ** 0.5).bfloat16()
    w_down = (torch.randn(e, f, d, generator=gen, device="cuda")
              / f ** 0.5).bfloat16()
    dy = torch.randn(n * k, d, generator=gen, device="cuda").bfloat16()
    m = n * k
    if routing == "router":
        fe = moe._top_k(torch.softmax(x.float() @ router, dim=-1), k)[1]
    else:
        fe = torch.randint(0, e - 1, (m,), generator=gen, device="cuda")
        fe[: m // 2] = 0
    tm = md.default_tile_m(m)
    ids = md.build_dispatch_layout(fe.reshape(m).to(torch.int32), e, tm, k)
    return x, w_gu, w_down, dy, ids, tm


def _moe_bound(name, n, m, m_pad, T, d, f, e, e_routed):
    """Least time for one B7/B8 kernel's work: its bytes (each input
    once: x or its rows, dy, the weights of the experts that have rows,
    the ids; each output once, the sorted a and dh at m_pad rows) over
    the HBM rate, against 2 flops a multiply-add on the m real copies
    over the bf16 peak (B7 6 m d f, dx 10 m d f, dw_gu 4 m d f, dw_down
    2 m d f). dx's two launches apart: the first (h, da and the
    silu-gate backward, writing a and dh) 6 m d f, the second (dh @
    w_gu^T scattered) 4 m d f."""
    weights = e_routed * 3 * d * f * 2
    ids = 2 * m_pad * 4 + T * 4
    x_b, rows = n * d * 2, m * d * 2
    moved, flops = {
        "grouped_ffn_forward": (x_b + weights + ids + rows, 6 * m * d * f),
        "grouped_ffn_backward_dx": (
            x_b + rows + weights + ids + rows + m_pad * 3 * f * 2,
            10 * m * d * f),
        "grouped_ffn_backward_dx_first": (
            x_b + rows + weights + ids + m_pad * 3 * f * 2, 6 * m * d * f),
        "grouped_ffn_backward_dx_second": (
            m_pad * 2 * f * 2 + e_routed * 2 * d * f * 2 + m_pad * 4 + T * 4
            + rows, 4 * m * d * f),
        "grouped_ffn_backward_dw_gu": (
            x_b + m_pad * 2 * f * 2 + m_pad * 4 + T * 4 + e * d * 2 * f * 4,
            4 * m * d * f),
        "grouped_ffn_backward_dw_down": (
            m_pad * f * 2 + rows + m_pad * 4 + T * 4 + e * f * d * 4,
            2 * m * d * f),
    }[name]
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_OPS_PER_S["bfloat16"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", moved, flops)


def _moe_library_calls(x, w_gu, w_down, dy, dh, a, ids, tm):
    """The library yardstick of each kernel, only timed: the per-expert
    ``torch.matmul`` loop over the expert-sorted copies (the port's
    "gmm" route), with the gather before it and the scatter after it.
    Group sizes are read to the host here, outside the timed calls."""
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import moe_dispatch as md
    from dlrover_tpu_torch.ops.fused_ce import _mm_f32

    ri, di, te = ids
    e, _, two_f = w_gu.shape
    f = two_f // 2
    m, d = dy.shape
    slots = (ri >= 0).nonzero()[:, 0]            # sorted copies, in order
    src, dst = ri[slots].long(), di[slots].long()
    sizes = torch.bincount(te.repeat_interleave(tm)[slots].long(),
                           minlength=e).tolist()
    ends = np.cumsum(sizes)
    ranges = [(int(s1 - n), int(s1), g) for g, (n, s1) in
              enumerate(zip(sizes, ends)) if n]

    def forward():
        xs = x[src]
        outs = []
        for s0, s1, g in ranges:
            h = xs[s0:s1] @ w_gu[g]
            outs.append((F.silu(h[:, :f]) * h[:, f:]) @ w_down[g])
        y = torch.empty((m, d), dtype=x.dtype, device=x.device)
        y[dst] = torch.cat(outs)
        return y

    def backward_dx():
        xs, dys = x[src], dy[dst]
        outs = []
        for s0, s1, g in ranges:
            h = (xs[s0:s1] @ w_gu[g]).float()
            da = (dys[s0:s1] @ w_down[g].t()).float()
            dhg, dhu = md._silu_bwd(h[:, :f], h[:, f:], da)
            outs.append(torch.cat([dhg, dhu], dim=1).bfloat16()
                        @ w_gu[g].t())
        dx = torch.empty((m, d), dtype=x.dtype, device=x.device)
        dx[dst] = torch.cat(outs)
        return dx

    def backward_dx_first():
        xs, dys = x[src], dy[dst]
        dhs, outs = [], []
        for s0, s1, g in ranges:
            h = (xs[s0:s1] @ w_gu[g]).float()
            da = (dys[s0:s1] @ w_down[g].t()).float()
            dhg, dhu = md._silu_bwd(h[:, :f], h[:, f:], da)
            dhs.append(torch.cat([dhg, dhu], dim=1).bfloat16())
            outs.append((F.silu(h[:, :f]) * h[:, f:]).bfloat16())
        return torch.cat(dhs), torch.cat(outs)

    def backward_dx_second():
        dhs = dh[slots]
        outs = [dhs[s0:s1] @ w_gu[g].t() for s0, s1, g in ranges]
        dx = torch.empty((m, d), dtype=x.dtype, device=x.device)
        dx[dst] = torch.cat(outs)
        return dx

    def backward_dw(lhs, rhs, out_shape):
        def call():
            dw = torch.zeros(out_shape, dtype=torch.float32, device=x.device)
            ls, rs = lhs(), rhs()
            for s0, s1, g in ranges:
                dw[g] = _mm_f32(ls[s0:s1].t(), rs[s0:s1])
            return dw
        return call

    return {
        "grouped_ffn_forward": forward,
        "grouped_ffn_backward_dx": backward_dx,
        "grouped_ffn_backward_dx_first": backward_dx_first,
        "grouped_ffn_backward_dx_second": backward_dx_second,
        "grouped_ffn_backward_dw_gu": backward_dw(
            lambda: x[src], lambda: dh[slots], (e, d, two_f)),
        "grouped_ffn_backward_dw_down": backward_dw(
            lambda: a[slots], lambda: dy[dst], (e, f, d)),
    }


def phase_moe_kernels():
    """B7 and B8 (dx, dw_gu, dw_down) against their plain versions on the
    same inputs: the training shape (8 x 2048 tokens routed by the
    router, tile 128), a skewed routing (half the copies on one expert,
    one expert empty) and a decode step (8 tokens, tile 16). Outputs pass
    elementwise within CE_REL |ref| + CE_ROW rms_d(ref) + CE_FLOOR
    rms(ref) (_ce_ratio: both round a, dh and the outputs at the same
    places from f32 sums taken in another order), rms_d over d of a row
    (y, dx_c, a, dh) or over the rows of a weight column (dw). The dw
    kernels get the plain dx kernel's dh and a, so each is held alone.
    One planted fault per kernel must fail the same bound: B7 and dx with
    the last routed tile run on the next expert's weights, dw_gu and
    dw_down without that tile's rows. Times: CUDA events, cold L2; B8
    dx also has its two launches timed apart (``launches_apart``: µs,
    bound and library yardstick of each, launched through
    ``backward_dx_launch``, which counts no launch)."""
    from dlrover_tpu_torch.ops import moe_dispatch as md

    gen = torch.Generator("cuda").manual_seed(SEED + 7)
    shapes = [("train", MOE_MICRO * MOE_SEQ, "router"),
              ("skewed", MOE_MICRO * MOE_SEQ, "skewed"),
              ("decode", 8, "router")]
    rows = {}
    for label, n, routing in shapes:
        x, w_gu, w_down, dy, ids, tm = _moe_kernel_inputs(n, routing, gen)
        ri, di, te = ids
        e, d, two_f = w_gu.shape
        f, m, T = two_f // 2, dy.shape[0], te.shape[0]
        y = md.grouped_ffn_forward(x, w_gu, w_down, ri, di, te, m, tm)
        dx_c, dh, a = md.grouped_ffn_backward_dx(x, dy, w_gu, w_down, ri, di,
                                                 te, tm)
        torch.cuda.synchronize()
        ref_y = md._forward_reference(x, w_gu, w_down, ri, di, te, m, tm)
        ref_dx, ref_dh, ref_a = md._backward_dx_reference(
            x, dy, w_gu, w_down, ri, di, te, tm)
        dwgu = md.grouped_ffn_backward_dw_gu(x, ref_dh, ri, te, e, tm)
        dwdn = md.grouped_ffn_backward_dw_down(ref_a, dy, di, te, e, tm)
        torch.cuda.synchronize()
        ref_gu = md._backward_dw_gu_reference(x, ref_dh, ri, te, e, tm)
        ref_dn = md._backward_dw_down_reference(ref_a, dy, di, te, e, tm)
        ratio = {"y": _ce_ratio(y, ref_y, -1),
                 "dx_c": _ce_ratio(dx_c, ref_dx, -1),
                 "dh": _ce_ratio(dh, ref_dh, -1), "a": _ce_ratio(a, ref_a, -1),
                 "dw_gu": _ce_ratio(dwgu, ref_gu, 1),
                 "dw_down": _ce_ratio(dwdn, ref_dn, 1)}

        def err(p, q):
            return float((p.float() - q.float()).abs().max())

        errs = {
            "grouped_ffn_forward": err(y, ref_y),
            "grouped_ffn_backward_dx": max(err(dx_c, ref_dx), err(dh, ref_dh),
                                           err(a, ref_a)),
            "grouped_ffn_backward_dw_gu": err(dwgu, ref_gu),
            "grouped_ffn_backward_dw_down": err(dwdn, ref_dn),
        }
        routed = (ri.view(-1, tm) >= 0).any(dim=1)
        # Experts without rows: all-zero weight gradients.
        has_rows = torch.zeros(e, dtype=torch.bool, device="cuda")
        has_rows[te[routed].long()] = True
        empty_zero = bool(not dwgu[~has_rows].any()
                          and not dwdn[~has_rows].any())
        e_routed = int(has_rows.sum())
        del y, dx_c, dwgu, dwdn
        # Every kernel (redesigned): the same bits on a second call.
        bitwise = {
            "forward": _check_rerun(
                f"moe/{label}/forward",
                lambda: md.grouped_ffn_forward(x, w_gu, w_down, ri, di, te,
                                               m, tm)),
            "dx": _check_rerun(
                f"moe/{label}/dx",
                lambda: md.grouped_ffn_backward_dx(x, dy, w_gu, w_down, ri,
                                                   di, te, tm)),
            "dw_gu": _check_rerun(
                f"moe/{label}/dw_gu",
                lambda: md.grouped_ffn_backward_dw_gu(x, ref_dh, ri, te, e,
                                                      tm)),
            "dw_down": _check_rerun(
                f"moe/{label}/dw_down",
                lambda: md.grouped_ffn_backward_dw_down(ref_a, dy, di, te, e,
                                                        tm)),
        }
        # Planted faults, from the plain versions.
        last = int(routed.nonzero().max())
        te_bad = te.clone()
        te_bad[last] = (te_bad[last] + 1) % e
        cut = torch.arange(T * tm, device="cuda") // tm == last
        ri_cut = torch.where(cut, -1, ri)
        di_cut = torch.where(cut, -1, di)
        fault = {
            "y": _ce_ratio(md._forward_reference(
                x, w_gu, w_down, ri, di, te_bad, m, tm), ref_y, -1),
            "dx_c": _ce_ratio(md._backward_dx_reference(
                x, dy, w_gu, w_down, ri, di, te_bad, tm)[0], ref_dx, -1),
            "dw_gu": _ce_ratio(md._backward_dw_gu_reference(
                x, ref_dh, ri_cut, te, e, tm), ref_gu, 1),
            "dw_down": _ce_ratio(md._backward_dw_down_reference(
                ref_a, dy, di_cut, te, e, tm), ref_dn, 1),
        }
        emit({"phase": "moe_bounds", "shape": label, "n": n, "m": m,
              "tile_m": tm, "tiles": T, "experts_with_rows": e_routed,
              "ratio": ratio, "planted_fault_ratio": fault,
              "empty_experts_zero": empty_zero, "bitwise_rerun": bitwise})
        for out, r in ratio.items():
            check(r <= 1.0, f"moe/{label}: {out} at {r} of its bound")
        for out, r in fault.items():
            check(r > 1.0, f"moe/{label}: the {out} bound passes a planted "
                           f"fault ({r})")
        check(empty_zero, f"moe/{label}: an expert without rows got a "
                          f"nonzero weight gradient")

        library = _moe_library_calls(x, w_gu, w_down, dy, ref_dh, ref_a, ids,
                                     tm)
        # B8 dx's two launches apart: the first writes a and dh, the
        # second reads dh.
        apart = {}
        for part, which in (("first", 1), ("second", 2)):
            def one():
                return md.backward_dx_launch(
                    x, dy, w_gu, w_down, ri, di, te, tm, which,
                    dh=ref_dh if which == 2 else None)
            ms = _time_ms(one, iters=10)
            name = f"grouped_ffn_backward_dx_{part}"
            bound_ms, bound_by, moved, flops = _moe_bound(
                name, n, m, T * tm, T, d, f, e, e_routed)
            apart[part] = {
                "ms": ms, "library_ms": _time_ms(library[name], iters=5),
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
                "flops": flops, "bound_share": bound_ms / ms}
        apart["first"]["library"] = ("per-expert x @ w_gu and dy @ w_down^T "
                                     "with the silu-gate backward")
        apart["second"]["library"] = "per-expert dh @ w_gu^T with scatter"
        calls = {
            "grouped_ffn_forward": (
                lambda: md.grouped_ffn_forward(x, w_gu, w_down, ri, di, te,
                                               m, tm),
                lambda: md._forward_reference(x, w_gu, w_down, ri, di, te,
                                              m, tm)),
            "grouped_ffn_backward_dx": (
                lambda: md.grouped_ffn_backward_dx(x, dy, w_gu, w_down, ri,
                                                   di, te, tm),
                lambda: md._backward_dx_reference(x, dy, w_gu, w_down, ri,
                                                  di, te, tm)),
            "grouped_ffn_backward_dw_gu": (
                lambda: md.grouped_ffn_backward_dw_gu(x, ref_dh, ri, te, e,
                                                      tm),
                lambda: md._backward_dw_gu_reference(x, ref_dh, ri, te, e,
                                                     tm)),
            "grouped_ffn_backward_dw_down": (
                lambda: md.grouped_ffn_backward_dw_down(ref_a, dy, di, te, e,
                                                        tm),
                lambda: md._backward_dw_down_reference(ref_a, dy, di, te, e,
                                                       tm)),
        }
        for name, (kernel, plain) in calls.items():
            ms = _time_ms(kernel, iters=10)
            plain_ms = _time_ms(plain, iters=3)
            library_ms = _time_ms(library[name], iters=5)
            bound_ms, bound_by, moved, flops = _moe_bound(
                name, n, m, T * tm, T, d, f, e, e_routed)
            row = {
                "phase": "kernel", "kernel": name, "shape": label, "n": n,
                "m": m, "d": d, "f": f, "e": e, "tile_m": tm,
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms,
                "library": "per-expert torch.matmul loop with gather and "
                           "scatter",
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
                "flops": flops, "bound_share": bound_ms / ms,
                "tflops": flops / ms / 1e9,
            }
            if name == "grouped_ffn_backward_dx":
                row["launches_apart"] = apart
            emit(row)
            rows[(name, label)] = row
        del library, calls, x, w_gu, w_down, dy, ref_dh, ref_a
        torch.cuda.empty_cache()
    return rows


def _routing_patch(top_k):
    """A context manager under which every dropless MoE layer routes
    through ``top_k(orig, probs, k)`` in place of ``models/moe._top_k``
    (``orig``)."""
    import contextlib

    from dlrover_tpu_torch.models import moe

    @contextlib.contextmanager
    def patch():
        orig = moe._top_k
        moe._top_k = functools.partial(top_k, orig)
        try:
            yield
        finally:
            moe._top_k = orig

    return patch()


def _routing_recorder(store, margins=None):
    """Every MoE layer appends its top-k expert ids [tokens, k] to
    ``store`` and, given ``margins``, the log-probability gap between
    its k-th and (k+1)-th expert [tokens] (kept on the device, no
    sync)."""
    def top_k(orig, probs, k):
        values, indices = orig(probs, k)
        store.append(indices)
        if margins is not None:
            top = torch.topk(probs, k + 1, dim=-1).values.log()
            margins.append(top[..., k - 1] - top[..., k])
        return values, indices

    return _routing_patch(top_k)


def _pinned_routing(ids):
    """Layer ``l``'s call routes to ``ids[l]`` [tokens, k], gated by its
    own probabilities there: the teacher-forced forward given the decode
    path's expert choices."""
    calls = iter(ids)

    def top_k(orig, probs, k):
        idx = next(calls)
        return probs.gather(-1, idx), idx

    return _routing_patch(top_k)


def phase_moe_generate(cfg, params):
    """MoE ``generate()``: b=8, prompt 128, 256 new greedy tokens, fp
    cache, twice (the second timed), after a prefill-alone run. Checks:
    the two runs agree bit for bit; exact launches per run (B7 once a
    layer per forward: the prefill and 255 single-token steps; B5 once a
    layer per single-token step; nothing else); the teacher-forced gap.

    The cached path and the teacher-forced forward round bf16 at other
    places, so a router near-tie may pick another expert set at some
    layer: the position "flips". A flip changes that token's K/V at every
    later layer, which every later position reads, so flips spread. The
    gap is held (ARGMAX_GAP) at every position once the teacher-forced
    forward is pinned to the decode path's routing, and at every
    position without a flip in the free forward. Flips at the first
    layer, where nothing has spread yet, must be near-ties (MOE_TIE).
    Returns the launches of the timed run."""
    from dlrover_tpu_torch.models import generate as gen
    from dlrover_tpu_torch.ops import decode_attention as da
    from dlrover_tpu_torch.ops import moe_dispatch as md

    b, prompt_len, new = 8, 128, 256
    L = cfg.n_layers
    prompt = torch.randint(
        0, cfg.vocab_size, (b, prompt_len),
        generator=torch.Generator("cuda").manual_seed(SEED + 1),
        device="cuda", dtype=torch.int32,
    )

    def run(n_new, store=None):
        da.reset_launch_counts()
        md.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if store is None:
            toks = gen.generate(cfg, params, prompt, n_new).tokens.cpu()
        else:
            with _routing_recorder(store):
                toks = gen.generate(cfg, params, prompt, n_new).tokens.cpu()
        wall = time.monotonic() - t0
        return toks, wall, {**da.launch_counts, **md.launch_counts}

    def want(n_new):
        counts = {name: 0 for name in (*da.launch_counts, *md.launch_counts)}
        counts["grouped_ffn_forward"] = L * n_new
        counts["decode_attention_fp"] = L * (n_new - 1)
        return counts

    _, t_prefill, launches = run(1)
    check(launches == want(1), f"moe_generate/prefill: launches {launches}")
    decode_ids = []
    toks, _, launches = run(new, decode_ids)
    check(launches == want(new), f"moe_generate: launches {launches}, want "
                                 f"{want(new)}")
    toks2, t_total, launches = run(new)
    check(launches == want(new), f"moe_generate/rerun: launches {launches}")
    check(toks.shape == (b, new), f"moe_generate: shape {toks.shape}")
    check(torch.equal(toks, toks2), "moe_generate: two runs disagree")

    seqs = torch.cat([prompt.cpu(), toks], dim=1).cuda()
    s = seqs.shape[1]
    n_pos = s - 1      # the last token is never fed to the decode path

    def sets(ids):
        """[L, b, s, k] sorted expert sets from per-layer [b s, k] ids."""
        return torch.sort(torch.stack(
            [t.reshape(b, -1, t.shape[-1]) for t in ids]), dim=-1).values

    # Decode routing per layer: the prefill's call, then one call per
    # single-token step.
    cached = sets([torch.cat(
        [decode_ids[layer].reshape(b, prompt_len, -1)]
        + [decode_ids[L * (j + 1) + layer].reshape(b, 1, -1)
           for j in range(new - 1)], dim=1).reshape(b * n_pos, -1)
        for layer in range(L)])                        # [L, b, n_pos, k]
    free_ids, margins = [], []
    with _routing_recorder(free_ids, margins):
        gap, hit = _argmax_gaps(cfg, params, seqs, prompt_len)
    free = sets(free_ids)
    pinned = torch.cat([cached, free[:, :, n_pos:]], dim=2)
    with _pinned_routing([t.reshape(b * s, -1) for t in pinned]):
        gap_pinned, hit_pinned = _argmax_gaps(cfg, params, seqs, prompt_len)

    same = (cached == free[:, :, :n_pos]).all(dim=-1)          # [L, b, n]
    agree = same.all(dim=0)
    first = ~same[0]
    tie_worst = (float(margins[0].reshape(b, s)[:, :n_pos][first].max())
                 if bool(first.any()) else 0.0)
    # Token t is chosen from position t - 1's logits.
    held = agree[:, prompt_len - 1:]
    gap_held = float(gap[held].max()) if bool(held.any()) else 0.0
    row = {
        "phase": "moe_generate", "kv": "fp", "batch": b,
        "prompt_len": prompt_len, "new_tokens": new, "total_s": t_total,
        "prefill_s": t_prefill,
        "decode_tok_s": b * (new - 1) / (t_total - t_prefill),
        "ms_per_step": 1e3 * (t_total - t_prefill) / (new - 1),
        "argmax_gap_max_pinned_routing": float(gap_pinned.max()),
        "argmax_agree_pinned_routing": float(hit_pinned.float().mean()),
        "argmax_gap_max_without_flips": gap_held,
        "argmax_gap_max_free": float(gap.max()),
        "argmax_agree_free": float(hit.float().mean()),
        "positions": b * n_pos,
        "flip_share": 1.0 - float(agree.float().mean()),
        "flip_share_per_layer": (~same).float().mean(dim=(1, 2)).tolist(),
        "first_layer_flips": int(first.sum()),
        "first_layer_flip_max_margin": tie_worst,
        "launches": launches,
    }
    emit(row)
    check(float(gap_pinned.max()) <= ARGMAX_GAP["fp"],
          f"moe_generate: token {float(gap_pinned.max())} logits below the "
          f"teacher-forced max under the decode path's routing")
    check(gap_held <= ARGMAX_GAP["fp"],
          f"moe_generate: token {gap_held} logits below the teacher-forced "
          f"max at a position without a routing flip")
    check(tie_worst <= MOE_TIE,
          f"moe_generate: a first-layer routing flip at a log-probability "
          f"margin of {tie_worst}, not a near-tie")
    wall, device = _device_profile(lambda: gen.generate(
        cfg, params, prompt, 32).tokens.cpu())
    emit(_profile_row("moe_generate/32", wall, device, kernel="grouped_ffn",
                      match="moe_", top_n=10))
    return launches


def phase_moe_train(cfg):
    """MoE training through ``make_train_step`` (remat ``mlp_only``,
    micro-batch 8 x 2048, grad_accum 1). Check one: a step through the
    kernels against the same step through the plain ``grouped_ffn``,
    both on one recorded routing, held to TRAIN_GATES, and a planted
    fault (B8 dw_down leaving expert 0's gradient at zero) the gates must
    reject; the plain step on its own routing is reported. Check two: MOE_STEPS
    steps with falling loss, twice from the seed with equal losses bit
    for bit, and exact launches: B1, B2 and each B8 kernel once a layer
    a step, B7 twice (the checkpointed out+MLP flank runs it again in the
    backward). Returns the launches of the first run."""
    import contextlib

    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import moe_dispatch as md
    from dlrover_tpu_torch.trainer import train_step as ts

    rs = np.random.RandomState(SEED + 1)
    tokens = torch.from_numpy(rs.randint(
        0, cfg.vocab_size, (MOE_MICRO, MOE_SEQ + 1)).astype(np.int32)).cuda()

    def patched(name, fn):
        @contextlib.contextmanager
        def patch():
            orig = getattr(md, name)
            setattr(md, name, fn(orig))
            try:
                yield
            finally:
                setattr(md, name, orig)
        return patch

    def drop_expert0(orig):
        def dw_down(*args, **kwargs):
            dw = orig(*args, **kwargs)
            dw[0] = 0.0
            return dw
        return dw_down

    # The kernels and the plain version round a and y at other places, so
    # a router near-tie in a later layer may pick other experts, and the
    # flip spreads to later positions through attention. The gated steps
    # are therefore pinned to the routing of one recorded kernel step;
    # the plain step with its own routing is reported beside them.
    routing = []
    _one_step_rows(cfg, tokens,
                   {"record": (None, lambda: _routing_recorder(routing))})

    def pinned(*patches):
        @contextlib.contextmanager
        def patch():
            with contextlib.ExitStack() as stack:
                stack.enter_context(_pinned_routing(routing))
                for extra in patches:
                    stack.enter_context(extra())
                yield
        return patch

    plain = patched(
        "grouped_ffn",
        lambda orig: lambda *a, **k: orig(*a, **{**k, "plain": True}))
    variants = {
        "plain": (None, pinned(plain)),
        "kernel": (None, pinned()),
        "fault_dw_down": (None, pinned(patched("grouped_ffn_backward_dw_down",
                                               drop_expert0))),
        "plain_own_routing": (None, plain),
    }
    one = _one_step_rows(cfg, tokens, variants)
    emit({"phase": "moe_train_vs_plain", "micro_batch": MOE_MICRO,
          "seq": MOE_SEQ, "gates": TRAIN_GATES, **one})
    _check_step_gates("moe_train", one, "fault_dw_down")

    tc = ts.TrainConfig(warmup_steps=2, grad_accum=1)
    runs = []
    for run in range(2):
        opt, state = _train_state(cfg, tc)
        step = ts.make_train_step(cfg, tc, opt, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        md.reset_launch_counts()
        losses, norms, times = [], [], []
        for _ in range(MOE_STEPS):
            t0 = time.monotonic()
            state, m = step(state, {"tokens": tokens})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
        launches = {**fa.launch_counts, **md.launch_counts}
        runs.append((losses, norms, times, launches,
                     torch.cuda.max_memory_allocated()))
        if run == 0:
            wall, device = _device_profile(
                lambda: float(step(state, {"tokens": tokens})[1]["loss"]))
            emit(_profile_row("moe_train/step", wall, device,
                              kernel="grouped_ffn", match="moe_", top_n=12))
        del opt, state, step
        torch.cuda.empty_cache()

    losses, norms, times, launches, peak = runs[0]
    step_s = float(np.mean(times[1:]))
    tokens_per_step = MOE_MICRO * MOE_SEQ
    flops_per_token = 6.0 * cfg.count_active_params()
    row = {
        "phase": "moe_train", "remat_policy": cfg.remat_policy,
        "micro_batch": MOE_MICRO, "seq": MOE_SEQ, "grad_accum": 1,
        "steps": MOE_STEPS, "params": cfg.count_params(),
        "active_params": cfg.count_active_params(), "losses": losses,
        "grad_norms": norms, "step_s": times,
        "step_s_mean_after_first": step_s,
        "tokens_per_s": tokens_per_step / step_s,
        "active_flops_per_token": flops_per_token,
        "active_flops_share_of_peak": flops_per_token * tokens_per_step
        / step_s / PEAK_OPS_PER_S["bfloat16"],
        "peak_memory_gib": peak / 2**30, "launches": launches,
        "rerun_losses": runs[1][0],
        "rerun_bitwise_equal": runs[1][0] == losses,
    }
    emit(row)
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"moe_train: non-finite loss or grad norm {losses} {norms}")
    check(losses[-1] < losses[0], f"moe_train: loss did not fall {losses}")
    per_layer = {name: 1 for name in launches}
    per_layer["grouped_ffn_forward"] = 2
    for name, n in launches.items():
        want = per_layer[name] * cfg.n_layers * MOE_STEPS
        check(n == want, f"moe_train: {name} launched {n} times, want {want}")
    check(runs[1][0] == losses, f"moe_train: a rerun gave {runs[1][0]}, "
                                f"the first {losses}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import decode_attention as da
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import fused_ce as fc
    from dlrover_tpu_torch.ops import moe_dispatch as md

    # fp32 matmuls run in full fp32 (no TF32) for the plain versions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device()
    ptxas = phase_build()
    kernel_rows = phase_kernels()
    paged_rows = phase_paged_kernels()
    flash_rows = phase_flash_kernels()

    cfg = flagship_config()
    params = llama.init_params(
        cfg, torch.Generator("cuda").manual_seed(SEED), device="cuda"
    )
    da.reset_launch_counts()
    gen_rows = phase_generate(cfg, params)
    gen_launches = dict(da.launch_counts)
    da.reset_launch_counts()
    md.reset_launch_counts()
    eng_launches, served = phase_engine(cfg, params)
    da.reset_launch_counts()
    paged_want = phase_paged_engine(cfg, params)
    paged_launches = dict(da.launch_counts)
    # Each spec run checks its own launches exactly.
    spec_launches = phase_spec_engine(cfg, params, served)
    paged_spec_launches = phase_paged_spec_engine(cfg, params, served)
    launches = {
        name: gen_launches[name] + eng_launches[name] + paged_launches[name]
        + spec_launches[name] + paged_spec_launches[name]
        for name in da.launch_counts
    }
    emit({"phase": "launches", "generate": gen_launches,
          "engine": eng_launches, "paged_engine": paged_launches,
          "paged_engine_want": paged_want, "spec_engine": spec_launches,
          "paged_spec_engine": paged_spec_launches,
          "per_decoded_token_generate": cfg.n_layers})
    # generate(): one launch per layer per single-token step, in two
    # full runs and one profiled run of 32 tokens.
    for kv in ("fp", "int8"):
        want = cfg.n_layers * (2 * (gen_rows[kv]["new_tokens"] - 1) + 31)
        got = gen_launches[f"decode_attention_{kv}"]
        check(got == want, f"generate/{kv}: {got} launches, want {want}")
    check(eng_launches["decode_attention_fp"] >= cfg.n_layers,
          "engine: the decode kernel never launched")
    # The paged engines: one B6 launch per layer per decode step (each
    # engine's warmup step included), and no other decode kernel.
    for name, want in paged_want.items():
        check(paged_launches[name] == want,
              f"paged engine: {paged_launches[name]} launches of {name}, "
              f"want {want}")
    check(paged_launches["decode_attention_fp"] == 0
          and paged_launches["decode_attention_int8"] == 0,
          f"paged engine launched the flat kernel: {paged_launches}")

    del params
    torch.cuda.empty_cache()
    launches.update(phase_train(cfg))
    ce_rows = phase_ce_kernels()
    phase_ce_ab()
    launches.update(phase_train_ce(cfg))

    moe_rows = phase_moe_kernels()
    moe_cfg = moe_config()
    moe_params = llama.init_params(
        moe_cfg, torch.Generator("cuda").manual_seed(SEED), device="cuda"
    )
    moe_launches = {"generate": phase_moe_generate(moe_cfg, moe_params)}
    da.reset_launch_counts()
    md.reset_launch_counts()
    moe_launches["engine"], moe_served = phase_engine(
        moe_cfg, moe_params, phase="moe_engine", gated=False)
    for name in ("decode_attention_fp", "grouped_ffn_forward"):
        check(moe_launches["engine"][name] >= moe_cfg.n_layers,
              f"moe_engine: {name} never launched")
    moe_launches["paged_engine"] = phase_moe_paged_engine(
        moe_cfg, moe_params, moe_served)
    del moe_params
    torch.cuda.empty_cache()
    moe_launches["train"] = phase_moe_train(moe_cfg)
    emit({"phase": "moe_launches", **moe_launches})
    for counts in moe_launches.values():
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")

    replaces = {
        "decode_attention_fp": "dlrover_tpu/ops/decode_attention.py:234",
        "decode_attention_int8": "dlrover_tpu/ops/decode_attention.py:244",
        "paged_decode_attention_fp":
            "dlrover_tpu/ops/decode_attention.py:254",
        "paged_decode_attention_int8":
            "dlrover_tpu/ops/decode_attention.py:267",
        "flash_forward": "dlrover_tpu/ops/pallas_attention.py:53",
        "flash_backward_dq": "dlrover_tpu/ops/pallas_attention.py:242",
        "flash_backward_dkv": "dlrover_tpu/ops/pallas_attention.py:301",
        "fused_ce_forward": "dlrover_tpu/ops/fused_ce.py:310",
        "fused_ce_backward_dx": "dlrover_tpu/ops/fused_ce.py:357",
        "fused_ce_backward_dw": "dlrover_tpu/ops/fused_ce.py:395",
        "grouped_ffn_forward": "dlrover_tpu/ops/moe_dispatch.py:188",
        "grouped_ffn_backward_dx": "dlrover_tpu/ops/moe_dispatch.py:210",
        "grouped_ffn_backward_dw_gu": "dlrover_tpu/ops/moe_dispatch.py:248",
        "grouped_ffn_backward_dw_down":
            "dlrover_tpu/ops/moe_dispatch.py:272",
    }
    sources = {
        "decode_attention": "dlrover_tpu_torch/ops/csrc/decode_attention.cu",
        "flash": "dlrover_tpu_torch/ops/csrc/flash_attention.cu",
        "fused_ce": "dlrover_tpu_torch/ops/csrc/fused_ce.cu",
        "moe": "dlrover_tpu_torch/ops/csrc/moe_dispatch.cu",
    }
    rows = [(name, kernel_rows[("main_path", kv)], sources["decode_attention"])
            for name, kv in (("decode_attention_fp", "fp"),
                             ("decode_attention_int8", "int8"))]
    rows += [("paged_decode_attention_fp", paged_rows[("engine", "fp")],
              sources["decode_attention"]),
             ("paged_decode_attention_int8",
              paged_rows[("engine_int8", "int8")],
              sources["decode_attention"])]
    rows += [(name, flash_rows[(name, "train")], sources["flash"])
             for name in ("flash_forward", "flash_backward_dq",
                          "flash_backward_dkv")]
    rows += [(name, ce_rows[(name, "ce_ab")], sources["fused_ce"])
             for name in ("fused_ce_forward", "fused_ce_backward_dx",
                          "fused_ce_backward_dw")]
    rows += [(name, moe_rows[(name, "train")], sources["moe"])
             for name in ("grouped_ffn_forward", "grouped_ffn_backward_dx",
                          "grouped_ffn_backward_dw_gu",
                          "grouped_ffn_backward_dw_down")]
    kernels = []
    for name, row, source in rows:
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    # The sources whose kernels were redesigned for Hopper (B1 and B2; B5
    # and B6; B3, B4 dx and dw; B7, B8 dx and B8 dw), and the launch
    # shapes ptxas does not print.
    emit({"ptxas": {src: ptxas.get(src, []) for src in
                    ("flash_attention.cu", "decode_attention.cu",
                     "fused_ce.cu", "moe_dispatch.cu")},
          "flash_dynamic_smem_bytes": fa.dynamic_smem_bytes(),
          "ce_fwd_launch": fc.fwd_kernel_config(),
          "ce_dx_launch": {d: fc.dx_kernel_config(d)
                           for d in (128, 384, 1024)},
          "ce_dw_launch": {d: fc.dw_kernel_config(d) for d in (128, 1024)},
          "moe_ffn_launch": {tm: md.ffn_kernel_config(tm) for tm in (16, 128)},
          "moe_dx_gate_up_launch": {
              tm: md.dx_gate_up_kernel_config(tm) for tm in (16, 128)},
          "moe_dw_launch": {
              "dw_gu": md.dw_kernel_config(1024, 2048, True),
              "dw_down": md.dw_kernel_config(1024, 1024, False)}})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
