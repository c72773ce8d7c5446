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
   path's shape and at the flagship and GQA decode shapes; flash
   attention forward (B1) and its dq and dk/dv backward kernels (B2) at
   the training shape (b=8, s=2048, h=kh=8, d=128, causal), a GQA shape
   (b=2, h=32, kh=8), a non-causal one and a ragged s=1000, each held
   elementwise and with a planted fault its bound must reject;
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
   memory and a profiled step.

Phases 4 and 5 check the tokens against the argmax of the port's own
teacher-forced forward over prompt + output, check that repeated runs
agree, and read the kernels' launch counters to show the decode path
went through them. Any failure raises (exit code 1) before the last
line, which is ``{"ok": true, "device": {...}}``.
"""

import json
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
    from dlrover_tpu_torch.ops import _ext

    t0 = time.monotonic()
    per_source = _ext.build()
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "per_source_s": per_source,
          "ptxas": {s: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "entry function" in ln]
                    for s, log in _ext.build_logs.items()}})


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


def _decode_bound(q, k, lens, kv):
    """Least time for this call's work: the bytes it must move (each
    input read once, the output written once; only filled cache rows)
    over the HBM rate, against the q.k and p.v flops over the peak rate
    of the inputs' type."""
    from dlrover_tpu_torch.ops.kv_quant import bytes_per_head_row

    b, h, d = q.shape
    _, max_len, kh, _ = k.shape
    rows = int(torch.clamp(lens, 0, max_len).sum())
    row_bytes = kh * bytes_per_head_row(d, kv, fp_itemsize=k.element_size())
    moved = 2 * rows * row_bytes + 2 * q.numel() * q.element_size() \
        + lens.numel() * 4
    flops = 4 * rows * (h // kh) * kh * d
    rate = PEAK_OPS_PER_S["int8" if kv == "int8" else "bfloat16"]
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", moved)


def _sdpa_call(q, k, v, lens):
    """One library call computing the fp kernel's function (rows of
    fill 0 give NaN there; it is only timed)."""
    import torch.nn.functional as F

    b, h, d = q.shape
    _, max_len, kh, _ = k.shape
    qs = q[:, :, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(max_len, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        qs, kt, vt, attn_mask=mask, enable_gqa=h != kh
    )


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
            ms = _time_ms(lambda: da.decode_attention(q, k, v, lens,
                                                      *scales))
            plain_ms = _time_ms(lambda: da.decode_attention_reference(
                q, k, v, lens, *scales))
            library_ms = (
                _time_ms(_sdpa_call(q, k, v, lens)) if kv == "fp" else None
            )
            bound_ms, bound_by, moved = _decode_bound(q, k, lens, kv)
            row = {
                "phase": "kernel", "shape": label, "kv": kv,
                "b": b, "h": h, "kh": kh, "d": d, "max_len": max_len,
                "lengths": [int(x) for x in lengths],
                "max_abs_err": float(err.max()), "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": moved, "bound_share": bound_ms / ms,
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
    checks that the same bound rejects it."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(SEED + 3)
    shapes = [  # label, b, s, h, kh, d, causal
        ("train", TRAIN_MICRO, TRAIN_SEQ, 8, 8, 128, True),
        ("gqa", 2, 2048, 32, 8, 128, True),
        ("full", 2, 2048, 8, 8, 128, False),
        ("ragged_1000", 2, 1000, 8, 8, 128, True),
    ]
    rows = {}
    for label, b, s, h, kh, d, causal in shapes:
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, s, kh, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, s, kh, d, generator=gen, device="cuda").bfloat16()
        do = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
        out, lse = fa.flash_forward(q, k, v, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal)
        out_err = (out.float() - ref_out.float()).abs()
        lse_err = float((lse - ref_lse).abs().max())
        check(lse_err <= 1e-3, f"flash_forward/{label}: lse err {lse_err}")
        delta = fa.flash_backward_delta(do, ref_out)
        dq = fa.flash_backward_dq(q, k, v, do, ref_lse, delta, causal)
        dk, dv = fa.flash_backward_dkv(q, k, v, do, ref_lse, delta, causal)
        torch.cuda.synchronize()
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
            if name == "flash_forward":
                row["lse_max_abs_err"] = lse_err
            emit(row)
            rows[(name, label)] = row
        del kernel_calls
        torch.cuda.empty_cache()
    return rows


# ---- main path -----------------------------------------------------------


def _argmax_gap(cfg, params, seqs, start, kv, label):
    """Teacher-forced check: for each token a row produced from
    position ``start`` on, the gap between the max logit of the port's
    forward at the previous position and the chosen token's logit."""
    from dlrover_tpu_torch.models import llama

    with torch.inference_mode():
        logits, _ = llama.forward(cfg, params, seqs)
    pred = logits[:, start - 1:-1]
    chosen = seqs[:, start:].long()
    gap = pred.max(dim=-1).values - pred.gather(-1, chosen[..., None])[..., 0]
    worst = float(gap.max())
    agree = float((pred.argmax(dim=-1) == chosen).float().mean())
    check(worst <= ARGMAX_GAP[kv],
          f"{label}: token {worst} logits below the teacher-forced max")
    return worst, agree


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


def phase_engine(cfg, params):
    from dlrover_tpu_torch.observability.registry import MetricsRegistry
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
    for r, n in zip(reqs, news):
        check(r.state == "done" and not r.failed and not r.truncated,
              f"engine: request {r.rid} ended {r.state} "
              f"failed={r.failed} truncated={r.truncated}")
        check(len(r.tokens) == n,
              f"engine: request {r.rid} got {len(r.tokens)} of {n}")
        check(r.requeues == 0, f"engine: request {r.rid} was requeued")
    errors = reg.get("serving_step_errors_total").value()
    check(errors == 0, f"engine: {errors} step errors")
    worst = 0.0
    agree = []
    for r, p in zip(reqs, prompts):
        seq = torch.from_numpy(
            np.concatenate([p, np.asarray(r.tokens, np.int32)])
        ).cuda()[None]
        w, a = _argmax_gap(cfg, params, seq, len(p), "fp",
                           f"engine/request {r.rid}")
        worst = max(worst, w)
        agree.append(a)
    ttfts = sorted(r.ttft_s for r in reqs)
    gen_tokens = sum(len(r.tokens) for r in reqs)
    row = {
        "phase": "engine", "requests": len(reqs), "slots": 8,
        "max_len": 1024, "prefill_chunk": 64,
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "new_tokens": gen_tokens, "wall_s": wall,
        "decode_tok_s": gen_tokens / wall,
        "total_tok_s": (gen_tokens + sum(len(p) for p in prompts)) / wall,
        "ttft_p50_s": float(np.median(ttfts)),
        "ttft_max_s": ttfts[-1],
        "iterations": reg.get("serving_iterations_total").value(),
        "step_errors": errors, "argmax_gap_max": worst,
        "argmax_agree": float(np.mean(agree)),
    }
    emit(row)
    return row


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
    tc1 = ts.TrainConfig(warmup_steps=2, grad_accum=1)

    def keys_cut(cut):
        def attention_fn(q, k, v, causal=True, **_):
            return fa.flash_attention(q, k[:, :cut], v[:, :cut], causal)
        return lambda p, b: llama.loss_fn(cfg, p, b,
                                          attention_fn=attention_fn)

    variants = {
        "plain": lambda p, b: llama.loss_fn(
            cfg, p, b, attention_fn=dot_product_attention),
        "kernel": None,
        "fault_last_tile": keys_cut(64 * ((TRAIN_SEQ - 1) // 64)),
        "fault_half": keys_cut(TRAIN_SEQ // 2),
    }
    one, plain_moments = {}, None
    for label, loss_fn in variants.items():
        opt, state = _train_state(cfg, tc1)
        step = ts.make_train_step(cfg, tc1, opt, device="cuda",
                                  loss_fn=loss_fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        state, m = step(state, {"tokens": tokens[:TRAIN_MICRO]})
        # Peak memory of the step alone: the plain step's moments, kept
        # for the comparison, are not counted.
        held = sum(t.numel() * 4 for t in plain_moments or ())
        row = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "step_s": time.monotonic() - t0,
               "peak_bytes": torch.cuda.max_memory_allocated() - held}
        moments = [state["opt_state"].state[p]["exp_avg"]
                   for p in ts.param_leaves(state["params"])]
        if plain_moments is None:
            plain_moments = moments
        else:
            ref = one["plain"]
            row["loss_rel"] = abs(row["loss"] - ref["loss"]) / ref["loss"]
            row["grad_norm_rel"] = abs(
                row["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
            dist = [float((a - b).norm() / b.norm())
                    for a, b in zip(moments, plain_moments)]
            row["grads_rel_l2"] = dict(zip(_leaf_names(state["params"]),
                                           dist))
            row["grads"] = max(dist)
        one[label] = row
        del opt, state, step, m, moments
        torch.cuda.empty_cache()
    del plain_moments
    emit({"phase": "train_vs_plain", "micro_batch": TRAIN_MICRO,
          "seq": TRAIN_SEQ, "gates": TRAIN_GATES, **one})
    gate_keys = {"loss": "loss_rel", "grad_norm": "grad_norm_rel",
                 "grads": "grads"}
    for gate, key in gate_keys.items():
        check(one["kernel"][key] <= TRAIN_GATES[gate],
              f"train: kernel vs plain {key} {one['kernel'][key]} > "
              f"{TRAIN_GATES[gate]}")
    for gate, key in (("grads", "grads"), ("grad_norm", "grad_norm_rel")):
        check(one["fault_half"][key] > TRAIN_GATES[gate],
              f"train: the {gate} gate passes a planted fault "
              f"({one['fault_half'][key]})")

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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import decode_attention as da

    # fp32 matmuls run in full fp32 (no TF32) for the plain versions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device()
    phase_build()
    kernel_rows = phase_kernels()
    flash_rows = phase_flash_kernels()

    cfg = flagship_config()
    params = llama.init_params(
        cfg, torch.Generator("cuda").manual_seed(SEED), device="cuda"
    )
    da.reset_launch_counts()
    gen_rows = phase_generate(cfg, params)
    gen_launches = dict(da.launch_counts)
    da.reset_launch_counts()
    eng_row = phase_engine(cfg, params)
    eng_launches = dict(da.launch_counts)
    launches = {
        name: gen_launches[name] + eng_launches[name]
        for name in da.launch_counts
    }
    emit({"phase": "launches", "generate": gen_launches,
          "engine": eng_launches,
          "per_decoded_token_generate": cfg.n_layers})
    # generate(): one launch per layer per single-token step, in two
    # full runs and one profiled run of 32 tokens.
    for kv in ("fp", "int8"):
        want = cfg.n_layers * (2 * (gen_rows[kv]["new_tokens"] - 1) + 31)
        got = gen_launches[f"decode_attention_{kv}"]
        check(got == want, f"generate/{kv}: {got} launches, want {want}")
    check(eng_launches["decode_attention_fp"] >= cfg.n_layers,
          "engine: the decode kernel never launched")

    del params
    torch.cuda.empty_cache()
    launches.update(phase_train(cfg))
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")

    replaces = {
        "decode_attention_fp": "dlrover_tpu/ops/decode_attention.py:234",
        "decode_attention_int8": "dlrover_tpu/ops/decode_attention.py:244",
        "flash_forward": "dlrover_tpu/ops/pallas_attention.py:53",
        "flash_backward_dq": "dlrover_tpu/ops/pallas_attention.py:242",
        "flash_backward_dkv": "dlrover_tpu/ops/pallas_attention.py:301",
    }
    sources = {
        "decode_attention": "dlrover_tpu_torch/ops/csrc/decode_attention.cu",
        "flash": "dlrover_tpu_torch/ops/csrc/flash_attention.cu",
    }
    rows = [(name, kernel_rows[("main_path", kv)], sources["decode_attention"])
            for name, kv in (("decode_attention_fp", "fp"),
                             ("decode_attention_int8", "int8"))]
    rows += [(name, flash_rows[(name, "train")], sources["flash"])
             for name in ("flash_forward", "flash_backward_dq",
                          "flash_backward_dkv")]
    kernels = []
    for name, row, source in rows:
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
