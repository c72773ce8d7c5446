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
   memory and a profiled step;
7. fused CE kernels: B3 (forward) and B4 (dx, dw) against their plain
   versions at the CE A/B shape (n=16384, d=1024, V=32000, bf16), a
   ragged one (n=4100, V=32003) and a masked one (30% of the rows with
   weight 0), elementwise, each with a planted fault the same bounds must
   reject; times, bounds and the dense route's time;
8. CE A/B (the JAX package's ``bench.py`` ``ce_ab_phase``): loss, dx and
   dw at n=16384, d=1024, V=32000 through the dense logits, the chunked
   fused CE and the B3/B4 kernels: ms and peak memory of each;
9. train through the fused CE: one grad_accum=1 flagship step each
   through the dense CE, the chunked fused CE (``DLROVER_TPU_FUSED_CE=on``)
   and a ``loss_fn`` that reaches B3/B4, held against the dense step
   with a planted fault the gates must reject; then 3 steps through
   B3/B4 with falling loss, exact launch counts and a bitwise rerun.

Phases 4 and 5 check the tokens against the argmax of the port's own
teacher-forced forward over prompt + output, check that repeated runs
agree, and read the kernels' launch counters to show the decode path
went through them. Any failure raises (exit code 1) before the last
line, which is ``{"ok": true, "device": {...}}``.
"""

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
    elementwise (see _ce_ratio). Each shape also plants a fault and
    checks that the same bounds reject it: B3 and dx without their last
    vocab tile (128 and 64 columns), dw without its last 64-row tile;
    row 0's target sits in the last vocab column."""
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
        f_pt, f_logz = fc._xla_forward(x, w[:, :128 * ((v - 1) // 128)],
                                       tgt, CE_Z)
        f_dx, _ = fc._xla_backward(x, w[:, :64 * ((v - 1) // 64)], tgt,
                                   ref_logz, a, b, want_dw=False)
        cut = 64 * ((n - 1) // 64)
        _, f_dw = fc._xla_backward(x[:cut], w, tgt[:cut], ref_logz[:cut],
                                   a[:cut], b[:cut], want_dx=False)
        fault = {"per_tok": _stat_ratio(f_pt, ref_pt),
                 "logz": _stat_ratio(f_logz, ref_logz),
                 "dx": _ce_ratio(f_dx.bfloat16(), ref_dx, -1),
                 "dw": _ce_ratio(f_dw, ref_dw, 0)}
        del f_pt, f_logz, f_dx, f_dw, ref_dx, ref_dw
        emit({"phase": "ce_bounds", "shape": label, "ratio": ratio,
              "planted_fault_ratio": fault})
        for out in ratio:
            check(ratio[out] <= 1.0,
                  f"fused_ce/{label}: {out} at {ratio[out]} of its bound")
        # Each kernel's fault must fail its outputs' bounds (B3's last
        # tile may hold only a few columns: row 0's per_tok loses its
        # target logit, while logz moves by their small share).
        for kernel, outs in (("B3", ("per_tok", "logz")), ("dx", ("dx",)),
                             ("dw", ("dw",))):
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
    ce_rows = phase_ce_kernels()
    phase_ce_ab()
    launches.update(phase_train_ce(cfg))
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")

    replaces = {
        "decode_attention_fp": "dlrover_tpu/ops/decode_attention.py:234",
        "decode_attention_int8": "dlrover_tpu/ops/decode_attention.py:244",
        "flash_forward": "dlrover_tpu/ops/pallas_attention.py:53",
        "flash_backward_dq": "dlrover_tpu/ops/pallas_attention.py:242",
        "flash_backward_dkv": "dlrover_tpu/ops/pallas_attention.py:301",
        "fused_ce_forward": "dlrover_tpu/ops/fused_ce.py:310",
        "fused_ce_backward_dx": "dlrover_tpu/ops/fused_ce.py:357",
        "fused_ce_backward_dw": "dlrover_tpu/ops/fused_ce.py:395",
    }
    sources = {
        "decode_attention": "dlrover_tpu_torch/ops/csrc/decode_attention.cu",
        "flash": "dlrover_tpu_torch/ops/csrc/flash_attention.cu",
        "fused_ce": "dlrover_tpu_torch/ops/csrc/fused_ce.cu",
    }
    rows = [(name, kernel_rows[("main_path", kv)], sources["decode_attention"])
            for name, kv in (("decode_attention_fp", "fp"),
                             ("decode_attention_int8", "int8"))]
    rows += [(name, flash_rows[(name, "train")], sources["flash"])
             for name in ("flash_forward", "flash_backward_dq",
                          "flash_backward_dkv")]
    rows += [(name, ce_rows[(name, "ce_ab")], sources["fused_ce"])
             for name in ("fused_ce_forward", "fused_ce_backward_dx",
                          "fused_ce_backward_dw")]
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
