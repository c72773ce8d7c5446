"""Smoke run of the PyTorch port on one NVIDIA GPU (sm_90a: H100).

    python3 chip_smoke.py

Drives ``dlrover_tpu_torch`` (and nothing of the JAX package) through
its serving path at the full width and depth of the flagship TpuLM
(vocab 32000, embed 1024, 16 layers, 8 heads of 128, mlp 4096, bf16
compute; random weights from a seed), in phases that each print one
JSON line:

1. device: the card's name, and its power limit from nvidia-smi;
2. build: the CUDA kernels, compiled from ``dlrover_tpu_torch/ops/csrc``;
3. kernels: every kernel against its plain PyTorch version on the card,
   at the main path's shape and at the flagship and GQA decode shapes,
   with its time (CUDA events, cold L2), its bandwidth bound, the plain
   version's time and a library call's time;
4. generate(): b=8, prompt 128, 256 new tokens, fp and int8 KV caches;
5. ServingEngine: 8 slots, max_len 1024, 16 greedy requests.

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
                        if "registers" in ln or "spill" in ln]
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


def _profile_row(label, wall, device):
    total = sum(ms for _, ms in device.values())
    attn = sum(ms for name, (_, ms) in device.items()
               if "decode_attention_kernel" in name)
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:6]
    return {
        "phase": "profile", "run": label, "wall_ms": wall * 1e3,
        "device_ms": total,
        "device_busy_share": total / (wall * 1e3) if total else None,
        "decode_attention_ms": attn,
        "decode_attention_share_of_device": attn / total if total else None,
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
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")

    replaces = {
        "decode_attention_fp": "dlrover_tpu/ops/decode_attention.py:234",
        "decode_attention_int8": "dlrover_tpu/ops/decode_attention.py:244",
    }
    kernels = []
    for name, kv in (("decode_attention_fp", "fp"),
                     ("decode_attention_int8", "int8")):
        row = kernel_rows[("main_path", kv)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dlrover_tpu_torch/ops/csrc/decode_attention.cu",
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
