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
11c. migrate: phase 11's 32 requests through two paged engines at its
    settings, fp and int8: each request exported from the first right
    after prefill (a quarter after 3 decode steps), imported into the
    second, released by the first. Every request complete, tokens within
    ARGMAX_GAP (the share equal to phase 11's unmigrated tokens
    reported), block conservation on both, the card's wire equal byte
    for byte to ``kv_to_wire`` on the CPU of the same rows, exact B6
    launches and export/import counts; export and import ms and wire MB
    a request. Then int8 one request at a time: the migrated tokens
    equal the unmigrated ones;
11d. fleet_disagg: ``FleetRouter`` over two ``ThreadReplica``s (paged,
    phase 11's fp settings), one prefill and one decode replica, over
    the reference's bimodal schedule (32 requests, Poisson arrivals 0.125
    s apart, 35% of prompts 64-96 tokens, the rest 8-16, 32-64 new
    tokens), tracing armed; then two mixed replicas. Every request
    exactly once, migrations plus fallbacks equal the requests, each
    request's spans tile its time to 1 ms, block conservation, the gap,
    exact B6 launches; TTFT, inter-token latency, tokens/s, migration
    pause;
11e. fleet_subprocess: three ``SubprocessReplica`` workers on this card
    (flagship, paged; one prefill, two decode), migrations over the JSONL
    pipe; a fault schedule SIGKILLs decode replica d1 at its first
    import. Every request exactly once, d1's the only death, block
    conservation on every heartbeat; each child's start seconds;
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
    and a profiled step;
16. elastic_ckpt: the port's elastic worker
    (``dlrover_tpu_torch.examples.train_llama``) on the flagship cut to
    8 layers at phase 6's shape (8 x 2048, ga 2), seed 0, under an agent
    this script plays (it hosts the ``AsyncCheckpointSaver`` and sets
    each worker's env). Run A trains 10 steps; run B saves to shm after
    every step and persists every 3, is SIGKILLed once step 5 is in shm
    (restored from memory), then once step 8 is in shm and step 6
    committed, with its segment unlinked (a lost host; restored from
    storage), and replays to 10. Gates: run B's replayed losses and
    final params, moments and step equal run A's bit for bit (a flipped
    moment element is rejected), the restores are the ones stated, each
    worker's B1/B2 launches are exact, no segment or socket is left.
    Image GB, save block and drain ms, snapshots dropped, persist and
    restore seconds and GB/s, worker start seconds, SIGKILL to first
    replayed step, steps redone and goodput (A's wall over B's);
17. mesh_train: the sharded train step (``make_train_step(...,
    mesh=build_mesh(MeshConfig()))``, the state as DTensors) on a world
    of one over nccl at phase 6's shape, 1 + 3 steps, against the
    mesh-less step from the same seed: losses, grad norms and final
    params bitwise equal, exact B1/B2 launches (the CE stays dense);
    step time and peak memory of both;
18. reshard_restore: the card saves that train state (params and both
    Adam moments) to storage; a 4-process gloo CPU world at dp=2, tp=2
    restores it (each rank reads only its regions, and each shard's
    bytes equal their slice of the card's file), saves its own shards
    (a proc file a rank), and the card restores those into whole leaves,
    bitwise equal to what it saved; a shard moved by one row in one
    rank's meta is refused. Bytes read per rank, restore seconds;
19. node_check: the port's ``agent/node_check_worker`` on the card as
    the reference agent runs it (matmul 1024, 30 rounds, a 64 MB
    all_reduce over a world of one): it writes its result file; under
    ``DLROVER_TPU_CHAOS_CHECK_FAIL_RANKS=0`` it writes none and exits
    non-zero;
20. long_context: the flagship at batch 1 and 32768, then 65536 tokens,
    remat ``attn_save``: a step through the lite attention block against
    one through the escape (TRAIN_GATES at 32768), the peak memory the
    lite block's forward and backward add below the escape's at both
    lengths, exactly 16 B1 and 16 of each B2 launch a step; step s,
    tokens/s, model-FLOP share;
21. pipeline_train: the flagship at pp_stages 4, 4 micro-batches, all
    stages on the card, 8 x 2048: a step against the flat step
    (TRAIN_GATES), exactly 64 B1 and 64 of each B2 launch a step; step s
    and peak memory of both;
22. ring_hops: ring attention's hop loops at sp = 4 through the
    one-process runner (every rank's 8192-token chunk of 32768 on the
    card), causal and not: out, lse, dq/dk/dv within the flash gate of
    the plain version and of B1/B2 on the whole sequence (B1/B2 also
    held against the plain version at 32768 and 65536 tokens); exact hop
    launches (causal 10, 6 hops skipped; non-causal 16); a hop fed a
    wrong lse is rejected;
23. moe_ep_body: the ep expert body for one rank of ep = 4 at
    ``moe_config``'s widths, its received rows padded to ``cap_rows``
    with sentinel rows: B7 and B8 forward and backward within B7/B8's
    gate of their plain versions, bitwise on a rerun, one launch each.

Phases 4, 5, 11, 11a-d check the tokens against the argmax of the
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


# Host seconds each phase of main() took, printed before the last lines.
PHASE_SECONDS = {}


def timed(name, fn, *args, **kwargs):
    t0 = time.monotonic()
    out = fn(*args, **kwargs)
    PHASE_SECONDS[name] = time.monotonic() - t0
    return out


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


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
    runs must have made, by kernel, and the tokens of the fp (513
    blocks) and int8 runs."""
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
    _, int8_tokens, n = _run_paged(cfg, params, work, "int8", "int8", 16,
                                   int8_blocks)
    want["int8"] += n
    want["fp"] += _profile_paged(cfg, params, work, "fp", fp_blocks)
    want["int8"] += _profile_paged(cfg, params, work, "int8", int8_blocks)
    return ({f"paged_decode_attention_{kv}": n for kv, n in want.items()},
            {"fp": tokens, "int8": int8_tokens})


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


# ---- migration and the serving fleet ------------------------------------


FP_BLOCKS, INT8_BLOCKS = 513, 993   # phase 11's pools (equal bytes)
MIGRATE_LATE_STEPS = 3              # a quarter exported after 3 decode steps


def _migrate_wire_check(eng, req, payload):
    """The KV wire the card made for ``req`` (quantized on the card for
    an fp pool) against ``kv_to_wire`` on the CPU of the same rows
    copied to the host: byte for byte."""
    import struct

    from dlrover_tpu_torch.ops.kv_quant import kv_to_wire

    (hlen,) = struct.unpack_from("<I", payload, 4)
    ids = torch.tensor(eng._slot_blocks[req.slot], device="cuda")
    rows = [pool.index_select(1, ids).cpu()
            for pool in (eng._k, eng._v, eng._kscale, eng._vscale)
            if pool is not None]
    return kv_to_wire(*rows) == payload[8 + hlen:]


def _migrate_run(cfg, params, work, kv, unmigrated):
    """Phase 11's 32 requests through two paged engines: each request is
    exported from the first right after its prefill (a quarter after
    MIGRATE_LATE_STEPS decode steps, the live-drain case), imported into
    the second, and released by the first. Returns the row and the B6
    launches of the run."""
    from dlrover_tpu_torch.ops import decode_attention as da
    from dlrover_tpu_torch.serving import kvpool

    blocks = FP_BLOCKS if kv == "fp" else INT8_BLOCKS
    da.reset_launch_counts()
    src, src_reg = _paged_engine(cfg, params, kv, 16, blocks)
    dst, dst_reg = _paged_engine(cfg, params, kv, 16, blocks)
    reqs = [src.submit(p, n) for p, n, _ in work]
    late = {r.rid for i, r in enumerate(reqs) if i % 4 == 3}
    moved, export_ms, import_ms, wire_mb, wire_same = {}, [], [], [], []
    t0 = time.monotonic()
    blocked = False
    while src.pending() or dst.pending():
        # While a ready request waits for room on the destination, the
        # source stands still (it would decode the request itself).
        if src.pending() and not blocked:
            src.step()
        blocked = False
        for r in list(src.scheduler.active()):
            if r.state != "decode" or len(r.tokens) < (
                    1 + MIGRATE_LATE_STEPS if r.rid in late else 1):
                continue
            if not kvpool.can_import(
                    dst, len(src._slot_blocks[r.slot])):
                blocked = True
                continue
            torch.cuda.synchronize()
            t_e = time.monotonic()
            payload = kvpool.export_request(src, r)
            t_i = time.monotonic()
            moved[r.rid] = kvpool.import_request(dst, payload)
            torch.cuda.synchronize()
            t_d = time.monotonic()
            export_ms.append(1e3 * (t_i - t_e))
            import_ms.append(1e3 * (t_d - t_i))
            wire_mb.append(len(payload) / 1e6)
            wire_same.append(_migrate_wire_check(src, r, payload))
            kvpool.release_exported(src, r)
        if dst.pending():
            dst.step()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = da.launch_counts[f"paged_decode_attention_{kv}"]
    want = cfg.n_layers * (src.call_counts["decode"]
                           + dst.call_counts["decode"])
    check(launches == want, f"migrate/{kv}: {launches} B6 launches, "
                            f"want {want}")
    check(da.launch_counts["decode_attention_fp"]
          + da.launch_counts["decode_attention_int8"] == 0,
          f"migrate/{kv}: the flat kernel launched")
    check(len(moved) == len(reqs),
          f"migrate/{kv}: {len(moved)} of {len(reqs)} requests moved")
    check(src.call_counts["export"] == len(reqs)
          and dst.call_counts["export"] == 0
          and dst.call_counts["import"] == len(reqs)
          and src.call_counts["import"] == 0,
          f"migrate/{kv}: call counts src {src.call_counts} dst "
          f"{dst.call_counts}")
    check(all(wire_same), f"migrate/{kv}: the card's wire differs from "
                          f"kv_to_wire on the CPU: {wire_same}")
    out, worst, agree, same = [], 0.0, [], []
    for r, (p, n, _) in zip(reqs, work):
        m = moved[r.rid]
        check(m.state == "done" and not m.failed and not m.truncated
              and len(m.tokens) == n,
              f"migrate/{kv}: request {r.rid} ended {m.state} with "
              f"{len(m.tokens)} of {n} tokens")
        seq = torch.from_numpy(
            np.concatenate([p, np.asarray(m.tokens, np.int32)])).cuda()[None]
        w, a = _argmax_gap(cfg, params, seq, len(p), kv,
                           f"migrate/{kv}/request {r.rid}")
        worst = max(worst, w)
        agree.append(a)
        out.append(m.tokens)
    for eng, reg, name in ((src, src_reg, "source"),
                           (dst, dst_reg, "destination")):
        eng.check_block_invariants()
        check(eng.kv_stats()["used"] == 0,
              f"migrate/{kv}: blocks in use on the {name}: "
              f"{eng.kv_stats()}")
        check(reg.get("serving_step_errors_total").value() == 0,
              f"migrate/{kv}: step errors on the {name}")
    same = [a == b for a, b in zip(out, unmigrated)]
    row = {
        "phase": "migrate", "kv": kv, "requests": len(reqs),
        "late_exports": len(late), "late_after_decode_steps":
        MIGRATE_LATE_STEPS, "num_blocks": blocks, "wall_s": wall,
        "export_ms_mean": float(np.mean(export_ms)),
        "export_ms_p50": float(np.median(export_ms)),
        "export_ms_max": max(export_ms),
        "import_ms_mean": float(np.mean(import_ms)),
        "import_ms_p50": float(np.median(import_ms)),
        "import_ms_max": max(import_ms),
        "wire_mb_mean": float(np.mean(wire_mb)),
        "wire_mb_max": max(wire_mb),
        "wire_equal_cpu": sum(wire_same),
        "argmax_gap_max": worst, "argmax_agree": float(np.mean(agree)),
        "share_equal_unmigrated": float(np.mean(same)),
        "b6_launches": launches, "call_counts": {
            "source": dict(src.call_counts),
            "destination": dict(dst.call_counts)},
    }
    emit(row)
    del src, dst
    torch.cuda.empty_cache()
    return row, launches


def _migrate_one_at_a_time(cfg, params, work):
    """The int8 pool, one request at a time, so the migrated and the
    unmigrated run decode in the same batch composition: the tokens must
    be equal (the int8 rows cross bit for bit). Returns (requests, B6
    launches)."""
    from dlrover_tpu_torch.ops import decode_attention as da
    from dlrover_tpu_torch.serving import kvpool

    da.reset_launch_counts()
    ref_eng, src, dst = (_paged_engine(cfg, params, "int8", 16,
                                       INT8_BLOCKS)[0] for _ in range(3))
    picked = work[:4]
    for i, (p, n, _) in enumerate(picked):
        n = min(n, 48)
        ref = ref_eng.submit(p, n)
        ref_eng.run_until_idle()
        r = src.submit(p, n)
        steps = MIGRATE_LATE_STEPS if i % 2 else 0
        while r.state != "decode" or len(r.tokens) < 1 + steps:
            src.step()
        m = kvpool.import_request(dst, kvpool.export_request(src, r))
        kvpool.release_exported(src, r)
        dst.run_until_idle()
        check(m.tokens == ref.tokens,
              f"migrate/int8 one at a time: request {i} (exported after "
              f"{len(r.tokens)} tokens) differs from its unmigrated run")
    want = cfg.n_layers * sum(e.call_counts["decode"]
                              for e in (ref_eng, src, dst))
    got = da.launch_counts["paged_decode_attention_int8"]
    check(got == want, f"migrate/int8 one at a time: {got} B6 launches, "
                       f"want {want}")
    emit({"phase": "migrate", "kv": "int8", "run": "one_at_a_time",
          "requests": len(picked), "tokens_equal_unmigrated": True,
          "b6_launches": got})
    del ref_eng, src, dst
    torch.cuda.empty_cache()
    return got


def phase_migrate(cfg, params, unmigrated):
    """Block migration between two paged engines at phase 11's settings
    (16 slots, block 16, 513 fp blocks, 993 int8 at equal bytes) over
    phase 11's 32 requests (see ``_migrate_run``), then the int8
    one-at-a-time equality. ``unmigrated`` {kv: tokens} are phase 11's
    runs of the same requests. Returns the B6 launches by kernel."""
    work = _paged_workload(cfg)
    out = {"paged_decode_attention_fp": 0, "paged_decode_attention_int8": 0}
    for kv in ("fp", "int8"):
        _, n = _migrate_run(cfg, params, work, kv, unmigrated[kv])
        out[f"paged_decode_attention_{kv}"] += n
    out["paged_decode_attention_int8"] += _migrate_one_at_a_time(
        cfg, params, work)
    return out


def fleet_workload(n_requests=32, seed=SEED, vocab=32000):
    """The reference's bimodal disaggregation schedule
    (``tools/bench_disagg.py`` ``make_workload``): Poisson arrivals with
    a mean gap of 0.125 s; 35% of prompts 64-96 tokens, the rest 8-16;
    32-64 new tokens each. [(arrival_s, prompt, max_new)]."""
    rs = np.random.RandomState(seed)
    arrivals = np.cumsum(rs.exponential(scale=0.125, size=n_requests))
    work = []
    for i in range(n_requests):
        plen = int(rs.randint(64, 97)) if rs.rand() < 0.35 else int(
            rs.randint(8, 17))
        prompt = rs.randint(1, min(100, vocab), size=plen).tolist()
        work.append((float(arrivals[i]), prompt, int(rs.randint(32, 65))))
    return work


def _drive_fleet(router, work, timeout_s=300.0):
    """Submit ``work`` on its arrival schedule and pump the router until
    every request is terminal. Returns (fleet requests, wall seconds)."""
    submitted, pending = [], list(work)
    t0 = time.monotonic()
    while pending or router.pending():
        check(time.monotonic() - t0 < timeout_s,
              f"fleet did not drain in {timeout_s} s")
        now = time.monotonic() - t0
        while pending and pending[0][0] <= now:
            _, prompt, max_new = pending.pop(0)
            submitted.append(router.submit(prompt, max_new))
        if not router.step():
            time.sleep(0.001)
    return submitted, time.monotonic() - t0


def _fleet_row(label, router, submitted, wall):
    """TTFT, inter-token latency (decode seconds per generated token of
    a request, as the reference's bench), tokens/s and the migration
    pause of one fleet run."""
    done = [r.result for r in submitted]
    ttfts = [r.ttft_s for r in done]
    itls = [(r.latency_s - r.ttft_s) / (len(r.tokens) - 1) for r in done]
    m = router.metrics
    pause_n, pause_sum = m.migration_pause._hist[()][-2:]
    fails = {k[0]: v for k, v in m.migration_failures._children.items()}
    return {
        "run": label, "requests": len(done), "wall_s": wall,
        "new_tokens": sum(len(r.tokens) for r in done),
        "tokens_per_s": sum(len(r.tokens) for r in done) / wall,
        "ttft_p50_s": float(np.percentile(ttfts, 50)),
        "ttft_p99_s": float(np.percentile(ttfts, 99)),
        "itl_p50_s": float(np.percentile(itls, 50)),
        "itl_p99_s": float(np.percentile(itls, 99)),
        "migrations": int(m.migrations.value()),
        "migration_failures": fails,
        "migration_pause_mean_s": pause_sum / pause_n if pause_n else None,
        "retries": int(m.retries.value()),
        "duplicates": int(m.duplicates.value()),
        "reroutes": int(m.reroutes.value()),
        "restarts": int(m.restarts.value()),
    }


def _check_exactly_once(label, submitted):
    ids = [r.request_id for r in submitted]
    check(len(set(ids)) == len(ids), f"{label}: duplicate request ids")
    for r in submitted:
        check(r.result is not None and r.result.ok,
              f"{label}: {r.request_id} ended {r.result}")
        check(len(r.result.tokens) == r.max_new_tokens,
              f"{label}: {r.request_id} got {len(r.result.tokens)} of "
              f"{r.max_new_tokens} tokens")


def _span_tiling(tracer):
    """Worst gap (s) between a serving.request span and the sum of its
    children (queue wait, prefill, migrate, decode), and the number of
    request trees and migrate spans."""
    spans = tracer.finished()
    kids = {}
    for s in spans:
        kids.setdefault(s["parent_id"], []).append(s)
    roots = [s for s in spans if s["name"] == "serving.request"]
    worst = max(abs(sum(c["dur_s"] for c in kids.get(s["span_id"], []))
                    - s["dur_s"]) for s in roots)
    return worst, len(roots), sum(
        1 for s in spans if s["name"] == "serving.migrate")


def phase_fleet_disagg(cfg, params):
    """``FleetRouter`` over two ``ThreadReplica``s in this process, each
    a paged engine at phase 11's fp settings: one ``prefill`` and one
    ``decode`` replica (two-phase dispatch through migration), then the
    same schedule over two ``mixed`` replicas. Tracing armed. Returns
    the B6 launches."""
    from dlrover_tpu_torch.observability import tracing
    from dlrover_tpu_torch.observability.registry import MetricsRegistry
    from dlrover_tpu_torch.ops import decode_attention as da
    from dlrover_tpu_torch.serving import fleet

    work = fleet_workload(vocab=cfg.vocab_size)
    total = 0
    for label, roles in (("disagg", ("prefill", "decode")),
                         ("mixed", ("mixed", "mixed"))):
        engines = {}

        def factory(name):
            def build():
                eng, reg = _paged_engine(cfg, params, "fp", 16, FP_BLOCKS)
                engines[name] = (eng, reg)
                return eng
            return build

        da.reset_launch_counts()
        replicas = [fleet.ThreadReplica(f"{role[0]}{i}", factory(
            f"{role[0]}{i}"), role=role) for i, role in enumerate(roles)]
        router = fleet.FleetRouter(
            replicas, fleet.RouterConfig(
                health=fleet.HealthPolicy(heartbeat_timeout_s=30.0)),
            registry=MetricsRegistry())
        tracer = tracing.arm(tracing.Tracer(service=f"fleet_{label}"))
        try:
            router.start(timeout_s=300.0)
            submitted, wall = _drive_fleet(router, work)
        finally:
            tracing.disarm()
            router.stop()
        label = f"fleet_{label}"
        _check_exactly_once(label, submitted)
        row = _fleet_row(label, router, submitted, wall)
        fails = sum(row["migration_failures"].values())
        # Nothing stands in a migration's way here: every request
        # migrates on a disaggregated fleet, and a fallback (an export
        # or import that failed on the card) fails the phase.
        want_mig = len(work) if roles[0] == "prefill" else 0
        check(row["migrations"] == want_mig and fails == 0,
              f"{label}: {row['migrations']} migrations and failures "
              f"{row['migration_failures']} for {len(work)} requests")
        check(row["retries"] == 0 and row["reroutes"] == 0
              and row["restarts"] == 0 and row["duplicates"] == 0,
              f"{label}: an attempt failed or a replica died: {row}")
        for name, (eng, reg) in engines.items():
            eng.check_block_invariants()
            check(eng.kv_stats()["used"] == 0,
                  f"{label}/{name}: blocks in use: {eng.kv_stats()}")
            check(reg.get("serving_step_errors_total").value() == 0,
                  f"{label}/{name}: step errors")
        decode_steps = {n: e.call_counts["decode"]
                        for n, (e, _) in engines.items()}
        got = da.launch_counts["paged_decode_attention_fp"]
        want = cfg.n_layers * sum(decode_steps.values())
        check(got == want, f"{label}: {got} B6 launches, want {want} "
                           f"from {decode_steps}")
        total += got
        worst_tile, n_trees, n_mig = _span_tiling(tracer)
        check(n_trees == len(work), f"{label}: {n_trees} request trees")
        check(worst_tile <= 1e-3,
              f"{label}: spans leave {worst_tile} s of a request untiled")
        if roles[0] == "prefill":
            check(n_mig == row["migrations"],
                  f"{label}: {n_mig} migrate spans")
        worst, agree = 0.0, []
        for r in submitted:
            seq = torch.tensor(r.prompt + r.result.tokens,
                               device="cuda")[None]
            w, a = _argmax_gap(cfg, params, seq, len(r.prompt), "fp",
                               f"{label}/{r.request_id}")
            worst = max(worst, w)
            agree.append(a)
        emit({"phase": "fleet_disagg", **row, "roles": list(roles),
              "b6_launches": got, "decode_steps": decode_steps,
              "span_tiling_worst_s": worst_tile,
              "migrate_spans": n_mig, "argmax_gap_max": worst,
              "argmax_agree": float(np.mean(agree))})
        del engines, replicas, router
        torch.cuda.empty_cache()
    return {"paged_decode_attention_fp": total}


def phase_fleet_subprocess(cfg, params):
    """``SubprocessReplica``s on this card (``--config flagship --device
    cuda``, paged at phase 11's fp settings): one ``prefill`` and two
    ``decode`` replicas over the bimodal schedule; migrations cross the
    JSONL pipe as base64. A fault schedule SIGKILLs decode replica d1,
    the first import destination, at its first ``fleet.replica.import``
    (an import received, no ack sent). Every request completes exactly
    once, the planned kill is the only death, and block conservation
    holds on every replica's heartbeats."""
    import tempfile

    from dlrover_tpu_torch.fault import FaultRule, FaultSchedule
    from dlrover_tpu_torch.observability import tracing
    from dlrover_tpu_torch.observability.registry import MetricsRegistry
    from dlrover_tpu_torch.serving import fleet

    work = fleet_workload(vocab=cfg.vocab_size)
    work_dir = tempfile.mkdtemp(prefix="fleet_subprocess_")
    sched = os.path.join(work_dir, "kill_d1.json")
    with open(sched, "w") as f:
        f.write(FaultSchedule([FaultRule(
            "fleet.replica.import", action="crash", nth=1)],
            label="kill_during_migration").to_json())
    replicas = [
        fleet.SubprocessReplica(
            name, work_dir, slots=16, max_len=PAGED_KW["max_len"],
            prefill_chunk=PAGED_KW["prefill_chunk"], heartbeat_s=0.2,
            paged=True, block_size=PAGED_KW["block_size"],
            num_blocks=FP_BLOCKS, role=role,
            schedule_path=[sched] if name == "d1" else "",
            device="cuda", config="flagship")
        for name, role in (("p0", "prefill"), ("d1", "decode"),
                           ("d2", "decode"))]
    router = fleet.FleetRouter(
        replicas, fleet.RouterConfig(
            auto_restart=False,
            health=fleet.HealthPolicy(heartbeat_timeout_s=30.0)),
        registry=MetricsRegistry())
    t0 = time.monotonic()
    start_s = {}
    try:
        for r in replicas:
            r.start()
        while len(start_s) < len(replicas):
            check(time.monotonic() - t0 < 300, "replicas did not start")
            for r in replicas:
                if r.replica_id not in start_s and r.wait_ready(0.05):
                    start_s[r.replica_id] = time.monotonic() - t0
                check(r.alive(), f"replica {r.replica_id} died booting")
        # Armed after the children started, so only this process
        # traces: the router's fleet.migrate spans name each
        # migration's destination and how it ended.
        tracer = tracing.arm(tracing.Tracer(service="fleet_subprocess"))
        router.start(timeout_s=1.0)
        submitted, wall = _drive_fleet(router, work)
        alive = {r.replica_id: r.alive() for r in replicas}
    finally:
        tracing.disarm()
        router.stop()
    label = "fleet_subprocess"
    _check_exactly_once(label, submitted)
    row = _fleet_row(label, router, submitted, wall)
    check(alive == {"p0": True, "d1": False, "d2": True},
          f"{label}: replicas alive at the end {alive}")
    with open(os.path.join(work_dir, "trace_replicad1.jsonl")) as f:
        fired = [json.loads(ln) for ln in f if ln.strip()]
    check([(e["point"], e["action"]) for e in fired]
          == [("fleet.replica.import", "crash")],
          f"{label}: faults fired {fired}")
    for r in replicas:
        if r.replica_id != "d1":
            check(not os.path.exists(os.path.join(
                work_dir, f"trace_replica{r.replica_id}.jsonl")),
                f"{label}: a fault fired on {r.replica_id}")
        check(r.kv_violation is None, f"{label}: {r.kv_violation}")
        check(bool(r.last_kv), f"{label}: no kv stats from {r.replica_id}")
    check(row["restarts"] == 0 and row["duplicates"] == 0,
          f"{label}: restarts {row['restarts']}, duplicates "
          f"{row['duplicates']}")
    # Every request migrates, to d2, except those sent to d1: the import
    # that killed it, and those whose send met its closed pipe. d1's
    # stdin reader may already hold the next import when the fault
    # fires, so at most two were in flight. Any other failure (an
    # export or import that raised on the card, a refusal, no
    # destination) fails the phase.
    migs = [s["attrs"] for s in tracer.finished()
            if s["name"] == "fleet.migrate"]
    ok_dst = [a["dst"] for a in migs if "failure_reason" not in a]
    failed = [(a["dst"], a["failure_reason"]) for a in migs
              if "failure_reason" in a]
    failed += [(m.dst, "in_flight") for m in router._migrations.values()]
    in_flight = sum(1 for _, why in failed if why != "import_send")
    check(set(ok_dst) <= {"d2"} and len(ok_dst) == row["migrations"],
          f"{label}: {row['migrations']} migrations, acked by {ok_dst}")
    check(all(dst == "d1" and why in (
        "import_send", "timeout", "abandoned", "in_flight")
        for dst, why in failed), f"{label}: failed migrations {failed}")
    check(set(row["migration_failures"]) <= {"import_send", "timeout"},
          f"{label}: migration failures {row['migration_failures']}")
    check(1 <= in_flight <= 2 and row["migrations"] + len(failed)
          == len(work), f"{label}: {row['migrations']} migrations and "
          f"{failed} failed for {len(work)} requests")
    emit({"phase": "fleet_subprocess", **row,
          "roles": {"p0": "prefill", "d1": "decode", "d2": "decode"},
          "start_s": start_s, "killed": "d1",
          "faults": [(e["point"], e["action"], e["hit"]) for e in fired],
          "failed_migrations": failed,
          "last_kv": {r.replica_id: r.last_kv for r in replicas}})
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


def _kernel_launches():
    """Every kernel wrapper's launch count so far (B1/B2 and B7/B8)."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import moe_dispatch as md

    return {**fa.launch_counts, **md.launch_counts}


def _launches_since(before):
    return {k: v - before.get(k, 0) for k, v in _kernel_launches().items()}


def _one_step_rows(cfg, tokens, variants, timed_steps=0):
    """One grad_accum=1 step per variant, each from the seed's params:
    ``variants`` maps a label to (a ``loss_fn`` for ``make_train_step``
    or None, a context manager factory the step runs under or None[, the
    variant's own config]). Returns {label: row}; every row after the
    first (the reference) carries its relative loss and grad-norm gaps
    and, per leaf, the relative L2 distance of Adam's first moment (0.1 x
    the clipped gradient: the lr is 0 at the first update) to the
    reference's (a stage-layout leaf compared in the flat layout). Each
    row has the first step's B1/B2/B7/B8 launches, the peak memory the
    step added above what was allocated when it began
    (``step_peak_bytes``: activations, gradients and the optimizer's
    moments, without what earlier phases still hold), the peak its
    forward and backward added before the optimizer's update began
    (``fwd_bwd_peak_bytes``: activations and gradients, what the remat
    policy governs; the first update's moments and temporaries, the
    same in every variant, are not in it) and, with ``timed_steps``,
    the seconds of that many further steps."""
    import contextlib
    import gc

    from dlrover_tpu_torch.trainer import train_step as ts

    tc1 = ts.TrainConfig(warmup_steps=2, grad_accum=1)
    one, ref_moments = {}, None
    for label, (loss_fn, patch, *own) in variants.items():
        vcfg = own[0] if own else cfg
        opt, state = _train_state(vcfg, tc1)
        step = ts.make_train_step(vcfg, tc1, opt, device="cuda",
                                  loss_fn=loss_fn)
        # Garbage of earlier phases freed inside the step would be
        # subtracted from its peak: collect it before the start mark.
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start_bytes = torch.cuda.memory_allocated()
        # The allocator's peak when the optimizer's update begins: the
        # forward's and backward's alone.
        update_marks = []
        hook = state["opt_state"].register_step_pre_hook(
            lambda *_: update_marks.append(torch.cuda.max_memory_allocated()))
        before = _kernel_launches()
        t0 = time.monotonic()
        with (patch or contextlib.nullcontext)():
            state, m = step(state, {"tokens": tokens})
        hook.remove()
        # Peak memory of the step alone: the reference's moments, kept
        # for the comparison, are not counted.
        held = sum(t.numel() * 4 for t in ref_moments or ())
        row = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "step_s": time.monotonic() - t0,
               "peak_bytes": torch.cuda.max_memory_allocated() - held,
               "step_peak_bytes": torch.cuda.max_memory_allocated()
               - start_bytes,
               "fwd_bwd_peak_bytes": update_marks[0] - start_bytes,
               "launches": _launches_since(before)}
        moments = [state["opt_state"].state[p]["exp_avg"]
                   for p in ts.param_leaves(state["params"])]
        if timed_steps:
            # Later steps update the moments in place.
            moments = [t.clone() for t in moments]
            row["timed_step_s"] = []
            for _ in range(timed_steps):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                with (patch or contextlib.nullcontext)():
                    state, m = step(state, {"tokens": tokens})
                    float(m["loss"])
                row["timed_step_s"].append(time.monotonic() - t0)
        if ref_moments is None:
            ref, ref_moments = row, moments
        else:
            row["loss_rel"] = abs(row["loss"] - ref["loss"]) / ref["loss"]
            row["grad_norm_rel"] = abs(
                row["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
            dist = [float((a.reshape(b.shape) - b).norm() / b.norm())
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


# ---- elastic training: flash checkpoints, kills, restores -----------------

# The worker's run: steps, persist cadence; run B's first SIGKILL once a
# step >= ELASTIC_KILL1 is in shm, its second (with the segment unlinked:
# a lost host) once step ELASTIC_KILL2 is in shm and the tracker shows
# ELASTIC_STORAGE_STEP. The flagship runs cut to ELASTIC_LAYERS layers
# (cut with the steps from 16 layers and 16 steps, persist every 5 and
# kills after 9 and 13, for the script's time limit).
ELASTIC_STEPS, ELASTIC_PERSIST = 10, 3
ELASTIC_KILL1, ELASTIC_KILL2, ELASTIC_STORAGE_STEP = 5, 8, 6
ELASTIC_LAYERS = 8
ELASTIC_TIMEOUT_S = 300.0


class _Worker:
    """One ``dlrover_tpu_torch.examples.train_llama`` process; a thread
    reads its stdout's JSON lines into ``events``."""

    def __init__(self, args, env, log_path):
        import threading

        self.spawned = time.monotonic()
        self._log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dlrover_tpu_torch.examples.train_llama",
             *args], env=env, stdout=subprocess.PIPE, stderr=self._log,
            text=True)
        self.events = []
        self._cond = threading.Condition()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            if line.startswith("{"):
                event = json.loads(line)
                event["t"] = time.monotonic()
                with self._cond:
                    self.events.append(event)
                    self._cond.notify_all()
        with self._cond:
            self.events.append({"event": "exit", "t": time.monotonic()})
            self._cond.notify_all()

    def wait_event(self, pred, what, timeout=ELASTIC_TIMEOUT_S):
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                for event in self.events:
                    if pred(event):
                        return event
                exited = any(e["event"] == "exit" for e in self.events)
                check(not exited, f"elastic_ckpt: the worker exited (rc "
                      f"{self.proc.poll()}) before {what}; see "
                      f"{self._log.name}")
                left = deadline - time.monotonic()
                check(left > 0, f"elastic_ckpt: no {what} in {timeout} s")
                self._cond.wait(min(left, 1.0))

    def steps(self):
        return [e for e in self.events if e["event"] == "step"]

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)
        self._reader.join(timeout=10)
        self._log.close()


def _elastic_compare(a, b):
    """Keys of the shm payloads' arrays whose bytes differ."""
    def raw(x):
        return x.reshape(-1).view(np.uint8)

    return sorted(k for k in a.keys() & b.keys()
                  if not np.array_equal(raw(a[k]), raw(b[k]))) + sorted(
        a.keys() ^ b.keys())


def phase_elastic_ckpt(device="cuda", config="flagship", micro=TRAIN_MICRO,
                       seq=TRAIN_SEQ):
    """The port's elastic worker (``examples/train_llama``) at
    micro-batch ``micro`` x ``seq``, global batch 2 x micro (ga 2),
    seed 0, under an agent played here: this process hosts the
    ``AsyncCheckpointSaver`` and sets each worker's ``WorkerEnv``. Run A
    trains ELASTIC_STEPS steps. Run B is SIGKILLed once step
    ELASTIC_KILL1 is in shm and relaunched: it must restore that step
    from memory. Once step ELASTIC_KILL2 is in shm and the tracker shows
    ELASTIC_STORAGE_STEP it is SIGKILLed again and its segment unlinked
    (a lost host): the relaunch must restore that step from storage and
    replay to the end. A fault schedule holds each doomed worker at the
    step after its kill step (a ``delay`` at ``agent.worker.crash``) so
    the kill lands there, and this process holds the shm lock over each
    kill, so no write is in flight. Gates: run B's final params,
    moments and step (its last shm image) equal run A's bit for bit,
    and a moment with one element flipped does not; every loss of run B
    equals run A's at its step; each worker launched B1, B2 dq and B2
    dk/dv n_layers x ga times a step it ran (none on the CPU); no
    segment or socket is left."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.common.constants import NodeEnv, WorkerEnv
    from dlrover_tpu_torch.fault import SCHEDULE_ENV, FaultRule, FaultSchedule
    from dlrover_tpu_torch.flash_ckpt import storage as ckpt_storage
    from dlrover_tpu_torch.flash_ckpt.engine import (
        CKPT_LOCK_PREFIX,
        shm_segment_name,
    )
    from dlrover_tpu_torch.flash_ckpt.saver import (
        AsyncCheckpointSaver,
        read_shm_payload,
    )
    from dlrover_tpu_torch.flash_ckpt.shared_obj import SharedLockClient
    from dlrover_tpu_torch.flash_ckpt.shm_handler import SharedMemoryHandler
    from dlrover_tpu_torch.models import llama

    cfg = (llama.flagship_config(n_layers=ELASTIC_LAYERS)
           if config == "flagship" else llama.tiny_config(n_layers=4))
    ga = 2
    free_gib = None
    if device == "cuda":
        torch.cuda.empty_cache()
        free_gib = torch.cuda.mem_get_info()[0] / 2**30
    root = tempfile.mkdtemp(prefix="elastic_ckpt_")
    disk_free_gb = shutil.disk_usage(root).free / 1e9
    repo = os.path.dirname(os.path.abspath(__file__))
    args = ["--steps", str(ELASTIC_STEPS), "--global-batch", str(ga * micro),
            "--micro-batch", str(micro), "--seq", str(seq),
            "--persist-every", str(ELASTIC_PERSIST), "--config", config,
            "--device", device, "--seed", str(SEED),
            "--layers", str(cfg.n_layers)]
    saved_env = {k: os.environ.get(k) for k in (
        NodeEnv.JOB_NAME, NodeEnv.NODE_RANK, NodeEnv.SHARED_DIR)}
    workers, shm_used, kills = [], [], []

    def run(label, plan):
        """One run under a fresh saver. ``plan``: (the step a worker is
        held after, how it is killed) per kill. Returns the run's
        workers, wall seconds, final shm image, the saver's persists,
        seconds from each SIGKILL to the next worker's first step, and
        the segment's bytes."""
        job = f"chipsmoke{os.getpid()}{label}"
        ckpt_dir = os.path.join(root, label, "ckpt")
        sock_dir = os.path.join(root, label, "sock")
        os.makedirs(sock_dir)
        os.environ.update({NodeEnv.JOB_NAME: job, NodeEnv.NODE_RANK: "0",
                           NodeEnv.SHARED_DIR: sock_dir})
        env = dict(os.environ, PYTHONPATH=repo)
        env.update({WorkerEnv.NUM_PROCESSES: "1", WorkerEnv.PROCESS_ID: "0",
                    WorkerEnv.LOCAL_RANK: "0",
                    WorkerEnv.LOCAL_WORLD_SIZE: "1"})
        saver = AsyncCheckpointSaver(local_world_size=1)
        lock = SharedLockClient(f"{CKPT_LOCK_PREFIX}_0")
        segment = SharedMemoryHandler(shm_segment_name(0))
        run_workers, kill_to_step = [], []
        t0 = time.monotonic()

        def spawn(hold_after=None):
            n = len(run_workers)
            env[WorkerEnv.RESTART_COUNT] = str(n)
            env.pop(SCHEDULE_ENV, None)
            if hold_after is not None:
                path = os.path.join(root, f"{label}_hold{n}.json")
                with open(path, "w") as f:
                    f.write(FaultSchedule([FaultRule(
                        "agent.worker.crash", action="delay",
                        delay_s=ELASTIC_TIMEOUT_S,
                        match={"step": hold_after})]).to_json())
                env[SCHEDULE_ENV] = path
            w = _Worker(args + ["--ckpt-dir", ckpt_dir], env,
                        os.path.join(root, f"{label}_worker{n}.log"))
            run_workers.append(w)
            workers.append(w)
            return w

        try:
            w = spawn(plan[0][0] if plan else None)
            for i, (_, kill) in enumerate(plan):
                settle = kill(w, lock, segment, saver, ckpt_dir)
                t_kill = time.monotonic()
                shm_used.append(shutil.disk_usage("/dev/shm").used)
                w = spawn(plan[i + 1][0] if i + 1 < len(plan) else None)
                if settle is not None:
                    settle(w, saver)
                first = w.wait_event(lambda e: e["event"] == "step",
                                     "a replayed step")
                kill_to_step.append(first["t"] - t_kill)
            w.wait_event(lambda e: e["event"] == "done", "the end")
            check(w.proc.wait(timeout=60) == 0, f"{label}: worker rc "
                  f"{w.proc.returncode}")
            wall = time.monotonic() - t0
            shm_used.append(shutil.disk_usage("/dev/shm").used)
            image_bytes = segment.size if segment.attach() else 0
            segment.close()
            final = read_shm_payload(0, lock)
            check(final is not None and final[0] == ELASTIC_STEPS,
                  f"{label}: final shm image {final and final[0]}")
            persists = list(saver.persist_records)
        finally:
            for w in run_workers:
                w.stop()
            saver.stop(timeout=ELASTIC_TIMEOUT_S)
            saver.unlink_all(1)
            socks = os.listdir(sock_dir)
            shutil.rmtree(os.path.join(root, label), ignore_errors=True)
        left = [n for n in os.listdir("/dev/shm") if job in n]
        check(left == [] and socks == [],
              f"{label}: segments {left} and sockets {socks} left")
        return (run_workers, wall, final[1]["arrays"], persists,
                kill_to_step, image_bytes)

    def kill_in_memory(w, lock, segment, saver, ckpt_dir):
        """SIGKILL once step ELASTIC_KILL1 is in shm."""
        w.wait_event(lambda e: e["event"] == "shm"
                     and e["step"] >= ELASTIC_KILL1, "the first kill's step")
        lock.acquire()
        try:
            w.proc.kill()
            w.proc.wait(timeout=60)
            kills.append(segment.get_step())
        finally:
            lock.release()
            segment.close()
        return settle_persist

    def settle_persist(w, saver):
        """The persist of step ELASTIC_PERSIST lands (while the relaunch
        boots) before the relaunch queues its own, so that one reads the
        image it asked for, not a later step's."""
        deadline = time.monotonic() + ELASTIC_TIMEOUT_S
        while saver.last_persisted_step < ELASTIC_PERSIST:
            check(time.monotonic() < deadline, "elastic_ckpt: the persist "
                  f"of step {ELASTIC_PERSIST} did not land")
            time.sleep(0.05)
        check(not any(e["event"] == "step" and e["step"] > ELASTIC_KILL1
                      for e in w.events),
              "elastic_ckpt: the relaunch ran past its restore step "
              f"before the persist of step {ELASTIC_PERSIST} landed")

    def kill_host(w, lock, segment, saver, ckpt_dir):
        """SIGKILL once step ELASTIC_KILL2 is in shm and the tracker
        shows ELASTIC_STORAGE_STEP; unlink the segment."""
        w.wait_event(lambda e: e["event"] == "shm"
                     and e["step"] >= ELASTIC_KILL2, "the second kill's step")
        deadline = time.monotonic() + ELASTIC_TIMEOUT_S
        while ckpt_storage.read_tracker(ckpt_dir) < ELASTIC_STORAGE_STEP:
            check(time.monotonic() < deadline, "elastic_ckpt: step "
                  f"{ELASTIC_STORAGE_STEP} never committed")
            time.sleep(0.05)
        lock.acquire()
        try:
            w.proc.kill()
            w.proc.wait(timeout=60)
        finally:
            lock.release()
        kills.append(ckpt_storage.read_tracker(ckpt_dir))
        segment.unlink()

    try:
        a_workers, wall_a, final_a, persists_a, _, image_bytes = run("A", [])
        b_workers, wall_b, final_b, persists_b, kill_to_step, _ = run(
            "B", [(ELASTIC_KILL1 + 1, kill_in_memory),
                  (ELASTIC_KILL2 + 1, kill_host)])
    finally:
        for w in workers:
            w.stop()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)

    label = "elastic_ckpt"

    def first(w, kind):
        return next((e for e in w.events if e["event"] == kind), None)

    readies = [first(w, "ready") for w in a_workers + b_workers]
    got = [(r["restored_from"], r["restored_step"]) for r in readies]
    check(got == [(None, 0), (None, 0), ("memory", ELASTIC_KILL1),
                  ("storage", ELASTIC_STORAGE_STEP)]
          and kills == [ELASTIC_KILL1, ELASTIC_STORAGE_STEP],
          f"{label}: restores {got}, kills at shm step and tracker {kills}")
    done_a, done_b = first(a_workers[0], "done"), first(b_workers[-1], "done")
    losses_a = {int(k): v for k, v in done_a["losses"].items()}
    replayed = [(e["step"], e["loss"]) for w in b_workers for e in w.steps()]
    differ = [(st, loss, losses_a[st]) for st, loss in replayed
              if loss != losses_a[st]]
    check(not differ, f"{label}: run B's losses differ from run A's at "
                      f"(step, B, A) {differ}")
    differ = _elastic_compare(final_a, final_b)
    check(not differ and done_a["digest"] == done_b["digest"],
          f"{label}: final state differs in {differ[:8]} (digests "
          f"{done_a['digest']}, {done_b['digest']})")
    # The planted fault: one element of the first moment leaf (leaf 0,
    # opt_state.exp_avg's first param in sorted order) flipped.
    planted = dict(final_b)
    planted["leaf0_shard0"] = final_b["leaf0_shard0"].copy()
    planted["leaf0_shard0"].reshape(-1).view(np.uint8)[0] ^= 1
    check(_elastic_compare(final_a, planted) == ["leaf0_shard0"],
          f"{label}: the bitwise gate passes a flipped moment element")
    launches = {}
    for w in a_workers + b_workers:
        n = len(w.steps())
        counts = w.steps()[-1]["launches"] if n else {}
        want = cfg.n_layers * ga * n if device == "cuda" else 0
        check(n > 0 and all(v == want for v in counts.values()),
              f"{label}: a worker ran {n} steps with launches {counts}, "
              f"want {want} each")
        for name, v in counts.items():
            launches[name] = launches.get(name, 0) + v
    gaps = sorted(b["t"] - a["t"] for w in a_workers + b_workers
                  for a, b in zip(w.steps(), w.steps()[1:]))
    compute = sorted(e["compute_s"] for w in a_workers + b_workers
                     for e in w.steps()[1:])
    saves = [e for w in a_workers + b_workers for e in w.events
             if e["event"] == "shm"]
    block = sorted(e["block_s"] * 1e3 for e in saves)
    drain = sorted(e["drain_s"] * 1e3 for e in saves)
    persists = [dict(p, gb_per_s=p["bytes"] / 1e9 / p["seconds"])
                for p in persists_a + persists_b if p["committed"]]
    state_gb = readies[0]["state_bytes"] / 1e9
    steps_b = sum(len(w.steps()) for w in b_workers)
    row = {
        "phase": label, "config": config, "n_layers": cfg.n_layers,
        "micro_batch": micro, "seq": seq, "grad_accum": ga,
        "steps": ELASTIC_STEPS, "persist_every": ELASTIC_PERSIST,
        "state_gb": state_gb, "image_gb": image_bytes / 1e9,
        "free_gib_before": free_gib, "kills": kills,
        "restores": [{k: r[k] for k in ("restored_from", "restored_step",
                                        "restore_s", "start_s")}
                     for r in readies],
        "restore_gb_per_s": {r["restored_from"]: state_gb / r["restore_s"]
                             for r in readies[2:]},
        "spawn_to_ready_s": [r["t"] - w.spawned for r, w in
                             zip(readies, a_workers + b_workers)],
        "kill_to_first_step_s": kill_to_step,
        "step_gap_s": {"p50": gaps[len(gaps) // 2], "max": gaps[-1]},
        "step_compute_s": {"p50": compute[len(compute) // 2],
                           "max": compute[-1]},
        "save_block_ms": {"p50": block[len(block) // 2], "max": block[-1]},
        "save_drain_ms": {"p50": drain[len(drain) // 2], "max": drain[-1]},
        "saves_committed": len(saves),
        "snapshots_dropped": [max([e["dropped"] for e in w.events
                                   if "dropped" in e], default=0)
                              for w in a_workers + b_workers],
        "persists": persists,
        "wall_s": {"A": wall_a, "B": wall_b},
        "steps_run_b": steps_b, "steps_redone": steps_b - ELASTIC_STEPS,
        "goodput": wall_a / wall_b,
        "shm_used_gb_max": max(shm_used) / 1e9,
        "ckpt_disk_free_gb_before": disk_free_gb,
        "df_dev_shm": subprocess.run(
            ["df", "-h", "/dev/shm"], capture_output=True,
            text=True).stdout.strip().splitlines()[-1],
        "losses_equal": True, "final_state_bitwise_equal": True,
        "planted_fault_rejected": True, "launches": launches,
    }
    emit(row)
    return launches


# ---- the mesh, the resharding restore and the node check -------------------

MESH_STEPS = 1 + 3                  # one warm step, three timed
RESHARD_MESH = {"dp": 2, "tp": 2}   # the CPU world the card's state moves to
RESHARD_TIMEOUT_S = 600.0


def _mesh_state(cfg, tc, mesh, device):
    """Fresh f32 params from the seed (on a mesh when ``mesh``)."""
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer import train_step as ts

    params = llama.init_params(
        cfg, torch.Generator(device).manual_seed(SEED), device=device)
    opt = ts.make_optimizer(tc)
    return opt, ts.init_train_state(cfg, opt, params, mesh=mesh)


def phase_mesh_train(cfg, device="cuda", micro=TRAIN_MICRO, seq=TRAIN_SEQ):
    """The sharded train step on a world of one: ``make_train_step(...,
    mesh=build_mesh(MeshConfig()))`` over nccl at phase 6's shape (micro
    8 x 2048, ga 2, remat mlp_only), MESH_STEPS steps, against the
    mesh-less step from the same seed and batch. Every collective of a
    world of one is an identity and the local shards are the whole
    leaves, so losses, grad norms and final params must be bitwise
    equal; B1/B2 launch exactly n_layers x ga times a step (the CE stays
    dense at this N·V, so B3/B4 do not run). The mesh-less run's final
    params are kept (as copies) and the rest of its state freed before
    the mesh run; each run's peak memory is its peak above what was
    allocated when it began. Returns (the mesh run's state, its
    launches). ``device="cpu"`` (gloo, no launches) rehearses
    it at a small ``cfg``."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import fused_ce as fc
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.trainer import train_step as ts

    on_card = device == "cuda"
    rs = np.random.RandomState(SEED + 1)
    tokens = torch.from_numpy(rs.randint(
        0, cfg.vocab_size, (TRAIN_GA * micro, seq + 1)
    ).astype(np.int32)).to(device)
    tc = ts.TrainConfig(warmup_steps=2, grad_accum=TRAIN_GA)
    mesh = build_mesh(MeshConfig(), device)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    runs = {}
    for label, m in (("meshless", None), ("mesh", mesh)):
        sync()
        held = torch.cuda.memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        opt, state = _mesh_state(cfg, tc, m, device)
        step = ts.make_train_step(cfg, tc, opt, device=device, mesh=m)
        fa.reset_launch_counts()
        fc.reset_launch_counts()
        losses, norms, times = [], [], []
        for _ in range(MESH_STEPS):
            t0 = time.monotonic()
            state, metrics = step(state, {"tokens": tokens})
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            sync()
            times.append(time.monotonic() - t0)
        runs[label] = {
            "losses": losses, "grad_norms": norms, "step_s": times,
            "step_s_mean_after_first": float(np.mean(times[1:])),
            "peak_memory_gib": (torch.cuda.max_memory_allocated() - held)
            / 2**30 if on_card else None,
            "launches": {**fa.launch_counts, **fc.launch_counts},
            "params": [ts.local_shard(p).detach().clone()
                       for p in ts.param_leaves(state["params"])]
            if m is None else None,
            "state": state if m is not None else None,
        }
        del opt, step, state
        if on_card:
            torch.cuda.empty_cache()
    a, b = runs["meshless"], runs["mesh"]
    leaves_b = [ts.local_shard(p) for p in
                ts.param_leaves(b["state"]["params"])]
    differ = [name for name, x, y in zip(
        _leaf_names(b["state"]["params"]), a["params"], leaves_b)
        if not torch.equal(x, y)]
    want = cfg.n_layers * TRAIN_GA * MESH_STEPS if on_card else 0
    row = {"phase": "mesh_train", "mesh": MeshConfig().describe(),
           "backend": torch.distributed.get_backend(),
           "micro_batch": micro, "seq": seq,
           "grad_accum": TRAIN_GA, "steps": MESH_STEPS,
           **{f"{k}_{lab}": runs[lab][k] for lab in runs for k in (
               "losses", "grad_norms", "step_s", "step_s_mean_after_first",
               "peak_memory_gib", "launches")},
           "losses_bitwise_equal": a["losses"] == b["losses"],
           "grad_norms_bitwise_equal": a["grad_norms"] == b["grad_norms"],
           "params_differ": differ}
    emit(row)
    check(a["losses"] == b["losses"] and a["grad_norms"] == b["grad_norms"],
          f"mesh_train: the world-one mesh step gave {b['losses']} "
          f"{b['grad_norms']}, the mesh-less {a['losses']} "
          f"{a['grad_norms']}")
    check(not differ, f"mesh_train: final params differ: {differ}")
    check(b["losses"][-1] < b["losses"][0],
          f"mesh_train: loss did not fall {b['losses']}")
    launches = b["launches"]
    for name in fa.launch_counts:
        check(launches[name] == want,
              f"mesh_train: {name} launched {launches[name]}, want {want}")
    for name in fc.launch_counts:
        check(launches[name] == 0,
              f"mesh_train: {name} launched on the dense CE route")
    del runs["meshless"], a
    if on_card:
        torch.cuda.empty_cache()
    return b["state"], {k: launches[k] for k in fa.launch_counts}


def zero_state_tree(cfg, mesh, device):
    """A zeroed tree of ``train_step.state_tree``'s structure on ``mesh``
    (this rank's shards allocated, as DTensors), the resharding
    restore's target."""
    from torch.distributed.tensor import DTensor

    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.parallel import sharding
    from dlrover_tpu_torch.trainer import train_step as ts

    shapes = ts.params_like(llama.init_params(cfg, device="meta"),
                            lambda p: tuple(p.shape))
    specs = ts.state_specs(cfg)["params"]

    def leaf(shape, spec):
        places = sharding.placements(spec, mesh)
        bounds = sharding.shard_bounds(shape, mesh, places)
        local = torch.zeros([hi - lo for lo, hi in bounds],
                            dtype=torch.float32, device=device)
        return DTensor.from_local(local, mesh, places, run_check=False)

    def tree():
        return ts._zip_like(shapes, specs, leaf)

    return {"params": tree(),
            "opt_state": {"exp_avg": tree(), "exp_avg_sq": tree(),
                          "step": ts.params_like(
                              shapes, lambda _: torch.tensor(0.0))},
            "step": 0}


def reshard_rank_main(card_dir, step, own_dir, out_path, config):
    """One rank of the CPU world of ``phase_reshard_restore`` (run by
    ``tools/torch_mesh_phases.py --reshard-rank``): restore the card's
    step into this rank's shards at RESHARD_MESH reading only its
    regions, hold each shard's bytes to its slice of the card's file,
    then save this rank's shards to ``own_dir``."""
    from dlrover_tpu_torch.flash_ckpt import engine as ckpt_engine
    from dlrover_tpu_torch.flash_ckpt import storage as ckpt_storage
    from dlrover_tpu_torch.flash_ckpt.shm_handler import (
        leaf_bytes,
        tree_flatten,
    )
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.parallel import sharding
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.trainer import runtime

    torch.set_num_threads(2)
    ctx = runtime.init_distributed(timeout_secs=300, device="cpu")
    mesh = build_mesh(MeshConfig(**RESHARD_MESH), "cpu")
    target = zero_state_tree(_config(config), mesh, "cpu")
    metas = ckpt_storage.load_step_meta(card_dir, step)
    stats = {}
    t0 = time.monotonic()
    result = ckpt_engine.load_global_state(card_dir, step, metas, target,
                                           stats)
    restore_s = time.monotonic() - t0
    out = {"rank": ctx.process_id, "coord": mesh.get_coordinate(),
           "restored": result is not None, "restore_s": restore_s,
           "bytes_read": stats.get("bytes_read"), "mismatched": []}
    local_bytes = 0
    if result is not None:
        leaves, _ = tree_flatten(result[1])
        with ckpt_storage.load_proc_arrays(card_dir, step, 0) as reader:
            for i, leaf in enumerate(leaves):
                got = leaf_bytes(leaf).numpy()
                local_bytes += got.size
                bounds = sharding.shard_bounds(
                    leaf.shape, mesh, leaf.placements) if hasattr(
                    leaf, "placements") else tuple(
                    (0, n) for n in np.shape(leaf))
                want = np.ascontiguousarray(reader.view(f"leaf{i}_shard0")[
                    tuple(slice(lo, hi) for lo, hi in bounds)])
                if not np.array_equal(got, want.reshape(-1).view(np.uint8)):
                    out["mismatched"].append(i)
    out["local_bytes"] = local_bytes
    engine = ckpt_engine.CheckpointEngine(own_dir, standalone=True)
    t0 = time.monotonic()
    engine.save_to_storage(step, result[1] if result else target)
    torch.distributed.barrier()
    out["save_s"] = time.monotonic() - t0
    engine._shm.unlink()  # noqa: SLF001
    engine.close()
    with open(out_path, "w") as f:
        json.dump(out, f)
    runtime.shutdown_distributed()
    return 0


def _move_one_row(ckpt_dir, step, pid, leaf_id):
    """Plant a fault: move one shard's bounds in ``pid``'s meta by one
    row. Returns the meta file's bytes, to put back."""
    import pickle

    from dlrover_tpu_torch.flash_ckpt import storage as ckpt_storage

    path = os.path.join(ckpt_storage.step_dir(ckpt_dir, step),
                        f"proc-{pid}.meta")
    with open(path, "rb") as f:
        saved = f.read()
    meta = ckpt_storage.load_step_meta(ckpt_dir, step)[pid]
    shard = meta["leaves"][leaf_id].shards[0]
    (lo, hi), *rest = shard.index
    shard.index = ((lo + 1, hi + 1), *rest)
    with open(path, "wb") as f:
        pickle.dump(meta, f)
    return path, saved


def _config(name):
    from dlrover_tpu_torch.models import llama

    return {"flagship": llama.flagship_config,
            "tiny": llama.tiny_config}[name]()


def phase_reshard_restore(cfg, state, device="cuda", config="flagship"):
    """A real change of layout across the card and a CPU world: the card
    (a world of one) saves ``state`` (params and both Adam moments) to
    storage; a 4-process gloo world at RESHARD_MESH restores it, each
    rank reading only its regions and holding each shard's bytes to the
    card's file; that world saves its own shards (a proc file a rank)
    and the card restores them into whole leaves, which must equal what
    it saved bit for bit. A shard whose bounds moved by one row in one
    rank's meta must be refused. ``device="cpu"`` with ``config``
    naming ``cfg`` ("tiny") rehearses it."""
    import shutil
    import tempfile
    import uuid

    from dlrover_tpu_torch.flash_ckpt import engine as ckpt_engine
    from dlrover_tpu_torch.flash_ckpt import storage as ckpt_storage
    from dlrover_tpu_torch.flash_ckpt.shm_handler import (
        leaf_bytes,
        tree_flatten,
    )
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.trainer import runtime
    from dlrover_tpu_torch.trainer import train_step as ts

    root = tempfile.mkdtemp(prefix="reshard_")
    job = f"reshard{uuid.uuid4().hex[:8]}"
    saved_env = {k: os.environ.get(k) for k in (
        "DLROVER_TPU_JOB_NAME", "DLROVER_TPU_SHARED_DIR")}
    os.environ["DLROVER_TPU_JOB_NAME"] = job
    os.environ["DLROVER_TPU_SHARED_DIR"] = os.path.join(root, "uds")
    runtime._context = None  # noqa: SLF001 (this process: a world of one)
    procs = []
    try:
        card_dir, world_dir = (os.path.join(root, n)
                               for n in ("card", "world"))
        tree = ts.state_tree(state)
        step = state["step"]
        engine = ckpt_engine.CheckpointEngine(card_dir, standalone=True)
        t0 = time.monotonic()
        engine.save_to_storage(step, tree)
        card_save_s = time.monotonic() - t0
        engine._shm.unlink()  # noqa: SLF001
        engine.close()
        check(ckpt_storage.read_tracker(card_dir) == step,
              "reshard_restore: the card's save was not committed")
        state_bytes = sum(leaf_bytes(x).numel()
                          for x in tree_flatten(tree)[0]
                          if isinstance(x, torch.Tensor))

        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        world = MeshConfig(**RESHARD_MESH).num_devices
        tool = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tools", "torch_mesh_phases.py")
        t0 = time.monotonic()
        for rank in range(world):
            env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                       OMP_NUM_THREADS="2",
                       DLROVER_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       DLROVER_TPU_NUM_PROCESSES=str(world),
                       DLROVER_TPU_PROCESS_ID=str(rank),
                       DLROVER_TPU_LOCAL_RANK=str(rank),
                       DLROVER_TPU_LOCAL_WORLD_SIZE=str(world),
                       DLROVER_TPU_NODE_RANK="0")
            log = open(os.path.join(root, f"rank{rank}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, tool, "--reshard-rank", card_dir,
                 str(step), world_dir, os.path.join(root, f"rank{rank}.json"),
                 config],
                env=env, stdout=log, stderr=subprocess.STDOUT), log))
        for proc, log in procs:
            rc = proc.wait(timeout=RESHARD_TIMEOUT_S)
            log.close()
            check(rc == 0, f"reshard_restore: a rank exited {rc}: "
                  + open(log.name).read()[-3000:])
        world_s = time.monotonic() - t0
        ranks = [json.load(open(os.path.join(root, f"rank{r}.json")))
                 for r in range(world)]
        for r in ranks:
            check(r["restored"] and not r["mismatched"],
                  f"reshard_restore: rank {r['rank']} restored "
                  f"{r['restored']}, leaves differing {r['mismatched']}")
            check(r["bytes_read"] == r["local_bytes"],
                  f"reshard_restore: rank {r['rank']} read "
                  f"{r['bytes_read']} bytes for {r['local_bytes']} of "
                  f"shards")

        # The world's shards back onto the card, whole.
        mesh = build_mesh(MeshConfig(), device)
        back = zero_state_tree(cfg, mesh, device)
        metas = ckpt_storage.load_step_meta(world_dir, step)
        check(sorted(metas) == list(range(world)),
              f"reshard_restore: proc files {sorted(metas)}")
        stats = {}
        t0 = time.monotonic()
        result = ckpt_engine.load_global_state(world_dir, step, metas, back,
                                               stats)
        if device == "cuda":
            torch.cuda.synchronize()
        card_restore_s = time.monotonic() - t0
        check(result is not None, "reshard_restore: the card refused the "
                                  "world's checkpoint")
        differ = [i for i, (x, y) in enumerate(zip(
            tree_flatten(tree)[0], tree_flatten(result[1])[0]))
            if isinstance(x, torch.Tensor) and not torch.equal(
                ts.local_shard(x), ts.local_shard(y).to(x.device))]
        check(not differ and result[1]["step"] == step,
              f"reshard_restore: leaves {differ} differ after the round "
              f"trip")
        # The planted fault: layers.wq's exp_avg shard of rank 1 (held by
        # that rank alone at dp=2, tp=2) moved by one row.
        names = _leaf_names(tree)
        leaf_id = names.index("opt_state.exp_avg.layers.wq")
        path, meta_bytes = _move_one_row(world_dir, step, 1, leaf_id)
        faulty = ckpt_engine.load_global_state(
            world_dir, step, ckpt_storage.load_step_meta(world_dir, step),
            back)
        with open(path, "wb") as f:
            f.write(meta_bytes)
        check(faulty is None, "reshard_restore: a shard moved by one row "
                              "was restored")
        row = {"phase": "reshard_restore", "from": "card (world 1)",
               "to": MeshConfig(**RESHARD_MESH).describe() + " gloo CPU",
               "state_gb": state_bytes / 1e9, "card_save_s": card_save_s,
               "world_s": world_s,
               "rank_bytes_read": [r["bytes_read"] for r in ranks],
               "rank_restore_s": [r["restore_s"] for r in ranks],
               "rank_save_s": [r["save_s"] for r in ranks],
               "card_restore_bytes_read": stats["bytes_read"],
               "card_restore_s": card_restore_s,
               "card_restore_gb_per_s": stats["bytes_read"] / 1e9
               / card_restore_s,
               "round_trip_bitwise_equal": True,
               "planted_fault_rejected": True}
        emit(row)
        return row
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        for seg in os.listdir("/dev/shm"):
            if job in seg:
                os.unlink(os.path.join("/dev/shm", seg))
        shutil.rmtree(root, ignore_errors=True)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        runtime._context = None  # noqa: SLF001


def phase_node_check(device="cuda", size=1024, comm_mb=64):
    """The port's ``node_check_worker`` on the card as the reference agent
    runs it (a subprocess with the agent's env: a world of one, matmul
    1024, 30 rounds, a 64 MB all_reduce): it writes its result file.
    Under ``DLROVER_TPU_CHAOS_CHECK_FAIL_RANKS=0`` it leaves no file and
    exits non-zero. ``device="cpu"`` rehearses it (smaller sizes)."""
    import tempfile

    out = {"phase": "node_check"}
    with tempfile.TemporaryDirectory() as d:
        for label, extra in (("ok", {}),
                             ("fail", {"DLROVER_TPU_CHAOS_CHECK_FAIL_RANKS":
                                       "0"})):
            result = os.path.join(d, f"r_{label}")
            env = dict(os.environ, DLROVER_TPU_COORDINATOR="",
                       DLROVER_TPU_NUM_PROCESSES="1",
                       DLROVER_TPU_PROCESS_ID="0",
                       DLROVER_TPU_LOCAL_RANK="0",
                       DLROVER_TPU_LOCAL_WORLD_SIZE="1",
                       DLROVER_TPU_CHECK_NODE_RANK="0",
                       DLROVER_TPU_CHECK_DEVICE=device, **extra)
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, "-m",
                 "dlrover_tpu_torch.agent.node_check_worker", result,
                 str(size), "30", str(comm_mb)], env=env, capture_output=True,
                text=True, timeout=300,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            wall = time.monotonic() - t0
            has_file = os.path.exists(result)
            out[label] = {"rc": proc.returncode, "result_file": has_file,
                          "wall_s": wall}
            if has_file:
                out[label]["elapsed_s"] = float(open(result).read())
            if label == "ok":
                check(proc.returncode == 0 and has_file,
                      f"node_check: rc {proc.returncode}, result file "
                      f"{has_file}: {proc.stderr[-2000:]}")
            else:
                check(proc.returncode != 0 and not has_file,
                      f"node_check: the fail variable gave rc "
                      f"{proc.returncode}, result file {has_file}")
    emit(out)
    return out


# ---- long context, the ring's hops, the ep expert body, the pipeline ------

LONG_SEQS = (32768, 65536)          # batch 1, the flagship under attn_save
RING_SP, RING_SEQ = 4, 32768        # ring_hops: 4 chunks of 8192
# The whole-sequence flash calls ring_hops also holds against the plain
# version: label, s, causal.
RING_WHOLE = (("whole_32768", 32768, True), ("whole_32768_full", 32768,
                                              False),
              ("whole_65536", 65536, True))
EP_RANKS, EP_TOKENS = 4, 2 * MOE_SEQ  # moe_ep_body: one rank of ep = 4
PP_STAGES, PP_MICRO = 4, 4          # pipeline_train


def _escape_flash():
    """The flash op without ``is_plain_flash``: under ``attn_save`` the
    layer keeps the escape (q, k, v, out and lse saved, the flanks
    recomputed) instead of the lite block."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    def attention_fn(q, k, v, causal=True, q_positions=None,
                     kv_positions=None, softmax_scale=None):
        return fa.flash_attention(q, k, v, causal, softmax_scale)

    attention_fn.saveable_residuals = True
    return attention_fn


def _check_train_gates(phase, row):
    for gate, key in (("loss", "loss_rel"), ("grad_norm", "grad_norm_rel"),
                      ("grads", "grads")):
        check(row[key] <= TRAIN_GATES[gate],
              f"{phase}: {key} {row[key]} > {TRAIN_GATES[gate]}")


def phase_long_context():
    """``bench.py``'s long-context path (``longctx_phase`` :486-560): the
    flagship at full width and depth, batch 1, 32768 and then 65536
    tokens, remat ``attn_save``, seed 0, the CE route "auto" picks (the
    chunked fused CE at these N x V). One step through the lite block
    (the default flash op) against one through the escape from the same
    state: within TRAIN_GATES at 32768, reported at 65536; the peak
    memory the lite block's forward and backward add
    (``fwd_bwd_peak_bytes``) below the escape's at both lengths (the
    whole step's peak, ``step_peak_bytes``, is reported: at 32768 the
    optimizer's first update sets it in both, four times the params'
    f32 bytes, so it cannot tell the two apart); exactly
    n_layers B1, B2 dq and B2 dk/dv launches a step in both (B1 is not
    re-run in the backward). Then one more step each, timed: step s,
    tokens/s and the model-FLOP share on the long-sequence basis ((6N +
    causal attention) FLOPs a token over the bf16 peak). Returns the
    launches."""
    from dlrover_tpu_torch.models import llama

    cfg = llama.flagship_config(remat_policy="attn_save")
    escape = _escape_flash()
    launches = {}
    for seq in LONG_SEQS:
        rs = np.random.RandomState(SEED + 11)
        tokens = torch.from_numpy(rs.randint(
            0, cfg.vocab_size, (1, seq + 1)).astype(np.int32)).cuda()
        one = _one_step_rows(cfg, tokens, {
            "escape": (lambda p, b: llama.loss_fn(cfg, p, b,
                                                  attention_fn=escape),
                       None),
            "lite": (None, None),
        }, timed_steps=1)
        flops_token = (cfg.flops_per_token()
                       + cfg.attention_flops_per_token(seq))
        for label, row in one.items():
            step_s = row["timed_step_s"][0]
            row.update(tokens_per_s=seq / step_s,
                       model_flops_share_of_peak=flops_token * seq / step_s
                       / PEAK_OPS_PER_S["bfloat16"],
                       step_peak_gib=row["step_peak_bytes"] / 2**30,
                       fwd_bwd_peak_gib=row["fwd_bwd_peak_bytes"] / 2**30)
            for name in ("flash_forward", "flash_backward_dq",
                         "flash_backward_dkv"):
                got = row["launches"][name]
                check(got == cfg.n_layers,
                      f"long_context/{seq}/{label}: {name} launched {got} "
                      f"times in a step, want {cfg.n_layers}")
                launches[name] = launches.get(name, 0) + got
        emit({"phase": "long_context", "seq": seq, "batch": 1,
              "remat_policy": cfg.remat_policy,
              "ce_path": llama.resolve_ce_path(cfg, seq),
              "gates": TRAIN_GATES if seq == LONG_SEQS[0] else None, **one})
        if seq == LONG_SEQS[0]:
            _check_train_gates(f"long_context/{seq}", one["lite"])
        lite, esc = (one[k]["fwd_bwd_peak_bytes"]
                     for k in ("lite", "escape"))
        check(lite < esc, f"long_context/{seq}: the lite block's forward "
                          f"and backward peak {lite} is not below the "
                          f"escape's {esc}")
        del tokens, one
        torch.cuda.empty_cache()
    return launches


def _plain_long_attention(q, k, v, do, causal, block):
    """Plain attention over the whole sequence, ``block`` query rows at a
    time against every key, with the causal mask at the rows' global
    positions (h == kh): out, lse, dq, dk, dv with the plain B1/B2
    versions' rounding (P to bf16 before P.V and dV, dS to bf16 before
    dq and dk; f32 sums)."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops.attention import NEG_INF

    b, s, h, d = q.shape
    scale = d ** -0.5
    kf, vf = k.float(), v.float()
    cols = torch.arange(s, device=q.device)

    def scores(a):
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, a:a + block].float(),
                          kf) * scale
        if causal:
            rows = torch.arange(a, a + block, device=q.device)[:, None]
            sc = torch.where(rows >= cols[None, :], sc, NEG_INF)
        return sc

    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    for a in range(0, s, block):
        sc = scores(a)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), vf)
        out[:, a:a + block] = (o / l.permute(0, 2, 1, 3)).bfloat16()
        lse[:, :, a:a + block] = (m + torch.log(l))[..., 0]
        del sc, p
    delta = fa.flash_backward_delta(do, out)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for a in range(0, s, block):
        p = torch.exp(scores(a) - lse[:, :, a:a + block, None])
        dob = do[:, a:a + block].float()
        dp = torch.einsum("bqhd,bkhd->bhqk", dob, vf)
        ds = (p * (dp - delta[:, :, a:a + block, None])
              * scale).bfloat16().float()
        del dp
        dq[:, a:a + block] = torch.einsum("bhqk,bkhd->bqhd", ds,
                                          kf).bfloat16()
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, q[:, a:a + block].float())
        dv += torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), dob)
        del p, ds
    return out, lse, dq, dk.bfloat16(), dv.bfloat16()


def _events_ms(fn):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_ring_hops():
    """The ring's hop loops (``ops/ring_attention``) at sp = RING_SP on
    this card through the one-process runner: every rank's chunk of b=1,
    s=RING_SEQ, h=kh=8, d=128 bf16 held here, each rank receiving what
    the previous one sent, causal and non-causal. The hops run B1 causal
    on the diagonal chunk, B1 non-causal on a chunk of the past, nothing
    on a chunk of the future; the backward feeds B2 the final lse and
    the global delta. out, lse and dq/dk/dv over the whole sequence are
    held at the flash gate (_flash_ratio; lse within 1e-3), on the
    second of two runs (the one timed), against the plain version
    (``_plain_long_attention``) and against B1/B2 called on the whole
    sequence, which are held against the plain version too, also at
    65536 tokens. Exact launches: causal RING_SP diagonal +
    RING_SP (RING_SP - 1) / 2 past hops (the rest skipped), non-causal
    RING_SP^2, of B1 and of each B2 kernel. A planted fault, one hop's B2
    fed that hop's own lse instead of the final one, must fail the gate.
    Returns the runner's launches (both runs)."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import ring_attention as ra

    gen = torch.Generator("cuda").manual_seed(SEED + 13)
    b, h, d, n = 1, 8, 128, RING_SP
    sl = RING_SEQ // n
    q, k, v, do = (torch.randn((b, RING_SEQ, h, d), generator=gen,
                               device="cuda").bfloat16() for _ in range(4))

    def chunks(t):
        return [t[:, r * sl:(r + 1) * sl].contiguous() for r in range(n)]

    qs, ks, vs, dos = (chunks(t) for t in (q, k, v, do))
    offsets = [r * sl for r in range(n)]
    launches = {}
    for causal in (True, False):
        # Twice: the first run also warms the allocator; the second is
        # timed and compared.
        for _ in range(2):
            before = _kernel_launches()
            fwd, fwd_ms = _events_ms(lambda: ra.one_process_ring_forward(
                qs, ks, vs, offsets, causal))
            outs, lses = [o for o, _ in fwd], [lse for _, lse in fwd]
            bwd, bwd_ms = _events_ms(lambda: ra.one_process_ring_backward(
                qs, ks, vs, outs, lses, dos, offsets, causal))
            got_launches = _launches_since(before)
            hops = n * n if not causal else n + n * (n - 1) // 2
            for name in ("flash_forward", "flash_backward_dq",
                         "flash_backward_dkv"):
                check(got_launches[name] == hops,
                      f"ring_hops/causal={causal}: {name} launched "
                      f"{got_launches[name]} times, want {hops}")
                launches[name] = launches.get(name, 0) + hops
        ring = {"out": torch.cat(outs, 1), "lse": torch.cat(lses, 2),
                "dq": torch.cat([t[0] for t in bwd], 1),
                "dk": torch.cat([t[1] for t in bwd], 1),
                "dv": torch.cat([t[2] for t in bwd], 1)}
        whole = {}
        for _ in range(2):      # the second call timed, as the ring's
            (whole["out"], whole["lse"]), w_fwd_ms = _events_ms(
                lambda: fa.flash_forward(q, k, v, causal))
            delta = fa.flash_backward_delta(do, whole["out"])
            (whole["dq"], (whole["dk"], whole["dv"])), w_bwd_ms = \
                _events_ms(lambda: (
                    fa.flash_backward_dq(q, k, v, do, whole["lse"], delta,
                                         causal),
                    fa.flash_backward_dkv(q, k, v, do, whole["lse"], delta,
                                          causal)))
        plain = dict(zip(("out", "lse", "dq", "dk", "dv"),
                         _plain_long_attention(q, k, v, do, causal, 2048)))
        names = ("out", "dq", "dk", "dv")
        ratio = {"vs_plain": {x: _flash_ratio(ring[x], plain[x])
                              for x in names},
                 "vs_whole": {x: _flash_ratio(ring[x], whole[x])
                              for x in names}}
        lse_err = {"vs_plain": float((ring["lse"] - plain["lse"]).abs()
                                     .max()),
                   "vs_whole": float((ring["lse"] - whole["lse"]).abs()
                                     .max())}

        # The planted fault: one hop's B2 fed that hop's own lse (the
        # causal ring's first past hop, rank 1's second; rank 1's first
        # hop without the mask).
        real_dq, real_dkv = fa.flash_backward_dq, fa.flash_backward_dkv
        target = {"dq": 0, "dkv": 0}
        hit = n if causal else 1    # the call index of that hop's B2

        def wrong_lse(which, real):
            def call(q_, k_, v_, do_, lse_, delta_, causal_=True,
                     scale_=None):
                target[which] += 1
                if target[which] == hit + 1:
                    lse_ = real_fwd(q_, k_, v_, causal_, scale_)[1]
                return real(q_, k_, v_, do_, lse_, delta_, causal_, scale_)
            return call

        real_fwd = fa.flash_forward
        try:
            fa.flash_backward_dq = wrong_lse("dq", real_dq)
            fa.flash_backward_dkv = wrong_lse("dkv", real_dkv)
            faulty = ra.one_process_ring_backward(qs, ks, vs, outs, lses,
                                                  dos, offsets, causal)
        finally:
            fa.flash_backward_dq, fa.flash_backward_dkv = real_dq, real_dkv
        fault_ratio = max(
            _flash_ratio(torch.cat([t[i] for t in faulty], 1), plain[x])
            for i, x in enumerate(("dq", "dk", "dv")))
        emit({"phase": "ring_hops", "sp": n, "seq": RING_SEQ, "chunk": sl,
              "b": b, "h": h, "kh": h, "d": d, "causal": causal,
              "hops_run": hops, "hops_skipped": n * n - hops,
              "launches": got_launches, "ratio": ratio, "lse_err": lse_err,
              "ring_ms": {"forward": fwd_ms, "backward": bwd_ms},
              "whole_ms": {"forward": w_fwd_ms, "backward": w_bwd_ms},
              "planted_fault_ratio": fault_ratio})
        for against, r in ratio.items():
            for x, val in r.items():
                check(val <= 1.0, f"ring_hops/causal={causal}: {x} "
                                  f"{against} at {val} of its bound")
            check(lse_err[against] <= 1e-3,
                  f"ring_hops/causal={causal}: lse {against} "
                  f"{lse_err[against]}")
        check(fault_ratio > 1.0, f"ring_hops/causal={causal}: the gate "
              f"passes a hop fed a wrong lse ({fault_ratio})")
        del ring, whole, plain, faulty, fwd, bwd, outs, lses
        torch.cuda.empty_cache()

    # B1/B2 on the whole sequence against the plain version, at the
    # lengths long_context runs them.
    for label, s, causal in RING_WHOLE:
        gen = torch.Generator("cuda").manual_seed(SEED + 19)
        wq, wk, wv, wdo = (torch.randn((b, s, h, d), generator=gen,
                                       device="cuda").bfloat16()
                           for _ in range(4))
        out, lse = fa.flash_forward(wq, wk, wv, causal)
        delta = fa.flash_backward_delta(wdo, out)
        got = {"out": out,
               "dq": fa.flash_backward_dq(wq, wk, wv, wdo, lse, delta,
                                          causal)}
        got["dk"], got["dv"] = fa.flash_backward_dkv(wq, wk, wv, wdo, lse,
                                                     delta, causal)
        plain = dict(zip(("out", "lse", "dq", "dk", "dv"),
                         _plain_long_attention(wq, wk, wv, wdo, causal,
                                               2048 * 32768 // s)))
        ratio = {x: _flash_ratio(got[x], plain[x]) for x in got}
        lse_err = float((lse - plain["lse"]).abs().max())
        emit({"phase": "flash_bounds", "shape": label, "b": b, "s": s,
              "h": h, "d": d, "causal": causal, "ratio": ratio,
              "lse_err": lse_err})
        for x, val in ratio.items():
            check(val <= 1.0, f"flash/{label}: {x} at {val} of its bound")
        check(lse_err <= 1e-3, f"flash/{label}: lse err {lse_err}")
        del wq, wk, wv, wdo, got, plain, out, lse, delta
        torch.cuda.empty_cache()
    return launches


def phase_moe_ep_body():
    """The expert side of the ep exchange (``models/moe.ep_expert_body``)
    for one rank of ep = EP_RANKS at ``moe_config``'s widths (d = f =
    1024, 8 experts, so 2 on the rank, top-2): the rows four source
    ranks send it, each routing its 2 x 2048-token share of the 8 x 2048
    micro-batch with one router (source-major, by expert within a
    source), padded to the reference's ``cap_rows`` with sentinel rows.
    Forward and backward through B7 and B8 (dx, dw_gu, dw_down) against
    the same body through their plain versions at B7/B8's gate
    (_ce_ratio: rows over d, weight gradients over the rows of a
    column), bitwise on a rerun (the run timed: the body's layout,
    padding, kernels and autograd, forward and backward); one B7 and one
    of each B8 launch a body. Returns the launches (first run and
    rerun)."""
    from dlrover_tpu_torch.models import moe

    mcfg = moe_config()
    d, f, e, k = mcfg.embed_dim, mcfg.mlp_dim, mcfg.n_experts, mcfg.moe_top_k
    e_loc, me = e // EP_RANKS, 1
    gen = torch.Generator("cuda").manual_seed(SEED + 17)
    router = torch.randn(d, e, generator=gen, device="cuda") / 8
    parts, counts = [], []
    for _ in range(EP_RANKS):
        x = torch.randn(EP_TOKENS, d, generator=gen, device="cuda").bfloat16()
        experts = moe._top_k(torch.softmax(x.float() @ router, dim=-1),
                             k)[1].reshape(-1)
        order = torch.argsort(experts, stable=True)
        xs = x[order // k]                      # the sorted dispatch rows
        per = torch.bincount(experts, minlength=e).tolist()
        start = sum(per[:me * e_loc])
        mine = per[me * e_loc:(me + 1) * e_loc]
        parts.append(xs[start:start + sum(mine)])
        counts.append(mine)
    recv = torch.cat(parts)
    n_recv = recv.shape[0]
    cap_rows = moe.ep_cap_rows(EP_TOKENS, EP_RANKS, k)
    w_gu = (torch.randn(e_loc, d, 2 * f, generator=gen, device="cuda")
            / d ** 0.5).bfloat16()
    w_down = (torch.randn(e_loc, f, d, generator=gen, device="cuda")
              / f ** 0.5).bfloat16()
    dy = torch.randn(n_recv, d, generator=gen, device="cuda").bfloat16()

    def body(plain):
        leaves = [t.clone().requires_grad_(True) for t in (recv, w_gu,
                                                            w_down)]
        ys = moe.ep_expert_body(leaves[0], counts, e_loc, cap_rows,
                                leaves[1], leaves[2], dispatch="fused",
                                plain=plain)
        grads = torch.autograd.grad(ys, leaves, dy)
        torch.cuda.synchronize()
        return [ys.detach()] + list(grads)

    before = _kernel_launches()
    got = body(False)
    first = _launches_since(before)
    rerun, ms = _events_ms(lambda: body(False))
    launches = _launches_since(before)
    body(True)
    ref, plain_ms = _events_ms(lambda: body(True))
    names = ("y", "dx", "dw_gu", "dw_down")
    dims = (-1, -1, 1, 1)
    ratio = {x: _ce_ratio(g, r, dim)
             for x, g, r, dim in zip(names, got, ref, dims)}
    bitwise = all(torch.equal(a, b) for a, b in zip(got, rerun))
    emit({"phase": "moe_ep_body", "ep": EP_RANKS, "rank": me,
          "experts_on_rank": e_loc, "source_tokens": EP_TOKENS,
          "rows_received": n_recv, "cap_rows": cap_rows,
          "per_source_counts": counts, "ratio": ratio,
          "bitwise_rerun": bitwise, "launches_a_body": first,
          "ms_fwd_bwd": ms, "plain_ms_fwd_bwd": plain_ms})
    for x, val in ratio.items():
        check(val <= 1.0, f"moe_ep_body: {x} at {val} of its bound")
    check(bitwise, "moe_ep_body: a rerun gave other bits")
    for name in ("grouped_ffn_forward", "grouped_ffn_backward_dx",
                 "grouped_ffn_backward_dw_gu",
                 "grouped_ffn_backward_dw_down"):
        check(first[name] == 1, f"moe_ep_body: {name} launched "
                                f"{first[name]} times in a body, want 1")
    return {name: n for name, n in launches.items() if n}


def phase_pipeline_train():
    """The GPipe pipeline (``trainer/pipeline``) on the flagship at
    ``pp_stages`` = PP_STAGES and ``num_microbatches`` = PP_MICRO, all
    stages on this card (a world of one), micro-batch 8 x 2048: one
    step against the flat step on the same batch from the same seed
    (the same draws in the stage layout) within TRAIN_GATES; exactly
    n_layers x PP_MICRO B1, B2 dq and B2 dk/dv launches a step (each
    layer once a micro-batch; bubble ticks compute nothing); then one
    more step of each, timed, and the peak memory of each. Returns the
    launches."""
    from dlrover_tpu_torch.models import llama

    flat = llama.flagship_config()
    piped = llama.flagship_config(pp_stages=PP_STAGES,
                                  num_microbatches=PP_MICRO)
    rs = np.random.RandomState(SEED + 1)
    tokens = torch.from_numpy(rs.randint(
        0, flat.vocab_size, (TRAIN_MICRO, TRAIN_SEQ + 1)).astype(
            np.int32)).cuda()
    one = _one_step_rows(flat, tokens, {
        "flat": (None, None), "pipeline": (None, None, piped)},
        timed_steps=1)
    want = flat.n_layers * PP_MICRO
    emit({"phase": "pipeline_train", "pp_stages": PP_STAGES,
          "num_microbatches": PP_MICRO, "micro_batch": TRAIN_MICRO,
          "seq": TRAIN_SEQ, "launches_want": want, "gates": TRAIN_GATES,
          **one})
    _check_train_gates("pipeline_train", one["pipeline"])
    launches = {}
    for name in ("flash_forward", "flash_backward_dq", "flash_backward_dkv"):
        got = one["pipeline"]["launches"][name]
        check(got == want, f"pipeline_train: {name} launched {got} times "
                           f"in a step, want {want}")
        launches[name] = got
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

    smi = timed("device", phase_device)
    ptxas = timed("build", phase_build)
    kernel_rows = timed("kernels", phase_kernels)
    paged_rows = timed("paged_kernels", phase_paged_kernels)
    flash_rows = timed("flash_kernels", phase_flash_kernels)

    cfg = llama.flagship_config()
    params = llama.init_params(
        cfg, torch.Generator("cuda").manual_seed(SEED), device="cuda"
    )
    da.reset_launch_counts()
    gen_rows = timed("generate", phase_generate, cfg, params)
    gen_launches = dict(da.launch_counts)
    da.reset_launch_counts()
    md.reset_launch_counts()
    eng_launches, served = timed("engine", phase_engine, cfg, params)
    da.reset_launch_counts()
    paged_want, paged_tokens = timed("paged_engine", phase_paged_engine,
                                     cfg, params)
    paged_launches = dict(da.launch_counts)
    # Each spec, migration and fleet run checks its own launches exactly.
    spec_launches = timed("spec_engine", phase_spec_engine, cfg, params,
                          served)
    paged_spec_launches = timed("paged_spec_engine", phase_paged_spec_engine,
                                cfg, params, served)
    migrate_launches = timed("migrate", phase_migrate, cfg, params,
                             paged_tokens)
    fleet_launches = timed("fleet_disagg", phase_fleet_disagg, cfg, params)
    timed("fleet_subprocess", phase_fleet_subprocess, cfg, params)
    launches = {
        name: gen_launches[name] + eng_launches[name] + paged_launches[name]
        + spec_launches[name] + paged_spec_launches[name]
        + migrate_launches.get(name, 0) + fleet_launches.get(name, 0)
        for name in da.launch_counts
    }
    emit({"phase": "launches", "generate": gen_launches,
          "engine": eng_launches, "paged_engine": paged_launches,
          "paged_engine_want": paged_want, "spec_engine": spec_launches,
          "paged_spec_engine": paged_spec_launches,
          "migrate": migrate_launches, "fleet_disagg": fleet_launches,
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
    launches.update(timed("train", phase_train, cfg))
    ce_rows = timed("ce_kernels", phase_ce_kernels)
    timed("ce_ab", phase_ce_ab)
    launches.update(timed("train_ce", phase_train_ce, cfg))

    moe_rows = timed("moe_kernels", phase_moe_kernels)
    moe_cfg = moe_config()
    moe_params = llama.init_params(
        moe_cfg, torch.Generator("cuda").manual_seed(SEED), device="cuda"
    )
    moe_launches = {"generate": timed("moe_generate", phase_moe_generate,
                                      moe_cfg, moe_params)}
    da.reset_launch_counts()
    md.reset_launch_counts()
    moe_launches["engine"], moe_served = timed(
        "moe_engine", phase_engine, moe_cfg, moe_params,
        phase="moe_engine", gated=False)
    for name in ("decode_attention_fp", "grouped_ffn_forward"):
        check(moe_launches["engine"][name] >= moe_cfg.n_layers,
              f"moe_engine: {name} never launched")
    moe_launches["paged_engine"] = timed(
        "moe_paged_engine", phase_moe_paged_engine, moe_cfg, moe_params,
        moe_served)
    del moe_params
    torch.cuda.empty_cache()
    moe_launches["train"] = timed("moe_train", phase_moe_train, moe_cfg)
    emit({"phase": "moe_launches", **moe_launches})
    for counts in moe_launches.values():
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    # The elastic worker's processes: their B1/B2 launches, each checked
    # exactly per worker inside the phase.
    for name, n in timed("elastic_ckpt", phase_elastic_ckpt).items():
        launches[name] += n
    # The mesh: the sharded step on a world of one (B1/B2 exact inside),
    # the resharding restore across the card and a CPU world, the node
    # check.
    mesh_state, mesh_launches = timed("mesh_train", phase_mesh_train, cfg)
    for name, n in mesh_launches.items():
        launches[name] += n
    timed("reshard_restore", phase_reshard_restore, cfg, mesh_state)
    del mesh_state
    torch.cuda.empty_cache()
    timed("node_check", phase_node_check)
    # The mesh's last axes: long context through the lite block, the
    # pipeline, the ring's hops and the ep expert body (launches exact
    # inside each phase).
    axes_launches = {
        "long_context": timed("long_context", phase_long_context),
        "pipeline_train": timed("pipeline_train", phase_pipeline_train),
        "ring_hops": timed("ring_hops", phase_ring_hops),
        "moe_ep_body": timed("moe_ep_body", phase_moe_ep_body),
    }
    emit({"phase": "axes_launches", **axes_launches})
    for counts in axes_launches.values():
        for name, n in counts.items():
            launches[name] += n
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
    emit({"phase": "seconds", **PHASE_SECONDS,
          "total": sum(PHASE_SECONDS.values())})
    print(smi, flush=True)
    emit({"kernels": kernels})
    torch.distributed.destroy_process_group()  # the mesh phases' group
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
