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
4. generate(): b=8, prompt 128, 128 new tokens, fp and int8 KV caches;
5. ServingEngine: 8 slots, max_len 1024, 16 greedy requests (prompts
   16-300, 16-64 new tokens);
6. train: ``make_train_step`` on the flagship, remat ``mlp_only``,
   micro-batch 8 x seq 2048 with ``grad_accum`` 2 (the JAX package's
   compute phase uses 16; cut for this script's time limit). One
   grad_accum=1 step through the kernels against the same step through
   plain attention (loss, grad norm and every leaf's gradient), and a
   planted fault the gradient gate must reject; 6 steps through the
   kernels with falling loss,
   exact kernel launch counts and a second run from the same seed that
   gives the same losses; step time, tokens/s, model FLOP share, peak
   memory and a profiled step: the port's per-op profile
   (``tpu_timer/xla_capture.capture_op_profile``, one window), every
   B1/B2 launch of the step bucketed under the model's ``attn`` scope
   and the scope shares (attn, mlp, vocab, optimizer, other) summing to
   1; then ``tpu_timer/analysis.matmul_analysis`` at 2048, 4096 and 8192,
   TFLOP/s each at no more than 105% of the bf16 dense peak;
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
    every split edge), GQA h=32/kh=8, blocks of 32 and 128 rows, and
    the fleet soak's replicas' blocks of 8 and max_len 64 (fp, b=8;
    their 2 slots share its split-K plan);
    times, the bytes bound, and gather + SDPA
    as the library call. Two planted faults the same tolerance must
    reject (a kernel that ignores the table, one that drops a row's last
    partly filled block), and whether B6 through an identity table
    equals B5 bit for bit (reported);
11. PagedServingEngine on the flagship, full depth: (a) fp at the bytes
    of phase 5's flat engine and twice its slots (16 slots, 513 blocks
    of 16 rows), 24 greedy requests (cut from 32 for the script's time
    limit, PR 23; prompts 16-300, 32-128 new tokens,
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
    the first 8 of phase 5's requests with prompts ``p + greedy(p) + p`` from phase
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
11c. migrate: phase 11's 24 requests (cut from 32 for the script's
    time limit, PR 22) through two paged engines at its
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
    the reference's bimodal schedule (16 requests, Poisson arrivals 0.125
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
11f. fleet_soak (run after phase 19, beside phase 29 and no other):
    the seeded chaos soak's
    fleet episodes (seed 0, 4 ``replica_kill_reroute`` and 6
    ``kill_during_migration``,
    ``tools/torch_chaos_soak.py --fleet-config flagship``, each in a
    process of its own, both at once): two paged ``SubprocessReplica``s
    of the flagship on this card under a ``FleetRouter``, one SIGKILLed
    mid-decode (4) or holding an unacked KV import (6) and restarted. The
    harness's invariants (every request terminal once, the victim
    BROKEN, probed and HEALTHY again, trace trees, block reclaim); the
    planned crash fired, a restart, in 6 a migration and a migration
    failure; block conservation on every replica's last heartbeat; every
    replica start on the card; B6 launched in the replicas (their
    heartbeats count it). Each episode's wall, replica start seconds,
    requests, restarts, migrations and the victim's breaker-open to
    re-admitted seconds;
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
    535M params, 233M active): b=8, prompt 128, MOE_GEN_NEW new tokens,
    fp cache; a bitwise rerun and exact B5 and B7 launches. Routing flips
    (positions whose top-2 expert set differs between the cached path
    and the teacher-forced forward at some layer) are counted and
    reported, not bounded. The teacher-forced gap is held to ARGMAX_GAP
    at every position once the forward is pinned to the decode path's
    routing, and at every position without a flip in the free forward;
    every flip at the first layer must be a near-tie (MOE_TIE);
14. MoE ``ServingEngine``: phase 5's 16 requests, every one complete;
    tokens/s and TTFT;
14a. MoE ``PagedServingEngine`` at phase 11's fp settings over the
    first 8 of phase 14's requests with prompts ``p + greedy(p) + p``: spec off and
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
    4 layers at phase 6's shape (8 x 2048, ga 2), seed 0, under the
    port's own launcher, master and agent: ``python -m
    dlrover_tpu_torch.run --standalone --nproc_per_node 1
    --max_restarts 2 -m dlrover_tpu_torch.examples.train_llama ...``
    starts the local master over HTTP and the agent, whose saver holds
    the shm image and whose restarts are the only relaunches (this
    script sets the job's name and socket directory, and rewrites run
    B's fault schedule file before each kill). Run A trains 10 steps,
    beside run B (a cut for the time limit, PR 19); run B saves to shm
    after every step and persists every 3, is SIGKILLed once step 5 is
    in shm (restored from memory), then once
    step 8 is in shm and step 6 or later committed, with its segment
    unlinked (a lost host; restored from storage at the step the
    tracker held when the relaunch read it), and replays to 10. Gates:
    both launchers exit 0 and their masters have exited; run B's
    incarnations show restart counts 0, 1, 2 and are the processes the
    agent started; run B's replayed losses and final params, moments
    and step equal run A's bit for bit (a flipped moment element is
    rejected), the restores are the ones stated, each incarnation's
    B1/B2 launches are exact, no segment or socket is left. Image GB,
    master start and rendezvous seconds, save block and drain ms,
    snapshots dropped, persist (the saver's ``ckpt_persist`` events)
    and restore seconds and GB/s, worker start seconds, SIGKILL to
    first replayed step, steps redone and goodput (A's wall over B's).
    The workers' hang watchdog runs with a 10 s floor: each held
    incarnation of run B writes one hang dump naming the fault point's
    frame and, on SIGUSR1, one on-demand flight-recorder dump whose last
    step is its kill step; the master receives each hang dump through
    the agent; run A writes none. Seeing the hang dump, the agent
    appends the held worker's native stacks (``tpu_timer/native_stack``,
    ptrace; the host's ``ptrace_scope`` printed first) to its log, within
    12 s;
17. mesh_train: the sharded train step (``make_train_step(...,
    mesh=build_mesh(MeshConfig()))``, the state as DTensors) on a world
    of one over nccl at phase 6's shape (the flagship cut to MESH_LAYERS
    = 4 layers), 1 + 3 steps, against the
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
24. live_rescale: the port's live rescale episode (the reference test's
    settings: world 2, 960 records in shards of 16, a save every 2
    steps, 80 ms steps), the master in this process and two
    ``rescale_worker`` processes whose ``w`` and ``opt`` (8 MiB of
    int64 each) live on the card: one SIGKILLed, the survivor rescaled
    to a world of one in-process, a joiner back to two; the harness's
    invariants (exactly once, replay bit-identity, restored CRCs, the
    process tree) and a flipped CRC rejected. Plan-to-first-step and
    barrier seconds per rescale, restore bytes and seconds;
25. agent_paths: the launcher's ``--network-check`` (the probe on the
    card, then TIMER_STEPS training steps under ``DLROVER_TPU_TIMER=1``
    and ``DLROVER_TPU_TIMER_XLA=1``; a rigged probe starts no worker):
    after the first step the capture trigger; the worker's daemon serves
    ``/metrics``; the launcher started its collector, whose class
    forwards a post-capture scrape's gauges to the launcher's master
    (this process calls it rather than wait for its 30 s tick); the
    timeline fetched through ``tpu_timer/dump.py`` holds
    B1/B2's kernels; the capture window's seconds and the step time in
    and out of it. Beside it (it runs in an interpreter of its own, so
    both sides' seconds include the other's load), the agent's warm
    standby (a crash through the fault schedule, the relaunch the
    adopted standby on the card), with
    the crash to first step against a cold relaunch; the capture
    listener runs in every interpreter, host-only in a waiting standby,
    which holds no CUDA context when adopted. Its local master runs the
    autoscale loop (every 0.5 s, recording), its fault history fed the
    two crashes: the recording's newest ``perf.global_step`` is a step
    the worker trained on the card, the loop retuned the checkpoint
    cadence from the observed MTBF, the recording replays to the live
    ledger, and no decision's actuation failed;
26. chaos_soak: the seeded chaos soak (``testing/soak.run_soak``, seed 0,
    episodes ``crash_drop``, ``torn_ckpt`` and ``serving_report``), the
    master in this process and each worker generation's state (``sum``,
    ``hist``, ``vec``) on the card; the serving scenario is the port's
    ``ServingEngine`` at the flagship's width (d = 1024, bf16) cut to 2
    layers, at the reference's slots, ``max_len``, prefill chunk and
    request mix. The reference's four invariants, every restore's CRC
    its save's, and B5 launched at least once a layer per decode step
    (``call_counts``). Goodput, MTTR mean and max, faults fired;
27. master_kill: the soak's ``master_kill`` episode (seed 0, episode 7):
    the master a process of its own with a durable journal, SIGKILLed
    at its planned journaled dispatch and restarted on the same journal
    and port, the worker (state on the card) never restarted. The
    reference's five invariants. Kill to first post-kill step, the
    master's restart to ready, its epochs, the journal's stats and the
    filesystem it sat on; then ``tools/torch_bench_master_recovery.py``
    (host only): lease-path RPS with the journal off and on, and
    ``master_recovery_s``;
28. replica_restore (run beside phase 16, on a thread of its own: both
    wait on process starts): two nodes of one world, each under its own
    launcher with ``--ckpt_replica_group 2`` and this process's local
    master, their workers (``testing/replica_worker``) holding the
    flagship's train state at ELASTIC_LAYERS layers on the card and
    training the same batches without a process group. Node 1 is lost
    with its host (launcher and worker SIGKILLed, segment unlinked)
    once its step 4 is in shm and pushed to node 0 and storage holds
    step 3; a fresh node-1 launcher pulls the segment from node 0 and
    its worker restores step 4 from memory, bit for bit; with node 0's
    replica port unreachable, the next relaunch falls back to storage
    and says so. Image bytes, push and pull seconds and GB/s, relaunch
    to first step, the memory and storage restores' seconds, and a
    timeline of the phase;
29. autoscale_soak (beside phase 11f, in a process of its own): the
    soak's ``straggler_evict`` episode (seed 0, episode 5,
    ``tools/torch_chaos_soak.py --episode 5``): one seeded schedule (a
    delayed straggler, three worker deaths, a traffic spike) run static,
    dry-run and autoscaled over a simulated cluster on the host, which
    launches nothing on the card (as the reference's). The harness's
    invariants; the autoscaled goodput above the static, the straggler
    evicted within the window bound, a dry run with no actuation, the
    recording's replay identical and a perturbed replay different. Both
    goodput fractions, the time to mitigate, the decisions.
30. gshard_sp_body: gshard MoE under sp as each sp rank computes it
    (``models/moe.moe_mlp_chunk``) at ``moe_config``'s widths with
    ``moe_impl="gshard"`` and the default capacity factor, expert 0's
    router column doubled so capacity binds: one layer over 8 x 2048
    tokens split into 4 chunks of 512, each run with the lower chunks'
    and the whole sequence's per-round expert counts, against the
    whole-sequence ``moe_mlp``: every token's kept/dropped choice equal,
    ``dropped_fraction`` equal and above 0, out and every gradient
    within TRAIN_GATES' relative L2 distance, a bitwise rerun, and a
    planted fault (chunk-local capacities) rejected. Seconds and the
    dropped fraction;
31. ckpt_bridges: the flagship's train state at 2 layers (params and
    AdamW's moments after one step on the card) saved by the port's
    ``Checkpointer``, exported to a ``torch.distributed.checkpoint`` step
    (``flash_ckpt/dcp_io``), loaded back onto the card without a
    template, imported into a second flash dir and restored by the engine
    onto the card, each bit for bit; then the same params as an
    ``nn.Module`` with fused AdamW and a LambdaLR through
    ``trainer/hf_flash.FlashCkptCallback``'s ``on_save`` and a fresh
    callback's ``on_train_begin``, bit for bit, every tensor on the
    card. The dirs on ``/dev/shm``; bytes and seconds of each step.
32. dist_master (alone): the distributed master over the simulated
    cluster, built from the master CLI's own parse (``--platform sim
    --node_num 2 --transport http --pre_check``) in this process, this
    process
    playing the cluster's hosts: one ``python -m dlrover_tpu_torch.run
    --master`` launcher for each running node, over
    ``testing/replica_worker`` (the flagship at ELASTIC_LAYERS layers
    on the card, DIST_STEPS steps, a persist every DIST_PERSIST to
    ``/dev/shm``), each
    exit reported to the cluster. Both ranks pause at their committed
    step DIST_PERSIST; node 1 is then lost with its host and reported
    preempted; the master's relaunch machinery creates its next
    incarnation, whose launcher this process starts; the world re-forms,
    both ranks train on from the committed step and end on one model.
    The master's node table, exit reason and pre-check, the restores of
    the committed step (the relaunch's from storage, node 0's from
    memory), each later step once a rank, exact B1/B2 launches. Master ready to first step, and host loss to the
    replacement's first step split into sim relaunch, launcher start,
    rendezvous, worker start, restore and first step;
33. control_plane: ``tools/torch_bench_control_plane.py --workers
    CONTROL_PLANE_WORKERS`` on the host, alone: max sustainable RPCs/s,
    master CPU s per 1k RPCs, time to quorum per world and the shed
    counts, its three invariants raising inside it.

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

import atexit
import contextlib
import functools
import json
import os
import re
import signal
import subprocess
import sys
import threading
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


_EMIT_LOCK = threading.Lock()
# Phases that run at once take turns at the process env (the job's name,
# node rank and socket directory name shm segments and sockets).
_ENV_LOCK = threading.Lock()


def emit(obj):
    with _EMIT_LOCK:
        print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def _process_env(values):
    """Set ``values`` in the process env for the block, under the env
    lock, then put back what was there."""
    with _ENV_LOCK:
        old = {k: os.environ.get(k) for k in values}
        os.environ.update(values)
        try:
            yield
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


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

    from concurrent.futures import ThreadPoolExecutor

    from dlrover_tpu_torch.tpu_timer import bridge, native_stack

    def native():
        t0 = time.monotonic()
        bridge.library_path()
        native_stack.ensure_built()
        return time.monotonic() - t0

    t0 = time.monotonic()
    # The profiler's native runtime and stack sampler (g++) build beside
    # the kernels, before any worker process would build them.
    with ThreadPoolExecutor(1) as pool:
        native_s = pool.submit(native)
        per_source = _ext.build()
    ptxas = {s: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "entry function" in ln or "C75" in ln]
             for s, log in _ext.build_logs.items()}
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "per_source_s": per_source, "native_s": native_s.result(),
          "ptxas": ptxas})
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
    from dlrover_tpu_torch.testing.fleet_soak import FleetSoakConfig

    gen = torch.Generator("cuda").manual_seed(SEED + 6)
    rs = np.random.RandomState(SEED + 6)
    # The split-edge inputs draw from streams of their own (see
    # phase_kernels).
    edge_gen = torch.Generator("cuda").manual_seed(SEED + 10)
    edge_rs = np.random.RandomState(SEED + 10)
    # (label, b, h, kh, d, block_size, max_blocks, num_blocks, top random
    # fill, kvs): the fp and the int8 paged engine as served below, then GQA
    # and larger blocks, then the fleet soak's replicas (phase fleet_soak,
    # the harness's blocks and max_len) at 8 rows.
    fleet = FleetSoakConfig()
    shapes = [
        ("engine", 16, 8, 8, 128, 16, 64, 513, 700, ("fp", "int8")),
        ("engine_int8", 16, 8, 8, 128, 16, 64, 993, 700, ("int8",)),
        ("gqa", 16, 32, 8, 128, 16, 64, 513, 700, ("fp", "int8")),
        ("block_32", 16, 8, 8, 128, 32, 32, 257, 700, ("fp", "int8")),
        ("block_128", 16, 8, 8, 128, 128, 8, 65, 500, ("fp", "int8")),
        ("fleet_soak", 8, 8, 8, 128, fleet.block_size,
         fleet.max_len // fleet.block_size, 65, fleet.max_len, ("fp",)),
    ]
    # The replicas call B6 with their slots (a pool of slots x max_len /
    # block_size + 1 blocks): the same split-K plan as the row's 8.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    check(da.split_plan(fleet.slots, 8, 8, fleet.max_len, sms)
          == da.split_plan(8, 8, 8, fleet.max_len, sms),
          f"paged fleet_soak: {fleet.slots} slots split max_len unlike "
          f"the row's 8")

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
        # A split as long as max_len puts split + 1 past it.
        edges = [min(n, bs * mb) for n in edges]
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
    # The profiler's raw events: ``prof.events()`` would first build the
    # tree of every host op (tens of seconds for a few hundred thousand
    # events), which only the device rows below would read.
    # Kernels, copies and memsets only: the model's ``record_function``
    # scopes also appear on the device's timeline (user annotations
    # spanning the kernels they enclose) and would count twice.
    device = {}
    for evt in prof.profiler.kineto_results.events():
        if (evt.device_type() == torch.autograd.DeviceType.CUDA
                and not evt.is_user_annotation()):
            n, ms = device.get(evt.name(), (0, 0.0))
            device[evt.name()] = (n + 1, ms + evt.duration_ns() / 1e6)
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

    b, prompt_len, new = 8, 128, 128
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


# The tokens the engine phases counted into the port's default registry,
# by kind, each from the engine's own requests (prompt lengths and
# generated tokens): what phase 32's ``/api/goodput`` serving branch must
# show.
SERVING_TOKENS = {}


def phase_engine(cfg, params, phase="engine", gated=True, shared=False):
    """The flat engine: 8 slots, 16 greedy requests. Every request must
    complete; the teacher-forced gap is held to ARGMAX_GAP when
    ``gated``, else reported. With ``shared`` the engine counts into the
    port's default registry (as a served model does, for the master's
    dashboard) and its requests' tokens are added to SERVING_TOKENS;
    else into a registry of its own. Returns the decode-attention and
    grouped FFN launches counted up to the engine's last step, before
    the teacher-forced checks (whose forward launches B7 on a MoE
    model), and each request's (prompt, tokens, max_new_tokens)."""
    from dlrover_tpu_torch.observability.registry import (
        MetricsRegistry,
        default_registry,
    )
    from dlrover_tpu_torch.ops import decode_attention as da
    from dlrover_tpu_torch.ops import moe_dispatch as md
    from dlrover_tpu_torch.serving import ServingEngine

    rs = np.random.RandomState(SEED + 2)
    prompts = [rs.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in rs.randint(16, 301, size=16)]
    news = [int(n) for n in rs.randint(16, 65, size=16)]
    reg = default_registry() if shared else MetricsRegistry()
    eng = ServingEngine(cfg, params, slots=8, max_len=1024,
                        prefill_chunk=64, registry=reg)
    # What the registry held before this engine (a shared one may have).
    base = {name: reg.get(name).value() for name in (
        "serving_step_errors_total", "serving_iterations_total")}
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
    errors = (reg.get("serving_step_errors_total").value()
              - base["serving_step_errors_total"])
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
    if shared:
        # No request was requeued: each prompt token was prefilled once
        # and each token generated once.
        for kind, n in (("prefill", sum(len(p) for p in prompts)),
                        ("decode", gen_tokens)):
            SERVING_TOKENS[kind] = SERVING_TOKENS.get(kind, 0) + n
    row = {
        "phase": phase, "requests": len(reqs), "slots": 8,
        "max_len": 1024, "prefill_chunk": 64,
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "new_tokens": gen_tokens, "wall_s": wall,
        "decode_tok_s": gen_tokens / wall,
        "total_tok_s": (gen_tokens + sum(len(p) for p in prompts)) / wall,
        "ttft_p50_s": float(np.median(ttfts)),
        "ttft_max_s": ttfts[-1],
        "iterations": (reg.get("serving_iterations_total").value()
                       - base["serving_iterations_total"]),
        "step_errors": errors, "argmax_gap_max": worst,
        "argmax_gap_gated": gated,
        "argmax_agree": float(np.mean(agree)),
        "launches": launches,
    }
    emit(row)
    return launches, [(p, r.tokens, n) for p, r, n in zip(prompts, reqs, news)]


# Phase 11's requests (cut from 32 for the script's time limit, PR 23):
# more than its 16 slots, so the ones that wait can hit the prefix cache.
PAGED_REQUESTS = 24


def _paged_workload(cfg, n_requests=PAGED_REQUESTS, prefix_share=0.6,
                    prefix_len=48):
    """``n_requests`` greedy requests, all submitted at once (the first
    requests of a longer workload from the same seed): prompts of 16-300
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
    # the 24 requests all are admitted before any prompt is cached, and
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


# The spec phases' requests: the first SPEC_REQUESTS of an engine
# phase's 16 (cut from 16 for the script's time limit).
SPEC_REQUESTS = 8


def _spec_work(served):
    """Greedy requests with repetitive prompts built from an engine
    phase's own output (its first SPEC_REQUESTS): ``p + greedy(p) + p``
    and the same token budget. After the second ``p`` the n-gram drafter
    proposes ``greedy(p)``."""
    return [(np.concatenate([p, np.asarray(toks, np.int32), p]), n)
            for p, toks, n in served[:SPEC_REQUESTS]]


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
    slots, max_len 1024, chunk 64) over the first 8 of phase 5's requests with
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
    the first 8 of the MoE engine phase's requests with prompts ``p + greedy(p) +
    p``, spec off and n-gram K = 3; the teacher-forced gap is reported,
    as the MoE engine phase's. Returns the launches by kernel."""
    return _spec_runs(
        cfg, params, _spec_work(served), "moe_paged_engine", "fp", False,
        dict(slots=16, num_blocks=513, **PAGED_KW),
        [("off", {}), ("ngram", _NGRAM)])


# ---- migration and the serving fleet ------------------------------------


FP_BLOCKS, INT8_BLOCKS = 513, 993   # phase 11's pools (equal bytes)
MIGRATE_LATE_STEPS = 3              # a quarter exported after 3 decode steps
# Phase 11c's requests: phase 11's (cut from 32 for the script's time
# limit, PR 22); more than the destination's 16 slots, so ready requests
# still wait for room there.
MIGRATE_REQUESTS = PAGED_REQUESTS


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
    """Phase 11c's requests through two paged engines: each request is
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
    the first MIGRATE_REQUESTS of phase 11's requests (see
    ``_migrate_run``), then the int8 one-at-a-time equality. ``unmigrated`` {kv: tokens} are phase 11's
    runs of the same requests. Returns the B6 launches by kernel."""
    work = _paged_workload(cfg)[:MIGRATE_REQUESTS]
    out = {"paged_decode_attention_fp": 0, "paged_decode_attention_int8": 0}
    for kv in ("fp", "int8"):
        _, n = _migrate_run(cfg, params, work, kv, unmigrated[kv])
        out[f"paged_decode_attention_{kv}"] += n
    out["paged_decode_attention_int8"] += _migrate_one_at_a_time(
        cfg, params, work)
    return out


# Phase 11d's requests (cut from the reference schedule's 32 for the
# script's time limit; phase 11e keeps 32).
FLEET_DISAGG_REQUESTS = 16


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

    work = fleet_workload(n_requests=FLEET_DISAGG_REQUESTS,
                          vocab=cfg.vocab_size)
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


# phase 11f: the fleet episodes of the seeded chaos soak, and their
# watchdog (each replica start pays `import torch` and a CUDA context).
FLEET_SOAK_EPISODES = {4: "replica_kill_reroute", 6: "kill_during_migration"}
FLEET_SOAK_WATCHDOG_S = 240.0
SOAK_PROCESS_TIMEOUT_S = 420.0


_CHILDREN = []


def _child(proc):
    """Registers a process that runs beside the phases: one still
    running when this script exits (a phase failed meanwhile) is
    killed."""
    _CHILDREN.append(proc)
    return proc


@atexit.register
def _kill_children():
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


class _ChildRun:
    """``python <argv>`` in a process of its own, from the repo's root
    with the repo on its path, started at once; its stderr goes to
    ``log`` (a path) or to this process's. ``result()`` waits, prints
    the lines of its stdout but the last, and returns the last one's
    JSON; the phase fails if the process exited non-zero."""

    def __init__(self, label, argv, log=None):
        repo = os.path.dirname(os.path.abspath(__file__))
        self.label = label
        self.log = open(log, "w") if log else None
        self.t0 = time.monotonic()
        self.proc = _child(subprocess.Popen(
            [sys.executable, *argv], cwd=repo,
            env=dict(os.environ, PYTHONPATH=repo), stdout=subprocess.PIPE,
            stderr=self.log, text=True))

    def result(self, timeout):
        try:
            out, _ = self.proc.communicate(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            if self.log:
                self.log.close()
        self.wall_s = time.monotonic() - self.t0
        lines = out.splitlines()
        for ln in lines[:-1]:
            print(ln, flush=True)
        check(self.proc.returncode == 0 and lines,
              f"{self.label}: exit {self.proc.returncode}")
        return json.loads(lines[-1])


def _interpreter_call(name, *args):
    """``chip_smoke.<name>(*args)`` in a fresh interpreter: its
    ``result()`` is what that returned."""
    code = ("import json, sys; import chip_smoke as cs; "
            f"out = cs.{name}(*json.loads(sys.argv[1])); "
            "print(json.dumps(out), flush=True)")
    return _ChildRun(name, ["-c", code, json.dumps(args)])


def _soak_episode(episode, work, *args):
    """``tools/torch_chaos_soak.py`` running one episode of seed SEED in a
    process of its own (the soak's entry point; the fault registry and
    the tracer it arms are process-wide, so two episodes cannot share
    one process), its stderr in ``work/episode<N>.log``."""
    run_dir = os.path.join(work, f"episode{episode}")
    os.makedirs(run_dir)
    return _ChildRun(
        f"soak episode {episode}",
        [os.path.join("tools", "torch_chaos_soak.py"), "--seed", str(SEED),
         "--episode", str(episode), "--work-dir", run_dir, *args],
        log=os.path.join(work, f"episode{episode}.log"))


def _soak_report(run):
    """Waits for a ``_soak_episode``: its episode's report."""
    summary = run.result(SOAK_PROCESS_TIMEOUT_S)
    check(summary["invariants"] == "pass" and summary["episodes"] == 1,
          f"{run.label}: {summary}")
    return summary["reports"][0]


def start_fleet_soak(device="cuda", config="flagship"):
    """Starts phase ``fleet_soak``'s two episodes (they run beside the
    autoscaler's episode); ``finish_fleet_soak`` gates them."""
    import tempfile

    work = tempfile.mkdtemp(prefix="fleet_soak_")
    runs = [_soak_episode(episode, work, "--device", device,
                          "--fleet-config", config,
                          "--watchdog-s", str(FLEET_SOAK_WATCHDOG_S))
            for episode in FLEET_SOAK_EPISODES]
    return work, runs, device, config, time.monotonic()


def finish_fleet_soak(started):
    """Waits for ``start_fleet_soak``'s episodes: the soak's fleet
    episodes (``tools/torch_chaos_soak.py --episode 4`` and ``--episode
    6``, seed SEED, ``--fleet-config config``), each in a process of its
    own, both at once. ``testing/fleet_soak`` runs two paged
    ``SubprocessReplica``s serving ``config`` (the flagship at full width
    and depth) on ``device`` under a ``FleetRouter``. In episode 4 a
    replica is SIGKILLed mid-decode at its seeded step; in episode 6, the
    decode replica of a prefill/decode pair holding an unacked KV import.
    Gates: the harness's invariants (the tool exits non-zero otherwise:
    every request terminal once, the victim BROKEN, probed HALF_OPEN and
    HEALTHY again, restarted, trace trees, block reclaim); completed +
    failed == requests and a restart; the planned crash fired
    (``fleet.replica.step``, ``fleet.replica.import``); in episode 6 a
    migration and a migration failure; block conservation on every
    replica's last heartbeat; every replica generation's ready line
    names ``device``; on the card, B6 (fp) launched in the replicas
    (their heartbeats count it, from zero in each process). On a failure
    the tail of every replica and episode log goes to stderr
    (``_soak_work_dir``). Returns the replicas' decode-kernel launches,
    summed."""
    work, runs, device, config, t0 = started
    launches = {}
    episodes = []
    with _soak_work_dir(None, work=work):
        reports = [(_soak_report(run), run.wall_s) for run in runs]
    for (rep, wall), (episode, kind) in zip(reports,
                                            FLEET_SOAK_EPISODES.items()):
        label = f"fleet_soak/{kind}"
        check(rep["kind"] == kind, f"{label}: ran {rep['kind']}")
        check(rep["completed"] + rep["failed"] == rep["requests"]
              and rep["restarts"] >= 1,
              f"{label}: {rep['completed']} completed, {rep['failed']} "
              f"failed of {rep['requests']}, {rep['restarts']} restarts")
        point = ("fleet.replica.step" if episode == 4
                 else "fleet.replica.import")
        check(any(f["point"] == point and f["action"] == "crash"
                  for f in rep["faults"]),
              f"{label}: faults fired {rep['faults']}")
        if episode == 6:
            check(rep["migrations"] >= 1 and rep["migration_failures"] >= 1,
                  f"{label}: {rep['migrations']} migrations, "
                  f"{rep['migration_failures']} failures")
        for rid, kv in rep["kv_blocks"].items():
            check(kv["free"] + kv["used"] + kv["cached"] == kv["total"],
                  f"{label}: replica {rid}'s last heartbeat {kv}")
        starts = rep["replica_starts"]
        check(all(gens and all(g["device"].startswith(device) for g in gens)
                  for gens in starts.values())
              and len(starts[rep["victim"]]) >= 2,
              f"{label}: replica starts {starts}")
        check(rep["victim_recovery_s"] is not None,
              f"{label}: the victim was never re-admitted")
        if device == "cuda":
            check(rep["launches"].get("paged_decode_attention_fp", 0) > 0,
                  f"{label}: the replicas launched no B6: {rep['launches']}")
        for name, n in rep["launches"].items():
            launches[name] = launches.get(name, 0) + n
        episodes.append({
            "episode": episode, "kind": kind, "wall_s": wall,
            "harness_wall_s": rep["wall_s"], "victim": rep["victim"],
            "requests": rep["requests"], "completed": rep["completed"],
            "failed": rep["failed"], "restarts": rep["restarts"],
            "reroutes": rep.get("reroutes"),
            "migrations": rep.get("migrations"),
            "migration_failures": rep.get("migration_failures"),
            "victim_recovery_s": rep["victim_recovery_s"],
            "replica_start_s": {rid: [round(g["start_s"], 3) for g in gens]
                                for rid, gens in starts.items()},
            "kv_blocks": rep["kv_blocks"], "launches": rep["launches"],
            "faults": [(f["point"], f["action"], f["hit"])
                       for f in rep["faults"]]})
    emit({"phase": "fleet_soak", "device": device, "config": config,
          "wall_s": time.monotonic() - t0, "episodes": episodes,
          "launches": launches})
    return launches


def start_autoscale_soak(device="cuda"):
    """Starts phase ``autoscale_soak``'s episode in a process of its own
    (it runs beside the fleet episodes); ``finish_autoscale_soak`` gates
    it."""
    import tempfile

    work = tempfile.mkdtemp(prefix="autoscale_soak_")
    return work, _soak_episode(5, work, "--device", device)


def finish_autoscale_soak(started):
    """The soak's ``straggler_evict`` episode (``tools/torch_chaos_soak.py
    --episode 5``, seed SEED) through ``testing/autoscale_soak``: one
    seeded straggler-and-crash schedule run static, dry-run and
    autoscaled. Like the reference's, this harness simulates its cluster
    on the host (the sim scaler, the task manager, the perf monitor,
    wall-clock sleeps as steps) and launches nothing on the card; its
    process holds no CUDA context. Gates: the harness's invariants (the
    tool exits non-zero otherwise); the autoscaled run's goodput above
    the static run's; the straggler evicted within
    ``mitigate_window_bound`` decision windows; the dry run's leading
    decision the live one's with zero actuations; the recording's replay
    identical to the live ledger and the perturbed replay different."""
    from dlrover_tpu_torch.testing.autoscale_soak import AutoscaleSoakConfig

    work, run = started
    with _soak_work_dir(None, work=work):
        rep = _soak_report(run)
    bound = AutoscaleSoakConfig().mitigate_window_bound
    label = "autoscale_soak"
    check(rep["kind"] == "straggler_evict" and rep["invariants"] == "pass",
          f"{label}: {rep['kind']} {rep['invariants']}")
    check(rep["autoscale_goodput_frac"] > rep["static_goodput_frac"],
          f"{label}: goodput {rep['autoscale_goodput_frac']} autoscaled, "
          f"{rep['static_goodput_frac']} static")
    check(rep["autoscale_time_to_mitigate_s"] is not None
          and rep["autoscale_mitigate_windows"] <= bound,
          f"{label}: mitigated after {rep['autoscale_mitigate_windows']} "
          f"windows (bound {bound})")
    check(rep["dry_run_actuations_total"] == 0
          and rep["dry_run_decisions_total"] > 0,
          f"{label}: dry run {rep['dry_run_decisions_total']} decisions, "
          f"{rep['dry_run_actuations_total']} actuations")
    check(rep["whatif_identity_ok"] is True
          and rep["whatif_perturbed_decisions"]
          != rep["whatif_recorded_decisions"],
          f"{label}: replay identity {rep['whatif_identity_ok']}, "
          f"{rep['whatif_recorded_decisions']} recorded and "
          f"{rep['whatif_perturbed_decisions']} perturbed decisions")
    row = {"phase": label, "wall_s": run.wall_s, "launches_on_card": 0}
    row.update({k: rep[k] for k in (
        "ab_wall_s", "goodput_causes",
        "static_goodput_frac", "autoscale_goodput_frac",
        "autoscale_time_to_mitigate_s", "autoscale_mitigate_windows",
        "autoscale_decisions_total", "autoscale_actuations_total",
        "autoscale_ckpt_retunes", "autoscale_fleet_grow_events",
        "goodput_attributed_frac", "whatif_recorded_decisions",
        "whatif_perturbed_decisions", "whatif_replay_snapshots_per_s",
        "deaths")})
    emit(row)
    return row


def phase_soak_episodes(device="cuda", config="flagship"):
    """Phases ``fleet_soak`` and ``autoscale_soak`` at once, beside no
    other phase: the autoscaler's episode (a simulated cluster on the
    host) runs while the fleet episodes' harnesses wait on their replica
    processes, which decode on the card. Each keeps its gates and
    prints its own row with its wall. Returns the replicas' decode-kernel
    launches."""
    autoscale = start_autoscale_soak(device)
    launches = finish_fleet_soak(start_fleet_soak(device, config))
    finish_autoscale_soak(autoscale)
    return launches


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


# The model's scopes (``record_function`` ranges, the reference's
# ``jax.named_scope`` names) and the buckets of the JAX bench's
# mfu_breakdown.
SCOPE_BUCKETS = {"attn": ("attn",), "mlp": ("mlp",),
                 "vocab": ("vocab", "lm_head"), "optimizer": ("optimizer",)}
# B1/B2's kernels as the profiler names them, by their wrappers' counts.
FLASH_KERNELS = {"flash_forward": "flash_fwd_kernel",
                 "flash_backward_dq": "flash_dq_kernel",
                 "flash_backward_dkv": "flash_dkv_kernel"}
# The GEMM sweep (tpu_timer/analysis.matmul_analysis): square bf16 sizes.
MATMUL_SIZES = (2048, 4096, 8192)


def _scope_profile(cfg, fn):
    """One flagship step under the port's per-op profile
    (``xla_capture.capture_op_profile``, one window on this thread).
    Gates: every B1/B2 launch of the step is a device row bucketed under
    ``attn``, ``n_layers x TRAIN_GA`` of each kernel; the scope shares
    sum to 1. Emits the kernel breakdown and the shares."""
    from dlrover_tpu_torch.tpu_timer import xla_capture as xc

    box = {}

    def window():
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        box["wall"] = time.monotonic() - t0

    t0 = time.monotonic()
    rows = xc.capture_op_profile(fn=window)
    capture_s = time.monotonic() - t0
    device = {}
    for r in rows:
        n, ms = device.get(r["name"], (0, 0.0))
        device[r["name"]] = (n + 1, ms + r["dur_us"] / 1e3)
    emit(_profile_row("train/step", box["wall"], device, kernel="flash",
                      match="flash_", top_n=10))
    shares = xc.bucket_by_scope(rows, SCOPE_BUCKETS)
    flash = {}
    for wrapper, kernel in FLASH_KERNELS.items():
        mine = [r for r in rows if xc.base_name(r["name"]) == kernel]
        flash[wrapper] = {
            "rows": len(mine),
            "outside_attn": [r["scope"] for r in mine
                             if xc.bucket_by_scope([r], SCOPE_BUCKETS)
                             .get("attn") != 1.0][:4]}
    emit({"phase": "scope_profile", "run": "train/step",
          "device_rows": len(rows), "capture_s": capture_s,
          "step_wall_s": box["wall"], "shares": shares,
          "shares_sum": sum(shares.values()), "flash": flash})
    want = cfg.n_layers * TRAIN_GA
    for wrapper, got in flash.items():
        check(got["rows"] == want and not got["outside_attn"],
              f"scope_profile: {wrapper} has {got['rows']} rows (want "
              f"{want}), outside attn under {got['outside_attn']}")
    check(set(shares) == set(SCOPE_BUCKETS) | {"other"}
          and abs(sum(shares.values()) - 1.0) <= 1e-6,
          f"scope_profile: shares {shares}")


def _matmul_sweep():
    """``tpu_timer/analysis.matmul_analysis`` at MATMUL_SIZES: TFLOP/s of
    each, gated at no more than 105% of the card's bf16 dense peak."""
    from dlrover_tpu_torch.tpu_timer import analysis

    rows = analysis.matmul_analysis(list(MATMUL_SIZES), iters=50)
    peak = PEAK_OPS_PER_S["bfloat16"] / 1e12
    emit({"phase": "matmul_analysis", "peak_tflops": peak, "rows": rows})
    for row in rows:
        check(0 < row["tflops"] <= 1.05 * peak,
              f"matmul_analysis: {row['size']}: {row['tflops']} TFLOP/s "
              f"against a {peak} TFLOP/s peak")


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
            # Where a step's time goes, by kernel and by the model's
            # scopes (profiling adds host time per op, so the busy share
            # is a lower bound).
            _scope_profile(cfg, lambda: float(
                step(state, {"tokens": tokens})[1]["loss"]))
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
    _matmul_sweep()
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


# phase 13's new tokens a run (cut from 128 for the script's time
# limit; greedy, so they are the first 64 of a 128-token run).
MOE_GEN_NEW = 64


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
    """MoE ``generate()``: b=8, prompt 128, MOE_GEN_NEW new greedy
    tokens, fp cache, twice (the second timed), after a prefill-alone
    run. Checks: the two runs agree bit for bit; exact launches per run
    (B7 once a layer per forward: the prefill and MOE_GEN_NEW - 1
    single-token steps; B5 once a
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

    b, prompt_len, new = 8, 128, MOE_GEN_NEW
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
# a lost host) once step ELASTIC_KILL2 is in shm and the tracker shows at
# least ELASTIC_STORAGE_STEP. The flagship runs cut to ELASTIC_LAYERS
# layers, for the script's time limit: from 16 layers and 16 steps
# (persist every 5, kills after 9 and 13) to 8 layers and these steps,
# then to 4 layers once the port's launcher, master and agent ran it
# (their process starts and the agent's breakpoint saves took the phase
# past 160 s at 8).
ELASTIC_STEPS, ELASTIC_PERSIST = 10, 3
ELASTIC_KILL1, ELASTIC_KILL2, ELASTIC_STORAGE_STEP = 5, 8, 6
ELASTIC_LAYERS = 4
ELASTIC_TIMEOUT_S = 300.0
# The workers' hang watchdog floor (DLROVER_TPU_HANG_DEADLINE_S): above
# any step's wall there (1.15 s at most on the H100 with the phase alone,
# 3.39 s beside phase 28), so only a held worker's silence passes it.
ELASTIC_HANG_DEADLINE_S = 10.0


def _proc_gone(pid):
    """True once ``pid`` has exited (no such process, or a zombie)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


_STANDALONE_LAUNCH = (
    "--standalone", "--nnodes", "1", "--nproc_per_node", "1",
    "--max_restarts", "2", "--monitor_interval", "0.2",
    "-m", "dlrover_tpu_torch.examples.train_llama")


class _Launcher:
    """One ``python -m dlrover_tpu_torch.run`` launcher: by default a
    ``--standalone`` job running the elastic worker
    (``dlrover_tpu_torch.examples.train_llama``) under the port's local
    master and agent; ``launch`` gives other launcher flags and worker
    module. A thread reads the workers' JSON lines off the launcher's
    stdout (the agent's workers inherit it) into ``events``; the
    launcher's, master's and workers' logs go to ``log_path``."""

    def __init__(self, args, env, log_path, launch=_STANDALONE_LAUNCH,
                 phase="elastic_ckpt"):
        import threading

        self.spawned = time.monotonic()
        self.log_path = log_path
        self.phase = phase
        self._log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dlrover_tpu_torch.run", *launch, *args],
            env=env, stdout=subprocess.PIPE, stderr=self._log, text=True)
        self.events = []
        self._cond = threading.Condition()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        inc = -1
        for line in self.proc.stdout:
            if line.startswith("{"):
                event = json.loads(line)
                event["t"] = time.monotonic()
                # The incarnation: each opens with its ready line.
                inc += event["event"] == "ready"
                event["inc"] = inc
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
                check(not exited, f"{self.phase}: the launcher exited (rc "
                      f"{self.proc.poll()}) before {what}; see "
                      f"{self.log_path}")
                left = deadline - time.monotonic()
                check(left > 0, f"{self.phase}: no {what} in {timeout} s")
                self._cond.wait(min(left, 1.0))

    def incarnations(self):
        """The workers' events, one list per incarnation."""
        out = []
        with self._cond:
            for e in self.events:
                if e["event"] != "exit" and e["inc"] >= 0:
                    while len(out) <= e["inc"]:
                        out.append([])
                    out[e["inc"]].append(e)
        return out

    def log(self):
        """The log's text (kept once the job is stopped)."""
        if self._log.closed:
            return self._text
        self._log.flush()
        with open(self.log_path) as f:
            return f.read()

    def pids(self):
        """(the master's pid, the workers' pids in the order the agent
        started them), from the launcher's and agent's log lines."""
        import re

        text = self.log()
        master = re.findall(r"local master pid=(\d+)", text)
        workers = re.findall(r"started worker local_rank=0 pid=(\d+)", text)
        return (int(master[0]) if master else None,
                [int(p) for p in workers])

    def stop(self):
        """End the job if it is still running (SIGTERM: the launcher
        stops its workers and its master), then SIGKILL what is left.
        Idempotent."""
        if self._log.closed:
            return
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=60)
        master, workers = self.pids()
        for pid in [p for p in [master, *workers] if p is not None]:
            if not _proc_gone(pid):
                os.kill(pid, signal.SIGKILL)
        self._reader.join(timeout=10)
        self._text = self.log()
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
    seed 0, under the port's launcher: ``python -m dlrover_tpu_torch.run
    --standalone --nproc_per_node 1 --max_restarts 2 -m
    dlrover_tpu_torch.examples.train_llama ...`` starts the local master
    (HTTP), the agent and its ``AsyncCheckpointSaver``, and the agent
    starts and restarts the worker. This process sets only the job's
    name and socket directory (and run B's fault schedule file). Run A
    trains ELASTIC_STEPS steps, beside run B (both at once: a cut for
    the script's time limit). Run B's worker is SIGKILLed once step
    ELASTIC_KILL1 is in shm: the agent restarts it, and it must restore
    that step from memory. Once step ELASTIC_KILL2 is in shm and the
    tracker shows ELASTIC_STORAGE_STEP or later, it is SIGKILLed again
    and its segment unlinked (a lost host): the agent's relaunch must
    restore from storage the step the tracker held when it read it,
    which is the tracker's step at the kill or, when the agent's
    breakpoint save of the segment won the race with the unlink, the
    segment's step ELASTIC_KILL2; then it replays to the end. The fault
    schedule holds each doomed worker at the step after its kill step
    (a ``delay`` at ``agent.worker.crash``; the file is rewritten before
    each kill, since every incarnation gets the same env), and this
    process holds the agent's shm lock over each kill, so no write is in
    flight. Gates: both launchers exit 0 and their masters have exited;
    run B's incarnations show restart counts 0, 1, 2 and are the
    processes the agent started; run B's final params, moments and step
    (the last shm image, read after the launcher exits and then
    unlinked) equal run A's bit for bit, and a moment with one element
    flipped does not; every loss of run B equals run A's at its step;
    each incarnation launched B1, B2 dq and B2 dk/dv n_layers x ga
    times a step it ran (none on the CPU); no segment or socket is
    left. The workers' hang watchdog runs with a floor of
    ELASTIC_HANG_DEADLINE_S: each held incarnation of run B writes one
    hang dump (the watchdog fires once in the hang) whose main thread's
    stack names the fault point's frame, then, on this process's
    SIGUSR1, one on-demand flight-recorder dump whose last step is its
    kill step and whose meta carries its restart count; the master's log
    shows each hang dump received through the agent's report; run A,
    never held, writes no hang dump."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.common.constants import NodeEnv
    from dlrover_tpu_torch.fault import SCHEDULE_ENV, FaultRule, FaultSchedule
    from dlrover_tpu_torch.flash_ckpt import storage as ckpt_storage
    from dlrover_tpu_torch.flash_ckpt.engine import (
        CKPT_LOCK_PREFIX,
        shm_segment_name,
    )
    from dlrover_tpu_torch.flash_ckpt.saver import read_shm_payload
    from dlrover_tpu_torch.flash_ckpt.shared_obj import SharedLockClient
    from dlrover_tpu_torch.flash_ckpt.shm_handler import SharedMemoryHandler
    from dlrover_tpu_torch.models import llama

    cfg = (llama.flagship_config(n_layers=ELASTIC_LAYERS)
           if config == "flagship" else llama.tiny_config(n_layers=4))
    ga = 2
    # The agent's native stacks ptrace the held workers: first what the
    # host allows (1: only a tracer with CAP_SYS_PTRACE, or an ancestor).
    try:
        with open("/proc/sys/kernel/yama/ptrace_scope") as f:
            ptrace_scope = f.read().strip()
    except OSError:
        ptrace_scope = "absent"
    emit({"phase": "elastic_ckpt", "ptrace_scope": ptrace_scope})
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
    launchers, shm_used, kills = [], [], []
    flight_dirs = {r: os.path.join(root, f"{r}_flight") for r in "AB"}
    held = []  # per held incarnation: its hang and on-demand dumps

    def read_dump(path, pid, after=0.0):
        try:
            with open(path) as f:
                dump = json.load(f)
        except (OSError, ValueError):
            return None
        if dump.get("pid") != pid or dump.get("dumped_at", 0.0) <= after:
            return None
        return dump

    def post_mortem(launcher, i):
        """The held incarnation ``i``: wait (bounded) for its hang
        watchdog's stack dump, then SIGUSR1 it for its flight
        recorder's on-demand dump."""
        from dlrover_tpu_torch.observability import (
            flight_recorder,
            hang_watchdog,
        )

        pid = launcher.wait_event(lambda e: e["event"] == "ready"
                                  and e["inc"] == i, "a ready line")["pid"]
        with _process_env({flight_recorder.FLIGHT_DIR_ENV:
                           flight_dirs["B"]}):
            hang_path = hang_watchdog.hang_dump_path(0, 0)
            demand_path = (os.path.splitext(flight_recorder.dump_path(
                0, 0))[0] + ".ondemand.json")
        t0 = time.monotonic()
        # The watchdog's deadline is its floor or 8 x the mean step gap,
        # whichever is larger, then up to a 5 s poll.
        deadline = t0 + ELASTIC_TIMEOUT_S / 2
        while (hang := read_dump(hang_path, pid)) is None:
            check(time.monotonic() < deadline, f"elastic_ckpt: incarnation "
                  f"{i} (pid {pid}) wrote no hang dump")
            time.sleep(0.05)
        t_hang = time.monotonic()
        signalled = time.time()
        os.kill(pid, signal.SIGUSR1)
        while (demand := read_dump(demand_path, pid, signalled)) is None:
            check(time.monotonic() < deadline, f"elastic_ckpt: incarnation "
                  f"{i} (pid {pid}) wrote no on-demand dump")
            time.sleep(0.02)
        t_demand = time.monotonic()
        # The agent saw the hang dump and appends the worker's native
        # stacks to its log (the launcher's stderr here) within the
        # reference's 12 s bound.
        sampled = re.compile(rf"native stacks of worker pid {pid}: (\d+) "
                             r"threads in ([0-9.]+) s")
        while not (found := sampled.findall(launcher.log())):
            check(time.monotonic() < t_hang + 20, f"elastic_ckpt: no native "
                  f"stacks of incarnation {i} (pid {pid}); ptrace_scope "
                  f"{ptrace_scope}")
            time.sleep(0.05)
        frames = re.search(rf"Native thread {pid} \(most recent call "
                           r"first\):\n((?:  #\d+ .*\n)+)", launcher.log())
        held.append({"inc": i, "pid": pid, "hang": hang, "on_demand": demand,
                     "hang_wait_s": t_hang - t0,
                     "on_demand_s": t_demand - t_hang,
                     "native_threads": int(found[0][0]),
                     "native_s": float(found[0][1]),
                     "native_wait_s": time.monotonic() - t_hang,
                     "native_main_thread": frames.group(1).splitlines()[:6]
                     if frames else [],
                     "hang_path": hang_path})

    def fired_once(entry):
        """The killed incarnation's hang dump is still its first: the
        watchdog fired once in the hang."""
        again = read_dump(entry["hang_path"], entry["pid"])
        entry["fired_once"] = (again is not None and again["dumped_at"]
                               == entry["hang"]["dumped_at"])

    def hold(path, step):
        """The schedule file every incarnation reads: hold at ``step``
        (None: no rule)."""
        rules = [] if step is None else [FaultRule(
            "agent.worker.crash", action="delay", delay_s=ELASTIC_TIMEOUT_S,
            match={"step": step})]
        with open(path, "w") as f:
            f.write(FaultSchedule(rules).to_json())

    def run(label, plan):
        """One launcher job. ``plan``: (the step the next incarnation is
        held after, or None; how the current one is killed) per kill.
        Returns the launcher, its wall seconds, the final shm image,
        seconds from each SIGKILL to the next incarnation's first step,
        the segment's bytes and the tracker's step at each kill."""
        job = f"chipsmoke{os.getpid()}{label}"
        ckpt_dir = os.path.join(root, label, "ckpt")
        sock_dir = os.path.join(root, label, "sock")
        events_dir = os.path.join(root, label, "events")
        os.makedirs(sock_dir)
        # This process's own view of the job (the agent's shm lock and
        # segment); the launcher gets the same two names.
        view = {NodeEnv.JOB_NAME: job, NodeEnv.NODE_RANK: "0",
                NodeEnv.SHARED_DIR: sock_dir}
        with _process_env(view):
            env = dict(os.environ, PYTHONPATH=repo,
                       DLROVER_TPU_EVENT_DIR=events_dir,
                       DLROVER_TPU_FLIGHT_DIR=flight_dirs[label],
                       DLROVER_TPU_HANG_DEADLINE_S=str(
                           ELASTIC_HANG_DEADLINE_S))
            lock = SharedLockClient(f"{CKPT_LOCK_PREFIX}_0")
            segment = SharedMemoryHandler(shm_segment_name(0))
        env.pop(SCHEDULE_ENV, None)
        if plan:
            schedule = os.path.join(root, f"{label}_hold.json")
            hold(schedule, ELASTIC_KILL1 + 1)
            env[SCHEDULE_ENV] = schedule
        kill_to_step = []
        t0 = time.monotonic()
        launcher = _Launcher(args + ["--ckpt-dir", ckpt_dir], env,
                             os.path.join(root, f"{label}_launcher.log"))
        launchers.append(launcher)
        try:
            for i, (next_hold, kill) in enumerate(plan):
                # Incarnation i read the file when it started; the next
                # one reads what is there after the kill.
                kill(launcher, i, lock, segment, ckpt_dir,
                     lambda step=next_hold: hold(schedule, step))
                t_kill = time.monotonic()
                shm_used.append(shutil.disk_usage("/dev/shm").used)
                first = launcher.wait_event(
                    lambda e, n=i + 1: e["event"] == "step"
                    and e["inc"] == n, "a replayed step")
                kill_to_step.append(first["t"] - t_kill)
            launcher.wait_event(lambda e: e["event"] == "done", "the end")
            rc = launcher.proc.wait(timeout=ELASTIC_TIMEOUT_S)
            check(rc == 0, f"{label}: launcher rc {rc}; see "
                  f"{launcher.log_path}")
            wall = time.monotonic() - t0
            master_pid, _ = launcher.pids()
            check(master_pid is not None and _proc_gone(master_pid),
                  f"{label}: the master (pid {master_pid}) has not exited")
            shm_used.append(shutil.disk_usage("/dev/shm").used)
            # The launcher leaves the saver's segment, as the
            # reference's does: read the final image, then unlink it.
            image_bytes = segment.size if segment.attach() else 0
            segment.close()
            with _process_env(view):
                final = read_shm_payload(0)
            check(final is not None and final[0] == ELASTIC_STEPS,
                  f"{label}: final shm image {final and final[0]}")
            # The agent's training events: its rendezvous rounds, and
            # its saver's persists.
            rdzv_s, persists = [], []
            for name in sorted(os.listdir(events_dir)):
                with open(os.path.join(events_dir, name)) as f:
                    for line in f:
                        e = json.loads(line)
                        c = e["content"]
                        if e["type"] != "end":
                            continue
                        if e["name"] == "rendezvous":
                            rdzv_s.append(c["duration_s"])
                        elif e["name"] == "ckpt_persist" and c["committed"]:
                            persists.append({
                                "step": c["committed_step"],
                                "seconds": c["duration_s"],
                                "bytes": c["bytes"],
                                "gb_per_s": c["bytes"] / 1e9 / max(
                                    c["duration_s"], 1e-9)})
        finally:
            launcher.stop()
            SharedMemoryHandler(segment.name).unlink()
            socks = os.listdir(sock_dir)
            shutil.rmtree(os.path.join(root, label), ignore_errors=True)
        left = [n for n in os.listdir("/dev/shm") if job in n]
        check(left == [] and socks == [],
              f"{label}: segments {left} and sockets {socks} left")
        return (launcher, wall, final[1]["arrays"], kill_to_step,
                image_bytes, rdzv_s, persists)

    def kill_worker(launcher, i, lock):
        """SIGKILL incarnation ``i`` under the shm lock; hold the lock
        until the process is gone."""
        pid = launcher.wait_event(lambda e: e["event"] == "ready"
                                  and e["inc"] == i, "a ready line")["pid"]
        lock.acquire()
        try:
            os.kill(pid, signal.SIGKILL)
            deadline = time.monotonic() + 60
            while not _proc_gone(pid):
                check(time.monotonic() < deadline,
                      f"elastic_ckpt: pid {pid} outlived its SIGKILL")
                time.sleep(0.01)
        finally:
            lock.release()

    def in_shm(i, step):
        return lambda e: (e["event"] == "shm" and e["step"] >= step
                          and e["inc"] == i)

    def kill_in_memory(launcher, i, lock, segment, ckpt_dir, rearm):
        """SIGKILL once step ELASTIC_KILL1 is in shm."""
        launcher.wait_event(in_shm(i, ELASTIC_KILL1), "the first kill's step")
        post_mortem(launcher, i)
        rearm()
        kill_worker(launcher, i, lock)
        fired_once(held[-1])
        kills.append(segment.get_step())
        segment.close()

    def kill_host(launcher, i, lock, segment, ckpt_dir, rearm):
        """SIGKILL once step ELASTIC_KILL2 is in shm and the tracker
        shows ELASTIC_STORAGE_STEP or later; unlink the segment."""
        launcher.wait_event(in_shm(i, ELASTIC_KILL2),
                            "the second kill's step")
        deadline = time.monotonic() + ELASTIC_TIMEOUT_S
        while ckpt_storage.read_tracker(ckpt_dir) < ELASTIC_STORAGE_STEP:
            check(time.monotonic() < deadline, "elastic_ckpt: step "
                  f"{ELASTIC_STORAGE_STEP} never committed")
            time.sleep(0.05)
        post_mortem(launcher, i)
        rearm()
        kill_worker(launcher, i, lock)
        fired_once(held[-1])
        kills.append(ckpt_storage.read_tracker(ckpt_dir))
        segment.unlink()

    def run_a():
        try:
            box["A"] = run("A", [])
        except BaseException as e:  # raised again by run B's thread
            box["error"] = e

    box = {}
    thread_a = threading.Thread(target=run_a, daemon=True)
    try:
        # Run A, never killed, is the reference: it runs beside run B.
        thread_a.start()
        b, wall_b, final_b, kill_to_step, _, rdzv_b, persists_b = run(
            "B", [(ELASTIC_KILL2 + 1, kill_in_memory),
                  (None, kill_host)])
        thread_a.join(timeout=2 * ELASTIC_TIMEOUT_S)
        check(not thread_a.is_alive(), "elastic_ckpt: run A did not end")
        if "error" in box:
            raise box["error"]
        a, wall_a, final_a, _, image_bytes, rdzv_a, persists_a = box["A"]
        hang_files_a = [n for n in os.listdir(flight_dirs["A"])
                        if n.startswith("hang_")]
    finally:
        for launcher in launchers:
            launcher.stop()
        if thread_a.ident is not None:
            thread_a.join(timeout=60)
        shutil.rmtree(root, ignore_errors=True)

    label = "elastic_ckpt"
    incs = a.incarnations() + b.incarnations()
    readies = [inc[0] for inc in incs]
    check([r["restart_count"] for r in readies] == [0, 0, 1, 2],
          f"{label}: restart counts {[r['restart_count'] for r in readies]}")
    for launcher in (a, b):
        _, started = launcher.pids()
        pids = [inc[0]["pid"] for inc in launcher.incarnations()]
        check(pids == started and len(set(pids)) == len(pids),
              f"{label}: incarnations {pids}, the agent started {started}")
    got = [(r["restored_from"], r["restored_step"]) for r in readies]
    # The storage restore reads the step the tracker held when the
    # relaunch read it: the tracker's step at the kill, or the segment's
    # ELASTIC_KILL2 when the agent's breakpoint save committed it first.
    storage_step = readies[3]["restore_read"]["tracker_step"]
    check(got == [(None, 0), (None, 0), ("memory", ELASTIC_KILL1),
                  ("storage", storage_step)]
          and readies[2]["restore_read"]["shm_step"] == ELASTIC_KILL1
          and readies[3]["restore_read"]["shm_step"] == -1
          and kills[0] == ELASTIC_KILL1
          and ELASTIC_STORAGE_STEP <= kills[1] <= ELASTIC_KILL2
          and storage_step in (kills[1], ELASTIC_KILL2),
          f"{label}: restores {got} (read {[r['restore_read'] for r in readies]}), "
          f"kills at shm step and tracker {kills}")
    done_a = next(e for e in incs[0] if e["event"] == "done")
    done_b = next(e for e in incs[-1] if e["event"] == "done")
    losses_a = {int(k): v for k, v in done_a["losses"].items()}
    steps = [[e for e in inc if e["event"] == "step"] for inc in incs]
    replayed = [(e["step"], e["loss"]) for inc in steps[1:] for e in inc]
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
    # The watchdog and the dumps: each held incarnation of run B wrote one
    # hang dump naming the fault point's frame, and on SIGUSR1 one
    # on-demand dump whose last step is its kill step; the agent
    # reported each hang dump and the master received it; run A, never
    # held, wrote none.
    check(hang_files_a == [] and [h["inc"] for h in held] == [0, 1],
          f"{label}: run A's hang dumps {hang_files_a}, run B's held "
          f"incarnations {[h['inc'] for h in held]}")
    b_log = b.log()
    watchdog = []
    for h, kill_step in zip(held, (ELASTIC_KILL1, ELASTIC_KILL2)):
        hang, demand = h["hang"], h["on_demand"]
        main_frames = [fr for name, stack in hang["stacks"].items()
                       if name.startswith("MainThread") for fr in stack]
        recorded = [r["step"] for r in demand["steps"] if "step_time_s" in r]
        restart_count = readies[1 + h["inc"]]["restart_count"]
        check(hang["kind"] == "stack_dump" and hang["reason"] == "hang:train"
              and any(fr.endswith(" fault_point") for fr in main_frames)
              and h["fired_once"],
              f"{label}: incarnation {h['inc']}'s hang dump ("
              f"{hang['reason']}, fired once {h['fired_once']}) main "
              f"thread {main_frames[-4:]}")
        check(demand.get("on_demand") is True and demand.get("stacks")
              and recorded and recorded[-1] == kill_step
              and demand["meta"]["restart_count"] == restart_count,
              f"{label}: incarnation {h['inc']}'s on-demand dump: steps "
              f"{recorded[-3:]}, meta {demand['meta']}")
        received = (f"received stack_dump diagnosis data from node 0 (pid "
                    f"{h['pid']}, dumped at {hang['dumped_at']},")
        check(received in b_log, f"{label}: the master did not receive "
                                  f"incarnation {h['inc']}'s hang dump")
        check(h["native_threads"] >= 1 and h["native_s"] <= 12.0
              and h["native_main_thread"],
              f"{label}: incarnation {h['inc']}'s native stacks: "
              f"{h['native_threads']} threads in {h['native_s']} s, main "
              f"thread {h['native_main_thread']}")
        watchdog.append({
            "inc": h["inc"], "pid": h["pid"], "restart_count": restart_count,
            "hang_for_s": hang["hang_for_s"], "deadline_s": hang["deadline_s"],
            "beats": hang["beats"], "hang_wait_s": h["hang_wait_s"],
            "on_demand_s": h["on_demand_s"], "last_step": recorded[-1],
            "main_thread_top": main_frames[-3:],
            "native_threads": h["native_threads"],
            "native_s": h["native_s"], "native_wait_s": h["native_wait_s"],
            "native_main_thread": h["native_main_thread"]})
    launches = {}
    for inc_steps in steps:
        n = len(inc_steps)
        counts = inc_steps[-1]["launches"] if n else {}
        want = cfg.n_layers * ga * n if device == "cuda" else 0
        check(n > 0 and all(v == want for v in counts.values()),
              f"{label}: an incarnation ran {n} steps with launches "
              f"{counts}, want {want} each")
        for name, v in counts.items():
            launches[name] = launches.get(name, 0) + v
    gaps = sorted(y["t"] - x["t"] for inc in steps
                  for x, y in zip(inc, inc[1:]))
    compute = sorted(e["compute_s"] for inc in steps for e in inc[1:])
    saves = [e for inc in incs for e in inc if e["event"] == "shm"]
    block = sorted(e["block_s"] * 1e3 for e in saves)
    drain = sorted(e["drain_s"] * 1e3 for e in saves)
    state_gb = readies[0]["state_bytes"] / 1e9
    steps_b = sum(len(inc) for inc in steps[1:])

    def master_start_s(launcher):
        import re

        found = re.findall(r"local master pid=\d+ serving at \S+ after "
                           r"([0-9.]+) s", launcher.log())
        return float(found[0]) if found else None

    row = {
        "phase": label, "config": config, "n_layers": cfg.n_layers,
        "micro_batch": micro, "seq": seq, "grad_accum": ga,
        "steps": ELASTIC_STEPS, "persist_every": ELASTIC_PERSIST,
        "launcher": "python -m dlrover_tpu_torch.run --standalone "
                    "--nproc_per_node 1 --max_restarts 2",
        "state_gb": state_gb, "image_gb": image_bytes / 1e9,
        "free_gib_before": free_gib, "kills": kills,
        "restores": [{k: r[k] for k in ("restored_from", "restored_step",
                                        "restore_read", "restore_s",
                                        "start_s", "restart_count")}
                     for r in readies],
        "restore_gb_per_s": {r["restored_from"]: state_gb / r["restore_s"]
                             for r in readies[2:]},
        "master_start_s": {"A": master_start_s(a), "B": master_start_s(b)},
        "rdzv_s": {"A": rdzv_a, "B": rdzv_b},
        "launch_to_first_ready_s": {
            "A": incs[0][0]["t"] - a.spawned,
            "B": b.incarnations()[0][0]["t"] - b.spawned},
        "kill_to_first_step_s": kill_to_step,
        "step_gap_s": {"p50": gaps[len(gaps) // 2], "max": gaps[-1]},
        "step_compute_s": {"p50": compute[len(compute) // 2],
                           "max": compute[-1]},
        "save_block_ms": {"p50": block[len(block) // 2], "max": block[-1]},
        "save_drain_ms": {"p50": drain[len(drain) // 2], "max": drain[-1]},
        "saves_committed": len(saves),
        "snapshots_dropped": [max([e["dropped"] for e in inc
                                   if "dropped" in e], default=0)
                              for inc in incs],
        "persists": {"A": persists_a, "B": persists_b},
        "wall_s": {"A": wall_a, "B": wall_b},
        "steps_run_b": steps_b, "steps_redone": steps_b - ELASTIC_STEPS,
        "goodput": wall_a / wall_b,
        "shm_used_gb_max": max(shm_used) / 1e9,
        "ckpt_disk_free_gb_before": disk_free_gb,
        "df_dev_shm": subprocess.run(
            ["df", "-h", "/dev/shm"], capture_output=True,
            text=True).stdout.strip().splitlines()[-1],
        "launcher_rc": [0, 0], "masters_exited": True,
        "restarted_by_agent": True,
        "losses_equal": True, "final_state_bitwise_equal": True,
        "planted_fault_rejected": True, "launches": launches,
        "hang_deadline_floor_s": ELASTIC_HANG_DEADLINE_S,
        "watchdog": watchdog, "hang_dumps_run_a": len(hang_files_a),
        "ptrace_scope": ptrace_scope,
        "master_received_hang_dumps": True,
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


# Phases 17-18's model: the flagship cut to MESH_LAYERS layers (from 16,
# for the script's time limit: the round trip moves 4.01 GB at 16).
MESH_LAYERS = 4


def _config(name):
    from dlrover_tpu_torch.models import llama

    return {"flagship": llama.flagship_config,
            "flagship_mesh": functools.partial(llama.flagship_config,
                                               n_layers=MESH_LAYERS),
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
        procs = {}
        # Both at once (a cut for the script's time limit, PR 19).
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
            procs[label] = (result, time.monotonic(), subprocess.Popen(
                [sys.executable, "-m",
                 "dlrover_tpu_torch.agent.node_check_worker", result,
                 str(size), "30", str(comm_mb)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__))))
        for label, (result, t0, proc) in procs.items():
            try:
                _, stderr = proc.communicate(timeout=300)
            finally:
                proc.kill()
            wall = time.monotonic() - t0
            has_file = os.path.exists(result)
            out[label] = {"rc": proc.returncode, "result_file": has_file,
                          "wall_s": wall}
            if has_file:
                out[label]["elapsed_s"] = float(open(result).read())
            if label == "ok":
                check(proc.returncode == 0 and has_file,
                      f"node_check: rc {proc.returncode}, result file "
                      f"{has_file}: {stderr[-2000:]}")
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


# ---- the mesh case gshard under sp, the checkpoint bridges ----------------

# gshard_sp_body: moe_config's widths at gshard's default capacity factor,
# one micro-batch split into GSHARD_SP chunks of every sequence; expert
# 0's router column scaled by GSHARD_HOT (a hot expert) so that capacity
# binds.
GSHARD_SP, GSHARD_HOT = 4, 2.0
# ckpt_bridges: the flagship at full width cut to this many layers.
BRIDGE_LAYERS = 2


def _gshard_inputs(d, f, e, micro, seq, device):
    gen = torch.Generator(device).manual_seed(SEED + 23)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    router = randn(d, e) / 8
    router[:, 0] *= GSHARD_HOT
    # f32 master weights, cast to bf16 inside the layer as the model's.
    return {
        "x": randn(micro, seq, d).bfloat16(), "router": router,
        "w_gate": randn(e, d, f) / d ** 0.5,
        "w_up": randn(e, d, f) / d ** 0.5,
        "w_down": randn(e, f, d) / f ** 0.5,
        "dy": randn(micro, seq, d).bfloat16(),
    }


def phase_gshard_sp_body(device="cuda", micro=TRAIN_MICRO, seq=TRAIN_SEQ):
    """gshard MoE under sp as an sp rank computes it
    (``models/moe.moe_mlp_chunk``), at ``moe_config``'s widths (d = f =
    1024, 8 experts, top-2) with ``moe_impl="gshard"`` and the default
    capacity factor (640 slots an expert a 2048-token sequence): one
    layer (bf16 activations, f32 master weights cast to bf16 inside, as
    the model's) over a micro-batch of 8 x 2048, each sequence split into
    GSHARD_SP chunks of 512, each chunk run on the card with the
    per-round expert counts of the lower chunks and of the whole
    sequence that the sp group's all-gather delivers (a world of one
    holds no sp > 1: NCCL refuses two ranks on one card), the outputs
    concatenated, forward and backward (``sum(y * dy) + 0.01 (aux +
    0.001 z)``, the model's aux weight). Against the whole-sequence
    ``moe_mlp`` on the card: every token's kept or dropped choice in
    every round equal, ``dropped_fraction`` equal and above 0, out, dx
    and the router and expert gradients each within TRAIN_GATES' per-leaf
    relative L2 distance (a chunk's weight gradients are rounded to bf16
    before the chunks' sum, as each sp rank's are before the sum over
    sp), aux and z within TRAIN_GATES' loss gap, and a rerun bitwise; a
    planted fault (each chunk under its own capacity and offsets) fails
    the decision gate. ``device="cpu"`` with a smaller micro-batch
    rehearses it."""
    from dlrover_tpu_torch.models import moe

    mcfg = moe_config()
    d, f, e, k = mcfg.embed_dim, mcfg.mlp_dim, mcfg.n_experts, mcfg.moe_top_k
    cf = mcfg.capacity_factor
    aux_w = mcfg.moe_aux_weight
    inp = _gshard_inputs(d, f, e, micro, seq, device)
    names = ("x", "router", "w_gate", "w_up", "w_down")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def run(chunked):
        leaves = [inp[n].clone().requires_grad_(True) for n in names]
        t0 = time.monotonic()
        if chunked:
            xs = leaves[0].chunk(GSHARD_SP, dim=1)
            counts = [moe.gshard_counts(c, leaves[1], k) for c in xs]
            totals = torch.stack(counts).sum(dim=0)
            lower = torch.zeros_like(totals)
            ys, stats, kept = [], [], []
            for c, n in zip(xs, counts):
                y, st, kp = moe.moe_mlp_chunk(c, *leaves[1:], lower, totals,
                                              seq, k, cf)
                lower = lower + n
                ys.append(y)
                stats.append(st)
                kept.append(kp)
            y = torch.cat(ys, dim=1)
            kept = torch.cat(kept, dim=2)
            aux, z = moe.router_losses_from_stats(
                torch.stack(stats).mean(dim=0), e)
            dropped = torch.stack([moe.dropped_share(kp) for kp in
                                   kept.chunk(GSHARD_SP, dim=2)]).mean() / k
        else:
            y, m = moe.moe_mlp(*leaves, top_k=k, capacity_factor=cf)
            aux, z, dropped = m.aux_loss, m.router_z_loss, m.dropped_fraction
            kept = None
        loss = ((y.float() * inp["dy"].float()).sum()
                + aux_w * (aux + 0.001 * z))
        grads = torch.autograd.grad(loss, leaves)
        sync()
        return {"y": y.detach(), "grads": grads, "kept": kept,
                "aux": float(aux.detach()), "z": float(z.detach()),
                "dropped": float(dropped), "s": time.monotonic() - t0}

    whole = run(False)
    chunked = run(True)
    rerun = run(True)
    # The whole sequence's decisions, from the chunk body with no
    # offsets; and a planted fault: each chunk under its own capacity
    # and offsets, which the decision gate must reject.
    weights = [inp[n] for n in names[1:]]
    with torch.no_grad():
        counts = moe.gshard_counts(inp["x"], inp["router"], k)
        whole_kept = moe.moe_mlp_chunk(
            inp["x"], *weights, torch.zeros_like(counts), counts, seq, k,
            cf)[2]
        local_kept = []
        for c in inp["x"].chunk(GSHARD_SP, dim=1):
            n = moe.gshard_counts(c, inp["router"], k)
            local_kept.append(moe.moe_mlp_chunk(
                c, *weights, torch.zeros_like(n), n, c.shape[1], k, cf)[2])
        fault_caught = not torch.equal(torch.cat(local_kept, dim=2),
                                       whole_kept)
    got = dict(zip(names, chunked["grads"]), y=chunked["y"])
    want = dict(zip(names, whole["grads"]), y=whole["y"])
    rel_l2 = {n: float((got[n].float() - want[n].float()).norm()
                       / want[n].float().norm()) for n in want}
    max_abs = {n: float((got[n].float() - want[n].float()).abs().max())
               for n in want}
    bitwise_whole = {n: bool(torch.equal(got[n], want[n])) for n in want}
    bitwise_rerun = (torch.equal(chunked["y"], rerun["y"]) and all(
        torch.equal(a, b) for a, b in zip(chunked["grads"],
                                          rerun["grads"])))
    kept_equal = bool(torch.equal(chunked["kept"], whole_kept))
    gaps = {n: abs(chunked[n] - whole[n]) / max(abs(whole[n]), 1e-30)
            for n in ("aux", "z")}
    emit({"phase": "gshard_sp_body", "sp": GSHARD_SP, "micro_batch": micro,
          "seq": seq, "chunk": seq // GSHARD_SP, "experts": e, "top_k": k,
          "capacity_factor": cf, "capacity": moe.expert_capacity(
              seq, e, k, cf), "hot_expert_scale": GSHARD_HOT,
          "dropped_fraction": chunked["dropped"],
          "whole_dropped_fraction": whole["dropped"],
          "kept_equal": kept_equal, "rel_l2": rel_l2, "max_abs_err": max_abs,
          "bitwise_vs_whole": bitwise_whole, "aux_z_gap": gaps,
          "bitwise_rerun": bitwise_rerun, "fault_caught": fault_caught,
          "whole_s": whole["s"],
          "chunked_s": chunked["s"], "rerun_s": rerun["s"]})
    check(kept_equal, "gshard_sp_body: a token's kept/dropped choice differs "
                      "from the whole sequence's")
    check(chunked["dropped"] == whole["dropped"] and chunked["dropped"] > 0,
          f"gshard_sp_body: dropped fraction {chunked['dropped']} against "
          f"the whole sequence's {whole['dropped']} (must be equal, > 0)")
    for n, val in rel_l2.items():
        check(val <= TRAIN_GATES["grads"],
              f"gshard_sp_body: {n} at a relative L2 distance of {val}")
    for n, gap in gaps.items():
        check(gap <= TRAIN_GATES["loss"],
              f"gshard_sp_body: {n} {gap} from the whole sequence's")
    check(bitwise_rerun, "gshard_sp_body: a rerun gave other bits")
    check(fault_caught, "gshard_sp_body: chunk-local capacities passed "
                        "the decision gate")
    return chunked["dropped"]


def _same_tree(a, b, where, on_card=True):
    """Two checkpoint trees equal leaf for leaf: tensors bit for bit in
    the same dtype (on the card where ``on_card``), other leaves
    equal."""
    from dlrover_tpu_torch.flash_ckpt.shm_handler import tree_flatten

    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    check(sa == sb, f"ckpt_bridges: {where}: another tree")
    for i, (x, y) in enumerate(zip(la, lb)):
        if not isinstance(x, torch.Tensor):
            check(x == y, f"ckpt_bridges: {where}: leaf {i} {y} != {x}")
            continue
        check(isinstance(y, torch.Tensor) and x.dtype == y.dtype
              and x.shape == y.shape,
              f"ckpt_bridges: {where}: leaf {i} {getattr(y, 'dtype', y)}")
        if on_card:
            check(y.is_cuda, f"ckpt_bridges: {where}: leaf {i} on {y.device}")
        xb = x.detach().reshape(-1).view(torch.uint8)
        yb = y.detach().reshape(-1).view(torch.uint8).to(xb.device)
        check(torch.equal(xb, yb), f"ckpt_bridges: {where}: leaf {i} differs")


class _ParamModule(torch.nn.Module):
    """The train state's params as an ``nn.Module``: one parameter per
    leaf, named by its path."""

    def __init__(self, params):
        from dlrover_tpu_torch.trainer import train_step as ts

        super().__init__()
        self.leaves = torch.nn.ParameterDict({
            name.replace(".", "__"): torch.nn.Parameter(p.detach().clone())
            for name, p in zip(_leaf_names(params),
                               ts.param_leaves(params))})


def _hf_stack(params, device, seed):
    """``_ParamModule`` over ``params`` (redrawn from ``seed`` unless it
    is None), fused AdamW on the card (its step counts live beside the
    params) and a LambdaLR."""
    module = _ParamModule(params).to(device)
    if seed is not None:
        gen = torch.Generator(device).manual_seed(seed)
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=gen, device=device))
    opt = torch.optim.AdamW(module.parameters(), lr=1e-3,
                            fused=device == "cuda")
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0 / (s + 1))
    return module, opt, sched


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(r, n))
               for r, _, names in os.walk(path) for n in names)


def phase_ckpt_bridges(device="cuda", layers=BRIDGE_LAYERS, micro=2,
                       seq=256):
    """The checkpoint bridges on the flagship's train state at full
    width cut to BRIDGE_LAYERS layers (params, AdamW's moments and step
    counts after one step of ``make_train_step`` on the card): the
    port's ``Checkpointer`` saves it to storage; ``dcp_io.export_step``
    writes it as a ``torch.distributed.checkpoint`` step and
    ``load_dcp`` reads it back onto the card without a template, bit for
    bit; ``import_step`` brings it into a second flash dir, and the
    engine restores that onto the card, in place, bit for bit. Then the
    same params as an ``nn.Module`` on the card with fused AdamW after
    one step and a LambdaLR: ``FlashCkptCallback.on_save`` snapshots
    them, and a fresh callback's ``on_train_begin`` restores them into a
    freshly drawn module, optimizer and scheduler, bit for bit, every
    tensor on the card. The dirs sit on ``/dev/shm`` where the host has
    it (the bridge's bytes, not the disk's speed) and are removed at the
    end. Bytes and seconds of each step. ``device="cpu"`` with
    ``layers`` and the tiny config's width rehearses it."""
    import shutil
    import tempfile
    import types
    import uuid

    from dlrover_tpu_torch.flash_ckpt import dcp_io
    from dlrover_tpu_torch.flash_ckpt import engine as ckpt_engine
    from dlrover_tpu_torch.flash_ckpt.checkpointer import (
        Checkpointer,
        StorageType,
    )
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer import hf_flash, runtime
    from dlrover_tpu_torch.trainer import train_step as ts

    cfg = (llama.flagship_config(n_layers=layers) if device == "cuda"
           else llama.tiny_config(n_layers=layers))
    tc = ts.TrainConfig()
    params = llama.init_params(
        cfg, torch.Generator(device).manual_seed(SEED), device=device)
    opt = ts.make_optimizer(tc)
    state = ts.init_train_state(cfg, opt, params)
    rs = np.random.RandomState(SEED + 5)
    tokens = torch.from_numpy(rs.randint(0, cfg.vocab_size, (
        micro, seq + 1)).astype(np.int32)).to(device)
    state, _ = ts.make_train_step(cfg, tc, opt, device=device)(
        state, {"tokens": tokens})
    tree = ts.state_tree(state)
    nbytes = ckpt_engine.state_nbytes(tree)
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    root = tempfile.mkdtemp(prefix="ckpt_bridges_", dir=shm)
    job = f"bridges{uuid.uuid4().hex[:8]}"
    dirs = {n: os.path.join(root, n) for n in ("flash", "dcp", "flash2",
                                              "hf")}
    row = {"phase": "ckpt_bridges", "layers": layers, "root": root,
           "state_bytes": nbytes}
    timings = {}

    def timed_step(name, fn):
        t0 = time.monotonic()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        timings[name] = time.monotonic() - t0
        return out

    try:
        with _process_env({"DLROVER_TPU_JOB_NAME": job,
                           "DLROVER_TPU_SHARED_DIR":
                               os.path.join(root, "uds")}):
            runtime._context = None  # noqa: SLF001 (a world of one)
            ckpt = Checkpointer(dirs["flash"], standalone=True)
            timed_step("save_s", lambda: ckpt.save_checkpoint(
                state["step"], tree, StorageType.DISK))
            check(ckpt.wait_saving_complete(),
                  "ckpt_bridges: the save was not committed")
            ckpt._engine._shm.unlink()  # noqa: SLF001
            ckpt.close()
            step = timed_step("export_s", lambda: dcp_io.export_step(
                dirs["flash"], dirs["dcp"]))
            check(step == state["step"], f"ckpt_bridges: exported {step}")
            _, loaded = timed_step("load_dcp_s", lambda: dcp_io.load_dcp(
                dirs["dcp"], device=device))
            _same_tree(tree, loaded, "load_dcp", on_card=device == "cuda")
            del loaded
            timed_step("import_s", lambda: dcp_io.import_step(
                dirs["dcp"], dirs["flash2"]))
            target = ts.params_like(tree, lambda x: torch.zeros_like(x)
                                    if isinstance(x, torch.Tensor) else 0)
            ckpt2 = Checkpointer(dirs["flash2"], standalone=True)
            restored = timed_step("restore_s", lambda: ckpt2.load_checkpoint(
                target=target))
            ckpt2.close()
            check(restored is not None and restored[0] == step
                  and ckpt2._engine.last_restore_source == "storage",  # noqa
                  "ckpt_bridges: the imported step did not restore")
            # In place: AdamW's step counts stay where AdamW keeps them.
            _same_tree(tree, restored[1], "engine restore", on_card=False)
            _same_tree(tree["params"], restored[1]["params"],
                       "engine restore params", on_card=device == "cuda")
            del restored, target
            # The HF callback on an nn.Module of the same params.
            module, hopt, sched = _hf_stack(state["params"], device, None)
            for p in module.parameters():
                p.grad = p.detach().clone()
            hopt.step()
            sched.step()
            hf_state = types.SimpleNamespace(global_step=step)
            cb = hf_flash.FlashCkptCallback(dirs["hf"])
            timed_step("hf_save_s", lambda: cb.on_save(
                None, hf_state, None, model=module, optimizer=hopt,
                lr_scheduler=sched))
            cb.close()
            module2, hopt2, sched2 = _hf_stack(state["params"], device,
                                               SEED + 9)
            hf_state2 = types.SimpleNamespace(global_step=0)
            cb2 = hf_flash.FlashCkptCallback(dirs["hf"])
            timed_step("hf_restore_s", lambda: cb2.on_train_begin(
                None, hf_state2, None, model=module2, optimizer=hopt2,
                lr_scheduler=sched2))
            check(hf_state2.global_step == step,
                  f"ckpt_bridges: HF resumed at {hf_state2.global_step}")
            check(cb2._ckpt._engine.last_restore_source == "memory",  # noqa
                  "ckpt_bridges: the HF restore did not read shm")
            cb2._ckpt._engine._shm.unlink()  # noqa: SLF001
            cb2.close()
            want = hf_flash.snapshot_training_state(module, hopt, sched)
            got = hf_flash.snapshot_training_state(module2, hopt2, sched2)
            _same_tree(want["model"], got["model"], "HF model",
                       on_card=device == "cuda")
            _same_tree(want["optimizer"], got["optimizer"], "HF optimizer",
                       on_card=device == "cuda")
            check(want["scheduler"] == got["scheduler"],
                  "ckpt_bridges: HF scheduler state differs")
            row["hf_bytes"] = ckpt_engine.state_nbytes(want)
            row["dcp_bytes"] = _dir_bytes(dirs["dcp"])
            row["flash_bytes"] = _dir_bytes(dirs["flash"])
            row["import_bytes"] = _dir_bytes(dirs["flash2"])
            row["step"] = step
            row["bitwise"] = True
            runtime._context = None  # noqa: SLF001
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row.update(timings)
    row["gb_per_s"] = {k: nbytes / 1e9 / max(v, 1e-9) for k, v in
                       timings.items()}
    emit(row)
    return row


# ---- the live rescale plane, the network check, the warm standby ----------

# phase 24: the reference test's live episode, w and opt 8 MiB of int64
# each on the card.
RESCALE_EPISODE = dict(world=2, dataset_size=960, shard_size=16,
                       ckpt_every=2, step_ms=80.0, watchdog_s=120.0)
RESCALE_VEC_LEN = 1 << 20
# phase 25: the worker the launcher and the agent run, and the steps its
# first two incarnations crash at (through its fault schedule).
AGENT_STEPS, AGENT_CRASH_STEPS = 6, (3, 5)
AGENT_TIMEOUT_S = 300.0
# phase 25(b): the injected capture listener's interval in every
# interpreter of the run (standbys and workers).
STANDBY_CAPTURE_S = 2.0
# phase 25(b): the local master's autoscale loop cadence.
AUTOSCALE_INTERVAL_S = 0.5
# phase 25: the most a capture window opened after the worker's first
# step may wait for the profiler to start (a first window opened during
# a process's start-up waited 10.1-11.2 s on the H100).
CAPTURE_STARTUP_MAX_S = 2.0


def _agent_worker_args(device, steps, ckpt_dir):
    """The elastic worker's argv for phase 25: one flagship layer at
    2 x 128 on the card (the flash kernels take bf16; the tiny config is
    f32), the tiny config on the CPU."""
    if device == "cuda":
        model = ["--config", "flagship", "--layers", "1", "--seq", "128"]
    else:
        model = ["--config", "tiny", "--layers", "1", "--seq", "8"]
    return model + ["--steps", str(steps), "--global-batch", "2",
                    "--micro-batch", "2", "--persist-every", "2",
                    "--device", device, "--seed", str(SEED),
                    "--ckpt-dir", ckpt_dir]


def _unlink_job_segments(job):
    for seg in os.listdir("/dev/shm"):
        if job in seg:
            os.unlink(os.path.join("/dev/shm", seg))


def phase_live_rescale(device="cuda", vec_len=RESCALE_VEC_LEN):
    """The port's live rescale (``testing/rescale_soak.run_rescale_episode``,
    scenario ``live``, seed 0) at the reference test's settings: the
    master (coordinator, task manager, KV store, servicer over HTTP) in
    this process, two ``rescale_worker`` processes whose int64 state
    (``w`` and ``opt`` of ``vec_len``) lives on ``device``. Rank 1 is
    SIGKILLed once both reached step 5; rank 0 rescales to a world of one
    in-process (plan, barrier, its byte ranges of ``w`` and ``opt``
    restored through ``load_state_regions`` into its device tensors, the
    peers' over the KV store); a fresh rank 1 (the episode's warm
    standby, adopted) joins and the world goes back to two. Gates: the
    harness's invariants (exactly once, every save bit-identical to the
    single-host replay of its consumed shards, every restore's CRC its
    save's, the survivor never restarted); deaths 1, generations
    {0: 0, 1: 1}, at least 3 plans, worlds 1 and 2, reasons ``node_lost``
    and ``scale_up*``, a plan-to-first-step time; every worker started
    on ``device``; a copy of the ledger with one save's CRC flipped is
    rejected. Prints each rescale's plan-to-first-step and barrier
    seconds, each plan's phase barrier waits, each restore's bytes and
    seconds, the episode's wall."""
    import copy
    import glob
    import shutil
    import tempfile

    from dlrover_tpu_torch.testing.rescale_soak import (
        RescaleSoakConfig,
        check_rescale_invariants,
        run_rescale_episode,
    )
    from dlrover_tpu_torch.testing.soak import SoakInvariantError

    cfg = RescaleSoakConfig(vec_len=vec_len, device=device,
                            **RESCALE_EPISODE)
    work = tempfile.mkdtemp(prefix="live_rescale_")
    t0 = time.monotonic()
    try:
        report = run_rescale_episode(seed=SEED, cfg=cfg, scenario="live",
                                     work_dir=work)
    except Exception:
        for path in sorted(glob.glob(os.path.join(
                work, "**", "*.log"), recursive=True)):
            with open(path, errors="replace") as f:
                print(f"--- {path}\n{f.read()[-3000:]}", file=sys.stderr)
        raise
    shutil.rmtree(work, ignore_errors=True)
    wall = time.monotonic() - t0
    events = report.pop("events")
    rescales = report["rescales"]
    check(report["deaths"] == 1, f"live_rescale: deaths {report['deaths']}")
    check(report["generations"] == {0: 0, 1: 1},
          f"live_rescale: generations {report['generations']}")
    check(report["plans"] >= 3, f"live_rescale: {report['plans']} plans")
    worlds = {t["world"] for t in rescales}
    check({1, 2} <= worlds, f"live_rescale: worlds {worlds}")
    reasons = {t["reason"] for t in rescales}
    check("node_lost" in reasons
          and any(r.startswith("scale_up") for r in reasons),
          f"live_rescale: reasons {reasons}")
    check(any(t.get("plan_to_first_step_s") is not None for t in rescales),
          "live_rescale: no plan-to-first-step time")
    starts = [e for e in events if e["kind"] == "worker_start"]
    check(len(starts) == 3 and all(e["device"].startswith(device)
                                   for e in starts),
          f"live_rescale: worker devices {[e['device'] for e in starts]}")
    flipped = copy.deepcopy(events)
    saves = [e for e in flipped if e["kind"] == "save" and e["step"] > 0]
    saves[len(saves) // 2]["crc"] ^= 1 << 7
    try:
        check_rescale_invariants(flipped, cfg)
        rejected = False
    except SoakInvariantError:
        rejected = True
    check(rejected, "live_rescale: a flipped save CRC passed the invariants")
    restores = [{k: e.get(k) for k in ("rank", "plan", "step", "bytes_read",
                                       "read_s", "seconds")}
                for e in events if e["kind"] == "restore"]
    row = {"phase": "live_rescale", "vec_len": vec_len, "device": device,
           "device_names": sorted({e.get("device_name") for e in starts}),
           "wall_s": wall, "episode_wall_s": report["wall_s"],
           "rescales": rescales, "plans_cut": report["plans_cut"],
           "restores": restores, "adopted": report["adopted"],
           "goodput_frac": report["goodput_frac"],
           "recovery_s": report["recovery_s"],
           "steps_executed": report["steps_executed"],
           "steps_unique": report["steps_unique"],
           "flipped_crc_rejected": rejected}
    emit(row)
    return row


class _LogTail:
    """Stamps each line appended to the watched files with the monotonic
    time this process read it (polled every 10 ms)."""

    def __init__(self, paths):
        import threading

        self._paths = list(paths)
        self._offsets = {p: 0 for p in self._paths}
        self._partial = {p: "" for p in self._paths}
        self.lines = []  # (t, path, line)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _poll(self):
        for path in self._paths:
            try:
                with open(path, errors="replace") as f:
                    f.seek(self._offsets[path])
                    chunk = f.read()
                    self._offsets[path] = f.tell()
            except OSError:
                continue
            if not chunk:
                continue
            now = time.monotonic()
            text = self._partial[path] + chunk
            *whole, self._partial[path] = text.split("\n")
            self.lines += [(now, path, ln) for ln in whole]

    def _run(self):
        while not self._stop.wait(0.01):
            self._poll()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
        self._poll()

    def json_lines(self, path):
        out = []
        for t, p, ln in list(self.lines):
            if p == path and ln.startswith("{"):
                try:
                    out.append((t, json.loads(ln)))
                except ValueError:
                    pass
        return out


# phase 25(a): the timed run's steps (a capture window's worth and
# more: the worker's steps run on through the window), the listener's
# window, and the most this process waits for the master to log the
# forwarded scrape.
TIMER_STEPS, TIMER_WINDOW_S, TIMER_FORWARD_S = 40, 0.5, 15.0


def _timer_run(device, root, repo, env):
    """The network check's healthy run under ``DLROVER_TPU_TIMER=1`` and
    ``DLROVER_TPU_TIMER_XLA=1``: the worker (held after its last step)
    trains TIMER_STEPS steps; once it reports its first step this
    process touches its capture trigger, waits for the listener's
    capture, then fetches the worker's ``/metrics`` and ``/timeline``
    through ``tpu_timer/dump.py``. The launcher runs one
    ``TpuTimerMetricCollector`` a local rank, which scrapes every 30 s
    (the reference's cadence); rather than wait up to that long for its
    next tick, this process forwards a scrape taken after the capture
    through the same collector class to the launcher's local master
    (its address from the launcher's log). Gates: the launcher started
    its collector; the daemon served ``/metrics``; the master received
    the parsed gauges with the capture's event count; the timeline holds
    B1/B2's kernels with positive durations; the window's profiler
    start-up within CAPTURE_STARTUP_MAX_S; the run's steps and exit; the
    network check as before. Returns the row."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common.constants import NodeEnv
    from dlrover_tpu_torch.diagnosis.collectors import (
        TpuTimerMetricCollector,
        parse_prometheus_text,
    )
    from dlrover_tpu_torch.tpu_timer import bridge, dump, xla_capture

    job = env[NodeEnv.JOB_NAME]
    os.makedirs(os.path.join(root, "pass"), exist_ok=True)
    hold = os.path.join(root, "pass", "hold")
    with _process_env({NodeEnv.JOB_NAME: job}):
        trigger = xla_capture.trigger_path(0)
        port_file = bridge.port_file_path(0)
    env = dict(env, DLROVER_TPU_TIMER="1", DLROVER_TPU_TIMER_XLA="1",
               DLROVER_TPU_TIMER_XLA_INTERVAL="3600",
               DLROVER_TPU_TIMER_XLA_WINDOW=str(TIMER_WINDOW_S))
    args = _agent_worker_args(device, TIMER_STEPS, os.path.join(
        root, "pass", "ckpt")) + ["--hold-file", hold]
    args[args.index("--persist-every") + 1] = str(TIMER_STEPS)
    launcher = _Launcher(
        args, env, os.path.join(root, "pass_launcher.log"),
        launch=("--standalone", "--network-check", "--nproc_per_node", "1",
                "--monitor_interval", "0.2", "-m",
                "dlrover_tpu_torch.examples.train_llama"),
        phase="agent_paths")
    t0 = time.monotonic()
    try:
        launcher.wait_event(lambda e: e["event"] == "step", "a first step")
        with open(trigger, "w") as f:
            f.write(str(time.time()))
        t_trigger = time.monotonic()
        deadline = t_trigger + 60
        while not (found := re.findall(
                r"xla capture #1 \(pid \d+\): (\d+) runtime events "
                r"recorded \((\d+) device events[^)]*\) in a ([0-9.]+) s "
                r"window after ([0-9.]+) s start-up", launcher.log())):
            check(time.monotonic() < deadline and launcher.proc.poll()
                  is None, "agent_paths/timer: no capture in 60 s")
            time.sleep(0.05)
        t_captured = time.monotonic()
        recorded, device_events, window_s, startup_s = found[0]
        with open(port_file) as f:
            port = int(f.read())
        metrics = parse_prometheus_text(dump.fetch_with_retries(
            port, "/metrics", retries=3).decode())
        timeline = json.loads(dump.annotate_clock_sync(
            dump.fetch_with_retries(port, "/timeline", retries=3)))
        # The launcher's collector class forwards a scrape taken after
        # the capture to the launcher's master (the master's log line
        # carries the capture's event count; a window on the CPU records
        # none).
        log = launcher.log()
        check("tpu_timer collector of local rank 0 every 30 s" in log,
              "agent_paths/timer: the launcher started no collector")
        addr = re.findall(r"local master pid=\d+ serving at (\S+) after",
                          log)
        check(len(addr) == 1, f"agent_paths/timer: master address {addr}")
        client = MasterClient(addr[0], node_id=0)
        try:
            check(TpuTimerMetricCollector(
                master_client=client, node_id=0,
                port_file=port_file).collect_once(),
                "agent_paths/timer: the collector forwarded nothing")
        finally:
            client.close()
        received = re.compile(
            r"received xpu_timer_metric diagnosis data from node 0 \((\d+) "
            r"metrics, xla_capture_events ([0-9.]+)")
        while not (forwarded := [
                m for m in received.findall(launcher.log())
                if float(m[1]) > 0 or device != "cuda"]):
            check(time.monotonic() < t_captured + TIMER_FORWARD_S,
                  "agent_paths/timer: the master received no scrape with "
                  "the capture")
            time.sleep(0.05)
        t_forwarded = time.monotonic()
        launcher.wait_event(lambda e: e["event"] == "held", "the hold")
        with open(hold, "w"):
            pass
        launcher.wait_event(lambda e: e["event"] == "done", "the end")
        rc = launcher.proc.wait(timeout=AGENT_TIMEOUT_S)
        wall = time.monotonic() - t0
        log = launcher.log()
    finally:
        launcher.stop()
    events = launcher.incarnations()[0]
    steps = [e for e in events if e["event"] == "step"]
    probes = [json.loads(ln) for ln in log.splitlines()
              if ln.startswith('{"event": "node_check_probe"')]
    check(rc == 0, f"timer run: rc {rc}: {log[-3000:]}")
    check(len(probes) == 1 and probes[0]["device"].startswith(device)
          and probes[0]["elapsed"] > 0, f"timer run: probes {probes}")
    check("the master's fault nodes [] after round" in log,
          "timer run: the master did not record the node healthy")
    check([e["step"] for e in steps] == list(range(1, TIMER_STEPS + 1))
          and events[-1]["event"] == "done",
          f"timer run: steps {[e['step'] for e in steps]}")
    if device == "cuda":
        check(steps[-1]["launches"].get("flash_forward", 0) > 0,
              "timer run: the worker launched no B1")
    captured = metrics.get("tpu_timer_gauge/xla_capture_events")
    check("tpu_timer_hang_spans" in metrics and captured is not None
          and (captured > 0 or device != "cuda"),
          f"timer run: /metrics {sorted(metrics)[:12]}")
    spans = {}
    window = None
    for e in timeline.get("traceEvents", []):
        spans.setdefault(e["name"], []).append(e["dur"])
        if e["name"] == "xla_capture_window":
            window = (e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6)
    kernels = {k: spans.get(f"xla/{k}", [])
               for k in FLASH_KERNELS.values()} if device == "cuda" else {}
    # The kernels land on the native clock inside the capture window.
    outside = [e["name"] for e in timeline.get("traceEvents", [])
               if e["name"].startswith("xla/") and window and not (
                   window[0] - 0.05 <= e["ts"] / 1e6
                   and (e["ts"] + e["dur"]) / 1e6 <= window[1] + 0.05)]
    check(float(startup_s) <= CAPTURE_STARTUP_MAX_S,
          f"timer run: the capture waited {startup_s} s for the profiler")
    check(all(durs and min(durs) > 0 for durs in kernels.values())
          and window is not None and "clock_sync" in timeline
          and not outside,
          f"timer run: timeline kernels "
          f"{ {k: len(v) for k, v in kernels.items()} }, "
          f"window {window}, names {sorted(spans)[:12]}, {len(outside)} "
          f"kernels outside the window: {outside[:4]}")
    # The worker's step seconds whose step line arrived in the window
    # (the native clock is CLOCK_MONOTONIC, as this process's).
    inside = [e["compute_s"] for e in steps
              if window and window[0] <= e["t"] <= window[1]]
    outside = [e["compute_s"] for e in steps[1:]
               if not (window and window[0] <= e["t"] <= window[1])]
    ready = next(e for e in events if e["event"] == "ready")
    held = next(e for e in events if e["event"] == "held")
    return {"rc": rc, "wall_s": wall, "probe": probes[0],
            "launch_to_ready_s": ready["t"] - launcher.spawned,
            "ready_to_first_step_s": steps[0]["t"] - ready["t"],
            "steps_s": steps[-1]["t"] - steps[0]["t"],
            "held_s": events[-1]["t"] - held["t"],
            "losses": [e["loss"] for e in steps],
            "trigger_to_capture_s": t_captured - t_trigger,
            "capture_to_master_s": t_forwarded - t_captured,
            "capture": {"recorded": int(recorded),
                        "device_events": int(device_events),
                        "window_s": float(window_s),
                        "startup_s": float(startup_s)},
            "step_s_in_window": inside, "step_s_outside_window": outside,
            "step_s_in_window_mean": float(np.mean(inside)) if inside
            else None,
            "step_s_outside_window_mean": float(np.mean(outside)),
            "metrics": len(metrics),
            "master_reports": [[int(a), float(b)] for a, b in forwarded],
            "timeline_kernels": {k: [len(v), float(np.mean(v))]
                                 for k, v in kernels.items()}}


def _network_check_runs(device):
    """``python -m dlrover_tpu_torch.run --standalone --network-check``
    twice at once: healthy (under the profiler daemon and its capture,
    ``_timer_run``), and with the probe rigged to fail."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from dlrover_tpu_torch.fault import SCHEDULE_ENV

    repo = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="network_check_")
    out, jobs = {}, {}
    try:
        for label, extra in (("pass", {}), ("fail", {
                "DLROVER_TPU_CHAOS_CHECK_FAIL_RANKS": "0"})):
            job = f"chipsmoke{os.getpid()}nc{label}"
            env = dict(os.environ, PYTHONPATH=repo,
                       DLROVER_TPU_JOB_NAME=job,
                       DLROVER_TPU_SHARED_DIR=os.path.join(root, label,
                                                           "sock"),
                       DLROVER_TPU_EVENT_DIR=os.path.join(root, label,
                                                          "events"),
                       DLROVER_TPU_CHECK_DEVICE=device, **extra)
            env.pop(SCHEDULE_ENV, None)
            jobs[label] = (job, env)

        def fail_run():
            job, env = jobs["fail"]
            t0 = time.monotonic()
            try:
                proc = subprocess.run(
                    [sys.executable, "-m", "dlrover_tpu_torch.run",
                     "--standalone", "--network-check", "--nproc_per_node",
                     "1", "--monitor_interval", "0.2", "-m",
                     "dlrover_tpu_torch.examples.train_llama",
                     *_agent_worker_args(device, 2, os.path.join(
                         root, "fail", "ckpt"))],
                    env=env, cwd=repo, capture_output=True, text=True,
                    timeout=AGENT_TIMEOUT_S)
            finally:
                _unlink_job_segments(job)
            return proc, time.monotonic() - t0

        def pass_run():
            job, env = jobs["pass"]
            try:
                return _timer_run(device, root, repo, env)
            finally:
                _unlink_job_segments(job)

        with ThreadPoolExecutor(2) as pool:
            failed = pool.submit(fail_run)
            out["pass"] = pass_run()
            proc, wall = failed.result()
        events = [json.loads(ln) for ln in proc.stdout.splitlines()
                  if ln.startswith("{")]
        probes = [json.loads(ln) for ln in proc.stderr.splitlines()
                  if ln.startswith('{"event": "node_check_probe"')]
        check(proc.returncode != 0 and probes == [] and events == []
              and "started worker" not in proc.stderr,
              f"network check fail run: rc {proc.returncode}, "
              f"probes {probes}, {len(events)} worker lines")
        out["fail"] = {"rc": proc.returncode, "wall_s": wall}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _standby_run(device, root, repo):
    """The port's ``ElasticAgent`` with ``warm_standby=True``, under an
    in-process local master and checkpoint saver, runs the elastic
    worker for AGENT_STEPS steps. Its fault schedule (rewritten once
    each incarnation has read it) crashes incarnation 0 at
    AGENT_CRASH_STEPS[0]: the relaunch must be the adopted standby.
    This process then kills the standby the agent spawned next, and
    incarnation 1 crashes at AGENT_CRASH_STEPS[1]: the agent must fall
    back to a cold spawn. Returns the row: each relaunch's seconds from
    the crash (its fault trace line) to its ready line and first step."""
    import threading

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.agent.training import (
        ElasticAgent,
        RunResult,
        WorkerSpec,
    )
    from dlrover_tpu_torch.common.constants import NodeEnv
    from dlrover_tpu_torch.fault import (
        SCHEDULE_ENV,
        TRACE_ENV,
        FaultRule,
        FaultSchedule,
    )
    from dlrover_tpu_torch.flash_ckpt.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.master.local_master import LocalJobMaster
    from dlrover_tpu_torch.master.node.job_context import JobContext

    job = f"chipsmoke{os.getpid()}standby"
    sock_dir, log_dir = os.path.join(root, "sock"), os.path.join(root, "logs")
    os.makedirs(sock_dir)
    os.makedirs(log_dir)
    schedule = os.path.join(root, "schedule.json")
    trace = os.path.join(root, "trace.jsonl")
    labels = ("warm", "cold")

    def crash_at(i):
        """The schedule incarnation ``i`` reads: crash at its step."""
        rules = [] if i >= len(labels) else [FaultRule(
            "agent.worker.crash", action="crash",
            match={"step": AGENT_CRASH_STEPS[i]}, rule_id=labels[i])]
        with open(schedule, "w") as f:
            f.write(FaultSchedule(rules).to_json())

    crash_at(0)
    os.environ.update({NodeEnv.JOB_NAME: job, NodeEnv.NODE_RANK: "0",
                       NodeEnv.SHARED_DIR: sock_dir})
    JobContext.reset_singleton()
    record = os.path.join(root, "autoscale", "signals.jsonl")
    master = LocalJobMaster(port=0, node_num=1, autoscale_loop=True,
                            autoscale_interval_s=AUTOSCALE_INTERVAL_S,
                            autoscale_record=record)
    master.prepare()
    client = MasterClient(f"localhost:{master.port}", node_id=0)
    AsyncCheckpointSaver.reset()
    saver = AsyncCheckpointSaver.start_async_saving_ckpt(client=client)
    log_path = os.path.join(log_dir, "worker-0-0.log")
    tail = _LogTail([log_path, trace])
    box, killed = {}, []
    try:
        spec = WorkerSpec(
            entrypoint="-m dlrover_tpu_torch.examples.train_llama",
            args=_agent_worker_args(device, AGENT_STEPS,
                                    os.path.join(root, "ckpt")),
            nproc_per_node=1, max_restarts=2, node_rank=0,
            monitor_interval=0.2, redirect_output=log_dir,
            # The master's address, as the launcher exports it: the
            # worker reports its steps to the master's perf monitor,
            # which the autoscale loop samples.
            env={SCHEDULE_ENV: schedule, TRACE_ENV: trace,
                 NodeEnv.MASTER_ADDR: f"localhost:{master.port}",
                 "PYTHONPATH": repo, "DLROVER_TPU_TIMER_XLA": "1",
                 "DLROVER_TPU_TIMER_XLA_INTERVAL": str(STANDBY_CAPTURE_S),
                 "DLROVER_TPU_TIMER_XLA_WINDOW": "0.1"},
            warm_standby=True)
        agent = ElasticAgent(spec, client, ckpt_saver=saver)
        t0 = time.monotonic()
        thread = threading.Thread(
            target=lambda: box.setdefault("result", agent.run()),
            daemon=True)
        thread.start()
        deadline = t0 + AGENT_TIMEOUT_S

        def wait_for(what, cond):
            while not cond():
                check(thread.is_alive() and time.monotonic() < deadline,
                      f"agent_paths/standby: no {what}")
                time.sleep(0.02)

        for i in range(len(labels)):
            # Incarnation i read the schedule once its ready line is out.
            wait_for(f"ready line of incarnation {i}", lambda: sum(
                e.get("event") == "ready"
                for _, e in tail.json_lines(log_path)) > i)
            crash_at(i + 1)
            if i == 1:
                # The standby spawned after the adoption dies before the
                # next crash: that relaunch must be a cold spawn.
                standby = agent._standby
                check(standby is not None and standby.poll() is None,
                      "agent_paths/standby: no standby after adoption")
                standby.kill()
                standby.wait(timeout=10)
                killed.append(standby.pid)
        # A cluster's master feeds its fault history from node failures;
        # the local master has none, so this harness feeds it the two
        # crashes (their trace lines' times), as the soak's harness does:
        # an observed MTBF the loop retunes the checkpoint cadence from
        # while the cold relaunch runs.
        def crash_times():
            return [t for t, e in tail.json_lines(trace)
                    if e.get("rule_id") in labels]

        wait_for("crash trace line of each incarnation",
                 lambda: len(crash_times()) == len(labels))
        for t in crash_times():
            master.fault_history.record_failure(t)
        thread.join(timeout=max(deadline - time.monotonic(), 1.0))
        check(not thread.is_alive(), f"agent_paths/standby: the agent "
              f"did not finish in {AGENT_TIMEOUT_S} s")
        wall = time.monotonic() - t0
    finally:
        tail.stop()
        saver.unlink_all(1)
        AsyncCheckpointSaver.reset()
        client.close()
        master.stop()
        _unlink_job_segments(job)
    check(box.get("result") == RunResult.SUCCEEDED,
          f"agent_paths/standby: agent result {box.get('result')}")
    autoscale = _autoscale_recording_gates(
        record, master, tail.json_lines(log_path))
    lines = tail.json_lines(log_path)
    readies = [(t, e) for t, e in lines if e.get("event") == "ready"]
    standbys = [e for _, e in lines if e.get("event") == "standby_ready"]
    crashes = {e.get("rule_id"): t for t, e in tail.json_lines(trace)}
    check(len(readies) == 3 and set(crashes) == set(labels),
          f"agent_paths/standby: {len(readies)} incarnations, crashes "
          f"{sorted(crashes)}")
    check(all(e["cuda_initialized"] is False for e in standbys),
          f"agent_paths/standby: a waiting standby initialised CUDA: "
          f"{standbys}")
    standby_pids = {e["pid"] for e in standbys}
    # The injected capture listener ran in every interpreter, and a
    # waiting standby, which has not stepped, opened no window: a
    # capture comes only from a worker after its first step, so none
    # touched a standby's CUDA state or its start-up.
    text = "\n".join(ln for _, p, ln in tail.lines if p == log_path)
    armed = {int(pid) for pid in re.findall(
        r"xla capture listener on in pid (\d+)", text)}
    firsts = {}  # worker pid -> the time of its first step line
    pid = None
    for t, e in lines:
        if e.get("event") == "ready":
            pid = e["pid"]
        elif e.get("event") == "step" and pid is not None:
            firsts.setdefault(pid, t)
    captures = [(t, int(m.group(1)), int(m.group(2)), float(m.group(3)))
                for t, p, ln in tail.lines if p == log_path
                for m in [re.search(
                    r"xla capture #\d+ \(pid (\d+)\): \d+ runtime events "
                    r"recorded \((\d+) device events[^)]*\) in a [0-9.]+ s "
                    r"window after ([0-9.]+) s start-up", ln)] if m]
    early = [(pid, t) for t, pid, _, _ in captures
             if pid not in firsts or t < firsts[pid]]
    check(standby_pids and standby_pids <= armed and not early
          and all(up <= CAPTURE_STARTUP_MAX_S for *_, up in captures),
          f"agent_paths/standby: listeners armed in pids {sorted(armed)}, "
          f"standbys {sorted(standby_pids)}, captures before a first step "
          f"{early}, start-ups {[c[3] for c in captures]}")
    row = {"wall_s": wall, "autoscale": autoscale,
           "standby_import_s": [e["import_s"] for e in standbys],
           "listeners": len(armed), "captures": len(captures),
           "captures_on_card": sum(n > 0 for _, _, n, _ in captures),
           "startup_s": [up for *_, up in captures]}
    for i, label in enumerate(labels):
        t_ready, relaunch = readies[i + 1]
        end = AGENT_CRASH_STEPS[i + 1] if i + 1 < len(labels) else (
            AGENT_STEPS)
        after = [(t, e) for t, e in lines if e.get("event") == "step"
                 and t_ready < t and (i + 2 == len(readies)
                                      or t < readies[i + 2][0])]
        check(relaunch["restart_count"] == i + 1 and after
              and after[0][1]["step"] == relaunch["restored_step"] + 1
              and after[-1][1]["step"] == end - (i + 1 < len(labels)),
              f"agent_paths/{label}: relaunch {relaunch}, steps "
              f"{[e['step'] for _, e in after]}")
        if device == "cuda":
            check(after[-1][1]["launches"].get("flash_forward", 0) > 0,
                  f"agent_paths/{label}: the relaunch launched no B1")
        adopted = relaunch["pid"] in standby_pids
        check(adopted == (label == "warm")
              and relaunch["pid"] not in killed,
              f"agent_paths/{label}: relaunch pid {relaunch['pid']}, "
              f"standbys {sorted(standby_pids)}, killed {killed}")
        t_crash = crashes[label]
        row[label] = {"crash_to_ready_s": t_ready - t_crash,
                      "crash_to_first_step_s": after[0][0] - t_crash,
                      "relaunch_start_s": relaunch["start_s"],
                      "relaunch_restored": [relaunch["restored_step"],
                                            relaunch["restored_from"]],
                      "relaunch_pid_is_standby": adopted}
    return row


def _autoscale_recording_gates(record, master, worker_lines):
    """Phase 25(b)'s master ran the autoscale loop, recording to
    ``record``: the recording's snapshots carry the worker's steps as
    the master's perf monitor received them (the newest recorded
    ``perf.global_step`` is the monitor's, a step the worker printed on
    the card, of its last incarnation or later), it replays to the live
    ledger (``assert_replay_identity``), and no ledger entry carries an
    actuation error."""
    from dlrover_tpu_torch.autoscaler import (
        SET_CKPT_INTERVAL,
        assert_replay_identity,
        load_recording,
    )

    recording = load_recording(record)
    steps = [s.values.get("perf.global_step") for s in recording.snapshots]
    printed = [e["step"] for _, e in worker_lines if e.get("event") == "step"]
    readies = [e for _, e in worker_lines if e.get("event") == "ready"]
    newest = max((n for n in steps if n is not None), default=None)
    check(newest is not None and newest == master.perf_monitor.global_step
          and newest in printed
          and newest > readies[-1]["restored_step"],
          f"agent_paths/autoscale: recorded global steps {steps[-5:]}, "
          f"the monitor's {master.perf_monitor.global_step}, printed "
          f"{printed}")
    check(steps == sorted(steps, key=lambda n: -1 if n is None else n),
          f"agent_paths/autoscale: global steps went back: {steps}")
    diff = assert_replay_identity(recording)
    entries = master.autoscaler.ledger.entries()
    errors = [d.to_dict(include_signals=False) for d in entries
              if d.outcome.startswith("error")]
    check(not errors, f"agent_paths/autoscale: actuation errors {errors}")
    retunes = [d for d in entries if d.action == SET_CKPT_INTERVAL
               and d.outcome == "actuated"]
    check(retunes and master.ckpt_cadence.interval_s() == float(
        retunes[-1].target),
          f"agent_paths/autoscale: no checkpoint cadence retune from the "
          f"two crashes' MTBF: decisions "
          f"{[(d.action, d.target, d.outcome) for d in entries]}, cadence "
          f"{master.ckpt_cadence.interval_s()}")
    return {"snapshots": len(recording.snapshots),
            "decisions": len(entries), "replayed": diff["identical"],
            "ckpt_interval_s": master.ckpt_cadence.interval_s(),
            "retune_reason": retunes[-1].reason,
            "newest_global_step": newest,
            "sources": sorted({k.split(".")[0] for k in
                               recording.snapshots[-1].values})}


def phase_agent_paths(device="cuda"):
    """(a) ``python -m dlrover_tpu_torch.run --standalone --network-check
    --nproc_per_node 1 -m dlrover_tpu_torch.examples.train_llama`` (one
    flagship layer at 2 x 128, 2 steps, on ``device``): exit 0, the
    port's probe (``agent/node_check_worker``) ran on ``device`` and
    wrote its result, the master's fault nodes are empty, then the worker
    trained 2 steps (launching B1 on the card); under
    ``DLROVER_TPU_CHAOS_CHECK_FAIL_RANKS=0`` the launcher exits non-zero
    and no worker starts (the two launchers run at once; (a) runs in an
    interpreter of its own, beside (b)). (b) The port's ``ElasticAgent``
    under an in-process local master (its autoscale loop on, recording)
    and saver runs the same worker for
    AGENT_STEPS steps with ``WorkerSpec(warm_standby=True)``; its first
    two incarnations crash at AGENT_CRASH_STEPS through their fault
    schedule, and the standby spawned before the second crash is
    killed. Gates: the agent exits 0; each relaunch (restart counts 1
    and 2) resumes at its restored step + 1 and trains on ``device``;
    the first is the adopted standby, the second a cold spawn (the dead
    standby's fallback); no waiting standby initialised CUDA; the
    injected capture listener ran in every standby, and no window opened
    before its process's first step, each within CAPTURE_STARTUP_MAX_S
    of profiler start-up; the autoscale recording's gates
    (``_autoscale_recording_gates``). Prints the seconds from each crash
    (its fault trace line) to the relaunch's ready line and first step:
    warm against cold."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.common.constants import NodeEnv

    repo = os.path.dirname(os.path.abspath(__file__))
    row = {"phase": "agent_paths", "device": device}
    # (a) runs in an interpreter of its own beside (b) (a cut for the
    # script's time limit): (b) sets this process's env for its
    # agent, and both spend most of their wall in process starts.
    network_check = _interpreter_call("_network_check_runs", device)
    saved_env = {k: os.environ.get(k) for k in (
        NodeEnv.JOB_NAME, NodeEnv.NODE_RANK, NodeEnv.SHARED_DIR)}
    root = tempfile.mkdtemp(prefix="agent_standby_")
    try:
        row["standby"] = _standby_run(device, root, repo)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    row["network_check"] = network_check.result(AGENT_TIMEOUT_S * 2)
    emit(row)
    return row


# phase 26: the serving scenario's model (the flagship's width, cut in
# depth), and the chaos soak's episodes.
SOAK_SERVING_LAYERS = 2
SOAK_EPISODES = 3
# phase 27: the master_kill episode of seed SEED.
MASTER_KILL_EPISODE = 7


def _soak_events(work, seed, episode):
    from dlrover_tpu_torch.testing.soak import _read_events

    return _read_events(os.path.join(work, f"soak-s{seed}-e{episode}",
                                     "events.jsonl"))


def _soak_ledger_gates(phase, events, device):
    """Every worker generation started on ``device``; every restore has
    a save of its step with the same CRC. Returns the restores."""
    starts = [e for e in events if e["kind"] == "worker_start"]
    check(starts and all(e["device"].startswith(device) for e in starts),
          f"{phase}: worker devices {[e.get('device') for e in starts]}")
    saves = {}
    restores = []
    for e in events:
        if e["kind"] == "save":
            saves.setdefault(e["step"], []).append(e["crc"])
        elif e["kind"] == "restore":
            check(e["crc"] in saves.get(e["step"], []),
                  f"{phase}: restore of step {e['step']} crc {e['crc']} "
                  f"matches no save of that step")
            restores.append({k: e[k] for k in ("step", "crc", "source",
                                               "generation")})
    return restores


@contextlib.contextmanager
def _soak_work_dir(prefix, work=None):
    """A soak phase's work directory (a new one, or ``work``): on a
    failure the tail of every worker and master log and ledger under it
    goes to stderr, and the directory goes in any case."""
    import glob
    import shutil
    import tempfile

    work = work or tempfile.mkdtemp(prefix=prefix)
    try:
        yield work
    except Exception:
        for path in sorted(p for pattern in ("*.log", "events.jsonl")
                           for p in glob.glob(os.path.join(
                               work, "**", pattern), recursive=True)):
            with open(path, errors="replace") as f:
                print(f"--- {path}\n{f.read()[-3000:]}", file=sys.stderr)
        raise
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_chaos_soak(device="cuda", layers=SOAK_SERVING_LAYERS):
    """``run_soak(seed=SEED, episodes=SOAK_EPISODES)`` with the worker's
    state and the serving engine on ``device``; the serving model is the
    flagship's width cut to ``layers`` on the card, the tiny config cut
    to ``layers`` on the CPU. Gates: the harness's invariants (it
    raises), every worker generation on ``device``, every restore's CRC
    its save's, one restore after each worker kill, every fault of the
    plans fired, and B5 (``decode_attention_fp``) launched at least
    ``layers`` times a decode step of the engines (``call_counts``,
    warmup included). Returns this phase's decode-kernel launches."""
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import decode_attention as da
    from dlrover_tpu_torch.testing.soak import SoakConfig, run_soak

    model = (llama.flagship_config(n_layers=layers) if device == "cuda"
             else llama.tiny_config(n_layers=layers))
    cfg = SoakConfig(device=device, serving_model=model,
                     keep_artifacts_on_success=True)
    da.reset_launch_counts()
    t0 = time.monotonic()
    with _soak_work_dir("chaos_soak_") as work:
        summary = run_soak(seed=SEED, episodes=SOAK_EPISODES, cfg=cfg,
                           work_dir=work)
        wall = time.monotonic() - t0
        launches = dict(da.launch_counts)
        episodes = []
        for rep in summary["reports"]:
            events = _soak_events(work, SEED, rep["episode"])
            restores = _soak_ledger_gates("chaos_soak", events, device)
            check(len(restores) == rep["deaths"],
                  f"chaos_soak/{rep['kind']}: {len(restores)} restores "
                  f"after {rep['deaths']} worker deaths")
            episodes.append({
                "kind": rep["kind"], "wall_s": rep["wall_s"],
                "generations": rep["generations"], "deaths": rep["deaths"],
                "recovery_s": rep["recovery_s"],
                "goodput_frac": rep["goodput_frac"],
                "faults": [f["rule_id"] for f in rep["faults"]],
                "restores": restores, "serving": rep["serving"],
                "steps_executed": rep["steps_executed"],
            })
    want_faults = {"crash_drop": {"worker-sigkill", "drop-get-task-reply"},
                   "torn_ckpt": {"worker-sigkill", "torn-shard-write",
                                 "shm-image-lost"},
                   "serving_report": {"prefetch-fetch-fails",
                                      "drop-done-report-reply",
                                      "serving-step-raises"}}
    for ep in episodes:
        check(set(ep["faults"]) == want_faults[ep["kind"]],
              f"chaos_soak/{ep['kind']}: faults fired {ep['faults']}")
    decode_steps = sum(ep["serving"]["call_counts"]["decode"]
                       for ep in episodes)
    check(decode_steps > 0
          and launches["decode_attention_fp"] >= layers * decode_steps,
          f"chaos_soak: {launches['decode_attention_fp']} B5 launches for "
          f"{decode_steps} decode steps of {layers} layers")
    row = {"phase": "chaos_soak", "device": device,
           "serving_model": {"embed_dim": model.embed_dim,
                             "n_layers": model.n_layers,
                             "dtype": model.dtype},
           "wall_s": wall, "goodput_frac": summary["goodput_frac"],
           "mttr_mean_s": summary["mttr_mean_s"],
           "mttr_max_s": summary["mttr_max_s"],
           "faults_injected": summary["faults_injected"],
           "decode_steps": decode_steps, "launches": launches,
           "episodes": episodes}
    emit(row)
    return launches


def phase_master_kill(device="cuda"):
    """The soak's ``master_kill`` episode (seed SEED, episode
    MASTER_KILL_EPISODE) with the worker's state on ``device``: its five
    invariants (the harness raises), the worker on ``device``, every
    restore's CRC its save's, epochs [1, 2], one crash at the planned
    hit, a clean-shutdown journal. Then the master recovery bench
    (``tools/torch_bench_master_recovery.py``, host only), its journal in
    a temp dir of its own: its exactly-once check raises; its RPS bound
    is reported. Prints the kill to first post-kill step, the master's
    restart to ready, the journal's records, bytes, commit groups and
    torn lines, the filesystem under the journal, and the bench's
    figures."""
    import importlib.util

    from dlrover_tpu_torch.testing.soak import (
        SoakConfig,
        build_episode_plan,
        run_soak,
    )

    cfg = SoakConfig(device=device, keep_artifacts_on_success=True)
    plan = build_episode_plan(SEED, MASTER_KILL_EPISODE, cfg)
    t0 = time.monotonic()
    with _soak_work_dir("master_kill_") as work:
        summary = run_soak(seed=SEED, episode=MASTER_KILL_EPISODE, cfg=cfg,
                           work_dir=work)
        wall = time.monotonic() - t0
        rep = summary["reports"][0]
        events = _soak_events(work, SEED, MASTER_KILL_EPISODE)
        _soak_ledger_gates("master_kill", events, device)
        spec = importlib.util.spec_from_file_location(
            "torch_bench_master_recovery",
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tools", "torch_bench_master_recovery.py"))
        bench = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bench)
    t1 = time.monotonic()
    bench_row = bench.run_bench()
    bench_row["wall_s"] = time.monotonic() - t1
    check(rep["master_epochs"] == [1, 2],
          f"master_kill: epochs {rep['master_epochs']}")
    check(rep["deaths"] == 0 and rep["generations"] == 1,
          f"master_kill: worker deaths {rep['deaths']}")
    crash = [f for f in rep["faults"] if f["rule_id"] == "master-sigkill"]
    check(len(crash) == 1 and crash[0]["hit"] == plan.master_kill_nth,
          f"master_kill: crashes {crash}, planned hit "
          f"{plan.master_kill_nth}")
    journal = rep["journal"]
    check(journal["clean_shutdown"],
          "master_kill: the journal did not end clean_shutdown")
    gen1 = journal["stats"][1] or {}
    row = {"phase": "master_kill", "device": device, "wall_s": wall,
           "kill_nth_dispatch": plan.master_kill_nth,
           "kill_to_first_step_s": rep["recovery_s"][0],
           "master_restart_to_ready_s": rep["master_restart_s"],
           "master_epochs": rep["master_epochs"],
           "goodput_frac": rep["goodput_frac"],
           "steps_executed": rep["steps_executed"],
           "journal": {"records": journal["records"],
                       "kinds": journal["kinds"],
                       "segment_bytes": journal["segment_bytes"],
                       "torn_lines": journal["corrupt_lines"],
                       "gen1_records_appended":
                           gen1.get("records_appended"),
                       "gen1_commit_groups": gen1.get("commit_groups"),
                       "gen1_recovered_records":
                           gen1.get("recovered_records"),
                       "gen1_recovered_torn_lines":
                           gen1.get("recovered_corrupt_lines"),
                       "fs": journal["fs"]},
           "recovery_bench": bench_row}
    emit(row)
    return row


# phase 28: a node lost with its host restores from its peer's memory.
REPLICA_STEPS, REPLICA_PERSIST, REPLICA_KILL = 5, 3, 4
REPLICA_TIMEOUT_S = 300.0
_REPLICA_LAUNCH = ("--nnodes", "2", "--nproc_per_node", "1",
                   "--max_restarts", "3", "--monitor_interval", "0.2",
                   "--ckpt_replica_group", "2",
                   "-m", "dlrover_tpu_torch.testing.replica_worker")


def _replica_log_transfers(text, what):
    """(step or None, bytes, seconds) of each replica push or pull a
    launcher logged."""
    import re

    if what == "push":
        found = re.findall(r"pushed \d+ shm segment replicas for step (\d+) "
                           r"\((\d+) bytes in ([0-9.]+) s\)", text)
        return [(int(s), int(b), float(t)) for s, b, t in found]
    found = re.findall(r"restored \d+ shm checkpoint segments from peers "
                       r"\((\d+) bytes in ([0-9.]+) s\)", text)
    return [(None, int(b), float(t)) for b, t in found]


def _log_walls(text, needle):
    """Wall-clock seconds of the log lines that hold ``needle`` (the
    port's log stamps each line ``[%Y-%m-%d %H:%M:%S,%f]``)."""
    import datetime

    return [datetime.datetime.strptime(line[1:24], "%Y-%m-%d %H:%M:%S,%f")
            .timestamp() for line in text.splitlines()
            if needle in line and line.startswith("[")]


def _restore_events(events_dir):
    """The ``ckpt_restore`` training events under ``events_dir``."""
    out = []
    for name in sorted(os.listdir(events_dir)) if os.path.isdir(
            events_dir) else []:
        with open(os.path.join(events_dir, name)) as f:
            out += [e["content"] for e in map(json.loads, f)
                    if e["name"] == "ckpt_restore"]
    return out


def _port_closed(addr):
    import socket

    host, port = addr.rsplit(":", 1)
    try:
        socket.create_connection((host, int(port)), timeout=2).close()
    except OSError:
        return True
    return False


def phase_replica_restore(device="cuda", config="flagship"):
    """Two nodes of one world on ``device``, each under its own launcher
    (``python -m dlrover_tpu_torch.run --master <this process's local
    master> --nnodes 2 --node_rank {0,1} --nproc_per_node 1
    --ckpt_replica_group 2 -m dlrover_tpu_torch.testing.replica_worker``),
    their workers holding the flagship's train state (params and AdamW
    moments, ELASTIC_LAYERS layers; the tiny config's on the CPU) on
    the device and training the same batches without a process group.
    Each step is saved to shm and every REPLICA_PERSIST steps persisted;
    each agent's saver pushes its node's image to the other node. Once
    node 1's step REPLICA_KILL is in shm and pushed, and storage holds
    step REPLICA_PERSIST, node 1's launcher (its agent) and worker are
    SIGKILLed and its segment unlinked (the host is lost). A fresh node-1
    launcher pulls the segment from node 0 before its worker starts, and
    the worker restores from memory; node 0's agent re-forms the world.
    Control: once that worker has saved its last step, node 1 is lost
    again, node 0's replica address in the master's KV store points at a
    closed port, and the next node-1 launcher pulls nothing, says so, and
    its worker restores from storage. Then both nodes are let go. Gates:
    the pulled segment's bytes are the lost one's (crc32 and length taken
    before the kill, read by the worker before its restore, and the pull
    moved that many bytes); the relaunch restored step REPLICA_KILL from
    memory (its worker's result and its ``ckpt_restore`` event), not the
    storage step; every restored leaf's crc32 is the lost image's, and
    an image with one element flipped does not match; the control
    restored the storage step from storage and its launcher logged the
    missing segment; node 0's restarts restored its own step from
    memory; both nodes' last launchers exit 0; each worker on the card
    launched B1; no segment, socket or replica port is left. Returns the
    B1/B2 launches of the workers' steps."""
    import shutil
    import tempfile
    import zlib

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common.constants import NodeEnv
    from dlrover_tpu_torch.common.env_utils import find_free_port
    from dlrover_tpu_torch.fault import SCHEDULE_ENV
    from dlrover_tpu_torch.flash_ckpt import storage as ckpt_storage
    from dlrover_tpu_torch.flash_ckpt.engine import shm_segment_name
    from dlrover_tpu_torch.flash_ckpt.shm_handler import SharedMemoryHandler
    from dlrover_tpu_torch.master.local_master import LocalJobMaster
    from dlrover_tpu_torch.master.node.job_context import JobContext
    from dlrover_tpu_torch.testing.replica_worker import image_digest

    label = "replica_restore"
    repo = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="replica_restore_")
    job = f"chipsmoke{os.getpid()}replica"
    ckpt_dir = os.path.join(root, "ckpt")
    release = os.path.join(root, "release")
    model = (["--config", "flagship", "--layers", str(ELASTIC_LAYERS),
              "--seq", "128"] if config == "flagship"
             else ["--config", "tiny", "--layers", "2", "--seq", "8"])

    def node_env(rank):
        return {NodeEnv.JOB_NAME: job, NodeEnv.NODE_RANK: str(rank)}

    def segment(rank):
        with _process_env(node_env(rank)):
            return shm_segment_name(0)

    JobContext.reset_singleton()
    master = LocalJobMaster(port=0, node_num=2)
    master.prepare()
    client = MasterClient(f"localhost:{master.port}", node_id=0)
    launchers = []

    def launch(rank, tag, steps):
        node_dir = os.path.join(root, tag)
        os.makedirs(node_dir)
        env = dict(os.environ, PYTHONPATH=repo, DLROVER_TPU_JOB_NAME=job,
                   DLROVER_TPU_SHARED_DIR=os.path.join(root, f"sock{rank}"),
                   DLROVER_TPU_EVENT_DIR=os.path.join(node_dir, "events"),
                   DLROVER_TPU_FLIGHT_DIR=os.path.join(root, "flight"))
        env.pop(SCHEDULE_ENV, None)
        env.pop(NodeEnv.NODE_RANK, None)
        launcher = _Launcher(
            model + ["--device", device, "--seed", str(SEED),
                     "--micro-batch", "1", "--steps", str(steps),
                     "--persist-every", str(REPLICA_PERSIST),
                     "--ckpt-dir", ckpt_dir, "--hold-file", release],
            env, os.path.join(node_dir, "launcher.log"),
            launch=("--master", f"localhost:{master.port}", "--node_rank",
                    str(rank), *_REPLICA_LAUNCH), phase=label)
        launchers.append((tag, launcher))
        return launcher

    def until(cond, what):
        deadline = time.monotonic() + REPLICA_TIMEOUT_S
        while not cond():
            check(time.monotonic() < deadline,
                  f"{label}: no {what} in {REPLICA_TIMEOUT_S} s")
            time.sleep(0.05)

    def lose_node_1(launcher):
        """SIGKILL the launcher (its agent) and its workers at once, then
        unlink the node's segment: the host is gone."""
        _, workers = launcher.pids()
        pids = [launcher.proc.pid, *workers]
        for pid in pids:
            if not _proc_gone(pid):
                os.kill(pid, signal.SIGKILL)
        until(lambda: all(_proc_gone(p) for p in pids), "exit of node 1")
        SharedMemoryHandler(segment(1)).unlink()

    def saved(launcher, inc, step=None):
        """Incarnation ``inc``'s last save (of ``step`` or later) is in
        shm."""
        return launcher.wait_event(
            lambda e: e["event"] == "saved" and e["inc"] == inc
            and (step is None or e["step"] >= step),
            f"incarnation {inc}'s last save", REPLICA_TIMEOUT_S)

    t_phase, wall_phase = time.monotonic(), time.time()
    marks = {}

    def mark(name, t=None):
        marks[name] = (time.monotonic() if t is None else t) - t_phase

    try:
        node0 = launch(0, "node0", REPLICA_STEPS)
        lost = launch(1, "node1", REPLICA_KILL)
        saved(node0, 0, REPLICA_STEPS)
        mark("node1_first_step", lost.wait_event(
            lambda e: e["event"] == "step", "node 1's first step")["t"])
        mark("node1_saved", saved(lost, 0, REPLICA_KILL)["t"])
        until(lambda: ckpt_storage.read_tracker(ckpt_dir) >= REPLICA_PERSIST,
              f"the commit of step {REPLICA_PERSIST}")
        until(lambda: any(s == REPLICA_KILL for s, _, _ in
                          _replica_log_transfers(lost.log(), "push")),
              f"node 1's push of step {REPLICA_KILL}")
        push = [t for t in _replica_log_transfers(lost.log(), "push")
                if t[0] == REPLICA_KILL][-1]
        mark("push_logged")
        lost_image = image_digest(segment(1))
        lost_crc, lost_bytes = lost_image["crc32"], lost_image["bytes"]
        image_crcs = lost_image["leaf_crc32"]
        # The planted fault: the first leaf with one bit flipped.
        seg = SharedMemoryHandler(segment(1))
        meta = seg.load_meta()
        shard = meta["leaves"][0].shards[0]
        leaf0 = seg.data_region(meta)[
            shard.offset:shard.offset + shard.nbytes].numpy().copy()
        seg.close()
        leaf0[0] ^= 1
        planted_crcs = [zlib.crc32(leaf0), *image_crcs[1:]]
        del leaf0
        tracker_at_kill = ckpt_storage.read_tracker(ckpt_dir)
        addr0 = client.kv_store_get("ckpt-replica-addr/0").decode()
        check(lost_image["step"] == REPLICA_KILL
              and tracker_at_kill == REPLICA_PERSIST,
              f"{label}: node 1's image at step {lost_image['step']}, "
              f"storage at {tracker_at_kill}")
        mark("crc_taken")
        lose_node_1(lost)
        mark("lost")

        relaunch = launch(1, "node1_memory", REPLICA_STEPS)
        ready = relaunch.wait_event(lambda e: e["event"] == "ready",
                                    "the relaunch's ready line")
        first = relaunch.wait_event(lambda e: e["event"] == "step",
                                    "the relaunch's first step")
        saved(relaunch, 0, REPLICA_STEPS)
        pulls = _replica_log_transfers(relaunch.log(), "pull")
        for name, needle in (("relaunch_pulled", "from peers ("),
                             ("relaunch_worker_started", "started worker")):
            walls = _log_walls(relaunch.log(), needle)
            if walls:
                marks[name] = walls[0] - wall_phase
        mark("relaunch_ready", ready["t"])
        mark("relaunch_first_step", first["t"])

        # Control: the peer's replica port is unreachable.
        lose_node_1(relaunch)
        client.kv_store_set("ckpt-replica-addr/0",
                            f"127.0.0.1:{find_free_port()}".encode())
        control = launch(1, "node1_storage", REPLICA_STEPS)
        c_ready = control.wait_event(lambda e: e["event"] == "ready",
                                     "the control's ready line")
        mark("control_ready", c_ready["t"])
        saved(control, 0, REPLICA_STEPS)
        saved(node0, 2)
        addr1 = client.kv_store_get("ckpt-replica-addr/1").decode()
        mark("released")
        with open(release, "w"):
            pass
        rcs = [launcher.proc.wait(timeout=REPLICA_TIMEOUT_S)
               for launcher in (node0, control)]
        wall = time.monotonic() - t_phase
        mark("exited")
        storage_bytes = os.path.getsize(os.path.join(
            ckpt_storage.step_dir(ckpt_dir, REPLICA_PERSIST), "proc-1.raw"))
    finally:
        for _, launcher in launchers:
            launcher.stop()
        client.close()
        master.stop()
        socks = []
        for r in (0, 1):
            sock_dir = os.path.join(root, f"sock{r}")
            if os.path.isdir(sock_dir):
                socks += os.listdir(sock_dir)
        _unlink_job_segments(job)
    try:
        events = {tag: _restore_events(os.path.join(root, tag, "events"))
                  for tag, _ in launchers}
        logs = {tag: launcher.log() for tag, launcher in launchers}
    finally:
        shutil.rmtree(root, ignore_errors=True)

    check(rcs == [0, 0], f"{label}: node 0 and the last node-1 launcher "
                         f"exited {rcs}")
    check(ready["image"] == {"step": REPLICA_KILL, "bytes": lost_bytes,
                             "crc32": lost_crc}
          and len(pulls) == 1 and pulls[0][1] == lost_bytes,
          f"{label}: the pulled segment {ready['image']} (pulls {pulls}) "
          f"is not the lost one ({lost_bytes} bytes, crc32 {lost_crc})")
    check(ready["restored_from"] == "memory"
          and ready["restored_step"] == REPLICA_KILL
          and events["node1_memory"] == [{"step": REPLICA_KILL,
                                          "source": "memory"}],
          f"{label}: the relaunch restored {ready['restored_step']} from "
          f"{ready['restored_from']} (events {events['node1_memory']})")
    differ = [i for i, (a, b) in enumerate(zip(ready["leaf_crc32"] or [],
                                               image_crcs)) if a != b]
    check(ready["leaf_crc32"] == image_crcs,
          f"{label}: the restored state differs from the lost image in "
          f"leaves {differ[:8]}")
    check(ready["leaf_crc32"] != planted_crcs,
          f"{label}: the bitwise gate passes a flipped element")
    check(c_ready["restored_from"] == "storage"
          and c_ready["restored_step"] == REPLICA_PERSIST
          and events["node1_storage"] == [{"step": REPLICA_PERSIST,
                                           "source": "storage"}]
          and "missing and on no peer" in logs["node1_storage"]
          and not _replica_log_transfers(logs["node1_storage"], "pull"),
          f"{label}: the control restored {c_ready['restored_step']} from "
          f"{c_ready['restored_from']} (events {events['node1_storage']})")
    incs0 = node0.incarnations()
    check([(i[0]["restored_from"], i[0]["restored_step"]) for i in incs0]
          == [(None, 0), ("memory", REPLICA_STEPS), ("memory", REPLICA_STEPS)],
          f"{label}: node 0's incarnations restored "
          f"{[(i[0]['restored_from'], i[0]['restored_step']) for i in incs0]}")
    left = [n for n in os.listdir("/dev/shm") if job in n]
    ports = [a for a in (addr0, addr1) if not _port_closed(a)]
    check(left == [] and socks == [] and ports == [],
          f"{label}: segments {left}, sockets {socks}, replica ports {ports} "
          f"left")
    launches = {}
    for _, launcher in launchers:
        for inc in launcher.incarnations():
            steps = [e for e in inc if e["event"] == "step"]
            if not steps:
                continue
            counts = steps[-1]["launches"]
            check(device != "cuda" or counts.get("flash_forward", 0) > 0,
                  f"{label}: a worker on the card launched no B1: {counts}")
            for name, v in counts.items():
                launches[name] = launches.get(name, 0) + v
    row = {
        "phase": label, "config": config, "device": device,
        "n_layers": ELASTIC_LAYERS if config == "flagship" else 2,
        "steps": REPLICA_STEPS, "kill_step": REPLICA_KILL,
        "storage_step": REPLICA_PERSIST,
        "image_bytes": lost_bytes,
        "push": {"step": push[0], "bytes": push[1], "s": push[2],
                 "gb_per_s": push[1] / 1e9 / max(push[2], 1e-9)},
        "pull": {"bytes": pulls[0][1], "s": pulls[0][2],
                 "gb_per_s": pulls[0][1] / 1e9 / max(pulls[0][2], 1e-9)},
        "relaunch_to_first_step_s": first["t"] - relaunch.spawned,
        "relaunch_to_ready_s": ready["t"] - relaunch.spawned,
        "memory_restore_s": ready["restore_s"],
        "storage_restore": {"step": REPLICA_PERSIST, "s": c_ready["restore_s"],
                            "bytes": storage_bytes},
        "control_to_ready_s": c_ready["t"] - control.spawned,
        "wall_s": wall, "timeline_s": marks,
        "launcher_rc": rcs, "pulled_bytes_equal": True,
        "restored_bitwise_equal": True, "planted_fault_rejected": True,
        "launches": launches,
    }
    emit(row)
    return launches


def phase_elastic_paths():
    """Phases 16 (``elastic_ckpt``) and 28 (``replica_restore``) at once,
    28 on a thread of its own: both spend most of their wall in process
    starts on the host, so together they take little more than the
    longer one (a cut for the script's time limit, PR 19). Each keeps
    its gates and prints its own row with its seconds. Returns their
    workers' B1/B2 launches, summed."""
    from concurrent.futures import ThreadPoolExecutor

    seconds = {}

    def run(name, fn):
        t0 = time.monotonic()
        out = fn()
        seconds[name] = time.monotonic() - t0
        return out

    t0 = time.monotonic()
    with ThreadPoolExecutor(1) as pool:
        replica = pool.submit(run, "replica_restore", phase_replica_restore)
        elastic = run("elastic_ckpt", phase_elastic_ckpt)
        replica_launches = replica.result()
    emit({"phase": "elastic_paths", **seconds,
          "wall_s": time.monotonic() - t0})
    return {name: n + replica_launches.get(name, 0)
            for name, n in elastic.items()}


DIST_STEPS, DIST_PERSIST = 5, 3
DIST_TIMEOUT_S = 300.0
_DIST_LAUNCH = ("--nnodes", "2", "--nproc_per_node", "1",
                "--max_restarts", "3", "--monitor_interval", "0.2",
                "-m", "dlrover_tpu_torch.testing.replica_worker")


def _event_walls(events_dir, name, kind):
    """Wall-clock stamps and contents of the ``kind`` ("begin"/"end")
    training events called ``name`` under ``events_dir``."""
    out = []
    for fname in sorted(os.listdir(events_dir)) if os.path.isdir(
            events_dir) else []:
        with open(os.path.join(events_dir, fname)) as f:
            out += [(e["ts"], e["content"]) for e in map(json.loads, f)
                    if e["name"] == name and e["type"] == kind]
    return sorted(out, key=lambda x: x[0])


def _http(port, method, path, payload=None):
    """One request to a local HTTP server: (status, parsed JSON or the
    text, seconds)."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path,
                     None if payload is None else json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read().decode()
        if resp.getheader("Content-Type") == "application/json":
            body = json.loads(body)
        return resp.status, body, time.perf_counter() - t0
    finally:
        conn.close()


def _dashboard_read(port, paths):
    """{path: (status, body)} of the dashboard's panels, read once."""
    return {path: _http(port, "GET", path)[:2] for path in paths}


def _dist_master_watch_gates(label, job, reads, detail, id1, id2,
                             serving_absent):
    """Phase 32's dashboard gates over its three reads; returns the
    numbers the phase prints. ``serving_absent``: the default registry
    holds no serving token family (no engine counted into it)."""
    from dlrover_tpu_torch.common.constants import NodeExitReason
    from dlrover_tpu_torch.diagnosis.collectors import parse_prometheus_text

    final = reads["final"]
    bad = {p: st for p, (st, _) in final.items() if st != 200}
    check(not bad and "<title>dlrover-tpu</title>" in final["/"][1],
          f"{label}: the dashboard's final panels answered {bad}")
    job_panel = final["/api/job"][1]
    want_table = {str(nid): row for nid, row in detail.items()}
    check(job_panel["job_name"] == job and job_panel["nodes"] == want_table,
          f"{label}: /api/job {job_panel}, want {job} and {want_table}")
    nodes = final["/api/nodes"][1]
    table = {str(r["id"]): {k: r[k] for k in (
        "type", "rank", "status", "relaunch_count", "host")} for r in nodes}
    by_rank = {rank: [(r["id"], r["relaunch_count"], r["exit_reason"])
                      for r in nodes if r["rank"] == rank] for rank in (0, 1)}
    check(table == want_table and len(by_rank[0]) == 1
          and by_rank[1] == [(id1, 0, NodeExitReason.PREEMPTED),
                             (id2, 1, by_rank[1][-1][2])],
          f"{label}: /api/nodes {nodes}, want get_job_detail()'s "
          f"{want_table} with rank 1 twice (first preempted)")
    node_status, node_page = reads["relaunched"][f"/api/node/worker-{id2}"]
    timeline = [e["status"] for e in (node_page or {}).get("timeline", [])] \
        if node_status == 200 else []
    check(len(timeline) >= 2 and timeline[-1] == node_page["status"],
          f"{label}: /api/node/worker-{id2} answered {node_status} "
          f"{node_page}")
    rdzv = {}
    for point in ("paused", "relaunched"):
        rows = [r for r in reads[point]["/api/rdzv"][1]
                if r["name"] == "training"]
        rdzv[point] = (rows[0]["round"], rows[0]["world_size"]) if rows \
            else None
    check(rdzv["paused"] is not None and rdzv["relaunched"] is not None
          and rdzv["paused"][1] == rdzv["relaunched"][1] == 2
          and rdzv["relaunched"][0] > rdzv["paused"][0] >= 1,
          f"{label}: /api/rdzv (round, world) at the pause and the "
          f"relaunch: {rdzv}")
    perf = final["/api/perf"][1]
    check(perf["global_step"] == DIST_STEPS,
          f"{label}: /api/perf's global step {perf['global_step']}, want "
          f"{DIST_STEPS}")
    plane = final["/api/control_plane"][1]
    verbs = {v: r["count"] for v, r in plane["rpc"]["verbs"].items()}
    check(plane["enabled"] is True and verbs
          and all(n > 0 for n in verbs.values()),
          f"{label}: /api/control_plane verbs {verbs}")
    check(final["/api/autoscaler"][1] == {"enabled": False},
          f"{label}: /api/autoscaler {final['/api/autoscaler'][1]}")
    goodput = {}
    for point, metrics, perf_now in (
            ("paused", reads["paused"]["/metrics"][1],
             reads["paused"]["/api/perf"][1]),
            ("final", final["/metrics"][1], perf)):
        scraped = parse_prometheus_text(metrics)
        goodput[point] = (scraped.get("dlrover_goodput"), perf_now["goodput"])
    prom_g, api_g = goodput["final"]
    check(prom_g is not None and api_g > 0
          and abs(prom_g - api_g) <= 1e-9 * max(1, api_g),
          f"{label}: /metrics' dlrover_goodput {prom_g}, /api/perf's "
          f"{api_g} (the workers report their train phases)")
    # The serving branch: the engine phases' own token counts, when they
    # ran in this process; disabled when no engine counted into the
    # default registry; else (another engine in this process, as under
    # pytest) only that it is enabled.
    serving = final["/api/goodput"][1]["serving"]
    if SERVING_TOKENS:
        serving_ok = serving.get("enabled") is True and (
            serving["tokens_by_kind"] == SERVING_TOKENS
            and serving["tokens_total"] == sum(SERVING_TOKENS.values())
            and serving["tokens_wasted_total"] == 0)
    elif serving_absent:
        serving_ok = serving == {"enabled": False}
    else:
        serving_ok = serving.get("enabled") is True
    check(serving_ok,
          f"{label}: /api/goodput's serving {serving}, the engine phases "
          f"counted {SERVING_TOKENS} (no family: {serving_absent})")
    return {"rdzv_round_world": rdzv, "global_step": perf["global_step"],
            "speed": perf["speed"], "goodput": goodput,
            "rpc_verbs": verbs, "metrics_samples": len(parse_prometheus_text(
                final["/metrics"][1])),
            "relaunched_timeline": timeline,
            "serving_tokens": serving.get("tokens_by_kind")}


# The panels phase 32 reads after the run, the job's final state.
DIST_FINAL_PANELS = ("/", "/api/job", "/api/nodes", "/api/perf",
                     "/api/control_plane", "/api/autoscaler", "/api/goodput",
                     "/metrics")


def phase_dist_master(device="cuda", config="flagship"):
    """The distributed master on the simulated cluster, built from the
    CLI's own parse (``DistributedJobMaster.from_args(parse_master_args(
    ["--platform", "sim", "--node_num", "2", "--transport", "http",
    "--pre_check"]))``) in this process: ``prepare()``, then
    ``pre_check()`` and ``run()`` on a thread. This process plays the
    cluster's hosts, as a kubelet would: it polls the master's sim
    cluster (through the master's scaler, ``list_nodes()``) and starts
    one ``python -m dlrover_tpu_torch.run --master <addr> --nnodes 2
    --node_rank <rank> --nproc_per_node 1`` launcher for each running
    node, over ``testing/replica_worker`` (the flagship's train state at
    ELASTIC_LAYERS layers on ``device``, the same batches on both ranks,
    no process group; a persist every DIST_PERSIST steps); a launcher
    that exits is reported to the cluster (``succeed_node`` on 0,
    ``fail_node`` otherwise). Both ranks' first workers train
    DIST_PERSIST steps and pause (``--pause-at``); once that step is
    committed, node 1's launcher and worker are SIGKILLed, its segment
    unlinked and the node reported ``preempt_node``: the master's
    relaunch machinery creates rank 1's next incarnation through
    ``SimScaler``, this process starts its launcher, the world re-forms
    (node 0's agent restarts its worker) and both ranks train from the
    committed step to DIST_STEPS. Gates: ``run()`` returns 0 with
    ``exit_reason`` SUCCEEDED and the pre-check passed;
    ``get_job_detail()`` shows rank 1 with two incarnations (the first
    PREEMPTED and deleted, the second succeeded, relaunch count 1) and
    rank 0 with one, and no other node; the relaunched worker restored
    the step the master had committed from storage (its
    ``restore_read``), node 0's restarted worker the same step from its
    memory; every step after it ran once on each rank, in the re-formed
    world; both nodes' last images have equal leaf crc32s; each
    incarnation's B1/B2 launches are n_layers per step.

    The master also serves its dashboard (``--dashboard_port 0``) and
    reports to a brain (``--brain_addr``): this process starts the
    port's ``BrainService`` on port 0 (a sqlite store under the phase's
    root) before the master and stops it after ``master.stop()``, which
    posts the job's completion record. The dashboard is read at the
    phase's wait points only (both ranks paused at the committed step;
    the relaunch's first step; after ``run()`` returns, when the phase
    serves the master's stopped ``DashboardServer`` once more to read
    the job's final state). Gates: the page answers; ``/api/job`` names
    the job; ``/api/nodes`` is ``get_job_detail()``'s table (rank 1's
    two incarnations, the first PREEMPTED, the second relaunched once;
    rank 0's one); the relaunched node's ``/api/node/`` page has a
    status timeline; ``/api/rdzv`` shows a world of 2 at the pause and
    at the relaunch, the second in a later round; ``/api/perf``'s
    global step reaches DIST_STEPS (the workers report each step);
    ``/api/control_plane`` counts every verb's RPCs; ``/api/autoscaler``
    is disabled; ``/metrics`` parses with the port's
    ``parse_prometheus_text`` and its ``dlrover_goodput`` is
    ``/api/perf``'s to the exposition's 10 digits and above 0 (each
    worker reports each step as a train phase); ``/api/goodput``'s
    serving branch holds, token for token, what the engine phases of
    this process counted (SERVING_TOKENS; disabled when no engine
    counted into the default registry). The brain holds the completion
    record, SUCCEEDED, and a runtime sample with 2 workers, speed > 0
    and step DIST_STEPS: the collector's ``collect_once`` at the wait
    point where both ranks have saved their last step (its 30 s timer
    may or may not fall between the first step and the end of ``run()``:
    its samples are counted and their times printed beside the phase's);
    ``/optimize`` answers with the plan and the three evaluators'
    assessments of those records. Returns the workers' B1/B2 launches."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from dlrover_tpu_torch.brain import evaluators
    from dlrover_tpu_torch.brain.service import BrainService
    from dlrover_tpu_torch.common.constants import (
        JobExitReason,
        NodeEnv,
        NodeExitReason,
        NodeStatus,
    )
    from dlrover_tpu_torch.fault import SCHEDULE_ENV
    from dlrover_tpu_torch.flash_ckpt.shm_handler import SharedMemoryHandler
    from dlrover_tpu_torch.master.args import parse_master_args
    from dlrover_tpu_torch.master.dist_master import DistributedJobMaster
    from dlrover_tpu_torch.master.node.job_context import JobContext
    from dlrover_tpu_torch.observability.registry import default_registry
    from dlrover_tpu_torch.testing.replica_worker import image_digest

    label = "dist_master"
    repo = os.path.dirname(os.path.abspath(__file__))
    # Storage on /dev/shm where the host has it (the default temp dir of
    # the card's host is a network file system).
    root = tempfile.mkdtemp(prefix="dist_master_", dir=(
        "/dev/shm" if os.path.isdir("/dev/shm") else None))
    job = f"chipsmoke{os.getpid()}dist"
    ckpt_dir = os.path.join(root, "ckpt")
    release = os.path.join(root, "release")
    n_layers = ELASTIC_LAYERS if config == "flagship" else 2
    model = (["--config", "flagship", "--layers", str(n_layers),
              "--seq", "128"] if config == "flagship"
             else ["--config", "tiny", "--layers", "2", "--seq", "8"])

    def segment(rank):
        # ``shm_segment_name(0)`` under the node's env, built without
        # setting the process env: this phase runs beside others that
        # set it.
        return f"dlrover_tpu_ckpt_{job}_n{rank}_0"

    JobContext.reset_singleton()
    brain = BrainService(port=0, data_dir=os.path.join(root, "brain"),
                         store="sqlite")
    brain.start()
    t_phase, wall_phase = time.monotonic(), time.time()
    master = DistributedJobMaster.from_args(parse_master_args(
        ["--platform", "sim", "--node_num", "2", "--transport", "http",
         "--pre_check", "--job_name", job, "--dashboard_port", "0",
         "--brain_addr", f"127.0.0.1:{brain.port}"]))
    cluster = master.job_manager._scaler._cluster  # noqa: SLF001
    master.prepare()
    t_ready = time.monotonic()
    dash_port = master.dashboard.port
    served, reads = {}, {}

    def serve():
        served["pre_check"] = master.pre_check()
        if served["pre_check"]:
            served["rc"] = master.run()
        else:
            master.stop()
            served["rc"] = 1

    server = threading.Thread(target=serve, name="dist-master", daemon=True)
    server.start()
    launchers = {}          # cluster node id -> (rank, tag, _Launcher)
    reported, lost = {}, set()

    def launch(node):
        rank = node.rank_index
        tag = f"node{node.id}_rank{rank}"
        node_dir = os.path.join(root, tag)
        os.makedirs(node_dir)
        env = dict(os.environ, PYTHONPATH=repo, DLROVER_TPU_JOB_NAME=job,
                   DLROVER_TPU_SHARED_DIR=os.path.join(root, f"sock{rank}"),
                   DLROVER_TPU_EVENT_DIR=os.path.join(node_dir, "events"),
                   DLROVER_TPU_FLIGHT_DIR=os.path.join(root, "flight"))
        env.pop(SCHEDULE_ENV, None)
        env.pop(NodeEnv.NODE_RANK, None)
        launchers[node.id] = (rank, tag, _Launcher(
            model + ["--device", device, "--seed", str(SEED),
                     "--micro-batch", "1", "--steps", str(DIST_STEPS),
                     "--persist-every", str(DIST_PERSIST),
                     "--pause-at", str(DIST_PERSIST),
                     "--ckpt-dir", ckpt_dir, "--hold-file", release],
            env, os.path.join(node_dir, "launcher.log"),
            launch=("--master", f"localhost:{master.port}", "--node_rank",
                    str(rank), *_DIST_LAUNCH), phase=label))

    def kubelet():
        """One poll: a launcher for each running node without one; each
        exited launcher's node reported to the cluster once."""
        for node in cluster.list_nodes():
            if node.status == NodeStatus.RUNNING and node.id not in launchers:
                launch(node)
        for node_id, (_, _, launcher) in list(launchers.items()):
            rc = launcher.proc.poll()
            if rc is None or node_id in reported or node_id in lost:
                continue
            reported[node_id] = rc
            (cluster.succeed_node if rc == 0 else cluster.fail_node)(node_id)

    def until(cond, what, master_exits=False):
        deadline = time.monotonic() + DIST_TIMEOUT_S
        while True:
            kubelet()
            if cond():
                return
            check(master_exits or server.is_alive(),
                  f"{label}: the master exited ({served}) before {what}")
            check(time.monotonic() < deadline,
                  f"{label}: no {what} in {DIST_TIMEOUT_S} s")
            time.sleep(0.05)

    def by_rank(rank):
        return [(nid, lc) for nid, (r, _, lc) in sorted(launchers.items())
                if r == rank]

    def last_event(launcher, event, step):
        """The launcher's last incarnation has had ``event`` at
        ``step``."""
        incs = launcher.incarnations()
        return bool(incs) and any(
            e["event"] == event and e["step"] == step for e in incs[-1])

    try:
        until(lambda: len(launchers) == 2, "a launcher for each node")
        (id0, node0), = by_rank(0)
        (id1, first1), = by_rank(1)
        until(lambda: last_event(node0, "paused", DIST_PERSIST)
              and last_event(first1, "paused", DIST_PERSIST)
              and master.job_manager.get_committed_ckpt_step()
              >= DIST_PERSIST,
              f"both nodes paused at the committed step {DIST_PERSIST}")
        first_steps = [lc.wait_event(lambda e: e["event"] == "step",
                                     "a first step")["t"]
                       for lc in (node0, first1)]
        committed_at_kill = master.job_manager.get_committed_ckpt_step()
        reads["paused"] = _dashboard_read(
            dash_port, ("/api/rdzv", "/api/perf", "/metrics"))
        # The host is lost: launcher (its agent) and worker at once, its
        # segment with it; the cluster reports a preemption.
        _, workers = first1.pids()
        pids = [first1.proc.pid, *workers]
        lost.add(id1)
        for pid in pids:
            if not _proc_gone(pid):
                os.kill(pid, signal.SIGKILL)
        until(lambda: all(_proc_gone(p) for p in pids), "exit of node 1")
        SharedMemoryHandler(segment(1)).unlink()
        t_lost = time.monotonic()
        cluster.preempt_node(id1)
        until(lambda: len(by_rank(1)) == 2, "rank 1's relaunched node")
        t_relaunched = time.monotonic()
        (id2, relaunch), = by_rank(1)[1:]
        ready = relaunch.wait_event(lambda e: e["event"] == "ready",
                                    "the relaunch's ready line",
                                    DIST_TIMEOUT_S)
        first = relaunch.wait_event(lambda e: e["event"] == "step",
                                    "the relaunch's first step",
                                    DIST_TIMEOUT_S)
        reads["relaunched"] = _dashboard_read(
            dash_port, ("/api/rdzv", f"/api/node/worker-{id2}"))
        # The world re-formed: node 0's agent restarted its worker, which
        # restored the committed step from its memory and trains on.
        until(lambda: last_event(relaunch, "saved", DIST_STEPS)
              and len(node0.incarnations()) >= 2
              and last_event(node0, "saved", DIST_STEPS),
              "both nodes' last saves")
        # Both ranks alive at their last step: one sample of the
        # collector to the brain, whatever its timer's phase.
        t_sample = time.time()
        watch_sample = master.metric_collector.collect_once()
        t_sampled = time.time()
        # Both images' crc32s at once (zlib lets go of the GIL).
        with ThreadPoolExecutor(2) as pool:
            digests = list(pool.map(image_digest, map(segment, (0, 1))))
        with open(release, "w"):
            pass
        until(lambda: not server.is_alive(), "the master's exit",
              master_exits=True)
        wall = time.monotonic() - t_phase
        job_nodes = master.job_manager.worker_manager.nodes
        detail = master.job_manager.get_job_detail().nodes
        # run() stopped the master, its dashboard with it: the same
        # server serves the job's final state once more.
        master.dashboard.start()
        try:
            reads["final"] = _dashboard_read(master.dashboard.port,
                                             DIST_FINAL_PANELS)
        finally:
            master.dashboard.stop()
        serving_absent = default_registry().get(
            "serving_tokens_total") is None
    finally:
        for _, _, launcher in launchers.values():
            launcher.stop()
        if server.is_alive():
            master.request_stop()
            server.join(timeout=30)
        socks = []
        for r in (0, 1):
            sock_dir = os.path.join(root, f"sock{r}")
            if os.path.isdir(sock_dir):
                socks += os.listdir(sock_dir)
        _unlink_job_segments(job)
    try:
        tags = {nid: tag for nid, (_, tag, _) in launchers.items()}
        rdzv = _event_walls(os.path.join(root, tags[id2], "events"),
                            "rendezvous", "begin")
        rdzv_end = _event_walls(os.path.join(root, tags[id2], "events"),
                                "rendezvous", "end")
        started = _log_walls(relaunch.log(), "started worker")
        # The brain after master.stop(): its records of the job, what
        # /optimize makes of them (against the three evaluators run here
        # on the same store), and one round trip of each verb.
        brain_runtime = brain.store.load("runtime", job_name=job)
        brain_done = brain.store.load("completion", job_name=job)
        assess_want = [a for a in (
            evaluators.EVALUATORS[name](brain.store).evaluate(job)
            for name in sorted(evaluators.EVALUATORS)) if a is not None]
        opt_status, optimized, optimize_s = _http(
            brain.port, "POST", "/optimize", {"job_name": job})
        persist_status, _, persist_s = _http(
            brain.port, "POST", "/persist_metrics", {
                "kind": "runtime", "record": {"job_name": job + "-probe"}})
        brain_evaluators = _http(brain.port, "GET", "/admin/evaluators")[1]
    finally:
        brain.stop()
        shutil.rmtree(root, ignore_errors=True)

    check(served.get("pre_check") is True,
          f"{label}: the pre-check did not pass ({served})")
    check(served.get("rc") == 0
          and master.exit_reason == JobExitReason.SUCCEEDED,
          f"{label}: run() returned {served.get('rc')} with exit reason "
          f"{master.exit_reason!r}")
    # (A succeeded node's exit reason is the cluster's "Succeeded" or,
    # when its agent's success report came first and the master exited
    # before the cluster's event, empty.)
    table = sorted((n.rank_index, nid, n.status, n.relaunch_count)
                   for nid, n in job_nodes.items())
    want = [(0, id0, NodeStatus.SUCCEEDED, 0),
            (1, id1, NodeStatus.DELETED, 0),
            (1, id2, NodeStatus.SUCCEEDED, 1)]
    check(table == want and sorted(detail) == sorted(job_nodes)
          and job_nodes[id1].exit_reason == NodeExitReason.PREEMPTED,
          f"{label}: the master's nodes {table} (node {id1}'s exit reason "
          f"{job_nodes[id1].exit_reason!r}), want {want} (detail {detail})")
    check(ready["restored_from"] == "storage"
          and ready["restored_step"] == committed_at_kill == DIST_PERSIST
          and ready["restore_read"]["tracker_step"] == committed_at_kill,
          f"{label}: the relaunch restored {ready['restored_step']} from "
          f"{ready['restored_from']} (read {ready['restore_read']}), the "
          f"master had committed {committed_at_kill}")
    node0_incs = node0.incarnations()
    reformed = [e for e in node0_incs[-1] if e["event"] == "ready"]
    check(len(node0_incs) == 2 and reformed
          and reformed[0]["restored_from"] == "memory"
          and reformed[0]["restored_step"] == committed_at_kill,
          f"{label}: node 0's {len(node0_incs)} incarnations, the last "
          f"restored {reformed}")
    ran = {0: [[e["step"] for e in inc if e["event"] == "step"]
               for inc in node0_incs],
           1: [[e["step"] for e in inc if e["event"] == "step"]
               for lc in (first1, relaunch) for inc in lc.incarnations()]}
    before = list(range(1, committed_at_kill + 1))
    after = list(range(committed_at_kill + 1, DIST_STEPS + 1))
    check(all(r == [before, after] for r in ran.values()),
          f"{label}: steps run by incarnation {ran}, want "
          f"{[before, after]} on each rank")
    check(all(d is not None and d["step"] == DIST_STEPS for d in digests)
          and digests[0]["leaf_crc32"] == digests[1]["leaf_crc32"],
          f"{label}: the nodes' last images differ: "
          f"{[(d or {}).get('step') for d in digests]}")
    left = [n for n in os.listdir("/dev/shm") if job in n]
    check(left == [] and socks == [],
          f"{label}: segments {left}, sockets {socks} left")
    launches = {}
    per_inc = []
    for _, _, launcher in launchers.values():
        for inc in launcher.incarnations():
            steps = [e for e in inc if e["event"] == "step"]
            if not steps:
                continue
            counts = steps[-1]["launches"]
            want_n = n_layers * len(steps) if device == "cuda" else 0
            per_inc.append((len(steps), counts))
            check(all(v == want_n for v in counts.values()),
                  f"{label}: an incarnation ran {len(steps)} steps with "
                  f"launches {counts}, want {want_n} each")
            for name, v in counts.items():
                launches[name] = launches.get(name, 0) + v
    watch = _dist_master_watch_gates(
        label, job, reads, detail, id1, id2, serving_absent)
    samples = [r for r in brain_runtime
               if r.get("worker_count") == 2 and r.get("speed", 0) > 0]
    watched = [r for r in brain_runtime
               if t_sample <= r["ts"] <= t_sampled
               and r["worker_count"] == watch_sample.worker_count == 2
               and r["speed"] == watch_sample.speed > 0
               and r["global_step"] == DIST_STEPS]
    check(watched and len(brain_done) == 1
          and brain_done[0]["exit_reason"] == JobExitReason.SUCCEEDED
          and brain_done[0]["success"] is True,
          f"{label}: the brain holds runtime {brain_runtime} (the "
          f"sample at the last saves: {watch_sample}) and completions "
          f"{brain_done}")
    check(opt_status == 200 and persist_status == 200
          and optimized["plan"] is not None
          and optimized["assessments"] == assess_want
          and brain_evaluators["evaluators"] == [
              "oom_risk", "straggler", "throughput_trend"],
          f"{label}: /optimize answered {opt_status} {optimized} (want "
          f"assessments {assess_want}; evaluators {brain_evaluators})")
    # The collector's timer against the job: its samples' times, the
    # first step's and the end of run(), from the phase's start.
    emit({"phase": "dist_master_watch", **watch,
          "brain": {"runtime_samples": len(brain_runtime),
                    "samples_2_workers_moving": len(samples),
                    "sample_at_s": [r["ts"] - wall_phase
                                    for r in brain_runtime],
                    "watched_sample_at_s": watched[0]["ts"] - wall_phase,
                    "first_step_at_s": max(first_steps) - t_phase,
                    "run_end_at_s": wall,
                    "last_sample": {k: brain_runtime[-1].get(k) for k in (
                        "global_step", "speed", "goodput", "worker_count")},
                    "completion": {k: brain_done[0].get(k) for k in (
                        "success", "exit_reason", "duration_s",
                        "failure_count")},
                    "plan": optimized["plan"],
                    "assessments": optimized["assessments"],
                    "optimize_ms": optimize_s * 1e3,
                    "persist_metrics_ms": persist_s * 1e3}})
    to_wall = wall_phase - t_phase
    spawn_wall = relaunch.spawned + to_wall
    split = {
        "sim_relaunch_s": t_relaunched - t_lost,
        "launcher_start_s": (rdzv[0][0] - spawn_wall) if rdzv else None,
        "rendezvous_s": rdzv_end[0][1]["duration_s"] if rdzv_end else None,
        "worker_start_s": ((ready["t"] + to_wall - started[0])
                           - ready["restore_s"]) if started else None,
        "restore_s": ready["restore_s"],
        "first_step_s": first["t"] - ready["t"],
    }
    row = {
        "phase": label, "config": config, "device": device,
        "n_layers": n_layers, "steps": DIST_STEPS,
        "persist_every": DIST_PERSIST, "committed_at_kill": committed_at_kill,
        "master_ready_s": t_ready - t_phase,
        "ready_to_first_step_s": {"rank0": first_steps[0] - t_ready,
                                  "rank1": first_steps[1] - t_ready},
        "loss_to_first_step_s": first["t"] - t_lost,
        "loss_split_s": split,
        "wall_s": wall, "nodes": table,
        "lost_exit_reason": job_nodes[id1].exit_reason, "steps_run": ran,
        "pre_check": True, "exit_reason": master.exit_reason,
        "leaf_crc32_equal": True, "launches_per_incarnation": per_inc,
        "launches": launches,
    }
    emit(row)
    return launches


CONTROL_PLANE_WORKERS = 1024
CONTROL_PLANE_TIMEOUT_S = 120.0


def phase_control_plane(workers=CONTROL_PLANE_WORKERS):
    """The master's saturation harness on the host, alone:
    ``tools/torch_bench_control_plane.py --workers N`` in a process of
    its own (``testing/control_plane_soak``: N sim workers over the HTTP
    transport against one ``MasterServicer``; the ramp, time to quorum
    at worlds 8 to N, the shed phase). Its three invariants (the shed
    ordering law, the bounded buffers' accounting, the per-verb metric
    and span means within 15%) raise inside it, and fail the phase
    through its exit code. Prints max sustainable RPCs/s, master CPU s
    per 1k RPCs, time to quorum per world and the shed counts."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "tools",
                                      "torch_bench_control_plane.py"),
         "--workers", str(workers)],
        env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
        text=True, timeout=CONTROL_PLANE_TIMEOUT_S)
    wall = time.monotonic() - t0
    tail = proc.stderr[-2000:]
    check(proc.returncode == 0,
          f"control_plane: the bench exited {proc.returncode}: {tail}")
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    check(rep["invariants"] == "pass" and rep["max_rps"] > 0
          and rep["cpu_s_per_1k_rpcs"] > 0 and rep["shed_diagnostic"] > 0
          and rep[f"quorum_{workers}_s"] > 0,
          f"control_plane: {rep}")
    emit({"phase": "control_plane", **rep, "wall_s": wall})
    return rep


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
    eng_launches, served = timed("engine", phase_engine, cfg, params,
                                 shared=True)
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
    # exactly per worker inside the phase; beside it, a node lost with
    # its host restores from its peer's memory (two nodes' workers on the
    # card, their launches counted from their step lines).
    for name, n in timed("elastic_paths", phase_elastic_paths).items():
        launches[name] += n
    # The mesh: the sharded step on a world of one (B1/B2 exact inside),
    # the resharding restore across the card and a CPU world, the node
    # check.
    mesh_cfg = _config("flagship_mesh")
    mesh_state, mesh_launches = timed("mesh_train", phase_mesh_train,
                                      mesh_cfg)
    for name, n in mesh_launches.items():
        launches[name] += n
    timed("reshard_restore", phase_reshard_restore, mesh_cfg, mesh_state,
          config="flagship_mesh")
    del mesh_state
    torch.cuda.empty_cache()
    timed("node_check", phase_node_check)
    # The distributed master on the simulated cluster, alone: two
    # launchers' workers on the card, one host lost and relaunched by the
    # master (B1/B2 exact per incarnation inside).
    for name, n in timed("dist_master", phase_dist_master).items():
        launches[name] += n
    # The soak's fleet and autoscaler episodes, beside each other only:
    # the fleet replica processes' heartbeats count B6, from zero in
    # each process.
    for name, n in timed("soak_episodes", phase_soak_episodes).items():
        launches[name] += n
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
    # gshard MoE under sp as each sp rank computes it (plain PyTorch, no
    # kernel), and the checkpoint bridges (DCP, the HF callback) on the
    # flagship's train state.
    timed("gshard_sp_body", phase_gshard_sp_body)
    timed("ckpt_bridges", phase_ckpt_bridges)
    # The live rescale plane (the episode's workers hold their state on
    # the card), the launcher's network check and the agent's warm
    # standby: control planes on the host, each gated inside its phase.
    timed("live_rescale", phase_live_rescale)
    timed("agent_paths", phase_agent_paths)
    # The chaos soak (worker state on the card, its serving scenario's
    # B5 launches counted from a reset just before it) and the master
    # killed and restarted from its journal.
    for name, n in timed("chaos_soak", phase_chaos_soak).items():
        launches[name] += n
    timed("master_kill", phase_master_kill)
    # The master's saturation harness on the host, alone.
    timed("control_plane", phase_control_plane)
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
