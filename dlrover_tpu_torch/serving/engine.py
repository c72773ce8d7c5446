"""Continuous-batching decode engine: slot-pooled KV cache, ragged
per-slot fills, iteration-level scheduling (port of
``dlrover_tpu/serving/engine.py``).

- **Slot pool.** One [layers, slots, max_len, kv_heads, head_dim] K and
  V slab in the compute dtype, allocated once and updated in place;
  occupancy is host bookkeeping (``scheduler.py``) and per-slot fill
  lengths are a host [slots] vector passed to every step.
- **Ragged decode.** One step decodes every active slot at its own fill:
  per-row positions drive RoPE, each slot's new K/V row lands at its own
  cursor ``min(length, max_len - 1)``, and the decode-attention kernel
  (``ops/decode_attention.py``) reads each slot's filled rows only.
  Inactive slots attend over zero rows; their outputs are discarded.
- **Chunked prefill.** Prompts enter ``prefill_chunk`` tokens at a time,
  one slot per call, through plain attention over that slot's cache rows
  with a positional causal mask, so a long prompt interleaves with
  decode iterations instead of stalling them.

- **Speculative decoding** (``spec_k > 0``, ``serving/spec_decode.py``).
  Each iteration drafts up to ``spec_k`` tokens per decoding slot (the
  host n-gram drafter, or the early-exit drafter: the first
  ``spec_draft_layers`` blocks through the decode kernel), then ONE
  verify step runs the fed token and the drafts, [slots, spec_k + 1]
  tokens, through the whole model with the cache read-only, appends
  their rows and applies the accept law; the fill advances by the
  accepted drafts plus one. The verify step replaces the decode step
  entirely (draft_len 0 is one-token decode through it). Rows a step
  would write at or past ``max_len``, and every row of an inactive
  slot, are dropped, never clamped onto a row that can become visible.

The paged engine (``serving/kvpool``) subclasses this one and overrides
the pool hooks and the device steps.

- **Observability and faults.** Each iteration passes the
  ``serving.step.error`` fault point before its device steps (a raise
  there takes the step-error recovery path); admissions, sheds,
  finishes and errors drop flight-recorder markers
  (``ServingMetrics.annotate``); a terminal request emits its phase
  spans (queue wait, prefill, migrate, decode, with spec draft/verify
  sub-spans) retrospectively, parented to the carrier ``submit(...,
  trace=)`` brought, when tracing is armed.

Typical use::

    eng = ServingEngine(cfg, params, slots=8, max_len=1024)
    eng.submit(prompt_ids, max_new_tokens=64, temperature=0.8)
    while eng.pending():
        for req in eng.step():
            consume(req.rid, req.tokens)
"""

import time
from typing import List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.fault import fault_point
from dlrover_tpu_torch.models import generate as gen_lib
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.serving import scheduler as sched_lib
from dlrover_tpu_torch.serving import spec_decode as spec_lib
from dlrover_tpu_torch.serving.metrics import serving_metrics
from dlrover_tpu_torch.serving.scheduler import DECODE, Request, Scheduler

# Lookback horizon of the host n-gram drafter: the rightmost suffix
# match decides the proposal, so only recent history can win, and the
# per-step host cost stays flat as sequences grow.
_NGRAM_WINDOW = 128


class ServingEngine:
    """Single-host continuous-batching engine over a slot-pooled cache.

    Host bookkeeping (the Scheduler) is torch-free; each ``step()`` runs
    at most one prefill chunk and one ragged decode iteration. The
    engine is not thread-safe — drive it from one serving loop.
    ``call_counts`` counts the device steps run (``prefill``,
    ``decode``, ``draft``, ``verify``; warmup's included): each decode
    step launches the decode kernel once a layer, each early-exit draft
    call ``spec_k`` times a draft layer, the verify step not at all."""

    def __init__(
        self,
        config: llama.TpuLMConfig,
        params,
        slots: int,
        max_len: int,
        prefill_chunk: int = 64,
        token_budget: Optional[int] = None,
        drain_mode: bool = False,
        generator: Optional[torch.Generator] = None,
        registry=None,
        max_requeues: int = 3,
        slo_classes=None,
        spec_k: int = 0,
        spec_drafter: str = "ngram",
        spec_draft_layers: int = 2,
        device="cuda",
    ):
        llama.require_flat_stack(config, "serving")
        if max_len % 8:
            raise ValueError("max_len must be a multiple of 8")
        if max_len % prefill_chunk:
            # Chunk starts are multiples of prefill_chunk (a partial
            # chunk only ever ENDS a prompt), so divisibility keeps every
            # fixed-size chunk write inside the slot's max_len rows.
            raise ValueError(
                f"max_len {max_len} must be a multiple of "
                f"prefill_chunk {prefill_chunk}"
            )
        if spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        if spec_k:
            if spec_drafter not in spec_lib.SPEC_DRAFTERS:
                raise ValueError(
                    f"spec_drafter must be one of "
                    f"{spec_lib.SPEC_DRAFTERS}, got {spec_drafter!r}"
                )
            if spec_drafter == "early_exit" and not (
                0 < spec_draft_layers <= config.n_layers
            ):
                raise ValueError(
                    f"spec_draft_layers must be in 1..{config.n_layers}"
                )
        self.config = config
        self.slots = slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.spec_k = spec_k
        self.spec_drafter = spec_drafter
        # 0 = no device drafter (the n-gram drafter is host code).
        self.spec_draft_layers = (
            spec_draft_layers
            if spec_k and spec_drafter == "early_exit" else 0
        )
        self.device = gen_lib.resolve_device(device)
        # How many step-error restarts a request gets before it is
        # EXPLICITLY failed — a persistent device error must not
        # livelock the serve loop re-queueing the same work forever.
        self.max_requeues = max_requeues
        self.scheduler = Scheduler(
            slots, max_len, prefill_chunk, token_budget, drain_mode,
            slo_classes=slo_classes, decode_tokens_per_slot=1 + spec_k,
        )
        self.metrics = serving_metrics(registry)
        self.metrics.slots_total.set(slots)
        self._params = gen_lib.prepare_decode_params(
            config, params, self.device
        )
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        self._generator = generator
        # Tokens decoded in the current iteration (per-token latency).
        self._iter_decoded = 0
        self._step_idx = 0
        # Running accepted-tokens-per-step mean (one decoding slot
        # through one verify step is one slot-step).
        self._spec_emitted = 0
        self._spec_slot_steps = 0
        self.call_counts = {"prefill": 0, "decode": 0, "draft": 0,
                            "verify": 0}
        self._k, self._v = self._fresh_pool()
        # Host mirrors of the per-slot state, passed into every step.
        self._lengths = np.zeros(slots, np.int32)
        self._tokens = np.zeros(slots, np.int32)
        self._temps = np.zeros(slots, np.float32)

    def _fresh_pool(self):
        shape = (
            self.config.n_layers, self.slots, self.max_len,
            self.config.n_kv_heads, self.config.head_dim,
        )
        dtype = self.config.compute_dtype
        return (
            torch.zeros(shape, dtype=dtype, device=self.device),
            torch.zeros(shape, dtype=dtype, device=self.device),
        )

    # ---- public API --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0,
               deadline_s: Optional[float] = None,
               trace: Optional[dict] = None,
               slo_class: Optional[str] = None) -> Request:
        req = self.scheduler.submit(
            prompt, max_new_tokens, temperature, deadline_s=deadline_s,
            slo_class=slo_class,
        )
        # Upstream trace carrier (fleet attempt span): the phase spans
        # are emitted retrospectively at completion, so the step loop
        # never touches the tracer.
        req.trace = trace
        self.metrics.queue_depth.set(len(self.scheduler.queue))
        return req

    def cancel(self, req: Request) -> None:
        """Evict a live request; its slot is recycled immediately."""
        if req.state == sched_lib.DONE:
            return
        if req.state == sched_lib.QUEUED:
            try:
                self.scheduler.queue.remove(req)
            except ValueError:
                pass
        slot = req.slot
        self.scheduler.evict(req)
        if slot >= 0:
            self._release_slot(req, slot)
        self.metrics.requests.inc(outcome="cancelled")
        self.metrics.annotate("serving_evict", rid=req.rid)

    def pending(self) -> int:
        """Requests not yet DONE (queued + in a slot)."""
        return len(self.scheduler.queue) + len(self.scheduler.active())

    def warmup(self) -> None:
        """Run one prefill chunk, one decode step and, with spec on, one
        draft and one verify step on throwaway state (building the
        kernels at first use), then reset the pool — so the first real
        request pays no build."""
        chunk = np.zeros((1, self.prefill_chunk), np.int32)
        self._prefill(chunk, 0, 0, 1, 0.0)
        self._decode(np.zeros(self.slots, bool))
        self._warmup_spec()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._reset_pool()

    def _warmup_spec(self) -> None:
        """The spec steps on throwaway state, every slot inactive."""
        if not self.spec_k:
            return
        inactive = np.zeros(self.slots, bool)
        drafts = np.zeros((self.slots, self.spec_k), np.int32)
        if self.spec_drafter == "early_exit":
            drafts = self._spec_draft_device(inactive)
        self._spec_verify_device(inactive, drafts,
                                 np.zeros(self.slots, np.int32))

    def step(self) -> List[Request]:
        """One scheduler iteration: admissions, at most one prefill
        chunk, one ragged decode step. Returns requests finished THIS
        iteration (tokens fully populated)."""
        t0 = time.monotonic()
        sch = self.scheduler
        finished: List[Request] = []
        self._iter_decoded = 0
        for req in sch.shed_expired(t0):
            self._report_shed(req, finished)
        for req in sch.admit(t0):
            self._admit_slot(req)
            if req.requeues == 0:
                # Re-admission after a step-error requeue is not a new
                # request.
                self.metrics.requests.inc(outcome="admitted")
            self.metrics.annotate(
                "serving_admit", rid=req.rid, slot=req.slot,
                prompt_len=req.prompt_len, requeues=req.requeues,
            )
        for req in sch.drain_admission_shed():
            self._report_shed(req, finished)
        try:
            fault_point("serving.step.error", step_idx=self._step_idx)
            pf = sch.pick_prefill()
            if pf is not None:
                self._run_prefill_chunk(pf, finished)
            decoding = sch.decoding()
            if decoding:
                self._run_decode(decoding, finished)
        except Exception as e:  # noqa: BLE001 — device errors vary
            self._recover_from_step_error(e, finished)
            self._iter_decoded = 0
        self._step_idx += 1
        self.metrics.iterations.inc()
        self.metrics.queue_depth.set(len(sch.queue))
        for name, depth in sch.queue_depth_by_class().items():
            self.metrics.class_queue_depth.set(depth, slo_class=name)
        self.metrics.active_slots.set(len(sch.active()))
        self._sync_pool_metrics()
        if self._iter_decoded:
            per_tok = (time.monotonic() - t0) / self._iter_decoded
            for _ in range(self._iter_decoded):
                self.metrics.token_latency.observe(per_tok)
        return finished

    def run_until_idle(self, max_iters: int = 100000) -> List[Request]:
        """Drive step() until nothing is pending; returns all finished."""
        done: List[Request] = []
        for _ in range(max_iters):
            if not self.pending():
                return done
            done.extend(self.step())
        raise RuntimeError(
            f"engine did not drain within {max_iters} iterations"
        )

    # ---- pool hooks (overridden by the paged engine, serving/kvpool) -------

    def _admit_slot(self, req: Request) -> None:
        """Bind engine-side per-slot state for a freshly admitted
        request. A recycled slot starts from fill 0: stale KV above the
        cursor is invisible and rewritten before visibility."""
        self._lengths[req.slot] = 0
        self._tokens[req.slot] = 0
        self._temps[req.slot] = req.temperature

    def _release_slot(self, req: Request, slot: int) -> None:
        """A request left its slot (finish/cancel). The flat pool has
        nothing to reclaim — stale rows are invisible; the paged engine
        returns the slot's blocks to the allocator here."""

    def _reset_pool(self) -> None:
        """Rebuild ALL device-side cache state after a failed step (the
        pool may hold half-written rows)."""
        self._k, self._v = self._fresh_pool()

    def _sync_pool_metrics(self) -> None:
        """Per-iteration pool gauges; the flat pool has none beyond the
        slot gauges step() already sets."""

    def _prompt_in_cache(self, req: Request) -> None:
        """The last prefill chunk of ``req`` has landed, and the request
        still holds its slot. Nothing to do for the flat pool; the paged
        engine registers the prompt's full blocks with its prefix cache
        here."""

    # ---- internals ---------------------------------------------------------

    def _report_shed(self, req: Request, finished: List[Request]) -> None:
        finished.append(req)
        self.metrics.shed.inc(reason="deadline", slo_class=req.slo_class)
        self.metrics.requests.inc(outcome="shed")
        self.metrics.failures.inc(reason="deadline")
        self.metrics.annotate(
            "serving_shed", rid=req.rid, reason="deadline",
            slo_class=req.slo_class,
        )
        self._emit_request_spans(req, status="error")

    def _recover_from_step_error(self, err: BaseException,
                                 finished: List[Request]):
        """A step raised (device fault, kernel launch error). The pool
        may hold half-written rows, so NOTHING cached on device
        survives: rebuild the pool and return every in-flight request to
        the front of the queue to restart from scratch. A request that
        keeps landing in a raising step is EXPLICITLY failed after
        ``max_requeues`` restarts. Every error counts in
        ``serving_step_errors_total`` and is logged with its
        traceback."""
        active = self.scheduler.active()
        wasted_prefill = sum(r.prefill_pos for r in active)
        wasted_decode = sum(len(r.tokens) for r in active)
        requeued = self.scheduler.requeue_active()
        self._reset_pool()
        self._lengths[:] = 0
        self._tokens[:] = 0
        self._temps[:] = 0.0
        self.metrics.step_errors.inc()
        if wasted_prefill:
            self.metrics.tokens_wasted.inc(wasted_prefill, kind="prefill")
        if wasted_decode:
            self.metrics.tokens_wasted.inc(wasted_decode, kind="decode")
        failed = 0
        for req in requeued:
            if req.requeues > self.max_requeues:
                try:
                    self.scheduler.queue.remove(req)
                except ValueError:
                    pass
                req.failed = True
                req.failure_reason = "requeue_budget"
                self.scheduler.finish(req)
                finished.append(req)
                self._emit_request_spans(req, status="error")
                failed += 1
                self.metrics.requests.inc(outcome="failed")
                self.metrics.failures.inc(reason="requeue_budget")
            else:
                self.metrics.requests.inc(outcome="requeued")
        self.metrics.annotate(
            "serving_step_error",
            error=f"{type(err).__name__}: {err}"[:200],
            requeued=len(requeued) - failed, failed=failed,
        )
        logger.warning(
            "serving step raised; pool rebuilt, %d in-flight request(s) "
            "re-queued, %d explicitly failed",
            len(requeued) - failed, failed, exc_info=err,
        )

    @torch.inference_mode()
    def _prefill(self, chunk: np.ndarray, slot: int, start: int,
                 n_valid: int, temperature: float) -> torch.Tensor:
        """One [1, chunk] prompt chunk into ONE slot's cache rows
        [start, start + chunk); returns the token sampled at the last
        real prompt position ``n_valid - 1`` (meaningful on the final
        chunk only; pad rows past it hold K/V that stays invisible)."""
        self.call_counts["prefill"] += 1
        cfg = self.config
        tokens = torch.from_numpy(chunk).to(self.device)
        c = chunk.shape[1]
        positions = (
            start + torch.arange(c, dtype=torch.int32, device=self.device)
        )[None, :]
        fill = torch.full((1,), start + 1, dtype=torch.int32,
                          device=self.device)  # read when chunk == 1
        x = llama.embed_tokens(cfg, self._params, tokens)
        for i in range(cfg.n_layers):
            x = gen_lib._layer_decode(
                cfg, llama.layer_params(self._params, i), x, positions,
                self._k[i, slot:slot + 1], self._v[i, slot:slot + 1],
                start, fill,
            )
        h = x[:, n_valid - 1:n_valid]
        logits = llama.unembed(cfg, self._params, h)[0, 0]
        return gen_lib.sample_token(logits, temperature, self._generator)

    @torch.inference_mode()
    def _decode(self, active: np.ndarray) -> np.ndarray:
        """[slots] fed tokens -> one sampled token per slot, ragged
        fills. Inactive slots keep their fed token."""
        self.call_counts["decode"] += 1
        cfg = self.config
        host = np.stack([
            self._lengths,
            self._tokens,
            np.minimum(self._lengths, self.max_len - 1),      # write row
            np.where(active, np.minimum(self._lengths + 1, self.max_len),
                     0),                                       # kernel fill
        ]).astype(np.int32)
        lengths, tokens, write, fill = torch.from_numpy(host).to(self.device)
        positions = lengths[:, None]
        write = write.long()
        x = llama.embed_tokens(cfg, self._params, tokens[:, None])
        for i in range(cfg.n_layers):
            x = gen_lib._layer_decode(
                cfg, llama.layer_params(self._params, i), x, positions,
                self._k[i], self._v[i], write, fill,
            )
        logits = llama.unembed(cfg, self._params, x)[:, 0]
        nxt = gen_lib.sample_token(logits, self._temps, self._generator)
        return np.where(active, nxt.cpu().numpy(), self._tokens)

    def _run_prefill_chunk(self, req: Request, finished: List[Request]):
        c = self.prefill_chunk
        start = req.prefill_pos
        n_valid = min(c, req.prompt_len - start)
        chunk = np.zeros((1, c), np.int32)
        chunk[0, :n_valid] = req.prompt[start:start + n_valid]
        first = self._prefill(chunk, req.slot, start, n_valid,
                              req.temperature)
        req.prefill_pos += n_valid
        self._lengths[req.slot] = req.prefill_pos
        self.metrics.tokens.inc(n_valid, kind="prefill")
        if req.prefill_pos < req.prompt_len:
            return  # more chunks to come; `first` is discarded unread
        self._prompt_in_cache(req)
        tok = int(first)
        req.first_token_ts = time.monotonic()
        if req.requeues == 0:
            # A re-run after a step-error requeue would re-observe an
            # inflated first-token latency for the same request.
            self.metrics.ttft.observe(req.ttft_s)
        req.tokens.append(tok)
        self._tokens[req.slot] = tok
        self.metrics.tokens.inc(kind="decode")
        if len(req.tokens) >= req.max_new_tokens:
            self._finish(req, finished)
        else:
            req.state = DECODE

    def _run_decode(self, decoding: List[Request],
                    finished: List[Request]):
        if self.spec_k:
            self._run_decode_spec(decoding, finished)
            return
        active = np.zeros(self.slots, bool)
        for r in decoding:
            active[r.slot] = True
        nxt = self._decode(active)
        for r in decoding:
            self._lengths[r.slot] += 1   # the fed token's KV landed
            tok = int(nxt[r.slot])
            r.tokens.append(tok)
            self._tokens[r.slot] = tok
            self.metrics.tokens.inc(kind="decode")
            self._iter_decoded += 1
            if len(r.tokens) >= r.max_new_tokens:
                self._finish(r, finished)
            elif self._lengths[r.slot] + 1 > self.max_len:
                # No room to feed the token just sampled.
                r.truncated = True
                self._finish(r, finished)

    # ---- speculative decode ------------------------------------------------

    def _run_decode_spec(self, decoding: List[Request],
                         finished: List[Request]):
        """One draft -> verify -> commit iteration for every decoding
        slot. Variable per-slot acceptance is a ragged fill advance;
        rejected drafts stay beyond the fill. The emitted tokens and the
        accept lengths reach the host in one copy."""
        decoding = self._spec_prepare_rows(decoding)
        if not decoding:
            return
        active = np.zeros(self.slots, bool)
        for r in decoding:
            active[r.slot] = True
        T = self.spec_k + 1
        t_d = time.monotonic()
        drafts, draft_len = self._spec_draft(decoding, active)
        t_v = time.monotonic()
        out = self._spec_verify_device(active, drafts, draft_len)
        out = out.cpu().numpy()
        emitted, acc = out[:, :T], out[:, T]
        t_e = time.monotonic()
        n_dec = len(decoding)
        d_dt = (t_v - t_d) / n_dec
        v_dt = (t_e - t_v) / n_dec
        for r in decoding:
            r.draft_s += d_dt
            r.verify_s += v_dt
        for r in decoding:
            s = r.slot
            n_acc = int(acc[s])
            dl = int(draft_len[s])
            toks = [int(t) for t in emitted[s, : n_acc + 1]]
            # All T rows landed; only the accepted prefix plus the final
            # token become visible (free rollback).
            self._lengths[s] += n_acc + 1
            r.tokens.extend(toks)
            self._tokens[s] = toks[-1]
            r.spec_drafted += dl
            r.spec_accepted += n_acc
            self.metrics.tokens.inc(n_acc + 1, kind="decode")
            if dl:
                self.metrics.spec_tokens.inc(dl, kind="drafted")
                if n_acc:
                    self.metrics.spec_tokens.inc(n_acc, kind="accepted")
                if dl - n_acc:
                    self.metrics.spec_tokens.inc(dl - n_acc,
                                                 kind="rejected")
                self.metrics.spec_accept_rate.observe(n_acc / dl)
            self._spec_emitted += n_acc + 1
            self._spec_slot_steps += 1
            self._iter_decoded += n_acc + 1
            if len(r.tokens) >= r.max_new_tokens:
                self._finish(r, finished)
            elif self._lengths[s] + 1 > self.max_len:
                # No room to feed the final token back.
                r.truncated = True
                self._finish(r, finished)
        self.metrics.spec_tokens_per_step.set(
            self._spec_emitted / self._spec_slot_steps
        )

    def _spec_prepare_rows(self, decoding: List[Request]):
        """Make rows fill..fill+spec_k writable for every decoding slot.
        The flat slab always has them; the paged engine allocates and
        privatizes blocks here and may preempt."""
        return decoding

    def _spec_draft(self, decoding: List[Request], active: np.ndarray):
        """Propose up to spec_k tokens per slot. Returns ``(drafts
        [slots, K], draft_len np [slots])``; the drafts are a device
        tensor (early exit) or a host array (n-gram)."""
        K = self.spec_k
        draft_len = np.zeros(self.slots, np.int32)
        caps = {
            r.slot: spec_lib.clamp_draft_len(
                K, len(r.tokens), r.max_new_tokens,
                int(self._lengths[r.slot]), self.max_len,
            )
            for r in decoding
        }
        if self.spec_drafter == "early_exit":
            drafts = self._spec_draft_device(active)
            if self.device.type == "cuda":
                # An honest draft/verify split of the iteration's time.
                torch.cuda.synchronize(self.device)
            # The device drafter always proposes K tokens; the clamp
            # rides in draft_len (acceptance never crosses it).
            for s, cap in caps.items():
                draft_len[s] = cap
            return drafts, draft_len
        drafts_np = np.zeros((self.slots, K), np.int32)
        for r in decoding:
            s = r.slot
            cap = caps[s]
            if cap <= 0:
                continue
            # Bounded lookback: the motifs worth speculating on recur
            # within a short horizon.
            toks = r.tokens
            if len(toks) >= _NGRAM_WINDOW:
                hist = np.asarray(toks[-_NGRAM_WINDOW:], np.int32)
            else:
                hist = np.concatenate([
                    np.asarray(
                        r.prompt[-(_NGRAM_WINDOW - len(toks)):], np.int32
                    ),
                    np.asarray(toks, np.int32),
                ])
            prop = spec_lib.propose_ngram(hist, cap)
            n = min(len(prop), cap)
            drafts_np[s, :n] = prop[:n]
            draft_len[s] = n
        return drafts_np, draft_len

    def _host_to_device(self, parts):
        """Int32 host arrays -> device views of one copy, in order."""
        flat = [np.asarray(p, np.int32).ravel() for p in parts]
        dev = torch.from_numpy(np.concatenate(flat)).to(self.device)
        out, at = [], 0
        for p, f in zip(parts, flat):
            out.append(dev[at:at + f.size].view(np.shape(p)))
            at += f.size
        return out

    @torch.inference_mode()
    def _spec_draft_device(self, active: np.ndarray) -> torch.Tensor:
        """Early-exit drafter: K single-token steps through the first
        ``spec_draft_layers`` blocks (the decode kernel reads each
        slot's rows), greedy through the shared head. Draft i's rows
        land at fill + i of the draft layers, beyond the fill; a row at
        or past max_len, and every row of an inactive slot, is dropped.
        Returns the drafts [slots, K] int32 on the device."""
        self.call_counts["draft"] += 1
        cfg = self.config
        K, slots = self.spec_k, self.slots
        lens = self._lengths[:, None] + np.arange(K)[None, :]  # [slots, K]
        valid = active[:, None] & (lens < self.max_len)
        src = [np.flatnonzero(valid[:, i]) for i in range(K)]
        dev = self._host_to_device(
            [self._lengths, self._tokens, active,
             np.where(valid, lens + 1, 0).T]
            + [a for i in range(K) for a in (src[i], lens[src[i], i])]
        )
        lengths, cur, act, fill = dev[:4]
        act = act.bool()
        drafts = []
        for i in range(K):
            sel, rows = dev[4 + 2 * i].long(), dev[5 + 2 * i].long()
            positions = (lengths + i)[:, None]
            x = llama.embed_tokens(cfg, self._params, cur[:, None])
            for j in range(self.spec_draft_layers):
                x = gen_lib._layer_decode(
                    cfg, llama.layer_params(self._params, j), x, positions,
                    self._k[j], self._v[j], (sel, rows, sel), fill[i],
                )
            logits = llama.unembed(cfg, self._params, x)[:, 0]
            cur = torch.where(act, logits.argmax(dim=-1).to(torch.int32),
                              cur)
            drafts.append(cur)
        return torch.stack(drafts, dim=1)

    @torch.inference_mode()
    def _spec_verify_device(self, active: np.ndarray, drafts,
                            draft_len: np.ndarray) -> torch.Tensor:
        """The verify step: the fed token and the K drafts of every slot,
        [slots, K + 1] tokens, through every layer with the cache
        read-only (``gen_lib._layer_verify``), their rows appended at
        fill..fill+K (dropped at or past max_len and for inactive
        slots), then the accept law. Returns [slots, K + 2] int32 on the
        device: the emitted tokens, then the accept length."""
        self.call_counts["verify"] += 1
        cfg = self.config
        T = self.spec_k + 1
        writes = self._lengths[:, None] + np.arange(T)[None, :]
        valid = active[:, None] & (writes < self.max_len)
        src = np.flatnonzero(valid)
        parts = [self._lengths, self._tokens, draft_len, active,
                 src // T, writes.ravel()[src], src]
        host_drafts = isinstance(drafts, np.ndarray)
        if host_drafts:
            parts.append(drafts)
        dev = self._host_to_device(parts)
        lengths, tokens, dlen, act = dev[:4]
        cursor = tuple(t.long() for t in dev[4:7])
        if host_drafts:
            drafts = dev[7]
        # The cache rows any active slot can see.
        rows = max(1, int(self._lengths[active].max(initial=0)))
        toks = torch.cat([tokens[:, None], drafts], dim=1)
        positions = lengths[:, None] + torch.arange(
            T, dtype=torch.int32, device=self.device)[None, :]
        x = llama.embed_tokens(cfg, self._params, toks)
        for i in range(cfg.n_layers):
            x, k_rows, v_rows, _, _ = gen_lib._layer_verify(
                cfg, llama.layer_params(self._params, i), x, positions,
                self._k[i, :, :rows], self._v[i, :, :rows], lengths,
            )
            gen_lib._append(self._k[i], k_rows, cursor)
            gen_lib._append(self._v[i], v_rows, cursor)
        logits = llama.unembed(cfg, self._params, x)     # [slots, T, V]
        emitted, acc = spec_lib.spec_accept(
            logits, drafts, dlen, self._temps, act.bool(), tokens,
            self._generator,
        )
        return torch.cat([emitted, acc[:, None]], dim=1)

    def _finish(self, req: Request, finished: List[Request]):
        slot = req.slot
        self.scheduler.finish(req)
        if slot >= 0:
            self._release_slot(req, slot)
        finished.append(req)
        self.metrics.requests.inc(
            outcome="truncated" if req.truncated else "finished"
        )
        self.metrics.annotate(
            "serving_finish", rid=req.rid, slot=slot,
            new_tokens=len(req.tokens), truncated=req.truncated,
        )
        self._emit_request_spans(req)

    def _emit_request_spans(self, req: Request, status: str = "ok"):
        """Retrospective phase tree for one terminal request: queue-wait
        / prefill / decode cut at the timestamps the scheduler already
        records, contiguous by construction so their durations sum to
        the request's end-to-end latency. Disarmed: one global check —
        zero per-iteration cost in the step loop."""
        tracer = tracing.active_tracer()
        if tracer is None:
            return
        finish = (
            req.finish_ts if req.finish_ts is not None
            else time.monotonic()
        )
        root = tracer.record_span(
            "serving.request", req.submit_ts, finish,
            kind="server", parent=req.trace,
            attrs={
                "rid": req.rid,
                "prompt_len": req.prompt_len,
                "new_tokens": len(req.tokens),
                "truncated": req.truncated,
                "requeues": req.requeues,
                "failure_reason": req.failure_reason,
                "slo_class": req.slo_class,
                "prefix_hit_blocks": req.prefix_hit_blocks,
            },
            status=status,
        )
        if req.admit_ts is None:
            # Never reached a slot (shed / failed while queued): the
            # whole life was queue wait.
            tracer.record_span(
                "serving.queue_wait", req.submit_ts, finish,
                parent=root, status=status,
            )
            return
        tracer.record_span(
            "serving.queue_wait", req.submit_ts, req.admit_ts,
            parent=root,
        )
        if req.first_token_ts is None:
            tracer.record_span(
                "serving.prefill", req.admit_ts, finish,
                parent=root, status=status,
            )
            return
        tracer.record_span(
            "serving.prefill", req.admit_ts, req.first_token_ts,
            parent=root, attrs={"prompt_len": req.prompt_len},
        )
        decode_start = req.first_token_ts
        if req.migrate_end_ts is not None:
            # Migrated request (kvpool/migrate): the migrate window sits
            # between the source-side prefill and the local decode.
            # Decode the SOURCE ran before a live-drain export gets its
            # own contiguous segment so the children still tile the
            # request end to end.
            m_end = min(req.migrate_end_ts, finish)
            m_start = req.migrate_start_ts
            if m_start is None or m_start < req.first_token_ts:
                m_start = req.first_token_ts
            m_start = min(m_start, m_end)
            if m_start - req.first_token_ts > 1e-6:
                tracer.record_span(
                    "serving.decode", req.first_token_ts, m_start,
                    parent=root, attrs={"segment": "pre_migrate"},
                )
            tracer.record_span(
                "serving.migrate", m_start, m_end, parent=root,
                attrs={"pause_s": round(m_end - m_start, 6)},
            )
            decode_start = m_end
        decode_span = tracer.record_span(
            "serving.decode", decode_start, finish,
            parent=root, attrs={"new_tokens": len(req.tokens)},
        )
        if req.verify_s > 0.0:
            # Spec decode splits the decode phase into draft / verify
            # sub-spans (per-slot shares of the iteration wall time,
            # laid contiguously — durations are the signal, not the
            # absolute placement).
            td = min(decode_start + req.draft_s, finish)
            tv = min(td + req.verify_s, finish)
            tracer.record_span(
                "serving.decode.draft", decode_start, td,
                parent=decode_span,
                attrs={"spec_drafted": req.spec_drafted},
            )
            tracer.record_span(
                "serving.decode.verify", td, tv,
                parent=decode_span,
                attrs={"spec_accepted": req.spec_accepted},
            )
