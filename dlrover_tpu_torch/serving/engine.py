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

Not ported yet: speculative decoding (``spec_k > 0`` raises), the paged
engine, the fleet, tracing spans and fault points.

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
from dlrover_tpu_torch.models import generate as gen_lib
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.serving import scheduler as sched_lib
from dlrover_tpu_torch.serving.metrics import serving_metrics
from dlrover_tpu_torch.serving.scheduler import DECODE, Request, Scheduler


class ServingEngine:
    """Single-host continuous-batching engine over a slot-pooled cache.

    Host bookkeeping (the Scheduler) is torch-free; each ``step()`` runs
    at most one prefill chunk and one ragged decode iteration. The
    engine is not thread-safe — drive it from one serving loop."""

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
        device="cuda",
    ):
        llama.require_dense(config)
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
            raise NotImplementedError(
                "speculative decoding is not ported yet"
            )
        self.config = config
        self.slots = slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.device = gen_lib.resolve_device(device)
        # How many step-error restarts a request gets before it is
        # EXPLICITLY failed — a persistent device error must not
        # livelock the serve loop re-queueing the same work forever.
        self.max_requeues = max_requeues
        self.scheduler = Scheduler(
            slots, max_len, prefill_chunk, token_budget, drain_mode,
            slo_classes=slo_classes,
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
               slo_class: Optional[str] = None) -> Request:
        req = self.scheduler.submit(
            prompt, max_new_tokens, temperature, deadline_s=deadline_s,
            slo_class=slo_class,
        )
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
        self.scheduler.evict(req)
        self.metrics.requests.inc(outcome="cancelled")

    def pending(self) -> int:
        """Requests not yet DONE (queued + in a slot)."""
        return len(self.scheduler.queue) + len(self.scheduler.active())

    def warmup(self) -> None:
        """Run one prefill chunk and one decode step on throwaway state
        (building the kernels at first use), then reset the pool — so
        the first real request pays no build."""
        chunk = np.zeros((1, self.prefill_chunk), np.int32)
        self._prefill(chunk, 0, 0, 1, 0.0)
        self._decode(np.zeros(self.slots, bool))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._reset_pool()

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
        for req in sch.drain_admission_shed():
            self._report_shed(req, finished)
        try:
            pf = sch.pick_prefill()
            if pf is not None:
                self._run_prefill_chunk(pf, finished)
            decoding = sch.decoding()
            if decoding:
                self._run_decode(decoding, finished)
        except Exception as e:  # noqa: BLE001 — device errors vary
            self._recover_from_step_error(e, finished)
            self._iter_decoded = 0
        self.metrics.iterations.inc()
        self.metrics.queue_depth.set(len(sch.queue))
        for name, depth in sch.queue_depth_by_class().items():
            self.metrics.class_queue_depth.set(depth, slo_class=name)
        self.metrics.active_slots.set(len(sch.active()))
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

    # ---- internals ---------------------------------------------------------

    def _admit_slot(self, req: Request) -> None:
        """A recycled slot starts from fill 0: stale KV above the cursor
        is invisible and rewritten before visibility."""
        self._lengths[req.slot] = 0
        self._tokens[req.slot] = 0
        self._temps[req.slot] = req.temperature

    def _reset_pool(self) -> None:
        self._k, self._v = self._fresh_pool()

    def _report_shed(self, req: Request, finished: List[Request]) -> None:
        finished.append(req)
        self.metrics.shed.inc(reason="deadline", slo_class=req.slo_class)
        self.metrics.requests.inc(outcome="shed")
        self.metrics.failures.inc(reason="deadline")

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
                failed += 1
                self.metrics.requests.inc(outcome="failed")
                self.metrics.failures.inc(reason="requeue_budget")
            else:
                self.metrics.requests.inc(outcome="requeued")
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

    def _finish(self, req: Request, finished: List[Request]):
        self.scheduler.finish(req)
        finished.append(req)
        self.metrics.requests.inc(
            outcome="truncated" if req.truncated else "finished"
        )
