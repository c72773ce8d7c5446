"""Paged serving engine: block-table KV over a shared block pool (port
of ``dlrover_tpu/serving/kvpool/engine.py``).

The flat engine (``serving/engine.py``) reserves one ``[max_len]`` KV row
per slot — a 20-token request pins as much device memory as a
1024-token one, and a shared system prompt re-prefills from scratch in
every slot. Here the cache is ``[layers, num_blocks, block_size,
kv_heads, head_dim]`` and a slot's logical cache is the pool rows its
BLOCK TABLE names:

- **Block tables ride with the fill vector.** The ``[slots,
  max_blocks]`` int32 tables are host bookkeeping; every decode step
  sends them to the device in the same single copy as the per-slot
  lengths, tokens and append coordinates. The append is a per-slot
  scatter at ``(table[cursor // bs], cursor % bs)``; non-active slots
  are redirected to the reserved SENTINEL block 0 so their garbage
  writes can never land in a block another slot shares (the flat
  engine's own-row trick does not survive sharing). Attention then runs
  through ``ops.decode_attention.paged_decode_attention`` — on the card
  the hand-written kernel that follows the table itself, so no gathered
  copy of the cache is made on the decode path.
- **Visibility invariant, unchanged.** A logical row is read iff
  ``row < fill``; stale or foreign content beyond a slot's fill —
  including the longer tail of a SHARED prefix block, and stale ids in
  the table past the fill — is never read.
- **Cross-request prefix cache.** Admission hashes the prompt's full
  blocks against the :class:`PrefixCache`; a hit slots the warm chain
  straight into the block table and prefill SKIPS the covered chunks.
  Shared blocks are refcounted and immutable: the one legal rewrite (a
  chunk-aligned re-prefill over a shared block, identical values)
  privatizes first via copy-on-write, a device block copy.
- **Oversubscription + relief.** ``num_blocks`` may be far below
  ``slots * max_blocks`` (short requests hold few blocks — that is the
  capacity win). When the pool runs dry the engine first evicts
  prefix-cache LRU chains, then PREEMPTS the youngest active request
  (front-requeued with progress reset, no requeue-budget charge); an
  engine is constructed with room for at least one full-length slot,
  so relief always terminates.

- **Speculative decoding** (``spec_k > 0``): before the draft and
  verify steps every decoding slot gets its rows fill..fill+spec_k
  allocated and privately owned (``_spec_prepare_rows``; this may
  preempt). The early-exit draft runs the first ``spec_draft_layers``
  blocks through the paged kernel; the verify step gathers each slot's
  visible rows through its table and runs the reference's verify math
  over them. Every write that must not land (an inactive slot, a row at
  or past ``max_len``) goes to the sentinel block.
- **MoE configs** serve as dense ones: every step reaches the expert
  layer through ``llama.mlp_block`` (the grouped FFN kernel on the
  card).

The pools are updated in place (the reference's donated jit programs
return new ones). One difference from the reference's decode step is
deliberate: the reference attends over the gathered view with the new
token's own K/V kept apart at full precision and appends afterwards;
the port appends first and reads the row back through the kernel, as
its flat engine and ``generate()`` do. With an fp pool in the compute
dtype the two agree to rounding; with an int8 pool the port reads the
new token's row quantized. The verify step keeps the port's convention
(``gen_lib._layer_verify``): with an int8 pool every new row, the
token's own too, is read quantized, so spec-on gives the port's
spec-off tokens; the reference reads each token's own row at full
precision there as well.

Not ported yet: the migration import/export of blocks.
"""

from typing import Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.models import generate as gen_lib
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops.kv_quant import (
    bytes_per_head_row,
    dequantize_kv,
    quantize_kv,
)
from dlrover_tpu_torch.serving.engine import ServingEngine
from dlrover_tpu_torch.serving.kvpool.allocator import (
    BlockAllocator,
    BlockPoolExhausted,
)
from dlrover_tpu_torch.serving import spec_decode as spec_lib
from dlrover_tpu_torch.serving.kvpool.prefix_cache import PrefixCache
from dlrover_tpu_torch.serving.scheduler import DECODE, PREFILL, Request

# Pool row 0 absorbs the garbage appends of non-active slots; never
# allocated, never read.
SENTINEL_BLOCK = 0


class PagedServingEngine(ServingEngine):
    """ServingEngine over a paged block pool (see module docstring).

    Same host-side step loop, scheduler, metrics and recovery semantics
    as the flat engine — only the pool hooks and the two device steps
    differ. ``num_blocks`` defaults to exactly the flat engine's memory
    budget (``slots * max_len / block_size`` + sentinel); pass fewer
    blocks and MORE slots for the oversubscribed capacity win.
    ``kv_cache_dtype="int8"`` stores the pool as int8 with per-(row,
    head) f32 scale pools (``ops/kv_quant``): dequantization folds into
    the attention kernel's math, and the COW/prefix/preemption machinery
    is unchanged (shared blocks share their scales)."""

    def __init__(
        self,
        config: llama.TpuLMConfig,
        params,
        slots: int,
        max_len: int,
        prefill_chunk: int = 64,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        prefix_cache: bool = True,
        prefix_cache_blocks: Optional[int] = None,
        token_budget: Optional[int] = None,
        drain_mode: bool = False,
        generator: Optional[torch.Generator] = None,
        registry=None,
        max_requeues: int = 3,
        slo_classes=None,
        kv_cache_dtype: str = "fp",
        spec_k: int = 0,
        spec_drafter: str = "ngram",
        spec_draft_layers: int = 2,
        device="cuda",
    ):
        if kv_cache_dtype not in ("fp", "int8"):
            raise ValueError(
                f"kv_cache_dtype {kv_cache_dtype!r} not in "
                f"('fp', 'int8')"
            )
        if max_len % block_size:
            raise ValueError(
                f"max_len {max_len} must be a multiple of block_size "
                f"{block_size}"
            )
        if prefill_chunk % block_size and block_size % prefill_chunk:
            # Chunk/block alignment keeps the prefill scatter-back a
            # fixed number of whole blocks; misaligned chunks would
            # straddle a shared/fresh block boundary mid-block.
            raise ValueError(
                f"prefill_chunk {prefill_chunk} and block_size "
                f"{block_size} must divide one another"
            )
        self.kv_cache_dtype = kv_cache_dtype
        self.block_size = block_size
        self.max_blocks = max_len // block_size
        if num_blocks is None:
            num_blocks = slots * self.max_blocks + 1
        if num_blocks - 1 < self.max_blocks:
            # Room for at least one full-length slot, or pool-pressure
            # relief (evict cache, preempt peers) could never free
            # enough for a lone max-length request.
            raise ValueError(
                f"num_blocks {num_blocks} cannot hold one full slot "
                f"({self.max_blocks} blocks + sentinel)"
            )
        self.num_blocks = num_blocks
        self._allocator = BlockAllocator(num_blocks, reserved=1)
        self._cache: Optional[PrefixCache] = (
            PrefixCache(self._allocator, block_size,
                        capacity_blocks=prefix_cache_blocks)
            if prefix_cache else None
        )
        self._tables = np.zeros((slots, self.max_blocks), np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in range(slots)]
        # USABLE-hit accounting (what kv_stats reports): a raw cache
        # hit whose blocks are all discarded by chunk alignment saved
        # nothing and must count as a miss — the cache's own raw
        # counters would overstate the win.
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_hit_blocks = 0
        # The base __init__ builds the value pools via _fresh_pool();
        # the int8 scale pools pair up right after it returns (nothing
        # in between touches them).
        super().__init__(
            config, params, slots, max_len,
            prefill_chunk=prefill_chunk, token_budget=token_budget,
            drain_mode=drain_mode, generator=generator, registry=registry,
            max_requeues=max_requeues, slo_classes=slo_classes,
            spec_k=spec_k, spec_drafter=spec_drafter,
            spec_draft_layers=spec_draft_layers, device=device,
        )
        self._kscale, self._vscale = self._fresh_scales()
        # Block watermark: only admit a request the pool can hold
        # (prompt + first decode block) counting evictable cache as
        # free — otherwise bursty arrivals thrash preemptions, each
        # one burning its victim's whole prefill investment.
        self.scheduler.admission_gate = self._can_admit
        # K+V bytes per block, for the bytes-in-use gauge: int8 pools
        # pay 1 byte/element + one f32 scale per (row, head).
        self._block_bytes = int(
            2 * config.n_layers * block_size * config.n_kv_heads
            * bytes_per_head_row(
                config.head_dim, kv_cache_dtype,
                torch.finfo(config.compute_dtype).bits // 8,
            )
        )
        self.metrics.kv_blocks_total.set(self._allocator.managed)

    # ---- pool construction -------------------------------------------------

    @property
    def _quantized(self) -> bool:
        return self.kv_cache_dtype == "int8"

    def _fresh_pool(self):
        shape = (
            self.config.n_layers, self.num_blocks, self.block_size,
            self.config.n_kv_heads, self.config.head_dim,
        )
        dtype = torch.int8 if self._quantized else self.config.compute_dtype
        return (
            torch.zeros(shape, dtype=dtype, device=self.device),
            torch.zeros(shape, dtype=dtype, device=self.device),
        )

    def _fresh_scales(self):
        """(k_scale, v_scale) pools for the int8 cache — (None, None)
        for fp. Every value-pool rebuild site (init, warmup, step-error
        recovery) pairs a _fresh_pool() call with this one so value and
        scale pools can never be mismatched."""
        if not self._quantized:
            return None, None
        shape = (
            self.config.n_layers, self.num_blocks, self.block_size,
            self.config.n_kv_heads,
        )
        return (
            torch.zeros(shape, dtype=torch.float32, device=self.device),
            torch.zeros(shape, dtype=torch.float32, device=self.device),
        )

    def warmup(self) -> None:
        """Run one prefill chunk, one decode step, the spec steps (with
        spec on) and one block copy on throwaway state (building the
        kernel at first use), then rebuild the pools — so the first real
        request pays no build."""
        chunk = np.zeros((1, self.prefill_chunk), np.int32)
        self._prefill(chunk, 0, 0, 1, 0.0)
        self._decode(np.zeros(self.slots, bool))
        self._warmup_spec()
        self._cow_copy(SENTINEL_BLOCK, SENTINEL_BLOCK)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._k, self._v = self._fresh_pool()
        self._kscale, self._vscale = self._fresh_scales()

    # ---- block bookkeeping -------------------------------------------------

    def _can_admit(self, req: Request) -> bool:
        """Admission watermark: free + cache-evictable blocks must
        cover the request's whole prompt plus one decode block (a
        prefix hit only LOWERS the real need — conservative). A
        request that already LOST its slot to pool pressure re-admits
        pessimistically, against its full prompt+decode worst case:
        optimistic re-admission is exactly the preempt-readmit-preempt
        thrash cycle, each lap burning a whole prefill."""
        rows = req.prompt_len + (
            req.max_new_tokens if req.preemptions else 1
        )
        need = -(-min(rows, self.max_len) // self.block_size)
        stats = self._allocator.stats(self._live_block_ids())
        return stats["free"] + stats["cached"] >= need

    def _live_block_ids(self) -> set:
        live = set()
        for blocks in self._slot_blocks:
            live.update(blocks)
        return live

    def _alloc_blocks(self, n: int, requester: Request) -> List[int]:
        """All-or-nothing allocation with the relief ladder: prefix
        cache LRU eviction first, then preemption of the YOUNGEST
        active request (never ``requester``). Raises only when relief
        is structurally impossible (requester alone overflows the
        pool), which the step-error recovery path bounds."""
        while True:
            try:
                return self._allocator.alloc(n)
            except BlockPoolExhausted:
                missing = n - self._allocator.free_count()
                if self._cache is not None and self._cache.evict_lru(
                    missing
                ):
                    continue
                victim = self._pick_preemption_victim(requester)
                if victim is None:
                    raise
                self._preempt(victim)

    def _pick_preemption_victim(
        self, requester: Request
    ) -> Optional[Request]:
        cands = [
            r for r in self.scheduler.active()
            if r is not requester and r.state in (PREFILL, DECODE)
            and self._slot_blocks[r.slot]
        ]
        if not cands:
            return None
        return max(cands, key=lambda r: r.rid)  # youngest first out

    def _preempt(self, victim: Request) -> None:
        slot = victim.slot
        # Reset-to-zero progress is wasted compute.
        if victim.prefill_pos:
            self.metrics.tokens_wasted.inc(
                victim.prefill_pos, kind="prefill"
            )
        if victim.tokens:
            self.metrics.tokens_wasted.inc(
                len(victim.tokens), kind="decode"
            )
        self.scheduler.preempt(victim)
        self._release_slot(victim, slot)
        self._lengths[slot] = 0
        self._tokens[slot] = 0
        self._temps[slot] = 0.0
        self.metrics.kv_preemptions.inc()
        self.metrics.requests.inc(outcome="preempted")
        logger.info(
            "kvpool pressure: preempted rid %d (slot %d) to free "
            "blocks", victim.rid, slot,
        )

    def _ensure_blocks(self, req: Request, upto_rows: int) -> None:
        """Grow ``req``'s block table to cover ``upto_rows`` logical
        rows (clamped to max_len)."""
        upto_rows = min(upto_rows, self.max_len)
        need = -(-upto_rows // self.block_size)
        blocks = self._slot_blocks[req.slot]
        missing = need - len(blocks)
        if missing <= 0:
            return
        fresh = self._alloc_blocks(missing, req)
        start = len(blocks)
        blocks.extend(fresh)
        self._tables[req.slot, start:start + len(fresh)] = fresh

    def _privatize(self, req: Request, logical_idx: int) -> None:
        """COW: the slot is about to WRITE logical block
        ``logical_idx``; if that block is shared, copy it to a fresh
        private block first (shared blocks are immutable)."""
        blocks = self._slot_blocks[req.slot]
        old = blocks[logical_idx]
        if self._allocator.refcount(old) <= 1:
            return
        new = self._alloc_blocks(1, req)[0]
        self._cow_copy(old, new)
        self._allocator.decref(old)
        self._allocator.cow_copies_total += 1
        blocks[logical_idx] = new
        self._tables[req.slot, logical_idx] = new
        self.metrics.kv_cow_copies.inc()

    # ---- pool hooks (the base step loop calls these) -----------------------

    def _admit_slot(self, req: Request) -> None:
        super()._admit_slot(req)
        slot = req.slot
        self._tables[slot, :] = SENTINEL_BLOCK
        self._slot_blocks[slot] = []
        if self._cache is None:
            return
        hit = self._cache.lookup(req.prompt)
        # Never skip the FINAL prompt token: its forward produces the
        # first sampled token, so a full-prompt hit still re-runs the
        # last chunk (identical values; COW privatizes any shared
        # touched block). Chunk-align the resume point, and drop hit
        # blocks that lie ENTIRELY inside the re-prefilled span — they
        # would only be COW-copied and rewritten.
        start = 0
        if hit:
            start = min(len(hit) * self.block_size, req.prompt_len - 1)
            start -= start % self.prefill_chunk
            keep = -(-start // self.block_size)  # partial head stays
            for block in hit[keep:]:
                self._allocator.decref(block)
            hit = hit[:keep]
        if not hit:
            self.metrics.prefix_lookups.inc(outcome="miss")
            self._prefix_misses += 1
            return
        self.metrics.prefix_lookups.inc(outcome="hit")
        self.metrics.prefix_hit_blocks.inc(len(hit))
        self._prefix_hits += 1
        self._prefix_hit_blocks += len(hit)
        req.prefix_hit_blocks = len(hit)
        self._slot_blocks[slot] = list(hit)
        self._tables[slot, :len(hit)] = hit
        req.prefill_pos = start
        self._lengths[slot] = start

    def _release_slot(self, req: Request, slot: int) -> None:
        for block in self._slot_blocks[slot]:
            self._allocator.decref(block)
        self._slot_blocks[slot] = []
        self._tables[slot, :] = SENTINEL_BLOCK

    def _reset_pool(self) -> None:
        # A failed step may have left half-written rows: the device
        # blocks AND everything that points at them (allocator, prefix
        # cache, tables, int8 scale pools) restart from scratch.
        self._k, self._v = self._fresh_pool()
        self._kscale, self._vscale = self._fresh_scales()
        self._allocator = BlockAllocator(self.num_blocks, reserved=1)
        if self._cache is not None:
            self._cache = PrefixCache(
                self._allocator, self.block_size,
                capacity_blocks=self._cache.capacity_blocks,
            )
        self._tables[:, :] = SENTINEL_BLOCK
        self._slot_blocks = [[] for _ in range(self.slots)]

    def _sync_pool_metrics(self) -> None:
        stats = self._allocator.stats(self._live_block_ids())
        self.metrics.kv_blocks.set(stats["free"], state="free")
        self.metrics.kv_blocks.set(stats["used"], state="used")
        self.metrics.kv_blocks.set(stats["cached"], state="cached")
        self.metrics.kv_bytes_in_use.set(
            (stats["used"] + stats["cached"]) * self._block_bytes
        )

    def _prompt_in_cache(self, req: Request) -> None:
        if self._cache is not None:
            # Register the FULL prompt blocks for future hits (partial
            # tails stay private: the owner's decode appends into them).
            n_full = req.prompt_len // self.block_size
            self._cache.insert(
                req.prompt, self._slot_blocks[req.slot][:n_full]
            )

    # ---- device steps (the pools are updated in place) ---------------------

    def _pools(self, layer: int):
        """Layer ``layer``'s (k, v, k_scale, v_scale) pool views; the
        scales are None for an fp pool."""
        if self._quantized:
            return (self._k[layer], self._v[layer],
                    self._kscale[layer], self._vscale[layer])
        return self._k[layer], self._v[layer], None, None

    @torch.inference_mode()
    def _cow_copy(self, src: int, dst: int) -> None:
        """Device block copy src -> dst (K and V, all layers, plus the
        scale pools for int8): the copy-on-write primitive."""
        pools = [self._k, self._v]
        if self._quantized:
            pools += [self._kscale, self._vscale]
        for pool in pools:
            pool[:, dst] = pool[:, src]

    @torch.inference_mode()
    def _prefill(self, chunk: np.ndarray, slot: int, start: int,
                 n_valid: int, temperature: float) -> torch.Tensor:
        """One [1, chunk] prompt chunk into ONE slot's blocks: per
        layer, gather the slot's logical cache through its table row (a
        copy), run the flat prefill body over it with plain attention,
        and scatter back only the touched blocks — shared untouched
        blocks are never rewritten (the COW invariant). An int8 pool is
        dequantized to f32 for the chunk forward and the touched span
        re-quantized on the way out: q * scale is exact in f32 and
        per-(row, head) round-to-nearest is idempotent (the amax element
        always maps to +-127), so rows below the chunk inside a touched
        block keep their exact stored values and scales. Returns the
        token sampled at the last real prompt position."""
        self.call_counts["prefill"] += 1
        cfg = self.config
        bs, c = self.block_size, chunk.shape[1]
        kh, hd = cfg.n_kv_heads, cfg.head_dim
        tokens = torch.from_numpy(chunk).to(self.device)
        table_row = torch.from_numpy(self._tables[slot]).to(
            self.device).long()
        positions = (
            start + torch.arange(c, dtype=torch.int32, device=self.device)
        )[None, :]
        # Blocks a chunk can touch: chunk // bs full blocks when chunks
        # are block-multiples, else the single block containing the
        # chunk (init enforces one of chunk % bs == 0 / bs % chunk ==
        # 0). With chunk-aligned starts the span [touched0 * bs,
        # + n_touch * bs) covers [start, start + chunk) exactly.
        n_touch = max(c // bs, 1)
        touched0 = start // bs
        ids = table_row[touched0:touched0 + n_touch]
        span = slice(touched0 * bs, (touched0 + n_touch) * bs)

        def view(pool, *head):
            return pool[table_row].reshape(1, self.max_len, *head)

        x = llama.embed_tokens(cfg, self._params, tokens)
        for i in range(cfg.n_layers):
            k_pool, v_pool, ks_pool, vs_pool = self._pools(i)
            k_slot, v_slot = view(k_pool, kh, hd), view(v_pool, kh, hd)
            if self._quantized:
                k_slot = dequantize_kv(k_slot, view(ks_pool, kh))
                v_slot = dequantize_kv(v_slot, view(vs_pool, kh))
            x = gen_lib._layer_decode(
                cfg, llama.layer_params(self._params, i), x, positions,
                k_slot, v_slot, start, plain_attention=True,
            )
            seg_k = k_slot[0, span].reshape(n_touch, bs, kh, hd)
            seg_v = v_slot[0, span].reshape(n_touch, bs, kh, hd)
            if self._quantized:
                k_pool[ids], ks_pool[ids] = quantize_kv(seg_k)
                v_pool[ids], vs_pool[ids] = quantize_kv(seg_v)
            else:
                k_pool[ids] = seg_k
                v_pool[ids] = seg_v
        h = x[:, n_valid - 1:n_valid]
        logits = llama.unembed(cfg, self._params, h)[0, 0]
        return gen_lib.sample_token(logits, temperature, self._generator)

    @torch.inference_mode()
    def _decode(self, active: np.ndarray) -> np.ndarray:
        """[slots] fed tokens -> one sampled token per slot, ragged
        fills. Per layer: project q/k/v, write the new row through the
        table at ``(table[cursor // bs], cursor % bs)`` (int8 pools
        quantize it first), then the paged kernel over the fill after
        the append. Non-active slots append to the sentinel block — all
        of them in one scatter; any winner is fine, the row is never
        read — and attend over 0 rows; their fed token is kept. The
        per-slot vectors and the tables reach the device in one copy."""
        self.call_counts["decode"] += 1
        cfg = self.config
        bs, slots = self.block_size, self.slots
        write = np.minimum(self._lengths, self.max_len - 1)
        blk = self._tables[np.arange(slots), write // bs]
        host = np.concatenate([
            self._lengths,
            self._tokens,
            np.where(active, blk, SENTINEL_BLOCK),
            np.where(active, write % bs, 0),
            np.where(active, np.minimum(self._lengths + 1, self.max_len),
                     0),                                     # kernel fill
            self._tables.ravel(),
        ]).astype(np.int32)
        dev = torch.from_numpy(host).to(self.device)
        lengths, tokens, blk, off, fill = dev[:5 * slots].view(5, slots)
        tables = dev[5 * slots:].view(slots, self.max_blocks)
        cursor = (blk.long(), off.long())
        positions = lengths[:, None]
        x = llama.embed_tokens(cfg, self._params, tokens[:, None])
        for i in range(cfg.n_layers):
            k_pool, v_pool, ks_pool, vs_pool = self._pools(i)
            x = gen_lib._layer_decode(
                cfg, llama.layer_params(self._params, i), x, positions,
                k_pool, v_pool, cursor, fill,
                k_scale=ks_pool, v_scale=vs_pool, block_tables=tables,
            )
        logits = llama.unembed(cfg, self._params, x)[:, 0]
        nxt = gen_lib.sample_token(logits, self._temps, self._generator)
        return np.where(active, nxt.cpu().numpy(), self._tokens)

    # ---- step internals ----------------------------------------------------

    def _run_prefill_chunk(self, req: Request, finished: List[Request]):
        c = self.prefill_chunk
        start = req.prefill_pos
        n_valid = min(c, req.prompt_len - start)
        self._ensure_blocks(req, start + n_valid)
        # Privatize every block this chunk touches (a prefix-hit resume
        # can chunk-align BELOW the shared span: the re-prefill writes
        # identical values, but never into a shared block).
        first_blk = start // self.block_size
        last_blk = min(
            (start + c - 1) // self.block_size,
            len(self._slot_blocks[req.slot]) - 1,
        )
        for idx in range(first_blk, last_blk + 1):
            self._privatize(req, idx)
        super()._run_prefill_chunk(req, finished)

    def _run_decode(self, decoding: List[Request],
                    finished: List[Request]):
        if self.spec_k:
            self._run_decode_spec(decoding, finished)
            return
        # Block-budget pass FIRST: growing a cursor past a block edge
        # may preempt the youngest peer, which must then sit this
        # iteration out.
        for r in list(decoding):
            if r.state != DECODE:
                continue  # preempted by an earlier peer's allocation
            cursor = min(self._lengths[r.slot], self.max_len - 1)
            self._ensure_blocks(r, cursor + 1)
            self._privatize(r, cursor // self.block_size)
        decoding = [r for r in decoding if r.state == DECODE]
        if decoding:
            super()._run_decode(decoding, finished)

    # ---- speculative decode hooks ------------------------------------------

    def _spec_prepare_rows(self, decoding: List[Request]):
        """Every decoding slot needs rows fill..fill+spec_k writable
        BEFORE the device steps: allocate the covering blocks (the
        relief ladder may preempt the youngest peer, which then sits
        this iteration out) and privatize every touched block — drafted-
        then-rejected rows must never land in a block another slot or
        the prefix cache shares."""
        T = self.spec_k + 1
        for r in list(decoding):
            if r.state != DECODE:
                continue  # preempted by an earlier peer's allocation
            fill = int(self._lengths[r.slot])
            upto = min(fill + T, self.max_len)
            self._ensure_blocks(r, upto)
            first_blk = min(fill, self.max_len - 1) // self.block_size
            last_blk = min(
                (upto - 1) // self.block_size,
                len(self._slot_blocks[r.slot]) - 1,
            )
            for idx in range(first_blk, last_blk + 1):
                self._privatize(r, idx)
        return [r for r in decoding if r.state == DECODE]

    def _coords(self, active: np.ndarray, rows: np.ndarray):
        """Pool coordinates (block, offset) of logical ``rows`` [slots,
        n] through the tables, and which of them are valid; an inactive
        slot's rows and rows at or past max_len go to the sentinel
        block."""
        valid = active[:, None] & (rows < self.max_len)
        w = np.minimum(rows, self.max_len - 1)
        blk = self._tables[np.arange(self.slots)[:, None],
                           w // self.block_size]
        return (np.where(valid, blk, SENTINEL_BLOCK),
                np.where(valid, w % self.block_size, 0), valid)

    @torch.inference_mode()
    def _spec_draft_device(self, active: np.ndarray) -> torch.Tensor:
        """Paged early-exit drafter: K single-token steps through the
        first ``spec_draft_layers`` blocks, each attending through the
        paged kernel; draft i's rows land at fill + i of the draft
        layers (sentinel-redirected when invalid). Returns the drafts
        [slots, K] int32 on the device."""
        self.call_counts["draft"] += 1
        cfg = self.config
        K = self.spec_k
        lens = self._lengths[:, None] + np.arange(K)[None, :]  # [slots, K]
        blk, off, valid = self._coords(active, lens)
        lengths, cur, act, blk, off, fill, tables = self._host_to_device([
            self._lengths, self._tokens, active, blk.T, off.T,
            np.where(valid, lens + 1, 0).T, self._tables,
        ])
        act = act.bool()
        drafts = []
        for i in range(K):
            cursor = (blk[i].long(), off[i].long())
            positions = (lengths + i)[:, None]
            x = llama.embed_tokens(cfg, self._params, cur[:, None])
            for j in range(self.spec_draft_layers):
                k_pool, v_pool, ks_pool, vs_pool = self._pools(j)
                x = gen_lib._layer_decode(
                    cfg, llama.layer_params(self._params, j), x, positions,
                    k_pool, v_pool, cursor, fill[i],
                    k_scale=ks_pool, v_scale=vs_pool, block_tables=tables,
                )
            logits = llama.unembed(cfg, self._params, x)[:, 0]
            cur = torch.where(act, logits.argmax(dim=-1).to(torch.int32),
                              cur)
            drafts.append(cur)
        return torch.stack(drafts, dim=1)

    @torch.inference_mode()
    def _spec_verify_device(self, active: np.ndarray, drafts,
                            draft_len: np.ndarray) -> torch.Tensor:
        """Paged verify step: per layer, gather each slot's visible rows
        through its table (a copy, as the prefill's), run
        ``gen_lib._layer_verify`` over them, and write the T new rows at
        their block coordinates (sentinel-redirected when invalid; an
        int8 pool stores the rows the layer quantized). Returns [slots,
        K + 2] int32 on the device: the emitted tokens, then the accept
        length."""
        self.call_counts["verify"] += 1
        cfg = self.config
        T, bs, slots = self.spec_k + 1, self.block_size, self.slots
        writes = self._lengths[:, None] + np.arange(T)[None, :]
        blk, off, _ = self._coords(active, writes)
        # The blocks any active slot can see.
        n_blk = max(1, -(-int(self._lengths[active].max(initial=0)) // bs))
        parts = [self._lengths, self._tokens, draft_len, active,
                 blk.ravel(), off.ravel(), self._tables[:, :n_blk]]
        host_drafts = isinstance(drafts, np.ndarray)
        if host_drafts:
            parts.append(drafts)
        dev = self._host_to_device(parts)
        lengths, tokens, dlen, act, blk, off, tables = dev[:7]
        if host_drafts:
            drafts = dev[7]
        cursor = (blk.long(), off.long())
        tables = tables.long()

        def view(pool):
            return pool[tables].reshape(slots, n_blk * bs, *pool.shape[2:])

        toks = torch.cat([tokens[:, None], drafts], dim=1)
        positions = lengths[:, None] + torch.arange(
            T, dtype=torch.int32, device=self.device)[None, :]
        x = llama.embed_tokens(cfg, self._params, toks)
        for i in range(cfg.n_layers):
            pools = self._pools(i)
            views = [None if pool is None else view(pool) for pool in pools]
            x, *rows = gen_lib._layer_verify(
                cfg, llama.layer_params(self._params, i), x, positions,
                views[0], views[1], lengths,
                k_scale=views[2], v_scale=views[3],
            )
            for pool, new in zip(pools, rows):
                if pool is not None:
                    gen_lib._append(pool, new, cursor)
        logits = llama.unembed(cfg, self._params, x)     # [slots, T, V]
        emitted, acc = spec_lib.spec_accept(
            logits, drafts, dlen, self._temps, act.bool(), tokens,
            self._generator,
        )
        return torch.cat([emitted, acc[:, None]], dim=1)

    # ---- observability -----------------------------------------------------

    def kv_stats(self) -> Dict[str, object]:
        """Allocator + prefix-cache accounting."""
        stats = dict(self._allocator.stats(self._live_block_ids()))
        stats["bytes_in_use"] = (
            (stats["used"] + stats["cached"]) * self._block_bytes
        )
        stats["cow_copies"] = self._allocator.cow_copies_total
        if self._cache is not None:
            for key, value in self._cache.stats().items():
                stats[f"prefix_{key}"] = value
            # Report USABLE hits (blocks that actually skipped
            # prefill), not the cache's raw lookup counters: a hit
            # fully discarded by chunk alignment saved nothing.
            lookups = self._prefix_hits + self._prefix_misses
            stats["prefix_hits"] = self._prefix_hits
            stats["prefix_misses"] = self._prefix_misses
            stats["prefix_hit_blocks"] = self._prefix_hit_blocks
            stats["prefix_hit_rate"] = round(
                self._prefix_hits / lookups if lookups else 0.0, 4
            )
        return stats

    def check_block_invariants(self) -> None:
        """Raise unless conservation + refcount sanity hold (tests)."""
        self._allocator.check()
        stats = self._allocator.stats(self._live_block_ids())
        total = stats["free"] + stats["used"] + stats["cached"]
        if total != self._allocator.managed:
            raise AssertionError(
                f"free+used+cached {total} != managed "
                f"{self._allocator.managed}: {stats}"
            )
