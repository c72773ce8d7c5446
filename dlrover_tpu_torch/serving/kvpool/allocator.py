"""Block allocator for the paged KV pool: free list + refcounts + COW
(the port's own copy of ``dlrover_tpu/serving/kvpool/allocator.py``).

Pure host bookkeeping (no torch anywhere — the same discipline as the
scheduler): the device holds one ``[layers, num_blocks, block_size,
kv_heads, head_dim]`` slab per K and V, and THIS object decides which
block ids are free, which are owned by live slots, and which are kept
warm by the prefix cache. A block id is just an int32 row index into
the pool's block axis.

Ownership is refcounted, not owned-by-one: a block holding a shared
prompt prefix is referenced by every slot whose block table points at
it PLUS the prefix cache keeping it warm. The invariants the engine's
``check_block_invariants`` asserts live here:

- **conservation** — ``free + allocated == managed`` at every moment
  (``managed = num_blocks - reserved``; block 0 is the reserved
  garbage-sink sentinel that inactive slots scatter into, never
  allocated, never read);
- **no negative refcounts** — ``decref`` below zero raises instead of
  silently corrupting the free list;
- **copy-on-write** — a block with refcount > 1 is NEVER written; a
  writer calls :meth:`ensure_private` first, which hands back the same
  id when the caller is the sole owner and a fresh id (caller then
  device-copies the rows) when the block is shared.
"""

from collections import deque
from typing import Deque, Dict, Iterable, List, Tuple


class BlockPoolExhausted(RuntimeError):
    """alloc() could not satisfy the request; the caller decides the
    relief policy (evict prefix-cache LRU, preempt a request)."""


class BlockAllocator:
    """Free-list block allocator with refcounts. Not thread-safe — the
    engine drives it from its single serve loop."""

    def __init__(self, num_blocks: int, reserved: int = 1):
        if num_blocks <= reserved:
            raise ValueError(
                f"num_blocks {num_blocks} must exceed reserved "
                f"{reserved}"
            )
        self.num_blocks = num_blocks
        self.reserved = reserved
        self._free: Deque[int] = deque(range(reserved, num_blocks))
        self._ref: Dict[int, int] = {}
        # Monotone counters for metrics/bench.
        self.allocs_total = 0
        self.frees_total = 0
        self.cow_copies_total = 0

    # ---- core --------------------------------------------------------------

    @property
    def managed(self) -> int:
        """Allocatable blocks (sentinels excluded)."""
        return self.num_blocks - self.reserved

    def free_count(self) -> int:
        return len(self._free)

    def allocated_count(self) -> int:
        return len(self._ref)

    def alloc(self, n: int = 1) -> List[int]:
        """n fresh blocks at refcount 1 — all or nothing, so a partial
        grant can never strand half an allocation on failure."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise BlockPoolExhausted(
                f"need {n} blocks, {len(self._free)} free "
                f"({len(self._ref)} allocated of {self.managed})"
            )
        out = [self._free.popleft() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        self.allocs_total += n
        return out

    def incref(self, block_id: int, n: int = 1) -> None:
        if block_id not in self._ref:
            raise ValueError(f"incref on unallocated block {block_id}")
        self._ref[block_id] += n

    def decref(self, block_id: int) -> bool:
        """Drop one reference; returns True when the block was freed.
        Going below zero raises — a double free is a bug, not a state."""
        count = self._ref.get(block_id)
        if count is None or count <= 0:
            raise ValueError(
                f"decref on block {block_id} with refcount "
                f"{0 if count is None else count}"
            )
        if count == 1:
            del self._ref[block_id]
            self._free.append(block_id)
            self.frees_total += 1
            return True
        self._ref[block_id] = count - 1
        return False

    def refcount(self, block_id: int) -> int:
        return self._ref.get(block_id, 0)

    def ensure_private(self, block_id: int) -> Tuple[int, bool]:
        """COW: returns ``(block_id, False)`` when the caller is the
        sole owner; otherwise drops the caller's reference, allocates a
        fresh block, and returns ``(new_id, True)`` — the caller must
        then copy the device rows ``old -> new`` BEFORE writing."""
        if self.refcount(block_id) <= 1:
            return block_id, False
        new = self.alloc(1)[0]          # may raise BlockPoolExhausted
        self.decref(block_id)
        self.cow_copies_total += 1
        return new, True

    # ---- invariants / accounting -------------------------------------------

    def stats(self, live_blocks: Iterable[int] = ()) -> Dict[str, int]:
        """Accounting snapshot. ``live_blocks`` is the union of every
        occupied slot's block table; allocated blocks outside it are
        the prefix cache's warm set. ``free + used + cached == total``
        always — the block-reclaim invariant."""
        live = set(live_blocks)
        used = sum(1 for b in self._ref if b in live)
        return {
            "total": self.managed,
            "free": len(self._free),
            "used": used,
            "cached": len(self._ref) - used,
            "min_ref": min(self._ref.values(), default=0),
            "negative_refs": sum(
                1 for c in self._ref.values() if c < 0
            ),
        }

    def check(self) -> None:
        """Raise on any broken invariant (tests + soak call this)."""
        if len(self._free) + len(self._ref) != self.managed:
            raise AssertionError(
                f"block conservation broken: free {len(self._free)} + "
                f"allocated {len(self._ref)} != managed {self.managed}"
            )
        bad = {b: c for b, c in self._ref.items() if c <= 0}
        if bad:
            raise AssertionError(f"non-positive refcounts: {bad}")
        dup = set(self._free) & set(self._ref)
        if dup:
            raise AssertionError(f"blocks both free and allocated: {dup}")
