"""Cross-request prefix cache: token prefixes → warm KV block chains
(the port's own copy of ``dlrover_tpu/serving/kvpool/prefix_cache.py``).

Shared system prompts are the serving fleet's biggest redundant work:
every request carrying the same leading tokens re-prefills identical
K/V on every replica. This cache keys FULL blocks of prompt tokens by a
cumulative chain hash (block k's key folds block k-1's key, so equal
keys mean equal token paths from position 0, not just an equal k-th
block) and keeps the finished blocks warm in the paged pool under a
cache-owned reference.

Structure is a trie over blocks: one entry per (parent chain, block
tokens), each holding one cache reference on its block. Lookup walks
root→leaf while keys match, increfs every hit block, and hands the
chain to the engine — the hit blocks slot straight into the request's
block table and prefill SKIPS the covered chunks. Insert registers a
finished prompt's full blocks (partial tails are never cached: a
partial block is still written by its owner's decode appends, and
shared blocks must stay immutable — COW handles the one legal rewrite,
a chunk-aligned re-prefill over a shared block).

Eviction is leaf-first LRU: only entries with no children are
evictable (evicting a mid-chain entry would orphan its suffix —
unreachable entries silently pinning blocks forever), and eviction
drops the cache's reference, freeing the block once no slot still
points at it. ``evict_lru`` is also the allocator's relief valve: the
engine calls it before preempting a request when the pool runs dry.
"""

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from dlrover_tpu_torch.serving.kvpool.allocator import BlockAllocator

# The chain root: block 0's parent. Any non-key value works; None keeps
# the trie honest (no token path hashes to it).
_ROOT = None


@dataclass
class _Entry:
    key: Tuple
    parent_key: Optional[Tuple]
    block_id: int
    # The block's literal tokens: verified on every hit, so a chain-hash
    # collision degrades to a miss instead of serving another prompt's
    # KV (correctness must not hang on 64-bit hash uniqueness).
    tokens: Tuple[int, ...] = ()
    children: Set[Tuple] = field(default_factory=set)


class PrefixCache:
    """See module docstring. Not thread-safe — engine-loop owned."""

    def __init__(
        self,
        allocator: BlockAllocator,
        block_size: int,
        capacity_blocks: Optional[int] = None,
    ):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self._alloc = allocator
        self.block_size = block_size
        # None = bounded only by the pool itself (eviction then happens
        # purely through the allocator-pressure relief valve).
        self.capacity_blocks = capacity_blocks
        self._entries: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        self.hits_total = 0
        self.misses_total = 0
        self.hit_blocks_total = 0
        self.evicted_blocks_total = 0

    # ---- keys --------------------------------------------------------------

    def _chain_keys(
        self, prompt: Sequence[int]
    ) -> List[Tuple[Tuple, Tuple[int, ...]]]:
        """Per-full-block ``(cumulative key, block tokens)`` pairs."""
        bs = self.block_size
        keys: List[Tuple[Tuple, Tuple[int, ...]]] = []
        parent: Optional[Tuple] = _ROOT
        for k in range(len(prompt) // bs):
            block = tuple(int(t) for t in prompt[k * bs:(k + 1) * bs])
            key = (hash((parent, block)), k)
            keys.append((key, block))
            parent = key
        return keys

    # ---- lookup / insert ---------------------------------------------------

    def lookup(self, prompt: Sequence[int]) -> List[int]:
        """Longest cached chain of full prompt blocks. Every returned
        block is INCREF'd for the caller — the hit is a loan the slot
        must decref like any other block it owns."""
        blocks: List[int] = []
        for key, tokens in self._chain_keys(prompt):
            entry = self._entries.get(key)
            if entry is None or entry.tokens != tokens:
                break
            self._entries.move_to_end(key)
            self._alloc.incref(entry.block_id)
            blocks.append(entry.block_id)
        if blocks:
            self.hits_total += 1
            self.hit_blocks_total += len(blocks)
        else:
            self.misses_total += 1
        return blocks

    def insert(self, prompt: Sequence[int], blocks: Sequence[int]) -> int:
        """Register a prefilled prompt's full blocks (``blocks[k]``
        holds rows ``[k*bs, (k+1)*bs)``). Newly cached blocks gain one
        cache-owned reference; chains already present are touched, not
        re-owned (a concurrent twin's identical blocks stay owned by
        its slot alone). Returns the number of blocks newly cached."""
        keys = self._chain_keys(prompt)
        n_full = min(len(keys), len(blocks))
        added = 0
        parent: Optional[Tuple] = _ROOT
        for k in range(n_full):
            key, tokens = keys[k]
            entry = self._entries.get(key)
            if entry is None:
                self._alloc.incref(blocks[k])
                entry = _Entry(
                    key=key, parent_key=parent, block_id=blocks[k],
                    tokens=tokens,
                )
                self._entries[key] = entry
                if parent is not _ROOT and parent in self._entries:
                    self._entries[parent].children.add(key)
                added += 1
            elif entry.tokens != tokens:
                # Chain-hash collision with a different token path:
                # cannot extend THIS chain past it (the child links
                # would corrupt the trie) — stop registering here.
                break
            else:
                self._entries.move_to_end(key)
            parent = key
        if self.capacity_blocks is not None:
            over = len(self._entries) - self.capacity_blocks
            if over > 0:
                self.evict_lru(over)
        return added

    # ---- eviction ----------------------------------------------------------

    def evict_lru(self, n_blocks: int) -> int:
        """Release up to ``n_blocks`` cache references, oldest LEAF
        first (never a mid-chain entry — an orphaned suffix would pin
        blocks unreachably). Returns how many entries were evicted; the
        underlying blocks free only once no slot references them."""
        evicted = 0
        while evicted < n_blocks:
            victim = None
            for key, entry in self._entries.items():
                if not entry.children:
                    victim = entry
                    break
            if victim is None:
                break
            del self._entries[victim.key]
            if (
                victim.parent_key is not _ROOT
                and victim.parent_key in self._entries
            ):
                self._entries[victim.parent_key].children.discard(
                    victim.key
                )
            self._alloc.decref(victim.block_id)
            evicted += 1
            self.evicted_blocks_total += 1
        return evicted

    def clear(self) -> None:
        """Drop every cache reference (pool rebuild after a step error:
        the device blocks are gone, the warm set with them)."""
        for entry in self._entries.values():
            self._alloc.decref(entry.block_id)
        self._entries.clear()

    # ---- accounting --------------------------------------------------------

    @property
    def cached_entries(self) -> int:
        return len(self._entries)

    def cached_block_ids(self) -> Set[int]:
        return {e.block_id for e in self._entries.values()}

    def hit_rate(self) -> float:
        total = self.hits_total + self.misses_total
        return self.hits_total / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "entries": len(self._entries),
            "hits": self.hits_total,
            "misses": self.misses_total,
            "hit_blocks": self.hit_blocks_total,
            "evicted_blocks": self.evicted_blocks_total,
            "hit_rate": round(self.hit_rate(), 4),
        }
