"""Paged KV memory plane of the port: block-table cache, cross-request
prefix reuse, admission riding the serving scheduler.

- :class:`BlockAllocator` — torch-free free list + refcounts + COW over
  the ``[layers, num_blocks, block_size, kv_heads, head_dim]`` pool;
- :class:`PrefixCache` — token-prefix trie → warm refcounted block
  chains, leaf-first LRU eviction;
- :class:`PagedServingEngine` — the flat engine's step loop over block
  tables, decode attention through the paged kernel, prefix-hit prefill
  skipping, pool-pressure relief (cache eviction → youngest-request
  preemption).

The migration of a request's blocks between engines is not ported yet.
"""

from dlrover_tpu_torch.serving.kvpool.allocator import (
    BlockAllocator,
    BlockPoolExhausted,
)
from dlrover_tpu_torch.serving.kvpool.engine import (
    SENTINEL_BLOCK,
    PagedServingEngine,
)
from dlrover_tpu_torch.serving.kvpool.prefix_cache import PrefixCache

__all__ = [
    "BlockAllocator",
    "BlockPoolExhausted",
    "PrefixCache",
    "PagedServingEngine",
    "SENTINEL_BLOCK",
]
