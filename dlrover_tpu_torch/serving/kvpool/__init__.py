"""Paged KV memory plane of the port: block-table cache, cross-request
prefix reuse, admission riding the serving scheduler.

- :class:`BlockAllocator` — torch-free free list + refcounts + COW over
  the ``[layers, num_blocks, block_size, kv_heads, head_dim]`` pool;
- :class:`PrefixCache` — token-prefix trie → warm refcounted block
  chains, leaf-first LRU eviction;
- :class:`PagedServingEngine` — the flat engine's step loop over block
  tables, decode attention through the paged kernel, prefix-hit prefill
  skipping, pool-pressure relief (cache eviction → youngest-request
  preemption);
- :mod:`migrate` — a request's blocks and scheduler state as bytes
  (the reference's payload), exported from one engine and admitted
  mid-stream into another.
"""

from dlrover_tpu_torch.serving.kvpool.allocator import (
    BlockAllocator,
    BlockPoolExhausted,
)
from dlrover_tpu_torch.serving.kvpool.engine import (
    SENTINEL_BLOCK,
    PagedServingEngine,
)
from dlrover_tpu_torch.serving.kvpool.migrate import (
    MigrationError,
    MigrationRefused,
    can_import,
    export_request,
    import_request,
    peek_header,
    release_exported,
)
from dlrover_tpu_torch.serving.kvpool.prefix_cache import PrefixCache

__all__ = [
    "BlockAllocator",
    "BlockPoolExhausted",
    "PrefixCache",
    "PagedServingEngine",
    "SENTINEL_BLOCK",
    "MigrationError",
    "MigrationRefused",
    "export_request",
    "import_request",
    "release_exported",
    "can_import",
    "peek_header",
]
