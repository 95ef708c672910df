"""Continuous-batching generation over a paged copy-on-write KV cache, the
port of ``repro.serve``.

The cache is organized around one page lifecycle, **match → alias → COW
→ insert → evict**: admission matches a prompt against the ``radix``
tree and aliases the cached pages into the new slot; GRPO groups share
one prefill through ``fork_slot``; the first divergent write to a shared
page copies just that page; a finished sequence inserts its pages back
into the tree; and the tree gives up LRU leaves when the allocator runs
dry.

Modules:

  * ``kv_cache`` — the paged pool ``[L, P, page, Hkv, D]`` on the device
    and its host allocator (free lists, block tables, refcounts, COW).
  * ``radix``    — the cross-request radix prefix cache over the pool.
  * ``model``    — chunked prefill and batched decode over the pool; decode
    attention through the hand-written paged flash-decode kernel.
  * ``engine``   — the continuous scheduler (``PagedEngine``).
  * ``feedback`` — ``EngineReport``, the engine's observed behavior.
"""
from .engine import EngineStats, PagedEngine, ServeConfig
from .feedback import EngineReport
from .kv_cache import PagedKVCache
from .radix import RadixCache

__all__ = ["PagedEngine", "ServeConfig", "EngineStats", "PagedKVCache",
           "RadixCache", "EngineReport"]
