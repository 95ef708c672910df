"""Cross-request radix prefix cache over the refcounted paged KV pool.

The port of ``repro.serve.radix``: host-side only, over the port's
``PagedKVCache`` (nothing here touches a tensor).

The copy-on-write ``fork_slot`` shares a prompt's KV pages only
*within* an explicit GRPO group: the engine must be told, at admission
time, that two requests are siblings.  That misses every other reuse
pattern the agentic-RL workload lives on — identical prompts submitted
minutes apart, a few-shot preamble shared by every request of a task,
and above all the multi-turn re-entry pattern: an episode that leaves
the engine for a tool call and comes back with its whole conversation
history as the new prompt, re-prefilling everything it already computed.

This module generalizes the COW machinery into an SGLang-style radix
tree over *all* live and recently-finished sequences:

  * every node owns a page-aligned **run** of tokens plus the physical
    pages holding their K/V (the tree holds one refcount per page, via
    ``PagedKVCache.retain_page`` — pages are co-owned with any live
    slots still using them);
  * ``match(tokens)`` walks the tree and returns the longest cached
    page-aligned prefix; the engine aliases those pages into the new
    slot (``adopt_pages`` — refcount up, no data moved, same COW barrier
    as a fork protects later writes) and prefills only the delta;
  * ``insert(tokens, pages)`` is called on sequence completion: the
    novel page-aligned suffix of the finished sequence becomes a new
    branch that co-owns the slot's pages, so the conversation survives
    the slot being freed and the next turn resumes from cache;
  * ``evict(need)`` releases least-recently-used **leaf** runs only when
    the allocator actually needs pages — interior runs are shared
    prefixes of deeper entries and must outlive them.

Children are keyed by the run's first *page* of tokens (a tuple of
``page_size`` ids), so two runs in the same node position always differ
within their first page and every split point is page-aligned — the
granularity at which pages can be aliased at all.  Sequences shorter
than one page are never cached (nothing page-aligned to share).

Refcount conservation is unchanged: the allocator's invariant
``pages_in_use + free_pages == num_pages - 1`` holds across any
interleaving of match/insert/evict with alloc/fork/cow/free (extended
property test in tests/test_serve.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .kv_cache import PagedKVCache


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class RadixNode:
    """One run of the tree: ``tokens`` (length = len(pages)·page_size)
    plus the pages holding their K/V.  Children are keyed by their run's
    first page of tokens."""

    __slots__ = ("parent", "children", "tokens", "pages", "last_access")

    def __init__(self, parent: Optional["RadixNode"]):
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "RadixNode"] = {}
        self.tokens: List[int] = []
        self.pages: List[int] = []
        self.last_access = 0

    def key(self, page: int) -> Tuple[int, ...]:
        return tuple(self.tokens[:page])


@dataclass
class RadixStats:
    hits: int = 0              # match() calls that returned ≥1 page
    misses: int = 0            # match() calls that returned nothing
    hit_tokens: int = 0        # tokens served from cache across matches
    inserts: int = 0           # new branches created
    insert_pages: int = 0      # pages newly co-owned by the tree
    evictions: int = 0         # leaf runs released
    evicted_pages: int = 0     # pages released back toward the free list

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class RadixCache:
    """The tree + its page-ownership bookkeeping over one ``PagedKVCache``."""

    def __init__(self, kv: PagedKVCache):
        self.kv = kv
        self.page = kv.page
        self.root = RadixNode(None)
        self.stats = RadixStats()
        self._tick = 0

    # --------------------------------------------------------------- lookup
    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached page-aligned prefix of ``tokens``: returns
        (page ids, n_tokens_covered).  Touches every node on the path
        for LRU; adopts nothing — the caller aliases the pages via
        ``PagedKVCache.adopt_pages`` once it decides to admit."""
        self._tick += 1
        node = self.root
        pages: List[int] = []
        matched = 0
        while len(tokens) - matched >= self.page:
            key = tuple(tokens[matched:matched + self.page])
            child = node.children.get(key)
            if child is None:
                break
            n = _common_prefix(child.tokens, tokens[matched:])
            usable = (n // self.page) * self.page
            if usable == 0:          # cannot happen (key matched) — guard
                break
            child.last_access = self._tick
            pages.extend(child.pages[:usable // self.page])
            matched += usable
            if usable < len(child.tokens):
                break                # diverged (or ran out) mid-run
            node = child
        if matched:
            self.stats.hits += 1
            self.stats.hit_tokens += matched
        else:
            self.stats.misses += 1
        return pages, matched

    # --------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Cache a finished sequence: walk the matching prefix, then hang
        the novel page-aligned suffix as a branch co-owning ``pages``
        (the tree retains one refcount per adopted page).  ``tokens``
        must be page-aligned with ``pages`` covering them one page run
        each.  Returns the number of pages newly cached."""
        n_aligned = (len(tokens) // self.page) * self.page
        tokens = list(tokens[:n_aligned])
        assert len(pages) >= n_aligned // self.page, \
            "insert needs one page per page-run of tokens"
        self._tick += 1
        node = self.root
        i = 0
        while i < len(tokens):
            key = tuple(tokens[i:i + self.page])
            child = node.children.get(key)
            if child is None:
                new = RadixNode(node)
                new.tokens = tokens[i:]
                new.pages = list(pages[i // self.page:
                                       len(tokens) // self.page])
                new.last_access = self._tick
                for pid in new.pages:
                    self.kv.retain_page(pid)
                node.children[key] = new
                self.stats.inserts += 1
                self.stats.insert_pages += len(new.pages)
                return len(new.pages)
            n = _common_prefix(child.tokens, tokens[i:])
            k = (n // self.page) * self.page     # page-aligned split point
            child.last_access = self._tick
            if k == len(child.tokens):
                node = child
                i += k
                continue
            # diverges (or ends) mid-run: split the child at the aligned
            # boundary so the shared prefix becomes an interior node
            self._split(child, k)
            node = child
            i += k
        return 0                                  # fully cached already

    def _split(self, node: RadixNode, k: int) -> None:
        """Split ``node``'s run at page-aligned ``k``: node keeps the
        first k tokens, a new child inherits the suffix (pages move
        between nodes — tree ownership, and refcounts, are unchanged)."""
        assert 0 < k < len(node.tokens) and k % self.page == 0
        suffix = RadixNode(node)
        suffix.tokens = node.tokens[k:]
        suffix.pages = node.pages[k // self.page:]
        suffix.last_access = node.last_access
        suffix.children = node.children
        for c in suffix.children.values():
            c.parent = suffix
        node.tokens = node.tokens[:k]
        node.pages = node.pages[:k // self.page]
        node.children = {suffix.key(self.page): suffix}

    # -------------------------------------------------------------- evict
    def evict(self, need: int) -> int:
        """Release least-recently-used leaf runs until the allocator's
        free list grew by ``need`` pages (or the tree is empty).  Pages
        still referenced by a live slot are released from the tree but
        only hit the free list when that slot frees them — eviction
        keeps going until enough pages *actually freed*.  Returns the
        number of pages returned to the free list."""
        freed0 = self.kv.free_pages
        while self.kv.free_pages - freed0 < need:
            leaf = self._lru_leaf()
            if leaf is None:
                break
            for pid in leaf.pages:
                self.kv.release_page(pid)
            del leaf.parent.children[leaf.key(self.page)]
            self.stats.evictions += 1
            self.stats.evicted_pages += len(leaf.pages)
        return self.kv.free_pages - freed0

    def _lru_leaf(self) -> Optional[RadixNode]:
        best: Optional[RadixNode] = None
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif best is None or n.last_access < best.last_access:
                best = n
        return best

    # -------------------------------------------------------------- stats
    @property
    def cached_pages(self) -> int:
        """Pages the tree currently co-owns."""
        total = 0
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            total += len(n.pages)
            stack.extend(n.children.values())
        return total

    @property
    def n_nodes(self) -> int:
        total = 0
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            total += 1
            stack.extend(n.children.values())
        return total

    def reset(self) -> None:
        """Drop the whole tree (releasing every co-owned page) — used
        when cached K/V becomes invalid, e.g. on a weight swap."""
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            for pid in n.pages:
                self.kv.release_page(pid)
            stack.extend(n.children.values())
        self.root = RadixNode(None)
