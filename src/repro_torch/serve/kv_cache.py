"""Paged KV cache: fixed-size blocks, block tables, refcounted COW pool.

The port of ``repro.serve.kv_cache``.  Device side, the cache is two pools
``[L, P, page, Hkv, D]`` (keys and values for every layer) on the engine's
device; host side, this class is the allocator: a LIFO free list of page
ids, a free list of sequence slots, per-slot length bookkeeping, a per-page
reference count and the ``[max_slots, maxp]`` int32 block table (numpy,
as in the reference).

Pages are allocated lazily as sequences grow (admission only reserves the
prompt), so pool memory tracks *actual* context, not the right-padded
worst case.

**Prefix sharing (copy-on-write).**  ``fork_slot(parent)`` gives a child
slot whose block table *aliases* the parent's prompt pages (refcount
incremented, no data moved).  Before a sequence WRITES into a page with
ref > 1, ``writable()`` copies that page into a free one, points the
writer's table at the private copy and decrements the shared page's
refcount; ``free_slot`` decrements refcounts, and a page returns to the
free list only when its count hits zero.  The copy is in place:
``k_pages[:, dst].copy_(k_pages[:, src])`` moves one page across all
layers, with no pool copy (the reference needed a donated jit for that).

Page id 0 is reserved as the null sink: unused block-table entries point
at it, and the batched decode step routes inactive slots' writes there.

``dirty`` flags host-table mutations so the engine can cache the device
copy of ``block_tables`` and re-upload only when something changed.

``page_size=None`` resolves through ``kernels.tuning`` (default 128).
The pools are created outside inference mode, so the engine may update
them in place whether or not its caller runs under
``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import tuning
from repro_torch.models.api import ModelConfig


class PagedKVCache:
    def __init__(self, cfg: ModelConfig, *, max_slots: int, max_len: int,
                 num_pages: Optional[int] = None,
                 page_size: Optional[int] = None, device=None):
        self.cfg = cfg
        self.page = tuning.resolve("paged_attention", "page_size", page_size)
        self.max_slots = max_slots
        self.max_len = max_len
        self.maxp = -(-max_len // self.page)           # pages per sequence
        # default pool: worst case + null page — callers shrink num_pages to
        # make paging bite (admission then waits on frees)
        self.num_pages = (1 + max_slots * self.maxp if num_pages is None
                          else num_pages)
        if self.num_pages < 2:
            raise ValueError("pool needs the null page plus ≥1 usable page")

        self.device = resolve_device(device)
        shape = (cfg.n_layers, self.num_pages, self.page, cfg.n_kv_heads,
                 cfg.hd)
        with torch.inference_mode(False):
            self.k_pages = torch.zeros(shape, dtype=cfg.tdtype,
                                       device=self.device)
            self.v_pages = torch.zeros(shape, dtype=cfg.tdtype,
                                       device=self.device)
        self.block_tables = np.zeros((max_slots, self.maxp), np.int32)
        self.seq_lens = np.zeros((max_slots,), np.int32)

        self._free_pages: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._free_slots: List[int] = list(range(max_slots - 1, -1, -1))
        self._pages_of: Dict[int, List[int]] = {}
        # per-page reference count; the null page stays at 0 forever
        self._ref = np.zeros((self.num_pages,), np.int32)
        self.dirty = True          # host block_tables newer than device copy
        self.forks = 0             # fork_slot calls (lifetime)
        self.cow_copies = 0        # divergent-write page copies (lifetime)

    # -------------------------------------------------------------- alloc
    def pages_needed(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.page)

    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    def alloc_slot(self) -> Optional[int]:
        if not self._free_slots:
            return None
        slot = self._free_slots.pop()
        self._pages_of[slot] = []
        self.seq_lens[slot] = 0
        self.block_tables[slot, :] = 0
        self.dirty = True
        return slot

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s block table to cover ``n_tokens`` logical slots.
        False (with no partial allocation) when the pool can't cover it."""
        owned = self._pages_of[slot]
        need = self.pages_needed(n_tokens) - len(owned)
        if need <= 0:
            return True
        if need > len(self._free_pages) or n_tokens > self.max_len:
            return False
        for _ in range(need):
            pid = self._free_pages.pop()
            self.block_tables[slot, len(owned)] = pid
            self._ref[pid] = 1
            owned.append(pid)
        self.dirty = True
        return True

    def fork_slot(self, parent: int, n_tokens: int,
                  child: Optional[int] = None) -> Optional[int]:
        """Make ``child`` a slot whose table aliases ``parent``'s pages
        covering ``n_tokens`` logical slots (refcounts incremented, no K/V
        moved).  ``child=None`` allocates a fresh slot (None when none is
        free); passing a pre-allocated empty slot lets callers reserve the
        slot at admission and fork later.  The caller must route any write
        into a shared page through ``writable`` first."""
        owned = self._pages_of[parent]
        npages = self.pages_needed(n_tokens)
        assert npages <= len(owned), "parent does not cover the prefix"
        if child is None:
            child = self.alloc_slot()
            if child is None:
                return None
        cpages = self._pages_of[child]
        assert not cpages, "fork target slot must hold no pages"
        for i in range(npages):
            pid = owned[i]
            self.block_tables[child, i] = pid
            self._ref[pid] += 1
            cpages.append(pid)
        self.seq_lens[child] = min(int(self.seq_lens[parent]), n_tokens)
        self.dirty = True
        self.forks += 1
        return child

    def writable(self, slot: int, pos: int) -> bool:
        """Copy-on-write barrier: make the page holding logical slot
        ``pos`` privately owned by ``slot`` (copying it if shared) so the
        caller may write there.  True when the position is writable
        (including positions past the table — ``ensure`` allocates those
        as private pages); False when a copy is needed but the pool has
        no free page (caller preempts and retries)."""
        idx = pos // self.page
        owned = self._pages_of[slot]
        if idx >= len(owned):
            return True                    # ensure() will allocate fresh
        pid = owned[idx]
        if self._ref[pid] <= 1:
            return True
        if not self._free_pages:
            return False
        new = self._free_pages.pop()
        # one page of K and V across all layers, copied in place
        self.k_pages[:, new].copy_(self.k_pages[:, pid])
        self.v_pages[:, new].copy_(self.v_pages[:, pid])
        self._ref[pid] -= 1
        self._ref[new] = 1
        owned[idx] = new
        self.block_tables[slot, idx] = new
        self.dirty = True
        self.cow_copies += 1
        return True

    # ---------------------------------------------- radix-cache co-ownership
    def retain_page(self, pid: int) -> None:
        """Take a reference on ``pid`` on behalf of an owner that is not a
        slot (the radix prefix cache).  The page must be live — the tree
        only adopts pages out of a slot that still holds them."""
        assert 0 < pid < self.num_pages and self._ref[pid] > 0, \
            "retain_page requires a live non-null page"
        self._ref[pid] += 1

    def release_page(self, pid: int) -> None:
        """Drop a non-slot reference taken by ``retain_page``; the page
        returns to the free list when no slot or tree node holds it."""
        assert self._ref[pid] > 0
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free_pages.append(pid)

    def adopt_pages(self, slot: int, page_ids: List[int],
                    n_tokens: int) -> None:
        """Alias cached pages into an empty ``slot``'s block table covering
        ``n_tokens`` logical slots (refcounts incremented, no K/V moved) —
        the radix-cache analogue of ``fork_slot``.  Writes into adopted
        pages must go through the same ``writable`` COW barrier."""
        owned = self._pages_of[slot]
        assert not owned, "adopt target slot must hold no pages"
        assert len(page_ids) == self.pages_needed(n_tokens) and \
            n_tokens % self.page == 0, "adoption must be page-aligned"
        for i, pid in enumerate(page_ids):
            assert self._ref[pid] > 0, "cannot adopt a freed page"
            self.block_tables[slot, i] = pid
            self._ref[pid] += 1
            owned.append(pid)
        self.seq_lens[slot] = n_tokens
        self.dirty = True

    def free_slot(self, slot: int) -> None:
        for pid in self._pages_of.pop(slot):
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                self._free_pages.append(pid)
        self.block_tables[slot, :] = 0
        self.seq_lens[slot] = 0
        self._free_slots.append(slot)
        self.dirty = True

    # -------------------------------------------------------------- stats
    @property
    def pages_in_use(self) -> int:
        """Physical pages holding live data (shared pages count once)."""
        return int((self._ref > 0).sum())

    @property
    def logical_pages(self) -> int:
        """Page references across all live block tables (shared pages
        count once per referencing sequence)."""
        return int(self._ref.sum())

    @property
    def shared_pages(self) -> int:
        return int((self._ref > 1).sum())

    @property
    def slots_in_use(self) -> int:
        return self.max_slots - len(self._free_slots)

    def shared_frac(self) -> float:
        """Fraction of logical page references served by a shared physical
        page — the pool capacity prefix sharing is saving right now."""
        logical = self.logical_pages
        return (logical - self.pages_in_use) / logical if logical else 0.0

    def page_occupancy(self) -> float:
        """Fraction of *logical* page capacity holding live tokens — the
        internal-fragmentation metric the page-size knob trades against."""
        cap = self.logical_pages * self.page
        return float(int(self.seq_lens.sum()) / cap) if cap else 1.0

    def occupancy(self) -> Dict[str, float]:
        usable = self.num_pages - 1
        return {
            "pages_in_use": float(self.pages_in_use),
            "pages_total": float(usable),
            "pool_util": self.pages_in_use / usable if usable else 0.0,
            "page_occupancy": self.page_occupancy(),
            "shared_frac": self.shared_frac(),
            "slots_in_use": float(self.slots_in_use),
        }
