"""Parity of the port's paged KV allocator and radix cache with the JAX
package, on the CPU.

One seeded random sequence of alloc / ensure / fork / writable (COW) /
free / retain / release / adopt / radix insert / match / evict runs on
both ``PagedKVCache``s (each with its ``RadixCache``).  After every
operation the block tables, sequence lengths, refcounts, free lists and
fork / COW counts are identical, and after every COW copy the pools hold
the same values.  The conservation property of ``tests/test_serve.py``
(``pages_in_use + free_pages == num_pages - 1`` under any interleaving)
is checked on the port with hypothesis.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:                                   # pragma: no cover
    from _prop import given, settings, st

from repro.models.api import ModelConfig as JaxModelConfig
from repro.serve.kv_cache import PagedKVCache as JaxKV
from repro.serve.radix import RadixCache as JaxRadix
from repro_torch.bridge import to_tensor
from repro_torch.models.api import ModelConfig
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.radix import RadixCache

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=259, dtype="float32", remat=False)
KV = dict(max_slots=4, max_len=64, page_size=8, num_pages=11)


def _toks(x, n):
    """Tokens of one of three conversations, so matches really hit."""
    return [(x % 3 + 7 * i) % 250 + 3 for i in range(n)]


def _pair():
    """Both caches, their pools filled with the same random values."""
    jkv = JaxKV(JaxModelConfig(**TINY), **KV)
    tkv = PagedKVCache(ModelConfig(**TINY), device="cpu", **KV)
    rng = np.random.default_rng(0)
    for name in ("k_pages", "v_pages"):
        data = rng.standard_normal(tkv.k_pages.shape).astype(np.float32)
        setattr(jkv, name, jnp.asarray(data))
        getattr(tkv, name).copy_(to_tensor(data))
    return jkv, tkv


def _apply(kv, radix, live, x):
    """One operation picked by ``x`` (the op set of the reference's
    conservation property, plus retain/release and adopt).  Returns what
    the operation returned, for comparison."""
    op = x % 10
    if op == 0:
        s = kv.alloc_slot()
        if s is not None:
            live.append(s)
        return s
    if not live and op not in (6, 7):
        return None
    pick = live[(x // 10) % len(live)] if live else None
    if op == 1:
        live.remove(pick)
        kv.free_slot(pick)
    elif op == 2:
        return kv.ensure(pick, (x // 64) % 70)       # may be refused
    elif op == 3:
        covered = len(kv._pages_of[pick]) * kv.page
        if covered:
            child = kv.fork_slot(pick, 1 + (x // 64) % covered)
            if child is not None:
                live.append(child)
            return child
    elif op == 4:
        covered = len(kv._pages_of[pick]) * kv.page
        if covered:
            return kv.writable(pick, (x // 64) % covered)
    elif op == 5:
        npages = len(kv._pages_of[pick])
        if npages:
            k = 1 + (x // 64) % npages
            return radix.insert(_toks(x // 512, k * kv.page),
                                kv._pages_of[pick][:k])
    elif op == 6:
        return radix.match(_toks(x // 512, kv.page * (1 + x // 8 % 3)))
    elif op == 7:
        return radix.evict(1 + (x // 8) % 4)
    elif op == 8:
        owned = kv._pages_of[pick]
        if owned:                   # a non-slot owner takes and drops a ref
            pid = owned[(x // 64) % len(owned)]
            kv.retain_page(pid)
            kv.release_page(pid)
            return pid
    elif op == 9:
        pages, n = radix.match(_toks(x // 512, 3 * kv.page))
        s = kv.alloc_slot()
        if s is not None:
            live.append(s)
            if pages:
                kv.adopt_pages(s, pages, n)
        return s, n
    return None


def _state(kv):
    return dict(tables=np.array(kv.block_tables), lens=np.array(kv.seq_lens),
                ref=np.array(kv._ref), free_pages=list(kv._free_pages),
                free_slots=list(kv._free_slots),
                pages_of={s: list(p) for s, p in kv._pages_of.items()},
                forks=kv.forks, cow=kv.cow_copies, dirty=kv.dirty,
                occ=kv.occupancy())


@pytest.mark.parametrize("seed", [0, 14, 19])
def test_allocator_matches_jax_under_random_ops(seed):
    jkv, tkv = _pair()
    jrx, trx = JaxRadix(jkv), RadixCache(tkv)
    jlive, tlive = [], []
    ops = np.random.default_rng(seed).integers(0, 1 << 20, size=200)
    cows = 0
    for x in ops:
        jout = _apply(jkv, jrx, jlive, int(x))
        tout = _apply(tkv, trx, tlive, int(x))
        assert tout == jout
        js, ts = _state(jkv), _state(tkv)
        for key in js:
            if isinstance(js[key], np.ndarray):
                np.testing.assert_array_equal(ts[key], js[key], err_msg=key)
            else:
                assert ts[key] == js[key], key
        assert tlive == jlive
        assert vars(trx.stats) == vars(jrx.stats)
        assert (trx.cached_pages, trx.n_nodes) == (jrx.cached_pages,
                                                   jrx.n_nodes)
        if tkv.cow_copies > cows:
            cows = tkv.cow_copies
            np.testing.assert_array_equal(tkv.k_pages.numpy(),
                                          np.asarray(jkv.k_pages))
            np.testing.assert_array_equal(tkv.v_pages.numpy(),
                                          np.asarray(jkv.v_pages))
    assert cows > 0, "the sequence should exercise the COW copy"
    assert trx.stats.hits > 0 and tkv.forks > 0
    for s in tlive:
        tkv.free_slot(s)
    trx.reset()
    assert tkv.pages_in_use == 0 and tkv.free_pages == tkv.num_pages - 1


def test_cow_copy_is_in_place_and_copies_one_page():
    """``writable`` copies the shared page across all layers into the
    writer's new page, in place: the pool tensors are the same objects,
    and every other page is untouched."""
    _, kv = _pair()
    parent = kv.alloc_slot()
    assert kv.ensure(parent, 20)
    child = kv.fork_slot(parent, 20)
    before = kv.k_pages.clone()
    pool = kv.k_pages
    tail = int(kv.block_tables[child][2])
    assert kv.writable(child, 20)
    new = int(kv.block_tables[child][2])
    assert kv.k_pages is pool and new != tail
    torch.testing.assert_close(kv.k_pages[:, new], before[:, tail],
                               rtol=0, atol=0)
    others = [p for p in range(kv.num_pages) if p != new]
    torch.testing.assert_close(kv.k_pages[:, others], before[:, others],
                               rtol=0, atol=0)


def test_pool_is_writable_in_place_under_inference_mode():
    """The pool is made outside inference mode, so a host COW copy after
    an inference-mode step (and the reverse) works."""
    with torch.inference_mode():
        _, kv = _pair()
        s = kv.alloc_slot()
        kv.ensure(s, 10)
        kv.k_pages[0, 1, 0].fill_(1.0)
    c = kv.fork_slot(s, 10)
    assert kv.writable(c, 10) and kv.cow_copies == 1
    with torch.inference_mode():
        kv.k_pages[0, kv.block_tables[c][1], 0].fill_(2.0)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 1 << 20), min_size=1, max_size=40))
def test_refcount_conservation_property(ops):
    """Any interleaving keeps the pool conserved: pages_in_use +
    free_pages == num_pages - 1, every live table entry names a page
    with refcount > 0, nothing on the free list is referenced, and no
    radix node references a freed page.  After freeing every slot and
    resetting the tree, the pool is whole."""
    kv = PagedKVCache(ModelConfig(**TINY), device="cpu", **KV)
    radix = RadixCache(kv)
    live = []
    for x in ops:
        _apply(kv, radix, live, x)
        assert kv.pages_in_use + kv.free_pages == kv.num_pages - 1
        assert kv._ref[0] == 0
        free = set(kv._free_pages)
        assert all(kv._ref[p] == 0 for p in free)
        for s in live:
            owned = kv._pages_of[s]
            for i, pid in enumerate(owned):
                assert kv._ref[pid] > 0 and pid not in free
                assert kv.block_tables[s, i] == pid
            assert (kv.block_tables[s, len(owned):] == 0).all()
        stack = list(radix.root.children.values())
        while stack:
            node = stack.pop()
            assert all(kv._ref[p] > 0 and p not in free for p in node.pages)
            stack.extend(node.children.values())
    for s in live:
        kv.free_slot(s)
    radix.reset()
    assert kv.pages_in_use == 0 and kv.free_pages == kv.num_pages - 1


def test_radix_match_insert_split_evict_matches_jax():
    """The reference's radix scenario on both packages: the same pages,
    matches, splits and evictions."""
    out = []
    for KVC, RX, cfg in ((JaxKV, JaxRadix, JaxModelConfig(**TINY)),
                         (PagedKVCache, RadixCache, ModelConfig(**TINY))):
        extra = {} if KVC is JaxKV else {"device": "cpu"}
        kv = KVC(cfg, max_slots=4, max_len=64, page_size=8, num_pages=17,
                 **extra)
        rx = RX(kv)
        s = kv.alloc_slot()
        kv.ensure(s, 32)
        pages = list(kv._pages_of[s])
        seq = list(range(3, 35))
        rec = [rx.insert(seq, pages), rx.cached_pages, rx.n_nodes,
               rx.match(seq), rx.match(seq[:20]), rx.match([99] * 16)]
        s2 = kv.alloc_slot()
        kv.ensure(s2, 16)
        rec.append(rx.insert(seq[:16] + [200] * 16,
                             pages[:2] + list(kv._pages_of[s2])))
        rec += [rx.n_nodes, rx.cached_pages]
        kv.free_slot(s)
        kv.free_slot(s2)
        rec += [rx.evict(2), rx.n_nodes, list(kv._free_pages),
                vars(rx.stats).copy()]
        rx.reset()
        rec += [rx.cached_pages, kv.pages_in_use, kv.free_pages]
        out.append(rec)
    assert out[1] == out[0]
    assert out[0][2] == 1 and out[0][7] == 3     # one run, then a split
