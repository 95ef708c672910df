"""The split paged decode (K2) on the CPU: its per-row split-and-merge
arithmetic against the JAX package, and its split count.

``paged_decode_attention_split_ref`` is the kernel's arithmetic in plain
PyTorch: each row's reachable slots ``[lo, end)`` cut into ``n_split``
runs of whole tiles, fp32 ``(acc, m, l)`` per run, then the merge.  The
same numpy inputs, made from a seed, go through it and through JAX's
``repro.kernels.paged_attention.ref.paged_decode_attention_ref`` (with the
table ids clamped, as the JAX wrapper clamps them).  Tolerance: 2e-5 in
float32, 5e-2 in bfloat16, and never a NaN, also where most splits of a
row attend nothing.  The CUDA kernel itself is held to the plain version
on the card by ``chip_smoke.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ref import \
    paged_decode_attention_ref as jax_paged_ref
from repro_torch.kernels.decode_attention.ops import TILE, _num_splits
from repro_torch.kernels.paged_attention.ops import _paged_splits
from repro_torch.kernels.paged_attention.ref import \
    paged_decode_attention_split_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(name: str):
    """Pools and tables where whole splits of a row attend nothing."""
    B, H, Hkv, D, page, maxp = 4, 4, 2, 16, 8, 5
    rng = np.random.default_rng(len(name) + 11)
    window = None
    lens = np.array([0, 1, 19, 40])           # an empty row, a 1-slot row
    if name == "window":                       # a window of 6 empties the
        lens = np.array([40, 33, 6, 3])        # early splits of long rows
        window = 6
    elif name == "small_pages":                # pages of 4: tiles span pages
        page, maxp = 4, 9
        lens = np.array([36, 5, 17, 0])
    elif name == "window_small_pages":
        page, maxp, window = 4, 9, 13
        lens = np.array([36, 14, 2, 30])
    P = B * maxp + 1
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[:B * maxp].reshape(B, maxp)
    bt = bt.astype(np.int32)
    # poison what no row may read: the null page and the dead slots
    kp[0], vp[0] = 1e6, -1e6
    for b in range(B):
        for slot in range(int(lens[b]), maxp * page):
            pid = bt[b, slot // page]
            kp[pid, slot % page], vp[pid, slot % page] = 1e6, -1e6
    if name == "absurd_ids":                   # ids past the row's pages
        bt[:, 3:] = 10 ** 6
        lens = np.minimum(lens, 3 * page)
    return q, kp, vp, bt, lens.astype(np.int32), window


CASES = ("ragged", "window", "small_pages", "window_small_pages",
         "absurd_ids")
SPLITS = [(1, 1), (2, 1), (3, 1), (7, 1), ("max", 1), (2, TILE),
          (3, TILE)]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("n_split,tile", SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_ref_matches_jax(name, n_split, tile, dtype):
    q, kp, vp, bt, lens, window = _case(name)
    P, page = kp.shape[:2]
    reach = bt.shape[1] * page if window is None else window
    n_max = -(-reach // tile)
    n_split = n_max if n_split == "max" else min(n_split, n_max)
    jdt, tdt = DTYPES[dtype]
    out = paged_decode_attention_split_ref(
        *[torch.from_numpy(a).to(tdt) for a in (q, kp, vp)],
        torch.from_numpy(bt), torch.from_numpy(lens), n_split,
        window=window, tile=tile)
    ref = jax_paged_ref(*[jnp.asarray(a, jdt) for a in (q, kp, vp)],
                        jnp.clip(jnp.asarray(bt), 0, P - 1),
                        jnp.asarray(lens), window=window)
    got = out.float().numpy()
    assert out.dtype == tdt and out.shape == q.shape
    assert np.isfinite(got).all()
    tol = 5e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)
    # a row of length 0 gives exactly 0
    for b in np.flatnonzero(lens == 0):
        assert not got[b].any()


def test_paged_split_ref_refuses_more_splits_than_tiles():
    q, kp, vp, bt, lens, _ = _case("window")
    t = [torch.from_numpy(a) for a in (q, kp, vp, bt, lens)]
    with pytest.raises(ValueError, match="n_split"):
        paged_decode_attention_split_ref(*t, 2, window=6, tile=TILE)


@pytest.mark.parametrize("B,Hkv,maxp,page,window,resident,D", [
    (32, 2, 2, 128, None, 2, 128),      # the paged main path
    (64, 2, 64, 128, None, 2, 128),     # the long shape
    (8, 2, 64, 128, None, 3, 128),
    (3, 2, 9, 4, None, 6, 16),
    (3, 2, 9, 4, 13, 4, 64),
    (1, 1, 1, 4, None, 2, 128),
    (2, 2, 512, 16, 100, 5, 64),
    (4, 8, 1000, 16, None, 2, 128),
    (2, 2, 8, 16, 0, 2, 128),
    (4, 8, 36, 128, 4096, 3, 80),       # danube's paged rows
])
def test_paged_splits_properties(B, Hkv, maxp, page, window, resident, D):
    """Never more splits than the tiles a row can reach (the table's
    width, or the window); otherwise K3's count over that reach, and with
    the host's longest length K3's count over it rounded up to a page
    (never more than without it)."""
    reach = maxp * page if window is None else min(maxp * page, window)
    tiles = max(1, math.ceil(reach / TILE))
    res = lambda gc: resident                 # noqa: E731
    n = _paged_splits(B, Hkv, D, maxp, page, window, 132, res)
    assert 1 <= n <= tiles
    assert n == _num_splits(B, Hkv, math.ceil(max(1, reach) / TILE), 132,
                            resident, 8, 1, D)
    for max_len in (1, page, 3 * page + 1, maxp * page, 10 ** 6):
        span = max(1, min(reach, -(-max_len // page) * page))
        got = _paged_splits(B, Hkv, D, maxp, page, window, 132, res,
                            max_len=max_len)
        assert got == _num_splits(B, Hkv, math.ceil(span / TILE), 132,
                                  resident, 8, 1, D) <= n
