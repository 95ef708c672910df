"""Decode at GQA groups above 8 query heads per KV head, on the CPU.

The reference's Pallas decode kernels take any group G = H / Hkv (they
block q as ``[1, 1, G, D]``); the port's CUDA kernels serve G as
``ceil(G / limit)`` head groups of one launch (``_head_groups``), the
limit being the block body's: 8 on the CUDA cores, and on the tensor
cores 16 where the one-group launch fills the SMs or its rows are long,
else 8.  Here the
port's plain versions, which the card holds those kernels to, are held
to the reference's Pallas kernels in interpret mode and to its oracles at
G = 12 (H = 12, Hkv = 1) and G = 12 (H = 48, Hkv = 4, starcoder2-15b) and
G = 16 (H = 64, Hkv = 4, qwen3-moe): dense decode (also split, as the
kernel merges) and paged decode.  Tolerance: 2e-5 in float32, 5e-2 in
bfloat16.  The grouping rule per body, the merge scratch and the split
counts it sizes are checked here too; ``tests/test_torch_gpu_decode.py``
holds the kernels themselves on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref
from repro.kernels.paged_attention.ops import \
    paged_decode_attention as jax_paged
from repro.kernels.paged_attention.ref import \
    paged_decode_attention_ref as jax_paged_ref
from repro_torch.kernels.decode_attention.ops import (
    GROUP_LIMIT, LONG_TILES, _cut, _head_groups, _launch_groups,
    _launch_splits, _num_splits, _split_scratch, decode_attention)
from repro_torch.kernels.decode_attention.ref import decode_attention_split_ref
from repro_torch.kernels.paged_attention.ops import (_paged_groups,
                                                     _paged_splits,
                                                     paged_decode_attention)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
EMPTY = -(2 ** 30)
GROUPS = [(12, 1), (48, 4), (64, 4)]          # (H, Hkv): G = 12, 12, 16


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _dense(B, H, Hkv, D, C, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    q_pos = np.array([C - 1, C // 3], np.int32)[:B]
    slot = np.broadcast_to(np.arange(C), (B, C))
    k_pos = np.where(slot <= q_pos[:, None], slot, EMPTY).astype(np.int32)
    return q, k, v, q_pos, k_pos


@pytest.mark.parametrize("H,Hkv", GROUPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 8])
def test_decode_at_large_groups_matches_jax(H, Hkv, dtype, window):
    B, D, C = 2, 16, 24
    arrays = _dense(B, H, Hkv, D, C, seed=H + Hkv)
    jdt, tdt = DTYPES[dtype]
    t = [torch.from_numpy(a).to(tdt) if a.dtype == np.float32
         else torch.from_numpy(a) for a in arrays]
    j = [jnp.asarray(a, jdt) if a.dtype == np.float32 else jnp.asarray(a)
         for a in arrays]
    out = decode_attention(*t, window=window)
    assert out.dtype == tdt and out.shape == (B, H, D)
    kern = jax_decode(*j, window=window, block_c=8, interpret=True)
    ref = jax_decode_ref(*j, window=window)
    np.testing.assert_allclose(_f32(out), _f32(kern), **_tol(dtype))
    np.testing.assert_allclose(_f32(out), _f32(ref), **_tol(dtype))
    # the split kernel's arithmetic (splits of 8 slots merged)
    split = decode_attention_split_ref(*t, 3, window=window, tile=8)
    np.testing.assert_allclose(_f32(split), _f32(ref), **_tol(dtype))


@pytest.mark.parametrize("H,Hkv", GROUPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 7])
def test_paged_decode_at_large_groups_matches_jax(H, Hkv, dtype, window):
    B, D, page, maxp = 2, 16, 4, 3
    P = B * maxp + 1
    rng = np.random.default_rng(H * Hkv)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P)).reshape(B, maxp).astype(np.int32)
    lens = np.array([maxp * page, 5], np.int32)
    jdt, tdt = DTYPES[dtype]
    out = paged_decode_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, kp, vp)),
        torch.from_numpy(bt), torch.from_numpy(lens), window=window)
    assert out.dtype == tdt and out.shape == (B, H, D)
    j = [jnp.asarray(a, jdt) for a in (q, kp, vp)] + [jnp.asarray(bt),
                                                       jnp.asarray(lens)]
    kern = jax_paged(*j, window=window, interpret=True)
    ref = jax_paged_ref(*j, window=window)
    np.testing.assert_allclose(_f32(out), _f32(kern), **_tol(dtype))
    np.testing.assert_allclose(_f32(out), _f32(ref), **_tol(dtype))


# (G, body) -> (NG, Gc): one group of all G heads up to the body's limit
GROUP_CASES = {("mma", 6): (1, 6), ("mma", 9): (1, 9), ("mma", 12): (1, 12),
               ("mma", 16): (1, 16), ("mma", 17): (2, 9),
               ("mma", 32): (2, 16), ("core", 6): (1, 6), ("core", 9): (2, 5),
               ("core", 12): (2, 6), ("core", 16): (2, 8),
               ("core", 17): (3, 6)}


@pytest.mark.parametrize("body", ["core", "mma"])
def test_head_groups_cover_every_head_once(body):
    limit = GROUP_LIMIT[body]
    assert limit == {"core": 8, "mma": 16}[body]
    for G in range(1, 129):
        ng, gc = _head_groups(G, body)
        assert gc <= limit and ng * gc >= G
        assert (ng - 1) * gc < G                 # the last group has heads
        assert ng == -(-G // limit)
        assert (ng == 1) == (G <= limit)
        if G <= limit:
            assert gc == G
    for (b, G), want in GROUP_CASES.items():
        if b == body:
            assert _head_groups(G, body) == want


def test_cut_never_leaves_a_group_empty():
    # the launchers' explicit groups (the smoke's two-group launch)
    assert not hasattr(_head_groups, "force")
    assert not hasattr(_num_splits, "force")
    assert _cut(12, 2) == (2, 6) and _cut(16, 2) == (2, 8)
    assert _cut(16, 1) == (1, 16) and _cut(12, 5) == (4, 3)
    assert _cut(3, 8) == (3, 1)
    for G in range(1, 40):
        for ng in range(1, 20):
            n, gc = _cut(G, ng)
            assert (n - 1) * gc < G <= n * gc and n <= min(ng, G)


# (G, body, blocks of the one-group launch) -> (NG, Gc) on 132 SMs
FILL_CASES = {(12, "mma", 256): (1, 12), (12, "mma", 132): (1, 12),
              (12, "mma", 131): (2, 6), (12, "mma", 32): (2, 6),
              (16, "mma", 256): (1, 16), (16, "mma", 128): (2, 8),
              (17, "mma", 256): (2, 9), (17, "mma", 128): (3, 6),
              (8, "mma", 4): (1, 8), (5, "mma", 4): (1, 5),
              (12, "core", 256): (2, 6), (16, "core", 4): (2, 8)}


@pytest.mark.parametrize("key", list(FILL_CASES), ids=str)
def test_head_groups_follow_the_one_group_grid(key):
    """The tensor-core body takes groups of 16 where the one-group
    launch's grid fills the SMs or its rows are long (LONG_TILES tiles a
    SM), and of 8 where neither holds; the CUDA-core body and G <= 8 do
    not depend on the launch."""
    G, body, blocks = key
    assert _head_groups(G, body, blocks, 132) == FILL_CASES[key]
    assert _head_groups(G, body, blocks, 132) == _head_groups(
        G, body, blocks * 2, 2 * 132)
    short = LONG_TILES * 132 - 1
    assert _head_groups(G, body, blocks, 132, short) == FILL_CASES[key]
    # rows long enough: the widest groups whatever the grid
    assert _head_groups(G, body, blocks, 132, short + 1) == \
        _head_groups(G, body) == _head_groups(G, body, 132, 132)


# blocks an SM holds of each body at D 128, given as numbers: the H100's
# query gives 2 for the tensor-core body at any group, and for the
# CUDA-core body fewer the more heads a group holds
RESIDENT = {"mma": lambda gc: 2, "core": lambda gc: {1: 6, 6: 3}.get(gc, 2)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,Hkv", [(48, 4), (64, 4), (12, 1), (48, 8)])
def test_launch_groups_one_group_where_the_rows_fill_the_card(H, Hkv,
                                                              dtype):
    """A one-group launch takes 16-row groups on the tensor cores where
    its grid (B x Hkv x the split rule's count at one group, from the
    blocks an SM holds) fills 132 SMs or its K/V read dominates (the SMs
    walk LONG_TILES tiles each); else groups of 8.  K3 and K2 then read
    each K/V tile once at G 12 / 16 where B x Hkv fills the card or the
    rows are long (B 64 x Hkv 4 at any C, B 32 x 2048), and keep two
    groups at the serve shapes (B 8 or 32 x Hkv 4 at 65 / 161 slots); G
    <= 8 is one group everywhere."""
    G = H // Hkv
    body = "mma" if dtype == torch.bfloat16 else "core"
    res = RESIDENT[body]
    widest = _head_groups(G, body)[1]
    for B in (1, 4, 8, 16, 32, 33, 64, 128):
        for C in (1, 65, 161, 512, 2048, 8192, 32768):
            ng = _launch_groups(B, G, Hkv, 128, C, 132, res, 8, body)
            tiles = -(-C // 16)
            one = _num_splits(B, Hkv, tiles, 132, res(widest), 8, widest,
                              128, body)
            long = B * Hkv * tiles >= LONG_TILES * 132
            want = 1 if G <= 8 or (body == "mma" and (
                B * Hkv * one >= 132 or long)) else 2
            assert ng == _cut(G, want)
            page = 128
            assert _paged_groups(B, G, Hkv, 128, -(-C // page), page, None,
                                 132, res, None, body) == ng
    mma = RESIDENT["mma"]
    assert _launch_groups(64, 12, 4, 128, 8192, 132, mma, 8,
                          "mma") == (1, 12)
    assert _launch_groups(32, 12, 4, 128, 161, 132, mma, 8, "mma") == (2, 6)
    assert _launch_groups(32, 12, 4, 128, 2048, 132, mma, 8,
                          "mma") == (1, 12)
    assert _launch_groups(8, 16, 4, 128, 65, 132, mma, 8, "mma") == (2, 8)


@pytest.mark.parametrize("body", ["core", "mma"])
@pytest.mark.parametrize("G", [6, 9, 12, 16])
def test_split_scratch_is_per_head_group(G, body):
    B, Hkv, D, n = 3, 4, 16, 5
    ng, gc = _head_groups(G, body)
    assert (ng, gc) == GROUP_CASES[body, G]
    acc, ml, counters = _split_scratch(B, Hkv, (ng, gc), D, n,
                                       torch.device("cpu"))
    assert acc.numel() == B * Hkv * ng * n * gc * D >= B * Hkv * n * G * D
    assert ml.numel() == B * Hkv * ng * n * gc * 2
    assert counters.numel() >= B * Hkv * ng and not counters.any()
    assert _split_scratch(B, Hkv, (ng, gc), D, 1, torch.device("cpu")) == \
        (None, None, None)


@pytest.mark.parametrize("body", ["core", "mma"])
@pytest.mark.parametrize("H,Hkv", [(12, 2), (48, 4), (64, 4), (36, 2)])
def test_launch_splits_count_the_body_groups(H, Hkv, body):
    """K3's and K2's split counts treat each head group they launch as one
    more KV head, with the blocks an SM holds of the body at those groups
    and the heads a group serves: the groups given, or by default those
    ``_head_groups`` gives the body for the one-group launch's grid."""
    G, n_sm, D = H // Hkv, 132, 128
    res = RESIDENT[body]
    for B, C in [(1, 8192), (4, 8192), (32, 161), (64, 8192), (64, 161)]:
        page = 128
        maxp = -(-C // page)
        for slots in (C, maxp * page):
            tiles = -(-slots // 16)
            widest = _head_groups(G, body)[1]
            one = _num_splits(B, Hkv, tiles, n_sm, res(widest), 8, widest, D,
                              body)
            ng, gc = _head_groups(G, body, B * Hkv * one, n_sm,
                                  B * Hkv * tiles)
            want = _num_splits(B, Hkv * ng, tiles, n_sm, res(gc), 8, gc, D,
                               body)
            if slots == C:
                assert _launch_splits(B, H, Hkv, D, C, n_sm, res,
                                      body=body) == want
            else:
                assert _paged_splits(B, Hkv, D, maxp, page, None, n_sm, res,
                                     G, body=body) == want
        for groups in ((1, G), _cut(G, 2)):
            want = _num_splits(B, Hkv * groups[0], -(-C // 16), n_sm,
                               res(groups[1]), 8, groups[1], D, body)
            assert _launch_splits(B, H, Hkv, D, C, n_sm, res, body=body,
                                  groups=groups) == want
    # at B 1 over 8192 slots two groups of G 12 / 16 take 12 splits a
    # group and one group 8; at B 64 one split
    if body == "mma" and G in (12, 16):
        assert _launch_splits(1, H, Hkv, D, 8192, n_sm, res) == 12
        assert _launch_splits(1, H, Hkv, D, 8192, n_sm, res,
                              groups=(1, G)) == 8
        assert _launch_splits(64, H, Hkv, D, 8192, n_sm, res) == 1
