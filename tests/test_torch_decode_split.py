"""The split-cache decode (K3) on the CPU: its split-and-merge arithmetic
against the JAX package, and the split count's properties.

``decode_attention_split_ref`` is the kernel's arithmetic in plain
PyTorch: per split fp32 ``(acc, m, l)`` over its slots, then the merge.
The same numpy inputs, made from a seed, go through it and through JAX's
``repro.kernels.decode_attention.ref.decode_attention_ref``.  Tolerance:
2e-5 in float32, 5e-2 in bfloat16, and never a NaN, also where most
splits attend nothing.  The CUDA kernel itself is held to the plain
version on the card by ``chip_smoke.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref
from repro_torch.kernels.decode_attention.ops import (EVERY_COUNT,
                                                      MAX_SPLITS,
                                                      MERGE_UNROLL,
                                                      MIN_SPLIT_TILES,
                                                      TILE, _num_splits)
from repro_torch.kernels.decode_attention.ref import decode_attention_split_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
EMPTY = -(2 ** 30)


def _case(name: str):
    """Cache layouts where whole splits attend nothing."""
    B, H, Hkv, D = 4, 4, 2, 16
    rng = np.random.default_rng(len(name))
    window = None
    if name == "ragged":           # row 0: 1 valid slot of 40
        C = 40
        lens = np.array([1, 7, 23, 40])
        slot = np.broadcast_to(np.arange(C), (B, C))
        dead = slot >= lens[:, None]
        k = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
        v = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
        # poison the dead slots: masked entries must never leak
        k[dead] = 1e6
        v[dead] = -1e6
        q_pos = (lens - 1).astype(np.int32)
        k_pos = np.where(dead, EMPTY, slot).astype(np.int32)
    elif name == "window":         # a window of 6 empties the early splits
        C, window = 40, 6
        k = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
        v = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
        q_pos = np.array([39, 39, 20, 5], np.int32)
        k_pos = np.where(np.arange(C)[None] <= q_pos[:, None],
                         np.arange(C)[None], EMPTY).astype(np.int32)
    else:                          # SWA ring: valid slots are not a prefix
        B, C, window = 2, 16, 10
        k = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
        v = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
        k_pos = np.full((B, C), EMPTY, np.int32)
        for s in range(C):
            k_pos[0, s] = 21 - 1 - ((21 - 1 - s) % C)
        k_pos[1, :5] = np.arange(5)
        q_pos = np.array([20, 4], np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    return q, k, v, q_pos, k_pos, window


SPLITS = [(name, n, tile) for name in ("ragged", "window", "ring")
          for n, tile in [(1, 1), (2, 1), (3, 1), (7, 1), ("C", 1), (2, 8)]]


@pytest.mark.parametrize("name,n_split,tile", SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ref_matches_jax(name, n_split, tile, dtype):
    q, k, v, q_pos, k_pos, window = _case(name)
    C = k.shape[1]
    n_split = C if n_split == "C" else n_split
    jdt, tdt = DTYPES[dtype]
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    out = decode_attention_split_ref(*t, torch.from_numpy(q_pos),
                                     torch.from_numpy(k_pos), n_split,
                                     window=window, tile=tile)
    ref = jax_decode_ref(*[jnp.asarray(a, jdt) for a in (q, k, v)],
                         jnp.asarray(q_pos), jnp.asarray(k_pos),
                         window=window)
    got = out.float().numpy()
    assert out.dtype == tdt and np.isfinite(got).all()
    tol = 5e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,Hkv,C,resident,rows,D", [
    (1, 1, 1, 4, 1, 64), (1, 1, TILE, 2, 6, 128), (1, 1, TILE + 1, 2, 6, 128),
    (8, 2, 161, 2, 6, 128), (32, 2, 161, 2, 6, 128), (32, 2, 256, 2, 6, 128),
    (64, 2, 8192, 2, 6, 128), (64, 2, 8192, 4, 6, 64), (8, 2, 1000, 3, 4, 80),
    (1, 8, 100_000, 2, 4, 128), (200, 8, 4096, 2, 4, 128),
    (3, 1, 300, 4, 12, 64), (8, 12, 1500, 4, 1, 64), (4, 8, 4096, 3, 4, 80),
])
@pytest.mark.parametrize("body", ["mma", "core"])
def test_num_splits_properties(B, Hkv, C, resident, rows, D, body):
    """The split rule is a pure function of numbers: at least one split,
    never more than the body's MAX_SPLITS or the tiles over
    MIN_SPLIT_TILES (1 when C fits two splits' least tiles; past
    EVERY_COUNT a multiple of MERGE_UNROLL), never fewer where the SMs
    hold more blocks or the rows walk more tiles, never more where a split
    must hold more tiles; and it refuses a split of no tile and an SM of
    no block."""
    if body == "core":
        rows = min(rows, 8)        # the CUDA-core body's groups
    tiles = math.ceil(C / TILE)

    def rule(B=B, tiles=tiles, n_sm=132, resident=resident,
             min_tiles=MIN_SPLIT_TILES):
        return _num_splits(B, Hkv, tiles, n_sm, resident, min_tiles, rows,
                           D, body)

    n = rule()
    assert 1 <= n <= max(1, min(MAX_SPLITS[body], tiles // MIN_SPLIT_TILES))
    assert n <= EVERY_COUNT or n % MERGE_UNROLL == 0
    if tiles < 2 * MIN_SPLIT_TILES:
        assert n == 1
    assert rule(resident=resident + 1) >= n
    assert rule(tiles=2 * tiles) >= n
    assert rule(min_tiles=2 * MIN_SPLIT_TILES) <= n
    # the same launch on a card of twice the SMs and half the rows per SM
    assert rule(n_sm=264) >= n
    with pytest.raises(ValueError, match="min_tiles"):
        rule(min_tiles=0)
    with pytest.raises(ValueError, match="resident"):
        rule(resident=0)


def test_num_splits_pays_a_split_only_where_it_gains():
    """A split that only adds a merge is not taken (K2's 1.5B paged step,
    32 rows x 2 KV heads over 256 slots: 1, where the half-wave rule took
    2); one that fills idle SMs is (whisper's 96 rows x KV heads over 94
    tiles, 4 blocks an SM: 4 splits, one resident wave of 384 blocks);
    and the merge's unrolled loop makes 4 splits cheaper than 5 or 6."""
    assert _num_splits(32, 2, 16, 132, 2, 8, 6, 128) == 1
    assert _num_splits(8, 12, 94, 132, 4, 8, 1, 64) == 4
    assert 8 * 12 * 4 <= 4 * 132 < 8 * 12 * 6
    assert _num_splits(64, 2, 512, 132, 2, 8, 6, 128) == 1
    assert _num_splits(1, 8, 512, 132, 2, 8, 6, 128) == 12
