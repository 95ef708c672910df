"""Decode at GQA groups above 8 query heads per KV head, on the CPU.

The reference's Pallas decode kernels take any group G = H / Hkv (they
block q as ``[1, 1, G, D]``); the port's CUDA kernels serve G above 8 as
``ceil(G / 8)`` head groups of one launch (``_head_groups``).  Here the
port's plain versions, which the card holds those kernels to, are held
to the reference's Pallas kernels in interpret mode and to its oracles at
G = 12 (H = 12, Hkv = 1) and G = 12 (H = 48, Hkv = 4, starcoder2-15b) and
G = 16 (H = 64, Hkv = 4, qwen3-moe): dense decode (also split, as the
kernel merges) and paged decode.  Tolerance: 2e-5 in float32, 5e-2 in
bfloat16.  The grouping rule and the merge scratch it sizes are checked
here too; ``tests/test_torch_gpu_decode.py`` holds the kernels themselves
on a card.
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
    MAX_GROUP, _head_groups, _split_scratch, decode_attention)
from repro_torch.kernels.decode_attention.ref import decode_attention_split_ref
from repro_torch.kernels.paged_attention.ops import paged_decode_attention

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


def test_head_groups_cover_every_head_once():
    for G in range(1, 129):
        ng, gc = _head_groups(G)
        assert gc <= MAX_GROUP and ng * gc >= G
        assert (ng - 1) * gc < G                 # the last group has heads
        assert (ng == 1) == (G <= MAX_GROUP)
        if G <= MAX_GROUP:
            assert gc == G
    assert _head_groups(12) == (2, 6) and _head_groups(16) == (2, 8)
    assert _head_groups(6) == (1, 6) and _head_groups(9) == (2, 5)


@pytest.mark.parametrize("G", [6, 9, 12, 16])
def test_split_scratch_is_per_head_group(G):
    B, Hkv, D, n = 3, 4, 16, 5
    acc, ml, counters = _split_scratch(B, Hkv, G, D, n, torch.device("cpu"))
    ng, gc = _head_groups(G)
    assert acc.numel() == B * Hkv * ng * n * gc * D >= B * Hkv * n * G * D
    assert ml.numel() == B * Hkv * ng * n * gc * 2
    assert counters.numel() >= B * Hkv * ng and not counters.any()
    assert _split_scratch(B, Hkv, G, D, 1, torch.device("cpu")) == \
        (None, None, None)
