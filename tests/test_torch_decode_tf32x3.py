"""K3's and K2's float32 tensor-core body (``csrc/split_decode.cuh
::decode_block_tf32x3``) on the CPU: a plain PyTorch model of its
arithmetic against the JAX package.

The body splits every float32 operand as ``x = hi + lo`` with ``hi =
tf32(x)`` (to nearest, by bit mask) and ``lo = x - hi`` (truncated to TF32
as ``mma.sync`` reads it) and takes each product as ``lo(a) hi(b) + hi(a)
lo(b) + hi(a) hi(b)``, in S = Q K^T and in O += P V.  It walks a row's
run of slots as the kernel does: the run cut into ``n_split`` splits of
whole 16-slot tiles (``split_tiles``), each split's tiles dealt to 4
pairs of warps, every 4th tile, the two warps of a pair taking its two
halves of 8 slots; each warp keeps its own fp32 online softmax, each half
tile's P V summed from zero and folded in with the correction; the 8
warps merge in the block, then the splits by their (m, l).
``tf32x3_walk`` does the same on one row (``ssm_scan/ref.py
::tf32_product``).  Held to the JAX Pallas kernels in interpret mode (as
``tests/test_kernels.py`` runs them) at the reference's float32
tolerance, 2e-5, over dense and paged rows, windows, rows that attend
nothing, G 6 and 12 (two head groups of 6) and D 64 / 80 / 128; with one
TF32 product (``hi(a) hi(b)``) it misses that tolerance on a row of 2,048
slots, so the test tells the two apart.  The kernel itself is held to the
plain version on the card (``chip_smoke.py``, ``tests/
test_torch_gpu_decode.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.paged_attention.ops import paged_decode_attention as jax_paged
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.ssm_scan.ref import tf32_product

NEG = -1e30
LOG2E = 1.4426950408889634
TILE, HALF, PAIRS = 16, 8, 4
EMPTY = -(2 ** 30)
TOL = dict(atol=2e-5, rtol=2e-5)


def tf32x3_walk(q, k, v, attended, n_split, scale, terms=2):
    """One row through the body: q [Hkv, G, D], k / v [n, Hkv, D] the
    row's run of n slots, ``attended`` [n] bool; returns o [Hkv, G, D] (0
    for a head that attends nothing).  ``terms`` 1 takes every product as
    one TF32 product."""
    Hkv, G, D = q.shape
    n = k.shape[0]
    tiles = -(-n // TILE)
    pad = tiles * TILE
    kz, vz = torch.zeros(pad, Hkv, D), torch.zeros(pad, Hkv, D)
    att = torch.zeros(pad, dtype=torch.bool)
    kz[:n], vz[:n], att[:n] = k, v, attended
    # unattended slots are zero-filled, never read
    kz[~att], vz[~att] = 0.0, 0.0
    kz, vz = kz.transpose(0, 1), vz.transpose(0, 1)      # [Hkv, pad, D]
    scale_log2 = scale * LOG2E
    parts = []
    for s in range(n_split):
        t_lo, t_hi = s * tiles // n_split, (s + 1) * tiles // n_split
        warps = []
        for w in range(2 * PAIRS):
            m = torch.full((Hkv, G), NEG)
            l = torch.zeros(Hkv, G)
            acc = torch.zeros(Hkv, G, D)
            for t in range(t_lo + w % PAIRS, t_hi, PAIRS):
                sl = slice(t * TILE + HALF * (w // PAIRS),
                           t * TILE + HALF * (w // PAIRS) + HALF)
                ok = att[sl]
                if not ok.any():
                    continue
                x = tf32_product(q, kz[:, sl].transpose(1, 2), terms)
                x = torch.where(ok, x * scale_log2, torch.full_like(x, NEG))
                mx = torch.maximum(m, x.max(-1).values)
                corr = torch.exp2(m - mx)
                p = torch.where((mx == NEG)[..., None], torch.zeros_like(x),
                                torch.exp2(x - mx[..., None]))
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + tf32_product(p, vz[:, sl],
                                                           terms)
                m = mx
            warps.append((m, l, acc))
        parts.append(_merge(warps))
    _, L, A = parts[0] if n_split == 1 else _merge(parts)
    return A / torch.clamp(L, min=1e-30)[..., None]


def _merge(parts):
    """(m, l, acc) of several owners merged by their weights exp2(m -
    M)."""
    M = torch.stack([m for m, _, _ in parts]).max(0).values
    L, A = torch.zeros_like(M), 0.0
    for m, l, acc in parts:
        w = torch.exp2(m - M)
        L = L + l * w
        A = A + acc * w[..., None]
    return M, L, A


def dense_walk(q, k, v, q_pos, k_pos, window, n_split, terms=2):
    """K3 on the body: each row's run is its whole cache, attended by
    position."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    out = torch.zeros(B, H, D)
    for b in range(B):
        kp, qp = k_pos[b], int(q_pos[b])
        ok = (kp >= 0) & (kp <= qp)
        if window is not None:
            ok &= kp > qp - window
        out[b] = tf32x3_walk(q[b].reshape(Hkv, H // Hkv, D), k[b], v[b], ok,
                             n_split, 1.0 / math.sqrt(D), terms).reshape(H, D)
    return out


def paged_walk(q, k_pages, v_pages, tables, lengths, window, n_split):
    """K2 on the body: a row's run is the slots the mask can reach, [lo,
    end), each read through its page (ids clamped into the pool)."""
    B, H, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    maxp = tables.shape[1]
    out = torch.zeros(B, H, D)
    for b in range(B):
        n = int(lengths[b])
        end = min(n, maxp * page)
        lo = 0 if window is None else max(0, n - window)
        i = torch.arange(lo, max(lo, end))
        pid = tables[b, torch.clamp(i // page, max=maxp - 1)].clamp(
            0, P - 1).long()
        k, v = k_pages[pid, i % page], v_pages[pid, i % page]
        out[b] = tf32x3_walk(q[b].reshape(Hkv, H // Hkv, D), k, v,
                             torch.ones(len(i), dtype=torch.bool), n_split,
                             1.0 / math.sqrt(D)).reshape(H, D)
    return out


def _dense(B, H, Hkv, D, C, valid, seed, spread=1.0):
    rng = np.random.default_rng(seed)
    q = (spread * rng.standard_normal((B, H, D))).astype(np.float32)
    k = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    q_pos = np.asarray(valid, np.int32) - 1
    slot = np.arange(C)[None]
    k_pos = np.where(slot <= q_pos[:, None], slot, EMPTY).astype(np.int32)
    return q, k, v, q_pos, k_pos


def _jax_dense(q, k, v, q_pos, k_pos, window):
    return np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(k_pos), window=window, interpret=True), np.float32)


# (B, H, Hkv, D, C, valid lengths, window, n_split): G 6 and 12, D 64 /
# 80 / 128, windows, one and several splits, a row that attends nothing
# (length 0), C not a multiple of the tile
DENSE = [
    (3, 12, 2, 128, 300, [300, 131, 7], None, 1),
    (3, 12, 2, 128, 300, [300, 131, 7], 40, 3),
    (2, 24, 2, 64, 200, [200, 97], None, 2),
    (3, 12, 2, 80, 150, [150, 64, 1], 30, 1),
    (2, 24, 2, 80, 100, [100, 50], None, 4),
    (3, 12, 2, 64, 77, [77, 0, 40], None, 1),
]


@pytest.mark.parametrize("case", DENSE)
def test_dense_walk_matches_jax(case):
    B, H, Hkv, D, C, valid, window, n_split = case
    q, k, v, q_pos, k_pos = _dense(B, H, Hkv, D, C, valid, C + D + H)
    got = dense_walk(*map(torch.from_numpy, (q, k, v, q_pos, k_pos)),
                     window, n_split)
    want = _jax_dense(q, k, v, q_pos, k_pos, window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for b, n in enumerate(valid):
        if n == 0:                  # a row that attends nothing reads 0
            assert not got[b].abs().max()


# (B, H, Hkv, D, maxp, lengths, window, n_split), pages of 16
PAGED = [
    (3, 12, 2, 128, 20, [320, 100, 1], None, 1),
    (3, 24, 2, 64, 12, [190, 33, 120], 50, 3),
    (3, 12, 2, 80, 10, [160, 0, 77], None, 2),
]


@pytest.mark.parametrize("case", PAGED)
def test_paged_walk_matches_jax(case):
    B, H, Hkv, D, maxp, lens, window, n_split = case
    page = 16
    P = B * maxp + 1
    rng = np.random.default_rng(maxp + D + H)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    tables = (rng.permutation(P - 1)[:B * maxp] + 1).reshape(
        B, maxp).astype(np.int32)
    lengths = np.asarray(lens, np.int32)
    got = paged_walk(*map(torch.from_numpy, (q, kp, vp, tables, lengths)),
                     window, n_split)
    want = np.asarray(jax_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lengths), window=window, interpret=True), np.float32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for b, n in enumerate(lens):
        if n == 0:
            assert not got[b].abs().max()


def test_one_tf32_product_misses_the_float32_tolerance():
    """On a row of 2,048 slots three TF32 products hold 2e-5 and one does
    not (q spread so the softmax is peaked, as trained attention is)."""
    C = 2048
    q, k, v, q_pos, k_pos = _dense(1, 12, 2, 128, C, [C], 7, spread=3.0)
    want = _jax_dense(q, k, v, q_pos, k_pos, None)
    args = tuple(map(torch.from_numpy, (q, k, v, q_pos, k_pos)))
    three = dense_walk(*args, None, 4).numpy()
    one = dense_walk(*args, None, 4, terms=1).numpy()
    err3 = float(np.abs(three - want).max())
    err1 = float(np.abs(one - want).max())
    assert np.allclose(three, want, **TOL), err3
    assert not np.allclose(one, want, **TOL), err1
    assert err1 > 10 * err3, (err1, err3)


def test_body_serves_float32_at_the_tensor_core_dims():
    """Float32 at D 64 / 80 / 128 on aligned tensors takes the body, in
    groups of up to 8 heads (rows 8..15 of the m16 tile carry the lo
    halves); anything else stays where it was."""
    for D in (64, 80, 128):
        assert ops._decode_body(torch.float32, D, True) == "tf32x3"
        assert ops._decode_body(torch.float32, D, False) == "core"
        assert ops._decode_body(torch.bfloat16, D, True) == "mma"
    assert ops._decode_body(torch.float32, 96, True) == "core"
    assert ops.GROUP_LIMIT["tf32x3"] == 8
    assert ops.BODIES["tf32x3"] == 2
    for G, want in ((6, (1, 6)), (12, (2, 6)), (16, (2, 8)), (9, (2, 5))):
        assert ops._head_groups(G, "tf32x3") == want
        # the group rule never widens the float32 body past 8
        assert ops._head_groups(G, "tf32x3", 10 ** 6, 132, 10 ** 9) == want


@pytest.mark.parametrize("D", [64, 80, 128])
def test_h100_resident_of_the_body(D):
    """The blocks an H100 SM holds of the body, as the CPU models count
    them: 8 warps x 3 stages of a half tile's K (rows 16 mod 32 floats)
    and V (rows D + 4) set them (the card's query gives the same, which
    ``chip_smoke.py`` checks)."""
    ld_k = D + (48 - D % 32) % 32
    ring = 8 * 3 * 8 * (ld_k + D + 4) * 4
    assert ring <= 232448                       # a block's most
    want = 233472 // (ring + 1024)
    assert ops.H100_RESIDENT_TF32X3[D] == want
    assert ops._h100_resident(D, "tf32x3")(6) == want
    assert ops._h100_resident(D)(6) == ops.H100_RESIDENT[D]
