"""The float32 ring bodies of K3's head-dim passes (``csrc/decode_hd.cu``:
``scores_ring_kernel<float>``, ``softmax_pv_ring_kernel<float>``) on the
CPU: a plain PyTorch model of their arithmetic against the JAX package.

Both bodies take every float32 product as three TF32 ``mma.sync``
products of the splits ``x = hi + lo``, ``hi = tf32(x)`` (to nearest, by
bit mask) and ``lo = x - hi`` (truncated to TF32 as ``mma.sync`` reads
it, ``ssm_scan/ref.py::to_tf32``):

* pass 1, ``scores_walk``: a score is ``hh + (lh + hl)`` (hi(q) hi(k),
  lo(q) hi(k), hi(q) lo(k)), each summed on the tensor cores over runs of
  at most 64 dims and the runs in fp32;
* pass 2, ``softmax_pv_walk``: the ring's tile walk (``ops._pv_geometry``'s
  tile of TW slots, ``ops._wave_splits``'s splits on an H100, each split's
  tiles dealt to 4 warps, every 4th tile), each warp's fp32 online
  softmax, each tile's P V summed from zero and folded into O with the
  correction; a unit of at most 8 heads also adds lo(p) lo(v) (its rows
  8..15 carry lo(p) against both halves of V), one of 9..16 heads takes
  the three products; the warps merge by their (m, l), then the splits.

The slices' scores are summed in fp32 (the all-reduce over ranks), and
the slices' outputs concatenated; the whole is held to JAX's
``repro.kernels.decode_attention.ref.decode_attention_ref`` over the full
head dim at the reference's float32 tolerance, 2e-5: m 2 / 4 / 16 slices
of D 128 and danube's D 80 at m 4 (Dl 20: whole k8 steps, the dims past
20 read as zeros), G 6 and 12, a window, a row that attends nothing.  With
one TF32 product (``hi(a) hi(b)``) both passes miss that tolerance on a
row of 2,048 slots, so the test tells the two apart.  The kernels
themselves are held to the plain versions on the card
(``chip_smoke.py::hd_phase``, ``tests/test_torch_decode_hd.py``'s
``gpu`` test).
"""
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.ssm_scan.ref import to_tf32

NEG = -1e30
LOG2E = 1.4426950408889634
RUN = 64               # dims a tensor-core sum of pass 1 covers at most
WARPS = 4              # pass 2: warps of a block, every 4th tile each
N_SM = 132
EMPTY = -(2 ** 30)
TOL = dict(atol=2e-5, rtol=2e-5)


def _split(x):
    hi = to_tf32(x)
    return hi, to_tf32(x - hi, nearest=False)


def scores_walk(q, k, scale, terms=2):
    """Pass 1 on one slice: q [B, H, Dl], k [B, C, Hkv, Dl] -> float32
    [B, H, C]."""
    B, H, Dl = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, Dl)
    kt = k.permute(0, 2, 3, 1)                           # [B, Hkv, Dl, C]
    hh = lh = hl = 0.0
    for d0 in range(0, Dl, RUN):
        (qh, ql), (kh, kl) = _split(qg[..., d0:d0 + RUN]), _split(
            kt[..., d0:d0 + RUN, :])
        hh = hh + qh @ kh
        if terms == 2:
            lh = lh + ql @ kh
            hl = hl + qh @ kl
    return ((hh + (lh + hl)) * scale).reshape(B, H, -1)


def _pv(p, v, terms, lolo):
    (ph, pl), (vh, vl) = _split(p), _split(v)
    if terms == 1:
        return ph @ vh
    out = pl @ vh + ph @ vl + ph @ vh
    return out + pl @ vl if lolo else out


def _merge(parts):
    """(m in log2 units, l, acc) of several owners merged by their weights
    exp2(m - M)."""
    M = torch.stack([m for m, _, _ in parts]).max(0).values
    L, A = torch.zeros_like(M), 0.0
    for m, l, acc in parts:
        w = torch.exp2(m - M)
        L = L + l * w
        A = A + acc * w[:, None]
    return M, L, A


def softmax_pv_walk(s, v, q_pos, k_pos, window, terms=2):
    """Pass 2 on one slice: s [B, H, C] summed scores, v [B, C, Hkv, Dl]
    -> [B, H, Dl], with the ring's tile and split count for this launch on
    an H100."""
    B, H, C = s.shape
    _, _, Hkv, Dl = v.shape
    G = H // Hkv
    geo = ops._pv_geometry(B, C, H, Hkv, Dl, 4, N_SM)
    tw = geo["tile"]
    n_split = ops._wave_splits(B, geo["gy"], C, N_SM, geo["blocks_per_sm"],
                               ops.MIN_RING_TILES, tw)
    tiles = -(-C // tw)
    ok = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window is not None:
        ok &= k_pos > q_pos[:, None] - window
    out = torch.zeros(B, H, Dl)
    for b in range(B):
        for hk in range(Hkv):
            for h0 in range(0, G, ops.UNIT_ROWS):      # a unit's heads
                heads = slice(hk * G + h0, hk * G + min(G, h0 + 16))
                lolo = min(G, h0 + 16) - h0 <= 8
                parts = []
                for sp in range(n_split):
                    t_lo = sp * tiles // n_split
                    t_hi = (sp + 1) * tiles // n_split
                    warps = []
                    for w in range(WARPS):
                        n = heads.stop - heads.start
                        m = torch.full((n,), NEG)
                        l, acc = torch.zeros(n), torch.zeros(n, Dl)
                        for t in range(t_lo + w, t_hi, WARPS):
                            c = slice(t * tw, min(C, (t + 1) * tw))
                            att = ok[b, c]
                            if not att.any():
                                continue
                            y = torch.where(att, s[b, heads, c], NEG)
                            mx = torch.maximum(m, y.max(-1).values)
                            cr = torch.exp2((m - mx) * LOG2E)
                            p = torch.where(att, torch.exp2(
                                (y - mx[:, None]) * LOG2E), 0.0)
                            vt = torch.where(att[:, None], v[b, c, hk], 0.0)
                            l = l * cr + p.sum(-1)
                            acc = acc * cr[:, None] + _pv(p, vt, terms, lolo)
                            m = mx
                        warps.append((m * LOG2E, l, acc))
                    parts.append(_merge(warps))
                _, L, A = _merge(parts)
                out[b, heads] = A / torch.clamp(L, min=1e-30)[:, None]
    return out


def hd_walk(q, k, v, q_pos, k_pos, m, window, terms=2):
    """The decode over m head-dim slices, the scores summed over them."""
    D = q.shape[-1]
    cut = [t.chunk(m, -1) for t in (q, k, v)]
    s = sum(scores_walk(a.contiguous(), b.contiguous(), D ** -0.5, terms)
            for a, b in zip(cut[0], cut[1]))
    return torch.cat([softmax_pv_walk(s, c.contiguous(), q_pos, k_pos,
                                      window, terms) for c in cut[2]], -1)


def _case(B, C, H, Hkv, D, valid, seed, spread=1.0):
    rng = np.random.default_rng(seed)
    q = (spread * rng.standard_normal((B, H, D))).astype(np.float32)
    k = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    q_pos = np.asarray([max(n, 1) - 1 for n in valid], np.int32)
    slot = np.arange(C)[None]
    k_pos = np.where(slot < np.asarray(valid)[:, None], slot,
                     EMPTY).astype(np.int32)
    return q, k, v, q_pos, k_pos


def _jax(q, k, v, q_pos, k_pos, window):
    import jax.numpy as jnp
    return np.asarray(decode_attention_ref(
        *(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)), window=window),
        np.float32)


# (B, C, G, Hkv, D, m, valid lengths, window): G 6 (the 1.5B) and 12
# (starcoder2, one 12-head unit of pass 2, two 8-row groups of pass 1),
# Dl 64 / 32 / 8 of D 128 and danube's D 80 at m 4 (Dl 20), a window,
# row 0 attends nothing
CASES = [
    (3, 300, 6, 2, 128, 2, [0, 300, 131], None),
    (3, 300, 6, 2, 128, 4, [0, 300, 77], 40),
    (3, 200, 6, 2, 128, 16, [0, 200, 9], None),
    (3, 150, 12, 2, 128, 2, [0, 150, 64], 30),
    (2, 180, 12, 2, 128, 16, [0, 180], None),
    (3, 160, 4, 2, 80, 4, [0, 160, 100], 50),
]


@pytest.mark.parametrize("case", CASES)
def test_ring_passes_match_jax(case):
    B, C, G, Hkv, D, m, valid, window = case
    q, k, v, q_pos, k_pos = _case(B, C, G * Hkv, Hkv, D, valid,
                                  seed=C + G + D + m)
    got = hd_walk(*map(torch.from_numpy, (q, k, v, q_pos, k_pos)), m,
                  window)
    want = _jax(q, k, v, q_pos, k_pos, window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[0].abs().max()       # a row that attends nothing


def test_pass_one_runs_of_64_dims():
    """Pass 1 over D 384 in one slice (K3's wrapper past D 256): six runs
    of 64 dims, each summed from zero, held to float64."""
    rng = np.random.default_rng(384)
    q = torch.from_numpy(rng.standard_normal((2, 12, 384)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 50, 2, 384)).astype(
        np.float32))
    want = torch.einsum("bhgd,bchd->bhgc", q.double().reshape(2, 2, 6, 384),
                        k.double()).reshape(2, 12, 50) * 384 ** -0.5
    got = scores_walk(q, k, 384 ** -0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_one_tf32_product_misses_the_float32_tolerance():
    """On a row of 2,048 slots (m 2, q spread so the softmax is peaked, as
    trained attention is) three TF32 products hold 2e-5 and one does
    not."""
    C = 2048
    args = _case(1, C, 12, 2, 128, [C], 7, spread=3.0)
    want = _jax(*args, None)
    t = tuple(map(torch.from_numpy, args))
    three = hd_walk(*t, 2, None).numpy()
    one = hd_walk(*t, 2, None, terms=1).numpy()
    err3 = float(np.abs(three - want).max())
    err1 = float(np.abs(one - want).max())
    assert np.allclose(three, want, **TOL), err3
    assert not np.allclose(one, want, **TOL), err1
    assert err1 > 10 * err3, (err1, err3)


@pytest.mark.parametrize("Dl,es,want", [(64, 4, 320), (8, 4, 64),
                                        (20, 4, 192), (32, 4, 192),
                                        (64, 2, 144)])
def test_pass_one_rows(Dl, es, want):
    """Pass 1's staged q row: float32 rows 64 mod 128 bytes (the two rows a
    quarter warp reads as float4 meet no bank conflict), bf16 an odd
    number of 16-byte pieces (ldmatrix's 8 rows)."""
    got = ops._scores_row(Dl * es, es)
    assert got == want and got >= Dl * es
    if es == 4:
        assert got % 128 == 64
    else:
        assert (got // 16) % 2 == 1
