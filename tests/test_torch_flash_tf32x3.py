"""K1's float32 tensor-core kernel (``csrc/flash_attention_fwd_tf32x3.cu``)
on the CPU: a plain PyTorch model of its arithmetic against the JAX
package.

The kernel splits every float32 operand as ``x = hi + lo`` with ``hi =
tf32(x)`` and ``lo = tf32(x - hi)`` (``cvt.rna.tf32.f32``: round to 10
mantissa bits, ties away from zero) and takes each product as ``lo(a) hi(b)
+ hi(a) lo(b) + hi(a) hi(b)`` in fp32, in both S = Q K^T and O += P V, with
an fp32 online softmax over the key tiles of its own plan
(``ops._tile_plan(..., "tf32x3")``: 64 packed rows a block, 32 keys a
tile).  ``tf32x3_walk`` does the same with TF32 rounding by bit mask
(``ssm_scan/ref.py::to_tf32`` and ``tf32_product``).  Held to JAX
``attention_ref`` at the reference's float32 tolerance (2e-5), it passes;
with one TF32 product (``hi(a) hi(b)``) it fails that tolerance, so the
test tells the two apart.  The kernel itself is held to the plain
version on the card by ``chip_smoke.py::kernels_phase``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention.ops import TILES, _tile_plan
from repro_torch.kernels.ssm_scan.ref import tf32_product, to_tf32

NEG_INF = -1e30
LOG2E = 1.4426950408889634
TOL = dict(atol=2e-5, rtol=2e-5)


def tf32x3_walk(q, k, v, causal, window, split=True):
    """The kernel's arithmetic in float32: per (b, hk) and per block of its
    plan, S over each visited key tile (zeros past Sk), masks only on the
    tiles the plan marks, the online softmax with log2(e) folded into the
    scale, and O += P V; a row with nothing attended gives 0.  Its
    products are ``ssm_scan/ref.py::tf32_product`` with both halves rounded
    to nearest, as this kernel splits them."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    keys = TILES["tf32x3"][1]
    scale_log2 = (1.0 / math.sqrt(D)) * LOG2E
    terms = 2 if split else 1
    pad = -(-Sk // keys) * keys + keys
    kz = torch.zeros(B, pad, Hkv, D)
    vz = torch.zeros(B, pad, Hkv, D)
    kz[:, :Sk], vz[:, :Sk] = k, v
    out = torch.zeros(B, Sq, H, D)
    for b in range(B):
        for hk in range(Hkv):
            for r0, r1, tiles in _tile_plan(Sq, Sk, G, causal, window,
                                            "tf32x3"):
                R = torch.arange(r0, r1)
                p, h = R // G, hk * G + R % G
                qb = q[b, p, h]                               # [rows, D]
                m = torch.full((len(R),), NEG_INF)
                l = torch.zeros(len(R))
                acc = torch.zeros(len(R), D)
                for k0, masked in tiles:
                    j = torch.arange(k0, k0 + keys)
                    s = tf32_product(qb, kz[b, j, hk].T, terms, True)
                    if masked:
                        ok = (j < Sk)[None].expand_as(s)
                        if causal:
                            ok = ok & (j[None] <= p[:, None])
                        if window is not None:
                            ok = ok & (j[None] > p[:, None] - window)
                        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    corr = torch.exp2((m - m_new) * scale_log2)
                    x = torch.exp2(s * scale_log2 - (m_new * scale_log2)[:, None])
                    x = torch.where((m_new == NEG_INF)[:, None],
                                    torch.zeros_like(x), x)
                    l = l * corr + x.sum(dim=1)
                    m = m_new
                    acc = acc * corr[:, None] + tf32_product(
                        x, vz[b, j, hk], terms, True)
                out[b, p, h] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out


# (B, Sq, Sk, H, Hkv, D), (causal, window)
CASES = [
    ((1, 40, 40, 12, 2, 128), (True, None)),     # G 6: 240 rows, 4 blocks
    ((1, 70, 70, 6, 1, 64), (True, 20)),         # window, G 6
    ((1, 33, 65, 4, 2, 80), (False, None)),      # non-causal, Sq != Sk
    ((1, 33, 65, 4, 4, 64), (True, None)),       # ragged causal, G 1
    ((2, 96, 32, 8, 2, 80), (True, 16)),         # rows >= 47 attend nothing
    ((1, 100, 100, 12, 2, 80), (True, 9)),       # G 6, D 80, window
    ((1, 50, 50, 12, 2, 128), (False, None)),    # G 6 non-causal
]


def _inputs(shape):
    B, Sq, Sk, H, Hkv, D = shape
    rng = np.random.default_rng(Sq * 1000 + Sk + D + H)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    return q, k, v


def _jax_ref(q, k, v, causal, window):
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    qp = jnp.broadcast_to(jnp.arange(Sq), (B, Sq))
    kp = jnp.broadcast_to(jnp.arange(Sk), (B, Sk))
    return np.asarray(jax_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=qp,
        k_positions=kp, causal=causal, window=window), np.float32)


def test_tf32_rounding_by_bit_mask():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 3.0e-3, 0.0])
    got = to_tf32(x)
    # ties (a half unit of the 10th bit) go away from zero
    assert got.tolist()[:5] == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                1.0 + 2 ** -9, -(1.0 + 2 ** -10)]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    # hi + lo keeps 21 of float32's 24 bits and more
    y = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    hi = to_tf32(y)
    lo = to_tf32(y - hi)
    assert float(((hi + lo - y).abs() / y.abs()).max()) < 2 ** -21


@pytest.mark.parametrize("shape,mask", CASES)
def test_tf32x3_walk_matches_jax(shape, mask):
    causal, window = mask
    q, k, v = _inputs(shape)
    got = tf32x3_walk(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), causal, window)
    want = _jax_ref(q, k, v, causal, window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if shape == (2, 96, 32, 8, 2, 80):
        assert not got[:, 47:].abs().max()


def test_one_tf32_product_fails_the_float32_tolerance():
    shape, (causal, window) = CASES[0]
    q, k, v = _inputs(shape)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal, window)
    want = _jax_ref(q, k, v, causal, window)
    three = tf32x3_walk(*args).numpy()
    one = tf32x3_walk(*args, split=False).numpy()
    err3 = float(np.abs(three - want).max())
    err1 = float(np.abs(one - want).max())
    assert np.allclose(three, want, **TOL)
    assert not np.allclose(one, want, **TOL)
    assert err1 > 20 * err3, (err1, err3)
