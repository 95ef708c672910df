"""K1's three kernels on the CPU: which one serves a call, and a plain
model of the packed tensor-core kernels' tile walk against the JAX package.

``_variant(dtype, D)`` picks the bf16 tensor-core kernel ("wgmma") for
bfloat16 at D = 64, 80 or 128 (80 padded to two 64-column chunks in shared
memory), the float32 tensor-core kernel ("tf32x3", the 3xTF32 split) for
float32 at those D, and the CUDA-core kernel ("simt") otherwise.  A packed
kernel gives a block a tile of rows of (position, head) pairs of one KV
head (128 for wgmma, 64 for tf32x3) and visits only the key tiles of
``_tile_plan`` (64 or 32 keys), masking only the tiles the plan marks; the
model below attends over exactly those keys with exactly those masks.
Held to JAX ``attention_ref`` at 2e-5 in float32, it shows that the skip
ranges drop no attended key and that no unmasked tile holds a key the
masks would drop.  The kernels themselves are held to the plain version on
the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention.ops import TILES, _tile_plan, _variant


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 64, "tf32x3"), (torch.float32, 128, "tf32x3"),
    (torch.bfloat16, 8, "simt"), (torch.bfloat16, 16, "simt"),
    (torch.bfloat16, 24, "simt"), (torch.bfloat16, 256, "simt"),
    (torch.float32, 8, "simt"), (torch.float32, 16, "simt"),
    (torch.float32, 24, "simt"), (torch.float32, 256, "simt"),
    (torch.bfloat16, 80, "wgmma"), (torch.float32, 80, "tf32x3"),
])
def test_variant(dtype, D, want):
    assert _variant(dtype, D) == want


def packed_walk(q, k, v, causal, window, variant):
    """A packed kernel's arithmetic in float64 numpy: per (b, hk) and per
    block of packed rows of ``variant``'s plan, softmax over the keys of the
    visited tiles, masked only where the plan says (keys past Sk are zeros,
    as the kernels' copies fill them); a row with nothing attended gives
    0."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    keys = TILES[variant][1]
    pad = -(-Sk // keys) * keys + keys
    kz = np.zeros((B, pad, Hkv, D))
    vz = np.zeros((B, pad, Hkv, D))
    kz[:, :Sk], vz[:, :Sk] = k, v
    out = np.zeros((B, Sq, H, D))
    for b in range(B):
        for hk in range(Hkv):
            for r0, r1, tiles in _tile_plan(Sq, Sk, G, causal, window,
                                            variant):
                if not tiles:
                    continue
                R = np.arange(r0, r1)
                p, h = R // G, hk * G + R % G
                s, vals = [], []
                for k0, masked in tiles:
                    j = np.arange(k0, k0 + keys)
                    ok = np.ones((len(R), keys), bool)
                    if masked:
                        ok = np.broadcast_to(j < Sk, ok.shape).copy()
                        if causal:
                            ok &= j[None] <= p[:, None]
                        if window is not None:
                            ok &= j[None] > p[:, None] - window
                    s.append(np.where(ok, q[b, p, h] @ kz[b, j, hk].T
                                      / np.sqrt(D), -np.inf))
                    vals.append(vz[b, j, hk])
                s = np.concatenate(s, axis=1)
                live = ~np.isneginf(s).all(axis=1)
                w = np.exp(s[live] - s[live].max(axis=1, keepdims=True))
                w /= w.sum(axis=1, keepdims=True)
                out[b, p[live], h[live]] = w @ np.concatenate(vals)
    return out


WALKS = [(shape, mask) for shape in [(2, 33, 65, 4, 4, 24),
                                     (2, 40, 40, 4, 2, 16),
                                     (1, 24, 24, 4, 1, 8),
                                     (1, 22, 22, 12, 2, 8),    # G=6: 132 rows
                                     (1, 40, 40, 10, 2, 8),    # G=5
                                     (1, 30, 50, 7, 1, 8)]     # G=7
         for mask in [(True, None), (True, 9), (False, None)]]
WALKS += [((2, 96, 32, 8, 2, 16), (True, 16)),   # rows >= 47 attend nothing
          ((1, 200, 200, 6, 1, 8), (True, 70))]  # tiles skipped on both sides


@pytest.mark.parametrize("variant", sorted(TILES))
@pytest.mark.parametrize("shape,mask", WALKS)
def test_packed_walk_matches_jax(shape, mask, variant):
    B, Sq, Sk, H, Hkv, D = shape
    causal, window = mask
    rng = np.random.default_rng(B * Sq + D + H)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    got = packed_walk(q, k, v, causal, window, variant)
    qp = jnp.broadcast_to(jnp.arange(Sq), (B, Sq))
    kp = jnp.broadcast_to(jnp.arange(Sk), (B, Sk))
    ref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            q_positions=qp, k_positions=kp, causal=causal,
                            window=window)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=2e-5,
                               rtol=2e-5)
    # one block per tile of packed rows; with a window over a long enough
    # sequence the last block starts past the first key tile
    rows, keys = TILES[variant]
    plans = list(_tile_plan(Sq, Sk, H // Hkv, causal, window, variant))
    assert len(plans) == -(-Sq * (H // Hkv) // rows)
    if window is not None and Sq == Sk > window + 2 * keys:
        assert plans[-1][2][0][0] > 0
