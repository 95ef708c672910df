"""Head dim 80 (h2o-danube) on the tensor cores, on the CPU.

Which kernel or block body serves a call: K1's ``_variant`` sends bfloat16
at D = 80 to the wgmma kernel, and ``decode_attention.ops._decode_body``
(the body that ``csrc/split_decode.cuh::dispatch`` launches for K3 and K2)
sends it to the mma body, with the H100's resident blocks following D.  A numpy
model of the wgmma kernel's padding (D padded to whole 64-column chunks
in shared memory, zeros past D, Q K^T over the k16 steps of real columns
only, P V over the padded chunks, the store cut at D, the scale of the
true D) is held to JAX ``attention_ref``.  The wrappers' plain versions
at D = 80 are held to the JAX Pallas kernels in interpret mode (as
``tests/test_kernels.py`` runs them), whose wrappers pad D to 128 in HBM
and scale by the true D.  Tolerances: 2e-5 in float32, 5e-2 in bfloat16.
The kernels themselves run only on the card (``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.paged_attention.ops import paged_decode_attention as jax_paged
from repro.kernels.paged_attention.ref import paged_decode_attention_ref as jax_paged_ref
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import (WGMMA_DIMS, _variant,
                                                     flash_attention)
from repro_torch.kernels.paged_attention.ops import paged_decode_attention

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
EMPTY = -(2 ** 30)


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _both(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------- which body serves
@pytest.mark.parametrize("D", [8, 16, 20, 32, 48, 64, 80, 96, 112, 128, 160,
                               256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_decode_body(D, dtype, aligned):
    """Aligned tensors at D 64 / 80 / 128 take a tensor-core body, "mma"
    in bfloat16 and "tf32x3" (three TF32 products) in float32; the rest
    the CUDA-core body."""
    tensor_cores = D in (64, 80, 128) and aligned
    want = (("mma" if dtype == torch.bfloat16 else "tf32x3")
            if tensor_cores else "core")
    assert decode_ops._decode_body(dtype, D, aligned) == want


@pytest.mark.parametrize("D,rows16,want", [
    (64, False, 4), (64, True, 4), (80, False, 3), (80, True, 3),
    (128, False, 2), (128, True, 2),
])
def test_h100_resident_follows_the_head_dim(D, rows16, want):
    """The blocks an H100 SM holds of the tensor-core body, as the CPU
    models count them (``_h100_resident``; the card's query gives the
    same, which ``chip_smoke.py`` checks): the shared-memory ring of 4
    warps x 3 stages of K and V tiles sets them, whatever the rows."""
    gc = 12 if rows16 else 6
    assert decode_ops._h100_resident(D)(gc) == decode_ops.H100_RESIDENT[D]
    assert decode_ops.H100_RESIDENT[D] == want
    ring = 4 * 3 * 2 * 16 * (2 * D + 16)
    assert want == 233472 // (ring + 1024)


def test_variants_agree_on_the_head_dims():
    """K1's wgmma kernel and the decode mma body serve the same bf16 head
    dims, and K1's and the decode's float32 tensor-core kernels the same
    float32 ones, so a config runs its prefill and its decode both on the
    tensor cores or neither."""
    assert tuple(WGMMA_DIMS) == tuple(decode_ops.MMA_DIMS) == (64, 80, 128)
    for D in range(8, 257, 8):
        assert (_variant(torch.bfloat16, D) == "wgmma") == (
            decode_ops._decode_body(torch.bfloat16, D, True) == "mma")
        assert (_variant(torch.float32, D) == "tf32x3") == (
            decode_ops._decode_body(torch.float32, D, True) == "tf32x3")


def test_aligned_reads_the_pointers():
    base = torch.zeros(64, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0        # the CPU allocator aligns to 64
    whole = base[:16]
    assert decode_ops._aligned(whole, whole, whole)
    off1 = base[1:17]       # 2 bytes in: neither k's 16 nor q's 4 hold
    assert not decode_ops._aligned(whole, off1, whole)
    assert not decode_ops._aligned(off1, whole, whole)
    off2 = base[2:18]       # 4 bytes in: q's 4 holds, v's 16 does not
    assert decode_ops._aligned(off2, whole, whole)
    assert not decode_ops._aligned(whole, whole, off2)


def test_decode_wrappers_count_by_body_and_not_on_cpu():
    """Both decode wrappers carry a count per body; a CPU call runs the
    plain version and counts nothing."""
    for fn in (decode_attention, paged_decode_attention):
        assert set(fn.launches_by_variant) == {"mma", "tf32x3", "core"}
    before = [(fn.launches, dict(fn.launches_by_variant))
              for fn in (decode_attention, paged_decode_attention)]
    q = torch.randn(1, 4, 80, dtype=torch.bfloat16)
    kv = torch.randn(1, 16, 2, 80, dtype=torch.bfloat16)
    decode_attention(q, kv, kv, torch.tensor([5], dtype=torch.int32),
                     torch.arange(16, dtype=torch.int32)[None])
    paged_decode_attention(q, kv, kv, torch.zeros(1, 1, dtype=torch.int32),
                           torch.tensor([9], dtype=torch.int32))
    assert [(fn.launches, dict(fn.launches_by_variant))
            for fn in (decode_attention, paged_decode_attention)] == before


# ------------------------------------------- the wgmma kernel's padding
def padded_model(q, k, v, causal, window):
    """The wgmma kernel's arithmetic over padded head dims, in float64
    numpy: q, k, v zero-padded to whole 64-column chunks (shared memory),
    scores over the k16 steps that hold real columns only, scaled by the
    true D; P V over every padded column; the store keeps columns < D and
    the padded ones must come out 0."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    Dp = -(-D // 64) * 64
    steps = -(-D // 16)

    def pad(x):
        out = np.zeros(x.shape[:-1] + (Dp,))
        out[..., :D] = x
        return out

    qz, kz, vz = pad(q), pad(k), pad(v)
    i = np.arange(Sq)[:, None]
    j = np.arange(Sk)[None]
    ok = (j <= i) if causal else np.ones((Sq, Sk), bool)
    if window is not None:
        ok = ok & (j > i - window)
    out = np.zeros((B, Sq, H, Dp))
    for b in range(B):
        for h in range(H):
            qs, ks = qz[b, :, h, :16 * steps], kz[b, :, h // G, :16 * steps]
            s = np.where(ok, qs @ ks.T / np.sqrt(D), -np.inf)
            m = s.max(-1, keepdims=True)
            w = np.where(np.isneginf(m), 0.0, np.exp(s - m))
            den = np.maximum(w.sum(-1, keepdims=True), 1e-30)
            out[b, :, h] = (w / den) @ vz[b, :, h // G]
    assert not out[..., D:].any()
    return out[..., :D]


@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
def test_padded_model_matches_jax(D, causal, window):
    B, Sq, H, Hkv = 1, 70, 8, 2
    rng = np.random.default_rng(D + (window or 0))
    q, k, v = (rng.standard_normal((B, Sq, n, D)).astype(np.float32)
               for n in (H, Hkv, Hkv))
    got = padded_model(q, k, v, causal, window)
    pos = jnp.broadcast_to(jnp.arange(Sq), (B, Sq))
    ref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            q_positions=pos, k_positions=pos, causal=causal,
                            window=window)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=2e-5,
                               rtol=2e-5)


# ------------------------------------------------ D = 80 parity with JAX
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_d80_matches_jax(dtype):
    B, S, H, Hkv, D, window = 1, 70, 8, 2, 80, 48
    rng = np.random.default_rng(80)
    jq, tq = _both(rng.standard_normal((B, S, H, D), np.float32), dtype)
    jk, tk = _both(rng.standard_normal((B, S, Hkv, D), np.float32), dtype)
    jv, tv = _both(rng.standard_normal((B, S, Hkv, D), np.float32), dtype)
    out = flash_attention(tq, tk, tv, True, window)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (B, S, H, D)
    kern = jax_flash(jq, jk, jv, True, window, None, 32, 32, True)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    ref = jax_attention_ref(jq, jk, jv, q_positions=pos, k_positions=pos,
                            causal=True, window=window)
    np.testing.assert_allclose(_f32(out), _f32(kern), **_tol(dtype))
    np.testing.assert_allclose(_f32(out), _f32(ref), **_tol(dtype))


def _ring(q_pos, C):
    """k_pos of a ring cache of C slots after positions 0..q_pos."""
    rows = []
    for qp in q_pos:
        rows.append([s if s <= qp else EMPTY for s in range(C)] if qp < C
                    else [qp - ((qp - s) % C) for s in range(C)])
    return np.asarray(rows, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_d80_matches_jax(dtype):
    """K3 at D = 80 over a ring of 40 slots with window 24: rows before,
    at and past the ring's length."""
    B, H, Hkv, D, C, window = 3, 8, 2, 80, 40, 24
    rng = np.random.default_rng(81)
    jq, tq = _both(rng.standard_normal((B, H, D), np.float32), dtype)
    jk, tk = _both(rng.standard_normal((B, C, Hkv, D), np.float32), dtype)
    jv, tv = _both(rng.standard_normal((B, C, Hkv, D), np.float32), dtype)
    q_pos = np.array([17, 39, 61], np.int32)
    k_pos = _ring(q_pos, C)
    out = decode_attention(tq, tk, tv, torch.from_numpy(q_pos),
                           torch.from_numpy(k_pos), window=window)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (B, H, D)
    j = (jnp.asarray(q_pos), jnp.asarray(k_pos))
    kern = jax_decode(jq, jk, jv, *j, window=window, block_c=8,
                      interpret=True)
    ref = jax_decode_ref(jq, jk, jv, *j, window=window)
    np.testing.assert_allclose(_f32(out), _f32(kern), **_tol(dtype))
    np.testing.assert_allclose(_f32(out), _f32(ref), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_d80_matches_jax(dtype):
    """K2 at D = 80 over pages of 8 (40 slots a row), window 24, lengths
    short of, at and past the window."""
    B, H, Hkv, D, page, maxp, window = 3, 8, 2, 80, 8, 5, 24
    P = B * maxp + 1
    rng = np.random.default_rng(82)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    bt = (rng.permutation(np.arange(1, P))[:B * maxp]
          .reshape(B, maxp).astype(np.int32))
    lens = np.array([11, 24, 40], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kp, vp))
    ints = [torch.from_numpy(a) for a in (bt, lens)]
    out = paged_decode_attention(tq, tk, tv, *ints, window=window)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (B, H, D)
    j = (jnp.asarray(bt), jnp.asarray(lens))
    kern = jax_paged(jq, jk, jv, *j, window=window, interpret=True)
    ref = jax_paged_ref(jq, jk, jv, *j, window=window)
    np.testing.assert_allclose(_f32(out), _f32(kern), **_tol(dtype))
    np.testing.assert_allclose(_f32(out), _f32(ref), **_tol(dtype))
