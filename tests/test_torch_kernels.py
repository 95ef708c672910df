"""Parity of the port's attention kernels with the JAX package on the CPU.

On a CPU tensor each wrapper of ``repro_torch.kernels`` runs its plain
PyTorch version; the same numpy inputs go through the JAX Pallas kernels in
interpret mode (as ``tests/test_kernels.py`` runs them) and through the
JAX ``ref.py`` oracles.  Tolerance is ``_tol``: 2e-5 for float32, 5e-2 for
bfloat16.  The CUDA kernels themselves are held to the plain versions on
the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D", [
    (2, 33, 65, 4, 4, 24),       # padding shapes (Sq != Sk, D not 2^k)
    (2, 40, 40, 4, 2, 16),       # GQA
    (1, 24, 24, 4, 1, 8),        # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 9),
                                           (False, None)])
def test_flash_attention_matches_jax(B, Sq, Sk, H, Hkv, D, dtype, causal,
                                     window):
    rng = np.random.default_rng(B * Sq + D)
    jq, tq = _both(rng.standard_normal((B, Sq, H, D), np.float32), dtype)
    jk, tk = _both(rng.standard_normal((B, Sk, Hkv, D), np.float32), dtype)
    jv, tv = _both(rng.standard_normal((B, Sk, Hkv, D), np.float32), dtype)
    out = flash_attention(tq, tk, tv, causal, window)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (B, Sq, H, D)
    kern = jax_flash(jq, jk, jv, causal, window, None, 32, 32, True)
    qp = jnp.broadcast_to(jnp.arange(Sq), (B, Sq))
    kp = jnp.broadcast_to(jnp.arange(Sk), (B, Sk))
    ref = jax_attention_ref(jq, jk, jv, q_positions=qp, k_positions=kp,
                            causal=causal, window=window)
    np.testing.assert_allclose(_f32(out), _f32(kern), **_tol(dtype))
    np.testing.assert_allclose(_f32(out), _f32(ref), **_tol(dtype))


@pytest.mark.parametrize("B,H,Hkv,D,C", [
    (2, 4, 2, 16, 24),
    (2, 8, 1, 64, 40),           # MQA
    (3, 6, 3, 20, 17),           # odd sizes
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 8])
def test_decode_attention_matches_jax(B, H, Hkv, D, C, dtype, window):
    rng = np.random.default_rng(B * C + H)
    jq, tq = _both(rng.standard_normal((B, H, D), np.float32), dtype)
    jk, tk = _both(rng.standard_normal((B, C, Hkv, D), np.float32), dtype)
    jv, tv = _both(rng.standard_normal((B, C, Hkv, D), np.float32), dtype)
    q_pos = (np.arange(B) * 3 + C // 2).astype(np.int32)
    k_pos = np.broadcast_to(np.arange(C), (B, C)).astype(np.int32)
    k_pos = np.where(k_pos <= q_pos[:, None], k_pos, -(2 ** 30)).astype(np.int32)
    out = decode_attention(tq, tk, tv, torch.from_numpy(q_pos),
                           torch.from_numpy(k_pos), window=window)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (B, H, D)
    kern = jax_decode(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(k_pos),
                      window=window, block_c=8, interpret=True)
    ref = jax_decode_ref(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(k_pos),
                         window=window)
    np.testing.assert_allclose(_f32(out), _f32(kern), **_tol(dtype))
    np.testing.assert_allclose(_f32(out), _f32(ref), **_tol(dtype))


def _decode_case(name: str):
    """The ragged and ring cache layouts of tests/test_kernels.py."""
    B, H, Hkv, D = 4, 4, 2, 16
    rng = np.random.default_rng(len(name))
    if name == "ragged":
        C, window = 40, 6
        lens = np.array([1, 7, 23, 40])
        slot = np.broadcast_to(np.arange(C), (B, C))
        dead = slot >= lens[:, None]
        k = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
        v = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
        # poison the dead slots: masked entries must never leak
        k[dead] = 1e6
        v[dead] = -1e6
        q_pos = (lens - 1).astype(np.int32)
        k_pos = np.where(dead, -(2 ** 30), slot).astype(np.int32)
    else:                            # SWA ring: valid slots are not a prefix
        B, C, window = 2, 16, 10
        k = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
        v = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
        k_pos = np.full((B, C), -(2 ** 30), np.int32)
        for s in range(C):
            k_pos[0, s] = 21 - 1 - ((21 - 1 - s) % C)
        k_pos[1, :5] = np.arange(5)
        q_pos = np.array([20, 4], np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    return q, k, v, q_pos, k_pos, window


@pytest.mark.parametrize("name", ["ragged", "ring"])
@pytest.mark.parametrize("window_on", [True, False])
def test_decode_attention_ragged_and_ring(name, window_on):
    q, k, v, q_pos, k_pos, window = _decode_case(name)
    window = window if window_on else None
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
    out = decode_attention(*t, window=window)
    j = [jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)]
    kern = jax_decode(*j, window=window, block_c=8, interpret=True)
    ref = jax_decode_ref(*j, window=window)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), _f32(kern), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), _f32(ref), atol=2e-5, rtol=2e-5)


def test_wrappers_run_the_plain_version_on_cpu_only():
    """A CPU tensor takes the plain path and is not counted as a launch.
    A meta tensor (the meta-device dry-run) takes it too, which there
    gives only the output's shape and dtype; no launch is counted."""
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.ssm_scan.ops import mlstm_scan
    q = torch.randn(1, 4, 2, 8)
    before = (flash_attention.launches, decode_attention.launches)
    flash_attention(q, q, q)
    decode_attention(q[:, 0], q, q, torch.tensor([3], dtype=torch.int32),
                     torch.arange(4, dtype=torch.int32)[None])
    assert (flash_attention.launches, decode_attention.launches) == before
    wrappers = (flash_attention, decode_attention, paged_decode_attention,
                mlstm_scan)
    counts = [w.launches for w in wrappers]
    meta = torch.empty(1, 4, 2, 8, device="meta")
    i32 = dict(dtype=torch.int32, device="meta")
    out = flash_attention(meta, meta, meta)
    assert out.is_meta and out.shape == meta.shape
    out = decode_attention(meta[:, 0], meta, meta, torch.empty(1, **i32),
                           torch.empty(1, 4, **i32))
    assert out.is_meta and out.shape == (1, 2, 8)
    pages = torch.empty(3, 4, 2, 8, device="meta")
    out = paged_decode_attention(meta[:, 0], pages, pages,
                                 torch.empty(1, 2, **i32),
                                 torch.empty(1, **i32))
    assert out.is_meta and out.shape == (1, 2, 8)
    x = torch.empty(1, 64, 2, 8, device="meta")
    g = torch.empty(1, 64, 2, device="meta")
    out = mlstm_scan(x, x, x, g, g)
    assert out.is_meta and out.shape == x.shape
    assert [w.launches for w in wrappers] == counts


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,window", [
    (1, 24, 24, 2, 2, 8, None),  # tests/test_kernels.py's gradient case
    (2, 40, 40, 4, 2, 16, 9),    # GQA + window
    (2, 33, 65, 4, 4, 24, None),  # Sq != Sk
])
def test_flash_attention_gradient_matches_jax(B, Sq, Sk, H, Hkv, D, window):
    """The autograd backward of ``flash_attention`` (a recompute of the
    plain attention) against ``jax.grad`` through the Pallas kernel's
    ``custom_vjp`` in interpret mode."""
    import jax
    rng = np.random.default_rng(7 + Sq)
    x = [rng.standard_normal(s).astype(np.float32) for s in
         ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]
    w = rng.standard_normal((B, Sq, H, D)).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, True, window, None, 8, 8, True) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in x))
    ts = [torch.from_numpy(a).requires_grad_() for a in x]
    (flash_attention(*ts, True, window) * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   **_tol("float32"))
