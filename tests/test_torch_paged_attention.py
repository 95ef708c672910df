"""Parity of the port's paged decode attention with the JAX package on the
CPU.

On a CPU tensor ``repro_torch...paged_decode_attention`` runs its plain
PyTorch version; the same numpy inputs go through the JAX Pallas kernel
in interpret mode (as ``tests/test_paged_attention.py`` runs it) and
through the JAX oracle.  Tolerance is ``_tol``: 2e-5 for float32, 5e-2 for
bfloat16.  The CUDA kernel itself is held to the plain version on the card
by ``chip_smoke.py``, on these cases and at the serving shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import \
    paged_decode_attention as jax_paged
from repro.kernels.paged_attention.ref import \
    paged_decode_attention_ref as jax_paged_ref
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_decode_attention_ref)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
EMPTY = -(2 ** 30)


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pool(B, H, Hkv, D, page, maxp, seed=0, shuffle=True):
    """numpy pool + shuffled block tables + ragged lengths (the layout of
    ``tests/test_paged_attention.py::_pool``)."""
    P = B * maxp + 1
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    ids = rng.permutation(np.arange(1, P)) if shuffle else np.arange(1, P)
    bt = ids[:B * maxp].reshape(B, maxp).astype(np.int32)
    lens = rng.integers(1, maxp * page + 1, B).astype(np.int32)
    return q, kp, vp, bt, lens


def _torch(*arrays, dtype="float32"):
    tdt = DTYPES[dtype][1]
    return [torch.from_numpy(a).to(tdt) if a.dtype == np.float32
            else torch.from_numpy(a) for a in arrays]


def _jax(*arrays, dtype="float32"):
    jdt = DTYPES[dtype][0]
    return [jnp.asarray(a, jdt) if a.dtype == np.float32 else jnp.asarray(a)
            for a in arrays]


@pytest.mark.parametrize("B,H,Hkv,D,page,maxp", [
    (1, 2, 2, 8, 4, 2),
    (2, 4, 2, 16, 8, 4),
    (2, 8, 1, 64, 16, 3),        # MQA
    (3, 6, 3, 20, 8, 5),         # odd head dim (the TPU wrapper padded it)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 7])
def test_paged_attention_matches_jax(B, H, Hkv, D, page, maxp, dtype,
                                     window):
    arrays = _pool(B, H, Hkv, D, page, maxp, seed=B * D + page)
    out = paged_decode_attention(*_torch(*arrays, dtype=dtype),
                                 window=window)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (B, H, D)
    j = _jax(*arrays, dtype=dtype)
    kern = jax_paged(*j, window=window, interpret=True)
    ref = jax_paged_ref(*j, window=window)
    np.testing.assert_allclose(_f32(out), _f32(kern), **_tol(dtype))
    np.testing.assert_allclose(_f32(out), _f32(ref), **_tol(dtype))


def test_page_permutation_invariance():
    """Physical placement is irrelevant: permute the pool, remap the
    tables, outputs must match."""
    q, kp, vp, bt, lens = _pool(2, 4, 2, 16, 8, 3, seed=9, shuffle=False)
    base = paged_decode_attention(*_torch(q, kp, vp, bt, lens))
    rng = np.random.default_rng(1)
    perm = np.concatenate([[0], 1 + rng.permutation(kp.shape[0] - 1)])
    inv = np.argsort(perm)              # page p moves to slot perm[p]
    moved = paged_decode_attention(
        *_torch(q, kp[inv], vp[inv], perm[bt].astype(np.int32), lens))
    np.testing.assert_allclose(moved.numpy(), base.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_garbage_pages_never_leak():
    """The null page and every slot past each sequence's length hold huge
    garbage; outputs match the JAX oracle on the clean pool."""
    B, page, maxp = 2, 8, 3
    q, kp, vp, bt, lens = _pool(B, 4, 2, 16, page, maxp, seed=4)
    lens = np.array([3, page * maxp], np.int32)          # tiny + full
    ref = jax_paged_ref(*_jax(q, kp, vp, bt, lens))
    kp, vp = kp.copy(), vp.copy()
    kp[0], vp[0] = 1e6, -1e6
    slot = np.arange(maxp * page).reshape(maxp, page)
    for b in range(B):
        dead = slot >= lens[b]
        for ip in range(maxp):
            kp[bt[b, ip]][dead[ip]] = 1e6
            vp[bt[b, ip]][dead[ip]] = -1e6
    out = paged_decode_attention(*_torch(q, kp, vp, bt, lens))
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), _f32(ref), atol=2e-5, rtol=2e-5)


def test_absurd_table_ids_are_clamped():
    """len=1 and 2 attend to one page; the entries past it are absurd ids,
    clamped into the pool as the JAX wrapper clamps them, and masked."""
    q, kp, vp, bt, lens = _pool(2, 2, 2, 8, 4, 3, seed=7)
    lens = np.array([1, 2], np.int32)
    bt = bt.copy()
    bt[:, 1:] = 10 ** 6
    out = paged_decode_attention(*_torch(q, kp, vp, bt, lens))
    kern = jax_paged(*_jax(q, kp, vp, bt, lens), interpret=True)
    ref = jax_paged_ref(*_jax(q, kp, vp, np.clip(bt, 0, kp.shape[0] - 1),
                              lens))
    np.testing.assert_allclose(out.numpy(), _f32(kern), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), _f32(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_paged_matches_dense_decode_ref(window):
    """Densify the paged cache: the port's dense decode oracle agrees."""
    B, H, Hkv, D, page, maxp = 3, 4, 2, 16, 4, 4
    q, kp, vp, bt, lens = _torch(*_pool(B, H, Hkv, D, page, maxp, seed=2))
    C = page * maxp
    kd = kp[bt.long()].reshape(B, C, Hkv, D)
    vd = vp[bt.long()].reshape(B, C, Hkv, D)
    slot = torch.arange(C, dtype=torch.int32).expand(B, C)
    k_pos = torch.where(slot < lens[:, None], slot,
                        torch.full_like(slot, EMPTY))
    dense = decode_attention_ref(q, kd, vd, lens - 1, k_pos, window=window)
    paged = paged_decode_attention(q, kp, vp, bt, lens, window=window)
    np.testing.assert_allclose(paged.numpy(), dense.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_empty_row_gives_zero():
    """A row with nothing to attend to (length 0) outputs 0, as the
    reference does."""
    q, kp, vp, bt, lens = _pool(2, 4, 2, 16, 4, 2, seed=3)
    lens = np.array([0, 5], np.int32)
    out = paged_decode_attention(*_torch(q, kp, vp, bt, lens))
    ref = jax_paged_ref(*_jax(q, kp, vp, bt, lens))
    assert not out[0].any()
    np.testing.assert_allclose(out.numpy(), _f32(ref), atol=2e-5, rtol=2e-5)


def test_wrapper_runs_the_plain_version_on_cpu_only():
    """A CPU tensor takes the plain path and is not counted as a launch.
    A meta tensor (the meta-device dry-run) takes it too, which there
    gives only the output's shape and dtype; no launch is counted."""
    q, kp, vp, bt, lens = _torch(*_pool(2, 4, 2, 8, 4, 2, seed=5))
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, kp, vp, bt, lens)
    assert paged_decode_attention.launches == before
    want = paged_decode_attention_ref(q, kp, vp, bt, lens)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    meta = [t.to("meta") for t in (q, kp, vp, bt, lens)]
    got = paged_decode_attention(*meta)
    assert got.is_meta and got.shape == out.shape and got.dtype == out.dtype
    assert paged_decode_attention.launches == before
