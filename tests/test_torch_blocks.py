"""Parity of ``repro_torch.models.blocks`` with ``repro.models.blocks``.

The same numpy inputs (from a seed) go through both packages in float32
and bfloat16; tolerance is ``_tol`` (2e-5 / 5e-2, as tests/test_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as jb
from repro_torch.models import blocks as tb

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _both(a: np.ndarray, dtype: str = "float32"):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a)).to(tdt)


def _close(t: torch.Tensor, j, dtype: str):
    assert t.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **_tol(dtype))


def _params(rng, shapes, dtype):
    out_j, out_t = {}, {}
    for name, shape in shapes.items():
        out_j[name], out_t[name] = _both(
            (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
                np.float32), dtype)
    return out_j, out_t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _both(rng.standard_normal((2, 5, 48)).astype(np.float32), dtype)
    js, ts = _both(rng.standard_normal(48).astype(np.float32), dtype)
    _close(tb.rms_norm(tx, ts, 1e-5), jb.rms_norm(jx, js, 1e-5), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_half_split(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.standard_normal((2, 7, 3, 12)).astype(np.float32), dtype)
    pos = np.array([np.arange(7), np.arange(100, 107)], np.int32)
    _close(tb.apply_rope(tx, torch.from_numpy(pos), 1e4),
           jb.apply_rope(jx, jnp.asarray(pos), 1e4), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_project_with_bias_and_out_project(dtype):
    rng = np.random.default_rng(2)
    d, H, Hkv, D = 48, 4, 2, 12
    jp, tp = _params(rng, {"wq": (d, H * D), "wk": (d, Hkv * D),
                           "wv": (d, Hkv * D), "wo": (H * D, d),
                           "bq": (H * D,), "bk": (Hkv * D,),
                           "bv": (Hkv * D,)}, dtype)
    jx, tx = _both(rng.standard_normal((2, 5, d)).astype(np.float32), dtype)
    for t, j in zip(tb.qkv_project(tx, tp, H, Hkv, D),
                    jb.qkv_project(jx, jp, H, Hkv, D)):
        assert t.shape == j.shape
        _close(t, j, dtype)
    jo, to = _both(rng.standard_normal((2, 5, H, D)).astype(np.float32), dtype)
    _close(tb.out_project(to, tp), jb.out_project(jo, jp), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu(dtype):
    rng = np.random.default_rng(3)
    jp, tp = _params(rng, {"w_gate": (48, 128), "w_up": (48, 128),
                           "w_down": (128, 48)}, dtype)
    jx, tx = _both(rng.standard_normal((2, 5, 48)).astype(np.float32), dtype)
    _close(tb.swiglu(tx, tp), jb.swiglu(jx, jp), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
def test_attention_prompt_chunked(dtype, window):
    """Sq > 1 through the chunk loops (chunks smaller than S, padded)."""
    rng = np.random.default_rng(4)
    B, S, H, Hkv, D = 2, 19, 4, 2, 12
    jq, tq = _both(rng.standard_normal((B, S, H, D)).astype(np.float32), dtype)
    jk, tk = _both(rng.standard_normal((B, S, Hkv, D)).astype(np.float32), dtype)
    jv, tv = _both(rng.standard_normal((B, S, Hkv, D)).astype(np.float32), dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    kw = dict(causal=True, window=window, q_chunk=8, kv_chunk=6)
    out = tb.attention(tq, tk, tv, q_positions=torch.from_numpy(pos.copy()),
                       k_positions=torch.from_numpy(pos.copy()), **kw)
    ref = jb.attention(jq, jk, jv, q_positions=jnp.asarray(pos),
                       k_positions=jnp.asarray(pos), **kw)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 6])
def test_attention_single_token_ragged(dtype, window):
    """Sq == 1 over a cache whose rows hold different numbers of tokens
    (empty slots at -2^30 carry poison values)."""
    rng = np.random.default_rng(5)
    B, C, H, Hkv, D = 3, 16, 4, 2, 12
    lens = np.array([1, 9, 16])
    k = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    dead = np.arange(C)[None] >= lens[:, None]
    k[dead], v[dead] = 1e4, -1e4
    k_pos = np.where(dead, -(2 ** 30), np.arange(C)[None]).astype(np.int32)
    q_pos = (lens - 1).astype(np.int32)[:, None]
    jq, tq = _both(rng.standard_normal((B, 1, H, D)).astype(np.float32), dtype)
    jk, tk = _both(k, dtype)
    jv, tv = _both(v, dtype)
    out = tb.attention(tq, tk, tv, q_positions=torch.from_numpy(q_pos),
                       k_positions=torch.from_numpy(k_pos), window=window)
    ref = jb.attention(jq, jk, jv, q_positions=jnp.asarray(q_pos),
                       k_positions=jnp.asarray(k_pos), window=window)
    _close(out, ref, dtype)
