"""K4's float32 tensor-core kernel (``csrc/mlstm_scan_tf32x3.cu``) on the
CPU: a plain PyTorch model of its arithmetic against the JAX package, and
why it takes three TF32 products.

``mlstm_two_pass_ref(..., tf32=True)`` is the kernel's arithmetic, pass by
pass, with its products as the tensor cores take float32 operands: each
operand split as ``x = hi + lo``, ``hi = to_tf32(x)`` (round to 10 mantissa
bits, ties away from zero, by bit mask as ``cvt.rna.tf32.f32``) and
``lo = x - hi``, which ``mma.sync`` truncates to TF32; each product
``lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b)`` in q k^T, P v, q C and the C
update, and 1 / sqrt(D) applied to the products' results.
The same numpy inputs, made from a seed, go through it, through the JAX
Pallas scan in interpret mode and through ``repro.models.xlstm
.mlstm_chunkwise``, at the sweep of ``tests/test_torch_ssm_two_pass.py``;
the final carry is held to the reference prefill's chunk scan.  Tolerance:
1e-4, the reference's own for float32.  On one long row (4096 steps at
D = 512, the xlstm-1.3b head) the three products hold 1e-4 against a
float64 chunkwise form and one TF32 product does not.  The CUDA kernel
itself is held to the plain version on the card by ``chip_smoke.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import mlstm_scan as jax_mlstm_scan
from repro.models import xlstm as jx
from repro_torch.kernels.ssm_scan.ref import (mlstm_two_pass_ref,
                                              tf32_product, to_tf32)

TOL = dict(atol=1e-4, rtol=1e-4)
# (B, S, H, D, chunk, dv), as tests/test_torch_ssm_two_pass.py: dv = D,
# dv dividing D, dv not dividing D, S not a chunk multiple
CASES = [(1, 16, 1, 8, 8, 8), (2, 50, 2, 16, 16, 8),
         (1, 64, 2, 32, 32, 12), (2, 37, 1, 16, 16, 5)]


def _inputs(B, S, H, D, seed):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    ig = r.standard_normal((B, S, H)).astype(np.float32)
    fg = r.standard_normal((B, S, H)).astype(np.float32) + 2.0
    return q, k, v, ig, fg


def _flat(x, B, H):
    return np.moveaxis(x, 2, 1).reshape(B * H, x.shape[1], *x.shape[3:])


def _chunkwise_f64(q, k, v, ig, fg, T=64):
    """The stabilised chunkwise form of ``repro.models.xlstm.mlstm_chunk``
    in float64 on the flat layout, S a chunk multiple."""
    BH, S, D = q.shape
    q, k, v, ig, fg = (x.double() for x in (q, k, v, ig, fg))
    q = q / math.sqrt(D)
    C = torch.zeros(BH, D, D, dtype=torch.float64)
    n = torch.zeros(BH, D, dtype=torch.float64)
    m = torch.zeros(BH, dtype=torch.float64)
    tri = torch.ones(T, T, dtype=torch.bool).tril()
    hs = []
    for c0 in range(0, S, T):
        sl = slice(c0, c0 + T)
        f = fg[:, sl]
        b = torch.cumsum(torch.clamp(f, max=0) - torch.log1p(torch.exp(
            -f.abs())), dim=-1)
        g = ig[:, sl]
        dmat = b[:, :, None] - b[:, None, :] + g[:, None, :]
        dmat = torch.where(tri, dmat, torch.full_like(dmat, -1e30))
        alpha = m[:, None] + b
        m_t = torch.maximum(alpha, dmat.amax(-1))
        w = torch.exp(dmat - m_t[:, :, None])
        inter = torch.exp(alpha - m_t)
        num = ((q[:, sl] @ k[:, sl].transpose(1, 2)) * w) @ v[:, sl] \
            + inter[:, :, None] * (q[:, sl] @ C)
        n_t = w @ k[:, sl] + inter[:, :, None] * n[:, None, :]
        den = torch.maximum((q[:, sl] * n_t).sum(-1).abs(), torch.exp(-m_t))
        hs.append(num / den[:, :, None])
        b_end = b[:, -1]
        m_new = torch.maximum(m + b_end, (b_end[:, None] - b + g).amax(-1))
        sc = torch.exp(m + b_end - m_new)
        kw = k[:, sl] * torch.exp(b_end[:, None] - b + g
                                  - m_new[:, None])[:, :, None]
        C = sc[:, None, None] * C + kw.transpose(1, 2) @ v[:, sl]
        n = sc[:, None] * n + kw.sum(1)
        m = m_new
    return torch.cat(hs, dim=1)


def test_tf32_rounding_and_split():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 3.0e-3, 0.0])
    # ties (half a unit of the 10th bit) go away from zero
    assert to_tf32(x).tolist()[:5] == [1.0, 1.0 + 2 ** -10,
                                       1.0 + 2 ** -10, 1.0 + 2 ** -9,
                                       -(1.0 + 2 ** -10)]
    assert (to_tf32(x).view(torch.int32) & 0x1FFF).eq(0).all()
    # mma.sync reads a .tf32 operand's top 19 bits: truncation
    assert to_tf32(x, False).tolist()[:5] == [1.0, 1.0, 1.0 + 2 ** -10,
                                              1.0 + 2 ** -10, -1.0]
    one_less = torch.tensor([1 - 2 ** -13])
    assert to_tf32(one_less, False).item() == 1 - 2 ** -11
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(64, 512, generator=gen)
    b = torch.randn(512, 64, generator=gen)
    want = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs()).max()
    three = float((tf32_product(a, b).double() - want).abs().max() / scale)
    one = float((tf32_product(a, b, 1).double() - want).abs().max() / scale)
    # three products carry float32's accuracy, one TF32 product 2^-11
    assert three < 2 ** -20 and one > 2 ** -14, (three, one)


@pytest.mark.parametrize("B,S,H,D,chunk,dv", CASES)
def test_tf32x3_two_pass_matches_jax(B, S, H, D, chunk, dv):
    q, k, v, ig, fg = _inputs(B, S, H, D, 7 * S + D + dv)
    kernel = np.asarray(jax_mlstm_scan(
        *(jnp.asarray(x) for x in (q, k, v, ig, fg)), chunk=chunk,
        interpret=True))
    chunkwise = np.asarray(jx.mlstm_chunkwise(
        *(jnp.asarray(x) for x in (q, k, v, ig, fg)), chunk))
    got = mlstm_two_pass_ref(
        *(torch.from_numpy(_flat(x, B, H)) for x in (q, k, v, ig, fg)),
        chunk, dv, tf32=True)
    assert got.dtype == torch.float32 and got.shape == (B * H, S, D)
    got = np.moveaxis(got.numpy().reshape(B, H, S, D), 1, 2)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got, chunkwise, **TOL)


@pytest.mark.parametrize("S,dv", [(33, 16), (70, 6)])
def test_tf32x3_final_state_matches_prefill(S, dv):
    """The carry after the last chunk equals the reference prefill's: its
    per-(batch, head) chunk scan from zeros, on the same values."""
    B, H, D = 2, 2, 16
    flat = [_flat(x, B, H) for x in _inputs(B, S, H, D, 11 + S)]
    zero = (jnp.zeros((D, D)), jnp.zeros((D,)), jnp.float32(0.0))

    def per_row(qs, ks, vs, igs, fgs):
        pad = (-S) % jx.CHUNK
        qs, ks, vs = (jnp.pad(x, ((0, pad), (0, 0))) for x in (qs, ks, vs))
        igs = jnp.pad(igs, ((0, pad),), constant_values=jx.NEG)
        fgs = jnp.pad(fgs, ((0, pad),), constant_values=1e4)
        n = (S + pad) // jx.CHUNK
        carry, _ = jax.lax.scan(
            lambda c, xs: jx.mlstm_chunk(*xs, c), zero,
            (qs.reshape(n, jx.CHUNK, D), ks.reshape(n, jx.CHUNK, D),
             vs.reshape(n, jx.CHUNK, D), igs.reshape(n, jx.CHUNK),
             fgs.reshape(n, jx.CHUNK)))
        return carry

    want = jax.vmap(per_row)(*(jnp.asarray(x) for x in flat))
    _, state = mlstm_two_pass_ref(*(torch.from_numpy(x) for x in flat),
                                  jx.CHUNK, dv, return_state=True, tf32=True)
    for got, ref in zip(state, want):
        assert got.dtype == torch.float32
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_one_tf32_product_fails_the_float32_tolerance():
    """One row of xlstm-1.3b's head (D = 512) over 4096 steps: the three
    products hold 1e-4 against the float64 chunkwise form, and one TF32
    product misses it, by an error hundreds of times the split's: the
    unnormalised recurrence multiplies an operand's rounding by
    sum |P| |v| / den."""
    q, k, v, ig, fg = (torch.from_numpy(x[:, :, 0]) for x in
                       _inputs(1, 4096, 1, 512, 0))
    want = _chunkwise_f64(q, k, v, ig, fg)
    err = {}
    for terms in (2, 1):
        got = mlstm_two_pass_ref(q, k, v, ig, fg, 64, 64, terms=terms,
                                 tf32=True).double()
        err[terms] = float((got - want).abs().max())
        close = torch.allclose(got, want, **TOL)
        assert close == (terms == 2), (terms, err)
    assert err[1] > 100 * err[2], err


def test_tf32_takes_float32_only():
    x = torch.zeros(1, 8, 8, dtype=torch.bfloat16)
    gates = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="float32"):
        mlstm_two_pass_ref(x, x, x, gates, gates, 8, 8, tf32=True)
