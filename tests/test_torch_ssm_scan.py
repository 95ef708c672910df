"""Parity of the port's mLSTM scan (``kernels/ssm_scan``) with the JAX
package, on the CPU.

Inputs come from a numpy seed.  ``mlstm_scan`` (which on a CPU tensor runs
``mlstm_chunkwise_ref``) and the strict recurrence ``mlstm_scan_ref`` are
held to the JAX Pallas kernel in interpret mode and to its oracle at the
sweep of ``tests/test_kernels.py::test_mlstm_scan_sweep`` (1e-4 in
float32, 5e-2 in bfloat16, the reference's own tolerances); the final
carry is held to the cache of ``repro.models.xlstm.prefill``; and the
autograd gradient (the backward recomputes the chunkwise form) to
``jax.grad`` of ``repro.models.xlstm.mlstm_chunkwise``, through which the
reference trains.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import mlstm_scan as jax_mlstm_scan
from repro.kernels.ssm_scan.ref import mlstm_scan_ref as jax_scan_ref
from repro.models import xlstm as jx
from repro_torch.kernels.ssm_scan.ops import mlstm_scan
from repro_torch.kernels.ssm_scan.ref import (mlstm_chunkwise_ref,
                                              mlstm_scan_ref)

SWEEP = [(1, 16, 1, 8, 8), (2, 50, 4, 16, 16), (1, 64, 2, 32, 32)]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(B, S, H, D, seed):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    ig = r.standard_normal((B, S, H)).astype(np.float32)
    fg = r.standard_normal((B, S, H)).astype(np.float32) + 2.0
    return q, k, v, ig, fg


def _flat(x, B, H):
    return np.moveaxis(x, 2, 1).reshape(B * H, x.shape[1], *x.shape[3:])


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("B,S,H,D,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_matches_jax_kernel_and_oracle(B, S, H, D, chunk, dtype):
    q, k, v, ig, fg = _inputs(B, S, H, D, S + D)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    want = np.asarray(jax_mlstm_scan(jq, jk, jv, jnp.asarray(ig),
                                     jnp.asarray(fg), chunk=chunk,
                                     interpret=True), np.float32)
    tq, tk, tv = (_to_torch(x, dtype) for x in (q, k, v))
    got = mlstm_scan(tq, tk, tv, torch.from_numpy(ig), torch.from_numpy(fg),
                     chunk=chunk)
    assert got.dtype == tq.dtype and got.shape == (B, S, H, D)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    # the strict recurrence, both sides, in float32 on the same values
    f32 = [np.asarray(x, np.float32) for x in (jq, jk, jv)]
    oracle = np.asarray(jax_scan_ref(*(jnp.asarray(_flat(x, B, H)) for x in
                                       f32 + [ig, fg])))
    ours = mlstm_scan_ref(*(torch.tensor(_flat(x, B, H)) for x in
                            f32 + [ig, fg])).numpy()
    np.testing.assert_allclose(ours, oracle, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        np.moveaxis(ours.reshape(B, H, S, D), 1, 2), got.float().numpy(),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("S", [33, 70])
def test_final_state_matches_prefill_cache(S):
    """The carry that ``return_state`` gives equals what the reference's
    ``prefill`` carries: its per-(batch, head) chunk scan from zeros."""
    B, H, D = 2, 2, 16
    q, k, v, ig, fg = _inputs(B, S, H, D, 7)
    # the reference prefill's scan body, run on these projections
    flat = [jnp.asarray(_flat(x, B, H)) for x in (q, k, v, ig, fg)]
    zero = (jnp.zeros((D, D)), jnp.zeros((D,)), jnp.float32(0.0))

    def per_row(qs, ks, vs, igs, fgs):
        pad = (-S) % jx.CHUNK
        qs, ks, vs = (jnp.pad(x, ((0, pad), (0, 0))) for x in (qs, ks, vs))
        igs = jnp.pad(igs, ((0, pad),), constant_values=jx.NEG)
        fgs = jnp.pad(fgs, ((0, pad),), constant_values=1e4)
        n = (S + pad) // jx.CHUNK
        carry, hs = jax.lax.scan(
            lambda c, xs: jx.mlstm_chunk(*xs, c), zero,
            (qs.reshape(n, jx.CHUNK, D), ks.reshape(n, jx.CHUNK, D),
             vs.reshape(n, jx.CHUNK, D), igs.reshape(n, jx.CHUNK),
             fgs.reshape(n, jx.CHUNK)))
        return carry, hs.reshape(-1, D)[:S]

    (C, n, m), h = jax.vmap(per_row)(*flat)
    got_h, (tC, tn, tm) = mlstm_scan(
        *(torch.from_numpy(x) for x in (q, k, v, ig, fg)), chunk=jx.CHUNK,
        return_state=True)
    assert tC.shape == (B, H, D, D) and tn.shape == (B, H, D)
    assert tm.shape == (B, H)
    for a, b in ((tC, C), (tn, n), (tm, m)):
        np.testing.assert_allclose(a.reshape(np.shape(b)).numpy(),
                                   np.asarray(b), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        np.moveaxis(got_h.numpy(), 2, 1).reshape(B * H, S, D),
        np.asarray(h), atol=1e-4, rtol=1e-4)
    # the flat plain version gives the same carry
    _, (fC, fn, fm) = mlstm_chunkwise_ref(
        *(torch.tensor(np.asarray(x)) for x in flat), jx.CHUNK,
        return_state=True)
    torch.testing.assert_close(fC, tC.reshape(B * H, D, D))
    torch.testing.assert_close(fm, tm.reshape(B * H))


@pytest.mark.parametrize("B,S,H,D,chunk", SWEEP)
def test_gradient_matches_jax_chunkwise(B, S, H, D, chunk):
    q, k, v, ig, fg = _inputs(B, S, H, D, 3 * S + D)
    w = np.random.default_rng(1).standard_normal((B, S, H, D)).astype(
        np.float32)

    def loss(q, k, v, ig, fg):
        return jnp.sum(jx.mlstm_chunkwise(q, k, v, ig, fg, chunk) * w)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(x) for x in (q, k, v, ig, fg)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, ig, fg)]
    (mlstm_scan(*xs, chunk=chunk) * torch.from_numpy(w)).sum().backward()
    for x, g in zip(xs, want):
        g = np.asarray(g)
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max())


def test_return_state_refuses_gradients():
    q = torch.zeros((1, 4, 1, 8), requires_grad=True)
    g = torch.zeros((1, 4, 1))
    with pytest.raises(ValueError, match="no gradient"):
        mlstm_scan(q, q, q, g, g, return_state=True)
