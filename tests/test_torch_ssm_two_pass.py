"""The two-pass mLSTM scan (K4's tensor-core kernel) on the CPU: its
intra-chunk pass and its carry pass over value-column blocks, against the
JAX package; and the choice of kernel.

``mlstm_two_pass_ref`` is the arithmetic of ``csrc/mlstm_scan_sm90.cu`` in
plain PyTorch, with the kernel's bfloat16 operand roundings (P, the copy
of C in ``q C`` and ``v o w_end``, each as two bf16 terms).  The same numpy inputs, made from a
seed, go through it, through the JAX Pallas scan in interpret mode (as
``tests/test_torch_ssm_scan.py`` runs it) and through
``repro.models.xlstm.mlstm_chunkwise``; the final carry is held to the
reference prefill's chunk scan.  Tolerance: 1e-4 in float32 (the
reference's own), 5e-2 in bfloat16, and never a NaN.  The CUDA kernel
itself is held to the plain version on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import mlstm_scan as jax_mlstm_scan
from repro.models import xlstm as jx
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import (mlstm_chunkwise_ref,
                                              mlstm_two_pass_ref)

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# (B, S, H, D, chunk, dv): dv = D, dv dividing D, dv not dividing D, S
# not a chunk multiple (pad steps must leave the carry unchanged)
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


@pytest.mark.parametrize("B,S,H,D,chunk,dv", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_pass_matches_jax(B, S, H, D, chunk, dv, dtype):
    q, k, v, ig, fg = _inputs(B, S, H, D, 5 * S + D + dv)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    kernel = np.asarray(jax_mlstm_scan(jq, jk, jv, jnp.asarray(ig),
                                       jnp.asarray(fg), chunk=chunk,
                                       interpret=True), np.float32)
    f32 = [np.asarray(x, np.float32) for x in (jq, jk, jv)]
    chunkwise = np.asarray(jx.mlstm_chunkwise(
        *(jnp.asarray(x) for x in f32 + [ig, fg]), chunk))
    tdt = getattr(torch, dtype)
    got = mlstm_two_pass_ref(
        *(torch.from_numpy(_flat(x, B, H)).to(tdt) for x in (q, k, v)),
        *(torch.from_numpy(_flat(x, B, H)) for x in (ig, fg)), chunk, dv)
    assert got.dtype == tdt and got.shape == (B * H, S, D)
    got = np.moveaxis(got.float().numpy().reshape(B, H, S, D), 1, 2)
    assert np.isfinite(got).all()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, kernel, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, chunkwise, atol=tol, rtol=tol)


@pytest.mark.parametrize("S,dv", [(33, 16), (70, 6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_pass_final_state_matches_prefill(S, dv, dtype):
    """The carry after the last chunk equals the reference prefill's: its
    per-(batch, head) chunk scan from zeros, on the same values."""
    B, H, D = 2, 2, 16
    q, k, v, ig, fg = _inputs(B, S, H, D, 9 + S)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(_flat(x, B, H)).to(tdt)
                  for x in (q, k, v))
    flat = [jnp.asarray(t.float().numpy()) for t in (tq, tk, tv)]
    flat += [jnp.asarray(_flat(x, B, H)) for x in (ig, fg)]
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

    want = jax.vmap(per_row)(*flat)
    _, state = mlstm_two_pass_ref(
        tq, tk, tv, *(torch.from_numpy(_flat(x, B, H)) for x in (ig, fg)),
        jx.CHUNK, dv, return_state=True)
    tol = TOL[dtype]
    for got, ref in zip(state, want):
        assert got.dtype == torch.float32
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol,
                                   rtol=tol)


def test_two_terms_hold_where_one_drifts():
    """Why the kernel gives P, C and v o w_end to the tensor cores as two
    bf16 terms: over 4096 steps at D = 512 (the long shape of one row) the
    two-term model holds the fp32 plain version at 5e-2, and one term
    errs far more (the unnormalised recurrence multiplies an operand's
    rounding by sum |P| |v| / den)."""
    r = np.random.default_rng(0)
    BH, S, D = 2, 4096, 512
    q, k, v = (torch.from_numpy(r.standard_normal((BH, S, D)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    ig = torch.from_numpy(r.standard_normal((BH, S)).astype(np.float32))
    fg = torch.from_numpy(r.standard_normal((BH, S)).astype(np.float32)) + 2
    want = mlstm_chunkwise_ref(q, k, v, ig, fg, 64).float()
    err = {}
    for terms in (1, 2):
        got = mlstm_two_pass_ref(q, k, v, ig, fg, 64, 64, terms=terms)
        err[terms] = float((got.float() - want).abs().mean())
        if terms == 2:
            torch.testing.assert_close(got.float(), want, atol=5e-2,
                                       rtol=5e-2)
    assert err[1] > 5 * err[2], err


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 512, "mma"), (torch.bfloat16, 256, "mma"),
    (torch.bfloat16, 128, "mma"), (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 32, "simt"), (torch.bfloat16, 96, "simt"),
    (torch.bfloat16, 500, "simt"), (torch.float32, 512, "tf32x3"),
    (torch.float32, 64, "tf32x3"), (torch.float32, 256, "tf32x3"),
    (torch.float32, 128, "tf32x3"), (torch.float32, 32, "simt"),
    (torch.float32, 96, "simt"), (torch.float16, 512, "simt"),
])
def test_variant(dtype, D, want):
    """At the D the tensor-core kernels are built for, bf16 takes "mma" and
    float32 "tf32x3" (three TF32 products: one misses float32's 1e-4,
    tests/test_torch_ssm_tf32x3.py); every other D and dtype keeps the
    CUDA-core kernel."""
    assert ops._variant(dtype, D) == want
    assert want == "simt" or D in ops.MMA_D
    assert set(ops.mlstm_scan.launches_by_variant) == {"simt", "mma",
                                                        "tf32x3"}
