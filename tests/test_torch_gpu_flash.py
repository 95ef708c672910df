"""K1's float32 tensor-core kernel (``"tf32x3"``,
``csrc/flash_attention_fwd_tf32x3.cu``) on a card, held to its plain
version: needs an NVIDIA GPU, and skips inside each test without one.  It
imports no JAX, so it runs on a machine with a card and no JAX (the
suite's ``conftest.py`` imports JAX, hence ``--noconftest``)::

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu \\
        tests/test_torch_gpu_flash.py

D 64 / 80 / 128, groups of 1 and 6 heads, causal, windowed, non-causal
and Sq != Sk, one launch a call on ``"tf32x3"``, within the reference's
float32 tolerance (2e-5, ``tests/test_kernels.py::_tol``); rows that
attend nothing read 0; a q that is not 16-byte aligned is refused.
``chip_smoke.py::kernels_phase`` runs the same kernel over a wider sweep.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_ref)

CASES = [((2, 100, 100, 12, 2), (True, None)),     # G 6: 600 rows
         ((2, 100, 100, 12, 2), (True, 9)),
         ((2, 33, 65, 12, 2), (False, None)),      # Sq != Sk, non-causal
         ((1, 70, 70, 4, 4), (True, 20)),          # G 1
         ((2, 96, 32, 8, 2), (True, 16))]          # rows >= 47 attend none


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("shape,mask", CASES)
def test_tf32x3_on_the_card(shape, mask, D):
    _need_gpu()
    B, Sq, Sk, H, Hkv = shape
    causal, window = mask
    gen = torch.Generator(device="cuda").manual_seed(Sq * D + H)
    q = torch.randn(B, Sq, H, D, generator=gen, device="cuda")
    k = torch.randn(B, Sk, Hkv, D, generator=gen, device="cuda")
    v = torch.randn(B, Sk, Hkv, D, generator=gen, device="cuda")
    before = dict(flash_attention.launches_by_variant)
    got = flash_attention(q, k, v, causal, window)
    after = flash_attention.launches_by_variant
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == "tf32x3") for n in after}
    want = flash_attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    if Sk == 32:
        assert not got[:, 47:].abs().max()


@pytest.mark.gpu
def test_tf32x3_refuses_an_unaligned_q():
    _need_gpu()
    base = torch.randn(1 * 8 * 4 * 64 + 1, device="cuda")
    q = base[1:].view(1, 8, 4, 64)             # 4 bytes past an alignment
    k = torch.randn(1, 8, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, k, k)
