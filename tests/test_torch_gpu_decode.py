"""The decode kernels (K3 dense, K2 paged) on a card at GQA groups above
8, held to their plain versions: needs an NVIDIA GPU, and skips inside
each test without one.  It imports no JAX, so it runs on a machine with a
card and no JAX (the suite's ``conftest.py`` imports JAX, hence
``--noconftest``)::

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu \\
        tests/test_torch_gpu_decode.py

G = 12 (H = 48, Hkv = 4, starcoder2-15b), 16 (H = 64, Hkv = 4) and 9
(a last head group smaller than the first), in float32 and bfloat16, with
one split and with the splits forced above 1, where the head groups'
merge tickets must not be shared.  Each call is one launch.  Tolerance:
2e-5 in float32, 5e-2 in bfloat16 (``tests/test_kernels.py::_tol``).
``chip_smoke.py`` runs the same cases.
"""
import pytest
import torch

from repro_torch.kernels.decode_attention.ops import (
    _num_splits, decode_attention, decode_attention_ref)
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_decode_attention_ref)

CASES = [(48, 4), (64, 4), (9, 1)]
EMPTY = -(2 ** 30)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == torch.bfloat16 \
        else dict(atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hkv", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("force", [1, 3])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_decode_on_the_card(H, Hkv, dtype, force, D):
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(H + force)
    B, C = 3, 700
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, C, Hkv, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, C, Hkv, D, generator=gen, device="cuda").to(dtype)
    q_pos = torch.tensor([C - 1, 300, 17], dtype=torch.int32, device="cuda")
    slot = torch.arange(C, dtype=torch.int32, device="cuda")[None]
    k_pos = torch.where(slot <= q_pos[:, None], slot,
                        torch.full_like(slot, EMPTY)).contiguous()
    _num_splits.force = force
    try:
        before = decode_attention.launches
        got = decode_attention(q, k, v, q_pos, k_pos)
        assert decode_attention.launches == before + 1
    finally:
        _num_splits.force = None
    want = decode_attention_ref(q, k, v, q_pos, k_pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hkv", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("force", [1, 3])
def test_paged_flash_decode_on_the_card(H, Hkv, dtype, force):
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(H * force)
    B, D, page, maxp = 3, 128, 16, 40
    P = B * maxp + 1
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(P, page, Hkv, D, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(P, page, Hkv, D, generator=gen, device="cuda").to(dtype)
    ids = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    bt = ids.reshape(B, maxp).to(torch.int32).contiguous()
    lens = torch.tensor([maxp * page, 333, 1], dtype=torch.int32,
                        device="cuda")
    _num_splits.force = force
    try:
        before = paged_decode_attention.launches
        got = paged_decode_attention(q, kp, vp, bt, lens)
        assert paged_decode_attention.launches == before + 1
    finally:
        _num_splits.force = None
    want = paged_decode_attention_ref(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
