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
merge tickets must not be shared.  Each call is one launch.  In bfloat16
at G = 12 and 16 the tensor-core body serves all G heads in one head
group (each K/V tile read once) and in two groups of 8 rows, both
launched through the uncounted ``_launch`` helpers and held to the same
plain version; the wrappers launch the groups ``_head_groups`` gives the
one-group grid (one group where it fills the SMs), and the CUDA-core body
refuses a group of more than 8 heads.  Tolerance:
2e-5 in float32, 5e-2 in bfloat16 (``tests/test_kernels.py::_tol``).
``chip_smoke.py`` runs the same cases.
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ops import (
    _cut, _num_splits, decode_attention, decode_attention_ref)
from repro_torch.kernels.paged_attention import ops as paged_ops
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


def _dense_case(B, C, H, Hkv, D, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, C, Hkv, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, C, Hkv, D, generator=gen, device="cuda").to(dtype)
    q_pos = torch.tensor([C - 1, 300, 17], dtype=torch.int32,
                         device="cuda")[:B]
    slot = torch.arange(C, dtype=torch.int32, device="cuda")[None]
    k_pos = torch.where(slot <= q_pos[:, None], slot,
                        torch.full_like(slot, EMPTY)).contiguous()
    return q, k, v, q_pos, k_pos


def _paged_case(B, H, Hkv, D, page, maxp, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    P = B * maxp + 1
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(P, page, Hkv, D, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(P, page, Hkv, D, generator=gen, device="cuda").to(dtype)
    ids = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    bt = ids.reshape(B, maxp).to(torch.int32).contiguous()
    lens = torch.tensor([maxp * page, 333, 1], dtype=torch.int32,
                        device="cuda")[:B]
    return q, kp, vp, bt, lens


def _launch_in(paged, args, n_split, body, ng, **kw):
    """One uncounted launch of K3's or K2's C entry in ``ng`` head groups;
    returns the output and the groups the C entry was given."""
    if paged:
        return paged_ops._launch(*args, None, 128 ** -0.5, n_split, body, ng)
    o, lse, groups = decode_ops._launch(*args, None, 128 ** -0.5, n_split,
                                        body, ng, **kw)
    return ((o, lse) if kw else o), groups


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hkv", [(48, 4), (64, 4)])
@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("ng", [1, 2])
@pytest.mark.parametrize("paged", [False, True])
def test_one_head_group_on_the_tensor_cores(H, Hkv, n_split, ng, paged):
    """bf16, D 128, G = 12 / 16: the tensor-core body in one head group
    (all 16 rows of its tile), or in the two groups of 8 rows, held to the
    plain version."""
    _need_gpu()
    if paged:
        args = _paged_case(3, H, Hkv, 128, 16, 40, torch.bfloat16,
                           H + n_split)
        plain = paged_decode_attention_ref
    else:
        args = _dense_case(3, 700, H, Hkv, 128, torch.bfloat16, H * n_split)
        plain = decode_attention_ref
    got, groups = _launch_in(paged, args, n_split, "mma", ng)
    assert groups == _cut(H // Hkv, ng) and groups[0] == ng
    want = plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [3, 40])
@pytest.mark.parametrize("paged", [False, True])
def test_wrappers_launch_the_rule_groups(B, paged):
    """bf16 G = 12 through the wrappers: one launch on the tensor-core
    body in the groups ``_head_groups`` gives the one-group grid (two
    groups at B 3 x Hkv 4, one at B 40 x Hkv 4, which fills 132 SMs),
    counted as the C entry was given them, held to the plain version."""
    _need_gpu()
    H, Hkv = 48, 4
    if paged:
        args = _paged_case(B, H, Hkv, 128, 16, 40, torch.bfloat16, B)
        args = (*args[:4], args[4].repeat(B)[:B].contiguous())
        wrapper, plain = paged_decode_attention, paged_decode_attention_ref
    else:
        args = _dense_case(B, 700, H, Hkv, 128, torch.bfloat16, B)
        args = (*args[:3], args[3].repeat(B)[:B].contiguous(),
                args[4].repeat(B, 1)[:B].contiguous())
        wrapper, plain = decode_attention, decode_attention_ref
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    want_ng = 1 if B * Hkv >= n_sm else 2
    before = (wrapper.launches, wrapper.launches_by_variant["mma"],
              wrapper.launches_by_groups.get(want_ng, 0))
    got = wrapper(*args)
    assert (wrapper.launches, wrapper.launches_by_variant["mma"],
            wrapper.launches_by_groups.get(want_ng, 0)) == tuple(
                n + 1 for n in before)
    assert wrapper.last_groups == _cut(H // Hkv, want_ng)
    want = plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))


@pytest.mark.gpu
def test_one_head_group_with_lse_at_g16():
    """The lse output of the one-group launch at G = 16 (the context-split
    decode merges by it) against the plain version's."""
    _need_gpu()
    args = _dense_case(3, 700, 64, 4, 128, torch.bfloat16, 16)
    (got, lse), groups = _launch_in(False, args, 3, "mma", 1,
                                    return_lse=True)
    assert groups == (1, 16)
    want, want_lse = decode_attention_ref(*args, return_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))
    torch.testing.assert_close(lse, want_lse.float(), atol=5e-2, rtol=5e-2)


@pytest.mark.gpu
def test_core_body_refuses_a_group_above_8():
    """The CUDA-core body takes groups of up to 8 heads: a launch asking
    it for one group of 12 is refused, never sent elsewhere."""
    _need_gpu()
    args = _dense_case(3, 700, 48, 4, 128, torch.float32, 5)
    with pytest.raises(RuntimeError, match="flash_decode"):
        _launch_in(False, args, 1, "core", 1)
