"""The decode kernels (K3 dense, K2 paged) on a card at GQA groups above
8, held to their plain versions: needs an NVIDIA GPU, and skips inside
each test without one.  It imports no JAX, so it runs on a machine with a
card and no JAX (the suite's ``conftest.py`` imports JAX, hence
``--noconftest``)::

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu \\
        tests/test_torch_gpu_decode.py

G = 12 (H = 48, Hkv = 4, starcoder2-15b), 16 (H = 64, Hkv = 4) and 9
(a last head group smaller than the first), in float32 and bfloat16,
through the wrappers (their own split count) and through the uncounted
``_launch`` helpers at one split and at 3, where the head groups' merge
tickets must not be shared.  Each call is one launch.  In bfloat16
at G = 12 and 16 the tensor-core body serves all G heads in one head
group (each K/V tile read once) and in two groups of 8 rows, both
launched through the uncounted ``_launch`` helpers and held to the same
plain version; the wrappers launch the groups ``_head_groups`` gives the
one-group grid (one group where it fills the SMs), and the CUDA-core body
refuses a group of more than 8 heads.  At whisper-small's
cross-attention decode every split count from 1 to 8 gives the plain
version's output, and K2 given a longest length shorter than its longest
row (``max_len``, which moves only the split count) still does.
Tolerance: 2e-5 in float32, 5e-2 in bfloat16
(``tests/test_kernels.py::_tol``); bfloat16 against the float32 plain
version also row by row (``BF16_ROW_TOL``, as ``chip_smoke.py`` holds
it).  float32 at D 64 / 80 / 128 runs on the 3xTF32 tensor-core body
("tf32x3", groups of up to 8 heads): through the wrappers and, beside
the CUDA-core body, through ``_launch`` at 1 and 3 splits, dense and
paged, with and without a window; the body refuses a group of 12,
bfloat16, D 96 and a k at a 4-byte offset.  ``chip_smoke.py`` runs the
same cases.
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ops import (
    _aligned, _cut, _decode_body, _launch_groups, _resident,
    decode_attention, decode_attention_ref)
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_decode_attention_ref)

CASES = [(48, 4), (64, 4), (9, 1)]
EMPTY = -(2 ** 30)
BF16_ROW_TOL = 2e-2    # chip_smoke.py's row gate for bfloat16 decode


def _bf16_excess(got, want32):
    """max over elements of (|got - want32| - 2^-8 |want32|) / the rms of
    want32 over the element's row (a query's heads x head dims), as
    ``chip_smoke.py::_bf16_excess``."""
    g = got.float().reshape(-1, got.shape[-2] * got.shape[-1])
    w = want32.float().reshape(g.shape)
    rms = w.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((g - w).abs() - 2.0 ** -8 * w.abs()).div(rms).max())


def _widened(args):
    return tuple(a.float() if a.is_floating_point() else a for a in args)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == torch.bfloat16 \
        else dict(atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hkv", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_decode_on_the_card(H, Hkv, dtype, n_split, D):
    """The wrapper (one counted launch at its own split count) and the
    same body and head groups launched at ``n_split`` through ``_launch``,
    both held to the plain version."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(H + n_split)
    B, C = 3, 700
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, C, Hkv, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, C, Hkv, D, generator=gen, device="cuda").to(dtype)
    q_pos = torch.tensor([C - 1, 300, 17], dtype=torch.int32, device="cuda")
    slot = torch.arange(C, dtype=torch.int32, device="cuda")[None]
    k_pos = torch.where(slot <= q_pos[:, None], slot,
                        torch.full_like(slot, EMPTY)).contiguous()
    before = decode_attention.launches
    got = decode_attention(q, k, v, q_pos, k_pos)
    assert decode_attention.launches == before + 1
    body = _decode_body(dtype, D, _aligned(q, k, v))
    forced, _, groups = decode_ops._launch(
        q, k, v, q_pos, k_pos, None, D ** -0.5, n_split, body,
        decode_attention.last_groups[0])
    assert groups == decode_attention.last_groups
    want = decode_attention_ref(q, k, v, q_pos, k_pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    torch.testing.assert_close(forced.float(), want.float(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hkv", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_split", [1, 3])
def test_paged_flash_decode_on_the_card(H, Hkv, dtype, n_split):
    """As the dense test, over the paged pool."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(H * n_split)
    B, D, page, maxp = 3, 128, 16, 40
    P = B * maxp + 1
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(P, page, Hkv, D, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(P, page, Hkv, D, generator=gen, device="cuda").to(dtype)
    ids = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    bt = ids.reshape(B, maxp).to(torch.int32).contiguous()
    lens = torch.tensor([maxp * page, 333, 1], dtype=torch.int32,
                        device="cuda")
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, kp, vp, bt, lens)
    assert paged_decode_attention.launches == before + 1
    body = _decode_body(dtype, D, _aligned(q, kp, vp))
    forced, groups = paged_ops._launch(
        q, kp, vp, bt, lens, None, D ** -0.5, n_split, body,
        paged_decode_attention.last_groups[0])
    assert groups == paged_decode_attention.last_groups
    want = paged_decode_attention_ref(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    torch.testing.assert_close(forced.float(), want.float(), **_tol(dtype))


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
    entry = "paged_flash_decode" if paged else "flash_decode"
    resident = _resident(entry, args[0].device, torch.bfloat16, 128, "mma",
                         True)
    C = 16 * 40 if paged else 700
    want_ng = _launch_groups(B, H // Hkv, Hkv, 128, C, n_sm, resident, 8,
                             "mma")[0]
    assert want_ng == (1 if B * Hkv >= n_sm else 2)
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


@pytest.mark.gpu
def test_every_split_count_at_whisper_cross():
    """whisper-small's cross-attention decode (B 8, 12 / 12 heads, D 64,
    1500 frames, every frame visible): every split count from 1 to 8 on
    the body and head groups the wrapper launches gives the plain
    version's output, in bfloat16 also row by row against the float32
    plain version."""
    _need_gpu()
    B, H, D, C = 8, 12, 64, 1500
    gen = torch.Generator(device="cuda").manual_seed(1500)
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((B, H, D), (B, C, H, D), (B, C, H, D)))
    q_pos = torch.full((B,), C - 1, dtype=torch.int32, device="cuda")
    k_pos = torch.arange(C, dtype=torch.int32, device="cuda").expand(
        B, C).contiguous()
    args = (q, k, v, q_pos, k_pos)
    decode_attention(*args)
    ng = decode_attention.last_groups[0]
    want = decode_attention_ref(*args)
    want32 = decode_attention_ref(*_widened(args))
    for n_split in range(1, 9):
        got, _, _ = decode_ops._launch(*args, None, D ** -0.5, n_split,
                                       "mma", ng)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   **_tol(torch.bfloat16))
        assert _bf16_excess(got, want32) <= BF16_ROW_TOL, n_split


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_max_len_moves_only_the_count(dtype):
    """K2 given the longest length (``max_len``), a shorter one, or none:
    the same output, held to the plain version; the split count runs over
    ``max_len`` rounded up to a page where given."""
    _need_gpu()
    B, H, Hkv, D, page, maxp = 8, 12, 2, 128, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(8)
    lens = torch.randint(33, 700, (B,), generator=gen, device="cuda",
                         dtype=torch.int32)
    P = B * maxp + 1
    kp = torch.randn(P, page, Hkv, D, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(P, page, Hkv, D, generator=gen, device="cuda").to(dtype)
    bt = (torch.randperm(P - 1, generator=gen, device="cuda") + 1).reshape(
        B, maxp).to(torch.int32).contiguous()
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    args = (q, kp, vp, bt, lens)
    want = paged_decode_attention_ref(*args)
    longest = int(lens.max())
    outs = {}
    for max_len in (None, longest, 40, 1):
        outs[max_len] = paged_decode_attention(*args, max_len=max_len)
        outs[max_len, "n"] = paged_decode_attention.last_n_split
    torch.cuda.synchronize()
    for max_len in (None, longest, 40, 1):
        torch.testing.assert_close(outs[max_len].float(), want.float(),
                                   **_tol(dtype))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    body = _decode_body(dtype, D, _aligned(q, kp, vp))
    resident = _resident("paged_flash_decode", q.device, dtype, D, body,
                         _aligned(q, kp, vp))
    for max_len in (None, longest, 40, 1):
        assert outs[max_len, "n"] == paged_ops._paged_splits(
            B, Hkv, D, maxp, page, None, n_sm, resident, H // Hkv, None,
            body, max_len=max_len)
    assert outs[1, "n"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("H", [12, 24])
@pytest.mark.parametrize("window", [None, 30])
@pytest.mark.parametrize("paged", [False, True])
def test_float32_tensor_core_body(D, H, window, paged):
    """float32 at D 64 / 80 / 128 on aligned tensors: the wrapper launches
    the 3xTF32 body ("tf32x3", one counted launch, no "core" launch), G 6
    in one head group and G 12 in two, and the body and the CUDA-core body
    launched at 1 and 3 splits through ``_launch`` on the same inputs all
    hold to the plain version at 2e-5."""
    _need_gpu()
    Hkv = 2
    if paged:
        args = _paged_case(3, H, Hkv, D, 16, 40, torch.float32, D + H)
        wrapper, plain = paged_decode_attention, paged_decode_attention_ref
        launch = paged_ops._launch
    else:
        args = _dense_case(3, 700, H, Hkv, D, torch.float32, D * H)
        wrapper, plain = decode_attention, decode_attention_ref
        launch = decode_ops._launch
    assert _decode_body(torch.float32, D, _aligned(*args[:3])) == "tf32x3"
    before = dict(wrapper.launches_by_variant)
    got = wrapper(*args, window=window)
    assert wrapper.launches_by_variant == dict(
        before, tf32x3=before["tf32x3"] + 1)
    assert wrapper.last_groups == _cut(H // Hkv, -(-(H // Hkv) // 8))
    want = plain(*args, window=window)
    outs = [got]
    for body in ("tf32x3", "core"):
        for n_split in (1, 3):
            outs.append(launch(*args, window, D ** -0.5, n_split, body,
                               wrapper.last_groups[0])[0])
    torch.cuda.synchronize()
    for out in outs:
        torch.testing.assert_close(out, want, **_tol(torch.float32))


@pytest.mark.gpu
def test_float32_tensor_core_body_refusals():
    """The 3xTF32 body serves float32 at D 64 / 80 / 128 on aligned
    tensors in groups of up to 8 heads; a launch asking it for one group of
    12, for bfloat16, for D 96 or for a k at a 4-byte offset is refused,
    never sent elsewhere."""
    _need_gpu()
    args = _dense_case(3, 700, 48, 4, 128, torch.float32, 6)
    with pytest.raises(RuntimeError, match="flash_decode"):
        _launch_in(False, args, 1, "tf32x3", 1)
    bf16 = _dense_case(3, 700, 12, 2, 128, torch.bfloat16, 7)
    with pytest.raises(RuntimeError, match="flash_decode"):
        _launch_in(False, bf16, 1, "tf32x3", 1)
    d96 = _dense_case(3, 700, 12, 2, 96, torch.float32, 8)
    with pytest.raises(RuntimeError, match="flash_decode"):
        decode_ops._launch(*d96, None, 96 ** -0.5, 1, "tf32x3", 1)
    q, k, v, q_pos, k_pos = _dense_case(3, 700, 12, 2, 128, torch.float32, 9)
    shifted = torch.empty(k.numel() + 1, device="cuda")[1:].view_as(k)
    shifted.copy_(k)
    assert not _aligned(q, shifted, v)
    assert _decode_body(torch.float32, 128, _aligned(q, shifted, v)) == "core"
    with pytest.raises(RuntimeError, match="flash_decode"):
        _launch_in(False, (q, shifted, v, q_pos, k_pos), 1, "tf32x3", 1)
