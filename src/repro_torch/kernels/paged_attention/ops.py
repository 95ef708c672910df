"""Paged flash decode: the hand-written Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention/kernel.py
::paged_flash_decode``.  The CUDA source is
``kernels/csrc/paged_flash_decode.cu``; its header says what bounds it on
the H100 (HBM: the attended slots' K/V bytes / 3.35 TB/s) and what the
design does about that: the split-cache kernels of K3
(``csrc/split_decode.cuh``) over the paged layout, each row's reachable
slots cut into ``_paged_splits`` runs whose fp32 partials merge in the
same launch; the count is K3's rule over the slots a row can reach, or
over the longest length where the caller gives it (``max_len``).

``paged_decode_attention`` takes ``[B, H, D]`` and returns ``[B, H, D]`` as
the JAX entry point does.  On a CPU tensor it runs
``paged_decode_attention_ref``; on a CUDA tensor it launches the kernel (or
raises) and counts the launch in ``paged_decode_attention.launches`` and,
per block body (K3's ``_decode_body``: ``"mma"``, ``"tf32x3"`` or
``"core"``), in ``paged_decode_attention.launches_by_variant``, and by
head groups (K3's ``_head_groups``: one group of up to 16 heads on the
bf16 tensor-core body where that launch fills the card or its K/V read
dominates, so a page's K/V rows are read once for G <= 16; groups of up
to 8 elsewhere), in
``paged_decode_attention.launches_by_groups``.  As in the reference wrapper, table ids are clamped into ``[0, P-1]`` (the
kernel clamps each id it reads), and the scale is that of the true D: the
kernel needs no padding of D.  Its knob is the split rule's
``min_split_tiles``, resolved through ``kernels.tuning`` as K3's; the page
size is a property of the pool (``serve.kv_cache.PagedKVCache`` resolves
it through ``kernels.tuning``), read from ``k_pages``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build, tuning
from ..decode_attention.ops import (BODIES, TILE, _aligned, _count, _cut,
                                    _decode_body, _launch_groups,
                                    _num_splits, _resident, _sm_count,
                                    _split_scratch)
from .ref import paged_decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 256

__all__ = ["paged_decode_attention", "paged_decode_attention_ref"]


def _paged_splits(B: int, Hkv: int, D: int, maxp: int, page: int,
                  window: Optional[int], n_sm: int, resident, G: int = 1,
                  min_split_tiles: Optional[int] = None, body: str = "mma",
                  groups=None, max_len: Optional[int] = None) -> int:
    """Blocks per (row, KV head, head group): ``decode_attention.ops
    ._num_splits`` over the slots a row walks at most (``_span``: the
    table's reach, or less where the host's longest length ``max_len``
    says so), the blocks an SM holds of ``body`` (``resident(Gc)``); the
    head groups ``groups`` (by default ``_paged_groups``'s) count as more
    KV heads.  ``min_split_tiles=None`` resolves through
    ``kernels.tuning``."""
    min_tiles = tuning.resolve("paged_attention", "min_split_tiles",
                               min_split_tiles)
    span = _span(maxp, page, window, max_len)
    if groups is None:
        groups = _launch_groups(B, G, Hkv, D, span, n_sm, resident,
                                min_tiles, body)
    return _num_splits(B, Hkv * groups[0], -(-span // TILE), n_sm,
                       resident(groups[1]), min_tiles, groups[1], D,
                       body)


def _reach(maxp: int, page: int, window: Optional[int]) -> int:
    """The most slots a row can reach: the table's ``maxp * page``, or
    the window if shorter."""
    reach = maxp * page if window is None else min(maxp * page, window)
    return max(1, reach)


def _span(maxp: int, page: int, window: Optional[int],
          max_len: Optional[int] = None) -> int:
    """The slots the split rule counts a row over: ``_reach``, cut to the
    host's longest length ``max_len`` rounded up to a page where given
    (so the count moves only when the longest row crosses a page).  The
    kernel cuts each row's own run whatever the count, so a ``max_len``
    below a row's length changes the count, never the result."""
    reach = _reach(maxp, page, window)
    if max_len is None:
        return reach
    return max(1, min(reach, -(-int(max_len) // page) * page))


def _paged_groups(B: int, G: int, Hkv: int, D: int, maxp: int, page: int,
                  window: Optional[int], n_sm: int, resident,
                  min_split_tiles: Optional[int] = None, body: str = "mma",
                  max_len: Optional[int] = None):
    """The head groups of a launch on ``body``: ``_launch_groups`` over the
    slots the split rule counts (``_span``)."""
    min_tiles = tuning.resolve("paged_attention", "min_split_tiles",
                               min_split_tiles)
    return _launch_groups(B, G, Hkv, D, _span(maxp, page, window, max_len),
                          n_sm, resident, min_tiles, body)


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_flash_decode")
    fn = lib.paged_flash_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def paged_decode_attention(
    q: torch.Tensor,             # [B, H, D]
    k_pages: torch.Tensor,       # [P, page, Hkv, D] global pool
    v_pages: torch.Tensor,       # [P, page, Hkv, D]
    block_tables: torch.Tensor,  # [B, maxp] int32 page ids (unused -> 0)
    lengths: torch.Tensor,       # [B] int32 valid context incl. the query
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    min_split_tiles: Optional[int] = None,
    max_len: Optional[int] = None,
) -> torch.Tensor:
    """One decode token over a paged KV cache.  Returns [B, H, D].

    ``max_len``, a host integer, is the longest of ``lengths`` as the
    caller knows it without reading the card: the split count runs over
    it rounded up to a page (``_span``) instead of the table's width.  It
    moves only the count: the kernel cuts each row's own run, so any
    ``max_len`` gives the same output.  ``min_split_tiles=None`` resolves
    through ``kernels.tuning``; the launch's split count is left in
    ``paged_decode_attention.last_n_split``."""
    B, H, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    # scale from the TRUE head dim
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    # on meta the plain version gives only its shapes (the dry-run)
    if q.device.type in ("cpu", "meta"):
        return paged_decode_attention_ref(
            q, k_pages, v_pages, torch.clamp(block_tables, 0, P - 1),
            lengths, window=window, scale=scale)
    if not q.is_cuda:
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    maxp = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if (k_pages.shape != v_pages.shape or k_pages.shape[3] != D
            or tuple(block_tables.shape) != (B, maxp)
            or tuple(lengths.shape) != (B,)):
        raise ValueError(
            f"paged_decode_attention: shapes q {tuple(q.shape)} k_pages "
            f"{tuple(k_pages.shape)} v_pages {tuple(v_pages.shape)} "
            f"block_tables {tuple(block_tables.shape)} lengths "
            f"{tuple(lengths.shape)}")
    if H % Hkv or D > MAX_D:
        raise ValueError(f"paged_decode_attention: H={H} Hkv={Hkv} D={D} "
                         f"(needs H % Hkv == 0 and D <= {MAX_D})")
    for t in (k_pages, v_pages, block_tables, lengths):
        if t.device != q.device:
            raise ValueError("paged_decode_attention: inputs on different "
                             "devices")
    if (k_pages.dtype != q.dtype or v_pages.dtype != q.dtype
            or q.dtype not in _DTYPES):
        raise ValueError(f"paged_decode_attention: dtypes q {q.dtype} "
                         f"k_pages {k_pages.dtype} v_pages {v_pages.dtype} "
                         "(float32 or bfloat16, all equal)")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_decode_attention: block_tables and lengths "
                         "must be int32")
    if not all(t.is_contiguous()
               for t in (q, k_pages, v_pages, block_tables, lengths)):
        raise ValueError("paged_decode_attention: inputs must be contiguous")
    if max_len is not None and int(max_len) < 1:
        raise ValueError(f"paged_decode_attention: max_len = {max_len}")
    aligned = _aligned(q, k_pages, v_pages)
    body = _decode_body(q.dtype, D, aligned)
    n_sm = _sm_count(q.device)
    resident = _resident("paged_flash_decode", q.device, q.dtype, D, body,
                         aligned)
    groups = _paged_groups(B, H // Hkv, Hkv, D, maxp, page, window, n_sm,
                           resident, min_split_tiles, body, max_len)
    n_split = _paged_splits(B, Hkv, D, maxp, page, window, n_sm, resident,
                            H // Hkv, min_split_tiles, body, groups, max_len)
    o, groups = _launch(q, k_pages, v_pages, block_tables, lengths, window,
                        scale, n_split, body, groups[0])
    _count(paged_decode_attention, body, groups, n_split)
    return o


def _launch(q, k_pages, v_pages, block_tables, lengths, window, scale,
            n_split, body, ng):
    """One launch of ``paged_flash_decode.cu`` with the given split count,
    body (``"mma"``, ``"tf32x3"`` or ``"core"``) and ``ng`` head groups
    (``_cut``), on inputs ``paged_decode_attention`` has checked; not
    counted (chip_smoke.py times the CUDA-core body and other groups
    through it).
    Returns ``(o, (NG, Gc))``, the groups as the C entry was given them."""
    B, H, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    maxp, G = block_tables.shape[1], H // Hkv
    groups = _cut(G, ng)
    o = torch.empty_like(q)
    scratch = _split_scratch(B, Hkv, groups, D, n_split, q.device)
    lib = _lib()
    err = lib.paged_flash_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), o.data_ptr(),
        *(0 if t is None else t.data_ptr() for t in scratch),
        B, P, page, maxp, Hkv, G, groups[0], D, n_split,
        -1 if window is None else int(window), float(scale),
        _DTYPES[q.dtype], BODIES[body], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "paged_flash_decode", err)
    return o, groups


paged_decode_attention.launches = 0
paged_decode_attention.launches_by_variant = {"mma": 0, "tf32x3": 0,
                                              "core": 0}
paged_decode_attention.launches_by_groups = {}   # head groups -> launches
paged_decode_attention.launches_by_splits = {}   # n_split -> launches
paged_decode_attention.last_n_split = None
paged_decode_attention.last_groups = None   # (NG, Gc) of the last launch
