"""Flash decode: the hand-written Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention/kernel.py
::flash_decode``.  The CUDA source is ``kernels/csrc/flash_decode.cu``; its
header says what bounds it on the H100 (HBM: cache bytes / 3.35 TB/s) and
what the design does about that: the cache is split across
``_num_splits(B, Hkv, C)`` blocks per (row, KV head), whose fp32 partials
merge in the same launch (``csrc/split_decode.cuh``).

``decode_attention`` takes ``[B, H, D]`` and returns ``[B, H, D]`` as the
JAX entry point does.  On a CPU tensor it runs ``decode_attention_ref``; on
a CUDA tensor it launches the kernel (or raises) and counts the launch in
``decode_attention.launches``.  The kernel needs no padding of D or C (the
TPU wrapper padded D to 128 and C to ``block_c``), and takes any group of
``G = H / Hkv`` query heads: above ``MAX_GROUP`` the launch adds head
groups (``_head_groups``), still one launch.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from .. import _build, tuning
from .ref import decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 8          # query heads a block serves (split_decode.cuh kMaxG)
TILE = 16              # cache slots per tile (split_decode.cuh kTile)
MIN_SPLIT_TILES = 8    # tiles a split holds at least, by default
N_SM = 132             # the H100's SMs

__all__ = ["decode_attention", "decode_attention_ref"]


def _num_splits(B: int, Hkv: int, C: int, n_sm: int = N_SM,
                waves: float = 2.0, force: Optional[int] = None,
                min_tiles: int = MIN_SPLIT_TILES) -> int:
    """Blocks per (row, KV head): enough for ``waves`` waves over ``n_sm``
    SMs (``B * Hkv * n >= waves * n_sm``) where the row has the tiles, with
    every split at least ``min_tiles`` tiles of TILE slots long (each split
    pays a merge of its fp32 partial), and 1 when C fits one tile.
    ``force`` (tests and chip_smoke only) asks for a given count, capped at
    the tiles."""
    if min_tiles < 1:
        raise ValueError(f"min_tiles = {min_tiles}: a split walks at least "
                         "one tile")
    tiles = -(-C // TILE)
    if force is not None:
        return max(1, min(int(force), tiles))
    want = math.ceil(waves * n_sm / (B * Hkv))
    return max(1, min(want, tiles // min_tiles))


_num_splits.force = None   # an override for every launch (tests, smoke)


def _waves(dtype: torch.dtype, D: int) -> float:
    """The waves ``_num_splits`` aims for with the body that serves
    ``dtype`` at ``D``: the tensor-core body (bf16, D = 64 or 128) keeps 4
    warps x 2 tiles in flight per block and fills HBM at half a wave; the
    CUDA-core body needs two (measured: PERF.md §6)."""
    return 0.5 if dtype == torch.bfloat16 and D in (64, 128) else 2.0


def _head_groups(G: int):
    """(NG, Gc): the kernel serves G query heads per KV head as NG =
    ceil(G / MAX_GROUP) groups of Gc = ceil(G / NG) heads (the last group
    may hold fewer), one block per group and split; NG = 1 for G <=
    MAX_GROUP.  ``split_decode.cuh::head_groups`` / ``group_heads`` apply
    the same rule."""
    ng = -(-G // MAX_GROUP)
    return ng, -(-G // ng)


# per device: the merge tickets, one int32 per (row, KV head, head group),
# zeroed once at creation; every launch leaves its counters at 0 again
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[device] = torch.zeros(max(n, 256), dtype=torch.int32,
                                              device=device)
    return buf


def _split_scratch(B: int, Hkv: int, G: int, D: int, n_split: int,
                   device: torch.device):
    """The merge scratch of a launch with ``n_split`` splits, per (row, KV
    head, head group): the fp32 partials ``(acc, m, l)`` and the tickets;
    ``(None,) * 3`` for one split."""
    if n_split == 1:
        return None, None, None
    ng, gc = _head_groups(G)
    blocks = B * Hkv * ng
    return (torch.empty(blocks * n_split * gc * D, dtype=torch.float32,
                        device=device),
            torch.empty(blocks * n_split * gc * 2, dtype=torch.float32,
                        device=device),
            _counters(device, blocks))


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    fn = lib.flash_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


_SMS: Dict[int, int] = {}   # per device index: its SMs


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def decode_attention(
    q: torch.Tensor,          # [B, H, D]
    k: torch.Tensor,          # [B, C, Hkv, D]
    v: torch.Tensor,          # [B, C, Hkv, D]
    q_pos: torch.Tensor,      # [B] int32
    k_pos: torch.Tensor,      # [B, C] int32
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    min_split_tiles: Optional[int] = None,
    return_lse: bool = False,
):
    """One decode token over the KV cache.  Returns [B, H, D], and with
    ``return_lse`` also each head's log-sum-exp float32 [B, H] (the same
    launch writes it; ``ref.merge_lse`` merges launches over disjoint runs
    of the cache, as a context split over ranks needs).

    ``min_split_tiles=None`` resolves through ``kernels.tuning`` (default
    MIN_SPLIT_TILES); the launch's split count is left in
    ``decode_attention.last_n_split``."""
    # on meta the plain version gives only its shapes (the dry-run)
    if q.device.type in ("cpu", "meta"):
        return decode_attention_ref(q, k, v, q_pos, k_pos, window=window,
                                    scale=scale, return_lse=return_lse)
    if not q.is_cuda:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, D = q.shape
    _, C, Hkv, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or tuple(q_pos.shape) != (B,) or tuple(k_pos.shape) != (B, C)):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} q_pos "
                         f"{tuple(q_pos.shape)} k_pos {tuple(k_pos.shape)}")
    if H % Hkv or D > 256:
        raise ValueError(f"decode_attention: H={H} Hkv={Hkv} D={D} (needs "
                         f"H % Hkv == 0 and D <= 256)")
    for t in (k, v, q_pos, k_pos):
        if t.device != q.device:
            raise ValueError("decode_attention: inputs on different devices")
    if k.dtype != q.dtype or v.dtype != q.dtype or q.dtype not in _DTYPES:
        raise ValueError(f"decode_attention: dtypes q {q.dtype} k {k.dtype} "
                         f"v {v.dtype} (float32 or bfloat16, all equal)")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise ValueError("decode_attention: q_pos and k_pos must be int32")
    if not all(t.is_contiguous() for t in (q, k, v, q_pos, k_pos)):
        raise ValueError("decode_attention: inputs must be contiguous")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    G = H // Hkv
    o = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    n_split = _launch_splits(B, H, Hkv, D, C, q.dtype, _sm_count(q.device),
                             min_split_tiles)
    scratch = _split_scratch(B, Hkv, G, D, n_split, q.device)
    lib = _lib()
    err = lib.flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), o.data_ptr(),
        0 if lse is None else lse.data_ptr(),
        *(0 if t is None else t.data_ptr() for t in scratch),
        B, C, Hkv, G, D, n_split,
        -1 if window is None else int(window), float(scale),
        _DTYPES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_decode", err)
    decode_attention.launches += 1
    decode_attention.last_n_split = n_split
    return (o, lse) if return_lse else o


def _launch_splits(B: int, H: int, Hkv: int, D: int, C: int,
                   dtype: torch.dtype, n_sm: int,
                   min_split_tiles: Optional[int] = None) -> int:
    """The split count ``decode_attention`` launches with: ``_num_splits``
    over the head groups, the body's waves and the resolved
    ``min_split_tiles`` knob."""
    min_tiles = tuning.resolve("decode_attention", "min_split_tiles",
                               min_split_tiles)
    return _num_splits(B, Hkv * _head_groups(H // Hkv)[0], C, n_sm,
                       waves=_waves(dtype, D), force=_num_splits.force,
                       min_tiles=min_tiles)


decode_attention.launches = 0
decode_attention.last_n_split = None
