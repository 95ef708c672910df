"""Flash decode: the hand-written Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention/kernel.py
::flash_decode``.  The CUDA source is ``kernels/csrc/flash_decode.cu``; its
header says what bounds it on the H100 (HBM: cache bytes / 3.35 TB/s) and
what the design does about that.

``decode_attention`` takes ``[B, H, D]`` and returns ``[B, H, D]`` as the
JAX entry point does.  On a CPU tensor it runs ``decode_attention_ref``; on
a CUDA tensor it launches the kernel (or raises) and counts the launch in
``decode_attention.launches``.  The kernel needs no padding of D or C (the
TPU wrapper padded D to 128 and C to ``block_c``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build
from .ref import decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 8          # query heads per KV head the kernel is built for

__all__ = ["decode_attention", "decode_attention_ref"]


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    fn = lib.flash_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def decode_attention(
    q: torch.Tensor,          # [B, H, D]
    k: torch.Tensor,          # [B, C, Hkv, D]
    v: torch.Tensor,          # [B, C, Hkv, D]
    q_pos: torch.Tensor,      # [B] int32
    k_pos: torch.Tensor,      # [B, C] int32
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode token over the KV cache.  Returns [B, H, D]."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, q_pos, k_pos, window=window,
                                    scale=scale)
    if not q.is_cuda:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, D = q.shape
    _, C, Hkv, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or tuple(q_pos.shape) != (B,) or tuple(k_pos.shape) != (B, C)):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} q_pos "
                         f"{tuple(q_pos.shape)} k_pos {tuple(k_pos.shape)}")
    if H % Hkv or H // Hkv > MAX_GROUP or D > 256:
        raise ValueError(f"decode_attention: H={H} Hkv={Hkv} D={D} (needs "
                         f"H % Hkv == 0, H/Hkv <= {MAX_GROUP}, D <= 256)")
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
    o = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), o.data_ptr(), B, C, Hkv, H // Hkv, D,
        -1 if window is None else int(window), float(scale),
        _DTYPES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_decode", err)
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
