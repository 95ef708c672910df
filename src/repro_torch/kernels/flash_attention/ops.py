"""Flash-attention forward: the hand-written Hopper kernel and its plain
version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py
::flash_attention_fwd``.  The CUDA source is ``kernels/csrc/
flash_attention_fwd.cu``; its header says what bounds it on the H100
(tensor-core FLOPs at long S: ``4*B*H*Sq*Sk*D/2`` causal) and what the
design does about that.

``flash_attention`` takes the model layout ``[B, S, H, D]`` as the JAX
entry point does.  On a CPU tensor it runs ``flash_attention_ref``; on a
CUDA tensor it launches the kernel (or raises) and counts the launch in
``flash_attention.launches``.  It is an autograd function whose backward
recomputes ``attention_ref`` (contiguous positions) under autograd, the
port of the reference's ``custom_vjp`` (``repro/kernels/flash_attention/
ops.py``, whose backward runs ``attention_ref`` under ``jax.vjp``): no
backward kernel, as in the reference.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build
from ..recompute import recompute_vjp
from .ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: contiguous positions 0..Sq-1 and 0..Sk-1."""
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    qp = torch.arange(Sq, device=q.device).expand(B, Sq)
    kp = torch.arange(Sk, device=q.device).expand(B, Sk)
    return attention_ref(q, k, v, q_positions=qp, k_positions=kp,
                         causal=causal, window=window, scale=scale)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: Optional[int],
             scale: Optional[float]) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, window, scale)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if H % Hkv or D > 256:
        raise ValueError(f"flash_attention: H={H} Hkv={Hkv} D={D} "
                         "(needs H % Hkv == 0 and D <= 256)")
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash_attention: q, k, v differ in device "
                             "or dtype")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} "
                         "(float32 or bfloat16)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: inputs must be contiguous")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    o = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, Sq, Sk, H, Hkv, D, int(causal),
        -1 if window is None else int(window), float(scale),
        _DTYPES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention_fwd", err)
    flash_attention.launches += 1
    return o


# the kernel forward; the backward recomputes the plain attention
_flash = recompute_vjp("_Flash", _forward, flash_attention_ref, 3)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Sk,Hkv,D] -> [B,Sq,H,D].  Contiguous positions
    (training/prefill: q rows at 0..Sq-1, k rows at 0..Sk-1)."""
    return _flash(q, k, v, causal, window, scale)


flash_attention.launches = 0
