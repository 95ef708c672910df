"""Chunked mLSTM scan: the hand-written Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan/kernel.py
::mlstm_scan_kernel``.  The CUDA source is ``kernels/csrc/mlstm_scan.cu``;
its header says what bounds it on the H100 and what the design does about
the ``[D, D]`` carry that does not fit one SM's shared memory.

``mlstm_scan`` takes the model layout ``q/k/v [B, S, H, D]``, ``ig/fg
[B, S, H]`` as the JAX entry point does, pads S to a chunk multiple (the
pad steps leave the carry unchanged) and flattens to ``[B*H, S, D]``.  On
a CPU tensor it runs ``mlstm_chunkwise_ref``; on a CUDA tensor it
launches the kernel (or raises) and counts the launch in
``mlstm_scan.launches``.  It is an autograd function whose backward
recomputes ``mlstm_chunkwise_ref`` under autograd: the reference has no
backward kernel (Pallas cannot differentiate its kernel, so the JAX
package trains through ``mlstm_chunkwise``), and neither has the port.

``return_state=True`` (the prefill path) also returns the final carry
``(C [B, H, D, D], n [B, H, D], m [B, H])`` in float32, as
``repro.models.xlstm.prefill`` computes it; those outputs carry no
gradient.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build, tuning
from ..recompute import recompute_vjp
from .ref import (mlstm_chunkwise_ref, mlstm_scan_ref,  # noqa: F401
                  pad_to_chunk)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 512            # the kernel's shared-memory carry holds D <= 512
MAX_CHUNK = 64         # rows of the kernel's [T, T] score tile

__all__ = ["mlstm_scan", "mlstm_chunkwise_ref", "mlstm_scan_ref"]


def _lib() -> ctypes.CDLL:
    lib = _build.load("mlstm_scan")
    fn = lib.mlstm_scan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _scan_flat(q, k, v, ig, fg, chunk: int, return_state: bool = False):
    """q/k/v [BH, S, D], ig/fg [BH, S] float32, S a chunk multiple ->
    h [BH, S, D] (and the final carry)."""
    if q.device.type == "cpu":
        return mlstm_chunkwise_ref(q, k, v, ig, fg, chunk, return_state)
    if not q.is_cuda:
        raise ValueError(f"mlstm_scan: unsupported device {q.device}")
    BH, S, D = q.shape
    if k.shape != q.shape or v.shape != q.shape or ig.shape != (BH, S) \
            or fg.shape != (BH, S):
        raise ValueError(f"mlstm_scan: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} ig "
                         f"{tuple(ig.shape)} fg {tuple(fg.shape)}")
    if not (1 <= chunk <= MAX_CHUNK) or S % chunk or S < 1 \
            or not 1 <= D <= MAX_D:
        raise ValueError(f"mlstm_scan: S={S} chunk={chunk} D={D} (needs "
                         f"S a multiple of chunk <= {MAX_CHUNK}, D <= "
                         f"{MAX_D})")
    for t in (k, v, ig, fg):
        if t.device != q.device:
            raise ValueError("mlstm_scan: inputs on different devices")
    if k.dtype != q.dtype or v.dtype != q.dtype or q.dtype not in _DTYPES:
        raise ValueError(f"mlstm_scan: dtypes q {q.dtype} k {k.dtype} v "
                         f"{v.dtype} (float32 or bfloat16, all equal)")
    if ig.dtype != torch.float32 or fg.dtype != torch.float32:
        raise ValueError("mlstm_scan: gates must be float32")
    if not all(t.is_contiguous() for t in (q, k, v, ig, fg)):
        raise ValueError("mlstm_scan: inputs must be contiguous")
    h = torch.empty_like(q)
    state = None
    if return_state:
        state = (torch.empty((BH, D, D), dtype=torch.float32,
                             device=q.device),
                 torch.empty((BH, D), dtype=torch.float32, device=q.device),
                 torch.empty((BH,), dtype=torch.float32, device=q.device))
    ptrs = [t.data_ptr() for t in state] if state else [None] * 3
    lib = _lib()
    err = lib.mlstm_scan(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
        fg.data_ptr(), h.data_ptr(), *ptrs, BH, S, D, chunk,
        1.0 / math.sqrt(D), _DTYPES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "mlstm_scan", err)
    mlstm_scan.launches += 1
    return (h, state) if return_state else h


# the kernel forward; the backward recomputes the plain chunkwise form
_scan = recompute_vjp("_Scan", _scan_flat, mlstm_chunkwise_ref, 5)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               ig: torch.Tensor, fg: torch.Tensor, chunk: Optional[int] = None,
               return_state: bool = False):
    """q/k/v [B, S, H, D]; ig/fg [B, S, H] (pre-activation gates) ->
    h [B, S, H, D] in q's dtype, from the zero state.

    ``chunk=None`` resolves through ``kernels.tuning`` (default 64).  With
    ``return_state`` returns ``(h, (C, n, m))``."""
    B, S, H, D = q.shape
    chunk = tuning.resolve("ssm_scan", "chunk", chunk)
    q, k, v, ig, fg = pad_to_chunk(q, k, v, ig.float(), fg.float(), chunk)
    Sp = q.shape[1]

    def flat(x):
        return x.movedim(2, 1).reshape(B * H, Sp, *x.shape[3:]).contiguous()

    args = [flat(x) for x in (q, k, v, ig, fg)]
    if return_state:
        if torch.is_grad_enabled() and any(x.requires_grad for x in args):
            raise ValueError("mlstm_scan: return_state is the inference "
                             "path; its outputs carry no gradient")
        h, (C, n, m) = _scan_flat(*args, chunk, True)
    else:
        h = _scan(*args, chunk)
    h = h.reshape(B, H, Sp, D).movedim(1, 2)[:, :S]
    if return_state:
        return h, (C.reshape(B, H, D, D), n.reshape(B, H, D),
                   m.reshape(B, H))
    return h


mlstm_scan.launches = 0
