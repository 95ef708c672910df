"""Flash-attention forward: the hand-written Hopper kernels and their
plain version.

Replace the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py
::flash_attention_fwd``.  Each CUDA source's header says what bounds it
on the H100 (tensor-core FLOPs at long S: ``4*B*H*Sq*Sk*D/2`` causal)
and what its design does about that.

Three kernels, chosen by ``_variant(dtype, D)`` from the dtype and D alone:
``"wgmma"`` (``csrc/flash_attention_fwd_sm90.cu``: tensor cores, GQA-packed
rows, TMA) for bfloat16 at D = 64, 80 or 128; ``"tf32x3"`` (``csrc/
flash_attention_fwd_tf32x3.cu``: tensor cores in float32 by the 3xTF32
split, GQA-packed rows, a cp.async ring) for float32 at those D; and
``"simt"`` (``csrc/flash_attention_fwd.cu``: fp32 CUDA cores) for every
other D.  At D = 80 (h2o-danube) the wgmma kernel pads the head dim to 128
in shared memory, as the reference's wrapper pads it in HBM, and scales by
the true D; the tf32x3 kernel takes 80 as it is (10 steps of 8).

``flash_attention`` takes the model layout ``[B, S, H, D]`` as the JAX
entry point does.  On a CPU tensor it runs ``flash_attention_ref``; on a
CUDA tensor it launches a kernel (or raises) and counts the launch in
``flash_attention.launches`` and, per variant, in
``flash_attention.launches_by_variant``.  It is an autograd function
whose backward recomputes ``attention_ref`` (contiguous positions) under
autograd, the port of the reference's ``custom_vjp`` (``repro/kernels/
flash_attention/ops.py``, whose backward runs ``attention_ref`` under
``jax.vjp``): no backward kernel, as in the reference.
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


# the packed tensor-core kernels' tiles (packed rows a block, keys a tile)
# and head dims: bf16 (flash_attention_fwd_sm90.cu) and float32 by 3xTF32
# (flash_attention_fwd_tf32x3.cu)
ROWS, KEYS = 128, 64
TF32_ROWS, TF32_KEYS = 64, 32
TILES = {"wgmma": (ROWS, KEYS), "tf32x3": (TF32_ROWS, TF32_KEYS)}
WGMMA_DIMS = (64, 80, 128)
TF32X3_DIMS = (64, 80, 128)
_SOURCES = {"simt": "flash_attention_fwd", "wgmma": "flash_attention_fwd_sm90",
            "tf32x3": "flash_attention_fwd_tf32x3"}


def _variant(dtype: torch.dtype, D: int) -> str:
    """The kernel that serves ``dtype`` at head dim ``D``."""
    if dtype == torch.bfloat16 and D in WGMMA_DIMS:
        return "wgmma"
    if dtype == torch.float32 and D in TF32X3_DIMS:
        return "tf32x3"
    return "simt"


def _tile_plan(Sq: int, Sk: int, G: int, causal: bool,
               window: Optional[int], variant: str = "wgmma"):
    """The walk of a packed kernel (``variant`` "wgmma" or "tf32x3", tiles
    from ``TILES``), block by block for one (b, hk): packed row R is
    (position R // G, head R % G of the group); a block holds ``rows``
    packed rows and visits key tiles of ``keys`` keys from the window's
    first tile to the causal diagonal of its last position, masking only
    the tiles that straddle Sk, the diagonal or the window edge.  Yields
    ``(r0, r1, [(k0, masked), ...])`` per block (rows r0..r1-1); the CUDA
    kernel computes the same."""
    n_rows, keys = TILES[variant]
    rows = Sq * G
    for r0 in range(0, rows, n_rows):
        r1 = min(r0 + n_rows, rows)
        p_lo, p_hi = r0 // G, (r1 - 1) // G
        hi = min(Sk, p_hi + 1) if causal else Sk
        lo = max(0, p_lo - window + 1) if window is not None else 0
        lo = lo // keys * keys
        tiles = []
        for k0 in range(lo, hi, keys):
            full = (k0 + keys <= Sk and (not causal or k0 + keys - 1 <= p_lo)
                    and (window is None or k0 > p_hi - window))
            tiles.append((k0, not full))
        yield r0, r1, tiles


def _lib(variant: str) -> ctypes.CDLL:
    name = _SOURCES[variant]
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        # the simt entry also takes the dtype before the device
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float]
                       + [ctypes.c_int] * (2 if variant == "simt" else 1)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: Optional[int],
             scale: Optional[float]) -> torch.Tensor:
    # on meta the plain version gives only its shapes (the dry-run)
    if q.device.type in ("cpu", "meta"):
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
    variant = _variant(q.dtype, D)
    lib = _lib(variant)
    name = _SOURCES[variant]
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Sq, Sk, H, Hkv, D, int(causal),
            -1 if window is None else int(window), float(scale))
    if variant == "simt":
        head += (_DTYPES[q.dtype],)
    elif any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"flash_attention: the {variant} kernel needs "
                         "16-byte aligned q, k, v")
    err = getattr(lib, name)(
        *head, q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, name, err)
    flash_attention.launches += 1
    flash_attention.launches_by_variant[variant] += 1
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
flash_attention.launches_by_variant = {"simt": 0, "wgmma": 0, "tf32x3": 0}
