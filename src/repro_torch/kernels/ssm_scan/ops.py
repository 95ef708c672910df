"""Chunked mLSTM scan: the hand-written Hopper kernels and their plain version.

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan/kernel.py
::mlstm_scan_kernel``.  Three kernels, chosen by ``_variant(dtype, D)``:

- ``"mma"`` (``csrc/mlstm_scan_sm90.cu``): bfloat16 at D in ``MMA_D``;
- ``"tf32x3"`` (``csrc/mlstm_scan_tf32x3.cu``): float32 at D in ``MMA_D``;
- ``"simt"`` (``csrc/mlstm_scan.cu``): either dtype at any other D.

"mma" and "tf32x3" are an intra-chunk pass and a carry pass ("tf32x3"
with the chunks' scores in a pass of their own ahead) with their
products on the tensor cores: bf16 operands as two bf16 terms, float32
ones as three TF32 products of hi / lo splits (one TF32 product misses
float32's 1e-4 over a long row, ``tests/test_torch_ssm_tf32x3.py``);
"simt" runs on the fp32 CUDA cores.  Each header says what bounds it on
the H100 and what the design does about the ``[D, D]`` carry that does
not fit one SM's shared memory.

``mlstm_scan`` takes the model layout ``q/k/v [B, S, H, D]``, ``ig/fg
[B, S, H]`` as the JAX entry point does.  The tensor-core kernels read
that layout in place, any S; for the "simt" kernel and the plain version
the wrapper pads S to a chunk multiple (the pad steps leave the carry
unchanged) and flattens to ``[B*H, S, D]``.  On a CPU tensor it runs
``mlstm_chunkwise_ref``; on a CUDA tensor it launches the kernel
``_variant`` names (or raises: a float32 call at D in ``MMA_D`` never
takes "simt" or the plain version) and counts the launch in
``mlstm_scan.launches`` and, per variant, in
``mlstm_scan.launches_by_variant`` (one count per call: "mma" runs its
two passes as two kernels, "tf32x3" its three as three).  It is an autograd
function whose backward recomputes ``mlstm_chunkwise_ref`` under
autograd: the reference has no
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
MAX_D = 512            # the kernels' carry holds D <= 512
MAX_CHUNK = 64         # rows of the kernels' [T, T] score tile
MMA_D = (64, 128, 256, 512)   # the D the tensor-core kernels are built for
_TENSOR_CORE = {torch.bfloat16: "mma", torch.float32: "tf32x3"}
_SOURCES = {"simt": "mlstm_scan", "mma": "mlstm_scan_sm90",
            "tf32x3": "mlstm_scan_tf32x3"}

__all__ = ["mlstm_scan", "mlstm_chunkwise_ref", "mlstm_scan_ref"]


def _variant(dtype: torch.dtype, D: int) -> str:
    """The kernel that serves ``dtype`` at head dim ``D``."""
    return _TENSOR_CORE.get(dtype, "simt") if D in MMA_D else "simt"


def _lib(variant: str) -> ctypes.CDLL:
    name = _SOURCES[variant]
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        # simt: 9 pointers, (BH, S, D, chunk), scale, dtype, device;
        # mma and tf32x3: 11 pointers (two scratch), (B, S, H, D, chunk),
        # scale, device
        simt = variant == "simt"
        fn.argtypes = ([ctypes.c_void_p] * (9 if simt else 11)
                       + [ctypes.c_int] * (4 if simt else 5) + [ctypes.c_float]
                       + [ctypes.c_int] * (2 if simt else 1)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _scan_flat(q, k, v, ig, fg, chunk: int, return_state: bool = False):
    """The CUDA-core kernel (or, on the CPU, the plain version) on the flat
    layout: q/k/v [BH, S, D], ig/fg [BH, S] float32, S a chunk multiple ->
    h [BH, S, D] (and the final carry)."""
    # on meta the plain version gives only its shapes (the dry-run)
    if q.device.type in ("cpu", "meta"):
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
    _check_inputs(q, k, v, ig, fg)
    h = torch.empty_like(q)
    state = _empty_state(BH, D, q.device) if return_state else None
    lib = _lib("simt")
    err = lib.mlstm_scan(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
        fg.data_ptr(), h.data_ptr(), *_state_ptrs(state), BH, S, D, chunk,
        1.0 / math.sqrt(D), _DTYPES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "mlstm_scan", err)
    mlstm_scan.launches += 1
    mlstm_scan.launches_by_variant["simt"] += 1
    mlstm_scan.last_chunk = chunk
    return (h, state) if return_state else h


def _scan_tc(q, k, v, ig, fg, chunk: int, return_state: bool = False):
    """The tensor-core kernel of q's dtype ("mma" for bfloat16, "tf32x3"
    for float32) on the model layout, in place: q/k/v [B, S, H, D] with D
    in MMA_D, ig/fg [B, S, H] float32, any S (the kernel's short last chunk
    stands for the padded one) -> h [B, S, H, D] (and the final carry, flat
    [B*H, ...])."""
    B, S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape or ig.shape != (B, S, H) \
            or fg.shape != (B, S, H):
        raise ValueError(f"mlstm_scan: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} ig "
                         f"{tuple(ig.shape)} fg {tuple(fg.shape)}")
    if not 1 <= chunk <= MAX_CHUNK or S < 1 or B * H > 65535:
        raise ValueError(f"mlstm_scan: S={S} chunk={chunk} B*H={B * H} "
                         f"(needs chunk <= {MAX_CHUNK}, B*H <= 65535)")
    q, k, v, ig, fg = (x.contiguous() for x in (q, k, v, ig, fg))
    _check_inputs(q, k, v, ig, fg)
    variant = _variant(q.dtype, D)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("mlstm_scan: the tensor-core kernels need 16-byte "
                         "aligned q, k, v")
    h = torch.empty_like(q)
    state = _empty_state(B * H, D, q.device) if return_state else None
    # what the passes hand on: P [B*H, chunks, 64, 64] (bf16 hi and lo
    # planes for "mma", fp32 for "tf32x3": the same bytes) and (inter, den,
    # w_end, sc) fp32 [B*H, chunks, 4, 64]; "tf32x3" adds its score pass's
    # sums fp32 [B*H, chunks, D + 4]
    n_chunks = -(-S // chunk)
    planes = 2 if variant == "mma" else 1
    p_scratch = torch.empty(B * H * n_chunks * planes * MAX_CHUNK * MAX_CHUNK,
                            dtype=q.dtype, device=q.device)
    per_chunk = 4 * MAX_CHUNK + (D + 4 if variant == "tf32x3" else 0)
    s_scratch = torch.empty(B * H * n_chunks * per_chunk,
                            dtype=torch.float32, device=q.device)
    name = _SOURCES[variant]
    lib = _lib(variant)
    err = getattr(lib, name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
        fg.data_ptr(), h.data_ptr(), *_state_ptrs(state),
        p_scratch.data_ptr(), s_scratch.data_ptr(), B, S, H, D, chunk,
        1.0 / math.sqrt(D), q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, name, err)
    mlstm_scan.launches += 1
    mlstm_scan.launches_by_variant[variant] += 1
    mlstm_scan.last_chunk = chunk
    return (h, state) if return_state else h


def _check_inputs(q, k, v, ig, fg) -> None:
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


def _empty_state(BH: int, D: int, device):
    return (torch.empty((BH, D, D), dtype=torch.float32, device=device),
            torch.empty((BH, D), dtype=torch.float32, device=device),
            torch.empty((BH,), dtype=torch.float32, device=device))


def _state_ptrs(state):
    return [t.data_ptr() for t in state] if state else [None] * 3


def _on_flat(fn, q, k, v, ig, fg, chunk: int, return_state: bool = False):
    """Run ``fn`` (the flat layout, S a chunk multiple) on the model layout:
    pad S to a chunk multiple, flatten to [B*H, S, ...], and back."""
    B, S, H, D = q.shape
    q, k, v, ig, fg = pad_to_chunk(q, k, v, ig, fg, chunk)
    Sp = q.shape[1]

    def flat(x):
        return x.movedim(2, 1).reshape(B * H, Sp, *x.shape[3:]).contiguous()

    out = fn(*(flat(x) for x in (q, k, v, ig, fg)), chunk, return_state)
    h, state = out if return_state else (out, None)
    h = h.reshape(B, H, Sp, D).movedim(1, 2)[:, :S]
    return (h, state) if return_state else h


def _forward(q, k, v, ig, fg, chunk: int, return_state: bool = False):
    """The kernel ``_variant`` picks on a CUDA tensor, the plain version on
    a CPU one; the model layout in and out (the state flat)."""
    if q.is_cuda and _variant(q.dtype, q.shape[3]) != "simt":
        return _scan_tc(q, k, v, ig, fg, chunk, return_state)
    return _on_flat(_scan_flat, q, k, v, ig, fg, chunk, return_state)


def _plain(q, k, v, ig, fg, chunk: int):
    """The plain chunkwise version on the model layout (differentiable)."""
    return _on_flat(mlstm_chunkwise_ref, q, k, v, ig, fg, chunk)


# the kernel forward; the backward recomputes the plain chunkwise form
_scan = recompute_vjp("_Scan", _forward, _plain, 5)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               ig: torch.Tensor, fg: torch.Tensor, chunk: Optional[int] = None,
               return_state: bool = False):
    """q/k/v [B, S, H, D]; ig/fg [B, S, H] (pre-activation gates) ->
    h [B, S, H, D] in q's dtype, from the zero state.

    ``chunk=None`` resolves through ``kernels.tuning`` (default 64); a
    launch leaves its chunk in ``mlstm_scan.last_chunk``.  With
    ``return_state`` returns ``(h, (C, n, m))``."""
    B, S, H, D = q.shape
    chunk = tuning.resolve("ssm_scan", "chunk", chunk)
    ig, fg = ig.float(), fg.float()
    if not return_state:
        return _scan(q, k, v, ig, fg, chunk)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v, ig, fg)):
        raise ValueError("mlstm_scan: return_state is the inference "
                         "path; its outputs carry no gradient")
    h, (C, n, m) = _forward(q, k, v, ig, fg, chunk, True)
    return h, (C.reshape(B, H, D, D), n.reshape(B, H, D), m.reshape(B, H))


mlstm_scan.launches = 0
mlstm_scan.launches_by_variant = {"simt": 0, "mma": 0, "tf32x3": 0}
mlstm_scan.last_chunk = None
