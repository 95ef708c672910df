"""Plain PyTorch versions of the stabilised mLSTM scan, on the flat
``[BH, S, D]`` layout of the kernel (rows are batch x head).

``mlstm_scan_ref`` is the strict per-step recurrence, the port of
``repro/kernels/ssm_scan/ref.py`` (a loop over time, batched over rows:
test shapes only).  ``mlstm_chunkwise_ref`` is the chunked form of
``repro/models/xlstm.py::mlstm_chunk`` / ``mlstm_chunkwise``: within a
chunk the recurrence is a decay-masked ``[T, T]`` product, across chunks
the ``(C, n, m)`` carry (true state = state * e^m) moves on.  It is what
the kernels compute, chunk for chunk, and what their backward recomputes.
``mlstm_two_pass_ref`` is the same arithmetic split as the tensor-core
kernels split it: an intra-chunk pass, then a carry pass over blocks of
value columns, with the bf16 kernel's operand roundings or (``tf32``) the
float32 kernel's TF32 products.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
NEG = -1e30
PAD_FG = 1e4          # forget-gate pad: log_sigmoid(1e4) == 0 exactly
State = Tuple[Tensor, Tensor, Tensor]


def log_sigmoid(x: Tensor) -> Tensor:
    """``min(x, 0) - log1p(e^{-|x|})``: stable, and 0 at the pad value."""
    return torch.clamp(x, max=0.0) - torch.log1p(torch.exp(-x.abs()))


def to_tf32(x: Tensor, nearest: bool = True) -> Tensor:
    """float32 cut to TF32 (10 mantissa bits) by bit mask: to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32``, or (``nearest`` False)
    truncated, as ``mma.sync`` reads a .tf32 operand's bits."""
    bits = x.contiguous().view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def tf32_product(a: Tensor, b: Tensor, terms: int = 2,
                 lo_nearest: bool = False) -> Tensor:
    """``a @ b`` as the float32 tensor-core kernels give it to the tensor
    cores: with ``terms`` 2 three TF32 products of the splits ``hi =
    to_tf32(x)`` (to nearest) and ``lo = x - hi``, small ones first (``lo(a)
    hi(b) + hi(a) lo(b) + hi(a) hi(b)``); with 1 the single product
    ``hi(a) hi(b)``.  ``csrc/mlstm_scan_tf32x3.cu`` passes lo as it is and
    ``mma.sync`` truncates it to TF32; ``csrc/flash_attention_fwd_tf32x3.cu``
    rounds lo to nearest as well (``lo_nearest``)."""
    ah, bh = to_tf32(a), to_tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = to_tf32(a - ah, lo_nearest), to_tf32(b - bh, lo_nearest)
    return al @ bh + ah @ bl + ah @ bh


def zero_state(BH: int, D: int, device) -> State:
    return (torch.zeros((BH, D, D), dtype=torch.float32, device=device),
            torch.zeros((BH, D), dtype=torch.float32, device=device),
            torch.zeros((BH,), dtype=torch.float32, device=device))


def mlstm_scan_ref(q: Tensor, k: Tensor, v: Tensor, ig: Tensor,
                   fg: Tensor) -> Tensor:
    """q/k/v [BH, S, D]; ig/fg [BH, S] -> h [BH, S, D] in q's dtype.

    m_t = max(logsig(f_t) + m_{t-1}, i_t)
    C_t = e^{logsig(f)+m_{t-1}-m_t} C_{t-1} + e^{i_t - m_t} k_t v_t^T
    n_t likewise with k_t;  h_t = (q_t/sqrt(D)) C_t / max(|q.n_t|, e^{-m_t})
    """
    BH, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    C, n, m = zero_state(BH, D, q.device)
    hs = []
    for t in range(S):
        lf = log_sigmoid(fg[:, t].float())
        g = ig[:, t].float()
        m_new = torch.maximum(lf + m, g)
        f_sc = torch.exp(lf + m - m_new)
        i_sc = torch.exp(g - m_new)
        kf, vf = k[:, t].float(), v[:, t].float()
        qf = q[:, t].float() * scale
        C = (f_sc[:, None, None] * C
             + i_sc[:, None, None] * kf[:, :, None] * vf[:, None, :])
        n = f_sc[:, None] * n + i_sc[:, None] * kf
        qn = torch.abs(torch.sum(qf * n, dim=-1))
        h = (qf[:, None, :] @ C)[:, 0] / torch.maximum(
            qn, torch.exp(-m_new))[:, None]
        hs.append(h)
        m = m_new
    return torch.stack(hs, dim=1).to(q.dtype)


def mlstm_chunk(q: Tensor, k: Tensor, v: Tensor, ig: Tensor, fg: Tensor,
                carry: State) -> Tuple[State, Tensor]:
    """One stabilised chunk for every row at once.  q/k/v [BH, T, D] in
    float32, q already scaled by 1/sqrt(D); ig/fg [BH, T]; carry
    (C [BH, D, D], n [BH, D], m [BH]).  Returns (new carry, h [BH, T, D])."""
    C_s, n_s, m = carry
    T = q.shape[1]
    lf = log_sigmoid(fg.float())
    b = torch.cumsum(lf, dim=-1)                                  # [BH, T]
    g = ig.float()
    # decay matrix D[t, j] = b_t - b_j + g_j for j <= t
    dmat = b[:, :, None] - b[:, None, :] + g[:, None, :]
    tri = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    dmat = torch.where(tri, dmat, torch.full_like(dmat, NEG))
    alpha = m[:, None] + b
    m_t = torch.maximum(alpha, torch.amax(dmat, dim=-1))          # [BH, T]
    wmat = torch.exp(dmat - m_t[:, :, None])
    scores = (q @ k.transpose(1, 2)) * wmat
    inter = torch.exp(alpha - m_t)
    h_num = scores @ v + inter[:, :, None] * (q @ C_s)
    n_t = wmat @ k + inter[:, :, None] * n_s[:, None, :]
    qn = torch.abs(torch.sum(q * n_t, dim=-1))
    h = h_num / torch.maximum(qn, torch.exp(-m_t))[:, :, None]
    # carry update at the end of the chunk
    b_end = b[:, -1]
    m_new = torch.maximum(m + b_end,
                          torch.amax(b_end[:, None] - b + g, dim=-1))
    scale_c = torch.exp(m + b_end - m_new)
    w_end = torch.exp(b_end[:, None] - b + g - m_new[:, None])    # [BH, T]
    kw = k * w_end[:, :, None]
    C_new = scale_c[:, None, None] * C_s + kw.transpose(1, 2) @ v
    n_new = scale_c[:, None] * n_s + torch.sum(kw, dim=1)
    return (C_new, n_new, m_new), h


def pad_to_chunk(q: Tensor, k: Tensor, v: Tensor, ig: Tensor, fg: Tensor,
                 chunk: int):
    """Pad the sequence axis (dim 1) to a chunk multiple.  Padded steps are
    the identity on the carry: i -> 0 (ig = -1e30) and f -> 1 (fg = 1e4)."""
    pad = (-q.shape[1]) % chunk
    if not pad:
        return q, k, v, ig, fg

    def widths(x):
        return (0, 0) * (x.dim() - 2) + (0, pad)

    q, k, v = (F.pad(x, widths(x)) for x in (q, k, v))
    ig = F.pad(ig, widths(ig), value=NEG)
    fg = F.pad(fg, widths(fg), value=PAD_FG)
    return q, k, v, ig, fg


def mlstm_chunkwise_ref(q: Tensor, k: Tensor, v: Tensor, ig: Tensor,
                        fg: Tensor, chunk: int = 64,
                        return_state: bool = False):
    """q/k/v [BH, S, D]; ig/fg [BH, S] -> h [BH, S, D] in q's dtype, from
    the zero state; with ``return_state`` also the final (C, n, m) in
    float32.  S is padded to a chunk multiple as the reference pads."""
    BH, S, D = q.shape
    q, k, v, ig, fg = pad_to_chunk(q, k, v, ig, fg, chunk)
    qf = q.float() * (1.0 / math.sqrt(D))
    kf, vf = k.float(), v.float()
    carry = zero_state(BH, D, q.device)
    hs = []
    for c0 in range(0, q.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        carry, h = mlstm_chunk(qf[:, sl], kf[:, sl], vf[:, sl], ig[:, sl],
                               fg[:, sl], carry)
        hs.append(h)
    h = torch.cat(hs, dim=1)[:, :S].to(q.dtype)
    return (h, carry) if return_state else h


def mlstm_two_pass_ref(q: Tensor, k: Tensor, v: Tensor, ig: Tensor,
                       fg: Tensor, chunk: int = 64, dv: int = 64,
                       return_state: bool = False, terms: int = 2,
                       tf32: bool = False):
    """The two passes of ``csrc/mlstm_scan_sm90.cu`` (and, with ``tf32``,
    of ``csrc/mlstm_scan_tf32x3.cu``) in plain PyTorch, on the flat layout
    (q/k/v [BH, S, D], ig/fg [BH, S]).

    Intra-chunk pass, row by row over its chunks, in fp32: the gate cumsum
    b, the stabiliser m_t, ``P = (q k^T) o e^(dmat - m_t)``, ``inter_t``,
    ``den_t = max(|rowsum(P)_t + inter_t q.n|, e^(-m_t))`` from the fp32
    P, the carry scale ``sc``, ``w_end`` and the (n, m) carry.  Carry pass,
    per block of ``dv`` value columns (the last may be narrower), over the
    chunks: ``h = (P v + inter o (q C)) / den``, then ``C = sc C + k^T
    (v o w_end)``.  With bfloat16 inputs the fp32 operands the kernel
    gives the tensor cores in bfloat16 are rounded so here too: P, the copy
    of C in ``q C`` and ``v o w_end``, each as ``terms`` bf16 terms (the
    kernel's two: ``hi = bf16(x)``, ``lo = bf16(x - hi)``); C itself stays
    fp32.  With float32 inputs and ``tf32``, every product (q k^T, P v,
    q C and the C update) is ``tf32_product(a, b, terms)``, the float32
    kernel's three TF32 products at ``terms`` 2, and 1 / sqrt(D) scales
    the products' results as there (q is not scaled).  Returns h [BH, S,
    D] in q's dtype (and the final fp32 ``(C, n, m)``)."""
    BH, S, D = q.shape
    if tf32 and q.dtype != torch.float32:
        raise ValueError("mlstm_two_pass_ref: tf32 takes float32 inputs")

    def operand(x: Tensor) -> Tensor:
        if q.dtype == torch.float32:
            return x
        hi = x.to(q.dtype).float()
        return hi if terms == 1 else hi + (x - hi).to(q.dtype).float()

    def mm(a: Tensor, b: Tensor) -> Tensor:
        return tf32_product(a, b, terms) if tf32 else a @ b

    # the bf16 kernel scales q; the tf32x3 kernel scales each product
    scale = 1.0 / math.sqrt(D)
    post = scale if tf32 else 1.0
    q, k, v, ig, fg = pad_to_chunk(q, k, v, ig, fg, chunk)
    qf = q.float() * (1.0 if tf32 else scale)
    kf, vf = k.float(), v.float()
    T = chunk
    tri = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    n = torch.zeros((BH, D), dtype=torch.float32, device=q.device)
    m = torch.zeros((BH,), dtype=torch.float32, device=q.device)
    scratch = []                     # per chunk: P, inter, den, w_end, sc
    for c0 in range(0, q.shape[1], T):
        sl = slice(c0, c0 + T)
        b = torch.cumsum(log_sigmoid(fg[:, sl].float()), dim=-1)
        g = ig[:, sl].float()
        dmat = b[:, :, None] - b[:, None, :] + g[:, None, :]
        dmat = torch.where(tri, dmat, torch.full_like(dmat, NEG))
        alpha = m[:, None] + b
        m_t = torch.maximum(alpha, torch.amax(dmat, dim=-1))
        P = mm(qf[:, sl], kf[:, sl].transpose(1, 2)) * post * torch.exp(
            dmat - m_t[:, :, None])
        inter = torch.exp(alpha - m_t)
        qn = torch.sum(qf[:, sl] * n[:, None, :], dim=-1) * post
        den = torch.maximum(torch.abs(P.sum(dim=-1) + inter * qn),
                            torch.exp(-m_t))
        b_end = b[:, -1]
        m_new = torch.maximum(m + b_end,
                              torch.amax(b_end[:, None] - b + g, dim=-1))
        sc = torch.exp(m + b_end - m_new)
        w = torch.exp(b_end[:, None] - b + g - m_new[:, None])
        n = sc[:, None] * n + torch.sum(kf[:, sl] * w[:, :, None], dim=1)
        m = m_new
        scratch.append((operand(P), inter, den, w, sc))

    h = torch.empty_like(qf)
    C_out = torch.empty((BH, D, D), dtype=torch.float32, device=q.device)
    for j0 in range(0, D, dv):
        cols = slice(j0, min(D, j0 + dv))
        C = torch.zeros((BH, D, cols.stop - j0), dtype=torch.float32,
                        device=q.device)
        for i, (P, inter, den, w, sc) in enumerate(scratch):
            sl = slice(i * T, (i + 1) * T)
            vc = vf[:, sl, cols]
            h[:, sl, cols] = (mm(P, vc) + (inter * post)[:, :, None]
                              * mm(qf[:, sl], operand(C))) / den[:, :, None]
            C = (sc[:, None, None] * C
                 + mm(kf[:, sl].transpose(1, 2), operand(vc * w[:, :, None])))
        C_out[:, :, cols] = C
    h = h[:, :S].to(q.dtype)
    return (h, (C_out, n, m)) if return_state else h
