"""Plain PyTorch versions of the stabilised mLSTM scan, on the flat
``[BH, S, D]`` layout of the kernel (rows are batch x head).

``mlstm_scan_ref`` is the strict per-step recurrence, the port of
``repro/kernels/ssm_scan/ref.py`` (a loop over time, batched over rows:
test shapes only).  ``mlstm_chunkwise_ref`` is the chunked form of
``repro/models/xlstm.py::mlstm_chunk`` / ``mlstm_chunkwise``: within a
chunk the recurrence is a decay-masked ``[T, T]`` product, across chunks
the ``(C, n, m)`` carry (true state = state * e^m) moves on.  It is what
the kernel computes, chunk for chunk, and what its backward recomputes.
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
