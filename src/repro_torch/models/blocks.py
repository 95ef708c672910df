"""Shared neural blocks: plain functions on tensors.

The port of ``repro.models.blocks``: fp32 norms and softmax accumulators,
half-split RoPE, the chunked online-softmax ``attention`` with the same
``-1e30`` mask and ``-2^30`` empty-slot convention.  ``attention`` is the
CPU oracle.  On a CUDA tensor it runs the hand-written flash kernel only
where the caller says the positions are the contiguous ``0..S-1`` case
(``contiguous_positions=True``, which the families' prompt layers set:
causal, windowed or, for whisper's encoder and cross-attention,
non-causal with Sq != Sk), as the reference does under ``use_pallas``;
every other call, such as the paged prefill over gathered pages, takes
the masked path.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel import local as _local

Tensor = torch.Tensor


# --------------------------------------------------------------------- init
def _trunc_normal(shape, std: float, dtype, gen: torch.Generator) -> Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (t * std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype) -> Tensor:
    """Truncated-normal fan-in init (LLM standard)."""
    return _trunc_normal((d_in, d_out), 1.0 / math.sqrt(d_in), dtype, gen)


def experts_init(gen: torch.Generator, n: int, d_in: int, d_out: int,
                 dtype) -> Tensor:
    """``n`` stacked ``dense_init`` matrices, [n, d_in, d_out] (MoE)."""
    return _trunc_normal((n, d_in, d_out), 1.0 / math.sqrt(d_in), dtype, gen)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> Tensor:
    return _trunc_normal((vocab, d), 0.02, dtype, gen)


# --------------------------------------------------------------------- norms
def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dt)


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor,
               eps: float = 1e-5) -> Tensor:
    """LayerNorm with fp32 statistics (whisper)."""
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S].  Half-split
    rotation: the first D/2 lanes pair with the last D/2."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                        # [D/2]
    angles = positions[..., None].float() * freqs                 # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                         # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention core
NEG_INF = -1e30
EMPTY_POS = -(2 ** 30)        # k_pos of an empty cache slot: never attended


def _mask_value(q_pos: Tensor, k_pos: Tensor, causal: bool,
                window: Optional[int], kv_len: Optional[Tensor]) -> Tensor:
    """Additive mask [..., Sq, Sk] from absolute positions."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    # Empty cache slots carry position -2^30 and must never be attended;
    # every real position is >= 0.
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    if kv_len is not None:
        ok = ok & (kp < kv_len[..., None, None])
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def flash_route(on_cuda: bool, Sq: int, kv_len: Optional[Tensor],
                contiguous_positions: bool) -> bool:
    """Whether ``attention`` hands the call to the flash kernel: a CUDA
    tensor, more than one query, no ``kv_len``, and positions that the
    caller declared to be ``0..Sq-1`` / ``0..Sk-1`` (the kernel masks by
    index and knows neither offsets nor empty slots)."""
    return on_cuda and contiguous_positions and kv_len is None and Sq > 1


def attention(
    q: Tensor,                # [B, Sq, H, D]
    k: Tensor,                # [B, Sk, Hkv, D]
    v: Tensor,                # [B, Sk, Hkv, D]
    *,
    q_positions: Tensor,      # [B, Sq] absolute positions
    k_positions: Tensor,      # [B, Sk]
    causal: bool = True,
    window: Optional[int] = None,
    kv_len: Optional[Tensor] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    scale: Optional[float] = None,
    contiguous_positions: bool = False,
) -> Tensor:
    """Chunked online-softmax attention (GQA aware), fp32 accumulators.

    ``contiguous_positions=True`` declares the prefill/training case
    (``q_positions`` are ``0..Sq-1`` and ``k_positions`` ``0..Sk-1``, as
    the reference assumes under ``use_pallas``): on a CUDA tensor with
    Sq > 1 and no ``kv_len`` that runs the flash kernel (``flash_route``).
    """
    if _local.is_dt(q):
        # a sharded step: each rank attends its local rows and heads
        return _attention_local(
            q, k, v, q_positions=q_positions, k_positions=k_positions,
            causal=causal, window=window, kv_len=kv_len, q_chunk=q_chunk,
            kv_chunk=kv_chunk, scale=scale,
            contiguous_positions=contiguous_positions)
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    assert H % Hkv == 0, (H, Hkv)
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    if flash_route(q.is_cuda or q.is_meta, Sq, kv_len, contiguous_positions):
        from repro_torch.kernels.flash_attention.ops import flash_attention
        return flash_attention(q, k, v, causal, window, scale)

    if Sq == 1:
        # single-token decode: full scores are only [B, H, Sk]
        qf = q.float().reshape(B, Hkv, G, D)
        s = torch.einsum("bhgd,bkhd->bhgk", qf, k.float()) * scale
        msk = _mask_value(q_positions, k_positions, causal, window, kv_len)
        s = s + msk[:, None, None, 0, :]
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = torch.sum(p, dim=-1, keepdim=True)
        o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
        o = o / torch.clamp(l, min=1e-30)
        return o.reshape(B, 1, H, D).to(q.dtype)

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    pq = (-Sq) % q_chunk
    pk = (-Sk) % kv_chunk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
        q_positions = F.pad(q_positions, (0, pq), value=-1)
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        # padded kv slots carry the empty-slot position, masked in every
        # mode.  (The reference pads with 2^30, which only the causal,
        # window and kv_len masks exclude: its non-causal calls attend the
        # zero pad keys whenever Sk is not a multiple of kv_chunk, e.g.
        # whisper's 1500 frames in chunks of 1024.  The port computes the
        # softmax over the real keys, as the flash kernels and the
        # reference's own one-token path do.)
        k_positions = F.pad(k_positions, (0, pk), value=EMPTY_POS)
    Sqp, Skp = Sq + pq, Sk + pk
    nq, nk = Sqp // q_chunk, Skp // kv_chunk

    qg = q.reshape(B, nq, q_chunk, Hkv, G, D).float()
    qpos = q_positions.reshape(B, nq, q_chunk)
    kg = k.reshape(B, nk, kv_chunk, Hkv, D).float()
    vg = v.reshape(B, nk, kv_chunk, Hkv, D).float()
    kpos = k_positions.reshape(B, nk, kv_chunk)

    outs = []
    for iq in range(nq):
        qb, qpb = qg[:, iq], qpos[:, iq]
        acc = torch.zeros((B, q_chunk, Hkv, G, D), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, q_chunk, Hkv, G), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, q_chunk, Hkv, G), dtype=torch.float32,
                        device=q.device)
        for ik in range(nk):
            s = torch.einsum("bqhgd,bkhd->bqhgk", qb, kg[:, ik]) * scale
            msk = _mask_value(qpb, kpos[:, ik], causal, window, kv_len)
            s = s + msk[:, :, None, None, :]
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bqhgk,bkhd->bqhgd", p, vg[:, ik])
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(outs, dim=1).reshape(B, Sqp, H, D)[:, :Sq]
    return out.to(q.dtype)


def _attention_local(q, k, v, *, q_positions, k_positions, kv_len, **kw):
    """``attention`` on DTensors, through ``parallel.local.local``: batch
    over the data axes, and heads over "model" when both H and Hkv divide
    it (GQA keeps each q head with its kv head), else replicated."""
    mesh = q.device_mesh
    H, Hkv = q.shape[2], k.shape[2]
    m = _local.model_size(mesh)
    heads = 2 if H % m == 0 and Hkv % m == 0 else None
    qkv = _local.batch_heads(mesh, q.shape, heads)
    rows = _local.batch_heads(mesh, q.shape, None)
    args = [q, k, v, _local.to_mesh(q_positions, q),
            _local.to_mesh(k_positions, q)]
    pl = [qkv, qkv, qkv, rows, rows]
    if kv_len is not None:
        args.append(_local.to_mesh(kv_len, q))
        pl.append(rows)

    def body(q, k, v, qp, kp, kl=None):
        q, k, v = _local.contiguous(q, k, v)
        return attention(q, k, v, q_positions=qp, k_positions=kp,
                         kv_len=kl, **kw)

    return _local.local(body, qkv, tuple(pl), *args)


# --------------------------------------------------------------- projections
def qkv_project(x: Tensor, p, n_heads: int, n_kv_heads: int,
                head_dim: int) -> Tuple[Tensor, Tensor, Tensor]:
    """x: [B,S,Dm] -> q [B,S,H,D], k/v [B,S,Hkv,D].  Optional biases."""
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = _local.split_last(q, n_heads, head_dim)
    k = _local.split_last(k, n_kv_heads, head_dim)
    v = _local.split_last(v, n_kv_heads, head_dim)
    return q, k, v


def out_project(o: Tensor, p) -> Tensor:
    return _local.merge_last(o) @ p["wo"]


def swiglu(x: Tensor, p) -> Tensor:
    """SwiGLU FFN: (silu(x W_gate) * x W_up) W_down, SiLU in fp32."""
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["w_down"]


def gelu_mlp(x: Tensor, p) -> Tensor:
    """GELU MLP with biases (whisper, starcoder2).  The tanh form, which is
    ``jax.nn.gelu``'s default, in fp32."""
    h = x @ p["w_up"] + p["b_up"].to(x.dtype)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ p["w_down"] + p["b_down"].to(x.dtype)


def init_attn_params(gen, d_model, n_heads, n_kv_heads, head_dim, dtype,
                     bias=False):
    p = {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim, dtype),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim, dtype),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype),
    }
    if bias:
        dev = gen.device
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype, device=dev)
    return p


def init_swiglu_params(gen, d_model, d_ff, dtype):
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype),
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
    }


def init_gelu_mlp_params(gen, d_model, d_ff, dtype):
    dev = gen.device
    return {
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "b_up": torch.zeros((d_ff,), dtype=dtype, device=dev),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
        "b_down": torch.zeros((d_model,), dtype=dtype, device=dev),
    }
