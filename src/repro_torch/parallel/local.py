"""DTensor boundaries of the model code: where a sharded step hands plain
local tensors to the hand-written kernels.

The family modules run unchanged on DTensors (parameters placed by
``parallel.sharding``) under ``implicit_replication``, so their plain
tensors (positions, masks) count as replicated.  What DTensor cannot do
for them is done here, each function the identity or a direct call on
plain tensors, so the single-device paths are untouched:

* ``local`` runs a function on each rank's local shards (``local_map``,
  inputs redistributed to the placements asked for, which the
  communication counters see): the kernels take ``data_ptr()`` and need
  plain, contiguous tensors.  ``blocks.attention``, ``decode_attention``
  and ``scan`` run per rank on local batch rows and heads;
  ``batch_heads`` / ``dim_placements`` build those placements;
* ``split_last`` / ``merge_last`` reshape the flat ``H·hd`` columns to
  heads and back where the model-axis shard does not divide the heads
  (the reference's plan shards the flat column);
* ``embed`` and ``vocab_logp`` are the vocab-parallel embedding and
  log-softmax, ``settle`` resolves the pending sums they leave;
* ``place_cache``, ``write_rows``, ``write_slots`` and ``copy_state``
  place a fresh cache by ``cache_pspecs`` and write it per rank;
* ``ssm`` runs hymba's SSM per rank on its channels;
* ``replicate_dim`` gathers a layer stack that ZeRO split on its layer
  dim before ``layer_views`` unbinds it.
"""
from __future__ import annotations

import sys
from typing import Callable, Optional, Sequence

import torch


def is_dt(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor, which takes
    seconds, on the single-device paths)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def settle(x):
    """A DTensor with its ``Partial`` placements reduced (to Replicate)."""
    if not is_dt(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    if list(pl) == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def _mesh_of(args):
    for a in args:
        if is_dt(a):
            return a.device_mesh
    return None


def dim_placements(mesh, dims: dict, shape: Sequence[int]):
    """Placements sharding tensor dim ``d`` over the mesh axes
    ``dims[d]`` where the size divides, else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from .mesh import axis_size
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axes in dims.items():
        axes = tuple(a for a in axes if a in names)
        if not axes or shape[d] % axis_size(mesh, axes):
            continue
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def batch_heads(mesh, shape: Sequence[int], head_dim: Optional[int] = 2):
    """Batch (dim 0) over ("pod","data"), heads (``head_dim``) over
    "model"."""
    dims = {0: ("pod", "data")}
    if head_dim is not None:
        dims[head_dim] = ("model",)
    return dim_placements(mesh, dims, shape)


def model_size(mesh) -> int:
    """Size of the "model" axis (1 when the mesh has none)."""
    from .mesh import axis_shape
    return axis_shape(mesh).get("model", 1)


def replicate(mesh):
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def local(fn: Callable, out_placements, in_placements, *args):
    """``fn(*local args)`` on each rank's shards; a direct call when no
    argument is a DTensor.  ``None`` placements pass an argument as is
    (non-tensors)."""
    mesh = _mesh_of(args)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map
    if out_placements and isinstance(out_placements[0], Placement):
        out_placements = (out_placements,)      # one output
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def contiguous(*ts):
    return tuple(t.contiguous() for t in ts)


def to_mesh(x: torch.Tensor, like) -> torch.Tensor:
    """A plain tensor as a replicated DTensor on ``like``'s mesh (identity
    when ``like`` is plain)."""
    if not is_dt(like) or is_dt(x):
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, like.device_mesh,
                              replicate(like.device_mesh), run_check=False)


def split_last(x, n: int, size: int):
    """``x [..., n*size] -> [..., n, size]``.  On a DTensor whose last dim
    is sharded over a mesh dim that does not divide ``n``, that mesh dim
    is replicated first (DTensor cannot split uneven shards across the
    new dims; the reference's plan shards the flat column all the same)."""
    if is_dt(x):
        pl = _even_last(x, n)
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:-1], n, size)


def vocab_logp(logits, targets):
    """log p(target) per position, float32, for DTensor logits [B, S, V]
    with the vocab over "model": the vocab-parallel log-softmax.  Each
    rank reduces its vocab slice (max, sum of exp, the target's logit when
    it falls in the slice) and DTensor sums the slices (``Partial``
    outputs of ``local``), so no rank gathers the [B, S, V] logits."""
    from torch.distributed.tensor import Partial, Shard
    mesh = logits.device_mesh
    lpl = dim_placements(mesh, {0: ("pod", "data"), 2: ("model",)},
                         logits.shape)
    rows = dim_placements(mesh, {0: ("pod", "data")}, targets.shape)
    vdim = [i for i, p in enumerate(lpl)
            if isinstance(p, Shard) and p.dim == 2]

    def reduced(op):
        pl = list(rows)
        for i in vdim:
            pl[i] = Partial(op)
        return tuple(pl)

    def vmax(lf):
        return torch.amax(lf.float(), dim=-1).detach()

    m = settle(local(vmax, reduced("max"), (lpl,), logits))

    def vsum(lf, m, t):
        lf = lf.float()
        V = lf.shape[-1]
        off = _offset(mesh, vdim, V)
        se = torch.sum(torch.exp(lf - m[..., None]), dim=-1)
        loc = t.long() - off
        inside = (loc >= 0) & (loc < V)
        tg = torch.gather(lf, -1, loc.clamp(0, V - 1)[..., None])[..., 0]
        return se, torch.where(inside, tg, torch.zeros_like(tg))

    se, tg = local(vsum, (reduced("sum"), reduced("sum")),
                   (lpl, rows, rows), logits, m, targets)
    return settle(tg) - (m + torch.log(settle(se)))


# ------------------------------------------------------------- embeddings
def embed(tokens, table):
    """``F.embedding(tokens, table)``; with a DTensor table sharded over
    its vocab rows, the vocab-parallel lookup: each rank looks up the ids
    in its slice (zeros elsewhere) and the slices are summed.  The table's
    other dim is gathered first (FSDP), the rows stay local."""
    import torch.nn.functional as F
    if not is_dt(table):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tokens = to_mesh(tokens, table)
    tpl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in table.placements)
    vdim = [i for i, p in enumerate(tpl) if isinstance(p, Shard)]
    rows = dim_placements(mesh, {0: ("pod", "data")}, tokens.shape)
    out = tuple(Partial("sum") if i in vdim else p
                for i, p in enumerate(rows))

    def body(t, w):
        V = w.shape[0]
        off = _offset(mesh, vdim, V)
        loc = t.long() - off
        inside = (loc >= 0) & (loc < V)
        e = F.embedding(loc.clamp(0, V - 1), w)
        return torch.where(inside[..., None], e, torch.zeros_like(e))

    return settle(local(body, out, (rows, tpl), tokens, table))


def _offset(mesh, dims, size: int) -> int:
    """Start of this rank's slice of a dim split over the mesh dims
    ``dims`` (in mesh order, each slice ``size`` long)."""
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx * size


# ------------------------------------------------------------- caches
def place_cache(cache: dict, cfg, like) -> dict:
    """A fresh cache placed as ``parallel.sharding.cache_pspecs`` says on
    ``like``'s mesh (identity when ``like`` is plain)."""
    if not is_dt(like):
        return cache
    from .sharding import cache_pspecs, distribute
    return distribute(cache, cache_pspecs(cache, cfg, like.device_mesh),
                      like.device_mesh)


def _rows_like(cache, ndim: int, drop: int):
    """Placements of a tensor shaped like ``cache`` with dim ``drop``
    removed (``ndim`` dims): the same dims sharded the same way, a shard
    of ``drop`` replicated."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p in cache.placements:
        d = p.dim - (p.dim > drop) if isinstance(p, Shard) else None
        out.append(Shard(d) if d is not None and p.dim != drop and d < ndim
                   else Replicate())
    return tuple(out)


def _ctx_start(cache) -> int:
    """First slot of this rank's run of a cache [B, C, ...] whose context
    dim is split (``cache_shard="ctx"``); 0 when it is whole."""
    from torch.distributed.tensor import Shard
    mesh = cache.device_mesh
    dims = [i for i, p in enumerate(cache.placements)
            if isinstance(p, Shard) and p.dim == 1]
    n = 1
    for i in dims:
        n *= mesh.size(i)
    return _offset(mesh, dims, -(-cache.shape[1] // n))


def write_rows(cache, slot, new, flat) -> None:
    """``cache [B, C, ...]``: row b's slot ``slot[b]`` := ``new[b]``, in
    place, through ``flat = arange(B) * C + slot`` on a plain cache (the
    caller computes it once a step); a sharded cache computes it from its
    local rows, and a rank holding a run of the context writes the rows
    whose slot falls in it (the others rewrite a slot of their own run
    with its value)."""
    def write(c, f, n):
        c.view(-1, *c.shape[2:]).index_copy_(0, f, n.to(c.dtype))

    if not is_dt(cache):
        return write(cache, flat, new)
    start = _ctx_start(cache)

    def body(c, s, n):
        B, C = c.shape[:2]
        loc = s.long() - start
        inside = ((loc >= 0) & (loc < C)).view(-1, *[1] * (n.dim() - 1))
        f = torch.arange(B, device=s.device) * C + loc.clamp(0, C - 1)
        old = c.view(-1, *c.shape[2:]).index_select(0, f)
        write(c, f, torch.where(inside, n.to(c.dtype), old))

    slot, new = to_mesh(slot, cache), to_mesh(new, cache)
    rows = _rows_like(cache, 1, 1)
    local(body, None, (cache.placements, rows,
                       _rows_like(cache, new.dim(), 1)), cache, slot, new)


def write_slots(cache, slots, new) -> None:
    """``cache [B, C, ...]``: ``cache[:, slots] := new`` in place (every
    row the same distinct slots: the prefill).  A rank holding a run of
    the context takes the slots that fall in it."""
    def body(c, s, n):
        c.index_copy_(1, s, n.to(c.dtype))

    if not is_dt(cache):
        return body(cache, slots, new)
    from torch.distributed.tensor import Replicate, Shard
    start = _ctx_start(cache)

    def body_run(c, s, n):
        C = c.shape[1]
        loc = s.long() - start
        # the source of each local slot (-1: none); slots outside the run
        # go to a spare entry past the end
        src = torch.full((C + 1,), -1, dtype=torch.long, device=s.device)
        src = src.index_put((torch.where((loc >= 0) & (loc < C), loc, C),),
                            torch.arange(s.shape[0], device=s.device))[:C]
        has = (src >= 0).view(1, C, *[1] * (c.dim() - 2))
        c.copy_(torch.where(has, n.index_select(1, src.clamp(min=0))
                            .to(c.dtype), c))

    slots, new = to_mesh(slots, cache), to_mesh(new, cache)
    npl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                for p in cache.placements)
    local(body_run if npl != tuple(cache.placements) else body, None,
          (cache.placements, replicate(cache.device_mesh), npl),
          cache, slots, new)


def copy_state(dst, src) -> None:
    """``dst.copy_(src)`` into a (possibly sharded) cache leaf."""
    if is_dt(dst):
        src = to_mesh(src, dst)
        if is_dt(src) and src.placements != dst.placements:
            src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


# ------------------------------------------------------------ attention
def decode_attention(q, k, v, q_pos, k_pos, *, window=None):
    """One decode token over the dense cache, placed as ``cache_pspecs``
    says, on each rank's local rows:

    * batch rows or KV heads split: the K3 kernel on the local ones;
    * context split (``cache_shard="ctx"``): K3 on each rank's run of the
      context with its log-sum-exp, the runs merged over the ranks
      (``merge_lse``: all-reduces of [B, H] maxima and weights and of the
      weighted [B, H, D] outputs), so no rank gathers the cache;
    * head dim split (the default ``"hd"``): each rank's partial q·k
      scores (K3's ``decode_scores`` pass) are summed over the split (an
      all-reduce of [B, H, C] float32 scores, as GSPMD partitions it),
      then K3's ``decode_softmax_pv`` pass runs the masks, the softmax
      and p·v on the local head-dim slice."""
    from repro_torch.kernels.decode_attention.ops import \
        decode_attention as kernel
    from repro_torch.kernels.decode_attention.ref import merge_lse
    if not is_dt(k):
        return kernel(q, k, v, q_pos, k_pos, window=window)
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    mesh = k.device_mesh
    q, q_pos, k_pos = (to_mesh(x, k) for x in (q, q_pos, k_pos))
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    split = {i: p.dim for i, p in enumerate(k.placements)
             if isinstance(p, Shard) and mesh.size(i) > 1}
    hd = [i for i, d in split.items() if d == 3]
    ctx = [i for i, d in split.items() if d == 1]
    cpl, qpl, kpl = [], [], []
    for p in k.placements:       # [B, C, Hkv, D] -> q / out [B, H, D]
        d = p.dim if isinstance(p, Shard) else None
        cpl.append(p if d is not None else Replicate())
        qpl.append(Shard({0: 0, 2: 1, 3: 2}[d]) if d in (0, 2, 3)
                   else Replicate())
        kpl.append(p if d in (0, 1) else Replicate())      # k_pos [B, C]
    cpl, qpl, kpl = tuple(cpl), tuple(qpl), tuple(kpl)
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in qpl)

    def reduce(x, op):
        for i in ctx:
            x = funcol.wait_tensor(funcol.all_reduce(x, op, (mesh, i)))
        return x

    def body(q, k, v, qp, kp):
        q, k, v, qp, kp = contiguous(q, k, v, qp, kp)
        if hd:
            return _decode_split_hd(q, k, v, qp, kp, window, scale,
                                    [(mesh, i) for i in hd])
        if not ctx:
            return kernel(q, k, v, qp, kp, window=window, scale=scale)
        o, lse = kernel(q, k, v, qp, kp, window=window, scale=scale,
                        return_lse=True)
        return merge_lse(o, lse, reduce)

    o = local(body, qpl, (qpl, cpl, cpl, rows, kpl), q, k, v, q_pos,
              k_pos)
    # gather the head-dim slices: the out projection flattens (H, D)
    out = tuple(p if not (isinstance(p, Shard) and p.dim == 2) else
                Replicate() for p in qpl)
    return o.redistribute(mesh, out) if out != qpl else o


def _decode_split_hd(q, k, v, q_pos, k_pos, window, scale, groups):
    """K3 on a head-dim slice: pass 1 (``decode_scores``) on the local
    slice, the float32 scores all-reduced over ``groups``, then pass 2
    (``decode_softmax_pv``) on the local slice of V."""
    import torch.distributed._functional_collectives as funcol
    from repro_torch.kernels.decode_attention.ops import (decode_scores,
                                                          decode_softmax_pv)
    s = decode_scores(q, k, scale=scale)
    for g in groups:
        s = funcol.wait_tensor(funcol.all_reduce(s, "sum", g))
    return decode_softmax_pv(s, v, q_pos, k_pos, window=window)


def scan(fn, q, k, v, ig, fg, n_out: int = 1):
    """The mLSTM scan ``fn(q, k, v, ig, fg)`` (q/k/v [B, S, H, D], gates
    [B, S, H]) on each rank's local rows and heads; ``n_out`` outputs
    placed like q's rows and heads (h [B,S,H,D]; with the carry, C
    [B,H,D,D], n [B,H,D], m [B,H])."""
    if not is_dt(q):
        return fn(q, k, v, ig, fg)
    mesh = q.device_mesh
    H = q.shape[2]
    heads = 2 if H % model_size(mesh) == 0 else None
    qpl = batch_heads(mesh, q.shape, heads)
    gpl = batch_heads(mesh, ig.shape, heads)
    ig, fg = to_mesh(ig, q), to_mesh(fg, q)
    if n_out == 1:
        out = qpl
    else:
        state = batch_heads(mesh, (q.shape[0], H), 1 if heads else None)
        out = (qpl, state, state, state)
    return local(lambda *a: fn(*contiguous(*a)), out,
                 (qpl, qpl, qpl, gpl, gpl), q, k, v, ig, fg)


def ssm(fn, x, dt, A, Bm, Cm, D, h):
    """Hymba's selective SSM ``fn(x, dt, A, Bm, Cm, D, h) -> (y, h)`` (the
    sequence or one step; x/dt [B, (S,) d], A [d, N], Bm/Cm [B, (S,) N],
    D [d], h [B, d, N]) on each rank's local rows and channels: every
    channel's recurrence is its own, so the channels split over "model"
    as the reference's ``ssm_in`` / ``A_log`` / ``Dskip`` do."""
    if not is_dt(x):
        return fn(x, dt, A, Bm, Cm, D, h)
    mesh = x.device_mesh
    ch = ("model",) if A.shape[0] % model_size(mesh) == 0 else ()
    rows = ("pod", "data")
    xp = dim_placements(mesh, {0: rows, x.dim() - 1: ch}, x.shape)
    bp = dim_placements(mesh, {0: rows}, Bm.shape)
    hp = dim_placements(mesh, {0: rows, 1: ch}, h.shape)
    args = [to_mesh(t, x) for t in (x, dt, A, Bm, Cm, D, h)]
    return local(fn, (xp, hp),
                 (xp, xp, dim_placements(mesh, {0: ch}, A.shape), bp, bp,
                  dim_placements(mesh, {0: ch}, D.shape), hp), *args)


def _even_last(x, n: int):
    """``x``'s placements with a shard of its last dim replicated where
    the mesh dim does not divide ``n`` (the heads)."""
    from torch.distributed.tensor import Replicate, Shard
    last = x.dim() - 1
    return [Replicate() if isinstance(p, Shard) and p.dim in (last, -1)
            and n % x.device_mesh.size(i) else p
            for i, p in enumerate(x.placements)]


class _MergeLast(torch.autograd.Function):
    """``[..., n, size] -> [..., n*size]`` on a DTensor whose backward
    replicates an uneven shard of the flat gradient before splitting it
    back into heads (DTensor cannot split it)."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        n = ctx.shape[-2]
        pl = _even_last(g, n)
        if pl != list(g.placements):
            g = g.redistribute(g.device_mesh, pl)
        return g.reshape(ctx.shape)


def merge_last(x):
    """``x [..., n, size] -> [..., n*size]`` (the heads flattened)."""
    if is_dt(x):
        return _MergeLast.apply(x)
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def replicate_dim(x, dim: int):
    """A DTensor with its shards of ``dim`` gathered (identity on plain
    tensors): unbinding the stacked ``[L, ...]`` layers needs the layer
    dim whole, and ZeRO may have split it (``parallel.sharding.
    zero_extend`` picks the largest divisible dim)."""
    if not is_dt(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)
