"""Error-feedback compressed gradient all-reduce, the port of
``repro.parallel.compression``.

Each rank quantizes its gradient to int8 with one per-tensor scale, the
ranks sum the int8 payloads (accumulated as int32, as the reference's
``psum`` does) and the mean of their scales dequantizes the sum; the
quantization error stays on the rank as a residual added to the next
step's gradient (error feedback).  ``torch.round`` rounds half to even,
as ``jnp.round`` does, so the arithmetic is the reference's.

Collectives are ``torch.distributed.all_reduce`` over the process group of
the mesh's ``axis``: NCCL on the card, gloo on CPU processes.  No launcher
flag turns it on, as in the reference.
"""
from __future__ import annotations

from typing import Any, Mapping, Tuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def _quantize(x: Tensor) -> Tuple[Tensor, Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _sum(x: Tensor, group) -> Tensor:
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def compressed_psum(x: Tensor, group) -> Tensor:
    """int8-quantized sum over ``group``: quantize locally, sum int32,
    dequantize by the mean of the ranks' scales (per tensor)."""
    q, scale = _quantize(x.float())
    total = _sum(q.to(torch.int32), group)
    n = float(dist.get_world_size(group))
    s = _sum(scale.clone(), group) / n
    return total.float() * s


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _map_pair(fn, a, b):
    """``fn(leaf_a, leaf_b) -> (x, y)`` over two trees of one structure;
    returns the tree of x and the tree of y."""
    if isinstance(a, Mapping):
        res = {k: _map_pair(fn, a[k], b[k]) for k in a}
        return ({k: v[0] for k, v in res.items()},
                {k: v[1] for k, v in res.items()})
    if isinstance(a, (list, tuple)):
        res = [_map_pair(fn, x, y) for x, y in zip(a, b)]
        return type(a)(r[0] for r in res), type(a)(r[1] for r in res)
    return fn(a, b)


def make_compressed_allreduce(mesh, axis: str = "data"):
    """Returns f(grads, residual) -> (mean_grads, new_residual): an
    error-feedback int8 all-reduce over the mesh axis ``axis`` for a tree
    (nested dicts / lists) of gradients, each rank holding its own."""
    group = mesh.get_group(axis)

    def one(g: Tensor, r: Tensor):
        x = g.float() + r
        q, scale = _quantize(x)
        new_r = x - q.float() * scale                # error feedback
        n = float(dist.get_world_size(group))
        total = _sum(q.to(torch.int32), group).float()
        s = _sum(scale.clone(), group) / n
        return (total * s / n).to(g.dtype), new_r

    def allreduce(grads: Any, residual: Any) -> Tuple[Any, Any]:
        return _map_pair(one, grads, residual)

    return allreduce


def init_residual(grads: Any) -> Any:
    return _tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                           device=g.device), grads)
