"""Autograd for a forward-only kernel: the backward recomputes the plain
version under autograd.

The reference differentiates its flash-attention kernel the same way (a
``custom_vjp`` whose backward runs ``attention_ref`` under ``jax.vjp``);
the port's K1 and K4 wrappers both take their gradient from here.
"""
from __future__ import annotations

from typing import Callable

import torch


def recompute_vjp(name: str, forward: Callable, ref: Callable,
                  n_tensors: int) -> Callable:
    """An autograd function ``fn(*tensors, *args)`` that runs
    ``forward(*tensors, *args)`` and whose backward differentiates
    ``ref(*tensors, *args)`` instead.  The first ``n_tensors`` inputs are
    the tensors; the rest are passed through and get no gradient.  The
    function is named ``name`` (its profiler node is ``{name}Backward``)."""

    def fwd(ctx, *inputs):
        tensors, args = inputs[:n_tensors], inputs[n_tensors:]
        ctx.args = args
        ctx.save_for_backward(*tensors)
        return forward(*tensors, *args)

    def bwd(ctx, dout):
        inputs = [x.detach().requires_grad_(need) for x, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = ref(*inputs, *ctx.args)
        wanted = [x for x in inputs if x.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, dout))
        return tuple(next(grads) if x.requires_grad else None
                     for x in inputs) + (None,) * len(ctx.args)

    fn = type(name, (torch.autograd.Function,),
              dict(forward=staticmethod(fwd), backward=staticmethod(bwd)))
    return fn.apply
